"""Operations and bytes of the tile composite kernels
(csrc/composite_fwd.cu, csrc/composite_bwd.cu) at one launch's inputs,
with chip_smoke.py's constants.

Forward: at every walked pair-pixel, the pair's alpha at the pixel
before its skip test: tile-local offsets (4), the conic quadratic (9),
exp, the opacity product and the 0.99 clamp (3): 16 operations.
Backward, counted from csrc/composite_bwd.cu: at every walked
pair-pixel the forward's 16 and the termination test (3); only where
the pair composites, w (1), gc (5), upg (2), 1 / (1 - alpha) (1),
dl_da (5), dl_dpow (2), u and v (2), the seven products of the nine
rows (7) and the nine adds that reduce them over the pixels (9): 34.
Bytes: each input read once and each output written once."""

OPS_PER_PAIR_PIXEL = 16
OPS_PER_PAIR_PIXEL_BWD = 19
OPS_PER_COMPOSITE_BWD = 34
F32 = 4


def fwd(walked: int, n_tiles: int, tile: int) -> tuple:
    """(operations, bytes): walked pairs, each over the tile's pixels;
    the walked feature rows (9), both offset tables and the output."""
    npx = tile * tile
    ops = OPS_PER_PAIR_PIXEL * walked * npx
    nbytes = F32 * (9 * walked + 2 * (n_tiles + 1) + n_tiles * 8 * npx)
    return ops, nbytes


def bwd(walked: int, composited: int, n_tiles: int, tile: int,
        grad_cap: int) -> tuple:
    """(operations, bytes): the walked feature rows, both offset
    tables, rows 0-3 of the forward output and of the cotangents, the
    9-row gradient buffer written."""
    npx = tile * tile
    ops = (OPS_PER_PAIR_PIXEL_BWD * walked * npx
           + OPS_PER_COMPOSITE_BWD * composited)
    nbytes = F32 * (9 * walked + 2 * (n_tiles + 1) + 2 * n_tiles * 4 * npx
                    + 9 * grad_cap)
    return ops, nbytes
