"""Bytes of the triplane's backward (csrc/triplane_bwd.cu) at the
field's shapes: the cotangent, the query points and the planes read
once, the plane gradients and the points' gradient written once
(chip_smoke.py's count)."""

F32 = 4


def bwd_bytes(n_points: int, feat_dim: int, plane_sizes: list) -> int:
    """n_points queries with a (n_points, feat_dim) cotangent over the
    planes of plane_sizes (C * H * W each)."""
    return F32 * (n_points * feat_dim + 2 * n_points * 3
                  + 2 * sum(plane_sizes))
