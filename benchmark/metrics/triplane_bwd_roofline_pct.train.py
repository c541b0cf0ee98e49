"""The triplane backward's byte bound at the field's shapes
(counts/triplane.py) over its kernels' device time per backward in the
traced window (one backward a step)."""
from counts import peaks, triplane

KERNEL = "triplane_bwd_"


def read(run):
    tr = run.state.trainer
    n = run.extra.get("triplane_bwd_launches", 0)
    t = run.trace.kernel_s(KERNEL)
    if not n or not t:
        return None
    grids = [g for scale in tr.params.triplane["grids"] for g in scale]
    acfg = tr.avatar_cfg
    nbytes = triplane.bwd_bytes(acfg.capacity, acfg.triplane.feat_dim,
                                [g.numel() for g in grids])
    bound, _by = peaks.bound_s(0, nbytes)
    return 100.0 * bound / (t / n)
