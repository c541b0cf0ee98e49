"""The exact KNN statistic once, as the step's chunk head makes it
(the canonical centres by the triplane and the geometry decoder, then
edge_stat over the live gaussians), at the cell's state after the
traced window: CUDA events around each call, the median of REPEATS."""
from statistics import median

import torch

REPEATS = 3


def read(run):
    from sings_tpu_torch.losses.regularizers import edge_stat
    from sings_tpu_torch.model.avatar import get_canon_xyz

    tr = run.state.trainer
    if tr is None or not torch.cuda.is_available():
        return None
    k = tr.step_cfg.knn_k

    def stat():
        with torch.no_grad():
            xyz = get_canon_xyz(tr.params, tr.buffers, tr.avatar_cfg)
            return edge_stat(xyz, tr.buffers.alive, k=k)

    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        stat()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return median(times)
