"""The reference's side of the pool cell (configuration
human_complex_pool2): each case trained alone, as two independent plain
float32 single-case runs of the checked steps, each with the exact KNN
statistic in every step.

Each case is reference/build.py's avatar and training step and
reference/train.py's checked steps, from that case's own inputs: its
seeded weights, its kit's poses, its targets, its frames and its draws.
The reference knows nothing of the pool: no case axis, no stacking, no
case camera. Departures from the program's pool, noted:
  * the program runs both cases' steps in one lockstep call, one case
    after the other on one card, and stacks their outputs again after
    every step; the reference runs case 0's steps, then case 1's, each
    on its own state;
  * the program rebuilds each case's camera at call time from float32
    arrays on the device (dist/train_cases.py::camera_arrays); the
    reference uses the camera the benchmark built;
  * the exact statistic is the plain copy's blocked distance matrix and
    torch.topk (reference/plain/ops/knn.py), where the program's card
    runs csrc/knn_topk.cu: both are exact, and differ only in the order
    of neighbours at equal distances;
  * no CUDA launcher anywhere (reference/plain), and TF32 off for
    matmuls and cuDNN (the runner's reference_inputs turns it off before
    the first render).
"""
from __future__ import annotations

from . import build as RB
from .train import checked_steps


def case_steps(cfg, smpl: dict, weights: dict, camera, images, masks,
               chunks: list, step0: int, device) -> dict:
    """One case's checked steps, alone: reference/train.py's
    checked_steps on the avatar and the training step that
    reference/build.py builds from the case's inputs. weights is used as
    given (the caller passes a copy). Raises where the configuration
    does not ask for the exact statistic in every step."""
    if str(cfg.tpu.get("knn_backend", "auto")) != "dense":
        raise ValueError("the pool's reference takes the exact statistic in "
                         "every step: tpu.knn_backend=dense")
    av = RB.avatar(cfg, smpl, weights, device)
    tr = RB.training(av, camera, device)
    return checked_steps(av, tr, images.to(device), masks.to(device), chunks,
                         int(step0))
