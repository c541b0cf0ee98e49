"""The port's tracing: named spans at its layer boundaries, and an
exporter of torch.profiler traces.

  * span(name): a torch.profiler.record_function range while a torch
    profiler runs, else one shared no-op context (no allocation, no
    dispatcher call). The ranges sit in the profiler's own session, on
    the clock of its device records: each kernel's launch falls inside
    the span that issued it (the ranges of a backward open on autograd's
    device thread). There is no switch: spans are on exactly when
    someone profiles.
  * trace(log_dir): a torch.profiler session (CPU activity, and CUDA
    activity when a card is present) that writes a Chrome trace,
    log_dir/trace.json, on exit. Wrap any call in it to see the spans
    below among the host's operations and the card's kernels.

The spans (dotted names, so that they never equal a caller's own
ranges):

  step.knn_stat         train/step.py::make_train_scan, the chunk head's
                        KNN statistic
  step.draws            train/step.py train_step: the step's random
                        draws, where the caller passes none
  step.decode           train_step: the SH mask, the screen probe,
                        avatar_forward and the warm-up gates
  step.rasterize        the step's rasterize call
  step.losses           photometric, silhouette and regularizer terms
  step.backward         torch.autograd.grad and the zero fill
  step.update           the finite guard, Adam, the kept state, the
                        density statistics and the metrics
  raster.preprocess     ops/rasterizer/api.py::rasterize: preprocess and
                        the screen probe
  raster.bin            prepare_composite: bin_gaussians
  raster.gather         prepare_composite: the pair features
  raster.composite_fwd  _Composite.forward: the launch and the relayout
  raster.composite_bwd  _Composite.backward: the cotangents' relayout
                        and the launch
  raster.unsort         _Composite.backward: unsort_pair_grads
  triplane.bwd          fields/triplane.py::_Triplane.backward
  anim.pose             train/trainer.py::render_chunk: pose_chunk
  anim.frame            render_chunk, once a frame: rasterize, quantize
  anim.readback         animate_chunk: a chunk's copy to the host
"""
from __future__ import annotations

import contextlib
import os

import torch

_NO_SPAN = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A named range of the host's work and the kernels it launches,
    recorded while a torch profiler runs; the shared no-op otherwise."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; writes log_dir/trace.json (Chrome format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
