"""PyTorch / CUDA port of sings_tpu for one NVIDIA H100.

The animation render and the training step of the JAX package,
rewritten in PyTorch: the avatar decode (triplane + decoder MLPs), LBS
posing, the tile rasterizer forward and backward, whose per-tile
compositing runs in hand-written CUDA kernels (csrc/composite_fwd.cu,
csrc/composite_bwd.cu), the losses and Adam. Module names mirror the
JAX package's; this package imports neither jax, optax nor sings_tpu.

Entry points run on CUDA unless the caller passes device="cpu"; on the
CPU every kernel wrapper uses its plain PyTorch version instead.
"""
from .device import resolve_device, set_full_float32

set_full_float32()

__all__ = ["resolve_device", "set_full_float32"]
