"""PyTorch / CUDA port of sings_tpu for one NVIDIA H100.

The animation-render path of the JAX package, rewritten in PyTorch: the
canonical avatar decode (triplane + decoder MLPs), batched LBS posing,
and the tile rasterizer forward, whose per-tile compositing runs in a
hand-written CUDA kernel (csrc/composite_fwd.cu). Module names mirror
the JAX package's; this package imports neither jax nor sings_tpu.

Entry points run on CUDA unless the caller passes device="cpu"; on the
CPU every kernel wrapper uses its plain PyTorch version instead.
"""
from .device import resolve_device, set_full_float32

set_full_float32()

__all__ = ["resolve_device", "set_full_float32"]
