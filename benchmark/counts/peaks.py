"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit). The port turns TF32 off (device.py), so its
float32 arithmetic runs outside the tensor cores."""

H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> tuple:
    """(the least time the chip could take, "operations" or "bytes"):
    the larger of operations over the fp32 peak and bytes over the
    memory bandwidth."""
    t_ops = ops / H100_FP32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
