"""Device selection and numeric setup shared by every entry point."""
from __future__ import annotations

import torch


def set_full_float32() -> None:
    """Keep float32 matmuls and convolutions in full float32.

    The JAX reference runs its cancelling matmuls at HIGHEST precision
    (cumsum-by-difference, SSIM variances); TF32 keeps about three
    decimal digits and would break those. PyTorch leaves TF32 off for
    matmuls but on for cuDNN convolutions by default, so set both.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> CUDA. Raises when CUDA is asked for and missing: there is
    no silent switch to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
        set_full_float32()
    return dev
