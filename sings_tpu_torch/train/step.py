"""Pieces of sings_tpu/train/step.py that the animation path uses."""
from __future__ import annotations

import torch


def sh_degree_mask(active_degree: int, device="cpu") -> torch.Tensor:
    """(16,) mask zeroing SH bands above the active degree."""
    band = torch.tensor([0] + [1] * 3 + [2] * 5 + [3] * 7, device=device)
    return (band <= active_degree).to(torch.float32)
