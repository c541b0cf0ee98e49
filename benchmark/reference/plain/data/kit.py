"""Training-kit splits (port of sings_tpu/data/kit.py's
get_data_splits; the kit itself the benchmark makes in memory)."""
from __future__ import annotations


def get_data_splits(num_frames: int):
    """Every ~10th frame (offset half-window) is validation."""
    num_val = max(num_frames // 10, 1)
    length = int(1 / num_val * num_frames)
    offset = length // 2
    val_list = list(range(num_frames))[offset::length]
    train_list = sorted(set(range(num_frames)) - set(val_list))
    assert train_list and val_list
    return train_list, val_list
