"""Dataset registry. Only the synthetic data type is ported so far; the
reference package's file-based loaders (Replica, ScanNet, TUM, ...) are
ROADMAP work."""
from __future__ import annotations

from .synthetic import SyntheticDataset

dataset_dict = {"synthetic": SyntheticDataset}


def get_dataset(data_path: str, data_type: str, device: str = "cpu"):
    """The dataset of ``data_type`` at ``data_path``; synthetic depth is traced on ``device``."""
    if data_type not in dataset_dict:
        raise NotImplementedError(f"data type {data_type!r} is not ported (have: {sorted(dataset_dict)})")
    return dataset_dict[data_type](data_path, device=device)
