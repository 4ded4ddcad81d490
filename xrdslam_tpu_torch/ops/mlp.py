"""Bias-free ReLU MLPs: the Co-SLAM SDF and color decoders.

Counterpart of ``xrdslam_tpu/ops/mlp.py``. The reference package stores a
layer as ``w [in, out]`` applied as ``x @ w``; here a layer is
``nn.Linear(in, out, bias=False)`` with ``weight [out, in]``, so a weight
carried over from the reference is transposed (``utils/from_jax.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    """dims = [in, hidden, ..., out]; ReLU between layers, none at the end."""

    def __init__(self, dims: Sequence[int], generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b, bias=False) for a, b in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            for layer in self.layers:
                # torch.nn.Linear's default bound, drawn from the given generator
                bound = 1.0 / math.sqrt(layer.in_features)
                layer.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h
