"""The parts of the ConvONet decoders that Point-SLAM uses.

Counterpart of ``xrdslam_tpu/models/conv_onet.py``: the 5-block skip MLP
with a Fourier embedding of the point (``mlp_decoder_init`` /
``mlp_decoder_apply``, reference decoder_nice.py's ``MLP``) as an
``nn.Module``, and ``masked_median``. The rest of that module (the
NICE-SLAM grids and model) comes with NICE-SLAM.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _uniform_(w: torch.Tensor, a: float, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)


class MLPDecoder(nn.Module):
    """p [N, 3], c [N, c_dim] -> [N, 1] (occupancy) or [N, 4] (``color``).

    ``h = sin(p @ B)`` then ``n_blocks`` ReLU layers, each followed by
    ``+ fc_i(c)``, with the embedding concatenated back after each block in
    ``skips``. Weights are drawn as the reference draws them (Xavier with
    ReLU gain, zero biases, ``B ~ 25 N(0, 1)``, the output layer at 0.1x
    Xavier) from ``generator``; they are not the reference's numbers.
    """

    def __init__(self, c_dim: int, hidden: int = 32, n_blocks: int = 5, skips: Sequence[int] = (2,),
                 color: bool = False, emb: int = 93, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.skips = tuple(skips)
        self.B = nn.Parameter(torch.randn((3, emb), generator=generator) * 25.0)
        dims = [emb if i == 0 else (hidden + emb if (i - 1) in self.skips else hidden) for i in range(n_blocks)]
        self.pts = nn.ModuleList(nn.Linear(d, hidden) for d in dims)
        self.fc = nn.ModuleList(nn.Linear(c_dim, hidden) for _ in range(n_blocks)) if c_dim > 0 else None
        out_dim = 4 if color else 1
        self.out = nn.Linear(hidden, out_dim)
        gain = float(np.sqrt(2.0))
        for layer in [*self.pts, *(self.fc or [])]:
            _uniform_(layer.weight, gain * np.sqrt(6.0 / sum(layer.weight.shape)), generator)
            nn.init.zeros_(layer.bias)
        # 0.1x Xavier on the output layer: a full-scale head on random
        # decoders saturates the occupancy sigmoid at once
        _uniform_(self.out.weight, 0.1 * np.sqrt(6.0 / (hidden + out_dim)), generator)
        nn.init.zeros_(self.out.bias)

    def forward(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        emb = torch.sin(p @ self.B)
        h = emb
        for i, layer in enumerate(self.pts):
            h = F.relu(layer(h))
            if self.fc is not None:
                h = h + self.fc[i](c)
            if i in self.skips:
                h = torch.cat([emb, h], -1)
        return self.out(h)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The median of ``x`` over ``mask > 0``: ``sort(x)[count // 2]``, the
    upper one for an even count (``torch.median`` returns the lower); 0
    when the mask is empty."""
    big = torch.where(mask > 0, x, torch.full_like(x, float("inf")))
    order = torch.sort(big).values
    count = torch.sum(mask > 0)
    med = order[torch.clamp(count // 2, max=x.shape[0] - 1)]
    return torch.where(count > 0, med, torch.zeros_like(med))
