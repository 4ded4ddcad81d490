"""Trilinear sampling of dense feature grids, with K4 as the grids' gradient.

Counterpart of ``xrdslam_tpu/ops/trilinear.py``. A grid is stored
channel-last ``[X, Y, Z, C]`` and sampled with align-corners and border
semantics: a normalized coordinate u in [-1, 1] maps to the index
(u + 1) / 2 (S - 1), clamped to the grid. The 8 corners of every point are
fetched with one ``ops.scatter.table_lookup`` on the flattened grid, so a
grid's backward is one scatter-add (K4 on the card, summed in a fixed
order); the blend, a weighted sum of the corners by their trilinear
weights (the reference nests seven lerps: the same function, summed in
another order), is plain torch, so that the gradient to the coordinates
flows through the fractions.
"""
from __future__ import annotations

import torch

from .scatter import table_lookup


def grid_corners(shape, coords: torch.Tensor):
    """The cells of normalized coords [N, 3] in a grid of ``shape`` (X, Y,
    Z): the flat ids of their 8 corners [N, 8] (c000, c001, c010, c011,
    c100, c101, c110, c111; the last bit is z) and the fractions (fx, fy,
    fz), each [N, 1]."""
    X, Y, Z = shape
    # per axis with the sizes as Python numbers: no host-to-device copy, so
    # that a CUDA graph can capture the sampling
    i0, frac = [], []
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    for a, s in enumerate((X, Y, Z)):
        # maximum/minimum, not clamp: on the border itself they pass half
        # the gradient, as the reference's clip does
        pos = torch.minimum(torch.maximum((coords[:, a] + 1.0) * 0.5 * (s - 1.0), zero), zero + (s - 1.0))
        # the lower corner is at most S - 2, so that a point on the far
        # border takes fraction 1 of the last cell
        i = torch.clamp(torch.floor(pos).to(torch.int32), max=max(s - 2, 0))
        i0.append(i)
        frac.append((pos - i.to(pos.dtype))[:, None])
    # [N, 2] lower and upper index per axis, combined by broadcasting
    xs, ys, zs = (torch.stack([i, torch.clamp(i + 1, max=s - 1)], -1) for i, s in zip(i0, (X, Y, Z)))
    ids = ((xs[:, :, None, None] * Y + ys[:, None, :, None]) * Z + zs[:, None, None, :]).reshape(-1, 8)
    return ids, frac


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor, corners=None) -> torch.Tensor:
    """Sample grid [X, Y, Z, C] at normalized coords [..., 3] in [-1, 1]:
    coords[..., i] indexes grid axis i. Returns [..., C]. ``corners`` is
    ``grid_corners`` of the grid's shape at these coords, where a caller
    samples several grids of one shape."""
    X, Y, Z, C = grid.shape
    shape = coords.shape[:-1]
    ids, (fx, fy, fz) = corners or grid_corners((X, Y, Z), coords.reshape(-1, 3))
    c = table_lookup(grid.reshape(-1, C), ids)  # [N, 8, C]
    # the trilinear weights of the 8 corners [N, 8], then one weighted sum:
    # a few kernels forward and backward, where the nested lerps of the
    # reference take ~90 with their broadcast gradients
    wx, wy, wz = (torch.cat([1 - f, f], -1) for f in (fx, fy, fz))
    w = (wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]).reshape(-1, 1, 8)
    return torch.bmm(w, c).reshape(*shape, C)


def normalize_3d_coordinate(p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """World [..., 3] -> [-1, 1] per axis over ``bound`` [3, 2]."""
    lo, hi = bound[:, 0], bound[:, 1]
    return (p - lo) / (hi - lo) * 2.0 - 1.0
