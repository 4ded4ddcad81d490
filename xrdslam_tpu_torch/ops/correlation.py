"""Patch correlation over feature maps (DPVO's correlation features).

Counterpart of ``xrdslam_tpu/ops/correlation.py``: each patch's P x P
feature vectors correlate with a (2r+1)^2 window of bilinearly sampled
features around the patch's reprojected location in its target frame. At
DPVO's sizes (P = 3, r = 3, two pyramid levels) that gives the update
operator 2 x 9 x 49 = 882 features an edge.

Plain torch, as the reference's is plain XLA. A bilinear sample reads its
four taps with zero padding outside the map. The correlation uses that a
window's offsets are whole pixels: every sample of a patch pixel's window
shares the pixel's fractional position, so the dot products are taken
once on the (2r+2)^2 whole-pixel grid around it (rows of a channels-last
copy of the maps, zero outside the map, contracted with the patch
feature in one batched product) and then blended, four grid values for
each window cell, with the bilinear weights. That reads 64 feature rows
for each patch pixel where sampling each cell reads 196, and it is the
same function: the dot product of a blend is the blend of the dot
products (float32 sums in another order).

Both gathers, the correlation's rows and a bilinear sample's four taps
(one gather for all four), go through ``ops.scatter.table_lookup``: their
forward is plain indexing, and the gradient of the maps, which DPVO's
training takes, is K4 on the card rather than torch's indexing backward.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .scatter import table_lookup


def bilinear_sample(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """fmap [C, H, W]; coords [..., 2] (x, y) -> [..., C]. Zero padding."""
    C, H, W = fmap.shape
    rows = fmap.reshape(C, H * W).t()
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    taps = ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)), (0, 1, (1 - fx) * fy), (1, 1, fx * fy))
    ids, wts = [], []
    for dx, dy, w in taps:
        xi, yi = x0i + dx, y0i + dy
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        ids.append(yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        wts.append(w * inb.to(w.dtype))
    v = table_lookup(rows, torch.stack(ids, -1))  # [..., 4, C]: the four taps in one gather
    out = v[..., 0, :] * wts[0][..., None]
    for k in range(1, 4):
        out = out + v[..., k, :] * wts[k][..., None]
    return out


def channels_last(fmaps: torch.Tensor) -> torch.Tensor:
    """[F, C, H, W] maps -> [F * H * W, C] rows, the layout the correlation reads."""
    F, C, H, W = fmaps.shape
    return fmaps.permute(0, 2, 3, 1).reshape(F * H * W, C)


def _correlate_rows(rows: torch.Tensor, hw: Tuple[int, int], gpatches: torch.Tensor, coords: torch.Tensor,
                    jj: torch.Tensor, radius: int) -> torch.Tensor:
    """``patch_correlation`` on maps already in ``channels_last`` rows."""
    H, W = hw
    E, C, P, _ = gpatches.shape
    side = 2 * radius + 2  # the whole-pixel grid under a window and its bilinear taps
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None, None], (y - y0)[..., None, None]
    d = torch.arange(-radius, radius + 2, device=coords.device)
    xi = x0.to(torch.int64)[..., None, None] + d  # [E, P, P, 1, side]
    yi = y0.to(torch.int64)[..., None, None] + d[:, None]  # [E, P, P, side, 1]
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    flat = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1) + (jj.to(torch.int64) * (H * W)).reshape(E, 1, 1, 1, 1)
    g = gpatches.permute(0, 2, 3, 1).reshape(E * P * P, C, 1)
    grid = torch.bmm(table_lookup(rows, flat.reshape(E * P * P, side * side)), g).reshape(E, P, P, side, side)
    grid = grid * inb.to(grid.dtype)
    out = ((1 - fx) * (1 - fy) * grid[..., :-1, :-1] + fx * (1 - fy) * grid[..., :-1, 1:]
           + (1 - fx) * fy * grid[..., 1:, :-1] + fx * fy * grid[..., 1:, 1:])
    return out / float(C) ** 0.5


def patch_correlation(fmaps: torch.Tensor, gpatches: torch.Tensor, coords: torch.Tensor, jj: torch.Tensor,
                      radius: int = 3) -> torch.Tensor:
    """Correlate patch features with windows around reprojected locations.

    fmaps [F, C, H, W] (one pyramid level); gpatches [E, C, P, P]; coords
    [E, P, P, 2] (x, y) in the target frame's scale; jj [E] the target
    frame -> corr [E, P, P, 2r+1, 2r+1], divided by sqrt(C).
    """
    return _correlate_rows(channels_last(fmaps), fmaps.shape[2:], gpatches, coords, jj, radius)


def patch_correlation_chunked(fmaps: torch.Tensor, gpatches: torch.Tensor, coords: torch.Tensor, jj: torch.Tensor,
                              radius: int = 3, chunk: int = 2048) -> torch.Tensor:
    """``patch_correlation`` over chunks of ``chunk`` edges (the last may be
    shorter), so that the peak memory is one chunk's."""
    rows, hw = channels_last(fmaps), fmaps.shape[2:]
    return torch.cat([_correlate_rows(rows, hw, gpatches[s:s + chunk], coords[s:s + chunk], jj[s:s + chunk], radius)
                      for s in range(0, gpatches.shape[0], chunk)])


def extract_patches(fmap: torch.Tensor, centers: torch.Tensor, p: int = 3) -> torch.Tensor:
    """P x P feature patches bilinearly sampled at subpixel ``centers``:
    fmap [C, H, W], centers [M, 2] -> [M, C, P, P]."""
    d = torch.arange(p, dtype=torch.float32, device=fmap.device) - (p - 1) / 2.0
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    pts = centers[:, None, None, :] + torch.stack([dx, dy], -1)
    return bilinear_sample(fmap, pts).permute(0, 3, 1, 2)
