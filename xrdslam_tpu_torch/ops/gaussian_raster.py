"""Tile rasterizer of isotropic gaussians, through hand-written CUDA kernels.

Counterpart of ``xrdslam_tpu/ops/gaussian_raster.py`` (its single-device
path; ``rasterize_dp`` is not ported). SplaTAM's gaussians are isotropic,
so a gaussian's footprint on screen is a circle, and one pass renders all
8 channels: rgb(3), depth, silhouette, depth^2 and two spare.

* ``bin_gaussians_device`` assigns the depth-sorted gaussians to the 16x16
  tiles they overlap, K per tile, nearest first (``bin_gaussians`` is the
  reference package's NumPy binner, copied for the tests).
* ``rasterize`` is a ``torch.autograd.Function``: its forward is K5
  (``raster_fwd``), its backward K6 (``raster_bwd``, which also reads the
  forward's image) and then K4 (``ops.scatter``) to sum each gaussian's
  per-tile gradients. ``rasterize_binned`` takes a ``Binning``, which keeps
  K4's ordering of its slots for every render that uses it.

The kernels are in ``kernels/gaussian_raster.cu``, whose header gives the
layouts, what bounds them on the card and what the design does about it.
Each wrapper chooses by the tensor's device: a CPU tensor goes to the
plain twin (``raster_fwd_torch`` / ``raster_bwd_torch``, written from the
reference's ``_alphas``, ``_transmittance`` and ``_suffix_sum``), a CUDA
tensor to the kernel, which raises if it cannot build or launch.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from .scatter import ScatterOrder, scatter_add_ordered, scatter_order

TILE = 16  # pixels per tile side
ALPHA_MAX = 0.99
N_CH = 8  # rgb(3), depth, sil, depth_sq, spare, spare
ROW = 16  # floats per tile slot: u, v, sigma, opacity, mask, ch0..7, 0, 0, 0

LAUNCHES: Dict[str, int] = {"raster_fwd": 0, "raster_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class TileBinning(NamedTuple):
    """Static-shape per-tile gaussian lists (host-built)."""

    tile_ids: np.ndarray  # [n_tiles, K] gaussian indices (depth-sorted)
    tile_mask: np.ndarray  # [n_tiles, K] validity
    n_tiles_x: int
    n_tiles_y: int


def bin_gaussians(
    u: np.ndarray, v: np.ndarray, depth: np.ndarray, radius: np.ndarray, alive: np.ndarray,
    height: int, width: int, k_per_tile: int = 256, margin: float = 8.0, max_span: int = 6,
) -> TileBinning:
    """The reference package's host binner, in NumPy: expand (gaussian,
    tile) pairs with a capped per-gaussian tile span, lexsort by (tile,
    depth rank) and fill fixed-K lists."""
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    n_tiles = ntx * nty
    valid = alive & (depth > 0.01) & np.isfinite(u) & np.isfinite(v) & (radius > 0)
    order = np.argsort(np.where(valid, depth, np.inf), kind="stable")
    order = order[valid[order]]
    ids_out = np.zeros((n_tiles, k_per_tile), np.int32)
    mask_out = np.zeros((n_tiles, k_per_tile), bool)
    if order.size == 0:
        return TileBinning(ids_out, mask_out, ntx, nty)
    uu, vv, rr = u[order], v[order], radius[order] + margin
    inside = (uu + rr >= 0) & (uu - rr < width) & (vv + rr >= 0) & (vv - rr < height)
    order, uu, vv, rr = order[inside], uu[inside], vv[inside], rr[inside]
    x0 = np.clip(((uu - rr) // TILE).astype(np.int64), 0, ntx - 1)
    x1 = np.clip(((uu + rr) // TILE).astype(np.int64), 0, ntx - 1)
    y0 = np.clip(((vv - rr) // TILE).astype(np.int64), 0, nty - 1)
    y1 = np.clip(((vv + rr) // TILE).astype(np.int64), 0, nty - 1)
    x1 = np.minimum(x1, x0 + max_span - 1)
    y1 = np.minimum(y1, y0 + max_span - 1)
    dx = np.arange(max_span)
    tx = x0[:, None, None] + dx[None, None, :]
    ty = y0[:, None, None] + dx[None, :, None]
    ok = (tx <= x1[:, None, None]) & (ty <= y1[:, None, None])
    tiles = (ty * ntx + tx).reshape(len(order), -1)
    ranks = np.broadcast_to(np.arange(len(order))[:, None], tiles.shape)
    gids = np.broadcast_to(order[:, None], tiles.shape)
    okf = ok.reshape(len(order), -1)
    tiles, ranks, gids = tiles[okf], ranks[okf], gids[okf]
    sort = np.lexsort((ranks, tiles))
    tiles, gids = tiles[sort], gids[sort]
    starts = np.searchsorted(tiles, np.arange(n_tiles), side="left")
    pos = np.arange(len(tiles)) - starts[tiles]
    keep = pos < k_per_tile
    ids_out[tiles[keep], pos[keep]] = gids[keep]
    mask_out[tiles[keep], pos[keep]] = True
    return TileBinning(ids_out, mask_out, ntx, nty)


def _tile_range(lo: torch.Tensor, hi_excl: int) -> torch.Tensor:
    """floor(lo / TILE) as int32, clipped to [0, hi_excl - 1]. The clip is
    done in float first, so that huge or non-finite values cannot overflow
    the cast (they belong to gaussians that are masked out anyway)."""
    t = torch.div(lo, TILE, rounding_mode="floor")
    t = torch.nan_to_num(t, nan=0.0).clamp(0.0, float(hi_excl - 1))
    return t.to(torch.int32)


@torch.no_grad()
def bin_gaussians_device(
    u: torch.Tensor, v: torch.Tensor, depth: torch.Tensor, radius: torch.Tensor, alive: torch.Tensor,
    height: int, width: int, k_per_tile: int = 256, margin: float = 8.0, max_span: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile binning on the device: (tile_ids [n_tiles, K] int32, tile_mask
    [n_tiles, K] bool), the same lists as the reference's
    ``bin_gaussians_device``: one stable depth sort, one stable sort by
    (tile, depth rank) with an int64 key, and a scatter into unique slots."""
    dev = u.device
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    n_tiles = ntx * nty
    G = u.shape[0]
    S = max_span * max_span
    valid = (alive > 0) & (depth > 0.01) & torch.isfinite(u) & torch.isfinite(v) & (radius > 0)
    rr = radius + margin
    valid &= (u + rr >= 0) & (u - rr < width) & (v + rr >= 0) & (v - rr < height)
    # depth rank: front-to-back compositing order; ties keep index order
    order = torch.argsort(torch.where(valid, depth, torch.full_like(depth, float("inf"))), stable=True)
    uu, vv, rro, val_o = u[order], v[order], rr[order], valid[order]
    x0 = _tile_range(uu - rro, ntx)
    x1 = torch.minimum(_tile_range(uu + rro, ntx), x0 + max_span - 1)
    y0 = _tile_range(vv - rro, nty)
    y1 = torch.minimum(_tile_range(vv + rro, nty), y0 + max_span - 1)
    span = torch.arange(max_span, dtype=torch.int32, device=dev)
    tx = x0[:, None, None] + span[None, None, :]
    ty = y0[:, None, None] + span[None, :, None]
    ok = (tx <= x1[:, None, None]) & (ty <= y1[:, None, None]) & val_o[:, None, None]
    tiles = torch.where(ok, ty.long() * ntx + tx.long(), n_tiles).reshape(-1)  # [G*S]
    ranks = torch.arange(G, dtype=torch.int64, device=dev)[:, None].expand(G, S).reshape(-1)
    gids = order.to(torch.int32)[:, None].expand(G, S).reshape(-1)
    sort_idx = torch.argsort(tiles * G + ranks, stable=True)
    tiles_s, gids_s = tiles[sort_idx], gids[sort_idx]
    starts = torch.searchsorted(tiles_s, torch.arange(n_tiles, dtype=torch.int64, device=dev))
    pos = torch.arange(G * S, dtype=torch.int64, device=dev) - starts[tiles_s.clamp(0, n_tiles - 1)]
    keep = (tiles_s < n_tiles) & (pos >= 0) & (pos < k_per_tile)
    # dropped entries go to one spare slot past the end; kept ones are unique
    dest = torch.where(keep, tiles_s * k_per_tile + pos, n_tiles * k_per_tile)
    flat_ids = torch.zeros(n_tiles * k_per_tile + 1, dtype=torch.int32, device=dev)
    flat_mask = torch.zeros(n_tiles * k_per_tile + 1, dtype=torch.bool, device=dev)
    flat_ids[dest] = gids_s
    flat_mask[dest] = keep
    return (flat_ids[:-1].reshape(n_tiles, k_per_tile), flat_mask[:-1].reshape(n_tiles, k_per_tile))


# ---------------------------------------------------------------------------
# plain twins (any device; the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _pixel_grid(n_tiles: int, ntx: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel centres of every tile, [n_tiles, 256, 1] each (x, y)."""
    t = torch.arange(n_tiles, device=device)[:, None]
    lin = torch.arange(TILE * TILE, device=device)[None, :]
    px = (lin % TILE + (t % ntx) * TILE).to(torch.float32)
    py = (lin // TILE + (t // ntx) * TILE).to(torch.float32)
    return px[..., None], py[..., None]


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp, with results under float32's smallest normal (arguments below
    -87) set to 0: torch's CPU exp is ~40x slower where its result
    underflows, and most (pixel, slot) pairs of a tile lie there."""
    return torch.where(x < -87.0, 0.0, torch.exp(torch.clamp(x, min=-87.0)))


def _alphas(gu, gv, gsig, gop, gmask, px, py):
    """alpha [T, P, K]: gaussian attributes [T, 1, K], pixels [T, P, 1]."""
    du = px - gu
    dv = py - gv
    inv2s2 = 0.5 / torch.clamp(gsig * gsig, min=1e-12)
    gauss = _exp(-(du * du + dv * dv) * inv2s2)
    alpha = torch.clamp(gop * gauss, 0.0, ALPHA_MAX)
    return torch.where(gmask, alpha, torch.zeros_like(alpha))


def _transmittance(alpha: torch.Tensor) -> torch.Tensor:
    """exp of the exclusive cumulative sum of log1p(-alpha) along K."""
    cs = torch.cumsum(torch.log1p(-alpha), dim=-1)
    return _exp(F.pad(cs[..., :-1], (1, 0)))


def _suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """suffix[k] = sum_{j>k} x[j], as total - inclusive cumsum."""
    return torch.sum(x, dim=-1, keepdim=True) - torch.cumsum(x, dim=-1)


def _slots(tiled: torch.Tensor):
    """Per-slot attribute rows [T, 1, K] (u, v, sigma, opacity, mask) and
    channels [T, K, N_CH]."""
    g = tiled.transpose(1, 2)[:, :, None, :]  # [T, 16, 1, K]
    return g[:, 0], g[:, 1], g[:, 2], g[:, 3], g[:, 4] > 0.5, tiled[:, :, 5:5 + N_CH]


def _tiles_to_image(x: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """[T, 256, C] per-tile pixels -> [16 nty, 16 ntx, C]."""
    c = x.shape[-1]
    return x.reshape(nty, ntx, TILE, TILE, c).permute(0, 2, 1, 3, 4).reshape(nty * TILE, ntx * TILE, c)


def _image_to_tiles(img: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """[16 nty, 16 ntx, C] -> [T, 256, C]."""
    c = img.shape[-1]
    return img.reshape(nty, TILE, ntx, TILE, c).permute(0, 2, 1, 3, 4).reshape(nty * ntx, TILE * TILE, c)


def raster_fwd_torch(tiled: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """tiled [T, K, 16] -> image [16 nty, 16 ntx, N_CH]."""
    gu, gv, gsig, gop, gmask, ch = _slots(tiled)
    px, py = _pixel_grid(tiled.shape[0], ntx, tiled.device)
    alpha = _alphas(gu, gv, gsig, gop, gmask, px, py)
    w = alpha * _transmittance(alpha)
    return _tiles_to_image(torch.einsum("tpk,tkc->tpc", w, ch), ntx, nty)


def raster_bwd_torch(tiled: torch.Tensor, gout: torch.Tensor, image: torch.Tensor, ntx: int,
                     nty: int) -> torch.Tensor:
    """(tiled [T, K, 16], gout [16 nty, 16 ntx, N_CH], image: the forward's
    output) -> per-slot gradients [T, K, 16] (d u, d v, d sigma, d opacity,
    0, d ch0..7, 0, 0, 0), zero for slots whose mask is off. The kernel
    forms each pixel's total contribution as gout . image; this twin forms
    it the reference's way, as the sum of the contributions, and does not
    read ``image``."""
    gu, gv, gsig, gop, gmask, ch = _slots(tiled)
    px, py = _pixel_grid(tiled.shape[0], ntx, tiled.device)
    gpx = _image_to_tiles(gout, ntx, nty)  # [T, P, C]
    du = px - gu
    dv = py - gv
    sig2 = torch.clamp(gsig * gsig, min=1e-12)  # [T, 1, K]
    r2 = du * du + dv * dv
    gauss = _exp(-r2 * (0.5 / sig2))
    raw_alpha = gop * gauss
    alpha = torch.where(gmask, torch.clamp(raw_alpha, 0.0, ALPHA_MAX), torch.zeros_like(raw_alpha))
    T = _transmittance(alpha)
    w = alpha * T
    dch = torch.einsum("tpc,tpk->tkc", gpx, w)
    gdotc = torch.einsum("tpc,tkc->tpk", gpx, ch)
    suffix = _suffix_sum(gdotc * w)
    dalpha = T * gdotc - suffix / torch.clamp(1.0 - alpha, min=1e-6)
    dalpha = torch.where((raw_alpha > ALPHA_MAX) | ~gmask, torch.zeros_like(dalpha), dalpha)
    d_common = dalpha * gop * gauss
    sig2, gsig = sig2[:, 0], gsig[:, 0]  # [T, K]
    zero = torch.zeros_like(sig2)
    dg = torch.cat([
        torch.stack([
            torch.sum(d_common * du, dim=1) / sig2,
            torch.sum(d_common * dv, dim=1) / sig2,
            torch.sum(d_common * r2, dim=1) / (sig2 * torch.clamp(gsig, min=1e-6)),
            torch.sum(dalpha * gauss, dim=1),
            zero,
        ], -1),
        dch,
        zero[..., None].expand(*zero.shape, ROW - 5 - N_CH),
    ], -1)
    return dg * gmask[:, 0, :, None]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_p, _i = ctypes.c_void_p, ctypes.c_int
_FWD = kernels.Kernel("gaussian_raster", "xr_raster_fwd", [_p, _p, _i, _i, _i, _p])
_BWD = kernels.Kernel("gaussian_raster", "xr_raster_bwd", [_p, _p, _p, _p, _i, _i, _i, _p])


def _check_cuda(t: torch.Tensor, shape, what: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous float32 {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{what} must be 16-byte aligned: the kernels read it as float4")


def raster_fwd(tiled: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """tiled [T, K, 16] -> image [16 nty, 16 ntx, N_CH]: K5 on CUDA, twin on CPU."""
    if kernels.on_cpu(tiled, "raster_fwd"):
        return raster_fwd_torch(tiled, ntx, nty)
    n_tiles, k = tiled.shape[0], tiled.shape[1]
    if n_tiles != ntx * nty:
        raise ValueError(f"{n_tiles} tiles do not make a {nty} x {ntx} grid")
    _check_cuda(tiled, (n_tiles, k, ROW), "tiled")
    out = torch.empty((nty * TILE, ntx * TILE, N_CH), dtype=torch.float32, device=tiled.device)
    _FWD(tiled.data_ptr(), out.data_ptr(), n_tiles, k, ntx, kernels.stream(tiled))
    LAUNCHES["raster_fwd"] += 1
    return out


def raster_bwd(tiled: torch.Tensor, gout: torch.Tensor, image: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """(tiled [T, K, 16], gout [16 nty, 16 ntx, N_CH], image: ``raster_fwd``
    of ``tiled``) -> [T, K, 16]: K6 on CUDA, twin on CPU."""
    if kernels.on_cpu(tiled, "raster_bwd"):
        return raster_bwd_torch(tiled, gout, image, ntx, nty)
    n_tiles, k = tiled.shape[0], tiled.shape[1]
    if n_tiles != ntx * nty:
        raise ValueError(f"{n_tiles} tiles do not make a {nty} x {ntx} grid")
    gout = gout.contiguous()  # autograd hands on the slice img[:H, :W]'s padded cotangent
    _check_cuda(tiled, (n_tiles, k, ROW), "tiled")
    _check_cuda(gout, (nty * TILE, ntx * TILE, N_CH), "gout")
    _check_cuda(image, (nty * TILE, ntx * TILE, N_CH), "image")
    dg = torch.empty_like(tiled)
    _BWD(tiled.data_ptr(), gout.data_ptr(), image.data_ptr(), dg.data_ptr(), n_tiles, k, ntx, kernels.stream(tiled))
    LAUNCHES["raster_bwd"] += 1
    return dg


def _pack_tile_data(u, v, sigma, opacity, channels, tile_ids, tile_mask) -> torch.Tensor:
    """Gather per-tile gaussian attributes -> [T, K, 16]."""
    G = u.shape[0]
    data = torch.cat([
        u[:, None], v[:, None], sigma[:, None], opacity[:, None],
        torch.ones_like(u[:, None]),  # placeholder for the mask
        channels,
        torch.zeros((G, ROW - 5 - channels.shape[1]), dtype=u.dtype, device=u.device),
    ], -1)
    tiled = torch.index_select(data, 0, tile_ids.reshape(-1)).reshape(*tile_ids.shape, ROW)
    tiled[:, :, 4] = tile_mask.to(u.dtype)
    return tiled


class Binning:
    """A tile binning held fixed over several renders: ``tile_ids`` [T, K]
    int32 and ``tile_mask`` [T, K] bool from ``bin_gaussians_device``
    (unpacks as that pair). The backward's K4 ordering of its live slots is
    built at the first backward and kept for every later one, unless one
    is given."""

    def __init__(self, tile_ids: torch.Tensor, tile_mask: torch.Tensor, order: Optional[ScatterOrder] = None):
        self.tile_ids, self.tile_mask = tile_ids, tile_mask
        self._order = order

    def __iter__(self):
        return iter((self.tile_ids, self.tile_mask))

    def order(self, n_gauss: int) -> ScatterOrder:
        """K4's ordering of the slots into ``n_gauss`` rows, masked slots
        left out: their rows of K6's output are zeros."""
        if self._order is None or self._order.num_rows != n_gauss:
            ids = torch.where(self.tile_mask, self.tile_ids, torch.full_like(self.tile_ids, -1))
            self._order = scatter_order(ids.reshape(-1), n_gauss)
        return self._order


class WindowBinning:
    """The binnings of a window of frames (``tile_ids`` / ``tile_mask``
    [W, T, K]) with each one's K4 ordering, all built at once, so that a
    frame picked on the device (``pick``) renders and differentiates with
    no host sync."""

    def __init__(self, tile_ids: torch.Tensor, tile_mask: torch.Tensor, n_gauss: int):
        self.tile_ids, self.tile_mask = tile_ids, tile_mask
        orders = [Binning(tile_ids[i], tile_mask[i]).order(n_gauss) for i in range(tile_ids.shape[0])]
        self._rows = [torch.stack([getattr(o, f) for o in orders]) for f in ("idx", "keys", "perm", "row_ptr")]
        self._num_rows, self._slots = n_gauss, orders[0].slots

    def pick(self, fi: torch.Tensor) -> Binning:
        """The binning of window row ``fi`` (an index tensor of one entry)."""
        idx, keys, perm, row_ptr = (torch.index_select(r, 0, fi)[0] for r in self._rows)
        return Binning(torch.index_select(self.tile_ids, 0, fi)[0], torch.index_select(self.tile_mask, 0, fi)[0],
                       ScatterOrder(idx, keys, perm, row_ptr, self._num_rows, self._slots))


class _Rasterize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, sigma, opacity, channels, binning: Binning, ntx: int, nty: int):
        tiled = _pack_tile_data(u, v, sigma, opacity, channels, binning.tile_ids, binning.tile_mask)
        image = raster_fwd(tiled, ntx, nty)
        ctx.save_for_backward(tiled, image)
        ctx.grid = (ntx, nty)
        ctx.n_gauss = u.shape[0]
        ctx.binning = binning
        return image

    @staticmethod
    def backward(ctx, gout):
        tiled, image = ctx.saved_tensors
        dg = raster_bwd(tiled, gout, image, *ctx.grid)  # masked slots are zero
        acc = scatter_add_ordered(ctx.binning.order(ctx.n_gauss), dg.reshape(-1, ROW))  # [G, 16]
        return acc[:, 0], acc[:, 1], acc[:, 2], acc[:, 3], acc[:, 5:5 + N_CH], None, None, None


def rasterize_binned(u, v, sigma, opacity, channels, binning: Binning, ntx: int, nty: int) -> torch.Tensor:
    """Rasterize projected gaussians to [16 nty, 16 ntx, N_CH].

    u, v: [G] pixel centres; sigma: [G] screen-space std (px); opacity:
    [G]; channels: [G, N_CH]; ``binning`` held fixed (not differentiated).
    """
    return _Rasterize.apply(u, v, sigma, opacity, channels, binning, ntx, nty)


def rasterize(u, v, sigma, opacity, channels, tile_ids, tile_mask, ntx: int, nty: int) -> torch.Tensor:
    """``rasterize_binned`` on a binning used once: tile_ids [T, K] int32 /
    tile_mask [T, K] bool from ``bin_gaussians_device``."""
    return rasterize_binned(u, v, sigma, opacity, channels, Binning(tile_ids, tile_mask), ntx, nty)
