"""Positional encodings: multiresolution hash grid (reference form) and OneBlob.

Counterpart of ``xrdslam_tpu/ops/encodings.py``. The hash grid follows the
instant-NGP scheme of tcnn's 'HashGrid': L levels with geometric resolution
growth, F features per level, the (1, 2654435761, 805459861) XOR-prime hash
on levels whose dense grid exceeds the table and dense indexing otherwise,
and trilinear interpolation of the 8 corner features.

``hashgrid_encode`` here is the plain reference, differentiated by autograd
(so its position gradient is zero outside [0,1]^3, through the clamp). The
main path encodes through ``ops.hashgrid_fast``, whose kernels follow the
TPU kernels instead.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

PRIMES = (1, 2654435761, 805459861)
_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def constant(values: tuple, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made at the
    first call with these arguments and kept. A copy from the host cannot
    be captured into a CUDA graph, so the steps that a graph replays read
    their constant tables through this; the first call comes in the eager
    run before a capture. The tensor is shared: never write to it."""
    key = (tuple(values), dtype, torch.device(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return _CONSTANTS[key]
# corner c = (cx, cy, cz) in the reference order: cx slowest, cz fastest
CORNER_OFFSETS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


class HashGridSpec(NamedTuple):
    """Static metadata for a multiresolution hash grid."""

    n_levels: int
    n_features: int
    log2_table_size: int
    resolutions: Tuple[int, ...]  # per-level grid resolution
    dense: Tuple[bool, ...]  # per-level: dense indexing instead of hashing

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def hashgrid_spec(
    n_levels: int = 16,
    n_features: int = 2,
    log2_table_size: int = 16,
    base_resolution: int = 16,
    finest_resolution: int = 512,
) -> HashGridSpec:
    """Geometric level progression (per_level_scale of tcnn)."""
    if n_levels > 1:
        b = math.exp2(math.log2(finest_resolution / base_resolution) / (n_levels - 1))
    else:
        b = 1.0
    resolutions = tuple(int(math.floor(base_resolution * (b**l))) for l in range(n_levels))
    table = 1 << log2_table_size
    dense = tuple((r + 1) ** 3 <= table for r in resolutions)
    return HashGridSpec(n_levels, n_features, log2_table_size, resolutions, dense)


def hashgrid_init(spec: HashGridSpec, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """tcnn initializes hash tables U(-1e-4, 1e-4)."""
    t = torch.empty((spec.n_levels, spec.table_size, spec.n_features), dtype=torch.float32)
    return t.uniform_(-1e-4, 1e-4, generator=generator)


def grid_corners(xc: torch.Tensor, spec: HashGridSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner rows and per-axis weight factors of clamped x [N, 3], all levels.

    Returns (rows [N, L, 8] int64, the row of each corner in its level's
    table; wsel [N, L, 8, 3], the corner's trilinear factor along each
    axis: frac or 1 - frac). A corner's weight is the product of its three
    factors. The hash is computed in int64: the low bits of the int64
    products equal those of the reference's wrapping uint32 products, so
    ``& (T - 1)`` gives the same rows exactly.
    """
    dev = xc.device
    res = torch.tensor(spec.resolutions, dtype=xc.dtype, device=dev)  # [L]
    res_i = res.to(torch.int64)[None, :, None]
    pos = xc[:, None, :] * res[None, :, None]  # [N, L, 3]
    ix0 = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64), min=0), res_i - 1)
    frac = pos - ix0.to(pos.dtype)
    off = torch.tensor(CORNER_OFFSETS, device=dev)  # [8, 3]
    c = ix0[:, :, None, :] + off  # [N, L, 8, 3]
    stride = (res_i + 1)
    dense_rows = c[..., 0] + stride * (c[..., 1] + stride * c[..., 2])
    hash_rows = ((c[..., 0] * PRIMES[0]) ^ (c[..., 1] * PRIMES[1]) ^ (c[..., 2] * PRIMES[2])) & (spec.table_size - 1)
    rows = torch.where(torch.tensor(spec.dense, device=dev)[None, :, None], dense_rows, hash_rows)
    fr = frac[:, :, None, :]
    wsel = torch.where(off.bool(), fr, 1.0 - fr)
    return rows, wsel


def flat_rows(rows: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """[N, L, 8] per-level rows -> rows of the table viewed as [L*T, F]."""
    base = torch.arange(spec.n_levels, device=rows.device) * spec.table_size
    return rows + base[None, :, None]


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Encode normalized coords x in [0,1]^3 (values outside are clamped).

    Args:
        table: [L, T, F] feature table.
        x: [..., 3] coordinates.
    Returns:
        [..., L*F] concatenated per-level trilinear features.
    """
    batch_shape = x.shape[:-1]
    xc = torch.clamp(x.reshape(-1, 3), 0.0, 1.0)
    rows, wsel = grid_corners(xc, spec)
    w = wsel[..., 0] * wsel[..., 1] * wsel[..., 2]
    feats = table.reshape(-1, spec.n_features)[flat_rows(rows, spec)]  # [N, L, 8, F]
    return torch.sum(feats * w[..., None], dim=2).reshape(*batch_shape, spec.out_dim)


# ---------------------------------------------------------------------------
# OneBlob encoding
# ---------------------------------------------------------------------------

def _quartic_cdf(u: torch.Tensor) -> torch.Tensor:
    """CDF of the quartic kernel 15/16 (1-u^2)^2 on [-1, 1] (tcnn OneBlob)."""
    uc = torch.clamp(u, -1.0, 1.0)
    cdf = 0.5 + (15.0 / 16.0) * (uc - (2.0 / 3.0) * uc**3 + 0.2 * uc**5)
    return torch.where(u < -1.0, 0.0, torch.where(u > 1.0, 1.0, cdf))


def oneblob_encode(x: torch.Tensor, n_bins: int = 16) -> torch.Tensor:
    """OneBlob encoding: the mass a quartic kernel centred at each coordinate
    deposits into ``n_bins`` uniform bins. [..., D] -> [..., D * n_bins]."""
    batch_shape = x.shape[:-1]
    d = x.shape[-1]
    xf = torch.clamp(x.reshape(-1, d), 0.0, 1.0)
    edges = torch.arange(n_bins + 1, dtype=xf.dtype, device=xf.device) / n_bins
    sigma = 1.0 / n_bins
    u = (edges[None, None, :] - xf[..., None]) / sigma  # [n, d, n_bins+1]
    cdf = _quartic_cdf(u)
    feats = cdf[..., 1:] - cdf[..., :-1]
    return feats.reshape(*batch_shape, d * n_bins)
