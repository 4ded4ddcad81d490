"""Packed patch-row hash-grid encoding: the Co-SLAM registry's default.

Counterpart of ``xrdslam_tpu/ops/hashgrid_packed.py``. The table is laid
out so that ONE gathered row per level holds the whole 2x2x2 corner patch
of a sample's cell (8F floats), and the table gradient is one scattered row
per sample per level.

* Dense levels ((res+1)^3 <= T): exact. The parameter stays the per-vertex
  grid ``v{l}`` ``[(R+1)^3, F]``; the patch table ``[R^3, 8F]`` (row
  ``x R^2 + y R + z`` over cells) is rebuilt from its slices in each
  encode, so its gradient reaches ``v{l}`` by autograd through the pack.
* Hash levels: ``h{l}`` ``[T, 8F]`` is keyed by the hash of the BASE cell
  and stores the full patch, so collisions alias patches, not vertices.
  This is the reference package's own layout, kept for parity.

The gather and its backward are one ``torch.autograd.Function`` with the
reference's rule (``_gl_fwd`` / ``_gl_bwd``): the backward reuses the
gathered rows (and the row ids and fractions), its dx is zeroed outside the open box (0, 1)^3 on the
unclipped x (unlike K2 and K9), and each level's table gradient is
``zeros.at[rid].add(w g)``: one ``ops.scatter.scatter_add`` (K4 on the
card) sums every level at once into the levels' tables stacked row-wise,
each level's row ids offset by the rows before it (the same sums, in the
same order, as one scatter per level). The reference's
``_widened_segsum`` / ``_scatter_k`` (a TPU segment-count trick with the
same sum) and its ``_good_rows`` padding
(fast gather sizes on the TPU; no padded row is ever gathered) are not
ported.

Cell arithmetic, weights, row ids and the table gradients run for all
levels at once; only the per-level gathers loop.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .encodings import PRIMES, HashGridSpec, constant
from .scatter import scatter_add


def packed_init(spec: HashGridSpec, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """U(-1e-4, 1e-4) tables, drawn level by level: ``v{l}`` [(R+1)^3, F]
    for a dense level, ``h{l}`` [T, 8F] for a hash level."""
    tables: Dict[str, torch.Tensor] = {}
    f = spec.n_features
    for l in range(spec.n_levels):
        r = spec.resolutions[l]
        if spec.dense[l]:
            name, shape = f"v{l}", ((r + 1) ** 3, f)
        else:
            name, shape = f"h{l}", (spec.table_size, 8 * f)
        tables[name] = torch.empty(shape, dtype=torch.float32).uniform_(-1e-4, 1e-4, generator=generator)
    return tables


def _pack_dense(vertex: torch.Tensor, res: int, f: int) -> torch.Tensor:
    """[(R+1)^3, F] vertex grid -> [R^3, 8F] patch rows: row (x R^2 + y R +
    z) holds V(x+i, y+j, z+k) in slot c = 4i + 2j + k."""
    r1 = res + 1
    v = vertex.reshape(r1, r1, r1, f)
    slots = [v[i:i + res, j:j + res, k:k + res] for i in (0, 1) for j in (0, 1) for k in (0, 1)]
    return torch.cat(slots, -1).reshape(res ** 3, 8 * f)


def pack_gather_tables(tables: Dict[str, torch.Tensor], spec: HashGridSpec) -> Tuple[torch.Tensor, ...]:
    """Per-level gather operands: the hash levels' tables as they are, the
    dense levels packed from their vertex grids (differentiable)."""
    return tuple(_pack_dense(tables[f"v{l}"], spec.resolutions[l], spec.n_features) if spec.dense[l]
                 else tables[f"h{l}"] for l in range(spec.n_levels))


def _cells(xc: torch.Tensor, spec: HashGridSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamped x [N, 3] -> (row ids [N, L] int64, frac [N, L, 3]). Dense rows index cells (x R^2 + y R + z);
    hash rows hash the base cell with the XOR primes, in int64, whose low
    bits equal the reference's wrapping uint32 products."""
    res = constant(spec.resolutions, xc.dtype, xc.device)
    res_i = res.to(torch.int64)
    pos = xc[:, None, :] * res[None, :, None]  # [N, L, 3]
    ix0 = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64), min=0), res_i[None, :, None] - 1)
    frac = pos - ix0.to(pos.dtype)
    dense_rows = (ix0[..., 0] * res_i + ix0[..., 1]) * res_i + ix0[..., 2]
    hash_rows = ((ix0[..., 0] * PRIMES[0]) ^ (ix0[..., 1] * PRIMES[1]) ^ (ix0[..., 2] * PRIMES[2])) & (
        spec.table_size - 1)
    dense = constant(spec.dense, None, xc.device)
    return torch.where(dense[None, :], dense_rows, hash_rows), frac


def _axis_weights(frac: torch.Tensor) -> torch.Tensor:
    """frac [..., 3] -> [..., 3, 2]: (1 - f, f) per axis."""
    return torch.stack([1.0 - frac, frac], -1)


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """frac [N, L, 3] -> w [N, L, 8] in slot order c = 4i + 2j + k."""
    a = _axis_weights(frac)
    wx, wy, wz = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    return (wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]).flatten(-3)


def stacked_rows(rid: torch.Tensor, n_rows: Sequence[int]) -> Tuple[torch.Tensor, List[int]]:
    """Row ids [N, L] into each level's table -> (ids [N*L] int32 into the
    tables stacked row-wise, point-major; the first row of each level and
    the total, L + 1 offsets)."""
    offsets = [0]
    for rows in n_rows:
        offsets.append(offsets[-1] + rows)
    first = constant(offsets[:-1], rid.dtype, rid.device)
    return (rid + first).to(torch.int32).reshape(-1), offsets


class _GatherLerp(torch.autograd.Function):
    """One patch row per level, trilinearly weighted; the reference's
    custom backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, spec: HashGridSpec, x: torch.Tensor, *packed: torch.Tensor) -> torch.Tensor:
        n, f = x.shape[0], spec.n_features
        rid, frac = _cells(torch.clamp(x, 0.0, 1.0), spec)
        rows = torch.stack([packed[l][rid[:, l]] for l in range(spec.n_levels)], 1)  # [N, L, 8F]
        w = _corner_weights(frac)
        # products and sums, not einsum: on the card einsum's batched
        # contractions over 8 corners become one gemv per batch
        out = torch.sum(rows.reshape(n, spec.n_levels, 8, f) * w[..., None], 2)
        ctx.spec = spec
        ctx.n_rows = [p.shape[0] for p in packed]
        ctx.save_for_backward(x, rows, rid, frac)
        return out.reshape(n, spec.out_dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        spec: HashGridSpec = ctx.spec
        x, rows, rid, frac = ctx.saved_tensors
        n, f, L = x.shape[0], spec.n_features, spec.n_levels
        gl = g.reshape(n, L, f)
        d_packed: List[Optional[torch.Tensor]] = [None] * L
        if any(ctx.needs_input_grad[2:]):
            vals = (_corner_weights(frac)[..., None] * gl[:, :, None, :]).reshape(n * L, 8 * f)
            ids, offsets = stacked_rows(rid, ctx.n_rows)
            stacked = scatter_add(ids, vals, offsets[-1])
            for l in range(L):
                if ctx.needs_input_grad[2 + l]:
                    d_packed[l] = stacked[offsets[l]:offsets[l + 1]]
        dx = None
        if ctx.needs_input_grad[1]:
            # g . f per corner [N, L, 2, 2, 2], then the derivative of the
            # trilinear weights along each axis: (f1 - f0) of that axis
            # times the other two axes' weights
            g8 = torch.sum(rows.reshape(n, L, 8, f) * gl[:, :, None, :], -1).reshape(n, L, 2, 2, 2)
            a = _axis_weights(frac)
            wx, wy, wz = a[..., 0, :], a[..., 1, :], a[..., 2, :]
            dfx = torch.sum((g8[:, :, 1] - g8[:, :, 0]) * wy[..., :, None] * wz[..., None, :], (-2, -1))
            dfy = torch.sum((g8[:, :, :, 1] - g8[:, :, :, 0]) * wx[..., :, None] * wz[..., None, :], (-2, -1))
            dfz = torch.sum((g8[..., 1] - g8[..., 0]) * wx[..., :, None] * wy[..., None, :], (-2, -1))
            res = constant(spec.resolutions, x.dtype, x.device)
            in_range = ((x > 0.0) & (x < 1.0)).to(x.dtype)
            dx = torch.sum(torch.stack([dfx, dfy, dfz], -1) * res[None, :, None], 1) * in_range
        return (None, dx, *d_packed)


def packed_hash_encode(tables: Dict[str, torch.Tensor], x: torch.Tensor, spec: HashGridSpec,
                       packed: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """tables (see :func:`packed_init`), x [..., 3] in [0,1] -> [..., L*F].

    ``packed``: a result of :func:`pack_gather_tables` to use instead of
    packing here; it is detached, so only d/dx flows (tracking)."""
    if packed is None:
        packed = pack_gather_tables(tables, spec)
    else:
        packed = tuple(p.detach() for p in packed)
    batch_shape = x.shape[:-1]
    out = _GatherLerp.apply(spec, x.reshape(-1, 3), *packed)
    return out.reshape(*batch_shape, spec.out_dim)
