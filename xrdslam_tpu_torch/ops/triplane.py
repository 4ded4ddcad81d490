"""Tri-plane scene encoding: the encoding of the Co-SLAM accuracy protocol.

Counterpart of ``xrdslam_tpu/ops/triplane.py``. Each scale ``s`` holds
three feature planes ``s{s}`` ``[3, R, R, C]`` over the axis pairs (0,1),
(0,2), (1,2); a point's feature is the bilinear blend of its cell's four
corners on each plane, concatenated scale-major, then plane by plane (the
SDF MLP's first layer reads them in that order).

* Gather: each plane is packed as one 2x2 corner patch per cell
  (``[R*R, 4C]``, the rolls of ``_pack_patch``), so one gathered row gives
  all four corners. The packed copy is built from DETACHED planes; its
  cotangent is zero, as in the reference, and the planes' gradient comes
  only from the backward rule.
* Backward (the reference's ``_tp_bwd``): the planes' gradient is the
  moment trick, one scattered row of [g, fu g, fv g, fu fv g] per point into
  its base cell, followed by the exact 2x2 deconvolution of the moment
  field. One ``ops.scatter.scatter_add`` (K4 on the card) splats every
  plane of every scale at once into their cells stacked row-wise (all
  scales have 4C = 32 moments a cell in the registry; scales of another
  width get a scatter each); dx comes from the saved corners, with NO mask
  outside [0,1]^3.

The reference's ``_good_rows`` padding (fast gather sizes on the TPU) is not
ported: no padded row is ever gathered.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .scatter import scatter_add

PLANES = ((0, 1), (0, 2), (1, 2))


class TriplaneSpec(NamedTuple):
    resolutions: Tuple[int, ...]  # per scale
    n_features: Tuple[int, ...]  # per scale (per plane)

    @property
    def out_dim(self) -> int:
        return 3 * sum(self.n_features)


def triplane_spec(resolutions=(128, 512), n_features=(8, 8)) -> TriplaneSpec:
    return TriplaneSpec(tuple(resolutions), tuple(n_features))


def triplane_init(spec: TriplaneSpec, generator: Optional[torch.Generator] = None,
                  std: float = 1e-4) -> Dict[str, torch.Tensor]:
    """N(0, std^2) planes ``s{s}`` [3, R, R, C], drawn scale by scale."""
    return {f"s{s}": torch.randn((3, R, R, C), generator=generator) * std
            for s, (R, C) in enumerate(zip(spec.resolutions, spec.n_features))}


def _cells(x: torch.Tensor, R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, 3] -> (cell origin [N, 3] int64 in [0, R-2], fraction [N, 3])
    on the R-vertex grid of each axis (the reference's ``_plane_uv``)."""
    u = torch.clamp(x, 0.0, 1.0) * (R - 1)
    u0 = torch.clamp(torch.floor(u), 0, R - 2)
    return u0.to(torch.int64), u - u0


def _pack_patch(plane: torch.Tensor) -> torch.Tensor:
    """[R, R, C] -> [R*R, 4C]: row (u0 R + v0) holds [P(u0,v0) | P(u0,v0+1) |
    P(u0+1,v0) | P(u0+1,v0+1)]. The wrapped last row and column are never
    gathered (u0, v0 <= R-2)."""
    R = plane.shape[0]
    p01 = torch.roll(plane, -1, dims=1)
    p10 = torch.roll(plane, -1, dims=0)
    p11 = torch.roll(p10, -1, dims=1)
    return torch.cat([plane, p01, p10, p11], -1).reshape(R * R, -1)


def triplane_pack(tables: Dict[str, torch.Tensor], spec: TriplaneSpec) -> Dict[str, torch.Tensor]:
    """The packed 2x2-patch gather tables ``s{s}`` [3, R*R, 4C] of the
    detached planes."""
    return {f"s{s}": torch.stack([_pack_patch(tables[f"s{s}"][p].detach()) for p in range(3)])
            for s in range(len(spec.resolutions))}


def _splat(cells: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]]) -> List[torch.Tensor]:
    """The moment fields [R*R, 4C] of each plane (rows [N] int64, fu [N], fv
    [N], g [N, C], R): every point's row [g, fu g, fv g, fu fv g] added into
    its base cell. One K4 launch per moment width over the planes stacked
    row-wise."""
    out: List[Optional[torch.Tensor]] = [None] * len(cells)
    for width in sorted({g.shape[1] for *_, g, _ in cells}):
        group = [i for i, (*_, g, _) in enumerate(cells) if g.shape[1] == width]
        n = cells[group[0]][0].shape[0]
        moments = torch.empty((len(group) * n, 4 * width), dtype=cells[group[0]][3].dtype,
                              device=cells[group[0]][3].device)
        rows, first = [], [0]
        for k, i in enumerate(group):
            r, fu, fv, g, R = cells[i]
            torch.cat([g, g * fu[:, None], g * fv[:, None], g * (fu * fv)[:, None]], -1,
                      out=moments[k * n:(k + 1) * n])
            rows.append(r + first[-1])
            first.append(first[-1] + R * R)
        M = scatter_add(torch.cat(rows).to(torch.int32), moments, first[-1])
        for k, i in enumerate(group):
            out[i] = M[first[k]:first[k + 1]]
    return out


def _deconvolve(M: torch.Tensor, R: int) -> torch.Tensor:
    """The exact bilinear splat into an [R, R, C] plane from its moment
    field M [R*R, 4C]: the 2x2 deconvolution (the corner weights are
    bilinear in (fu, fv))."""
    M = M.reshape(R, R, 4, -1)
    m00, m10, m01, m11 = M[:, :, 0], M[:, :, 1], M[:, :, 2], M[:, :, 3]
    d = m00 - m10 - m01 + m11
    d = d + F.pad((m10 - m11)[:-1], (0, 0, 0, 0, 1, 0))
    d = d + F.pad((m01 - m11)[:, :-1], (0, 0, 1, 0, 0, 0))
    return d + F.pad(m11[:-1, :-1], (0, 0, 1, 0, 1, 0))


class _EncodeCore(torch.autograd.Function):
    """Forward from the packed copy; the reference's backward rule."""

    @staticmethod
    def forward(ctx, spec: TriplaneSpec, x: torch.Tensor, packed: List[torch.Tensor], *tables: torch.Tensor):
        outs, corners = [], []
        for s, (R, C) in enumerate(zip(spec.resolutions, spec.n_features)):
            u0, fr = _cells(x, R)
            for p, (a, b) in enumerate(PLANES):
                c = packed[s][p][u0[:, a] * R + u0[:, b]]  # [N, 4C]
                f00, f01, f10, f11 = c[:, :C], c[:, C:2 * C], c[:, 2 * C:3 * C], c[:, 3 * C:]
                fu, fv = fr[:, a:a + 1], fr[:, b:b + 1]
                outs.append(f00 * ((1 - fu) * (1 - fv)) + f01 * ((1 - fu) * fv) + f10 * (fu * (1 - fv))
                            + f11 * (fu * fv))
                corners.append(c)
        ctx.spec = spec
        ctx.save_for_backward(x, *corners)
        return torch.cat(outs, -1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        spec: TriplaneSpec = ctx.spec
        x, *corners = ctx.saved_tensors
        dx = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        cells = []  # (rows, fu, fv, g, R) of each plane to splat
        off = ci = 0
        for s, (R, C) in enumerate(zip(spec.resolutions, spec.n_features)):
            u0, fr = _cells(x, R)
            for a, b in PLANES:
                gk = g[:, off:off + C]
                off += C
                fu, fv = fr[:, a], fr[:, b]
                if ctx.needs_input_grad[3 + s]:
                    cells.append((u0[:, a] * R + u0[:, b], fu, fv, gk, R))
                if dx is not None:
                    c = corners[ci]
                    f00, f01, f10, f11 = c[:, :C], c[:, C:2 * C], c[:, 2 * C:3 * C], c[:, 3 * C:]
                    dfu = (f10 - f00) * (1 - fv)[:, None] + (f11 - f01) * fv[:, None]
                    dfv = (f01 - f00) * (1 - fu)[:, None] + (f11 - f10) * fu[:, None]
                    dx[:, a] += torch.sum(gk * dfu, -1) * (R - 1.0)
                    dx[:, b] += torch.sum(gk * dfv, -1) * (R - 1.0)
                ci += 1
        splats = iter(_splat(cells))
        dtables: List[Optional[torch.Tensor]] = []
        for s, R in enumerate(spec.resolutions):
            dtables.append(torch.stack([_deconvolve(next(splats), R) for _ in PLANES])
                           if ctx.needs_input_grad[3 + s] else None)
        return (None, dx, None, *dtables)


def triplane_encode(tables: Dict[str, torch.Tensor], x: torch.Tensor, spec: TriplaneSpec,
                    packed: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """tables {s{i}: [3, R, R, C]}, x [N, 3] in [0, 1] -> [N, out_dim].

    ``packed``: a result of :func:`triplane_pack` to use instead of packing
    here (tracking: the tables are constant). The tables' gradient comes
    from the backward rule either way, and only where they require one."""
    if packed is None:
        packed = triplane_pack(tables, spec)
    n_scales = len(spec.resolutions)
    return _EncodeCore.apply(spec, x, [packed[f"s{s}"] for s in range(n_scales)],
                             *[tables[f"s{s}"] for s in range(n_scales)])
