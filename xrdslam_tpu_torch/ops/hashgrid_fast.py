"""Hash-grid encoding through hand-written CUDA kernels, with a plain twin.

Counterpart of ``xrdslam_tpu/ops/hashgrid_fast.py``: the exact per-vertex
hash grid (tcnn HashGrid layout), table ``[L, T, F]``, x ``[..., 3]``.

* ``hashgrid_fwd`` replaces the TPU's trilinear-forward kernel (K1,
  ``_trilerp_fwd_kernel``) and the XLA corner gather before it: warps of
  32 consecutive points at one level, an x-pair's two corner entries in
  one 16-byte load where they share an aligned pair, the block's outputs
  staged in shared memory and stored as one contiguous run. It computes
  the same bits as one thread per (point, level) would (the same
  arithmetic, the corners summed in the same order).
* ``hashgrid_bwd`` replaces the position-gradient kernel (K2,
  ``_trilerp_bwd_kernel``) and the table-gradient kernel (K3,
  ``_dtable_kernel``): dx summed over a point's levels with warp shuffles
  (the same bits on every run), dtable with float2 and float4 atomics.

The kernels are in ``kernels/hashgrid.cu``, whose header says what bounds
them on the card and what the design does about it. Each wrapper chooses by
the tensor's device: a CPU tensor goes to the plain twin
(``hashgrid_fwd_torch`` / ``hashgrid_bwd_torch``), a CUDA tensor to the
kernel, which raises if it cannot build or launch. Nothing falls back.

The position gradient follows the TPU kernel, not autodiff of the reference
``encodings.hashgrid_encode``: it is the gradient at the clamped point,
never zeroed outside [0,1]^3.

``LAUNCHES`` counts kernel launches: ``hashgrid_fwd`` per forward launch,
``hashgrid_bwd_dx`` / ``hashgrid_bwd_dtable`` per backward call that
computed dx / dtable, ``hashgrid_bwd_dx_dtable`` per call that computed
both (mapping's). ``FWD_LAUNCHES_BY_N`` splits ``hashgrid_fwd`` by the
number of points N of each launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import kernels
from .encodings import CORNER_OFFSETS, HashGridSpec, flat_rows, grid_corners

LAUNCHES: Dict[str, int] = {"hashgrid_fwd": 0, "hashgrid_bwd_dx": 0, "hashgrid_bwd_dtable": 0,
                            "hashgrid_bwd_dx_dtable": 0}
FWD_LAUNCHES_BY_N: Dict[int, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    FWD_LAUNCHES_BY_N.clear()


# ---------------------------------------------------------------------------
# plain twins (any device; the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def hashgrid_fwd_torch(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """table [L, T, F], x [N, 3] -> [N, L*F]."""
    rows, wsel = grid_corners(torch.clamp(x, 0.0, 1.0), spec)
    w = wsel[..., 0] * wsel[..., 1] * wsel[..., 2]
    feats = table.reshape(-1, spec.n_features)[flat_rows(rows, spec)]  # [N, L, 8, F]
    return torch.sum(feats * w[..., None], dim=2).reshape(x.shape[0], spec.out_dim)


def hashgrid_bwd_torch(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor, spec: HashGridSpec,
                       need_dtable: bool = True, need_dx: bool = True
                       ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """g [N, L*F] -> (dtable [L, T, F] | None, dx [N, 3] | None).

    dtable is the scatter-add of w*g (``index_add_``); dx is the TPU
    kernel's formula written out: the sum over levels and corners of (g.f)
    times the derivative of the corner's trilinear weight, times res, at
    the clamped point.
    """
    n, F = x.shape[0], spec.n_features
    rows, wsel = grid_corners(torch.clamp(x, 0.0, 1.0), spec)
    flat = flat_rows(rows, spec)
    gl = g.reshape(n, spec.n_levels, 1, F)
    dtable = dx = None
    if need_dtable:
        w = wsel[..., 0] * wsel[..., 1] * wsel[..., 2]
        dtable = torch.zeros_like(table)
        dtable.view(-1, F).index_add_(0, flat.reshape(-1), (w[..., None] * gl).reshape(-1, F))
    if need_dx:
        gdotf = (table.reshape(-1, F)[flat] * gl).sum(-1)  # [N, L, 8]
        sign = torch.tensor(CORNER_OFFSETS, dtype=x.dtype, device=x.device) * 2.0 - 1.0  # [8, 3]
        wx, wy, wz = wsel[..., 0], wsel[..., 1], wsel[..., 2]
        dw = torch.stack([sign[:, 0] * wy * wz, wx * sign[:, 1] * wz, wx * wy * sign[:, 2]], -1)
        res = torch.tensor(spec.resolutions, dtype=x.dtype, device=x.device)
        dx = torch.sum(gdotf[..., None] * dw * res[None, :, None, None], dim=(1, 2))
    return dtable, dx


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_LEVEL_ARGS: Dict[HashGridSpec, Tuple[ctypes.Array, ctypes.Array]] = {}


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD = kernels.Kernel("hashgrid", "xr_hashgrid_fwd", [_p, _p, _p, _ll, _i, _i, _p, _p, _p])
_BWD = kernels.Kernel("hashgrid", "xr_hashgrid_bwd", [_p, _p, _p, _p, _p, _ll, _i, _i, _p, _p, _p])


def level_args(spec: HashGridSpec):
    """The per-level resolutions and dense flags as ctypes int arrays."""
    if spec not in _LEVEL_ARGS:
        arr = ctypes.c_int * spec.n_levels
        _LEVEL_ARGS[spec] = (arr(*spec.resolutions), arr(*[int(d) for d in spec.dense]))
    return _LEVEL_ARGS[spec]


def _check_cuda_inputs(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> None:
    if spec.n_features != 2:
        raise ValueError(f"hash-grid kernels take F=2 features, got {spec.n_features}")
    if spec.log2_table_size < 7 or spec.n_levels > 32:
        raise ValueError(f"hash-grid kernels take T=2^k >= 128 and <= 32 levels, got {spec}")
    if table.shape != (spec.n_levels, spec.table_size, 2):
        raise ValueError(f"table shape {tuple(table.shape)} does not match {spec}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [N, 3], got {tuple(x.shape)}")
    for name, t in (("table", table), ("x", x)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 on {x.device}")


def aligned(t: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """``t``, or a copy of it that starts on an ``n_bytes`` boundary: the
    kernels read table entries and g pairs as float2 (8 bytes) and the
    forward reads an x-pair of [L, T, 2] entries as one float4 (16)."""
    return t if t.data_ptr() % n_bytes == 0 else t.clone()


def hashgrid_fwd(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """table [L, T, 2], x [N, 3] -> [N, L*2]: kernel on CUDA, twin on CPU."""
    if kernels.on_cpu(x, "hash-grid encoding"):
        return hashgrid_fwd_torch(table, x, spec)
    _check_cuda_inputs(table, x, spec)
    table = aligned(table, 16)
    res, dense = level_args(spec)
    out = torch.empty((x.shape[0], spec.out_dim), dtype=torch.float32, device=x.device)
    _FWD(table.data_ptr(), x.data_ptr(), out.data_ptr(), x.shape[0], spec.n_levels, spec.log2_table_size, res, dense,
         kernels.stream(x))
    LAUNCHES["hashgrid_fwd"] += 1
    FWD_LAUNCHES_BY_N[x.shape[0]] = FWD_LAUNCHES_BY_N.get(x.shape[0], 0) + 1
    return out


def hashgrid_bwd(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor, spec: HashGridSpec,
                 need_dtable: bool = True, need_dx: bool = True
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dtable | None, dx | None) for upstream g [N, L*2]: kernel on CUDA,
    twin on CPU. A dtable that is not needed (tracking: the table is
    constant) costs neither its atomics nor its memset; dx is written
    whole, with no fill."""
    if kernels.on_cpu(x, "hash-grid encoding"):
        return hashgrid_bwd_torch(table, x, g, spec, need_dtable, need_dx)
    _check_cuda_inputs(table, x, spec)
    if g.shape != (x.shape[0], spec.out_dim) or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g must be float32 [{x.shape[0]}, {spec.out_dim}] on {x.device}")
    table, g = aligned(table, 8), aligned(g.contiguous(), 8)
    if not (need_dtable or need_dx):
        return None, None
    res, dense = level_args(spec)
    dtable = torch.zeros_like(table) if need_dtable else None
    dx = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device) if need_dx else None
    _BWD(table.data_ptr(), x.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None,
         dtable.data_ptr() if need_dtable else None, x.shape[0], spec.n_levels, spec.log2_table_size, res, dense,
         kernels.stream(x))
    LAUNCHES["hashgrid_bwd_dx"] += int(need_dx)
    LAUNCHES["hashgrid_bwd_dtable"] += int(need_dtable)
    LAUNCHES["hashgrid_bwd_dx_dtable"] += int(need_dx and need_dtable)
    return dtable, dx


class HashGridEncode(torch.autograd.Function):
    """Encode with ``hashgrid_fwd``; differentiate with ``hashgrid_bwd``,
    computing only the gradients autograd asks for."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
        ctx.spec = spec
        ctx.save_for_backward(table, x)
        return hashgrid_fwd(table, x, spec)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        table, x = ctx.saved_tensors
        dtable, dx = hashgrid_bwd(table, x, g.contiguous(), ctx.spec,
                                  need_dtable=ctx.needs_input_grad[0], need_dx=ctx.needs_input_grad[1])
        return dtable, dx, None


def encode(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """[..., 3] -> [..., L*F] through ``HashGridEncode``."""
    batch_shape = x.shape[:-1]
    out = HashGridEncode.apply(table.contiguous(), x.reshape(-1, 3).contiguous(), spec)
    return out.reshape(*batch_shape, spec.out_dim)
