"""Hash-grid encoding from the plane layout through hand-written CUDA
kernels, with plain twins.

Counterpart of ``xrdslam_tpu/ops/pallas_hashgrid.py``: the same trilinear
hash-grid encode as ``ops.hashgrid_fast``, read from the TPU's plane layout
``planes [L, F, T/128, 128]`` (``pack_table``), in which entry ``e`` of
feature ``f`` sits at ``planes[l, f, e >> 7, e & 127]``.

* ``hashgrid_planes_fwd`` replaces the TPU's forward kernel (K8,
  ``_fwd_kernel``): x is clamped to [0,1]^3, out is ``[N, 2L]``. It is
  K1's design on this layout: an x-pair whose entries share an aligned
  pair is read as one float2 per feature.
* ``hashgrid_planes_bwd`` replaces the backward kernel (K9,
  ``_bwd_kernel``): dx and dplanes in one pass. dx is the gradient at the
  clamped point, not zeroed outside [0,1]^3 (as K2); dplanes is summed
  with fp32 atomics into zeroed planes, so its last bits change from run
  to run (the TPU's one-hot matmuls were deterministic).

Both kernels are ``kernels/hashgrid.cu``'s K1-K3 code on this layout
(``xr_hashgrid_planes_fwd`` / ``xr_hashgrid_planes_bwd``). Like the TPU
kernels they take F = 2 and T = 2^16 only and raise ``ValueError`` for
anything else. A CPU tensor goes to the twin (``hashgrid_planes_fwd_torch``
/ ``hashgrid_planes_bwd_torch``), a CUDA tensor to the kernel, which raises
if it cannot build or launch.

Nothing in either package calls these yet; they are held against the TPU
kernels at function level. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import kernels
from .encodings import HashGridSpec
from .hashgrid_fast import aligned, hashgrid_bwd_torch, hashgrid_fwd_torch, level_args

LAUNCHES: Dict[str, int] = {"hashgrid_planes_fwd": 0, "hashgrid_planes_bwd": 0}
LOG2_T = 16  # the TPU kernels' table size: T/128 = 512 rows per plane


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_table(table: torch.Tensor) -> torch.Tensor:
    """[L, T, F] -> [L, F, T/128, 128] plane layout."""
    L, T, F = table.shape
    return table.reshape(L, T // 128, 128, F).permute(0, 3, 1, 2).contiguous()


def unpack_table(planes: torch.Tensor) -> torch.Tensor:
    """[L, F, T/128, 128] -> [L, T, F]."""
    L, F, S, _ = planes.shape
    return planes.permute(0, 2, 3, 1).reshape(L, S * 128, F).contiguous()


def _check_spec(spec: HashGridSpec) -> None:
    if spec.n_features != 2 or spec.log2_table_size != LOG2_T:
        raise ValueError(f"the plane-layout kernels take F = 2 and T = 2^{LOG2_T} only, got {spec}")


# ---------------------------------------------------------------------------
# plain twins (any device; the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def hashgrid_planes_fwd_torch(planes: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """planes [L, 2, T/128, 128], x [N, 3] -> [N, 2L]."""
    _check_spec(spec)
    return hashgrid_fwd_torch(unpack_table(planes), x, spec)


def hashgrid_planes_bwd_torch(planes: torch.Tensor, x: torch.Tensor, g: torch.Tensor, spec: HashGridSpec,
                              need_dplanes: bool = True, need_dx: bool = True
                              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """g [N, 2L] -> (dplanes [L, 2, T/128, 128] | None, dx [N, 3] | None)."""
    _check_spec(spec)
    dtable, dx = hashgrid_bwd_torch(unpack_table(planes), x, g, spec, need_dplanes, need_dx)
    return (None if dtable is None else pack_table(dtable)), dx


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD = kernels.Kernel("hashgrid", "xr_hashgrid_planes_fwd", [_p, _p, _p, _ll, _i, _i, _p, _p, _p])
_BWD = kernels.Kernel("hashgrid", "xr_hashgrid_planes_bwd", [_p, _p, _p, _p, _p, _ll, _i, _i, _p, _p, _p])


def _check_cuda_inputs(planes: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> None:
    _check_spec(spec)
    if spec.n_levels > 32:
        raise ValueError(f"the plane-layout kernels take at most 32 levels, got {spec.n_levels}")
    if planes.shape != (spec.n_levels, 2, spec.table_size // 128, 128):
        raise ValueError(f"planes shape {tuple(planes.shape)} does not match {spec}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [N, 3], got {tuple(x.shape)}")
    for name, t in (("planes", planes), ("x", x)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 on {x.device}")


def hashgrid_planes_fwd(planes: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """planes [L, 2, T/128, 128], x [N, 3] -> [N, 2L]: K8 on CUDA, twin on CPU."""
    if kernels.on_cpu(x, "plane-layout hash-grid encoding"):
        return hashgrid_planes_fwd_torch(planes, x, spec)
    _check_cuda_inputs(planes, x, spec)
    planes = aligned(planes, 8)
    res, dense = level_args(spec)
    out = torch.empty((x.shape[0], spec.out_dim), dtype=torch.float32, device=x.device)
    _FWD(planes.data_ptr(), x.data_ptr(), out.data_ptr(), x.shape[0], spec.n_levels, spec.log2_table_size, res,
         dense, kernels.stream(x))
    LAUNCHES["hashgrid_planes_fwd"] += 1
    return out


def hashgrid_planes_bwd(planes: torch.Tensor, x: torch.Tensor, g: torch.Tensor, spec: HashGridSpec,
                        need_dplanes: bool = True, need_dx: bool = True
                        ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dplanes | None, dx | None) for upstream g [N, 2L]: K9 on CUDA, twin
    on CPU. An output that is not needed is neither zeroed nor summed."""
    if kernels.on_cpu(x, "plane-layout hash-grid encoding"):
        return hashgrid_planes_bwd_torch(planes, x, g, spec, need_dplanes, need_dx)
    _check_cuda_inputs(planes, x, spec)
    if g.shape != (x.shape[0], spec.out_dim) or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g must be float32 [{x.shape[0]}, {spec.out_dim}] on {x.device}")
    if not (need_dplanes or need_dx):
        return None, None
    g = aligned(g.contiguous(), 8)
    res, dense = level_args(spec)
    dplanes = torch.zeros_like(planes) if need_dplanes else None
    dx = torch.empty((x.shape[0], 3), dtype=torch.float32, device=x.device) if need_dx else None
    _BWD(planes.data_ptr(), x.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None,
         dplanes.data_ptr() if need_dplanes else None, x.shape[0], spec.n_levels, spec.log2_table_size, res, dense,
         kernels.stream(x))
    LAUNCHES["hashgrid_planes_bwd"] += 1
    return dplanes, dx


class HashGridPlanesEncode(torch.autograd.Function):
    """Encode with ``hashgrid_planes_fwd``; differentiate with
    ``hashgrid_planes_bwd``, computing only the gradients autograd asks
    for."""

    @staticmethod
    def forward(ctx, planes: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
        ctx.spec = spec
        ctx.save_for_backward(planes, x)
        return hashgrid_planes_fwd(planes, x, spec)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        planes, x = ctx.saved_tensors
        dplanes, dx = hashgrid_planes_bwd(planes, x, g.contiguous(), ctx.spec,
                                          need_dplanes=ctx.needs_input_grad[0], need_dx=ctx.needs_input_grad[1])
        return dplanes, dx, None


def hashgrid_encode_planes(planes: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """planes [L, 2, T/128, 128], x [..., 3] -> [..., 2L] through
    ``HashGridPlanesEncode``."""
    batch_shape = x.shape[:-1]
    out = HashGridPlanesEncode.apply(planes.contiguous(), x.reshape(-1, 3).contiguous(), spec)
    return out.reshape(*batch_shape, spec.out_dim)
