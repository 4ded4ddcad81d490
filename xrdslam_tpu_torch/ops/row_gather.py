"""Row gather ``table [R, C], idx [...] -> [..., C]`` through a hand-written
CUDA kernel, with a plain twin.

Counterpart of ``xrdslam_tpu/ops/row_gather.py``, whose two Pallas kernels
(K7a ``_flat_kernel`` for widths that are multiples of 1024, K7b
``_kernel`` for width 128) become one kernel in ``kernels/row_gather.cu``
for every width divisible by 4. Its caller is the Point-SLAM kNN
(``ops.point_table.knn_query``), whose rows hold int32 ids bitcast to
float32: the kernel and the twin copy bits and compute nothing.

A CUDA tensor goes to the kernel, which raises if it cannot build or
launch; a CPU tensor goes to ``row_gather_torch`` (``index_select``). Ids
outside ``[0, R)`` give rows of zeros in both. The gradient of ``table``
is a scatter-add (K4, ``ops.scatter.scatter_add``), as the reference's
``_rg_bwd``. ``LAUNCHES["row_gather"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import kernels
from .scatter import scatter_add

LAUNCHES: Dict[str, int] = {"row_gather": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def row_gather_torch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, C], idx [N] -> [N, C]: the plain twin."""
    ok = (idx >= 0) & (idx < table.shape[0])
    out = torch.index_select(table, 0, torch.where(ok, idx, torch.zeros_like(idx)).long())
    return out.masked_fill_(~ok[:, None], 0)


def row_gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, C] (4-byte elements), idx [N] int32 -> [N, C]: kernel on
    CUDA, twin on CPU."""
    if kernels.on_cpu(table, "row_gather"):
        return row_gather_torch(table, idx)
    if table.dim() != 2 or idx.dim() != 1 or table.element_size() != 4 or table.shape[1] % 4 != 0:
        raise ValueError(f"row_gather takes table [R, C] of 4-byte elements with C % 4 == 0 and idx [N], "
                         f"got {table.dtype} {tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32 or idx.device != table.device:
        raise ValueError(f"row_gather takes int32 idx on the table's device, got {idx.dtype} on {idx.device}")
    table, idx = table.contiguous(), idx.contiguous()
    if table.data_ptr() % 16 != 0:
        raise ValueError("row_gather's table must be 16-byte aligned: the kernel copies 16-byte words")
    p = ctypes.c_void_p
    ll = ctypes.c_longlong
    lib = kernels.bind("row_gather", {"xr_row_gather": [p, p, p, ll, ll, ll, p]})
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    code = lib.xr_row_gather(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], table.shape[1],
                             table.shape[0], torch.cuda.current_stream(table.device).cuda_stream)
    kernels.check(lib, code, "row_gather")
    LAUNCHES["row_gather"] += 1
    return out


class _RowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return row_gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_add(idx, g, ctx.num_rows), None


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, C], idx [...] int32 -> [..., C], differentiable in ``table``."""
    out = _RowGather.apply(table, idx.reshape(-1).to(torch.int32))
    return out.reshape(*idx.shape, table.shape[1])
