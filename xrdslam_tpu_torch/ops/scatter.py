"""Row scatter-add through a hand-written CUDA kernel, with a plain twin.

Counterpart of ``xrdslam_tpu/ops/pallas_scatter.py``. ``scatter_add(idx,
g, num_rows)`` is ``zeros([num_rows, C]).at[idx].add(g)`` in fp32, the
function that ``scatter_add_matmul`` computes on SplaTAM's path (there it
takes its exact XLA-scatter branch; see the note in
``kernels/scatter.cu``, K4). ``table_lookup``, its other caller in the
reference package, comes with Vox-Fusion.

A CUDA tensor goes to the kernel, which raises if it cannot build or
launch; a CPU tensor goes to ``scatter_add_torch`` (``index_add_``).
Indices outside ``[0, num_rows)`` are dropped by both, as JAX drops them.
``LAUNCHES["scatter_add"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import kernels

LAUNCHES: Dict[str, int] = {"scatter_add": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scatter_add_torch(idx: torch.Tensor, g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """idx [N] int, g [N, C] -> [num_rows, C]: the plain twin."""
    ok = (idx >= 0) & (idx < num_rows)
    out = torch.zeros((num_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx[ok].long(), g[ok])


def scatter_add(idx: torch.Tensor, g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """idx [N] int32, g [N, C] f32 -> [num_rows, C] f32: kernel on CUDA,
    twin on CPU. Sums with fp32 atomics on the card: not deterministic in
    the last bits."""
    if kernels.on_cpu(g, "scatter_add"):
        return scatter_add_torch(idx, g, num_rows)
    if idx.dim() != 1 or g.dim() != 2 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"scatter_add takes idx [N] and g [N, C], got {tuple(idx.shape)} and {tuple(g.shape)}")
    if idx.dtype != torch.int32 or g.dtype != torch.float32 or idx.device != g.device:
        raise ValueError(f"scatter_add takes int32 idx and float32 g on one device, got {idx.dtype}, {g.dtype}")
    idx, g = idx.contiguous(), g.contiguous()
    p = ctypes.c_void_p
    lib = kernels.bind("scatter", {"xr_scatter_add": [p, p, p, ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_longlong, p]})
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    code = lib.xr_scatter_add(idx.data_ptr(), g.data_ptr(), out.data_ptr(), g.shape[0], g.shape[1], num_rows,
                              torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check(lib, code, "scatter_add")
    LAUNCHES["scatter_add"] += 1
    return out
