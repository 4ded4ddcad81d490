"""Row scatter-add through a hand-written CUDA kernel, with a plain twin,
and the embedding lookup whose gradient it is.

Counterpart of ``xrdslam_tpu/ops/pallas_scatter.py``. ``scatter_add(idx,
g, num_rows)`` is ``zeros([num_rows, C]).at[idx].add(g)`` in fp32, the
function that ``scatter_add_matmul`` computes on SplaTAM's path and on
Point-SLAM's (at their 131,072 and 262,144 rows it takes its exact
XLA-scatter branch; see the note in ``kernels/scatter.cu``, K4).
``table_lookup(table, idx)`` is ``table[idx]`` (plain indexing, as the
reference's ``jnp.take``) with K4 as its gradient: Point-SLAM's feature
tables take theirs through it.

On the card K4 sums each output row in a fixed order, so the same inputs
give the same bits on every run, as the TPU kernel does. Its ordering
step is ``scatter_order``: a stable sort of the ids (plain torch) and the
kernel's row-pointer search. A caller whose ids serve several sums builds
the ordering once and hands it to ``scatter_add_ordered`` (SplaTAM's tile
binning serves 40 or 60 iterations); ``scatter_add`` orders and sums.

A CUDA tensor goes to the kernel, which raises if it cannot build or
launch; a CPU tensor goes to ``scatter_add_torch`` (``index_add_``), or,
with an ordering, to ``scatter_add_sorted_torch``.
Indices outside ``[0, num_rows)`` are dropped by both, as JAX drops them.
``scatter_rows`` is a plain row copy with the same rule for its one
dropped index, JAX's ``.at[dest].set(rows, mode="drop")``.
``LAUNCHES["scatter_add"]`` counts launches of the summing kernel,
``LAUNCHES["scatter_order"]`` those of the row-pointer search;
``LAUNCHES_BY_ROWS`` splits the summing kernel's by the rows of the table
it sums into.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from .. import kernels

LAUNCHES: Dict[str, int] = {"scatter_add": 0, "scatter_order": 0}
LAUNCHES_BY_ROWS: Dict[int, int] = {}  # num_rows -> summing kernel launches

_p, _ll = ctypes.c_void_p, ctypes.c_longlong
_ORDER = kernels.Kernel("scatter", "xr_scatter_order", [_p, _ll, _ll, _p, _p])
_SUM = kernels.Kernel("scatter", "xr_scatter_sum",
                      [_p, _p, _p, _p, _p, _p, _ll, ctypes.c_int, _ll, ctypes.c_int, _p])
_SLOTS = kernels.Kernel("scatter", "xr_scatter_slots", [_ll], restype=_ll)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_ROWS.clear()


class ScatterOrder(NamedTuple):
    """The entries of ``idx`` ordered by row: ``keys`` the ids sorted
    (stable: equal ids in ascending entry index), ``perm`` the entry at each
    sorted position, ``row_ptr`` [num_rows + 1] the first sorted position
    of each row; ``slots`` the kernel's number of partial-sum slots for
    long rows."""
    idx: torch.Tensor
    keys: torch.Tensor
    perm: torch.Tensor
    row_ptr: torch.Tensor
    num_rows: int
    slots: int


def scatter_rows(dst: torch.Tensor, dest: torch.Tensor, rows: torch.Tensor) -> None:
    """``dst[dest[i]] = rows[i]`` in place, for distinct ``dest[i] <
    len(dst)``; entries with ``dest[i] == len(dst)`` are dropped (they land
    in a spare row of a temporary copy)."""
    buf = torch.cat([dst, dst[:1]])
    buf.index_copy_(0, dest, rows.to(dst.dtype))
    dst.copy_(buf[:-1])


def scatter_add_torch(idx: torch.Tensor, g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """idx [N] int, g [N, C] -> [num_rows, C]: the plain twin."""
    ok = (idx >= 0) & (idx < num_rows)
    out = torch.zeros((num_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx[ok].long(), g[ok])


def scatter_add_sorted_torch(order: ScatterOrder, g: torch.Tensor) -> torch.Tensor:
    """The plain twin of the summing kernel: the entries in sorted order,
    so that each row adds its segment in that order."""
    a, b = int(order.row_ptr[0]), int(order.row_ptr[-1])
    out = torch.zeros((order.num_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, order.keys[a:b].long(), g[order.perm[a:b]])


def row_ptr_torch(keys: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The plain twin of the kernel's row-pointer search: for sorted ids
    ``keys``, the first position of each row in [0, num_rows]."""
    rows = torch.arange(num_rows + 1, dtype=keys.dtype, device=keys.device)
    return torch.searchsorted(keys, rows).to(torch.int32)


def scatter_order(idx: torch.Tensor, num_rows: int) -> ScatterOrder:
    """The ordering of ``idx`` [N] int32 for ``scatter_add_ordered``: a
    stable sort, then the row pointers (the kernel on CUDA, the twin on
    CPU)."""
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"scatter_order takes int32 idx [N], got {idx.dtype} {tuple(idx.shape)}")
    if idx.shape[0] >= 2**31 or num_rows >= 2**31:
        raise ValueError("scatter_order takes fewer than 2^31 entries and rows")
    keys, perm = torch.sort(idx, stable=True)
    if kernels.on_cpu(idx, "scatter_order"):
        return ScatterOrder(idx, keys, perm, row_ptr_torch(keys, num_rows), num_rows, 0)
    row_ptr = torch.empty(num_rows + 1, dtype=torch.int32, device=idx.device)
    _ORDER(keys.data_ptr(), keys.shape[0], num_rows, row_ptr.data_ptr(), kernels.stream(idx))
    LAUNCHES["scatter_order"] += 1
    return ScatterOrder(idx, keys, perm, row_ptr, num_rows, _SLOTS.bind()(keys.shape[0]))


def scatter_add_ordered(order: ScatterOrder, g: torch.Tensor) -> torch.Tensor:
    """g [N, C] f32 -> [num_rows, C] f32, the scatter-add of ``g`` at the
    ids ``order`` was built from: the kernel on CUDA (each row summed by its
    owner in sorted order, the same bits on every run), the twin on CPU."""
    idx, n = order.idx, order.idx.shape[0]
    if g.dim() != 2 or g.shape[0] != n:
        raise ValueError(f"scatter_add takes idx [N] and g [N, C], got {tuple(idx.shape)} and {tuple(g.shape)}")
    if kernels.on_cpu(g, "scatter_add"):
        return scatter_add_sorted_torch(order, g)
    if g.dtype != torch.float32 or idx.device != g.device:
        raise ValueError(f"scatter_add takes float32 g on the ids' device, got {g.dtype} on {g.device}")
    g = g.contiguous()
    c = g.shape[1]
    out = torch.empty((order.num_rows, c), dtype=torch.float32, device=g.device)
    vec4 = c % 4 == 0 and g.data_ptr() % 16 == 0
    partials = torch.empty((order.slots, c), dtype=torch.float32, device=g.device)
    _SUM(order.keys.data_ptr(), order.perm.data_ptr(), order.row_ptr.data_ptr(), g.data_ptr(), out.data_ptr(),
         partials.data_ptr(), n, c, order.num_rows, int(vec4), kernels.stream(g))
    LAUNCHES["scatter_add"] += 1
    LAUNCHES_BY_ROWS[order.num_rows] = LAUNCHES_BY_ROWS.get(order.num_rows, 0) + 1
    return out


def scatter_add(idx: torch.Tensor, g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """idx [N] int32, g [N, C] f32 -> [num_rows, C] f32: kernel on CUDA
    (ordered, then summed), twin on CPU."""
    if kernels.on_cpu(g, "scatter_add"):
        return scatter_add_torch(idx, g, num_rows)
    if idx.dim() != 1 or g.dim() != 2 or idx.shape[0] != g.shape[0]:
        raise ValueError(f"scatter_add takes idx [N] and g [N, C], got {tuple(idx.shape)} and {tuple(g.shape)}")
    if idx.dtype != torch.int32 or g.dtype != torch.float32 or idx.device != g.device:
        raise ValueError(f"scatter_add takes int32 idx and float32 g on one device, got {idx.dtype}, {g.dtype}")
    return scatter_add_ordered(scatter_order(idx.contiguous(), num_rows), g)


class _TableLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_add(idx, g, ctx.num_rows), None


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, C], idx [...] int -> [..., C]; the gradient of ``table`` is
    ``scatter_add`` (K4 on CUDA)."""
    out = _TableLookup.apply(table, idx.reshape(-1).to(torch.int32))
    return out.reshape(*idx.shape, table.shape[1])
