"""Fixed-capacity neural point cloud with a block-union spatial-hash kNN.

Counterpart of ``xrdslam_tpu/ops/point_table.py``. Each hash row is keyed
by a base cell ``b = floor(p / cell_size - 0.5)`` and stores the union of
the points whose cells fall in the 2x2x2 block ``{b, b+1}^3``: every point
that can lie within ``cell_size / 2`` of a query landing in that block. A
row is packed as ``[count, positions (per_cell x 3), member ids (per_cell,
int32 bitcast to float32)]`` and padded to a multiple of 1024 floats.

``PointMap`` is the host store, a copy of the reference's (numpy; the
insertion runs on the host, as the reference's FAISS index mutation does).
``device_state(device)`` uploads the hash keys and rows; the rows keep their
bits, so the member ids survive as the denormal floats they are. After an
insertion, ``upload(maps)`` writes the rows it changed into those device
tensors in place, so that a CUDA graph that captured them reads the new
map.
``knn_query`` probes the hash on the device, gathers one union row per
query with ``ops.row_gather`` (K7, the CUDA kernel on the card), and takes
the k nearest candidates: distances squared, ties to the lower candidate
as ``jax.lax.top_k`` breaks them, and invalid picks at D2 = 1e10 (and
position 1e6).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .row_gather import row_gather

_P1, _P2, _P3 = 73856093, 19349669, 83492791
_EMPTY = np.iinfo(np.int32).min
_N_PROBES = 8  # linear-probe depth of the device lookup, the reference's default

# the 8 base cells whose 2x2x2 block contains a point's cell
_BASE_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)], np.int64
)


class PointMap:
    """Host-side point store + block-union hash rows with a device mirror."""

    def __init__(self, max_points: int = 262144, cell_size: float = 0.08, hash_cap: int = 1 << 16, per_cell: int = 192):
        assert hash_cap & (hash_cap - 1) == 0, "hash_cap must be a power of two"
        self.max_points = max_points
        self.cell_size = cell_size
        self.hash_cap = hash_cap
        self.per_cell = per_cell
        self.n_points = 0
        self.pos = np.zeros((max_points, 3), np.float32)
        self.cell_keys = np.full((hash_cap, 3), _EMPTY, np.int32)
        self.cell_list = np.zeros((hash_cap, per_cell), np.int32)
        self.cell_count = np.zeros((hash_cap,), np.int32)
        # packed union row: [count, pos(per_cell*3), members(per_cell, int32
        # bitcast to f32)], padded to a multiple of 1024 elements
        self._o_pos = 1
        self._o_mem = 1 + 3 * per_cell
        width = -(-(self._o_mem + per_cell) // 1024) * 1024
        self.cell_data = np.zeros((hash_cap, width), np.float32)
        self.overflowed = False
        self._dirty = set()  # rows changed since the last device_state or upload

    # ------------------------------------------------------------------
    def _hash(self, keys: np.ndarray) -> np.ndarray:
        """[..., 3] int -> hash slot; the low bits match the device's because
        hash_cap is a power of two (truncation commutes with XOR and the mask)."""
        k = keys.astype(np.int64)
        return ((k[..., 0] * _P1) ^ (k[..., 1] * _P2) ^ (k[..., 2] * _P3)) & (self.hash_cap - 1)

    def _slot(self, key: Tuple[int, int, int]) -> int:
        """Find-or-create the slot for a base-cell key (linear probing)."""
        h = int(self._hash(np.asarray(key)))
        for p in range(64):
            s = (h + p) % self.hash_cap
            if self.cell_count[s] == 0 and self.cell_keys[s][0] == _EMPTY:
                self.cell_keys[s] = key
                return s
            if tuple(self.cell_keys[s]) == key:
                return s
        self.overflowed = True
        return int(h)

    def _find_slot(self, key: Tuple[int, int, int]) -> int:
        """Find-only: -1 when the key has no row."""
        h = int(self._hash(np.asarray(key)))
        for p in range(64):
            s = (h + p) % self.hash_cap
            if self.cell_keys[s][0] == _EMPTY:
                return -1
            if tuple(self.cell_keys[s]) == key:
                return s
        return -1

    def add_points(self, pts: np.ndarray) -> int:
        """Append points; returns the number added. Each point joins the
        union rows of its 8 covering base cells."""
        n = min(len(pts), self.max_points - self.n_points)
        if n <= 0:
            self.overflowed = True
            return 0
        pts = np.asarray(pts[:n], np.float32)
        start = self.n_points
        self.pos[start : start + n] = pts
        cells = np.floor(pts / self.cell_size).astype(np.int64)
        bases = (cells[:, None, :] - _BASE_OFFSETS[None]).reshape(-1, 3)
        pidx = np.repeat(np.arange(start, start + n, dtype=np.int64), 8)
        uk, inv = np.unique(bases, axis=0, return_inverse=True)
        slots_u = np.fromiter((self._slot(tuple(k)) for k in uk), np.int64, len(uk))
        slots = slots_u[inv.reshape(-1)]
        order = np.argsort(slots, kind="stable")
        ss, ps = slots[order], pidx[order]
        uniq_s, first, counts = np.unique(ss, return_index=True, return_counts=True)
        self._dirty.update(uniq_s.tolist())
        K = self.per_cell
        for s, f, c in zip(uniq_s, first, counts):
            c0 = int(self.cell_count[s])
            take = min(K - c0, int(c))
            if take <= 0:
                self.overflowed = True
                continue
            m = ps[f : f + take]
            self.cell_list[s, c0 : c0 + take] = m
            self.cell_count[s] = c0 + take
            row = self.cell_data[s]
            row[0] = float(c0 + take)
            row[self._o_pos + 3 * c0 : self._o_pos + 3 * (c0 + take)] = self.pos[m].ravel()
            row[self._o_mem + c0 : self._o_mem + c0 + take] = m.astype(np.int32).view(np.float32)
        self.n_points += n
        return n

    def neighbor_counts(self, pts: np.ndarray, radius) -> np.ndarray:
        """Host query: the number of stored points within ``radius`` (a
        scalar or one per point) of each point. Radii are capped by
        cell_size / 2, the union rows' coverage."""
        if self.n_points == 0:
            return np.zeros(len(pts), np.int64)
        radius = np.broadcast_to(np.asarray(radius, np.float64), (len(pts),))
        counts = np.zeros(len(pts), np.int64)
        bases = np.floor(np.asarray(pts) / self.cell_size - 0.5).astype(np.int64)
        for i, (b, p) in enumerate(zip(bases, pts)):
            s = self._find_slot(tuple(b))
            if s < 0:
                continue
            idx = self.cell_list[s, : self.cell_count[s]]
            d = np.linalg.norm(self.pos[idx] - p, axis=-1)
            counts[i] = int((d <= radius[i]).sum())
        return counts

    def device_state(self, device) -> Dict[str, object]:
        """The hash keys and rows as tensors on ``device`` (copies), the cell
        size as a 0-dim tensor there (a true fp32 division, as the
        reference's), the point count and the row layout."""
        device = torch.device(device)
        self._dirty.clear()
        return {
            "cell_keys": torch.tensor(self.cell_keys, device=device),
            "cell_data": torch.tensor(self.cell_data, device=device),
            "n_points": self.n_points,
            "cell_size": torch.tensor(self.cell_size, dtype=torch.float32, device=device),
            "per_cell": self.per_cell,
        }

    def upload(self, maps: Dict[str, object]) -> int:
        """Write the hash keys and rows changed since the last
        ``device_state`` or ``upload`` into the device tensors of ``maps``
        (made by ``device_state``) in place, and its point count; the
        tensors keep their addresses and, row for row, ``device_state``'s
        bits. Returns the number of rows written."""
        n = len(self._dirty)
        if n:
            rows = np.fromiter(sorted(self._dirty), np.int64, n)
            dev = maps["cell_data"].device
            idx = torch.from_numpy(rows).to(dev)
            maps["cell_keys"].index_copy_(0, idx, torch.from_numpy(self.cell_keys[rows]).to(dev))
            maps["cell_data"].index_copy_(0, idx, torch.from_numpy(self.cell_data[rows]).to(dev))
            self._dirty.clear()
        maps["n_points"] = self.n_points
        return n


def hash_probe(maps: Dict[str, object], pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts [N, 3] -> (the row of each query's base cell [N] int32, 0 where
    there is none; found [N] bool): linear probing over ``_N_PROBES`` slots,
    the first match before any empty slot."""
    keys = maps["cell_keys"]
    cap = keys.shape[0]
    assert cap & (cap - 1) == 0, "hash_cap must be a power of two"
    base = torch.floor(pts / maps["cell_size"] - 0.5).to(torch.int32)  # [N, 3]
    b = base.to(torch.int64)
    # int64 products, masked: the low bits equal the reference's int32 wraparound
    h = ((b[:, 0] * _P1) ^ (b[:, 1] * _P2) ^ (b[:, 2] * _P3)) & (cap - 1)
    slots = (h[:, None] + torch.arange(_N_PROBES, device=pts.device)) & (cap - 1)  # [N, P]
    skeys = keys[slots]  # [N, P, 3]
    match = torch.all(skeys == base[:, None, :], -1)
    empty = skeys[..., 0] == _EMPTY
    hit = (match | empty).to(torch.int32)
    stop = torch.cumsum(hit, -1) - hit
    live = match & (stop == 0)
    found = torch.any(live, -1)
    first = torch.argmax(live.to(torch.int32), -1)  # the first of equal maxima
    row = torch.gather(slots, 1, first[:, None])[:, 0]
    return torch.where(found, row, torch.zeros_like(row)).to(torch.int32), found


def knn_query(maps: Dict[str, object], pts: torch.Tensor, k: int = 8, with_pos: bool = False):
    """Device kNN: pts [N, 3] -> (D2 [N, k], I [N, k] int32, n_valid [N])
    (plus cpos [N, k, 3] when ``with_pos``).

    One union-row gather per query (K7); valid for query radii up to the
    map's cell_size / 2. Distances are squared.
    """
    per_cell = maps["per_cell"]
    o_pos, o_mem = 1, 1 + 3 * per_cell
    n = pts.shape[0]
    found_idx, found = hash_probe(maps, pts)
    rows = row_gather(maps["cell_data"], found_idx)  # [N, W]
    cnt = rows[:, 0].to(torch.int32)
    cpos = rows[:, o_pos : o_pos + 3 * per_cell].reshape(n, per_cell, 3)
    ids = rows.view(torch.int32)[:, o_mem : o_mem + per_cell]  # the bits, never a float operation
    valid = (torch.arange(per_cell, device=pts.device)[None, :] < cnt[:, None]) & found[:, None]
    d2 = torch.sum(torch.square(cpos - pts[:, None, :]), -1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    # the k smallest, ties to the lower candidate (as jax.lax.top_k): a
    # top-k over keys (d2's bits, candidate) that are unique, ordered as a
    # stable sort would order them (d2 >= 0, so its bits order as its values)
    shift = max(per_cell - 1, 1).bit_length()
    key = (d2.view(torch.int32).to(torch.int64) << shift) | torch.arange(per_cell, device=pts.device)
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).indices
    D2 = torch.gather(d2, 1, top)
    I = torch.gather(ids, 1, top)
    finite = torch.isfinite(D2)
    n_valid = torch.sum(finite, -1)
    D2 = torch.where(finite, D2, torch.full_like(D2, 1e10))
    if with_pos:
        cpos_k = torch.gather(cpos, 1, top[..., None].expand(n, k, 3))
        # invalid picks land at 1e6, so a tracker re-deriving D2 from
        # positions still gives them weight 0
        cpos_k = torch.where((D2 >= 1e10)[..., None], torch.full_like(cpos_k, 1e6), cpos_k)
        return D2, I, n_valid, cpos_k
    return D2, I, n_valid
