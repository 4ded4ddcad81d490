"""Fixed-capacity voxel hash map: Vox-Fusion's sparse voxel octree on the device.

Counterpart of ``xrdslam_tpu/ops/voxel_hash.py``:

  * a host ``VoxelHashMap`` (a dict allocator, as the reference's CPU
    octree) with a device mirror; the tests use it as an oracle;
  * the device state, a dict of fixed-shape tensors (``empty_device_maps``):
    an open-addressed voxel hash ``hash_keys [CAP, 3]`` / ``hash_vals
    [CAP]``, the voxels' integer coordinates, centres and 8 shared vertex
    ids, and a second open-addressed hash for the vertices, with the two
    counts as 0-dim int32 tensors;
  * device insertion in two stages (``new_voxel_mask`` marks the voxels of
    a point set that the map lacks, ``insert_marked`` allocates them and
    their vertices) and the membership query ``lookup_voxels``.

Insertion is plain tensor work with no host sync: slots are elected by a
scatter-min (order-independent, so a run is a function of its code), the
candidates compacted to a fixed size by a cumsum and a scatter, and the
tables and counts of ``maps`` are written in place, so that a CUDA graph
that captured an insertion replays it on the same buffers. Writes that
the reference drops (``mode="drop"``) go to a spare row of a temporary
copy (``ops/scatter.scatter_rows``); the state has no spare row.

The hash is the reference's bit for bit: the int32 wrap-around products
are formed in int64 and their low 32 bits sign-extended, then reduced
with a non-negative remainder, for every coordinate, negative ones and
``EMPTY_KEY`` included.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .scatter import scatter_rows

_P1, _P2, _P3 = 73856093, 19349669, 83492791  # classic spatial-hash primes
N_PROBES = 8
VERTEX_CHUNK = 8192  # vertex candidates per insertion pass (the reference's chunk)

# vertex corner offsets, fixed ordering shared by interpolation
CORNERS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.int64)
EMPTY_KEY = int(np.iinfo(np.int32).min)

Maps = Dict[str, torch.Tensor]


def _hash_np(coords: np.ndarray, cap: int) -> np.ndarray:
    """Host twin of the device hash (``_hash_i32``)."""
    c = coords.astype(np.int64)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    h32 = ((h & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000  # sign-extend low 32
    return (h32 % cap + cap) % cap


class VoxelHashMap:
    """Host-side voxel/vertex slot allocator with a device mirror."""

    def __init__(self, max_voxels: int = 16384, max_vertices: int = 20000, voxel_size: float = 0.2,
                 hash_cap: int = 1 << 16) -> None:
        self.max_voxels = max_voxels
        self.max_vertices = max_vertices
        self.voxel_size = voxel_size
        self.hash_cap = hash_cap
        self.vox_index: Dict[Tuple[int, int, int], int] = {}
        self.vert_index: Dict[Tuple[int, int, int], int] = {}
        self.hash_keys = np.full((hash_cap, 3), EMPTY_KEY, np.int32)
        self.hash_vals = np.full((hash_cap,), -1, np.int32)
        self.vox_coords = np.zeros((max_voxels, 3), np.int32)
        self.vox_vertex_idx = np.zeros((max_voxels, 8), np.int32)
        self.overflowed = False

    @property
    def n_voxels(self) -> int:
        return len(self.vox_index)

    @property
    def n_vertices(self) -> int:
        return len(self.vert_index)

    def insert_points(self, points: np.ndarray) -> bool:
        """World points -> voxel coords -> new voxels and vertices, in sorted
        coordinate order. Returns True if anything was inserted."""
        coords = np.unique(np.floor(points / self.voxel_size).astype(np.int64), axis=0)
        new = [tuple(c) for c in coords if tuple(c) not in self.vox_index]
        if not new:
            return False
        for key in new:
            if len(self.vox_index) >= self.max_voxels:
                self.overflowed = True
                break
            vi = len(self.vox_index)
            self.vox_index[key] = vi
            self.vox_coords[vi] = key
            for ci, off in enumerate(CORNERS):
                vkey = (key[0] + int(off[0]), key[1] + int(off[1]), key[2] + int(off[2]))
                ei = self.vert_index.get(vkey)
                if ei is None:
                    if len(self.vert_index) >= self.max_vertices:
                        self.overflowed = True
                        ei = 0
                    else:
                        ei = len(self.vert_index)
                        self.vert_index[vkey] = ei
                self.vox_vertex_idx[vi, ci] = ei
            # linear probing into the hash mirror
            h = int(_hash_np(np.asarray(key, np.int64), self.hash_cap))
            for p in range(self.hash_cap):
                slot = (h + p) % self.hash_cap
                if self.hash_vals[slot] == -1:
                    self.hash_keys[slot] = key
                    self.hash_vals[slot] = vi
                    break
        return True

    def device_state(self, device="cpu") -> Maps:
        """The voxel tables as tensors (no vertex hash: lookup only)."""
        def t(a):
            return torch.as_tensor(a, device=device)

        return {"hash_keys": t(self.hash_keys), "hash_vals": t(self.hash_vals),
                "vox_centers": t((self.vox_coords.astype(np.float32) + 0.5) * np.float32(self.voxel_size)),
                "vox_coords": t(self.vox_coords), "vox_vertex_idx": t(self.vox_vertex_idx),
                "n_voxels": torch.tensor(self.n_voxels, dtype=torch.int32, device=device)}


def _hash_i32(kx: torch.Tensor, ky: torch.Tensor, kz: torch.Tensor, cap: int) -> torch.Tensor:
    """The spatial hash of int coordinates -> slot in [0, cap), int64: the
    reference's int32 wrap-around products and sign-of-dividend remainders,
    computed exactly in int64."""
    h = (kx.long() * _P1) ^ (ky.long() * _P2) ^ (kz.long() * _P3)
    h32 = ((h & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return torch.remainder(h32, cap)


def hash_insert(keys_tbl: torch.Tensor, vals_tbl: torch.Tensor, counter: torch.Tensor, cand: torch.Tensor,
                cand_valid: torch.Tensor, max_items: int, n_probes: int = N_PROBES
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized open-addressed insertion of ``cand [C, 3]`` int32 with
    in-batch dedupe, writing ``keys_tbl`` / ``vals_tbl`` in place.

    Per probe stage every still-unplaced candidate checks its slot (a
    matching key: adopt its id), empty slots elect one winner by
    scatter-min, winners take ids ``counter + rank``, and duplicates of a
    winner's key adopt the fresh id. Candidates unplaced after ``n_probes``
    stages (a full chain, table or ``max_items``) get id -1.

    Returns (the new counter, ids [C] int32).
    """
    cap = keys_tbl.shape[0]
    c = cand.shape[0]
    dev = cand.device
    h = _hash_i32(cand[:, 0], cand[:, 1], cand[:, 2], cap)
    arange = torch.arange(c, dtype=torch.int32, device=dev)
    none = torch.full((c,), c, dtype=torch.int32, device=dev)
    ids = torch.full((c,), -1, dtype=torch.int32, device=dev)
    done = ~cand_valid
    for p in range(n_probes):
        slot = (h + p) % cap
        v_at = vals_tbl[slot]
        match = torch.all(keys_tbl[slot] == cand, -1) & (v_at >= 0) & ~done
        ids = torch.where(match, v_at, ids)
        done = done | match
        empty = (v_at < 0) & ~done
        wtbl = torch.full((cap,), c, dtype=torch.int32, device=dev)
        wtbl.scatter_reduce_(0, slot, torch.where(empty, arange, none), "amin", include_self=True)
        is_w = empty & (wtbl[slot] == arange)
        new_id = counter + torch.cumsum(is_w, 0).to(torch.int32) - 1
        ok = is_w & (new_id < max_items)
        sslot = torch.where(ok, slot, cap)
        scatter_rows(keys_tbl, sslot, cand)
        scatter_rows(vals_tbl, sslot, new_id)
        ids = torch.where(ok, new_id, ids)
        done = done | ok
        counter = counter + ok.sum().to(torch.int32)
        # duplicates of this stage's winners adopt the fresh entry
        v_at = vals_tbl[slot]
        match2 = torch.all(keys_tbl[slot] == cand, -1) & (v_at >= 0) & ~done
        ids = torch.where(match2, v_at, ids)
        done = done | match2
    return counter, ids


def lookup_voxels(hash_keys: torch.Tensor, hash_vals: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Voxel membership: int coords [..., 3] -> voxel id or -1 (int32).
    Linear probing over ``N_PROBES`` slots; an empty slot ends the chain."""
    cap = hash_keys.shape[0]
    c = coords.to(torch.int32)
    h = _hash_i32(c[..., 0], c[..., 1], c[..., 2], cap)
    result = torch.full(c.shape[:-1], -1, dtype=torch.int32, device=c.device)
    found = torch.zeros(c.shape[:-1], dtype=torch.bool, device=c.device)
    for p in range(N_PROBES):
        slot = (h + p) % cap
        vals = hash_vals[slot]
        match = torch.all(hash_keys[slot] == c, -1) & (vals >= 0) & ~found
        result = torch.where(match, vals, result)
        found = found | match | (vals < 0)
    return result


def new_voxel_mask(maps: Maps, pts: torch.Tensor, valid: torch.Tensor, *, voxel_size: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of device insertion: the voxel coords of ``pts`` [N, 3]
    (``EMPTY_KEY`` where not ``valid``) and the mask of those the map lacks."""
    cc = torch.floor(pts / voxel_size).to(torch.int32)
    cc = torch.where(valid[:, None], cc, EMPTY_KEY)
    vidx = lookup_voxels(maps["hash_keys"], maps["hash_vals"], cc)
    return cc, valid & (vidx < 0)


def compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The indices of the first ``size`` set entries of ``mask`` [N], in
    index order, padded with N: ``jnp.nonzero(mask, size=size,
    fill_value=N)`` with a fixed shape and no host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), n, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(n, device=mask.device))
    return out[:size]


@torch.no_grad()
def insert_marked(maps: Maps, cc: torch.Tensor, new: torch.Tensor, *, voxel_size: float, max_voxels: int,
                  max_vertices: int, max_new: int = 1024) -> Maps:
    """Stage 2 of device insertion, in place on ``maps``: one candidate per
    home slot among the marked coords ``cc [N, 3]`` (``new`` [N]; distinct
    keys sharing a home slot wait a frame), the first ``max_new`` in index
    order, voxel insertion, then the new voxels' 8 vertices through the
    vertex hash, in chunks of ``VERTEX_CHUNK`` candidates (ids are
    allocated per chunk, so the chunking decides which row a vertex gets).
    A vertex that finds no slot takes row 0, as the host allocator's
    overflow does. Coords left out are inserted by a later call. Returns
    ``maps``."""
    cap = maps["hash_keys"].shape[0]
    n = cc.shape[0]
    dev = cc.device
    h0 = _hash_i32(cc[:, 0], cc[:, 1], cc[:, 2], cap)
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    wt = torch.full((cap,), n, dtype=torch.int32, device=dev)
    wt.scatter_reduce_(0, h0, torch.where(new, ar, n), "amin", include_self=True)
    pre = new & (wt[h0] == ar)
    idx = compact(pre, max_new)
    cc_pad = torch.cat([cc, torch.full((1, 3), EMPTY_KEY, dtype=torch.int32, device=dev)], 0)
    cand = cc_pad[idx]
    cand_valid = idx < n

    n_vox0 = maps["n_voxels"].clone()
    n_vox, vids = hash_insert(maps["hash_keys"], maps["hash_vals"], n_vox0, cand, cand_valid, max_voxels)
    newly = (vids >= n_vox0) & cand_valid
    tgt = torch.where(newly, vids.long(), max_voxels)
    scatter_rows(maps["vox_coords"], tgt, cand)
    scatter_rows(maps["vox_centers"], tgt, (cand.to(torch.float32) + 0.5) * voxel_size)

    # shared vertex rows for the new voxels
    a = torch.arange(8, dtype=torch.int32, device=dev)
    corners = torch.stack([a >> 2, (a >> 1) & 1, a & 1], -1)  # CORNERS, made on the device
    vkeys = cand[:, None, :] + corners[None]  # [C, 8, 3]
    vkeys = torch.where(newly[:, None, None], vkeys, EMPTY_KEY).reshape(-1, 3)
    vvalid = newly[:, None].expand(-1, 8).reshape(-1)
    n_vert = maps["n_vertices"]
    parts = []
    for s in range(0, vkeys.shape[0], VERTEX_CHUNK):
        n_vert, e = hash_insert(maps["vhash_keys"], maps["vhash_vals"], n_vert, vkeys[s:s + VERTEX_CHUNK],
                                vvalid[s:s + VERTEX_CHUNK], max_vertices)
        parts.append(e)
    ei = torch.clamp(torch.cat(parts), min=0).reshape(-1, 8)
    scatter_rows(maps["vox_vertex_idx"], tgt, ei)
    maps["n_voxels"].copy_(n_vox)
    maps["n_vertices"].copy_(n_vert)
    return maps


def insert_points_device(maps: Maps, pts: torch.Tensor, valid: torch.Tensor, *, voxel_size: float,
                         max_voxels: int, max_vertices: int, max_new: int = 1024) -> Maps:
    """``new_voxel_mask`` then ``insert_marked``: in place on ``maps``."""
    cc, new = new_voxel_mask(maps, pts, valid, voxel_size=voxel_size)
    return insert_marked(maps, cc, new, voxel_size=voxel_size, max_voxels=max_voxels,
                         max_vertices=max_vertices, max_new=max_new)


def empty_device_maps(max_voxels: int, max_vertices: int, hash_cap: int = 1 << 16,
                      device: Optional[torch.device] = None) -> Maps:
    """A fresh device voxel map (see ``insert_marked``)."""
    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {"hash_keys": full((hash_cap, 3), EMPTY_KEY), "hash_vals": full((hash_cap,), -1),
            "vox_coords": full((max_voxels, 3), 0), "vox_centers": full((max_voxels, 3), 0.0, torch.float32),
            "vox_vertex_idx": full((max_voxels, 8), 0), "n_voxels": full((), 0),
            "vhash_keys": full((hash_cap, 3), EMPTY_KEY), "vhash_vals": full((hash_cap,), -1),
            "n_vertices": full((), 0)}
