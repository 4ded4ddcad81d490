"""Tile-based triangle-mesh depth rasterizer, in torch on any device.

Counterpart of ``xrdslam_tpu/ops/mesh_raster.py``, which is plain
``jax.numpy`` (no Pallas kernel): the unseen-view depth renders of
``utils/eval_recon.calc_2d_metric``. Vertices are projected, each
triangle's screen bounding circle is binned to the 16x16 tiles by
``gaussian_raster.bin_gaussians_device`` (margin 0, at most ``max_span``
tiles a side, nearest first), and each tile tests its pixels against its
K triangles with signed edge functions, interpolates 1/z with the
barycentrics (perspective-correct) and keeps the least depth, in the
reference's order of operations.

The reference maps its tiles in chunks of at most 2^22 (pixel, triangle)
pairs inside one compiled program. Here a chunk is a few dozen eager ops,
so on the card the chunk is sized from the free device memory instead:
tiles are independent, and the depths do not depend on the chunking.

Camera convention as in the rest of the package (x right, y up, z
backward: ``z_cam = -p_cam[2]``, ``u = cx + fx x/z``, ``v = cy - fy y/z``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .gaussian_raster import TILE, bin_gaussians_device

CPU_CHUNK_PAIRS = 1 << 22  # the reference's chunk, (pixel, triangle) pairs
PAIR_BYTES = 40  # device bytes live per (pixel, triangle) pair in a chunk, at most
HYBRID_FACES = 4096  # above this many faces the tile pass is joined by the splat pass


def _project(vertices: torch.Tensor, w2c: torch.Tensor, fx, fy, cx, cy):
    pc = vertices @ w2c[:3, :3].T + w2c[:3, 3]
    z = -pc[:, 2]
    zs = torch.clamp(torch.abs(z), min=1e-9) * torch.sign(torch.where(z == 0, torch.ones_like(z), z))
    u = cx + fx * pc[:, 0] / zs
    v = cy - fy * pc[:, 1] / zs
    return u, v, z


def _face_attributes(vertices, faces, w2c, fx, fy, cx, cy):
    """(fu, fv, fz) [F, 3] of each face's corners and its validity [F]."""
    fu_all, fv_all, fz_all = _project(vertices, w2c, fx, fy, cx, cy)
    fu, fv, fz = fu_all[faces], fv_all[faces], fz_all[faces]
    return fu, fv, fz, (fz > 1e-4).all(-1)


def chunk_tiles(n_tiles: int, k_per_tile: int, device: torch.device) -> int:
    """Tiles a chunk: the reference's 2^22 pairs on the CPU; on the card as
    many as half the free device memory (the allocator's cached blocks
    included) holds at ``PAIR_BYTES`` a pair."""
    pairs = CPU_CHUNK_PAIRS
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        pairs = max(pairs, free // 2 // PAIR_BYTES)
    return max(1, min(n_tiles, pairs // max(TILE * TILE * k_per_tile, 1)))


def _tile_depths(attr, ids, msk, tile_idx, ntx):
    """Least depth of each pixel of tiles ``tile_idx`` [C] over their slots
    ``ids`` / ``msk`` [C, K]: [C, P], inf where no triangle covers it.
    ``attr`` [F, 9] holds each face's (au, av, bu, bv, cu, cv) and its
    corners' 1/z. The reference's arithmetic, op for op; the in-place ops
    only reuse buffers."""
    lin = torch.arange(TILE * TILE, dtype=torch.int64, device=ids.device)
    px = (lin[None, :] % TILE + (tile_idx % ntx)[:, None] * TILE).to(torch.float32) + 0.5
    py = (lin[None, :] // TILE + (tile_idx // ntx)[:, None] * TILE).to(torch.float32) + 0.5
    pxc, pyc = px[:, :, None], py[:, :, None]  # [C, P, 1]
    a = attr[ids]  # [C, K, 9]
    au, av, bu, bv, cu, cv, iz0, iz1, iz2 = (a[..., j][:, None, :] for j in range(9))  # [C, 1, K]

    def edge(eu, ev, su, sv):
        # (eu - su) * (pyc - sv) - (ev - sv) * (pxc - su), as the reference
        # writes it and as its CPU backend computes it: the first product and
        # the difference contracted into one fused multiply-add. The float64
        # product of two float32 values is exact, so only the difference
        # rounds, as in the fma (but for a rare double rounding), and a pixel
        # centre on an edge that two triangles share falls to the side the
        # reference's rounding puts it.
        t = (pxc - su).mul_(ev - sv)
        return (pyc - sv).double().mul_((eu - su).double()).sub_(t).float()

    w0 = edge(cu, cv, bu, bv)
    w1 = edge(au, av, cu, cv)
    w2 = edge(bu, bv, au, av)
    area = (bu - au) * (cv - av) - (bv - av) * (cu - au)  # [C, 1, K]
    area_ok = torch.abs(area) > 1e-12
    pos = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    inside = (w0 <= 0) & (w1 <= 0) & (w2 <= 0)
    inside |= pos
    del pos
    inside &= area_ok & msk[:, None, :]
    inv_area = 1.0 / torch.where(area_ok, area, torch.ones_like(area))
    # 1/z is linear in screen space under these barycentrics:
    # invz = l0 iz0 + l1 iz1 + l2 iz2 with l_i = w_i / area
    invz = w0.mul_(inv_area).mul_(iz0)
    invz += w1.mul_(inv_area).mul_(iz1)
    invz += w2.mul_(inv_area).mul_(iz2)
    del w1, w2
    inside &= invz > 1e-9
    z = torch.reciprocal(invz.clamp_(min=1e-9))
    z.masked_fill_(~inside, float("inf"))
    return z.amin(-1)


@torch.no_grad()
def render_mesh_depth(vertices: torch.Tensor, faces: torch.Tensor, w2c: torch.Tensor, fx, fy, cx, cy,
                      height: int, width: int, k_per_tile: int = 64, max_span: int = 8,
                      chunk: Optional[int] = None) -> torch.Tensor:
    """Depth image [H, W] (0 where no surface) on the inputs' device.

    vertices [V, 3] float32, faces [F, 3] integer, w2c [4, 4].
    ``k_per_tile`` caps the triangles of a tile (nearest first, so only far
    surfaces are truncated); ``max_span`` caps a triangle's tile footprint
    (a larger one is clipped to max_span^2 tiles from its bounding box's
    corner). ``chunk`` tiles are tested at a time (default
    :func:`chunk_tiles`)."""
    dev = vertices.device
    ntx, nty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    n_tiles = ntx * nty
    faces = faces.long()
    if faces.shape[0] == 0:
        return torch.zeros(height, width, dtype=torch.float32, device=dev)
    fu, fv, fz, valid = _face_attributes(vertices, faces, w2c, fx, fy, cx, cy)
    # a conservative disk over the screen bounding box, for the gaussian binner
    umin, umax = fu.amin(-1), fu.amax(-1)
    vmin, vmax = fv.amin(-1), fv.amax(-1)
    uc, vc = 0.5 * (umin + umax), 0.5 * (vmin + vmax)
    rad = 0.5 * torch.sqrt((umax - umin) ** 2 + (vmax - vmin) ** 2) + 1e-3
    zmin = torch.where(valid, fz.amin(-1), torch.zeros_like(umin))
    tiles, tmask = bin_gaussians_device(uc, vc, zmin, rad, valid, height, width, k_per_tile=k_per_tile,
                                        margin=0.0, max_span=max_span)
    # a tile's list fills its slots from the first, so the slots past the
    # fullest tile's count are masked everywhere: leave them out
    k_used = int(tmask.sum(1).max())
    if k_used == 0:
        return torch.zeros(height, width, dtype=torch.float32, device=dev)
    tiles, tmask = tiles[:, :k_used], tmask[:, :k_used]
    iz = 1.0 / torch.clamp(fz, min=1e-9)
    attr = torch.stack([fu[:, 0], fv[:, 0], fu[:, 1], fv[:, 1], fu[:, 2], fv[:, 2], iz[:, 0], iz[:, 1], iz[:, 2]], -1)
    chunk = chunk or chunk_tiles(n_tiles, k_used, dev)
    depth_t = torch.empty(n_tiles, TILE * TILE, dtype=torch.float32, device=dev)
    for s in range(0, n_tiles, chunk):
        idx = torch.arange(s, min(s + chunk, n_tiles), device=dev)
        depth_t[s:s + chunk] = _tile_depths(attr, tiles[s:s + chunk].long(), tmask[s:s + chunk], idx, ntx)
    img = depth_t.reshape(nty, ntx, TILE, TILE).permute(0, 2, 1, 3).reshape(nty * TILE, ntx * TILE)[:height, :width]
    return torch.where(torch.isfinite(img), img, torch.zeros_like(img))


@torch.no_grad()
def splat_mesh_depth(vertices: torch.Tensor, faces: torch.Tensor, w2c: torch.Tensor, fx, fy, cx, cy,
                     height: int, width: int, fp: int = 3) -> torch.Tensor:
    """Scatter-min depth splatting for dense meshes (faces at or below pixel
    scale): each face's centroid depth goes to the least of its fp x fp
    pixel footprint (``scatter_reduce_`` "amin"; writes outside the image
    go to a spare slot past its end, the reference's ``mode="drop"``).
    Exact z-buffering degenerates to this when triangles are sub-pixel."""
    dev = vertices.device
    fu, fv, fz, valid = _face_attributes(vertices, faces.long(), w2c, fx, fy, cx, cy)
    cu, cv, cz = fu.mean(-1), fv.mean(-1), fz.mean(-1)
    bx = torch.floor(cu - (fp - 1) / 2.0).to(torch.int64)
    by = torch.floor(cv - (fp - 1) / 2.0).to(torch.int64)
    d = torch.arange(fp, dtype=torch.int64, device=dev)
    px = bx[:, None, None] + d[None, None, :]
    py = by[:, None, None] + d[None, :, None]
    ok = valid[:, None, None] & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    idx = torch.where(ok, py * width + px.clamp(0, width - 1), height * width)
    vals = torch.where(ok, cz[:, None, None].expand(idx.shape), float("inf"))
    img = torch.full((height * width + 1,), float("inf"), dtype=torch.float32, device=dev)
    img.scatter_reduce_(0, idx.reshape(-1), vals.reshape(-1), "amin")
    img = img[: height * width].reshape(height, width)
    return torch.where(torch.isfinite(img), img, torch.zeros_like(img))


def mesh_tensors(mesh, device) -> tuple:
    """(vertices float32, faces int64) of a ``utils.io.Mesh`` on ``device``."""
    return (torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=device),
            torch.as_tensor(np.asarray(mesh.faces, np.int64), device=device))


def default_k_per_tile(n_faces: int, height: int, width: int) -> int:
    """The reference's rule: the next power of two of 6 faces a tile on
    average, in [64, 4096]."""
    n_tiles = ((width + TILE - 1) // TILE) * ((height + TILE - 1) // TILE)
    avg = 6 * n_faces / max(n_tiles, 1)
    return int(min(max(64, 1 << int(np.ceil(np.log2(max(avg, 1))))), 4096))


def render_depth(vertices: torch.Tensor, faces: torch.Tensor, c2w: np.ndarray, fx, fy, cx, cy,
                 height: int, width: int, k_per_tile: Optional[int] = None, **kw) -> np.ndarray:
    """:func:`render_mesh_depth_np` on mesh tensors already on their device."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32)
    w2c_t = torch.as_tensor(w2c, device=vertices.device)
    cam = (float(fx), float(fy), float(cx), float(cy))
    hybrid = False
    if k_per_tile is None:
        k_per_tile = default_k_per_tile(faces.shape[0], height, width)
        hybrid = faces.shape[0] > HYBRID_FACES
    d_tile = render_mesh_depth(vertices, faces, w2c_t, *cam, height, width, k_per_tile=k_per_tile, **kw)
    if not hybrid:
        return d_tile.cpu().numpy()
    d_splat = splat_mesh_depth(vertices, faces, w2c_t, *cam, height, width)
    inf = torch.full_like(d_tile, float("inf"))
    m = torch.minimum(torch.where(d_tile > 0, d_tile, inf), torch.where(d_splat > 0, d_splat, inf))
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m)).cpu().numpy()


def render_mesh_depth_np(mesh, c2w: np.ndarray, fx, fy, cx, cy, height: int, width: int,
                         k_per_tile: Optional[int] = None, device="cuda", **kw) -> np.ndarray:
    """Depth [H, W] of a ``utils.io.Mesh`` at ``c2w`` (this package's
    convention), rendered on ``device``.

    Dense meshes (more than 4,096 faces) get the reference's hybrid: the
    tile pass's nearest-first budget keeps the near, screen-large faces it
    handles exactly, a scatter-min splat pass covers the distant sub-pixel
    faces that the budget would starve, and the two depth maps min-merge.
    Small meshes use the tile pass alone, as does an explicit
    ``k_per_tile``."""
    verts, faces = mesh_tensors(mesh, torch.device(device))
    return render_depth(verts, faces, c2w, fx, fy, cx, cy, height, width, k_per_tile=k_per_tile, **kw)
