"""Mesh post-processing: frustum culling and connected-component cleaning.

Counterpart of ``xrdslam_tpu/utils/mesh_ops.py`` (NumPy; no trimesh):
connected components by union-find over the edge list, visibility by a
frustum and depth test per frame.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .io import Mesh


def _union_find_components(n_verts: int, edges: np.ndarray) -> np.ndarray:
    """Vertex component labels via union-find. edges [E, 2]."""
    parent = np.arange(n_verts)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    return np.array([find(i) for i in range(n_verts)])


def clean_mesh(mesh: Mesh, min_len: int = 100) -> Mesh:
    """Drop connected components with fewer than ``min_len`` vertices."""
    faces = np.asarray(mesh.faces)
    verts = np.asarray(mesh.vertices)
    if len(faces) == 0:
        return mesh
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]])
    labels = _union_find_components(len(verts), edges)
    label_count = dict(zip(*np.unique(labels, return_counts=True)))
    keep_v = np.array([label_count[label] >= min_len for label in labels])
    keep_f = keep_v[faces].all(1)
    new_index = np.cumsum(keep_v) - 1
    colors = np.asarray(mesh.vertex_colors)[keep_v] if mesh.vertex_colors is not None else None
    return Mesh(vertices=verts[keep_v].astype(np.float32), faces=new_index[faces[keep_f]].astype(np.int32),
                vertex_colors=colors)


def cull_mesh(
    dataset,
    mesh: Mesh,
    estimate_c2w_list: Optional[List[np.ndarray]] = None,
    eval_rec: bool = False,
    truncation: float = 0.06,
) -> Mesh:
    """Remove faces never seen from the (estimated) trajectory: a vertex is
    seen if it projects inside some frame's image in front of the camera
    and, with ``eval_rec``, lies within ``truncation`` behind that frame's
    observed depth. Camera convention as the reference's: +x right, +y up,
    -z viewing (x is flipped before K and -z is the depth)."""
    verts = np.asarray(mesh.vertices, np.float64)
    n_imgs = len(estimate_c2w_list) if estimate_c2w_list is not None else len(dataset)
    cam = dataset.get_camera()
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    never_seen = np.ones(len(verts), bool)
    hom = np.concatenate([verts, np.ones((len(verts), 1))], 1)  # [N,4]
    for i in range(n_imgs):
        _, _, depth, c2w = dataset[i]
        if estimate_c2w_list is not None:
            c2w = np.asarray(estimate_c2w_list[i])
        cam_pts = hom @ np.linalg.inv(np.asarray(c2w, np.float64)).T  # [N,4]
        x, y, z = -cam_pts[:, 0], cam_pts[:, 1], cam_pts[:, 2]
        uvz = (K @ np.stack([x, y, z])).T
        zz = uvz[:, 2] + 1e-5
        u = uvz[:, 0] / zz
        v = uvz[:, 1] / zz
        inb = (u > 0) & (u < cam.width - 1) & (v > 0) & (v < cam.height - 1) & (0 <= -z)
        if eval_rec and depth is not None:
            ui = np.clip(u.astype(np.int64), 0, cam.width - 1)
            vi = np.clip(v.astype(np.int64), 0, cam.height - 1)
            inb &= np.asarray(depth)[vi, ui] + truncation >= -z
        never_seen &= ~inb
        if not never_seen.any():
            break
    faces = np.asarray(mesh.faces)
    keep_f = ~never_seen[faces].all(1)  # drop the faces seen by none
    used = np.zeros(len(verts), bool)
    used[faces[keep_f].ravel()] = True
    new_index = np.cumsum(used) - 1
    colors = np.asarray(mesh.vertex_colors)[used] if mesh.vertex_colors is not None else None
    return Mesh(vertices=np.asarray(mesh.vertices)[used].astype(np.float32),
                faces=new_index[faces[keep_f]].astype(np.int32), vertex_colors=colors)
