"""NeuralRecon's sequence training in the environment.

Counterpart of ``xrdslam_tpu/utils/neucon_train.py``. The reference ships
pretrained weights (``model_000047.ckpt``) that this repository does not
have; this module trains the NeuCon network with the reference's loss
(neucon_network.py:249-300) on the analytic synthetic scenes instead.
Exact TSDF and occupancy targets come from the scene's SDF, restricted to
the voxels the frames' depth observes; fragments come from the
algorithm's own keyframe gating and input assembly; and the ConvGRU's
hidden state is threaded across the fragments of an epoch as at inference
(no gradient across a fragment's boundary).

The optimiser is optax's ``adam(lr)``, from ``engine/optimizers.py``. The
checkpoint is the reference package's ``.npz``: one array ``p{i}`` a leaf,
in ``jax.tree_util``'s flatten order (dict keys sorted), each in the
reference's layout, so that either package loads the other's file.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..algorithms.neural_recon import _GlobalVolume, keyframe_passes
from ..common.frame import upload
from ..common.synthetic import SCENE_SDF
from ..engine.optimizers import GroupOptimizers, OptimizerConfig
from ..models.neucon import OUT_CHANNELS, Tree, leaves, map_tree, to_jax_layout, to_torch_layout, tree_from_leaves


def scene_sdf_numpy(scene: str) -> Callable[[np.ndarray], np.ndarray]:
    """A synthetic scene's SDF on numpy points [..., 3] (float64), for
    ``level_targets``."""
    sdf = SCENE_SDF[scene]
    return lambda p: sdf(torch.as_tensor(np.asarray(p), dtype=torch.float64)).numpy()


def _visibility(pts: np.ndarray, frames: Sequence, cam, trunc: float) -> np.ndarray:
    """A point is observed if it projects into some frame's image in front
    of the camera no deeper than the observed depth plus the truncation (the
    reference's depth-fused TSDF ground truth): voxels behind surfaces or
    outside every frustum stay empty in the target."""
    vis = np.zeros(pts.shape[0], bool)
    for f in frames:
        w2c = np.linalg.inv(f.get_pose())  # the reference's convention (+z forward, y down)
        pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.round(cam.fx * pc[:, 0] / z + cam.cx).astype(np.int64)
            v = np.round(cam.fy * pc[:, 1] / z + cam.cy).astype(np.int64)
        inb = (z > 1e-3) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        d = np.zeros_like(z)
        d[inb] = np.asarray(f.depth)[v[inb], u[inb]]
        vis |= inb & (d > 0) & (z < d + trunc)
    return vis


def level_targets(mc, vol_origin: np.ndarray, sdf_fn: Callable[[np.ndarray], np.ndarray], frames: Sequence = None,
                  cam=None, device="cpu"):
    """Each level's dense (tsdf, occ) targets [D, D, D] on ``device`` from
    a scene SDF, restricted to depth-observed voxels when ``frames`` and
    ``cam`` are given. The truncation is 3 finest voxels at every level."""
    tsdf_ts, occ_ts = [], []
    trunc = 3.0 * mc.voxel_size
    for i in range(mc.n_layer):
        interval = 2 ** (mc.n_layer - 1 - i)
        dim = mc.n_vox // interval
        ax = np.arange(dim, dtype=np.float32) * interval
        gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
        pts = np.stack([gx, gy, gz], -1).reshape(-1, 3) * mc.voxel_size + vol_origin
        tsdf = np.clip(np.asarray(sdf_fn(pts)).reshape(dim, dim, dim) / trunc, -1.0, 1.0).astype(np.float32)
        if frames is not None:
            vis = _visibility(pts, frames, cam, trunc).reshape(dim, dim, dim)
            tsdf = np.where(vis, tsdf, 1.0).astype(np.float32)
        occ = (np.abs(tsdf) < 1.0).astype(np.float32)
        tsdf_ts.append(upload(tsdf, device))
        occ_ts.append(upload(occ, device))
    return tsdf_ts, occ_ts


def collect_fragments(algo, frames: Sequence) -> List[dict]:
    """The algorithm's keyframe gating and fragment assembly over posed
    frames, touching neither its parameters nor its volumes: each fragment's
    ``fragment_step`` inputs on the algorithm's device, its voxel origin
    and its frames."""
    frags, pending = [], []
    for f in frames:
        if not pending or keyframe_passes(pending[-1].get_pose(), f.get_pose(), algo.config.min_angle,
                                          algo.config.min_distance):
            pending.append(f)
        if len(pending) > algo.config.mapping_window_size:
            imgs, projs, vol_origin, origin_vox, aligned_T = algo._fragment_inputs(pending)
            frags.append({"imgs": upload(imgs, algo.device), "projs": upload(projs, algo.device),
                          "vol_origin": upload(vol_origin, algo.device), "origin_vox": origin_vox,
                          "aligned_T": aligned_T, "frames": list(pending)})
            pending = []
    return frags


def train_sequence(algo, frags: List[dict], sdf_fn: Callable[[np.ndarray], np.ndarray], epochs: int = 2,
                   steps_per_fragment: int = 25, lr: float = 1e-3, verbose: bool = False, params: Tree = None):
    """Train the NeuCon network on a fragment sequence with its GRU hidden
    state threaded across fragments; returns (params, losses). The hidden
    volumes start empty each epoch and take each fragment's new crops after
    its steps, as at inference. ``params`` (by default a copy of the
    model's) is trained in place."""
    mc = algo.model.config
    model = algo.model
    targets = [level_targets(mc, fr["vol_origin"].cpu().numpy(), sdf_fn, frames=fr.get("frames"), cam=algo.camera,
                             device=algo.device) for fr in frags]
    if params is None:
        params = map_tree(lambda p, t: t.detach().clone(), model.params)
    flat = [t for _, t in leaves(params)]
    opt = GroupOptimizers({"neucon": OptimizerConfig(lr=lr)})
    state = opt.init({"neucon": flat})
    losses: List[float] = []
    for ep in range(epochs):
        hidden_vols = [_GlobalVolume(OUT_CHANNELS[i]) for i in range(mc.n_layer)]
        for fi, fr in enumerate(frags):
            hiddens = [upload(np.ascontiguousarray(hidden_vols[i].crop(lo, dim)), algo.device)
                       for i, (lo, dim) in enumerate(algo.level_los(fr["origin_vox"]))]
            tsdf_ts, occ_ts = targets[fi]
            frag_losses = []
            for _ in range(steps_per_fragment):
                loss, grads = model.value_and_grad(params, fr["imgs"], fr["projs"], fr["vol_origin"], hiddens,
                                                   fr["aligned_T"], tsdf_ts, occ_ts)
                opt.update({"neucon": grads}, state, {"neucon": flat})
                frag_losses.append(loss)
            losses.extend(torch.stack(frag_losses).cpu().tolist())
            # the next fragment reads this one's hidden state after its steps
            _, _, new_hiddens = model.fragment_step(params, fr["imgs"], fr["projs"], fr["vol_origin"], hiddens)
            for i, (lo, _) in enumerate(algo.level_los(fr["origin_vox"])):
                hidden_vols[i].write(lo, new_hiddens[i].cpu().numpy())
            if verbose:
                print(f"[neucon-train] epoch {ep} frag {fi}: loss {losses[-1]:.4f}", flush=True)
    return params, losses


def save_params(path: str, params: Tree) -> None:
    """The reference package's checkpoint: ``p{i}`` for the i-th leaf in
    sorted-key order, in the reference's layouts (its ``__treedef__`` bytes
    are not read by either package; here they list the leaves' paths)."""
    items = leaves(params)
    paths = "\n".join("/".join(p) for p, _ in items)
    np.savez(path, __treedef__=np.frombuffer(paths.encode(), dtype=np.uint8),
             **{f"p{i}": to_jax_layout(p, t.detach().cpu().numpy()) for i, (p, t) in enumerate(items)})


def load_params(path: str, like_params: Tree) -> Tree:
    """A checkpoint of either package as a tree of ``like_params``'
    structure, on its leaves' device."""
    items = []
    with np.load(path) as data:
        for i, (p, like) in enumerate(leaves(like_params)):
            a = torch.from_numpy(to_torch_layout(p, data[f"p{i}"]))
            if tuple(a.shape) != tuple(like.shape):
                raise ValueError(f"{'/'.join(p)}: shape {tuple(a.shape)} does not fit {tuple(like.shape)}")
            items.append((p, a.to(like.device)))
    return tree_from_leaves(items)
