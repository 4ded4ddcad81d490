"""NeuCon: NeuralRecon's coarse-to-fine network on dense fragment volumes.

Counterpart of ``xrdslam_tpu/models/neucon.py``, in torch's channels-first
layout (NCHW for the image backbone, NCDHW for the volumes) and as plain
functions over a parameter tree. The tree has the reference package's
keys (``backbone``, ``unet{i}``, ``gru{i}``, ``tsdf{i}``, ``occ{i}``);
its leaves are tensors in torch's layouts:

* 2-D convolutions OIHW (the depthwise ones ``[cin, 1, 3, 3]``, applied
  with ``groups=cin``), 3-D convolutions ``[O, I, D, H, W]``;
* the U-Nets' stride-2 transposed convolutions (``up1``, ``up2``)
  ``[I, O, D, H, W]`` with the kernel flipped on its three spatial axes:
  the reference's ``conv_transpose`` does not flip its kernel, and
  ``F.conv_transpose3d`` with the flipped kernel computes the same;
* the ``tsdf{i}`` / ``occ{i}`` heads as the reference's ``[hid, 1]``
  matrices.

``to_torch_layout`` / ``to_jax_layout`` convert a leaf between the
reference's layouts (HWIO, DHWIO) and these by its key path, so that a
checkpoint of either package loads in the other.

Differences from the reference package, each within float32 rounding:
``back_project`` sums the views one at a time (the reference gathers all
views at once, ``[V, N, C]`` for each of four corners: 849 MB each at the
96^3 level with 10 views), and the heads sum in another order. A view's
corner gathers are one ``ops/scatter.table_lookup``: their gradient, the
training step's, is K4, the port's deterministic scatter-add (torch's
own indexing backward serialises the many voxels that share a pixel:
1.44 s of a 1.92 s step at the registry's width on the H100). The
convolutions run in full float32 with cuDNN's deterministic algorithms
(``fp32_convolutions``), inside ``fragment_step`` and ``value_and_grad``
only, whatever the process's TF32 setting.

The cascade thresholds the occupancy logits at 0: a logit within
rounding of 0 can flip between the packages and change the finer levels
below it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch
from torch.nn import functional as F

from ..configs.base import InstantiateConfig
from ..ops.scatter import table_lookup
from .vonet import fp32_convolutions

# channel schedule (the reference's neucon_network.py:27-32, alpha = 1)
BACKBONE_CHANNELS = [24, 40, 80]  # 1/4, 1/8, 1/16
CH_IN = [80 + 1, 96 + 40 + 2 + 1, 48 + 24 + 2 + 1]
OUT_CHANNELS = [96, 48, 24]
PIXEL_MEAN = np.array([103.53, 116.28, 123.675], np.float32)  # BGR*255 means
LEVEL_WEIGHTS = [1.0, 0.8, 0.64]  # the loss's weight of each level

Tree = Dict[str, Any]


# ------------------------------------------------------------------ layouts
def _kind(path: Tuple[str, ...]) -> str:
    """A leaf's kind from its key path: "b" (a bias), "head", "deconv" or
    "conv" (2-D or 3-D, depthwise included)."""
    if path[-1] == "b":
        return "b"
    if path[0].startswith(("tsdf", "occ")):
        return "head"
    if path[0].startswith("unet") and path[-2] in ("up1", "up2"):
        return "deconv"
    return "conv"


def to_torch_layout(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    """A reference leaf (HWIO / DHWIO kernels) in this module's layout."""
    kind = _kind(path)
    a = np.asarray(a, np.float32)
    if kind in ("b", "head"):
        return a
    n = a.ndim - 2  # spatial axes
    perm = (n + 1, n) + tuple(range(n))  # -> [O, I, *spatial]
    if kind == "deconv":
        perm = (n, n + 1) + tuple(range(n))  # -> [I, O, *spatial], flipped
        return np.ascontiguousarray(np.flip(a.transpose(perm), axis=tuple(range(2, 2 + n))))
    return np.ascontiguousarray(a.transpose(perm))


def to_jax_layout(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    """``to_torch_layout``'s inverse."""
    kind = _kind(path)
    a = np.asarray(a, np.float32)
    if kind in ("b", "head"):
        return a
    n = a.ndim - 2
    if kind == "deconv":
        a = np.flip(a, axis=tuple(range(2, 2 + n)))
        return np.ascontiguousarray(a.transpose(tuple(range(2, 2 + n)) + (0, 1)))
    return np.ascontiguousarray(a.transpose(tuple(range(2, 2 + n)) + (1, 0)))


def leaves(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) in ``jax.tree_util``'s flatten order for a tree of
    dicts: keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])
    return out


def tree_from_leaves(items) -> Tree:
    """``leaves``' inverse: a tree of dicts from (key path, leaf) pairs."""
    tree: Tree = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def map_tree(fn, tree: Tree, prefix: Tuple[str, ...] = ()) -> Tree:
    """``fn(path, leaf)`` over a tree of dicts."""
    return {k: map_tree(fn, v, prefix + (k,)) if isinstance(v, dict) else fn(prefix + (k,), v)
            for k, v in tree.items()}


# ------------------------------------------------------------------- init
def _init_tree(seed: int) -> Tree:
    """The reference's structure and He-normal init, in the reference's
    layouts (numpy), from a torch generator; biases zero."""
    gen = torch.Generator().manual_seed(seed)

    def he(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return (torch.randn(shape, generator=gen) * np.sqrt(2.0 / fan_in)).numpy()

    def conv2d(cin, cout, k):
        return {"w": he(k, k, cin, cout), "b": np.zeros(cout, np.float32)}

    def conv3d(cin, cout, k):
        return {"w": he(k, k, k, cin, cout), "b": np.zeros(cout, np.float32)}

    def sep(cin, cout):
        return {"dw": {"w": he(3, 3, 1, cin), "b": np.zeros(cin, np.float32)}, "pw": conv2d(cin, cout, 1)}

    d = [32, 16, 24, 40, 80]
    tree: Tree = {"backbone": {
        "stem": conv2d(3, d[0], 3), "b1": sep(d[0], d[1]), "b2": sep(d[1], d[2]), "b2b": sep(d[2], d[2]),
        "b3": sep(d[2], d[3]), "b3b": sep(d[3], d[3]), "b4": sep(d[3], d[4]), "b4b": sep(d[4], d[4]),
        "out1": conv2d(d[4], d[4], 1), "inner1": conv2d(d[3], d[4], 1), "inner2": conv2d(d[2], d[4], 1),
        "out2": conv2d(d[4], d[3], 3), "out3": conv2d(d[4], d[2], 3)}}

    def res(ci, co):
        p = {"c1": conv3d(ci, co, 3), "c2": conv3d(co, co, 3)}
        if ci != co:
            p["down"] = conv3d(ci, co, 1)
        return p

    for i in range(3):
        cs = [int(c / 2 ** i) for c in (32, 64, 128, 96, 96)]
        hid = OUT_CHANNELS[i]
        tree[f"unet{i}"] = {
            "stem": conv3d(CH_IN[i], cs[0], 3), "down1": conv3d(cs[0], cs[0], 2),
            "r1a": res(cs[0], cs[1]), "r1b": res(cs[1], cs[1]), "down2": conv3d(cs[1], cs[1], 2),
            "r2a": res(cs[1], cs[2]), "r2b": res(cs[2], cs[2]), "up1": conv3d(cs[2], cs[3], 2),
            "u1a": res(cs[3] + cs[1], cs[3]), "u1b": res(cs[3], cs[3]), "up2": conv3d(cs[3], cs[4], 2),
            "u2a": res(cs[4] + cs[0], cs[4]), "u2b": res(cs[4], cs[4]),
            "pt1": conv3d(cs[0], cs[2], 1), "pt2": conv3d(cs[2], cs[4], 1)}
        tree[f"gru{i}"] = {k: conv3d(2 * hid, hid, 3) for k in ("convz", "convr", "convq")}
        tree[f"tsdf{i}"] = {"w": he(hid, 1), "b": np.zeros(1, np.float32)}
        tree[f"occ{i}"] = {"w": he(hid, 1), "b": np.zeros(1, np.float32)}
    return tree


def params_from_numpy(np_tree: Tree, device) -> Tree:
    """A tree in the reference's layouts (numpy leaves) as this module's
    parameters on ``device``."""
    return map_tree(lambda p, a: torch.from_numpy(np.array(to_torch_layout(p, a))).to(device), np_tree)


def params_to_numpy(params: Tree) -> Tree:
    """``params_from_numpy``'s inverse: numpy leaves in the reference's layouts."""
    return map_tree(lambda p, t: to_jax_layout(p, t.detach().cpu().numpy()), params)


# ---------------------------------------------------------------- helpers
def _conv2d(p: Tree, x: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    return F.conv2d(x, p["w"], p["b"], stride, p["w"].shape[-1] // 2, groups=groups)


def _conv3d(p: Tree, x: torch.Tensor) -> torch.Tensor:
    return F.conv3d(x, p["w"], p["b"], 1, p["w"].shape[-1] // 2)


def _deconv3d(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """Stride-2 transposed 3-D convolution, kernel 2 (the reference's
    ``conv_transpose(..., (2, 2, 2), "SAME")``)."""
    return F.conv_transpose3d(x, p["w"], p["b"], stride=2)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Instance norm over every voxel of a volume (or, on [V, C, h, w],
    over each view's pixels): biased variance, eps 1e-5, no affine."""
    return F.instance_norm(x, eps=1e-5)


def _up(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling by ``k`` on every axis after the
    second (the reference's ``jnp.repeat``)."""
    for d in range(2, x.ndim):
        x = x.repeat_interleave(k, d)
    return x


# --------------------------------------------------------------- backbone
def backbone2d_apply(params: Tree, imgs: torch.Tensor) -> List[torch.Tensor]:
    """imgs [V, H, W, 3] (0..255 RGB) -> [feat4 [V, 24, H/4, W/4], feat8
    [V, 40, ...], feat16 [V, 80, ...]]: a depthwise-separable trunk and an
    FPN (the reference's backbone.py:66-85 interface)."""
    x = (imgs - imgs.new_tensor(PIXEL_MEAN[::-1].copy())).permute(0, 3, 1, 2)  # PIXEL_STD = 1

    def sep(p, x, stride=1):
        y = F.relu(_norm(_conv2d(p["dw"], x, stride, groups=x.shape[1])))
        return F.relu(_norm(_conv2d(p["pw"], y)))

    x = F.relu(_norm(_conv2d(params["stem"], x, stride=2)))
    x = sep(params["b1"], x)
    c4 = sep(params["b2b"], sep(params["b2"], x, stride=2))  # 1/4, 24
    c8 = sep(params["b3b"], sep(params["b3"], c4, stride=2))  # 1/8, 40
    c16 = sep(params["b4b"], sep(params["b4"], c8, stride=2))  # 1/16, 80
    out16 = _conv2d(params["out1"], c16)
    up8 = _up(out16) + _conv2d(params["inner1"], c8)
    out8 = _conv2d(params["out2"], up8)
    up4 = _up(up8) + _conv2d(params["inner2"], c4)
    out4 = _conv2d(params["out3"], up4)
    return [out4, out8, out16]


# ------------------------------------------------------------ back-project
def back_project(vox_xyz: torch.Tensor, feats: torch.Tensor, KRcam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unproject image features into the voxels (the reference's
    ops/back_project.py:8-92).

    vox_xyz [N, 3] world coordinates; feats [V, C, h, w]; KRcam [V, 4, 4]
    (scaled K @ w2c). Returns ([N, C + 1]: the mean feature over the views
    that see a voxel and its normalised mean depth; the count [N] of those
    views). The views are summed one at a time; a view's four corner
    gathers are one ``table_lookup``, so that the features' gradient is one
    K4 launch a view.
    """
    V, C, h, w = feats.shape
    N = vox_xyz.shape[0]
    hom = torch.cat([vox_xyz, torch.ones_like(vox_xyz[:, :1])], -1)  # [N, 4]
    acc = feats.new_zeros((N, C))
    count = feats.new_zeros(N)
    zsum = feats.new_zeros(N)
    for v in range(V):
        im_p = hom @ KRcam[v].T  # [N, 4]
        z = im_p[:, 2]
        zs = torch.clamp(z.abs(), min=1e-6)
        x = im_p[:, 0] / zs * torch.sign(z)
        y = im_p[:, 1] / zs * torch.sign(z)
        inb = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1) & (z > 0)).to(feats.dtype)
        x0 = torch.clamp(torch.floor(x), 0, w - 2)
        y0 = torch.clamp(torch.floor(y), 0, h - 2)
        fx = torch.clamp(x - x0, 0.0, 1.0)
        fy = torch.clamp(y - y0, 0.0, 1.0)
        i00 = y0.long() * w + x0.long()
        flat = feats[v].permute(1, 2, 0).reshape(h * w, C)
        # the four corners in one lookup, whose gradient is one K4 launch
        c = table_lookup(flat, torch.cat([i00, i00 + 1, i00 + w, i00 + w + 1])).view(4, N, C)
        val = (c[0] * ((1 - fx) * (1 - fy))[:, None]
               + c[1] * (fx * (1 - fy))[:, None]
               + c[2] * ((1 - fx) * fy)[:, None]
               + c[3] * (fx * fy)[:, None])
        acc = acc + val * inb[:, None]
        count = count + inb
        zsum = zsum + z * inb
    denom = torch.clamp(count, min=1.0)
    mean_feat = acc / denom[:, None]
    zmean_v = zsum / denom
    zmask = (zmean_v > 0).to(feats.dtype)
    zmean = torch.sum(zmean_v * zmask) / torch.clamp(zmask.sum(), min=1.0)
    # the square root of a sum of squares, as the reference writes it (not a deviation)
    zstd = torch.sqrt(torch.sum(torch.square((zmean_v - zmean) * zmask))) + 1e-5
    znorm = torch.where(zmask > 0, (zmean_v - zmean) / zstd, torch.zeros_like(zmean_v))
    return torch.cat([mean_feat, znorm[:, None]], -1), count


# ----------------------------------------------------------------- U-Net
def _res_apply(p: Tree, x: torch.Tensor) -> torch.Tensor:
    y = F.relu(_norm(_conv3d(p["c1"], x)))
    y = _norm(_conv3d(p["c2"], y))
    sc = _norm(_conv3d(p["down"], x)) if "down" in p else x
    return F.relu(sc + y)


def _down2(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """Kernel 2, stride 2, no padding (BasicConvolutionBlock ks=2 stride=2)."""
    return F.relu(_norm(F.conv3d(x, p["w"], p["b"], stride=2)))


def unet3d_apply(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """x [1, cin, D, H, W] -> [1, cs4, D, H, W]: the dense SPVCNN
    counterpart (stem, two stride-2 stages, two up stages with skips, the
    point-transform residuals as 1x1x1 convolutions)."""
    x0 = F.relu(_norm(_conv3d(params["stem"], x)))
    x1 = _down2(params["down1"], x0)
    x1 = _res_apply(params["r1b"], _res_apply(params["r1a"], x1))
    x2 = _down2(params["down2"], x1)
    x2 = _res_apply(params["r2b"], _res_apply(params["r2a"], x2))
    z1 = _up(x2, 4) + _conv3d(params["pt1"], x0)  # point-transform residual 1
    y = F.relu(_norm(_deconv3d(params["up1"], x2)))
    y = _res_apply(params["u1b"], _res_apply(params["u1a"], torch.cat([y, x1], 1)))
    y = F.relu(_norm(_deconv3d(params["up2"], y)))
    y = _res_apply(params["u2b"], _res_apply(params["u2a"], torch.cat([y, x0], 1)))
    return y + _conv3d(params["pt2"], z1)  # point-transform residual 2


# -------------------------------------------------------------- ConvGRU
def convgru_apply(params: Tree, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense ConvGRU (the reference's modules.py:202-225) on [1, C, D, H, W]."""
    hx = torch.cat([h, x], 1)
    z = torch.sigmoid(_conv3d(params["convz"], hx))
    r = torch.sigmoid(_conv3d(params["convr"], hx))
    q = torch.tanh(_conv3d(params["convq"], torch.cat([r * h, x], 1)))
    return (1.0 - z) * h + z * q


def _head(p: Tree, h: torch.Tensor) -> torch.Tensor:
    """``h @ w + b`` over the channels: [1, hid, D, H, W] -> [D, H, W]."""
    return torch.tensordot(h[0], p["w"][:, 0], dims=([0], [0])) + p["b"][0]


# ----------------------------------------------------------------- model
@dataclass
class NeuConModelConfig(InstantiateConfig):
    """The reference's NeuConModelConfig (neu_con_model.py:16-24, input_config.py's
    model_cfg: N_VOX 96, VOXEL_SIZE 0.05, fusion on and full)."""

    _target: Type = field(default_factory=lambda: NeuCon)
    n_vox: int = 96
    voxel_size: float = 0.05
    n_layer: int = 3
    thresholds: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hidden_dim: int = 64
    pos_weight: float = 1.5
    pretrained_path: str = ""
    seed: int = 0


class NeuCon:
    """The parameter tree (``params``) and the fragment program over it."""

    def __init__(self, config: NeuConModelConfig, device="cpu", **kwargs) -> None:
        self.config = config
        # each level's grid passes two stride-2 stages in the U-Net
        assert config.n_vox % 16 == 0, "n_vox must be divisible by 16"
        self.device = torch.device(device)
        self.params: Tree = params_from_numpy(_init_tree(config.seed), self.device)
        if config.pretrained_path and not os.path.exists(str(config.pretrained_path)):
            print(f"[neucon] WARNING: pretrained weights not found at {config.pretrained_path}; using RANDOM "
                  f"weights (the reference ckpt is torchsparse-based; see docs/STATUS.md)", flush=True)

    def _levels(self, params: Tree, imgs: torch.Tensor, KRcams: torch.Tensor, vol_origin: torch.Tensor,
                hiddens: Sequence[torch.Tensor], keep: Optional[List[dict]] = None):
        """Every level, coarse to fine: [(h [1, hid, D, D, D], tsdf, occ
        logits, up_occ, occupancy [D, D, D])] (the reference's
        neucon_network.py:103-247 forward, fusion on and full).
        ``hiddens[i]`` is the level's hidden crop, [D, D, D, hid]. Each
        level's stage inputs are appended to ``keep`` if given (to time
        the stages alone)."""
        cfg = self.config
        feats = backbone2d_apply(params["backbone"], imgs)  # 1/4, 1/8, 1/16
        out = []
        prev_feat = prev_occ = None
        for i in range(cfg.n_layer):
            scale = cfg.n_layer - 1 - i
            interval = 2 ** scale
            dim = cfg.n_vox // interval
            ax = torch.arange(dim, dtype=torch.float32, device=imgs.device) * interval
            vox = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
            volume, count = back_project(vox * cfg.voxel_size + vol_origin, feats[scale], KRcams[scale])
            vol = volume.T.reshape(1, -1, dim, dim, dim)
            if i:
                vol = torch.cat([vol, _up(prev_feat)], 1)
                up_occ = _up(prev_occ[None, None])[0, 0]
            else:
                up_occ = torch.ones((dim, dim, dim), dtype=torch.bool, device=imgs.device)
            vis = count.reshape(dim, dim, dim) > 0
            vol = vol * (up_occ & vis).to(vol.dtype)
            feat = unet3d_apply(params[f"unet{i}"], vol)
            h0 = hiddens[i].permute(3, 0, 1, 2)[None]
            h = convgru_apply(params[f"gru{i}"], h0, feat)
            if keep is not None:
                keep.append({"feats": feats[scale], "vox_w": vox * cfg.voxel_size + vol_origin,
                             "KRcam": KRcams[scale], "vol": vol, "hidden": h0, "feat": feat})
            tsdf = torch.tanh(_head(params[f"tsdf{i}"], h)) * 1.05
            occ = _head(params[f"occ{i}"], h)
            # fusion FULL: the cascade gates on the predicted occupancy only
            occupancy = (occ > cfg.thresholds[i]) & up_occ
            out.append((h, tsdf, occ, up_occ, occupancy))
            prev_feat = torch.cat([h, tsdf[None, None], occ[None, None]], 1)
            prev_occ = occupancy
        return out

    @torch.no_grad()
    def fragment_step(self, params: Tree, imgs, KRcams, vol_origin, hiddens, aligned_T=None):
        """One fragment update: the whole coarse-to-fine network.

        imgs [V, H, W, 3] 0..255; KRcams [3, V, 4, 4] per scale (scale 0:
        the finest, intrinsics / 4); vol_origin [3]; hiddens: each level's
        hidden crop [D_i, D_i, D_i, hid_i]; ``aligned_T`` is unused, as in
        the reference package. Returns (tsdf [N, N, N] with 1 where not
        occupied, occupancy [N, N, N] bool, the new hidden crops [D_i, D_i,
        D_i, hid_i])."""
        with fp32_convolutions():
            levels = self._levels(params, imgs, KRcams, vol_origin, hiddens)
        _, tsdf, _, _, occupancy = levels[-1]
        new_hiddens = [h[0].permute(1, 2, 3, 0).contiguous() for h, *_ in levels]
        return torch.where(occupancy, tsdf, torch.ones_like(tsdf)), occupancy, new_hiddens

    def loss(self, params: Tree, imgs, KRcams, vol_origin, hiddens, aligned_T, tsdf_targets, occ_targets):
        """Multi-level loss (the reference's neucon_network.py:249-300):
        pos-weighted BCE on occupancy and log-L1 on TSDF over the occupied
        target voxels, each level over its active set (``up_occ``)."""
        cfg = self.config
        total = imgs.new_zeros(())
        levels = self._levels(params, imgs, KRcams, vol_origin, hiddens)
        for i, (h, tsdf, occ, up_occ, _) in enumerate(levels):
            occ_t, tsdf_t = occ_targets[i], tsdf_targets[i]
            mask = up_occ.to(occ.dtype)
            n_all = torch.clamp(mask.sum(), min=1.0)
            n_p = torch.clamp((occ_t * mask).sum(), min=1.0)
            w1 = (n_all - n_p) / n_p * cfg.pos_weight
            bce = (w1 * occ_t * F.softplus(-occ) + (1.0 - occ_t) * F.softplus(occ)) * mask
            occ_loss = bce.sum() / n_all

            def logt(x):
                return torch.sign(x) * torch.log1p(torch.abs(x))

            tsdf_loss = torch.sum(torch.abs(logt(tsdf) - logt(tsdf_t)) * occ_t * mask) / n_p
            total = total + LEVEL_WEIGHTS[i] * (occ_loss + tsdf_loss)
        return total

    def value_and_grad(self, params: Tree, *args) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, the gradient of every leaf of ``params`` in ``leaves``'
        order), forward and backward in full float32."""
        items = leaves(params)
        with fp32_convolutions(), torch.enable_grad():
            live = [t.detach().requires_grad_(True) for _, t in items]
            loss = self.loss(tree_from_leaves((p, t) for (p, _), t in zip(items, live)), *args)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), list(grads)
