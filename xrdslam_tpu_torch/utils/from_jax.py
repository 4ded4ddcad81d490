"""Load the reference package's parameters into the port.

``gaussian_params_from_jax`` takes the reference SplaTAM ``params`` dict
(``means3D``, ``rgb_colors``, ``unnorm_rotations``, ``logit_opacities``,
``log_scales``) with numpy leaves, and optionally its ``dead`` mask and
``count``, and returns the port's tensors; ``splatam_state_from_jax`` puts
such a state, with the reference's device keyframe store (``kf_rgb_u16``,
``kf_depth``, ``kf_w2c``) and count, into a port ``SplaTAM`` in place.
``params_from_jax`` takes the reference Co-SLAM ``model_params`` tree with
its leaves as numpy arrays
(``{"embed_fn": {"table": ...}, "decoder": {"sdf": {"w": [...]}, "color":
{"w": [...]}}}``, each ``w`` ``[in, out]``; the table is ``[L, T, F]`` for
the exact hash, a dict of ``v{l}`` / ``h{l}`` tables for the packed hash
and of ``s{i}`` planes for the tri-plane) and copies it into a
``JointEncoding``. Linear weights are transposed to
``nn.Linear``'s ``[out, in]``. ``pointslam_params_from_jax`` takes the
reference Point-SLAM ``params`` tree (``{"geometry": {"feats"}, "color":
{"feats", "relpos_B", "nb_w1", "nb_b1", "nb_w2", "nb_b2"}, "decoder":
{"geo": ..., "col": ...}}``, each decoder ``{"B", "pts_w", "pts_b", "fc_w",
"fc_b", "out_w", "out_b"}``), and its ``frozen`` dict where the reference
keeps the loaded geometry decoder frozen, and copies them into a
``ConvOnet2``.
``niceslam_params_from_jax`` takes the reference NICE-SLAM ``params`` tree
(``grid_middle``, ``grid_fine``, ``grid_color``, ``grid_coarse`` as [X, Y,
Z, C], and ``decoder``: ``{name: decoder tree}`` for the trainable
decoders, the coarse one without ``B`` and ``fc_*``) and, for decoders the
reference keeps frozen, its ``frozen`` dict; copies both into a
``ConvOnet``. ``voxfusion_params_from_jax`` takes the reference Vox-Fusion
``model_params`` tree (``{"embeddings": {"table"}, "decoder": {"pts":
[...], "sdf_out", "color0", "color1"}}``, each layer ``{"w", "b"}``) and
copies it into a ``SparseVoxel``; ``voxfusion_state_from_jax`` copies the
reference's device voxel maps (the dict of ``empty_device_maps`` /
``insert_marked``, or of ``VoxelHashMap.device_state``, whose vertex hash
is left as it is) into a port ``VoxFusion``'s ``maps`` in place (the
same keys, shapes and dtypes). ``dpvo_params_from_jax`` copies the
reference DPVO's ``params`` tree (``fnet``, ``inet``, ``update``; the layout
of ``dpvo_train.save_params``) into a ``VONet``; ``dpvo_state_from_jax``
copies a DPVO's whole state (the host graph, poses, patches, counters, the
patch generator's state, the feature rings and each edge's hidden state)
from a reference ``DPVO``, or from another port ``DPVO``, into a port
``DPVO``, so that both run their next update from one state.
``neucon_params_from_jax`` copies the reference NeuralRecon ``params`` tree
(``backbone``, ``unet{i}``, ``gru{i}``, ``tsdf{i}``, ``occ{i}``; HWIO and
DHWIO kernels) into a ``NeuCon``'s tree in place, each leaf in torch's
layout (``models/neucon.to_torch_layout``: the transposed convolutions'
kernels flipped).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.conv_onet import ConvOnet
from ..models.conv_onet_pointslam import ConvOnet2
from ..models.gaussian_splatting import GAUSS_GROUPS
from ..models.joint_encoding import JointEncoding
from ..models.sparse_voxel import SparseVoxel
from .torch_convert import _copy, _linear, load_tree_into_decoder

if TYPE_CHECKING:
    from ..models.neucon import NeuCon
    from ..algorithms.dpvo import DPVO
    from ..models.vonet import VONet
    from ..algorithms.splatam import SplaTAM
    from ..algorithms.voxfusion import VoxFusion


@torch.no_grad()
def params_from_jax(np_tree: Dict[str, Any], model: JointEncoding) -> JointEncoding:
    table = np_tree["embed_fn"]["table"]
    if isinstance(model.embed_fn, torch.nn.Parameter):
        _copy(model.embed_fn, table, "embed_fn.table")
    else:
        names = sorted(table) if isinstance(table, dict) else None
        if names != sorted(model.embed_fn):
            raise ValueError(f"embed_fn.table: the reference's tables {names} do not match the model's "
                             f"{sorted(model.embed_fn)}")
        for k, v in table.items():
            _copy(model.embed_fn[k], v, f"embed_fn.table.{k}")
    for net, name in ((model.sdf_net, "sdf"), (model.color_net, "color")):
        ws = np_tree["decoder"][name]["w"]
        if len(ws) != len(net.layers) or "b" in np_tree["decoder"][name]:
            raise ValueError(f"decoder.{name}: expected {len(net.layers)} bias-free layers")
        for i, (layer, w) in enumerate(zip(net.layers, ws)):
            _copy(layer.weight, np.asarray(w).T, f"decoder.{name}.w[{i}]")
    return model


def gaussian_params_from_jax(np_tree: Dict[str, Any], device="cpu", dead: Optional[Any] = None,
                             count: Optional[Any] = None
                             ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor], Optional[int]]:
    """(params, dead as a bool tensor or None, count as an int or None)."""
    params = {k: torch.tensor(np.asarray(np_tree[k], np.float32), device=device) for k in GAUSS_GROUPS}
    dead_t = None if dead is None else torch.tensor(np.asarray(dead, bool), device=device)
    return params, dead_t, None if count is None else int(np.asarray(count))


@torch.no_grad()
def splatam_state_from_jax(algo: "SplaTAM", np_tree: Dict[str, Any], dead: Any, count: Any,
                           kf_rgb_u16: Optional[Any] = None, kf_depth: Optional[Any] = None,
                           kf_w2c: Optional[Any] = None) -> "SplaTAM":
    """The reference SplaTAM's table, ``dead``, count (host and device) and,
    where given, its keyframe store rows (rgb as uint16 [N, H, W, 3], depth
    [N, H, W], w2c [N, 4, 4], N at most the port's ``max_keyframes``)."""
    for k in GAUSS_GROUPS:
        _copy(algo.params[k], np_tree[k], k)
    algo.dead.copy_(torch.from_numpy(np.asarray(dead, bool)))
    n = int(np.asarray(count))
    algo.count_dev.fill_(n)
    algo.model.n_gauss = n
    if kf_rgb_u16 is not None:
        rgb = np.asarray(kf_rgb_u16, np.uint16)
        algo.kf_rgb[:len(rgb)] = torch.from_numpy((rgb.astype(np.int32) - 32768).astype(np.int16))
        _copy(algo.kf_depth[:len(rgb)], kf_depth, "kf_depth")
        _copy(algo.kf_w2c[:len(rgb)], kf_w2c, "kf_w2c")
    return algo


@torch.no_grad()
def pointslam_params_from_jax(np_tree: Dict[str, Any], model: ConvOnet2,
                              frozen: Optional[Dict[str, Any]] = None) -> ConvOnet2:
    _copy(model.geo_feats, np_tree["geometry"]["feats"], "geometry.feats")
    col = np_tree["color"]
    _copy(model.col_feats, col["feats"], "color.feats")
    if "relpos_B" not in col:
        raise ValueError("color: the reference model has no relative-position MLP")
    _copy(model.relpos_B, col["relpos_B"], "color.relpos_B")
    _linear(model.nb1, col["nb_w1"], col["nb_b1"], "color.nb1")
    _linear(model.nb2, col["nb_w2"], col["nb_b2"], "color.nb2")
    decoders = {**(frozen or {}), **np_tree["decoder"]}
    load_tree_into_decoder(model.geo_decoder, decoders["geo"], "decoder.geo")
    load_tree_into_decoder(model.col_decoder, decoders["col"], "decoder.col")
    if ("exposure" in np_tree) != model.has_exposure:
        raise ValueError(f"exposure: the reference's tree {'has' if 'exposure' in np_tree else 'lacks'} the exposure "
                         f"MLP, the model {'has' if model.has_exposure else 'lacks'} it")
    if model.has_exposure:
        for k in ("w1", "b1", "w2", "b2"):
            _copy(getattr(model, f"exposure_{k}"), np_tree["exposure"][k], f"exposure.{k}")
    return model


@torch.no_grad()
def niceslam_params_from_jax(np_tree: Dict[str, Any], model: ConvOnet,
                             frozen: Optional[Dict[str, Any]] = None) -> ConvOnet:
    if sorted(k for k in np_tree if k.startswith("grid_")) != sorted(model.grids):
        raise ValueError(f"the reference's grids {sorted(np_tree)} do not match the model's {sorted(model.grids)}")
    for name, grid in model.grids.items():
        _copy(grid, np_tree[name], name)
    trees = {**(frozen or {}), **np_tree["decoder"]}
    if sorted(trees) != sorted(model.decoders):
        raise ValueError(f"the reference's decoders {sorted(trees)} do not match the model's {sorted(model.decoders)}")
    for name, dec in model.decoders.items():
        load_tree_into_decoder(dec, trees[name], f"decoder.{name}")
    return model


@torch.no_grad()
def voxfusion_params_from_jax(np_tree: Dict[str, Any], model: SparseVoxel) -> SparseVoxel:
    _copy(model.embeddings, np_tree["embeddings"]["table"], "embeddings.table")
    dec = np_tree["decoder"]
    if len(dec["pts"]) != len(model.pts):
        raise ValueError(f"decoder.pts: {len(dec['pts'])} layers, the model has {len(model.pts)}")
    for i, (layer, tree) in enumerate(zip(model.pts, dec["pts"])):
        _linear(layer, tree["w"], tree["b"], f"decoder.pts[{i}]")
    for name in ("sdf_out", "color0", "color1"):
        _linear(getattr(model, name), dec[name]["w"], dec[name]["b"], f"decoder.{name}")
    return model


@torch.no_grad()
def voxfusion_state_from_jax(algo: "VoxFusion", np_maps: Dict[str, Any]) -> "VoxFusion":
    for k, v in np_maps.items():
        dst = algo.maps[k]
        src = torch.from_numpy(np.array(v))
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"maps.{k}: {src.dtype} {tuple(src.shape)} does not fit {dst.dtype} {tuple(dst.shape)}")
        dst.copy_(src)
    return algo


@torch.no_grad()
def dpvo_params_from_jax(np_tree: Dict[str, Any], model: "VONet") -> "VONet":
    model.load_tree(np_tree)
    return model


# a DPVO's host state, copied as arrays, and its scalars
DPVO_HOST_ARRAYS = ("tstamps", "poses_t", "poses_q", "patches", "colors", "points", "ii", "jj", "kk")
DPVO_SCALARS = ("n", "m", "counter")
DPVO_RINGS = ("imap_ring", "gmap_ring", "fmap1_ring", "fmap2_ring")


def _host(x: Any) -> np.ndarray:
    """An array of either package (numpy, jax, or a tensor on any device) as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.array(x)


@torch.no_grad()
def dpvo_state_from_jax(algo: "DPVO", src: Any) -> "DPVO":
    for k in DPVO_HOST_ARRAYS:
        dst, val = getattr(algo, k), _host(getattr(src, k))
        if val.shape[1:] != dst.shape[1:] or (k not in ("ii", "jj", "kk") and val.shape != dst.shape):
            raise ValueError(f"{k}: shape {val.shape} does not fit {dst.shape}")
        setattr(algo, k, val.astype(dst.dtype))
    for k in DPVO_SCALARS:
        setattr(algo, k, int(getattr(src, k)))
    for k in DPVO_RINGS:
        _copy(getattr(algo, k), _host(getattr(src, k)), k)
    net = torch.as_tensor(_host(src.net).astype(np.float32))
    if tuple(net.shape) != (len(algo.ii), algo.DIM):
        raise ValueError(f"net: shape {tuple(net.shape)} does not fit {len(algo.ii)} edges")
    algo.net = net.to(algo.device)
    algo.tlist = list(src.tlist)
    algo.delta = {int(t): (int(t0), np.array(dP)) for t, (t0, dP) in src.delta.items()}
    algo._rng.bit_generator.state = src._rng.bit_generator.state
    algo.initialized = bool(src.is_initialized())
    return algo


@torch.no_grad()
def neucon_params_from_jax(np_tree: Dict[str, Any], model: "NeuCon") -> "NeuCon":
    from ..models.neucon import leaves, to_torch_layout

    src = dict(leaves(np_tree))
    dst = leaves(model.params)
    if set(src) != {p for p, _ in dst}:
        raise ValueError(f"the trees differ: {sorted(set(src) ^ {p for p, _ in dst})}")
    for path, t in dst:
        _copy(t, to_torch_layout(path, src[path]), "/".join(path))
    return model
