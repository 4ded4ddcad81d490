"""The reference's torch checkpoints -> the reference packages' parameter trees.

Counterpart of ``xrdslam_tpu/utils/torch_convert.py``, and the same trees:
nested dicts and lists of float32 numpy arrays, linear weights [in, out]
for the ConvONet decoders (``models/conv_onet.mlp_decoder_apply``'s layout)
and [out, in] for VONet (torch's, with convolutions OIHW).
``load_tree_into_decoder`` copies a decoder tree into an ``MLPDecoder``
(``decoder_tree`` reads one out), ``VONet.load_tree`` a VONet tree into
the network. Checkpoints load on the
CPU (``map_location="cpu"``), as the reference package loads them.

* ``load_dpvo_weights``: DPVO's ``dpvo.pth`` (the reference's
  vo_net_model.py:39-50: ``module.`` prefixes stripped, ``update.lmbda``
  dropped) by the name mapping of ``_dpvo_layout``. ``save_dpvo_weights``
  writes a tree back in that layout.
* ``load_nice_decoders``: NICE-SLAM's ``middle_fine.pt`` (the *middle*
  decoder stored under ``coarse``, the *fine* one under ``fine``: the
  original NICE-SLAM naming, the reference's conv_onet.py:305-318) and
  ``coarse.pt``; Point-SLAM loads the middle decoder of a
  ``middle_fine.pt``. ``save_nice_decoders`` writes trees back in that
  layout.

The correlation features' order is the JAX package's: ``stack([level 1,
level 2], -1).reshape(E, -1)`` of corr [E, P, P, 7, 7]. If the
reference's CUDA kernel flattens its 882 features in another order, the
first correlation layer's input columns of a converted ``dpvo.pth`` need
the matching permutation; the port carries the JAX mapping over and does
not re-derive the reference kernel's order.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .param_tree import flatten_tree


def _torch_load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=False)


def _f32(v: Any) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)


# ------------------------------------------------------------------ DPVO
def _dpvo_layout(leaf: Callable[[str], Any]) -> Dict[str, Any]:
    """The VONet tree with ``leaf(reference name)`` at each leaf: the name
    mapping, written once for both directions.

      patchify.fnet.* -> fnet.*  (convolutions stay OIHW; ``downsample.0`` -> ``down``)
      patchify.inet.* -> inet.*
      update.c1.{0,2} -> update.c1[0, 1]  (nn.Sequential indices)
      update.gru.{0..3} -> update.gru.{ln1, gr1, ln2, gr2}
      update.corr.{0,2,3,5} -> update.corr[0, 1, 2 (the layer norm), 3]
      update.agg_kk / agg_ij .f/.g/.h -> the SoftAggs' linears
      update.d.1 / update.w.1 -> the heads (GradientClip and Sigmoid have no parameters)
    """
    def wb(prefix):
        return {"w": leaf(prefix + ".weight"), "b": leaf(prefix + ".bias")}

    def resblock(prefix, has_down):
        p = {"conv1": wb(prefix + ".conv1"), "conv2": wb(prefix + ".conv2")}
        if has_down:
            p["down"] = wb(prefix + ".downsample.0")
        return p

    def encoder(prefix):
        return {"conv1": wb(prefix + ".conv1"),
                "layer1": [resblock(prefix + ".layer1.0", False), resblock(prefix + ".layer1.1", False)],
                "layer2": [resblock(prefix + ".layer2.0", True), resblock(prefix + ".layer2.1", False)],
                "conv2": wb(prefix + ".conv2")}

    def softagg(prefix):
        return {"f": wb(prefix + ".f"), "g": wb(prefix + ".g"), "h": wb(prefix + ".h")}

    def gated(prefix):
        return {"gate": wb(prefix + ".gate.0"), "res1": wb(prefix + ".res.0"), "res2": wb(prefix + ".res.2")}

    up = "update"
    return {
        "fnet": encoder("patchify.fnet"),
        "inet": encoder("patchify.inet"),
        "update": {
            "c1": [wb(f"{up}.c1.0"), wb(f"{up}.c1.2")],
            "c2": [wb(f"{up}.c2.0"), wb(f"{up}.c2.2")],
            "norm": wb(f"{up}.norm"),
            "agg_kk": softagg(f"{up}.agg_kk"),
            "agg_ij": softagg(f"{up}.agg_ij"),
            "gru": {"ln1": wb(f"{up}.gru.0"), "gr1": gated(f"{up}.gru.1"),
                    "ln2": wb(f"{up}.gru.2"), "gr2": gated(f"{up}.gru.3")},
            "corr": [wb(f"{up}.corr.0"), wb(f"{up}.corr.2"), wb(f"{up}.corr.3"), wb(f"{up}.corr.5")],
            "d": wb(f"{up}.d.1"),
            "w": wb(f"{up}.w.1"),
        },
    }


def load_dpvo_weights(path: str) -> Dict[str, Any]:
    """A reference ``dpvo.pth`` -> the VONet tree (``VONet.load_tree``'s)."""
    state = _torch_load(path)
    state = {k.replace("module.", ""): v for k, v in state.items() if "update.lmbda" not in k}
    return _dpvo_layout(lambda name: _f32(state[name]))


def save_dpvo_weights(path: str, tree: Dict[str, Any]) -> None:
    """A VONet tree -> a ``torch.save`` state dict with the reference's names."""
    flat = flatten_tree(tree)
    names = flatten_tree(_dpvo_layout(lambda name: name))
    torch.save({name: torch.from_numpy(_f32(flat[key]).copy()) for key, name in names.items()}, path)


# ------------------------------------------------------- ConvONet decoders
def _convert_mlp(state: Dict[str, Any]) -> Dict[str, Any]:
    """A reference MLP decoder's state dict -> the decoder tree (linear
    weights transposed to [in, out])."""
    out: Dict[str, Any] = {}
    pts_w, pts_b, fc_w, fc_b = {}, {}, {}, {}
    for k, v in state.items():
        arr = _f32(v)
        m = re.search(r"(pts_linears|fc_c)\.(\d+)\.(weight|bias)$", k)
        if m:
            w, b = (pts_w, pts_b) if m.group(1) == "pts_linears" else (fc_w, fc_b)
            if m.group(3) == "weight":
                w[int(m.group(2))] = arr.T
            else:
                b[int(m.group(2))] = arr
        elif k.endswith("output_linear.weight"):
            out["out_w"] = arr.T
        elif k.endswith("output_linear.bias"):
            out["out_b"] = arr
        elif k.endswith("embedder._B"):
            out["B"] = arr
    out["pts_w"] = [pts_w[i] for i in range(len(pts_w))]
    out["pts_b"] = [pts_b[i] for i in range(len(pts_b))]
    if fc_w:
        out["fc_w"] = [fc_w[i] for i in range(len(fc_w))]
        out["fc_b"] = [fc_b[i] for i in range(len(fc_b))]
    return out


def _decoder_state(prefix: str, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``_convert_mlp``'s inverse: the reference's names under ``prefix``."""
    def t(a):
        return torch.from_numpy(_f32(a).copy())

    state = {}
    for kind, ws, bs in (("pts_linears", tree["pts_w"], tree["pts_b"]),
                         ("fc_c", tree.get("fc_w", []), tree.get("fc_b", []))):
        for i, (w, b) in enumerate(zip(ws, bs)):
            state[f"{prefix}.{kind}.{i}.weight"] = t(np.asarray(w).T)
            state[f"{prefix}.{kind}.{i}.bias"] = t(b)
    state[f"{prefix}.output_linear.weight"] = t(np.asarray(tree["out_w"]).T)
    state[f"{prefix}.output_linear.bias"] = t(tree["out_b"])
    if "B" in tree:
        state[f"{prefix}.embedder._B"] = t(tree["B"])
    return state


def _model_state(ck: Dict[str, Any]) -> Dict[str, Any]:
    return ck["model"] if "model" in ck else ck


def load_nice_decoders(middle_fine_path: str, coarse_path: Optional[str] = None) -> Dict[str, Any]:
    """{"middle", "fine"(, "coarse")} decoder trees from the reference's
    ``middle_fine.pt`` (and ``coarse.pt``); entries of an encoder are
    skipped."""
    middle, fine = {}, {}
    for k, v in _model_state(_torch_load(middle_fine_path)).items():
        if "decoder" not in k or "encoder" in k:
            continue
        if "coarse" in k:  # the middle decoder under its original name
            middle[k] = v
        elif "fine" in k:
            fine[k] = v
    out = {"middle": _convert_mlp(middle), "fine": _convert_mlp(fine)}
    if coarse_path:
        coarse = {k: v for k, v in _model_state(_torch_load(coarse_path)).items()
                  if "decoder" in k and "encoder" not in k}
        out["coarse"] = _convert_mlp(coarse)
    return out


def save_nice_decoders(middle_fine_path: str, trees: Dict[str, Any], coarse_path: Optional[str] = None) -> None:
    """Decoder trees -> ``middle_fine.pt`` (``{"model": ...}``, the middle
    decoder under ``decoder.coarse``, the fine under ``decoder.fine``) and,
    with ``coarse_path``, ``coarse.pt`` (the coarse decoder under
    ``decoder``)."""
    torch.save({"model": {**_decoder_state("decoder.coarse", trees["middle"]),
                          **_decoder_state("decoder.fine", trees["fine"])}}, middle_fine_path)
    if coarse_path:
        torch.save({"model": _decoder_state("decoder", trees["coarse"])}, coarse_path)


def _copy(dst: torch.Tensor, src: Any, what: str) -> None:
    src = torch.tensor(np.asarray(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src)


def _linear(layer: torch.nn.Linear, w: Any, b: Any, what: str) -> None:
    _copy(layer.weight, np.asarray(w).T, f"{what}.w")
    _copy(layer.bias, b, f"{what}.b")


@torch.no_grad()
def load_tree_into_decoder(dec: torch.nn.Module, tree: Dict[str, Any], what: str) -> None:
    """Copy a decoder tree (``_convert_mlp``'s layout) into an
    ``MLPDecoder``; the tree must have the decoder's layers and shapes."""
    if (len(tree["pts_w"]) != len(dec.pts) or ("fc_w" in tree) != (dec.fc is not None)
            or ("B" in tree) != (dec.B is not None)):
        raise ValueError(f"{what}: the reference decoder has another layout")
    if dec.B is not None:
        _copy(dec.B, tree["B"], f"{what}.B")
    for i, layer in enumerate(dec.pts):
        _linear(layer, tree["pts_w"][i], tree["pts_b"][i], f"{what}.pts[{i}]")
    for i, layer in enumerate(dec.fc or []):
        _linear(layer, tree["fc_w"][i], tree["fc_b"][i], f"{what}.fc[{i}]")
    _linear(dec.out, tree["out_w"], tree["out_b"], f"{what}.out")


def decoder_tree(dec: torch.nn.Module) -> Dict[str, Any]:
    """``load_tree_into_decoder``'s inverse: an ``MLPDecoder``'s weights as
    a decoder tree of float32 numpy arrays ([in, out] linears)."""
    def w(layer):
        return _f32(layer.weight).T.copy()

    tree = {"pts_w": [w(layer) for layer in dec.pts], "pts_b": [_f32(layer.bias) for layer in dec.pts],
            "out_w": w(dec.out), "out_b": _f32(dec.out.bias)}
    if dec.fc is not None:
        tree["fc_w"] = [w(layer) for layer in dec.fc]
        tree["fc_b"] = [_f32(layer.bias) for layer in dec.fc]
    if dec.B is not None:
        tree["B"] = _f32(dec.B)
    return tree
