"""Load the reference package's Co-SLAM parameters into the port's model.

``params_from_jax`` takes the reference ``model_params`` tree with its
leaves as numpy arrays (``{"embed_fn": {"table": [L,T,F]}, "decoder":
{"sdf": {"w": [...]}, "color": {"w": [...]}}}``, each ``w`` ``[in, out]``)
and copies it into a ``JointEncoding``. Linear weights are transposed to
``nn.Linear``'s ``[out, in]``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.joint_encoding import JointEncoding


def _copy(dst: torch.Tensor, src: Any, what: str) -> None:
    src = torch.tensor(np.asarray(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def params_from_jax(np_tree: Dict[str, Any], model: JointEncoding) -> JointEncoding:
    _copy(model.table, np_tree["embed_fn"]["table"], "embed_fn.table")
    for net, name in ((model.sdf_net, "sdf"), (model.color_net, "color")):
        ws = np_tree["decoder"][name]["w"]
        if len(ws) != len(net.layers) or "b" in np_tree["decoder"][name]:
            raise ValueError(f"decoder.{name}: expected {len(net.layers)} bias-free layers")
        for i, (layer, w) in enumerate(zip(net.layers, ws)):
            _copy(layer.weight, np.asarray(w).T, f"decoder.{name}.w[{i}]")
    return model
