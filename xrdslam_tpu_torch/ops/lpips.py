"""LPIPS (AlexNet backbone) in torch, gated on its weights.

Counterpart of ``xrdslam_tpu/ops/lpips.py``: the same parameter tree
(``conv0..4`` with ``w`` [O, I, k, k] and ``b``; ``lin0..4`` with ``w``
[1, C, 1, 1]), the converter from torchvision's ``alexnet.pth`` and the
LPIPS ``alex.pth`` lin weights, and the cached loader of
``$XRDSLAM_LPIPS_WEIGHTS``. The weights are not in the repository; without
them ``common.metrics.lpips`` is NaN.

Architecture (richzhang/PerceptualSimilarity, lpips/lpips.py, on
torchvision's AlexNet features):
  * input RGB in [0, 1] -> scaled to [-1, 1] -> per-channel shift/scale
  * AlexNet conv stack; taps after each of the 5 ReLUs
  * unit-normalize each tap over channels, squared difference
  * per-tap non-negative 1x1 "lin" weights, spatial mean, sum of taps
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# lpips.py ScalingLayer constants
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# torchvision alexnet.features convs: (cin, cout, k, stride, pad, maxpool after)
_CONVS = [
    (3, 64, 11, 4, 2, True),
    (64, 192, 5, 1, 2, True),
    (192, 384, 3, 1, 1, False),
    (384, 256, 3, 1, 1, False),
    (256, 256, 3, 1, 1, True),
]
_TAP_CHANNELS = [64, 192, 384, 256, 256]
_FEATURE_INDEX = [0, 3, 6, 8, 10]  # alexnet.features.<i> of each conv

Params = Dict[str, Dict[str, torch.Tensor]]


def alexnet_taps(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x [N, 3, H, W], already shifted and scaled -> the 5 ReLU taps."""
    taps = []
    for i, (_, _, _, stride, pad, pool) in enumerate(_CONVS):
        p = params[f"conv{i}"]
        x = F.relu(F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad))
        taps.append(x)
        if pool and i < len(_CONVS) - 1:  # the last pool's output feeds nothing
            x = F.max_pool2d(x, 3, 2)
    return taps


@torch.no_grad()
def lpips_apply(params: Params, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """img0 / img1 [H, W, 3] in [0, 1], on the parameters' device -> the
    scalar LPIPS distance."""
    dev = img0.device
    shift = torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=dev)[None, :, None, None]

    def prep(im):
        return (im.permute(2, 0, 1)[None] * 2.0 - 1.0 - shift) / scale

    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (a, b) in enumerate(zip(alexnet_taps(params, prep(img0)), alexnet_taps(params, prep(img1)))):
        na = a * torch.rsqrt(torch.sum(a * a, 1, keepdim=True) + 1e-10)
        nb = b * torch.rsqrt(torch.sum(b * b, 1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2
        total = total + torch.mean(torch.sum(d * params[f"lin{i}"]["w"], dim=1), dim=(-2, -1))[0]
    return total


def init_params(seed: int = 0, device="cpu") -> Params:
    """A random tree of the right shapes (for structure and tests only:
    LPIPS means something only with the pretrained weights)."""
    g = torch.Generator().manual_seed(seed)
    params: Params = {}
    for i, (cin, cout, k, _, _, _) in enumerate(_CONVS):
        params[f"conv{i}"] = {"w": torch.randn((cout, cin, k, k), generator=g) * np.sqrt(2.0 / (cin * k * k)),
                              "b": torch.zeros((cout,))}
    for i, c in enumerate(_TAP_CHANNELS):
        params[f"lin{i}"] = {"w": torch.rand((1, c, 1, 1), generator=g) * 0.01}
    return to_device(params, device)


def to_device(params: Params, device) -> Params:
    return {k: {n: t.to(device=device, dtype=torch.float32) for n, t in v.items()} for k, v in params.items()}


class WeightsError(ValueError):
    """A weights file that loads but lacks a tensor of the tree, or has one
    of another shape."""


def _state_dict(path: str) -> Dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def load_torch_weights(alexnet_path: str, lin_path: str) -> Params:
    """torchvision's ``alexnet.pth`` (the convs ``features.0/3/6/8/10``) and
    the LPIPS ``alex.pth`` lin weights (``lin{i}.model.1.weight``, or the
    newer ``lins.{i}.model.1.weight``) -> the tree of :func:`lpips_apply`,
    on the CPU."""
    anet, lins = _state_dict(alexnet_path), _state_dict(lin_path)

    def take(sd, key, shape, path):
        if key not in sd:
            raise WeightsError(f"{path}: no tensor {key!r}")
        t = torch.as_tensor(np.asarray(sd[key], np.float32))
        if tuple(t.shape) != shape:
            raise WeightsError(f"{path}: {key!r} has shape {tuple(t.shape)}, expected {shape}")
        return t

    params: Params = {}
    for i, (fi, (cin, cout, k, _, _, _)) in enumerate(zip(_FEATURE_INDEX, _CONVS)):
        params[f"conv{i}"] = {"w": take(anet, f"features.{fi}.weight", (cout, cin, k, k), alexnet_path),
                              "b": take(anet, f"features.{fi}.bias", (cout,), alexnet_path)}
    for i, c in enumerate(_TAP_CHANNELS):
        key = f"lin{i}.model.1.weight"
        if key not in lins:
            key = f"lins.{i}.model.1.weight"
        params[f"lin{i}"] = {"w": take(lins, key, (1, c, 1, 1), lin_path)}
    return params


_CACHED: Optional[Params] = None


def get_pretrained(weights_dir: Optional[str] = None) -> Optional[Params]:
    """The pretrained tree from ``weights_dir`` (default
    ``$XRDSLAM_LPIPS_WEIGHTS``), which holds ``alexnet.pth`` and
    ``lpips_alex.pth``, loaded once a process; None when the files are
    absent, or do not load (then with a line that gives the loader's error)."""
    global _CACHED
    if _CACHED is not None:
        return _CACHED
    d = weights_dir or os.environ.get("XRDSLAM_LPIPS_WEIGHTS", "")
    if not d:
        return None
    a, l = os.path.join(d, "alexnet.pth"), os.path.join(d, "lpips_alex.pth")
    if not (os.path.exists(a) and os.path.exists(l)):
        return None
    try:
        _CACHED = load_torch_weights(a, l)
    except (WeightsError, OSError, RuntimeError, pickle.UnpicklingError) as e:
        print(f"[lpips] failed to load weights from {d}: {e}", flush=True)
        return None
    return _CACHED
