"""VONet: DPVO's feature encoders and update operator as ``nn.Module``s.

Counterpart of ``xrdslam_tpu/models/vonet.py``. The modules carry the
reference's parameter names: a reference key ``update/corr/0/w`` is this
module's ``update.corr.0.weight`` (``b``: ``bias``), so that its flat
``.npz`` checkpoints (``utils/param_tree.save_params``) load one to one.
Convolutions are OIHW and linear weights [out, in], as in the reference.

* ``BasicEncoder4`` (``fnet`` with instance norm, ``inet`` without): a
  7x7 stride-2 stem, two pairs of residual blocks (32 -> 64 channels, the
  second pair at stride 2) and a 1x1 head, at a quarter of the image's
  resolution. Its convolutions run in full float32 with cuDNN's
  deterministic algorithms, whatever the process's TF32 setting.
* ``UpdateOperator``: the correlation encoder, the neighbour MLPs ``c1``
  / ``c2``, two ``SoftAgg``s, two gated residuals and the ``d`` / ``w``
  heads. Its layer norms take the reference's eps of 1e-3 (``nn.LayerNorm``
  defaults to 1e-5).
* ``SoftAgg``: a softmax-weighted sum over each group of edges, broadcast
  back to the group's edges, with a softmax for each channel. The group
  maximum is ``scatter_reduce(amax)``, which no order of its inputs
  changes; it only shifts the softmax, so it is taken without a gradient
  (the reference differentiates through it: the terms cancel, up to
  rounding). The denominators and the weighted sums are
  ``scatter.segment_sum`` (K4 on the card, two launches of 384 columns,
  over one ordering), and the gathers of the denominators and of the
  output back to the edges are ``scatter.segment_gather`` on the same
  ordering, so that in training each of the four is one K4 launch one way
  or the other.

The parameters are created without gradients (``requires_grad_(False)``);
``engine/dpvo_train`` switches them on to train. The reference's gradient
hooks (GradientClip, GradZero) are the identity in the forward pass and
are left out, as in the JAX package's training.

``VONetConfig.pretrained_path`` is read as the reference reads it: a
``.npz`` is the packages' own checkpoint (``utils/param_tree``), another
existing file a torch checkpoint in the reference's layout
(``utils/torch_convert.load_dpvo_weights``), and a missing file leaves
random weights with a warning.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple, Type

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import InstantiateConfig
from ..ops import scatter
from ..utils.param_tree import flatten_tree, listify, load_params
from ..utils.torch_convert import load_dpvo_weights

DIM = 384  # the update operator's width
ENC = 32  # the encoders' stem width
P = 3  # the patch size
CORR_DIM = 2 * 49 * P * P  # two levels of a 7 x 7 window for each of the 9 patch pixels: 882


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in full float32 (no TF32) and with deterministic
    algorithms inside the block; the process's settings are restored after it."""
    cudnn = torch.backends.cudnn
    old = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = False, True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = old


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d's default: biased variance, eps 1e-5, no affine."""
    return F.instance_norm(x, eps=1e-5)


class ResBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, norm: bool):
        super().__init__()
        self.stride, self.norm = stride, norm
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        if stride != 1:
            self.down = nn.Conv2d(cin, planes, 1, stride, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = _instance_norm if self.norm else (lambda v: v)
        y = F.relu(f(self.conv1(x)))
        y = F.relu(f(self.conv2(y)))
        if self.stride != 1:
            x = f(self.down(x))
        return F.relu(x + y)


class BasicEncoder4(nn.Module):
    """x [B, 3, H, W] -> [B, out, H/4, W/4]."""

    def __init__(self, output_dim: int, norm: bool):
        super().__init__()
        self.norm = norm
        self.conv1 = nn.Conv2d(3, ENC, 7, 2, 3)
        self.layer1 = nn.ModuleList([ResBlock(ENC, ENC, 1, norm), ResBlock(ENC, ENC, 1, norm)])
        self.layer2 = nn.ModuleList([ResBlock(ENC, 2 * ENC, 2, norm), ResBlock(2 * ENC, 2 * ENC, 1, norm)])
        self.conv2 = nn.Conv2d(2 * ENC, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        x = F.relu(_instance_norm(x) if self.norm else x)
        for block in (*self.layer1, *self.layer2):
            x = block(x)
        return self.conv2(x)


class SoftAgg(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.f, self.g, self.h = nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor, num_segments: int) -> torch.Tensor:
        """x [E, D]; seg [E] int32 group ids in [0, num_segments) (padded
        edges at the reserved last group); mask [E] bool."""
        order = scatter.scatter_order(seg, num_segments)  # one ordering for both sums and both gathers
        logits = torch.where(mask[:, None], self.g(x), torch.full_like(x, -1e30))
        with torch.no_grad():  # the maximum only shifts the softmax: no gradient flows through it
            seg_max = torch.zeros((num_segments, x.shape[1]), dtype=x.dtype, device=x.device).scatter_reduce(
                0, seg.long()[:, None].expand_as(logits), logits, "amax", include_self=False)
        ex = torch.exp(logits - seg_max[seg.long()]) * mask[:, None].to(x.dtype)
        denom = scatter.segment_sum(order, ex)
        wts = ex / torch.clamp(scatter.segment_gather(denom, order), min=1e-12)
        y = scatter.segment_sum(order, self.f(x) * wts)
        return scatter.segment_gather(self.h(y), order)


class GatedResidual(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gate, self.res1, self.res2 = nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + torch.sigmoid(self.gate(x)) * self.res2(F.relu(self.res1(x)))


def _ln() -> nn.LayerNorm:
    return nn.LayerNorm(DIM, eps=1e-3)


class UpdateOperator(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = nn.ModuleList([nn.Linear(DIM, DIM), nn.Linear(DIM, DIM)])
        self.c2 = nn.ModuleList([nn.Linear(DIM, DIM), nn.Linear(DIM, DIM)])
        self.norm = _ln()
        self.agg_kk, self.agg_ij = SoftAgg(DIM), SoftAgg(DIM)
        self.gru = nn.ModuleDict({"ln1": _ln(), "gr1": GatedResidual(DIM), "ln2": _ln(), "gr2": GatedResidual(DIM)})
        self.corr = nn.ModuleList([nn.Linear(CORR_DIM, DIM), nn.Linear(DIM, DIM), _ln(), nn.Linear(DIM, DIM)])
        self.d, self.w = nn.Linear(DIM, 2), nn.Linear(DIM, 2)

    def forward(self, net, inp, corr, seg_kk, seg_ij, ix, jx, mask, num_segments: int):
        """One update step on the padded edge set.

        net [E, DIM] hidden state; inp [E, DIM] context; corr [E, 882];
        seg_kk / seg_ij [E] int32 dense group ids of the patch and of the
        (ii, jj) frame pair, padded edges at ``num_segments - 1``; ix / jx
        [E] the edge of the same patch at target jj - 1 / jj + 1, -1 where
        there is none; mask [E] bool. Returns (net', delta [E, 2], weight
        [E, 2]).
        """
        c = self.corr
        net = self.norm(net + inp + c[3](F.relu(c[2](c[1](F.relu(c[0](corr)))))))
        m = mask[:, None].to(net.dtype)
        mask_ix = ((ix >= 0) & mask)[:, None].to(net.dtype)
        mask_jx = ((jx >= 0) & mask)[:, None].to(net.dtype)
        net_ix = net[ix.long().clamp(min=0)] * mask_ix
        net_jx = net[jx.long().clamp(min=0)] * mask_jx
        net = net + self.c1[1](F.relu(self.c1[0](net_ix)))
        net = net + self.c2[1](F.relu(self.c2[0](net_jx)))
        net = net + self.agg_kk(net, seg_kk, mask, num_segments)
        net = net + self.agg_ij(net, seg_ij, mask, num_segments)
        g = self.gru
        net = g["gr1"](g["ln1"](net))
        net = g["gr2"](g["ln2"](net))
        net = net * m
        delta = self.d(F.relu(net))
        weight = torch.sigmoid(self.w(F.relu(net)))
        return net, delta, weight * m


@dataclass
class VONetConfig(InstantiateConfig):
    """The reference's VONetConfig: the checkpoint at ``pretrained_path``
    is loaded (a ``.npz`` of ``utils/param_tree.save_params``, or a torch
    ``dpvo.pth`` in the reference's layout); without a file there, the
    weights are random (with a warning)."""

    _target: Type = field(default_factory=lambda: VONet)
    pretrained_path: str = ""


def _init_(module: nn.Module, gen: torch.Generator) -> None:
    """The reference's initialisation: convolutions Kaiming-normal on
    fan-out with zero bias, linear layers uniform in +-1/sqrt(fan-in)."""
    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            cout, _, k, _ = mod.weight.shape
            mod.weight.normal_(0.0, float(np.sqrt(2.0 / (cout * k * k))), generator=gen)
            mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            bound = float(1.0 / np.sqrt(mod.in_features))
            mod.weight.uniform_(-bound, bound, generator=gen)
            mod.bias.uniform_(-bound, bound, generator=gen)


def state_key(ref_key: str) -> str:
    """A reference checkpoint key (``update/corr/0/w``) -> the state-dict key
    (``update.corr.0.weight``)."""
    *path, leaf = ref_key.split("/")
    return ".".join(path + [{"w": "weight", "b": "bias"}[leaf]])


class VONet(nn.Module):
    """The DPVO network: ``fnet``, ``inet`` and ``update``."""

    DIM = DIM
    RES = 4
    P = P

    def __init__(self, config: VONetConfig, seed: int = 0):
        super().__init__()
        self.config = config
        self.fnet = BasicEncoder4(128, norm=True)
        self.inet = BasicEncoder4(DIM, norm=False)
        self.update = UpdateOperator()
        self.loaded_from = ""  # the checkpoint the weights came from, "" for random weights
        with torch.no_grad():
            _init_(self, torch.Generator().manual_seed(seed))
        path = str(config.pretrained_path)
        if path and path.endswith(".npz") and os.path.exists(path):
            self.load_tree(load_params(path))
            self.loaded_from = path
        elif path and os.path.exists(path):
            self.load_tree(load_dpvo_weights(path))
            self.loaded_from = path
        elif path:
            print(f"[vonet] WARNING: pretrained weights not found at {path}; using RANDOM weights — "
                  f"tracking accuracy will be poor (mechanics only)", flush=True)
        self.requires_grad_(False)

    @torch.no_grad()
    def load_tree(self, tree: Any) -> None:
        """Copy a reference parameter tree (nested dicts and lists of
        arrays, ``w`` / ``b`` leaves) into the module; every parameter must
        be given, at its shape."""
        flat = {state_key(k): torch.from_numpy(np.array(v, np.float32)) for k, v in flatten_tree(tree).items()}
        own = self.state_dict()
        if set(flat) != set(own):
            raise ValueError(f"checkpoint keys differ: missing {sorted(set(own) - set(flat))[:5]}, "
                             f"unexpected {sorted(set(flat) - set(own))[:5]}")
        for k, v in flat.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} does not fit {tuple(own[k].shape)}")
        self.load_state_dict(flat)

    def tree(self) -> Dict[str, Any]:
        """The parameters as the reference's nested tree of numpy arrays."""
        root: Dict[str, Any] = {}
        inv = {"weight": "w", "bias": "b"}
        for key, val in self.state_dict().items():
            *path, leaf = key.split(".")
            node = root
            for p in path:
                node = node.setdefault(p, {})
            node[inv[leaf]] = val.detach().cpu().numpy()
        return listify(root)

    def extract_features(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image [3, H, W] in [0, 1] -> (fmap [128, H/4, W/4], imap [DIM,
        H/4, W/4]), both divided by 4; the input is normalised as 2 rgb - 0.5."""
        x = (2.0 * image - 0.5)[None]
        with fp32_convolutions():
            fmap = self.fnet(x)[0] / 4.0
            imap = self.inet(x)[0] / 4.0
        return fmap, imap
