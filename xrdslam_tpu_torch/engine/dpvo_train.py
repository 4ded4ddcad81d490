"""DPVO's update operator trained in the environment, and its checkpoint format.

Counterpart of ``xrdslam_tpu/engine/dpvo_train.py``. The reference ships
pretrained weights (``dpvo.pth``) that this repository does not have; the
operator learns here instead from synthetic RGB-D frame pairs with exact
correspondences: patch centres of frame i with known depth are reprojected
into frame j with the true poses, the current estimate is that target plus
noise (a mid-convergence bundle-adjustment state), and the network, which
sees only the correlation features at the perturbed coordinates, must
regress the correction ``delta`` and a validity ``weight``, recurrently
for ``n_rec`` steps as at inference.

* ``make_batch``: numpy, the JAX package's function as it is: the same
  ``rng`` draws in the same order, so the same dataset gives the same
  batch bit for bit.
* ``loss_fn``: the L1 of ``delta`` against the error clipped to +-4 px
  (the correlation window's reach), over valid patches, plus 0.05 x the
  BCE of ``weight`` on validity, averaged over the ``n_rec`` steps, with
  the estimate detached between steps. Edges are padded as in the JAX
  package: each patch its own ``kk`` group, all in ``ij`` group 0, no
  neighbours, ``m + 1`` segments. The second pyramid level is
  ``avg_pool2d`` 4 x 4 (the JAX ``reduce_window`` sum / 16, VALID).
* ``value_and_grad`` runs the loss and its gradients with cuDNN's
  convolutions in full float32 (``models/vonet.fp32_convolutions``), the
  backward too. On the card every gradient that reaches the correlation's
  and the samplers' maps, and the SoftAggs' sums and gathers, is K4
  (``ops/scatter``): ``TRAIN_STEP_SCATTERS`` counts its launches a step.
* ``train``: optax's ``chain(clip_by_global_norm(5), adam(lr))`` as
  ``engine/optimizers.GroupOptimizers`` with one group of every parameter
  and ``max_norm`` 5, on a numpy ``Generator`` seeded from ``seed``; the
  parameters change in place.

The checkpoint is a flat ``.npz``, as the JAX package's ``save_params`` /
``load_params`` write it (``utils/param_tree``, imported here under the
JAX module's names). ``models/vonet.VONet.load_tree`` and ``VONet.tree``
convert its tree to and from the module, so either package loads the
other's file.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.vonet import fp32_convolutions
from ..ops.correlation import bilinear_sample, extract_patches, patch_correlation_chunked
from ..utils.param_tree import load_params, save_params  # noqa: F401  (the JAX module's checkpoint functions)
from .optimizers import GroupOptimizers, OptimizerConfig

BATCH_KEYS = ("images", "centers", "target", "cur0", "valid")


# ---------------------------------------------------------------- training
def make_batch(ds, rng: np.random.Generator, m: int = 64, max_gap: int = 3, noise_px: float = 3.0):
    """One training example from a synthetic RGB-D pair: numpy arrays
    ``images`` [2, 3, H, W], ``centers`` [m, 2] (frame i at 1/4
    resolution), ``target`` [m, 2] (their true 1/4-resolution coordinates
    in frame j), ``cur0`` [m, 2] (the noisy start) and ``valid`` [m]."""
    n = len(ds)
    i = int(rng.integers(0, n))
    j = int(np.clip(i + int(rng.choice([-3, -2, -1, 1, 2, 3][:2 * max_gap])), 0, n - 1))
    if j == i:
        j = min(i + 1, n - 1)
    _, rgb_i, depth_i, c2w_i = ds[i]
    _, rgb_j, depth_j, c2w_j = ds[j]
    H, W = depth_i.shape
    cam = ds.get_camera()
    h4, w4 = H // 4, W // 4

    x4 = rng.integers(1, w4 - 1, m).astype(np.float32)
    y4 = rng.integers(1, h4 - 1, m).astype(np.float32)
    uf = (4.0 * x4 + 2.0).astype(np.int64).clip(0, W - 1)
    vf = (4.0 * y4 + 2.0).astype(np.int64).clip(0, H - 1)
    z = depth_i[vf, uf]
    # the dataset's camera convention: dirs = [(u - cx) / fx, -(v - cy) / fy, -1]
    dirs = np.stack([(uf - cam.cx) / cam.fx, -(vf - cam.cy) / cam.fy, -np.ones_like(z)], -1)
    pts = c2w_i[:3, 3] + (dirs @ c2w_i[:3, :3].T) * z[:, None]
    w2c_j = np.linalg.inv(np.asarray(c2w_j, np.float64))
    pc = pts @ w2c_j[:3, :3].T + w2c_j[:3, 3]
    zj = -pc[:, 2]
    uj = cam.cx + cam.fx * pc[:, 0] / np.maximum(zj, 1e-6)
    vj = cam.cy - cam.fy * pc[:, 1] / np.maximum(zj, 1e-6)
    tx4 = (uj - 2.0) / 4.0
    ty4 = (vj - 2.0) / 4.0
    # valid: in bounds, in front, not occluded (depth consistency)
    inb = (zj > 0.05) & (uj >= 2) & (uj < W - 2) & (vj >= 2) & (vj < H - 2) & (z > 0)
    uji = np.clip(uj.astype(np.int64), 0, W - 1)
    vji = np.clip(vj.astype(np.int64), 0, H - 1)
    unocc = np.abs(depth_j[vji, uji] - zj) < 0.05 + 0.05 * zj
    valid = inb & unocc

    imgs = np.stack([np.ascontiguousarray(rgb_i.transpose(2, 0, 1), np.float32),
                     np.ascontiguousarray(rgb_j.transpose(2, 0, 1), np.float32)])
    target = np.stack([tx4, ty4], -1).astype(np.float32)
    cur0 = target + rng.normal(0, noise_px, (m, 2)).astype(np.float32)
    return {"images": imgs, "centers": np.stack([x4, y4], -1).astype(np.float32), "target": target,
            "cur0": cur0, "valid": valid.astype(np.float32)}


def upload_batch(batch: Dict[str, np.ndarray], device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A ``make_batch`` batch as tensors on ``device``."""
    return {k: torch.as_tensor(batch[k]).to(device=device, dtype=dtype) for k in BATCH_KEYS}


def _grid(p: int, like: torch.Tensor) -> torch.Tensor:
    """[p, p, 2] (x, y) offsets of a patch's pixels from its centre."""
    d = torch.arange(p, dtype=like.dtype, device=like.device) - p // 2
    gy, gx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([gx, gy], -1)


def recurrent_steps(model, images: torch.Tensor, centers: torch.Tensor, cur0: torch.Tensor, n_rec: int,
                    chunk: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The update operator's ``n_rec`` steps on one pair, patches of frame
    0 at ``centers`` correlated with frame 1 around the estimate, which
    starts at ``cur0`` and moves by each step's ``delta`` (detached): yields
    (the estimate the step saw, delta [m, 2], weight [m, 2])."""
    fmap_i, imap_i = model.extract_features(images[0])
    fmap_j, _ = model.extract_features(images[1])
    gmap = extract_patches(fmap_i, centers, p=model.P)  # [m, 128, P, P]
    ctx = bilinear_sample(imap_i, centers)  # [m, DIM]
    m, dev = centers.shape[0], centers.device
    fring, fring2 = fmap_j[None], F.avg_pool2d(fmap_j[None], 4, 4)
    jj = torch.zeros(m, dtype=torch.int32, device=dev)
    seg_kk = torch.arange(m, dtype=torch.int32, device=dev)
    none = torch.full((m,), -1, dtype=torch.int32, device=dev)
    mask = torch.ones(m, dtype=torch.bool, device=dev)
    grid = _grid(model.P, centers)
    net = torch.zeros((m, model.DIM), dtype=ctx.dtype, device=dev)
    cur = cur0
    for _ in range(n_rec):
        coords = cur[:, None, None, :] + grid
        c1 = patch_correlation_chunked(fring, gmap, coords, jj, radius=3, chunk=chunk)
        c2 = patch_correlation_chunked(fring2, gmap, coords / 4.0, jj, radius=3, chunk=chunk)
        corr = torch.stack([c1, c2], -1).reshape(m, -1)
        net, delta, weight = model.update(net, ctx, corr, seg_kk, jj, none, none, mask, num_segments=m + 1)
        yield cur, delta, weight
        cur = (cur + delta).detach()


def loss_fn(model, images, centers, target, cur0, valid, n_rec: int = 2, chunk: int = 64) -> torch.Tensor:
    """The supervised delta / weight loss over ``n_rec`` recurrent steps."""
    total = 0.0
    for cur, delta, weight in recurrent_steps(model, images, centers, cur0, n_rec, chunk):
        # the error clipped to the correlation window, so that far targets
        # do not dominate (the operator sees +-(3 + 1) px)
        err = torch.clamp(target - cur, -4.0, 4.0)
        total = total + torch.sum(torch.abs(delta - err) * valid[:, None]) / (torch.sum(valid) + 1e-6)
        # the weight predicts validity, in both channels
        w = torch.clamp(weight, 1e-5, 1 - 1e-5)
        v = valid[:, None]
        total = total + 0.05 * torch.mean(-(v * torch.log(w) + (1 - v) * torch.log(1 - w)))
    return total / n_rec


def train_step_scatters(m: int, n_rec: int = 2, chunk: int = 64) -> int:
    """K4 launches of one training step (``value_and_grad``) on the card:
    in the forward, each step's two SoftAggs sum twice (``segment_sum``);
    in the backward, each SoftAgg's two ``segment_gather``s, each
    correlation chunk on each of the two levels, the patch sampler and the
    context sample (``table_lookup``: one gather each) take their table
    gradient through K4."""
    softagg = 2 * 2  # two SoftAggs, two sums (forward) or two gathers (backward) each
    return n_rec * (softagg + softagg + 2 * math.ceil(m / chunk)) + 2


def value_and_grad(model, params: List[torch.Tensor], batch: Dict[str, torch.Tensor], n_rec: int = 2,
                   chunk: int = 64) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, d loss / d ``params``) on an uploaded batch, with cuDNN's
    convolutions in full float32 in the forward and the backward.
    ``params`` (the model's, which it creates without gradients) take
    gradients for the call only."""
    for p in params:
        p.requires_grad_(True)
    try:
        with fp32_convolutions(), torch.enable_grad():
            loss = loss_fn(model, *(batch[k] for k in BATCH_KEYS), n_rec=n_rec, chunk=chunk)
            grads = torch.autograd.grad(loss, params)
    finally:
        for p in params:
            p.requires_grad_(False)
    return loss.detach(), list(grads)


def train(model, ds, device, n_iters: int = 400, lr: float = 2e-4, m: int = 64, seed: int = 0,
          noise_px: float = 3.0, log_every: int = 50, chunk: int = 64) -> Tuple[Any, List[float]]:
    """Adam on every parameter of ``model`` (a ``VONet``, moved to
    ``device`` and trained in place) with the global gradient norm clipped
    at 5, one ``make_batch`` batch an iteration; returns (model, losses)."""
    rng = np.random.default_rng(seed)
    model.to(device)
    params = list(model.parameters())
    opt = GroupOptimizers({"vonet": OptimizerConfig(lr=lr, max_norm=5.0)})
    state = opt.init({"vonet": params})
    losses = []
    for it in range(n_iters):
        batch = upload_batch(make_batch(ds, rng, m=m, noise_px=noise_px), device, params[0].dtype)
        loss, grads = value_and_grad(model, params, batch, chunk=chunk)
        opt.update({"vonet": grads}, state, {"vonet": params})
        losses.append(loss)
        if log_every and it % log_every == 0:
            print(f"[dpvo-train] iter {it}: loss {float(loss):.4f}", flush=True)
    return model, torch.stack(losses).cpu().tolist() if losses else []
