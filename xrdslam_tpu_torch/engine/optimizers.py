"""Per-group Adam, as plain functions on tensors, matching optax exactly.

Counterpart of ``xrdslam_tpu/engine/optimizers.py``. Each named group of
tensors gets its own Adam with per-group lr/eps/betas/weight_decay, and
the transformations run in optax's order:

1. ``max_norm``: clip the group's gradients to that global norm;
2. Adam scaling, with eps outside the square root and the step count
   starting at 1;
3. weight decay *added after* the Adam scaling (decoupled, AdamW-style;
   ``torch.optim.Adam(weight_decay=...)`` would add it to the gradient);
4. times ``-lr``, or ``-schedule(step)`` with the step counted from 0.

``accum_step=N`` sums gradients over calls; only every Nth call applies the
steps above to the sum (and advances Adam's count and the schedule) and
resets it. Parameters are updated in place.

Where a group's Adam step count lives is chosen at its init:

* on the host (the default): ``count`` and ``calls`` are Python ints, and
  the bias corrections, the schedule and the ``accum_step`` branch are
  formed on the host. A replayed CUDA graph would replay them as the
  constants of its capture, so only a group whose state restarts at every
  call may keep them there: the tracking pose groups and Co-SLAM's mapping
  pose groups, re-initialised by each call, whose n-th step within a call
  is the same step in every call.
* on the device (``device_count``): ``count`` and ``calls`` are int64
  tensors on the parameters' device, updated in place inside the step,
  with the bias corrections formed from them there and the
  ``accum_step`` branch taken by ``torch.where`` (optax's
  ``ScaleByAdamState.count`` as an array). A group whose state persists
  across calls needs this (Co-SLAM's map, across mapping calls). Such a
  group takes no schedule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..configs.base import PrintableConfig

ScheduleFn = Callable[[int], float]  # step -> absolute lr


@dataclass
class OptimizerConfig(PrintableConfig):
    """Adam optimizer config."""

    lr: float = 5e-4
    eps: float = 1e-8
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    max_norm: Optional[float] = None
    accum_step: Optional[int] = None


@dataclass
class AdamOptimizerConfig(OptimizerConfig):
    """Alias kept for config-surface parity with the reference."""


def _group_init(params: List[torch.Tensor], accum: bool, on_device: bool) -> Dict[str, object]:
    def zero():
        return torch.zeros((), dtype=torch.int64, device=params[0].device) if on_device else 0

    state: Dict[str, object] = {
        "mu": [torch.zeros_like(p) for p in params],
        "nu": [torch.zeros_like(p) for p in params],
        "count": zero(),  # Adam steps taken (optax ScaleByAdamState.count)
    }
    if accum:
        state["acc"] = [torch.zeros_like(p) for p in params]
        state["calls"] = zero()
    return state


def _clip(cfg: OptimizerConfig, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    if cfg.max_norm is None:
        return grads
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < cfg.max_norm
    return [torch.where(keep, g, (g / g_norm) * cfg.max_norm) for g in grads]


def _adam(cfg: OptimizerConfig, c1, c2, p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
          nu: torch.Tensor) -> torch.Tensor:
    """Moments updated in place; returns the step to add to ``p`` (times -lr)."""
    b1, b2 = cfg.betas
    mu.mul_(b1).add_(g, alpha=1.0 - b1)
    nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
    upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
    if cfg.weight_decay:
        upd = upd + cfg.weight_decay * p
    return upd


@torch.no_grad()
def _group_step(cfg: OptimizerConfig, schedule: Optional[ScheduleFn], state: Dict[str, object],
                params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
    if isinstance(state["count"], torch.Tensor):
        if schedule is not None:
            raise ValueError("a group whose step count is on the device takes no schedule")
        _device_group_step(cfg, state, params, grads)
        return
    if "acc" in state:
        for a, g in zip(state["acc"], grads):
            a.add_(g)
        state["calls"] += 1
        if state["calls"] % cfg.accum_step != 0:
            return
        grads = [a.clone() for a in state["acc"]]
        for a in state["acc"]:
            a.zero_()
    grads = _clip(cfg, grads)
    # the schedule sees the count before this step (optax scale_by_schedule)
    lr = schedule(state["count"]) if schedule is not None else cfg.lr
    state["count"] += 1
    b1, b2 = cfg.betas
    c1 = 1.0 - b1 ** state["count"]
    c2 = 1.0 - b2 ** state["count"]
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        p.add_(_adam(cfg, c1, c2, p, g, mu, nu), alpha=-lr)


def _device_group_step(cfg: OptimizerConfig, state: Dict[str, object], params: List[torch.Tensor],
                       grads: List[torch.Tensor]) -> None:
    """``_group_step`` with the count on the device: no host value depends
    on the step, so a captured step replays correctly."""
    apply = None
    if "acc" in state:
        for a, g in zip(state["acc"], grads):
            a.add_(g)
        state["calls"].add_(1)
        apply = state["calls"] % cfg.accum_step == 0
        grads = [a.clone() for a in state["acc"]]
        for a in state["acc"]:
            a.copy_(torch.where(apply, torch.zeros_like(a), a))
    grads = _clip(cfg, grads)
    state["count"].add_(1 if apply is None else apply.to(torch.int64))
    # float64, as the host computes them; each is read as float32 by the
    # division, as the host's Python float is
    k = state["count"].to(torch.float64)
    b1, b2 = cfg.betas
    c1 = 1.0 - torch.pow(b1, k)
    c2 = 1.0 - torch.pow(b2, k)
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        if apply is None:
            p.add_(_adam(cfg, c1, c2, p, g, mu, nu), alpha=-cfg.lr)
            continue
        # until the first applied call the count is 0 and the step is
        # 0/0; torch.where keeps p, mu and nu wherever the call does not apply
        mu1, nu1 = mu.clone(), nu.clone()
        upd = _adam(cfg, c1, c2, p, g, mu1, nu1)
        mu.copy_(torch.where(apply, mu1, mu))
        nu.copy_(torch.where(apply, nu1, nu))
        p.copy_(torch.where(apply, p.add(upd, alpha=-cfg.lr), p))


class GroupOptimizers:
    """A set of per-group optimizers over ``{group: [tensors]}`` dicts."""

    def __init__(self, configs: Dict[str, OptimizerConfig],
                 schedules: Optional[Dict[str, ScheduleFn]] = None, device_count: Iterable[str] = ()) -> None:
        self.configs = configs
        self.schedules = schedules or {}
        self.device_count = frozenset(device_count)  # groups whose count init puts on the device

    def init(self, params: Dict[str, List[torch.Tensor]]) -> Dict[str, Dict[str, object]]:
        return {name: self.init_group(name, ps) for name, ps in params.items()}

    def init_group(self, name: str, params: List[torch.Tensor]) -> Dict[str, object]:
        cfg = self.configs[name]
        return _group_init(params, cfg.accum_step is not None and cfg.accum_step > 1, name in self.device_count)

    def update(self, grads: Dict[str, List[torch.Tensor]], state: Dict[str, Dict[str, object]],
               params: Dict[str, List[torch.Tensor]]) -> None:
        """One step of every group in ``params``; params and state change in place."""
        for name, ps in params.items():
            _group_step(self.configs[name], self.schedules.get(name), state[name], ps, grads[name])
