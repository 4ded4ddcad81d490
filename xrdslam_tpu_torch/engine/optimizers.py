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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

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


def _group_init(params: List[torch.Tensor], accum: bool) -> Dict[str, object]:
    state: Dict[str, object] = {
        "mu": [torch.zeros_like(p) for p in params],
        "nu": [torch.zeros_like(p) for p in params],
        "count": 0,  # Adam steps taken (optax ScaleByAdamState.count)
    }
    if accum:
        state["acc"] = [torch.zeros_like(p) for p in params]
        state["calls"] = 0
    return state


@torch.no_grad()
def _group_step(cfg: OptimizerConfig, schedule: Optional[ScheduleFn], state: Dict[str, object],
                params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
    if "acc" in state:
        for a, g in zip(state["acc"], grads):
            a.add_(g)
        state["calls"] += 1
        if state["calls"] % cfg.accum_step != 0:
            return
        grads = [a.clone() for a in state["acc"]]
        for a in state["acc"]:
            a.zero_()
    if cfg.max_norm is not None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < cfg.max_norm
        grads = [torch.where(keep, g, (g / g_norm) * cfg.max_norm) for g in grads]
    # the schedule sees the count before this step (optax scale_by_schedule)
    lr = schedule(state["count"]) if schedule is not None else cfg.lr
    state["count"] += 1
    b1, b2 = cfg.betas
    c1 = 1.0 - b1 ** state["count"]
    c2 = 1.0 - b2 ** state["count"]
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
        upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p
        p.add_(upd, alpha=-lr)


class GroupOptimizers:
    """A set of per-group optimizers over ``{group: [tensors]}`` dicts."""

    def __init__(self, configs: Dict[str, OptimizerConfig],
                 schedules: Optional[Dict[str, ScheduleFn]] = None) -> None:
        self.configs = configs
        self.schedules = schedules or {}

    def init(self, params: Dict[str, List[torch.Tensor]]) -> Dict[str, Dict[str, object]]:
        return {name: self.init_group(name, ps) for name, ps in params.items()}

    def init_group(self, name: str, params: List[torch.Tensor]) -> Dict[str, object]:
        cfg = self.configs[name]
        return _group_init(params, cfg.accum_step is not None and cfg.accum_step > 1)

    def update(self, grads: Dict[str, List[torch.Tensor]], state: Dict[str, Dict[str, object]],
               params: Dict[str, List[torch.Tensor]]) -> None:
        """One step of every group in ``params``; params and state change in place."""
        for name, ps in params.items():
            _group_step(self.configs[name], self.schedules.get(name), state[name], ps, grads[name])
