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

On the host-count path below, a group's tensors of at most
``FOREACH_MAX_NUMEL`` entries step together with multi-tensor
(``torch._foreach_*``) kernels, larger ones with plain kernels each (the
multi-tensor kernels run one block per 65,536 entries: too few for a
table); the clip takes the small tensors' entries as one vector and each
large tensor alone (``pieces``). So a step is a few launches whatever the
group's number of small tensors, and copies no table.

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
FOREACH_MAX_NUMEL = 65536  # one block of the multi-tensor kernels


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


def pieces(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors' entries as flat vectors: the small ones' (at most
    ``FOREACH_MAX_NUMEL`` entries) in one, a copy unless there is one, then
    each large one's, a view. An operation on a group's gradients so takes a
    few kernels whatever its number of small tensors, and copies no table."""
    small = [t.reshape(-1) for t in tensors if t.numel() <= FOREACH_MAX_NUMEL]
    large = [t.reshape(-1) for t in tensors if t.numel() > FOREACH_MAX_NUMEL]
    return ([small[0] if len(small) == 1 else torch.cat(small)] if small else []) + large


def unpieces(parts: List[torch.Tensor], like: List[torch.Tensor]) -> List[torch.Tensor]:
    """``pieces``' inverse: views of ``parts`` in the shapes and order of ``like``."""
    small = [t.numel() for t in like if t.numel() <= FOREACH_MAX_NUMEL]
    views = iter(parts[0].split(small) if small else ())
    large = iter(parts[1:] if small else parts)
    return [next(views if t.numel() <= FOREACH_MAX_NUMEL else large).view(t.shape) for t in like]


def _clip(cfg: OptimizerConfig, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    if cfg.max_norm is None:
        return grads
    parts = pieces(grads)
    sq = [torch.sum(p * p) for p in parts]
    g_norm = torch.sqrt(sum(sq[1:], sq[0]))
    keep = g_norm < cfg.max_norm
    return unpieces([torch.where(keep, p, (p / g_norm) * cfg.max_norm) for p in parts], grads)


def _each(name: str) -> Callable:
    """``torch._foreach_<name>`` with plain kernels: the tensor method on each
    tensor of the list, with the other operand's matching tensor or the scalar."""
    def op(xs, other=None, **kw):
        others = other if isinstance(other, list) else [other] * len(xs)
        return [getattr(x, name)(*(() if other is None else (o,)), **kw) for x, o in zip(xs, others)]
    return op


_MULTI_OPS = {name: getattr(torch, "_foreach_" + name) for name in ("mul_", "add_", "mul", "div", "sqrt")}
_PLAIN_OPS = {name: _each(name) for name in _MULTI_OPS}


def _adam(cfg: OptimizerConfig, c1, c2, ps: List[torch.Tensor], gs: List[torch.Tensor], mus: List[torch.Tensor],
          nus: List[torch.Tensor], multi: bool) -> List[torch.Tensor]:
    """Adam on lists of tensors: the moments updated in place; returns the
    steps to add to ``ps`` (times -lr). With ``multi`` each operation is one
    multi-tensor kernel over the lists (a group's small tensors), else plain
    kernels on each tensor (a large one, or a step whose count is on the
    device)."""
    op = _MULTI_OPS if multi else _PLAIN_OPS
    b1, b2 = cfg.betas
    op["mul_"](mus, b1)
    op["add_"](mus, gs, alpha=1.0 - b1)
    op["mul_"](nus, b2)
    op["add_"](nus, op["mul"](gs, gs), alpha=1.0 - b2)
    denom = op["sqrt"](op["div"](nus, c2))
    op["add_"](denom, cfg.eps)
    upd = op["div"](op["div"](mus, c1), denom)
    if cfg.weight_decay:
        op["add_"](upd, ps, alpha=cfg.weight_decay)
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
        torch._foreach_add_(state["acc"], grads)
        state["calls"] += 1
        if state["calls"] % cfg.accum_step != 0:
            return
        grads = torch._foreach_mul(state["acc"], 1.0)
        torch._foreach_zero_(state["acc"])
    grads = _clip(cfg, grads)
    # the schedule sees the count before this step (optax scale_by_schedule)
    lr = schedule(state["count"]) if schedule is not None else cfg.lr
    state["count"] += 1
    b1, b2 = cfg.betas
    c1 = 1.0 - b1 ** state["count"]
    c2 = 1.0 - b2 ** state["count"]
    small = [i for i, p in enumerate(params) if p.numel() <= FOREACH_MAX_NUMEL]
    batches = [(small, True)] if small else []
    batches += [([i], False) for i, p in enumerate(params) if p.numel() > FOREACH_MAX_NUMEL]
    for idx, multi in batches:
        ps = [params[i] for i in idx]
        upd = _adam(cfg, c1, c2, ps, [grads[i] for i in idx], [state["mu"][i] for i in idx],
                    [state["nu"][i] for i in idx], multi)
        (_MULTI_OPS if multi else _PLAIN_OPS)["add_"](ps, upd, alpha=-lr)


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
            p.add_(_adam(cfg, c1, c2, [p], [g], [mu], [nu], False)[0], alpha=-cfg.lr)
            continue
        # until the first applied call the count is 0 and the step is
        # 0/0; torch.where keeps p, mu and nu wherever the call does not apply
        mu1, nu1 = mu.clone(), nu.clone()
        (upd,) = _adam(cfg, c1, c2, [p], [g], [mu1], [nu1], False)
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
