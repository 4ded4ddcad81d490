"""GroupOptimizers of the port against the optax chain of the JAX package:
per-group Adam with eps outside the sqrt, decoupled weight decay after the
Adam scaling, global-norm clipping, a per-step schedule counted from 0, and
accum_step (grads summed; applied and reset every Nth call)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from xrdslam_tpu.engine import optimizers as jopt  # noqa: E402
from xrdslam_tpu_torch.engine import optimizers as topt  # noqa: E402

SHAPES = {"accum": [(4, 3), (5,)], "decay": [(6, 2)], "plain": [(3,)]}


def _configs(mod):
    return {
        "accum": mod.AdamOptimizerConfig(lr=1e-2, betas=(0.9, 0.99), weight_decay=1e-6, max_norm=0.5, accum_step=5),
        "decay": mod.AdamOptimizerConfig(lr=1e-2, eps=1e-15, betas=(0.9, 0.99), weight_decay=1e-6, max_norm=2.0),
        "plain": mod.AdamOptimizerConfig(lr=1e-3),
    }


def test_group_optimizers_match_optax():
    rng = np.random.default_rng(0)
    p0 = {g: [rng.standard_normal(s).astype(np.float32) for s in shapes] for g, shapes in SHAPES.items()}
    # schedules evaluated at the step count from 0; under accumulation the
    # count advances only on the applied calls
    scheds = {"accum": lambda s: 2e-2 * 0.5 ** s, "decay": lambda s: 1e-2 * 0.8 ** s}
    jo = jopt.GroupOptimizers(_configs(jopt), schedules=scheds)
    to = topt.GroupOptimizers(_configs(topt), schedules=scheds)
    jp = {g: [jnp.asarray(a) for a in v] for g, v in p0.items()}
    tp = {g: [torch.from_numpy(a.copy()) for a in v] for g, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(12):
        # large grads on some steps so that max_norm clips
        scale = 5.0 if step % 2 else 0.05
        grads = {g: [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes] for g, shapes in SHAPES.items()}
        jp, js = jo.update({g: [jnp.asarray(a) for a in v] for g, v in grads.items()}, js, jp)
        to.update({g: [torch.from_numpy(a) for a in v] for g, v in grads.items()}, ts, tp)
        for g in SHAPES:
            for a, b in zip(jp[g], tp[g]):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0, err_msg=f"{g} step {step}")
    # the accumulating group applied twice (5th and 10th calls) and holds 2 calls of grads
    assert ts["accum"]["count"] == 2 and ts["accum"]["calls"] == 12
    assert ts["plain"]["count"] == 12


def test_accumulation_freezes_params_between_applies():
    cfg = topt.AdamOptimizerConfig(lr=0.1, accum_step=3)
    p = [torch.zeros(2)]
    opt = topt.GroupOptimizers({"g": cfg})
    st = opt.init({"g": p})
    for i in range(1, 7):
        before = p[0].clone()
        opt.update({"g": [torch.ones(2)]}, st, {"g": p})
        assert torch.equal(p[0], before) == (i % 3 != 0)
