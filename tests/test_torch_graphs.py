"""What a replayed step needs from the port: optimizer state on the device,
and ``engine/graphs.py``.

* A group whose Adam step count is on the device (``device_count``, the
  Co-SLAM map's) matches the JAX package's optax chain over three
  successive mapping-like calls of 10 steps, each call with a new
  ``GroupOptimizers`` on the same state, with ``max_norm``, weight decay
  and ``accum_step`` (1e-6, as ``test_torch_optimizers.py``).
* ``GraphReplay`` calls the function eagerly on CPU tensors and keeps no
  graph.
* On the card (``cuda`` marker), a function that syncs the host inside
  (``.item()``) makes the capture raise, and no graph is kept: nothing
  falls back to eager.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.engine import optimizers as topt  # noqa: E402
from xrdslam_tpu_torch.engine.graphs import GraphReplay, PendingFetch  # noqa: E402
from xrdslam_tpu_torch.ops import scatter  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SHAPES = [(4, 3), (5,)]
VARIANTS = {
    "accum": dict(lr=1e-2, betas=(0.9, 0.99), weight_decay=1e-6, max_norm=0.5, accum_step=3),
    "decay": dict(lr=1e-2, eps=1e-15, betas=(0.9, 0.99), weight_decay=1e-6, max_norm=2.0),
    "plain": dict(lr=1e-3),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_device_step_count_matches_optax(variant):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from xrdslam_tpu.engine import optimizers as jopt

    rng = np.random.default_rng(1)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jo = jopt.GroupOptimizers({"g": jopt.AdamOptimizerConfig(**VARIANTS[variant])})
    jp = {"g": [jnp.asarray(a) for a in p0]}
    js = jo.init(jp)
    tp = {"g": [torch.from_numpy(a.copy()) for a in p0]}
    cfg = {"g": topt.AdamOptimizerConfig(**VARIANTS[variant])}
    ts = topt.GroupOptimizers(cfg, device_count=["g"]).init(tp)
    assert isinstance(ts["g"]["count"], torch.Tensor)
    steps = 0
    for call in range(3):
        opt = topt.GroupOptimizers(cfg, device_count=["g"])  # a new optimizer per call, as map_step's
        for _ in range(10):
            scale = 5.0 if steps % 2 else 0.05  # large grads on some steps, so that max_norm clips
            grads = [(scale * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
            jp, js = jo.update({"g": [jnp.asarray(a) for a in grads]}, js, jp)
            opt.update({"g": [torch.from_numpy(a) for a in grads]}, ts, tp)
            steps += 1
            for a, b in zip(jp["g"], tp["g"]):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0,
                                           err_msg=f"{variant} call {call} step {steps}")
    applied = steps // 3 if variant == "accum" else steps
    assert int(ts["g"]["count"]) == applied
    if variant == "accum":
        assert int(ts["g"]["calls"]) == steps


def test_device_count_takes_no_schedule():
    p = {"g": [torch.zeros(2)]}
    opt = topt.GroupOptimizers({"g": topt.AdamOptimizerConfig()}, schedules={"g": lambda s: 1e-3},
                               device_count=["g"])
    st = opt.init(p)
    with pytest.raises(ValueError):
        opt.update({"g": [torch.ones(2)]}, st, p)


def test_graph_replay_calls_eagerly_on_cpu():
    graphs = GraphReplay()
    x = torch.arange(6, dtype=torch.float32)
    state = torch.zeros(6)
    scatter.reset_launches()

    def step(x):
        state.add_(x)
        return x * 2.0, state.sum()

    for k in range(3):
        y, s = graphs("key", step, [x])
        assert torch.equal(y, x * 2.0) and float(s) == 15.0 * (k + 1)
    assert not graphs.captures and not graphs.replays and graphs.pool_bytes() == 0
    t, = PendingFetch(x).wait()
    np.testing.assert_array_equal(t, x.numpy())


@pytest.mark.cuda
def test_cuda_capture_with_a_host_sync_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graphs = GraphReplay()
    x = torch.ones(4, device="cuda")

    def step(x):
        return (x * x.sum().item(),)

    with pytest.raises(RuntimeError):
        graphs("sync", step, [x])
    assert "sync" not in graphs.captures and not graphs.replays
