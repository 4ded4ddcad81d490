"""DPVO's training in the port against the JAX package, and K4 under its gradients.

The same batches, drawn by each package's ``make_batch`` from one seed out
of a small numpy dataset (4 frames of the port's synthetic office at
48x64), go to the JAX functions and their ports, with the JAX package
handed the port's initial weights (``VONet.tree``):

* ``make_batch`` is bit-equal to JAX's;
* ``loss_fn``'s value and every gradient leaf (``value_and_grad``)
  against ``jax.value_and_grad(loss_fn)``, both in float64: in float32 the
  encoders' instance norms leave the biases before them gradients of
  rounding noise only (mathematically zero), 2% of the floor below. Loss
  to 1e-9 relative; each leaf to 1e-6 of the larger of its largest entry
  and 1e-5 of the largest entry of any leaf (the zero-gradient biases
  before the instance norms and in front of the per-channel softmaxes);
* three ``train`` steps from the same weights on the same batches, in
  float64: the losses to 1e-9 relative, every parameter to 1e-9 (three
  Adam steps of 2e-4 each);
* a tree the port trained and saved loads in both packages;
* ``segment_sum`` and ``segment_gather`` pass ``gradcheck`` in float64,
  and a step's K4 calls (the twins' on the CPU) equal
  ``train_step_scatters``.

The ``cuda``-marked tests run on the card (this file imports JAX only
inside its fixtures): ``segment_sum`` launches K4 and has a gradient, and a
training step's gradients with the kernels equal the same step's with the
plain twins on the card.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.common.synthetic import SyntheticDataset  # noqa: E402
from xrdslam_tpu_torch.engine import dpvo_train as T  # noqa: E402
from xrdslam_tpu_torch.utils.param_tree import flatten_tree  # noqa: E402
from xrdslam_tpu_torch.models.vonet import VONet, VONetConfig, state_key  # noqa: E402
from xrdslam_tpu_torch.ops import scatter  # noqa: E402

M, CHUNK = 8, 8


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class Frames:
    """A numpy dataset of the port's synthetic office, rendered once:
    ``len``, ``ds[i]`` = (i, rgb, depth, c2w) and ``get_camera``, which both
    packages' ``make_batch`` read."""

    def __init__(self, n_frames=4, height=48, width=64):
        ds = SyntheticDataset(n_frames=n_frames, height=height, width=width, scene="office")
        self.frames = [ds[i] for i in range(n_frames)]
        self.camera = ds.get_camera()

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]

    def get_camera(self):
        return self.camera


@pytest.fixture(scope="module")
def frames():
    return Frames()


def _close(got, want, what, rel, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max()), floor, 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"


def _jax_tree(tree, dtype):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def test_make_batch_is_bit_equal(frames):
    pytest.importorskip("jax")
    from xrdslam_tpu.engine import dpvo_train as JT

    for seed in (0, 1, 2):
        for m, noise in ((M, 3.0), (32, 2.0)):
            got = T.make_batch(frames, np.random.default_rng(seed), m=m, noise_px=noise)
            want = JT.make_batch(frames, np.random.default_rng(seed), m=m, noise_px=noise)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """``jax.value_and_grad(loss_fn)`` of the JAX package, compiled once;
    call it inside ``jax.enable_x64``."""
    jax = pytest.importorskip("jax")
    from xrdslam_tpu.engine import dpvo_train as JT

    return jax.jit(jax.value_and_grad(JT.loss_fn), static_argnames=("n_rec", "chunk"))


def _jax_batch(batch):
    import jax.numpy as jnp

    return [jnp.asarray(batch[k], jnp.float64) for k in T.BATCH_KEYS]


@pytest.fixture(scope="module")
def grads_case(frames, jax_value_and_grad):
    """A batch, the port's initial float64 VONet and JAX's loss and
    gradients on the same weights (float64, ``jax.enable_x64``)."""
    import jax
    import jax.numpy as jnp

    net = VONet(VONetConfig(), seed=5).double()
    batch = T.make_batch(frames, np.random.default_rng(7), m=M)
    with jax.enable_x64(True):
        loss, grads = jax_value_and_grad(_jax_tree(net.tree(), jnp.float64), *_jax_batch(batch), chunk=CHUNK)
        want = float(loss), flatten_tree(jax.tree_util.tree_map(np.asarray, grads))
    return net, batch, want


def test_loss_and_every_gradient_match_jax(grads_case):
    net, batch, (want_loss, want_grads) = grads_case
    named = dict(net.named_parameters())
    loss, grads = T.value_and_grad(net, list(named.values()), T.upload_batch(batch, "cpu", torch.float64),
                                   chunk=CHUNK)
    _close(float(loss), want_loss, "loss", 1e-9)
    got = dict(zip(named, grads))
    assert sorted(got) == sorted(state_key(k) for k in want_grads)
    floor = 1e-5 * max(float(np.abs(g).max()) for g in want_grads.values())
    for k, g in want_grads.items():
        _close(got[state_key(k)].numpy(), g, k, 1e-6, floor)
    # the update operator and both encoders learn
    for part in ("fnet.", "inet.", "update."):
        assert max(float(g.abs().max()) for n, g in got.items() if n.startswith(part)) > 1e-4, part
    assert all(not p.requires_grad for p in net.parameters())  # value_and_grad restores inference


@pytest.fixture(scope="module")
def trained(frames, jax_value_and_grad):
    """Three ``train`` steps of both packages from the same float64 weights
    and seed: (port net, port losses, JAX tree, JAX losses). The JAX side
    is its ``train``'s loop (``make_batch``, ``value_and_grad(loss_fn)``,
    optax's ``chain(clip_by_global_norm(5), adam(lr))``) in float64: its
    ``train`` itself hands the convolutions the batch in float32, which
    float64 weights do not take."""
    import jax
    import jax.numpy as jnp
    import optax

    from xrdslam_tpu.engine import dpvo_train as JT

    net = VONet(VONetConfig(), seed=6).double()
    rng = np.random.default_rng(3)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(2e-4))

    @jax.jit
    def apply(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    with jax.enable_x64(True):
        params = _jax_tree(net.tree(), jnp.float64)
        opt_state = tx.init(params)
        jlosses = []
        for _ in range(3):
            loss, g = jax_value_and_grad(params, *_jax_batch(JT.make_batch(frames, rng, m=M)), chunk=CHUNK)
            params, opt_state = apply(g, opt_state, params)
            jlosses.append(float(loss))
        jtree = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    net, losses = T.train(net, frames, "cpu", n_iters=3, lr=2e-4, m=M, seed=3, log_every=0, chunk=CHUNK)
    return net, losses, jtree, jlosses


def test_three_train_steps_match_jax(trained):
    net, losses, jtree, jlosses = trained
    assert len(losses) == len(jlosses) == 3
    _close(losses, jlosses, "losses", 1e-9)
    got = flatten_tree(net.tree())
    assert sorted(got) == sorted(jtree)
    for k, want in jtree.items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-9, err_msg=k)
    moved = sum(int(np.any(got[k] != v)) for k, v in flatten_tree(VONet(VONetConfig(), seed=6).tree()).items())
    assert moved > 0.9 * len(got)
    assert all(not p.requires_grad for p in net.parameters())


def test_a_port_trained_tree_loads_in_both_packages(trained, tmp_path):
    pytest.importorskip("jax")
    import jax

    from xrdslam_tpu.engine.dpvo_train import load_params as jload
    from xrdslam_tpu.models.vonet import VONet as JVONet, VONetConfig as JVONetConfig

    net = copy.deepcopy(trained[0]).float()  # as the card trains it
    path = str(tmp_path / "trained.npz")
    T.save_params(path, net.tree())
    want = flatten_tree(net.tree())
    for what, tree in (("jax load_params", jload(path)), ("jax VONet", JVONet(JVONetConfig(pretrained_path=path)).params),
                       ("port load_params", T.load_params(path)),
                       ("port VONet", VONet(VONetConfig(pretrained_path=path)).tree())):
        flat = flatten_tree(jax.tree_util.tree_map(np.asarray, tree))
        assert sorted(flat) == sorted(want), what
        for k, v in want.items():
            np.testing.assert_array_equal(flat[k], v, err_msg=f"{what}: {k}")
    assert VONet(VONetConfig(pretrained_path=path)).loaded_from == path


@pytest.mark.parametrize("num_segments", [1, 7])
def test_segment_sum_and_gather_gradcheck(num_segments):
    rng = np.random.default_rng(num_segments)
    seg = torch.from_numpy(rng.integers(0, num_segments, 11).astype(np.int32))
    order = scatter.scatter_order(seg, num_segments)
    x = torch.from_numpy(rng.normal(size=(11, 3))).requires_grad_(True)
    table = torch.from_numpy(rng.normal(size=(num_segments, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: scatter.segment_sum(order, v), (x,))
    assert torch.autograd.gradcheck(lambda t: scatter.segment_gather(t, order), (table,))
    want = torch.zeros((num_segments, 3), dtype=x.dtype).index_add_(0, seg.long(), x)
    torch.testing.assert_close(scatter.segment_sum(order, x), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("m,chunk", [(M, CHUNK), (12, 8)])
def test_a_steps_scatters_are_the_schedule(frames, monkeypatch, m, chunk):
    """The K4 calls of a step (the twins' on the CPU: ``scatter_add`` and
    ``scatter_add_ordered``, each a K4 launch on the card) equal
    ``train_step_scatters``; 12 edges in chunks of 8 give a shorter last
    chunk."""
    calls = []
    for name in ("scatter_add", "scatter_add_ordered"):
        shipped = getattr(scatter, name)
        monkeypatch.setattr(scatter, name, lambda *a, _f=shipped, **k: calls.append(1) or _f(*a, **k))
    net = VONet(VONetConfig())
    batch = T.upload_batch(T.make_batch(frames, np.random.default_rng(0), m=m), "cpu")
    T.value_and_grad(net, list(net.parameters()), batch, chunk=chunk)
    assert len(calls) == T.train_step_scatters(m, 2, chunk)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_segment_sum_launches_k4_and_has_a_gradient():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    rng = np.random.default_rng(0)
    seg = torch.from_numpy(rng.integers(0, 65, 64).astype(np.int32)).cuda()
    seg[:32] = 0  # one long segment, as SoftAgg's ij groups give it
    x = torch.from_numpy(rng.normal(size=(64, 384)).astype(np.float32)).cuda().requires_grad_(True)
    up = torch.from_numpy(rng.normal(size=(65, 384)).astype(np.float32)).cuda()
    order = scatter.scatter_order(seg, 65)
    scatter.reset_launches()
    y = scatter.segment_sum(order, x)
    assert scatter.LAUNCHES["scatter_add"] == 1
    (g,) = torch.autograd.grad((y * up).sum(), x)
    torch.testing.assert_close(y, scatter.scatter_add_torch(seg, x.detach(), 65), rtol=0, atol=1e-4)
    torch.testing.assert_close(g, up[seg.long()], rtol=0, atol=0)
    t = up.clone().requires_grad_(True)
    (gt,) = torch.autograd.grad((scatter.segment_gather(t, order) * x.detach()).sum(), t)
    assert scatter.LAUNCHES["scatter_add"] == 2
    torch.testing.assert_close(gt, scatter.scatter_add_torch(seg, x.detach(), 65), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_train_step_gradients_match_the_twins(frames, monkeypatch):
    """One step's loss and gradients with K4 against the same step with
    every K4 call replaced by its plain twin, on the card (1e-4 of the
    larger of a leaf's largest entry and 1e-2 of the largest of any leaf:
    the twins sum in another order, and the biases before the encoders'
    instance norms, whose gradient is zero but for float32 rounding, carry
    ~1e-7 of the largest entry in either run); and K4's launches equal the
    schedule."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    net = VONet(VONetConfig()).cuda()
    params = list(net.parameters())
    batch = T.upload_batch(T.make_batch(frames, np.random.default_rng(0), m=64), "cuda")
    scatter.reset_launches()
    loss, grads = T.value_and_grad(net, params, batch, chunk=64)
    assert scatter.LAUNCHES["scatter_add"] == T.train_step_scatters(64, 2, 64)
    loss2, grads2 = T.value_and_grad(net, params, batch, chunk=64)
    monkeypatch.setattr(scatter, "scatter_add", scatter.scatter_add_torch)
    monkeypatch.setattr(scatter, "scatter_add_ordered", lambda order, g: scatter.scatter_add_sorted_torch(order, g))
    scatter.reset_launches()
    twin_loss, twin = T.value_and_grad(net, params, batch, chunk=64)
    assert scatter.LAUNCHES["scatter_add"] == 0
    _close(float(loss), float(twin_loss), "loss", 1e-5)
    assert float(loss) == float(loss2)
    floor = 1e-2 * max(float(g.abs().max()) for g in twin)
    for (name, _), g, g2, w in zip(net.named_parameters(), grads, grads2, twin):
        assert torch.equal(g, g2), name  # K4 sums in a fixed order
        _close(g.cpu().numpy(), w.cpu().numpy(), name, 1e-4, floor)
    assert max(float(g.abs().max()) for (n, _), g in zip(net.named_parameters(), grads)
               if n.startswith("update.agg_kk.f")) > 0  # SoftAgg's sums pass a gradient upstream
