"""The port's hash-grid encoder against the JAX package.

The CPU path of ``xrdslam_tpu_torch.ops.hashgrid_fast`` is its plain twin;
it is held against the JAX reference (``encodings.hashgrid_encode`` with
autodiff) and the JAX TPU kernels (``hashgrid_fast.hashgrid_encode_kern``,
run in Pallas interpret mode on the CPU). The position gradient follows the
TPU kernel: it is not zeroed outside [0,1]^3, so it is compared with
autodiff of the reference only for points inside the box.

The CUDA kernels are compared with the twin on the card (``cuda`` marker).
JAX is imported only by the fixtures that need it, so that on the card's
machine, which has no jax, those tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_hashgrid.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu_torch.ops import encodings as tenc  # noqa: E402
from xrdslam_tpu_torch.ops import hashgrid_fast as thf  # noqa: E402

N = 600
SPEC_ARGS = (6, 2, 10, 8, 100)  # 6 levels (dense and hashed), T = 2^10


@pytest.fixture(scope="module")
def jx():
    """The JAX package's encoders."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from xrdslam_tpu.ops import encodings, hashgrid_fast

    return SimpleNamespace(jax=jax, jnp=jnp, enc=encodings, hf=hashgrid_fast)


@pytest.fixture(scope="module")
def case(jx):
    rng = np.random.default_rng(0)
    jspec = jx.enc.hashgrid_spec(*SPEC_ARGS)
    tspec = tenc.hashgrid_spec(*SPEC_ARGS)
    table = rng.uniform(-1e-2, 1e-2, (jspec.n_levels, jspec.table_size, 2)).astype(np.float32)
    x = rng.uniform(-0.3, 1.3, (N, 3)).astype(np.float32)
    g = rng.standard_normal((N, jspec.out_dim)).astype(np.float32)
    inside = np.all((x >= 0.0) & (x <= 1.0), axis=1)
    assert 0 < inside.sum() < N
    return jspec, tspec, table, x, g, inside


@pytest.fixture(scope="module")
def jax_grads(jx, case):
    jspec, _, table, x, g, _ = case
    jnp = jx.jnp
    table, x = jnp.asarray(table), jnp.asarray(x)
    ref = jx.jax.grad(lambda t, xx: jnp.sum(jx.enc.hashgrid_encode(t, xx, jspec) * g), argnums=(0, 1))(table, x)
    kern = jx.jax.grad(lambda t, xx: jnp.sum(jx.hf.hashgrid_encode_kern(t, xx, jspec) * g), argnums=(0, 1))(table, x)
    return [np.asarray(a) for a in ref], [np.asarray(a) for a in kern]


@pytest.fixture(scope="module")
def twin_grads(case):
    _, tspec, table, x, g, _ = case
    dt, dx = thf.hashgrid_bwd(torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(g), tspec)
    return dt.numpy(), dx.numpy()


def test_spec_matches_jax(jx, case):
    jspec, tspec, *_ = case
    assert tuple(tspec) == tuple(jspec)
    office = tenc.hashgrid_spec(16, 2, 16, 16, 319)
    assert office.resolutions == jx.enc.hashgrid_spec(16, 2, 16, 16, 319).resolutions
    assert sum(office.dense) == 5


@pytest.mark.parametrize("oracle", ["reference", "tpu_kernel"])
def test_fwd_matches_jax(jx, case, oracle):
    jspec, tspec, table, x, _, _ = case
    fn = jx.enc.hashgrid_encode if oracle == "reference" else jx.hf.hashgrid_encode_kern
    want = np.asarray(fn(jx.jnp.asarray(table), jx.jnp.asarray(x), jspec))
    got = thf.hashgrid_fwd(torch.from_numpy(table), torch.from_numpy(x), tspec).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_dx_matches_tpu_kernel_everywhere(case, jax_grads, twin_grads):
    # the TPU kernel's dx is the gradient at the clamped point, also outside the box
    _, kern = jax_grads
    np.testing.assert_allclose(twin_grads[1], kern[1], atol=1e-5, rtol=0)


def test_dx_matches_reference_inside_the_box(case, jax_grads, twin_grads):
    *_, inside = case
    ref, _ = jax_grads
    np.testing.assert_allclose(twin_grads[1][inside], ref[1][inside], atol=1e-5, rtol=0)


def test_dtable_matches_reference_autodiff(jax_grads, twin_grads):
    ref, _ = jax_grads
    scale = np.abs(ref[0]).max()
    assert np.abs(twin_grads[0] - ref[0]).max() <= 1e-5 * scale


def test_dtable_matches_tpu_kernel(jax_grads, twin_grads):
    # the TPU kernel scatters through bf16 one-hot matmuls (~1e-3 relative)
    _, kern = jax_grads
    scale = np.abs(kern[0]).max()
    assert np.abs(twin_grads[0] - kern[0]).max() <= 5e-3 * scale


def test_reference_encode_matches_jax_autodiff(case, jax_grads):
    """The port's plain reference (autodiff through the clamp) is the JAX reference."""
    _, tspec, table, x, g, _ = case
    tt = torch.from_numpy(table).requires_grad_(True)
    xx = torch.from_numpy(x).requires_grad_(True)
    torch.sum(tenc.hashgrid_encode(tt, xx, tspec) * torch.from_numpy(g)).backward()
    ref, _ = jax_grads
    np.testing.assert_allclose(xx.grad.numpy(), ref[1], atol=1e-5, rtol=0)
    assert np.abs(tt.grad.numpy() - ref[0]).max() <= 1e-5 * np.abs(ref[0]).max()


def test_autograd_function_computes_only_needed_grads(case, twin_grads):
    _, tspec, table, x, g, _ = case
    tt = torch.from_numpy(table).requires_grad_(True)
    xx = torch.from_numpy(x).reshape(20, 30, 3).requires_grad_(True)
    out = thf.encode(tt, xx, tspec)
    assert out.shape == (20, 30, tspec.out_dim)
    torch.sum(out.reshape(N, -1) * torch.from_numpy(g)).backward()
    np.testing.assert_allclose(tt.grad.numpy(), twin_grads[0], atol=1e-7, rtol=0)
    np.testing.assert_allclose(xx.grad.reshape(N, 3).numpy(), twin_grads[1], atol=1e-6, rtol=0)
    # a detached table (tracking) gets no gradient; x still does
    xx.grad = None
    dx, = torch.autograd.grad(torch.sum(thf.encode(tt.detach(), xx, tspec).reshape(N, -1) * torch.from_numpy(g)), [xx])
    np.testing.assert_allclose(dx.reshape(N, 3).numpy(), twin_grads[1], atol=1e-6, rtol=0)


def test_wrappers_reject_other_devices(case):
    _, tspec, table, x, g, _ = case
    meta = torch.empty((N, 3), device="meta")
    with pytest.raises(ValueError):
        thf.hashgrid_fwd(torch.empty(table.shape, device="meta"), meta, tspec)
    with pytest.raises(ValueError):
        thf.hashgrid_bwd(torch.empty(table.shape, device="meta"), meta, torch.empty(g.shape, device="meta"), tspec)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 44_032])
def test_cuda_kernels_match_twin(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    spec = tenc.hashgrid_spec(16, 2, 16, 16, 319)
    rng = np.random.default_rng(n)
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32), device=dev)
    g = torch.as_tensor(rng.standard_normal((n, spec.out_dim)).astype(np.float32), device=dev)
    table = torch.as_tensor(rng.standard_normal((16, spec.table_size, 2)).astype(np.float32), device=dev)
    before = dict(thf.LAUNCHES)
    out = thf.hashgrid_fwd(table, x, spec)
    dt, dx = thf.hashgrid_bwd(table, x, g, spec)
    torch.cuda.synchronize()
    assert thf.LAUNCHES["hashgrid_fwd"] == before["hashgrid_fwd"] + 1
    assert thf.LAUNCHES["hashgrid_bwd_dx"] == before["hashgrid_bwd_dx"] + 1
    assert thf.LAUNCHES["hashgrid_bwd_dtable"] == before["hashgrid_bwd_dtable"] + 1
    want = thf.hashgrid_fwd_torch(table, x, spec)
    dt_w, dx_w = thf.hashgrid_bwd_torch(table, x, g, spec)
    assert (out - want).abs().max().item() <= 1e-5
    # fp32 atomics sum in another order than the twin
    assert (dx - dx_w).abs().max().item() <= 1e-4 * dx_w.abs().max().item()
    assert (dt - dt_w).abs().max().item() <= 1e-4 * dt_w.abs().max().item()
    # through autograd, a detached table skips the dtable pass (tracking)
    xg = x.clone().requires_grad_(True)
    (dx_auto,) = torch.autograd.grad(torch.sum(thf.encode(table, xg, spec) * g), [xg])
    assert thf.LAUNCHES["hashgrid_bwd_dtable"] == before["hashgrid_bwd_dtable"] + 1
    assert (dx_auto - dx_w).abs().max().item() <= 1e-4 * dx_w.abs().max().item()
