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


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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


def ray_samples(rng, n: int, spec) -> np.ndarray:
    """[n, 3] float32 points in the main path's order: rays of 43 sorted
    samples each, so that consecutive points often share a cell; a third of
    the points have one coordinate on a cell boundary k/res of a random
    level; rows 0-3 (where n >= 4) sit at 0, at 1 and outside the box."""
    n_rays = n // 43 + 1
    o = rng.uniform(-0.1, 1.1, (n_rays, 3))
    d = rng.standard_normal((n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 1.2, (n_rays, 43)), axis=1)
    x = (o[:, None] + t[..., None] * d[:, None]).reshape(-1, 3)[:n].astype(np.float32)
    k = rng.choice(n, n // 3, replace=False)
    res = np.asarray(spec.resolutions)[rng.integers(0, spec.n_levels, len(k))]
    x[k, rng.integers(0, 3, len(k))] = (rng.integers(0, res + 1) / res).astype(np.float32)
    if n >= 4:
        x[0], x[1], x[2, 0], x[3, 2] = 0.0, 1.0, -0.25, 1.5
    return x


@pytest.mark.parametrize("oracle", ["reference", "tpu_kernel"])
def test_fwd_matches_jax_on_ray_samples(jx, oracle):
    """The twin, the CUDA forward's oracle, on the kind of input the card's
    tests give the kernel: ray-ordered, boundary-heavy, at 0, 1 and
    outside the box (516 points, 6 levels; 1e-6 absolute, as above)."""
    rng = np.random.default_rng(7)
    jspec, tspec = jx.enc.hashgrid_spec(*SPEC_ARGS), tenc.hashgrid_spec(*SPEC_ARGS)
    x = ray_samples(rng, 516, tspec)
    table = rng.uniform(-1.0, 1.0, (tspec.n_levels, tspec.table_size, 2)).astype(np.float32)
    fn = jx.enc.hashgrid_encode if oracle == "reference" else jx.hf.hashgrid_encode_kern
    want = np.asarray(fn(jx.jnp.asarray(table), jx.jnp.asarray(x), jspec))
    got = thf.hashgrid_fwd(torch.from_numpy(table), torch.from_numpy(x), tspec).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


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


def test_cpu_forward_counts_no_launch(case):
    """A CPU tensor takes the twin: neither ``LAUNCHES`` nor the count by N
    moves, which count kernel launches only."""
    _, tspec, table, x, _, _ = case
    before, before_n = dict(thf.LAUNCHES), dict(thf.FWD_LAUNCHES_BY_N)
    thf.hashgrid_fwd(torch.from_numpy(table), torch.from_numpy(x), tspec)
    assert thf.LAUNCHES == before and thf.FWD_LAUNCHES_BY_N == before_n
    thf.FWD_LAUNCHES_BY_N[N] = 3
    thf.reset_launches()
    assert thf.FWD_LAUNCHES_BY_N == {} and not any(thf.LAUNCHES.values())


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
    before, before_n = dict(thf.LAUNCHES), thf.FWD_LAUNCHES_BY_N.get(n, 0)
    out = thf.hashgrid_fwd(table, x, spec)
    dt, dx = thf.hashgrid_bwd(table, x, g, spec)
    torch.cuda.synchronize()
    assert thf.LAUNCHES["hashgrid_fwd"] == before["hashgrid_fwd"] + 1
    assert thf.FWD_LAUNCHES_BY_N[n] == before_n + 1
    assert thf.LAUNCHES["hashgrid_bwd_dx"] == before["hashgrid_bwd_dx"] + 1
    assert thf.LAUNCHES["hashgrid_bwd_dtable"] == before["hashgrid_bwd_dtable"] + 1
    want = thf.hashgrid_fwd_torch(table, x, spec)
    dt_w, dx_w = thf.hashgrid_bwd_torch(table, x, g, spec)
    assert (out - want).abs().max().item() <= 1e-5
    # shuffles (dx) and atomics (dtable) sum in another order than the twin
    assert (dx - dx_w).abs().max().item() <= 1e-4 * dx_w.abs().max().item()
    assert (dt - dt_w).abs().max().item() <= 1e-4 * dt_w.abs().max().item()
    # through autograd, a detached table skips the dtable pass (tracking)
    xg = x.clone().requires_grad_(True)
    (dx_auto,) = torch.autograd.grad(torch.sum(thf.encode(table, xg, spec) * g), [xg])
    assert thf.LAUNCHES["hashgrid_bwd_dtable"] == before["hashgrid_bwd_dtable"] + 1
    assert (dx_auto - dx_w).abs().max().item() <= 1e-4 * dx_w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [16, 12, 32, 1])
def test_cuda_dx_is_deterministic(levels):
    """dx sums a point's levels with warp shuffles, for any L <= 32: the same
    bits twice, within the tolerance of the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    spec = tenc.hashgrid_spec(levels, 2, 16, 16, 319)
    rng = np.random.default_rng(levels)
    dev = torch.device("cuda")
    n = 20_000
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32), device=dev)
    g = torch.as_tensor(rng.standard_normal((n, spec.out_dim)).astype(np.float32), device=dev)
    table = torch.as_tensor(rng.standard_normal((levels, spec.table_size, 2)).astype(np.float32), device=dev)
    runs = [thf.hashgrid_bwd(table, x, g, spec, need_dtable=False)[1] for _ in range(2)]
    both = thf.hashgrid_bwd(table, x, g, spec)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(both[1], runs[0])
    dt_w, dx_w = thf.hashgrid_bwd_torch(table, x, g, spec)
    assert (runs[0] - dx_w).abs().max().item() <= 1e-4 * dx_w.abs().max().item()
    assert (both[0] - dt_w).abs().max().item() <= 1e-4 * dt_w.abs().max().item()


@pytest.mark.cuda
def test_cuda_dtable_in_one_level0_cell():
    """Every point in one cell of level 0 (res 16): all their dense-level
    corner adds land on a few entries of each privatised grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    spec = tenc.hashgrid_spec(16, 2, 16, 16, 319)
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    n = 176_128
    x = torch.as_tensor(rng.uniform(5.0, 6.0, (n, 3)).astype(np.float32) / 16, device=dev)  # cell (5, 5, 5)
    g = torch.as_tensor(rng.standard_normal((n, spec.out_dim)).astype(np.float32), device=dev)
    table = torch.as_tensor(rng.standard_normal((16, spec.table_size, 2)).astype(np.float32), device=dev)
    dt, dx = thf.hashgrid_bwd(table, x, g, spec)
    torch.cuda.synchronize()
    dt_w, dx_w = thf.hashgrid_bwd_torch(table, x, g, spec)
    assert (dt - dt_w).abs().max().item() <= 1e-4 * dt_w.abs().max().item()
    assert (dx - dx_w).abs().max().item() <= 1e-4 * dx_w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 12, 16, 32])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 44_032])
def test_cuda_fwd_on_ray_samples(n, levels):
    """The level-major forward against its twin on ray-ordered samples with
    points on cell boundaries, at 0, at 1 and outside the box, at counts
    that are not a multiple of a warp's 32 points or of a thread's levels:
    within 1e-5 (FWD_ATOL of chip_smoke.py), and the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    spec = tenc.hashgrid_spec(levels, 2, 16, 16, 319)
    rng = np.random.default_rng(1000 * levels + n)
    dev = torch.device("cuda")
    x = torch.as_tensor(ray_samples(rng, n, spec), device=dev)
    table = torch.as_tensor(rng.standard_normal((levels, spec.table_size, 2)).astype(np.float32), device=dev)
    outs = [thf.hashgrid_fwd(table, x, spec) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] - thf.hashgrid_fwd_torch(table, x, spec)).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_cuda_fwd_on_misaligned_table():
    """A table view that starts 8 bytes past a 16-byte boundary (a slice of a
    larger buffer): the wrapper copies it and gives the aligned table's
    bits; the C function, which reads x-pairs as float4, refuses the
    pointer with cudaErrorMisalignedAddress (716) through ``kernels.check``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    from xrdslam_tpu_torch import kernels

    spec = tenc.hashgrid_spec(16, 2, 16, 16, 319)
    rng = np.random.default_rng(16)
    dev = torch.device("cuda")
    n = 1000
    x = torch.as_tensor(ray_samples(rng, n, spec), device=dev)
    table = torch.as_tensor(rng.standard_normal((16, spec.table_size, 2)).astype(np.float32), device=dev)
    buf = torch.empty(table.numel() + 2, dtype=torch.float32, device=dev)
    view = buf[2:].view(table.shape)
    view.copy_(table)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    got, want = thf.hashgrid_fwd(view, x, spec), thf.hashgrid_fwd(table, x, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    res, dense = thf.level_args(spec)
    out = torch.empty_like(want)
    with pytest.raises(RuntimeError, match="cudaError 716"):
        thf._FWD(view.data_ptr(), x.data_ptr(), out.data_ptr(), n, spec.n_levels, spec.log2_table_size, res, dense,
                 kernels.stream(x))
