"""The plane-layout hash-grid encoder (K8, K9) of the port against the JAX
package's TPU kernels.

The CPU path of ``xrdslam_tpu_torch.ops.hashgrid_planes`` is its plain
twin; it is held against ``pallas_hashgrid.hashgrid_encode_pallas`` run in
Pallas interpret mode on the CPU (the kernels' T = 2^16 is built in; one
block of 480 points, some outside [0,1]^3, on 4 levels: 2 dense, 2
hashed). Tolerances: forward 1e-6 absolute; dx and dplanes 1e-4 of their
largest entry (sums in another order). dx follows the TPU kernel (the
gradient at the clamped point, not zeroed outside the box), so it is held
against autodiff of the reference encode only inside the box.

The CUDA kernels are compared with the twin on the card (``cuda`` marker):
``python -m pytest --noconftest -m cuda tests/test_torch_hashgrid_planes.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hashgrid import ray_samples  # noqa: E402
from xrdslam_tpu_torch.ops import encodings as tenc  # noqa: E402
from xrdslam_tpu_torch.ops import hashgrid_fast as thf  # noqa: E402
from xrdslam_tpu_torch.ops import hashgrid_planes as thp  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


N = 480
SPEC_ARGS = (4, 2, 16, 16, 100)  # resolutions 16, 29 (dense), 54, 100 (hashed); T = 2^16
FWD_ATOL = 1e-6
BWD_RTOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from xrdslam_tpu.ops import encodings, pallas_hashgrid

    return SimpleNamespace(jax=jax, jnp=jnp, enc=encodings, ph=pallas_hashgrid)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    tspec = tenc.hashgrid_spec(*SPEC_ARGS)
    assert tspec.dense == (True, True, False, False)
    table = rng.uniform(-1.0, 1.0, (tspec.n_levels, tspec.table_size, 2)).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, (N, 3)).astype(np.float32)
    g = rng.standard_normal((N, tspec.out_dim)).astype(np.float32)
    inside = np.all((x >= 0.0) & (x <= 1.0), axis=1)
    assert 0 < inside.sum() < N
    return tspec, table, x, g, inside


@pytest.fixture(scope="module")
def tpu_kernels(jx, case):
    """(out, dplanes, dx) of the TPU kernels K8/K9, in interpret mode."""
    tspec, table, x, g, _ = case
    jspec = jx.enc.hashgrid_spec(*SPEC_ARGS)
    planes = jx.ph.pack_table(jx.jnp.asarray(table), jspec)
    out, vjp = jx.jax.vjp(lambda p, xx: jx.ph.hashgrid_encode_pallas(p, xx, jspec), planes, jx.jnp.asarray(x))
    dplanes, dx = vjp(jx.jnp.asarray(g))
    return np.asarray(out), np.asarray(dplanes), np.asarray(dx)


@pytest.fixture(scope="module")
def twin(case):
    tspec, table, x, g, _ = case
    planes = thp.pack_table(torch.from_numpy(table))
    out = thp.hashgrid_planes_fwd(planes, torch.from_numpy(x), tspec)
    dplanes, dx = thp.hashgrid_planes_bwd(planes, torch.from_numpy(x), torch.from_numpy(g), tspec)
    return out.numpy(), dplanes.numpy(), dx.numpy()


def _rel_close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= BWD_RTOL * scale, f"{what}: max abs err {err:.3e} > {BWD_RTOL} x {scale:.3e}"


def test_pack_and_unpack_match_jax(jx, case):
    tspec, table, *_ = case
    jspec = jx.enc.hashgrid_spec(*SPEC_ARGS)
    want = np.asarray(jx.ph.pack_table(jx.jnp.asarray(table), jspec))
    got = thp.pack_table(torch.from_numpy(table))
    assert got.shape == (tspec.n_levels, 2, 512, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(thp.unpack_table(got).numpy(), np.asarray(jx.ph.unpack_table(jx.jnp.asarray(want))))
    np.testing.assert_array_equal(thp.unpack_table(got).numpy(), table)


def test_fwd_matches_tpu_kernel(tpu_kernels, twin):
    np.testing.assert_allclose(twin[0], tpu_kernels[0], atol=FWD_ATOL, rtol=0)


def test_dplanes_matches_tpu_kernel(tpu_kernels, twin):
    _rel_close(twin[1], tpu_kernels[1], "dplanes")


def test_dx_matches_tpu_kernel_everywhere(tpu_kernels, twin):
    # K9's dx is the gradient at the clamped point, also outside the box
    _rel_close(twin[2], tpu_kernels[2], "dx")


def test_dx_matches_reference_autodiff_inside_the_box(jx, case, twin):
    tspec, table, x, g, inside = case
    jspec = jx.enc.hashgrid_spec(*SPEC_ARGS)
    ref = jx.jax.grad(lambda xx: jx.jnp.sum(jx.enc.hashgrid_encode(jx.jnp.asarray(table), xx, jspec) * g))(
        jx.jnp.asarray(x))
    _rel_close(twin[2][inside], np.asarray(ref)[inside], "dx inside the box")


def test_autograd_function_computes_only_needed_grads(case, twin):
    tspec, table, x, g, _ = case
    planes = thp.pack_table(torch.from_numpy(table)).requires_grad_(True)
    xx = torch.from_numpy(x).reshape(16, 30, 3).requires_grad_(True)
    out = thp.hashgrid_encode_planes(planes, xx, tspec)
    assert out.shape == (16, 30, tspec.out_dim)
    np.testing.assert_array_equal(out.detach().reshape(N, -1).numpy(), twin[0])
    torch.sum(out.reshape(N, -1) * torch.from_numpy(g)).backward()
    np.testing.assert_allclose(planes.grad.numpy(), twin[1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(xx.grad.reshape(N, 3).numpy(), twin[2], atol=1e-6, rtol=0)
    # detached planes get no gradient; x still does
    (dx,) = torch.autograd.grad(
        torch.sum(thp.hashgrid_encode_planes(planes.detach(), xx, tspec).reshape(N, -1) * torch.from_numpy(g)), [xx])
    np.testing.assert_allclose(dx.reshape(N, 3).numpy(), twin[2], atol=1e-6, rtol=0)


@pytest.mark.parametrize("bad", [dict(n_features=4), dict(log2_table_size=15)])
def test_only_the_tpu_kernels_shapes_are_taken(bad):
    spec = tenc.hashgrid_spec(*SPEC_ARGS)._replace(**bad)
    planes = torch.zeros((spec.n_levels, spec.n_features, spec.table_size // 128, 128))
    x = torch.rand(8, 3)
    with pytest.raises(ValueError, match="2\\^16"):
        thp.hashgrid_planes_fwd(planes, x, spec)
    with pytest.raises(ValueError, match="2\\^16"):
        thp.hashgrid_planes_bwd(planes, x, torch.zeros(8, spec.out_dim), spec)


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
    planes = torch.as_tensor(rng.standard_normal((16, 2, 512, 128)).astype(np.float32), device=dev)
    before = dict(thp.LAUNCHES)
    out = thp.hashgrid_planes_fwd(planes, x, spec)
    dp, dx = thp.hashgrid_planes_bwd(planes, x, g, spec)
    torch.cuda.synchronize()
    assert thp.LAUNCHES["hashgrid_planes_fwd"] == before["hashgrid_planes_fwd"] + 1
    assert thp.LAUNCHES["hashgrid_planes_bwd"] == before["hashgrid_planes_bwd"] + 1
    want = thp.hashgrid_planes_fwd_torch(planes, x, spec)
    dp_w, dx_w = thp.hashgrid_planes_bwd_torch(planes, x, g, spec)
    assert (out - want).abs().max().item() <= 1e-5
    # shuffles (dx) and atomics (dplanes) sum in another order than the twin
    assert (dx - dx_w).abs().max().item() <= BWD_RTOL * dx_w.abs().max().item()
    assert (dp - dp_w).abs().max().item() <= BWD_RTOL * dp_w.abs().max().item()
    xg = x.clone().requires_grad_(True)
    (dx_auto,) = torch.autograd.grad(torch.sum(thp.hashgrid_encode_planes(planes, xg, spec) * g), [xg])
    assert (dx_auto - dx_w).abs().max().item() <= BWD_RTOL * dx_w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 12, 16, 32])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 44_032])
def test_cuda_fwd_on_ray_samples(n, levels):
    """K8 against its twin on ray-ordered, boundary-heavy samples at ragged
    counts (1e-5 absolute); the same bits twice, and the same bits as K1 on
    the same table in the [L, T, 2] layout (one kernel, one arithmetic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    spec = tenc.hashgrid_spec(levels, 2, 16, 16, 319)
    rng = np.random.default_rng(1000 * levels + n)
    dev = torch.device("cuda")
    x = torch.as_tensor(ray_samples(rng, n, spec), device=dev)
    table = torch.as_tensor(rng.standard_normal((levels, spec.table_size, 2)).astype(np.float32), device=dev)
    planes = thp.pack_table(table)
    outs = [thp.hashgrid_planes_fwd(planes, x, spec) for _ in range(2)]
    k1 = thf.hashgrid_fwd(table, x, spec)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], k1)
    assert (outs[0] - thp.hashgrid_planes_fwd_torch(planes, x, spec)).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_cuda_fwd_on_misaligned_planes():
    """Planes that start 4 bytes past an 8-byte boundary: the wrapper copies
    them and gives the aligned planes' bits; the C function, which reads an
    entry pair as one float2 per feature, refuses the pointer with
    cudaErrorMisalignedAddress (716) through ``kernels.check``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    from xrdslam_tpu_torch import kernels

    spec = tenc.hashgrid_spec(16, 2, 16, 16, 319)
    rng = np.random.default_rng(16)
    dev = torch.device("cuda")
    n = 1000
    x = torch.as_tensor(ray_samples(rng, n, spec), device=dev)
    planes = torch.as_tensor(rng.standard_normal((16, 2, 512, 128)).astype(np.float32), device=dev)
    buf = torch.empty(planes.numel() + 1, dtype=torch.float32, device=dev)
    view = buf[1:].view(planes.shape)
    view.copy_(planes)
    assert view.is_contiguous() and view.data_ptr() % 8 == 4
    got, want = thp.hashgrid_planes_fwd(view, x, spec), thp.hashgrid_planes_fwd(planes, x, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    res, dense = thf.level_args(spec)
    out = torch.empty_like(want)
    with pytest.raises(RuntimeError, match="cudaError 716"):
        thp._FWD(view.data_ptr(), x.data_ptr(), out.data_ptr(), n, spec.n_levels, spec.log2_table_size, res, dense,
                 kernels.stream(x))
