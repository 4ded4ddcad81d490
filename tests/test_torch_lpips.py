"""The port's LPIPS(alex) against the JAX package's.

* ``lpips_apply`` on the port's ``init_params(seed)`` and on the same tree
  in JAX, two 64x64 images: within 1e-5 (both in float32);
* ``load_torch_weights`` on files the test writes in the reference's
  layouts (torchvision's ``alexnet.pth`` with the LPIPS ``lin{i}`` keys, and
  the newer ``lins.{i}`` keys): the same tree as the JAX converter's, and
  ``metrics.lpips`` through ``$XRDSLAM_LPIPS_WEIGHTS`` equal to JAX's
  metric; a file without a tensor is the loader's own error, and the metric
  is NaN;
* ``metrics.lpips`` is NaN when no weights are present.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from xrdslam_tpu.common import metrics as jmetrics  # noqa: E402
from xrdslam_tpu.ops import lpips as jlpips  # noqa: E402
from xrdslam_tpu_torch.common import metrics  # noqa: E402
from xrdslam_tpu_torch.ops import lpips  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The suite runs in several worker processes; one torch thread each
    keeps them from oversubscribing the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def no_cached_weights(monkeypatch):
    monkeypatch.setattr(lpips, "_CACHED", None)
    monkeypatch.setattr(jlpips, "_CACHED", None)


def _images(seed=0):
    """Two 64x64 images (one size for every JAX call: its ops compile once)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def _jax_tree(params):
    import jax.numpy as jnp

    return {k: {n: jnp.asarray(t.numpy()) for n, t in v.items()} for k, v in params.items()}


def test_lpips_apply_matches_jax():
    import jax.numpy as jnp

    params = lpips.init_params(3)
    a, b = _images()
    got = float(lpips.lpips_apply(params, torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jlpips.lpips_apply(_jax_tree(params), jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= ATOL, (got, want)
    assert float(lpips.lpips_apply(params, torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def _write_reference_files(d, lins_key="lin{}.model.1.weight", drop=None):
    g = torch.Generator().manual_seed(0)
    anet = {}
    for fi, (cin, cout, k, _, _, _) in zip(lpips._FEATURE_INDEX, lpips._CONVS):
        anet[f"features.{fi}.weight"] = torch.randn((cout, cin, k, k), generator=g) * 0.05
        anet[f"features.{fi}.bias"] = torch.randn((cout,), generator=g) * 0.05
    lins = {lins_key.format(i): torch.rand((1, c, 1, 1), generator=g) * 0.02
            for i, c in enumerate(lpips._TAP_CHANNELS)}
    anet.pop(drop, None)
    torch.save(anet, str(d / "alexnet.pth"))
    torch.save(lins, str(d / "lpips_alex.pth"))


@pytest.mark.parametrize("lins_key", ["lin{}.model.1.weight", "lins.{}.model.1.weight"])
def test_load_torch_weights_as_jax(tmp_path, monkeypatch, lins_key):
    _write_reference_files(tmp_path, lins_key)
    paths = (str(tmp_path / "alexnet.pth"), str(tmp_path / "lpips_alex.pth"))
    got, want = lpips.load_torch_weights(*paths), jlpips.load_torch_weights(*paths)
    assert set(got) == set(want)
    for k in got:
        assert set(got[k]) == set(want[k])
        for n in got[k]:
            np.testing.assert_array_equal(got[k][n].numpy(), np.asarray(want[k][n]), err_msg=f"{k}/{n}")
    monkeypatch.setenv("XRDSLAM_LPIPS_WEIGHTS", str(tmp_path))
    a, b = _images(1)
    got_m, want_m = metrics.lpips(a, b), jmetrics.lpips(a, b)
    assert np.isfinite(got_m) and got_m > 0
    assert abs(got_m - want_m) <= ATOL, (got_m, want_m)


def test_a_file_without_a_tensor_is_the_loaders_error(tmp_path, monkeypatch, capsys):
    _write_reference_files(tmp_path, drop="features.8.bias")
    with pytest.raises(lpips.WeightsError, match="features.8.bias"):
        lpips.load_torch_weights(str(tmp_path / "alexnet.pth"), str(tmp_path / "lpips_alex.pth"))
    monkeypatch.setenv("XRDSLAM_LPIPS_WEIGHTS", str(tmp_path))
    assert lpips.get_pretrained() is None
    assert "failed to load weights" in capsys.readouterr().out
    assert np.isnan(metrics.lpips(*_images()))


def test_metric_is_nan_without_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("XRDSLAM_LPIPS_WEIGHTS", raising=False)
    assert np.isnan(metrics.lpips(*_images()))
    monkeypatch.setenv("XRDSLAM_LPIPS_WEIGHTS", str(tmp_path))  # a directory without the files
    assert lpips.get_pretrained() is None
    assert np.isnan(metrics.lpips(*_images()))
