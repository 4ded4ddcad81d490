"""2D render metrics: PSNR, SSIM, MS-SSIM, depth-L1 (host NumPy) and LPIPS.

Counterpart of ``xrdslam_tpu/common/metrics.py``. SSIM is the single-scale
11x11 Gaussian-window form; MS-SSIM the 5-scale one with the standard
weights. LPIPS runs ``ops/lpips.py`` on its pretrained weights where they
are present, and is NaN where they are not (the reference package's
torchmetrics fallback downloads its weights, so it is not ported).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(pred: np.ndarray, target: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
    p, t = np.asarray(pred, np.float64), np.asarray(target, np.float64)
    se = (p - t) ** 2
    mse = se[mask].mean() if mask is not None else se.mean()
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def _filter2d(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """'valid' 2D correlation per channel."""
    from numpy.lib.stride_tricks import sliding_window_view

    return np.einsum("ij...ab,ab->ij...", sliding_window_view(img, k.shape, axis=(0, 1)), k)


def _ssim_cs(p: np.ndarray, t: np.ndarray, data_range: float) -> tuple:
    """(mean SSIM, mean contrast-structure) over an 11x11 Gaussian window."""
    k = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_p, mu_t = _filter2d(p, k), _filter2d(t, k)
    var_p = _filter2d(p * p, k) - mu_p**2
    var_t = _filter2d(t * t, k) - mu_t**2
    cov = _filter2d(p * t, k) - mu_p * mu_t
    cs = (2 * cov + c2) / (var_p + var_t + c2)
    s = ((2 * mu_p * mu_t + c1) / (mu_p**2 + mu_t**2 + c1)) * cs
    return float(s.mean()), float(cs.mean())


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    """Single-scale SSIM, 11x11 Gaussian window, C1/C2 per Wang et al."""
    p, t = np.asarray(pred, np.float64), np.asarray(target, np.float64)
    if p.ndim == 2:
        p, t = p[..., None], t[..., None]
    return _ssim_cs(p, t, data_range)[0]


def _avg_pool2(x: np.ndarray) -> np.ndarray:
    h, w = (x.shape[0] // 2) * 2, (x.shape[1] // 2) * 2
    x = x[:h, :w]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def ms_ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    """Multi-scale SSIM (Wang et al. 2003), 5 scales, standard weights:
    contrast-structure at the finer scales, full SSIM at the coarsest, 2x2
    average pooling between; fewer scales when the image is too small."""
    weights = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
    p, t = np.asarray(pred, np.float64), np.asarray(target, np.float64)
    if p.ndim == 2:
        p, t = p[..., None], t[..., None]
    levels = len(weights)
    while levels > 1 and min(p.shape[0], p.shape[1]) // 2 ** (levels - 1) < 11:
        levels -= 1
    w = weights[:levels] / weights[:levels].sum() if levels < len(weights) else weights
    vals = []
    for i in range(levels):
        s, cs = _ssim_cs(p, t, data_range)
        vals.append(s if i == levels - 1 else cs)
        if i != levels - 1:
            p, t = _avg_pool2(p), _avg_pool2(t)
    return float(np.prod(np.clip(np.asarray(vals), 1e-6, None) ** w))


def depth_l1(pred: np.ndarray, target: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
    """Mean |pred-target| over valid depth, in the input unit (meters)."""
    p, t = np.asarray(pred, np.float64), np.asarray(target, np.float64)
    if mask is None:
        mask = t > 0
    if mask.sum() == 0:
        return float("nan")
    return float(np.abs(p - t)[mask].mean())



LPIPS_UNAVAILABLE = ("the port's ops/lpips.py needs the converted AlexNet and LPIPS lin weights (alexnet.pth and "
                     "lpips_alex.pth in the directory $XRDSLAM_LPIPS_WEIGHTS names); they are not present, so LPIPS "
                     "is not measured")


def lpips(pred: np.ndarray, target: np.ndarray, device="cpu") -> float:
    """LPIPS(alex) of two [H, W, 3] images on ``device`` where the
    pretrained weights load, else NaN."""
    import torch

    from ..ops.lpips import get_pretrained, lpips_apply, to_device

    params = get_pretrained()
    if params is None:
        return float("nan")

    def img(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device).clamp(0, 1)

    return float(lpips_apply(to_device(params, device), img(pred), img(target)))
