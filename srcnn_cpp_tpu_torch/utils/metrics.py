"""Image quality metrics: PSNR and SSIM.

The reference publishes butterfly before/after pairs evaluated by the
standard SRCNN protocol (reference Pictures/Resize.m: downscale ground truth
bicubically, super-resolve, compare) — these are the metrics that protocol
needs.  Pure NumPy, float64, usable both in tests and in the eval harness.

A copy of ``srcnn_cpp_tpu/utils/metrics.py`` (the port never imports the
JAX package; ``tests/test_torch_eval.py`` holds the two equal).
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB between two images."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2.0 * sigma**2))
    k /= k.sum()
    return k


def _filter2_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' correlation with a 1-D kernel applied on both axes."""
    pad = len(k) // 2
    out = np.apply_along_axis(lambda m: np.convolve(m, k, mode="full"), 0, img)
    out = np.apply_along_axis(lambda m: np.convolve(m, k, mode="full"), 1, out)
    return out[2 * pad : out.shape[0] - 2 * pad, 2 * pad : out.shape[1] - 2 * pad]


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Structural similarity (Wang et al. 2004) on grayscale planes.

    Gaussian 11x11 sigma=1.5 windows, 'valid' boundary — the standard
    configuration used by SR papers for Set5/Set14 reporting.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    k = _gaussian_kernel()
    mu_a = _filter2_sep(a, k)
    mu_b = _filter2_sep(b, k)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_a = _filter2_sep(a * a, k) - mu_a2
    s_b = _filter2_sep(b * b, k) - mu_b2
    s_ab = _filter2_sep(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (s_a + s_b + c2)
    return float(np.mean(num / den))
