"""Statistical parity of two stochastic renders (tests and chip_smoke.py).

Two engines with different random streams agree only in distribution. The
check: whole-image per-channel means within a relative tolerance, and every
``block`` x ``block`` block mean within ``n_se`` standard errors. The
per-pixel variance comes from two renders of the reference engine under
different seeds (``ref_a``, ``ref_b``): E[(a - b)^2] / 2 is the variance of
one render's pixel, so a block mean difference of two independent renders
has variance 2 * mean(v) / block^2.
"""

from __future__ import annotations

import numpy as np


def block_means(img: np.ndarray, block: int) -> np.ndarray:
    h, w, c = img.shape
    hb, wb = h // block, w // block
    img = img[:hb * block, :wb * block]
    return img.reshape(hb, block, wb, block, c).mean(axis=(1, 3))


def statistical_parity(test: np.ndarray, ref_a: np.ndarray,
                       ref_b: np.ndarray, *, block: int = 16,
                       mean_rtol: float = 0.01, n_se: float = 5.0,
                       atol: float = 1e-5) -> dict:
    """Compare ``test`` with ``ref_a``; returns the figures of the check and
    whether it passed (``ok``)."""
    test, ref_a, ref_b = (np.asarray(x, np.float64) for x in
                          (test, ref_a, ref_b))
    m_test = test.mean(axis=(0, 1))
    m_ref = ref_a.mean(axis=(0, 1))
    mean_rel = np.abs(m_test - m_ref) / np.maximum(np.abs(m_ref), 1e-12)
    var = 0.5 * (ref_a - ref_b) ** 2
    se = np.sqrt(2.0 * block_means(var, block) / (block * block))
    diff = np.abs(block_means(test, block) - block_means(ref_a, block))
    worst = float(np.max(diff / (n_se * se + atol)))
    return {
        "mean_rel_err": [float(x) for x in mean_rel],
        "worst_block_over_limit": worst,
        "ok": bool((mean_rel <= mean_rtol).all() and worst <= 1.0),
    }
