"""Training losses: L1 + D-SSIM, the standard 3DGS objective.

Capability add over the reference (which is a forward-only viewer with no
training, SURVEY.md §0); demanded by BASELINE config 4. SSIM follows the
standard 11x11 Gaussian-window formulation, implemented as depthwise
convolutions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache()
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d(img: jax.Array, window: jax.Array) -> jax.Array:
    """Depthwise 2D filter on (H, W, C) with same padding."""
    c = img.shape[-1]
    kernel = jnp.broadcast_to(window[:, :, None, None], window.shape + (1, c))
    # NHWC, HWIO, depthwise via feature_group_count
    out = jax.lax.conv_general_dilated(
        img[None],
        kernel,
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0]


def ssim(img0: jax.Array, img1: jax.Array, c1: float = 0.01**2,
         c2: float = 0.03**2) -> jax.Array:
    """Mean SSIM over an (H, W, C) pair in [0, 1]."""
    window = jnp.asarray(_gaussian_window())
    mu0 = _filter2d(img0, window)
    mu1 = _filter2d(img1, window)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = _filter2d(img0 * img0, window) - mu00
    sigma11 = _filter2d(img1 * img1, window) - mu11
    sigma01 = _filter2d(img0 * img1, window) - mu01
    num = (2.0 * mu01 + c1) * (2.0 * sigma01 + c2)
    den = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return jnp.mean(num / den)


def l1(img0: jax.Array, img1: jax.Array) -> jax.Array:
    return jnp.mean(jnp.abs(img0 - img1))


def rgb_loss(pred: jax.Array, target: jax.Array,
             ssim_weight: float = 0.2) -> jax.Array:
    """(1 - w) L1 + w (1 - SSIM) — the 3DGS training objective."""
    return (1.0 - ssim_weight) * l1(pred, target) + ssim_weight * (
        1.0 - ssim(pred, target)
    )


def psnr(pred: jax.Array, target: jax.Array) -> jax.Array:
    mse = jnp.mean((pred - target) ** 2)
    return -10.0 * jnp.log10(jnp.maximum(mse, 1e-10))
