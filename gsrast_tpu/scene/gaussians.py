"""Gaussian scene representation.

The replacement for the reference's `SplatData` AoS loader
(/root/reference/apps/gsrast/SplatData.hpp:15-69, SplatData.cpp:28-156): the
scene is a pytree of SoA arrays storing *raw* (pre-activation) parameters —
exactly what a trained .ply contains — with the activations the reference
applies at load time (scale <- exp, rotation <- normalize, opacity <- sigmoid;
SplatData.cpp:50-54) exposed as an explicit, differentiable `activated()`
transform. Raw storage is what training needs; rendering always consumes the
activated view.

Capacity vs. count: XLA wants static shapes, so a scene may be allocated
with `capacity >= N` rows and a validity mask; densification fills free slots
and pruning releases them without reshaping (see train/densify.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass

MAX_SH_DEGREE = 3
NUM_SH_COEFFS = (MAX_SH_DEGREE + 1) ** 2  # 16


@pytree_dataclass
class GaussianScene:
    """Raw (trainable) Gaussian parameters, SoA.

    Attributes:
      means:      (M, 3) world-space centers.
      log_scales: (M, 3) log of per-axis std-devs (stored raw; reference
                  exponentiates at load, SplatData.cpp:8,50).
      quats:      (M, 4) unnormalized rotation quaternions, (w, x, y, z)
                  (reference normalizes at load, SplatData.cpp:52).
      opacity_logits: (M,) pre-sigmoid opacities (reference SplatData.cpp:10,53).
      sh:         (M, K, 3) spherical-harmonic coefficients, K=(deg+1)^2, DC
                  first (reference RichPoint shs[48], SplatData.hpp:9-25).
      mask:       (M,) bool — True for live Gaussians (capacity slots beyond N
                  are dead).
    """

    means: jax.Array
    log_scales: jax.Array
    quats: jax.Array
    opacity_logits: jax.Array
    sh: jax.Array
    mask: jax.Array

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    def num_active(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32))

    # ---- activations (differentiable) ----

    def scales(self) -> jax.Array:
        return jnp.exp(self.log_scales)

    def rotations(self) -> jax.Array:
        q = self.quats
        return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)

    def opacities(self) -> jax.Array:
        return jax.nn.sigmoid(self.opacity_logits)

    def activated(self) -> "ActivatedGaussians":
        return ActivatedGaussians(
            means=self.means,
            scales=self.scales(),
            quats=self.rotations(),
            opacities=jnp.where(self.mask, self.opacities(), 0.0),
            sh=self.sh,
            mask=self.mask,
        )

    # ---- stats (reference SplatData.cpp:55-62 bbox/center; Inspector data
    # stats panel Inspector.cpp:95-115) ----

    def bbox(self) -> Tuple[jax.Array, jax.Array]:
        big = jnp.float32(3.0e38)
        live = self.mask[:, None]
        mn = jnp.min(jnp.where(live, self.means, big), axis=0)
        mx = jnp.max(jnp.where(live, self.means, -big), axis=0)
        return mn, mx

    def center(self) -> jax.Array:
        live = self.mask[:, None].astype(self.means.dtype)
        return jnp.sum(self.means * live, axis=0) / jnp.maximum(jnp.sum(live), 1.0)


@pytree_dataclass
class ActivatedGaussians:
    """Render-ready view of a scene (post-activation)."""

    means: jax.Array
    scales: jax.Array
    quats: jax.Array
    opacities: jax.Array
    sh: jax.Array
    mask: jax.Array

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1


PARAM_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def split_params(scene: GaussianScene):
    """Split into (trainable float params dict, bool mask) — jax.grad wants a
    pytree of inexact leaves."""
    params = {f: getattr(scene, f) for f in PARAM_FIELDS}
    return params, scene.mask


def merge_params(params: dict, mask: jax.Array) -> GaussianScene:
    return GaussianScene(mask=mask, **params)


def from_arrays(
    means,
    log_scales,
    quats,
    opacity_logits,
    sh,
    mask=None,
    capacity: Optional[int] = None,
) -> GaussianScene:
    """Build a scene from host arrays, optionally padding to `capacity`."""
    means = jnp.asarray(means, jnp.float32)
    n = means.shape[0]
    log_scales = jnp.asarray(log_scales, jnp.float32)
    quats = jnp.asarray(quats, jnp.float32)
    opacity_logits = jnp.asarray(opacity_logits, jnp.float32).reshape(n)
    sh = jnp.asarray(sh, jnp.float32)
    if mask is None:
        mask = jnp.ones((n,), bool)
    else:
        mask = jnp.asarray(mask, bool)
    scene = GaussianScene(
        means=means,
        log_scales=log_scales,
        quats=quats,
        opacity_logits=opacity_logits,
        sh=sh,
        mask=mask,
    )
    if capacity is not None and capacity > n:
        scene = pad_to_capacity(scene, capacity)
    return scene


def pad_to_capacity(scene: GaussianScene, capacity: int) -> GaussianScene:
    n = scene.capacity
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current size {n}")
    if capacity == n:
        return scene
    pad = capacity - n

    def _pad(x, fill=0.0):
        shape = (pad,) + x.shape[1:]
        return jnp.concatenate([x, jnp.full(shape, fill, x.dtype)], axis=0)

    return GaussianScene(
        means=_pad(scene.means),
        log_scales=_pad(scene.log_scales, fill=-10.0),
        quats=_pad(scene.quats).at[n:, 0].set(1.0),
        opacity_logits=_pad(scene.opacity_logits, fill=-10.0),
        sh=_pad(scene.sh),
        mask=_pad(scene.mask, fill=False),
    )


def random_scene(
    key: jax.Array,
    n: int,
    sh_degree: int = 0,
    extent: float = 1.0,
    isotropic: bool = False,
    scale_range: Tuple[float, float] = (0.01, 0.05),
) -> GaussianScene:
    """Synthetic test scene (BASELINE config 1/2 style: isotropic or
    anisotropic Gaussians in a cube)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    means = jax.random.uniform(k1, (n, 3), minval=-extent, maxval=extent)
    lo, hi = np.log(scale_range[0] * extent), np.log(scale_range[1] * extent)
    if isotropic:
        ls = jax.random.uniform(k2, (n, 1), minval=lo, maxval=hi)
        log_scales = jnp.broadcast_to(ls, (n, 3))
        quats = jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
    else:
        log_scales = jax.random.uniform(k2, (n, 3), minval=lo, maxval=hi)
        quats = jax.random.normal(k3, (n, 4))
        quats = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True)
    opacity_logits = jax.random.uniform(k4, (n,), minval=-1.0, maxval=3.0)
    ksh = (sh_degree + 1) ** 2
    sh = jnp.zeros((n, ksh, 3))
    # DC around mid-gray with variation; higher orders small.
    sh = sh.at[:, 0, :].set(jax.random.uniform(k5, (n, 3), minval=-1.0, maxval=1.0))
    if ksh > 1:
        krest = jax.random.split(k5, 1)[0]
        sh = sh.at[:, 1:, :].set(0.1 * jax.random.normal(krest, (n, ksh - 1, 3)))
    return GaussianScene(
        means=means,
        log_scales=log_scales,
        quats=quats,
        opacity_logits=opacity_logits,
        sh=sh,
        mask=jnp.ones((n,), bool),
    )
