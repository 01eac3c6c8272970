"""Analytic-ellipsoid ray-trace debug renderer (reference mode 2).

The analog of GSEllipsoids (/root/reference/apps/gsrast/
GSEllipsoids.cpp + shaders/splats/fragment.glsl:30-83): each Gaussian drawn
as an opaque ellipsoid at 2x scale, per-pixel analytic ray-ellipsoid
intersection with exact depth, alpha-culled below 0.3 — the same semantics as
the fragment shader (discard alpha < 0.3, splats/fragment.glsl:44), minus the
GL instancing: here every (pixel, gaussian) pair is a batched quadratic
solve, z-tested with a min-reduction, chunked over Gaussians to bound memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..camera import Camera, camera_rays
from ..ops.covariance import quat_to_rotmat
from ..scene.gaussians import ActivatedGaussians

ALPHA_CULL = 0.3  # splats/fragment.glsl:44
SCALE_MULT = 2.0  # vertex scales cube by 2x scale (splats/vertex.glsl:39-56)


def render_ellipsoids(
    gaussians: ActivatedGaussians,
    camera: Camera,
    background=(0.0, 0.0, 0.0),
    gauss_chunk: int = 256,
) -> jax.Array:
    """Returns (H, W, 3)."""
    h, w = camera.height, camera.width
    origin, direction = camera_rays(camera)  # (h, w, 3) each
    o = origin.reshape(-1, 3)
    d = direction.reshape(-1, 3)
    p = o.shape[0]

    color_all = 0.2 * gaussians.sh[:, 0, :] + 0.5
    rot = quat_to_rotmat(gaussians.quats)  # (N, 3, 3) world<-local
    inv_scale = 1.0 / jnp.maximum(gaussians.scales * SCALE_MULT, 1e-8)
    alpha_ok = (gaussians.opacities >= ALPHA_CULL) & gaussians.mask

    n = gaussians.means.shape[0]
    pad = (-n) % gauss_chunk
    n_chunks = (n + pad) // gauss_chunk

    def pad_to(x, fill=0.0):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0
        ) if pad else x

    means = pad_to(gaussians.means)
    rots = pad_to(rot)
    inv_scales = pad_to(inv_scale, fill=1.0)
    colors = pad_to(color_all)
    live = pad_to(alpha_ok.astype(jnp.float32))

    def chunk_fn(carry, idx):
        best_t, best_color = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, idx * gauss_chunk, gauss_chunk)
        mu = sl(means)         # (G, 3)
        r = sl(rots)           # (G, 3, 3)
        isc = sl(inv_scales)   # (G, 3)
        col = sl(colors)       # (G, 3)
        lv = sl(live)          # (G,)

        # Transform rays into each ellipsoid's unit-sphere frame:
        # q = S^-1 R^T (x - mu)
        oo = jnp.einsum("gij,pj->gpi", jnp.swapaxes(r, -1, -2), o) - jnp.einsum(
            "gij,gj->gi", jnp.swapaxes(r, -1, -2), mu
        )[:, None, :]
        oo = oo * isc[:, None, :]
        dd = jnp.einsum("gij,pj->gpi", jnp.swapaxes(r, -1, -2), d) * isc[:, None, :]

        a = jnp.sum(dd * dd, axis=-1)
        b = 2.0 * jnp.sum(oo * dd, axis=-1)
        c = jnp.sum(oo * oo, axis=-1) - 1.0
        disc = b * b - 4.0 * a * c
        hit = (disc >= 0.0) & (lv[:, None] > 0.0)
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = (-b - sq) / (2.0 * a)
        t1 = (-b + sq) / (2.0 * a)
        t = jnp.where(t0 > 1e-4, t0, t1)  # nearest positive root
        t = jnp.where(hit & (t > 1e-4), t, jnp.inf)  # (G, P)

        tmin = jnp.min(t, axis=0)  # (P,)
        arg = jnp.argmin(t, axis=0)
        closer = tmin < best_t
        best_color = jnp.where(closer[:, None], col[arg], best_color)
        best_t = jnp.minimum(best_t, tmin)
        return (best_t, best_color), None

    init = (
        jnp.full((p,), jnp.inf),
        jnp.broadcast_to(jnp.asarray(background, jnp.float32), (p, 3)),
    )
    (best_t, best_color), _ = jax.lax.scan(
        chunk_fn, init, jnp.arange(n_chunks)
    )
    return jnp.clip(best_color.reshape(h, w, 3), 0.0, 1.0)
