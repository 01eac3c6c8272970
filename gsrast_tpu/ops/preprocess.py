"""Batched Gaussian preprocessing: cull + project + shade.

The analog of the reference preprocess kernel
(/root/reference/apps/gsrast/gscuda/GSCuda.cu:261-375): one fused, batched,
fully-differentiable XLA computation over all N Gaussians (the reference runs
one CUDA thread per Gaussian; here XLA vectorizes over the N axis on the VPU).
Outputs exactly the per-Gaussian state the reference's GeometryState carries
(AuxBuffer.cuh:38-54): depths, means2D, conic+opacity, rgb, radii,
tiles_touched.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import config as cfg
from ..camera import Camera
from ..scene.gaussians import ActivatedGaussians
from . import covariance, projection, sh as sh_ops


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space state (the GeometryState analog)."""

    mean2d: jax.Array   # (N, 2) pixel coords
    depth: jax.Array    # (N,) camera-space z
    conic: jax.Array    # (N, 3) inverse 2D covariance [A, B, C]
    color: jax.Array    # (N, 3) RGB from SH
    opacity: jax.Array  # (N,)
    radius: jax.Array   # (N,) int32 pixel radius (0 = culled)
    rect: projection.TileRect  # covered tile rectangle
    tiles_touched: jax.Array   # (N,) int32


def preprocess(
    gaussians: ActivatedGaussians,
    camera: Camera,
    render_cfg: cfg.RenderConfig,
    mean2d_delta: jax.Array | None = None,
) -> Preprocessed:
    """`mean2d_delta`: optional (N, 2) zero-valued perturbation added to the
    screen positions; differentiating wrt it yields the per-Gaussian
    screen-space positional gradient that drives densification (the 3DGS
    "viewspace point gradient")."""
    view = camera.view
    full_proj = camera.full_projection()
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)

    mean_view = projection.to_camera(gaussians.means, view)
    depth = mean_view[..., 2]
    mean2d, ndc = projection.project(
        gaussians.means, full_proj, camera.width, camera.height
    )
    if mean2d_delta is not None:
        mean2d = mean2d + mean2d_delta
    visible = projection.in_frustum(depth, ndc) & gaussians.mask

    cov6 = covariance.compute_cov3d(gaussians.scales, gaussians.quats)
    # Guard the EWA division by z for culled points.
    safe_view = mean_view.at[..., 2].set(jnp.where(visible, depth, 1.0))
    cov2d = covariance.compute_cov2d(
        safe_view,
        cov6,
        view[:3, :3],
        camera.focal_x,
        camera.focal_y,
        camera.tan_fov_x,
        camera.tan_fov_y,
    )
    conic, radius_f, cov_valid = covariance.conic_and_radius(cov2d)
    visible = visible & cov_valid

    # View-dependent color from SH (full evaluation; the reference stubs this
    # with DC-only at GSCuda.cu:361-366).
    direction = gaussians.means - camera.position
    direction = direction / (
        jnp.linalg.norm(direction, axis=-1, keepdims=True) + 1e-12
    )
    degree = min(render_cfg.sh_degree, gaussians.sh_degree)
    color = sh_ops.eval_sh(gaussians.sh, direction, degree)

    # Opacity-aware PER-AXIS extent (exactness-preserving): the blend skips
    # alpha = opacity * exp(-1/2 d^T Sigma^-1 d) < ALPHA_MIN
    # (GSCuda.cu:645-649), so the support is the ellipse
    # d^T Sigma^-1 d <= c with c = 2 ln(opacity/ALPHA_MIN) (capped at the
    # reference's (3 sigma)^2, GSCuda.cu:337-341), whose tight axis-aligned
    # bound is +-sqrt(c * Sigma_xx) by +-sqrt(c * Sigma_yy). The reference's
    # circular radius 3 sqrt(lambda_max) over-covers both axes — severely so
    # for the elongated splats trained scenes are full of.
    # 2% margin on the threshold (same headroom as binning.slot_keep): the
    # dropped pixels are provably below ALPHA_MIN even under f32 rounding.
    op_act = gaussians.opacities
    cfac = jnp.clip(
        2.0 * jnp.log(op_act / (0.98 * cfg.ALPHA_MIN)),
        0.0, cfg.GAUSSIAN_EXTENT_SIGMA ** 2,
    )
    ext_x = jnp.ceil(jnp.sqrt(cfac * jnp.maximum(cov2d[..., 0], 0.0)))
    ext_y = jnp.ceil(jnp.sqrt(cfac * jnp.maximum(cov2d[..., 2], 0.0)))
    del radius_f  # superseded by the per-axis extents (always <= 3 sqrt(λmax))
    radius = jnp.where(
        visible, jnp.maximum(ext_x, ext_y), 0.0).astype(jnp.int32)
    rect = projection.tile_rect(
        mean2d, jnp.where(visible, ext_x, 0.0), grid_h, grid_w,
        render_cfg.tile_h, render_cfg.tile_w,
        radius_y=jnp.where(visible, ext_y, 0.0),
    )
    tiles = jnp.where(radius > 0, rect.area(), 0).astype(jnp.int32)
    opacity = jnp.where(visible, gaussians.opacities, 0.0)

    return Preprocessed(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        color=color,
        opacity=opacity,
        radius=radius,
        rect=rect,
        tiles_touched=tiles,
    )
