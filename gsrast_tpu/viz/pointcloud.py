"""Point-cloud debug renderer (reference mode 1).

The analog of GSPointCloud (/root/reference/apps/gsrast/
GSPointCloud.cpp:19-48 + shaders/pointcloud/*.glsl): splat centers as
fixed-size points, z-tested, colored 0.2 * SH-DC + 0.5 exactly like the GL
vertex shader (pointcloud/vertex.glsl:13-15). Instead of GL_POINTS we
scatter-min into a z-buffer keyed on depth — the same "depth as sortable
bits" trick the reference's CUDA point mode uses (GSCuda.cu:80-84
atomicMin on float-bits-as-uint).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import config as cfg
from ..camera import Camera
from ..ops import projection
from ..scene.gaussians import ActivatedGaussians


def render_pointcloud(
    gaussians: ActivatedGaussians,
    camera: Camera,
    point_size: int = 2,
    background=(0.0, 0.0, 0.0),
) -> jax.Array:
    """Returns (H, W, 3). `point_size` mirrors glPointSize(2)
    (GSRastWindow.cpp:49)."""
    h, w = camera.height, camera.width
    mean_view = projection.to_camera(gaussians.means, camera.view)
    depth = mean_view[..., 2]
    mean2d, ndc = projection.project(
        gaussians.means, camera.full_projection(), w, h
    )
    visible = projection.in_frustum(depth, ndc) & gaussians.mask

    color = 0.2 * gaussians.sh[:, 0, :] + 0.5  # pointcloud/vertex.glsl:13-15

    px = jnp.round(mean2d[:, 0]).astype(jnp.int32)
    py = jnp.round(mean2d[:, 1]).astype(jnp.int32)

    # z-buffer via scatter-min of packed (depth_bits << 20 | gaussian_id):
    # positive-float bits are order-preserving, so min picks the nearest.
    # We pack into int64-free form: sort by depth instead — scatter in
    # far-to-near order so the nearest point wins the overwrite race.
    order = jnp.argsort(-depth)  # far first
    px, py, color_o = px[order], py[order], color[order]
    vis_o = visible[order]

    img = jnp.broadcast_to(
        jnp.asarray(background, jnp.float32), (h, w, 3)
    ).astype(jnp.float32)
    half = point_size // 2
    for dy in range(-half, point_size - half):
        for dx in range(-half, point_size - half):
            xx = px + dx
            yy = py + dy
            ok = vis_o & (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            flat = jnp.where(ok, yy * w + xx, h * w)
            img = img.reshape(h * w, 3).at[flat].set(
                color_o, mode="drop"
            ).reshape(h, w, 3)
    return jnp.clip(img, 0.0, 1.0)
