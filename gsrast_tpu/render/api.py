"""Top-level render entry point.

The analog of the reference's mode dispatch (RenderSelector +
GSGaussians::draw, /root/reference/apps/gsrast/GSGaussians.cpp:155-212) as a
pure function: `render(scene, camera, config)` returns the image plus
auxiliary state; the backend field selects the XLA path (differentiable
oracle) or the Pallas fast path.
"""

from __future__ import annotations

from typing import Union

from .. import config as cfg
from ..camera import Camera
from ..scene.gaussians import ActivatedGaussians, GaussianScene
from .dense import RenderOutput, render_dense
from .pallas_blend import MAX_TILE_PIXELS
from .tiled import render_tiled_xla


def default_backend(platform: str | None = None) -> str:
    """The render backend for a JAX platform (default: the current one):
    the compiled pallas kernels on a GPU, the XLA path on the CPU. Any other
    platform is an error, never a silent fallback."""
    import jax

    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no render backend for platform {platform!r}")


def scene_tile_counts(scene, camera: Camera, render_cfg: cfg.RenderConfig):
    """Per-Gaussian owned-tile counts from one preprocess pass (numpy)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..ops.preprocess import preprocess

    if isinstance(scene, GaussianScene):
        scene = scene.activated()
    grid_h, _ = render_cfg.grid_shape(camera.height, camera.width)
    prep = jax.jit(
        lambda a: preprocess(a, camera, render_cfg), static_argnums=()
    )(scene)
    rect = prep.rect
    rw = jnp.maximum(rect.x_max - rect.x_min, 0)
    nrows = jnp.maximum(
        jnp.minimum(rect.y_max, grid_h) - jnp.maximum(rect.y_min, 0), 0)
    counts = jnp.where(prep.radius > 0, nrows * rw, 0)
    return np.asarray(jax.device_get(counts))


def auto_render_config(
    scene,
    camera: Camera,
    backend: str | None = None,
    base: cfg.RenderConfig | None = None,
    margin: float = 1.12,
    auto_tile_w: bool = True,
) -> cfg.RenderConfig:
    """THE product-default RenderConfig for (scene, camera): the fused
    multi-tier pipeline with its binning spec derived from the scene's own
    measured tile-count distribution (one preprocess pass ->
    ops.binning.auto_tiers), and the tile shape picked by the big-splat
    heuristic (mean tiles/gaussian > 8 -> double the tile width, halving
    big-rect tile counts). This is what `python -m gsrast_tpu render/train`
    runs — no hand-set K knobs anywhere in the user-facing flows.
    `margin` is budget headroom for view/scene drift (training passes a
    larger one because densification reshapes the count distribution);
    overflow beyond it is counted in RenderStats, never silent."""
    import numpy as np

    from ..ops import binning as binning_ops

    if backend is None:
        backend = default_backend()
    rcfg = base if base is not None else cfg.RenderConfig()
    # Legacy-path knobs stay as counted fallbacks for cfg.tiers=() callers.
    rcfg = rcfg.replace(
        backend=backend, max_tiles_per_gaussian=512, heavy_fraction=0.5)
    counts = scene_tile_counts(scene, camera, rcfg)
    mean_c = float(counts.mean()) if counts.size else 0.0
    # Big-splat scenes (trained scenes grow splats spanning many tiles):
    # keep doubling the tile AREA while the mean owned-tile count stays
    # high. Sort rows scale with tiles/gaussian; the blend kernels take
    # tiles up to pallas_blend.MAX_TILE_PIXELS.
    while (auto_tile_w and mean_c > 8.0
           and rcfg.tile_h * rcfg.tile_w < MAX_TILE_PIXELS):
        if rcfg.tile_w <= rcfg.tile_h * 2:
            rcfg = rcfg.replace(tile_w=rcfg.tile_w * 2)
        else:
            rcfg = rcfg.replace(tile_h=rcfg.tile_h * 2)
        counts = scene_tile_counts(scene, camera, rcfg)
        mean_c = float(counts.mean()) if counts.size else 0.0
    return rcfg.replace(
        tiers=binning_ops.auto_tiers(np.asarray(counts), margin=margin))


def render(
    scene: Union[GaussianScene, ActivatedGaussians],
    camera: Camera,
    render_cfg: cfg.RenderConfig = cfg.RenderConfig(),
    mean2d_delta=None,
) -> RenderOutput:
    if isinstance(scene, GaussianScene):
        scene = scene.activated()
    if render_cfg.backend == "xla":
        return render_tiled_xla(scene, camera, render_cfg, mean2d_delta)
    if render_cfg.backend == "dense":
        return render_dense(scene, camera, render_cfg)
    if render_cfg.backend == "pallas":
        from .pallas_pipeline import render_tiled_pallas

        return render_tiled_pallas(scene, camera, render_cfg, mean2d_delta)
    raise ValueError(f"unknown backend {render_cfg.backend!r}")
