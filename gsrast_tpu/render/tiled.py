"""Tile-sorted renderer, pure-XLA path.

The full pipeline of the reference's `gscuda::forward`
(/root/reference/apps/gsrast/gscuda/GSCuda.cu:695-811) as one jittable,
end-to-end differentiable function: preprocess -> binning (non-differentiable
integer structure, like the reference's sort) -> per-tile front-to-back blend.

The blend evaluates the reference's sequential recurrence (GSCuda.cu:543-677)
in closed form via a cumulative product along the per-tile depth-sorted axis
(see render/dense.py for the derivation), batched over tiles, so XLA autodiff
provides exact gradients — the correctness baseline for the hand-written
Pallas kernels.

Static-shape policy: per-tile work is capped at `max_per_tile` intersections
(overflow counted in stats; the Pallas path walks true ranges uncapped).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .. import config as cfg
from ..camera import Camera
from ..ops import binning as binning_ops
from ..ops.preprocess import Preprocessed, preprocess
from ..scene.gaussians import ActivatedGaussians
from .dense import RenderOutput


def tile_pixel_coords(render_cfg: cfg.RenderConfig) -> Tuple[jax.Array, jax.Array]:
    """Intra-tile pixel offsets, flattened row-major: (P,), (P,)."""
    th, tw = render_cfg.tile_h, render_cfg.tile_w
    ys = jnp.arange(th, dtype=jnp.float32)
    xs = jnp.arange(tw, dtype=jnp.float32)
    py, px = jnp.meshgrid(ys, xs, indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def blend_tiles_xla(
    prep: Preprocessed,
    binning: binning_ops.Binning,
    grid_h: int,
    grid_w: int,
    render_cfg: cfg.RenderConfig,
    num_local_rows: int | None = None,
    row0=0,
    row_stride: int = 1,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Blend all tiles. Returns (tiles_rgb (T, P, 3), final_t (T, P),
    n_contrib (T, P), overflow_per_tile_cap scalar).

    `num_local_rows`/`row0`/`row_stride` support the tile-sharded path: this
    rank blends local tiles [0, num_local_rows * grid_w) whose GLOBAL tile
    row (for pixel coordinates) is row0 + local_row * row_stride.
    """
    # Per-intersection state in sorted order (gather; transposes to
    # scatter-add in the backward pass automatically).
    gidx = jnp.maximum(binning.sorted_gauss, 0)
    s_mean2d = prep.mean2d[gidx]
    s_conic = prep.conic[gidx]
    s_color = prep.color[gidx]
    s_opacity = jnp.where(binning.sorted_gauss >= 0, prep.opacity[gidx], 0.0)
    return blend_sorted_xla(
        s_mean2d, s_conic, s_color, s_opacity, binning.tile_starts,
        grid_h, grid_w, render_cfg, num_local_rows, row0, row_stride,
    )


def blend_sorted_xla(
    s_mean2d: jax.Array,   # (C, 2) per-intersection, (tile|depth)-sorted
    s_conic: jax.Array,    # (C, 3)
    s_color: jax.Array,    # (C, 3)
    s_opacity: jax.Array,  # (C,) 0 for dead slots
    tile_starts: jax.Array,  # (T+1,)
    grid_h: int,
    grid_w: int,
    render_cfg: cfg.RenderConfig,
    num_local_rows: int | None = None,
    row0=0,
    row_stride: int = 1,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Core of `blend_tiles_xla` over pre-gathered per-intersection features
    (the primitive-sharded path receives features via all_to_all rather than
    gathering them from a local Preprocessed)."""
    num_tiles = (grid_h if num_local_rows is None else num_local_rows) * grid_w
    row0 = jnp.asarray(row0, jnp.int32)
    k_tile = render_cfg.max_per_tile
    tile_chunk = render_cfg.tile_chunk
    background = jnp.asarray(render_cfg.background, jnp.float32)

    starts = tile_starts[:-1]
    ends = tile_starts[1:]
    counts = ends - starts
    overflow = jnp.sum(jnp.maximum(counts - k_tile, 0))

    px_off, py_off = tile_pixel_coords(render_cfg)  # (P,)
    p = px_off.shape[0]
    capacity = s_opacity.shape[0]

    num_chunks = -(-num_tiles // tile_chunk)

    def do_chunk(chunk_idx):
        t0 = chunk_idx * tile_chunk
        tids = jnp.minimum(t0 + jnp.arange(tile_chunk), num_tiles - 1)
        # Local tile -> global tile row/col (row-based ownership).
        ty = row0 + (tids // grid_w) * row_stride
        tx = tids % grid_w
        # (TC, P) absolute pixel centers
        pix_x = tx[:, None] * render_cfg.tile_w + px_off[None, :]
        pix_y = ty[:, None] * render_cfg.tile_h + py_off[None, :]

        take = starts[tids][:, None] + jnp.arange(k_tile)[None, :]  # (TC, K)
        in_range = take < ends[tids][:, None]
        take_c = jnp.minimum(take, capacity - 1)
        mean2d = s_mean2d[take_c]    # (TC, K, 2)
        conic = s_conic[take_c]      # (TC, K, 3)
        color = s_color[take_c]      # (TC, K, 3)
        opacity = jnp.where(in_range, s_opacity[take_c], 0.0)  # (TC, K)

        dx = mean2d[..., 0:1] - pix_x[:, None, :]  # (TC, K, P)
        dy = mean2d[..., 1:2] - pix_y[:, None, :]
        ca, cb, cc = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = jnp.minimum(
            cfg.ALPHA_MAX, opacity[..., None] * jnp.exp(power)
        )
        valid = in_range[..., None] & (power <= 0.0) & (alpha >= cfg.ALPHA_MIN)
        alpha_eff = jnp.where(valid, alpha, 0.0)

        p_cum = jnp.cumprod(1.0 - alpha_eff, axis=1)  # along K
        t_before = jnp.concatenate(
            [jnp.ones_like(p_cum[:, :1]), p_cum[:, :-1]], axis=1
        )
        include = p_cum >= cfg.TRANSMITTANCE_MIN
        w = jnp.where(include & valid, alpha_eff * t_before, 0.0)  # (TC, K, P)
        rgb = jnp.einsum(
            "tkp,tkc->tpc", w, color, precision=jax.lax.Precision.HIGHEST
        )

        final_t = jnp.min(
            jnp.where(include, p_cum, jnp.inf), axis=1, initial=1.0
        )
        final_t = jnp.minimum(final_t, 1.0)
        rgb = rgb + final_t[..., None] * background[None, None, :]

        # n_contrib (r5 definition, shared by every backend): the count of
        # blend positions before saturation — include=True positions within
        # the tile's real segment. The reference reports the last position
        # with a nonzero contribution instead (GSCuda.cu:671); the count is
        # what the backward replay gate needs and is computable without a
        # lane reduction in the Pallas fast path (pallas_blend.py).
        n_contrib = jnp.sum(
            (include & in_range[..., None]).astype(jnp.int32), axis=1
        )
        return rgb, final_t, n_contrib

    tiles_rgb, final_t, n_contrib = jax.lax.map(
        do_chunk, jnp.arange(num_chunks)
    )
    tiles_rgb = tiles_rgb.reshape(num_chunks * render_cfg.tile_chunk, p, 3)
    final_t = final_t.reshape(num_chunks * render_cfg.tile_chunk, p)
    n_contrib = n_contrib.reshape(num_chunks * render_cfg.tile_chunk, p)
    return (
        tiles_rgb[:num_tiles],
        final_t[:num_tiles],
        n_contrib[:num_tiles],
        overflow,
    )


def untile(tiles: jax.Array, grid_h: int, grid_w: int,
           render_cfg: cfg.RenderConfig, height: int, width: int) -> jax.Array:
    """(T, P, ...) tile-major -> (height, width, ...) image, cropped."""
    th, tw = render_cfg.tile_h, render_cfg.tile_w
    trailing = tiles.shape[2:]
    img = tiles.reshape((grid_h, grid_w, th, tw) + trailing)
    img = jnp.moveaxis(img, 2, 1)  # (gh, th, gw, tw, ...)
    img = img.reshape((grid_h * th, grid_w * tw) + trailing)
    return img[:height, :width]


def untile_cf(tiles: jax.Array, grid_h: int, grid_w: int,
              render_cfg: cfg.RenderConfig, height: int,
              width: int) -> jax.Array:
    """(T, ch, P) channel-first tiles -> (ch, height, width); callers
    transpose to the user-facing (H, W, ch) only at the API boundary."""
    th, tw = render_cfg.tile_h, render_cfg.tile_w
    ch = tiles.shape[1]
    img = tiles.reshape(grid_h, grid_w, ch, th, tw)
    img = jnp.transpose(img, (2, 0, 3, 1, 4))  # (ch, gh, th, gw, tw)
    img = img.reshape(ch, grid_h * th, grid_w * tw)
    return img[:, :height, :width]


def render_tiled_xla(
    gaussians: ActivatedGaussians,
    camera: Camera,
    render_cfg: cfg.RenderConfig = cfg.RenderConfig(),
    mean2d_delta=None,
) -> RenderOutput:
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    capacity = render_cfg.capacity(gaussians.means.shape[0])

    prep = preprocess(gaussians, camera, render_cfg, mean2d_delta)
    if render_cfg.tiers:
        # Multi-tier fused structure (r4): the SAME plan and the same
        # (tile, depth, gaussian id) order the pallas path consumes.
        plan = binning_ops.plan_tiers(
            jax.lax.stop_gradient(prep), grid_h, grid_w, render_cfg)
        tile, _sd, sgauss = jax.lax.sort(
            (plan.tile_key, plan.depth_key, plan.gauss), dimension=0,
            num_keys=3, is_stable=True)
        tile_starts = jnp.searchsorted(
            tile, jnp.arange(grid_h * grid_w + 1, dtype=jnp.int32),
            side="left").astype(jnp.int32)
        binning = binning_ops.Binning(
            # sorted_slot is NOT the per-sorted-position slot payload on this
            # path (the fused sort was not run with it); blend_tiles_xla
            # never reads it, so store an explicitly empty array rather than
            # an identity iota a future consumer could mistake for the real
            # permutation.
            sorted_tile=tile, sorted_gauss=sgauss,
            sorted_slot=jnp.zeros((0,), jnp.int32),
            heavy_idx=jnp.zeros((0,), jnp.int32), tile_starts=tile_starts,
            num_intersections=plan.total,
            overflow_capacity=jnp.int32(0),
            overflow_tile_cap=plan.overflow_tile_cap,
        )
    else:
        binning = binning_ops.build_binning(
            jax.lax.stop_gradient(prep), grid_h, grid_w, render_cfg, capacity
        )
    tiles_rgb, final_t, n_contrib, overflow_tile = blend_tiles_xla(
        prep, binning, grid_h, grid_w, render_cfg
    )
    image = untile(tiles_rgb, grid_h, grid_w, render_cfg,
                   camera.height, camera.width)
    final_t_img = untile(final_t, grid_h, grid_w, render_cfg,
                         camera.height, camera.width)
    n_contrib_img = untile(n_contrib, grid_h, grid_w, render_cfg,
                           camera.height, camera.width)
    stats = {
        "num_visible": jnp.sum(prep.radius > 0),
        "num_intersections": binning.num_intersections,
        "overflow_capacity": binning.overflow_capacity,
        "overflow_tile_cap": binning.overflow_tile_cap,
        "overflow_per_tile": overflow_tile,
        "radii": prep.radius,
    }
    return RenderOutput(
        image=image, final_t=final_t_img, n_contrib=n_contrib_img, stats=stats
    )
