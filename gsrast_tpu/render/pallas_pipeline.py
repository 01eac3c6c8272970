"""Tile-sorted renderer, Pallas fast path.

Same pipeline as render/tiled.py (the XLA oracle) but the per-tile blend runs
as hand-written Pallas GPU kernels with a custom VJP, exactly as the
reference's CUDA design pairs its forward `renderCUDA` with a (never-written)
backward (/root/reference/apps/gsrast/gscuda/GSCuda.cu:543-677; SURVEY.md
§2.3). The forward saves per-pixel final transmittance and last-contributor
index — the same residuals the reference stores (GSCuda.cu:669-676) — and the
backward replays the blend in reverse from them.

Differentiability layout:
  preprocess (XLA, autodiff)  ->  fused sort-pack (custom VJP: features ride
  the binning sort as payloads; cotangents route back by ONE slot-keyed sort
  + per-tier sums — NO scatter, NO gather)  ->  blend (Pallas custom_vjp
  over per-intersection features)  ->  image assembly (XLA).
Binning is integer structure (stop_gradient), as in the reference where
gradients do not flow through the sort.

Dataflow: `fused_pack` builds the feature rows ELEMENTWISE on the t-major
multi-tier slot grid (a broadcast of count-ranked rows) and lets them ride
the (tile, full-depth) 2-key sort as payloads, so no gather follows the sort.
The legacy two-tier `_gather_sorted` path below serves cfg.tiers=() configs
and the primitive-sharded exchange. The kernels walk each tile's own
segment of the sorted order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as cfg
from ..camera import Camera
from ..ops import binning as binning_ops
from ..ops.preprocess import preprocess
from ..scene.gaussians import ActivatedGaussians
from .dense import RenderOutput
from . import pallas_blend as pb
from .tiled import untile, untile_cf


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def _gather_sorted(feat_nt, sorted_gauss, sorted_slot, heavy_idx, k1, k2):
    """feat_nt (F, N) lane-major feature rows -> (F, C) columns in sorted
    intersection order.

    Forward is a minor-axis gather; the hand-written VJP routes
    per-intersection cotangents back to the two-tier (n, k) slots by SORTING
    them (cotangent rows ride one structure sort keyed on the slot payload)
    and K-summing each tier, in place of the scatter-add XLA autodiff would
    emit. Runs only when differentiating — pure forward rendering pays
    nothing."""
    gidx = jnp.maximum(sorted_gauss, 0)
    live = (sorted_gauss >= 0).astype(jnp.float32)[None, :]
    return feat_nt[:, gidx] * live  # dead slots inert (opacity 0)


def _gather_sorted_fwd(feat_nt, sorted_gauss, sorted_slot, heavy_idx, k1, k2):
    out = _gather_sorted(
        feat_nt, sorted_gauss, sorted_slot, heavy_idx, k1, k2)
    return out, (sorted_slot, heavy_idx, feat_nt.shape[1],
                 sorted_gauss.shape[0])


def _gather_sorted_bwd(k1, k2, res, dfeat):
    sorted_slot, heavy_idx, n, capacity = res
    f = dfeat.shape[0]
    h = heavy_idx.shape[0]
    kh = k2 - k1
    ns = n * k1 + h * kh
    # Sort the cotangent rows by their tiered slot id: position s of the
    # result then holds slot s's cotangent, so the per-Gaussian reduction is
    # a reshape + K-sum per tier (tier 2 lands back on its gaussians with
    # one tiny H-row scatter-add). Slots dropped by the capacity truncation
    # sit at sort positions >= capacity and carry the appended zero columns;
    # padded sentinel slots (value ns) sort past every real slot and fall
    # off the [:ns] trim. Dead slots within capacity carry exactly-zero
    # cotangents (the blend backward masks foreign/sentinel lanes and
    # zero-fills dead chunks). The (F, C) layout makes the payload rows free
    # slices — no transpose anywhere.
    pad = jnp.zeros((f, sorted_slot.shape[0] - capacity), dfeat.dtype)
    dp = jnp.concatenate([dfeat, pad], axis=1)
    ops = (sorted_slot,) + tuple(dp[i] for i in range(f))
    out = jax.lax.sort(ops, dimension=0, num_keys=1, is_stable=True)
    d_slots = jnp.stack(out[1:], axis=0)[:, :ns]  # (F, ns)

    def ksum(x, k):
        # Strided windowed sum along the flat minor axis.
        return jax.lax.reduce_window(
            x, 0.0, jax.lax.add, window_dimensions=(1, k),
            window_strides=(1, k), padding="VALID",
        )

    d_nt = ksum(d_slots[:, : n * k1], k1)
    if h > 0:
        d2 = ksum(d_slots[:, n * k1:], kh)
        # heavy_idx is padded with N: out-of-bounds adds drop.
        d_nt = d_nt.at[:, heavy_idx].add(d2, mode="drop")
    return d_nt, None, None, None


_gather_sorted.defvjp(_gather_sorted_fwd, _gather_sorted_bwd)


def feature_rows(prep) -> jax.Array:
    """Per-gaussian screen features as (9, N) rows (the kernels'
    feature-row order, see pallas_blend rows 0:9)."""
    return jnp.stack(
        [
            prep.mean2d[:, 0], prep.mean2d[:, 1],          # rows 0:2
            prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2],  # 2:5
            prep.opacity,                                  # row 5
            prep.color[:, 0], prep.color[:, 1], prep.color[:, 2],  # 6:9
        ],
        axis=0,
    )


def _fused_pack_impl(feat_nt, tile_key, depth_key, slot, gauss, order,
                     tiers, n, num_tiles, need_slot=True):
    """`need_slot=False`: pure-forward renders (the viewer path) drop
    the slot payload from the sort — it exists only to route cotangents in
    the VJP."""
    dims, _ = binning_ops.tier_dims(n, tiers)
    s = tile_key.shape[0]
    ranked = feat_nt[:, order]  # (9, N) count-ranked
    # T-major tier blocks: a broadcast along a NEW MIDDLE axis — contiguous
    # row copies, no relayout.
    parts = [
        jnp.broadcast_to(ranked[:, None, :b_j], (9, w_j, b_j))
        .reshape(9, w_j * b_j)
        for (w_j, b_j, _off) in dims
    ]
    grid_feat = jnp.concatenate(parts, axis=1)
    s0 = grid_feat.shape[1]
    if s > s0:
        grid_feat = jnp.concatenate(
            [grid_feat, jnp.zeros((9, s - s0), grid_feat.dtype)], axis=1)
    # num_keys=3: (tile, FULL 32-bit depth, gaussian id) — the reference's
    # 64-bit tile|depth ordering (GSCuda.cu:461-474) with equal depths
    # blended in gaussian-id order. The slot order (a count ranking) would
    # break such ties differently on every tile-sharded device, and the
    # sharded renders would then disagree with this one.
    maybe_slot = (slot,) if need_slot else ()
    ops = (tile_key, depth_key, gauss) + maybe_slot + tuple(
        grid_feat[i] for i in range(9))
    out = jax.lax.sort(ops, dimension=0, num_keys=3, is_stable=True)
    tile = out[0]
    sslot = out[3] if need_slot else None
    base = 4 if need_slot else 3
    tile_starts = jnp.searchsorted(
        tile, jnp.arange(num_tiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    feat_packed = pack_sorted_features(jnp.stack(out[base:], axis=0))
    return feat_packed, tile_starts, sslot


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8))
def fused_pack(feat_nt, tile_key, depth_key, slot, gauss, order, tiers, n,
               num_tiles):
    """Multi-tier fused sort-pack: the 9 feature rows ride the binning
    sort as payloads, built ELEMENTWISE on the tier grid (a broadcast of the
    count-ranked per-gaussian rows — no gather anywhere in the forward).

    Replaces build_binning's sort + the separate sorted-order feature gather.
    The multi-tier grid keeps the sort's row count near the true
    intersection count. The reference does the equivalent with one CUB
    radix sort over (tile|depth) keys + payload indices (GSCuda.cu:791-797)
    and gathers features per-pixel inside the blend.

    Returns (feat_packed (FROWS, S), tile_starts (T+1,)). `gauss` is the
    third sort key: equal depths blend in gaussian-id order on every path
    (the oracle and the sharded paths sort the same three keys). Backward: cotangent rows are routed back to
    the tier grid by ONE sort keyed on the slot payload (no scatter),
    reduced per tier by sublane-axis sums (t-major tiers), accumulated
    across tiers by SLICE adds (tiers are nested prefixes of the ranking),
    and un-ranked by one more N-row sort."""
    feat_packed, tile_starts, _sslot = _fused_pack_impl(
        feat_nt, tile_key, depth_key, slot, gauss, order, tiers, n,
        num_tiles, need_slot=False)
    return feat_packed, tile_starts


def _fused_pack_fwd(feat_nt, tile_key, depth_key, slot, gauss, order, tiers,
                    n, num_tiles):
    feat_packed, tile_starts, sslot = _fused_pack_impl(
        feat_nt, tile_key, depth_key, slot, gauss, order, tiers, n,
        num_tiles)
    return (feat_packed, tile_starts), (sslot, order)


def _fused_pack_bwd(tiers, n, num_tiles, res, cots):
    sslot, order = res
    d_packed, _d_starts = cots
    dims, _ = binning_ops.tier_dims(n, tiers)
    # Route cotangents back to tier-grid order by sorting them by slot id
    # (no scatter — see _gather_sorted).
    ops = (sslot,) + tuple(d_packed[i] for i in range(9))
    routed = jax.lax.sort(ops, dimension=0, num_keys=1, is_stable=True)
    dg = jnp.stack(routed[1:], axis=0)  # (9, S) in slot order

    d_ranked = jnp.zeros((9, n), dg.dtype)
    for (w_j, b_j, off_j) in dims:
        # T-major tier: reshape splits the MAJOR axis (free) and the
        # per-gaussian reduction is a sum over that axis.
        d_tier = jnp.sum(
            dg[:, off_j: off_j + b_j * w_j].reshape(9, w_j, b_j), axis=1)
        # Nested prefixes: tier j's rows are ranks [0, b_j) — slice add
        # (tier 0 may itself be budgeted < n on the tile-sharded path).
        d_ranked = d_ranked.at[:, :b_j].add(d_tier)
    # Un-rank: one more N-row sort keyed on the original index payload.
    ops2 = (order,) + tuple(d_ranked[i] for i in range(9))
    unranked = jax.lax.sort(ops2, dimension=0, num_keys=1, is_stable=True)
    d_feat_nt = jnp.stack(unranked[1:], axis=0)
    zi = lambda a: np.zeros(a.shape, jax.dtypes.float0)
    return (d_feat_nt, zi(sslot), zi(sslot), zi(sslot), zi(sslot),
            zi(order))


fused_pack.defvjp(_fused_pack_fwd, _fused_pack_bwd)


def pack_features(prep, binning: binning_ops.Binning,
                  render_cfg: cfg.RenderConfig) -> jax.Array:
    """Gather per-Gaussian screen state into the kernels' (FROWS, C)
    layout, row f = feature f of every sorted intersection (see
    pallas_blend module docstring). Rows are stacked from preprocess
    outputs and gathered along the minor axis."""
    k2 = render_cfg.max_tiles_per_gaussian
    k1 = min(render_cfg.base_tiles_per_gaussian, k2)
    feat_nt = feature_rows(prep)
    feat = _gather_sorted(
        feat_nt, binning.sorted_gauss, binning.sorted_slot, binning.heavy_idx,
        k1, k2,
    )  # (9, C)
    return pack_sorted_features(feat)


def pack_sorted_features(feat_t: jax.Array) -> jax.Array:
    """(9, C) per-intersection feature rows already in sorted order -> the
    kernels' (FROWS, C) layout (zero rows appended). Used directly by the
    primitive-sharded path, where features arrive through the all_to_all
    exchange instead of a local per-Gaussian gather."""
    c = feat_t.shape[1]
    return jnp.concatenate(
        [feat_t, jnp.zeros((pb.FROWS - feat_t.shape[0], c), jnp.float32)],
        axis=0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7, 8))
def _blend(feat_packed, tile_starts, tile_map, grid_h, grid_w, tile_h,
           tile_w, interpret, num_tiles):
    out = pb.blend_forward(
        feat_packed, tile_starts, grid_h, grid_w, tile_h, tile_w, interpret,
        num_tiles=num_tiles, tile_map=tile_map,
    )
    # Channel-first (T, 3, P) slice of the (T, 8, P) kernel output.
    rgb = out[:, pb.OC_R : pb.OC_B + 1, :]
    ft = out[:, pb.OC_FT, :]
    nc = out[:, pb.OC_NC, :].astype(jnp.int32)
    return rgb, ft, nc


def _blend_fwd(feat_packed, tile_starts, tile_map, grid_h, grid_w, tile_h,
               tile_w, interpret, num_tiles):
    rgb, ft, nc = _blend(
        feat_packed, tile_starts, tile_map, grid_h, grid_w, tile_h, tile_w,
        interpret, num_tiles,
    )
    return (rgb, ft, nc), (feat_packed, tile_starts, tile_map, ft, nc)


def _blend_bwd(grid_h, grid_w, tile_h, tile_w, interpret, num_tiles_s,
               res, cots):
    feat_packed, tile_starts, tile_map, ft, nc = res
    d_rgb, d_ft, _d_nc = cots  # n_contrib is integer output: no gradient
    num_tiles, p = ft.shape
    aux = jnp.concatenate(
        [
            d_rgb,                       # rows 0:3 (T, 3, P)
            d_ft[:, None, :],            # row 3
            ft[:, None, :],              # row 4
            nc.astype(jnp.float32)[:, None, :],  # row 5
            jnp.zeros((num_tiles, 2, p), jnp.float32),
        ],
        axis=1,
    )
    dfeat = pb.blend_backward(
        feat_packed, tile_starts, aux, grid_h, grid_w, tile_h, tile_w,
        interpret, num_tiles=num_tiles_s, tile_map=tile_map,
    )
    d_starts = np.zeros(tile_starts.shape, jax.dtypes.float0)
    d_map = np.zeros(tile_map.shape, jax.dtypes.float0)
    return dfeat, d_starts, d_map


_blend.defvjp(_blend_fwd, _blend_bwd)


def render_tiled_pallas(
    gaussians: ActivatedGaussians,
    camera: Camera,
    render_cfg: cfg.RenderConfig = cfg.RenderConfig(),
    mean2d_delta=None,
) -> RenderOutput:
    tile_h, tile_w = render_cfg.tile_h, render_cfg.tile_w
    pb.check_tile_shape(tile_h, tile_w)
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    num_tiles = grid_h * grid_w
    capacity = render_cfg.capacity(gaussians.means.shape[0])
    interpret = render_cfg.interpret

    prep = preprocess(gaussians, camera, render_cfg, mean2d_delta)
    if render_cfg.tiers:
        n = gaussians.means.shape[0]
        plan = binning_ops.plan_tiers(
            jax.lax.stop_gradient(prep), grid_h, grid_w, render_cfg)
        feat_nt = feature_rows(prep)
        feat_packed, tile_starts = fused_pack(
            feat_nt, plan.tile_key, plan.depth_key, plan.slot, plan.gauss,
            plan.order, render_cfg.tiers, n, num_tiles)
        bin_stats = {
            "num_intersections": plan.total,
            "overflow_capacity": jnp.int32(0),  # no capacity truncation
            "overflow_tile_cap": plan.overflow_tile_cap,
        }
    else:
        binning = binning_ops.build_binning(
            jax.lax.stop_gradient(prep), grid_h, grid_w, render_cfg, capacity
        )
        feat_packed = pack_features(prep, binning, render_cfg)
        tile_starts = binning.tile_starts
        bin_stats = {
            "num_intersections": binning.num_intersections,
            "overflow_capacity": binning.overflow_capacity,
            "overflow_tile_cap": binning.overflow_tile_cap,
        }
    rgb_tiles, ft_tiles, nc_tiles = _blend(
        feat_packed, tile_starts, jnp.array([0, 1], jnp.int32),
        grid_h, grid_w, tile_h, tile_w, interpret, num_tiles,
    )

    background = jnp.asarray(render_cfg.background, jnp.float32)
    image_cf = untile_cf(rgb_tiles, grid_h, grid_w, render_cfg,
                         camera.height, camera.width)  # (3, H, W)
    final_t = untile(ft_tiles, grid_h, grid_w, render_cfg,
                     camera.height, camera.width)
    n_contrib = untile(nc_tiles, grid_h, grid_w, render_cfg,
                       camera.height, camera.width)
    image_cf = image_cf + final_t[None, :, :] * background[:, None, None]
    # User-facing (H, W, 3) only at the API boundary.
    image = jnp.moveaxis(image_cf, 0, -1)

    stats = {
        "num_visible": jnp.sum(prep.radius > 0),
        "overflow_per_tile": jnp.int32(0),  # pallas path walks true ranges
        "radii": prep.radius,
        **bin_stats,
    }
    return RenderOutput(
        image=image, final_t=final_t, n_contrib=n_contrib, stats=stats
    )
