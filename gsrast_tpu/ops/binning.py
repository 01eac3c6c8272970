"""Tile binning: duplicate-with-keys, global sort, tile range extraction.

The replacement for the reference's binning pipeline
(/root/reference/apps/gsrast/gscuda/GSCuda.cu:422-538, 771-801):

  reference (CUDA)                        this module (XLA)
  --------------------------------        --------------------------------
  cub InclusiveSum(tilesTouched)          (folded into the sort below)
  numRendered readback sizes buffer       static capacity + overflow counters
  duplicateWithKeys (scatter at offset)   full (N, K) slot grid built
                                          ELEMENTWISE (zero gathers); invalid
                                          slots get sentinel keys
  cub RadixSort of tile<<32|depthbits     ONE lax.sort of a single packed
                                          int32 key `tile << depth_bits |
                                          depth_top_bits` with the flat slot
                                          index as payload (the reference
                                          packs tile|depth into 64 bits the
                                          same way, GSCuda.cu:461-474; we
                                          budget 31 bits: full-precision
                                          depth ordering within ~2^-16
                                          relative, ties broken by slot)
  identifyTileRanges                      searchsorted over the sorted tiles
  (no backward pass in reference)         the feature-pack VJP inverts the
                                          sort permutation (second structure
                                          sort, run lazily ONLY when
                                          differentiating) so cotangents
                                          route back to (n, k) slots with a
                                          GATHER + K-sum — no scatter
                                          anywhere in the training step

Why a static (N, K) grid and not a compacted variable-length expansion: the
grid builds every key ELEMENTWISE from per-Gaussian arrays (no scatters and
no gathers) and lets one sort both compact (sentinels sink past the capacity
truncation) and order, where an expansion needs a binary search or a
scatter per slot. (Both designs were chosen on the previous accelerator;
ROADMAP Queue 1 re-measures them on the GPU.) K is a *counted* forward cap
(overflow_tile_cap, no silent drops); callers size it per scene
(RenderConfig.max_tiles_per_gaussian; the bench scene's true max is 16).

Tile ownership across devices is BY TILE ROW: a device owns tile rows
{row0 + r * row_stride}. Row ownership keeps the owned-tile count of a
clipped rect a closed-form product (rows_owned * rect_width), so the sharded
path enumerates *only its own* intersections — enumerate-then-filter would
waste a D-fold slice of the grid on foreign tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import config as cfg
from . import projection
from .preprocess import Preprocessed


class Binning(NamedTuple):
    sorted_tile: jax.Array    # (C,) int32; sentinel = num_local_tiles
    sorted_gauss: jax.Array   # (C,) int32 gaussian index; -1 for dead slots
    sorted_slot: jax.Array    # (max(S, C),) int32 full sort payload: tiered
                              # slot id per sorted position (see build_binning
                              # for the numbering). The feature pack's VJP
                              # routes cotangents back through it; positions
                              # >= C were dropped by the capacity truncation.
    heavy_idx: jax.Array      # (H,) int32 gaussians granted a tier-2 row
                              # (padded with N); (0,) when single-tier
    tile_starts: jax.Array    # (T+1,) int32 half-open ranges per local tile
    num_intersections: jax.Array  # scalar int32 (actually written, <= C)
    overflow_capacity: jax.Array  # scalar int32: intersections dropped (C full)
    overflow_tile_cap: jax.Array  # scalar int32: owned tiles dropped by the
                                  # K cap or the heavy budget (counted,
                                  # never silent)


def owned_row_range(y_min, y_max, row0, row_stride: int, num_rows: int):
    """Rows {row0 + r*row_stride : 0 <= r < num_rows} ∩ [y_min, y_max) as
    (first owned row y0, count). Closed-form — this is why ownership is by
    row: the owned-tile count of a rect stays `rows * rect_width`."""
    y_lo = jnp.maximum(y_min, row0)
    y_hi = jnp.minimum(y_max, row0 + num_rows * row_stride)
    y0 = y_lo + (row0 - y_lo) % row_stride
    nrows = jnp.maximum(0, (y_hi - y0 + row_stride - 1) // row_stride)
    return y0, nrows


def expand_intersections(counts: jax.Array, capacity: int):
    """Variable-length expansion: slot j of [0, capacity) -> (gaussian i,
    within-gaussian ordinal k) via one vectorized binary search — the
    duplicateWithKeys analog (GSCuda.cu:422-475) without a scatter.

    Exact (no per-Gaussian cap), but a binary search per slot: the
    legacy primitive-sharded routing (tiers=()) uses it; the single-device
    hot path uses the elementwise slot grids instead.

    Returns (i (C,), k (C,), offsets (N,), total scalar)."""
    offsets = jnp.cumsum(counts) - counts  # exclusive scan, (N,)
    total = offsets[-1] + counts[-1]
    j = jnp.arange(capacity, dtype=jnp.int32)
    i = (
        jnp.searchsorted(offsets, j, side="right", method="scan_unrolled")
        .astype(jnp.int32)
        - 1
    )
    i = jnp.maximum(i, 0)
    k = j - offsets[i]
    return i, k, offsets.astype(jnp.int32), total.astype(jnp.int32)


class TierPlan(NamedTuple):
    """Integer structure of the multi-tier fused binning (r4).

    Slots are numbered over a COUNT-RANKED gaussian order (`order`), T-MAJOR
    within each tier: tier j covers tile ordinals k_{j-1}..k_j of the B_j
    top-ranked gaussians (a PREFIX of the ranking — nested prefixes mean the
    backward's per-tier reductions are slice-adds, never scatters), and slot
    (rank r, ordinal t) = off_j + (t - k_{j-1})*B_j + r. T-major keeps every
    tier grid a (w_j, B_j) array with the LARGE axis in lanes: no minor-dim
    padding, per-rank fields broadcast along a middle axis for free, and the
    VJP's per-gaussian reduction is a sublane-axis sum. All arrays are
    stop-gradient integer structure, like the reference's sort
    (GSCuda.cu:461-538).
    """

    tile_key: jax.Array   # (S,) int32 local tile id; num_tiles = dead slot
    depth_key: jax.Array  # (S,) int32 FULL positive-float depth bits — the
                          # fused sort uses num_keys=2 (tile, depth), i.e.
                          # the reference's full-precision 64-bit tile|depth
                          # ordering (GSCuda.cu:461-474) with no quantized-
                          # depth ties (r1-r3 packed both into 31 bits)
    slot: jax.Array    # (S,) int32 tiered slot id (== position: iota)
    gauss: jax.Array   # (S,) int32 original gaussian index; -1 dead
    order: jax.Array   # (N,) int32 count-descending gaussian ranking
    total: jax.Array   # scalar int32: true (post-cull) intersections
    overflow_tile_cap: jax.Array  # scalar int32 tiles dropped by k_last cap
                                  # or a tier budget (counted, never silent)


def tier_dims(n: int, tiers) -> tuple:
    """Static per-tier (width w_j, rows B_j, slot offset off_j). Budgets are
    lane-rounded, clamped to n and to nesting (non-increasing). Tier 0 with
    frac >= 1 covers every gaussian; a budgeted tier 0 (frac < 1, used by the
    tile-sharded path where most gaussians own no tile on a given device)
    drops low-ranked gaussians entirely — counted, never silent."""
    dims = []
    off = 0
    prev_b = n
    prev_k = 0
    for j, (k, frac) in enumerate(tiers):
        assert k > prev_k, f"tier ks must ascend, got {tiers}"
        if j == 0 and frac >= 1.0:
            b = n
        else:
            b = min(n, max(128, -(-int(n * frac) // 128) * 128), prev_b)
        dims.append((k - prev_k, b, off))
        off += (k - prev_k) * b
        prev_b, prev_k = b, k
    return tuple(dims), off


def shard_tiers(tiers, n_dev: int) -> tuple:
    """Per-device tier spec for tile sharding: the single-device widths and
    budgets, with tier 0 taking every Gaussian a device receives. A device
    owns a subset of each Gaussian's tile rows, so no Gaussian needs more
    slots on one device than on all of them together; a Gaussian whose rect
    spans fewer rows than there are devices keeps its whole count on the
    device that owns its rows, so the widths cannot shrink with the device
    count. Per-device sort volume is therefore that of one device. Drops are
    counted by plan_tiers, never silent."""
    if n_dev <= 1:
        return tuple(tiers)
    return tuple((k, max(f, 1.0) if i == 0 else f)
                 for i, (k, f) in enumerate(tiers))


def auto_tiers(counts, margin: float = 1.12, k0_max: int = 4,
               tier_penalty: float = 0.08):
    """Derive a near-minimal tier spec from a scene's per-Gaussian tile-count
    distribution (host-side; counts is a numpy array from one preprocess
    pass). Minimizes total slot volume S = sum_j w_j * B_j over tier cut
    points by shortest path on the candidate k grid, with `margin` headroom
    on every budget so skewed views don't overflow. Replaces the hand-picked
    per-scene knobs."""
    import numpy as np

    counts = np.asarray(counts)
    n = max(int(counts.shape[0]), 1)
    cmax = int(counts.max()) if counts.size else 1
    cmax = max(cmax, 1)
    cands = sorted({1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                    192, 256, 384, 512, 768, 1024, cmax})
    cands = [c for c in cands if c <= cmax]
    if cands[-1] != cmax:
        cands.append(cmax)
    # frac(count > k) with headroom; budgets never below one lane row.
    frac = {k: min(1.0, float((counts > k).mean()) * margin + 128.0 / n)
            for k in [0] + cands}
    # Tier 0 is budgeted too (r5): gaussians with count == 0 (culled /
    # out-of-frustum — the majority in trained scenes at many views) get NO
    # slots instead of k0 dead sentinel rows each; the count-descending
    # ranking puts them last, so a frac(count > 0) budget covers every
    # visible gaussian with `margin` headroom (drops counted, never silent).
    f0 = frac[0]
    # dp over cut points: dp[i] = min slot volume covering counts <= cands[i]
    best = {}
    for i, ci in enumerate(cands):
        if ci <= k0_max:
            best[i] = (ci * f0, [(ci, f0)])  # single tier-0 up to k0_max
        else:
            best[i] = (float("inf"), None)
        for j in range(i):
            cj = cands[j]
            if best[j][1] is None:
                continue
            # tier_penalty (in slots/gaussian units) charges each extra
            # tier's fixed cost (grid build, concat, compile) so thin tiers
            # merge away.
            cost = best[j][0] + (ci - cj) * frac[cj] + tier_penalty
            if cost < best[i][0]:
                best[i] = (cost, best[j][1] + [(ci, frac[cj])])
    tiers = best[len(cands) - 1][1]
    # Enforce nesting (non-increasing fracs) — frac is monotone already.
    return tuple((int(k), round(float(f), 4)) for k, f in tiers)


def plan_tiers(
    prep: Preprocessed,
    grid_h: int,
    grid_w: int,
    render_cfg: cfg.RenderConfig,
    num_local_rows: int | None = None,
    row0=0,
    row_stride: int = 1,
    dest_rows: int | None = None,
    n_dest: int = 1,
) -> TierPlan:
    """Multi-tier slot-grid structure for the fused sort-pack path.

    Same job as build_binning's two-tier grid (duplicateWithKeys,
    GSCuda.cu:422-475) but with len(cfg.tiers) residual tiers over ONE
    count-descending ranking of the gaussians, sizing the total slot count S
    near the true intersection count (the sort and the VJP's routing sort
    cost follows the row count). Returns only structure — the feature payloads
    ride the big sort itself (render/pallas_pipeline.fused_pack).

    `dest_rows`/`n_dest` (r5): primitive-sharded routing mode. Tile keys
    become DEST-PREFIXED route keys `(gy // dest_rows) << ltile_bits | local
    tile on that device` (contiguous row ownership, `dest_rows` rows per
    device), so the primitive-sharded exchange groups slots by destination
    device AND orders them with the SAME one sort — replacing the
    searchsorted expansion. Sentinel = n_dest << ltile_bits."""
    tiers = render_cfg.tiers
    assert tiers, "plan_tiers requires cfg.tiers"
    if dest_rows is not None:
        assert num_local_rows in (None, grid_h) and row_stride == 1, (
            "routing mode enumerates the FULL grid")
        ltile_bits = (dest_rows * grid_w + 1).bit_length()
        assert (n_dest << ltile_bits) < (1 << 31), (
            f"{n_dest} devices x {ltile_bits} tile bits overflow int32")
    # The f32-reciprocal floor trick below needs the f32 relative error
    # (~1.2e-7) to stay under the 1/(2*rw) floor-boundary margin:
    # k_last * grid_w must stay well below ~4e6. Today's largest
    # configs (4K at 8x64: k_last~16k x grid_w 60) hold with ~4x margin.
    assert tiers[-1][0] * grid_w < 4_000_000, (
        f"k_last={tiers[-1][0]} x grid_w={grid_w} exceeds the f32 "
        "floor-division safety bound; use wider tiles or integer division"
    )
    n = prep.depth.shape[0]
    if num_local_rows is None:
        num_local_rows = grid_h
        row0 = 0
    row0 = jnp.asarray(row0, jnp.int32)
    num_tiles = num_local_rows * grid_w
    sentinel = (num_tiles if dest_rows is None
                else jnp.int32(n_dest << ltile_bits))
    k_last = tiers[-1][0]

    rect = prep.rect
    rw = jnp.maximum(rect.x_max - rect.x_min, 0)
    rw_safe = jnp.maximum(rw, 1)
    # Owned tile rows only (tile-sharded path: rows {row0 + r*stride}).
    y0, nrows = owned_row_range(
        rect.y_min, rect.y_max, row0, row_stride, num_local_rows)
    rho0 = (y0 - row0) // row_stride  # first owned LOCAL row
    counts_full = jnp.where(prep.radius > 0, nrows * rw, 0).astype(jnp.int32)
    counts = jnp.minimum(counts_full, k_last)
    # FULL 32-bit positive-float depth bits: the fused sort is num_keys=2
    # (tile, depth) — the reference's 64-bit key ordering exactly, with no
    # quantized-depth ties (GSCuda.cu:461-474).
    depth_q = projection.depth_order_key(prep.depth)

    # slot_keep inputs (tile-vs-ellipse cull, tiers >= 1 only — see
    # build_binning for the bound and the tier-0 cost measurement).
    A, B, Cc = prep.conic[..., 0], prep.conic[..., 1], prep.conic[..., 2]
    lam_min = jnp.maximum(
        0.5 * (A + Cc)
        - jnp.sqrt(jnp.maximum(0.25 * (A - Cc) ** 2 + B * B, 0.0)),
        0.0,
    )
    cull_thresh = 2.0 * jnp.log(
        jnp.maximum(prep.opacity, 1e-12) / (0.98 * cfg.ALPHA_MIN)
    )

    # ONE count-descending ranking; every structure field rides as payload
    # (sort cost is row-bound, payloads near-free). Stable -> deterministic.
    # (On the sharded relevance-exchange path this runs over the COMPACTED
    # relevant set — c_recv rows, falling with D — not all N; an
    # approximately-pre-ranked variant that skipped this sort entirely was
    # tried in r5 and reverted: rank misplacement at tier-budget boundaries
    # dropped real tiles on skewed scenes.)
    idx = jnp.arange(n, dtype=jnp.int32)
    (_, order, r_xmin, r_rw, r_rho0, r_counts, r_depthq, r_mx, r_my,
     r_lam, r_thr) = jax.lax.sort(
        (-counts, idx, rect.x_min, rw_safe, rho0, counts, depth_q,
         prep.mean2d[..., 0], prep.mean2d[..., 1], lam_min, cull_thresh),
        dimension=0, num_keys=1, is_stable=True,
    )

    dims, s0 = tier_dims(n, tiers)
    th_px, tw_px = float(render_cfg.tile_h), float(render_cfg.tile_w)
    # Exact integer ks // rw via one f32 multiply: (ks + 0.5) / rw is never
    # an integer, so exactness needs the f32 relative error (~1.2e-7) of
    # (ks + 0.5) * (1/rw) to stay below the distance to the nearest floor
    # boundary, >= 1/(2*rw): holds while ks * rw < ~4e6 (rw <= grid_w; the
    # static assert above enforces k_last * grid_w < 4e6). Integer division
    # on the VPU is emulated and was a top cost of the (B, w) grid build
    # this replaces.
    r_inv_rw = 1.0 / r_rw.astype(jnp.float32)

    tkeys, gausses = [], []
    rank = jnp.arange(n, dtype=jnp.int32)
    b0 = dims[0][1]
    granted_k = jnp.where(rank < b0, jnp.int32(tiers[0][0]), 0)
    k_lo = 0
    for j, ((w_j, b_j, off_j), (k_j, _)) in enumerate(zip(dims, tiers)):
        # T-major (w_j, B_j): ranks ride the LANE axis.
        ksf = k_lo + 0.5 + jnp.arange(w_j, dtype=jnp.float32)[:, None]
        ks = k_lo + jnp.arange(w_j, dtype=jnp.int32)[:, None]  # (w_j, 1)
        ry = jnp.floor(ksf * r_inv_rw[None, :b_j]).astype(jnp.int32)
        rx = ks - ry * r_rw[None, :b_j]
        ly = r_rho0[None, :b_j] + ry                    # local tile row
        gy = row0 + ly * row_stride                     # global tile row
        gx = r_xmin[None, :b_j] + rx
        if dest_rows is None:
            local = ly * grid_w + gx
        else:
            # Route key: destination device (contiguous-row ownership) in
            # the high bits, that device's LOCAL tile id in the low bits.
            # dest_rows is static, so the division is a multiply-shift.
            dest = gy // dest_rows
            local = (dest << ltile_bits) | (
                (gy - dest * dest_rows) * grid_w + gx)
        valid = ks < r_counts[None, :b_j]
        if j > 0:
            px_lo = gx.astype(jnp.float32) * tw_px
            py_lo = gy.astype(jnp.float32) * th_px
            mxj = r_mx[None, :b_j]
            myj = r_my[None, :b_j]
            dx = jnp.maximum(
                jnp.maximum(px_lo - mxj, mxj - (px_lo + (tw_px - 1))), 0.0)
            dy = jnp.maximum(
                jnp.maximum(py_lo - myj, myj - (py_lo + (th_px - 1))), 0.0)
            valid &= (dx * dx + dy * dy) * r_lam[None, :b_j] <= (
                r_thr[None, :b_j])
            granted_k = jnp.where((rank < b_j) & (r_counts > k_lo),
                                  k_j, granted_k)
        tkeys.append(jnp.where(
            valid, local, sentinel).reshape(-1))
        gausses.append(
            jnp.broadcast_to(order[None, :b_j], (w_j, b_j)).reshape(-1))
        k_lo = k_j

    tile_key = jnp.concatenate(tkeys)
    # Depth rides t-major like the features: broadcast per tier.
    depth_key = jnp.concatenate([
        jnp.broadcast_to(r_depthq[None, :b_j], (w_j, b_j)).reshape(-1)
        for (w_j, b_j, _off) in dims
    ])
    gauss = jnp.concatenate(gausses)
    s = -(-s0 // 128) * 128
    if s > s0:
        pad = s - s0
        tile_key = jnp.concatenate(
            [tile_key, jnp.full((pad,), sentinel, jnp.int32)])
        depth_key = jnp.concatenate([depth_key, jnp.zeros((pad,), jnp.int32)])
        gauss = jnp.concatenate([gauss, jnp.full((pad,), -1, jnp.int32)])
    slot = jnp.arange(s, dtype=jnp.int32)

    live = tile_key != sentinel
    total = jnp.sum(live, dtype=jnp.int32)
    dropped = jnp.sum(counts_full - counts) + jnp.sum(
        jnp.maximum(jnp.minimum(r_counts, k_last) - granted_k, 0))
    return TierPlan(
        tile_key=tile_key, depth_key=depth_key, slot=slot,
        gauss=jnp.where(live, gauss, -1),
        order=order, total=total,
        overflow_tile_cap=dropped.astype(jnp.int32),
    )


def build_binning(
    prep: Preprocessed,
    grid_h: int,
    grid_w: int,
    render_cfg: cfg.RenderConfig,
    capacity: int,
    num_local_rows: int | None = None,
    row0=0,
    row_stride: int = 1,
) -> Binning:
    """Bin Gaussians into (tile | depth)-sorted intersection lists.

    When `num_local_rows`/`row0` are given, only tile rows
    {row0 + r * row_stride : 0 <= r < num_local_rows} are binned and tile ids
    in the result are LOCAL (r * grid_w + x) — this is the tile-sharded
    multi-chip path (SURVEY.md §2.5). `row_stride > 1` interleaves row
    ownership round-robin across devices (device d of D owns rows
    {d, d+D, ...}) so screen-space load concentrations spread evenly.
    """
    if num_local_rows is None:
        num_local_rows = grid_h
        row0 = jnp.int32(0)
    row0 = jnp.asarray(row0, jnp.int32)
    num_local_tiles = num_local_rows * grid_w
    k2 = render_cfg.max_tiles_per_gaussian
    k1 = min(render_cfg.base_tiles_per_gaussian, k2)
    n = prep.depth.shape[0]
    imax = jnp.iinfo(jnp.int32).max
    # Tier-2 (heavy) budget: static row count for gaussians touching more
    # than k1 tiles. Two-tier keeps total slots near mean*N instead of K*N
    # (most gaussians touch few tiles; the bench scene's mean is ~4.4 at
    # 8x64 tiles) — the sorts and the VJP's cotangent routing scale with
    # slot count.
    if k2 > k1:
        h_budget = max(
            128, -(-int(n * render_cfg.heavy_fraction) // 128) * 128
        )
        h_budget = min(h_budget, n)
    else:
        h_budget = 0

    # Key layout: local_tile in the high bits, quantized depth order in the
    # low bits, 31 bits total (positive int32). +1 keeps the all-ones
    # sentinel pattern (imax >> depth_bits) strictly above every real tile id.
    tile_bits = (num_local_tiles + 1).bit_length()
    depth_bits = 31 - tile_bits
    assert depth_bits >= 12, (
        f"{num_local_tiles} tiles leaves only {depth_bits} depth bits; "
        "use a larger tile shape or shard the tile grid"
    )

    rect = prep.rect
    rw = rect.x_max - rect.x_min
    rw_safe = jnp.maximum(rw, 1)
    y0, nrows = owned_row_range(
        rect.y_min, rect.y_max, row0, row_stride, num_local_rows
    )
    rho0 = (y0 - row0) // row_stride  # first owned LOCAL row
    counts_full = jnp.where(prep.radius > 0, nrows * rw, 0).astype(jnp.int32)
    counts = jnp.minimum(counts_full, k2)

    # Positive-float bitcast is order-preserving (GSCuda.cu:465-471); keep
    # the top `depth_bits` bits. Ordering of depths within ~2^-(depth_bits-9)
    # relative falls back to slot order — invisible in the blend, and both
    # backends consume the same binning so they stay bit-identical.
    dshift = 31 - depth_bits
    depth_q = projection.depth_order_key(prep.depth) >> dshift  # (N,)

    # Per-slot tile rejection (exactness-preserving): the rect is a box
    # around an ellipse, so corner tiles often cannot reach the ALPHA_MIN
    # blend threshold anywhere. With lam_min the conic's smallest eigenvalue,
    # alpha <= opacity * exp(-0.5 * lam_min * d^2) for d the distance from
    # the mean to the tile's closest pixel; when that bound (with a 2%
    # safety margin on the threshold) is below ALPHA_MIN the slot can be
    # dropped — every backend's blend would skip all its pixels anyway
    # (GSCuda.cu:645-649). Applied to the TIER-2 grid only: that is where
    # the big rects (and so the box-vs-ellipse waste) live, and the tier-1
    # grid is 8x larger — culling it costs more elementwise math than the
    # dropped slots save downstream.
    A, B, Cc = prep.conic[..., 0], prep.conic[..., 1], prep.conic[..., 2]
    lam_min = 0.5 * (A + Cc) - jnp.sqrt(
        jnp.maximum(0.25 * (A - Cc) ** 2 + B * B, 0.0)
    )
    lam_min = jnp.maximum(lam_min, 0.0)
    # drop iff d^2 * lam_min > 2 ln(opacity / (0.98 * ALPHA_MIN))
    cull_thresh = 2.0 * jnp.log(
        jnp.maximum(prep.opacity, 1e-12) / (0.98 * cfg.ALPHA_MIN)
    )
    mx = prep.mean2d[..., 0]
    my = prep.mean2d[..., 1]
    tile_h_px = render_cfg.tile_h
    tile_w_px = render_cfg.tile_w

    def slot_keep(gy, gx, idx):
        """gy/gx: global tile row/col per slot; idx: gaussian per row."""
        px_lo = gx.astype(jnp.float32) * tile_w_px
        px_hi = px_lo + (tile_w_px - 1)
        py_lo = gy.astype(jnp.float32) * tile_h_px
        py_hi = py_lo + (tile_h_px - 1)
        mxi = mx[idx][:, None]
        myi = my[idx][:, None]
        dx = jnp.maximum(jnp.maximum(px_lo - mxi, mxi - px_hi), 0.0)
        dy = jnp.maximum(jnp.maximum(py_lo - myi, myi - py_hi), 0.0)
        d2 = dx * dx + dy * dy
        return d2 * lam_min[idx][:, None] <= cull_thresh[idx][:, None]

    # Tier 1: the (N, K1) slot grid, built elementwise (no gathers): slot
    # (i, k) is the k-th owned tile of gaussian i, walking its owned rows
    # row-major. Slot numbering: tier-1 slot (i, k) = i*K1 + k; tier-2 slot
    # (h, k) = N*K1 + h*(K2-K1) + (k - K1).
    ks = jnp.arange(k1, dtype=jnp.int32)[None, :]  # (1, K1)
    ry = ks // rw_safe[:, None]
    rx = ks - ry * rw_safe[:, None]
    local = (rho0[:, None] + ry) * grid_w + rect.x_min[:, None] + rx
    valid1 = ks < jnp.minimum(counts, k1)[:, None]  # (N, K1)
    key1 = jnp.where(
        valid1, (local << depth_bits) | depth_q[:, None], imax
    ).reshape(-1)
    gauss1 = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[:, None], (n, k1)
    ).reshape(-1)
    nk1 = n * k1

    if h_budget > 0:
        # Tier 2: compact the heavy gaussians (counts > K1) into H rows and
        # enumerate their tiles K1..K2 from gathered per-row fields (H is
        # small — the gathers are cheap). Demand beyond the budget is
        # counted, never silent.
        kh = k2 - k1
        heavy = counts > k1
        order = jnp.argsort(~heavy, stable=True).astype(jnp.int32)
        n_heavy = jnp.sum(heavy, dtype=jnp.int32)
        n_sel = jnp.minimum(n_heavy, h_budget)
        sel_ok = jnp.arange(h_budget, dtype=jnp.int32) < n_sel
        h_idx = jnp.where(sel_ok, order[:h_budget], n)   # pad with N
        h_c = jnp.minimum(h_idx, n - 1)
        counts_h = jnp.where(sel_ok, counts[h_c], 0)
        ks2 = k1 + jnp.arange(kh, dtype=jnp.int32)[None, :]  # (1, KH)
        rw_h = rw_safe[h_c]
        ry2 = ks2 // rw_h[:, None]
        rx2 = ks2 - ry2 * rw_h[:, None]
        local2 = (
            (rho0[h_c][:, None] + ry2) * grid_w
            + rect.x_min[h_c][:, None] + rx2
        )
        valid2 = (ks2 < counts_h[:, None]) & slot_keep(
            y0[h_c][:, None] + ry2 * row_stride,
            rect.x_min[h_c][:, None] + rx2, h_c,
        )
        key2 = jnp.where(
            valid2, (local2 << depth_bits) | depth_q[h_c][:, None], imax
        ).reshape(-1)
        gauss2 = jnp.broadcast_to(h_c[:, None], (h_budget, kh)).reshape(-1)
        granted2 = jnp.sum(jnp.maximum(counts_h - k1, 0), dtype=jnp.int32)
        key = jnp.concatenate([key1, key2])
        gauss = jnp.concatenate([gauss1, gauss2])
        ns = nk1 + h_budget * kh
        total = (jnp.sum(valid1, dtype=jnp.int32)
                 + jnp.sum(valid2, dtype=jnp.int32))
        dropped_tiles = jnp.sum(counts_full - counts) + (
            jnp.sum(jnp.maximum(counts - k1, 0)) - granted2
        )
    else:
        h_idx = jnp.zeros((0,), jnp.int32)
        key = key1
        gauss = gauss1
        ns = nk1
        total = jnp.sum(valid1, dtype=jnp.int32)
        dropped_tiles = jnp.sum(counts_full - jnp.minimum(counts, k1))

    slot = jnp.arange(ns, dtype=jnp.int32)
    if ns < capacity:  # static: pad so truncation is a no-op
        pad = capacity - ns
        key = jnp.concatenate([key, jnp.full((pad,), imax, jnp.int32)])
        slot = jnp.concatenate([slot, jnp.full((pad,), ns, jnp.int32)])
        gauss = jnp.concatenate([gauss, jnp.full((pad,), -1, jnp.int32)])

    # Stable single-key sort: payload (slot) ascending breaks ties, so the
    # result is fully deterministic. Sentinel keys sink to the end, so the
    # truncation to capacity keeps every real intersection (when it doesn't,
    # the drop is counted in overflow_capacity). The gaussian index rides as
    # a second payload (slot -> gaussian is non-uniform across tiers).
    sorted_key, sorted_slot, sorted_gauss_raw = jax.lax.sort(
        (key, slot, gauss), dimension=0, num_keys=1, is_stable=True
    )

    sorted_key_c = sorted_key[:capacity]
    is_real = sorted_key_c != imax
    sorted_gauss = jnp.where(is_real, sorted_gauss_raw[:capacity], -1)
    sorted_tile = jnp.minimum(
        sorted_key_c >> depth_bits, jnp.int32(num_local_tiles)
    )
    tile_starts = jnp.searchsorted(
        sorted_tile, jnp.arange(num_local_tiles + 1, dtype=jnp.int32),
        side="left",
    ).astype(jnp.int32)

    written = jnp.minimum(total, capacity)
    return Binning(
        sorted_tile=sorted_tile,
        sorted_gauss=sorted_gauss,
        sorted_slot=sorted_slot,
        heavy_idx=h_idx,
        tile_starts=tile_starts,
        num_intersections=written.astype(jnp.int32),
        overflow_capacity=jnp.maximum(total - capacity, 0).astype(jnp.int32),
        overflow_tile_cap=dropped_tiles.astype(jnp.int32),
    )
