"""Multi-chip sharded rendering and training (shard_map over the mesh).

The parallelism design from SURVEY.md §2.5, replacing nothing in the
reference (it is strictly single-GPU) but required by the north star:

  * Tile sharding ("SP"): the 16x16-tile grid of the reference
    (GSCuda.cu:731-732) generalizes to a set of tiles per device.
    Every device preprocesses all Gaussians (cheap, embarrassingly parallel
    over N), bins ONLY its own tiles (a local sort whose live keys are ~1/D
    of the intersections, though its slot grid keeps the single-device
    volume — ops/binning.shard_tiers; the global radix sort of
    GSCuda.cu:791-797 becomes D independent local sorts), blends its tiles, and the image is the reassembly — no
    communication in the forward pass at all; XLA inserts the psum of
    parameter gradients in the backward (replicated-in -> psum-of-cotangents).
    Ownership is BY TILE ROW, interleaved round-robin (device d owns rows
    {d, d+D, ...}) so screen-space load concentrations spread evenly; row
    (not flat-id) ownership keeps each device's owned-tile count of a rect in
    closed form, so binning expands only owned intersections (ops/binning.py).

  * Primitive (Gaussian) sharding (the renderer's "TP"): the Gaussian SoA —
    the flat arrays of GSGaussians.cpp:121-137 — is sharded over the mesh.
    Each device preprocesses/culls only its N/D Gaussians, routes its
    (tile|depth, features) intersection records to the devices owning the
    covered tiles with ONE all_to_all, then locally sorts and blends its own
    tiles. Backward reverses the exchange (the all_to_all transposes to the
    opposite all_to_all) — parameter gradients come back already sharded,
    no psum over N needed.

  * Data parallelism: a batch of cameras sharded over the "data" axis; the
    per-device loss mean turns into a global psum in backward.

Blending is per-tile independent (no ring pass needed — SURVEY.md §5
"long-context analog"), so scaling efficiency is gated only by tile-load
imbalance (addressed by interleaved ownership) and the key exchange volume.
"""

from __future__ import annotations


from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import config as cfg
from ..camera import Camera
from ..ops import binning as binning_ops
from ..ops import projection
from ..ops.preprocess import preprocess
from ..render.dense import RenderOutput
from ..render.tiled import blend_tiles_xla, blend_sorted_xla, untile
from ..render.pallas_pipeline import (
    _blend,
    feature_rows,
    fused_pack,
    pack_features,
    pack_sorted_features,
)
from ..scene.gaussians import ActivatedGaussians
from .mesh import DATA_AXIS, TILE_AXIS


def _rows_per_device(grid_h: int, n_dev: int) -> int:
    return -(-grid_h // n_dev)


def _tile_perm(grid_h: int, grid_w: int, n_dev: int, rpd: int,
               interleave: bool) -> Optional[jnp.ndarray]:
    """Global tile t -> row index in the all-gathered (n_dev * rpd * grid_w)
    tile stack under row-based ownership (None = identity)."""
    if n_dev == 1:
        return None
    t = np.arange(grid_h * grid_w)
    y, x = t // grid_w, t % grid_w
    if interleave:
        dev, rho = y % n_dev, y // n_dev
    else:
        dev, rho = y // rpd, y % rpd
    return jnp.asarray(dev * (rpd * grid_w) + rho * grid_w + x,
                       dtype=np.int32)


def _blend_local(prep, binning, grid_h, grid_w, render_cfg, num_local_rows,
                 row0, row_stride, backend):
    """Blend this device's local tiles with either backend. Returns
    (tiles_rgb, final_t, n_contrib, overflow_per_tile) with the background
    already composited (both backends match blend_tiles_xla semantics)."""
    tpd = num_local_rows * grid_w
    if backend == "pallas":
        feat_packed = pack_features(prep, binning, render_cfg)
        tile_map = jnp.stack(
            [jnp.asarray(row0, jnp.int32),
             jnp.asarray(row_stride, jnp.int32)]
        )
        rgb, ft, nc = _blend(
            feat_packed, binning.tile_starts, tile_map, grid_h, grid_w,
            render_cfg.tile_h, render_cfg.tile_w, render_cfg.interpret, tpd,
        )
        background = jnp.asarray(render_cfg.background, jnp.float32)
        rgb = rgb + ft[:, None, :] * background[None, :, None]
        # match the XLA branch's (T, P, 3) tile form for reassembly
        return jnp.moveaxis(rgb, 1, 2), ft, nc, jnp.int32(0)
    tiles_rgb, final_t, n_contrib, ovf = blend_tiles_xla(
        prep, binning, grid_h, grid_w, render_cfg,
        num_local_rows=num_local_rows, row0=row0, row_stride=row_stride,
    )
    return tiles_rgb, final_t, n_contrib, ovf


def _sharded_prep(g_full: ActivatedGaussians, camera, render_cfg, n_dev: int,
                  axis: str):
    """Preprocess 1/D of the gaussians on each device, then all_gather the
    per-gaussian screen state, so no device preprocesses all N:
    per-device preprocess cost is N/D, the all_gather
    moves ~N*60B between devices, and its AD transpose is the reduce-scatter of
    per-gaussian cotangents (parameter grads then psum once, as before).
    Requires N % n_dev == 0 (pad_gaussians)."""
    d = jax.lax.axis_index(axis)
    n = g_full.means.shape[0]
    nl = n // n_dev
    g_local = jax.tree.map(
        lambda x: jax.lax.dynamic_slice_in_dim(x, d * nl, nl, 0), g_full)
    prep_local = preprocess(g_local, camera, render_cfg)
    return jax.tree.map(
        lambda x: jax.lax.all_gather(x, axis, axis=0, tiled=True), prep_local)


def _relevance_exchange(g_full: ActivatedGaussians, camera, render_cfg,
                        n_dev: int, axis: str, rpd: int, interleave: bool,
                        send_capacity: Optional[int] = None):
    """Preprocess 1/D of the gaussians per device, then route each one to
    ONLY the devices whose owned tile rows its rect intersects: replaces `_sharded_prep`'s all_gather of the FULL per-gaussian
    state (~N x 60 B per device per camera) with an all_to_all whose volume
    is the per-device RELEVANT set (sum_g min(rect_rows_g, D) / D rows —
    most splats span 1-3 tile rows, so this falls well below N and shrinks
    with D). Invisible gaussians are dropped before the exchange.

    Because the plan then runs over c_recv rows instead of N, the N-row
    count-ranking sort, a per-device Amdahl term, shrinks to the relevant
    set too. (A variant
    that pre-ranked the blocks in the exchange and skipped the plan's
    ranking sort entirely was tried and reverted: approximate rank
    misplacement at tier-budget boundaries dropped real tiles on skewed
    scenes.)

    Returns (prep_received [c_recv rows], ovf_send). Send-budget overflow
    is counted, never silent."""
    from ..ops.preprocess import Preprocessed

    d = jax.lax.axis_index(axis)
    n = g_full.means.shape[0]
    nl = n // n_dev
    if send_capacity is None:
        # Per-(src,dst) budget: expected rows ~= nl * E[min(rows, D)] / D
        # with E[..] typically 1-3; 2x skew headroom, capped at nl.
        send_capacity = min(nl, -(-6 * nl // n_dev))
    c_send = max(128, -(-send_capacity // 128) * 128)
    g_local = jax.tree.map(
        lambda x: jax.lax.dynamic_slice_in_dim(x, d * nl, nl, 0), g_full)
    prep = preprocess(g_local, camera, render_cfg)
    sprep = jax.lax.stop_gradient(prep)
    rect = sprep.rect
    nrows = jnp.maximum(rect.y_max - rect.y_min, 0)
    rw = jnp.maximum(rect.x_max - rect.x_min, 0)
    live = sprep.radius > 0
    proxy = jnp.where(live, nrows * rw, 0)

    # Destination enumeration: (nl, D) grid, j-th destination of gaussian g.
    j = jnp.arange(n_dev, dtype=jnp.int32)[None, :]
    if interleave:
        # Owned rows of device d' are {d' + r*D}: a rect spanning `nrows`
        # consecutive rows touches the residues (y_min + j) % D, j < nrows.
        ndest = jnp.minimum(nrows, n_dev)[:, None]
        dest = (rect.y_min[:, None] + j) % n_dev
    else:
        d_lo = rect.y_min // rpd
        d_hi = jnp.maximum((rect.y_max - 1) // rpd, d_lo)
        ndest = jnp.where(nrows > 0, d_hi - d_lo + 1, 0)[:, None]
        dest = jnp.minimum(d_lo[:, None] + j, n_dev - 1)
    del proxy
    valid = (j < ndest) & live[:, None]
    route = jnp.where(valid, dest, n_dev).reshape(-1)
    # Payload = local gaussian id; stable sort keeps deterministic order.
    gidx = jnp.broadcast_to(
        jnp.arange(nl, dtype=jnp.int32)[:, None], (nl, n_dev)).reshape(-1)
    sroute, src = jax.lax.sort(
        (route, gidx), num_keys=1, is_stable=True)
    dest_starts = jnp.searchsorted(
        sroute, jnp.arange(n_dev + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    ovf_send = jnp.sum(jnp.maximum(
        dest_starts[1:] - dest_starts[:-1] - c_send, 0))

    idx = dest_starts[:-1, None] + jnp.arange(c_send)[None, :]  # (D, Cs)
    ok = idx < dest_starts[1:, None]
    src_g = src[jnp.minimum(idx, src.shape[0] - 1)]  # (D, Cs) local ids
    src_g = jnp.where(ok, src_g, 0)

    # Differentiable 10-column record: [mean2d(2) conic(3) opacity color(3)
    # depth]; depth is stop-grad structure riding the same tensor.
    rec = jnp.concatenate(
        [prep.mean2d, prep.conic, prep.opacity[:, None], prep.color,
         jax.lax.stop_gradient(prep.depth)[:, None]], axis=1)  # (nl, 10)
    send_rec = rec[src_g] * ok.astype(jnp.float32)[:, :, None]
    # Integer structure: [x_min x_max y_min y_max radius].
    ints = jnp.stack(
        [rect.x_min, rect.x_max, rect.y_min, rect.y_max, sprep.radius],
        axis=1)  # (nl, 5)
    send_ints = jnp.where(ok[:, :, None], ints[src_g], 0)

    recv_rec = jax.lax.all_to_all(
        send_rec, axis, split_axis=0, concat_axis=0, tiled=True
    ).reshape(n_dev, c_send, 10)
    recv_ints = jax.lax.all_to_all(
        send_ints, axis, split_axis=0, concat_axis=0, tiled=True
    ).reshape(n_dev, c_send, 5)
    merged = recv_rec.reshape(-1, 10)
    mints = recv_ints.reshape(-1, 5)

    depth = jax.lax.stop_gradient(merged[:, 9])
    radius = mints[:, 4]
    prep_r = Preprocessed(
        mean2d=merged[:, 0:2],
        depth=jnp.where(radius > 0, depth, 1.0),
        conic=merged[:, 2:5],
        color=merged[:, 6:9],
        opacity=merged[:, 5],
        radius=radius,
        rect=projection.TileRect(
            x_min=mints[:, 0], y_min=mints[:, 2],
            x_max=mints[:, 1], y_max=mints[:, 3]),
        tiles_touched=jnp.maximum(mints[:, 1] - mints[:, 0], 0)
        * jnp.maximum(mints[:, 3] - mints[:, 2], 0),
    )
    return prep_r, ovf_send.astype(jnp.int32)


def _local_tiles_fused(prep, render_cfg, cfg_d, grid_h, grid_w, rpd, row0,
                       row_stride, backend, ovf_extra=None):
    """This device's tiles via the fused multi-tier path (cfg_d carries the
    per-device tier spec from shard_tiers). Returns
    (tiles_rgb (T,P,3), ft, nc, stats_vec)."""
    tpd = rpd * grid_w
    n = prep.depth.shape[0]
    plan = binning_ops.plan_tiers(
        jax.lax.stop_gradient(prep), grid_h, grid_w, cfg_d,
        num_local_rows=rpd, row0=row0, row_stride=row_stride)
    if backend == "pallas":
        feat_packed, tile_starts = fused_pack(
            feature_rows(prep), plan.tile_key, plan.depth_key, plan.slot,
            plan.gauss, plan.order, cfg_d.tiers, n, tpd)
        tile_map = jnp.stack([jnp.asarray(row0, jnp.int32),
                              jnp.asarray(row_stride, jnp.int32)])
        rgb, ft, nc = _blend(
            feat_packed, tile_starts, tile_map, grid_h, grid_w,
            render_cfg.tile_h, render_cfg.tile_w, render_cfg.interpret, tpd)
        background = jnp.asarray(render_cfg.background, jnp.float32)
        rgb = rgb + ft[:, None, :] * background[None, :, None]
        tiles_rgb, ovf_tile = jnp.moveaxis(rgb, 1, 2), jnp.int32(0)
    else:
        # Oracle branch: the same (tile, depth, gaussian id) order.
        tile, _sd, sgauss = jax.lax.sort(
            (plan.tile_key, plan.depth_key, plan.gauss), dimension=0,
            num_keys=3, is_stable=True)
        tile_starts = jnp.searchsorted(
            tile, jnp.arange(tpd + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        binning = binning_ops.Binning(
            # sorted_slot: not the real sort permutation on this path;
            # blend_tiles_xla never reads it.
            sorted_tile=tile, sorted_gauss=sgauss,
            sorted_slot=jnp.zeros((0,), jnp.int32),
            heavy_idx=jnp.zeros((0,), jnp.int32), tile_starts=tile_starts,
            num_intersections=plan.total, overflow_capacity=jnp.int32(0),
            overflow_tile_cap=plan.overflow_tile_cap)
        tiles_rgb, ft, nc, ovf_tile = blend_tiles_xla(
            prep, binning, grid_h, grid_w, render_cfg,
            num_local_rows=rpd, row0=row0, row_stride=row_stride)
    stats = jnp.stack([
        plan.total,
        jnp.int32(0) if ovf_extra is None else ovf_extra,
        plan.overflow_tile_cap,
        ovf_tile.astype(jnp.int32),
    ])[None]
    return tiles_rgb, ft, nc, stats


def render_tile_sharded(
    gaussians: ActivatedGaussians,
    camera: Camera,
    render_cfg: cfg.RenderConfig,
    mesh: Mesh,
    interleave: bool = True,
    backend: Optional[str] = None,
    prep_exchange: bool = True,
    prep_send_capacity: Optional[int] = None,
) -> RenderOutput:
    """Tile-sharded forward (+ differentiable backward via shard_map AD).

    `interleave=True` assigns tile ROWS round-robin (device d of D owns rows
    {d, d+D, d+2D, ...}) for load balance — screen-space locality means
    contiguous ranges concentrate the heavy tiles on few devices.
    `backend` overrides render_cfg.backend ('xla' or 'pallas').
    `prep_exchange` (r5, fused path only): route per-gaussian state to the
    devices whose rows its rect touches (all_to_all on the relevant set,
    pre-ranked plan) instead of all_gathering the full preprocessed state;
    `prep_send_capacity` overrides the per-(src,dst) send budget (overflow
    counted).
    """
    backend = backend or render_cfg.backend
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    num_tiles = grid_h * grid_w
    n_dev = mesh.shape[TILE_AXIS]
    rpd = _rows_per_device(grid_h, n_dev)
    row_stride = n_dev if interleave else 1
    if render_cfg.tiers:
        # Fused multi-tier path (r4): sharded preprocess; each device plans
        # its own tiles with the single-device tier widths (shard_tiers).
        gaussians = pad_gaussians(gaussians, n_dev)
        n_pad = gaussians.means.shape[0]
        tiers_d = binning_ops.shard_tiers(render_cfg.tiers, n_dev)
        use_exchange = prep_exchange and n_dev > 1
        if use_exchange:
            nl = n_pad // n_dev
            c_send = prep_send_capacity
            if c_send is None:
                c_send = min(nl, -(-6 * nl // n_dev))
            c_send = max(128, -(-c_send // 128) * 128)
            c_recv = n_dev * c_send
            # Budget fracs were measured over the FULL population; the
            # plan's input is now the c_recv-row relevant set, so scale
            # them to keep the same absolute budgets (clip at 1 keeps
            # nesting monotone).
            tiers_d = tuple(
                (k, min(1.0, f * n_pad / c_recv)) for k, f in tiers_d)
        cfg_d = render_cfg.replace(tiers=tiers_d)
    else:
        local_capacity = render_cfg.capacity(
            gaussians.means.shape[0] // max(n_dev // 2, 1)
        )

    def shard_fn(g: ActivatedGaussians):
        d = jax.lax.axis_index(TILE_AXIS)
        row0 = d if interleave else d * rpd
        if render_cfg.tiers:
            if use_exchange:
                prep, ovf_x = _relevance_exchange(
                    g, camera, render_cfg, n_dev, TILE_AXIS, rpd,
                    interleave, c_send)
            else:
                prep = _sharded_prep(g, camera, render_cfg, n_dev, TILE_AXIS)
                ovf_x = None
            tiles_rgb, final_t, n_contrib, stats = _local_tiles_fused(
                prep, render_cfg, cfg_d, grid_h, grid_w, rpd, row0,
                row_stride, backend, ovf_extra=ovf_x)
            return tiles_rgb, final_t, n_contrib.astype(jnp.int32), stats
        prep = preprocess(g, camera, render_cfg)
        binning = binning_ops.build_binning(
            jax.lax.stop_gradient(prep), grid_h, grid_w, render_cfg,
            local_capacity, num_local_rows=rpd, row0=row0,
            row_stride=row_stride,
        )
        tiles_rgb, final_t, n_contrib, ovf = _blend_local(
            prep, binning, grid_h, grid_w, render_cfg, rpd, row0,
            row_stride, backend,
        )
        stats = jnp.stack(
            [
                binning.num_intersections,
                binning.overflow_capacity,
                binning.overflow_tile_cap,
                ovf.astype(jnp.int32),
            ]
        )[None]
        return tiles_rgb, final_t, n_contrib.astype(jnp.int32), stats

    in_spec = jax.tree.map(lambda _: P(), gaussians)
    tiles_rgb, final_t, n_contrib, stats = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(in_spec,),
        out_specs=(P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS)),
        check_vma=False,
    )(gaussians)

    perm = _tile_perm(grid_h, grid_w, n_dev, rpd, interleave)
    if perm is None:
        tiles_rgb = tiles_rgb[:num_tiles]
        final_t = final_t[:num_tiles]
        n_contrib = n_contrib[:num_tiles]
    else:
        tiles_rgb = tiles_rgb[perm]
        final_t = final_t[perm]
        n_contrib = n_contrib[perm]

    image = untile(tiles_rgb, grid_h, grid_w, render_cfg,
                   camera.height, camera.width)
    final_t_img = untile(final_t, grid_h, grid_w, render_cfg,
                         camera.height, camera.width)
    n_contrib_img = untile(n_contrib, grid_h, grid_w, render_cfg,
                           camera.height, camera.width)

    agg = jnp.sum(stats, axis=0)
    out_stats = {
        "num_intersections": agg[0],
        "overflow_capacity": agg[1],
        "overflow_tile_cap": agg[2],
        "overflow_per_tile": agg[3],
    }
    return RenderOutput(
        image=image,
        final_t=final_t_img,
        n_contrib=n_contrib_img,
        stats=out_stats,
    )


@jax.custom_vjp
def _permute_rows(x, perm, inv_perm):
    """x[perm] with a gather-only VJP: the cotangent routes back through the
    inverse permutation (a gather instead of a scatter; same trick as the
    binning's inv_pos). Requires perm to be a bijection on range(len(x))."""
    return x[perm]


def _permute_rows_fwd(x, perm, inv_perm):
    return x[perm], (inv_perm,)


def _permute_rows_bwd(res, cot):
    (inv_perm,) = res
    z = np.zeros(inv_perm.shape, jax.dtypes.float0)
    return cot[inv_perm], z, z


_permute_rows.defvjp(_permute_rows_fwd, _permute_rows_bwd)


def render_primitive_sharded(
    gaussians: ActivatedGaussians,
    camera: Camera,
    render_cfg: cfg.RenderConfig,
    mesh: Mesh,
    backend: Optional[str] = None,
    send_capacity: Optional[int] = None,
) -> RenderOutput:
    """Primitive-sharded forward/backward: Gaussians sharded over the mesh,
    ONE all_to_all routes intersection records to tile owners (SURVEY §2.5
    "the renderer's TP"; the reference's flat single-GPU arrays are
    GSGaussians.cpp:121-137).

    Per device d of D (contiguous tile-ROW ownership, rpd rows each):
      1. preprocess local N/D Gaussians (cull/project/conic/rect);
      2. expand the true per-Gaussian intersection lists (searchsorted
         expansion, ops/binning.py — no per-Gaussian cap); key = dest device
         | local tile | quantized depth (the reference's 64-bit tile|depth
         key, GSCuda.cu:461-474, plus a routing prefix);
      3. ONE local sort groups slots by destination; fixed (D, c_send)
         send buffers are filled by gather (overflow counted, never silent);
      4. all_to_all exchanges keys + 9-float feature rows (mean2d, conic,
         opacity, rgb) — the features travel WITH the keys so no device ever
         materializes the full Gaussian set;
      5. local sort by (tile|depth, global gaussian id) restores exact
         global blend order; blend local tiles with either backend.
    Backward: every step is a gather/collective whose transpose is a
    gather/collective (the all_to_all reverses itself); parameter gradients
    arrive already sharded over N — no gradient psum is needed.

    `gaussians` leaves must carry a leading N divisible by D (use
    `pad_gaussians`); arrays are interpreted as sharded over TILE_AXIS.
    """
    backend = backend or render_cfg.backend
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    num_tiles = grid_h * grid_w
    n_dev = mesh.shape[TILE_AXIS]
    rpd = _rows_per_device(grid_h, n_dev)  # contiguous row ownership
    tpd = rpd * grid_w
    n_total = gaussians.means.shape[0]
    if n_total % n_dev != 0:
        raise ValueError(
            f"N={n_total} not divisible by {n_dev} devices; pad_gaussians()"
        )
    nl = n_total // n_dev
    c_exp = render_cfg.capacity(nl)  # local expansion capacity
    if send_capacity is None:
        # ~ per-(src,dst) expected volume with 4x skew headroom.
        send_capacity = max(
            256, -(-int(n_total * render_cfg.intersect_capacity_factor)
                   // (n_dev * n_dev) * 4 // 128) * 128
        )
    c_send = -(-send_capacity // 128) * 128
    c_recv = n_dev * c_send

    # r4: 2-key ordering (route = dest|ltile, FULL 32-bit depth bits) — the
    # reference's 64-bit key precision (GSCuda.cu:461-474) with no
    # quantized-depth ties, matching the fused single-chip path; also lifts
    # the old 31-bit budget's device/tile-count limit.
    ltile_bits = (tpd + 1).bit_length()
    imax = jnp.iinfo(jnp.int32).max

    def shard_fn(g: ActivatedGaussians):
        d = jax.lax.axis_index(TILE_AXIS)
        prep = preprocess(g, camera, render_cfg)
        sprep = jax.lax.stop_gradient(prep)

        # --- 2. intersection slots with routing keys (structure: no grad) --
        if render_cfg.tiers:
            # r5: the multi-tier slot grid with
            # DEST-PREFIXED route keys — the same elementwise grid + ONE
            # 2-key sort as the single-chip fused path, replacing the
            # searchsorted expansion.
            plan = binning_ops.plan_tiers(
                sprep, grid_h, grid_w, render_cfg, dest_rows=rpd,
                n_dest=n_dev)
            route, dkey, gauss_slot = plan.tile_key, plan.depth_key, plan.gauss
            total = plan.total
            ovf_expand = plan.overflow_tile_cap  # k_last-cap drops (counted)
        else:
            depth_q = projection.depth_order_key(sprep.depth)  # full bits
            rect = sprep.rect
            rw_safe = jnp.maximum(rect.x_max - rect.x_min, 1)
            gi, k, _offsets, total = binning_ops.expand_intersections(
                sprep.tiles_touched, c_exp
            )
            valid = jnp.arange(c_exp, dtype=jnp.int32) < total
            ovf_expand = jnp.maximum(total - c_exp, 0)
            ry = k // rw_safe[gi]
            rx = k - ry * rw_safe[gi]
            y = rect.y_min[gi] + ry
            x = rect.x_min[gi] + rx
            dest = y // rpd
            ltile = (y - dest * rpd) * grid_w + x
            route = jnp.where(valid, (dest << ltile_bits) | ltile, imax)
            dkey = jnp.where(valid, depth_q[gi], 0)
            gauss_slot = jnp.where(valid, gi, -1)

        # --- 3. group by destination: one 2-key sort + fixed-buffer gather -
        sroute, sdkey, sgauss = jax.lax.sort(
            (route, dkey, gauss_slot), num_keys=2, is_stable=True)
        sdest = jnp.minimum(sroute >> ltile_bits, n_dev)
        dest_starts = jnp.searchsorted(
            sdest, jnp.arange(n_dev + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        dcounts = dest_starts[1:] - dest_starts[:-1]
        ovf_send = jnp.sum(jnp.maximum(dcounts - c_send, 0))

        idx = dest_starts[:-1, None] + jnp.arange(c_send)[None, :]  # (D, Cs)
        ok = idx < dest_starts[1:, None]
        idx_c = jnp.minimum(idx, sroute.shape[0] - 1)
        lkey_mask = (1 << ltile_bits) - 1
        src_gauss = sgauss[idx_c]  # (D, Cs) local gaussian; -1 dead
        ok = ok & (src_gauss >= 0)
        src_gauss = jnp.maximum(src_gauss, 0)
        send_key = jnp.where(ok, sroute[idx_c] & lkey_mask, imax)
        send_depth = jnp.where(ok, sdkey[idx_c], 0)
        send_gid = jnp.where(ok, d * nl + src_gauss, -1)

        feat_n = jnp.concatenate(
            [
                prep.mean2d,                # 0:2
                prep.conic,                 # 2:5
                prep.opacity[:, None],      # 5
                prep.color,                 # 6:9
            ],
            axis=1,
        )  # (nl, 9) — differentiable
        send_feat = (
            feat_n[src_gauss]
            * ok.astype(jnp.float32)[:, :, None]
        )  # (D, Cs, 9)

        # --- 4. the exchange ----------------------------------------------
        recv_key = jax.lax.all_to_all(
            send_key, TILE_AXIS, split_axis=0, concat_axis=0, tiled=True
        ).reshape(-1)
        recv_depth = jax.lax.all_to_all(
            send_depth, TILE_AXIS, split_axis=0, concat_axis=0, tiled=True
        ).reshape(-1)
        recv_gid = jax.lax.all_to_all(
            send_gid, TILE_AXIS, split_axis=0, concat_axis=0, tiled=True
        ).reshape(-1)
        recv_feat = jax.lax.all_to_all(
            send_feat, TILE_AXIS, split_axis=0, concat_axis=0, tiled=True
        ).reshape(c_recv, 9)

        # --- 5. local order restore + blend -------------------------------
        pos = jnp.arange(c_recv, dtype=jnp.int32)
        # Global blend order = (tile, FULL depth, global gaussian id) —
        # 3-key sort; deterministic and quantization-free.
        _, _, _, perm = jax.lax.sort(
            (recv_key, recv_depth, recv_gid, pos), num_keys=3, is_stable=True
        )
        _, inv_perm = jax.lax.sort((perm, pos), num_keys=1, is_stable=True)
        sorted_ltile = jnp.minimum(recv_key[perm], tpd)
        sorted_key = jnp.where(sorted_ltile < tpd, sorted_ltile, imax)
        tile_starts = jnp.searchsorted(
            sorted_ltile, jnp.arange(tpd + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        s_feat = _permute_rows(recv_feat, perm, inv_perm)  # (Cr, 9)
        live = (sorted_key != imax).astype(jnp.float32)
        row_lo = d * rpd

        if backend == "pallas":
            feat_packed = pack_sorted_features((s_feat * live[:, None]).T)
            tile_map = jnp.stack(
                [row_lo.astype(jnp.int32), jnp.int32(1)]
            )
            rgb, ft, nc = _blend(
                feat_packed, tile_starts, tile_map, grid_h, grid_w,
                render_cfg.tile_h, render_cfg.tile_w, render_cfg.interpret, tpd,
            )
            background = jnp.asarray(render_cfg.background, jnp.float32)
            rgb = rgb + ft[:, None, :] * background[None, :, None]
            rgb = jnp.moveaxis(rgb, 1, 2)  # (T, P, 3) to match reassembly
            ovf_tile = jnp.int32(0)
        else:
            rgb, ft, nc, ovf_tile = blend_sorted_xla(
                s_feat[:, 0:2], s_feat[:, 2:5], s_feat[:, 6:9],
                s_feat[:, 5] * live, tile_starts, grid_h, grid_w,
                render_cfg, num_local_rows=rpd, row0=row_lo,
            )

        stats = jnp.stack(
            [
                jnp.minimum(total, c_recv),
                ovf_send.astype(jnp.int32),
                ovf_expand.astype(jnp.int32),
                ovf_tile.astype(jnp.int32),
            ]
        )[None]
        return rgb, ft, nc.astype(jnp.int32), stats

    in_spec = jax.tree.map(lambda _: P(TILE_AXIS), gaussians)
    tiles_rgb, final_t, n_contrib, stats = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(in_spec,),
        out_specs=(P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS)),
        check_vma=False,
    )(gaussians)

    perm = _tile_perm(grid_h, grid_w, n_dev, rpd, interleave=False)
    if perm is None:
        tiles_rgb = tiles_rgb[:num_tiles]
        final_t = final_t[:num_tiles]
        n_contrib = n_contrib[:num_tiles]
    else:
        tiles_rgb = tiles_rgb[perm]
        final_t = final_t[perm]
        n_contrib = n_contrib[perm]

    image = untile(tiles_rgb, grid_h, grid_w, render_cfg,
                   camera.height, camera.width)
    final_t_img = untile(final_t, grid_h, grid_w, render_cfg,
                         camera.height, camera.width)
    n_contrib_img = untile(n_contrib, grid_h, grid_w, render_cfg,
                           camera.height, camera.width)
    agg = jnp.sum(stats, axis=0)
    out_stats = {
        "num_intersections": agg[0],
        "overflow_send": agg[1],      # send-buffer drops (counted)
        "overflow_capacity": agg[2],  # expansion-capacity drops (counted)
        "overflow_per_tile": agg[3],
    }
    return RenderOutput(
        image=image, final_t=final_t_img, n_contrib=n_contrib_img,
        stats=out_stats,
    )


def pad_gaussians(g: ActivatedGaussians, n_dev: int) -> ActivatedGaussians:
    """Pad N to a multiple of n_dev with inert (opacity-0) Gaussians."""
    n = g.means.shape[0]
    target = -(-n // n_dev) * n_dev
    if target == n:
        return g
    pad = target - n

    def pad_leaf(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    return jax.tree.map(pad_leaf, g)


def make_sharded_train_step(
    render_cfg: cfg.RenderConfig,
    mesh: Mesh,
    height: int,
    width: int,
    cameras_per_device: int = 1,
    ssim_weight: float = 0.2,
    optimizer=None,
    interleave: bool = True,
    backend: Optional[str] = None,
):
    """Data + tile parallel training step — ONE shard_map over both mesh axes.

    Layout per step:
      * camera batch B = n_data * cameras_per_device, sharded over "data";
      * inside the shard, each camera renders its LOCAL tiles (interleaved
        over the "tiles" axis), then an all_gather over "tiles" assembles the
        full image for the loss (SSIM crosses tile borders, so the loss needs
        the whole image); the all_gather's AD transpose is the reduce-scatter
        of pixel cotangents. Comm/compute overlap is left to XLA's
        latency-hiding scheduler;
      * replicated parameters transpose to a psum of gradients over the
        whole mesh; with the sharded preprocess each device's
        contribution is a disjoint N/D slice, which XLA lowers to
        all-gathers of the slices instead of a dense all-reduce.

    Returns train_step(params, mask, opt_state, cameras, targets)
      -> (params, opt_state, loss, grads).
    """
    from ..scene.gaussians import merge_params
    from ..train.loss import rgb_loss

    backend = backend or render_cfg.backend
    n_data = mesh.shape[DATA_AXIS]
    n_tile = mesh.shape[TILE_AXIS]
    grid_h, grid_w = render_cfg.grid_shape(height, width)
    num_tiles = grid_h * grid_w
    rpd = _rows_per_device(grid_h, n_tile)
    row_stride = n_tile if interleave else 1
    perm = _tile_perm(grid_h, grid_w, n_tile, rpd, interleave)

    def shard_fn(params, mask, cams_local, tgts_local):
        # cams_local: pytree with leading dim cameras_per_device (this data
        # shard's cameras); replicated across the tile axis.
        d_tile = jax.lax.axis_index(TILE_AXIS)
        row0 = d_tile if interleave else d_tile * rpd
        scene = merge_params(params, mask)
        act = scene.activated()
        if render_cfg.tiers:
            act = pad_gaussians(act, n_tile)
            tiers_d = binning_ops.shard_tiers(render_cfg.tiers, n_tile)
            use_exchange = n_tile > 1
            if use_exchange:
                n_pad = act.means.shape[0]
                nl = n_pad // n_tile
                c_send = max(128, -(-min(nl, -(-6 * nl // n_tile)) // 128)
                             * 128)
                tiers_d = tuple(
                    (k, min(1.0, f * n_pad / (n_tile * c_send)))
                    for k, f in tiers_d)
            cfg_d = render_cfg.replace(tiers=tiers_d)
        else:
            local_capacity = render_cfg.capacity(
                max(act.means.shape[0] // max(n_tile // 2, 1), 1024)
            )

        def render_one(cam_leaves, tgt):
            cam = cam_leaves
            if render_cfg.tiers:
                if use_exchange:
                    prep, _ovf = _relevance_exchange(
                        act, cam, render_cfg, n_tile, TILE_AXIS, rpd,
                        interleave, c_send)
                else:
                    prep = _sharded_prep(
                        act, cam, render_cfg, n_tile, TILE_AXIS)
                tiles_rgb, _ft, _nc, _st = _local_tiles_fused(
                    prep, render_cfg, cfg_d, grid_h, grid_w, rpd, row0,
                    row_stride, backend)
                all_tiles = jax.lax.all_gather(
                    tiles_rgb, TILE_AXIS, axis=0, tiled=True
                )
                all_tiles = (
                    all_tiles[:num_tiles] if perm is None
                    else all_tiles[perm]
                )
                image = untile(all_tiles, grid_h, grid_w, render_cfg,
                               height, width)
                return rgb_loss(image, tgt, ssim_weight)
            prep = preprocess(act, cam, render_cfg)
            binning = binning_ops.build_binning(
                jax.lax.stop_gradient(prep), grid_h, grid_w, render_cfg,
                local_capacity, num_local_rows=rpd, row0=row0,
                row_stride=row_stride,
            )
            tiles_rgb, _ft, _nc, _ovf = _blend_local(
                prep, binning, grid_h, grid_w, render_cfg, rpd, row0,
                row_stride, backend,
            )
            # Assemble the full image: all_gather over the tile axis; its
            # transpose (backward) is a reduce-scatter of pixel cotangents.
            all_tiles = jax.lax.all_gather(
                tiles_rgb, TILE_AXIS, axis=0, tiled=True
            )
            all_tiles = (
                all_tiles[:num_tiles] if perm is None else all_tiles[perm]
            )
            image = untile(all_tiles, grid_h, grid_w, render_cfg, height, width)
            return rgb_loss(image, tgt, ssim_weight)

        losses = [
            render_one(
                jax.tree.map(lambda x: x[i], cams_local), tgts_local[i]
            )
            for i in range(cameras_per_device)
        ]
        loss = jnp.mean(jnp.stack(losses))
        return jax.lax.pmean(loss, DATA_AXIS)[None]

    def batch_loss(params, mask, cameras, targets):
        param_spec = jax.tree.map(lambda _: P(), params)
        mask_spec = jax.tree.map(lambda _: P(), mask)
        cam_spec = jax.tree.map(lambda _: P(DATA_AXIS), cameras)
        tgt_spec = P(DATA_AXIS)
        loss = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(param_spec, mask_spec, cam_spec, tgt_spec),
            out_specs=P(DATA_AXIS),
            check_vma=False,
        )(params, mask, cameras, targets)
        return jnp.mean(loss)

    def train_step(params, mask, opt_state, cameras, targets):
        loss, grads = jax.value_and_grad(batch_loss)(
            params, mask, cameras, targets
        )
        if optimizer is not None:
            import optax

            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        return params, opt_state, loss, grads

    return train_step
