"""Adaptive density control: densify (clone/split), prune, opacity reset.

Capability add over the reference (no training at all, SURVEY.md §2.3);
BASELINE config 4 requires the full 3DGS adaptive-density schedule. The
Static-shape twist: XLA needs static shapes, so the scene lives in a
fixed-capacity SoA with a validity mask (scene/gaussians.py) and all
densify/prune operations are pure functions that move Gaussians between live
and dead slots with masked scatter — no reallocation, fully jittable.

Semantics follow the standard 3DGS recipe:
  * accumulate per-Gaussian max view-space positional gradient norms;
  * clone small high-gradient Gaussians (copy, keep scale);
  * split large high-gradient Gaussians (sample 2 children inside the parent,
    scale /= 1.6, parent dies);
  * prune by min opacity / max world size;
  * periodically reset opacity toward a small value.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..scene.gaussians import GaussianScene


class DensifyState(NamedTuple):
    """Running statistics between densify steps."""

    grad_accum: jax.Array  # (M,) sum of ||d mean2d|| per view
    denom: jax.Array       # (M,) number of views the gaussian was visible in
    max_radii: jax.Array   # (M,) max screen radius seen (for size pruning)


def init_densify_state(capacity: int) -> DensifyState:
    return DensifyState(
        grad_accum=jnp.zeros((capacity,), jnp.float32),
        denom=jnp.zeros((capacity,), jnp.float32),
        max_radii=jnp.zeros((capacity,), jnp.float32),
    )


def accumulate_stats(
    state: DensifyState,
    mean2d_grad: jax.Array,  # (M, 2) gradient of loss wrt screen position
    radii: jax.Array,        # (M,) int32 screen radii (0 = not visible)
) -> DensifyState:
    visible = radii > 0
    norm = jnp.linalg.norm(mean2d_grad, axis=-1)
    return DensifyState(
        grad_accum=state.grad_accum + jnp.where(visible, norm, 0.0),
        denom=state.denom + visible.astype(jnp.float32),
        max_radii=jnp.maximum(state.max_radii, radii.astype(jnp.float32)),
    )


def _compact_indices(flags: jax.Array, limit: int) -> Tuple[jax.Array, jax.Array]:
    """Indices of up-to-`limit` True flags (padded with capacity), plus count."""
    m = flags.shape[0]
    limit = min(limit, m)  # a budget beyond capacity is just capacity
    order = jnp.argsort(~flags, stable=True)  # True flags first
    count = jnp.sum(flags.astype(jnp.int32))
    take = order[:limit]
    valid = jnp.arange(limit) < jnp.minimum(count, limit)
    return jnp.where(valid, take, m), jnp.minimum(count, limit)


def densify_and_prune(
    scene: GaussianScene,
    state: DensifyState,
    key: jax.Array,
    grad_threshold: float = 2e-4,
    scale_threshold: float = 0.01,  # fraction of scene extent
    scene_extent: float = 1.0,
    min_opacity: float = 0.005,
    max_screen_radius: float = 0.0,  # 0 disables screen-size pruning
    max_new: int = 4096,
) -> Tuple[GaussianScene, DensifyState, dict]:
    """One adaptive-density step. Returns (scene, reset stats, info dict).

    `max_new` is the static per-step budget of new Gaussians (clones + split
    children); demand beyond it is counted in info["densify_overflow"] — no
    silent caps.
    """
    m = scene.capacity
    avg_grad = state.grad_accum / jnp.maximum(state.denom, 1.0)
    high_grad = (avg_grad > grad_threshold) & scene.mask

    world_scale = jnp.max(jnp.exp(scene.log_scales), axis=-1)
    is_small = world_scale <= scale_threshold * scene_extent
    clone_flags = high_grad & is_small
    split_flags = high_grad & ~is_small

    # ---- prune ----
    opac = jax.nn.sigmoid(scene.opacity_logits)
    prune = scene.mask & (opac < min_opacity)
    if max_screen_radius > 0:
        prune = prune | (scene.mask & (state.max_radii > max_screen_radius))
    prune = prune & ~clone_flags & ~split_flags  # densify targets survive
    mask = scene.mask & ~prune

    # ---- allocate free slots ----
    # Budget: clones need 1 slot, splits need 2 (parent dies, 2 children).
    n_clone_budget = max_new // 2
    clone_idx, n_clone = _compact_indices(clone_flags, n_clone_budget)
    split_budget = (max_new - n_clone_budget) // 2
    split_idx, n_split = _compact_indices(split_flags, split_budget)
    demand = (
        jnp.sum(clone_flags.astype(jnp.int32))
        + 2 * jnp.sum(split_flags.astype(jnp.int32))
    )

    free_flags = ~mask
    free_idx, n_free = _compact_indices(free_flags, max_new)
    # clones take free slots [0, n_clone); split children take
    # [n_clone, n_clone + 2 n_split)
    n_clone = jnp.minimum(n_clone, n_free)
    n_split = jnp.minimum(n_split, jnp.maximum(n_free - n_clone, 0) // 2)

    def gather(x, idx):
        return x[jnp.minimum(idx, m - 1)]

    # ---- clones: exact copies ----
    budget = clone_idx.shape[0]
    clone_ok = jnp.arange(budget) < n_clone
    dst_c = jnp.where(clone_ok, gather(free_idx, jnp.arange(budget)), m)

    def scatter_rows(arr, dst, src_rows, ok):
        dst = jnp.where(ok, dst, m)
        return arr.at[dst].set(src_rows, mode="drop")

    new = scene
    for field in ["means", "log_scales", "quats", "opacity_logits", "sh"]:
        arr = getattr(new, field)
        src = gather(arr, clone_idx)
        new = new.replace(**{field: scatter_rows(arr, dst_c, src, clone_ok)})
    mask = mask.at[jnp.where(clone_ok, dst_c, m)].set(True, mode="drop")

    # ---- splits: 2 children sampled inside the parent, parent dies ----
    sbudget = split_idx.shape[0]
    split_ok = jnp.arange(sbudget) < n_split
    child_slots = jnp.arange(2 * sbudget).reshape(sbudget, 2)
    dst_s = jnp.where(
        split_ok[:, None], gather(free_idx, n_clone + child_slots), m
    )

    p_means = gather(scene.means, split_idx)
    p_logs = gather(scene.log_scales, split_idx)
    p_quats = gather(scene.quats, split_idx)
    p_opac = gather(scene.opacity_logits, split_idx)
    p_sh = gather(scene.sh, split_idx)

    from ..ops.covariance import quat_to_rotmat

    qn = p_quats / (jnp.linalg.norm(p_quats, axis=-1, keepdims=True) + 1e-12)
    rot = quat_to_rotmat(qn)  # (S, 3, 3)
    noise = jax.random.normal(key, (sbudget, 2, 3)) * jnp.exp(p_logs)[:, None, :]
    offsets = jnp.einsum("sij,skj->ski", rot, noise)
    child_means = p_means[:, None, :] + offsets  # (S, 2, 3)
    child_logs = jnp.broadcast_to(
        (p_logs - jnp.log(1.6))[:, None, :], (sbudget, 2, 3)
    )

    def scatter2(arr, rows):
        flat_dst = dst_s.reshape(-1)
        flat_rows = rows.reshape((2 * sbudget,) + rows.shape[2:])
        return arr.at[flat_dst].set(flat_rows, mode="drop")

    new = new.replace(
        means=scatter2(new.means, child_means),
        log_scales=scatter2(new.log_scales, child_logs),
        quats=scatter2(new.quats, jnp.broadcast_to(
            p_quats[:, None, :], (sbudget, 2, 4))),
        opacity_logits=scatter2(new.opacity_logits, jnp.broadcast_to(
            p_opac[:, None], (sbudget, 2))),
        sh=scatter2(new.sh, jnp.broadcast_to(
            p_sh[:, None], (sbudget, 2) + p_sh.shape[1:])),
    )
    mask = mask.at[dst_s.reshape(-1)].set(True, mode="drop")
    # parents die
    dead_parents = jnp.where(split_ok, split_idx, m)
    mask = mask.at[dead_parents].set(False, mode="drop")

    new = new.replace(mask=mask)
    # Slots whose parameters were (re)written or freed this step: ONLY these
    # lose their Adam moments (trainer.surgery_opt_state); every untouched
    # Gaussian keeps its optimizer state across densify — the standard 3DGS
    # recipe (r1/r2 fully re-initialized the optimizer, hurting convergence).
    changed = jnp.zeros((m,), bool)
    changed = changed.at[jnp.where(clone_ok, dst_c, m)].set(True, mode="drop")
    changed = changed.at[dst_s.reshape(-1)].set(True, mode="drop")
    changed = changed.at[dead_parents].set(True, mode="drop")
    changed = changed | prune
    info = {
        "num_cloned": n_clone,
        "num_split": n_split,
        "num_pruned": jnp.sum(prune.astype(jnp.int32)),
        "densify_overflow": jnp.maximum(
            demand - (n_clone + 2 * n_split), 0
        ),
        "num_active": new.num_active(),
        "changed_slots": changed,
    }
    return new, init_densify_state(m), info


def reset_opacity(scene: GaussianScene, max_opacity: float = 0.01) -> GaussianScene:
    """Clamp opacities to <= max_opacity (the periodic 3DGS opacity reset)."""
    cap = jnp.log(max_opacity / (1.0 - max_opacity)).astype(jnp.float32)
    return scene.replace(
        opacity_logits=jnp.minimum(scene.opacity_logits, cap)
    )
