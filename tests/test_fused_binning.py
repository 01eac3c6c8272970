"""Multi-tier fused binning (r4): plan_tiers structure + fused sort-pack.

Covers the fused path against three baselines (SURVEY.md §4 tier 2-3):
the tiered XLA oracle (same structure, bit-identical ordering), the legacy
two-tier pallas path (allclose at zero overflow — tie-break order may differ
for equal quantized-depth keys), and XLA autodiff gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsrast_tpu import Camera, RenderConfig, random_scene, render
from gsrast_tpu.camera import look_at
from gsrast_tpu.ops import binning as binning_ops
from gsrast_tpu.ops.preprocess import preprocess
from gsrast_tpu.scene.gaussians import merge_params, split_params

TIERS_FULL = ((2, 1.0), (4, 1.0), (8, 1.0), (16, 0.5), (64, 0.5))


def make_camera(w=256, h=128):
    return Camera(
        view=look_at(jnp.array([0.0, 0.0, -2.5]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2),
        fov_y=jnp.float32(1.0),
        width=w,
        height=h,
    )


def base_cfg(**kw):
    d = dict(
        backend="pallas", interpret=True, tile_h=8, tile_w=32,
        max_tiles_per_gaussian=64,
        heavy_fraction=0.5, intersect_capacity_factor=16.0, max_per_tile=4096,
    )
    d.update(kw)
    return RenderConfig(**d)


@pytest.fixture(scope="module")
def scene():
    return random_scene(jax.random.PRNGKey(0), 3000, sh_degree=1,
                        isotropic=False, scale_range=(0.005, 0.05))


class TestTierPlan:
    def test_dims_nested_and_lane_rounded(self):
        dims, s0 = binning_ops.tier_dims(10_000, TIERS_FULL)
        widths = [w for w, _, _ in dims]
        budgets = [b for _, b, _ in dims]
        assert widths == [2, 2, 4, 8, 48]
        assert budgets[0] == 10_000
        assert all(b % 128 == 0 or b == 10_000 for b in budgets)
        assert all(a >= b for a, b in zip(budgets, budgets[1:]))
        assert s0 == sum(w * b for w, b, _ in dims)

    def test_plan_counts_match_grid(self, scene):
        cam = make_camera()
        rc = base_cfg(tiers=TIERS_FULL)
        prep = preprocess(scene.activated(), cam, rc)
        gh, gw = rc.grid_shape(cam.height, cam.width)
        plan = binning_ops.plan_tiers(prep, gh, gw, rc)
        n = scene.means.shape[0]
        # slot ids are the identity iota; keys/gauss agree on liveness.
        assert (plan.slot.shape == plan.tile_key.shape
                == plan.depth_key.shape == plan.gauss.shape)
        np.testing.assert_array_equal(
            np.asarray(plan.gauss) >= 0,
            np.asarray(plan.tile_key) != gh * gw)
        assert int(plan.total) > 0
        assert int(plan.overflow_tile_cap) == 0
        assert np.asarray(plan.order).shape == (n,)
        assert sorted(np.asarray(plan.order).tolist()) == list(range(n))

    def test_budget_overflow_counted(self, scene):
        cam = make_camera()
        # Starve the upper tiers: gaussians with >4 tiles beyond the tiny
        # budget lose tiles, and the loss must be counted.
        rc = base_cfg(tiers=((2, 1.0), (4, 0.05), (64, 0.05)))
        prep = preprocess(scene.activated(), cam, rc)
        gh, gw = rc.grid_shape(cam.height, cam.width)
        plan = binning_ops.plan_tiers(prep, gh, gw, rc)
        full = binning_ops.plan_tiers(
            prep, gh, gw, base_cfg(tiers=TIERS_FULL))
        assert int(plan.overflow_tile_cap) > 0
        assert int(plan.total) < int(full.total)


class TestFusedRender:
    def test_matches_tiered_oracle_bitwise_structure(self, scene):
        cam = make_camera()
        rc = base_cfg(tiers=TIERS_FULL)
        out_p = render(scene.activated(), cam, rc)
        out_x = render(scene.activated(), cam, rc.replace(backend="xla"))
        assert int(out_p.stats["overflow_tile_cap"]) == 0
        np.testing.assert_allclose(
            out_p.image, out_x.image, atol=5e-6, rtol=1e-5)
        np.testing.assert_allclose(
            out_p.final_t, out_x.final_t, atol=5e-6, rtol=1e-5)

    def test_matches_legacy_two_tier(self, scene):
        """Zero-overflow fused vs legacy: same set of contributions; order
        of equal quantized-depth keys may differ, so allclose not bitwise."""
        cam = make_camera()
        out_l = render(scene.activated(), cam, base_cfg())
        out_f = render(scene.activated(), cam, base_cfg(tiers=TIERS_FULL))
        assert int(out_l.stats["overflow_tile_cap"]) == 0
        assert int(out_f.stats["overflow_tile_cap"]) == 0
        np.testing.assert_allclose(out_f.image, out_l.image, atol=2e-3)

    def test_ellipse_cull_is_exactness_preserving(self, scene):
        """Disabling the tier>=1 tile-vs-ellipse cull (by making every tier
        width ride tier 0, which is never culled) changes nothing beyond
        blend-order noise for tied keys."""
        cam = make_camera()
        out_all0 = render(scene.activated(), cam,
                          base_cfg(tiers=((64, 1.0),)))
        out_tiers = render(scene.activated(), cam, base_cfg(tiers=TIERS_FULL))
        np.testing.assert_allclose(out_tiers.image, out_all0.image, atol=2e-3)

    def test_gradients_match_oracle(self, scene):
        cam = make_camera()
        rc = base_cfg(tiers=TIERS_FULL)
        params, mask = split_params(scene)

        def loss(p, r):
            s = merge_params(p, mask)
            img = render(s.activated(), cam, r).image
            return jnp.mean(img * img)

        g_p = jax.grad(lambda p: loss(p, rc))(params)
        g_x = jax.grad(lambda p: loss(p, rc.replace(backend="xla")))(params)
        for k in g_p:
            a, b = np.asarray(g_p[k]), np.asarray(g_x[k])
            m = max(np.abs(b).max(), 1e-12)
            assert np.abs(a - b).max() / m < 1e-5, k

    def test_jit_and_mean2d_delta_grad(self, scene):
        """The densification screen-gradient hook works through the fused
        pack (mean2d rows are differentiable payloads)."""
        cam = make_camera()
        rc = base_cfg(tiers=TIERS_FULL)
        act = scene.activated()
        n = scene.means.shape[0]

        @jax.jit
        def g(delta):
            from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas

            def loss(d):
                out = render_tiled_pallas(act, cam, rc, mean2d_delta=d)
                return jnp.sum(out.image)

            return jax.grad(loss)(delta)

        gd = g(jnp.zeros((n, 2), jnp.float32))
        assert np.isfinite(np.asarray(gd)).all()
        assert np.abs(np.asarray(gd)).max() > 0
