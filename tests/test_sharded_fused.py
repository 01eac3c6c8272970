"""Fused multi-tier binning on the sharded paths: sharded preprocess and
exchange, per-device tier specs (shard_tiers), and one blend order, (tile,
depth, gaussian id), on every path. Checks image + gradient agreement with
the single-device fused render on the 8-virtual-device mesh, including a
scene full of equal depths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsrast_tpu import Camera, RenderConfig, random_scene, render
from gsrast_tpu.camera import look_at
from gsrast_tpu.ops.binning import shard_tiers, tier_dims
from gsrast_tpu.parallel.mesh import make_mesh
from gsrast_tpu.parallel.sharded import (make_sharded_train_step,
                                         pad_gaussians,
                                         render_primitive_sharded,
                                         render_tile_sharded)
from gsrast_tpu.scene.gaussians import split_params

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

TIERS = ((2, 1.0), (4, 1.0), (8, 0.5), (32, 0.25))
CFG = RenderConfig(tile_h=8, tile_w=128, max_per_tile=512, tile_chunk=2,
                   intersect_capacity_factor=16.0,
                   background=(0.05, 0.1, 0.15), tiers=TIERS,
                   backend="pallas", interpret=True)


def make_camera(w=256, h=64):
    return Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0), width=w, height=h,
    )


@pytest.fixture(scope="module")
def scene():
    return random_scene(jax.random.PRNGKey(11), 512, sh_degree=1,
                        scale_range=(0.02, 0.1))


class TestShardTiers:
    def test_widths_and_budgets_kept(self):
        """Per-device widths stay the single-device widths (a small splat
        keeps its whole tile count on the device owning its rows), budgets
        survive, and tier 0 takes every received gaussian."""
        td = shard_tiers(TIERS, 8)
        assert [k for k, _ in td] == [k for k, _ in TIERS]
        assert [f for _, f in td[1:]] == [f for _, f in TIERS[1:]]
        assert td[0][1] >= 1.0
        _, s1 = tier_dims(10_000, TIERS)
        _, s8 = tier_dims(10_000, td)
        assert s8 == s1

    def test_single_device_identity(self):
        assert shard_tiers(TIERS, 1) == TIERS


class TestFusedTileSharded:
    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    @pytest.mark.parametrize("interleave", [True, False])
    def test_matches_single_device(self, scene, backend, interleave):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        ref = render(scene.activated(), camera, CFG)
        assert int(ref.stats["overflow_tile_cap"]) == 0
        out = jax.jit(
            lambda a: render_tile_sharded(
                a, camera, CFG, mesh, interleave=interleave, backend=backend
            )
        )(scene.activated())
        assert int(out.stats["overflow_tile_cap"]) == 0
        # Device-scaled tiers shift which slots the (exactness-preserving)
        # ellipse cull sees, so counts are close but not equal; the IMAGE
        # must match exactly either way.
        ref_n = int(ref.stats["num_intersections"])
        assert abs(int(out.stats["num_intersections"]) - ref_n) < (
            0.06 * ref_n + 64)
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5)

    def test_gradients_match_single_device(self, scene):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        act = scene.activated()

        def loss_sharded(means):
            a = act.replace(means=means)
            return jnp.sum(render_tile_sharded(
                a, camera, CFG, mesh, backend="pallas").image)

        def loss_ref(means):
            a = act.replace(means=means)
            return jnp.sum(render(a, camera, CFG).image)

        g_sh = jax.jit(jax.grad(loss_sharded))(act.means)
        g_ref = jax.jit(jax.grad(loss_ref))(act.means)
        np.testing.assert_allclose(
            np.asarray(g_sh), np.asarray(g_ref), atol=2e-4, rtol=1e-4)

    def test_eight_device_skew(self, scene):
        """Corner-concentrated scene on the full 8-device tile mesh:
        interleaved ownership + per-device tiers stay exact (zero counted
        drops) and match single-device."""
        s = scene.replace(means=scene.means * 0.12
                          + jnp.array([-0.9, -0.35, 0.0]))
        camera = make_camera()
        mesh = make_mesh((1, 8), jax.devices())
        ref = render(s.activated(), camera, CFG)
        out = jax.jit(
            lambda a: render_tile_sharded(
                a, camera, CFG, mesh, interleave=True, backend="pallas")
        )(s.activated())
        assert int(out.stats["overflow_tile_cap"]) == 0
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5)

class TestFusedPrimitiveSharded:
    """r5: the primitive-sharded exchange binned by the
    multi-tier route grid (dest-prefixed keys, ONE 2-key sort) instead of
    the searchsorted expansion."""

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_matches_single_device(self, scene, backend):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        act = pad_gaussians(scene.activated(), 4)
        ref = render(scene.activated(), camera, CFG)
        out = jax.jit(
            lambda a: render_primitive_sharded(
                a, camera, CFG, mesh, backend=backend, send_capacity=4096)
        )(act)
        assert int(out.stats["overflow_send"]) == 0
        assert int(out.stats["overflow_capacity"]) == 0  # k_last-cap drops
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5)

    def test_gradients_match_single_device(self, scene):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        act = pad_gaussians(scene.activated(), 4)

        def loss_sharded(means):
            a = act.replace(means=means)
            return jnp.sum(render_primitive_sharded(
                a, camera, CFG, mesh, backend="pallas",
                send_capacity=4096).image)

        def loss_ref(means):
            a = act.replace(means=means)
            return jnp.sum(render(a, camera, CFG).image)

        g_sh = jax.jit(jax.grad(loss_sharded))(act.means)
        g_ref = jax.jit(jax.grad(loss_ref))(act.means)
        np.testing.assert_allclose(
            np.asarray(g_sh), np.asarray(g_ref), atol=2e-4, rtol=1e-4)

    def test_skewed_send_overflow_counted(self, scene):
        """Corner-concentrated scene: with headroom the tier-grid exchange
        is exact; with a tight send buffer it counts drops, never silent."""
        s = scene.replace(means=scene.means * 0.12
                          + jnp.array([-0.9, -0.35, 0.0]))
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        act = pad_gaussians(s.activated(), 4)
        ref = render(s.activated(), camera, CFG)
        out = jax.jit(
            lambda a: render_primitive_sharded(
                a, camera, CFG, mesh, backend="pallas", send_capacity=8192)
        )(act)
        assert int(out.stats["overflow_send"]) == 0
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5)
        tight = jax.jit(
            lambda a: render_primitive_sharded(
                a, camera, CFG, mesh, backend="pallas", send_capacity=128)
        )(act)
        assert int(tight.stats["overflow_send"]) > 0


class TestTrainStepFused:
    def test_train_step_fused(self, scene):
        """DP x tile mesh with the fused local path: one step runs, loss
        finite, params move."""
        import optax

        camera = make_camera()
        mesh = make_mesh((2, 4), jax.devices())
        params, mask = split_params(scene)
        opt = optax.adam(1e-3)
        opt_state = opt.init(params)
        step = make_sharded_train_step(
            CFG, mesh, camera.height, camera.width, optimizer=opt,
            backend="pallas")
        n_data = 2
        cams = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_data,) + x.shape), camera)
        tgts = jnp.zeros((n_data, camera.height, camera.width, 3),
                         jnp.float32)
        new_params, opt_state, loss, grads = jax.jit(step)(
            params, mask, opt_state, cams, tgts)
        assert np.isfinite(float(loss))
        moved = any(
            float(jnp.abs(a - b).max()) > 0
            for a, b in zip(jax.tree.leaves(new_params),
                            jax.tree.leaves(params)))
        assert moved


@pytest.fixture(scope="module")
def tie_scene(scene):
    """Means on a few depth planes: the axis-aligned camera then gives
    whole groups of gaussians bit-identical depths, so the blend order of
    equal depths decides the image."""
    return scene.replace(
        means=scene.means.at[:, 2].set(jnp.round(scene.means[:, 2] * 2) / 2))


class TestEqualDepthOrder:
    """Every path blends equal depths in gaussian-id order, so sharding
    cannot reorder them (a per-device slot order did, by up to 0.28 here)."""

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    @pytest.mark.parametrize("path", ["tile", "primitive"])
    def test_sharded_render_matches(self, tie_scene, backend, path):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        cfg = CFG.replace(backend=backend)
        ref = render(tie_scene.activated(), camera, cfg)
        if path == "tile":
            fn = lambda a: render_tile_sharded(a, camera, cfg, mesh)
            act = tie_scene.activated()
        else:
            fn = lambda a: render_primitive_sharded(
                a, camera, cfg, mesh, send_capacity=4096)
            act = pad_gaussians(tie_scene.activated(), 4)
        out = jax.jit(fn)(act)
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5)

    def test_backends_agree(self, tie_scene):
        camera = make_camera()
        imgs = [np.asarray(render(tie_scene.activated(), camera,
                                  CFG.replace(backend=b)).image)
                for b in ("xla", "pallas")]
        np.testing.assert_allclose(imgs[0], imgs[1], atol=2e-5)

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_train_step_gradients_match(self, tie_scene, backend):
        """(2, 2) data x tile mesh against (1, 1): same loss and
        gradients."""
        camera = make_camera()
        params, mask = split_params(tie_scene)
        cams = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape),
                            camera)
        tgts = jnp.full((2, camera.height, camera.width, 3), 0.25,
                        jnp.float32)
        res = []
        for shape in ((2, 2), (1, 1)):
            mesh = make_mesh(shape, jax.devices()[:shape[0] * shape[1]])
            step = make_sharded_train_step(
                CFG, mesh, camera.height, camera.width,
                cameras_per_device=2 // shape[0], backend=backend)
            _, _, loss, grads = jax.jit(step)(params, mask, None, cams, tgts)
            res.append((float(loss), grads))
        (l4, g4), (l1, g1) = res
        np.testing.assert_allclose(l4, l1, rtol=1e-5)
        for k in g1:
            np.testing.assert_allclose(
                np.asarray(g4[k]), np.asarray(g1[k]), atol=2e-4, rtol=1e-4,
                err_msg=k)
