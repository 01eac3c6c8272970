"""Multi-device sharding tests on the 8-virtual-CPU-device mesh
(SURVEY.md §4 tier 4: multi-host logic without a cluster). Checks that the
tile-sharded render equals the single-device render bit-for-bit in structure
and allclose numerically, and that the DP+tile-sharded train step runs and
produces finite, replicated-consistent gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gsrast_tpu import Camera, RenderConfig, random_scene
from gsrast_tpu.camera import look_at
from gsrast_tpu.parallel.mesh import make_mesh
from gsrast_tpu.parallel.sharded import (make_sharded_train_step,
                                         pad_gaussians,
                                         render_primitive_sharded,
                                         render_tile_sharded)
from gsrast_tpu.render.tiled import render_tiled_xla
from gsrast_tpu.scene.gaussians import split_params

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CFG = RenderConfig(tile_h=8, tile_w=128, max_per_tile=256, tile_chunk=2,
                   intersect_capacity_factor=16.0,
                   background=(0.05, 0.1, 0.15), interpret=True)


def make_camera(w=256, h=16):
    # 2 x 2 grid of 8x128 tiles
    return Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0), width=w, height=h,
    )


@pytest.fixture(scope="module")
def scene():
    return random_scene(jax.random.PRNGKey(11), 256, sh_degree=1,
                        scale_range=(0.02, 0.1))


@pytest.fixture(scope="module")
def corner_scene():
    """Deliberately skewed load: every Gaussian concentrated
    in one screen corner, so one device's tile rows carry ~all of the work
    under contiguous ownership and the send buckets skew hard under
    primitive sharding."""
    s = random_scene(jax.random.PRNGKey(13), 256, sh_degree=1,
                     scale_range=(0.02, 0.08))
    corner = jnp.array([-0.9, -0.35, 0.0])  # upper-left of the frustum
    return s.replace(means=s.means * 0.12 + corner)


class TestSkewedLoad:
    @pytest.mark.parametrize("interleave", [False, True])
    def test_corner_scene_matches_single_device(self, corner_scene,
                                                interleave):
        camera = make_camera(256, 64)  # 8 tile rows x 2 cols
        mesh = make_mesh((1, 4), jax.devices()[:4])
        ref = render_tiled_xla(corner_scene.activated(), camera, CFG)
        assert int(ref.stats["overflow_capacity"]) == 0
        out = jax.jit(
            lambda a: render_tile_sharded(
                a, camera, CFG, mesh, interleave=interleave, backend="xla"
            )
        )(corner_scene.activated())
        # Interleaved row ownership spreads the corner blob; contiguous
        # concentrates it — both must still be exact (capacity headroom) and
        # must COUNT, not hide, their load.
        assert int(out.stats["overflow_capacity"]) == 0
        assert int(out.stats["num_intersections"]) == int(
            ref.stats["num_intersections"])
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5
        )

    def test_contiguous_capacity_overflow_is_counted(self, corner_scene):
        """Contiguous ownership + skew concentrates ~all intersections on one
        device; a tight capacity must overflow COUNTED, never silently."""
        camera = make_camera(256, 64)
        mesh = make_mesh((1, 4), jax.devices()[:4])
        tight = CFG.replace(intersect_capacity_factor=1.0)
        out = jax.jit(
            lambda a: render_tile_sharded(
                a, camera, tight, mesh, interleave=False, backend="xla"
            )
        )(corner_scene.activated())
        ref = render_tiled_xla(
            corner_scene.activated(), camera,
            CFG.replace(intersect_capacity_factor=16.0))
        # The per-device capacity heuristic is capacity(N/(D/2)) = cap(128);
        # the corner device owns ~everything, so it must drop and count.
        assert int(out.stats["overflow_capacity"]) > 0
        # Interleaving the same tight config spreads the load enough to
        # drop less (or nothing): imbalance is real and measured.
        out_i = jax.jit(
            lambda a: render_tile_sharded(
                a, camera, tight, mesh, interleave=True, backend="xla"
            )
        )(corner_scene.activated())
        assert (int(out_i.stats["overflow_capacity"])
                < int(out.stats["overflow_capacity"]))

    def test_primitive_sharded_skewed_send(self, corner_scene):
        """Send buckets skew toward the corner-owning device: with headroom
        the exchange is exact; with a tight send buffer it counts drops."""
        camera = make_camera(256, 64)
        mesh = make_mesh((1, 4), jax.devices()[:4])
        act = pad_gaussians(corner_scene.activated(), 4)
        ref = render_tiled_xla(corner_scene.activated(), camera, CFG)
        out = jax.jit(
            lambda a: render_primitive_sharded(
                a, camera, CFG, mesh, send_capacity=4096
            )
        )(act)
        assert int(out.stats["overflow_send"]) == 0
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5
        )
        # Dense enough that one (src, dst) bucket must exceed the 128-row
        # minimum send buffer: 2048 corner gaussians / 4 sources, ~4 tiles
        # each, ~one owning destination.
        dense = random_scene(jax.random.PRNGKey(17), 2048, sh_degree=1,
                             scale_range=(0.02, 0.08))
        dense = dense.replace(
            means=dense.means * 0.12 + jnp.array([-0.9, -0.35, 0.0]))
        tight = jax.jit(
            lambda a: render_primitive_sharded(
                a, camera, CFG, mesh, send_capacity=128
            )
        )(pad_gaussians(dense.activated(), 4))
        assert int(tight.stats["overflow_send"]) > 0


class TestTileSharded:
    @pytest.mark.parametrize("interleave", [False, True])
    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_matches_single_device(self, scene, interleave, backend):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        ref = render_tiled_xla(scene.activated(), camera, CFG)
        out = jax.jit(
            lambda a: render_tile_sharded(
                a, camera, CFG, mesh, interleave=interleave, backend=backend
            )
        )(scene.activated())
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5
        )

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_gradients_match_single_device(self, scene, backend):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        act = scene.activated()

        def loss_sharded(means):
            a = act.replace(means=means)
            return jnp.sum(
                render_tile_sharded(a, camera, CFG, mesh,
                                    backend=backend).image
            )

        def loss_ref(means):
            a = act.replace(means=means)
            return jnp.sum(render_tiled_xla(a, camera, CFG).image)

        # shard_map AD must run under jit (eager grad of shard_map trips
        # XLA sharding-override asserts in current JAX).
        g_sh = jax.jit(jax.grad(loss_sharded))(act.means)
        g_ref = jax.jit(jax.grad(loss_ref))(act.means)
        np.testing.assert_allclose(
            np.asarray(g_sh), np.asarray(g_ref), atol=5e-4, rtol=1e-3
        )


class TestPrimitiveSharded:
    """The all-to-all key-exchange path: Gaussians sharded over the mesh
    (SURVEY §2.5 'the renderer's TP')."""

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_matches_single_device(self, scene, backend):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        act = pad_gaussians(scene.activated(), 4)
        ref = render_tiled_xla(act, camera, CFG)
        out = jax.jit(
            lambda a: render_primitive_sharded(
                a, camera, CFG, mesh, backend=backend
            )
        )(act)
        assert int(out.stats["overflow_capacity"]) == 0
        np.testing.assert_allclose(
            np.asarray(out.image), np.asarray(ref.image), atol=2e-5
        )

    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    def test_gradients_match_single_device(self, scene, backend):
        camera = make_camera()
        mesh = make_mesh((1, 4), jax.devices()[:4])
        act = pad_gaussians(scene.activated(), 4)

        def loss_sharded(means):
            a = act.replace(means=means)
            return jnp.sum(
                render_primitive_sharded(a, camera, CFG, mesh,
                                         backend=backend).image
            )

        def loss_ref(means):
            a = act.replace(means=means)
            return jnp.sum(render_tiled_xla(a, camera, CFG).image)

        g_sh = jax.jit(jax.grad(loss_sharded))(act.means)
        g_ref = jax.jit(jax.grad(loss_ref))(act.means)
        np.testing.assert_allclose(
            np.asarray(g_sh), np.asarray(g_ref), atol=5e-4, rtol=1e-3
        )

    def test_send_overflow_counted(self):
        """Tiny send buffers must COUNT drops, never silently truncate.
        (Dense, high-opacity scene: the r5 per-axis opacity-aware rects
        shrank the module fixture's intersections below one 128-row send
        buffer.)"""
        camera = make_camera()
        mesh = make_mesh((1, 2), jax.devices()[:2])
        dense = random_scene(jax.random.PRNGKey(7), 2048, sh_degree=1,
                             scale_range=(0.05, 0.15))
        act = pad_gaussians(dense.activated(), 2)
        out = jax.jit(
            lambda a: render_primitive_sharded(
                a, camera, CFG, mesh, send_capacity=128
            )
        )(act)
        assert int(out.stats["overflow_send"]) > 0


class TestShardedTrainStep:
    def test_runs_and_finite(self, scene):
        mesh = make_mesh((2, 4), jax.devices()[:8])
        camera = make_camera()
        params, mask = split_params(scene)
        n_data = 2
        cams = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_data,) + x.shape), camera
        )
        targets = jnp.zeros((n_data, camera.height, camera.width, 3),
                            jnp.float32)
        optimizer = optax.adam(1e-3)
        opt_state = optimizer.init(params)
        step = jax.jit(make_sharded_train_step(
            CFG, mesh, camera.height, camera.width, cameras_per_device=1,
            optimizer=optimizer,
        ))
        new_params, _, loss, grads = step(params, mask, opt_state, cams,
                                          targets)
        assert bool(jnp.isfinite(loss))
        gnorm = jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)))
        assert bool(jnp.isfinite(gnorm)) and float(gnorm) > 0.0
        # params actually moved
        assert not np.allclose(np.asarray(new_params["means"]),
                               np.asarray(params["means"]))

    def test_loss_matches_unsharded(self, scene):
        """The sharded per-step loss equals the plain single-device loss of
        the same batch (communication does not change the math)."""
        from gsrast_tpu.render.api import render
        from gsrast_tpu.train.loss import rgb_loss

        mesh = make_mesh((2, 4), jax.devices()[:8])
        camera = make_camera()
        params, mask = split_params(scene)
        n_data = 2
        cams = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_data,) + x.shape), camera
        )
        targets = jnp.zeros((n_data, camera.height, camera.width, 3),
                            jnp.float32)
        step = jax.jit(make_sharded_train_step(
            CFG, mesh, camera.height, camera.width, cameras_per_device=1,
            optimizer=None,
        ))
        _, _, loss, _ = step(params, mask, None, cams, targets)

        img = render(scene.activated(), camera, CFG).image
        ref = rgb_loss(img, targets[0], 0.2)
        np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5,
                                   atol=1e-6)
