"""Heavy-tile validation against an UNCAPPED oracle: the tiled-XLA oracle truncates per-tile work at max_per_tile and
r3's assert_comparable therefore REFUSES heavy scenes; the dense per-pixel
oracle (render/dense.py) has no cap at all, so genuinely heavy tiles can be
*validated*, not just refused. The Pallas path walks true ranges uncapped —
this is the test that proves it right where the capped oracle can't."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsrast_tpu import Camera, RenderConfig, random_scene
from gsrast_tpu.camera import look_at
from gsrast_tpu.render.dense import render_dense
from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
from gsrast_tpu.render.tiled import render_tiled_xla


@pytest.fixture(scope="module")
def heavy_scene():
    """~2.5k gaussians squeezed into a fraction of the frame: the hot tile
    carries thousands of intersections — far past any per-tile cap."""
    s = random_scene(jax.random.PRNGKey(7), 2560, sh_degree=1,
                     scale_range=(0.01, 0.05))
    return s.replace(means=s.means * jnp.array([0.15, 0.15, 1.0]))


@pytest.fixture(scope="module")
def camera():
    return Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0), width=64, height=32,
    )


CFG = RenderConfig(
    backend="pallas", interpret=True, tile_h=8, tile_w=16, max_per_tile=256,
    intersect_capacity_factor=64.0, tile_chunk=2,
    tiers=((4, 1.0), (16, 1.0), (64, 0.5), (2560, 0.25)),
    background=(0.1, 0.2, 0.3),
)


class TestHeavyTileUncappedOracle:
    def test_scene_is_genuinely_heavy(self, heavy_scene, camera):
        out = render_tiled_xla(heavy_scene.activated(), camera,
                               CFG.replace(backend="xla"))
        # the capped oracle DOES truncate here — this scene is past its cap
        assert int(out.stats["overflow_per_tile"]) > 0

    def test_pallas_matches_dense_uncapped(self, heavy_scene, camera):
        act = heavy_scene.activated()
        out_p = render_tiled_pallas(act, camera, CFG)
        out_d = render_dense(act, camera, CFG, match_tiled_rects=True)
        np.testing.assert_allclose(
            np.asarray(out_p.image), np.asarray(out_d.image),
            atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(
            np.asarray(out_p.final_t), np.asarray(out_d.final_t),
            atol=5e-5, rtol=1e-4)

    def test_pallas_grads_match_dense_uncapped(self, heavy_scene, camera):
        act = heavy_scene.activated()

        def loss_p(means):
            out = render_tiled_pallas(
                act.replace(means=means), camera, CFG)
            return jnp.mean(out.image ** 2)

        def loss_d(means):
            out = render_dense(
                act.replace(means=means), camera, CFG,
                match_tiled_rects=True)
            return jnp.mean(out.image ** 2)

        g_p = jax.jit(jax.grad(loss_p))(act.means)
        g_d = jax.jit(jax.grad(loss_d))(act.means)
        m = np.abs(np.asarray(g_d)).max()
        assert np.abs(np.asarray(g_p) - np.asarray(g_d)).max() / m < 2e-5
