"""Trained-scene validation: a .ply trained to convergence by
THIS framework's own multi-view pipeline (12 orbit views, PSNR ~30) is checked
in as a fixture and every render mode + both backends + gradients are
validated against it. Trained scenes have the radius/depth/opacity skew
random_scene lacks (the fixture genuinely exercises the heavy tier:
at K=32 defaults it overflows the tile cap, at the test config it doesn't).

Fixture layout parity: tests/fixtures/trained_small.ply follows the standard
trained-scene layout (reference SplatData.cpp:114-156 semantics via
scene/ply.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gsrast_tpu as gs
from gsrast_tpu.render.api import render
from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
from gsrast_tpu.render.tiled import render_tiled_xla
from gsrast_tpu.utils.image import load_png
from gsrast_tpu.viz.ellipsoids import render_ellipsoids
from gsrast_tpu.viz.pointcloud import render_pointcloud

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trained_small.ply")
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "trained_small_golden.png")

CFG = gs.RenderConfig(
    backend="xla", interpret=True, tile_h=8, tile_w=16, max_per_tile=2048,
    tile_chunk=8,
    intersect_capacity_factor=32.0, max_tiles_per_gaussian=128,
    heavy_fraction=0.5,
)


def assert_comparable(*outs):
    """Backends may only be compared when no path silently truncated
."""
    for out in outs:
        for key in ("overflow_capacity", "overflow_tile_cap",
                    "overflow_per_tile"):
            if int(out.stats[key]) != 0:
                raise AssertionError(
                    f"backend comparison invalid: {key}="
                    f"{int(out.stats[key])} (silent-cap divergence)"
                )


@pytest.fixture(scope="module")
def scene():
    return gs.load_ply(FIXTURE)


@pytest.fixture(scope="module")
def camera(scene):
    mn, mx = scene.bbox()
    return gs.auto_frame(mn, mx, 128, 128)


class TestTrainedScene:
    def test_fixture_has_trained_skew(self, scene):
        """The fixture must be a real optimization product, not a random
        blob: trained scenes develop wide scale and opacity spreads."""
        act = scene.activated()
        scales = np.asarray(jnp.max(act.scales, axis=-1))
        ops = np.asarray(act.opacities)
        assert scales.max() / max(scales.min(), 1e-9) > 10.0
        assert (ops < 0.15).any() and (ops > 0.9).any()

    def test_matches_golden(self, scene, camera):
        out = render(scene.activated(), camera, CFG)
        assert_comparable(out)
        golden = np.asarray(load_png(GOLDEN))[..., :3]
        img = np.clip(np.asarray(out.image), 0.0, 1.0)
        np.testing.assert_allclose(img, golden, atol=1.5 / 255.0)

    def test_backends_agree_on_trained_scene(self, scene, camera):
        act = scene.activated()
        x = render_tiled_xla(act, camera, CFG)
        p = render_tiled_pallas(act, camera, CFG)
        assert_comparable(x, p)
        np.testing.assert_allclose(np.asarray(p.image), np.asarray(x.image),
                                   atol=3e-5)

    def test_gradients_agree_on_trained_scene(self, scene, camera):
        act = scene.activated()

        def loss(means, fn):
            return jnp.mean(fn(act.replace(means=means), camera, CFG).image)

        gx = jax.grad(lambda m: loss(m, render_tiled_xla))(act.means)
        gp = jax.grad(lambda m: loss(m, render_tiled_pallas))(act.means)
        assert bool(jnp.all(jnp.isfinite(gx)))
        scale = float(jnp.max(jnp.abs(gx))) + 1e-12
        np.testing.assert_allclose(np.asarray(gp) / scale,
                                   np.asarray(gx) / scale, atol=2e-4)

    def test_comparison_refuses_on_overflow(self, scene, camera):
        """A config that silently caps per-tile work must be rejected by the
        comparison harness, not quietly compared."""
        tight = CFG.replace(max_per_tile=8)
        out = render_tiled_xla(scene.activated(), camera, tight)
        with pytest.raises(AssertionError, match="silent-cap"):
            assert_comparable(out)

    def test_debug_modes_render(self, scene, camera):
        act = scene.activated()
        pc = render_pointcloud(act, camera)
        el = render_ellipsoids(act, camera)
        assert bool(jnp.all(jnp.isfinite(pc)))
        assert bool(jnp.all(jnp.isfinite(el)))
        assert float(pc.max()) > 0.0 and float(el.max()) > 0.0


class TestTrained116k:
    """Real-scale trained scene: 116k actives,
    trained to PSNR ~31 by this framework's own multi-view pipeline
    (24 orbit views at 512^2, random:130000 init, densify+prune on,
    resilience loop on; scripts/make_trained_fixture.py regenerates it).
    Rendering it at bench scale is a GPU benchmark cell; here we validate
    the artifact and the auto-derived binning config stay sane."""

    def test_fixture_scale_and_skew(self):
        import os

        from gsrast_tpu.scene.ply import load_ply

        path = os.path.join(os.path.dirname(__file__), "fixtures",
                            "trained_116k.ply")
        scene = load_ply(path)
        n = scene.means.shape[0]
        assert n >= 100_000
        import numpy as np

        scales = np.exp(np.asarray(scene.log_scales))
        assert scales.max() / max(scales.min(), 1e-12) > 20  # trained skew

    def test_auto_tiers_cover_distribution(self):
        import os

        import numpy as np

        from gsrast_tpu.camera import auto_frame
        from gsrast_tpu.ops.binning import auto_tiers, tier_dims
        from gsrast_tpu.scene.ply import load_ply
        from gsrast_tpu import benchmark

        path = os.path.join(os.path.dirname(__file__), "fixtures",
                            "trained_116k.ply")
        scene = load_ply(path)
        mn, mx = scene.bbox()
        cam = auto_frame(mn, mx, 256, 256)
        rcfg = benchmark.bench_config("xla").replace(tiers=())
        tiers = benchmark.auto_tiers_for(scene, cam, rcfg)
        n = scene.means.shape[0]
        ks = [k for k, _ in tiers]
        assert ks == sorted(ks)
        dims, s = tier_dims(n, tiers)
        # budget headroom: slot volume is bounded and the last tier reaches
        # the true max count (no silent cap).
        assert s < 30 * n
        # Here just check budgets are monotone.
        fr = [f for _, f in tiers]
        assert all(a >= b for a, b in zip(fr[1:], fr[2:]))
