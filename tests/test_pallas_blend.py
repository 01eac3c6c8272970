"""Pallas blend kernel pair vs the XLA oracle, in interpret mode on the CPU
(tests/test_gpu_kernels.py runs them compiled on a GPU). Gradcheck of the
hand-derived backward against jax.grad of the XLA path (SURVEY.md §4 tier
3); the platform -> backend choice and the kernels' shape guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsrast_tpu import Camera, RenderConfig, random_scene
from gsrast_tpu.camera import look_at
from gsrast_tpu.render import pallas_blend as pb
from gsrast_tpu.render.api import default_backend
from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
from gsrast_tpu.render.tiled import render_tiled_xla
from gsrast_tpu.scene.gaussians import merge_params, split_params


def make_camera(w=256, h=32):
    return Camera(
        view=look_at(jnp.array([0.0, 0.0, -4.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2),
        fov_y=jnp.float32(1.0),
        width=w,
        height=h,
    )


def pallas_cfg(**kw):
    base = dict(
        max_per_tile=1024,
        tile_chunk=4,
        intersect_capacity_factor=32.0,
        background=(0.1, 0.2, 0.3),
        interpret=True,
    )
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def scene_aniso():
    return random_scene(jax.random.PRNGKey(7), 60, sh_degree=2,
                        isotropic=False, scale_range=(0.05, 0.3))


class TestPallasForward:
    def test_matches_xla(self, scene_aniso):
        cam = make_camera()
        cfg = pallas_cfg()
        xla = render_tiled_xla(scene_aniso.activated(), cam, cfg)
        pal = render_tiled_pallas(scene_aniso.activated(), cam, cfg)
        np.testing.assert_allclose(pal.image, xla.image, atol=3e-6)
        np.testing.assert_allclose(pal.final_t, xla.final_t, atol=3e-6)
        np.testing.assert_array_equal(pal.n_contrib, xla.n_contrib)

    def test_empty_scene_background(self):
        scene = random_scene(jax.random.PRNGKey(0), 4, sh_degree=0)
        scene = scene.replace(means=scene.means + jnp.array([0.0, 0.0, -50.0]))
        cam = make_camera(128, 16)
        cfg = pallas_cfg()
        out = render_tiled_pallas(scene.activated(), cam, cfg)
        np.testing.assert_allclose(
            out.image, np.broadcast_to([0.1, 0.2, 0.3], (16, 128, 3)), atol=1e-6
        )

    def test_saturated_early_exit(self):
        """Many opaque gaussians stacked at the center: per-pixel early
        termination must clamp n_contrib well below N."""
        n = 64
        scene = random_scene(jax.random.PRNGKey(1), n, sh_degree=0)
        scene = scene.replace(
            means=jnp.tile(jnp.array([[0.0, 0.0, 0.0]]), (n, 1))
            + jnp.linspace(0, 0.5, n)[:, None] * jnp.array([0.0, 0.0, 1.0]),
            log_scales=jnp.log(jnp.full((n, 3), 0.3)),
            quats=jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (n, 1)),
            opacity_logits=jnp.full((n,), 4.0),  # ~0.982 opacity
        )
        cam = make_camera(128, 16)
        cfg = pallas_cfg()
        xla = render_tiled_xla(scene.activated(), cam, cfg)
        pal = render_tiled_pallas(scene.activated(), cam, cfg)
        center_nc = int(pal.n_contrib[8, 64])
        assert center_nc < n // 2  # early termination kicked in
        np.testing.assert_array_equal(pal.n_contrib, xla.n_contrib)
        np.testing.assert_allclose(pal.image, xla.image, atol=3e-6)


class TestLargeTiles:
    """Tiles up to MAX_TILE_PIXELS (four pixels a thread in the forward):
    image, final_t, n_contrib and gradients must match the XLA oracle
    exactly like the default 16x16 tile does."""

    @pytest.mark.parametrize("tile", [(32, 32), (8, 128)])
    def test_large_tile_forward_and_grads(self, scene_aniso, tile):
        cam = make_camera(128, 64)
        cfg = pallas_cfg(tile_h=tile[0], tile_w=tile[1],
                         tiers=((2, 1.0), (8, 0.5), (32, 0.25)))
        assert cfg.tile_h * cfg.tile_w == pb.MAX_TILE_PIXELS
        xla = render_tiled_xla(scene_aniso.activated(), cam, cfg)
        pal = render_tiled_pallas(scene_aniso.activated(), cam, cfg)
        np.testing.assert_allclose(pal.image, xla.image, atol=3e-6)
        np.testing.assert_allclose(pal.final_t, xla.final_t, atol=3e-6)
        np.testing.assert_array_equal(pal.n_contrib, xla.n_contrib)

        params, mask = split_params(scene_aniso)
        target = jnp.full((64, 128, 3), 0.25)

        def loss(p, renderer):
            scene = merge_params(p, mask)
            out = renderer(scene.activated(), cam, cfg)
            return (jnp.mean((out.image - target) ** 2)
                    + 0.1 * jnp.mean(out.final_t))

        g_pal = jax.grad(lambda p: loss(p, render_tiled_pallas))(params)
        g_xla = jax.grad(lambda p: loss(p, render_tiled_xla))(params)
        for name in params:
            a, b = g_pal[name], g_xla[name]
            scale = max(float(jnp.max(jnp.abs(b))), 1e-8)
            np.testing.assert_allclose(
                a / scale, b / scale, atol=2e-5,
                err_msg=f"{tile} tile grad mismatch: {name}")


class TestPallasBackward:
    def test_grads_match_xla_autodiff(self, scene_aniso):
        cam = make_camera()
        cfg = pallas_cfg()
        params, mask = split_params(scene_aniso)
        target = jnp.full((32, 256, 3), 0.25)

        def loss(p, renderer):
            scene = merge_params(p, mask)
            out = renderer(scene.activated(), cam, cfg)
            return (
                jnp.mean((out.image - target) ** 2)
                + 0.1 * jnp.mean(out.final_t)
            )

        g_pal = jax.grad(lambda p: loss(p, render_tiled_pallas))(params)
        g_xla = jax.grad(lambda p: loss(p, render_tiled_xla))(params)
        for name in params:
            a, b = g_pal[name], g_xla[name]
            scale = max(float(jnp.max(jnp.abs(b))), 1e-8)
            np.testing.assert_allclose(
                a / scale, b / scale, atol=2e-5,
                err_msg=f"pallas grad mismatch: {name}",
            )
            assert float(jnp.max(jnp.abs(a))) > 0.0, f"zero pallas grad: {name}"


class TestBackendChoice:
    @pytest.mark.parametrize("platform,backend", [
        ("gpu", "pallas"), ("cpu", "xla"), ("metal", None), ("rocm", None)])
    def test_platform_to_backend(self, platform, backend):
        if backend is None:
            with pytest.raises(ValueError, match="no render backend"):
                default_backend(platform)
        else:
            assert default_backend(platform) == backend

    def test_current_platform(self):
        assert default_backend() == "xla"  # the test suite runs on the CPU

    @pytest.mark.parametrize("fn", ["blend_forward", "blend_backward"])
    def test_gpu_never_interprets(self, monkeypatch, fn):
        """The kernels refuse interpret=True where they would run compiled;
        nothing infers interpret from the platform."""
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        feat = jnp.zeros((pb.FROWS, 128), jnp.float32)
        starts = jnp.zeros((2,), jnp.int32)
        args = (feat, starts)
        if fn == "blend_backward":
            args += (jnp.zeros((1, 8, 256), jnp.float32),)
        with pytest.raises(ValueError, match="interpret"):
            getattr(pb, fn)(*args, 1, 1, 16, 16, interpret=True)
        assert not RenderConfig().interpret

    @pytest.mark.parametrize("tile", [(16, 24), (12, 16), (64, 32)])
    def test_tile_shape_guard(self, tile):
        with pytest.raises(ValueError):
            pb.check_tile_shape(*tile)
