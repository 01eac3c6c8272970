"""The blend kernels compiled for a CUDA device.

Marked `gpu`: each test asks for the `cuda_device` fixture, which skips
unless JAX runs on a GPU. Run them on the card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py`
(`python chip_smoke.py` does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsrast_tpu import Camera, RenderConfig, random_scene
from gsrast_tpu.camera import look_at
from gsrast_tpu.render import pallas_blend as pb
from gsrast_tpu.render.api import auto_render_config, default_backend
from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
from gsrast_tpu.render.tiled import render_tiled_xla
from gsrast_tpu.scene.gaussians import merge_params, split_params

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device (JAX_PLATFORMS=cuda)")
    return jax.devices()[0]


def _scene_camera():
    scene = random_scene(jax.random.PRNGKey(7), 2000, sh_degree=2,
                         isotropic=False, scale_range=(0.02, 0.1))
    cam = Camera(view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
                 fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0),
                 width=256, height=128)
    return scene, cam


def test_gpu_picks_compiled_kernels(cuda_device):
    scene, cam = _scene_camera()
    assert default_backend() == "pallas"
    rcfg = auto_render_config(scene, cam)
    assert rcfg.backend == "pallas" and not rcfg.interpret


def test_gpu_refuses_interpret(cuda_device):
    feat = jnp.zeros((pb.FROWS, 128), jnp.float32)
    with pytest.raises(ValueError, match="interpret"):
        pb.blend_forward(feat, jnp.zeros((2,), jnp.int32), 1, 1, 16, 16,
                         interpret=True)


@pytest.mark.parametrize("tile", [(16, 16), (32, 32)])
def test_compiled_kernels_match_oracle(cuda_device, tile):
    scene, cam = _scene_camera()
    cfg = RenderConfig(tile_h=tile[0], tile_w=tile[1], max_per_tile=4096,
                       tile_chunk=4, intersect_capacity_factor=32.0,
                       background=(0.1, 0.2, 0.3))
    params, mask = split_params(scene)
    target = jnp.full((cam.height, cam.width, 3), 0.25)

    def loss(p, renderer):
        out = renderer(merge_params(p, mask).activated(), cam, cfg)
        return (jnp.mean((out.image - target) ** 2)
                + 0.1 * jnp.mean(out.final_t)), out

    with jax.default_matmul_precision("highest"):
        (_, ref), g_ref = jax.jit(jax.value_and_grad(
            lambda p: loss(p, render_tiled_xla), has_aux=True))(params)
    (_, out), g = jax.jit(jax.value_and_grad(
        lambda p: loss(p, render_tiled_pallas), has_aux=True))(params)
    assert int(ref.stats["overflow_per_tile"]) == 0
    np.testing.assert_allclose(out.image, ref.image, atol=1e-4)
    np.testing.assert_allclose(out.final_t, ref.final_t, atol=1e-4)
    assert np.mean(np.asarray(out.n_contrib) == np.asarray(ref.n_contrib)) \
        >= 0.9999
    for k in g:
        a, b = np.asarray(g[k]), np.asarray(g_ref[k])
        assert np.abs(a - b).max() / max(np.abs(b).max(), 1e-30) < 1e-3, k
