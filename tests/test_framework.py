"""Framework-surface tests: compositor nesting, pose store, inspector
reports, image IO, debug viz modes, CLI apps (SURVEY.md §2.1/2.2/2.4 parity:
Framebuffer/fbtest, Database/pose table, Inspector panels, GSPointCloud,
GSEllipsoids, spheretrace diagnostics)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsrast_tpu import Camera, random_scene
from gsrast_tpu.camera import debug_camera, look_at, pose_from_dict, pose_to_dict
from gsrast_tpu.utils import compositor
from gsrast_tpu.utils.image import load_png, save_png, screenshot, to_uint8
from gsrast_tpu.utils.inspector import (FrameStats, camera_report,
                                        peek_gaussian, scene_report)
from gsrast_tpu.utils.posedb import PoseDB, Store
from gsrast_tpu.viz.ellipsoids import render_ellipsoids
from gsrast_tpu.viz.pointcloud import render_pointcloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    return random_scene(jax.random.PRNGKey(5), 64, sh_degree=1,
                        scale_range=(0.05, 0.2))


@pytest.fixture(scope="module")
def camera():
    return Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0),
        width=64, height=48,
    )


class TestCompositor:
    def test_blit_clips(self):
        parent = compositor.solid(10, 10, (0.0, 0.0, 0.0))
        child = jnp.ones((4, 4, 3))
        out = compositor.blit(parent, child, y=8, x=8)
        assert float(out[9, 9, 0]) == 1.0
        assert float(out[7, 7, 0]) == 0.0
        # fully off-screen: unchanged
        out2 = compositor.blit(parent, child, y=20, x=0)
        assert np.allclose(np.asarray(out2), 0.0)

    def test_nested_stack_composites(self):
        # the fbtest scenario: inner target composited into outer at (2, 3)
        stack = compositor.RenderStack(8, 8, clear=(0.5, 0.0, 0.0))
        stack.push(2, 2, y=2, x=3)
        stack.draw(jnp.ones((2, 2, 3)))
        stack.pop()
        img = np.asarray(stack.image)
        assert np.allclose(img[2:4, 3:5], 1.0)
        assert np.allclose(img[0, 0], [0.5, 0.0, 0.0])

    def test_resize_nearest(self):
        img = jnp.arange(4.0).reshape(2, 2, 1)
        up = compositor.resize_nearest(img, 4, 4)
        assert up.shape == (4, 4, 1)
        assert float(up[0, 0, 0]) == 0.0 and float(up[3, 3, 0]) == 3.0

    def test_overlay_alpha(self):
        parent = compositor.solid(4, 4, (1.0, 1.0, 1.0))
        child = jnp.concatenate(
            [jnp.zeros((2, 2, 3)), jnp.full((2, 2, 1), 0.5)], axis=-1
        )
        out = compositor.overlay(parent, child)
        assert np.allclose(np.asarray(out[0, 0]), 0.5)
        assert np.allclose(np.asarray(out[3, 3]), 1.0)


class TestPoseStore:
    def test_roundtrip_and_hidden_keys(self, tmp_path, camera):
        store = Store(str(tmp_path / "db.json"))
        store.put("t", "__hidden", 1)
        store.put("t", "visible", 2)
        assert [k for k, _ in store.iterate("t")] == ["visible"]
        assert [k for k, _ in store.iterate("t", include_hidden=True)] == [
            "__hidden", "visible"]
        db = PoseDB(store=store)
        db.save("home", camera)
        # reload from disk through a fresh store (persistence)
        db2 = PoseDB(path=str(tmp_path / "db.json"))
        cam2 = db2.load("home")
        assert cam2 is not None
        np.testing.assert_allclose(
            np.asarray(cam2.view), np.asarray(camera.view), atol=1e-6)
        assert db2.delete("home") and db2.load("home") is None

    def test_pose_dict_roundtrip(self, camera):
        cam2 = pose_from_dict(json.loads(json.dumps(pose_to_dict(camera))))
        np.testing.assert_allclose(
            np.asarray(cam2.view), np.asarray(camera.view), atol=1e-6)
        assert cam2.width == camera.width


class TestInspector:
    def test_scene_report(self, scene):
        rep = scene_report(scene)
        assert rep["num_active"] == 64
        assert rep["bytes"]["means"] == 64 * 3 * 4
        assert rep["bytes"]["total"] > 0

    def test_camera_report(self, camera):
        rep = camera_report(camera)
        assert rep["width"] == 64

    def test_peek_gaussian(self, scene, camera):
        rep = peek_gaussian(scene, camera, 3)
        # the reference CUDA panel's fields (Inspector.cpp:180-209)
        for key in ("depth", "radius", "mean2d", "conic", "color",
                    "tiles_touched", "rect", "raw"):
            assert key in rep, key

    def test_frame_stats(self):
        fs = FrameStats(window_seconds=100.0)
        for _ in range(5):
            fs.record(0.01, pixels=1000)
        rep = fs.report()
        assert rep["frames"] == 5
        assert rep["fps"] == pytest.approx(100.0, rel=0.05)


class TestImageIO:
    def test_png_roundtrip(self, tmp_path):
        img = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)
        p = save_png(img, str(tmp_path / "x.png"))
        back = load_png(p)
        np.testing.assert_allclose(back, img, atol=1.0 / 255.0)

    def test_screenshot_timestamped(self, tmp_path):
        p = screenshot(np.zeros((4, 4, 3), np.float32), str(tmp_path))
        assert os.path.exists(p) and p.endswith(".png")

    def test_to_uint8_clips(self):
        out = to_uint8(np.asarray([[-1.0, 2.0]]))
        assert out.min() == 0 and out.max() == 255

    @pytest.mark.parametrize("channels", [3, 4])
    def test_png_codec_roundtrip_exact(self, channels):
        from gsrast_tpu.utils.image import decode_png, encode_png

        img = np.random.default_rng(channels).integers(
            0, 256, (13, 29, channels), dtype=np.uint8)
        data = encode_png(img)
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(decode_png(data), img)

    @pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
    def test_png_decodes_every_row_filter(self, ftype):
        """Rows filtered by Sub/Up/Average/Paeth (as other encoders write
        them) decode to the original pixels."""
        import struct
        import zlib

        from gsrast_tpu.utils.image import _chunk, _paeth, decode_png

        img = np.random.default_rng(ftype).integers(
            0, 256, (6, 7, 3), dtype=np.uint8)
        h, w, bpp = img.shape
        raw = img.reshape(h, w * bpp).astype(np.int32)
        rows = []
        for y in range(h):
            cur = raw[y]
            up = raw[y - 1] if y else np.zeros_like(cur)
            left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
            pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
                    4: _paeth(left, up, upleft)}[ftype]
            rows.append(bytes([ftype]) + ((cur - pred) & 0xFF)
                        .astype(np.uint8).tobytes())
        png = (b"\x89PNG\r\n\x1a\n"
               + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
               + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
               + _chunk(b"IEND", b""))
        np.testing.assert_array_equal(decode_png(png), img)

    def test_png_fixture_decodes(self):
        golden = os.path.join(os.path.dirname(__file__), "fixtures",
                              "trained_small_golden.png")
        img = load_png(golden)
        assert img.shape == (128, 128, 3) and img.dtype == np.float32
        assert 0.0 < float(img.mean()) < 1.0


class TestVizModes:
    def test_pointcloud_renders_points(self, scene, camera):
        img = render_pointcloud(scene.activated(), camera)
        assert img.shape == (48, 64, 3)
        assert float(jnp.max(img)) > 0.0  # something was drawn

    def test_ellipsoids_depth_and_cull(self, camera):
        # two overlapping ellipsoids; the nearer one must win the z-test
        from gsrast_tpu.scene.gaussians import from_arrays
        scene = from_arrays(
            means=np.asarray([[0, 0, 0], [0, 0, -1.0]], np.float32),
            log_scales=np.log(np.full((2, 3), 0.4, np.float32)),
            quats=np.asarray([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32),
            opacity_logits=np.asarray([4.0, 4.0], np.float32),
            sh=np.asarray([[[2.0, -1.0, -1.0]], [[-1.0, 2.0, -1.0]]],
                          np.float32),
        )
        img = np.asarray(render_ellipsoids(scene.activated(), camera))
        cy, cx = 24, 32
        # nearer ellipsoid (index 1, green-ish SH) covers the center
        assert img[cy, cx, 1] > img[cy, cx, 0]

    def test_debug_camera_deterministic(self):
        c1, c2 = debug_camera(), debug_camera()
        np.testing.assert_array_equal(np.asarray(c1.view), np.asarray(c2.view))


class TestFirstPersonController:
    """The WASD/mouse-look/speed state machine (reference
    FirstPersonCamera.cpp:28-100, Window.cpp:110-128)."""

    def test_forward_moves_along_front(self):
        from gsrast_tpu.camera import fp_camera, fp_init, fp_move

        st = fp_init([0.0, 0.0, 0.0], yaw=0.0, pitch=0.0, speed=2.0)
        st2 = fp_move(st, forward=1.0, dt=0.5)  # 1 unit along +x (yaw=0)
        np.testing.assert_allclose(np.asarray(st2.eye), [1.0, 0.0, 0.0],
                                   atol=1e-6)
        cam = fp_camera(st2, 64, 48)
        assert cam.width == 64 and np.isfinite(np.asarray(cam.view)).all()

    def test_strafe_is_perpendicular(self):
        from gsrast_tpu.camera import fp_init, fp_move

        st = fp_init([0.0, 0.0, 0.0], yaw=0.0, speed=1.0)
        fwd = np.asarray(fp_move(st, forward=1.0, dt=1.0).eye)
        side = np.asarray(fp_move(st, strafe=1.0, dt=1.0).eye)
        assert abs(float(np.dot(fwd, side))) < 1e-5

    def test_pitch_clamped(self):
        from gsrast_tpu.camera import fp_init, fp_look

        st = fp_init([0.0, 0.0, 0.0])
        for _ in range(10):
            st = fp_look(st, 0.0, 1000.0)
        assert float(st.pitch) <= np.pi / 2 - 0.049

    def test_speed_doubling(self):
        from gsrast_tpu.camera import fp_init, fp_move, fp_speed

        st = fp_init([0.0, 0.0, 0.0], speed=1.0)
        st = fp_speed(st, 2.0)
        assert float(st.speed) == 2.0
        d = np.linalg.norm(np.asarray(fp_move(st, forward=1.0, dt=1.0).eye))
        np.testing.assert_allclose(d, 2.0, atol=1e-6)

    def test_invert_up_flips_strafe(self):
        from gsrast_tpu.camera import fp_init, fp_move

        a = fp_move(fp_init([0, 0, 0], invert_up=True), strafe=1.0, dt=1.0)
        b = fp_move(fp_init([0, 0, 0], invert_up=False), strafe=1.0, dt=1.0)
        np.testing.assert_allclose(np.asarray(a.eye), -np.asarray(b.eye),
                                   atol=1e-6)


class TestApps:
    def _run(self, args, cwd=REPO):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable] + args, cwd=cwd, env=env,
            capture_output=True, text=True, timeout=600,
        )

    def test_spheretrace_diagnostics(self, tmp_path):
        r = self._run(["apps/spheretrace.py", "--out",
                       str(tmp_path / "st.png")])
        assert r.returncode == 0, r.stderr[-2000:]
        assert "projected axes" in r.stdout
        assert os.path.exists(tmp_path / "st.png")

    def test_fbtest(self, tmp_path):
        r = self._run(["apps/fbtest.py", str(tmp_path / "fb.png")])
        assert r.returncode == 0, r.stderr[-2000:]
        assert os.path.exists(tmp_path / "fb.png")


class TestDistributedBootstrap:
    def test_single_process_noop(self):
        from gsrast_tpu.parallel.mesh import initialize_distributed

        initialize_distributed(None, 1, 0)  # must not raise or init anything

    def test_cli_dist_flag_parses_and_forwards(self, monkeypatch):
        import gsrast_tpu.parallel.mesh as mesh_mod

        calls = {}

        def fake_init(coordinator_address=None, num_processes=None,
                      process_id=None):
            calls.update(addr=coordinator_address, n=num_processes,
                         pid=process_id)

        monkeypatch.setattr(jax.distributed, "initialize", fake_init)
        from gsrast_tpu.cli import _maybe_distributed

        class A:
            dist = "10.0.0.1:1234,4,2"

        _maybe_distributed(A())
        assert calls == {"addr": "10.0.0.1:1234", "n": 4, "pid": 2}
