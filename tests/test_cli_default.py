"""The CLI's default render path IS the flagship fused multi-tier path.

`python -m gsrast_tpu render/train` must run
plan_tiers/fused_pack with auto-derived tiers — not the legacy two-tier
path with hand-set K. These tests pin that: the auto config carries a
non-empty tier spec, and the CLI's PNG equals a direct render through the
fused path.
"""

import numpy as np
import jax

from gsrast_tpu import cli
from gsrast_tpu.camera import auto_frame
from gsrast_tpu.render.api import auto_render_config, render
from gsrast_tpu.scene.gaussians import random_scene
from gsrast_tpu.scene.ply import save_ply
from gsrast_tpu.utils.image import load_png


def _tiny_scene():
    return random_scene(jax.random.PRNGKey(3), 500, sh_degree=1)


class TestCliDefaultIsFused:
    def test_auto_config_uses_tiers(self):
        scene = _tiny_scene()
        mn, mx = scene.bbox()
        cam = auto_frame(mn, mx, 128, 128)
        rcfg = auto_render_config(scene, cam, "xla")
        assert rcfg.tiers, "product default must be the fused tier path"
        # k cap derives from the scene's own max tile count, not a hand-set
        # constant.
        assert rcfg.tiers[-1][0] >= 1

    def test_cli_render_matches_flagship(self, tmp_path):
        scene = _tiny_scene()
        ply = str(tmp_path / "s.ply")
        save_ply(scene, ply)
        out = str(tmp_path / "r.png")
        cli.cmd_render([ply, "--out", out, "--width", "128",
                        "--height", "128", "--backend", "xla"])
        got = np.asarray(load_png(out))

        loaded = cli._load(ply)
        mn, mx = loaded.bbox()
        cam = auto_frame(mn, mx, 128, 128)
        rcfg = auto_render_config(loaded, cam, "xla")
        assert rcfg.tiers
        want = np.asarray(render(loaded.activated(), cam, rcfg).image)
        # PNG quantizes to 8 bits.
        np.testing.assert_allclose(got, np.clip(want, 0, 1), atol=1.5 / 255)

    def test_cli_train_builds_auto_cfg(self, tmp_path, monkeypatch):
        """`train` derives its RenderConfig through _auto_cfg (fused tiers)."""
        scene = _tiny_scene()
        ply = str(tmp_path / "s.ply")
        save_ply(scene, ply)
        seen = {}
        real = cli._auto_cfg

        def spy(args, scene_, camera_, margin=1.12):
            rcfg = real(args, scene_, camera_, margin=margin)
            seen["tiers"] = rcfg.tiers
            return rcfg

        monkeypatch.setattr(cli, "_auto_cfg", spy)
        cli.cmd_train(["--scene", ply, "--steps", "2", "--width", "64",
                       "--height", "64", "--backend", "xla",
                       "--ckpt-dir", str(tmp_path / "ck"),
                       "--ckpt-every", "1000"])
        assert seen.get("tiers"), "train must run the fused tier path"
