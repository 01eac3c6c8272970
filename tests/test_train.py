"""Training-loop tests: loss decreases, densify/prune/opacity-reset
mechanics, checkpoint save/restore determinism (SURVEY.md §4 tier for
BASELINE config 4 — capabilities beyond the forward-only reference)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsrast_tpu import Camera, RenderConfig, random_scene
from gsrast_tpu.camera import look_at
from gsrast_tpu.render.api import render
from gsrast_tpu.scene.gaussians import split_params
from gsrast_tpu.train import checkpoint as ckpt
from gsrast_tpu.train import densify as densify_mod
from gsrast_tpu.train.loss import psnr, rgb_loss, ssim
from gsrast_tpu.train.trainer import (TrainConfig, init_train_state,
                                      make_optimizer, make_train_step,
                                      maybe_densify)


def make_camera(w=64, h=64):
    return Camera(
        view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
        fov_x=jnp.float32(1.0), fov_y=jnp.float32(1.0), width=w, height=h,
    )


CFG = RenderConfig(tile_h=8, tile_w=16, max_per_tile=256, tile_chunk=8,
                   intersect_capacity_factor=16.0)


@pytest.fixture(scope="module")
def setup():
    target_scene = random_scene(jax.random.PRNGKey(1), 48, sh_degree=0,
                                scale_range=(0.05, 0.15))
    camera = make_camera()
    target = render(target_scene.activated(), camera, CFG).image
    # start from a perturbed copy of the target scene
    init = target_scene.replace(
        means=target_scene.means
        + 0.03 * jax.random.normal(jax.random.PRNGKey(2),
                                   target_scene.means.shape),
        opacity_logits=target_scene.opacity_logits - 0.5,
    )
    return init, camera, target


class TestLosses:
    def test_ssim_identity(self):
        img = jax.random.uniform(jax.random.PRNGKey(0), (32, 32, 3))
        assert float(ssim(img, img)) == pytest.approx(1.0, abs=1e-4)

    def test_ssim_decreases_with_noise(self):
        img = jax.random.uniform(jax.random.PRNGKey(0), (32, 32, 3))
        noisy = img + 0.3 * jax.random.normal(jax.random.PRNGKey(1), img.shape)
        assert float(ssim(img, noisy)) < 0.9

    def test_psnr(self):
        a = jnp.zeros((8, 8, 3))
        b = jnp.full((8, 8, 3), 0.1)
        assert float(psnr(a, b)) == pytest.approx(20.0, abs=0.1)

    def test_rgb_loss_zero_at_match(self):
        img = jax.random.uniform(jax.random.PRNGKey(0), (16, 16, 3))
        assert float(rgb_loss(img, img, 0.2)) == pytest.approx(0.0, abs=1e-5)


class TestTrainStep:
    def test_loss_decreases(self, setup):
        scene, camera, target = setup
        tc = TrainConfig()
        opt = make_optimizer(tc, scene_extent=1.0)
        state = init_train_state(scene, opt)
        step = jax.jit(make_train_step(CFG, tc, opt))
        state, m0 = step(state, camera, target)
        for _ in range(20):
            state, m = step(state, camera, target)
        assert float(m["loss"]) < float(m0["loss"])
        assert int(state.step) == 21
        assert bool(jnp.isfinite(m["psnr"]))

    def test_dead_slots_stay_frozen(self, setup):
        scene, camera, target = setup
        scene = scene.replace(mask=scene.mask.at[40:].set(False))
        tc = TrainConfig()
        opt = make_optimizer(tc, scene_extent=1.0)
        state = init_train_state(scene, opt)
        step = jax.jit(make_train_step(CFG, tc, opt))
        before = np.asarray(scene.means[40:])
        state, _ = step(state, camera, target)
        np.testing.assert_array_equal(np.asarray(state.scene.means[40:]),
                                      before)


class TestDensify:
    def test_densify_adds_and_opacity_reset(self, setup):
        scene, camera, target = setup
        tc = TrainConfig(densify_from=1, densify_every=1,
                         grad_threshold=1e-12, opacity_reset_every=10**9)
        opt = make_optimizer(tc, scene_extent=1.0)
        state = init_train_state(scene, opt)
        step = jax.jit(make_train_step(CFG, tc, opt))
        state, _ = step(state, camera, target)
        n0 = int(state.scene.num_active())
        state2, info = maybe_densify(state, tc, jax.random.PRNGKey(0), 1.0,
                                     opt)
        assert int(state2.scene.num_active()) >= n0  # clones/splits >= prunes

    def test_adam_moments_survive_densify(self, setup):
        """Moment surgery: untouched Gaussians keep their Adam mu/nu across a
        densify step; changed slots are zeroed."""
        scene, camera, target = setup
        from gsrast_tpu.scene.gaussians import pad_to_capacity

        scene = pad_to_capacity(scene, scene.capacity + 16)  # free slots
        tc = TrainConfig(densify_from=1, densify_every=1,
                         grad_threshold=1e-12, opacity_reset_every=10**9)
        opt = make_optimizer(tc, scene_extent=1.0)
        state = init_train_state(scene, opt)
        step = jax.jit(make_train_step(CFG, tc, opt))
        state, _ = step(state, camera, target)
        state2, info = maybe_densify(state, tc, jax.random.PRNGKey(0), 1.0,
                                     opt)
        assert info is not None
        changed = np.asarray(info["changed_slots"])
        assert changed.any()  # grad_threshold=0 forces clones/splits
        assert not changed.all()
        mu_old = state.opt_state.inner_states["means"].inner_state[0].mu
        mu_new = state2.opt_state.inner_states["means"].inner_state[0].mu
        keep = ~changed
        np.testing.assert_array_equal(
            np.asarray(mu_old["means"])[keep], np.asarray(mu_new["means"])[keep]
        )
        assert np.all(np.asarray(mu_new["means"])[changed] == 0.0)
        # mu of a stepped state is non-zero somewhere in the kept set, so the
        # equality above is not vacuous.
        assert np.any(np.asarray(mu_old["means"])[keep] != 0.0)

    def test_opacity_reset_zeroes_only_opacity_moments(self, setup):
        scene, camera, target = setup
        tc = TrainConfig(densify_from=10**9, opacity_reset_every=1)
        opt = make_optimizer(tc, scene_extent=1.0)
        state = init_train_state(scene, opt)
        step = jax.jit(make_train_step(CFG, tc, opt))
        state, _ = step(state, camera, target)
        state2, _ = maybe_densify(state, tc, jax.random.PRNGKey(0), 1.0, opt)
        mu_op = state2.opt_state.inner_states["opacity"].inner_state[0].mu
        assert np.all(np.asarray(mu_op["opacity_logits"]) == 0.0)
        mu_means = state2.opt_state.inner_states["means"].inner_state[0].mu
        old_means = state.opt_state.inner_states["means"].inner_state[0].mu
        np.testing.assert_array_equal(
            np.asarray(mu_means["means"]), np.asarray(old_means["means"])
        )

    def test_opacity_reset_caps(self, setup):
        scene, _, _ = setup
        out = densify_mod.reset_opacity(scene, max_opacity=0.01)
        ops = jax.nn.sigmoid(out.opacity_logits)
        assert float(jnp.max(jnp.where(out.mask, ops, 0.0))) <= 0.011


class TestMultiView:
    def test_dataset_roundtrip(self, setup, tmp_path):
        scene, _, _ = setup
        from gsrast_tpu.scene.dataset import (load_dataset,
                                              render_synthetic_dataset)

        path, cams = render_synthetic_dataset(
            scene, str(tmp_path / "ds"), n_views=4, width=64, height=64,
            render_cfg=CFG,
        )
        ds = load_dataset(path)
        assert ds.num_frames == 4
        assert ds.images.shape == (4, 64, 64, 3)
        np.testing.assert_allclose(
            np.asarray(ds.cameras[2].view), np.asarray(cams[2].view),
            atol=1e-6,
        )
        # PNG quantization bounds the roundtrip error
        from gsrast_tpu.render.api import render
        img = render(scene.activated(), ds.cameras[1], CFG).image
        assert float(jnp.max(jnp.abs(
            jnp.clip(img, 0.0, 1.0) - ds.images[1]
        ))) <= 1.5 / 255.0

    def test_multiview_train_psnr_rises(self, setup, tmp_path):
        """Round-robin multi-view training on >= 8 synthetic views fits the
        scene."""
        scene, _, _ = setup
        from gsrast_tpu.scene.dataset import (load_dataset,
                                              render_synthetic_dataset)

        path, _ = render_synthetic_dataset(
            scene, str(tmp_path / "ds"), n_views=8, width=64, height=64,
            render_cfg=CFG,
        )
        ds = load_dataset(path)
        init = scene.replace(
            means=scene.means + 0.02 * jax.random.normal(
                jax.random.PRNGKey(7), scene.means.shape),
        )
        tc = TrainConfig(densify_from=10**9, opacity_reset_every=10**9)
        opt = make_optimizer(tc, scene_extent=1.0)
        state = init_train_state(init, opt)
        step = jax.jit(make_train_step(CFG, tc, opt))

        def mean_psnr(st):
            vals = []
            for i in range(ds.num_frames):
                from gsrast_tpu.render.api import render
                img = render(st.scene.activated(), ds.cameras[i], CFG).image
                vals.append(float(psnr(img, jnp.asarray(ds.images[i]))))
            return sum(vals) / len(vals)

        before = mean_psnr(state)
        for i in range(60):
            cam = ds.cameras[i % ds.num_frames]
            tgt = jnp.asarray(ds.images[i % ds.num_frames])
            state, metrics = step(state, cam, tgt)
        after = mean_psnr(state)
        assert after > before + 1.0, (before, after)


class TestResilience:
    def _loop_pieces(self, setup):
        scene, camera, target = setup
        tc = TrainConfig(densify_from=10**9, opacity_reset_every=10**9)
        opt = make_optimizer(tc, scene_extent=1.0)
        state = init_train_state(scene, opt)
        step = jax.jit(make_train_step(CFG, tc, opt))
        return state, lambda st, i: step(st, camera, target)

    def test_nan_rollback_recovers(self, setup, tmp_path):
        """A poisoned step must be detected, rolled back to the last good
        checkpoint, and training must continue to completion (SURVEY §5
        failure-detection subsystem; fault injection)."""
        from gsrast_tpu.train.resilience import ResilienceConfig, run_resilient

        state, fn = self._loop_pieces(setup)
        rc = ResilienceConfig(
            ckpt_dir=str(tmp_path / "ck"), ckpt_every=5,
            heartbeat_path=str(tmp_path / "hb.json"), heartbeat_every=5,
            inject_nan_at_step=7,
        )
        final, stopped = run_resilient(state, 12, fn, rc, log=lambda s: None)
        assert not stopped
        assert int(final.step) == 12
        assert bool(jnp.all(jnp.isfinite(final.scene.means)))

    def test_nan_persistent_aborts(self, setup, tmp_path):
        from gsrast_tpu.train.resilience import ResilienceConfig, run_resilient

        state, fn = self._loop_pieces(setup)

        def poisoned(st, i):
            st2, m = fn(st, i)
            return st2._replace(
                scene=st2.scene.replace(means=st2.scene.means * jnp.nan)
            ), m

        rc = ResilienceConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=100,
                              max_rollbacks=2)
        with pytest.raises(RuntimeError, match="non-finite"):
            run_resilient(state, 5, poisoned, rc, log=lambda s: None)

    def test_preemption_checkpoints_and_stops(self, setup, tmp_path):
        import os
        import signal

        from gsrast_tpu.train import checkpoint as ckpt_mod
        from gsrast_tpu.train.resilience import ResilienceConfig, run_resilient

        state, fn = self._loop_pieces(setup)

        def fn_with_sigterm(st, i):
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)  # simulated eviction
            return fn(st, i)

        rc = ResilienceConfig(
            ckpt_dir=str(tmp_path / "ck"), ckpt_every=10**9,
            heartbeat_path=str(tmp_path / "hb.json"),
        )
        final, stopped = run_resilient(state, 100, fn_with_sigterm, rc,
                                       log=lambda s: None)
        assert stopped
        assert int(final.step) == 4
        assert ckpt_mod.latest_step(str(tmp_path / "ck")) == 4
        from gsrast_tpu.train.resilience import read_heartbeat
        hb = read_heartbeat(str(tmp_path / "hb.json"))
        assert hb is not None and hb["step"] == 4


class TestCheckpoint:
    def test_save_restore_roundtrip(self, setup, tmp_path):
        scene, camera, target = setup
        tc = TrainConfig()
        opt = make_optimizer(tc, scene_extent=1.0)
        state = init_train_state(scene, opt)
        step = jax.jit(make_train_step(CFG, tc, opt))
        state, _ = step(state, camera, target)
        state, _ = step(state, camera, target)

        path = ckpt.save(str(tmp_path), state)
        assert os.path.isdir(path)
        assert ckpt.latest_step(str(tmp_path)) == 2

        template = init_train_state(scene, opt)
        restored = ckpt.restore(str(tmp_path), template)
        assert int(restored.step) == 2
        np.testing.assert_allclose(np.asarray(restored.scene.means),
                                   np.asarray(state.scene.means), atol=0)

        # deterministic resume: one more step from restored == from original
        s1, m1 = step(state, camera, target)
        s2, m2 = step(restored, camera, target)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(s1.scene.means),
                                   np.asarray(s2.scene.means), atol=1e-7)

    def test_npz_layout_and_pruning(self, setup, tmp_path):
        """One `step_XXXXXXXX/state.npz` per saved step holding every leaf
        of the TrainState; only the newest `keep` steps survive; a
        template of another structure is refused."""
        scene, _, _ = setup
        opt = make_optimizer(TrainConfig(), scene_extent=1.0)
        state = init_train_state(scene, opt)
        for k in range(4):
            ckpt.save(str(tmp_path), state._replace(step=jnp.int32(k)),
                      keep=2)
        assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                                "step_00000003"]
        with np.load(tmp_path / "step_00000003" / "state.npz") as z:
            assert len(z.files) == len(jax.tree.leaves(state))
        restored = ckpt.restore(str(tmp_path), state)
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
            assert a.dtype == b.dtype and a.shape == b.shape
        assert int(restored.step) == 3
        with pytest.raises(ValueError, match="leaves"):
            ckpt.restore(str(tmp_path), {"only": jnp.zeros(3)})

    def test_restore_missing_returns_none(self, setup, tmp_path):
        scene, _, _ = setup
        opt = make_optimizer(TrainConfig(), scene_extent=1.0)
        template = init_train_state(scene, opt)
        assert ckpt.restore(str(tmp_path / "nope"), template) is None
