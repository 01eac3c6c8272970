#!/usr/bin/env python3
"""Bring-up check: the render and train path on one GPU, end to end.

    python chip_smoke.py                 # one card, every phase below
    python chip_smoke.py --four-cards    # the sharded paths on four cards
    python chip_smoke.py --trace DIR     # also profile the 1M/1080p step

One process drives the card. Phases, in order (any failure exits non-zero
and prints no result line):

  device     nvidia-smi name and power limit, JAX platform / kind / count;
             anything but a `gpu` platform is an error.
  compile    the 1M-gaussian SH3 1920x1080 forward+backward render step
             (render/api.render with auto_render_config, which must pick the
             compiled pallas kernels); prints memory_analysis().
  main path  runs that step: finite loss and gradients, overflow counters 0.
  reference  the kernels against render_tiled_xla (max_per_tile raised to
             the true per-tile maximum, HIGHEST matmul precision): forward at
             1M/1080p, gradients at 100k/800x800, each within its stated
             tolerance.
  timing     kernel vs XLA oracle, median of 5: forward+backward at both
             sizes, forward at 1M/1080p; an oracle step that does not fit
             in device memory is reported as such.
  gpu tests  the pytest cases marked `gpu`, compiled on the card.
  train      `python -m gsrast_tpu make-dataset` at 1024x576, then `train`
             for 5 steps with densification and a checkpoint, resumed once.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")

SMALL = (100_000, 800, 800)
LARGE = (1_000_000, 1920, 1080)
FOUR_K = (1_000_000, 3840, 2160)

# Kernel vs oracle tolerances. GPU exp/log and summation order differ from
# the oracle's, and the backward rebuilds transmittance from log-space sums,
# so results agree to float32 rounding, not bit for bit. Where alpha rounds
# across ALPHA_MIN = 1/255 one side keeps a gaussian the other skips: that
# pixel moves by at most alpha * T * colour <= 1/255.
TOL_IMAGE = 1e-4       # abs, image and final_T, on all but TOL_OUTLIERS
TOL_OUTLIERS = 1e-3    # share of pixels allowed past TOL_IMAGE (cut flips)
TOL_IMAGE_MAX = 1.0 / 255.0  # abs, every pixel: one ALPHA_MIN flip
TOL_NC_SHARE = 0.9999  # n_contrib: threshold flips at ALPHA_MIN/T_MIN
TOL_GRAD = 1e-3        # max |a - b| / max |b| per parameter
# Sharded vs one card use the same tolerances: the same kernels and the same
# (tile, depth, gaussian id) blend order, with each device preprocessing its
# own share of the gaussians.

OVERFLOW_KEYS = ("overflow_capacity", "overflow_tile_cap",
                 "overflow_per_tile", "overflow_send")


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- device ----

def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_device(require_gpu: bool = True, count: int = 1) -> dict:
    log(f"nvidia-smi: {nvidia_smi()}")
    info = device_info()
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    if require_gpu:
        check(info["platform"] == "gpu",
              f"no GPU: JAX platform is {info['platform']!r}")
        check(info["count"] >= count,
              f"needs {count} GPUs, JAX sees {info['count']}")
    return info


# ---------------------------------------------------------------- cases ----

class Case:
    """One scene + camera + product render config, and its jitted steps."""

    def __init__(self, n, width, height, backend=None, interpret=False,
                 sh=3):
        from gsrast_tpu import RenderConfig
        from gsrast_tpu.benchmark import bench_scene_camera
        from gsrast_tpu.render.api import auto_render_config
        from gsrast_tpu.scene.gaussians import split_params

        self.label = f"n={n} {width}x{height}"
        self.scene, self.camera = bench_scene_camera(n, width, height, sh=sh)
        base = RenderConfig(interpret=True) if interpret else None
        self.rcfg = auto_render_config(self.scene, self.camera, backend,
                                       base=base)
        self.params, self.mask = split_params(self.scene)
        self._steps = {}

    def oracle_cfg(self):
        """render_tiled_xla's config with nothing dropped: max_per_tile is
        the true per-tile maximum of this view."""
        return self.rcfg.replace(backend="xla",
                                 max_per_tile=max(1, max_tile_count(self)))

    def step(self, rcfg, grad: bool = True):
        """Jitted fwd(+bwd) of a loss on image and final_T. Returns
        (loss, grads | image, final_t, n_contrib, overflow stats)."""
        import jax
        import jax.numpy as jnp

        from gsrast_tpu.render.api import render
        from gsrast_tpu.scene.gaussians import merge_params

        key = (rcfg, grad)
        if key in self._steps:
            return self._steps[key]
        camera = self.camera

        def run(params, mask):
            out = render(merge_params(params, mask).activated(), camera, rcfg)
            stats = {k: v for k, v in out.stats.items() if k in OVERFLOW_KEYS}
            loss = jnp.mean(out.image ** 2) + 0.1 * jnp.mean(out.final_t)
            return loss, (out, stats)

        if grad:
            def fn(params, mask):
                (loss, (_, stats)), g = jax.value_and_grad(
                    run, has_aux=True)(params, mask)
                return loss, g, stats
        else:
            def fn(params, mask):
                _, (out, stats) = run(params, mask)
                return out.image, out.final_t, out.n_contrib, stats

        self._steps[key] = jax.jit(fn)
        return self._steps[key]


def max_tile_count(case: Case) -> int:
    """The largest number of intersections any one tile holds."""
    import jax
    import jax.numpy as jnp

    from gsrast_tpu.ops import binning as binning_ops
    from gsrast_tpu.ops.preprocess import preprocess

    rcfg, camera = case.rcfg, case.camera
    gh, gw = rcfg.grid_shape(camera.height, camera.width)

    @jax.jit
    def count(act):
        prep = preprocess(act, camera, rcfg)
        plan = binning_ops.plan_tiers(prep, gh, gw, rcfg)
        starts = jnp.searchsorted(
            jnp.sort(plan.tile_key),
            jnp.arange(gh * gw + 1, dtype=plan.tile_key.dtype))
        return jnp.max(starts[1:] - starts[:-1])

    return int(count(case.scene.activated()))


def overflow_zero(stats: dict, what: str) -> None:
    vals = {k: int(v) for k, v in stats.items()}
    log(f"  {what} overflow counters: {vals}")
    check(all(v == 0 for v in vals.values()),
          f"{what}: nonzero overflow counters {vals}")


def device_bytes_limit():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("bytes_limit")


def fmt_bytes(n) -> str:
    return "n/a" if n is None else f"{n / 2**30:.2f} GiB"


def memory_line(compiled) -> tuple[str, int | None]:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis unavailable", None
    need = getattr(ma, "peak_memory_in_bytes", 0) or (
        ma.temp_size_in_bytes + ma.argument_size_in_bytes
        + ma.output_size_in_bytes - ma.alias_size_in_bytes)
    return (f"args={fmt_bytes(ma.argument_size_in_bytes)} "
            f"out={fmt_bytes(ma.output_size_in_bytes)} "
            f"temp={fmt_bytes(ma.temp_size_in_bytes)} "
            f"peak~{fmt_bytes(need)}"), need


# --------------------------------------------------------------- phases ----

def phase_compile(case: Case, expect_backend: str | None = "pallas"):
    from gsrast_tpu.render.pallas_blend import (BWD_CHUNK, FWD_BATCH,
                                                MAX_TILE_PIXELS)

    rcfg = case.rcfg
    log(f"compile {case.label}: backend={rcfg.backend} "
        f"tile={rcfg.tile_h}x{rcfg.tile_w} tiers={rcfg.tiers}")
    if expect_backend:
        check(rcfg.backend == expect_backend,
              f"auto_render_config chose {rcfg.backend!r}, "
              f"expected {expect_backend!r}")
    check(rcfg.tile_h * rcfg.tile_w <= MAX_TILE_PIXELS, "tile too large")
    t0 = time.perf_counter()
    compiled = case.step(rcfg).lower(case.params, case.mask).compile()
    line, _ = memory_line(compiled)
    log(f"  fwd+bwd step compiled in {time.perf_counter() - t0:.1f}s "
        f"(blend kernels: fwd batch {FWD_BATCH}, bwd chunk {BWD_CHUNK}); "
        f"memory_analysis: {line}")
    return compiled


def phase_main_path(case: Case) -> float:
    import jax
    import numpy as np

    loss, grads, stats = case.step(case.rcfg)(case.params, case.mask)
    loss = float(loss)
    check(math.isfinite(loss), f"main path loss {loss}")
    for k, g in grads.items():
        check(bool(np.isfinite(np.asarray(g)).all()), f"non-finite grad {k}")
    overflow_zero(jax.device_get(stats), f"main path {case.label}")
    log(f"main path {case.label}: loss={loss:.6f} grads finite")
    return loss


def compare_forward(case: Case) -> dict:
    """Kernel forward vs the oracle: image, final_T, n_contrib."""
    import jax
    import numpy as np

    ocfg = case.oracle_cfg()
    img, ft, nc, st = jax.device_get(
        case.step(case.rcfg, grad=False)(case.params, case.mask))
    with jax.default_matmul_precision("highest"):
        rimg, rft, rnc, rst = jax.device_get(
            case.step(ocfg, grad=False)(case.params, case.mask))
    overflow_zero(st, f"kernel fwd {case.label}")
    overflow_zero(rst, f"oracle fwd {case.label} K={ocfg.max_per_tile}")
    res = {**agreement("image", img, rimg),
           **agreement("final_t", ft, rft),
           "n_contrib_equal_share": float(np.mean(nc == rnc))}
    log(f"reference fwd {case.label} (oracle max_per_tile="
        f"{ocfg.max_per_tile}): {res}")
    for k in ("image", "final_t"):
        check(res[f"{k}_max_abs"] <= TOL_IMAGE_MAX
              and res[f"{k}_share_over_tol"] <= TOL_OUTLIERS,
              f"{k} differs: {res}")
    check(res["n_contrib_equal_share"] >= TOL_NC_SHARE, f"n_contrib {res}")
    return res


def agreement(name: str, a, b) -> dict:
    """Largest per-pixel difference and the share of pixels past
    TOL_IMAGE."""
    import numpy as np

    d = np.abs(np.asarray(a) - np.asarray(b))
    if d.ndim == 3:
        d = d.max(axis=-1)
    return {f"{name}_max_abs": float(d.max()),
            f"{name}_share_over_tol": float(np.mean(d > TOL_IMAGE))}


def compare_grads(case: Case) -> dict:
    import jax
    import numpy as np

    ocfg = case.oracle_cfg()
    loss, g, st = jax.device_get(case.step(case.rcfg)(case.params, case.mask))
    with jax.default_matmul_precision("highest"):
        rloss, rg, rst = jax.device_get(
            case.step(ocfg)(case.params, case.mask))
    overflow_zero(st, f"kernel fwd+bwd {case.label}")
    overflow_zero(rst, f"oracle fwd+bwd {case.label}")
    res = {"loss_rel": float(abs(loss - rloss) / max(abs(rloss), 1e-30))}
    for k in g:
        a, b = np.asarray(g[k]), np.asarray(rg[k])
        res[k] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    log(f"reference grads {case.label}: scale-normalised max diff {res}")
    for k in g:
        check(res[k] <= TOL_GRAD, f"gradient {k} differs: {res[k]}")
    check(res["loss_rel"] <= TOL_IMAGE, f"loss differs: {res}")
    return res


def timeit(fn, *args, iters: int = 5) -> float:
    """Median wall ms of `iters` calls of fn(*args) after one warm-up call,
    each ended by block_until_ready."""
    import statistics

    import jax

    jax.block_until_ready(fn(*args))
    runs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs) * 1e3


def phase_timing(case: Case, iters: int = 5, grad: bool = True) -> dict:
    """One step (fwd+bwd, or fwd only): the kernels vs what XLA makes of
    the plain oracle with nothing dropped. Median of `iters` wall ms."""
    import jax

    what = "fwd+bwd" if grad else "fwd"
    pix = case.camera.width * case.camera.height
    ms_k = timeit(case.step(case.rcfg, grad), case.params, case.mask,
                  iters=iters)
    res = {"kernel_ms": ms_k, "kernel_mpix_s": pix / ms_k / 1e3}
    ocfg = case.oracle_cfg()
    res["oracle_max_per_tile"] = ocfg.max_per_tile
    compiled = case.step(ocfg, grad).lower(case.params, case.mask).compile()
    line, need = memory_line(compiled)
    limit = device_bytes_limit()
    res["oracle_ms"] = None
    if need is not None and limit is not None and need > limit:
        log(f"timing {case.label}: oracle {what} does NOT fit: needs "
            f"{fmt_bytes(need)} of {fmt_bytes(limit)} ({line})")
    else:
        try:
            ms_x = timeit(compiled, case.params, case.mask, iters=iters)
            res.update(oracle_ms=ms_x, oracle_mpix_s=pix / ms_x / 1e3,
                       speedup=ms_x / ms_k)
        except jax.errors.JaxRuntimeError as e:  # the allocator said no
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            log(f"timing {case.label}: oracle {what} ran out of device "
                f"memory ({line})")
    log(f"timing {case.label} {what}: {res}")
    return res


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu_kernels.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def run_cli(argv) -> str:
    """`python -m gsrast_tpu <argv>` in this process; returns its stdout."""
    from gsrast_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    return out


def phase_train(n: int = 20_000, width: int = 1024, height: int = 576,
                steps: int = 5, views: int = 4, workdir: str | None = None):
    """make-dataset from a random n-gaussian scene, then train another
    random scene of n/2 (capacity 3n/4, so densification has free slots)
    for `steps` steps with densification every 2 steps and a checkpoint at
    the end, then resume for one more step."""
    import re

    work = workdir or os.path.join(WORK, "train")
    shutil.rmtree(work, ignore_errors=True)
    data, ck = os.path.join(work, "data"), os.path.join(work, "ckpt")
    size = ["--width", str(width), "--height", str(height)]
    log(f"train: make-dataset random:{n} {width}x{height} x{views}")
    run_cli(["make-dataset", f"random:{n}", "--out", data,
             "--views", str(views)] + size)
    common = ["train", "--scene", f"random:{n // 2}", "--data", data,
              "--capacity", str(3 * n // 4),
              "--ckpt-dir", ck, "--ckpt-every", str(steps),
              "--densify-from", "2", "--densify-every", "2"] + size
    out = run_cli(common + ["--steps", str(steps)])
    losses = [float(x) for x in re.findall(r"loss=([-\w.+]+)", out)]
    check(bool(losses) and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    out2 = run_cli(common + ["--steps", str(steps + 1), "--resume"])
    check(f"resumed from step {steps}" in out2,
          "checkpoint restore did not resume")
    losses2 = [float(x) for x in re.findall(r"loss=([-\w.+]+)", out2)]
    check(bool(losses2) and all(math.isfinite(x) for x in losses2),
          f"resumed losses {losses2}")
    log(f"train: {steps} steps loss {losses} -> resumed step {steps}: "
        f"{losses2}")
    return losses + losses2


def phase_trace(case: Case, outdir: str, steps: int = 3) -> None:
    """Profile a few steps and print the device ops that take the time."""
    import collections
    import re

    import jax

    step = case.step(case.rcfg)
    jax.block_until_ready(step(case.params, case.mask))
    shutil.rmtree(outdir, ignore_errors=True)
    with jax.profiler.trace(outdir):
        for _ in range(steps):
            jax.block_until_ready(step(case.params, case.mask))
    paths = [os.path.join(d, f) for d, _, fs in os.walk(outdir) for f in fs
             if f.endswith(".xplane.pb")]
    check(bool(paths), "profiler wrote no trace")
    pd = jax.profiler.ProfileData.from_file(paths[0])
    tot, launches = collections.Counter(), collections.Counter()
    busy = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name and "Kernel" not in line.name:
                continue
            for ev in line.events:
                # XLA splits one sort into passes named sort_X__1, __2, ...
                name = re.sub(r"__\d+$", "", ev.name)
                tot[name] += ev.duration_ns
                launches[name] += 1
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy.sort()
    union, cur_s, cur_e = 0.0, None, None
    for s, e in busy:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        union += cur_e - cur_s
    span = (busy[-1][1] - busy[0][0]) if busy else 0.0
    log(f"trace {case.label}: {steps} steps, device busy "
        f"{union / 1e6 / steps:.3f} ms/step over a "
        f"{span / 1e6 / steps:.3f} ms/step window")
    for name, ns in tot.most_common(15):
        log(f"  {ns / 1e6 / steps:9.3f} ms/step {launches[name] // steps:5d} "
            f"launches/step  {name[:100]}")


def phase_four_cards(n_render=FOUR_K, n_train=(1_000_000, 1920, 1080),
                     interpret: bool = False) -> None:
    """Sharded training on a (2, 2) mesh and both sharded renders at 4K on
    (1, 4), each against the same work on one card, with the median wall
    time of each. Every comparison runs; the phase fails at the end if any
    of them did."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gsrast_tpu.parallel.mesh import make_mesh
    from gsrast_tpu.parallel.sharded import (make_sharded_train_step,
                                             pad_gaussians,
                                             render_primitive_sharded,
                                             render_tile_sharded)
    from gsrast_tpu.render.api import render

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 devices, found {len(devs)}")
    backend = "pallas" if interpret else None
    failures = []

    def soft_check(cond, msg):
        if not cond:
            log(f"  FAIL: {msg}")
            failures.append(msg)

    case = Case(*n_render, backend=backend, interpret=interpret)
    act = case.scene.activated()
    one = jax.jit(lambda a: render(a, case.camera, case.rcfg).image)
    ref = one(act)
    iters = 1 if interpret else 3
    log(f"four cards one-card render {case.label}: "
        f"{timeit(one, act, iters=iters):.3f} ms")
    mesh = make_mesh((1, 4), devs[:4])
    for name, fn, arg in (
            ("render_tile_sharded", render_tile_sharded, act),
            ("render_primitive_sharded", render_primitive_sharded,
             pad_gaussians(act, 4))):
        t0 = time.perf_counter()
        sharded = jax.jit(lambda a: fn(a, case.camera, case.rcfg, mesh))
        out = sharded(arg)
        img = np.asarray(out.image)
        dt = time.perf_counter() - t0
        ms = timeit(lambda a: sharded(a).image, arg, iters=iters)
        ovf = {k: int(v) for k, v in jax.device_get(out.stats).items()
               if k in OVERFLOW_KEYS}
        agree = agreement("image", img, ref)
        log(f"four cards {name} {case.label} (1, 4) vs one card: {agree}, "
            f"overflow {ovf}, {ms:.3f} ms (first call {dt:.1f}s)")
        soft_check(not any(ovf.values()), f"{name} overflow {ovf}")
        soft_check(agree["image_max_abs"] <= TOL_IMAGE_MAX
                   and agree["image_share_over_tol"] <= TOL_OUTLIERS,
                   f"{name} differs from one card: {agree}")

    tcase = Case(*n_train, backend=backend, interpret=interpret)
    cam = tcase.camera
    n_cams = 2
    cams = jax.tree.map(lambda x: jnp.broadcast_to(x, (n_cams,) + x.shape),
                        cam)
    targets = jnp.full((n_cams, cam.height, cam.width, 3), 0.25, jnp.float32)
    opt = optax.adam(1e-3)
    opt_state = opt.init(tcase.params)
    results = {}
    for shape, devices in (((2, 2), devs[:4]), ((1, 1), devs[:1])):
        m = make_mesh(shape, devices)
        step = jax.jit(make_sharded_train_step(
            tcase.rcfg, m, cam.height, cam.width,
            cameras_per_device=n_cams // shape[0], optimizer=opt))
        args = (tcase.params, tcase.mask, opt_state, cams, targets)
        _, _, loss, grads = jax.device_get(step(*args))
        ms = timeit(step, *args, iters=iters)
        results[shape] = (float(loss), grads)
        log(f"four cards train step {tcase.label} {shape} ({n_cams} "
            f"cameras): {ms:.3f} ms")
    (l4, g4), (l1, g1) = results[(2, 2)], results[(1, 1)]
    diffs = {k: float(np.abs(g4[k] - g1[k]).max()
                      / max(np.abs(g1[k]).max(), 1e-30)) for k in g1}
    log(f"four cards train step {tcase.label} (2, 2) vs one card: loss "
        f"{l4:.6f} vs {l1:.6f}; scale-normalised grad diff {diffs}")
    soft_check(abs(l4 - l1) <= TOL_IMAGE * max(abs(l1), 1e-30),
               f"sharded loss differs: {l4} vs {l1}")
    for k, d in diffs.items():
        soft_check(d <= TOL_GRAD, f"sharded gradient {k} differs: {d}")
    check(not failures, f"four-card comparisons failed: {failures}")


# ----------------------------------------------------------------- main ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="also profile the 1M/1080p step into DIR")
    args = ap.parse_args(argv)

    # The card, never a silent CPU fallback (the in-process gpu tests'
    # conftest keeps this platform too).
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    sys.path.insert(0, REPO)
    from gsrast_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t_start = time.perf_counter()
    if args.four_cards:
        info = phase_device(count=4)
        phase_four_cards()
    else:
        info = phase_device()
        large = Case(*LARGE)
        phase_compile(large)
        phase_main_path(large)
        compare_forward(large)
        small = Case(*SMALL)
        compare_grads(small)
        for case in (small, large):
            phase_timing(case)
        phase_timing(large, grad=False)
        if args.trace:
            phase_trace(large, args.trace)
        del large, small
        phase_gpu_tests()
        phase_train()
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
