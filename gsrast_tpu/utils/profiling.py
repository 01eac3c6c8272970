"""Tracing and profiling.

The reference's observability is an FPS plot and a dt table
(/root/reference/apps/gsrast/Inspector.cpp:142-165, Window.cpp:104-108); this
module provides the device-level equivalents SURVEY.md §5 calls for:

  * `trace(logdir)`            — jax.profiler device trace (Perfetto/XProf),
                                 the analog of watching the FPS plot live;
  * `StageTimer`               — wall-clock timing of jitted stages with
                                 block_until_ready fencing (kernel timing the
                                 reference never had);
  * `throughput_report(...)`   — Mpixels/s (+ per-chip) counters, the
                                 BASELINE north-star metric;
  * `device_memory_report()`   — live HBM usage per buffer kind (the
                                 "Loaded data" byte-size panel, device side).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str = "gsrast_trace", create_perfetto_link: bool = False):
    """Capture a device trace around a code block; view in XProf/Perfetto."""
    jax.profiler.start_trace(logdir, create_perfetto_link=create_perfetto_link)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Named wall-clock timers with device fencing.

    with timer.stage("binning"): out = f(x)
    Every stage exit calls block_until_ready on the stage's result if given.
    """

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def timeit(self, name: str, fn: Callable, *args, iters: int = 5, **kw):
        """Compile (first call untimed), then time `iters` fenced calls."""
        out = fn(*args, **kw)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kw)
        jax.block_until_ready(out)
        self.times.setdefault(name, []).append(
            (time.perf_counter() - t0) / iters
        )
        return out

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {
                "mean_ms": 1e3 * sum(ts) / len(ts),
                "min_ms": 1e3 * min(ts),
                "count": len(ts),
            }
        return out


def throughput_report(
    pixels: int, seconds: float, n_chips: Optional[int] = None
) -> Dict[str, float]:
    """Mpixels/s counters (BASELINE.md north-star units)."""
    n_chips = n_chips or jax.device_count()
    mpix = pixels / seconds / 1e6
    return {
        "mpixels_per_s": mpix,
        "mpixels_per_s_per_chip": mpix / max(n_chips, 1),
        "fps_equivalent": 1.0 / seconds if seconds > 0 else float("inf"),
        "n_chips": n_chips,
    }


def device_memory_report() -> List[Dict]:
    """Per-device live-buffer byte counts (HBM view of the Inspector's
    'Loaded data' panel)."""
    out = []
    for d in jax.devices():
        try:
            stats = d.memory_stats()
        except (RuntimeError, AttributeError):
            stats = None
        if stats:
            out.append(
                {
                    "device": str(d),
                    "bytes_in_use": stats.get("bytes_in_use"),
                    "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                    "bytes_limit": stats.get("bytes_limit"),
                }
            )
        else:
            out.append({"device": str(d)})
    return out
