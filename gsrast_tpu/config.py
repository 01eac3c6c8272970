"""Global constants and render configuration.

The analog of the reference's compile-time config
(/root/reference/Config.hpp:3-48): where the reference hardcodes window size,
near/far planes, FOV and the 16x16 CUDA tile (Config.hpp:46-48, GSCuda.cu:20-21),
we expose a frozen dataclass that is hashable (usable as a jit static arg).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

# Math constants (reference Config.hpp:16-23).
PI = 3.14159265358979323846
EPSILON = 1e-6

# Default camera parameters (reference Config.hpp:18-23).
DEFAULT_NEAR = 0.01
DEFAULT_FAR = 100.0
DEFAULT_FOV_DEG = 45.0

# Default "window" size (reference Config.hpp:3-5).
DEFAULT_WIDTH = 1024
DEFAULT_HEIGHT = 768

NUM_CHANNELS = 3  # reference Config.hpp:46

# Blend thresholds (reference GSCuda.cu:645-658).
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TRANSMITTANCE_MIN = 1e-4

# EWA low-pass dilation added to the 2D covariance diagonal
# (reference GSCuda.cu:197-231; the "+0.3" anti-aliasing floor).
COV2D_DILATION = 0.3

# Frustum-cull margin: NDC +-1.3 (reference GSCuda.cu:302-309) and the
# near-plane depth cut used by the Inria-style rasterizer.
NDC_CULL_MARGIN = 1.3
NEAR_CULL_DEPTH = 0.2

# Gaussian extent: radius = ceil(3 sqrt(lambda_max)) (reference GSCuda.cu:337-341).
GAUSSIAN_EXTENT_SIGMA = 3.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for the tile-sorted rasterizer.

    Hashable + frozen so it can be passed as a `jax.jit` static argument.

    Attributes:
      tile_h/tile_w: pixel tile shape. Default 16x16, the reference's tile
        (GSCuda.cu:20-21); the pallas kernels need powers of two (see
        render/pallas_blend.check_tile_shape). The tile shape is an internal
        detail, not observable in the output.
      max_tiles_per_gaussian: static cap K2 on how many (owned) tiles one
        Gaussian may be binned into; size it to the scene's true per-Gaussian
        tile maximum (`scripts/scene_stats.py` reports it). Overflow is
        *counted* (no silent caps) in RenderStats.
      base_tiles_per_gaussian: tier-1 width K1 of the two-tier slot grid
        (ops/binning.py): every Gaussian gets K1 elementwise slots; only the
        `heavy_fraction` densest get budgeted tier-2 rows for tiles K1..K2.
        Keeps sort/routing volume near mean*N instead of K2*N.
      heavy_fraction: static budget of tier-2 rows as a fraction of N.
      intersect_capacity_factor: static capacity of the (tile|depth) key list,
        as a multiple of N. The reference sizes this buffer exactly via a
        device->host readback of the scanned total (GSCuda.cu:771-784); we
        use a static capacity + overflow accounting instead.
      tile_chunk: how many tiles the XLA blend path processes per lax.map step
        (bounds peak memory).
      max_per_tile: static cap of intersections blended per tile in the XLA
        path (the Pallas path walks true ranges and has no such cap).
      backend: 'xla' (pure-JAX, differentiable by autodiff; the correctness
        oracle path) or 'pallas' (hand-written GPU kernels with custom VJP).
        render/api.default_backend picks one from the platform.
      interpret: run the pallas kernels in the Pallas interpreter (CPU tests
        only; the kernels refuse it on a GPU).
    """

    tile_h: int = 16
    tile_w: int = 16
    max_tiles_per_gaussian: int = 32
    # Multi-tier fused binning (r4): when non-empty, the pallas path uses
    # ops/binning.plan_tiers + the fused sort-pack instead of the two-tier
    # grid + separate gather. Entries are (k_j, budget_frac_j), k ascending:
    # every Gaussian gets slots for its first k_0 tiles; the budget_frac_j * N
    # Gaussians with the MOST tiles (a prefix of one count-ranked order) also
    # get slots k_{j-1}..k_j. budget fracs must be non-increasing (nested
    # prefixes -> no holes in any Gaussian's tile enumeration). A first-entry
    # frac >= 1.0 covers every Gaussian; frac < 1 budgets tier 0 itself
    # (used by the tile-sharded path; drops counted). Sizes the sort volume
    # near the TRUE intersection count instead of K*N: sort cost follows the
    # row count, so this is the binning throughput knob. () = legacy
    # two-tier grid.
    tiers: Tuple[Tuple[int, float], ...] = ()
    base_tiles_per_gaussian: int = 8
    heavy_fraction: float = 0.125
    intersect_capacity_factor: float = 4.0
    tile_chunk: int = 16
    max_per_tile: int = 1024
    backend: str = "xla"
    interpret: bool = False
    sh_degree: int = 3
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dtype: str = "float32"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    def grid_shape(self, height: int, width: int) -> Tuple[int, int]:
        """Number of tiles (rows, cols) covering a height x width image."""
        ty = -(-height // self.tile_h)
        tx = -(-width // self.tile_w)
        return ty, tx

    def padded_shape(self, height: int, width: int) -> Tuple[int, int]:
        ty, tx = self.grid_shape(height, width)
        return ty * self.tile_h, tx * self.tile_w

    def capacity(self, num_gaussians: int) -> int:
        cap = int(num_gaussians * self.intersect_capacity_factor)
        # Round up to a multiple of 128.
        return max(128, -(-cap // 128) * 128)
