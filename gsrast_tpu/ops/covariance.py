"""3D covariance construction and EWA projection to 2D.

Pure per-Gaussian math, re-derived from the splatting formulation the
reference implements in CUDA:
  * quat -> rotation matrix         (reference GSCuda.cu:157-162)
  * cov3D = R S S^T R^T (sym upper) (reference GSCuda.cu:168-195)
  * EWA cov2D = J W Sigma W^T J^T
    + 0.3 I dilation                (reference GSCuda.cu:197-231)
  * conic = inverse(cov2D), radius = ceil(3 sqrt(lambda_max))
                                    (reference GSCuda.cu:329-341)

Everything is float32, vector-shaped, and differentiable by jax.grad (the
hand-written Pallas backward is checked against autodiff of these).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .. import config as cfg


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """Unit quaternion (w, x, y, z) -> (3, 3) rotation matrix.

    Accepts batched (..., 4). The caller is responsible for normalization
    (GaussianScene.rotations()).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def compute_cov3d(scale: jax.Array, quat: jax.Array) -> jax.Array:
    """Sigma = R S S^T R^T, returned as the symmetric upper triangle
    (..., 6): [xx, xy, xz, yy, yz, zz] (reference GSCuda.cu:168-195 stores the
    same 6 floats).

    Expanded to per-channel elementwise formulas: no batched (N, 3, 3)
    matmuls of tiny operands, and exact f32 (no reduced-precision matmul
    pass).
    """
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    sx, sy, sz = scale[..., 0], scale[..., 1], scale[..., 2]
    # M = R diag(s); Sigma = M M^T.
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    return jnp.stack(
        [
            m00 * m00 + m01 * m01 + m02 * m02,  # xx
            m00 * m10 + m01 * m11 + m02 * m12,  # xy
            m00 * m20 + m01 * m21 + m02 * m22,  # xz
            m10 * m10 + m11 * m11 + m12 * m12,  # yy
            m10 * m20 + m11 * m21 + m12 * m22,  # yz
            m20 * m20 + m21 * m21 + m22 * m22,  # zz
        ],
        axis=-1,
    )


def cov3d_to_matrix(cov6: jax.Array) -> jax.Array:
    """(..., 6) upper triangle -> (..., 3, 3) symmetric matrix."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return jnp.stack(
        [
            jnp.stack([xx, xy, xz], axis=-1),
            jnp.stack([xy, yy, yz], axis=-1),
            jnp.stack([xz, yz, zz], axis=-1),
        ],
        axis=-2,
    )


def compute_cov2d(
    mean_view: jax.Array,
    cov6: jax.Array,
    view_rot: jax.Array,
    focal_x: jax.Array,
    focal_y: jax.Array,
    tan_fov_x: jax.Array,
    tan_fov_y: jax.Array,
) -> jax.Array:
    """EWA splatting: project a 3D covariance to screen space.

    Args:
      mean_view: (..., 3) gaussian center in camera space (z = depth > 0).
      cov6: (..., 6) world-space covariance upper triangle.
      view_rot: (3, 3) world->camera rotation (view[:3, :3]).
      focal_*: pixels; tan_fov_*: half-angle tangents.

    Returns:
      (..., 3): 2D covariance [a, b, c] = [[a, b], [b, c]] with the +0.3
      low-pass dilation on the diagonal (reference GSCuda.cu:197-231).
    """
    tx, ty, tz = mean_view[..., 0], mean_view[..., 1], mean_view[..., 2]
    # Clamp the tangent-plane position to 1.3x the frustum (GSCuda.cu:205-210).
    lim_x = 1.3 * tan_fov_x
    lim_y = 1.3 * tan_fov_y
    txtz = jnp.clip(tx / tz, -lim_x, lim_x)
    tytz = jnp.clip(ty / tz, -lim_y, lim_y)
    tx = txtz * tz
    ty = tytz * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # T = J @ W where J is the (2, 3) perspective Jacobian
    # [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]] (GSCuda.cu:212-217) and
    # W = view_rot. Expanded per-channel: elementwise work with scalar W
    # entries instead of batched tiny matmuls.
    w00, w01, w02 = view_rot[0, 0], view_rot[0, 1], view_rot[0, 2]
    w10, w11, w12 = view_rot[1, 0], view_rot[1, 1], view_rot[1, 2]
    w20, w21, w22 = view_rot[2, 0], view_rot[2, 1], view_rot[2, 2]
    jx = focal_x * inv_z
    jy = focal_y * inv_z
    jxz = -focal_x * tx * inv_z2
    jyz = -focal_y * ty * inv_z2
    t00 = jx * w00 + jxz * w20
    t01 = jx * w01 + jxz * w21
    t02 = jx * w02 + jxz * w22
    t10 = jy * w10 + jyz * w20
    t11 = jy * w11 + jyz * w21
    t12 = jy * w12 + jyz * w22
    # cov2d = T Sigma T^T with Sigma the symmetric (..., 6) upper triangle.
    s00, s01, s02 = cov6[..., 0], cov6[..., 1], cov6[..., 2]
    s11, s12, s22 = cov6[..., 3], cov6[..., 4], cov6[..., 5]
    # Sigma T^T columns: v_i = Sigma @ t_i (t_i = row i of T).
    v00 = s00 * t00 + s01 * t01 + s02 * t02
    v01 = s01 * t00 + s11 * t01 + s12 * t02
    v02 = s02 * t00 + s12 * t01 + s22 * t02
    v10 = s00 * t10 + s01 * t11 + s02 * t12
    v11 = s01 * t10 + s11 * t11 + s12 * t12
    v12 = s02 * t10 + s12 * t11 + s22 * t12
    a = t00 * v00 + t01 * v01 + t02 * v02 + cfg.COV2D_DILATION
    b = t10 * v00 + t11 * v01 + t12 * v02
    c = t10 * v10 + t11 * v11 + t12 * v12 + cfg.COV2D_DILATION
    return jnp.stack([a, b, c], axis=-1)


def conic_and_radius(cov2d: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Invert the 2D covariance and bound the splat's pixel extent.

    Returns (conic (...,3), radius (...,), valid (...,)): conic = [A, B, C]
    of the quadratic form; radius = ceil(3 sqrt(lambda_max)) via the
    eigenvalue bound mid +- sqrt(mid^2 - det) (reference GSCuda.cu:329-341);
    valid = det > 0 (degenerate covariances are culled, GSCuda.cu:331-335).
    """
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    valid = det > 0.0
    det_safe = jnp.where(valid, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = jnp.stack([c * inv_det, -b * inv_det, a * inv_det], axis=-1)
    mid = 0.5 * (a + c)
    lam_max = mid + jnp.sqrt(jnp.maximum(0.1, mid * mid - det))
    radius = jnp.ceil(cfg.GAUSSIAN_EXTENT_SIGMA * jnp.sqrt(lam_max))
    radius = jnp.where(valid, radius, 0.0)
    return conic, radius, valid
