"""Quaternion algebra in scalar-first (w, x, y, z) convention.

All functions are pure JAX, operate on the trailing axis of size 4, and
broadcast over arbitrary leading batch dimensions, so they vmap/jit
cleanly and fuse into surrounding device compute.

The scalar-first convention matches the reference's state layout
(reference filters/base_filter.py:25-27: ``qw, qx, qy, qz``).  The
small-angle "boxplus" used by the MEKF (reference
filters/extended_kalman_filter.py:137-152) is `apply_small_angle`.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def identity(dtype=jnp.float32) -> jnp.ndarray:
    """Identity quaternion [1, 0, 0, 0]."""
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def normalize(q: jnp.ndarray) -> jnp.ndarray:
    """Normalize to unit quaternion (safe at zero norm)."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, _EPS)


def conjugate(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion conjugate [w, -x, -y, -z] (= inverse for unit q)."""
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product a ⊗ b (scalar-first)."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v by unit quaternion(s) q: R(q) @ v.

    Uses the expanded Rodrigues form (no intermediate 3x3 matrix), which
    XLA fuses into a handful of VPU ops.
    """
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> 3x3 rotation matrix (batched on leading dims)."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = jnp.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape((*q.shape[:-1], 3, 3))


def from_matrix(m: jnp.ndarray) -> jnp.ndarray:
    """3x3 rotation matrix -> unit quaternion (w >= 0 branch-free form).

    Uses the numerically robust 4-branch method expressed with
    ``jnp.where`` so it is jit/vmap safe (no data-dependent control
    flow, per XLA semantics).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate computations; pick the one with the largest pivot.
    def _safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    qw0 = _safe_sqrt(1.0 + tr) / 2.0
    q0 = jnp.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
         (m10 - m01) / (4 * qw0)], axis=-1)

    qx1 = _safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = jnp.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
         (m02 + m20) / (4 * qx1)], axis=-1)

    qy2 = _safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = jnp.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
         (m12 + m21) / (4 * qy2)], axis=-1)

    qz3 = _safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = jnp.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
         (m12 + m21) / (4 * qz3), qz3], axis=-1)

    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                        -m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)[..., None]
    q = jnp.where(best == 0, q0,
                  jnp.where(best == 1, q1, jnp.where(best == 2, q2, q3)))
    return normalize(q)


def from_rotvec(rv: jnp.ndarray) -> jnp.ndarray:
    """Rotation vector (axis * angle) -> unit quaternion.

    Taylor-safe near zero angle, including under differentiation: the
    norm is computed from a clamped squared norm so the unselected
    `where` branch never produces a NaN gradient (the d‖v‖/dv = v/‖v‖
    singularity at v = 0).
    """
    angle_sq = jnp.sum(rv * rv, axis=-1, keepdims=True)
    angle = jnp.sqrt(jnp.maximum(angle_sq, _EPS))
    half = 0.5 * angle
    small = angle_sq < 1e-12
    # sin(half)/angle, stable as angle->0: 0.5 - angle^2/48 + ...
    k = jnp.where(small, 0.5 - angle_sq / 48.0, jnp.sin(half) / angle)
    w = jnp.where(small, 1.0 - angle_sq / 8.0, jnp.cos(half))
    return jnp.concatenate([w, rv * k], axis=-1)


def to_rotvec(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> rotation vector (axis * angle).

    Taylor-safe near identity, including under differentiation (see
    `from_rotvec`).
    """
    q = jnp.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    sin_sq = jnp.sum(v * v, axis=-1, keepdims=True)
    sin_half = jnp.sqrt(jnp.maximum(sin_sq, _EPS))
    angle = 2.0 * jnp.arctan2(sin_half, w)
    small = sin_sq < 1e-12
    # angle / sin(half) ~ 2 + angle^2/12 as angle->0
    k = jnp.where(small, 2.0 + sin_sq / 3.0, angle / sin_half)
    return v * k


def from_euler_xyz(angles: jnp.ndarray) -> jnp.ndarray:
    """Extrinsic x-y-z Euler angles -> quaternion.

    Matches ``scipy.spatial.transform.Rotation.from_euler("xyz", a)``
    (lowercase = extrinsic; composition R = Rz(c) Ry(b) Rx(a)), which the
    reference uses to interpret marker orientations (reference
    filters/ekf_with_rotations.py:216-219).
    """
    a, b, c = jnp.moveaxis(angles, -1, 0)
    zero = jnp.zeros_like(a)
    qx = from_rotvec(jnp.stack([a, zero, zero], axis=-1))
    qy = from_rotvec(jnp.stack([zero, b, zero], axis=-1))
    qz = from_rotvec(jnp.stack([zero, zero, c], axis=-1))
    return multiply(qz, multiply(qy, qx))


def apply_small_angle(q: jnp.ndarray, err: jnp.ndarray) -> jnp.ndarray:
    """MEKF multiplicative correction: normalize([1, err/2]) ⊗ q.

    This is the error-state reset of the reference's update step
    (reference filters/ekf_with_rotations.py:146-154): the small-angle
    error vector ``err`` (3,) becomes dq = [1, ex/2, ey/2, ez/2] which is
    Hamilton-multiplied onto the accumulated quaternion.
    """
    dq = jnp.concatenate(
        [jnp.ones_like(err[..., :1]), 0.5 * err], axis=-1)
    return normalize(multiply(dq, q))


def angle_between(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Geodesic angle (radians) between two unit quaternions."""
    dot = jnp.abs(jnp.sum(a * b, axis=-1))
    return 2.0 * jnp.arccos(jnp.clip(dot, 0.0, 1.0))
