"""Batched planar PnP: homography + IPPE-square + Gauss-Newton refine.

Batched-accelerator replacement for the reference's per-marker host loop around
``cv2.solvePnP(..., flags=SOLVEPNP_IPPE_SQUARE)`` (reference
filters/base_filter.py:125-171). The whole pipeline — closed-form
square homography, 2x2 spectral decomposition, 3x3 translation solve
and a fixed-iteration 6x6 Gauss-Newton polish — is written in
structure-of-arrays *scalar* form so M markers across B frames solve
as ONE fused elementwise XLA program with no data-dependent shapes and
no small trailing tensor dims (which tiled layouts pad to full tiles).

Method: "Infinitesimal Plane-based Pose Estimation" (IPPE), Collins &
Bartoli 2014 — the same algorithm OpenCV's IPPE_SQUARE implements.
Both pose solutions of the planar two-fold ambiguity are constructed
and disambiguated by reprojection error, then the winner is polished
with a few damped Gauss-Newton iterations on the reprojection residual
(replacing OpenCV's iterative refinement).

Conventions: object/marker frame has the tag in the z=0 plane with
corners in IPPE_SQUARE order (TL, TR, BR, BL — reference
filters/base_filter.py:112-120); the returned pose maps marker
coordinates to camera coordinates: x_cam = R x_obj + t.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aruco_slam_tpu.core import camera as cam_mod
from aruco_slam_tpu.core import quaternion as quat
from aruco_slam_tpu.ops import linalg as small

_EPS = 1e-12


class PnPResult(NamedTuple):
    """Batched solution; leading axes match the input batch."""

    t_cl: jnp.ndarray   # (..., 3) marker origin in camera frame
    q_cl: jnp.ndarray   # (..., 4) wxyz marker-to-camera rotation
    rvec: jnp.ndarray   # (..., 3) rotation vector (OpenCV rvec parity)
    err: jnp.ndarray    # (..., ) RMS reprojection error, *pixels*
    err2: jnp.ndarray   # (..., ) RMS error of the rejected solution


def square_object_points(marker_size) -> jnp.ndarray:
    """Canonical square corners (4, 3), IPPE_SQUARE order."""
    s = marker_size / 2.0
    return jnp.asarray(
        [[-s, s, 0.0], [s, s, 0.0], [s, -s, 0.0], [-s, -s, 0.0]])


def homography_4pt(obj_xy: jnp.ndarray, img_xy: jnp.ndarray) -> jnp.ndarray:
    """DLT homography from exactly 4 correspondences.

    obj_xy: (4, 2) plane coordinates; img_xy: (4, 2) normalized image
    coordinates. Returns (3, 3) with H[2,2] = 1.
    """
    x, y = obj_xy[:, 0], obj_xy[:, 1]
    u, v = img_xy[:, 0], img_xy[:, 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    rows_u = jnp.stack(
        [x, y, ones, zeros, zeros, zeros, -u * x, -u * y], axis=-1)
    rows_v = jnp.stack(
        [zeros, zeros, zeros, x, y, ones, -v * x, -v * y], axis=-1)
    a = jnp.concatenate([rows_u, rows_v], axis=0)      # (8, 8)
    b = jnp.concatenate([u, v], axis=0)                # (8,)
    # normal-equation solve with an unrolled 8x8 Cholesky: batches of
    # tiny library solves serialize badly (see ops/linalg.py)
    h = small.solve_normal(a, b)
    return jnp.concatenate([h, jnp.ones(1, h.dtype)]).reshape(3, 3)


def _safe_div(a, b, eps=_EPS):
    return a / jnp.where(jnp.abs(b) < eps,
                         jnp.where(b < 0, -eps, eps), b)


def _h_square_entries(s, u, v):
    """Closed-form homography taking the canonical square corners
    TL(−s,s) TR(s,s) BR(s,−s) BL(−s,−s) to the quad (u_k, v_k):
    projective unit-square interpolation (Heckbert '89) composed with
    the affine unit↔square map. Exact 4-point homography — replaces
    the DLT 8x8 normal solve with ~40 batched-scalar ops and no
    (…, 8, 8) tensors (tile padding, see _gn_refine_entries)."""
    sx = u[0] - u[1] + u[2] - u[3]
    sy = v[0] - v[1] + v[2] - v[3]
    dx1 = u[1] - u[2]
    dy1 = v[1] - v[2]
    dx2 = u[3] - u[2]
    dy2 = v[3] - v[2]
    den = dx1 * dy2 - dx2 * dy1
    g = _safe_div(sx * dy2 - dx2 * sy, den)
    hh = _safe_div(dx1 * sy - sx * dy1, den)
    a = u[1] - u[0] + g * u[1]
    b = u[3] - u[0] + hh * u[3]
    c = u[0]
    d = v[1] - v[0] + g * v[1]
    e = v[3] - v[0] + hh * v[3]
    f = v[0]
    # unit-square H = [[a,b,c],[d,e,f],[g,hh,1]]; compose with
    # x' = (x+s)/2s, y' = (s−y)/2s
    k = 0.5 / s
    return [[a * k, -b * k, 0.5 * a + 0.5 * b + c],
            [d * k, -e * k, 0.5 * d + 0.5 * e + f],
            [g * k, -hh * k, 0.5 * g + 0.5 * hh + 1.0]]


def _ippe_rotations_entries(h):
    """Both IPPE rotation solutions from a homography given as 3x3
    scalar entries; returns two 3x3 scalar lists (SoA form of
    Collins & Bartoli 2014, §IPPE)."""
    inv22 = _safe_div(jnp.ones_like(h[2][2]), h[2][2])
    h = [[h[i][j] * inv22 for j in range(3)] for i in range(3)]
    u0, v0 = h[0][2], h[1][2]
    # rotate the camera so the origin's ray is the optical axis:
    # rv = I + [k]ₓ + [k]ₓ²/(1+cosθ), k = e_z × d, d = (u0,v0,1)/‖·‖
    nrm = jnp.sqrt(u0 * u0 + v0 * v0 + 1.0)
    d0, d1, c = u0 / nrm, v0 / nrm, 1.0 / nrm
    m = 1.0 / jnp.maximum(1.0 + c, 1e-6)
    rv = [[1.0 - d0 * d0 * m, -d0 * d1 * m, d0],
          [-d0 * d1 * m, 1.0 - d1 * d1 * m, d1],
          [-d0, -d1, 1.0 - (d0 * d0 + d1 * d1) * m]]
    # hp = rvᵀ h; 2x2 Jacobian at the rotated origin A = hp[:2,:2]/hp22
    hp = [[rv[0][i] * h[0][j] + rv[1][i] * h[1][j]
           + rv[2][i] * h[2][j] for j in range(3)] for i in range(3)]
    ihp22 = _safe_div(jnp.ones_like(hp[2][2]), hp[2][2])
    a00, a01 = hp[0][0] * ihp22, hp[0][1] * ihp22
    a10, a11 = hp[1][0] * ihp22, hp[1][1] * ihp22
    # gamma = 1/σ_max(A); closed-form 2x2 spectral radius of AᵀA
    g00 = a00 * a00 + a10 * a10
    g01 = a00 * a01 + a10 * a11
    g11 = a01 * a01 + a11 * a11
    tr = g00 + g11
    det = g00 * g11 - g01 * g01
    disc = jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0))
    gamma = 1.0 / jnp.sqrt(jnp.maximum(0.5 * (tr + disc), _EPS))
    gg = gamma * gamma
    ga00, ga01 = gamma * a00, gamma * a01
    ga10, ga11 = gamma * a10, gamma * a11
    c1 = jnp.sqrt(jnp.maximum(1.0 - gg * g00, 0.0))
    c2m = jnp.sqrt(jnp.maximum(1.0 - gg * g11, 0.0))
    c2 = jnp.where(g01 > 0, -c2m, c2m)  # c1*c2 = −gamma² g01

    def build(c1v, c2v):
        # rp columns: (γA col1, γA col2, col1 × col2); r = rv @ rp
        cx = ga10 * c2v - c1v * ga11
        cy = c1v * ga01 - ga00 * c2v
        cz = ga00 * ga11 - ga10 * ga01
        rp = [[ga00, ga01, cx], [ga10, ga11, cy], [c1v, c2v, cz]]
        return [[rv[i][0] * rp[0][j] + rv[i][1] * rp[1][j]
                 + rv[i][2] * rp[2][j] for j in range(3)]
                for i in range(3)]

    return build(c1, c2), build(-c1, -c2)


def _rx_entries(rr, ox, oy, k):
    """Rotated object point R X_k for the z = 0 corner k."""
    return (rr[0][0] * ox[k] + rr[0][1] * oy[k],
            rr[1][0] * ox[k] + rr[1][1] * oy[k],
            rr[2][0] * ox[k] + rr[2][1] * oy[k])


def _solve_translation_entries(rr, ox, oy, u, v):
    """Least-squares translation given rotation: per point,
    (r1·X + t1) − u (r3·X + t3) = 0 and likewise for v — 3x3 normal
    equations assembled and Cholesky-solved entirely in scalars."""
    one = jnp.ones_like(u[0])
    n00 = 4.0 * one
    n02 = -(u[0] + u[1] + u[2] + u[3])
    n12 = -(v[0] + v[1] + v[2] + v[3])
    n22 = sum(u[k] * u[k] + v[k] * v[k] for k in range(4))
    b0 = jnp.zeros_like(u[0])
    b1 = jnp.zeros_like(u[0])
    b2 = jnp.zeros_like(u[0])
    for k in range(4):
        rxx, rxy, rxz = _rx_entries(rr, ox, oy, k)
        bu = u[k] * rxz - rxx
        bv = v[k] * rxz - rxy
        b0 = b0 + bu
        b1 = b1 + bv
        b2 = b2 - u[k] * bu - v[k] * bv
    zero = jnp.zeros_like(u[0])
    t = small.solve_spd_entries(
        [[n00], [zero, n00], [n02, n12, n22]], [b0, b1, b2])
    return list(t)


def _reproj_rms_entries(rr, tt, ox, oy, u, v):
    """RMS normalized reprojection error + non-positive-depth penalty
    (so such solutions always lose the ambiguity vote)."""
    e2 = 0.0
    pen = 0.0
    for k in range(4):
        rxx, rxy, rxz = _rx_entries(rr, ox, oy, k)
        pz = rxz + tt[2]
        z = jnp.maximum(pz, 1e-6)
        x = (rxx + tt[0]) / z
        y = (rxy + tt[1]) / z
        e2 = e2 + (x - u[k]) ** 2 + (y - v[k]) ** 2
        pen = pen + jnp.maximum(0.3 - pz, 0.0)
    return jnp.sqrt(e2 * 0.25) + pen * 1e3


def _gn_refine_entries(rr, tt, ox, oy, uo, vo, iters: int,
                       damping: float = 1e-9):
    """Fixed-iteration damped Gauss-Newton on the normalized-coordinate
    reprojection residual; parameters are [δθ (left rotvec), δt].

    Jacobians are analytic — for p = Exp(δθ) R X + (t + δt):
        ∂π/∂p = [[1/z, 0, −x/z²], [0, 1/z, −y/z²]],
        ∂p/∂δθ = −[R X]ₓ,   ∂p/∂δt = I.

    Written in structure-of-arrays scalar form: the 4 corners, the 21
    JᵀJ entries, the 6x6 Cholesky, and the 3x3 rotation update are all
    unrolled into batched-scalar arithmetic with NO small trailing
    tensor dims. Stacked (4,2,3)/(3,3) intermediates pad out to whole
    layout tiles at serving batch sizes, whereas scalars fuse into a
    single elementwise kernel inside the loop.
    """
    dt = tt[0].dtype

    def body(_, carry):
        rr = [[carry[3 * i + j] for j in range(3)] for i in range(3)]
        tt = [carry[9], carry[10], carry[11]]
        jtj = [[jnp.asarray(damping, dt) if i == j else
                jnp.asarray(0.0, dt) for j in range(i + 1)]
               for i in range(6)]
        jtr = [jnp.asarray(0.0, dt) for _ in range(6)]
        for k in range(4):
            a0, a1, a2 = _rx_entries(rr, ox, oy, k)
            z = jnp.maximum(a2 + tt[2], 1e-6)
            iz = 1.0 / z
            x = (a0 + tt[0]) * iz
            y = (a1 + tt[1]) * iz
            ru = x - uo[k]
            rv = y - vo[k]
            # rows of J for this point: [−[RX]ₓ chained | dπ/dp]
            ju = [-x * a1 * iz, (a2 + x * a0) * iz, -a1 * iz,
                  iz, jnp.asarray(0.0, dt), -x * iz]
            jv = [-(a2 + y * a1) * iz, y * a0 * iz, a0 * iz,
                  jnp.asarray(0.0, dt), iz, -y * iz]
            for i in range(6):
                for j in range(i + 1):
                    jtj[i][j] = jtj[i][j] + ju[i] * ju[j] \
                        + jv[i] * jv[j]
                jtr[i] = jtr[i] + ju[i] * ru + jv[i] * rv
        delta = small.solve_spd_entries(jtj, [-g for g in jtr])
        # rotation update R ← Exp(δθ) R, unrolled via the quaternion
        w0, w1, w2 = delta[0], delta[1], delta[2]
        th = jnp.sqrt(w0 * w0 + w1 * w1 + w2 * w2)
        half = 0.5 * th
        small_ang = th < 1e-8
        f = jnp.where(small_ang, 0.5,
                      jnp.sin(half) / jnp.where(small_ang, 1.0, th))
        qw = jnp.cos(half)
        qx, qy, qz = f * w0, f * w1, f * w2
        dm = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
               2 * (qx * qz + qy * qw)],
              [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
               2 * (qy * qz - qx * qw)],
              [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
               1 - 2 * (qx * qx + qy * qy)]]
        out = []
        for i in range(3):
            for j in range(3):
                out.append(dm[i][0] * rr[0][j] + dm[i][1] * rr[1][j]
                           + dm[i][2] * rr[2][j])
        out.extend([tt[0] + delta[3], tt[1] + delta[4],
                    tt[2] + delta[5]])
        return tuple(out)

    carry0 = tuple(rr[0] + rr[1] + rr[2] + list(tt))
    out = jax.lax.fori_loop(0, iters, body, carry0)
    return ([[out[3 * i + j] for j in range(3)] for i in range(3)],
            [out[9], out[10], out[11]])


def solve_square_pnp_normalized(img_xy: jnp.ndarray, marker_size,
                                refine_iters: int = 8) -> PnPResult:
    """IPPE-square PnP from normalized (undistorted) corner coords.

    img_xy: (4, 2). Use `solve_square_pnp` for pixel input. The `err`
    fields here are in normalized coordinates.

    The whole solve — closed-form homography, IPPE rotations,
    translation, dual-basin Gauss-Newton, disambiguation — runs in
    structure-of-arrays scalar form (see _gn_refine_entries for why),
    so vmapping over millions of markers stays one fused elementwise
    program. Both ambiguity candidates are refined: near-degenerate
    views can put the closed-form winner in the wrong basin, where
    Gauss-Newton stalls at a poor local minimum.
    """
    s = marker_size / 2.0
    one = jnp.ones((), img_xy.dtype)
    ox = [-s * one, s * one, s * one, -s * one]
    oy = [s * one, s * one, -s * one, -s * one]
    u = [img_xy[k, 0] for k in range(4)]
    v = [img_xy[k, 1] for k in range(4)]

    h = _h_square_entries(s * one, u, v)
    r1e, r2e = _ippe_rotations_entries(h)
    t1e = _solve_translation_entries(r1e, ox, oy, u, v)
    t2e = _solve_translation_entries(r2e, ox, oy, u, v)
    r1e, t1e = _gn_refine_entries(r1e, t1e, ox, oy, u, v, refine_iters)
    r2e, t2e = _gn_refine_entries(r2e, t2e, ox, oy, u, v, refine_iters)
    e1 = _reproj_rms_entries(r1e, t1e, ox, oy, u, v)
    e2 = _reproj_rms_entries(r2e, t2e, ox, oy, u, v)
    best_first = e1 <= e2
    r = jnp.stack([
        jnp.stack([jnp.where(best_first, r1e[i][j], r2e[i][j])
                   for j in range(3)], -1) for i in range(3)], -2)
    t = jnp.stack([jnp.where(best_first, t1e[i], t2e[i])
                   for i in range(3)], -1)
    err = jnp.where(best_first, e1, e2)
    q = quat.from_matrix(r)
    return PnPResult(t_cl=t, q_cl=q, rvec=quat.to_rotvec(q), err=err,
                     err2=jnp.where(best_first, e2, e1))


@functools.partial(jax.jit, static_argnums=(3,))
def solve_square_pnp(cam: cam_mod.CameraModel, corners_px: jnp.ndarray,
                     marker_size, refine_iters: int = 8) -> PnPResult:
    """Batched IPPE-square PnP from distorted pixel corners.

    corners_px: (..., 4, 2) in IPPE_SQUARE order. All leading batch
    dims are vmapped; the per-marker work is 8x8 + 3x3 + 6x6 solves.
    Reported errors are converted to approximate pixels using the mean
    focal length.

    Jitted at module level: the drivers call this EAGERLY per chunk,
    and the SoA-scalar solve is hundreds of tiny ops per marker —
    measured 3.4 s for one eager 24-frame chunk on CPU vs
    milliseconds compiled (inside other jits the decorator inlines).
    """
    xy = cam_mod.pixel_to_ray(cam, corners_px)
    batch = xy.shape[:-2]
    flat = xy.reshape((-1, 4, 2))
    res = jax.vmap(
        lambda c: solve_square_pnp_normalized(c, marker_size, refine_iters)
    )(flat)
    f = 0.5 * (cam.fx + cam.fy)
    return PnPResult(
        t_cl=res.t_cl.reshape(*batch, 3),
        q_cl=res.q_cl.reshape(*batch, 4),
        rvec=res.rvec.reshape(*batch, 3),
        err=(res.err * f).reshape(batch),
        err2=(res.err2 * f).reshape(batch),
    )
