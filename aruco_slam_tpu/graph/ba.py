"""Batched Schur-complement bundle adjustment on marker pose graphs.

Problem structure (mirrors the reference's factor graph, reference
filters/factor_graph.py:92-300):

* pose variables X_0 .. X_{n-1} — camera poses (camera-to-world),
* landmark variables L_j — marker positions (3-vectors; the reference's
  landmark Pose3 rotations are vestigial — only translations are ever
  read out, reference factor_graph.py:201-204 — so we model points),
* a hard prior on X_0 (the reference uses zero-sigma start noise,
  reference factor_graph.py:41-43: we freeze X_0 as the gauge),
* identity-motion odometry factors between consecutive poses
  (reference factor_graph.py:161-189),
* camera→landmark observation factors carrying the PnP translation
  t_cl (reference factor_graph.py:287-300 uses a BetweenFactorPose3
  whose rotation is a copy of the current camera estimate — i.e. only
  the translation is informative; we use the honest 3-dim point
  factor r = R_iᵀ(l_j − t_i) − t_cl).

Accelerator shape of the solve: all residual/Jacobian blocks are produced by
``vmap(jacfwd(...))`` over factor arrays, the normal equations are
assembled with scatter-adds into dense blocks, landmarks are
eliminated with a **dense** Schur complement

    S = H_pp − W H_ll⁻¹ Wᵀ,      g_s = g_p − W H_ll⁻¹ g_l,

and the reduced (6n × 6n) camera system is solved by Cholesky. With
≤ a few thousand poses and ≤ a few hundred markers the dense forms are
small by accelerator standards — a handful of dense matmuls — and avoid every
sparse/pointer structure GTSAM's Bayes tree needs on CPU.

Fixed capacity everywhere: `max_poses`, `max_landmarks`, `max_factors`
with validity masks; padded entries contribute exactly zero and padded
variables are frozen with identity diagonal blocks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from aruco_slam_tpu.core import quaternion as quat

_PI = 3.141592653589793


class GraphConfig(NamedTuple):
    """Capacities + noise model. Noise defaults equal the reference's
    (reference filters/factor_graph.py:20-25)."""

    max_poses: int = 128
    max_landmarks: int = 64
    max_factors: int = 1024
    odom_sigma_rot: float = 20.0 * _PI / 180.0
    odom_sigma_t: float = 0.1
    meas_sigma_t: float = 0.5
    # depth-scaled per-axis measurement whitening: if pixel_sigma > 0,
    # each factor is whitened with [sig_xy, sig_xy, sig_z](depth) from
    # the planar-PnP error law sig_z = px * z^2 / (f*s), sig_xy =
    # sig_z/3 (same model as filters/mekf.py) instead of the constant
    # isotropic meas_sigma_t — depth errors are ~9x lateral at range,
    # and a constant sigma misweights them.
    pixel_sigma: float = 0.0
    focal_px: float = 1414.9
    marker_size: float = 0.16
    # 6-dof landmarks: estimate marker ORIENTATIONS too (the reference
    # stores full Pose3 landmarks, reference factor_graph.py:287-300;
    # its rotation measurements are vestigial copies of the camera
    # estimate, but our online mekf_rotations produces real landmark
    # orientations — this is the offline smoother that can refine
    # them). Measurement factors gain a 3-dim rotation residual
    # Log(q_cl_meas^-1 (q_i^-1 q_lj)) whitened by meas_sigma_rot, and
    # the Schur landmark blocks become 6x6.
    with_rotations: bool = False
    meas_sigma_rot: float = 0.35  # ~20 deg, matches the odometry prior
    # Levenberg-Marquardt (reference factor_graph.py:334-336)
    lm_init_lambda: float = 1e-4
    lm_factor: float = 4.0
    # robust (Huber) loss on measurement factors: whitened residuals
    # beyond `huber_delta` are IRLS-downweighted by sqrt(delta/|r|)
    # (0 = plain least squares, the reference's behavior — GTSAM
    # supports robust noise models but the reference never enables one)
    huber_delta: float = 0.0
    dtype: jnp.dtype = jnp.float32

    @property
    def lm_dim(self) -> int:
        """Landmark error-state dimension: 3 (point) or 6 (pose)."""
        return 6 if self.with_rotations else 3


class GraphState(NamedTuple):
    """Fixed-capacity pose-graph problem + current estimates.

    ``prior_lm_h``/``prior_lm_mean`` carry per-landmark Gaussian
    priors in information form — the residue of marginalized-out
    poses (see `marginalize_poses`). Zero information = no prior."""

    pose_q: jnp.ndarray    # (T, 4) wxyz camera-to-world
    pose_t: jnp.ndarray    # (T, 3)
    lm: jnp.ndarray        # (L, 3) marker positions (world)
    lm_q: jnp.ndarray      # (L, 4) marker orientations (world, wxyz;
    #                        identity and unused unless with_rotations)
    lm_active: jnp.ndarray  # (L,) bool
    num_poses: jnp.ndarray  # () int32 — poses 0..num_poses-1 are live
    f_pose: jnp.ndarray    # (F,) int32 observing pose index
    f_lm: jnp.ndarray      # (F,) int32 observed landmark index
    f_tcl: jnp.ndarray     # (F, 3) measured marker pos in camera frame
    f_qcl: jnp.ndarray     # (F, 4) measured marker orientation in the
    #                        camera frame (identity unless with_rotations)
    f_sig: jnp.ndarray     # (F, 3) per-axis whitening sigmas
    f_valid: jnp.ndarray   # (F,) bool
    f_count: jnp.ndarray   # () int32
    prior_lm_h: jnp.ndarray     # (L, 3, 3) information (position block)
    prior_lm_mean: jnp.ndarray  # (L, 3)


def init_graph(cfg: GraphConfig, cam_t=None, cam_q=None) -> GraphState:
    dt = cfg.dtype
    pose_q = jnp.zeros((cfg.max_poses, 4), dt).at[:, 0].set(1.0)
    pose_t = jnp.zeros((cfg.max_poses, 3), dt)
    if cam_q is not None:
        pose_q = pose_q.at[0].set(jnp.asarray(cam_q, dt))
    if cam_t is not None:
        pose_t = pose_t.at[0].set(jnp.asarray(cam_t, dt))
    return GraphState(
        pose_q=pose_q,
        pose_t=pose_t,
        lm=jnp.zeros((cfg.max_landmarks, 3), dt),
        lm_q=jnp.zeros((cfg.max_landmarks, 4), dt).at[:, 0].set(1.0),
        lm_active=jnp.zeros(cfg.max_landmarks, bool),
        num_poses=jnp.asarray(1, jnp.int32),
        f_pose=jnp.zeros(cfg.max_factors, jnp.int32),
        f_lm=jnp.zeros(cfg.max_factors, jnp.int32),
        f_tcl=jnp.zeros((cfg.max_factors, 3), dt),
        f_qcl=jnp.zeros((cfg.max_factors, 4), dt).at[:, 0].set(1.0),
        f_sig=jnp.full((cfg.max_factors, 3), cfg.meas_sigma_t, dt),
        f_valid=jnp.zeros(cfg.max_factors, bool),
        f_count=jnp.asarray(0, jnp.int32),
        prior_lm_h=jnp.zeros((cfg.max_landmarks, 3, 3), dt),
        prior_lm_mean=jnp.zeros((cfg.max_landmarks, 3), dt),
    )


@functools.partial(jax.jit, static_argnums=0)
def add_frame(cfg: GraphConfig, state: GraphState, t_cl: jnp.ndarray,
              mask: jnp.ndarray, q_cl: jnp.ndarray | None = None
              ) -> GraphState:
    """Ingest one frame: measurement factors for observed slots, new
    landmark initialization, and the next pose (identity motion model,
    reference factor_graph.py:161-189).

    ``t_cl``: (C, 3) marker positions in the camera frame, slot-indexed
    (slot == landmark index == marker id); ``mask``: (C,) bool;
    ``q_cl``: (C, 4) marker orientations in the camera frame (wxyz),
    used when cfg.with_rotations. Observations beyond factor capacity
    are dropped (oldest-first semantics are preserved by construction
    — new factors append).
    """
    dt = cfg.dtype
    i = state.num_poses - 1  # current pose index
    cam_q = state.pose_q[i]
    cam_t = state.pose_t[i]
    t_cl = jnp.where(mask[:, None], t_cl.astype(dt), 0.0)
    if q_cl is None:
        q_cl = jnp.zeros(t_cl.shape[:1] + (4,), dt).at[:, 0].set(1.0)
    else:
        q_cl = jnp.where(mask[:, None], quat.normalize(
            q_cl.astype(dt)), jnp.asarray([1.0, 0, 0, 0], dt))

    # initialize unseen landmarks in the world frame
    new = mask & ~state.lm_active
    lm_init = quat.rotate(cam_q[None, :], t_cl) + cam_t
    lm = jnp.where(new[:, None], lm_init, state.lm)
    lmq_init = quat.multiply(cam_q[None, :], q_cl)
    lm_q = jnp.where(new[:, None], lmq_init, state.lm_q)
    lm_active = state.lm_active | mask

    # append measurement factors at slots f_count + rank(slot in mask)
    c = mask.shape[0]
    rank = jnp.cumsum(mask) - 1                     # (C,)
    dest = state.f_count + rank                     # (C,)
    ok = mask & (dest < cfg.max_factors)
    # masked-off slots scatter out of bounds and are dropped — this
    # avoids write collisions between live and dead lanes
    dest_safe = jnp.where(ok, dest, cfg.max_factors)
    slots = jnp.arange(c, dtype=jnp.int32)

    def scatter(arr, vals):
        return arr.at[dest_safe].set(vals, mode="drop")

    f_pose = scatter(state.f_pose, jnp.full(c, i, jnp.int32))
    f_lm = scatter(state.f_lm, slots)
    f_tcl = scatter(state.f_tcl, t_cl)
    f_qcl = scatter(state.f_qcl, q_cl)
    if cfg.pixel_sigma > 0.0:
        depth = jnp.clip(t_cl[:, 2], 0.2, None)
        sig_z = jnp.maximum(
            cfg.pixel_sigma * depth * depth
            / (cfg.focal_px * cfg.marker_size), 1e-4)
        sig = jnp.stack([sig_z / 3.0, sig_z / 3.0, sig_z], axis=-1)
    else:
        sig = jnp.full((c, 3), cfg.meas_sigma_t, dt)
    f_sig = scatter(state.f_sig, sig.astype(dt))
    f_valid = scatter(state.f_valid, ok)
    f_count = jnp.minimum(
        state.f_count + jnp.sum(mask, dtype=jnp.int32),
        jnp.asarray(cfg.max_factors, jnp.int32))

    # next pose: identity motion model (estimate = current pose)
    nxt = jnp.minimum(state.num_poses, cfg.max_poses - 1)
    pose_q = state.pose_q.at[nxt].set(cam_q)
    pose_t = state.pose_t.at[nxt].set(cam_t)
    num_poses = jnp.minimum(state.num_poses + 1,
                            jnp.asarray(cfg.max_poses, jnp.int32))

    return state._replace(
        pose_q=pose_q, pose_t=pose_t, lm=lm, lm_q=lm_q,
        lm_active=lm_active, num_poses=num_poses, f_pose=f_pose,
        f_lm=f_lm, f_tcl=f_tcl, f_qcl=f_qcl, f_sig=f_sig,
        f_valid=f_valid, f_count=f_count)


@functools.partial(jax.jit, static_argnums=(0, 2))
def marginalize_poses(cfg: GraphConfig, state: GraphState,
                      n_drop: int) -> GraphState:
    """Drop the oldest `n_drop` poses, absorbing their information
    into per-landmark Gaussian priors — the bounded-memory online mode
    (the capability the reference gets from `graph.resize(100)` +
    ISAM2's marginalization, reference factor_graph.py:220-224).

    Exactness: the dropped subsystem (all factors touching poses
    < n_drop) is linearized at the current estimate and the dropped
    poses are Schur-eliminated jointly. Of the resulting fill-in we
    keep the landmark block DIAGONAL (cross-landmark and landmark-to-
    kept-pose coupling is discarded — the standard sliding-window
    approximation; the first kept pose is gauge-frozen afterwards, so
    its fill-in row carries no information anyway).

    Pose 0's Jacobians are dropped (it was the frozen gauge anchor —
    a fixed parameter, not a variable to eliminate).
    """
    dt = cfg.dtype
    tcap, lcap = cfg.max_poses, cfg.max_landmarks
    d6 = n_drop * 6
    z6 = jnp.zeros(6, dt)
    z3 = jnp.zeros(3, dt)

    dropped = state.f_valid & (state.f_pose < n_drop)
    fq = state.pose_q[state.f_pose]
    ft = state.pose_t[state.f_pose]
    fl = state.lm[state.f_lm]

    def meas_all(q, t, l, tcl, sig):
        r = _meas_residual(z6, z3, q, t, l, tcl, sig)
        jp, jl = jax.jacfwd(_meas_residual, argnums=(0, 1))(
            z6, z3, q, t, l, tcl, sig)
        return r, jp, jl

    r_m, jp_m, jl_m = jax.vmap(meas_all)(fq, ft, fl, state.f_tcl,
                                         state.f_sig)
    if cfg.huber_delta > 0.0:
        rn = jnp.linalg.norm(r_m, axis=-1)
        wgt = jnp.sqrt(jnp.minimum(
            1.0, cfg.huber_delta / jnp.maximum(rn, 1e-12))).astype(dt)
        r_m, jp_m, jl_m = (r_m * wgt[:, None], jp_m * wgt[:, None, None],
                           jl_m * wgt[:, None, None])
    r_m = jnp.where(dropped[:, None], r_m, 0.0)
    # pose 0 = frozen gauge: not a variable
    jp_m = jnp.where((dropped & (state.f_pose > 0))[:, None, None],
                     jp_m, 0.0)
    jl_m = jnp.where(dropped[:, None, None], jl_m, 0.0)

    # dropped-pose system H_dd (6D, 6D), clamped scatter indices
    fp = jnp.minimum(state.f_pose, n_drop - 1)
    h_dd4 = jnp.zeros((n_drop, 6, n_drop, 6), dt)
    h_dd4 = h_dd4.at[fp, :, fp, :].add(
        jnp.einsum("fmi,fmj->fij", jp_m, jp_m))
    g_d = jnp.zeros((n_drop, 6), dt).at[fp].add(
        -jnp.einsum("fmi,fm->fi", jp_m, r_m))

    # odometry factors among dropped poses (pairs a=i, b=i-1, a<n_drop)
    # and the boundary pair a=n_drop (kept, treated as fixed): only
    # its J_b (dropped side) enters
    idx_a = jnp.arange(1, tcap)
    idx_b = jnp.arange(0, tcap - 1)
    o_live = idx_a < state.num_poses

    def odom_all(qa, ta, qb, tb):
        r = _odom_residual(z6, z6, qa, ta, qb, tb,
                           cfg.odom_sigma_rot, cfg.odom_sigma_t)
        ja, jb = jax.jacfwd(_odom_residual, argnums=(0, 1))(
            z6, z6, qa, ta, qb, tb, cfg.odom_sigma_rot,
            cfg.odom_sigma_t)
        return r, ja, jb

    r_o, ja_o, jb_o = jax.vmap(odom_all)(
        state.pose_q[idx_a], state.pose_t[idx_a],
        state.pose_q[idx_b], state.pose_t[idx_b])
    o_drop = o_live & (idx_a <= n_drop)      # touches a dropped pose
    r_o = jnp.where(o_drop[:, None], r_o, 0.0)
    ja_o = jnp.where((o_drop & (idx_a < n_drop))[:, None, None],
                     ja_o, 0.0)
    jb_o = jnp.where((o_drop & (idx_b > 0))[:, None, None], jb_o, 0.0)
    oa = jnp.minimum(idx_a, n_drop - 1)
    ob = jnp.minimum(idx_b, n_drop - 1)
    h_dd4 = h_dd4.at[oa, :, oa, :].add(
        jnp.einsum("fmi,fmj->fij", ja_o, ja_o))
    h_dd4 = h_dd4.at[ob, :, ob, :].add(
        jnp.einsum("fmi,fmj->fij", jb_o, jb_o))
    cross = jnp.einsum("fmi,fmj->fij", ja_o, jb_o)
    h_dd4 = h_dd4.at[oa, :, ob, :].add(cross)
    h_dd4 = h_dd4.at[ob, :, oa, :].add(jnp.swapaxes(cross, -1, -2))
    g_d = g_d.at[oa].add(-jnp.einsum("fmi,fm->fi", ja_o, r_o))
    g_d = g_d.at[ob].add(-jnp.einsum("fmi,fm->fi", jb_o, r_o))
    h_dd = h_dd4.reshape(d6, d6) + 1e-6 * jnp.eye(d6, dtype=dt)

    # coupling W (6D, L, 3) and dropped-factor landmark blocks
    w_d = jnp.zeros((n_drop, 6, lcap, 3), dt)
    w_d = w_d.at[fp, :, state.f_lm, :].add(
        jnp.einsum("fmi,fmj->fij", jp_m, jl_m))
    w_d = w_d.reshape(d6, lcap, 3)
    h_ll_f = jnp.zeros((lcap, 3, 3), dt).at[state.f_lm].add(
        jnp.einsum("fmi,fmj->fij", jl_m, jl_m))
    g_lf = jnp.zeros((lcap, 3), dt).at[state.f_lm].add(
        -jnp.einsum("fmi,fm->fi", jl_m, r_m))

    # Schur: Λ_add[j] = H_j − W_jᵀ H_dd⁻¹ W_j ; g'_j = g_j − W_jᵀ H_dd⁻¹ g_d
    fact = cho_factor(h_dd, lower=True)
    hinv_w = cho_solve(fact, w_d.reshape(d6, lcap * 3)) \
        .reshape(d6, lcap, 3)
    lam_add = h_ll_f - jnp.einsum("nlj,nlk->ljk", w_d, hinv_w)
    lam_add = 0.5 * (lam_add + jnp.swapaxes(lam_add, -1, -2))
    hinv_g = cho_solve(fact, g_d.reshape(d6))
    g_sch = g_lf - jnp.einsum("nlj,n->lj", w_d, hinv_g)

    # fold into the existing prior: the new information sits at mean
    # m_add with Λ_add m_add = Λ_add lm + g' (by construction at the
    # linearization point), so the information-weighted mean combine
    # needs no solve against the possibly-singular Λ_add itself
    eye3 = jnp.eye(3, dtype=dt)
    lam_new = state.prior_lm_h + lam_add
    lam_new_s = lam_new + 1e-8 * eye3[None]
    num = jnp.einsum("lij,lj->li", state.prior_lm_h,
                     state.prior_lm_mean) \
        + jnp.einsum("lij,lj->li", lam_add, state.lm) + g_sch
    m_new = jnp.linalg.solve(lam_new_s, num[..., None])[..., 0]
    touched = jnp.zeros(lcap, bool).at[
        jnp.where(dropped, state.f_lm, lcap)].set(True, mode="drop")
    prior_lm_h = jnp.where(touched[:, None, None], lam_new,
                           state.prior_lm_h)
    prior_lm_mean = jnp.where(touched[:, None], m_new,
                              state.prior_lm_mean)

    # compact: drop absorbed factors, shift pose indices down
    keep = state.f_valid & (state.f_pose >= n_drop)
    rank = jnp.cumsum(keep) - 1
    dest = jnp.where(keep, rank, cfg.max_factors)

    def compact(arr, fill=0):
        out = jnp.full_like(arr, fill)
        return out.at[dest].set(arr, mode="drop")

    f_pose = compact(state.f_pose) - jnp.asarray(n_drop, jnp.int32)
    f_pose = jnp.maximum(f_pose, 0)
    f_lm = compact(state.f_lm)
    f_tcl = compact(state.f_tcl)
    # invalid slots get the identity quaternion (w=1 via fill on the
    # scalar column after compaction)
    f_qcl = compact(state.f_qcl).at[:, 0].add(
        1.0 - compact(state.f_valid.astype(dt)))
    # invalid slots keep a nonzero sigma (residuals divide by it
    # before the validity mask zeroes them)
    f_sig = compact(state.f_sig, fill=cfg.meas_sigma_t)
    f_valid = compact(state.f_valid.astype(jnp.int32)).astype(bool)
    f_count = jnp.sum(keep, dtype=jnp.int32)

    pose_q = jnp.roll(state.pose_q, -n_drop, axis=0)
    pose_t = jnp.roll(state.pose_t, -n_drop, axis=0)
    num_poses = jnp.maximum(state.num_poses - n_drop, 1)

    return state._replace(
        pose_q=pose_q, pose_t=pose_t, num_poses=num_poses,
        f_pose=f_pose, f_lm=f_lm, f_tcl=f_tcl, f_qcl=f_qcl,
        f_sig=f_sig, f_valid=f_valid, f_count=f_count,
        prior_lm_h=prior_lm_h, prior_lm_mean=prior_lm_mean)


# ---------------------------------------------------------------------------
# Residuals (whitened) and their Jacobian blocks, batched per factor.
# ---------------------------------------------------------------------------

def _meas_residual(eps_p, eps_l, pose_q, pose_t, lm, t_cl, sigma_t):
    """Whitened point-observation residual (3,).

    ``sigma_t``: scalar or (3,) per-axis whitening (camera frame — the
    residual lives there, so the depth axis gets its own sigma).
    Perturbation convention: eps_p = [δθ (right rotvec), δt (world)].
    """
    q = quat.multiply(pose_q, quat.from_rotvec(eps_p[:3]))
    t = pose_t + eps_p[3:]
    pred = quat.rotate(quat.conjugate(q), lm + eps_l - t)
    return (pred - t_cl) / sigma_t


def _meas_residual_rot(eps_p, eps_l, pose_q, pose_t, lm, lm_q, t_cl,
                       q_cl, sigma_t, sigma_rot):
    """Whitened 6-dof pose-landmark observation residual (6,):
    [position (camera frame) / sigma_t, Log(q_cl_meas⁻¹ q_cl_pred)
    / sigma_rot]. Landmark perturbation eps_l = [δl (world), δθ
    (right rotvec on q_lj)] — the offline counterpart of
    mekf_rotations' landmark error state (filters/mekf.py)."""
    q = quat.multiply(pose_q, quat.from_rotvec(eps_p[:3]))
    t = pose_t + eps_p[3:]
    lq = quat.multiply(lm_q, quat.from_rotvec(eps_l[3:]))
    pred_t = quat.rotate(quat.conjugate(q), lm + eps_l[:3] - t)
    r_t = (pred_t - t_cl) / sigma_t
    pred_q = quat.multiply(quat.conjugate(q), lq)
    r_r = quat.to_rotvec(
        quat.multiply(quat.conjugate(q_cl), pred_q)) / sigma_rot
    return jnp.concatenate([r_t, r_r])


def _odom_residual(eps_a, eps_b, qa, ta, qb, tb, sig_rot, sig_t):
    """Whitened identity-motion between-factor residual (6,) for the
    pose pair (a = X_{i}, b = X_{i-1}): [Log(R_aᵀ R_b), R_aᵀ(t_b − t_a)]
    — the expected relative pose is the identity (reference
    factor_graph.py:178-185)."""
    q_a = quat.multiply(qa, quat.from_rotvec(eps_a[:3]))
    t_a = ta + eps_a[3:]
    q_b = quat.multiply(qb, quat.from_rotvec(eps_b[:3]))
    t_b = tb + eps_b[3:]
    rel_q = quat.multiply(quat.conjugate(q_a), q_b)
    r_rot = quat.to_rotvec(rel_q) / sig_rot
    r_t = quat.rotate(quat.conjugate(q_a), t_b - t_a) / sig_t
    return jnp.concatenate([r_rot, r_t])


class MeasTerms(NamedTuple):
    """Measurement-factor contributions to the normal equations — a
    plain pytree of sums over factors, so partial results computed on
    factor *shards* combine with `psum` (see parallel/sharded_ba.py).
    D = cfg.lm_dim (3 point / 6 pose landmarks)."""

    diag: jnp.ndarray   # (T, 6, 6) pose diagonal blocks
    w4: jnp.ndarray     # (T, 6, L, D) pose-landmark coupling
    h_ll: jnp.ndarray   # (L, D, D) landmark blocks
    g_p: jnp.ndarray    # (T, 6)
    g_l: jnp.ndarray    # (L, D)
    cost: jnp.ndarray   # ()


def _meas_linearize(cfg: GraphConfig, state: GraphState):
    """Per-factor residuals + Jacobian blocks:
    (r (F, m), jp (F, m, 6), jl (F, m, D)) with m = 3 or 6."""
    dt = cfg.dtype
    z6 = jnp.zeros(6, dt)
    zl = jnp.zeros(cfg.lm_dim, dt)
    fq = state.pose_q[state.f_pose]
    ft = state.pose_t[state.f_pose]
    fl = state.lm[state.f_lm]

    if cfg.with_rotations:
        flq = state.lm_q[state.f_lm]

        def meas_all(q, t, l, lq, tcl, qcl, sig):
            args = (q, t, l, lq, tcl, qcl, sig, cfg.meas_sigma_rot)
            r = _meas_residual_rot(z6, zl, *args)
            jp, jl = jax.jacfwd(_meas_residual_rot, argnums=(0, 1))(
                z6, zl, *args)
            return r, jp, jl

        return jax.vmap(meas_all)(fq, ft, fl, flq, state.f_tcl,
                                  state.f_qcl, state.f_sig)

    def meas_all(q, t, l, tcl, sig):
        r = _meas_residual(z6, zl, q, t, l, tcl, sig)
        jp, jl = jax.jacfwd(_meas_residual, argnums=(0, 1))(
            z6, zl, q, t, l, tcl, sig)
        return r, jp, jl

    return jax.vmap(meas_all)(fq, ft, fl, state.f_tcl, state.f_sig)


def _meas_terms(cfg: GraphConfig, state: GraphState, pose_free
                ) -> MeasTerms:
    """Linearize the measurement factors carried by `state` (all of
    them, or — under shard_map — this device's shard) into summed
    normal-equation contributions."""
    dt = cfg.dtype
    tcap, lcap = cfg.max_poses, cfg.max_landmarks

    r_m, jp_m, jl_m = _meas_linearize(cfg, state)
    if cfg.huber_delta > 0.0:
        rn = jnp.linalg.norm(r_m, axis=-1)
        wgt = jnp.sqrt(jnp.minimum(
            1.0, cfg.huber_delta / jnp.maximum(rn, 1e-12))).astype(dt)
        r_m = r_m * wgt[:, None]
        jp_m = jp_m * wgt[:, None, None]
        jl_m = jl_m * wgt[:, None, None]
    valid = state.f_valid
    r_m = jnp.where(valid[:, None], r_m, 0.0)
    jp_m = jnp.where((valid & pose_free[state.f_pose])[:, None, None],
                     jp_m, 0.0)
    jl_m = jnp.where(valid[:, None, None], jl_m, 0.0)

    ld = cfg.lm_dim
    diag = jnp.zeros((tcap, 6, 6), dt).at[state.f_pose].add(
        jnp.einsum("fmi,fmj->fij", jp_m, jp_m))
    w4 = jnp.zeros((tcap, 6, lcap, ld), dt)
    w4 = w4.at[state.f_pose, :, state.f_lm, :].add(
        jnp.einsum("fmi,fmj->fij", jp_m, jl_m))
    h_ll = jnp.zeros((lcap, ld, ld), dt).at[state.f_lm].add(
        jnp.einsum("fmi,fmj->fij", jl_m, jl_m))
    g_p = jnp.zeros((tcap, 6), dt).at[state.f_pose].add(
        -jnp.einsum("fmi,fm->fi", jp_m, r_m))
    g_l = jnp.zeros((lcap, ld), dt).at[state.f_lm].add(
        -jnp.einsum("fmi,fm->fi", jl_m, r_m))
    return MeasTerms(diag=diag, w4=w4, h_ll=h_ll, g_p=g_p, g_l=g_l,
                     cost=jnp.sum(r_m * r_m))


def pose_free_mask(cfg: GraphConfig, state: GraphState, free_from):
    return (jnp.arange(cfg.max_poses) >= jnp.maximum(free_from, 1)) \
        & (jnp.arange(cfg.max_poses) < state.num_poses)


def _pose_system(cfg: GraphConfig, state: GraphState, pose_free,
                 meas: MeasTerms):
    """Odometry factors + measurement pose blocks → dense pose-pose
    system. Returns (h_pp (T6, T6), g_p (T6,), cost_meas+odom).
    Pose-side only: independent of any landmark sharding."""
    dt = cfg.dtype
    tcap = cfg.max_poses
    z6 = jnp.zeros(6, dt)

    # --- odometry factors between consecutive live poses ---
    idx_a = jnp.arange(1, tcap)             # X_i
    idx_b = jnp.arange(0, tcap - 1)         # X_{i-1}
    o_valid = idx_a < state.num_poses

    def odom_all(qa, ta, qb, tb):
        r = _odom_residual(z6, z6, qa, ta, qb, tb,
                           cfg.odom_sigma_rot, cfg.odom_sigma_t)
        ja, jb = jax.jacfwd(_odom_residual, argnums=(0, 1))(
            z6, z6, qa, ta, qb, tb, cfg.odom_sigma_rot, cfg.odom_sigma_t)
        return r, ja, jb

    r_o, ja_o, jb_o = jax.vmap(odom_all)(
        state.pose_q[idx_a], state.pose_t[idx_a],
        state.pose_q[idx_b], state.pose_t[idx_b])
    r_o = jnp.where(o_valid[:, None], r_o, 0.0)
    ja_o = jnp.where((o_valid & pose_free[idx_a])[:, None, None], ja_o, 0.0)
    jb_o = jnp.where((o_valid & pose_free[idx_b])[:, None, None], jb_o, 0.0)

    cost = meas.cost + jnp.sum(r_o * r_o)

    # --- assemble the dense pose-pose system ---
    h4 = jnp.zeros((tcap, 6, tcap, 6), dt)
    h4 = h4.at[jnp.arange(tcap), :, jnp.arange(tcap), :].add(meas.diag)
    h4 = h4.at[idx_a, :, idx_a, :].add(
        jnp.einsum("fmi,fmj->fij", ja_o, ja_o))
    h4 = h4.at[idx_b, :, idx_b, :].add(
        jnp.einsum("fmi,fmj->fij", jb_o, jb_o))
    cross = jnp.einsum("fmi,fmj->fij", ja_o, jb_o)
    h4 = h4.at[idx_a, :, idx_b, :].add(cross)
    h4 = h4.at[idx_b, :, idx_a, :].add(
        jnp.swapaxes(cross, -1, -2))
    # frozen poses: identity diagonal so the dense solve stays SPD
    frozen = ~pose_free
    h4 = h4.at[jnp.arange(tcap), :, jnp.arange(tcap), :].add(
        jnp.where(frozen[:, None, None], jnp.eye(6, dtype=dt), 0.0))
    h_pp = h4.reshape(tcap * 6, tcap * 6)

    g_p = meas.g_p
    g_p = g_p.at[idx_a].add(-jnp.einsum("fmi,fm->fi", ja_o, r_o))
    g_p = g_p.at[idx_b].add(-jnp.einsum("fmi,fm->fi", jb_o, r_o))
    return h_pp, g_p.reshape(tcap * 6), cost


def _landmark_system(cfg: GraphConfig, lm, lm_active, prior_h,
                     prior_mean, meas_h_ll, meas_g_l):
    """Landmark blocks + marginalization priors. Works on the full
    landmark set or (in the distributed path) on this device's
    landmark SHARD — every input is per-landmark, so slicing is
    exact. Returns (h_ll (l, D, D), g_l (l, D), prior_cost).

    Priors carry POSITION information only ((l, 3, 3) always): with
    6-dof landmarks they pad into the top-left block — pose
    marginalization folds no rotation information (see
    marginalize_poses), matching the MEKF's treatment of rotation
    uncertainty as filter-local."""
    dt = cfg.dtype
    ld = cfg.lm_dim
    # inactive landmarks: identity so the block inverse is well defined
    h_ll = meas_h_ll + jnp.where(
        lm_active[:, None, None], 0.0, 1.0) * jnp.eye(ld, dtype=dt)
    # marginalization priors (information form): quadratic factors
    # 0.5 (l - m)' Λ (l - m) per landmark (see marginalize_poses)
    h_ll = h_ll.at[:, :3, :3].add(prior_h)
    prior_r = prior_mean - lm                        # (l, 3)
    hp = jnp.einsum("lij,lj->li", prior_h, prior_r)
    g_l = meas_g_l.at[:, :3].add(hp)
    return h_ll, g_l, jnp.sum(prior_r * hp)


def _linearize(cfg: GraphConfig, state: GraphState, free_from,
               meas: MeasTerms | None = None):
    """Build the dense Schur-ready normal equations.

    ``free_from``: first free pose index (int32 scalar). Poses with
    index < free_from (and the gauge pose 0, and padded poses) are
    frozen: their Jacobian columns are dropped. Landmarks are always
    free (matching ISAM2, which keeps landmarks active).

    ``meas``: pre-summed measurement terms (a distributed path may
    supply the psum of per-shard `_meas_terms`); computed locally
    when None.

    Returns (h_pp, w, h_ll, g_p, g_l, cost):
      h_pp (T*6, T*6), w (T*6, L*3), h_ll (L, 3, 3), g_p (T*6,),
      g_l (L*3,), cost ().
    """
    tcap, lcap = cfg.max_poses, cfg.max_landmarks
    pose_free = pose_free_mask(cfg, state, free_from)
    if meas is None:
        meas = _meas_terms(cfg, state, pose_free)
    h_pp, g_p, cost = _pose_system(cfg, state, pose_free, meas)
    h_ll, g_l4, prior_cost = _landmark_system(
        cfg, state.lm, state.lm_active, state.prior_lm_h,
        state.prior_lm_mean, meas.h_ll, meas.g_l)
    w = meas.w4.reshape(tcap * 6, lcap * cfg.lm_dim)
    return h_pp, w, h_ll, g_p, g_l4.reshape(lcap * cfg.lm_dim), \
        cost + prior_cost


def _schur_reduce(h_ll, w3, g_l3, damping):
    """Per-landmark(-shard) half of the Schur complement.

    h_ll (l, 3, 3), w3 (T6, l, 3), g_l3 (l, 3) — `l` may be the full
    landmark capacity or one device's shard; every output is a plain
    SUM over landmarks, so shard partials combine with one psum.
    Returns (h_ll_inv, w_hinv, s_meas (T6, T6), g_s_meas (T6,)).
    """
    dt = w3.dtype
    eye = jnp.eye(h_ll.shape[-1], dtype=dt)
    h_ll_inv = jnp.linalg.inv(h_ll + damping * eye[None])
    w_hinv = jnp.einsum("nlk,lkm->nlm", w3, h_ll_inv)    # (T6, l, 3)
    s_meas = jnp.einsum("nlm,plm->np", w_hinv, w3)
    g_s_meas = jnp.einsum("nlm,lm->n", w_hinv, g_l3)
    return h_ll_inv, w_hinv, s_meas, g_s_meas


def _schur_pose_solve(h_pp, g_p, s_meas, g_s_meas, damping):
    """Solve the reduced camera system S dp = g_s (replicated)."""
    dt = h_pp.dtype
    s = h_pp - s_meas
    s = s + damping * jnp.eye(s.shape[0], dtype=dt)
    fact = cho_factor(s, lower=True)
    return cho_solve(fact, g_p - g_s_meas)


def _schur_back_substitute(h_ll_inv, w3, g_l3, dp):
    """Per-landmark(-shard) back-substitution dl = H_ll⁻¹(g_l − Wᵀdp)."""
    rhs_l = g_l3 - jnp.einsum("nlm,n->lm", w3, dp)
    return jnp.einsum("lkm,lm->lk", h_ll_inv, rhs_l)


def _schur_solve(cfg: GraphConfig, h_pp, w, h_ll, g_p, g_l, damping):
    """Schur-eliminate landmarks, solve the reduced camera system."""
    lcap = cfg.max_landmarks
    w3 = w.reshape(-1, lcap, cfg.lm_dim)                 # (T6, L, D)
    g_l3 = g_l.reshape(lcap, cfg.lm_dim)
    h_ll_inv, _, s_meas, g_s_meas = _schur_reduce(h_ll, w3, g_l3,
                                                  damping)
    dp = _schur_pose_solve(h_pp, g_p, s_meas, g_s_meas, damping)
    dl = _schur_back_substitute(h_ll_inv, w3, g_l3, dp)
    return dp.reshape(-1, 6), dl


def _retract(state: GraphState, dp, dl, free_from):
    """dl: (L, 3) point or (L, 6) [δl, δθ] pose-landmark updates."""
    tcap = state.pose_q.shape[0]
    pose_free = (jnp.arange(tcap) >= jnp.maximum(free_from, 1)) \
        & (jnp.arange(tcap) < state.num_poses)
    dp = jnp.where(pose_free[:, None], dp, 0.0)
    pose_q = quat.normalize(
        quat.multiply(state.pose_q, quat.from_rotvec(dp[:, :3])))
    pose_t = state.pose_t + dp[:, 3:]
    dl = jnp.where(state.lm_active[:, None], dl, 0.0)
    lm_q = state.lm_q
    if dl.shape[-1] == 6:
        lm_q = quat.normalize(quat.multiply(
            lm_q, quat.from_rotvec(dl[:, 3:])))
    return state._replace(pose_q=pose_q, pose_t=pose_t,
                          lm=state.lm + dl[:, :3], lm_q=lm_q)


def _cost_parts(cfg: GraphConfig, state: GraphState
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Whitened squared error split into (shardable, replicated) parts.

    The first term sums over factors and landmarks — computed on a
    factor/landmark shard it is a partial sum that combines with one
    psum. The second (odometry) term depends only on the replicated
    pose arrays, so a sharded caller adds it WITHOUT reduction.
    """
    dt = cfg.dtype
    fq = state.pose_q[state.f_pose]
    ft = state.pose_t[state.f_pose]
    fl = state.lm[state.f_lm]
    z6 = jnp.zeros(6, dt)
    zl = jnp.zeros(cfg.lm_dim, dt)
    if cfg.with_rotations:
        r_m = jax.vmap(
            lambda q, t, l, lq, tcl, qcl, sig: _meas_residual_rot(
                z6, zl, q, t, l, lq, tcl, qcl, sig,
                cfg.meas_sigma_rot)
        )(fq, ft, fl, state.lm_q[state.f_lm], state.f_tcl,
          state.f_qcl, state.f_sig)
    else:
        r_m = jax.vmap(
            lambda q, t, l, tcl, sig: _meas_residual(
                z6, zl, q, t, l, tcl, sig)
        )(fq, ft, fl, state.f_tcl, state.f_sig)
    if cfg.huber_delta > 0.0:
        rn = jnp.linalg.norm(r_m, axis=-1)
        r_m = r_m * jnp.sqrt(jnp.minimum(
            1.0, cfg.huber_delta / jnp.maximum(rn, 1e-12)))[:, None]
    r_m = jnp.where(state.f_valid[:, None], r_m, 0.0)
    tcap = cfg.max_poses
    idx_a = jnp.arange(1, tcap)
    idx_b = jnp.arange(0, tcap - 1)
    r_o = jax.vmap(
        lambda qa, ta, qb, tb: _odom_residual(
            z6, z6, qa, ta, qb, tb, cfg.odom_sigma_rot, cfg.odom_sigma_t)
    )(state.pose_q[idx_a], state.pose_t[idx_a],
      state.pose_q[idx_b], state.pose_t[idx_b])
    r_o = jnp.where((idx_a < state.num_poses)[:, None], r_o, 0.0)
    pr = state.lm - state.prior_lm_mean
    prior_cost = jnp.sum(pr * jnp.einsum("lij,lj->li",
                                         state.prior_lm_h, pr))
    return jnp.sum(r_m * r_m) + prior_cost, jnp.sum(r_o * r_o)


def _cost_only(cfg: GraphConfig, state: GraphState) -> jnp.ndarray:
    """Total whitened squared error at the current estimate."""
    shardable, odom = _cost_parts(cfg, state)
    return shardable + odom


@functools.partial(jax.jit, static_argnums=(0, 2))
def _optimize(cfg: GraphConfig, state: GraphState, iters: int,
              free_from) -> tuple[GraphState, jnp.ndarray]:
    """Levenberg-Marquardt: `iters` trial steps with adaptive damping.

    Each iteration linearizes, Schur-solves, and accepts the step only
    if the true cost decreases (classic LM accept/reject, the behavior
    of the reference's gtsam LevenbergMarquardtOptimizer,
    reference factor_graph.py:327-345).

    Traced at full f32 matmul precision: at default precision an
    accelerator may run f32 matmuls with reduced-precision inputs
    (TF32 tensor cores on a GPU), and the normal equations / Schur
    complement are exactly the kind of small accuracy-critical linalg
    that turns a quadratically-converging GN step into a stalled one
    (same failure as in the MEKF, filters/mekf.py mekf_step).
    """
    with jax.default_matmul_precision("highest"):
        return _optimize_impl(cfg, state, iters, free_from)


def _optimize_impl(cfg, state, iters, free_from):

    def step(carry, _):
        st, lam, cost = carry
        h_pp, w, h_ll, g_p, g_l, _ = _linearize(cfg, st, free_from)
        dp, dl = _schur_solve(cfg, h_pp, w, h_ll, g_p, g_l, lam)
        trial = _retract(st, dp, dl, free_from)
        new_cost = _cost_only(cfg, trial)
        accept = new_cost < cost
        st = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), trial, st)
        lam = jnp.where(accept, lam / cfg.lm_factor, lam * cfg.lm_factor)
        lam = jnp.clip(lam, 1e-9, 1e6)
        cost = jnp.where(accept, new_cost, cost)
        return (st, lam, cost), cost

    cost0 = _cost_only(cfg, state)
    lam0 = jnp.asarray(cfg.lm_init_lambda, cfg.dtype)
    (state, _, cost), _ = jax.lax.scan(
        step, (state, lam0, cost0), None, length=iters)
    return state, cost


def optimize_window(cfg: GraphConfig, state: GraphState,
                    window: int = 8, iters: int = 3
                    ) -> tuple[GraphState, jnp.ndarray]:
    """Incremental smoothing: re-linearized GN/LM over the trailing
    `window` poses (earlier poses frozen) + all landmarks — the
    ISAM2-equivalent online mode (reference factor_graph.py:153-155)."""
    free_from = jnp.maximum(state.num_poses - window, 1)
    return _optimize(cfg, state, iters, free_from)


def batch_optimize(cfg: GraphConfig, state: GraphState,
                   iters: int = 50) -> tuple[GraphState, jnp.ndarray]:
    """Full-batch LM over every pose (the reference's offline
    batch_optimize, reference factor_graph.py:327-345)."""
    return _optimize(cfg, state, iters, jnp.asarray(1, jnp.int32))


@functools.partial(jax.jit, static_argnums=0)
def landmark_covariances(cfg: GraphConfig, state: GraphState) -> jnp.ndarray:
    """Marginal covariance blocks (L, 3, 3) of the landmarks — the role
    of ISAM2's marginalCovariance (reference factor_graph.py:208-218).

    Cov_ll = H_ll⁻¹ + H_ll⁻¹ Wᵀ S⁻¹ W H_ll⁻¹ (block diagonal part).
    """
    with jax.default_matmul_precision("highest"):
        return _landmark_covariances_impl(cfg, state)


def _landmark_covariances_impl(cfg, state):
    free_from = jnp.asarray(1, jnp.int32)
    h_pp, w, h_ll, _, _, _ = _linearize(cfg, state, free_from)
    dt = cfg.dtype
    lcap = cfg.max_landmarks
    eps = 1e-6
    h_ll_inv = jnp.linalg.inv(
        h_ll + eps * jnp.eye(cfg.lm_dim, dtype=dt)[None])
    w3 = w.reshape(-1, lcap, cfg.lm_dim)
    m = jnp.einsum("nlk,lkm->nlm", w3, h_ll_inv)       # W H_ll⁻¹
    s = h_pp - jnp.einsum("nlm,plm->np", m, w3)
    s = s + eps * jnp.eye(s.shape[0], dtype=dt)
    fact = cho_factor(s, lower=True)
    y = cho_solve(fact, m.reshape(m.shape[0], -1)).reshape(m.shape)
    corr = jnp.einsum("nlk,nlm->lkm", m, y)
    return h_ll_inv + corr
