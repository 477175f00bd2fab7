"""Fused multiplicative-error-state Kalman filter (MEKF) for marker SLAM.

Accelerator re-design of the reference's two EKF backends
(reference filters/extended_kalman_filter.py — point landmarks,
reference filters/ekf_with_rotations.py — full-pose landmarks):

* The state has **fixed capacity**: `capacity` landmark slots with an
  ``active`` mask. Marker id == slot index (ArUco DICT_5X5_50 ids are
  0..49), so "adding a marker" (reference
  extended_kalman_filter.py:239-290, an O(n²) numpy reallocation) is a
  masked write — no dynamic shapes, everything jits once.
* Per-frame predict + activate + update is ONE jitted function of
  dense, statically-shaped arrays; whole sequences run under
  ``lax.scan`` (`mekf_scan`) so XLA pipelines the per-frame dense
  algebra back-to-back on device.
* The innovation solve is a dense Cholesky (`cho_factor/cho_solve`)
  instead of scipy SuperLU spsolve (reference
  extended_kalman_filter.py:129): at these block sizes dense,
  matmul-shaped linear algebra beats any sparse path on an
  accelerator.
* Measurement Jacobians come from `jax.jacfwd` of the measurement
  function at trace time — the role the reference fills with SymPy
  codegen + a dill cache (reference ekf_with_rotations.py:337-427) —
  and fuse into the surrounding XLA computation.

Error-state covariance layout (a deliberate redesign of the
reference's): the reference keeps a covariance over
[xyz, qw qx qy qz, ex ey ez] per pose block (reference
filters/base_filter.py:25-31), which represents orientation
uncertainty twice (quaternion components AND the multiplicative error
vector). We keep quaternions in the *state* but track covariance only
over the minimal error state:

    camera block:  6 dims  [δt (3), δθ (3)]
                   9 dims  [δt, δθ, δv]  (motion_model="cv")
    landmark j:    3 dims  [δt]          (point mode)
                   6 dims  [δt, δθ]      (rotation mode)

Frame convention: the state quaternion ``q`` is the camera-to-world
rotation, so h(x) = R(q)ᵀ (x_l − t) is the landmark in the camera
frame, and landmark initialization is x_l = R(q) t_cl + t.  (The
reference uses the same h — extended_kalman_filter.py:317-325 — but
its add_marker at :264-272 applies the INVERSE rotation; its own TODO
at :260-262 flags this. We fix it rather than replicate it.)

Landmark initialization is the *consistent* EKF-SLAM augmentation
P ← G P Gᵀ + B R Bᵀ (cross-covariance between the new landmark and the
camera), not the reference's zeroed cross terms + fixed diagonal
(reference extended_kalman_filter.py:276-290) — the latter is
overconfident and destabilizes the filter when landmarks appear
mid-sequence under tight measurement noise. Set
``consistent_init=False`` for the reference's behavior.

Known reference bugs intentionally not replicated:
* extended_kalman_filter.py:143-149 parses the scalar-first state
  quaternion as scalar-last during the multiplicative update.
* quaternion measurement residuals ignore the double cover; we sign-
  align the observed quaternion to the prediction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from aruco_slam_tpu.core import quaternion as quat

CAM_EDIMS = 6  # camera error dims without a motion model: [δt, δθ]
CAM_EDIMS_CV = 9  # with the constant-velocity model: [δt, δθ, δv]
_DT = slice(0, 3)
_DTH = slice(3, 6)
_DV = slice(6, 9)


class MekfConfig(NamedTuple):
    """Filter tuning. Noise defaults equal the reference's module
    constants (reference extended_kalman_filter.py:21-27,
    ekf_with_rotations.py:23-31)."""

    capacity: int = 64
    with_rotations: bool = False
    initial_camera_uncertainty: float = 0.1
    initial_landmark_uncertainty: float = 0.7
    r_uncertainty: float = 0.9
    q_uncertainty_cam: float = 0.3
    q_error_uncertainty_cam: float = 0.5
    q_uncertainty_lm: float = 0.01
    joseph_form: bool = True
    consistent_init: bool = True
    dtype: jnp.dtype = jnp.float32
    # covariance STORAGE dtype (None = `dtype`). "bf16" halves the
    # covariance memory traffic — at survey scale (err_dim 1545, 9.5 MB
    # f32) the batched step is bandwidth-bound on ~a dozen
    # cov-sized passes per frame, so storage width is the throughput
    # knob. All small/critical algebra (the gain chain ph_t -> S ->
    # S⁻¹ -> K, residuals, state vectors) stays f32: bf16 inputs
    # promote to f32 at those ops, so only the bulky N² reads/writes
    # narrow. Joseph form + per-step symmetrization absorb the extra
    # rounding like a little process noise; validate ATE on your map
    # scale before serving with it (bench/large_map.py reports it).
    cov_dtype: jnp.dtype | None = None
    ns_iters: int = 20  # Newton–Schulz iterations for S⁻¹
    # innovation solve: "cho" = dense Cholesky (exact, serial); "ns" =
    # Newton–Schulz inverse (pure matmuls, batches perfectly under
    # vmap — the batched-serving choice)
    s_solver: str = "cho"
    # constant-velocity motion model: predict the camera forward by an
    # exponential moving average of its recent per-frame displacement.
    # The reference README (:55-56) claims a moving-average motion
    # model but never implements it (MOVING_AVG_WINDOW is unused,
    # reference extended_kalman_filter.py:19); this is the working
    # version. 0.0 disables (reference behavior: predict is noise-only).
    # Superseded by motion_model="cv" below, which estimates the
    # velocity *in the filter* with proper covariance bookkeeping
    # instead of an out-of-band EMA.
    vel_smoothing: float = 0.0
    # "none": static predict (reference behavior, or the EMA shift if
    #   vel_smoothing > 0).
    # "cv": constant-velocity camera — the error state grows to
    #   [δt, δθ, δv] (9 dims), predict applies t += v with the exact
    #   F P Fᵀ propagation, and the velocity is corrected by the same
    #   Kalman update as everything else. Robust where the EMA hack
    #   oscillates: the filter learns per-frame how much to trust v.
    motion_model: str = "none"
    q_vel: float = 2e-3          # velocity random-walk variance ("cv")
    q_pos_cv: float = 1e-4       # residual position noise under "cv"
    initial_vel_uncertainty: float = 0.01
    # per-frame velocity decay under "cv" (1.0 = pure constant
    # velocity). <1 bounds the dead-reckoning excursion when no
    # observations are accepted for a stretch — see the predict step.
    vel_decay: float = 1.0
    # matmul precision for the update chain (see mekf_step). On an
    # H100 (measured: max relative error of a 1024³ f32 product):
    # "highest" = true f32 (1.5e-6; the default); "high" and
    # "default" = TF32 tensor-core inputs (3.3e-4 — both names give
    # the same); "mixed" = TF32 covariance products with the gain
    # chain (ph_t/S/S⁻¹/K) pinned to f32. "default"/"high" put the
    # gain chain in TF32 too, which is not safe: S can go indefinite
    # and the Cholesky NaNs on big maps. On the CPU every name is f32.
    matmul_precision: str = "highest"
    # failure detection (SURVEY.md §5 — the reference has none): if an
    # update produces non-finite state, drop it and carry the predicted
    # state forward instead of poisoning the filter permanently.
    divergence_guard: bool = True
    # measurement compaction: gather the <=max_obs observed slots into
    # a compact measurement block so the innovation system is
    # (max_obs*md)² instead of (capacity*md)² — with 64 slots and ~8
    # visible markers that is a 16x smaller S. Frames observing more
    # than max_obs slots drop the highest-id extras (gated + rare; set
    # max_obs >= capacity to disable).
    max_obs: int = 16
    # depth-aware measurement covariance: if pixel_sigma > 0, replace
    # the constant r_uncertainty with a per-observation R derived from
    # planar-PnP error propagation — depth error of a square marker of
    # side `marker_size` seen at depth z with focal `focal_px` scales
    # as sigma_z = pixel_sigma * z^2 / (focal_px * marker_size), and
    # lateral error is ~sigma_z/3 (both verified against Monte-Carlo
    # PnP on synthetic corners; the z^2/(f s) law is the classical
    # stereo-disparity depth-error result with the marker side acting
    # as the baseline). The reference has only a constant R
    # (reference extended_kalman_filter.py:26 R_UNCERTAINTY); a
    # constant cannot be right at both 1 m and 5 m range.
    pixel_sigma: float = 0.0
    focal_px: float = 1414.9     # reference calibration fx
    marker_size: float = 0.16    # reference marker side (m)
    # fused innovation gate: observations of an already-active landmark
    # whose camera-frame position residual exceeds this (meters) are
    # dropped from the update (0 = off). In-step equivalent of the
    # standalone `innovation_gate` helper, so the gated `lax.scan` path
    # needs no per-frame Python. New landmarks always pass (their
    # residual is ~0 by construction).
    gate_distance: float = 0.0

    @property
    def lm_dims(self) -> int:
        """Landmark state dims: [xyz] or [xyz, quat]."""
        return 7 if self.with_rotations else 3

    @property
    def lm_edims(self) -> int:
        """Landmark error dims: [δt] or [δt, δθ]."""
        return 6 if self.with_rotations else 3

    @property
    def meas_dims(self) -> int:
        return 7 if self.with_rotations else 3

    @property
    def cam_edims(self) -> int:
        """Camera error dims: [δt, δθ] (+ [δv] with the cv model)."""
        return CAM_EDIMS_CV if self.motion_model == "cv" else CAM_EDIMS

    @property
    def err_dim(self) -> int:
        return self.cam_edims + self.capacity * self.lm_edims


class MekfState(NamedTuple):
    """Filter state pytree (all statically shaped)."""

    cam_t: jnp.ndarray  # (3,)
    cam_q: jnp.ndarray  # (4,) wxyz, camera-to-world
    lm: jnp.ndarray     # (C, 3) or (C, 7): [xyz] / [xyz, quat wxyz]
    cov: jnp.ndarray    # (N, N) error-state covariance, N = err_dim
    active: jnp.ndarray  # (C,) bool
    vel: jnp.ndarray    # (3,) EMA per-frame camera displacement
                        # (deterministic aux state; only used when
                        # vel_smoothing > 0)
    dropped_obs: jnp.ndarray  # () int32 — cumulative observations
                        # dropped by the max_obs measurement
                        # compaction (frames observing more than
                        # max_obs slots). Nonzero after a run means
                        # max_obs was undersized: raise it (run_slam
                        # auto-sizes and warns; library consumers
                        # check this counter)


class FrameObservations(NamedTuple):
    """One frame's marker observations, indexed by landmark slot.

    ``t_cl``: marker position in the camera frame (C, 3) — the PnP tvec.
    ``q_cl``: marker orientation in the camera frame (C, 4) wxyz.
    ``mask``: (C,) bool — slot observed this frame.
    """

    t_cl: jnp.ndarray
    q_cl: jnp.ndarray
    mask: jnp.ndarray
    # optional (C,) planar-PnP ambiguity ratio err_best/err_other in
    # [0, 1]: near 1 means the IPPE two-fold tilt ambiguity was a coin
    # toss and the measured ROTATION is unreliable (the position is
    # stable across both basins). Used to de-weight rotation rows in
    # rotation mode; None = assume unambiguous.
    ambiguity: jnp.ndarray | None = None
    # optional (C,) bool: slots RECYCLED by the detector's LRU table
    # this frame (ops/detect.assign_slots_lru) — the slot now carries a
    # DIFFERENT marker, so the landmark is deactivated before the
    # update and re-initializes from this frame's observation through
    # the normal consistent augmentation. None = no recycling.
    reset: jnp.ndarray | None = None


def init_state(cfg: MekfConfig, cam_t=None, cam_q=None) -> MekfState:
    """Initial state: camera at given pose, no active landmarks."""
    dt = cfg.dtype
    cam_t = jnp.zeros(3, dt) if cam_t is None else jnp.asarray(cam_t, dt)
    cam_q = quat.identity(dt) if cam_q is None else jnp.asarray(cam_q, dt)
    lm = jnp.zeros((cfg.capacity, cfg.lm_dims), dt)
    if cfg.with_rotations:
        lm = lm.at[:, 3].set(1.0)  # identity quaternions
    n = cfg.err_dim
    diag = jnp.full((n,), cfg.initial_landmark_uncertainty, dt)
    diag = diag.at[:CAM_EDIMS].set(cfg.initial_camera_uncertainty)
    if cfg.motion_model == "cv":
        diag = diag.at[_DV].set(cfg.initial_vel_uncertainty)
    return MekfState(
        cam_t=cam_t,
        cam_q=cam_q,
        lm=lm,
        cov=jnp.diag(diag).astype(cfg.cov_dtype or dt),
        active=jnp.zeros(cfg.capacity, dtype=bool),
        vel=jnp.zeros(3, dt),
        dropped_obs=jnp.zeros((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Measurement models as functions of the error state, linearized at 0.
# ---------------------------------------------------------------------------

def _perturb(q: jnp.ndarray, dth: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative rotation-vector perturbation dq(δθ) ⊗ q."""
    dq = jnp.concatenate([jnp.ones_like(dth[..., :1]), 0.5 * dth], axis=-1)
    return quat.multiply(dq, q)


def _h_point(eps_c, eps_l, cam_t, cam_q, lm_t):
    """Landmark position in the camera frame, as a function of the
    camera error (6,) and landmark error (3,)."""
    t = cam_t + eps_c[_DT]
    q_wc = _perturb(cam_q, eps_c[_DTH])
    return quat.rotate(quat.conjugate(q_wc), lm_t + eps_l - t)


def _h_pose(eps_c, eps_l, cam_t, cam_q, lm_t, lm_q):
    """Landmark pose [xyz, quat] in the camera frame, as a function of
    the camera error (6,) and landmark error (6,).

    Same model as the reference's symbolic h (reference
    ekf_with_rotations.py:382-390): q_cl = q_wc⁻¹ ⊗ q_wl with
    multiplicative perturbations on both rotations.
    """
    t = cam_t + eps_c[_DT]
    q_wc = _perturb(cam_q, eps_c[_DTH])
    q_wl = _perturb(lm_q, eps_l[_DTH])
    xyz_cl = quat.rotate(quat.conjugate(q_wc), lm_t + eps_l[_DT] - t)
    q_cl = quat.multiply(quat.conjugate(q_wc), q_wl)
    return jnp.concatenate([xyz_cl, q_cl])


def _meas_variances(cfg: MekfConfig, t_cl, ambiguity=None):
    """Per-observation measurement variances.

    Returns (r_rows (C, md), r_init (C, zdim)): the measurement-row
    variances for the Kalman update and the init-noise variances for
    the consistent augmentation (zdim = 3 position components, plus a
    3-dim rotation VECTOR in rotation mode — quaternion-component
    noise dq ≈ δθ/2 means var_rotvec = 4·var_quat).

    With pixel_sigma <= 0 this is the reference's constant R
    (reference extended_kalman_filter.py:26); otherwise depth-scaled
    planar-PnP error propagation (see MekfConfig.pixel_sigma).
    """
    c, md, dt = cfg.capacity, cfg.meas_dims, cfg.dtype
    if cfg.pixel_sigma <= 0.0:
        zdim = 6 if cfg.with_rotations else 3
        return (jnp.full((c, md), cfg.r_uncertainty, dt),
                jnp.full((c, zdim), cfg.r_uncertainty, dt))
    depth = jnp.clip(t_cl[:, 2], 0.2, None)
    sig_z = cfg.pixel_sigma * depth * depth \
        / (cfg.focal_px * cfg.marker_size)
    var_z = jnp.maximum(sig_z * sig_z, 1e-8)
    var_xy = var_z / 9.0
    r_pos = jnp.stack([var_xy, var_xy, var_z], axis=-1)
    if not cfg.with_rotations:
        return r_pos.astype(dt), r_pos.astype(dt)
    # attitude error of planar PnP: ~3x the naive px*z/(f*s) law
    # (Monte-Carlo calibrated), and effectively unbounded when the
    # IPPE ambiguity ratio approaches 1 — tilt flips are not Gaussian,
    # so ambiguous rotations are de-weighted out of the update
    sig_th = 3.0 * cfg.pixel_sigma * depth / (cfg.focal_px * cfg.marker_size)
    var_q = jnp.maximum(sig_th * sig_th, 1e-8)
    if ambiguity is not None:
        var_q = var_q * jnp.where(ambiguity > 0.6, 1e6, 1.0)
    r_rows = jnp.concatenate(
        [r_pos, jnp.tile(var_q[:, None], (1, 4))], axis=-1)
    r_init = jnp.concatenate(
        [r_pos, jnp.tile(4.0 * var_q[:, None], (1, 3))], axis=-1)
    return r_rows.astype(dt), r_init.astype(dt)


def _augment_consistent(cfg: MekfConfig, state: MekfState, new, new_dims,
                        t_cl, q_cl, r_init) -> jnp.ndarray:
    """Consistent covariance augmentation for newly activated landmarks.

    The new landmark error is a function of the camera error and the
    measurement noise, so  P ← G P Gᵀ + B R Bᵀ,  with G = I except
    new-block rows = ∂g/∂(camera error) in the camera columns and
    B = ∂g/∂(measurement).

    BLOCKED product: G = M + E with M = diag(keep) (identity minus
    the new rows/cols) and E the rank-ce scatter of the new-block
    camera Jacobian rows, so

        G P Gᵀ = M P M + (E P)M + ((E P)M)ᵀ + E P Eᵀ,

    where every E-product contracts over only the ce camera columns
    (E P = g_full @ P[:ce, :]). The dense form is two N³ GEMMs —
    14.7 GFLOP/frame at the 512-survey's N=1545, and under vmap the
    `lax.cond` below becomes a SELECT that executes the branch every
    frame, which made this one product ~90% of the whole batched
    survey pipeline. The blocked form is ~2·3·N²·ce ≈ 0.13 GFLOP.

    Wrapped in `lax.cond` on "any new landmark this frame": after the
    map is built almost every frame adds nothing, so the unbatched
    filter skips even the blocked cost.
    """
    c, le, n, dt = cfg.capacity, cfg.lm_edims, cfg.err_dim, cfg.dtype
    ce = cfg.cam_edims

    def augment():
        if cfg.with_rotations:
            def g_init(eps_c, z, tcl_j, qcl_j):
                t = state.cam_t + eps_c[_DT]
                q_wc = _perturb(state.cam_q, eps_c[_DTH])
                xyz = quat.rotate(q_wc, tcl_j + z[:3]) + t
                # orientation error enters via a rotation-vector
                # perturbation of the measured relative rotation
                q_wl = quat.multiply(
                    q_wc, _perturb(qcl_j, z[3:6]))
                # local error of the initialized landmark: position and
                # rotation-vector offset from the nominal init
                xyz0 = quat.rotate(state.cam_q, tcl_j) + state.cam_t
                q0 = quat.multiply(state.cam_q, qcl_j)
                dq = quat.multiply(q_wl, quat.conjugate(q0))
                return jnp.concatenate(
                    [xyz - xyz0, quat.to_rotvec(dq)])

            zdim = 6
            jac = jax.vmap(
                jax.jacfwd(g_init, argnums=(0, 1)),
                in_axes=(None, None, 0, 0),
            )(jnp.zeros(ce, dt), jnp.zeros(zdim, dt), t_cl, q_cl)
        else:
            def g_init(eps_c, z, tcl_j):
                t = state.cam_t + eps_c[_DT]
                q_wc = _perturb(state.cam_q, eps_c[_DTH])
                xyz = quat.rotate(q_wc, tcl_j + z) + t
                xyz0 = quat.rotate(state.cam_q, tcl_j) + state.cam_t
                return xyz - xyz0

            zdim = 3
            jac = jax.vmap(
                jax.jacfwd(g_init, argnums=(0, 1)),
                in_axes=(None, None, 0),
            )(jnp.zeros(ce, dt), jnp.zeros(zdim, dt), t_cl)
        j_cam_init, j_z_init = jac  # (C, le, 6), (C, le, zdim)

        g_cam = jnp.where(new[:, None, None], j_cam_init, 0.0)
        g_full = jnp.zeros((n, ce), dt).at[ce:, :].set(
            g_cam.reshape(c * le, ce))              # E's cam columns
        keep = (~new_dims).astype(dt)               # (N,)
        p = state.cov
        cdt = p.dtype  # covariance storage dtype (cfg.cov_dtype)
        if n < 768:
            # small-state: ONE dense G P Gᵀ instead of the blocked
            # form's many small ops
            g_mat = jnp.eye(n, dtype=dt) * keep[:, None]
            g_mat = g_mat.at[ce:, :ce].set(g_cam.reshape(c * le, ce))
            cov = (g_mat @ p.astype(dt) @ g_mat.T).astype(cdt)
        else:
            # large-state: the dense form is two N³ GEMMs (14.7
            # GFLOP/frame at the 512-survey's N=1545) that the
            # vmap'd lax.cond below executes EVERY frame; rank-ce
            # blocked products are ~100x fewer FLOPs and leave the
            # step bandwidth-bound (measured 417 -> 559 fps batch 8)
            mpm = p * (keep[:, None] * keep[None, :]).astype(cdt)
            # rank-ce GEMMs store at the covariance dtype
            epm = ((g_full @ p[:ce, :].astype(dt))
                   * keep[None, :]).astype(cdt)     # (E P) M
            # M P Eᵀ as its own rank-ce GEMM instead of epm.T: P is
            # symmetric, so the two accumulate the SAME products in
            # the same order (bit-equal transpose) — and an N²
            # transpose READ is a relayout pass this function exists
            # to avoid
            epmt = ((keep[:, None] * p[:, :ce].astype(dt))
                    @ g_full.T).astype(cdt)
            epe = (g_full @ (p[:ce, :ce].astype(dt)
                             @ g_full.T)).astype(cdt)  # E P Eᵀ
            cov = mpm + epm + epmt + epe
        b = jnp.where(new[:, None, None], j_z_init, 0.0)
        brb = jnp.einsum("jlz,jmz,jz->jlm", b, b, r_init)
        # block-diagonal B R Bᵀ via the identity einsum: it looks like
        # a dense (C·le)² materialization but XLA fuses the broadcast-
        # multiply straight into the .add consumer — one elementwise
        # pass. (A strided .at[jj,:,jj,:] diagonal-block add lowers to
        # a real scatter and measured 15% SLOWER on the 512-survey.)
        eye_c = jnp.eye(c, dtype=dt)
        brb_full = jnp.einsum("jc,jlm->jlcm", eye_c, brb).reshape(
            c * le, c * le)
        return cov.at[ce:, ce:].add(brb_full.astype(cdt))

    return jax.lax.cond(new.any(), augment, lambda: state.cov)


# ---------------------------------------------------------------------------
# The fused per-frame step.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=0)
def mekf_step(cfg: MekfConfig, state: MekfState,
              obs: FrameObservations) -> MekfState:
    """One frame: activate new landmarks → predict → update.

    Mirrors the reference's observe() ordering (reference
    extended_kalman_filter.py:58-82): markers first (so new markers
    join this frame's update), then covariance inflation, then the
    Kalman update over all observed markers.
    """
    # An accelerator's default matmul precision rounds f32 inputs
    # (TF32 on a GPU: ~1e-3 relative); the assembled innovation
    # covariance S = HPHᵀ+R is a difference of large terms whose
    # small eigenvalues do not survive that, and an indefinite S NaNs
    # the Cholesky solver and caps the Newton–Schulz gain accuracy.
    # The whole update chain is small dense linalg where accuracy is
    # the point, so trace it at full f32 precision by default
    # (cfg.matmul_precision relaxes it; "mixed" = default-precision
    # bulk with an f32-pinned gain chain, see the update).
    ctx = ("default" if cfg.matmul_precision == "mixed"
           else cfg.matmul_precision)
    with jax.default_matmul_precision(ctx):
        return _mekf_step_impl(cfg, state, obs)


def _mekf_step_impl(cfg: MekfConfig, state: MekfState,
                    obs: FrameObservations) -> MekfState:
    c, le, md = cfg.capacity, cfg.lm_edims, cfg.meas_dims
    n = cfg.err_dim
    ce = cfg.cam_edims
    dt = cfg.dtype

    mask = obs.mask
    if cfg.divergence_guard:
        # non-finite observations are treated as unobserved: they must
        # not reach landmark initialization or the residual
        mask = mask & jnp.isfinite(obs.t_cl).all(-1) \
            & jnp.isfinite(obs.q_cl).all(-1)
    # Sanitize masked-off slots: mask-by-multiplication does not stop
    # NaN/Inf garbage (e.g. a diverged PnP solution that detection
    # rejected) from propagating, so replace them outright.
    t_cl = jnp.where(mask[:, None], obs.t_cl.astype(dt), 0.0)
    ident_q = jnp.zeros_like(obs.q_cl).at[:, 0].set(1.0)
    q_cl = quat.normalize(
        jnp.where(mask[:, None], obs.q_cl, ident_q).astype(dt))

    # --- motion model predict ---
    prev_t = state.cam_t
    if cfg.motion_model == "cv":
        # constant-velocity predict: v' = ρv, t += v' on the nominal,
        # and the exact F P Fᵀ with F = I + (∂δt'/∂δv) and δv' = ρδv;
        # row/col updates instead of a dense N×N matmul (F differs
        # from I in 6 rows only). ρ < 1 bounds dead reckoning: if the
        # filter stops accepting observations (occlusion, gating), the
        # integrated position converges to |v|/(1-ρ) instead of
        # running away linearly forever.
        cov0 = state.cov
        if cfg.vel_decay < 1.0:
            rho = jnp.asarray(cfg.vel_decay, dt)
            state = state._replace(vel=rho * state.vel)
            rho_c = rho.astype(cov0.dtype)  # bf16-cov storage mode
            cov0 = cov0.at[_DV, :].multiply(rho_c)
            cov0 = cov0.at[:, _DV].multiply(rho_c)
        state = state._replace(cam_t=state.cam_t + state.vel)
        cov0 = cov0.at[_DT, :].add(cov0[_DV, :])
        cov0 = cov0.at[:, _DT].add(cov0[:, _DV])
        state = state._replace(cov=cov0)
    elif cfg.vel_smoothing > 0.0:
        # move the nominal camera forward by the velocity EMA; the
        # orientation/position error covariance inflation below already
        # accounts for model error. Replacing cam_t on the state makes
        # every downstream linearization use the predicted nominal.
        state = state._replace(cam_t=state.cam_t + state.vel)

    # --- slot recycling: a reset slot's landmark belongs to a marker
    # the detector evicted — deactivate so this frame's observation
    # re-initializes it (mean AND covariance, via the augmentation) ---
    if obs.reset is not None:
        state = state._replace(active=state.active & ~obs.reset)

    # --- activation: initialize newly seen landmarks in the map frame ---
    new = mask & ~state.active
    lm_xyz_init = quat.rotate(state.cam_q[None, :], t_cl) + state.cam_t
    lm = state.lm.at[:, :3].set(
        jnp.where(new[:, None], lm_xyz_init, state.lm[:, :3]))
    if cfg.with_rotations:
        q_wl_init = quat.normalize(
            quat.multiply(state.cam_q[None, :], q_cl))
        lm = lm.at[:, 3:7].set(
            jnp.where(new[:, None], q_wl_init, lm[:, 3:7]))
    active = state.active | mask

    lm_new_dims = jnp.repeat(new, le)  # (C*le,)
    new_dims = jnp.concatenate([jnp.zeros(ce, bool), lm_new_dims])
    amb = None
    if obs.ambiguity is not None:
        amb = jnp.where(mask, obs.ambiguity.astype(dt), 0.0)
    r_rows, r_init = _meas_variances(cfg, t_cl, amb)
    if cfg.consistent_init:
        cov = _augment_consistent(cfg, state, new, new_dims, t_cl, q_cl,
                                  r_init)
    else:
        # Reference-style init: zero cross terms, fixed diagonal
        # (reference extended_kalman_filter.py:276-290).
        keep = ~new_dims
        cov = state.cov * (keep[:, None] & keep[None, :])
        cov = cov + jnp.diag(
            jnp.where(new_dims, cfg.initial_landmark_uncertainty,
                      0.0).astype(dt))
    # --- predict: inflate covariance with process noise (the reference
    # has no state motion model; predict only adds Q, reference
    # extended_kalman_filter.py:95-105) ---
    q_diag = jnp.zeros((n,), dt)
    if cfg.motion_model == "cv":
        q_diag = q_diag.at[_DT].set(cfg.q_pos_cv)
        q_diag = q_diag.at[_DTH].set(cfg.q_error_uncertainty_cam)
        q_diag = q_diag.at[_DV].set(cfg.q_vel)
    else:
        q_diag = q_diag.at[_DT].set(cfg.q_uncertainty_cam)
        q_diag = q_diag.at[_DTH].set(cfg.q_error_uncertainty_cam)
    lm_active_dims = jnp.repeat(active, le)
    q_diag = q_diag.at[ce:].set(
        jnp.where(lm_active_dims, cfg.q_uncertainty_lm, 0.0))
    cdt = cfg.cov_dtype or dt  # covariance STORAGE dtype (see config)
    cov = (cov + jnp.diag(q_diag)).astype(cdt)

    # --- update ---
    if cfg.with_rotations:
        def h_j(eps_c, eps_l, lm_j, _tcl):
            return _h_pose(eps_c, eps_l, state.cam_t, state.cam_q,
                           lm_j[:3], lm_j[3:7])
    else:
        def h_j(eps_c, eps_l, lm_j, _tcl):
            return _h_point(eps_c, eps_l, state.cam_t, state.cam_q,
                            lm_j[:3])

    zeros_c = jnp.zeros(ce, dt)
    zeros_l = jnp.zeros(le, dt)

    def h_and_jac(lm_j, tcl_j):
        h = h_j(zeros_c, zeros_l, lm_j, tcl_j)
        j_cam, j_lm = jax.jacfwd(h_j, argnums=(0, 1))(
            zeros_c, zeros_l, lm_j, tcl_j)
        return h, j_cam, j_lm

    h_all, j_cam, j_lm = jax.vmap(h_and_jac)(lm, t_cl)
    # h_all (C, md); j_cam (C, md, 6); j_lm (C, md, le)

    if cfg.with_rotations:
        # double-cover: sign-align observed quaternion to prediction
        flip = jnp.sum(q_cl * h_all[:, 3:7], axis=-1) < 0
        q_obs = jnp.where(flip[:, None], -q_cl, q_cl)
        z = jnp.concatenate([t_cl, q_obs], axis=-1)
    else:
        z = t_cl

    if cfg.gate_distance > 0.0:
        # state.active is the PRE-activation mask: gate only landmarks
        # that existed before this frame
        pos_resid = jnp.linalg.norm(z[:, :3] - h_all[:, :3], axis=-1)
        mask = mask & (~state.active | (pos_resid < cfg.gate_distance))

    w = mask[:, None].astype(dt)  # (C, 1) measurement-row mask
    resid_rows = (z - h_all) * w  # (C, md)


    k_obs = min(cfg.max_obs, c)
    # loud truncation accounting: frames observing more than k_obs
    # slots drop the extras below — count them so consumers see it
    # (state.dropped_obs; run_slam warns when it ends nonzero)
    dropped_obs = state.dropped_obs + jnp.maximum(
        jnp.sum(mask, dtype=jnp.int32) - k_obs, 0) \
        if k_obs < c else state.dropped_obs
    if k_obs < c:
        # measurement compaction: gather the observed slots into a
        # compact block so S is (k_obs*md)² instead of (C*md)². With
        # C=64 slots and ~8 visible markers the innovation system
        # shrinks 16x. top_k is deterministic (ties -> lowest index);
        # frames observing more than k_obs slots drop the highest ids.
        sel_score, sel = jax.lax.top_k(mask.astype(jnp.int32), k_obs)
        sel_valid = (sel_score > 0).astype(dt)          # (K,)
        h_cam = (j_cam[sel] * sel_valid[:, None, None]
                 ).reshape(k_obs * md, ce)
        onehot = (sel[:, None] == jnp.arange(c)[None, :]
                  ).astype(dt) * sel_valid[:, None]     # (K, C)
        h_lm = jnp.einsum("kc,kml->kmcl", onehot, j_lm[sel])
        h_mat = jnp.concatenate(
            [h_cam, h_lm.reshape(k_obs * md, c * le)], axis=1)
        resid = (resid_rows[sel] * sel_valid[:, None]).reshape(-1)
        r_diag = jnp.where(jnp.repeat(sel_valid > 0, md),
                           r_rows[sel].reshape(-1), 1.0).astype(dt)
    else:
        # full block: H (C*md, N); camera columns from j_cam, landmark
        # columns block-diagonal, built with an einsum against the
        # identity — a dense, matmul-shaped scatter.
        h_cam = (j_cam * w[:, :, None]).reshape(c * md, ce)
        eye_c = jnp.eye(c, dtype=dt)
        h_lm = jnp.einsum("jc,jml->jmcl", eye_c, j_lm * w[:, :, None])
        h_mat = jnp.concatenate(
            [h_cam, h_lm.reshape(c * md, c * le)], axis=1)
        resid = resid_rows.reshape(-1)
        r_diag = jnp.where(
            jnp.repeat(mask, md), r_rows.reshape(-1), 1.0).astype(dt)
    cov_pred = cov  # kept for the divergence guard
    # Under "mixed" precision the step traces at default-precision
    # matmuls but the GAIN chain (ph_t -> S -> S⁻¹ -> K) is pinned to
    # true f32: S must stay numerically PSD (see mekf_step), while the
    # bulky rank-M covariance products below tolerate the rounding.
    hp = (jax.lax.Precision.HIGHEST
          if cfg.matmul_precision == "mixed" else None)
    mm = functools.partial(jnp.matmul, precision=hp)
    ph_t = mm(cov, h_mat.T)               # (N, M)
    s = mm(h_mat, ph_t) + jnp.diag(r_diag)  # (M, M)
    if cfg.s_solver == "ns":
        # Newton–Schulz inverse: X_{k+1} = X_k (2I - S X_k). Pure
        # matmuls, so under vmap this becomes batched GEMMs (a
        # Cholesky would serialize). x0 = S/‖S‖₁² makes every
        # eigenvalue of S·x0 lie in (0, 1], so the iteration converges
        # quadratically once it leaves the small-eigenvalue regime.
        # Robustness note: an eigendirection with |λ| ≪ ν has S·x0
        # eigenvalue λ²/ν² ≈ 0, which after a bounded iteration count
        # is still ≈ 0 — near-null directions of an f32-indefinite S
        # are implicitly TRUNCATED (gain ~0) instead of exploding the
        # way an unpivoted Cholesky does. Large maps (many landmarks
        # all correlated through the 6-dof camera make S rank-6-
        # dominated) rely on this.
        m_dim = s.shape[0]
        eye_m = jnp.eye(m_dim, dtype=dt)
        norm1 = jnp.max(jnp.sum(jnp.abs(s), axis=0))
        x0 = s / (norm1 * norm1)
        s_inv = jax.lax.fori_loop(
            0, cfg.ns_iters,
            lambda _, x: mm(x, 2.0 * eye_m - mm(s, x)), x0)
        gain = mm(ph_t, s_inv)            # K = P Hᵀ S⁻¹, (N, M)
    else:
        # Equilibrated + jittered Cholesky: S is HPHᵀ (rank ≤ the
        # camera dof for blocks coupled only through the camera) plus
        # a small R diagonal, so trailing f32 pivots are tiny
        # differences of large numbers and routinely go negative on
        # big maps (NaN factor). Scale to unit diagonal, then add a
        # relative jitter that bounds the pivot roundoff; at 1e-5
        # relative the gain perturbation is ~1e-5 — far below
        # measurement noise.
        d_inv = jax.lax.rsqrt(jnp.maximum(jnp.diag(s), 1e-30))
        s_eq = s * d_inv[:, None] * d_inv[None, :]
        s_eq = s_eq + 1e-5 * jnp.eye(s.shape[0], dtype=dt)
        s_fact = cho_factor(s_eq, lower=True)
        gain = cho_solve(s_fact, (ph_t * d_inv[None, :]).T).T \
            * d_inv[None, :]
    innovation = mm(gain, resid)          # (N,) — gain chain stays
                                          # f32 under "mixed"

    if cfg.divergence_guard:
        # a non-finite innovation (e.g. NaN observations that slipped
        # the detector gates, or covariance blow-up) must not poison
        # the state: fall back to the predicted state for this frame
        innovation = jnp.where(jnp.isfinite(innovation).all(),
                               innovation, 0.0)

    # state corrections: additive positions, multiplicative quaternions
    cam_t = state.cam_t + innovation[_DT]
    cam_q = quat.normalize(_perturb(state.cam_q, innovation[_DTH]))
    lm_inn = innovation[ce:].reshape(c, le)
    lm = lm.at[:, :3].add(lm_inn[:, :3])
    if cfg.with_rotations:
        lm_q = quat.normalize(
            jax.vmap(_perturb)(lm[:, 3:7], lm_inn[:, 3:6]))
        lm = lm.at[:, 3:7].set(lm_q)

    # covariance update — rank-M expansion: (I−KH)P(I−KH)ᵀ + KRKᵀ
    #   = P − K(HP) − (HP)ᵀKᵀ + K S Kᵀ   with S = HPHᵀ + R exact.
    # Valid for ANY gain K (including the Newton–Schulz approximate
    # one). Forming I−KH densely costs two N³ GEMMs per frame (N = 201
    # at capacity 64); this form costs three rank-M products
    # (M = max_obs·md ≈ 48) — ~3.7x fewer FLOPs — and P is symmetrized
    # every step. The big (N, N) GEMM outputs store at the covariance
    # dtype (the cast fuses into the GEMM epilogue; a no-op at the f32
    # default).
    a = (gain @ ph_t.T).astype(cdt)         # K (HP) : (N, N)
    if cfg.joseph_form:
        ksk = ((gain @ s) @ gain.T).astype(cdt)
        cov = cov - a - a.T + ksk
    else:
        # the reference's (I−KH)P (extended_kalman_filter.py:156)
        cov = cov - a
    cov = (0.5 * (cov + cov.T)).astype(cdt)

    if cfg.divergence_guard:
        cov = jnp.where(jnp.isfinite(cov).all(), cov, cov_pred)

    if cfg.motion_model == "cv":
        vel = state.vel + innovation[_DV]
    elif cfg.vel_smoothing > 0.0:
        b = jnp.asarray(cfg.vel_smoothing, dt)
        vel = b * state.vel + (1.0 - b) * (cam_t - prev_t)
    else:
        vel = state.vel

    return MekfState(cam_t=cam_t, cam_q=cam_q, lm=lm, cov=cov,
                     active=active, vel=vel, dropped_obs=dropped_obs)


@functools.partial(jax.jit, static_argnums=0)
def mekf_scan(cfg: MekfConfig, state: MekfState, obs_seq: FrameObservations
              ) -> tuple[MekfState, jnp.ndarray]:
    """Run the filter over a whole sequence with `lax.scan`.

    ``obs_seq`` fields carry a leading time axis (T, ...). Returns the
    final state and the (T, 7) camera trajectory [xyz, quat wxyz] — the
    fused equivalent of the reference's per-frame Python driver loop
    (reference main/run_slam.py:111-141).
    """

    def step(carry, obs):
        nxt = mekf_step(cfg, carry, obs)
        return nxt, jnp.concatenate([nxt.cam_t, nxt.cam_q])

    return jax.lax.scan(step, state, obs_seq)


def preload_map(cfg: MekfConfig, state: MekfState, ids, positions,
                uncertainties=None) -> MekfState:
    """Activate landmarks from a saved map before filtering — the
    working equivalent of the reference's load-map path (reference
    filters/base_filter.py:249-272, which is disabled and crashes on a
    stale ``self.filter`` attribute; we fix the capability instead of
    replicating the bug). ``uncertainties`` seeds the per-landmark
    covariance diagonal; defaults to the config's initial value."""
    ids = jnp.asarray(ids, jnp.int32)
    pos = jnp.asarray(positions, cfg.dtype)
    lm = state.lm.at[ids, :3].set(pos[:, :3])
    active = state.active.at[ids].set(True)
    if uncertainties is None:
        unc = jnp.full((len(ids), 3), cfg.initial_landmark_uncertainty,
                       cfg.dtype)
    else:
        unc = jnp.asarray(uncertainties, cfg.dtype)[:, :3]
    le = cfg.lm_edims
    diag_rows = cfg.cam_edims + ids[:, None] * le + jnp.arange(3)[None, :]
    cov = state.cov.at[diag_rows.reshape(-1),
                       diag_rows.reshape(-1)].set(unc.reshape(-1))
    return state._replace(lm=lm, active=active, cov=cov)


@functools.partial(jax.jit, static_argnums=0)
def rotation_consistency_gate(cfg: MekfConfig, state: MekfState,
                              obs: FrameObservations,
                              threshold_deg: float = 50.0
                              ) -> FrameObservations:
    """Reject observations whose implied map-frame marker rotation
    disagrees with the filter's landmark rotation estimate.

    Capability of the reference's (defined-but-never-called)
    `correct_poses` quaternion gate, reference
    filters/base_filter.py:274-325 with QUAT_THRESHOLD=50 deg at :32 —
    recast as a masked batch op over all slots at once. One behavioral
    fix: the reference silently DROPS observations of unknown markers;
    here not-yet-active slots pass through so new landmarks can still
    be initialized. Requires ``with_rotations`` (landmark rotations
    are state only in that mode, as in the reference's EKF_Rotations
    layout).
    """
    if not cfg.with_rotations:
        raise ValueError("rotation gate needs with_rotations=True")
    # observed map-frame rotation: q_wl_obs = q_wc ⊗ q_cl
    q_obs = quat.multiply(state.cam_q[None, :], obs.q_cl)
    dot = jnp.abs(jnp.sum(quat.normalize(q_obs)
                          * quat.normalize(state.lm[:, 3:7]), axis=-1))
    angle = 2.0 * jnp.arccos(jnp.clip(dot, 0.0, 1.0))  # double cover
    ok = angle < jnp.deg2rad(threshold_deg)
    keep = jnp.where(state.active, ok, True) & obs.mask
    return obs._replace(mask=keep)


@functools.partial(jax.jit, static_argnums=0)
def innovation_gate(cfg: MekfConfig, state: MekfState,
                    obs: FrameObservations,
                    max_distance_m: float = 1.0) -> FrameObservations:
    """Position-innovation gate for either landmark mode: reject
    observations whose camera-frame position prediction disagrees with
    the measurement by more than ``max_distance_m`` (a
    generalization of the reference's rotation-only gate to the
    point-landmark filter, which has no rotation state to gate on)."""
    pred = quat.rotate(quat.conjugate(state.cam_q)[None, :],
                       state.lm[:, :3] - state.cam_t[None, :])
    dist = jnp.linalg.norm(obs.t_cl - pred, axis=-1)
    keep = jnp.where(state.active, dist < max_distance_m, True) & obs.mask
    return obs._replace(mask=keep)


def landmark_uncertainties(cfg: MekfConfig, state: MekfState) -> jnp.ndarray:
    """Per-landmark error covariance diagonals (C, lm_edims) — the
    map-file uncertainty column (reference
    extended_kalman_filter.py:91-93)."""
    diag = jnp.diagonal(state.cov)[cfg.cam_edims:]
    return diag.reshape(cfg.capacity, cfg.lm_edims)


def camera_pose(state: MekfState) -> jnp.ndarray:
    """Camera pose as [xyz, quat wxyz] (7,)."""
    return jnp.concatenate([state.cam_t, state.cam_q])
