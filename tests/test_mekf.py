"""MEKF engine: masking invariants, convergence, ATE on synthetic scenes."""

import numpy as np
import jax.numpy as jnp

from aruco_slam_tpu.bench import ate, synthetic
from aruco_slam_tpu.filters import (
    FrameObservations,
    MekfConfig,
    init_state,
    mekf_scan,
    mekf_step,
)
from aruco_slam_tpu.filters.mekf import landmark_uncertainties


TIGHT = dict(r_uncertainty=1e-4, q_uncertainty_cam=0.05,
             q_error_uncertainty_cam=0.05, q_uncertainty_lm=1e-6)


def make_obs_seq(cfg, noise_t=0.0, noise_r=0.0, frames=150, markers=8,
                 fov_limit=0.75):
    scene = synthetic.make_wall_scene(num_markers=markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    obs = synthetic.observe_poses(
        scene, traj, cfg.capacity, noise_t=noise_t, noise_r=noise_r,
        fov_limit=fov_limit)
    seq = FrameObservations(
        t_cl=jnp.asarray(obs.t_cl, cfg.dtype),
        q_cl=jnp.asarray(obs.q_cl, cfg.dtype),
        mask=jnp.asarray(obs.mask),
    )
    return scene, traj, seq


def test_single_step_activates_and_updates():
    cfg = MekfConfig(capacity=16, dtype=jnp.float64)
    state = init_state(cfg)
    scene, traj, seq = make_obs_seq(cfg, frames=2, markers=4)
    obs0 = FrameObservations(seq.t_cl[0], seq.q_cl[0], seq.mask[0])
    nxt = mekf_step(cfg, state, obs0)
    assert bool(np.asarray(obs0.mask).any())
    np.testing.assert_array_equal(np.asarray(nxt.active),
                                  np.asarray(obs0.mask))
    # newly initialized landmarks should be near their true positions
    # (first camera pose ~ origin identity)
    m = np.asarray(obs0.mask)
    est = np.asarray(nxt.lm[:, :3])[m]
    true = scene.marker_pos[m[: len(scene.marker_pos)]]
    assert np.abs(est - true).max() < 0.5


def test_inactive_slots_untouched():
    cfg = MekfConfig(capacity=16, dtype=jnp.float64)
    state = init_state(cfg)
    _, _, seq = make_obs_seq(cfg, frames=30, markers=4)
    final, _ = mekf_scan(cfg, state, seq)
    never_seen = ~np.asarray(seq.mask).any(axis=0)
    assert never_seen.any()
    # state of never-seen slots unchanged
    np.testing.assert_array_equal(
        np.asarray(final.lm)[never_seen], np.asarray(state.lm)[never_seen])
    # covariance of never-seen slots: initial diagonal, zero cross terms
    unc = np.asarray(landmark_uncertainties(cfg, final))
    np.testing.assert_allclose(
        unc[never_seen], cfg.initial_landmark_uncertainty, atol=1e-9)


def test_noiseless_convergence_point():
    cfg = MekfConfig(capacity=16, dtype=jnp.float64, **TIGHT)
    state = init_state(cfg)
    scene, traj, seq = make_obs_seq(cfg, frames=200, markers=8)
    final, cam_traj = mekf_scan(cfg, state, seq)
    est_t = np.asarray(cam_traj[:, :3])
    err = ate.ate_rmse(est_t, traj.cam_t)
    # noiseless observations + tight noise config. The consistent
    # landmark init carries honest gauge drift (the map is anchored
    # only by the initial camera prior), so a few cm over the orbit.
    assert err < 0.04, f"ATE {err}"
    # landmarks converge to ground truth in the gauge-aligned frame
    s, r, tt = ate.umeyama_alignment(est_t, traj.cam_t)
    m = len(scene.marker_pos)
    seen = np.asarray(seq.mask).any(axis=0)[:m]
    lm_est = np.asarray(final.lm[:m, :3])[seen]
    lm_aligned = (s * (r @ lm_est.T)).T + tt
    lm_err = np.abs(lm_aligned - scene.marker_pos[seen]).max()
    assert lm_err < 0.15, f"landmark err {lm_err}"  # late-activated landmarks inherit init-epoch gauge


def test_reference_default_tuning_tracks():
    """With the reference's (very loose) default noise constants and a
    sparse-visibility scene, the filter drifts but stays bounded —
    the behavior envelope of the reference EKF."""
    cfg = MekfConfig(capacity=16, dtype=jnp.float64)
    state = init_state(cfg)
    _, traj, seq = make_obs_seq(cfg, frames=200, markers=8, fov_limit=0.45)
    _, cam_traj = mekf_scan(cfg, state, seq)
    err = ate.ate_rmse(np.asarray(cam_traj[:, :3]), traj.cam_t)
    assert np.isfinite(err) and err < 0.6, f"ATE {err}"


def test_noisy_convergence_point():
    cfg = MekfConfig(capacity=16, dtype=jnp.float64,
                     r_uncertainty=1e-3, q_uncertainty_cam=0.05,
                     q_error_uncertainty_cam=0.05, q_uncertainty_lm=1e-5)
    state = init_state(cfg)
    scene, traj, seq = make_obs_seq(
        cfg, frames=200, markers=12, noise_t=0.01, noise_r=0.01)
    _, cam_traj = mekf_scan(cfg, state, seq)
    err = ate.ate_rmse(np.asarray(cam_traj[:, :3]), traj.cam_t)
    assert err < 0.05, f"ATE {err}"


def test_noiseless_convergence_rotations():
    cfg = MekfConfig(capacity=16, with_rotations=True, dtype=jnp.float64,
                     **TIGHT)
    state = init_state(cfg)
    scene, traj, seq = make_obs_seq(cfg, frames=200, markers=8)
    final, cam_traj = mekf_scan(cfg, state, seq)
    err = ate.ate_rmse(np.asarray(cam_traj[:, :3]), traj.cam_t)
    assert err < 0.04, f"ATE {err}"
    # landmark orientations should match ground truth (up to sign)
    m = len(scene.marker_pos)
    seen = np.asarray(seq.mask).any(axis=0)[:m]
    est_q = np.asarray(final.lm[:m, 3:7])[seen]
    true_q = scene.marker_quat[seen]
    dots = np.abs(np.sum(est_q * true_q, axis=-1))
    assert (dots > 0.99).all(), dots


def test_float32_stability():
    """The device dtype: covariance must stay PSD-ish and finite."""
    cfg = MekfConfig(capacity=16, dtype=jnp.float32,
                     r_uncertainty=1e-3, q_uncertainty_cam=0.05,
                     q_error_uncertainty_cam=0.05, q_uncertainty_lm=1e-5)
    state = init_state(cfg)
    _, traj, seq = make_obs_seq(
        cfg, frames=300, markers=8, noise_t=0.005, noise_r=0.005)
    final, cam_traj = mekf_scan(cfg, state, seq)
    assert np.isfinite(np.asarray(cam_traj)).all()
    diag = np.diagonal(np.asarray(final.cov))
    assert (diag > -1e-3).all()
    err = ate.ate_rmse(np.asarray(cam_traj[:, :3]), traj.cam_t)
    assert err < 0.1, f"ATE {err}"


def test_scan_matches_step_loop():
    cfg = MekfConfig(capacity=16, dtype=jnp.float64)
    state = init_state(cfg)
    _, _, seq = make_obs_seq(cfg, frames=20, markers=4)
    by_scan, _ = mekf_scan(cfg, state, seq)
    s = state
    for i in range(20):
        s = mekf_step(cfg, s, FrameObservations(
            seq.t_cl[i], seq.q_cl[i], seq.mask[i]))
    np.testing.assert_allclose(
        np.asarray(by_scan.cam_t), np.asarray(s.cam_t), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(by_scan.cov), np.asarray(s.cov), atol=1e-12)


def test_rotation_consistency_gate():
    """Reference correct_poses capability (base_filter.py:274-325):
    observations rotated >50 deg from the landmark estimate drop out;
    unknown (inactive) slots pass through for initialization."""
    from aruco_slam_tpu.filters import rotation_consistency_gate
    cfg = MekfConfig(capacity=4, with_rotations=True)
    state = init_state(cfg)
    # activate slot 0 with identity rotation
    state = state._replace(
        active=state.active.at[0].set(True),
        lm=state.lm.at[0, 3].set(1.0))
    q_bad = jnp.asarray(  # 90 deg about z
        [np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4)], jnp.float32)
    q_good = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    obs = FrameObservations(
        t_cl=jnp.zeros((4, 3), jnp.float32),
        q_cl=jnp.stack([q_bad, q_good, q_bad, q_good]),
        mask=jnp.asarray([True, True, True, False]))
    gated = rotation_consistency_gate(cfg, state, obs)
    # slot 0: active + 90deg off -> dropped; slot 1: active? no ->
    # passes; slot 2: inactive -> passes; slot 3: unobserved
    assert list(np.asarray(gated.mask)) == [False, True, True, False]


def test_innovation_gate():
    from aruco_slam_tpu.filters import innovation_gate
    cfg = MekfConfig(capacity=3)
    state = init_state(cfg)
    state = state._replace(
        active=state.active.at[0].set(True) .at[1].set(True),
        lm=state.lm.at[0].set(
            jnp.asarray([0.0, 0.0, 2.0], state.lm.dtype))
                   .at[1].set(
            jnp.asarray([0.0, 0.0, 2.0], state.lm.dtype)))
    obs = FrameObservations(
        t_cl=jnp.asarray([[0.0, 0.0, 2.1],    # near prediction
                          [5.0, 0.0, 2.0],    # 5 m off
                          [9.9, 9.9, 9.9]],   # inactive slot
                         jnp.float32),
        q_cl=jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (3, 1)),
        mask=jnp.asarray([True, True, True]))
    gated = innovation_gate(cfg, state, obs, max_distance_m=1.0)
    assert list(np.asarray(gated.mask)) == [True, False, True]


def test_preload_map_round_trip(tmp_path):
    """save_map -> load_map -> preload_map seeds the filter (working
    version of the reference's broken load path, base_filter.py:249-272)."""
    from aruco_slam_tpu.filters.mekf import preload_map
    from aruco_slam_tpu.io import load_map, save_map
    cfg = MekfConfig(capacity=8)
    ids = np.array([1, 4, 6])
    pos = np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [6.0, 7.0, 8.0]])
    unc = np.full((3, 3), 0.25)
    f = tmp_path / "map.txt"
    save_map(f, ids, pos, unc)
    lids, lpos, lunc = load_map(f)
    state = preload_map(cfg, init_state(cfg), lids, lpos, lunc)
    assert list(np.where(np.asarray(state.active))[0]) == [1, 4, 6]
    np.testing.assert_allclose(np.asarray(state.lm)[ids, :3], pos,
                               atol=1e-5)
    diag = np.diagonal(np.asarray(state.cov))
    assert abs(diag[6 + 3 * 1] - 0.25) < 1e-5


def test_measurement_compaction_is_exact():
    """max_obs compaction == full measurement block when the per-frame
    observation count fits (bit-equal trajectories)."""
    base = MekfConfig(capacity=32)
    _, traj, seq = make_obs_seq(base, frames=40, markers=6,
                                noise_t=0.005)
    outs = {}
    for mo in (32, 8):
        cfg = base._replace(max_obs=mo)
        _, cam_traj = mekf_scan(cfg, init_state(cfg), seq)
        outs[mo] = np.asarray(cam_traj)
    np.testing.assert_allclose(outs[8], outs[32], atol=1e-6)


def test_divergence_guard_survives_nan_observation():
    """A NaN observation that slips past the gates must not poison the
    filter (SURVEY.md §5: the reference has no failure handling)."""
    cfg = MekfConfig(capacity=8)
    _, _, seq = make_obs_seq(cfg, frames=10, markers=4)
    state = init_state(cfg)
    for i in range(10):
        t = seq.t_cl[i]
        if i == 5:  # poison one masked-ON observation
            t = t.at[0, 0].set(jnp.nan)
        state = mekf_step(cfg, state, FrameObservations(
            t, seq.q_cl[i], seq.mask[i]))
    assert np.isfinite(np.asarray(state.cam_t)).all()
    assert np.isfinite(np.asarray(state.cov)).all()


def test_velocity_motion_model_runs_and_stays_consistent():
    """vel_smoothing > 0 (the motion model the reference README
    promises but never implements) tracks a smooth sequence."""
    cfg = MekfConfig(capacity=16, vel_smoothing=0.7)
    _, traj, seq = make_obs_seq(cfg, frames=100, markers=6,
                                noise_t=0.005, noise_r=0.005)
    final, cam_traj = mekf_scan(cfg, init_state(cfg), seq)
    assert np.isfinite(np.asarray(cam_traj)).all()
    err = ate.ate_rmse(np.asarray(cam_traj)[:, :3], traj.cam_t)
    assert err < 0.15, f"ATE {err}"
    assert np.isfinite(np.asarray(final.vel)).all()


def test_ns_solver_matches_cholesky():
    """XLA Newton–Schulz innovation solve (the batched-serving path)
    tracks the Cholesky solve."""
    base = MekfConfig(capacity=16)
    _, traj, seq = make_obs_seq(base, frames=40, markers=6,
                                noise_t=0.005)
    outs = {}
    for sv in ("cho", "ns"):
        cfg = base._replace(s_solver=sv)
        _, cam_traj = mekf_scan(cfg, init_state(cfg), seq)
        outs[sv] = np.asarray(cam_traj)
    np.testing.assert_allclose(outs["ns"], outs["cho"], atol=1e-4)


def test_ns_solver_matches_cholesky_rotations_cv():
    """The serving configuration's solver ("ns") against the exact
    Cholesky over a whole sequence in the largest per-landmark block
    (rotation landmarks: 6 error dims, 7-dim measurements) under the
    constant-velocity model: trajectories, landmarks and covariances
    agree to f32 solve noise."""
    base = MekfConfig(capacity=16, with_rotations=True,
                      motion_model="cv")
    _, traj, seq = make_obs_seq(base, frames=80, markers=6,
                                noise_t=0.005, noise_r=0.005)
    outs = {}
    for sv in ("cho", "ns"):
        cfg = base._replace(s_solver=sv)
        final, cam_traj = mekf_scan(cfg, init_state(cfg), seq)
        outs[sv] = (np.asarray(cam_traj), np.asarray(final.lm),
                    np.asarray(final.cov))
    for got, ref in zip(outs["ns"], outs["cho"]):
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_cv_motion_model_beats_static_predict():
    """motion_model="cv" (velocity in the error state with exact
    F P Fᵀ propagation) tracks a smooth orbit much tighter than the
    static predict, and the velocity estimate converges to the true
    per-frame displacement."""
    base = dict(capacity=16, dtype=jnp.float64, q_uncertainty_lm=0.0,
                r_uncertainty=1e-3)
    _, traj, seq = make_obs_seq(MekfConfig(**base), frames=150,
                                markers=12, noise_t=0.005)
    errs = {}
    for mm in ("none", "cv"):
        cfg = MekfConfig(motion_model=mm, **base)
        final, cam_traj = mekf_scan(cfg, init_state(cfg), seq)
        errs[mm] = ate.ate_rmse(np.asarray(cam_traj)[:, :3], traj.cam_t)
        if mm == "cv":
            true_vel = traj.cam_t[-1] - traj.cam_t[-2]
            assert np.linalg.norm(
                np.asarray(final.vel) - true_vel) < 0.02
    # on this dense-visibility scene the static predict is already near
    # the floor; cv must be at least as tight, and absolutely tight
    assert errs["cv"] <= errs["none"] * 1.05, errs
    assert errs["cv"] < 0.02, errs


def test_depth_scaled_measurement_covariance():
    """pixel_sigma > 0 builds a per-observation R from the z²/(f·s)
    planar-PnP depth error law; the filter stays consistent and the
    far-landmark uncertainty exceeds the near-landmark one."""
    cfg = MekfConfig(capacity=16, dtype=jnp.float64, motion_model="cv",
                     q_uncertainty_lm=0.0, pixel_sigma=1.0,
                     focal_px=1414.9, marker_size=0.16)
    scene, traj, seq = make_obs_seq(cfg, frames=150, markers=12,
                                    noise_t=0.005)
    final, cam_traj = mekf_scan(cfg, init_state(cfg), seq)
    assert np.isfinite(np.asarray(cam_traj)).all()
    err = ate.ate_rmse(np.asarray(cam_traj)[:, :3], traj.cam_t)
    assert err < 0.1, f"ATE {err}"
    # rotations mode wires quaternion rows into R as well
    cfg_r = cfg._replace(with_rotations=True)
    _, _, seq_r = make_obs_seq(cfg_r, frames=60, markers=8)
    final_r, traj_r = mekf_scan(cfg_r, init_state(cfg_r), seq_r)
    assert np.isfinite(np.asarray(traj_r)).all()


def test_fused_innovation_gate_rejects_outlier():
    """A wild outlier observation of a known landmark must not move
    the state when gate_distance is set — and must corrupt it when the
    gate is off (sanity that the gate is doing the work)."""
    import jax
    base = MekfConfig(capacity=8, dtype=jnp.float64, r_uncertainty=1e-3)
    _, traj, seq = make_obs_seq(base, frames=20, markers=6)
    res = {}
    for gate in (0.0, 1.0):
        cfg = base._replace(gate_distance=gate)
        st, _ = mekf_scan(cfg, init_state(cfg), seq)
        # outlier: known landmark 0 reported 5 m off
        bad = FrameObservations(
            t_cl=jnp.asarray(seq.t_cl[-1]).at[0].add(
                jnp.asarray([5.0, 0.0, 0.0])),
            q_cl=seq.q_cl[-1], mask=seq.mask[-1] | (jnp.arange(8) == 0))
        nxt = mekf_step(cfg, st, bad)
        res[gate] = np.linalg.norm(
            np.asarray(nxt.cam_t) - np.asarray(st.cam_t))
    # the gated step still moves a little (the frame's other, valid
    # observations update the camera); the outlier's 5 m kick must not
    assert res[1.0] < 0.05, res
    assert res[0.0] > 10 * res[1.0], res


def test_ambiguity_deweights_unreliable_rotations():
    """Rotation measurements flagged as IPPE-ambiguous (err ratio ~1)
    must not poison the rotations-mode filter: flipping the observed
    marker rotation on ambiguous observations should barely move the
    trajectory when ambiguity is supplied."""
    cfg = MekfConfig(capacity=16, with_rotations=True, motion_model="cv",
                     q_uncertainty_lm=0.0, pixel_sigma=1.0,
                     dtype=jnp.float64)
    _, traj, seq = make_obs_seq(cfg, frames=80, markers=8)
    # corrupt rotations on every 4th frame's observations (tilt flip),
    # as the IPPE ambiguity does at range
    rng = np.random.default_rng(0)
    q = np.asarray(seq.q_cl).copy()
    bad = np.zeros(seq.mask.shape, bool)
    bad[::4] = np.asarray(seq.mask)[::4]
    flip = np.concatenate(  # ~40 deg tilt error
        [np.full((*q.shape[:2], 1), np.cos(0.35)),
         np.full((*q.shape[:2], 2), 0.0),
         np.full((*q.shape[:2], 1), np.sin(0.35))], axis=-1)
    from aruco_slam_tpu.core import quaternion as quat
    qj = jnp.asarray(q)
    q_bad = np.where(bad[..., None], np.asarray(
        quat.multiply(jnp.asarray(flip), qj)), q)
    amb = np.where(bad, 0.95, 0.05)
    errs = {}
    for use_amb in (False, True):
        s = FrameObservations(
            seq.t_cl, jnp.asarray(q_bad), seq.mask,
            jnp.asarray(amb) if use_amb else None)
        _, cam_traj = mekf_scan(cfg, init_state(cfg), s)
        errs[use_amb] = ate.ate_rmse(
            np.asarray(cam_traj)[:, :3], traj.cam_t)
    assert errs[True] < errs[False], errs
    assert errs[True] < 0.05, errs


def test_cv_vel_decay_bounds_dead_reckoning():
    """With motion_model="cv", a stretch with zero accepted
    observations must not run away: vel_decay < 1 caps the integrated
    excursion at ~|v|/(1-rho), while pure constant velocity (decay 1)
    keeps integrating forever."""
    cfg0 = MekfConfig(capacity=4, motion_model="cv",
                      r_uncertainty=1e-3)

    def run(cfg):
        state = init_state(cfg)
        # one landmark straight ahead; 10 frames moving +x at 0.1/frame
        # teach the filter a velocity
        lm_w = np.array([0.0, 0.0, 3.0])
        for f in range(30):
            cam = np.array([0.1 * f, 0.0, 0.0])
            t_cl = jnp.asarray((lm_w - cam)[None], jnp.float32)
            obs = FrameObservations(
                t_cl=jnp.broadcast_to(t_cl, (4, 3)),
                q_cl=jnp.zeros((4, 4)).at[:, 0].set(1.0),
                mask=jnp.asarray([True, False, False, False]))
            state = mekf_step(cfg, state, obs)
        # then 200 blind frames
        blind = FrameObservations(
            t_cl=jnp.zeros((4, 3)), q_cl=jnp.zeros((4, 4)).at[:, 0].set(1.0),
            mask=jnp.zeros(4, bool))
        x_teach = float(state.cam_t[0])
        for _ in range(200):
            state = mekf_step(cfg, state, blind)
        return float(state.cam_t[0]) - x_teach, float(state.vel[0])

    exc_decay, v_decay = run(cfg0._replace(vel_decay=0.9))
    exc_const, v_const = run(cfg0)
    # decayed blind excursion caps at ~v/(1-rho) = 10v; constant
    # velocity integrates 200v — and its velocity never dies
    assert exc_const > 5.0 * exc_decay, (exc_const, exc_decay)
    assert abs(v_decay) < 1e-3, v_decay
    assert abs(v_const) > 1e-3, v_const


def test_dropped_obs_counter():
    """max_obs truncation is LOUD: frames observing more slots than
    the compaction width count their dropped extras in
    state.dropped_obs (VERDICT r2 weak #6: library consumers got
    silent drops past max_obs)."""
    cfg = MekfConfig(capacity=8, max_obs=2)
    state = init_state(cfg)
    obs = FrameObservations(
        t_cl=jnp.tile(jnp.asarray([0.0, 0.0, 2.0]), (8, 1))
        + 0.3 * jnp.arange(8)[:, None],
        q_cl=jnp.zeros((8, 4)).at[:, 0].set(1.0),
        mask=jnp.asarray([True] * 5 + [False] * 3))
    state = mekf_step(cfg, state, obs)
    assert int(state.dropped_obs) == 3  # 5 observed, 2 kept
    state = mekf_step(cfg, state, obs)
    assert int(state.dropped_obs) == 6  # cumulative

    # wide-enough compaction never drops
    cfg2 = MekfConfig(capacity=8, max_obs=8)
    s2 = init_state(cfg2)
    s2 = mekf_step(cfg2, s2, obs)
    assert int(s2.dropped_obs) == 0


def test_blocked_augmentation_matches_dense_gpg():
    """_augment_consistent's blocked form (M P M + rank-ce E terms)
    must equal the dense G P Gᵀ + B R Bᵀ it replaces (the dense form
    was two N³ GEMMs per frame, ~90% of the batched 512-survey cost
    under vmap'd lax.cond — VERDICT r4 #7)."""
    import jax
    from aruco_slam_tpu.filters import mekf as m

    # capacity 6 exercises the small-state DENSE branch, 256 the
    # large-state BLOCKED branch (the form switches on err_dim)
    for with_rot, seed, cap in ((False, 0, 6), (True, 1, 6),
                                (False, 2, 256)):
        cfg = MekfConfig(capacity=cap, with_rotations=with_rot,
                         motion_model="cv")
        n, ce, le, c = cfg.err_dim, cfg.cam_edims, cfg.lm_edims, cap
        rng = np.random.default_rng(seed)
        a = rng.normal(size=(n, n))
        cov = jnp.asarray(a @ a.T * 0.01 + np.eye(n) * 0.1, cfg.dtype)
        state = init_state(cfg)._replace(
            cov=cov,
            cam_t=jnp.asarray(rng.normal(size=3), cfg.dtype),
            cam_q=jnp.asarray([0.9, 0.1, -0.2, 0.4], cfg.dtype))
        state = state._replace(
            cam_q=state.cam_q / jnp.linalg.norm(state.cam_q))
        new = jnp.asarray(([True, False] * ((cap + 1) // 2))[:cap])
        new_dims = jnp.concatenate(
            [jnp.zeros(ce, bool), jnp.repeat(new, le)])
        t_cl = jnp.asarray(rng.normal(size=(c, 3)) + [0, 0, 3],
                           cfg.dtype)
        q_raw = rng.normal(size=(c, 4))
        q_cl = jnp.asarray(
            q_raw / np.linalg.norm(q_raw, axis=1, keepdims=True),
            cfg.dtype)
        r_init = jnp.asarray(rng.uniform(0.01, 0.1, (c, 6 if with_rot
                                                     else 3)),
                             cfg.dtype)

        got = m._augment_consistent(cfg, state, new, new_dims, t_cl,
                                    q_cl, r_init)

        # dense reference: build G and B R Bᵀ explicitly
        zc = jnp.zeros(ce, cfg.dtype)
        if with_rot:
            def g_init(eps_c, z, tcl_j, qcl_j):
                from aruco_slam_tpu.core import quaternion as quat
                t = state.cam_t + eps_c[m._DT]
                q_wc = m._perturb(state.cam_q, eps_c[m._DTH])
                xyz = quat.rotate(q_wc, tcl_j + z[:3]) + t
                q_wl = quat.multiply(q_wc, m._perturb(qcl_j, z[3:6]))
                xyz0 = quat.rotate(state.cam_q, tcl_j) + state.cam_t
                q0 = quat.multiply(state.cam_q, qcl_j)
                dq = quat.multiply(q_wl, quat.conjugate(q0))
                return jnp.concatenate([xyz - xyz0, quat.to_rotvec(dq)])
            jac = jax.vmap(jax.jacfwd(g_init, argnums=(0, 1)),
                           in_axes=(None, None, 0, 0))(
                zc, jnp.zeros(6, cfg.dtype), t_cl, q_cl)
        else:
            def g_init(eps_c, z, tcl_j):
                from aruco_slam_tpu.core import quaternion as quat
                t = state.cam_t + eps_c[m._DT]
                q_wc = m._perturb(state.cam_q, eps_c[m._DTH])
                xyz = quat.rotate(q_wc, tcl_j + z) + t
                xyz0 = quat.rotate(state.cam_q, tcl_j) + state.cam_t
                return xyz - xyz0
            jac = jax.vmap(jax.jacfwd(g_init, argnums=(0, 1)),
                           in_axes=(None, None, 0))(
                zc, jnp.zeros(3, cfg.dtype), t_cl)
        j_cam_init, j_z_init = jac
        g_cam = jnp.where(new[:, None, None], j_cam_init, 0.0)
        g_mat = jnp.eye(n, dtype=cfg.dtype) * (~new_dims)[:, None]
        g_mat = g_mat.at[ce:, :ce].set(g_cam.reshape(c * le, ce))
        b = jnp.where(new[:, None, None], j_z_init, 0.0)
        brb = jnp.einsum("jlz,jmz,jz->jlm", b, b, r_init)
        ref = g_mat @ cov @ g_mat.T
        eye_c = jnp.eye(c, dtype=cfg.dtype)
        brb_full = jnp.einsum("jc,jlm->jlcm", eye_c, brb).reshape(
            c * le, c * le)
        ref = ref.at[ce:, ce:].add(brb_full)

        # blocked vs dense differ only by f32 reassociation; the
        # longer dot products at capacity 256 accumulate ~3e-5
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-5 if cap < 100 else 1e-4,
                                   err_msg=f"with_rotations={with_rot}")


def test_bf16_covariance_storage_mode():
    """cov_dtype=bf16 (the bandwidth-bound survey serving mode,
    bench/large_map.py --cov-dtype bf16) must track close to the f32
    filter: the gain chain stays f32, so bf16 storage rounds like a
    little extra process noise — bounded ATE, no blow-up."""
    import jax.numpy as jnp

    cfg32 = MekfConfig(capacity=64, s_solver="ns",
                       motion_model="cv")
    cfg16 = cfg32._replace(cov_dtype=jnp.bfloat16)
    _, traj, seq = make_obs_seq(cfg32, noise_t=0.005)
    _, tr32 = mekf_scan(cfg32, init_state(cfg32), seq)
    st16, tr16 = mekf_scan(cfg16, init_state(cfg16), seq)
    assert st16.cov.dtype == jnp.bfloat16
    e32 = ate.ate_rmse(np.asarray(tr32)[:, :3], traj.cam_t)
    e16 = ate.ate_rmse(np.asarray(tr16)[:, :3], traj.cam_t)
    assert np.isfinite(np.asarray(tr16)).all()
    assert e16 < 2.5 * e32 + 0.02, (e16, e32)
