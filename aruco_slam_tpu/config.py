"""Typed application config — the single tunable surface.

The reference scatters its knobs across module-level constants
(display flags and sizes in main/run_slam.py:31-44, filter noise in
filters/extended_kalman_filter.py:19-34 and
filters/ekf_with_rotations.py:21-40, graph noise in
filters/factor_graph.py:20-28, detector parameters in
filters/base_filter.py:82-90). Here they are one dataclass that the
CLI populates and every subsystem consumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SlamAppConfig:
    # input
    input: str = "sequence.npz"
    filter: str = "mekf"          # mekf | mekf_rotations | factorgraph
    marker_size: float = 0.16     # meters (reference base_filter.py:178)
    capacity: int = 64
    # LRU slot recycling: > 0 lets a NEW marker id evict a slot whose
    # marker went unobserved for this many frames once the table is
    # full, so corridor-style runs traversing more than `capacity`
    # distinct markers keep mapping (ops/detect.assign_slots_lru);
    # 0 = slots permanent (saturation still counted + warned)
    slot_max_age: int = 0
    # fleet streaming (multi-stream serving): split the fleet into G
    # schedule cohorts so a dead stream triggers an immediate full
    # sweep of its own cohort (ops/detect.streaming_step);
    # 0 = one shared schedule, no per-stream rescue
    rescue_cohorts: int = 0
    # marker dictionary for image-domain inputs (reference
    # base_filter.py:82 hardcodes DICT_5X5_50; calibration uses
    # AprilTag 36h11) — ops/dictionary.py names
    dict_name: str = "dict_5x5_50"
    # streaming detection: 0 = full detection every frame (the
    # reference's behavior); K >= 3 = full detection on 2 of every K
    # frames and decode-validated corner tracking in between
    # (ops/detect.detect_or_track) — several times cheaper per frame
    # on video-rate input, new markers acquired at the next full pass
    track_every: int = 0
    # full-sweep preset: "robust" = the 3-pass (window x scale)
    # candidate sweep (survives blur/noise/clutter — the analog of the
    # reference's adaptiveThreshWinSize 3-30 sweep); "fast" = single
    # coarse pass, ~3x cheaper, for clean well-lit scenes
    detector: str = "robust"
    # camera fallback (the reference's calibration artifacts,
    # calibration/camera_matrix.npy + dist_coeffs.npy)
    camera_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3], [0.0, 0.0, 1.0]]))
    dist_coeffs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [0.0614, -0.2951, 0.0005, 0.0029, 0.4387]))
    # outputs (reference main/run_slam.py:28-32)
    trajectory_file: str = "outputs/trajectory.txt"
    map_file: str = "outputs/map.txt"
    # viz sinks
    viz_2d: bool = False
    viz_3d: bool = False
    # "mpl" = matplotlib 3D figures (axes/ticks, ~50 ms/frame);
    # "fast" = the numpy raster renderer (viz/render3d, ~1-2 ms) —
    # use for long-sequence exports
    viz_3d_renderer: str = "mpl"
    viz_dir: str = "outputs/images"
    export_video: bool = False
    # detection gating
    max_reproj_px: float = 3.0
    # graph online mode
    window: int = 8
    window_iters: int = 3
    # bounded-memory online smoothing: live-pose budget. When the
    # graph reaches this many poses, the oldest half are Schur-
    # marginalized into per-landmark priors (graph/ba.py
    # marginalize_poses) — the reference's graph.resize(100) role
    # (reference filters/factor_graph.py:224), done with the
    # information kept instead of discarded. 0 = unbounded (the graph
    # must then hold every pose of the run).
    pose_budget: int = 128
    batch_iters: int = 50
    # factor-graph noise model. The reference's constants
    # (reference filters/factor_graph.py:20-25: odom sigma 0.1 m /
    # 20 deg, measurement sigma 0.5 m) assume near-stationary handheld
    # video; on trajectories with real motion the tight zero-motion
    # odometry prior biases the solve, so the app defaults weigh
    # measurements over odometry. Pass the reference values via CLI
    # flags for behavioral parity.
    meas_sigma_t: float = 0.01
    odom_sigma_t: float = 1.0
    odom_sigma_rot: float = 1.0
    # MEKF noise. Reference parity is r=0.9, q_cam=0.3, q_rot=0.5,
    # q_lm=0.01 (reference extended_kalman_filter.py:21-27) — tuned for
    # its noisy handheld video; PnP on clean detections is far more
    # accurate than r=0.9 assumes, so the app defaults weigh
    # measurements accordingly (2.8x lower ATE on the synthetic demo).
    mekf_r: float = 0.005
    mekf_q_cam: float = 1.0
    mekf_q_rot: float = 1.0
    # landmarks are physically static: zero process noise lets the map
    # harden as evidence accumulates (reference uses 0.01, which keeps
    # re-softening it and lets camera motion leak into the landmarks)
    mekf_q_lm: float = 0.0
    # constant-velocity camera model ("cv") + depth-scaled measurement
    # covariance (pixel_sigma, in px): 3-10x lower ATE than the static
    # predict + constant R at realistic corner noise (<= 0.5 px after
    # subpixel refinement). Set motion_model="none" and pixel_sigma=0
    # for reference-parity behavior.
    mekf_motion_model: str = "cv"
    mekf_q_vel: float = 2e-3
    # <1 bounds the blind dead-reckoning excursion (filters/mekf.py
    # vel_decay); 0.99 costs nothing on tracked runs
    mekf_vel_decay: float = 0.99
    # matmul precision of the update chain on the GPU (filters/mekf.py
    # matmul_precision): "highest" (f32, default) | "mixed" | "high"
    mekf_precision: str = "highest"
    # corner noise (px) driving the depth-scaled measurement whitening
    # in BOTH backends (filters/mekf.py pixel_sigma, graph/ba.py
    # per-factor sigmas); 0 = constant-R reference behavior
    pixel_sigma: float = 1.0
    # MEKF innovation gate (m): drop observations of known landmarks
    # whose position residual exceeds this; 0 = off
    gate_distance: float = 1.0
    # update-compaction width (filters/mekf.py max_obs): the max
    # markers one frame may observe before extras are dropped.
    # 0 = auto-size from the sequence's densest frame (never drops)
    max_obs: int = 0
    # Huber delta (whitened units) for robust BA factors; 0 = plain LS
    huber_delta: float = 2.0
