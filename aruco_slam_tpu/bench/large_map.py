"""Large-map throughput benchmark — BASELINE.json config 5 at scale.

"Multi-sequence throughput run: batched parallel SLAM over many videos
+ 500-marker synthetic map": a 512-marker wall surveyed by a raster
sweep, filtered by a 512-capacity constant-velocity MEKF (error-state
dim 9 + 512*3 = 1545, so the per-frame covariance update is real
matmul work), and S independent sequences vmapped over the device at
once.

The reference cannot represent this run at all: its EKF grows a dense
numpy state per landmark in Python (reference
extended_kalman_filter.py:239-290) and processes one sequence,
one frame, one marker at a time (reference main/run_slam.py:111-141).

    python -m aruco_slam_tpu.bench.large_map            # GPU
    python -m aruco_slam_tpu.bench.large_map --platform cpu \
        --markers 96 --frames 64 --batch 2              # dev box

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--markers", type=int, default=512)
    p.add_argument("--frames", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-obs", type=int, default=48)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--precision", default="mixed",
                   choices=["highest", "high", "mixed"],
                   help="update-chain matmul precision (filters/mekf "
                        "matmul_precision). The serving default is "
                        "'mixed': default-precision bulk covariance "
                        "products with the gain chain pinned to f32; "
                        "the row reports its ATE")
    p.add_argument("--cov-dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="covariance STORAGE dtype (MekfConfig."
                        "cov_dtype): bf16 halves the bytes the "
                        "dim-1545 step moves, at an ATE cost the row "
                        "reports")
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from aruco_slam_tpu.bench import synthetic
    from aruco_slam_tpu.bench.ate import ate_rmse
    from aruco_slam_tpu.core import camera as cam_mod
    from aruco_slam_tpu.filters import MekfConfig, init_state
    from aruco_slam_tpu.ops import pnp

    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    d = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    cam = cam_mod.CameraModel.from_matrix(jnp.asarray(k, jnp.float32),
                                          jnp.asarray(d, jnp.float32))

    # wall wide enough that the raster sweep sees a bounded strip
    # (~33 of 512 markers) per frame, with vertical overlap between
    # passes (FOV height ~3.4 m at 4.5 m depth vs ~2.2 m row spacing)
    # so successive rows share landmarks — like a real survey flight
    extent = 11.0 * np.sqrt(args.markers / 512.0)
    scene = synthetic.make_wall_scene(
        num_markers=args.markers, seed=0, extent=float(extent),
        depth=4.5)
    traj = synthetic.make_raster_trajectory(
        num_frames=args.frames, rows=4,
        extent_x=float(extent - 2.0), extent_y=float(0.4 * extent))
    corners, mask = synthetic.observe_corners(
        scene, traj, cam, args.markers, noise_px=0.3, seed=1)
    visible = mask.sum(1)

    fcfg = MekfConfig(capacity=args.markers, max_obs=args.max_obs,
                      s_solver="ns",
                      pixel_sigma=0.3, gate_distance=1.5,
                      motion_model="cv", vel_decay=0.99,
                      matmul_precision=args.precision,
                      cov_dtype=jnp.bfloat16
                      if args.cov_dtype == "bf16" else None)
    state0 = init_state(fcfg)
    marker_size = scene.marker_size

    from aruco_slam_tpu.bench.pipeline import make_pipeline
    pipeline = make_pipeline(cam, marker_size, fcfg, chunk=16)

    corners_d = jnp.asarray(corners, jnp.float32)
    mask_d = jnp.asarray(mask)
    rng = np.random.default_rng(7)
    corners_b = jnp.asarray(
        corners[None] + rng.normal(0, 0.3, (args.batch,) + corners.shape),
        jnp.float32)
    mask_b = jnp.broadcast_to(mask_d, (args.batch,) + mask.shape)

    from aruco_slam_tpu.bench.pipeline import (
        compile_and_time, device_fields, flops_metrics)
    single = compile_and_time(lambda c, m: pipeline(state0, c, m)[1],
                              (corners_d, mask_d), reps=args.reps)
    ate = ate_rmse(np.asarray(single.out[:, :3]), traj.cam_t)
    single_fps = args.frames / single.run_s
    batched = jax.vmap(pipeline, in_axes=(None, 0, 0))
    bat = compile_and_time(lambda c, m: batched(state0, c, m)[1],
                           (corners_b, mask_b), reps=args.reps)
    fps = args.batch * args.frames / bat.run_s
    flop_row = flops_metrics(bat.flops, bat.run_s)

    # offline smoothing at the same scale (north-star config 3): full
    # batch LM with Schur-eliminated landmarks over every pose/factor
    from aruco_slam_tpu.graph import (
        GraphConfig, add_frame, batch_optimize, init_graph)
    res = jax.vmap(
        lambda c: pnp.solve_square_pnp(cam, c, marker_size))(corners_d)
    t_cl_h = np.asarray(res.t_cl)
    mask_h = np.asarray(mask) & (np.asarray(res.err) < 3.0)
    nfac = int(mask_h.sum()) + args.frames
    gcfg = GraphConfig(max_poses=args.frames + 2,
                       max_landmarks=args.markers,
                       max_factors=nfac + 64,
                       pixel_sigma=0.3, huber_delta=2.0)
    gstate = init_graph(gcfg)
    for i in range(args.frames):
        gstate = add_frame(gcfg, gstate, jnp.asarray(t_cl_h[i]),
                           jnp.asarray(mask_h[i]))
    ba = compile_and_time(
        lambda s: batch_optimize(gcfg, s, iters=40)[0].pose_t,
        (gstate,), reps=1)
    ba_ate = ate_rmse(np.asarray(ba.out)[:args.frames], traj.cam_t)
    # BA achieved FLOP/s: the Schur system is real GEMM content
    ba_flop_row = {f"ba_{k}": v for k, v in
                   flops_metrics(ba.flops, ba.run_s).items()}

    print(json.dumps({
        "metric": "large_map_fps_per_chip",
        "value": round(fps, 1),
        "unit": f"frames/s ({args.markers}-marker map, "
                f"batch {args.batch}, {args.precision} precision, "
                f"{args.cov_dtype} covariance)",
        "single_stream_fps": round(single_fps, 1),
        "ate_m": round(float(ate), 4),
        "offline_ba_ate_m": round(float(ba_ate), 4),
        "offline_ba_s": round(ba.run_s, 2),
        "compile_s": {"single": round(single.compile_s, 2),
                      "batched": round(bat.compile_s, 2),
                      "ba": round(ba.compile_s, 2)},
        "temp_mib": {k: round(r.memory.temp_size_in_bytes / 2**20, 1)
                     for k, r in (("single", single), ("batched", bat),
                                  ("ba", ba))},
        "n_factors": nfac,
        "mean_visible": round(float(visible.mean()), 1),
        "state_dim": fcfg.err_dim,
        **device_fields(),
        **flop_row,
        **ba_flop_row,
    }))


if __name__ == "__main__":
    main()
