"""Online factor-graph backend benchmark — the per-frame smoothing
path (bounded-memory windowed GN + Schur pose marginalization).

This is the one backend whose driver loop is per-frame host Python
(apps/run_slam.py run_factorgraph — the on-device counterpart of the
reference's per-frame ISAM2 update, reference
filters/factor_graph.py:149-155), so its throughput can regress
silently without a pinned number: bench.py and bench/large_map.py
cover only the MEKF paths. This bench drives the REAL product
function (run_slam.run_factorgraph) at the app-default 128-pose
budget with marginalization, and reports fps + ATE as one JSON line.

    python -m aruco_slam_tpu.bench.factorgraph            # GPU
    python -m aruco_slam_tpu.bench.factorgraph --platform cpu \
        --frames 80 --pose-budget 48                      # dev box
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--markers", type=int, default=12)
    p.add_argument("--pose-budget", type=int, default=128)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from aruco_slam_tpu.apps.run_slam import run_factorgraph
    from aruco_slam_tpu.bench import synthetic
    from aruco_slam_tpu.bench.ate import ate_rmse
    from aruco_slam_tpu.bench.pipeline import device_fields
    from aruco_slam_tpu.config import SlamAppConfig
    from aruco_slam_tpu.core import camera as cam_mod

    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    cam = cam_mod.CameraModel.from_matrix(jnp.asarray(k, jnp.float32),
                                          jnp.zeros(5, jnp.float32))
    scene = synthetic.make_wall_scene(num_markers=args.markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=args.frames)
    obs = synthetic.observe_poses(scene, traj, 64, fov_limit=0.75,
                                  noise_t=0.01, noise_r=0.01, seed=1)
    times = np.arange(args.frames) / 30.0

    cfg = SlamAppConfig(input="", filter="factorgraph",
                        window=args.window,
                        pose_budget=args.pose_budget)

    def run(n):
        return run_factorgraph(cfg, times[:n], obs.t_cl[:n],
                               obs.q_cl[:n], obs.mask[:n], cam)

    # warm the jitted add_frame / optimize_window / marginalize
    # programs on a prefix long enough to hit the marginalization
    # (same static shapes -> same compiled programs in the timed run)
    run(min(args.frames, args.pose_budget + 4))
    t0 = time.perf_counter()
    cam_traj, active, _, _ = run(args.frames)
    dt = time.perf_counter() - t0
    ate = ate_rmse(cam_traj[:, :3], traj.cam_t)

    print(json.dumps({
        "metric": "factorgraph_online_fps",
        "value": round(args.frames / dt, 1),
        "unit": f"frames/s (pose budget {args.pose_budget}, "
                f"window {args.window}, marginalizing)",
        "ate_m": round(float(ate), 4),
        "n_landmarks": int(np.asarray(active).sum()),
        "frames": args.frames,
        **device_fields(),
    }))


if __name__ == "__main__":
    main()
