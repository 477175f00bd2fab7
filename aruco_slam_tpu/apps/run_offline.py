"""Offline two-pass SLAM driver (batch smoothing).

On-device equivalent of the reference's main/run_offline.py: pass 1
ingests every frame into the factor graph, then a full-batch LM solve
smooths the whole trajectory; pass 2 replays for outputs using the
smoothed per-iteration estimates (reference main/run_offline.py:86-142,
filters/factor_graph.py:327-345).

    python -m aruco_slam_tpu.apps.run_offline --input seq.npz

Distributed modes (the reference is single-threaded; this is the
product surface of parallel/dist.py + parallel/sharded_ba.py):

    # one machine, N OS processes joined over jax.distributed (Gloo
    # on CPU, NCCL on GPUs; each process gets ONE card) — the solve
    # runs landmark-sharded over the global mesh, process 0 writes
    python -m aruco_slam_tpu.apps.run_offline --input seq.npz \
        --processes 2 --local-devices 2 --platform cpu

    # cluster: one process per host, each started with --distributed
    # and the SLAM_COORDINATOR / SLAM_NUM_PROCESSES / SLAM_PROCESS_ID
    # env vars; every process drives all cards of its host
    python -m aruco_slam_tpu.apps.run_offline --input seq.npz \
        --distributed

    # fleet of sequences on a 2-D ('data','kf') mesh: each sequence's
    # landmarks shard over kf, sequences are data-parallel
    python -m aruco_slam_tpu.apps.run_offline \
        --input a.npz,b.npz,c.npz,d.npz --fleet 4x2

Pass 1 scales with processes too: image-domain inputs shard the heavy
per-frame candidate pipeline round-robin over processes (the cheap
sequential id->slot scan + PnP replicate bit-identically —
run_slam._observations_from_frames_sharded), and --fleet shards the
per-sequence window-solve ingest with a graph-state all-gather. Only
process 0 touches the filesystem.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from aruco_slam_tpu.config import SlamAppConfig
from aruco_slam_tpu.graph import (
    GraphConfig, add_frame, batch_optimize, init_graph,
    landmark_covariances, optimize_window)
from aruco_slam_tpu.io import TrajectoryWriter, save_map
from aruco_slam_tpu.io.sources import NpzSource
from aruco_slam_tpu.apps.run_slam import (
    _resolve_recycling, load_observations, load_video_observations,
    print_device)
from aruco_slam_tpu.io.sources import is_video


def _launch_processes(args, argv) -> None:
    """--processes N: re-exec this command in N OS processes joined
    over jax.distributed — the one-process-per-host cluster launch
    shape on one machine (transport: Gloo on CPU, NCCL on GPUs). Each
    child sees exactly one GPU (parallel/dist.one_card_env). The
    children inherit every flag except --processes (replaced by
    --distributed) and write outputs from process 0 only."""
    import subprocess
    import sys

    from aruco_slam_tpu.parallel.dist import one_card_env

    src = list(argv) if argv is not None else sys.argv[1:]
    child_argv = []
    skip = False
    for a in src:
        if skip:
            skip = False
            continue
        if a == "--processes":
            skip = True
            continue
        if a.startswith("--processes="):
            continue
        child_argv.append(a)
    if "--distributed" not in child_argv:
        child_argv.append("--distributed")
    procs = []
    for pid in range(args.processes):
        env = dict(os.environ)
        if args.local_devices:
            # the child sizes its own virtual-device pool via
            # --local-devices; an inherited forced count would win
            env.pop("XLA_FLAGS", None)
        env.update(SLAM_COORDINATOR=args.coordinator,
                   SLAM_NUM_PROCESSES=str(args.processes),
                   SLAM_PROCESS_ID=str(pid))
        one_card_env(pid, env)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "aruco_slam_tpu.apps.run_offline"]
            + child_argv, env=env))
    rc = [p.wait() for p in procs]
    if any(rc):
        raise SystemExit(f"distributed workers failed: exit codes {rc}")


def _load_all(cfg: SlamAppConfig, inputs: list[str], calib):
    """Load every input sequence (npz bundles or video files)."""
    import dataclasses
    seqs = []
    for path in inputs:
        c = dataclasses.replace(cfg, input=path)
        if is_video(path):
            src = None
            obs = load_video_observations(c, calib)
        else:
            src = NpzSource(path)
            obs = load_observations(src, c)
        seqs.append((src, _resolve_recycling(obs)))
    return seqs


def _ingest(gcfg: GraphConfig, cfg: SlamAppConfig, t_cl, mask, q_cl,
            with_rotations: bool, checkpoint_every: int = 0,
            checkpoint: str = "", resume: str | None = None,
            is_main: bool = True) -> "GraphState":  # noqa: F821
    """Pass 1: per-frame ingest with a cheap incremental window solve —
    the warm start the reference gets from running ISAM2 during its
    first pass (reference main/run_offline.py:86-94); batch LM from the
    raw zero-motion init stalls far from the optimum."""
    t = t_cl.shape[0]
    state = init_graph(gcfg)
    start = 0
    if resume:
        from aruco_slam_tpu.utils.checkpoint import load_checkpoint
        state, fdone = load_checkpoint(resume, (state, np.int64(0)))
        start = int(fdone)
        if is_main:
            print(f"resumed from {resume} at ingest frame {start}")
    for i in range(start, t):
        state = add_frame(gcfg, state, jnp.asarray(t_cl[i]),
                          jnp.asarray(mask[i]),
                          jnp.asarray(q_cl[i])
                          if with_rotations else None)
        state, _ = optimize_window(gcfg, state, window=cfg.window,
                                   iters=cfg.window_iters)
        if checkpoint_every and is_main and i + 1 < t \
                and (i + 1) % checkpoint_every == 0:
            from aruco_slam_tpu.utils.checkpoint import save_checkpoint
            save_checkpoint(checkpoint, (state, np.int64(i + 1)))
    return state


def _solve(gcfg: GraphConfig, state, iters: int, distributed: bool):
    """Batch LM — landmark-sharded over the global device mesh when a
    distributed runtime (or >1 local device under --distributed) is
    up, identical to the single-device solve up to float reduction
    order (tests/test_dist.py)."""
    if distributed and jax.device_count() > 1:
        from aruco_slam_tpu.parallel import (
            make_mesh, sharded_batch_optimize)
        mesh = make_mesh()
        return sharded_batch_optimize(gcfg, state, mesh, iters=iters)
    return batch_optimize(gcfg, state, iters=iters)


def _seq_path(path: str, i: int, n: int) -> str:
    if n == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}_seq{i}{ext}"


def _write_outputs(args, cfg, gcfg, state, times, t_cl, q_cl, mask,
                   slot_ids, src, cam, seq_i: int = 0, n_seq: int = 1):
    """Pass 2 + persistence for one solved sequence (process 0 only)."""
    t = len(times)
    cam_traj = np.concatenate([np.asarray(state.pose_t),
                               np.asarray(state.pose_q)], axis=1)[:t]
    traj_file = _seq_path(cfg.trajectory_file, seq_i, n_seq)
    map_file = _seq_path(cfg.map_file, seq_i, n_seq)
    with TrajectoryWriter(traj_file) as w:
        for i in range(t):
            w.write(float(times[i]), cam_traj[i])
    if cfg.viz_2d or cfg.viz_3d:
        from aruco_slam_tpu.apps import sinks
        viewers = sinks.build_viewers(cfg, cam, src)
        sinks.replay(viewers, times, cam_traj, state.lm,
                     state.lm_active, t_cl, q_cl, mask,
                     slot_ids=slot_ids)

    active = np.asarray(state.lm_active)
    slots = np.where(active)[0]
    # id->slot table inputs record TRUE marker ids in the map file
    ids = slot_ids[slots] if slot_ids is not None else slots
    cov = np.asarray(landmark_covariances(gcfg, state))
    unc = np.diagonal(cov, axis1=-2, axis2=-1)
    lm_out = np.asarray(state.lm)
    if args.ba_rotations:
        # 7-column records [xyz, quat wxyz] — the layout the
        # reference's rotation filter persists (its 10-dim landmark
        # block, reference filters/ekf_with_rotations.py:38)
        lm_out = np.concatenate([lm_out, np.asarray(state.lm_q)], 1)
    save_map(map_file, ids, lm_out[slots], unc[slots])
    print(f"wrote {traj_file} ({t} poses), "
          f"{map_file} ({len(ids)} landmarks)")
    if src is not None and src.has("gt_cam_t"):
        from aruco_slam_tpu.bench import ate
        est = np.asarray(state.pose_t)[:t]
        print(f"ATE vs ground truth: "
              f"{ate.ate_rmse(est, src['gt_cam_t']):.4f} m")


def _run_fleet(args, cfg: SlamAppConfig, inputs: list[str],
               is_main: bool) -> None:
    """--fleet DATAxKF: solve a fleet of independent sequences on the
    2-D ('data','kf') mesh — each sequence's landmark/factor blocks
    shard over `kf` (per-iteration psums stay on that axis), sequences are
    data-parallel over `data` with zero cross-sequence traffic."""
    from aruco_slam_tpu.parallel import (
        sharded_fleet_optimize, stack_graphs)
    from aruco_slam_tpu.parallel.dist import make_mesh2d

    n_data, n_kf = (int(v) for v in args.fleet.split("x"))
    seqs = _load_all(cfg, inputs, args.calib)
    # common capacities so the problems stack into one fleet array
    max_t = max(len(o[0]) for _, o in seqs)
    max_l = max(o[1].shape[1] for _, o in seqs)
    max_f = max(int(o[3].sum()) for _, o in seqs) + 8
    cam0 = seqs[0][1][4]
    gcfg = GraphConfig(max_poses=max_t + 2, max_landmarks=max_l,
                       max_factors=max_f, pixel_sigma=cfg.pixel_sigma,
                       focal_px=float(cam0.fx),
                       marker_size=cfg.marker_size,
                       huber_delta=cfg.huber_delta,
                       meas_sigma_t=cfg.meas_sigma_t,
                       odom_sigma_t=cfg.odom_sigma_t,
                       odom_sigma_rot=cfg.odom_sigma_rot,
                       with_rotations=args.ba_rotations,
                       dtype=jnp.float64 if args.f64 else jnp.float32)
    for _, o in seqs[1:]:
        if abs(float(o[4].fx) - float(cam0.fx)) > 0.01 * float(cam0.fx):
            print("warning: fleet sequences have different focal "
                  "lengths; using the first camera's for the "
                  "pixel-noise scaling")
            break
    t0 = time.perf_counter()
    nproc = jax.process_count()
    if 1 < nproc <= len(seqs):
        # shard the per-sequence ingest round-robin over processes and
        # all-gather the graph states: pass 1 scales with processes
        # instead of replicating every sequence's ingest everywhere
        from jax.experimental import multihost_utils
        pid = jax.process_index()
        own = [_ingest(gcfg, cfg, o[1], o[3], o[2], args.ba_rotations)
               for i, (_, o) in enumerate(seqs) if i % nproc == pid]
        mmax = -(-len(seqs) // nproc)
        local = stack_graphs(own + [own[0]] * (mmax - len(own)))
        g = multihost_utils.process_allgather(local)  # (P, mmax, ...)
        states = [jax.tree.map(lambda a, i=i: a[i % nproc, i // nproc],
                               g)
                  for i in range(len(seqs))]
    else:
        states = [_ingest(gcfg, cfg, o[1], o[3], o[2],
                          args.ba_rotations)
                  for _, o in seqs]
    fleet = stack_graphs(states)
    mesh = make_mesh2d(n_data=n_data, n_kf=n_kf)
    out, costs = sharded_fleet_optimize(gcfg, fleet, mesh,
                                        iters=cfg.batch_iters)
    jax.block_until_ready(costs)
    dt = time.perf_counter() - t0
    if not is_main:
        return
    print(f"fleet solve: {len(seqs)} sequences on a {n_data}x{n_kf} "
          f"(data x kf) mesh, {cfg.batch_iters} LM iters in {dt:.2f}s")
    for i, (src, o) in enumerate(seqs):
        times, t_cl, q_cl, mask, cam, _amb, slot_ids = o
        seq_state = jax.tree.map(lambda x, i=i: x[i], out)
        _write_outputs(args, cfg, gcfg, seq_state, times, t_cl, q_cl,
                       mask, slot_ids, src, cam, seq_i=i,
                       n_seq=len(seqs))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Offline two-pass marker SLAM (batch smoothing)")
    p.add_argument("--input", required=True,
                   help="sequence bundle (.npz) or video; with "
                        "--fleet, a comma-separated list")
    p.add_argument("--platform", default=None,
                   help="JAX platform override (cpu | gpu); default: "
                        "JAX's own choice")
    p.add_argument("--trajectory", default="outputs/trajectory.txt")
    p.add_argument("--map", dest="map_file", default="outputs/map.txt")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--calib", default=None,
                   help="directory with camera_matrix.npy + "
                        "dist_coeffs.npy (video input)")
    p.add_argument("--ba-rotations", action="store_true",
                   help="6-dof landmarks: smooth marker ORIENTATIONS "
                        "too (graph/ba.py with_rotations; map records "
                        "gain quaternion columns like the reference's "
                        "rotation filter, reference "
                        "filters/ekf_with_rotations.py:33-40)")
    p.add_argument("--viz-2d", action="store_true",
                   help="pass-2 replay through the 2D overlay with the "
                        "smoothed poses (reference "
                        "main/run_offline.py:124-142)")
    p.add_argument("--viz-3d", action="store_true")
    p.add_argument("--viz-3d-renderer", default="mpl",
                   choices=["mpl", "fast"],
                   help="see run_slam --viz-3d-renderer")
    p.add_argument("--viz-dir", default="outputs/images")
    p.add_argument("--export-video", action="store_true")
    dflt = SlamAppConfig(input="")
    p.add_argument("--meas-sigma-t", type=float, default=dflt.meas_sigma_t)
    p.add_argument("--odom-sigma-t", type=float, default=dflt.odom_sigma_t)
    p.add_argument("--odom-sigma-rot", type=float,
                   default=dflt.odom_sigma_rot)
    p.add_argument("--track-every", type=int, default=dflt.track_every,
                   metavar="K",
                   help="streaming detection for image/video input "
                        "(see run_slam --track-every); 0 = full "
                        "detection every frame")
    p.add_argument("--detector", default=dflt.detector,
                   choices=["robust", "fast"],
                   help="full-sweep preset (see run_slam --detector)")
    p.add_argument("--capacity", type=int, default=dflt.capacity,
                   help="detector slot / landmark capacity for "
                        "image-domain inputs (see run_slam "
                        "--capacity)")
    p.add_argument("--slot-max-age", type=int, default=dflt.slot_max_age,
                   metavar="N",
                   help="recycle detector slots unobserved for > N "
                        "frames (see run_slam --slot-max-age); the "
                        "offline solve epoch-splits recycled slots "
                        "into fresh landmark columns, so long "
                        "corridor runs can traverse more distinct "
                        "markers than --capacity")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler device trace of the "
                        "solve to DIR (view with XProf/TensorBoard)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   metavar="N",
                   help="persist the graph + ingest index every N "
                        "pass-1 frames (0 = off); a killed run "
                        "resumes instead of re-ingesting everything")
    p.add_argument("--checkpoint", default="outputs/checkpoint.npz",
                   help="checkpoint file path")
    p.add_argument("--resume", default=None,
                   help="resume pass 1 from a checkpoint (bit-exact, "
                        "tests/test_io_apps.py); a checkpoint taken "
                        "after ingest completed skips straight to the "
                        "batch solve")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process JAX runtime "
                        "(jax.distributed, wired by the "
                        "SLAM_COORDINATOR / SLAM_NUM_PROCESSES / "
                        "SLAM_PROCESS_ID env vars) and run "
                        "the batch solve landmark-sharded over the "
                        "GLOBAL device mesh; process 0 writes outputs")
    p.add_argument("--processes", type=int, default=0, metavar="N",
                   help="single-machine launcher: start N OS "
                        "processes joined over jax.distributed (Gloo "
                        "on CPU, NCCL on GPUs; one card per process) "
                        "each re-running this command — the "
                        "one-process-per-host cluster launch shape")
    p.add_argument("--local-devices", type=int, default=None,
                   metavar="M",
                   help="virtual devices contributed per process on "
                        "the CPU backend (with --processes / "
                        "--distributed)")
    p.add_argument("--coordinator", default="127.0.0.1:29791",
                   help="coordinator address for --processes")
    p.add_argument("--fleet", default=None, metavar="DATAxKF",
                   help="solve a FLEET of sequences (comma-separated "
                        "--input) on a 2-D ('data','kf') mesh: "
                        "sequences data-parallel over DATA devices, "
                        "each landmark-sharded over KF; outputs get "
                        "_seqI suffixes (visualization is per-"
                        "sequence: re-run one sequence with --viz-2d)")
    p.add_argument("--f64", action="store_true",
                   help="solve in float64 (accuracy mode; also makes "
                        "sharded and single-device solves agree to "
                        "~1e-7 instead of float32 reduction noise)")
    args = p.parse_args(argv)
    if args.track_every and args.track_every < 3:
        p.error("--track-every needs K >= 3")
    inputs = args.input.split(",")
    if len(inputs) > 1 and not args.fleet:
        p.error("multiple --input sequences need --fleet DATAxKF")
    if args.fleet and (args.viz_2d or args.viz_3d or args.export_video):
        p.error("--fleet is a batch-production mode; re-run a single "
                "sequence with --viz-2d/--viz-3d to visualize it")
    if args.fleet and (args.checkpoint_every or args.resume):
        p.error("--fleet does not checkpoint (per-sequence ingest is "
                "cheap; checkpoint single-sequence runs)")
    if args.processes:
        return _launch_processes(args, argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    if args.distributed:
        from aruco_slam_tpu.parallel import dist
        dist.initialize(local_devices=args.local_devices)
    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    is_main = jax.process_index() == 0
    if is_main:
        print_device()

    cfg = SlamAppConfig(input=args.input,
                        trajectory_file=args.trajectory,
                        map_file=args.map_file, batch_iters=args.iters,
                        meas_sigma_t=args.meas_sigma_t,
                        odom_sigma_t=args.odom_sigma_t,
                        odom_sigma_rot=args.odom_sigma_rot,
                        viz_2d=args.viz_2d, viz_3d=args.viz_3d,
                        viz_3d_renderer=args.viz_3d_renderer,
                        viz_dir=args.viz_dir,
                        export_video=args.export_video,
                        track_every=args.track_every,
                        detector=args.detector,
                        capacity=args.capacity,
                        slot_max_age=args.slot_max_age)
    if args.fleet:
        return _run_fleet(args, cfg, inputs, is_main)

    # under a multi-process runtime, shard the image-domain candidate
    # pipeline round-robin over processes (the sequential slot scan +
    # PnP replicate; observations come out bit-identical) — the whole
    # ingest scales, not just the LM solve
    shard = ((jax.process_index(), jax.process_count())
             if args.distributed and jax.process_count() > 1 else None)
    if is_video(cfg.input):
        src = None
        obs = load_video_observations(cfg, args.calib, shard=shard)
    else:
        src = NpzSource(cfg.input)
        obs = load_observations(src, cfg, shard=shard)
    times, t_cl, q_cl, mask, cam, _amb, slot_ids = \
        _resolve_recycling(obs)

    t = len(times)
    gcfg = GraphConfig(max_poses=t + 2, max_landmarks=t_cl.shape[1],
                       max_factors=int(mask.sum()) + 8,
                       pixel_sigma=cfg.pixel_sigma,
                       focal_px=float(cam.fx),
                       marker_size=cfg.marker_size,
                       huber_delta=cfg.huber_delta,
                       meas_sigma_t=cfg.meas_sigma_t,
                       odom_sigma_t=cfg.odom_sigma_t,
                       odom_sigma_rot=cfg.odom_sigma_rot,
                       with_rotations=args.ba_rotations,
                       dtype=jnp.float64 if args.f64 else jnp.float32)
    from aruco_slam_tpu.utils.profiling import device_trace
    t0 = time.perf_counter()
    with device_trace(args.profile):
        state = _ingest(gcfg, cfg, t_cl, mask, q_cl,
                        args.ba_rotations,
                        checkpoint_every=args.checkpoint_every,
                        checkpoint=args.checkpoint, resume=args.resume,
                        is_main=is_main)
        state, cost = _solve(gcfg, state, cfg.batch_iters,
                             args.distributed)
        # sync INSIDE the trace (and before reading the clock): the
        # solve dispatches asynchronously, so without this the trace
        # stops and dt is read while the device is still solving
        jax.block_until_ready(cost)
    dt = time.perf_counter() - t0
    if not is_main:
        return
    where = f"{jax.device_count()} devices x " \
            f"{jax.process_count()} processes" \
        if args.distributed else "1 device"
    print(f"batch solve: {t} poses, {int(state.f_count)} factors, "
          f"{cfg.batch_iters} LM iters on {where} in {dt:.2f}s "
          f"(final cost {float(cost):.3f})")
    _write_outputs(args, cfg, gcfg, state, times, t_cl, q_cl, mask,
                   slot_ids, src, cam)


if __name__ == "__main__":
    main()
