"""Multi-device scaling-efficiency harness for the sharded BA solver.

Measures `parallel.sharded_batch_optimize` wall time across mesh sizes
and reports strong-scaling efficiency — the harness behind the north
star's >=70% multi-host target. On real multi-chip hardware run it
as-is; on a single-chip/dev box run it on virtual CPU devices first:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m aruco_slam_tpu.bench.scaling --platform cpu

Each row also carries the quantities that make a future multi-chip run
interpretable in one command (virtual CPU devices share host cores, so
the CPU *efficiency* column validates mechanics only):

* ``factors_per_device`` — per-shard factor capacity after the
  landmark repartition (work balance),
* ``psum_bytes_per_iter`` — exact per-device collective volume of one
  LM iteration (pose blocks + partial Schur + cost scalars; it is
  O(T²), independent of landmarks/factors by design),
* ``collective_s`` / ``collective_frac`` — measured time of JUST the
  collectives: a shard_map program psum-ing the same-shaped buffers
  the solver psums, iterated the same number of times on the same
  mesh. compute_s = seconds − collective_s.

Prints one JSON line per mesh size.
"""

from __future__ import annotations

import argparse
import functools
import json
import time


def _collective_microbench(mesh, axis, tcap, iters, reps, dtype):
    """Time `iters` rounds of the solver's exact psum set on `mesh`."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    t6 = tcap * 6

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P(),
                       out_specs=P())
    def run(x):
        def body(i, carry):
            diag, g_p, s, g_s, c = carry
            # the three psum rounds of one LM iteration
            diag, g_p, c1 = jax.lax.psum((diag, g_p, c), axis)
            s, g_s = jax.lax.psum((s, g_s), axis)
            c2 = jax.lax.psum(c1, axis)
            return (diag + i, g_p, s, g_s, c2 * 1e-30)

        diag = jnp.zeros((tcap, 6, 6), dtype) + x
        g_p = jnp.zeros((tcap, 6), dtype)
        s = jnp.zeros((t6, t6), dtype)
        g_s = jnp.zeros(t6, dtype)
        carry = jax.lax.fori_loop(
            0, iters, body, (diag, g_p, s, g_s, x[0]))
        return carry[0][:1, :1, 0] + carry[2][:1, 0]

    x = jnp.ones((1,), dtype)
    jax.block_until_ready(run(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(run(x))
    return (time.perf_counter() - t0) / reps


def run(mesh_sizes, frames=256, markers=32, iters=10, reps=3):
    import jax
    import jax.numpy as jnp

    from aruco_slam_tpu.parallel import make_mesh, sharded_batch_optimize
    from aruco_slam_tpu.parallel.sharded_ba import _shard_capacity

    cfg, state = _build_problem(frames, markers)
    tcap = cfg.max_poses
    t6 = tcap * 6
    itemsize = jnp.dtype(cfg.dtype).itemsize
    # per-iteration psum payload: (diag, g_p, cost) + (S, g_S) + cost
    psum_bytes = itemsize * (tcap * 36 + tcap * 6 + 1
                             + t6 * t6 + t6 + 1)

    results = []
    base_dt = None
    for n in mesh_sizes:
        if n > jax.device_count():
            break
        mesh = make_mesh(n)
        out, _ = sharded_batch_optimize(cfg, state, mesh, iters=iters)
        jax.block_until_ready(out.pose_t)  # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out, _ = sharded_batch_optimize(cfg, state, mesh,
                                            iters=iters)
            jax.block_until_ready(out.pose_t)
        dt = (time.perf_counter() - t0) / reps
        if base_dt is None:
            base_dt = dt
        # LM runs 2 linearization+cost passes/iter worth of psums;
        # the collective microbench models the psum set per iteration
        coll = 0.0 if n == 1 else _collective_microbench(
            mesh, mesh.axis_names[0], tcap, iters, reps, cfg.dtype)
        eff = base_dt / (dt * n)
        row = {"devices": n, "seconds": round(dt, 4),
               "speedup": round(base_dt / dt, 3),
               "efficiency": round(eff, 3),
               "factors_per_device": _shard_capacity(cfg, state, n),
               "psum_bytes_per_iter": psum_bytes,
               "collective_s": round(coll, 4),
               "collective_frac": round(coll / dt, 3) if dt else 0.0}
        if jax.default_backend() == "cpu":
            # virtual devices time-share the same host cores, so the
            # "speedup" column is meaningless there by construction
            row["note"] = ("virtual CPU devices share host cores: "
                           "validates collective layout/mechanics, "
                           "NOT speedup — run on a real multi-chip "
                           "slice for efficiency numbers")
        results.append(row)
        print(json.dumps(row))
    return results


def _build_problem(frames, markers):
    import jax.numpy as jnp

    from aruco_slam_tpu.bench import synthetic
    from aruco_slam_tpu.graph import GraphConfig, add_frame, init_graph

    cfg = GraphConfig(max_poses=frames + 2, max_landmarks=markers,
                      max_factors=frames * (markers // 2),
                      meas_sigma_t=0.01, odom_sigma_t=1.0,
                      odom_sigma_rot=1.0)
    scene = synthetic.make_wall_scene(num_markers=markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    obs = synthetic.observe_poses(scene, traj, cfg.max_landmarks,
                                  noise_t=0.005, fov_limit=0.9)
    state = init_graph(cfg)
    for i in range(frames):
        state = add_frame(cfg, state, jnp.asarray(obs.t_cl[i]),
                          jnp.asarray(obs.mask[i]))
    return cfg, state


def run_worker(frames, markers, iters, reps, local_devices):
    """One process of a multi-process run. The SLAM_* env vars carry
    the coordinator/rank (parallel/dist.initialize reads them); this
    is exactly the one-process-per-host cluster launch shape — only
    the transport (Gloo here, NCCL between GPU hosts) differs."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from aruco_slam_tpu.parallel import dist
    dist.initialize(local_devices=local_devices)
    from aruco_slam_tpu.parallel import make_mesh, \
        sharded_batch_optimize

    cfg, state = _build_problem(frames, markers)
    mesh = make_mesh()  # global: all devices across all processes
    out, _ = sharded_batch_optimize(cfg, state, mesh, iters=iters)
    jax.block_until_ready(out.pose_t)
    t0 = time.perf_counter()
    for _ in range(reps):
        out, _ = sharded_batch_optimize(cfg, state, mesh, iters=iters)
        jax.block_until_ready(out.pose_t)
    dt = (time.perf_counter() - t0) / reps
    if jax.process_index() == 0:
        print(json.dumps({
            "devices": jax.device_count(),
            "processes": jax.process_count(),
            "seconds": round(dt, 4),
            "note": "multi-PROCESS run (Gloo on CPU): validates the "
                    "pod launch shape + cross-process collectives; "
                    "efficiency numbers need real chips"}),
            flush=True)


def run_fleet(n_data, n_kf, frames, markers, iters, reps):
    """Bench the 2-D ('data','kf') mesh: a fleet of n_data independent
    BA problems, each landmark-sharded over n_kf devices."""
    import jax

    from aruco_slam_tpu.parallel import (
        make_mesh2d, sharded_fleet_optimize, stack_graphs)

    cfg, state = _build_problem(frames, markers)
    fleet = stack_graphs([state] * n_data)
    mesh = make_mesh2d(n_data=n_data, n_kf=n_kf)
    out, costs = sharded_fleet_optimize(cfg, fleet, mesh, iters=iters)
    jax.block_until_ready(costs)
    t0 = time.perf_counter()
    for _ in range(reps):
        out, costs = sharded_fleet_optimize(cfg, fleet, mesh,
                                            iters=iters)
        jax.block_until_ready(costs)
    dt = (time.perf_counter() - t0) / reps
    row = {"mesh": f"{n_data}x{n_kf} (data x kf)",
           "problems": n_data, "seconds": round(dt, 4),
           "problems_per_s": round(n_data / dt, 3)}
    if jax.default_backend() == "cpu":
        row["note"] = ("virtual CPU devices share host cores: "
                       "validates the 2-D layout, not speedup")
    print(json.dumps(row))
    return row


def _build_image_bundle(frames):
    """Deterministic small image sequence every ingest process can
    rebuild identically (no filesystem coordination needed)."""
    import numpy as np

    from aruco_slam_tpu.apps import make_synthetic
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    return make_synthetic.build(
        frames=frames, markers=8, capacity=16, noise_px=0.2, seed=0,
        camera_matrix=k, dist_coeffs=np.zeros(5), with_images=True,
        image_size=(720, 405))


def _ingest_once(bundle, shard, reps: int = 3):
    """Timed pass of the image front end (detection + slot scan +
    PnP). Returns the MIN of `reps` post-compile runs (the 2-core dev
    host schedules noisily; min rejects cross-process interference)."""
    import jax.numpy as jnp

    from aruco_slam_tpu.apps.run_slam import (
        _observations_from_frames, _observations_from_frames_sharded)
    from aruco_slam_tpu.config import SlamAppConfig
    from aruco_slam_tpu.core import camera as cam_mod

    cfg = SlamAppConfig(input="", capacity=16)
    cfg.marker_size = float(bundle["marker_size"])
    cam = cam_mod.CameraModel.from_matrix(
        jnp.asarray(bundle["camera_matrix"]),
        jnp.asarray(bundle["dist_coeffs"]))
    imgs, times = bundle["images"], bundle["times"]

    def go():
        if shard:
            return _observations_from_frames_sharded(
                zip(times, imgs), cam, cfg, shard[0], shard[1],
                total=len(imgs))
        return _observations_from_frames(zip(times, imgs), cam, cfg)

    go()  # compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        go()
        best = min(best, time.perf_counter() - t0)
    return best


def run_ingest_worker(frames, local_devices):
    """One process of the sharded-ingest measurement. Pinned to one
    host core (os.sched_setaffinity) so N processes use N cores — on
    this shared-core dev host that is the honest analog of N hosts."""
    import os

    import jax
    jax.config.update("jax_platforms", "cpu")
    from aruco_slam_tpu.parallel import dist
    dist.initialize(local_devices=local_devices)
    pid, nproc = jax.process_index(), jax.process_count()
    want = int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    assert nproc == want, \
        f"worker joined {nproc} processes, expected {want}"
    try:
        os.sched_setaffinity(0, {pid % os.cpu_count()})
    except (AttributeError, OSError):
        pass
    bundle = _build_image_bundle(frames)
    dt = _ingest_once(bundle, (pid, nproc))
    if pid == 0:
        print(json.dumps({"ingest_seconds": round(dt, 4),
                          "processes": nproc, "frames": frames}),
              flush=True)


def run_ingest(nproc, frames, local_devices, port=29781):
    """Ingest-throughput scaling row (VERDICT r3 #5): the image-domain
    front end (full per-frame candidate detection) sharded over N
    processes vs 1, same core budget per process. Detection is
    per-frame independent, so wall time should drop ~linearly.

    Every measurement (including the 1-process baseline) runs in a
    FRESH worker subprocess and the launcher never initializes JAX: a
    co-resident idle XLA:CPU runtime measurably halves the workers'
    throughput on this shared-core host."""
    import os
    import subprocess
    import sys

    env_base = {k: v for k, v in os.environ.items()
                if k != "XLA_FLAGS"}

    def launch(n, portoff):
        procs = []
        for pid in range(n):
            env = dict(env_base)
            # workers run the CPU backend by design (virtual devices,
            # one pinned core each): hide every card from them
            env["CUDA_VISIBLE_DEVICES"] = ""
            if n > 1:
                env.update(SLAM_COORDINATOR=f"127.0.0.1:{port+portoff}",
                           SLAM_NUM_PROCESSES=str(n),
                           SLAM_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "aruco_slam_tpu.bench.scaling",
                 "--ingest-worker", "--frames", str(frames),
                 "--local-devices", str(local_devices)],
                env=env, stdout=subprocess.PIPE, text=True))
        outs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise SystemExit("ingest workers failed")
        return next(json.loads(ln) for ln in outs[0].splitlines()
                    if ln.startswith("{"))["ingest_seconds"]

    base = launch(1, 0)
    sharded = launch(nproc, 1)
    row = {"metric": "sharded_ingest_scaling",
           "frames": frames,
           "ingest_1proc_s": round(base, 4),
           f"ingest_{nproc}proc_s": round(sharded, 4),
           "speedup": round(base / sharded, 3) if sharded else 0.0,
           "efficiency": round(base / (sharded * nproc), 3)
           if sharded else 0.0,
           "note": "each process pinned to one host core: N "
                   "processes = N cores, the honest single-machine "
                   "analog of N hosts"}
    print(json.dumps(row))
    return row


def run_multiprocess(nproc, frames, markers, iters, reps,
                     local_devices=2, port=29777):
    import os
    import subprocess
    import sys

    procs = []
    for pid in range(nproc):
        env = {k: v for k, v in os.environ.items()
               if k != "XLA_FLAGS"}
        env["CUDA_VISIBLE_DEVICES"] = ""  # CPU-backend workers
        env.update(SLAM_COORDINATOR=f"127.0.0.1:{port}",
                   SLAM_NUM_PROCESSES=str(nproc),
                   SLAM_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "aruco_slam_tpu.bench.scaling",
             "--worker", "--frames", str(frames),
             "--markers", str(markers), "--iters", str(iters),
             "--reps", str(reps),
             "--local-devices", str(local_devices)], env=env))
    rc = [p.wait() for p in procs]
    if any(rc):
        raise SystemExit(f"worker exit codes {rc}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--platform", default=None)
    p.add_argument("--sizes", default="1,2,4,8")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--markers", type=int, default=32)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--processes", type=int, default=0,
                   help="launch N OS processes joined with "
                        "jax.distributed (the multi-host shape) "
                        "instead of the single-process device sweep")
    p.add_argument("--local-devices", type=int, default=2)
    p.add_argument("--fleet", default=None, metavar="DATAxKF",
                   help="bench the 2-D mesh instead, e.g. --fleet 4x2 "
                        "= 4 data-parallel problems, each landmark-"
                        "sharded over 2 devices")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--ingest", type=int, default=0, metavar="N",
                   help="measure the sharded IMAGE-INGEST front end "
                        "(detection round-robin over N processes) "
                        "against the 1-process baseline at the same "
                        "per-process core budget")
    p.add_argument("--ingest-worker", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.ingest_worker:
        run_ingest_worker(args.frames, args.local_devices)
        return
    if args.ingest:
        run_ingest(args.ingest, min(args.frames, 64),
                   args.local_devices)
        return
    if args.worker:
        run_worker(args.frames, args.markers, args.iters, args.reps,
                   args.local_devices)
        return
    if args.processes:
        run_multiprocess(args.processes, args.frames, args.markers,
                         args.iters, args.reps, args.local_devices)
        return
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.fleet:
        n_data, n_kf = (int(v) for v in args.fleet.split("x"))
        run_fleet(n_data, n_kf, args.frames, args.markers,
                  args.iters, args.reps)
        return
    sizes = [int(s) for s in args.sizes.split(",")]
    run(sizes, frames=args.frames, iters=args.iters)


if __name__ == "__main__":
    main()
