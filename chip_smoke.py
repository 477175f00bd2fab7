#!/usr/bin/env python3
"""Smoke test of the marker-SLAM main path on NVIDIA GPUs.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only

One process drives the card(s). Frames are rendered once, at the
reference's video size (1920x1080, 12 markers, seeds 0/1), into .npz
bundles under outputs/chip_smoke/ and shared by every phase, which then
drives the system through its own entry points (apps.run_slam.main,
apps.run_offline.main, bench/large_map.main) and the library calls they
are made of. Every phase is checked against a plain reference — the
same program on the CPU backend of this process, a single-device run,
or the rendered ground truth — with the tolerance stated beside it.

One card: precision probe, detection parity (GPU vs CPU), XLA stage
timings, corners->pose (GPU vs CPU), run_slam in three configurations,
run_offline, the 512-marker survey. Four cards (--four, and nothing
else): landmark-sharded BA vs single-device BA, run_offline --fleet 2x2
vs per-sequence solves, 4-stream serving sharded over the cards vs the
per-stream runs.

Every timing line ends with the card name and power limit. The last
line of standard output is one JSON object, printed only when every
phase passed; otherwise the exit code is 1. Without a GPU, or outside a
checkout of the repo, the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "outputs" / "chip_smoke"

# --- tolerances -----------------------------------------------------------
# Detection, GPU vs CPU: both backends run the same f32 program; they
# differ in reduction order, fused multiply-adds and transcendental
# approximations (measured 2e-6 px on an H100). 0.05 px is far below
# the detector's own corner error (tenths of a px against the rendered
# truth) yet catches any real divergence (a different refinement
# window or candidate moves a corner by a pixel or more).
CORNER_TOL_PX = 0.05
# Corners->pose, GPU vs CPU, at matmul_precision="highest": PnP and the
# MEKF are f32 end to end and differ only in rounding, which 512
# filtered frames amplify to ~1e-4 m (measured on an H100). 1 mm bounds
# that with margin and stays far under the centimetres of PnP depth
# noise that a real divergence (TF32 in the gain chain, a wrong
# solver) shows.
POSE_TOL_M = 1e-3
# run_slam / run_offline ATE against the rendered ground truth (m): PnP
# depth noise at 1080p puts ATE at a few cm (0.021-0.062 m measured on
# an H100), and a broken stage (lost markers, diverged filter) at
# decimeters or more.
APP_ATE_MAX_M = 0.1
# the 512-marker survey at its standard size, "highest" precision
SURVEY_ATE_MAX_M = 0.1
# sharded vs single-device BA on four cards: identical math, only f32
# reduction order differs (psums across cards); measured ~1e-6 m
SHARD_TOL_M = 1e-3
# 4-stream serving vs single-stream runs: the vmapped and partitioned
# programs round differently in f32 through detection, PnP and 64
# filter steps — measured up to 1.8 mm on these sequences on CPU
# virtual devices (vmapped-vs-single and sharded-vs-unsharded alike),
# 0.9 mm on four H100s.
# 5 mm is still 20x under APP_ATE_MAX_M; a mis-sharded stream (wrong
# frames, lost tables) is off by decimeters.
SERVE_TOL_M = 5e-3

FRAMES = 128     # frames per rendered bundle
MARKERS = 12
CAPACITY = 64


class Smoke:
    """Phase runner: prints tagged lines, records failed phases."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def line(self, msg: str) -> None:
        print(f"{msg}  [{self.card}]", flush=True)

    def phase(self, name: str, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(self, *args)
        except Exception:  # noqa: BLE001 — recorded, fails the run
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name}: FAILED", flush=True)
            return None
        print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s wall)",
              flush=True)
        return out

    def compiled(self, name: str, fn, *args, reps: int = 3,
                 frames: int | None = None):
        """Compile `fn` ahead of time, then time it
        (bench/pipeline.compile_and_time); one line with compile
        seconds, run seconds, frames/s and the compiled memory
        analysis. Returns the output."""
        from aruco_slam_tpu.bench.pipeline import compile_and_time
        r = compile_and_time(fn, args, reps)
        rate = f", {frames / r.run_s:.1f} frames/s" if frames else ""
        mem = r.memory
        self.line(f"time {name}: compile {r.compile_s:.2f} s, run "
                  f"{1e3 * r.run_s:.3f} ms/call{rate}; memory temp "
                  f"{mem.temp_size_in_bytes / 2**20:.1f} MiB, args "
                  f"{mem.argument_size_in_bytes / 2**20:.1f} MiB, out "
                  f"{mem.output_size_in_bytes / 2**20:.1f} MiB")
        return r.out


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def require_gpu():
    """The first device must be a GPU: this script measures nothing
    on any other backend."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{dev.platform} ({dev.device_kind})")
    return dev


def card_info() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def camera():
    import jax.numpy as jnp
    import numpy as np

    from aruco_slam_tpu.core import camera as cam_mod
    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    d = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    return cam_mod.CameraModel.from_matrix(jnp.asarray(k, jnp.float32),
                                           jnp.asarray(d, jnp.float32))


# --- shared data ----------------------------------------------------------

def render_bundles(sm: Smoke, frames: int = FRAMES,
                   image_size=(1920, 1080)) -> dict:
    """Two rendered .npz bundles: "orbit" (one whole orbit, seed 0) and
    "video" (video-rate motion, seed 1, what --track-every expects)."""
    from aruco_slam_tpu.apps import make_synthetic
    from aruco_slam_tpu.io import sources

    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, seed, orbit in (("orbit", 0, None),
                              ("video", 1, 10 * frames)):
        t0 = time.perf_counter()
        b = make_synthetic.build(frames=frames, markers=MARKERS,
                                 capacity=CAPACITY, seed=seed,
                                 with_images=True, image_size=image_size,
                                 orbit_frames=orbit)
        paths[name] = OUT / f"{name}.npz"
        sources.save_npz(paths[name], **b)
        print(f"rendered {name}: {frames} frames "
              f"{image_size[0]}x{image_size[1]} in "
              f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return paths


def load(path):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def traj_ate(traj_file, gt_t) -> float:
    from aruco_slam_tpu.bench.ate import ate_rmse
    from aruco_slam_tpu.io import read_trajectory
    _, poses = read_trajectory(traj_file)
    return ate_rmse(poses[:, :3], gt_t[:len(poses)])


# --- one-card phases ------------------------------------------------------

def precision_probe(sm: Smoke) -> None:
    """What each matmul precision name gives on this device: relative
    error of a 1024^3 f32 product against float64 numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(0)
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    for name in ("highest", "high", "default"):
        with jax.default_matmul_precision(name):
            got = np.asarray(jax.jit(jnp.matmul)(a, b), np.float64)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        print(f"precision {name!r}: max rel error {err:.2e}", flush=True)


def detection_parity(sm: Smoke, paths, n: int = 8) -> None:
    """Robust 3-pass detector on `n` frames, GPU vs this process's CPU
    backend: identical id sets per frame, corners within
    CORNER_TOL_PX."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aruco_slam_tpu.ops import detect

    b = load(paths["orbit"])
    ims = b["images"][:n]
    cfg = detect.DetectorConfig(capacity=CAPACITY)
    fn = lambda x: detect.detect_markers_batch(x, cfg)[:2]  # noqa: E731
    gpu = sm.compiled(f"detect robust 3-pass x{n} frames", fn,
                      jnp.asarray(ims), frames=n)
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = jax.jit(fn)(jax.device_put(ims, cpu_dev))
    gc, gm = (np.asarray(a) for a in gpu)
    cc, cm = (np.asarray(a) for a in cpu)
    for f in range(n):
        check((gm[f] == cm[f]).all(),
              f"frame {f}: GPU ids {np.where(gm[f])[0].tolist()} vs "
              f"CPU ids {np.where(cm[f])[0].tolist()}")
    d = float(np.abs(gc - cc)[gm].max()) if gm.any() else 0.0
    truth = b["corner_mask"][:n]
    recall = gm.sum() / max(int(truth.sum()), 1)
    print(f"detection parity: {int(gm.sum())} markers in {n} frames, "
          f"same ids, max |corner GPU - CPU| {d:.2e} px (tol "
          f"{CORNER_TOL_PX}); recall vs rendered truth {recall:.3f}",
          flush=True)
    check(d <= CORNER_TOL_PX, f"corner mismatch {d} px")


def stage_timings(sm: Smoke, paths, batch: int = 16) -> None:
    """The plain XLA stages the removed hand-written kernels shadowed —
    each labelling pass, subpixel refinement, the MEKF update with
    both innovation solvers — as shares of the robust image->pose frame
    time. Repetitions on device (bench/pipeline.time_loop)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aruco_slam_tpu.bench.pipeline import make_pipeline, time_loop
    from aruco_slam_tpu.filters import (
        FrameObservations, MekfConfig, init_state, mekf_scan)
    from aruco_slam_tpu.ops import detect, pnp

    b = load(paths["orbit"])
    ims = jnp.asarray(b["images"])
    t = ims.shape[0]
    cam = camera()
    dcfg = detect.DetectorConfig(capacity=CAPACITY)
    fcfg = MekfConfig(capacity=CAPACITY)
    state0 = init_state(fcfg)
    ms = float(b["marker_size"])

    def e2e(images):
        det = jax.lax.map(lambda x: detect.detect_markers_batch(x, dcfg),
                          images.reshape(t // batch, batch,
                                         *images.shape[1:]))
        cs = det.corners.reshape(t, CAPACITY, 4, 2)
        mk = det.mask.reshape(t, CAPACITY)
        return make_pipeline(cam, ms, fcfg, chunk=batch)(state0, cs,
                                                         mk)[1]

    frame_s = time_loop(e2e, (ims,), 2) / t
    sm.line(f"time robust image->pose (detect + PnP + MEKF, {t} frames, "
            f"reps on device): {1e3 * frame_s:.3f} ms/frame, "
            f"{1 / frame_s:.1f} frames/s")
    sm.compiled(f"robust image->pose x{t} frames (host dispatch)", e2e,
                ims, frames=t)

    def share(name, secs):
        sm.line(f"stage {name}: {1e3 * secs:.4f} ms/frame = "
                f"{100 * secs / frame_s:.1f}% of the robust frame")

    # labelling passes at the robust sweep's real shapes and budgets
    # (_detect_candidates: two coarse passes at downscale 4, one fine
    # at 2). The flood runs a fixed schedule of stencil rounds and
    # scans, so its cost does not depend on the mask's content.
    rng = np.random.default_rng(0)
    for name, (h, w), iters, n_pass in (
            ("label coarse 270x480 (x2 passes)", (270, 480),
             dcfg.prop_iters, 2),
            ("label fine 540x960", (540, 960),
             max(16, dcfg.prop_iters // 2), 1)):
        fg = jnp.asarray(rng.random((batch, h, w)) < 0.3)
        label = jax.vmap(lambda m, it=iters: detect._connected_components(
            m, it, dcfg.scan_rounds))
        share(name, n_pass * time_loop(label, (fg,), 4) / batch)
    # subpixel refinement: 3 passes x K candidates x 4 corners per frame
    n_corners = 3 * dcfg.max_candidates * 4
    seeds = jnp.asarray(rng.uniform([20, 20], [1900, 1060],
                                    (batch, n_corners, 2)), jnp.float32)
    sched = ((dcfg.subpix_win, dcfg.subpix_iters), (3, 4))
    secs = time_loop(jax.vmap(lambda im, c: detect._subpix_refine(
        im, c, sched)), (ims[:batch], seeds), 4) / batch
    share(f"subpixel refine ({n_corners} corners)", secs)
    # MEKF update (predict + activate + update), both solvers
    det = jax.jit(detect.detect_markers_batch, static_argnums=1)(
        ims, dcfg)
    res = pnp.solve_square_pnp(cam, det.corners, ms)
    obs = FrameObservations(res.t_cl, res.q_cl,
                            det.mask & (res.err < 3.0))
    for solver in ("cho", "ns"):
        cfg = fcfg._replace(s_solver=solver, max_obs=16)
        secs = time_loop(lambda o, c=cfg: mekf_scan(c, init_state(c),
                                                    o)[1],
                         (obs,), 4) / t
        share(f"MEKF update s_solver={solver!r}", secs)


def corners_to_pose(sm: Smoke, frames: int = 512, batch: int = 256,
                    cpu_members: int = 2) -> None:
    """bench.py's headline shape at matmul_precision="highest": 512
    frames single-stream (Cholesky) and 256 sequences batched
    (Newton-Schulz), GPU trajectories against the same programs on
    the CPU backend (first `cpu_members` batch members)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aruco_slam_tpu.bench import synthetic
    from aruco_slam_tpu.bench.pipeline import make_pipeline
    from aruco_slam_tpu.filters import MekfConfig, init_state

    cam = camera()
    scene = synthetic.make_wall_scene(num_markers=8, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    corners, mask = synthetic.observe_corners(
        scene, traj, cam, CAPACITY, noise_px=0.3, seed=1)
    rng = np.random.default_rng(7)
    corners_b = (corners[None] + rng.normal(
        0, 0.3, (batch,) + corners.shape)).astype(np.float32)
    mask_b = np.broadcast_to(mask, (batch,) + mask.shape)
    fcfg = MekfConfig(capacity=CAPACITY, matmul_precision="highest")
    fcfg_b = fcfg._replace(s_solver="ns")
    state0 = init_state(fcfg)
    single = lambda c, m: make_pipeline(  # noqa: E731
        cam, scene.marker_size, fcfg, chunk=64)(state0, c, m)[1]
    batched = jax.vmap(lambda c, m: make_pipeline(
        cam, scene.marker_size, fcfg_b, chunk=64)(state0, c, m)[1])
    c32 = corners.astype(np.float32)
    g1 = np.asarray(sm.compiled(
        f"corners->pose single stream x{frames}", single,
        jnp.asarray(c32), jnp.asarray(mask), frames=frames))
    gb = np.asarray(sm.compiled(
        f"corners->pose batched {batch}x{frames}", batched,
        jnp.asarray(corners_b), jnp.asarray(mask_b),
        frames=batch * frames, reps=2))
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        put = lambda a: jax.device_put(a, cpu_dev)  # noqa: E731
        c1 = np.asarray(jax.jit(single)(put(c32), put(mask)))
        cb = np.asarray(jax.jit(batched)(
            put(corners_b[:cpu_members]), put(mask_b[:cpu_members])))
    d1 = float(np.abs(g1[:, :3] - c1[:, :3]).max())
    db = float(np.abs(gb[:cpu_members, :, :3] - cb[:, :, :3]).max())
    from aruco_slam_tpu.bench.ate import ate_rmse
    ate = ate_rmse(g1[:, :3], traj.cam_t)
    print(f"corners->pose: max |dt| GPU vs CPU single {d1:.2e} m, "
          f"batched {db:.2e} m (tol {POSE_TOL_M}); single-stream ATE "
          f"{ate:.4f} m", flush=True)
    check(np.isfinite(gb).all(), "non-finite batched trajectory")
    check(max(d1, db) <= POSE_TOL_M, f"pose mismatch {d1}, {db}")


def run_slam_phases(sm: Smoke, paths) -> None:
    """run_slam on the rendered 1080p bundles: --filter
    mekf_rotations, --track-every 8 on video-rate frames, and 2-stream
    serving. Each writes its TUM trajectory + map; ATE is bounded."""
    from aruco_slam_tpu.apps import run_slam

    orbit, video = (load(paths[k]) for k in ("orbit", "video"))
    runs = (("mekf_rotations", [str(paths["orbit"])],
             ["--filter", "mekf_rotations"], [orbit]),
            ("track_every_8", [str(paths["video"])],
             ["--track-every", "8"], [video]),
            ("two_streams", [str(paths["orbit"]), str(paths["video"])],
             [], [orbit, video]))
    for name, inputs, extra, gts in runs:
        traj = OUT / f"slam_{name}.txt"
        t0 = time.perf_counter()
        run_slam.main(["--input", ",".join(inputs), "--trajectory",
                       str(traj), "--map", str(OUT / f"map_{name}.txt")]
                      + extra)
        wall = time.perf_counter() - t0
        files = ([traj] if len(inputs) == 1 else
                 [Path(run_slam._stream_path(str(traj), i))
                  for i in range(len(inputs))])
        ates = [traj_ate(f, g["gt_cam_t"]) for f, g in zip(files, gts)]
        sm.line(f"run_slam {name}: {FRAMES} frames x {len(inputs)} "
                f"stream(s) in {wall:.1f} s wall (compile included); "
                f"ATE {', '.join(f'{a:.4f}' for a in ates)} m (max "
                f"{APP_ATE_MAX_M})")
        check(max(ates) <= APP_ATE_MAX_M, f"run_slam {name} ATE {ates}")


def run_offline_phase(sm: Smoke, paths) -> None:
    """run_offline (pass-1 ingest + batch LM) on the orbit bundle."""
    from aruco_slam_tpu.apps import run_offline

    traj = OUT / "offline.txt"
    t0 = time.perf_counter()
    run_offline.main(["--input", str(paths["orbit"]), "--trajectory",
                      str(traj), "--map", str(OUT / "map_offline.txt")])
    wall = time.perf_counter() - t0
    ate = traj_ate(traj, load(paths["orbit"])["gt_cam_t"])
    sm.line(f"run_offline: {FRAMES} frames in {wall:.1f} s wall "
            f"(compile included); ATE {ate:.4f} m (max {APP_ATE_MAX_M})")
    check(ate <= APP_ATE_MAX_M, f"run_offline ATE {ate}")


def survey_phase(sm: Smoke) -> None:
    """bench/large_map.py at its standard size (512 markers, 512
    frames, batch 8, f32 covariance) under "highest" and "mixed"."""
    import io
    from contextlib import redirect_stdout

    from aruco_slam_tpu.bench import large_map

    rows = {}
    for prec in ("highest", "mixed"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            large_map.main(["--precision", prec, "--reps", "1"])
        wall = time.perf_counter() - t0
        rows[prec] = json.loads(buf.getvalue().strip().splitlines()[-1])
        r = rows[prec]
        sm.line(f"survey {prec}: {r['value']} frames/s batch 8, single "
                f"stream {r['single_stream_fps']} frames/s, ATE "
                f"{r['ate_m']} m, BA {r['offline_ba_s']} s (ATE "
                f"{r['offline_ba_ate_m']} m); compile s "
                f"{r['compile_s']}, temp MiB {r['temp_mib']}; "
                f"{wall:.1f} s wall")
    print(f"survey ATE: highest {rows['highest']['ate_m']} m, mixed "
          f"{rows['mixed']['ate_m']} m (max {SURVEY_ATE_MAX_M} at "
          f"highest)", flush=True)
    check(rows["highest"]["ate_m"] <= SURVEY_ATE_MAX_M,
          f"survey ATE {rows['highest']['ate_m']}")


# --- four-card phases -----------------------------------------------------

def sharded_ba_phase(sm: Smoke, paths, n: int = 4) -> None:
    """Landmark-sharded batch LM on make_mesh(n) against the
    single-device batch_optimize, on the orbit bundle's pose-level
    observations."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aruco_slam_tpu.graph import (
        GraphConfig, add_frame, batch_optimize, init_graph)
    from aruco_slam_tpu.parallel import make_mesh, sharded_batch_optimize

    b = load(paths["orbit"])
    t = len(b["times"])
    cfg = GraphConfig(max_poses=t + 2, max_landmarks=CAPACITY,
                      max_factors=int(b["mask"].sum()) + 8,
                      meas_sigma_t=0.01, odom_sigma_t=1.0,
                      odom_sigma_rot=1.0)
    state = init_graph(cfg)
    for i in range(t):
        state = add_frame(cfg, state, jnp.asarray(b["t_cl"][i]),
                          jnp.asarray(b["mask"][i]))
    mesh = make_mesh(n)
    t0 = time.perf_counter()
    multi, cost_m = sharded_batch_optimize(cfg, state, mesh, iters=20)
    jax.block_until_ready(cost_m)
    sm.line(f"sharded BA on {n} cards: {time.perf_counter() - t0:.2f} s "
            "(compile included)")
    single, cost_s = batch_optimize(cfg, state, iters=20)
    d = float(np.abs(np.asarray(multi.pose_t)[:t]
                     - np.asarray(single.pose_t)[:t]).max())
    devs = len(multi.pose_t.sharding.device_set)
    print(f"sharded BA: |dpose| {d:.2e} m (tol {SHARD_TOL_M}), cost "
          f"{float(cost_m):.4f} vs {float(cost_s):.4f}, result on "
          f"{devs} devices", flush=True)
    check(devs == n, f"sharded result on {devs} devices")
    check(d <= SHARD_TOL_M, f"sharded BA |dpose| {d}")


def fleet_phase(sm: Smoke, paths) -> None:
    """run_offline --fleet 2x2 on both bundles against the
    single-sequence run_offline of each."""
    import numpy as np

    from aruco_slam_tpu.apps import run_offline
    from aruco_slam_tpu.io import read_trajectory

    names = ("orbit", "video")
    fleet = OUT / "fleet.txt"
    t0 = time.perf_counter()
    run_offline.main(["--input", ",".join(str(paths[k]) for k in names),
                      "--fleet", "2x2", "--trajectory", str(fleet),
                      "--map", str(OUT / "map_fleet.txt")])
    sm.line(f"run_offline --fleet 2x2: {time.perf_counter() - t0:.1f} s "
            "wall (compile included)")
    for i, k in enumerate(names):
        solo = OUT / f"offline_{k}.txt"
        run_offline.main(["--input", str(paths[k]), "--trajectory",
                          str(solo), "--map",
                          str(OUT / f"map_offline_{k}.txt")])
        _, a = read_trajectory(OUT / f"fleet_seq{i}.txt")
        _, s = read_trajectory(solo)
        d = float(np.abs(a[:, :3] - s[:, :3]).max())
        ate = traj_ate(OUT / f"fleet_seq{i}.txt",
                       load(paths[k])["gt_cam_t"])
        print(f"fleet {k}: |dpose| vs single-sequence {d:.2e} m (tol "
              f"{SHARD_TOL_M}), ATE {ate:.4f} m", flush=True)
        check(d <= SHARD_TOL_M, f"fleet {k} |dpose| {d}")


def serving_phase(sm: Smoke, paths, n: int = 4) -> None:
    """4-stream serving (run_slam --input a,b,a,b), sharded one stream
    per card, against single-stream runs with the same --max-obs."""
    import jax
    import numpy as np

    from aruco_slam_tpu.apps import run_slam
    from aruco_slam_tpu.io import read_trajectory

    names = ["orbit", "video"] * (n // 2)
    fleet = OUT / "serve.txt"
    common = ["--max-obs", "16"]
    t0 = time.perf_counter()
    run_slam.main(["--input", ",".join(str(paths[k]) for k in names),
                   "--trajectory", str(fleet),
                   "--map", str(OUT / "map_serve.txt")] + common)
    sm.line(f"run_slam {n}-stream serving: {time.perf_counter() - t0:.1f}"
            " s wall (compile included)")
    solo = {}
    for k in ("orbit", "video"):
        solo[k] = OUT / f"serve_solo_{k}.txt"
        run_slam.main(["--input", str(paths[k]), "--trajectory",
                       str(solo[k]), "--map",
                       str(OUT / f"map_serve_solo_{k}.txt")] + common)
    for i, k in enumerate(names):
        _, a = read_trajectory(run_slam._stream_path(str(fleet), i))
        _, s = read_trajectory(solo[k])
        d = float(np.abs(a[:, :3] - s[:, :3]).max())
        print(f"serving stream {i} ({k}): |dpose| vs single stream "
              f"{d:.2e} m (tol {SERVE_TOL_M})", flush=True)
        check(d <= SERVE_TOL_M, f"stream {i} |dpose| {d}")
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()]
    print("peak bytes per card: "
          + ", ".join(f"{p / 2**20:.0f} MiB" for p in peaks), flush=True)
    check(min(peaks) > 2**20, f"a card held no work: {peaks}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded paths, on four cards")
    args = p.parse_args(argv)

    try:
        import aruco_slam_tpu
    except ImportError:
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repo (aruco_slam_tpu not found)") from None
    if Path(aruco_slam_tpu.__file__).resolve().parents[1] != ROOT:
        raise SystemExit("chip_smoke: aruco_slam_tpu is not the copy "
                         "beside this script")
    import jax

    dev = require_gpu()
    cards = card_info()
    for c in cards:
        print(f"nvidia-smi: {c}", flush=True)
    print(f"jax {jax.__version__}; devices: {jax.devices()}", flush=True)
    need = 4 if args.four else 1
    if jax.device_count() < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, found "
                         f"{jax.device_count()}")

    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    sm = Smoke(cards[0])
    t_all = time.perf_counter()
    # the four-card phases compare sharded with single-device results
    # (no ATE bound), so half the frames do
    paths = sm.phase("render", render_bundles,
                     FRAMES // 2 if args.four else FRAMES)
    if paths is None:
        return 1
    if args.four:
        sm.phase("sharded BA", sharded_ba_phase, paths)
        sm.phase("fleet BA", fleet_phase, paths)
        sm.phase("sharded serving", serving_phase, paths)
    else:
        sm.phase("precision probe", precision_probe)
        sm.phase("detection parity", detection_parity, paths)
        sm.phase("stage timings", stage_timings, paths)
        sm.phase("corners->pose", corners_to_pose)
        sm.phase("run_slam", run_slam_phases, paths)
        sm.phase("run_offline", run_offline_phase, paths)
        sm.phase("survey", survey_phase)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    if sm.failed:
        print(f"FAILED phases: {', '.join(sm.failed)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
