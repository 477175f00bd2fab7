"""Headline benchmark: fused marker-SLAM frame pipeline, fps per device.

Runs the flagship path — batched IPPE-square PnP from pixel corners +
the fused MEKF update — on the default device in two shapes:

* single-stream: one video, one `lax.scan` over 512 frames (latency-
  bound; the shape the reference's sequential CPU loop runs), and
* batched serving: 256 independent sequences vmapped over the same
  pipeline (throughput-bound; the shape a serving device runs).

Prints ONE JSON line with the batched throughput as the headline
value; `single_stream_fps` rides along for latency comparisons.
vs_baseline is the speedup over the measured reference-EKF CPU rate at
the same observation boundary (45.1 fps @ 8 visible markers of a
64-marker map — see BASELINE_MEASURED.md). Every row names the
platform, device kind and device count it ran on.

Ride-along fields:

* robust_e2e_fps      — full image->pose at 1080p, 3-pass robust
                        detection every frame, 128 frames / chunk 16:
                        the SAME program shape as bench/e2e.py's
                        standard run
* streaming_fps       — image->pose with --track-every 8 streaming
* serving_fps_per_stream — 8-camera 1080p full-detection serving
                        (BASELINE config 5), measured on the REAL
                        vmapped fleet program
* large_map_fps / large_map_pct_of_tf32_peak / ba_lm_iters_per_s —
                        512-marker survey MEKF (dim-1545 covariance)
                        and the 512-pose batch-LM BA solve, via
                        bench/large_map.py
"""

from __future__ import annotations

import json

import numpy as np

REFERENCE_FPS = 45.1  # measured; BASELINE_MEASURED.md

FRAMES = 512
CAPACITY = 64
MARKERS = 8
BATCH = 256


def main() -> None:
    import jax
    import jax.numpy as jnp

    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from aruco_slam_tpu.bench import synthetic
    from aruco_slam_tpu.core import camera as cam_mod
    from aruco_slam_tpu.filters import MekfConfig, init_state

    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    d = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    cam = cam_mod.CameraModel.from_matrix(jnp.asarray(k, jnp.float32),
                                          jnp.asarray(d, jnp.float32))
    scene = synthetic.make_wall_scene(num_markers=MARKERS, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=FRAMES)
    corners, mask = synthetic.observe_corners(
        scene, traj, cam, CAPACITY, noise_px=0.3, seed=1)

    fcfg = MekfConfig(capacity=CAPACITY)
    state0 = init_state(fcfg)
    corners_d = jnp.asarray(corners, jnp.float32)
    mask_d = jnp.asarray(mask)
    marker_size = scene.marker_size

    from aruco_slam_tpu.bench.pipeline import make_pipeline as _mk

    def make_pipeline(cfg_):
        # corners -> batched PnP -> fused MEKF scan; chunked PnP keeps
        # solver intermediates bounded (vmapping the whole sequence at
        # batch 64 wants ~45 GB)
        return _mk(cam, marker_size, cfg_, chunk=64)

    # single-stream: the exact Cholesky solve. batched: the Newton-
    # Schulz solver, which vmaps into batched GEMMs where a Cholesky
    # would serialize. Serving precision: default-precision covariance
    # products with an f32-pinned gain chain ("mixed") — the
    # covariance tolerates the rounding while S stays numerically PSD
    # for the Newton-Schulz solver.
    fcfg_b = fcfg._replace(s_solver="ns", matmul_precision="mixed")

    # B independent sequences: shared geometry, distinct pixel noise
    rng = np.random.default_rng(7)
    corners_b = jnp.asarray(
        corners[None] + rng.normal(0, 0.3, (BATCH,) + corners.shape),
        jnp.float32)
    mask_b = jnp.broadcast_to(mask_d, (BATCH,) + mask.shape)

    from aruco_slam_tpu.bench.pipeline import (
        device_fields, flops_metrics, flops_of, time_loop)

    single_fn = make_pipeline(fcfg)
    batched_fn = jax.vmap(make_pipeline(fcfg_b), in_axes=(None, 0, 0))
    dt = time_loop(lambda c, m: single_fn(state0, c, m)[1],
                   (corners_d, mask_d), reps=8)
    single_fps = FRAMES / dt
    dtb = time_loop(lambda c, m: batched_fn(state0, c, m)[1],
                    (corners_b, mask_b), reps=2)
    batched_fps = BATCH * FRAMES / dtb

    flops = flops_of(batched_fn, state0, corners_b, mask_b)
    row = {
        "metric": "mekf_pipeline_fps_per_chip",
        "value": round(batched_fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(batched_fps / REFERENCE_FPS, 2),
        "batch": BATCH,
        "single_stream_fps": round(single_fps, 1),
        **device_fields(),
        **flops_metrics(flops, dtb),
    }
    # image-domain + scale axes ride along: every engine axis in one row
    images, scene = _rendered_frames(cam, 128)
    row.update(_image_fields(cam, images, scene))
    row.update(_streaming_field(cam))
    row.update(_serving_field(cam, images[:64], scene))
    row.update(_large_map_fields())
    print(json.dumps(row))


def _rendered_frames(cam, frames: int, markers: int = 10,
                     video_rate: bool = False):
    """Rendered 1080p frames (host-side, ~1 s/frame) + scene."""
    import jax
    import jax.numpy as jnp

    from aruco_slam_tpu.bench import synthetic
    from aruco_slam_tpu.bench.render import render_sequence

    scene = synthetic.make_wall_scene(num_markers=markers, seed=0)
    if video_rate:
        traj = jax.tree.map(
            lambda a: a[:frames],
            synthetic.make_orbit_trajectory(num_frames=10 * frames))
    else:
        traj = synthetic.make_orbit_trajectory(num_frames=frames)
    imgs = render_sequence(scene, traj, cam, image_size=(1920, 1080))
    return jnp.asarray(imgs), scene


def _e2e_programs(cam, scene, frames: int, chunk: int,
                  track_every: int = 0):
    """The bench/e2e.py program shapes: detect (full or streaming) ->
    chunked PnP -> fused MEKF scan, per stream."""
    import jax
    import jax.numpy as jnp

    from aruco_slam_tpu.filters import (
        FrameObservations, MekfConfig, init_state, mekf_scan)
    from aruco_slam_tpu.ops import detect, pnp

    dcfg = detect.DetectorConfig(capacity=CAPACITY)  # robust
    fcfg = MekfConfig(capacity=CAPACITY)
    state0 = init_state(fcfg)
    ms = scene.marker_size
    t = frames

    def detect_seq(images):
        if not track_every:
            det = jax.lax.map(
                lambda x: detect.detect_markers_batch(x, dcfg),
                images.reshape(t // chunk, chunk, *images.shape[1:]))
            return (det.corners.reshape(t, CAPACITY, 4, 2),
                    det.mask.reshape(t, CAPACITY))
        _, (cs, msk) = jax.lax.scan(
            detect.streaming_step(dcfg, track_every),
            detect.streaming_init(dcfg), images)
        return cs, msk

    def pnp_mekf_tail(cs, msk, state):
        res = pnp.solve_square_pnp(cam, cs, ms)
        obs = FrameObservations(res.t_cl, res.q_cl,
                                msk & (res.err < 3.0))
        return mekf_scan(fcfg, state, obs)

    def e2e(images, state):
        return pnp_mekf_tail(*detect_seq(images), state)

    return e2e, state0, fcfg


def _timed_fps(e2e, state0, images, frames: int, reps: int):
    """Frames/s of the e2e program over `images`, repetitions on
    device (bench/pipeline.time_loop)."""
    from aruco_slam_tpu.bench.pipeline import time_loop
    dt = time_loop(lambda ims: e2e(ims, state0)[1], (images,), reps)
    return frames / dt


def _image_fields(cam, images, scene, chunk: int = 16) -> dict:
    """Robust image->pose e2e fps — the 128-frame bench/e2e.py
    standard."""
    frames = images.shape[0]
    e2e, state0, _ = _e2e_programs(cam, scene, frames, chunk)
    fps = _timed_fps(e2e, state0, images, frames, reps=4)
    return {"robust_e2e_fps": round(fps, 1),
            "robust_e2e_frames": frames}


def _streaming_field(cam, frames: int = 128, track_every: int = 8
                     ) -> dict:
    """Streaming (detect-every-K) image->pose fps on a video-rate
    trajectory."""
    images, scene = _rendered_frames(cam, frames, video_rate=True)
    e2e, state0, _ = _e2e_programs(cam, scene, frames, 16,
                                   track_every=track_every)
    fps = _timed_fps(e2e, state0, images, frames, reps=4)
    return {"streaming_fps": round(fps, 1),
            "streaming_track_every": track_every}


def _serving_field(cam, images, scene, chunk: int = 16,
                   streams: int = 8) -> dict:
    """8-camera 1080p full-detection serving (BASELINE config 5),
    measured on the REAL vmapped fleet program: every stream runs the
    same rendered sequence."""
    import jax
    import jax.numpy as jnp

    from aruco_slam_tpu.bench.pipeline import time_loop
    from aruco_slam_tpu.filters import init_state
    from aruco_slam_tpu.parallel.multi_slam import stack_states

    frames = images.shape[0]
    e2e, state0, fcfg = _e2e_programs(cam, scene, frames, chunk)
    states0 = stack_states([init_state(fcfg)] * streams)
    fleet = jax.vmap(e2e)
    ims = jnp.broadcast_to(images, (streams,) + images.shape)
    dt = time_loop(lambda x: fleet(x, states0)[1], (ims,), reps=2)
    return {"serving_fps_per_stream": round(frames / dt, 1),
            "serving_streams": streams}


def _large_map_fields() -> dict:
    """512-marker survey MEKF (dim-1545 covariance) + the
    512-pose/~17k-factor batch-LM BA solve, from bench/large_map.py's
    standard run."""
    import io
    from contextlib import redirect_stdout

    from aruco_slam_tpu.bench import large_map

    def run(extra):
        buf = io.StringIO()
        with redirect_stdout(buf):
            large_map.main(["--reps", "2"] + extra)
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    out = run([])
    row = {"large_map_fps": out["value"],
           "large_map_ate_m": out["ate_m"],
           "large_map_pct_of_tf32_peak": out.get("pct_of_tf32_peak"),
           "ba_lm_iters_per_s": round(40.0 / out["offline_ba_s"], 2),
           "ba_pct_of_tf32_peak": out.get("ba_pct_of_tf32_peak")}
    # bf16-covariance serving mode rides along with its ATE
    b16 = run(["--cov-dtype", "bf16"])
    row["large_map_bf16_fps"] = b16["value"]
    row["large_map_bf16_ate_m"] = b16["ate_m"]
    return row


if __name__ == "__main__":
    main()
