"""End-to-end image->pose benchmark: the full SLAM pipeline on device.

Renders a synthetic 1080p marker sequence host-side, then measures the
complete on-device pipeline — image-domain ArUco detection, batched
IPPE PnP, fused MEKF scan — as one jitted program. This is the
boundary the reference crosses per frame with cv2.aruco detection +
per-marker solvePnP + numpy EKF (tens of ms per 1080p frame on CPU;
its filter alone measures 22 ms/frame, BASELINE_MEASURED.md).

    python -m aruco_slam_tpu.bench.e2e [--frames 128]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=128)
    p.add_argument("--markers", type=int, default=10)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--platform", default=None)
    p.add_argument("--detector", default="robust",
                   choices=["robust", "fast"],
                   help="robust = the default 3-pass (window x scale) "
                        "candidate sweep (survives blur/noise/clutter"
                        "); fast = single coarse pass for clean scenes")
    p.add_argument("--track-every", type=int, default=0, metavar="K",
                   help="streaming mode: full detection on 2 of every "
                        "K frames (velocity bootstrap), cheap corner "
                        "tracking + decode-validation in between "
                        "(ops/detect.detect_or_track). Renders a "
                        "video-rate trajectory (10x slower orbit) so "
                        "inter-frame motion is physical. K >= 3")
    p.add_argument("--video-rate", action="store_true",
                   help="use the sliced 10x-longer orbit (what "
                        "--track-every implies) without tracking — "
                        "for apples-to-apples full-vs-tracked runs")
    p.add_argument("--streams", type=int, default=1, metavar="S",
                   help="serve S independent video streams at once "
                        "(full pixels->pose pipeline vmapped over the "
                        "stream axis; BASELINE config 5 shape). "
                        "Reports aggregate and per-stream fps")
    p.add_argument("--rescue-cohorts", type=int, default=0,
                   metavar="G",
                   help="fleet streaming only: split the --streams "
                        "fleet into G schedule cohorts (staggered "
                        "K/G apart) so a stream that loses every "
                        "marker triggers an immediate full sweep of "
                        "its own cohort instead of waiting out the "
                        "period (ops/detect.streaming_step)")
    p.add_argument("--degrade", default=None,
                   choices=["blur", "noise", "combined"],
                   help="degrade the rendered frames host-side "
                        "(bench/degrade.py) before measuring — the "
                        "conditions the robust multi-pass sweep "
                        "exists for; detection quality shows up in "
                        "mean_detections_per_frame")
    args = p.parse_args(argv)
    if args.track_every and args.track_every < 3:
        p.error("--track-every needs K >= 3")
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from aruco_slam_tpu.bench import synthetic
    from aruco_slam_tpu.bench.render import render_sequence
    from aruco_slam_tpu.core import camera as cam_mod
    from aruco_slam_tpu.filters import (
        FrameObservations, MekfConfig, init_state, mekf_scan)
    from aruco_slam_tpu.ops import detect, pnp

    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    d = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    cam = cam_mod.CameraModel.from_matrix(jnp.asarray(k, jnp.float32),
                                          jnp.asarray(d, jnp.float32))
    scene = synthetic.make_wall_scene(num_markers=args.markers, seed=0)
    if args.track_every or args.video_rate:
        # tracking needs video-rate motion; the default whole-orbit-in-
        # `frames` trajectory jumps tens of px per frame
        traj = jax.tree.map(
            lambda a: a[:args.frames],
            synthetic.make_orbit_trajectory(num_frames=10 * args.frames))
    else:
        traj = synthetic.make_orbit_trajectory(num_frames=args.frames)
    t0 = time.perf_counter()
    frames = render_sequence(scene, traj, cam, image_size=(1920, 1080))
    print(f"# rendered {args.frames} frames in "
          f"{time.perf_counter() - t0:.1f}s (host)", flush=True)
    if args.degrade:
        from aruco_slam_tpu.bench import degrade
        kw = {"blur": dict(blur_sigma=1.5),
              "noise": dict(noise_sigma=8.0),
              "combined": dict(blur_sigma=1.0, noise_sigma=6.0,
                               vignette_strength=0.4)}[args.degrade]
        t0 = time.perf_counter()
        frames = np.stack([degrade.degrade(f, seed=i, **kw)
                           for i, f in enumerate(frames)])
        print(f"# degraded ({args.degrade}) in "
              f"{time.perf_counter() - t0:.1f}s (host)", flush=True)

    capacity = 64
    dcfg = detect.with_preset(detect.DetectorConfig(capacity=capacity),
                              args.detector)
    fcfg = MekfConfig(capacity=capacity)
    state0 = init_state(fcfg)
    marker_size = scene.marker_size
    t = args.frames
    ch = args.chunk

    ke = args.track_every

    def detect_seq(images):
        """(T, H, W) -> (corners (T,C,4,2), mask (T,C))."""
        if not ke:
            det = jax.lax.map(
                lambda x: detect.detect_markers_batch(x, dcfg),
                images.reshape(t // ch, ch, *images.shape[1:]))
            return (det.corners.reshape(t, capacity, 4, 2),
                    det.mask.reshape(t, capacity))
        _, (cs, ms) = jax.lax.scan(detect.streaming_step(dcfg, ke),
                                   detect.streaming_init(dcfg), images)
        return cs, ms

    def pnp_mekf_tail(corners_seq, mask_seq, state):
        def pnp_chunk(c):
            res = pnp.solve_square_pnp(cam, c, marker_size)
            return res.t_cl, res.q_cl, res.err
        t_cl, q_cl, err = jax.lax.map(
            pnp_chunk, corners_seq.reshape(t // ch, ch, capacity, 4, 2))
        merge = lambda a: a.reshape(t, *a.shape[2:])
        obs = FrameObservations(
            merge(t_cl), merge(q_cl), mask_seq & (merge(err) < 3.0))
        return mekf_scan(fcfg, state, obs)

    def e2e(images, state):
        return pnp_mekf_tail(*detect_seq(images), state)

    def e2e_fleet(images, states):
        """(S, T, H, W): the tracked fleet shares ONE scalar full/track
        schedule (detect.streaming_step(streams=...)) so the branch
        stays a real cond under vmap."""
        if not ke:
            return jax.vmap(e2e)(images, states)
        ns_ = images.shape[0]
        _, (cs, ms) = jax.lax.scan(
            detect.streaming_step(dcfg, ke, streams=ns_,
                                  rescue_cohorts=args.rescue_cohorts),
            detect.streaming_init(dcfg, streams=ns_),
            jnp.swapaxes(images, 0, 1))
        return jax.vmap(pnp_mekf_tail)(jnp.swapaxes(cs, 0, 1),
                                       jnp.swapaxes(ms, 0, 1), states)

    # repetitions run ON DEVICE in one dispatch (bench/pipeline
    # time_loop): host dispatch stays out of sub-ms/frame numbers
    from aruco_slam_tpu.bench.pipeline import time_loop
    ns = args.streams
    reps = 8 if ns == 1 else max(2, 8 // ns)
    images = jnp.asarray(frames)
    if ns == 1:
        dt = time_loop(lambda im: e2e(im, state0)[1], (images,), reps)
    else:
        # stream fleet: ONE rendered sequence broadcast on device to
        # every stream; host renders and ships (T, H, W) once
        from aruco_slam_tpu.parallel.multi_slam import stack_states
        states0 = stack_states([init_state(fcfg)] * ns)
        fleet_ims = jnp.broadcast_to(images, (ns,) + images.shape)
        dt = time_loop(lambda im: e2e_fleet(im, states0)[1],
                       (fleet_ims,), reps)
    fps = ns * t / dt

    # --- stage split: each stage timed with the same on-device loop
    # as the headline ---
    sreps = max(2, reps)
    if ns == 1:
        cs, ms = jax.jit(detect_seq)(images)
        res0 = jax.jit(lambda c: pnp.solve_square_pnp(
            cam, c, marker_size))(cs)
        obs = FrameObservations(res0.t_cl, res0.q_cl,
                                ms & (res0.err < 3.0))
        dt_detect = time_loop(detect_seq, (images,), sreps)
        dt_pnp = time_loop(
            lambda c: pnp.solve_square_pnp(cam, c, marker_size),
            (cs,), sreps)
        dt_mekf = time_loop(lambda o: mekf_scan(fcfg, state0, o),
                            (obs,), sreps)
    else:
        # stage split on the REAL fleet program: vmap changes the cost
        # structure (layouts, batched GEMMs), so a single-stream proxy
        # mismeasures it
        def fleet_detect(ims):
            if not ke:
                return jax.vmap(detect_seq)(ims)
            _, (cs_, ms_) = jax.lax.scan(
                detect.streaming_step(dcfg, ke, streams=ns,
                                      rescue_cohorts=args.rescue_cohorts),
                detect.streaming_init(dcfg, streams=ns),
                jnp.swapaxes(ims, 0, 1))
            return jnp.swapaxes(cs_, 0, 1), jnp.swapaxes(ms_, 0, 1)

        cs, ms = jax.jit(fleet_detect)(fleet_ims)
        fleet_pnp = jax.vmap(lambda c: pnp.solve_square_pnp(
            cam, c, marker_size))
        res0 = jax.jit(fleet_pnp)(cs)
        obs = FrameObservations(res0.t_cl, res0.q_cl,
                                ms & (res0.err < 3.0))
        dt_detect = time_loop(fleet_detect, (fleet_ims,), sreps) / ns
        dt_pnp = time_loop(fleet_pnp, (cs,), sreps) / ns
        dt_mekf = time_loop(
            lambda o: jax.vmap(lambda st, oo: mekf_scan(fcfg, st, oo))(
                states0, o), (obs,), sreps) / ns
        ms = ms.reshape(-1, ms.shape[-1])  # stream-pooled detections

    class _Totals:
        totals = {"detect": dt_detect, "pnp": dt_pnp, "mekf": dt_mekf}

    timer = _Totals()
    for name, secs in timer.totals.items():
        print(f"# {name:8s} {1e3 * secs / t:8.3f} ms/frame")

    from aruco_slam_tpu.bench.pipeline import (
        device_fields, flops_metrics, flops_of)
    flops = flops_of(lambda im, st: e2e(im, st)[1], images, state0)
    row = {
        "metric": "e2e_image_to_pose_fps_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "resolution": "1920x1080",
        "detector": args.detector,
        **device_fields(),
        **flops_metrics(flops * ns, dt),
    }
    if args.degrade:
        row["degrade"] = args.degrade
    if ns > 1:
        row["streams"] = ns
        row["per_stream_fps"] = round(fps / ns, 1)
        # the detect/pnp/mekf ms fields are measured on the REAL
        # vmapped fleet program (per-stream-frame cost)
        row["stage_split"] = "fleet"
    if ke:
        row["track_every"] = ke
    if args.rescue_cohorts:
        row["rescue_cohorts"] = args.rescue_cohorts
    # observation quality rides along: tracked-mode drops show up as a
    # lower per-frame detection count than a full-sweep run on the
    # same --video-rate trajectory
    row["mean_detections_per_frame"] = round(
        float(np.asarray(ms).sum(1).mean()), 2)
    for name in ("detect", "pnp", "mekf"):
        if name in timer.totals:
            row[f"{name}_ms_per_frame"] = round(
                1e3 * timer.totals[name] / t, 4)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
