"""Stage-level profile of the robust detector on device.

The robust 3-pass candidate sweep is the e2e pipeline's cost center
(~90% of the image->pose budget); this bench times each stage of
`ops/detect._detect_candidates` as its own on-device program over a
batch of rendered 1080p frames, so optimization work attacks measured
numbers instead of guesses.

    python -m aruco_slam_tpu.bench.detect_profile [--frames 16]

Prints one ms/frame line per stage plus the full-detector total.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--markers", type=int, default=10)
    p.add_argument("--platform", default=None)
    p.add_argument("--detector", default="robust",
                   choices=["robust", "fast"])
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--stages", default=None,
                   help="comma-separated subset of stage stops to "
                        "profile (default: all); 'none' = full "
                        "detector only")
    args = p.parse_args(argv)
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from aruco_slam_tpu.bench import synthetic
    from aruco_slam_tpu.bench.pipeline import device_fields, time_loop
    from aruco_slam_tpu.bench.render import render_sequence
    from aruco_slam_tpu.core import camera as cam_mod
    from aruco_slam_tpu.ops import detect

    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    d = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    cam = cam_mod.CameraModel.from_matrix(jnp.asarray(k, jnp.float32),
                                          jnp.asarray(d, jnp.float32))
    scene = synthetic.make_wall_scene(num_markers=args.markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=args.frames)
    t0 = time.perf_counter()
    frames = render_sequence(scene, traj, cam, image_size=(1920, 1080))
    print(f"# rendered {args.frames} frames in "
          f"{time.perf_counter() - t0:.1f}s (host)", flush=True)
    images = jnp.asarray(np.asarray(frames))
    t = args.frames

    cfg = detect.with_preset(detect.DetectorConfig(), args.detector)

    def timeit(name, fn, images):
        """On-device repetition (bench/pipeline.time_loop); the f32
        sum of every output leaf keeps the whole prefix live."""
        ms = 1e3 * time_loop(fn, (images,), args.reps) / t
        print(f"# {name:<28s} {ms:8.3f} ms/frame", flush=True)
        return None, ms

    # -- full detector (batched, what e2e measures) --
    _, full_ms = timeit(
        "detect_markers (full)",
        lambda im: detect.detect_markers_batch(im, cfg)[:2], images)

    # -- stage prefixes (vmapped over the frame batch like the real
    # detector; each prefix timed alone, so stage cost = successive
    # difference) --
    stages = detect.candidate_stage_names()
    if args.stages == "none":
        stages = ()
    elif args.stages:
        want = set(args.stages.split(","))
        stages = tuple(s_ for s_ in stages if s_ in want)
    prev = 0.0
    rows = {}
    for s in stages:
        _, ms = timeit(
            f"prefix:{s}",
            lambda im, s=s: jax.vmap(
                lambda x: detect._detect_candidates(x, cfg, stop=s)
            )(im), images)
        rows[s] = ms - prev
        prev = ms
    rows["slots+rest"] = full_ms - prev
    print(json.dumps({"metric": "detect_stage_ms_per_frame",
                      "detector": args.detector,
                      "total_ms": round(full_ms, 3),
                      **device_fields(),
                      **{k: round(v, 3) for k, v in rows.items()}}))


if __name__ == "__main__":
    main()
