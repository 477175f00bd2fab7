"""Generate a synthetic marker sequence as an .npz bundle.

Fills the role of the reference's (gitignored, unavailable)
input_video.mp4 demo data with exact ground truth:

    python -m aruco_slam_tpu.apps.make_synthetic --out outputs/seq.npz \
        --frames 300 --markers 12 [--noise-px 0.3] [--images]
"""

from __future__ import annotations

import argparse

import numpy as np

from aruco_slam_tpu.bench import synthetic
from aruco_slam_tpu.core import camera as cam_mod
from aruco_slam_tpu.io import sources


def build(frames=300, markers=12, capacity=64, seed=0, noise_px=0.0,
          noise_t=0.0, noise_r=0.0, fov_limit=0.75,
          camera_matrix=None, dist_coeffs=None, marker_size=0.16,
          with_images=False, image_size=(1920, 1080),
          orbit_frames=None, dict_name="dict_5x5_50",
          marker_ids=None):
    """orbit_frames: length of the FULL orbit the `frames` output
    frames are sliced from (defaults to `frames` — one whole orbit).
    Set larger (e.g. 10x frames) for video-rate inter-frame motion,
    the regime the streaming tracker (--track-every) expects.

    dict_name / marker_ids control what the RENDERED images carry
    (scene marker j shows dictionary id marker_ids[j]; default j) —
    e.g. dict_5x5_1000 ids around 900 exercise the id->slot table
    (run_slam needs no capacity inflation for sparse high ids). The
    corner-/pose-level arrays stay indexed by scene marker, so only
    image-domain consumers see the dictionary ids."""
    k = camera_matrix if camera_matrix is not None else np.array(
        [[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3], [0.0, 0.0, 1.0]])
    d = dist_coeffs if dist_coeffs is not None else np.array(
        [0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    cam = cam_mod.CameraModel.from_matrix(k, d)
    scene = synthetic.make_wall_scene(num_markers=markers, seed=seed,
                                      marker_size=marker_size)
    traj = synthetic.make_orbit_trajectory(
        num_frames=max(orbit_frames or frames, frames), seed=seed + 1)
    if orbit_frames and orbit_frames > frames:
        import jax
        traj = jax.tree.map(lambda a: a[:frames], traj)
    pose_obs = synthetic.observe_poses(
        scene, traj, capacity, noise_t=noise_t, noise_r=noise_r,
        fov_limit=fov_limit, seed=seed + 2)
    corners, cmask = synthetic.observe_corners(
        scene, traj, cam, capacity, noise_px=noise_px, seed=seed + 3,
        image_size=image_size)
    out = dict(
        times=traj.times,
        t_cl=pose_obs.t_cl, q_cl=pose_obs.q_cl, mask=pose_obs.mask,
        corners=corners, corner_mask=cmask,
        gt_cam_t=traj.cam_t, gt_cam_q=traj.cam_q,
        gt_marker_pos=scene.marker_pos, gt_marker_quat=scene.marker_quat,
        marker_size=np.float64(scene.marker_size),
        camera_matrix=k, dist_coeffs=d,
    )
    if with_images:
        from aruco_slam_tpu.bench.render import render_sequence
        out["images"] = render_sequence(scene, traj, cam,
                                        image_size=image_size,
                                        dict_name=dict_name,
                                        marker_ids=marker_ids)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--markers", type=int, default=12)
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-px", type=float, default=0.0)
    p.add_argument("--noise-t", type=float, default=0.0)
    p.add_argument("--noise-r", type=float, default=0.0)
    p.add_argument("--images", action="store_true",
                   help="render grayscale frames (slower, larger)")
    p.add_argument("--dict", dest="dict_name", default="dict_5x5_50",
                   help="marker dictionary for rendered images "
                        "(ops/dictionary.names())")
    p.add_argument("--id-offset", type=int, default=0,
                   help="rendered marker j carries dictionary id "
                        "offset+j (high offsets exercise the id->slot "
                        "table: run_slam --dict needs no capacity "
                        "inflation)")
    p.add_argument("--video-rate", action="store_true",
                   help="slice the frames from a 10x-longer orbit so "
                        "inter-frame motion is video-rate (what "
                        "run_slam --track-every expects)")
    p.add_argument("--platform", default="cpu",
                   help="JAX platform (default cpu: synthesis is a "
                        "host-side tool of many small eager ops)")
    args = p.parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    bundle = build(frames=args.frames, markers=args.markers,
                   capacity=args.capacity, seed=args.seed,
                   noise_px=args.noise_px, noise_t=args.noise_t,
                   noise_r=args.noise_r, with_images=args.images,
                   orbit_frames=(10 * args.frames if args.video_rate
                                 else None),
                   dict_name=args.dict_name,
                   marker_ids=(np.arange(args.markers) + args.id_offset
                               if args.id_offset else None))
    sources.save_npz(args.out, **bundle)
    print(f"wrote {args.out}: {args.frames} frames, "
          f"{args.markers} markers"
          + (", with images" if args.images else ""))


if __name__ == "__main__":
    main()
