"""Online SLAM driver.

On-device equivalent of the reference's main/run_slam.py: per-frame
marker observation → filter update → trajectory/map/viz outputs.

    python -m aruco_slam_tpu.apps.run_slam --input seq.npz \
        --filter {mekf,mekf_rotations,factorgraph} [--viz-2d --viz-3d]

Input: an .npz sequence (see apps/make_synthetic.py). If the bundle
carries pixel `corners` they are pushed through the batched IPPE PnP
on device (the path the reference runs per marker through
cv2.solvePnP, reference filters/base_filter.py:125-171); otherwise
pose-level observations (`t_cl`/`q_cl`/`mask`) are used directly.

Fast path: without viz, the MEKF filters the WHOLE sequence with one
fused `lax.scan` on device; per-frame Python looping only happens when
per-frame rendering was requested.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import jax
import jax.numpy as jnp

from aruco_slam_tpu.config import SlamAppConfig
from aruco_slam_tpu.core import camera as cam_mod
from aruco_slam_tpu.filters import (
    FrameObservations, MekfConfig, init_state, mekf_scan, mekf_step)
from aruco_slam_tpu.filters import mekf as mekf_mod
from aruco_slam_tpu.graph import (
    GraphConfig, add_frame, init_graph, landmark_covariances,
    marginalize_poses, optimize_window)
from aruco_slam_tpu.io import TrajectoryWriter, save_map
from aruco_slam_tpu.io.sources import (
    VIDEO_SUFFIXES, NpzSource, VideoSource, is_video)
from aruco_slam_tpu.ops import pnp


def _observations_from_frames(frame_iter, cam, cfg: SlamAppConfig,
                              chunk: int = 32):
    """Image-domain front end over a (timestamp, gray) iterator:
    batched detection + PnP in fixed-size chunks.

    Slots are decoupled from marker ids by an id->slot table
    (ops/detect.detect_markers_mapped): slots are claimed in
    first-seen order, so ``cfg.capacity`` bounds the number of
    DISTINCT MARKERS PRESENT — dict_5x5_1000 or apriltag_36h11 runs
    need no capacity inflation (the reference keys landmarks by
    encounter order the same way, reference
    filters/extended_kalman_filter.py:239-290). The final table
    (slot -> marker id) is returned so the map file records true ids.

    Pipelined by construction: each chunk's detect+PnP is DISPATCHED
    (JAX async) and the loop immediately goes back to decoding the
    next chunk on the host — host video decode and device detection
    overlap; nothing blocks until the final gather. The tail chunk is
    zero-padded to the chunk size so the whole video runs one compiled
    program (a new batch shape would recompile the detector)."""
    from aruco_slam_tpu.ops import detect
    dcfg = detect.with_preset(
        detect.DetectorConfig(capacity=cfg.capacity,
                              dict_name=cfg.dict_name,
                              slot_max_age=cfg.slot_max_age),
        cfg.detector)
    times, buf, outs = [], [], []
    table = [detect.slot_table_init(dcfg.capacity)]
    seen = [jnp.zeros(dcfg.capacity, jnp.int32)]
    fidx = [0]

    ke = cfg.track_every
    if ke and cfg.slot_max_age:
        raise ValueError("--slot-max-age with --track-every is not "
                         "supported yet: the streaming carry does not "
                         "thread the LRU table")
    if ke:
        # streaming front end: the chunk runs as ONE scan whose carry
        # (corners, mask, velocity, id->slot table, frame index)
        # crosses chunk boundaries via `track_cr`; schedule = the
        # shared ops/detect.streaming_step (full on 2 bootstrap frames
        # per period + immediate re-acquire when tracking empties)
        @jax.jit
        def tracked_chunk(cr, ims):
            return jax.lax.scan(
                detect.streaming_step(dcfg, ke, mapped=True), cr, ims)

        track_cr = [detect.streaming_init(dcfg, mapped=True)]

    def flush():
        n = len(buf)
        if not n:
            return
        if n < chunk:
            buf.extend([np.zeros_like(buf[0])] * (chunk - n))
        ims = jnp.asarray(np.stack(buf))
        if ke:
            track_cr[0], (det_c, det_m) = tracked_chunk(track_cr[0], ims)
            reset = jnp.zeros(det_m.shape, bool)
            ids_f = jnp.zeros(det_m.shape, jnp.int32)
            dropped = jnp.zeros(det_m.shape[0], jnp.int32)
        else:
            # LRU batch path even at slot_max_age=0: identical slot
            # assignments, but table saturation is COUNTED, not silent
            det_c, det_m, reset, ids_f, table[0], seen[0], dropped = \
                detect.detect_markers_batch_lru(
                    ims, dcfg, table[0], seen[0], fidx[0])
        fidx[0] += n
        res = pnp.solve_square_pnp(cam, det_c, cfg.marker_size)
        mask = det_m & (res.err < cfg.max_reproj_px)
        amb = res.err / jnp.maximum(res.err2, 1e-9)
        # device arrays, not np: keep the dispatch asynchronous
        outs.append((res.t_cl, res.q_cl, mask, amb, reset, ids_f,
                     dropped, n))
        buf.clear()

    for ts, gray in frame_iter:
        times.append(ts)
        buf.append(gray)
        if len(buf) == chunk:
            flush()
    flush()
    if not times:
        raise ValueError("no decodable frames")
    cat = lambda i: np.concatenate(
        [np.asarray(o[i])[:o[-1]] for o in outs])
    slot_ids = np.asarray(track_cr[0][3] if ke else table[0])
    dropped_ids = int(sum(np.asarray(o[6])[:o[-1]].sum()
                          for o in outs))
    if dropped_ids:
        print(f"WARNING: {dropped_ids} marker sightings found NO free "
              f"slot (id->slot table saturated at capacity "
              f"{dcfg.capacity}); raise --capacity or set "
              "--slot-max-age N to recycle stale slots")
    reset_seq = cat(4) if cfg.slot_max_age else None
    ids_seq = cat(5) if cfg.slot_max_age else None
    return (np.asarray(times), cat(0), cat(1), cat(2), cam, cat(3),
            slot_ids, reset_seq, ids_seq)


def _observations_from_frames_sharded(frame_iter, cam,
                                      cfg: SlamAppConfig, pid: int,
                                      nproc: int, chunk: int = 32,
                                      total: int | None = None):
    """Distributed image front end (run_offline --distributed):
    chunk c's HEAVY candidate pipeline (threshold/flood/harvest/
    subpix/decode — ~95% of detection) runs only on process
    c % nproc; the small per-frame candidate arrays are all-gathered
    and the cheap sequential id->slot scan + batched PnP replicate
    deterministically on every process, so the detected observations
    are bit-identical to the single-process front end while detection
    wall time scales ~linearly with processes (host video decode
    stays replicated — it is not the bottleneck). VERDICT r3 #5: the
    previous prologue re-ran FULL detection everywhere."""
    from aruco_slam_tpu.ops import detect
    if cfg.track_every:
        raise ValueError("--distributed ingest shards full detection; "
                         "tracked streaming (--track-every) is "
                         "sequential — drop one of the two flags")
    dcfg = detect.with_preset(
        detect.DetectorConfig(capacity=cfg.capacity,
                              dict_name=cfg.dict_name,
                              slot_max_age=cfg.slot_max_age),
        cfg.detector)
    if total is not None:  # short inputs: every process owns >=1 chunk
        chunk = max(1, min(chunk, -(-total // nproc)))
    cand_fn = functools.partial(detect.detect_candidates_batch,
                                cfg=dcfg)

    times, buf = [], []
    mine = []          # this process's chunks, in order
    n_chunks = 0

    def flush():
        nonlocal n_chunks
        n = len(buf)
        if not n:
            return
        if n < chunk:
            buf.extend([np.zeros_like(buf[0])] * (chunk - n))
        if n_chunks % nproc == pid:
            out = cand_fn(jnp.asarray(np.stack(buf)))
            mine.append([np.asarray(a) for a in out])
        n_chunks += 1
        buf.clear()

    for ts, gray in frame_iter:
        times.append(ts)
        buf.append(gray)
        if len(buf) == chunk:
            flush()
    flush()
    if not times:
        raise ValueError("no decodable frames")

    # all-gather the candidate chunks (uniform shape per process:
    # pad the chunk COUNT, reassemble round-robin)
    from jax.experimental import multihost_utils
    mmax = -(-n_chunks // nproc)
    if not mine:       # more processes than chunks
        raise ValueError(
            f"process {pid} owns no chunks ({n_chunks} chunks over "
            f"{nproc} processes): use fewer processes")
    local = [np.stack([m[j] for m in mine]
                      + [np.zeros_like(mine[0][j])]
                      * (mmax - len(mine)))
             for j in range(4)]
    gathered = [multihost_utils.process_allgather(a) for a in local]
    ordered = [
        np.concatenate([g[c % nproc, c // nproc] for c in
                        range(n_chunks)])
        for g in gathered]                       # (n_chunks*chunk, ...)

    tlen = len(times)
    slot_c, slot_m, reset, ids_seq, table_ids, _seen, dropped = \
        detect.assign_sequence_lru(
            dcfg, detect.slot_table_init(dcfg.capacity),
            jnp.zeros(dcfg.capacity, jnp.int32), 0,
            *(jnp.asarray(a) for a in ordered))
    slot_c, slot_m, reset, ids_seq = (slot_c[:tlen], slot_m[:tlen],
                                      reset[:tlen], ids_seq[:tlen])
    res = pnp.solve_square_pnp(cam, slot_c, cfg.marker_size)
    mask = slot_m & (res.err < cfg.max_reproj_px)
    amb = res.err / jnp.maximum(res.err2, 1e-9)
    dropped_ids = int(np.asarray(dropped)[:tlen].sum())
    if dropped_ids and pid == 0:
        print(f"WARNING: {dropped_ids} marker sightings found NO free "
              f"slot (id->slot table saturated at capacity "
              f"{dcfg.capacity}); raise --capacity or set "
              "--slot-max-age N to recycle stale slots")
    return (np.asarray(times), np.asarray(res.t_cl),
            np.asarray(res.q_cl), np.asarray(mask), cam,
            np.asarray(amb), np.asarray(table_ids),
            np.asarray(reset) if cfg.slot_max_age else None,
            np.asarray(ids_seq) if cfg.slot_max_age else None)


def epoch_remap(t_cl, q_cl, mask, reset, ids_seq):
    """Split recycled slots into per-epoch landmark columns.

    The batch graph keys landmarks by COLUMN; LRU recycling
    (--slot-max-age) makes one detector slot host several physical
    markers over the run, so feeding slot columns straight into the
    graph would merge two markers into one landmark and corrupt the
    solve. Both graph drivers (run_offline's batch solve and
    run_slam's online windowed graph) load the whole sequence up
    front, so the fix is a host-side relayout: each (slot, epoch)
    pair — epoch = number of resets of that slot up to the frame —
    gets its OWN column. The
    MEKF handles the same situation online by re-initializing through
    consistent augmentation instead (filters/mekf.py reset handling);
    the reference never faces this because its landmark registration
    is unbounded (reference filters/factor_graph.py:226-264).

    Returns (t_cl, q_cl, mask, col_ids) with L = #observed
    (slot, epoch) pairs columns; ``col_ids`` maps column -> true
    marker id (from ``ids_seq``, the per-frame table snapshots —
    the final table only remembers each slot's LAST tenant)."""
    t, c = mask.shape
    epoch = np.cumsum(np.asarray(reset, np.int64), axis=0)  # (T, C)
    key = epoch * c + np.arange(c)[None, :]
    used = np.unique(key[mask])
    col = np.searchsorted(used, key)                        # (T, C)
    l2 = len(used)
    rows = np.broadcast_to(np.arange(t)[:, None], (t, c))
    t_cl2 = np.zeros((t, l2) + t_cl.shape[2:], t_cl.dtype)
    q_cl2 = np.zeros((t, l2) + q_cl.shape[2:], q_cl.dtype)
    mask2 = np.zeros((t, l2), bool)
    t_cl2[rows[mask], col[mask]] = t_cl[mask]
    q_cl2[rows[mask], col[mask]] = q_cl[mask]
    mask2[rows[mask], col[mask]] = True
    col_ids = np.full(l2, -1, np.int64)
    col_ids[col[mask]] = ids_seq[mask]
    return t_cl2, q_cl2, mask2, col_ids


def _resolve_recycling(obs):
    """Normalize a loader 9-tuple: consume reset/ids_seq by epoch-
    splitting recycled slots into fresh landmark columns (no-op when
    nothing recycled). Returns the 7-tuple the solve consumes."""
    times, t_cl, q_cl, mask, cam, amb, slot_ids, reset, ids_seq = obs
    if reset is not None and np.asarray(reset).any():
        n0 = t_cl.shape[1]
        t_cl, q_cl, mask, slot_ids = epoch_remap(
            np.asarray(t_cl), np.asarray(q_cl), np.asarray(mask),
            np.asarray(reset), np.asarray(ids_seq))
        amb = None  # per-slot layout no longer matches; unused offline
        print(f"slot recycling: split {n0} detector slots into "
              f"{t_cl.shape[1]} per-epoch landmark columns")
    return times, t_cl, q_cl, mask, cam, amb, slot_ids


def load_camera(cfg: SlamAppConfig, calib_dir=None):
    """Camera from saved calibration artifacts (the reference's
    camera_matrix.npy + dist_coeffs.npy, reference
    filters/base_filter.py:55-63) or the config fallback."""
    from pathlib import Path
    k, d = cfg.camera_matrix, cfg.dist_coeffs
    if calib_dir:
        cd = Path(calib_dir)
        k = np.load(cd / "camera_matrix.npy")
        d = np.load(cd / "dist_coeffs.npy")
    return cam_mod.CameraModel.from_matrix(jnp.asarray(k),
                                           jnp.asarray(d))


def load_video_observations(cfg: SlamAppConfig, calib_dir=None,
                            shard=None):
    """Decode a video file (host) and run the image-domain front end
    — the reference's primary input path (reference
    main/run_slam.py:96-121).

    The decode runs on a background thread feeding a native ring
    (io/native.PrefetchingFrameSource), so frame decode overlaps BOTH
    the host-side chunk assembly and the device detection that JAX
    async dispatch already overlaps. ``shard=(pid, nproc)`` shards the
    candidate pipeline across processes
    (_observations_from_frames_sharded)."""
    import itertools

    cam = load_camera(cfg, calib_dir)
    vs = VideoSource(cfg.input)
    it = vs.frames()
    try:
        first = next(it)
    except StopIteration:
        raise ValueError(f"{cfg.input}: no decodable frames") from None
    try:
        from aruco_slam_tpu.io.native import PrefetchingFrameSource
        rest = PrefetchingFrameSource(it, first[1].shape, capacity=16)
    except RuntimeError as e:  # no C++ toolchain: plain iterator
        print(f"decode prefetch unavailable ({e}); synchronous decode")
        rest = it
    frames = itertools.chain([first], rest)
    try:
        if shard and shard[1] > 1:
            return _observations_from_frames_sharded(
                frames, cam, cfg, shard[0], shard[1])
        return _observations_from_frames(frames, cam, cfg)
    except ValueError as e:
        raise ValueError(f"{cfg.input}: {e}") from e


def load_observations(src: NpzSource, cfg: SlamAppConfig, shard=None):
    """Return (times, t_cl (T,C,3), q_cl (T,C,4), mask (T,C), cam,
    ambiguity, slot_ids, reset, ids_seq). ``slot_ids`` maps slot ->
    marker id for image-domain inputs (the id->slot table); None for
    corner-/pose-level bundles, whose slot index IS the marker id.
    ``reset`` (T, C) flags slots the LRU table recycled (forwarded to
    FrameObservations.reset); ``ids_seq`` (T, C) is the id occupying
    each slot at each frame (the offline epoch split needs ids the
    recycling overwrote); both None without --slot-max-age."""
    k = src["camera_matrix"] if src.has("camera_matrix") \
        else cfg.camera_matrix
    d = src["dist_coeffs"] if src.has("dist_coeffs") else cfg.dist_coeffs
    cam = cam_mod.CameraModel.from_matrix(jnp.asarray(k), jnp.asarray(d))
    marker_size = float(src["marker_size"]) if src.has("marker_size") \
        else cfg.marker_size
    cfg.marker_size = marker_size  # downstream consumers (R scaling)
    if src.has("images"):
        imgs = src["images"]
        if shard and shard[1] > 1:
            return _observations_from_frames_sharded(
                zip(src.times, imgs), cam, cfg, shard[0], shard[1],
                total=len(imgs))
        return _observations_from_frames(
            zip(src.times, imgs), cam, cfg)
    if src.has("corners"):
        res = pnp.solve_square_pnp(
            cam, jnp.asarray(src["corners"]), marker_size)
        mask = jnp.asarray(src["corner_mask"]) \
            & (res.err < cfg.max_reproj_px)
        amb = res.err / jnp.maximum(res.err2, 1e-9)
        return (src.times, np.asarray(res.t_cl), np.asarray(res.q_cl),
                np.asarray(mask), cam, np.asarray(amb), None, None,
                None)
    if src.has("t_cl"):
        return (src.times, src["t_cl"], src["q_cl"], src["mask"], cam,
                None, None, None, None)
    raise ValueError(
        f"{src.path}: no 'images', 'corners', or 't_cl' observations")


def _auto_max_obs(cfg: SlamAppConfig, mask, capacity: int) -> int:
    """Update-compaction width for a sequence: frames observing more
    than max_obs slots would silently drop the extras (filters/mekf.py
    measurement compaction), so size it from the densest frame."""
    max_vis = int(np.asarray(mask).sum(axis=-1).max())
    if cfg.max_obs:
        if max_vis > cfg.max_obs:
            print(f"WARNING: --max-obs {cfg.max_obs} < densest frame "
                  f"({max_vis} markers): extra observations will be "
                  "dropped")
        return cfg.max_obs
    return min(capacity, max(16, -(-max_vis // 8) * 8))


def _mekf_config(cfg: SlamAppConfig, capacity: int, max_obs: int,
                 with_rotations: bool, cam) -> MekfConfig:
    """One place mapping driver flags -> MekfConfig (shared by the
    single-stream and multi-stream serving paths)."""
    return MekfConfig(capacity=capacity, max_obs=max_obs,
                      with_rotations=with_rotations,
                      r_uncertainty=cfg.mekf_r,
                      q_uncertainty_cam=cfg.mekf_q_cam,
                      q_error_uncertainty_cam=cfg.mekf_q_rot,
                      q_uncertainty_lm=cfg.mekf_q_lm,
                      motion_model=cfg.mekf_motion_model,
                      q_vel=cfg.mekf_q_vel,
                      vel_decay=cfg.mekf_vel_decay,
                      matmul_precision=cfg.mekf_precision,
                      pixel_sigma=cfg.pixel_sigma,
                      focal_px=float(cam.fx),
                      marker_size=cfg.marker_size,
                      gate_distance=cfg.gate_distance)


def run_mekf(cfg: SlamAppConfig, times, t_cl, q_cl, mask, cam,
             with_rotations: bool, viewers=(), load_map_file=None,
             ambiguity=None, ckpt_every: int = 0, ckpt_path=None,
             resume=None, slot_ids=None, reset=None):
    max_obs = _auto_max_obs(cfg, mask, t_cl.shape[1])
    fcfg = _mekf_config(cfg, t_cl.shape[1], max_obs, with_rotations,
                        cam)
    state = init_state(fcfg)
    if load_map_file:
        from aruco_slam_tpu.io import load_map as _load
        from aruco_slam_tpu.filters.mekf import preload_map
        ids, pos, unc = _load(load_map_file)
        if slot_ids is not None:
            # id->slot layout: translate the map's marker ids to this
            # run's slots; map landmarks the sequence never observed
            # have no slot and are skipped (they could not receive an
            # update anyway)
            lut = {int(mid): s for s, mid in enumerate(slot_ids)
                   if mid >= 0}
            keep = [j for j in range(len(ids)) if int(ids[j]) in lut]
            if len(keep) < len(ids):
                print(f"load-map: {len(ids) - len(keep)} landmarks "
                      "not observed in this sequence; skipped")
            pos, unc = pos[keep], unc[keep]
            ids = np.array([lut[int(ids[j])] for j in keep],
                           np.int64)
        if len(ids):
            state = preload_map(fcfg, state, ids, pos, unc)
    seq = FrameObservations(
        jnp.asarray(t_cl), jnp.asarray(q_cl), jnp.asarray(mask),
        None if ambiguity is None else jnp.asarray(ambiguity),
        None if reset is None else jnp.asarray(reset))
    tt = len(times)
    start = 0
    cam_traj = np.zeros((tt, 7), np.float32)
    if resume:
        from aruco_slam_tpu.utils.checkpoint import load_checkpoint
        state, fdone, traj_prev = load_checkpoint(
            resume, (state, np.int64(0), np.zeros((1, 7), np.float32)))
        start = int(fdone)
        cam_traj[:start] = np.asarray(traj_prev)[:start]
        for v in viewers:  # align frame providers with the skip
            getattr(v, "skip_to", lambda i: None)(start)
        print(f"resumed from {resume} at frame {start}")

    def checkpoint(frame_done):
        if not ckpt_every or ckpt_path is None:
            return
        from aruco_slam_tpu.utils.checkpoint import save_checkpoint
        save_checkpoint(ckpt_path, (state, np.int64(frame_done),
                                    cam_traj[:frame_done]))

    if not viewers:
        t0 = time.perf_counter()
        step = ckpt_every if ckpt_every else tt - start
        for s in range(start, tt, max(step, 1)):
            e = min(s + step, tt)
            chunk = jax.tree.map(lambda a: a[s:e], seq)
            state, traj_chunk = mekf_scan(fcfg, state, chunk)
            cam_traj[s:e] = np.asarray(traj_chunk)
            if e < tt:
                checkpoint(e)
        dt = time.perf_counter() - t0
        done = tt - start
        print(f"fused scan: {done} frames in {dt:.3f}s "
              f"({done / dt:.1f} fps)")
    else:
        from aruco_slam_tpu.apps import sinks
        for i in range(start, tt):
            state = mekf_step(fcfg, state, FrameObservations(
                seq.t_cl[i], seq.q_cl[i], seq.mask[i],
                None if seq.ambiguity is None else seq.ambiguity[i],
                None if seq.reset is None else seq.reset[i]))
            cam_traj[i] = np.asarray(mekf_mod.camera_pose(state))
            _feed_viewers(viewers, cam_traj[i], state.lm,
                          state.active, t_cl[i], q_cl[i], mask[i],
                          slot_ids=slot_ids)
            if sinks.stop_requested(viewers):
                # the live window's 'q': end the RUN, like the
                # reference's loop break (reference main/run_slam.py:127-141)
                cam_traj = cam_traj[:i + 1]
                break
            if ckpt_every and (i + 1) % ckpt_every == 0 and i + 1 < tt:
                checkpoint(i + 1)
    if int(state.dropped_obs):
        print(f"WARNING: {int(state.dropped_obs)} observations were "
              f"dropped by the max_obs={fcfg.max_obs} update "
              "compaction (densest frames exceeded it); raise "
              "--max-obs")
    unc = np.asarray(mekf_mod.landmark_uncertainties(fcfg, state))
    active = np.asarray(state.active)
    lm = np.asarray(state.lm)[:, :3]
    return cam_traj, active, lm, unc[:, :3]


def run_factorgraph(cfg: SlamAppConfig, times, t_cl, q_cl, mask, cam,
                    viewers=(), ckpt_every: int = 0, ckpt_path=None,
                    resume=None, with_rotations: bool = False,
                    slot_ids=None):
    t = len(times)
    budget = cfg.pose_budget
    if budget and budget < t + 2:
        max_poses = max(budget, 2 * cfg.window + 4)
        if max_poses > budget:
            print(f"pose budget raised {budget} -> {max_poses}: the "
                  f"{cfg.window}-pose window needs headroom to "
                  "marginalize safely")
        max_factors = int(mask.sum(1).max()) * max_poses + 8
    else:
        max_poses, max_factors = t + 2, int(mask.sum()) + 8
    gcfg = GraphConfig(max_poses=max_poses,
                       max_landmarks=t_cl.shape[1],
                       max_factors=max_factors,
                       meas_sigma_t=cfg.meas_sigma_t,
                       odom_sigma_t=cfg.odom_sigma_t,
                       odom_sigma_rot=cfg.odom_sigma_rot,
                       pixel_sigma=cfg.pixel_sigma,
                       focal_px=float(cam.fx),
                       marker_size=cfg.marker_size,
                       huber_delta=cfg.huber_delta,
                       with_rotations=with_rotations)
    state = init_graph(gcfg)
    t_cl_d = jnp.asarray(t_cl)
    q_cl_d = jnp.asarray(q_cl) if with_rotations else None
    mask_d = jnp.asarray(mask)
    # pose count is deterministic (add_frame +1 until cap, marginalize
    # -drop), so it's tracked HOST-side: the frame loop dispatches
    # without ever syncing on the device (the old int(state.num_poses)
    # read cost one round trip per frame)
    num, drop = 1, max_poses // 2
    start = 0
    head = np.zeros((0, 7), np.float32)
    if resume:
        from aruco_slam_tpu.utils.checkpoint import load_checkpoint
        state, fdone, head = load_checkpoint(
            resume, (state, np.int64(0), np.zeros((1, 7), np.float32)))
        start = int(fdone)
        head = np.asarray(head)[:start]
        num = int(state.num_poses)
        for v in viewers:  # align frame providers with the skip
            getattr(v, "skip_to", lambda i: None)(start)
        print(f"resumed from {resume} at frame {start}")
    traj_parts = []

    def materialize():
        tail = np.concatenate(
            [np.asarray(jnp.stack([p for p, _ in traj_parts])),
             np.asarray(jnp.stack([q for _, q in traj_parts]))],
            axis=1) if traj_parts else np.zeros((0, 7), np.float32)
        return np.concatenate([head, tail.astype(np.float32)])

    t0 = time.perf_counter()
    for i in range(start, t):
        state = add_frame(gcfg, state, t_cl_d[i], mask_d[i],
                          None if q_cl_d is None else q_cl_d[i])
        num = min(num + 1, max_poses)
        state, _ = optimize_window(gcfg, state, window=cfg.window,
                                   iters=cfg.window_iters)
        cur = num - 2
        traj_parts.append((state.pose_t[cur], state.pose_q[cur]))
        if budget and num >= max_poses - 1:
            state = marginalize_poses(gcfg, state, drop)
            num = max(num - drop, 1)
        if viewers:
            pose_i = np.concatenate([np.asarray(traj_parts[-1][0]),
                                     np.asarray(traj_parts[-1][1])])
            _feed_viewers(viewers, pose_i, state.lm,
                          state.lm_active, t_cl[i], q_cl[i], mask[i],
                          slot_ids=slot_ids)
            from aruco_slam_tpu.apps import sinks
            if sinks.stop_requested(viewers):
                break  # live window 'q' ends the run
        if ckpt_every and ckpt_path and (i + 1) % ckpt_every == 0 \
                and i + 1 < t:
            from aruco_slam_tpu.utils.checkpoint import save_checkpoint
            save_checkpoint(ckpt_path,
                            (state, np.int64(i + 1), materialize()))
    cam_traj = materialize()
    dt = time.perf_counter() - t0
    done = t - start
    print(f"factorgraph online: {done} frames in {dt:.3f}s "
          f"({done / dt:.1f} fps)")
    cov = np.asarray(landmark_covariances(gcfg, state))
    unc = np.diagonal(cov, axis1=-2, axis2=-1)
    return cam_traj, np.asarray(state.lm_active), \
        np.asarray(state.lm), unc


def _stream_path(path: str, i: int) -> str:
    """Per-stream output path: outputs/trajectory.txt -> _s0/_s1/..."""
    from pathlib import Path
    pp = Path(path)
    return str(pp.with_name(f"{pp.stem}_s{i}{pp.suffix}"))


def _load_stream_frames(path: str, cfg: SlamAppConfig, calib_dir):
    """One stream's (times, frames (T, H, W) uint8, cam-or-None, src)."""
    if is_video(path):
        vs = VideoSource(path)
        pairs = list(vs.frames())
        if not pairs:
            raise ValueError(f"{path}: no decodable frames")
        times = np.asarray([t for t, _ in pairs])
        frames = np.stack([f for _, f in pairs])
        return times, frames, None, None
    src = NpzSource(path)
    if not src.has("images"):
        raise ValueError(f"{path}: multi-stream serving needs image "
                         "input (npz 'images' or video)")
    cam = None
    if src.has("camera_matrix"):
        cam = cam_mod.CameraModel.from_matrix(
            jnp.asarray(src["camera_matrix"]),
            jnp.asarray(src["dist_coeffs"] if src.has("dist_coeffs")
                        else cfg.dist_coeffs))
    return src.times, src["images"], cam, src


def run_multi_stream(cfg: SlamAppConfig, inputs: list[str], args,
                     chunk: int = 32) -> None:
    """Online multi-camera serving: S independent streams through the
    batched image->pose pipeline in one program per chunk — the
    product surface over parallel/multi_slam.batched_mekf_scan
    (BASELINE config 5; the reference's one-camera driver, reference
    main/run_slam.py:82, scaled to fleets).

    Per-stream id->slot tables keep marker ids decoupled from slots
    independently per camera; outputs land in per-stream files
    (trajectory_s0.txt, map_s0.txt, ...). With more than one JAX
    device and S divisible by the device count, the stream axis is
    sharded over a 1-D mesh for detection, PnP and filtering alike —
    streams are independent, so every stage scales linearly
    (parallel/multi_slam.batched_image_slam's layout).

    Matching single-stream runs: detection + PnP run the identical
    per-frame programs (chunked exactly like the single-stream front
    end), so with a shared ``--max-obs`` each stream's trajectory is
    bitwise what `--input <that stream alone>` produces
    (tests/test_io_apps.py::test_multi_stream_cli_matches_single).
    """
    from aruco_slam_tpu.ops import detect

    loaded = [_load_stream_frames(p, cfg, args.calib) for p in inputs]
    s = len(loaded)
    tlen = min(len(t) for t, _, _, _ in loaded)
    if any(len(t) != tlen for t, _, _, _ in loaded):
        print(f"streams have unequal lengths; truncating all to "
              f"{tlen} frames")
    times = loaded[0][0][:tlen]
    cam = next((c for _, _, c, _ in loaded if c is not None), None)
    if cam is None:
        cam = load_camera(cfg, args.calib)
    for _, _, _, src in loaded:  # npz marker size, like the 1-stream path
        if src is not None and src.has("marker_size"):
            cfg.marker_size = float(src["marker_size"])
            break
    frames = np.stack([f[:tlen] for _, f, _, _ in loaded])  # (S,T,H,W)
    shard = None
    ndev = len(jax.devices())
    if ndev > 1 and s % ndev == 0:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec
        mesh = Mesh(np.array(jax.devices()), ("data",))
        shard = NamedSharding(mesh, PartitionSpec("data"))
        print(f"sharding {s} streams over {ndev} devices")

    dcfg = detect.with_preset(
        detect.DetectorConfig(capacity=cfg.capacity,
                              dict_name=cfg.dict_name),
        cfg.detector)
    ke = cfg.track_every

    if ke:
        step = detect.streaming_step(
            dcfg, ke, streams=s, mapped=True,
            rescue_cohorts=cfg.rescue_cohorts)

        @jax.jit
        def detect_chunk(carry, ims_ts):  # ims (T, S, H, W) time-major
            carry, (cs, ms) = jax.lax.scan(step, carry, ims_ts)
            return carry, cs, ms

        carry = detect.streaming_init(dcfg, streams=s, mapped=True)
    else:
        @jax.jit
        def detect_chunk(tables, ims):    # ims (S, T, H, W)
            cs, ms, tables = jax.vmap(
                lambda im, tb: detect.detect_markers_batch_mapped(
                    im, dcfg, tb))(ims, tables)
            return tables, cs, ms

        carry = detect.slot_table_init(dcfg.capacity, streams=s)

    outs = []
    for c0 in range(0, tlen, chunk):
        ims = frames[:, c0:c0 + chunk]
        n = ims.shape[1]
        if n < chunk:  # zero-pad the tail: one compiled program
            ims = np.concatenate(
                [ims, np.zeros((s, chunk - n) + ims.shape[2:],
                               ims.dtype)], axis=1)
        # the stream axis leads: sharded arrays put each stream's
        # detection on its own device
        ims = jax.device_put(ims, shard) if shard else jnp.asarray(ims)
        if ke:
            carry, cs, ms = detect_chunk(
                carry, jnp.swapaxes(ims, 0, 1))
            cs, ms = jnp.swapaxes(cs, 0, 1), jnp.swapaxes(ms, 0, 1)
        else:
            carry, cs, ms = detect_chunk(carry, ims)
        res = pnp.solve_square_pnp(cam, cs, cfg.marker_size)
        mask = ms & (res.err < cfg.max_reproj_px)
        amb = res.err / jnp.maximum(res.err2, 1e-9)
        outs.append((res.t_cl, res.q_cl, mask, amb, n))
    cat = lambda i: np.concatenate(
        [np.asarray(o[i])[:, :o[4]] for o in outs], axis=1)
    t_cl, q_cl, mask, amb = cat(0), cat(1), cat(2), cat(3)
    tables = np.asarray(carry[3] if ke else carry)     # (S, C)

    max_obs = _auto_max_obs(cfg, mask, dcfg.capacity)
    fcfg = _mekf_config(cfg, dcfg.capacity, max_obs,
                        cfg.filter == "mekf_rotations", cam)
    from aruco_slam_tpu.parallel.multi_slam import (
        batched_mekf_scan, stack_states)
    states = stack_states([init_state(fcfg)] * s)
    obs = FrameObservations(jnp.asarray(t_cl), jnp.asarray(q_cl),
                            jnp.asarray(mask), jnp.asarray(amb))
    t0 = time.perf_counter()
    states, trajs = batched_mekf_scan(
        fcfg, states, obs, mesh=shard.mesh if shard else None)
    trajs = np.asarray(trajs)
    dt = time.perf_counter() - t0
    print(f"fleet scan: {s} streams x {tlen} frames in {dt:.3f}s "
          f"({s * tlen / dt:.1f} fps aggregate)")
    dropped = np.asarray(states.dropped_obs)
    if dropped.sum():
        print(f"WARNING: per-stream dropped observations "
              f"{dropped.tolist()} under max_obs={fcfg.max_obs}; "
              "raise --max-obs")

    unc = np.asarray(jax.vmap(
        lambda st: mekf_mod.landmark_uncertainties(fcfg, st))(states))
    active = np.asarray(states.active)
    lm = np.asarray(states.lm)[:, :, :3]
    for i in range(s):
        tf = _stream_path(cfg.trajectory_file, i)
        with TrajectoryWriter(tf) as w:
            for ts, pose in zip(times, trajs[i]):
                w.write(float(ts), pose)
        slots = np.where(active[i])[0]
        ids = tables[i][slots]
        mf = _stream_path(cfg.map_file, i)
        save_map(mf, ids, lm[i][slots], unc[i][:, :3][slots])
        line = f"stream {i}: {tf} ({tlen} poses), {mf} " \
               f"({len(ids)} landmarks)"
        src = loaded[i][3]
        if src is not None and src.has("gt_cam_t"):
            from aruco_slam_tpu.bench import ate
            err = ate.ate_rmse(trajs[i][:, :3], src["gt_cam_t"][:tlen])
            line += f", ATE {err:.4f} m"
        print(line)


def print_device() -> None:
    """One start-up line naming the devices this run computes on."""
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} "
          f"x{jax.device_count()}")


def _feed_viewers(viewers, cam_pose, lm, active, t_cl, q_cl, mask,
                  slot_ids=None):
    act = np.asarray(active)
    pts = np.asarray(lm)[:, :3][act]
    ids = None if slot_ids is None else np.asarray(slot_ids)
    # (pose, orientation, marker id) triples: the id lets the 2D
    # overlay draw the outline + label (slot index IS the id for
    # corner-/pose-level inputs)
    det = [(t_cl[j], q_cl[j], int(j) if ids is None else int(ids[j]))
           for j in np.where(np.asarray(mask))[0]]
    for v in viewers:
        v.view_frame(cam_pose, pts, det)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="On-device marker SLAM")
    p.add_argument("--input", required=True, help=".npz sequence")
    p.add_argument("--platform", default=None,
                   help="JAX platform override (cpu | gpu); default: "
                        "JAX's own choice")
    p.add_argument("--filter", default="mekf",
                   choices=["mekf", "mekf_rotations", "factorgraph"])
    p.add_argument("--trajectory", default="outputs/trajectory.txt")
    p.add_argument("--map", dest="map_file", default="outputs/map.txt")
    p.add_argument("--viz-2d", action="store_true")
    p.add_argument("--viz-3d", action="store_true")
    p.add_argument("--viz-3d-renderer", default="mpl",
                   choices=["mpl", "fast"],
                   help="3D export renderer: mpl = matplotlib figures "
                        "(axes/ticks, ~50 ms/frame), fast = the numpy "
                        "raster the live window uses (~1-2 ms/frame; "
                        "pick for long sequences)")
    p.add_argument("--display", action="store_true",
                   help="live interactive 2D window, 'q' quits (the "
                        "reference's cv2.imshow loop, reference "
                        "viewers/viewer_2d.py:103-106); falls back to "
                        "headless export when no GUI exists")
    p.add_argument("--viz-dir", default="outputs/images")
    p.add_argument("--export-video", action="store_true",
                   help="also write {viz_dir}/2d.mp4 / 3d.mp4 (the "
                        "reference's VideoWriter exports, reference "
                        "viewers/viewer_2d.py:46-56)")
    p.add_argument("--window", type=int, default=8)
    dflt = SlamAppConfig(input="")
    p.add_argument("--pose-budget", type=int, default=dflt.pose_budget,
                   help="bounded-memory online smoothing: marginalize "
                        "the oldest poses past this budget (0 = keep "
                        "every pose)")
    p.add_argument("--meas-sigma-t", type=float, default=dflt.meas_sigma_t)
    p.add_argument("--odom-sigma-t", type=float, default=dflt.odom_sigma_t)
    p.add_argument("--odom-sigma-rot", type=float,
                   default=dflt.odom_sigma_rot)
    p.add_argument("--load-map", default=None,
                   help="seed the filter with a saved map (the "
                        "reference's LOAD_MAP path, fixed + enabled)")
    p.add_argument("--calib", default=None,
                   help="directory with camera_matrix.npy + "
                        "dist_coeffs.npy (video input; the reference's "
                        "calibration artifacts)")
    p.add_argument("--detector", default=dflt.detector,
                   choices=["robust", "fast"],
                   help="full-sweep preset for image inputs: robust = "
                        "3-pass (window x scale) candidate sweep; "
                        "fast = single coarse pass (~3x cheaper, "
                        "clean scenes)")
    p.add_argument("--track-every", type=int, default=dflt.track_every,
                   metavar="K",
                   help="streaming detection for image/video input: "
                        "full sweep on 2 of every K frames, decode-"
                        "validated corner tracking in between (K >= 3;"
                        " 0 = full detection every frame)")
    p.add_argument("--rescue-cohorts", type=int, default=0,
                   metavar="G",
                   help="multi-stream serving with --track-every: "
                        "split the fleet into G schedule cohorts "
                        "(staggered K/G apart); a stream that loses "
                        "every marker triggers an immediate full "
                        "sweep of its own cohort instead of waiting "
                        "out the period. G must divide the stream "
                        "count; 0 = one shared schedule")
    p.add_argument("--slot-max-age", type=int, default=dflt.slot_max_age,
                   metavar="N",
                   help="recycle id->slot table slots whose marker "
                        "went unobserved for N frames once the table "
                        "is full (corridor runs traversing more than "
                        "--capacity distinct markers keep mapping; "
                        "evicted landmarks leave the final map). "
                        "0 = permanent slots; saturation is still "
                        "counted and warned")
    p.add_argument("--capacity", type=int, default=dflt.capacity,
                   help="landmark slots (simultaneously tracked "
                        "distinct markers for image inputs)")
    p.add_argument("--dict", dest="dict_name", default=dflt.dict_name,
                   help="marker dictionary for image inputs — any of "
                        "the standard cv2 predefined set "
                        "(dict_{4x4,5x5,6x6,7x7}_{50,100,250,1000}, "
                        "aruco_original, apriltag_{16h5,25h9,36h10,"
                        "36h11}; ops/dictionary.names())")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler device trace of the "
                        "filter run to DIR (view with XProf/"
                        "TensorBoard)")
    p.add_argument("--mekf-r", type=float, default=dflt.mekf_r)
    p.add_argument("--mekf-q-cam", type=float, default=dflt.mekf_q_cam)
    p.add_argument("--mekf-q-rot", type=float, default=dflt.mekf_q_rot)
    p.add_argument("--mekf-q-lm", type=float, default=dflt.mekf_q_lm)
    p.add_argument("--mekf-motion-model", default=dflt.mekf_motion_model,
                   choices=["none", "cv"],
                   help="camera predict: constant-velocity state (cv) "
                        "or the reference's static predict (none)")
    p.add_argument("--pixel-sigma", type=float,
                   default=dflt.pixel_sigma,
                   help="corner noise (px) for depth-scaled measurement "
                        "covariance in both backends; 0 = constant R "
                        "(reference behavior)")
    p.add_argument("--mekf-q-vel", type=float, default=dflt.mekf_q_vel)
    p.add_argument("--vel-decay", type=float,
                   default=dflt.mekf_vel_decay,
                   help="per-frame velocity decay under the cv model; "
                        "<1 bounds blind dead reckoning")
    p.add_argument("--precision", default=dflt.mekf_precision,
                   choices=["highest", "high", "mixed", "default"],
                   help="matmul precision of the filter update chain "
                        "on the GPU: highest = f32; high and default = "
                        "TF32 everywhere; mixed = TF32 covariance "
                        "products, f32 gain chain (the CPU computes "
                        "f32 under every name)")
    p.add_argument("--gate-distance", type=float,
                   default=dflt.gate_distance,
                   help="MEKF innovation gate (m); 0 = off")
    p.add_argument("--max-obs", type=int, default=dflt.max_obs,
                   help="MEKF update compaction width (markers per "
                        "frame); 0 = auto-size from the sequence")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save filter/graph state + partial trajectory "
                        "every N frames (0 = off)")
    p.add_argument("--checkpoint", default="outputs/checkpoint.npz",
                   help="checkpoint file path")
    p.add_argument("--resume", default=None,
                   help="resume a killed run from a checkpoint; "
                        "continues bit-exactly (tests/test_io_apps.py)")
    p.add_argument("--huber-delta", type=float, default=dflt.huber_delta,
                   help="robust BA loss delta (whitened); 0 = plain LS")
    p.add_argument("--ba-rotations", action="store_true",
                   help="factorgraph backend: 6-dof landmarks with "
                        "orientation residuals (graph/ba.py "
                        "with_rotations)")
    args = p.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print_device()

    cfg = SlamAppConfig(
        input=args.input, filter=args.filter,
        trajectory_file=args.trajectory, map_file=args.map_file,
        viz_2d=args.viz_2d, viz_3d=args.viz_3d, viz_dir=args.viz_dir,
        viz_3d_renderer=args.viz_3d_renderer,
        export_video=args.export_video,
        window=args.window, pose_budget=args.pose_budget,
        meas_sigma_t=args.meas_sigma_t,
        odom_sigma_t=args.odom_sigma_t,
        odom_sigma_rot=args.odom_sigma_rot,
        mekf_r=args.mekf_r, mekf_q_cam=args.mekf_q_cam,
        mekf_q_rot=args.mekf_q_rot, mekf_q_lm=args.mekf_q_lm,
        mekf_motion_model=args.mekf_motion_model,
        pixel_sigma=args.pixel_sigma,
        mekf_q_vel=args.mekf_q_vel,
        mekf_vel_decay=args.vel_decay,
        mekf_precision=args.precision,
        gate_distance=args.gate_distance,
        huber_delta=args.huber_delta,
        max_obs=args.max_obs,
        dict_name=args.dict_name,
        track_every=args.track_every,
        detector=args.detector,
        capacity=args.capacity,
        slot_max_age=args.slot_max_age,
        rescue_cohorts=args.rescue_cohorts)
    if args.track_every and args.track_every < 3:
        p.error("--track-every needs K >= 3 (2 full frames bootstrap "
                "the velocity prior)")
    if "," in args.input:
        # multi-camera serving: --input a.npz,b.npz,... fans the
        # streams through the batched pixels->pose pipeline
        if cfg.slot_max_age:
            p.error("--slot-max-age is not supported by multi-stream "
                    "serving yet (the fleet detector threads per-"
                    "stream id->slot tables without the LRU carry); "
                    "run corridor-scale streams individually")
        if cfg.filter == "factorgraph":
            p.error("multi-stream serving runs the MEKF backends; for "
                    "batch factor-graph fleets use run_offline --fleet")
        if args.viz_2d or args.viz_3d or args.display:
            print("note: viz/display are per-stream features; the "
                  "fleet path writes trajectories/maps only")
        run_multi_stream(cfg, [s for s in args.input.split(",") if s],
                         args)
        return
    if is_video(cfg.input):
        src = None
        times, t_cl, q_cl, mask, cam, amb, slot_ids, reset, _ids = \
            load_video_observations(cfg, args.calib)
    else:
        src = NpzSource(cfg.input)
        times, t_cl, q_cl, mask, cam, amb, slot_ids, reset, _ids = \
            load_observations(src, cfg)

    from aruco_slam_tpu.apps import sinks
    viewers = sinks.build_viewers(cfg, cam, src, display=args.display)

    from aruco_slam_tpu.utils.profiling import device_trace
    with device_trace(args.profile):
        if cfg.filter in ("mekf", "mekf_rotations"):
            cam_traj, active, lm, unc = run_mekf(
                cfg, times, t_cl, q_cl, mask, cam,
                with_rotations=(cfg.filter == "mekf_rotations"),
                viewers=viewers, load_map_file=args.load_map,
                ambiguity=amb, ckpt_every=args.checkpoint_every,
                ckpt_path=args.checkpoint, resume=args.resume,
                slot_ids=slot_ids, reset=reset)
        else:
            # the factor graph keys landmarks by COLUMN and has no
            # reset concept — epoch-split recycled slots into fresh
            # columns (the MEKF path above consumes `reset` natively
            # via re-initializing augmentation instead)
            times, t_cl, q_cl, mask, cam, amb, slot_ids = \
                _resolve_recycling((times, t_cl, q_cl, mask, cam, amb,
                                    slot_ids, reset, _ids))
            cam_traj, active, lm, unc = run_factorgraph(
                cfg, times, t_cl, q_cl, mask, cam, viewers=viewers,
                ckpt_every=args.checkpoint_every,
                ckpt_path=args.checkpoint, resume=args.resume,
                with_rotations=args.ba_rotations, slot_ids=slot_ids)

    for v in viewers:
        v.close()

    if len(cam_traj) < len(times):  # live window 'q' ended the run
        print(f"quit requested at frame {len(cam_traj)}/{len(times)}")
        times = times[:len(cam_traj)]
    with TrajectoryWriter(cfg.trajectory_file) as w:
        for ts, pose in zip(times, cam_traj):
            w.write(float(ts), pose)
    slots = np.where(active)[0]
    # under the id->slot table the map file records TRUE marker ids
    # (slot index == id for corner-/pose-level inputs)
    ids = slot_ids[slots] if slot_ids is not None else slots
    save_map(cfg.map_file, ids, lm[slots], unc[slots])
    print(f"wrote {cfg.trajectory_file} ({len(times)} poses), "
          f"{cfg.map_file} ({len(ids)} landmarks)")
    if src is not None and src.has("gt_cam_t"):
        from aruco_slam_tpu.bench import ate
        err = ate.ate_rmse(cam_traj[:, :3],
                           src["gt_cam_t"][:len(cam_traj)])
        print(f"ATE vs ground truth: {err:.4f} m")


if __name__ == "__main__":
    main()
