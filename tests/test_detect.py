"""Image-domain detector vs rendered ground truth and cv2 oracle."""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from aruco_slam_tpu.bench import synthetic, render
from aruco_slam_tpu.core import camera as cam_mod
from aruco_slam_tpu.ops import detect

K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])  # half-res reference intrinsics
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
SIZE = (960, 540)


@pytest.fixture(scope="module")
def rendered():
    cam = cam_mod.CameraModel.from_matrix(jnp.asarray(K2),
                                          jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=30)
    frames = render.render_sequence(scene, traj, cam, image_size=SIZE)
    corners, mask = synthetic.observe_corners(
        scene, traj, cam, 64, image_size=SIZE)
    return cam, scene, traj, frames, corners, mask


CFG = detect.DetectorConfig()


def test_detects_expected_ids(rendered):
    cam, scene, traj, frames, corners, mask = rendered
    for f in range(0, len(frames), 5):
        det = detect.detect_markers(jnp.asarray(frames[f]), CFG)
        got = set(np.where(np.asarray(det.mask))[0].tolist())
        expected = set(np.where(mask[f])[0].tolist())
        # expected-visible markers can be grazing/small; require
        # recall on all but at most one, and no false ids
        assert len(expected - got) <= 1, (f, expected, got)
        assert got <= expected, (f, expected, got)


def test_corner_accuracy(rendered):
    cam, scene, traj, frames, corners, mask = rendered
    errs = []
    for f in range(0, len(frames), 5):
        det = detect.detect_markers(jnp.asarray(frames[f]), CFG)
        for sid in np.where(np.asarray(det.mask))[0]:
            errs.append(np.abs(np.asarray(det.corners[sid])
                               - corners[f][sid]).max())
    assert len(errs) >= 20
    assert np.max(errs) < 1.5, np.max(errs)
    assert np.mean(errs) < 0.9, np.mean(errs)


def test_matches_cv2_detections(rendered):
    cam, scene, traj, frames, corners, mask = rendered
    p = cv2.aruco.DetectorParameters()
    cvdet = cv2.aruco.ArucoDetector(
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_50), p)
    for f in range(0, len(frames), 5):
        det = detect.detect_markers(jnp.asarray(frames[f]), CFG)
        ours = set(np.where(np.asarray(det.mask))[0].tolist())
        cr, ids, _ = cvdet.detectMarkers(frames[f])
        theirs = set(ids.ravel().tolist()) if ids is not None else set()
        assert ours == theirs, (f, ours, theirs)


def test_corner_order_matches_cv2(rendered):
    """Corner 0 must be the marker's canonical top-left (IPPE order)."""
    cam, scene, traj, frames, corners, mask = rendered
    cvdet = cv2.aruco.ArucoDetector(
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_50),
        cv2.aruco.DetectorParameters())
    det = detect.detect_markers(jnp.asarray(frames[0]), CFG)
    cr, ids, _ = cvdet.detectMarkers(frames[0])
    for i, sid in enumerate(ids.ravel()):
        if not det.mask[sid]:
            continue
        ours = np.asarray(det.corners[sid])
        theirs = cr[i].reshape(4, 2)
        # same corner order => pointwise distance small
        assert np.abs(ours - theirs).max() < 2.5, (sid, ours, theirs)


def test_empty_image():
    blank = jnp.full((540, 960), 178, jnp.uint8)
    det = detect.detect_markers(blank, CFG)
    assert not np.asarray(det.mask).any()


def test_tiny_frames_do_not_crash():
    """The two-level top-K block reduction must leave >= K entries;
    frames small enough that ceil(n/blk) < max_candidates fall back to
    the plain sort (round-3 advisor: 64x64 raised ValueError)."""
    for shape in ((64, 64), (48, 64)):
        blank = jnp.full(shape, 178, jnp.uint8)
        det = detect.detect_markers(blank, detect.DetectorConfig())
        assert not np.asarray(det.mask).any()


def test_noise_image_no_false_positives():
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 255, size=(540, 960), dtype=np.uint8)
    det = detect.detect_markers(jnp.asarray(noise), CFG)
    assert np.asarray(det.mask).sum() == 0


def test_batch_detection(rendered):
    cam, scene, traj, frames, corners, mask = rendered
    det = detect.detect_markers_batch(jnp.asarray(frames[:3]), CFG)
    assert det.corners.shape == (3, 64, 4, 2)
    single = detect.detect_markers(jnp.asarray(frames[1]), CFG)
    np.testing.assert_array_equal(np.asarray(det.mask[1]),
                                  np.asarray(single.mask))


def test_full_image_pipeline_ate(rendered):
    """frames -> detect -> PnP -> MEKF: the complete visual loop."""
    from aruco_slam_tpu.filters import (
        FrameObservations, MekfConfig, init_state, mekf_scan)
    from aruco_slam_tpu.ops import pnp
    from aruco_slam_tpu.bench import ate
    cam, scene, traj, frames, corners, mask = rendered
    det = detect.detect_markers_batch(jnp.asarray(frames), CFG)
    res = pnp.solve_square_pnp(cam, det.corners, scene.marker_size)
    obs = FrameObservations(
        t_cl=res.t_cl, q_cl=res.q_cl,
        mask=det.mask & (res.err < 3.0))
    fcfg = MekfConfig(capacity=64, r_uncertainty=1e-3,
                      q_uncertainty_cam=0.05,
                      q_error_uncertainty_cam=0.05,
                      q_uncertainty_lm=1e-5)
    final, cam_traj = mekf_scan(fcfg, init_state(fcfg), obs)
    err = ate.ate_rmse(np.asarray(cam_traj[:, :3]), traj.cam_t)
    # at 960x540 markers are ~35 px wide: PnP depth noise is a few
    # percent of range, so decimeter-level ATE is the physical floor
    assert err < 0.3, f"ATE {err}"


def test_full_image_pipeline_ba(rendered):
    """frames -> detect -> PnP -> batch BA: the offline visual loop."""
    from aruco_slam_tpu.graph import (
        GraphConfig, add_frame, batch_optimize, init_graph)
    from aruco_slam_tpu.ops import pnp
    from aruco_slam_tpu.bench import ate
    cam, scene, traj, frames, corners, mask = rendered
    det = detect.detect_markers_batch(jnp.asarray(frames), CFG)
    res = pnp.solve_square_pnp(cam, det.corners, scene.marker_size)
    okm = np.asarray(det.mask & (res.err < 3.0))
    t = len(frames)
    gcfg = GraphConfig(max_poses=t + 2, max_landmarks=64,
                       max_factors=int(okm.sum()) + 8,
                       dtype=jnp.float64, meas_sigma_t=0.03,
                       odom_sigma_t=1.0, odom_sigma_rot=1.0)
    state = init_graph(gcfg)
    tcl = np.asarray(res.t_cl)
    for i in range(t):
        state = add_frame(gcfg, state, jnp.asarray(tcl[i]),
                          jnp.asarray(okm[i]))
    state, _ = batch_optimize(gcfg, state, iters=30)
    err = ate.ate_rmse(np.asarray(state.pose_t)[:t], traj.cam_t)
    assert err < 0.2, f"ATE {err}"


DEGRADATIONS = {
    "blur": dict(blur_sigma=1.5),
    "motion": dict(motion_len=7, motion_angle=30.0),
    "noise": dict(noise_sigma=8.0),
    "lighting": dict(vignette_strength=0.55, gradient_strength=0.35),
    "combined": dict(blur_sigma=1.0, noise_sigma=6.0,
                     vignette_strength=0.4),
    # the hard half of real-camera artifacts (VERDICT r4 #8): 8x8 DCT
    # blocking/ringing from a real JPEG codec, and gain-amplified
    # signal-dependent shot noise from photon-starved capture
    "jpeg": dict(jpeg_quality=20),
    "lowlight": dict(low_light_exposure=0.12),
    "night_stream": dict(low_light_exposure=0.2, blur_sigma=0.8,
                         jpeg_quality=35),
}


class TestDegraded:
    """Detection must survive realistic imagery — blur, noise,
    vignetting, lighting gradients, clutter — not just clean renders.
    Oracle: cv2.aruco on the SAME degraded frames (its adaptive window
    sweep 3-30, reference filters/base_filter.py:84-88, is the
    robustness bar)."""

    @pytest.fixture(scope="class")
    def cvdet(self):
        return cv2.aruco.ArucoDetector(
            cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_50),
            cv2.aruco.DetectorParameters())

    @pytest.mark.parametrize("name", sorted(DEGRADATIONS))
    def test_recall_tracks_cv2(self, rendered, cvdet, name):
        from aruco_slam_tpu.bench import degrade
        cam, scene, traj, frames, corners, mask = rendered
        kw = DEGRADATIONS[name]
        miss = 0
        total_cv = 0
        for f in range(0, len(frames), 5):
            img = degrade.degrade(frames[f], seed=f, **kw)
            det = detect.detect_markers(jnp.asarray(img), CFG)
            ours = set(np.where(np.asarray(det.mask))[0].tolist())
            _, ids, _ = cvdet.detectMarkers(img)
            theirs = set(ids.ravel().tolist()) if ids is not None \
                else set()
            expected = set(np.where(mask[f])[0].tolist())
            # no hallucinated ids
            assert ours <= expected, (name, f, ours - expected)
            miss += len(theirs - ours)
            total_cv += len(theirs)
        # recall within ~1 marker of cv2 per sampled frame
        assert miss <= 6, (name, f"missed {miss} of cv2's {total_cv}")

    @pytest.mark.parametrize("name", ["blur", "noise", "combined"])
    def test_corner_accuracy_degraded(self, rendered, name):
        from aruco_slam_tpu.bench import degrade
        cam, scene, traj, frames, corners, mask = rendered
        kw = DEGRADATIONS[name]
        errs = []
        for f in range(0, len(frames), 5):
            img = degrade.degrade(frames[f], seed=f, **kw)
            det = detect.detect_markers(jnp.asarray(img), CFG)
            for sid in np.where(np.asarray(det.mask))[0]:
                errs.append(np.abs(np.asarray(det.corners[sid])
                                   - corners[f][sid]).max())
        assert len(errs) >= 10, name
        assert np.mean(errs) < 1.5, (name, np.mean(errs))
        assert np.max(errs) < 4.0, (name, np.max(errs))

    def test_cluttered_background(self, cvdet):
        """Distractor shapes must not displace real markers from the
        candidate set or produce false ids."""
        from aruco_slam_tpu.bench import degrade, render
        cam = cam_mod.CameraModel.from_matrix(jnp.asarray(K2),
                                              jnp.asarray(DIST))
        scene = synthetic.make_wall_scene(num_markers=10, seed=2)
        traj = synthetic.make_orbit_trajectory(num_frames=10)
        bg = degrade.clutter_background((SIZE[1], SIZE[0]), seed=7)
        frames = render.render_sequence(scene, traj, cam,
                                        image_size=SIZE, background=bg)
        _, mask = synthetic.observe_corners(scene, traj, cam, 64,
                                            image_size=SIZE)
        miss = 0
        for f in range(0, len(frames), 3):
            img = degrade.degrade(frames[f], noise_sigma=5.0, seed=f)
            det = detect.detect_markers(jnp.asarray(img), CFG)
            ours = set(np.where(np.asarray(det.mask))[0].tolist())
            _, ids, _ = cvdet.detectMarkers(img)
            theirs = set(ids.ravel().tolist()) if ids is not None \
                else set()
            expected = set(np.where(mask[f])[0].tolist())
            assert ours <= expected, (f, ours - expected)
            miss += len(theirs - ours)
        assert miss <= 4, f"missed {miss} vs cv2 on clutter"


def test_subpix_refine_matches_cv2_corner_subpix(rendered):
    """The batched structure-tensor refinement (the detector's stage 5)
    against cv2.cornerSubPix running the same coarse-to-fine schedule
    — two calls, 13x13 then 7x7 windows — from the same perturbed
    seeds on rendered corners. Both must land near the true corners
    and near each other (they differ only in window recentering:
    integer-rounded here, bilinear in cv2)."""
    cam, scene, traj, frames, corners, mask = rendered
    rng = np.random.default_rng(3)
    ours, theirs, truths = [], [], []
    for f in range(0, len(frames), 6):
        truth = corners[f][mask[f]].reshape(-1, 2)
        seeds = truth + rng.uniform(-2, 2, size=truth.shape)
        sched = ((6, 6), (3, 4))
        ours.append(np.asarray(detect._subpix_refine(
            jnp.asarray(frames[f]), jnp.asarray(seeds, jnp.float32),
            sched)))
        cv = seeds.astype(np.float32).reshape(-1, 1, 2).copy()
        img = frames[f].astype(np.float32)
        for half, iters in sched:
            cv = cv2.cornerSubPix(
                img, cv, (half, half), (-1, -1),
                (cv2.TERM_CRITERIA_COUNT + cv2.TERM_CRITERIA_EPS,
                 iters, 1e-3))
        theirs.append(cv.reshape(-1, 2))
        truths.append(truth)
    ours, theirs, truth = (np.concatenate(a)
                           for a in (ours, theirs, truths))
    assert len(truth) >= 40
    d_cv = np.abs(ours - theirs).max(-1)
    assert np.median(d_cv) < 0.1, np.median(d_cv)
    assert np.percentile(d_cv, 95) < 0.6, np.percentile(d_cv, 95)
    err_ours = np.abs(ours - truth).max(-1).mean()
    err_cv = np.abs(theirs - truth).max(-1).mean()
    assert err_ours < err_cv + 0.05, (err_ours, err_cv)


# (prop_iters, scan_rounds) budgets: the coarse passes' full budget,
# and the fine-downscale pass's HALF prop_iters (detect_markers keeps
# scan_rounds full: the segmented scans are what carries marker-scale
# convergence — scan_rounds=2 splits a 131-px marker into 4+ labels) —
# marker-scale shapes must converge at the halved budget too, so
# future tuning can't silently regress fine-pass separation
_FLOOD_BUDGETS = [(CFG.prop_iters, CFG.scan_rounds),
                  (max(16, CFG.prop_iters // 2), CFG.scan_rounds)]


# label grids of a 1080p frame: 270x480 (downscale 4, the coarse
# passes) and 540x960 (downscale 2, the fine pass)
@pytest.mark.parametrize(
    "shape,prop_iters,scan_rounds",
    [pytest.param((270, 480), it, sr, id=f"{it}-{sr}_{i}")
     for i, (it, sr) in enumerate(_FLOOD_BUDGETS)]
    + [pytest.param((540, 960), it, sr, id=f"540x960-{it}-{sr}_{i}")
       for i, (it, sr) in enumerate(_FLOOD_BUDGETS)])
def test_flood_converges_on_marker_shapes(shape, prop_iters,
                                          scan_rounds):
    """The stencil+segmented-scan flood must fully label rotated
    marker-shaped blobs (border ring + payload holes) at every size up
    to full frame — the shapes the detector exists for. Oracle:
    scipy.ndimage.label with 8-connectivity."""
    from scipy import ndimage

    h, w = shape
    for ang in (0, 15, 30, 45, 60):
        for size in (8, 64, 131, 260) + ((520,) if h > 270 else ()):
            fg = np.zeros((h, w), np.uint8)
            rect = cv2.boxPoints(
                ((w // 2, h // 2), (size, size), ang)).astype(np.int32)
            cv2.fillPoly(fg, [rect], 1)
            inner = cv2.boxPoints(
                ((w // 2, h // 2), (size * 5 / 7, size * 5 / 7), ang))
            for i in range(5):
                for j in range(5):
                    if (i + j) % 2:
                        continue
                    u, v = (i + 0.5) / 5, (j + 0.5) / 5
                    p = ((1 - u) * ((1 - v) * inner[0] + v * inner[1])
                         + u * ((1 - v) * inner[3] + v * inner[2]))
                    cv2.circle(fg, tuple(np.round(p).astype(int)),
                               max(1, int(size / 14)), 0, -1)
            fgb = fg.astype(bool)
            # _connected_components treats the outermost 1-px ring as
            # background — the oracle must see the same input
            fgb[0, :] = fgb[-1, :] = False
            fgb[:, 0] = fgb[:, -1] = False
            lab = np.asarray(detect._connected_components(
                jnp.asarray(fgb), prop_iters, scan_rounds=scan_rounds))
            oracle, n = ndimage.label(fgb, structure=np.ones((3, 3)))
            for comp in range(1, n + 1):
                got = set(lab[oracle == comp].tolist())
                assert len(got) == 1, (
                    f"ang {ang} size {size}: component {comp} "
                    f"split into {len(got)} labels")


class TestTracking:
    """Streaming detect-every-K: decode-validated corner tracking
    between full sweeps (ops/detect.track_markers / detect_or_track)."""

    @pytest.fixture(scope="class")
    def video_rate(self):
        """14 frames at video-rate motion (a 300-frame orbit sliced —
        the whole-orbit-in-14 default jumps ~100 px/frame)."""
        import jax
        cam = cam_mod.CameraModel.from_matrix(jnp.asarray(K2),
                                              jnp.asarray(DIST))
        scene = synthetic.make_wall_scene(num_markers=10, seed=0)
        traj = jax.tree.map(
            lambda a: a[:14],
            synthetic.make_orbit_trajectory(num_frames=300))
        frames = render.render_sequence(scene, traj, cam,
                                        image_size=SIZE)
        gt_corners, mask = synthetic.observe_corners(
            scene, traj, cam, 64, image_size=SIZE)
        return frames, gt_corners, mask

    def test_pure_tracking_follows(self, video_rate):
        """Track 13 consecutive frames with NO re-detection: survivors
        must stay pixel-accurate against the render ground truth (no
        drift) and never hallucinate."""
        frames, gt, vis = video_rate
        d0 = detect.detect_markers(jnp.asarray(frames[0]), CFG)
        n0 = int(np.asarray(d0.mask).sum())
        assert n0 >= 3
        c, m = d0.corners, d0.mask
        v = jnp.zeros_like(c)
        errs = []
        for f in range(1, len(frames)):
            c2, m2 = detect.track_markers(jnp.asarray(frames[f]),
                                          c, m, CFG, v)
            v = detect.track_velocity(c2, m2, c, m)
            c, m = c2, m2
            tids = set(np.where(np.asarray(m))[0].tolist())
            expected = set(np.where(vis[f])[0].tolist())
            assert tids <= expected, (f, tids - expected)
            for i in tids:
                diff = np.abs(np.asarray(c[i]) - gt[f][i]).max()
                assert diff < 2.5, (f, i, diff)
                errs.append(diff)
        # sub-px typical accuracy, same bar as the full detector's
        # corner test, and bounded attrition over 13 tracked frames
        assert np.mean(errs) < 1.0, np.mean(errs)
        assert int(np.asarray(m).sum()) >= n0 - 2

    def test_edge_adjacent_marker_stays_tracked(self, video_rate):
        """A fully-visible marker whose corners sit a few px from the
        frame border must survive tracking — the old track_win+4
        (12 px) in-frame margin invalidated it every tracked frame
        even though its refine windows fit and its payload decoded."""
        frames, gt, vis = video_rate
        img0 = np.asarray(frames[0])
        d0 = detect.detect_markers(jnp.asarray(img0), CFG)
        c0 = np.asarray(d0.corners)
        ids = np.where(np.asarray(d0.mask))[0]
        left_id = ids[int(np.argmin([c0[i][:, 0].min() for i in ids]))]
        # shift the whole frame left so that marker's leftmost corner
        # sits 6 px from the border (still fully visible)
        shift = int(c0[left_id][:, 0].min()) - 6
        assert shift > 0
        shifted = np.roll(img0, -shift, axis=1)
        seed = c0.copy()
        seed[..., 0] -= shift
        c, m = detect.track_markers(jnp.asarray(shifted),
                                    jnp.asarray(seed), d0.mask, CFG)
        assert np.asarray(m)[left_id], "edge-adjacent marker dropped"
        diff = np.abs(np.asarray(c[left_id]) - seed[left_id]).max()
        assert diff < 1.5, diff

    def test_detect_or_track_reacquires(self, video_rate):
        """With full sweeps 2 of every K frames, everything the
        full detector sees is acquired within one period, and tracked
        frames carry (nearly) the full set."""
        frames, _, vis = video_rate
        k = 5
        c = jnp.zeros((64, 4, 2), jnp.float32)
        m = jnp.zeros(64, bool)
        v = jnp.zeros_like(c)
        seen, seen_full = set(), set()
        tracked_counts, full_counts = [], []
        for f in range(len(frames)):
            c, m, v = detect.detect_or_track(
                jnp.asarray(frames[f]), c, m, v,
                jnp.asarray(f % k < 2), CFG)
            full = detect.detect_markers(jnp.asarray(frames[f]), CFG)
            seen |= set(np.where(np.asarray(m))[0].tolist())
            seen_full |= set(np.where(np.asarray(full.mask))[0].tolist())
            if f % k >= 2:
                tracked_counts.append(int(np.asarray(m).sum()))
                full_counts.append(int(np.asarray(full.mask).sum()))
        assert seen == seen_full, (seen, seen_full)
        # tracked frames keep most of what a full sweep would see
        assert sum(tracked_counts) >= sum(full_counts) - len(full_counts)


def test_all_standard_dictionaries_load_and_detect():
    """Every baked dictionary (scripts/bake_dictionaries.py — the full
    cv2 predefined set the reference can select from, reference
    filters/base_filter.py:82) loads, and detection end-to-end decodes
    the right ids for a sample of them, including >50-marker tables
    and 7x7 payloads."""
    from aruco_slam_tpu.ops import dictionary

    names = dictionary.names()
    assert len(names) >= 21, names
    for name in names:
        d = dictionary.load(name)
        assert d.table.shape == (d.num_markers * 4,
                                 d.marker_bits ** 2)

    cam = cam_mod.CameraModel.from_matrix(jnp.asarray(K2),
                                          jnp.asarray(DIST))
    for name, test_id in [("dict_7x7_50", 7), ("dict_4x4_250", 199),
                          ("aruco_original", 777)]:
        scene = synthetic.make_wall_scene(num_markers=3, seed=3)
        traj = synthetic.make_orbit_trajectory(num_frames=2)
        frames = render.render_sequence(
            scene, traj, cam, image_size=SIZE, dict_name=name,
            marker_ids=np.array([test_id, test_id + 1, test_id + 2]))
        cfg = detect.DetectorConfig(dict_name=name,
                                    capacity=test_id + 4)
        det = detect.detect_markers(jnp.asarray(frames[0]), cfg)
        got = set(np.where(np.asarray(det.mask))[0].tolist())
        expected = {test_id, test_id + 1, test_id + 2}
        assert got and got <= expected, (name, got, expected)


class TestMappedSlots:
    """id->slot table layout (detect_markers_mapped): capacity sized
    by markers PRESENT, not by the dictionary's id range — the role
    the reference fills by keying landmarks in encounter order
    (reference filters/extended_kalman_filter.py:239-290)."""

    @pytest.fixture(scope="class")
    def high_id_scene(self):
        """3 markers from dict_5x5_1000 with ids around 900 — under
        the slot==id layout this would need capacity >= 903."""
        import jax as _jax
        cam = cam_mod.CameraModel.from_matrix(jnp.asarray(K2),
                                              jnp.asarray(DIST))
        ids = np.array([900, 905, 910])
        scene = synthetic.make_wall_scene(num_markers=3, seed=3)
        # 4 video-rate frames (sliced from a 120-frame orbit so the
        # streaming tracker's motion assumptions hold)
        traj = _jax.tree.map(
            lambda a: a[:4],
            synthetic.make_orbit_trajectory(num_frames=120))
        frames = render.render_sequence(
            scene, traj, cam, image_size=SIZE,
            dict_name="dict_5x5_1000", marker_ids=ids)
        gt, vis = synthetic.observe_corners(scene, traj, cam, 3,
                                            image_size=SIZE)
        return frames, ids, gt, vis

    CFG1000 = detect.DetectorConfig(dict_name="dict_5x5_1000",
                                    capacity=8)

    def test_high_ids_fit_small_capacity(self, high_id_scene):
        frames, ids, gt, vis = high_id_scene
        table = detect.slot_table_init(8)
        det, table = detect.detect_markers_mapped(
            jnp.asarray(frames[0]), self.CFG1000, table)
        m = np.asarray(det.mask)
        tids = np.asarray(table)
        assert m.sum() == vis[0].sum()
        got = set(tids[np.where(m)[0]].tolist())
        assert got <= set(ids.tolist()), (got, ids)
        # corners land where the render ground truth says, mapped
        # through the table (slot s holds marker tids[s] = 900 + 5j)
        for s in np.where(m)[0]:
            j = int(np.where(ids == tids[s])[0][0])
            diff = np.abs(np.asarray(det.corners[s]) - gt[0][j]).max()
            assert diff < 1.5, (s, tids[s], diff)

    def test_table_stable_across_frames(self, high_id_scene):
        """A marker keeps its slot for the whole run: the table only
        grows, so landmark slot j in a filter stays marker table[j]."""
        frames, ids, gt, vis = high_id_scene
        table = detect.slot_table_init(8)
        assign = {}
        for f in range(len(frames)):
            det, table = detect.detect_markers_mapped(
                jnp.asarray(frames[f]), self.CFG1000, table)
            tids = np.asarray(table)
            for s in np.where(np.asarray(det.mask))[0]:
                mid = int(tids[s])
                assert assign.setdefault(mid, s) == s, \
                    (f, mid, s, assign)
        # every marker the render ground truth says was ever visible
        # got exactly one stable slot (the 4 video-rate frames share a
        # viewpoint, so this may be fewer than the 3 scene markers)
        assert len(assign) == int(vis.any(0).sum()), (assign, vis)

    def test_matches_slot_by_id_layout(self, rendered):
        """On a small dictionary both layouts must find the same
        markers with the same corners — only the slot indexing
        differs."""
        cam, scene, traj, frames, corners, mask = rendered
        base = detect.detect_markers(jnp.asarray(frames[5]), CFG)
        det, table = detect.detect_markers_mapped(
            jnp.asarray(frames[5]), CFG,
            detect.slot_table_init(CFG.capacity))
        tids = np.asarray(table)
        base_ids = set(np.where(np.asarray(base.mask))[0].tolist())
        m = np.asarray(det.mask)
        got = {int(tids[s]) for s in np.where(m)[0]}
        assert got == base_ids
        for s in np.where(m)[0]:
            np.testing.assert_allclose(
                np.asarray(det.corners[s]),
                np.asarray(base.corners[int(tids[s])]), atol=1e-4)

    def test_streaming_mapped_tracks_high_ids(self, high_id_scene):
        """The mapped streaming carry (table in the scan state): full
        sweep acquires, tracked frames re-validate each slot against
        its TABLE id, slots stay stable."""
        frames, ids, gt, vis = high_id_scene
        cr = detect.streaming_init(self.CFG1000, mapped=True)
        step = detect.streaming_step(self.CFG1000, track_every=4,
                                     mapped=True)
        import jax as _jax
        cr, (cs, ms) = _jax.lax.scan(step, cr,
                                     jnp.asarray(frames,
                                                 jnp.float32))
        tids = np.asarray(cr[3])
        assert set(tids[tids >= 0].tolist()) <= set(ids.tolist())
        # frames 2..3 are tracked; survivors must be accurate
        for f in (2, 3):
            for s in np.where(np.asarray(ms[f]))[0]:
                j = int(np.where(ids == tids[s])[0][0])
                diff = np.abs(np.asarray(cs[f][s]) - gt[f][j]).max()
                assert diff < 2.5, (f, s, diff)


def test_tracking_lost_everything_reacquires(rendered):
    """With an empty carry, pure tracking stays empty — the drivers'
    `(i % K < 2) | ~mask.any()` schedule forces a full sweep the
    moment tracking has nothing left, instead of running out the
    period blind."""
    import jax.numpy as jnp_
    cam, scene, traj, frames, corners, mask = rendered
    img = jnp_.asarray(frames[0])
    c = jnp_.zeros((64, 4, 2), jnp_.float32)
    m = jnp_.zeros(64, bool)
    v = jnp_.zeros_like(c)
    _, m1 = detect.track_markers(img, c, m, CFG, v)
    assert not np.asarray(m1).any()
    do_full = jnp_.asarray(False) | ~m.any()
    c2, m2, _ = detect.detect_or_track(img, c, m, v, do_full, CFG)
    assert np.asarray(m2).any()


def test_fleet_cohort_rescue(rendered):
    """Staggered-cohort fleet rescue (VERDICT r3 #3): a stream that
    loses every marker mid-period re-acquires at the NEXT frame via
    its cohort's dead-stream sweep, instead of tracking blind until
    the shared schedule's next full pass (which is what
    rescue_cohorts=0 does — asserted as the contrast)."""
    import jax
    import jax.numpy as jnp_
    cam, scene, traj, frames, corners, mask = rendered
    ke, t = 8, 7
    blank = np.full_like(frames[0], 178)  # background gray
    # stream 0 healthy (static frame); stream 1 blanks at 2..3, back 4+
    s0 = np.stack([frames[0]] * t)
    s1 = s0.copy()
    s1[2] = blank
    s1[3] = blank
    seq = jnp_.asarray(np.stack([s0, s1], axis=1),
                       jnp_.float32)          # (T, S, H, W)

    def run(cohorts):
        step = detect.streaming_step(CFG, ke, streams=2,
                                     rescue_cohorts=cohorts)
        cr = detect.streaming_init(CFG, streams=2)
        _, (cs, ms) = jax.lax.scan(step, cr, seq)
        return np.asarray(ms)                # (T, S, C)

    m = run(cohorts=2)
    assert m[1, 1].any()                     # tracking before blank
    assert not m[3, 1].any()                 # blank frames: all lost
    assert m[4, 1].any(), "cohort rescue must re-acquire at frame 4"
    assert m[4, 0].sum() >= m[1, 0].sum() - 1  # healthy stream intact

    m0 = run(cohorts=0)
    # shared scalar schedule: stream 1 stays blind until i=8 (> t-1)
    assert not m0[4:, 1].any(), \
        "without cohorts the fleet must (by design) wait for the " \
        "next scheduled sweep — if this fires, update the cohort " \
        "docs: per-stream rescue became free"


def test_detect_or_track_batch_matches_single(rendered):
    """The fleet streaming step (scalar schedule, cond outside the
    stream vmap) must produce exactly what per-stream detect_or_track
    produces on each stream."""
    import jax
    import jax.numpy as jnp_
    cam, scene, traj, frames, corners, mask = rendered
    s = 3
    imgs0 = jnp_.asarray(np.stack([frames[0]] * s))
    # the module fixture's whole-orbit motion (~100 px/frame) is far
    # past tracking range (video-rate behavior is covered by
    # TestTracking); a static frame still exercises the batched
    # full/track path equality this test is about
    imgs1 = imgs0
    c = jnp_.zeros((s, 64, 4, 2), jnp_.float32)
    m = jnp_.zeros((s, 64), bool)
    v = jnp_.zeros_like(c)
    # frame 0: full sweep; frame 1: tracked
    c, m, v = detect.detect_or_track_batch(
        imgs0, c, m, v, jnp_.asarray(True), CFG)
    c2, m2, v2 = detect.detect_or_track_batch(
        imgs1, c, m, v, jnp_.asarray(False), CFG)
    # reference: single-stream path on stream 0
    c_s, m_s, v_s = detect.detect_or_track(
        jnp_.asarray(frames[0]), c[0] * 0, m[0] & False,
        v[0] * 0, jnp_.asarray(True), CFG)
    c2_s, m2_s, _ = detect.detect_or_track(
        jnp_.asarray(frames[0]), c_s, m_s, v_s,
        jnp_.asarray(False), CFG)
    assert np.asarray(m2).any()
    np.testing.assert_array_equal(np.asarray(m2[0]), np.asarray(m2_s))
    np.testing.assert_allclose(np.asarray(c2[0]), np.asarray(c2_s),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m2[0]), np.asarray(m2[2]))
