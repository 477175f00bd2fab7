"""Camera calibration from planar board views (batched LM).

The capability of the reference's ChArUco calibration tool
(reference calibration/charuco_calibration.py:33-77 →
cv2.aruco.calibrateCameraCharuco): estimate intrinsics
(fx, fy, cx, cy) + 5-term distortion from multiple views of a known
planar board. Accelerator-shaped: one Levenberg-Marquardt problem over
[intrinsics(9), per-view poses(6V)] with all views' reprojection
residuals evaluated as one batched computation and the (small, dense)
normal equations solved directly.

Two board types, matching the reference's calibration surface:

* marker grid boards (``grid_board`` — cv2.aruco.GridBoard shape):
  residuals on the detected marker corners themselves;
* ChArUco boards (``charuco_board`` — the reference's actual board,
  cv2.aruco.CharucoBoard with DICT_APRILTAG_36h11, reference
  calibration/charuco_calibration.py:12-16,36-37): markers identify
  the board, then the interior chessboard corners are interpolated
  from local marker homographies (the capability of
  cv2.aruco.CharucoDetector.detectBoard /
  interpolateCornersCharuco, reference
  calibration/charuco_calibration.py:59-61), optionally refined to
  subpixel saddle points on-device, and the calibration residuals run
  on those chessboard corners.

Initialization is Zhang-style: per-view plane homographies give the
focal length from the orthonormality constraints (principal point
assumed at the image center, zero skew), then poses from IPPE.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu.core import camera as cam_mod
from aruco_slam_tpu.core import quaternion as quat
from aruco_slam_tpu.ops import pnp


class BoardLayout(NamedTuple):
    """Planar marker board: per marker id, the 4 corner positions in
    board coordinates (z = 0), IPPE corner order."""

    ids: np.ndarray       # (M,)
    corners: np.ndarray   # (M, 4, 2) board-plane xy


def grid_board(nx: int, ny: int, marker_size: float, gap: float,
               first_id: int = 0) -> BoardLayout:
    """nx × ny grid of markers (like cv2.aruco.GridBoard)."""
    ids, corners = [], []
    pitch = marker_size + gap
    s = marker_size
    for gy in range(ny):
        for gx in range(nx):
            x0 = gx * pitch
            y0 = gy * pitch
            # TL TR BR BL with y up in board frame
            corners.append([[x0, y0 + s], [x0 + s, y0 + s],
                            [x0 + s, y0], [x0, y0]])
            ids.append(first_id + gy * nx + gx)
    return BoardLayout(np.asarray(ids, np.int32),
                       np.asarray(corners, np.float64))


class CharucoBoard(NamedTuple):
    """Chessboard with markers in the white squares (the reference's
    calibration board, cv2.aruco.CharucoBoard semantics: square (0,0)
    at the board origin is black; markers fill white squares in
    row-major order; interior chessboard corners are the calibration
    features). Board frame: x right, y up, z out of the board."""

    squares_x: int
    squares_y: int
    square_len: float
    marker_len: float
    layout: BoardLayout      # the board's markers (for detection/init)
    chess_pts: np.ndarray    # (C,2) interior corner board xy, row-major


def charuco_board(squares_x: int, squares_y: int, square_len: float,
                  marker_len: float, first_id: int = 0) -> CharucoBoard:
    """squares_x × squares_y ChArUco board. Markers occupy squares
    with (gx + gy) odd (square (0,0) black, like cv2), centered with
    margin (square_len − marker_len)/2."""
    if marker_len >= square_len:
        raise ValueError("marker_len must be < square_len")
    ids, corners = [], []
    s = marker_len
    margin = (square_len - marker_len) / 2.0
    mid = first_id
    # cv2-compatible layout: the top-left square (as printed) is
    # black; marker ids run row-major from the top-left white square.
    # Board frame y is up, so the printed top row is gy = squares_y−1.
    for row_top in range(squares_y):
        gy = squares_y - 1 - row_top
        for gx in range(squares_x):
            if (gx + row_top) % 2 == 0:   # black square, no marker
                continue
            x0 = gx * square_len + margin
            y0 = gy * square_len + margin
            corners.append([[x0, y0 + s], [x0 + s, y0 + s],
                            [x0 + s, y0], [x0, y0]])
            ids.append(mid)
            mid += 1
    # interior chessboard corners, cv2 id order: row-major from the
    # printed top-left (max board y first)
    chess = [[ix * square_len, iy * square_len]
             for iy in range(squares_y - 1, 0, -1)
             for ix in range(1, squares_x)]
    return CharucoBoard(
        squares_x, squares_y, square_len, marker_len,
        BoardLayout(np.asarray(ids, np.int32),
                    np.asarray(corners, np.float64)),
        np.asarray(chess, np.float64))


class CalibrationResult(NamedTuple):
    camera_matrix: np.ndarray  # (3, 3)
    dist_coeffs: np.ndarray    # (5,)
    rms_px: float
    per_view_rms: np.ndarray   # (V,)


def _zhang_focal_init(homs: np.ndarray, cx: float, cy: float) -> float:
    """Focal estimate from plane homographies (zero skew, centered
    principal point): with K = diag(f, f, 1) shifted by (cx, cy),
    h1ᵀ ω h2 = 0 and h1ᵀ ω h1 = h2ᵀ ω h2, ω = K⁻ᵀK⁻¹."""
    rows, rhs = [], []
    for h in homs:
        # shift principal point so K = diag(f, f, 1)
        t = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
        hh = t @ h
        h1, h2 = hh[:, 0], hh[:, 1]

        def w_terms(a, b):
            # aᵀ diag(1/f², 1/f², 1) b = (a0 b0 + a1 b1)/f² + a2 b2
            return a[0] * b[0] + a[1] * b[1], a[2] * b[2]

        c1, d1 = w_terms(h1, h2)
        rows.append(c1)
        rhs.append(-d1)
        c2a, d2a = w_terms(h1, h1)
        c2b, d2b = w_terms(h2, h2)
        rows.append(c2a - c2b)
        rhs.append(-(d2a - d2b))
    rows = np.asarray(rows)
    rhs = np.asarray(rhs)
    denom = float(rows @ rows)
    if denom < 1e-12:
        return 1000.0
    inv_f2 = float(rows @ rhs) / denom
    if inv_f2 <= 1e-12:
        return 1000.0
    return 1.0 / np.sqrt(inv_f2)


def _fit_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares DLT homography (h22 = 1) from (N,2)→(N,2),
    N ≥ 4."""
    a_rows, b_rows = [], []
    for (x, y), (u, v) in zip(src, dst):
        a_rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b_rows.append(u)
        a_rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b_rows.append(v)
    a = np.asarray(a_rows)
    b = np.asarray(b_rows)
    hvec, *_ = np.linalg.lstsq(a, b, rcond=None)
    return np.append(hvec, 1.0).reshape(3, 3)


def _init_views(layout: BoardLayout, view_corners: np.ndarray,
                view_mask: np.ndarray, image_size: tuple[int, int]):
    """Zhang focal + per-view IPPE pose initialization from detected
    marker corners. Returns (f0, cx0, cy0, pose0 (V,6) rotvec+t,
    valid_views)."""
    v = view_mask.shape[0]
    w, h = image_size
    cx0, cy0 = w / 2.0, h / 2.0

    homs = []
    for i in range(v):
        det = np.where(view_mask[i])[0]
        if len(det) < 2:
            homs.append(None)
            continue
        homs.append(_fit_homography(layout.corners[det].reshape(-1, 2),
                                    view_corners[i, det].reshape(-1, 2)))
    valid_views = [i for i, hh in enumerate(homs) if hh is not None]
    f0 = _zhang_focal_init([homs[i] for i in valid_views], cx0, cy0)

    cam0 = cam_mod.CameraModel.from_matrix(
        jnp.asarray([[f0, 0, cx0], [0, f0, cy0], [0, 0, 1.0]]),
        jnp.zeros(5))
    pose0 = np.zeros((v, 6))
    pose0[:, 5] = 1.0  # z offset placeholder
    for i in valid_views:
        j = int(np.where(view_mask[i])[0][0])
        res = pnp.solve_square_pnp_normalized(
            jnp.asarray(cam_mod.pixel_to_ray(
                cam0, jnp.asarray(view_corners[i, j]))),
            float(np.linalg.norm(layout.corners[j][0]
                                 - layout.corners[j][1])))
        # lift the marker pose to the board pose: the marker frame is
        # centered on the marker, the board frame on its own origin,
        # both in the same plane — board point p maps to the camera as
        # R (p − center_j) + t.
        r = np.asarray(quat.to_matrix(res.q_cl))
        t = np.asarray(res.t_cl)
        center_board = np.array([*layout.corners[j].mean(0), 0.0])
        pose0[i, :3] = np.asarray(quat.to_rotvec(res.q_cl))
        pose0[i, 3:] = t - r @ center_board
    return f0, cx0, cy0, pose0, valid_views


def _lm_calibrate(board_pts: np.ndarray, view_pts: np.ndarray,
                  view_mask: np.ndarray, intr0: np.ndarray,
                  pose0: np.ndarray, iters: int) -> np.ndarray:
    """Joint LM over [intrinsics(9), poses(6V)] with reprojection
    residuals on generic planar point features.

    board_pts: (N, 3) board-frame points (z = 0); view_pts: (V, N, 2)
    detected pixels; view_mask: (V, N). Returns optimized params
    (9 + 6V,)."""
    v = view_pts.shape[0]
    pts3 = jnp.asarray(board_pts)
    obs = jnp.asarray(view_pts, jnp.float64)
    msk = jnp.asarray(view_mask)

    def residuals(params):
        intr = params[:9]
        cam = cam_mod.CameraModel(
            fx=intr[0], fy=intr[1], cx=intr[2], cy=intr[3],
            dist=intr[4:9])
        poses = params[9:].reshape(v, 6)
        rot = quat.to_matrix(quat.from_rotvec(poses[:, :3]))  # (V,3,3)
        pts = jnp.einsum("vab,nb->vna", rot, pts3) \
            + poses[:, None, 3:]
        proj = cam_mod.project(cam, pts)
        r = (proj - obs) * msk[:, :, None]
        return r.reshape(-1)

    @jax.jit
    def lm_step(params, lam, cost):
        r = residuals(params)
        jac = jax.jacfwd(residuals)(params)
        jtj = jac.T @ jac
        jtj = jtj + lam * jnp.diag(jnp.diag(jtj) + 1e-9)
        delta = jnp.linalg.solve(jtj, -(jac.T @ r))
        trial = params + delta
        new_cost = jnp.sum(residuals(trial) ** 2)
        accept = new_cost < cost
        params = jnp.where(accept, trial, params)
        lam = jnp.where(accept, lam * 0.3, lam * 3.0)
        cost = jnp.where(accept, new_cost, cost)
        return params, jnp.clip(lam, 1e-10, 1e8), cost

    params = jnp.concatenate([jnp.asarray(intr0, jnp.float64),
                              jnp.asarray(pose0.reshape(-1),
                                          jnp.float64)])
    lam = jnp.asarray(1e-3, jnp.float64)
    cost = jnp.sum(residuals(params) ** 2)
    for _ in range(iters):
        params, lam, cost = lm_step(params, lam, cost)
    return np.asarray(params)


def _result(params: np.ndarray, board_pts: np.ndarray,
            view_pts: np.ndarray, view_mask: np.ndarray
            ) -> CalibrationResult:
    v = view_pts.shape[0]
    intr = params[:9]
    k = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]],
                  [0, 0, 1.0]])
    cam = cam_mod.CameraModel(
        fx=jnp.asarray(intr[0]), fy=jnp.asarray(intr[1]),
        cx=jnp.asarray(intr[2]), cy=jnp.asarray(intr[3]),
        dist=jnp.asarray(intr[4:9]))
    poses = params[9:].reshape(v, 6)
    rot = quat.to_matrix(quat.from_rotvec(jnp.asarray(poses[:, :3])))
    pts = jnp.einsum("vab,nb->vna", rot, jnp.asarray(board_pts)) \
        + jnp.asarray(poses)[:, None, 3:]
    r = np.asarray(cam_mod.project(cam, pts)) - view_pts
    r = r * view_mask[:, :, None]
    counts = np.maximum(view_mask.sum(-1), 1)
    per_view = np.sqrt((r ** 2).sum((-1, -2)) / counts)
    n = max(float(view_mask.sum()), 1.0)
    rms = float(np.sqrt((r ** 2).sum() / n))
    return CalibrationResult(k, intr[4:9], rms, per_view)


def calibrate(board: BoardLayout, view_corners: np.ndarray,
              view_mask: np.ndarray, image_size: tuple[int, int],
              iters: int = 40) -> CalibrationResult:
    """Calibrate from detected marker corners across views.

    view_corners: (V, M, 4, 2) pixel corners per view per board marker
    (aligned with board.ids); view_mask: (V, M) detected flags.
    """
    v, m = view_mask.shape
    f0, cx0, cy0, pose0, _ = _init_views(
        board, view_corners, view_mask, image_size)
    intr0 = np.array([f0, f0, cx0, cy0, 0, 0, 0, 0, 0])
    board_pts = np.concatenate(
        [board.corners, np.zeros((m, 4, 1))], -1).reshape(-1, 3)
    pts = view_corners.reshape(v, -1, 2)
    msk = np.repeat(view_mask, 4, axis=-1)
    params = _lm_calibrate(board_pts, pts, msk, intr0, pose0, iters)
    return _result(params, board_pts, pts, msk)


def interpolate_chess_corners(
        board: CharucoBoard, marker_corners: np.ndarray,
        marker_mask: np.ndarray, min_markers: int = 2,
        radius_squares: float = 2.5
) -> tuple[np.ndarray, np.ndarray]:
    """Interior chessboard corners from detected marker corners via
    local homographies — the capability of
    cv2.aruco.interpolateCornersCharuco (reference
    calibration/charuco_calibration.py:59 uses its successor
    CharucoDetector.detectBoard).

    For each interior corner, fit a board→pixel homography from the
    corners of the nearest detected markers (≥ ``min_markers`` within
    ``radius_squares`` board squares) and map the corner through it.
    Local fits track lens distortion far better than one global
    homography. Host-side scaffolding (tiny problem sizes); the
    subpixel polish runs on-device (ops/detect.refine_corners).

    marker_corners: (V, M, 4, 2) aligned with board.layout.ids;
    marker_mask: (V, M). Returns (chess_px (V, C, 2), chess_mask
    (V, C))."""
    v, m = marker_mask.shape
    c = len(board.chess_pts)
    centers = board.layout.corners.mean(1)           # (M, 2)
    radius = radius_squares * board.square_len
    chess_px = np.zeros((v, c, 2))
    chess_mask = np.zeros((v, c), bool)
    for i in range(v):
        det = np.where(marker_mask[i])[0]
        if len(det) < min_markers:
            continue
        for j in range(c):
            p = board.chess_pts[j]
            d = np.linalg.norm(centers[det] - p, axis=-1)
            order = np.argsort(d)
            near = det[order[:4]]
            near = near[d[order[:4]] <= radius]
            if len(near) < min_markers:
                continue
            hom = _fit_homography(
                board.layout.corners[near].reshape(-1, 2),
                marker_corners[i, near].reshape(-1, 2))
            q = hom @ np.array([p[0], p[1], 1.0])
            chess_px[i, j] = q[:2] / q[2]
            chess_mask[i, j] = True
    return chess_px, chess_mask


def calibrate_charuco(board: CharucoBoard, marker_corners: np.ndarray,
                      marker_mask: np.ndarray, chess_px: np.ndarray,
                      chess_mask: np.ndarray,
                      image_size: tuple[int, int],
                      iters: int = 40) -> CalibrationResult:
    """Calibrate from interpolated chessboard corners (the residual
    features cv2.aruco.calibrateCameraCharuco uses, reference
    calibration/charuco_calibration.py:70). Marker detections seed the
    Zhang/IPPE initialization; chessboard corners carry the LM."""
    f0, cx0, cy0, pose0, _ = _init_views(
        board.layout, marker_corners, marker_mask, image_size)
    intr0 = np.array([f0, f0, cx0, cy0, 0, 0, 0, 0, 0])
    c = len(board.chess_pts)
    board_pts = np.concatenate(
        [board.chess_pts, np.zeros((c, 1))], -1)
    params = _lm_calibrate(board_pts, chess_px, chess_mask, intr0,
                           pose0, iters)
    return _result(params, board_pts, chess_px, chess_mask)
