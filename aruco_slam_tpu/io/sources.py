"""Frame/observation sources feeding the device pipeline.

The reference ingests frames synchronously with cv2.VideoCapture in the
driver loop (reference main/run_slam.py:96-116). Here the ingest
boundary is an iterator of host arrays that the drivers batch onto the
device; sources cover:

* ``NpzSource`` — sequences stored as .npz (pose-level observations,
  corner-level observations, and/or rendered grayscale images + ground
  truth) — the framework's native interchange format, produced by
  `apps/make_synthetic.py` or by converting videos offline.
* ``VideoSource`` — a real video file via imageio/cv2 when available
  (host decode stays on CPU by design; SURVEY.md §2 native table).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class NpzSource:
    """Sequence bundle. Recognized keys (all optional except times):

    times (T,), t_cl (T,C,3), q_cl (T,C,4), mask (T,C),
    corners (T,C,4,2), corner_mask (T,C), images (T,H,W) uint8,
    gt_cam_t (T,3), gt_cam_q (T,4), marker_size (), camera_matrix (3,3),
    dist_coeffs (5,).
    """

    def __init__(self, path) -> None:
        self.path = Path(path)
        data = np.load(self.path, allow_pickle=False)
        self.data = {k: data[k] for k in data.files}
        if "times" not in self.data:
            raise ValueError(f"{path}: missing 'times'")

    def __len__(self) -> int:
        return len(self.data["times"])

    @property
    def times(self) -> np.ndarray:
        return self.data["times"]

    def has(self, key: str) -> bool:
        return key in self.data

    def __getitem__(self, key: str) -> np.ndarray:
        return self.data[key]


def save_npz(path, **arrays) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


# container extensions routed to VideoSource — ONE source of truth for
# the drivers (apps/run_slam.py, run_offline.py) and the viz frame
# providers (apps/sinks.py)
VIDEO_SUFFIXES = {".mp4", ".avi", ".mov", ".mkv"}


def is_video(path) -> bool:
    return Path(path).suffix.lower() in VIDEO_SUFFIXES


class VideoSource:
    """Grayscale frames from a video file (host-side decode).

    Prefers imageio (with its pyav plugin); falls back to cv2. Both
    are optional installs (the ``video`` extra); with neither, opening
    a video raises a RuntimeError that says so.
    ``size=(w, h)`` resizes every frame (the reference hard-codes a
    1920x1080 resize, reference main/run_slam.py:43,116 — only correct
    when the calibration is 1080p); default None keeps the native
    resolution so the frames match whatever calibration is supplied.
    """

    def __init__(self, path, size=None) -> None:
        self.path = str(path)
        self.size = size
        try:
            import imageio.v3 as iio
            self._iio = iio
            self._mode = "imageio"
            meta = iio.improps(self.path, plugin="pyav")
            self.num_frames = int(meta.shape[0]) if meta.shape else 0
        except Exception as iio_err:  # missing package/plugin, codec
            try:
                import cv2
            except ImportError:
                raise RuntimeError(
                    f"cannot decode {self.path}: video input needs "
                    "imageio with the pyav plugin or OpenCV (pip "
                    "install 'aruco-slam-tpu[video]'); imageio said: "
                    f"{iio_err}") from None
            self._cv2 = cv2
            self._mode = "cv2"
            cap = cv2.VideoCapture(self.path)
            self.num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            self._fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            cap.release()

    def __len__(self) -> int:
        return self.num_frames

    def frames(self):
        """Yield (timestamp_s, grayscale uint8 (H, W)) per frame."""
        w, h = self.size if self.size else (None, None)
        if self._mode == "imageio":
            from aruco_slam_tpu.io import native
            fps = 30.0
            for i, frame in enumerate(
                    self._iio.imiter(self.path, plugin="pyav")):
                # single native pass: BT.601 grayscale + resize
                # (native/hostpipe.cpp hp_gray_resize; numpy fallback)
                out_hw = (h, w) if self.size else frame.shape[:2]
                gray = native.gray_resize(frame, out_hw)
                yield i / fps, gray
        else:
            cap = self._cv2.VideoCapture(self.path)
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                ts = cap.get(self._cv2.CAP_PROP_POS_MSEC) / 1000.0
                gray = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2GRAY)
                if self.size:
                    gray = self._cv2.resize(gray, (w, h))
                yield ts, gray
            cap.release()

