"""Bake the standard ArUco/AprilTag dictionaries to ops/data/*.npy.

The marker bit patterns are public constant data; the reference
selects them at runtime through OpenCV
(cv2.aruco.getPredefinedDictionary, reference
filters/base_filter.py:82, calibration/charuco_calibration.py:12).
This tool extracts the same tables once with cv2 (a test-only
dependency) and stores them as plain (N, n, n) uint8 arrays, so the
runtime detector needs no OpenCV — ops/dictionary.py loads the .npy
and builds the ±1 match table from it.

    python scripts/bake_dictionaries.py [--check]

--check verifies existing files instead of rewriting them.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent.parent / "aruco_slam_tpu" \
    / "ops" / "data"

# our name -> (cv2 constant name, marker bits per side)
TABLES = {
    "dict_4x4_50": ("DICT_4X4_50", 4),
    "dict_4x4_100": ("DICT_4X4_100", 4),
    "dict_4x4_250": ("DICT_4X4_250", 4),
    "dict_4x4_1000": ("DICT_4X4_1000", 4),
    "dict_5x5_50": ("DICT_5X5_50", 5),
    "dict_5x5_100": ("DICT_5X5_100", 5),
    "dict_5x5_250": ("DICT_5X5_250", 5),
    "dict_5x5_1000": ("DICT_5X5_1000", 5),
    "dict_6x6_50": ("DICT_6X6_50", 6),
    "dict_6x6_100": ("DICT_6X6_100", 6),
    "dict_6x6_250": ("DICT_6X6_250", 6),
    "dict_6x6_1000": ("DICT_6X6_1000", 6),
    "dict_7x7_50": ("DICT_7X7_50", 7),
    "dict_7x7_100": ("DICT_7X7_100", 7),
    "dict_7x7_250": ("DICT_7X7_250", 7),
    "dict_7x7_1000": ("DICT_7X7_1000", 7),
    "aruco_original": ("DICT_ARUCO_ORIGINAL", 5),
    "apriltag_16h5": ("DICT_APRILTAG_16h5", 4),
    "apriltag_25h9": ("DICT_APRILTAG_25h9", 5),
    "apriltag_36h10": ("DICT_APRILTAG_36h10", 6),
    "apriltag_36h11": ("DICT_APRILTAG_36h11", 6),
}


def extract(cv2, cv_name: str, nbits: int) -> np.ndarray:
    d = cv2.aruco.getPredefinedDictionary(getattr(cv2.aruco, cv_name))
    assert d.markerSize == nbits, (cv_name, d.markerSize, nbits)
    n = d.bytesList.shape[0]
    bits = np.zeros((n, nbits, nbits), np.uint8)
    for i in range(n):
        bits[i] = cv2.aruco.Dictionary.getBitsFromByteList(
            d.bytesList[i][None], nbits)
    return bits


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--check", action="store_true",
                   help="verify existing .npy files against cv2 "
                        "instead of writing")
    args = p.parse_args(argv)
    import cv2

    DATA.mkdir(parents=True, exist_ok=True)
    for name, (cv_name, nbits) in TABLES.items():
        bits = extract(cv2, cv_name, nbits)
        path = DATA / f"{name}.npy"
        if args.check:
            if not path.exists():
                print(f"MISSING {name}")
                continue
            ok = np.array_equal(np.load(path), bits)
            print(f"{'OK     ' if ok else 'MISMATCH'} {name} "
                  f"({bits.shape[0]} markers, {nbits}x{nbits})")
            assert ok, name
        else:
            np.save(path, bits)
            print(f"wrote {path.name}: {bits.shape[0]} markers, "
                  f"{nbits}x{nbits}")


if __name__ == "__main__":
    main()
