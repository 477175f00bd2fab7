"""Batched compute kernels: homography, IPPE-square PnP, ArUco
dictionaries, image-domain marker detection.

Replaces the reference's OpenCV C++ calls (cv2.solvePnP IPPE_SQUARE at
reference filters/base_filter.py:156-164, cv2.aruco detection at
:194) with dense, batch-first JAX implementations designed for an
accelerator's wide vector and matmul units rather than per-marker host
loops.
"""
