"""Image-domain ArUco detection as a dense, statically-shaped pipeline.

Accelerator replacement for cv2.aruco.ArucoDetector.detectMarkers
(reference filters/base_filter.py:74-90, 194). OpenCV's detector is
irregular CPU code — contour tracing, polygon approximation, per-
candidate hash lookups. XLA needs static shapes and dense data flow,
so every stage here is reformulated dense (SURVEY.md §7 "hard parts"):

 1. adaptive threshold — fused with the downscale as reduce_window
    min/avg pools against a local box mean, binary = pixel < mean − C,
    matching the reference's adaptiveThreshWinSize range semantics.
 2. connected components — at a downscaled resolution, alternating
    3×3 min-label stencils with segmented row/column min-scans
    (gather-free; see _connected_components) instead of contour
    tracing.
 3. candidate selection — per-component areas from a sort + run-length
    scan histogram (no scatter), area-gated top-K.
 4. quad corners — per-candidate masked argmax geometry: farthest
    point from centroid, farthest from it (the diagonal), then extreme
    points on both sides of the diagonal; ordered clockwise.
 5. subpixel refinement — the classic gradient structure-tensor
    iteration (cv2.cornerSubPix's math) on gathered full-res windows,
    batched over all corners.
 6. decode — homography-sample the (n+2)² cell grid, threshold,
    border check, and match payloads against ALL dictionary rotations
    with ONE ±1 matmul (ops/dictionary.py's table).
 7. slot outputs — deduplicated by id into fixed-capacity arrays
    (corners (C,4,2) + mask), feeding the batched PnP directly.

Corner convention matches OpenCV/IPPE_SQUARE: clockwise from the
marker's canonical top-left.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu.ops import dictionary as dict_mod


class DetectorConfig(NamedTuple):
    dict_name: str = dict_mod.DICT_5X5_50
    capacity: int = 64            # output slots (marker ids)
    max_candidates: int = 32      # K quad candidates per frame
    downscale: int = 4            # component-labeling resolution
    thresh_win: int = 15          # box window (full res), odd
    # candidate sweep: (threshold window FULL-res px, downscale) passes,
    # each thresholded+labeled+harvested independently and the
    # candidate lists merged — the dense analog of OpenCV's
    # adaptiveThreshWinSize 3..30 sweep (reference
    # filters/base_filter.py:84-88). Small windows adapt under lighting
    # gradients/vignetting; large windows keep blurred low-contrast
    # borders; the fine-downscale pass separates markers from adjacent
    # dark clutter that the coarse min-pool would bridge (a ds-px gap
    # is one low-res pixel). None = auto: derived from thresh_win and
    # downscale as ((w, d), (3w, d)) + ((w, d//2) when d//2 >= 2) —
    # ((15,4),(45,4),(15,2)) at the defaults — so tuning
    # thresh_win/downscale keeps working. An explicit tuple is used
    # verbatim; ((thresh_win, downscale),) gives the fast single pass.
    passes: tuple[tuple[int, int], ...] | None = None
    thresh_c: float = 7.0         # threshold offset (uint8 counts)
    min_area: int = 16            # component pixels at low res
    max_area_frac: float = 0.05
    prop_iters: int = 16          # total 3x3 min-flood rounds, split
                                  # across the scan rounds (see
                                  # _connected_components). 16 is the
                                  # measured convergence floor: the
                                  # scipy.ndimage oracle sweep labels
                                  # every rotated marker shape (8 px to
                                  # full frame, holes included) with a
                                  # single label at (16, 4) on both the
                                  # coarse and fine grids, while 8
                                  # splits the 8/16-px shapes — the
                                  # tiny rotated markers need stencil
                                  # transport the scans cannot supply
    scan_rounds: int = 4          # segmented row/col min-scan
                                  # alternations; each propagates
                                  # labels across whole dark runs, so
                                  # full-frame markers label without
                                  # per-pixel iteration (gather-free
                                  # replacement of the old pointer-
                                  # jump stage)
    fine_scan_rounds: int | None = None
                                  # scan rounds for FINE-downscale
                                  # passes (None = scan_rounds). The
                                  # fine pass exists to split small/
                                  # medium markers from adjacent
                                  # clutter; its scans are the robust
                                  # sweep's single costliest kernel
                                  # (4x the coarse pixel count), and a
                                  # fine-pass split of a LARGE marker
                                  # is harmless — the coarse passes
                                  # label it whole and id-dedup keeps
                                  # their copy (oracle-gated:
                                  # tests/test_detect.py TestDegraded
                                  # + clutter recall)
    subpix_win: int = 6           # half window (13x13)
    subpix_iters: int = 6
    track_win: int = 8            # track_markers first-stage half
                                  # window: max inter-frame corner
                                  # motion the tracker absorbs (px)
    track_slots: int = 16         # max simultaneously-tracked markers
                                  # (live slots compacted via top_k;
                                  # 0 = track every slot). With more
                                  # than track_slots live markers the
                                  # KEPT set is the lowest slot ids
                                  # (top_k ties are deterministic), so
                                  # crowded scenes systematically thin
                                  # high-id observations on tracked
                                  # frames; the extras re-acquire at
                                  # each full sweep. Raise track_slots
                                  # if uniform coverage matters
    max_hamming: int = 1          # payload correction budget
    border_max_white: int = 2     # tolerated white border cells
    slot_max_age: int = 0         # LRU slot recycling: a new marker
                                  # id may evict a slot unobserved for
                                  # more than this many frames when
                                  # the table is full (corridor runs
                                  # traversing > capacity distinct
                                  # markers keep mapping). 0 = slots
                                  # are permanent (drops counted via
                                  # assign_slots_lru / the lru batch
                                  # path either way)
    refine_budget: int = 0        # candidates kept (after geometric
                                  # dedup across the sweep's passes)
                                  # into subpixel refinement + decode;
                                  # 0 (default) = refine all passes*K.
                                  # Off by default because the global
                                  # top-budget ranks by AREA: big dark
                                  # clutter blobs outrank real markers
                                  # (measured: budget 48 misses 9 ids
                                  # the full width catches on the
                                  # cluttered-background suite) — use
                                  # on clean/controlled scenes only


class Detections(NamedTuple):
    """Slot-indexed per-frame output (slot == marker id)."""

    corners: jnp.ndarray  # (C, 4, 2) full-res pixel corners (TL TR BR BL)
    mask: jnp.ndarray     # (C,) bool
    # diagnostics
    cand_corners: jnp.ndarray  # (K, 4, 2)
    cand_ids: jnp.ndarray      # (K,) decoded id or -1
    cand_valid: jnp.ndarray    # (K,)


def _box_mean(img: jnp.ndarray, win: int) -> jnp.ndarray:
    """Local box mean with edge clamping via an integral image."""
    return _box_mean_multi(img, (win,))[0]


def _box_mean_multi(img: jnp.ndarray, wins: tuple[int, ...]
                    ) -> list[jnp.ndarray]:
    """Box means for SEVERAL window sizes from one shared integral
    image (the cumsum chain is the expensive part; the window only
    picks 4-point slice offsets). Edge replication is idempotent, so
    padding by the largest radius yields sums identical to per-window
    padding. Used by the candidate sweep: the two same-downscale
    passes differ only in window, so they share the integral image."""
    h, w = img.shape
    rmax = max(wn // 2 for wn in wins)
    pad = jnp.pad(img, ((rmax + 1, rmax), (rmax + 1, rmax)),
                  mode="edge")
    ii = jnp.cumsum(jnp.cumsum(pad, axis=0), axis=1)
    out = []
    for wn in wins:
        r = wn // 2
        hi, lo = rmax + 1 + r, rmax - r
        a = ii[hi:hi + h, hi:hi + w]
        b = ii[lo:lo + h, hi:hi + w]
        c = ii[hi:hi + h, lo:lo + w]
        d = ii[lo:lo + h, lo:lo + w]
        out.append((a - b - c + d) / (wn * wn))
    return out


def _connected_components(fg: jnp.ndarray, iters: int,
                          scan_rounds: int = 3) -> jnp.ndarray:
    """Connected-component labels by min-label flooding.

    fg: (h, w) bool. Returns int32 labels; background = h*w (BIG).

    Alternates two gather-free propagation mechanisms:

    * 3x3 min stencils (`iters` rounds total, split across the scan
      rounds) — pure elementwise work crossing diagonal joints and
      staircase edges one pixel per round;
    * segmented row/column min-scans (`scan_rounds` alternations) —
      `associative_scan` with a reset at every background pixel, which
      propagates a label across an ENTIRE contiguous dark run in one
      log-depth pass. A marker's border is a thick ring of long runs,
      so reach along it is unbounded: full-frame close-up markers
      label in a few rounds with no per-pixel iteration count.

    Nothing here gathers: reach comes from the scans instead of a
    pointer-jump round (label = label[label]), a data-dependent
    gather over the whole label image per round.

    The outermost 1-px ring is treated as background. Markers lose at
    most one labeling-resolution pixel at the frame edge, within the
    slack the subpixel refinement already absorbs.
    """
    h, w = fg.shape
    big = h * w
    edge_r = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) % (h - 1)
              == 0)
    edge_c = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) % (w - 1)
              == 0)
    fg = fg & ~edge_r & ~edge_c

    def prop(_, labels):
        # separable 3x3 box min (vertical then horizontal pass) — the
        # same 8-neighbor+self min as a 9-plane stack but 6 planes of
        # memory traffic instead of 10, and no pad copy
        p = jnp.pad(labels, ((1, 1), (0, 0)), constant_values=big)
        v = jnp.minimum(labels, jnp.minimum(p[:-2, :], p[2:, :]))
        q = jnp.pad(v, ((0, 0), (1, 1)), constant_values=big)
        m = jnp.minimum(v, jnp.minimum(q[:, :-2], q[:, 2:]))
        return jnp.where(fg, m, big)

    reset = (~fg).astype(jnp.int32)
    # Segmented min via a single monotonic int32 key per direction:
    # high bits carry the run id (cumsum of background resets along
    # the axis — restarts per line, so bounded by the line length),
    # low bits carry the bit-inverted label. A plain cummax then never
    # leaks across runs (an earlier run's key is strictly smaller in
    # the high bits) and picks the min label within the run in the low
    # bits. Native cumsum/cummax kernels beat a tuple-carry
    # associative_scan ~2x. Bit budget is sized per axis; if label
    # bits + run bits ever exceed int32 (≈8K-wide frames at the
    # default downscale) we fall back to the tuple-carry scan.
    label_bits = max(1, int(big).bit_length())
    maxl = (1 << label_bits) - 1

    def seg_op(a, b):
        mv = jnp.where(b[1], b[0], jnp.minimum(a[0], b[0]))
        return mv, a[1] | b[1]

    # The two directions run SEQUENTIALLY (the backward scan consumes
    # the forward-updated labels) rather than from a shared input:
    # per-round reach is strictly >= the parallel-directions form (a
    # forward-found min propagates backward in the same round), and it
    # halves the peak value liveness.
    def seg_scan_dir(labels, axis, reverse):
        run_bits = int(fg.shape[axis]).bit_length()
        if label_bits + run_bits > 31:
            rs = reset.astype(bool)
            sc, _ = jax.lax.associative_scan(
                seg_op, (labels, rs), axis=axis, reverse=reverse)
            return jnp.where(fg, sc, big)
        inv = jnp.where(fg, maxl - labels, 0)
        run = jax.lax.cumsum(reset, axis=axis, reverse=reverse)
        key = jax.lax.cummax((run << label_bits) | inv, axis=axis,
                             reverse=reverse)
        return jnp.where(fg, maxl - (key & maxl), big)

    def seg_scan(labels, axis):
        return seg_scan_dir(seg_scan_dir(labels, axis, False),
                            axis, True)

    per = max(1, iters // (scan_rounds + 1)) if scan_rounds else iters
    lin = jnp.arange(big, dtype=jnp.int32).reshape(h, w)
    labels = jnp.where(fg, lin, big)
    labels = jax.lax.fori_loop(0, per, prop, labels)
    for _ in range(scan_rounds):
        labels = seg_scan(labels, 1)  # along rows
        labels = seg_scan(labels, 0)  # along columns
        labels = jax.lax.fori_loop(0, per, prop, labels)
    return labels


def _quad_corners_compact(xf: jnp.ndarray, yf: jnp.ndarray,
                          valid: jnp.ndarray) -> jnp.ndarray:
    """Extreme-point quad corners from COMPACT per-candidate pixel
    lists: xf/yf (K, N) low-res coords, valid (K, N). Returns
    (K, 4, 2) (x, y), clockwise from an arbitrary corner.

    Same geometry as the old dense-mask form (farthest-from-centroid,
    farthest-from-that = the diagonal, extremes either side of it),
    but on the component's own pixels (N = max_area) instead of a
    (K, h, w) mask stack — the mask stack plus its masked-argmax score
    planes cost ~50 MB of memory traffic per pass at 1080p; the
    compact lists hold the whole stage under 1 MB."""
    m = valid.astype(jnp.float32)
    cnt = jnp.maximum(m.sum(-1), 1.0)
    cx = (m * xf).sum(-1) / cnt
    cy = (m * yf).sum(-1) / cnt

    neg = -1e9

    def argpt(score):
        idx = jnp.argmax(jnp.where(valid, score, neg), axis=-1)
        take = lambda a: jnp.take_along_axis(a, idx[:, None],
                                             axis=1)[:, 0]
        return jnp.stack([take(xf), take(yf)], -1)  # (K, 2)

    d0 = (xf - cx[:, None]) ** 2 + (yf - cy[:, None]) ** 2
    c0 = argpt(d0)
    d1 = (xf - c0[:, :1]) ** 2 + (yf - c0[:, 1:]) ** 2
    c1 = argpt(d1)
    # signed area relative to the diagonal c0 -> c1
    ex = c1[:, 0] - c0[:, 0]
    ey = c1[:, 1] - c0[:, 1]
    s = (xf - c0[:, :1]) * ey[:, None] - (yf - c0[:, 1:]) * ex[:, None]
    c2 = argpt(s)
    c3 = argpt(-s)
    quad = jnp.stack([c0, c2, c1, c3], axis=1)  # (K, 4, 2) around hull
    # clockwise order by angle around the centroid (image y down:
    # increasing angle == clockwise on screen)
    ang = jnp.arctan2(quad[..., 1] - cy[:, None],
                      quad[..., 0] - cx[:, None])
    order = jnp.argsort(ang, axis=-1)
    return jnp.take_along_axis(quad, order[..., None], axis=1)


def _gather_patches(img: jnp.ndarray, corners: jnp.ndarray, rad: int):
    """One (N, P, P) f32 patch gather centered at the rounded corners.
    vmapped dynamic_slice lowers to a gather of contiguous (P, P)
    windows (row-sized reads) instead of P² single-element lookups.
    The gather reads the image in its NARROWEST dtype (uint8 frames stay
    uint8 — 4x fewer scattered bytes than gathering the f32 copy;
    conversion afterwards on the small patch stack is exact).
    Returns (patches, cx0, cy0)."""
    h, w = img.shape
    p = 2 * rad + 1
    cx0 = jnp.clip(jnp.round(corners[:, 0]).astype(jnp.int32),
                   rad, w - rad - 1)
    cy0 = jnp.clip(jnp.round(corners[:, 1]).astype(jnp.int32),
                   rad, h - rad - 1)
    patches = jax.vmap(lambda y, x: jax.lax.dynamic_slice(
        img, (y - rad, x - rad), (p, p)))(cy0, cx0)
    return patches.astype(jnp.float32), cx0, cy0


def _subpix_refine(img: jnp.ndarray, corners: jnp.ndarray,
                   schedule: tuple[tuple[int, int], ...]) -> jnp.ndarray:
    """Gradient structure-tensor subpixel refinement (cornerSubPix
    math), batched over corners (N, 2) on the full-res image.

    `schedule` is a sequence of (half_window, iterations) stages run
    coarse-to-fine — e.g. ((6, 6), (3, 4)) matches two cornerSubPix
    calls with shrinking windows.

    Patch-based: each corner's neighborhood is gathered from the image
    ONCE (a patch big enough for the largest window plus the maximum
    cumulative drift across all stages), and every iteration then runs
    as pure elementwise math on the (N, P, P) patch stack — recentering
    via a window mask instead of re-slicing. Per-iteration dynamic
    slices would cost a gather per corner per round; this form does
    one gather for the whole coarse-to-fine refinement."""
    # patch radius: every stage's window (plus 1px gradient border)
    # must stay inside the patch after all preceding stages' drift
    # (each stage may move the estimate by up to its own half-window)
    cum = 0
    rad = 0
    for half, _ in schedule:
        cum += half  # max drift this stage adds
        rad = max(rad, cum + half + 1)
    drift = 0
    sched = []
    for half, iters in schedule:
        sigma2 = (half / 1.5) ** 2
        drift = min(drift + half, rad - half - 1)
        sched.append((half, iters, sigma2, drift))

    patches, cx0, cy0 = _gather_patches(img, corners, rad)
    # starting offset of the true corner estimate from the patch
    # center (window must stay inside the patch)
    c = jnp.stack([corners[:, 0] - cx0, corners[:, 1] - cy0], -1)
    c = jnp.clip(c, -(rad - 1), rad - 1)

    # dense gradients on the patch interior: (N, P-2, P-2)
    gx = 0.5 * (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2])
    gy = 0.5 * (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1])
    q = 2 * rad - 1
    # interior pixel coords relative to the patch center
    px = (jax.lax.broadcasted_iota(jnp.float32, (q, q), 1)
          - (q - 1) / 2.0)[None]
    py = (jax.lax.broadcasted_iota(jnp.float32, (q, q), 0)
          - (q - 1) / 2.0)[None]
    proj = gx * px + gy * py

    for half, iters, sigma2, drift in sched:
        def body(_, c, half=half, sigma2=sigma2, drift=drift):
            # gaussian window centered at the current integer estimate
            # (matches the slice-based recentering of cv2.cornerSubPix)
            wx = jnp.round(c[:, 0])[:, None, None]
            wy = jnp.round(c[:, 1])[:, None, None]
            inside = ((jnp.abs(px - wx) <= half)
                      & (jnp.abs(py - wy) <= half)).astype(jnp.float32)
            wgt = inside * jnp.exp(
                -0.5 * ((px - wx) ** 2 + (py - wy) ** 2) / sigma2)
            wgx = wgt * gx
            wgy = wgt * gy
            wxx = (wgx * gx).sum((-1, -2))
            wxy = (wgx * gy).sum((-1, -2))
            wyy = (wgy * gy).sum((-1, -2))
            bx = (wgx * proj).sum((-1, -2))
            by = (wgy * proj).sum((-1, -2))
            det = wxx * wyy - wxy * wxy
            ok = jnp.abs(det) > 1e-9
            nx = jnp.where(ok, (wyy * bx - wxy * by) / det, c[:, 0])
            ny = jnp.where(ok, (wxx * by - wxy * bx) / det, c[:, 1])
            nx = jnp.clip(nx, c[:, 0] - half, c[:, 0] + half)
            ny = jnp.clip(ny, c[:, 1] - half, c[:, 1] + half)
            # the window must stay inside the patch
            return jnp.stack([jnp.clip(nx, -drift, drift),
                              jnp.clip(ny, -drift, drift)], -1)

        c = jax.lax.fori_loop(0, iters, body, c)
    return c + jnp.stack([cx0, cy0], -1).astype(jnp.float32)


def _homography_cells(corners: jnp.ndarray, cells: int) -> jnp.ndarray:
    """Homography from cell-grid coords (x right, y down, origin at
    corner 0) to pixels, per candidate. corners: (K, 4, 2) clockwise.

    Closed form: the source is a SQUARE, so the exact 4-point
    homography comes from pnp's Heckbert projective-interpolation
    entries (ops/pnp._h_square_entries) composed with the constant
    affine cell-grid -> canonical-square map — ~40 batched scalar ops
    per candidate instead of the 8x8 DLT normal solve the first cut
    vmapped here (96 tiny serialized solves). The quad
    targets are centered/scaled to ~unit size first (same Hartley
    conditioning the DLT needed: the entries mix products of
    coordinates, and pixel-scale magnitudes cost f32 bits).
    """
    from aruco_slam_tpu.ops.pnp import _h_square_entries
    g = float(cells)

    center = corners.mean(axis=1)                        # (K, 2)
    scale = jnp.maximum(
        jnp.abs(corners - center[:, None, :]).mean(axis=(1, 2)), 1e-3)
    cn = (corners - center[:, None, :]) / scale[:, None, None]
    # canonical square (Heckbert order TL TR BR BL with y UP, s=g/2)
    # relates to cell coords by x_sq = x - g/2, y_sq = g/2 - y
    u = [cn[:, i, 0] for i in range(4)]
    v = [cn[:, i, 1] for i in range(4)]
    hsq = _h_square_entries(jnp.asarray(g / 2.0, corners.dtype), u, v)
    h_norm = jnp.stack([jnp.stack(r, -1) for r in
                        [[hsq[i][j] for j in range(3)]
                         for i in range(3)]], -2)        # (K, 3, 3)
    t = jnp.zeros((corners.shape[0], 3, 3), corners.dtype)
    t = t.at[:, 0, 0].set(scale).at[:, 1, 1].set(scale) \
         .at[:, 0, 2].set(center[:, 0]) \
         .at[:, 1, 2].set(center[:, 1]).at[:, 2, 2].set(1.0)
    a = jnp.asarray([[1.0, 0.0, -g / 2.0],
                     [0.0, -1.0, g / 2.0],
                     [0.0, 0.0, 1.0]], corners.dtype)
    # true f32: at default precision a GPU runs f32 matmuls in TF32
    # (~1e-3 relative), i.e. up to a pixel of error on 1080p sample
    # positions; these 3x3 products cost nothing at full precision
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return mm(mm(t, h_norm), a)




def _sample_cells(img: jnp.ndarray, quads: jnp.ndarray, cells: int
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Homography-sample the (cells x cells) grid of every quad and
    threshold to bits. quads: (K, 4, 2) clockwise pixel corners.
    Returns (bits (K, cells, cells) bool, border_white (K,) count).

    Cell centers sample NEAREST-pixel: decode only thresholds the
    sample against the marker's own (min+max)/2, and the center of a
    payload cell is >= a cell-radius away from any edge, so the
    sub-pixel interpolation bilinear adds is noise-averaging at best —
    while costing 4 scattered image gathers per point instead of 1."""
    k = quads.shape[0]
    hmat = _homography_cells(quads, cells)         # (K, 3, 3)
    ci = (jnp.arange(cells, dtype=jnp.float32) + 0.5)
    gx, gy = jnp.meshgrid(ci, ci)                  # (cells, cells)
    ones = jnp.ones_like(gx)
    grid = jnp.stack([gx, gy, ones], -1).reshape(-1, 3)  # (cells², 3)
    proj = jnp.einsum("kab,nb->kna", hmat, grid,
                      precision=jax.lax.Precision.HIGHEST)  # see above
    px = proj[..., 0] / proj[..., 2]
    py = proj[..., 1] / proj[..., 2]
    h, w = img.shape
    xi = jnp.clip(jnp.round(px).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(py).astype(jnp.int32), 0, h - 1)
    samples = img[yi, xi].reshape(k, cells, cells)

    smin = samples.min(axis=(1, 2), keepdims=True)
    smax = samples.max(axis=(1, 2), keepdims=True)
    bits = samples > 0.5 * (smin + smax)
    border = jnp.concatenate([
        bits[:, 0, :], bits[:, -1, :],
        bits[:, 1:-1, 0], bits[:, 1:-1, -1]], axis=-1)
    return bits, border.sum(-1)


def candidate_stage_names() -> tuple[str, ...]:
    """Prefix checkpoints `_detect_candidates(stop=...)` accepts, in
    pipeline order — the bench/detect_profile stage split."""
    return ("rawpools", "pools", "flood", "sort", "harvest",
            "subpix", "homog", "sample", "decode")


def _detect_candidates(image: jnp.ndarray, cfg: DetectorConfig,
                       stop: str | None = None
                       ) -> tuple[jnp.ndarray, jnp.ndarray,
                                  jnp.ndarray, jnp.ndarray]:
    """Steps 1-6 of the pipeline: the candidate sweep through decode.

    Returns (canon (K,4,2) canonical-order corners, cand_ids (K,)
    decoded id or -1, decoded (K,) bool, top_score (K,) component
    area) with K = max_candidates * number of passes. Slot placement
    (step 7) is separate so both slot layouts — slot == marker id
    (`detect_markers`) and the id->slot table (`detect_markers_mapped`)
    — share everything upstream.

    `stop` (a static string from `candidate_stage_names`) truncates the
    pipeline after that stage and returns its intermediates — purely a
    profiling hook (bench/detect_profile) so each stage's device cost
    is measurable as successive prefix differences.
    """
    d = dict_mod.load(cfg.dict_name)
    nbits = d.marker_bits
    cells = nbits + 2
    img = image.astype(jnp.float32)
    h, w = img.shape
    k = cfg.max_candidates

    # 1+2. adaptive threshold fused with each pass's downscale: the
    # binary is only ever consumed at /ds resolution (corner refinement
    # and decoding sample the grayscale directly), so threshold there —
    # "any dark pixel in the block" becomes min-pool(img) against a box
    # mean of avg-pool(img). This removes the 2-MP integral image that
    # dominated the profile.
    #
    # Foreground gate per pass: "contains a dark pixel" (min-pool) AND
    # "the block is dark on average" (avg-pool at half the offset). The
    # min alone floods under sensor noise — the min of a ds² block of
    # N(0, sigma) samples biases ~1.5 sigma below the mean, so sigma>5
    # turned whole frames foreground; the avg term is noise-reduced by
    # ds (sigma_eff = sigma/ds) and keeps the binary clean while thin
    # 1-lowres-px borders still pass.
    #
    # Each pass is labeled and harvested SEPARATELY (like OpenCV, which
    # extracts candidates per adaptiveThreshWinSize and merges the
    # candidate lists): OR-ing the binaries instead merges components a
    # small window keeps apart — on cluttered scenes a marker adjacent
    # to a dark shape survives the small window / fine downscale but
    # fuses into a non-quad blob in the union.
    if cfg.passes:
        passes = cfg.passes
    else:  # auto sweep honoring the thresh_win/downscale knobs
        w0, d0 = cfg.thresh_win, cfg.downscale
        passes = ((w0, d0), (3 * w0, d0))
        if d0 // 2 >= 2:
            passes = passes + ((w0, d0 // 2),)
    base_ds = max(ds for _, ds in passes)
    win_by_ds: dict[int, list[int]] = {}
    for wf, ds in passes:
        wl_ = max(3, wf // ds) | 1
        if wl_ not in win_by_ds.setdefault(ds, []):
            win_by_ds[ds].append(wl_)
    pools: dict[int, tuple] = {}
    per_pass = []
    raw_pools = []
    # pools finest-first: a coarser grid is an exact (f, f) pool of a
    # finer one (floor-division nests), so only the FINEST downscale
    # ever reads the 2-MP image — the ds=4 pools derive from the ds=2
    # pools at 1/4 the input size. reduce_window reads the image in its
    # own layout (a reshape-to-(hl, ds, wl, ds) form would relayout it).
    for ds in sorted({d for _, d in passes}):
        hl, wl = h // ds, w // ds
        src = next((d2 for d2 in sorted(pools, reverse=True)
                    if ds % d2 == 0), None)
        if src:
            f = ds // src
            small_min = jax.lax.reduce_window(
                pools[src][2], jnp.inf, jax.lax.min, (f, f), (f, f),
                "VALID")
            small_avg = jax.lax.reduce_window(
                pools[src][3], 0.0, jax.lax.add, (f, f), (f, f),
                "VALID") * (1.0 / (f * f))
        else:
            crop = img[: hl * ds, : wl * ds]
            small_min = jax.lax.reduce_window(
                crop, jnp.inf, jax.lax.min, (ds, ds), (ds, ds),
                "VALID")
            small_avg = jax.lax.reduce_window(
                crop, 0.0, jax.lax.add, (ds, ds), (ds, ds),
                "VALID") * (1.0 / (ds * ds))
        raw_pools.append((small_min, small_avg))
        # one shared integral image serves every window at this
        # downscale (the two coarse passes differ only in window)
        means = None if stop == "rawpools" else dict(
            zip(win_by_ds[ds], _box_mean_multi(
                small_avg, tuple(win_by_ds[ds]))))
        pools[ds] = (hl, wl, small_min, small_avg, means)
    for wf, ds in passes:
        if stop in ("pools", "rawpools"):
            continue
        hl, wl, small_min, small_avg, means = pools[ds]
        bg_label = hl * wl
        win_l = max(3, wf // ds) | 1  # odd, at labeling resolution
        mean = means[win_l]
        fg = (small_min < (mean - cfg.thresh_c)) \
            & (small_avg < (mean - 0.5 * cfg.thresh_c))
        # Fine-downscale passes run at 4x the coarse pixel count and
        # dominate the 3-pass sweep's cost, so they get HALF the
        # stencil budget. Only prop_iters is halved: convergence on
        # marker-scale shapes is carried by the segmented scans (the
        # long-range label transport), and a budget sweep against the
        # scipy.ndimage oracle shows (prop_iters 12..32, scan_rounds 4)
        # labels every rotated marker shape up to full frame with a
        # single label while ANY scan_rounds < 4 splits large markers
        # (worst split 25 at (24, 2)) — asserted at exactly this
        # halved budget by tests/test_detect.py
        # test_flood_converges_on_marker_shapes.
        fine = ds < base_ds
        fine_rounds = (cfg.scan_rounds if cfg.fine_scan_rounds is None
                       else cfg.fine_scan_rounds)
        # fine passes historically ran at HALF the stencil budget (4x
        # the pixels); never below the 16-round convergence floor
        fine_iters = max(16, cfg.prop_iters // 2)
        labels = _connected_components(
            fg, fine_iters if fine else cfg.prop_iters,
            scan_rounds=fine_rounds if fine else cfg.scan_rounds)

        # Fine-downscale passes exist to SEPARATE components the
        # coarse min-pool bridges; once labeled, everything downstream
        # (areas, candidate masks, quad seeds) runs on the label image
        # SUBSAMPLED back to the coarsest grid — label equality
        # survives strided subsampling, the sort shrinks 4x, the
        # (K, h, w) mask stack shrinks 4x, and the subpixel refinement
        # absorbs the coarser quad seed.
        sub = base_ds // ds
        labs = labels[::sub, ::sub] if sub > 1 else labels
        per_pass.append((labs, bg_label, ds))
    if stop == "rawpools":
        return tuple(x for rp in raw_pools for x in rp)
    if stop == "pools":
        return tuple(pools[ds][2] for ds in pools)
    if stop == "flood":
        return tuple(p[0] for p in per_pass)
    if stop == "sort":
        return jax.vmap(lambda l: jnp.sort(l.reshape(-1)))(
            jnp.stack([p[0] for p in per_pass]))

    # 3+4. component areas -> top-K candidates -> quad corners, BATCHED
    # over the passes: every pass's label image lands on the same
    # coarsest grid, so the sort/top-K/mask/extreme-point stages run as
    # ONE vmapped program over a (P, hl, wl) stack instead of P
    # separate kernel chains (same math per pass, so outputs are
    # bit-identical to the per-pass loop it replaces).
    #
    # Sort-based area histogram: sort the labels, find run starts, get
    # each run's length from the distance to the next start (reverse
    # cummin — no gathers) instead of a scatter-add histogram
    # (zeros.at[labels].add(1)).
    labs_stack = jnp.stack([p[0] for p in per_pass])  # (P, hl, wl)
    bgs = jnp.asarray([p[1] for p in per_pass], jnp.int32)

    def harvest(labs, bg_label):
        hl2, wl2 = labs.shape
        n = labs.size
        max_area = int(cfg.max_area_frac * n)
        idx = jnp.arange(n, dtype=jnp.int32)
        # keep each pixel's flat position through the sort: the
        # sorted array then holds every component as a CONTIGUOUS run
        # of its pixel positions, which is what lets the quad stage
        # slice compact per-candidate pixel lists instead of building
        # a (K, h, w) mask stack (see _quad_corners_compact).
        # UNSTABLE sort: within a run the position order is arbitrary,
        # and nothing downstream depends on it — the capped slice
        # keeps whole runs (cnt <= cap by the area gate), extremes are
        # order-free, and every tie-break packs positions explicitly
        s_lab, s_pos = jax.lax.sort((labs.reshape(-1), idx),
                                    num_keys=1, is_stable=False)
        start = jnp.concatenate(
            [jnp.ones(1, bool), s_lab[1:] != s_lab[:-1]])
        start_pos = jnp.where(start, idx, n)
        after = jnp.concatenate(
            [start_pos[1:], jnp.asarray([n], jnp.int32)])
        next_start = jax.lax.cummin(after, reverse=True)
        cnt = jnp.where(start, next_start - idx, 0)
        score = jnp.where(
            (s_lab < bg_label) & (cnt >= cfg.min_area)
            & (cnt <= max_area), cnt, 0)
        # Two-level top-K: a full-length top_k is a second O(n log n)
        # sort. Qualifying run-starts are
        # >= min_area slots apart in the sorted array (the earlier
        # qualifying run occupies that many slots), so a block-max
        # with block <= min_area can never merge two qualifying
        # scores — reduce 16x, then top_k the short array. The key
        # packs (score, inverted POSITION): position, not label —
        # fine-pass label values live in the fine grid (4x this
        # array's index range) and would overflow the key — and
        # inverted so score ties resolve to the LOWEST position,
        # exactly like the plain top_k this replaces.
        pos_bits = max(1, int(n).bit_length())
        score_bits = max(1, int(max_area).bit_length())
        blk = max(1, min(16, cfg.min_area))
        # the block reduction must leave >= k entries for top_k (tiny
        # frames: ceil(n/blk) < k) — fall back to the plain sort there
        if (pos_bits + score_bits <= 31 and blk > 1
                and (n + (-n) % blk) // blk >= k):
            pmask = (1 << pos_bits) - 1
            key = (score << pos_bits) | (n - 1 - idx)
            pad = (-n) % blk
            if pad:
                key = jnp.concatenate(
                    [key, jnp.zeros(pad, key.dtype)])
            red = key.reshape(-1, blk).max(axis=1)
            top_key, _ = jax.lax.top_k(red, k)
            top_score = top_key >> pos_bits
            starts = n - 1 - (top_key & pmask)  # run starts in s_pos
        else:
            if n < k:  # micro frame: fewer pixels than candidate slots
                score = jnp.concatenate(
                    [score, jnp.zeros(k - n, score.dtype)])
            top_score, starts = jax.lax.top_k(score, k)
        cand_ok = top_score > 0
        # compact per-candidate pixel lists: component j's pixels are
        # s_pos[starts_j : starts_j + cnt_j] (one contiguous slice) —
        # cap at max_area (the area gate's own bound). The slices run
        # as ALIGNED 2D row slabs of a (rows, 128) view — start row
        # st//128, the st%128 offset handled by the validity mask —
        # so every slice starts on a 128-element boundary instead of
        # an arbitrary offset
        cap = min(max_area, n)
        rows = cap // 128 + 2
        tot_rows = -(-n // 128) + rows
        pos_pad = jnp.concatenate(
            [s_pos, jnp.zeros(tot_rows * 128 - n, jnp.int32)]
        ).reshape(tot_rows, 128)
        slab = jax.vmap(lambda st: jax.lax.dynamic_slice(
            pos_pad, (st // 128, jnp.int32(0)), (rows, 128)))(starts)
        capw = rows * 128
        pix = slab.reshape(k, capw)              # (K, capw)
        off = (starts % 128)[:, None]
        j2 = jnp.arange(capw, dtype=jnp.int32)[None, :]
        valid = (j2 >= off) & (j2 < off + top_score[:, None]) \
            & cand_ok[:, None]
        xf = (pix % wl2).astype(jnp.float32)
        yf = (pix // wl2).astype(jnp.float32)
        return (_quad_corners_compact(xf, yf, valid), top_score,
                cand_ok)

    quads, scores, oks = jax.vmap(harvest)(labs_stack, bgs)
    if stop == "harvest":
        return quads, scores, oks
    # lift coarse-grid quads to full-res pixels (per-pass subpixel
    # center offset (ds-1)/2)
    offs = jnp.asarray([(p[2] - 1) / 2.0 for p in per_pass],
                       quads.dtype)
    quads_full = (quads * base_ds
                  + offs[:, None, None, None]).reshape(-1, 4, 2)
    top_score = scores.reshape(-1)
    cand_ok = oks.reshape(-1)
    k = k * len(passes)  # candidate count downstream of this point

    # Candidate budget: the passes see the SAME markers (that is the
    # sweep's point), so of the P*K harvested candidates only ~1/P are
    # distinct — yet subpixel refinement and decode pay for all of
    # them. Geometric dedup (same component found by several passes ->
    # centroids within ~2 coarse pixels; the best-scoring copy is the
    # one id-dedup would pick after decode anyway) then a global
    # top-`refine_budget` by area caps the downstream width. Distinct
    # markers can't collide: min_area forces >= 4x4 coarse-pixel
    # components, so centroids of different markers sit > 2 coarse px
    # apart.
    b = cfg.refine_budget
    if b and b < k:
        cent = quads_full.mean(axis=1)                     # (k, 2)
        idx_k = jnp.arange(k, dtype=jnp.int32)
        pri = top_score * k + (k - 1 - idx_k)  # score, tie: low index
        near = (jnp.max(jnp.abs(cent[:, None, :] - cent[None, :, :]),
                        axis=-1) < 2.0 * base_ds)
        better = near & cand_ok[None, :] & (pri[None, :] > pri[:, None])
        alive = cand_ok & ~better.any(axis=1)
        top_score, sel = jax.lax.top_k(
            jnp.where(alive, top_score, 0), b)
        quads_full = quads_full[sel]
        cand_ok = top_score > 0
        k = b

    # 5. subpixel refinement on the full-res image: a coarse pass pulls
    # the low-res (±downscale px) estimate into the basin, then a tight
    # window sharpens without dragging in the marker's interior edges.
    flat_c = quads_full.reshape(-1, 2)
    refined = _subpix_refine(
        image, flat_c,
        ((cfg.subpix_win, cfg.subpix_iters), (3, 4))).reshape(k, 4, 2)
    if stop == "subpix":
        return refined, top_score, cand_ok
    if stop == "homog":
        return _homography_cells(refined, cells)
    if stop == "sample":
        return _sample_cells(img, refined, cells)

    # 6. decode: sample cell centers through the quad homography
    bits, border_white = _sample_cells(img, refined, cells)
    border_ok = border_white <= cfg.border_max_white
    payload = bits[:, 1:-1, 1:-1].reshape(k, -1)

    table = jnp.asarray(d.table)                   # (N*4, nbits²)
    corr = (payload.astype(jnp.float32) * 2.0 - 1.0) @ table.T
    best = jnp.argmax(corr, axis=-1)
    hamming = ((nbits * nbits) - corr[jnp.arange(k), best]) / 2.0
    ids = jnp.asarray(d.table_ids)[best]
    rots = jnp.asarray(d.table_rot)[best]
    decoded = border_ok & (hamming <= cfg.max_hamming) & cand_ok

    # canonical corner order: roll so index 0 is the marker's TL
    def roll_one(c, r):
        return jnp.roll(c, -r, axis=0)

    canon = jax.vmap(roll_one)(refined, rots)
    cand_ids = jnp.where(decoded, ids, -1)
    return canon, cand_ids, decoded, top_score


@functools.partial(jax.jit, static_argnums=(1,))
def detect_markers(image: jnp.ndarray, cfg: DetectorConfig
                   ) -> Detections:
    """Detect ArUco markers in one grayscale frame (H, W) uint8/f32.

    Slot layout: slot == marker id — direct and stable, but it needs
    ``capacity`` >= max id + 1, which couples state size to the
    DICTIONARY (dict_5x5_1000 would need 1000 slots for one marker).
    For large dictionaries use `detect_markers_mapped`, which sizes
    capacity by the markers actually PRESENT via an id->slot table
    (the role the reference fills by keying landmarks in encounter
    order, reference filters/extended_kalman_filter.py:239-290).
    """
    canon, cand_ids, decoded, top_score = _detect_candidates(image, cfg)
    k = canon.shape[0]

    # 7. dedup into slot outputs (largest candidate wins per id),
    # fully data-parallel: per slot, argmax candidate score over the
    # (K, C) id-match matrix: one (K, C) reduction instead of a
    # sequential K-step .at[].set loop of tiny dynamic-update-slices.
    # Ties break to the LOWER candidate index (earlier pass), like the
    # loop did.
    ok = decoded & (cand_ids >= 0) & (cand_ids < cfg.capacity)
    match = ok[:, None] & (cand_ids[:, None]
                           == jnp.arange(cfg.capacity)[None, :])
    scores = jnp.where(match, top_score[:, None], -1)   # (K, C)
    best = jnp.argmax(scores, axis=0)                   # (C,)
    slot_mask = jnp.max(scores, axis=0) > 0
    slot_c = jnp.where(slot_mask[:, None, None], canon[best], 0.0)

    return Detections(corners=slot_c, mask=slot_mask,
                      cand_corners=canon, cand_ids=cand_ids,
                      cand_valid=decoded)


def slot_table_init(capacity: int, streams: int | None = None
                    ) -> jnp.ndarray:
    """Fresh id->slot table: (C,) int32 marker id per slot, -1 = free
    (leading (S,) axis with ``streams``). Slots are claimed in
    first-seen order by `assign_slots` and never freed, so a slot's
    marker id is stable for the whole run — landmark j in the filter
    IS marker table[j]."""
    lead = () if streams is None else (streams,)
    return jnp.full(lead + (capacity,), -1, jnp.int32)


def assign_slots(table_ids: jnp.ndarray, canon: jnp.ndarray,
                 cand_ids: jnp.ndarray, decoded: jnp.ndarray,
                 top_score: jnp.ndarray
                 ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Step 7 with an id->slot table: decouple marker id from slot.

    A decoded candidate whose id is already in ``table_ids`` lands in
    that slot; unseen ids claim the first free slot (first-seen
    compaction), so ``capacity`` is sized by markers PRESENT, not by
    the dictionary's id range (the reference keys landmarks by
    encounter order the same way, reference
    filters/extended_kalman_filter.py:239-290). When every slot is
    taken, further new ids are dropped (their candidates stay visible
    in the Detections diagnostics). Largest candidate wins per id, as
    in `detect_markers`.

    Returns (corners (C,4,2), mask (C,), new table_ids (C,)).
    """
    c = table_ids.shape[0]
    k = canon.shape[0]
    # Fully data-parallel form of the (conceptually sequential)
    # candidate loop — (K, K)/(K, C) masks instead of K tiny
    # dynamic-update-slice kernels. Semantics preserved exactly:
    #  * one WINNER per id: highest score, ties to the lower candidate
    #    index (the loop's strict-greater replacement rule),
    #  * unseen ids claim free slots in FIRST-OCCURRENCE order (the
    #    loop claims at the first same-id candidate, not the winner),
    #  * when free slots run out, later new ids drop.
    out = _assign_slots_impl(table_ids, canon, cand_ids, decoded,
                             top_score)
    return out[0], out[1], out[2]


def assign_slots_lru(table_ids: jnp.ndarray, last_seen: jnp.ndarray,
                     frame_idx, max_age: int, canon: jnp.ndarray,
                     cand_ids: jnp.ndarray, decoded: jnp.ndarray,
                     top_score: jnp.ndarray):
    """`assign_slots` with SLOT RECYCLING + saturation accounting —
    the bounded-state answer to the reference's unbounded landmark
    registration (reference extended_kalman_filter.py:239-290): long
    corridor-style runs traverse more distinct markers than slots, so
    a full table must not stop mapping forever.

    ``last_seen`` (C,): frame index each claimed slot last received an
    observation; ``frame_idx``: the current frame; ``max_age`` > 0
    lets a new id EVICT the least-recently-seen slot that has gone
    unobserved for more than max_age frames (truly-free slots are
    always claimed first; slots observed this frame are never
    evicted). max_age == 0 disables eviction but still counts drops.

    Returns (corners (C,4,2), mask (C,), table_ids, last_seen,
    evicted (C,) — slots reassigned THIS call, whose filter landmark
    must be reset before the update (FrameObservations.reset),
    dropped () int32 — new ids that found no slot: nonzero means the
    table SATURATED; surface it loudly à la MekfState.dropped_obs).
    """
    slot_c, slot_mask, table_ids, evicted, dropped = _assign_slots_impl(
        table_ids, canon, cand_ids, decoded, top_score,
        last_seen=last_seen, frame_idx=frame_idx, max_age=max_age)
    last_seen = jnp.where(slot_mask, jnp.asarray(frame_idx, jnp.int32),
                          last_seen)
    return slot_c, slot_mask, table_ids, last_seen, evicted, dropped


def _assign_slots_impl(table_ids, canon, cand_ids, decoded, top_score,
                       last_seen=None, frame_idx=None, max_age: int = 0):
    c = table_ids.shape[0]
    k = canon.shape[0]
    ok = decoded & (cand_ids >= 0)
    idx = jnp.arange(k, dtype=jnp.int32)
    same = ok[:, None] & ok[None, :] \
        & (cand_ids[:, None] == cand_ids[None, :])     # (K, K)
    occ = jnp.min(jnp.where(same, idx[None, :], k), axis=1)
    better = same & ((top_score[None, :] > top_score[:, None])
                     | ((top_score[None, :] == top_score[:, None])
                        & (idx[None, :] < idx[:, None])))
    winner = ok & ~better.any(axis=1)

    known = cand_ids[:, None] == table_ids[None, :]    # (K, C)
    has_known = known.any(axis=1)
    neww = winner & ~has_known
    rank = jnp.sum(neww[None, :] & (occ[None, :] < occ[:, None]),
                   axis=1)                             # claims before i
    free = table_ids < 0
    if max_age:
        # claim ordering: free slots first (in index order — the
        # historical first-seen compaction), then evictable slots
        # stalest-first. A slot receiving an observation THIS frame is
        # protected. Monotonic int32 key + top_k (ties -> lowest slot).
        receiving = (known & winner[:, None]).any(axis=0)  # (C,)
        age = jnp.asarray(frame_idx, jnp.int32) - last_seen
        stale = ~free & ~receiving & (age > max_age)
        big = jnp.int32(1) << 29      # 2*big must stay inside int32
        key = jnp.where(free, 2 * big,
                        jnp.where(stale, jnp.minimum(age, big - 1),
                                  jnp.int32(-1)))
        _, order = jax.lax.top_k(key, c)               # slots best-first
        n_claim = (free | stale).sum()
        claim_ok = neww & (rank < n_claim)
        slot_new = order[jnp.clip(rank, 0, c - 1)]
    else:
        free_rank = jnp.cumsum(free) - 1               # (C,)
        claim_ok = neww & (rank < free.sum())
        slot_new = jnp.argmax(free[None, :]
                              & (free_rank[None, :] == rank[:, None]),
                              axis=1)
    slot = jnp.where(has_known, jnp.argmax(known, axis=1), slot_new)
    placed = (winner & has_known) | claim_ok
    onehot = placed[:, None] & (jnp.arange(c)[None, :]
                                == slot[:, None])      # (K, C)
    claim_oh = onehot & claim_ok[:, None]
    claimed = claim_oh.any(axis=0)
    evicted = claimed & (table_ids >= 0)               # recycled slots
    dropped = (neww & ~claim_ok).sum().astype(jnp.int32)
    table_ids = jnp.where(
        claimed,
        jnp.sum(jnp.where(claim_oh, cand_ids[:, None], 0), axis=0,
                dtype=table_ids.dtype),
        table_ids)
    slot_mask = onehot.any(axis=0)
    slot_c = jnp.where(slot_mask[:, None, None],
                       canon[jnp.argmax(onehot, axis=0)], 0.0)
    return slot_c, slot_mask, table_ids, evicted, dropped


@functools.partial(jax.jit, static_argnums=(1,))
def detect_markers_mapped(image: jnp.ndarray, cfg: DetectorConfig,
                          table_ids: jnp.ndarray
                          ) -> tuple[Detections, jnp.ndarray]:
    """`detect_markers` with the id->slot table layout: slots are
    assigned first-seen (stable across frames via ``table_ids``), so
    ``cfg.capacity`` bounds simultaneous distinct markers, not the
    dictionary's id range. Returns (Detections, updated table_ids);
    thread the table through the run and translate slots back to
    marker ids at the output boundary (``table_ids[slot]``)."""
    canon, cand_ids, decoded, top_score = _detect_candidates(image, cfg)
    slot_c, slot_mask, table_ids = assign_slots(
        table_ids, canon, cand_ids, decoded, top_score)
    return Detections(corners=slot_c, mask=slot_mask,
                      cand_corners=canon, cand_ids=cand_ids,
                      cand_valid=decoded), table_ids


def detect_markers_batch(images: jnp.ndarray, cfg: DetectorConfig
                         ) -> Detections:
    """vmapped detection over a leading batch axis (B, H, W)."""
    return jax.vmap(lambda im: detect_markers(im, cfg))(images)


@functools.partial(jax.jit, static_argnums=(1,))
def detect_markers_batch_mapped(images: jnp.ndarray,
                                cfg: DetectorConfig,
                                table_ids: jnp.ndarray
                                ) -> tuple[jnp.ndarray, jnp.ndarray,
                                           jnp.ndarray]:
    """Mapped full detection over a CHUNK of consecutive frames of ONE
    stream (T, H, W): the heavy candidate pipeline vectorizes over
    frames (they are independent), and only the slot assignment —
    whose id->slot table is the single piece of cross-frame state —
    runs as a sequential scan. Returns (corners (T,C,4,2),
    mask (T,C), final table_ids)."""
    canon, cand_ids, decoded, top_score = jax.vmap(
        lambda im: _detect_candidates(im, cfg))(images)

    def step(tids, xs):
        sc, sm, tids = assign_slots(tids, *xs)
        return tids, (sc, sm)

    table_ids, (slot_c, slot_m) = jax.lax.scan(
        step, table_ids, (canon, cand_ids, decoded, top_score))
    return slot_c, slot_m, table_ids


@functools.partial(jax.jit, static_argnums=(1,))
def detect_markers_batch_lru(images: jnp.ndarray, cfg: DetectorConfig,
                             table_ids: jnp.ndarray,
                             last_seen: jnp.ndarray, frame0
                             ):
    """`detect_markers_batch_mapped` with LRU slot recycling +
    saturation accounting (see `assign_slots_lru`): the candidate
    pipeline vectorizes over the (T, H, W) chunk; slot assignment
    scans with (table_ids, last_seen) carry starting at absolute
    frame index ``frame0``.

    Returns (corners (T,C,4,2), mask (T,C), reset (T,C) — slots
    recycled at each frame, to be forwarded as
    FrameObservations.reset so the filter re-initializes them —
    ids_seq (T,C) the marker id occupying each slot AT each frame
    (offline epoch splitting needs pre-recycle ids the final table has
    overwritten), table_ids, last_seen, dropped (T,) per-frame
    saturated-id counts).
    """
    return assign_sequence_lru(
        cfg, table_ids, last_seen, frame0,
        *detect_candidates_batch(images, cfg))


@functools.partial(jax.jit, static_argnums=(1,))
def detect_candidates_batch(images: jnp.ndarray, cfg: DetectorConfig):
    """The vmapped candidate pipeline (steps 1-6) over a (T, H, W)
    chunk — the shardable heavy half of mapped detection (module-level
    jit so repeated driver calls hit one compile cache). Returns
    (canon, cand_ids, decoded, top_score) with leading T."""
    return jax.vmap(lambda im: _detect_candidates(im, cfg))(images)


@functools.partial(jax.jit, static_argnums=(0,))
def assign_sequence_lru(cfg: DetectorConfig, table_ids, last_seen,
                        frame0, canon, cand_ids, decoded, top_score):
    """The sequential half of `detect_markers_batch_lru`: scan LRU
    slot assignment over a (T, ...) candidate sequence. Split out so
    a DISTRIBUTED front end can shard the heavy per-frame candidate
    pipeline across processes and replicate only this cheap
    deterministic scan (apps/run_offline --distributed ingest)."""

    def step(cr, xs):
        tids, seen, i = cr
        sc, sm, tids, seen, ev, dr = assign_slots_lru(
            tids, seen, i, cfg.slot_max_age, *xs)
        return (tids, seen, i + 1), (sc, sm, ev, tids, dr)

    (table_ids, last_seen, _), (slot_c, slot_m, reset, ids_seq,
                                dropped) = \
        jax.lax.scan(step, (table_ids, last_seen, jnp.int32(frame0)),
                     (canon, cand_ids, decoded, top_score))
    return slot_c, slot_m, reset, ids_seq, table_ids, last_seen, dropped


@functools.partial(jax.jit, static_argnums=(3,))
def track_markers(image: jnp.ndarray, corners: jnp.ndarray,
                  mask: jnp.ndarray, cfg: DetectorConfig,
                  velocity: jnp.ndarray | None = None,
                  slot_ids: jnp.ndarray | None = None
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Track previously-detected markers into a new frame — the cheap
    per-frame half of a detect-every-K streaming pipeline.

    Instead of the full-frame candidate sweep, each live slot's 4
    corners are pulled to the new frame's corners by the same
    structure-tensor subpixel iteration the detector uses (first stage
    window ``cfg.track_win`` absorbs inter-frame motion up to that many
    pixels), then VALIDATED by re-decoding the payload through the quad
    homography: a tracked slot survives only if the bits still spell
    its own id (rotation 0 — tracked corners stay canonical) within
    ``max_hamming`` and the border is black. Markers that fail (left
    the frame, moved too fast, occluded) drop out and are re-acquired
    by the next full `detect_markers` pass; NEW markers only ever enter
    through a full pass.

    corners: (C, 4, 2) slot corners from the previous frame,
    mask: (C,) live slots. `velocity` (C, 4, 2), if given, is the
    per-corner displacement measured LAST step (constant-velocity
    prior): the search starts at corners + velocity, so only the
    frame-to-frame acceleration has to fit inside ``track_win`` —
    smooth camera pans of any speed stay locked once acquired.
    `slot_ids` (C,) gives each slot's marker id for the payload
    re-validation (-1 = free); None = slot index IS the id
    (`detect_markers` layout). Returns the same (corners, mask)
    shapes for this frame. Cost is ~candidate-free: three patch
    gathers + decode, a small fraction of the robust full sweep.
    """
    d = dict_mod.load(cfg.dict_name)
    c = corners.shape[0]
    if velocity is None:
        velocity = jnp.zeros_like(corners)
    if slot_ids is None:
        slot_ids = jnp.arange(c)
    ts = min(cfg.track_slots, c) if cfg.track_slots else c
    if ts < c:
        # Compact to the live slots: every stage below does per-slot
        # work (patch gathers, scalar homographies, payload decode),
        # so tracking 64 mostly-dead slots costs ~4x tracking the ~16
        # that can actually be alive. top_k on the mask picks the live
        # slot indices (ties resolve to the lowest ids — deterministic;
        # >track_slots simultaneously-visible markers fall back to
        # re-acquisition at the next full sweep).
        _, idx = jax.lax.top_k(mask.astype(jnp.int32), ts)
        rc, ok = _track_core(image, corners[idx], mask[idx],
                             velocity[idx], cfg, d, slot_ids[idx])
        return (corners.at[idx].set(rc),
                jnp.zeros(c, bool).at[idx].set(ok))
    return _track_core(image, corners, mask, velocity, cfg, d,
                       slot_ids)


def _track_core(image, corners, mask, velocity, cfg: DetectorConfig,
                d, slot_ids):
    """Tracking math on a (possibly compacted) slot set: corners
    (S,4,2), mask (S,), velocity (S,4,2), slot_ids (S,) marker id per
    row. Returns (corners (S,4,2), ok (S,))."""
    nbits = d.marker_bits
    cells = nbits + 2
    img = image.astype(jnp.float32)
    h, w = img.shape
    c = corners.shape[0]

    # Iterated median-consensus refinement. A single wide-window pull
    # per corner is not reliable: corners whose motion approaches the
    # window can stall at the drift clip or lock onto the WRONG
    # attractor (a payload-cell corner ~1 cell away). So: pull all 4
    # corners, take the per-marker MEDIAN displacement as the marker's
    # translation (robust to 2 bad corners of 4; stuck corners
    # contribute ~0, so the median can undershoot but not flip),
    # re-pull from the translated quad, update the median, then polish
    # with tight windows. Each round halves the worst-case residual
    # (undershoot ≤ motion/2), and the stage windows (track_win → 6 →
    # 3/2) cover it at every step. Frame-to-frame rotation/perspective
    # change at video rate is ~a pixel, absorbed by the tight stages.
    def consensus(seed, schedule):
        pulled = _subpix_refine(
            image, seed.reshape(-1, 2), schedule).reshape(c, 4, 2)
        return seed + jnp.median(pulled - seed, axis=1, keepdims=True)

    quad = consensus(corners + velocity,
                     ((cfg.track_win, cfg.subpix_iters),))
    quad = consensus(quad, ((6, 4),))
    refined = _subpix_refine(
        image, quad.reshape(-1, 2), ((3, 4), (2, 2))).reshape(c, 4, 2)
    # The polish can hop to a payload-cell attractor a few px off
    # (whose capture basin starts ~1.5 px out — and which can still
    # survive decode, compounding frame over frame). The consensus
    # quad is sub-px accurate once converged AND carries per-corner
    # velocity through seed0, so true shape change per frame is well
    # under a pixel: any corner that strayed further snaps back to
    # the quad instead of feeding the drift.
    refined = jnp.where(
        jnp.abs(refined - quad) > 1.25, quad, refined)

    bits, border_white = _sample_cells(img, refined, cells)
    payload = bits[:, 1:-1, 1:-1].reshape(c, -1)
    n = d.num_markers
    table = jnp.asarray(d.bits.reshape(n, -1).astype(bool))
    expected = table[jnp.clip(slot_ids, 0, n - 1)]
    hamming = (payload ^ expected).sum(-1)
    slot_live = (slot_ids >= 0) & (slot_ids < n)

    # off-frame check: a corner is invalid only when the FINAL tight
    # refine window (half=3, +1 px gradient border) cannot lie inside
    # the image at all. A wider clamp-derived margin (track_win+4 =
    # 12 px at defaults) dropped fully-visible edge-adjacent markers
    # on every tracked frame, flapping them between dropped and
    # full-sweep re-acquired; the consensus snap above bounds
    # per-corner drift to 1.25 px and the payload re-decode below
    # rejects real corruption, so geometry only requires the window
    # to fit.
    margin = 4.0
    xs, ys = refined[..., 0], refined[..., 1]
    in_frame = ((xs > margin) & (xs < w - margin)
                & (ys > margin) & (ys < h - margin)).all(-1)

    ok = (mask & slot_live & in_frame
          & (border_white <= cfg.border_max_white)
          & (hamming <= cfg.max_hamming))
    return refined, ok


def detect_or_track(image: jnp.ndarray, corners: jnp.ndarray,
                    mask: jnp.ndarray, velocity: jnp.ndarray,
                    do_full: jnp.ndarray, cfg: DetectorConfig
                    ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One streaming-detection step: full candidate sweep when
    `do_full` (a traced bool — e.g. ``i % K == 0`` inside a scan, or
    "tracked count collapsed"), else cheap tracking of the previous
    frame's corners with a constant-velocity prior. Both branches
    return slot (corners (C,4,2), mask (C,), velocity (C,4,2)), so
    this drops into a `lax.scan` carry directly.

    Velocity is the displacement since the previous frame for slots
    alive in both (0 for fresh acquisitions), in EITHER branch — so a
    slot that stays alive across a full pass keeps its prior, and two
    consecutive full passes bootstrap the prior for everything visible
    (schedule ``i % K < 2`` when the sequence moves fast; a fresh
    slot's first track step otherwise has to absorb the raw motion
    inside ``track_win``)."""

    def full(_):
        det = detect_markers(image, cfg)
        return (det.corners, det.mask,
                track_velocity(det.corners, det.mask, corners, mask))

    def track(_):
        nc, nm = track_markers(image, corners, mask, cfg, velocity)
        return nc, nm, track_velocity(nc, nm, corners, mask)

    return jax.lax.cond(do_full, full, track, None)


def detect_or_track_batch(images: jnp.ndarray, corners: jnp.ndarray,
                          mask: jnp.ndarray, velocity: jnp.ndarray,
                          do_full: jnp.ndarray, cfg: DetectorConfig
                          ) -> tuple[jnp.ndarray, jnp.ndarray,
                                     jnp.ndarray]:
    """Streaming step for a FLEET of video streams (S leading axis)
    sharing one full/track schedule. `do_full` must be a SCALAR (e.g.
    ``i % K < 2`` — the same for every stream): keeping the predicate
    unbatched keeps the branch a real `lax.cond`, whereas vmapping
    `detect_or_track` with per-stream predicates lowers the cond to a
    select that executes BOTH branches every frame (full detection
    always runs — tracking saves nothing). The cost: no per-stream
    "lost everything" early re-acquisition; a dropped stream waits for
    the next scheduled full sweep."""

    def full(_):
        det = detect_markers_batch(images, cfg)
        return (det.corners, det.mask,
                jax.vmap(track_velocity)(det.corners, det.mask,
                                         corners, mask))

    def track(_):
        nc, nm = jax.vmap(
            lambda im, c, m, v: track_markers(im, c, m, cfg, v)
        )(images, corners, mask, velocity)
        return nc, nm, jax.vmap(track_velocity)(nc, nm, corners, mask)

    return jax.lax.cond(do_full, full, track, None)


def detect_or_track_mapped(image: jnp.ndarray, corners: jnp.ndarray,
                           mask: jnp.ndarray, velocity: jnp.ndarray,
                           table_ids: jnp.ndarray, do_full: jnp.ndarray,
                           cfg: DetectorConfig
                           ) -> tuple[jnp.ndarray, jnp.ndarray,
                                      jnp.ndarray, jnp.ndarray]:
    """`detect_or_track` with the id->slot table layout: the table is
    part of the streaming carry, so slot assignments stay stable
    across full sweeps AND tracked frames (a slot's marker id never
    changes once claimed), and the tracker validates each slot's
    payload against table_ids[slot]."""

    def full(_):
        det, tids = detect_markers_mapped(image, cfg, table_ids)
        return (det.corners, det.mask,
                track_velocity(det.corners, det.mask, corners, mask),
                tids)

    def track(_):
        nc, nm = track_markers(image, corners, mask, cfg, velocity,
                               slot_ids=table_ids)
        return nc, nm, track_velocity(nc, nm, corners, mask), table_ids

    return jax.lax.cond(do_full, full, track, None)


def detect_or_track_batch_mapped(images: jnp.ndarray,
                                 corners: jnp.ndarray,
                                 mask: jnp.ndarray,
                                 velocity: jnp.ndarray,
                                 table_ids: jnp.ndarray,
                                 do_full: jnp.ndarray,
                                 cfg: DetectorConfig):
    """Fleet (leading S axis) streaming step with per-stream id->slot
    tables; same scalar-predicate contract as `detect_or_track_batch`."""

    def full(_):
        det, tids = jax.vmap(
            lambda im, t: detect_markers_mapped(im, cfg, t)
        )(images, table_ids)
        return (det.corners, det.mask,
                jax.vmap(track_velocity)(det.corners, det.mask,
                                         corners, mask), tids)

    def track(_):
        nc, nm = jax.vmap(
            lambda im, c, m, v, t: track_markers(im, c, m, cfg, v,
                                                 slot_ids=t)
        )(images, corners, mask, velocity, table_ids)
        return (nc, nm, jax.vmap(track_velocity)(nc, nm, corners, mask),
                table_ids)

    return jax.lax.cond(do_full, full, track, None)


def with_preset(cfg: DetectorConfig, preset: str) -> DetectorConfig:
    """Resolve a named full-sweep preset: "robust" = the multi-pass
    (window x scale) candidate sweep (cfg unchanged — `passes=None`
    auto-derives it), "fast" = the single coarse pass, built from the
    SAME thresh_win/downscale knobs so tuning them keeps the presets
    consistent everywhere (drivers + benches share this helper)."""
    if preset == "robust":
        return cfg
    if preset == "fast":
        return cfg._replace(passes=((cfg.thresh_win, cfg.downscale),))
    raise ValueError(f"unknown detector preset {preset!r}")


def streaming_init(cfg: DetectorConfig, streams: int | None = None,
                   mapped: bool = False):
    """Initial (corners, mask, velocity[, table_ids], frame index)
    carry for a `lax.scan` over `streaming_step`. ``mapped`` adds the
    id->slot table (see `detect_markers_mapped`)."""
    lead = () if streams is None else (streams,)
    cr = (jnp.zeros(lead + (cfg.capacity, 4, 2), jnp.float32),
          jnp.zeros(lead + (cfg.capacity,), bool),
          jnp.zeros(lead + (cfg.capacity, 4, 2), jnp.float32))
    if mapped:
        cr = cr + (slot_table_init(cfg.capacity, streams),)
    return cr + (jnp.int32(0),)


def streaming_step(cfg: DetectorConfig, track_every: int,
                   streams: int | None = None, mapped: bool = False,
                   rescue_cohorts: int = 0):
    """The ONE definition of the detect-every-K scan step, shared by
    the drivers and benches so the schedule cannot drift between them.

    Returns a `lax.scan` step over frames with carry (corners, mask,
    velocity[, table_ids], i): full sweep on the 2 bootstrap frames of
    every `track_every`-frame period, validated tracking in between.
    ``mapped`` switches to the id->slot table layout (carry gains the
    table; scan outputs are unchanged slot arrays).

    streams=None (single stream): the schedule also forces a full
    sweep the moment tracking has nothing left (all markers left frame
    / motion spike) instead of running out the period blind.
    streams=S (fleet, frames shaped (S, H, W)): the predicate must
    stay SCALAR so the full/track choice remains a real `lax.cond`
    (see detect_or_track_batch). With ``rescue_cohorts=0`` there is
    therefore no per-stream rescue — a dropped stream waits for the
    next scheduled sweep. ``rescue_cohorts=G`` restores rescue by
    SPLITTING the fleet into G cohorts of S/G streams: each cohort
    keeps its own scalar predicate (schedule staggered by K/G frames,
    which also smooths the fleet's per-frame cost), and a stream that
    loses everything triggers an immediate full sweep of ITS COHORT
    only — blast radius S/G streams, re-acquisition next frame
    instead of end-of-period. G single-stream cohorts (G == S) give
    exact single-stream rescue semantics at the cost of G compiled
    branch pairs.
    """
    ke = track_every
    if rescue_cohorts and streams:
        if streams % rescue_cohorts:
            raise ValueError(
                f"rescue_cohorts={rescue_cohorts} must divide "
                f"streams={streams}")
        return _cohort_step(cfg, ke, streams, rescue_cohorts, mapped)

    def step(cr, im):
        if mapped:
            c, m, v, tids, i = cr
            do_full = (i % ke) < 2
            if streams is None:
                c, m, v, tids = detect_or_track_mapped(
                    im, c, m, v, tids, do_full | ~m.any(), cfg)
            else:
                c, m, v, tids = detect_or_track_batch_mapped(
                    im, c, m, v, tids, do_full, cfg)
            return (c, m, v, tids, i + 1), (c, m)
        c, m, v, i = cr
        do_full = (i % ke) < 2
        if streams is None:
            c, m, v = detect_or_track(im, c, m, v,
                                      do_full | ~m.any(), cfg)
        else:
            c, m, v = detect_or_track_batch(im, c, m, v, do_full, cfg)
        return (c, m, v, i + 1), (c, m)

    return step


def _cohort_step(cfg: DetectorConfig, ke: int, streams: int,
                 cohorts: int, mapped: bool):
    """Staggered-cohort fleet step (see streaming_step): one scalar
    full/track predicate per cohort = real lax.cond per cohort, with
    dead-stream rescue bounded to the cohort."""
    per = streams // cohorts

    def step(cr, im):
        if mapped:
            c, m, v, tids, i = cr
        else:
            c, m, v, i = cr
        oc, om, ov, ot = [], [], [], []
        for g in range(cohorts):
            sl = slice(g * per, (g + 1) * per)
            # cohort g's bootstrap frames, phase-shifted by g*ke/G
            sched = ((i + (g * ke) // cohorts) % ke) < 2
            dead = (~m[sl].any(axis=-1)).any()
            pred = sched | dead
            if mapped:
                ck, mk, vk, tk = detect_or_track_batch_mapped(
                    im[sl], c[sl], m[sl], v[sl], tids[sl], pred, cfg)
                ot.append(tk)
            else:
                ck, mk, vk = detect_or_track_batch(
                    im[sl], c[sl], m[sl], v[sl], pred, cfg)
            oc.append(ck)
            om.append(mk)
            ov.append(vk)
        c = jnp.concatenate(oc)
        m = jnp.concatenate(om)
        v = jnp.concatenate(ov)
        if mapped:
            tids = jnp.concatenate(ot)
            return (c, m, v, tids, i + 1), (c, m)
        return (c, m, v, i + 1), (c, m)

    return step


def track_velocity(new_c: jnp.ndarray, new_m: jnp.ndarray,
                   old_c: jnp.ndarray, old_m: jnp.ndarray
                   ) -> jnp.ndarray:
    """Per-marker translation velocity for the tracking prior: the
    MEDIAN corner displacement, broadcast over corners. Deliberately
    translation-only — a per-corner velocity would bake any single
    corner's residual error into next frame's seed and compound it;
    shape change per frame is sub-px and the track windows absorb it."""
    med = jnp.median(new_c - old_c, axis=1, keepdims=True)
    return jnp.where((new_m & old_m)[:, None, None],
                     jnp.broadcast_to(med, new_c.shape), 0.0)


@functools.partial(jax.jit, static_argnums=(2, 3))
def refine_corners(image: jnp.ndarray, corners: jnp.ndarray,
                   half: int = 5, iters: int = 8) -> jnp.ndarray:
    """Public batched subpixel refinement of point features on one
    grayscale frame: corners (N, 2) → (N, 2). The structure-tensor
    iteration is cv2.cornerSubPix's math, which converges to both
    marker (edge) corners and chessboard saddle points — used by the
    ChArUco calibration path (ops/calibrate.py) the way the
    reference's CharucoDetector refines interpolated corners
    (reference calibration/charuco_calibration.py:59-61)."""
    return _subpix_refine(image, corners, ((half, iters),))
