"""Plain NumPy references for the frontend's image kernels.

Brute-force definitions, written independently of the array formulations
in ``ops.fast`` and ``ops.patches``; the tests and ``chip_smoke.py`` hold
those to these.  Arithmetic runs in the input's dtype (bf16 arrays come in
as ``ml_dtypes.bfloat16``), so equality is exact, not approximate.
"""

from __future__ import annotations

import numpy as np

from .fast import ARC_LEN, CIRCLE_OFFSETS
from .patches import CENTER, PATCH_COLS, PATCH_ROWS, WIN_COLS, WIN_ROWS


def fast_score_np(img: np.ndarray, threshold: float) -> np.ndarray:
    """FAST-9/16 corner response of an [H, W] image, f32[H, W].

    For every pixel and each of the 16 starting points of the ring, the
    arc's score is the smallest of its 9 circle differences (bright arc) or
    of their negations (dark arc); the pixel's score is the largest arc
    score, kept where it exceeds ``threshold``.  The 3-px frame where the
    ring leaves the image is 0."""
    h, w = img.shape
    r = 3
    centre = img[r:h - r, r:w - r]
    d = np.stack([
        (img[r + dy:h - r + dy, r + dx:w - r + dx] - centre).astype(np.float32)
        for dy, dx in CIRCLE_OFFSETS
    ])                                                # [16, H-6, W-6]
    best = np.zeros(centre.shape, np.float32)
    for s in range(16):
        arc = d[[(s + j) % 16 for j in range(ARC_LEN)]]
        best = np.maximum(best, np.maximum(arc.min(axis=0), (-arc).min(axis=0)))
    out = np.zeros((h, w), np.float32)
    out[r:h - r, r:w - r] = np.where(best > threshold, best, 0.0)
    return out


def nms3_np(score: np.ndarray) -> np.ndarray:
    """3×3 non-max suppression of an [H, W] map: keep pixels no smaller than
    any neighbour inside the image."""
    h, w = score.shape
    s = np.asarray(score, np.float32)
    padded = np.full((h + 2, w + 2), -np.inf, np.float32)
    padded[1:-1, 1:-1] = s
    pooled = np.max(
        [padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
         for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)
    return np.where(s >= pooled, s, 0.0).astype(np.float32)


def patches_np(canvas: np.ndarray, centers_yx: np.ndarray) -> np.ndarray:
    """f32[N, 48, 64] windows of ``canvas`` by slicing, with the window
    origin clamped as ``ops.patches.extract_patches`` documents."""
    h, w = canvas.shape
    out = np.empty((len(centers_yx), PATCH_ROWS, PATCH_COLS), np.float32)
    for i, (cy, cx) in enumerate(np.asarray(centers_yx)):
        y = min(max(int(cy) - CENTER, 0), h - WIN_ROWS)
        x = min(max(int(cx) - CENTER, 0), w - WIN_COLS)
        out[i] = canvas[y:y + PATCH_ROWS, x:x + PATCH_COLS]
    return out
