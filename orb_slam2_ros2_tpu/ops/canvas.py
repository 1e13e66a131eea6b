"""Flat pyramid canvas: all pyramid levels stacked into one tall image.

New design (no reference counterpart): per-keypoint patch operations
(orientation moments, BRIEF sampling, stereo SAD) must gather from the
keypoint's *own pyramid level*.  Levels have different static shapes, so
instead of eight separately-shaped gathers we write every level into one
[ΣHl, W0] canvas at a static row offset.  A keypoint's patch address is then
``(v_level + row_offset[octave], u_level)`` — one uniform gather space for
all octaves, one gather for the whole frame.
"""

from __future__ import annotations

import numpy as np

from .pyramid import level_shapes


def canvas_layout(h: int, w: int, n_levels: int, scale_factor: float):
    """Static layout: (row_offsets [n_levels], total_rows, level_shapes)."""
    shapes = level_shapes(h, w, n_levels, scale_factor)
    offsets = []
    acc = 0
    for hl, _ in shapes:
        offsets.append(acc)
        acc += hl
    return np.array(offsets, np.int32), acc, shapes


def padded_canvas_shape(h: int, w: int, n_levels: int, scale_factor: float):
    """Canvas dims padded so the patch window's clamp bounds (56 × 256,
    ``ops.patches``) never bind for any legal keypoint: x = u−22 ≤ w−46
    needs cols ≥ w+210; y ≤ total−23 needs rows ≥ total+33."""
    _, total_rows, _ = canvas_layout(h, w, n_levels, scale_factor)
    cols = ((w + 210) + 127) // 128 * 128
    rows = total_rows + 40
    return rows, cols
