"""FAST-9/16 corner detection as whole-image batched array ops.

The reference runs cv::FAST per 30×30 cell with a 20→7 threshold fallback,
then uniformizes keypoints with a quadtree that keeps the max-response corner
per node (reference: src/ORBExtractor.cc:331-387 ``extractFast``,
ORBExtractor.cc:19-192 ``Quadtree``).  That is a per-pixel branchy CPU
design.  Here:

- the FAST *score map* is computed for the whole level at once: 16 rolled
  copies of the image give the circle differences, a log-depth AND/min
  reduction finds 9-contiguous arcs, and the score is the exact FAST corner
  response max over arcs of the min circle difference (the "largest threshold
  for which this is still a corner" definition);
- 3×3 non-max suppression is a max-pool comparison;
- the quadtree is replaced by fixed-shape *per-cell top-k selection*: each
  16×16 cell contributes its best K corners, candidates are ranked by
  (rank-within-cell, −score) so every cell's best corner outranks any cell's
  second — the same spatial-uniformization objective, in one sort.

The 20→7 two-threshold fallback emerges naturally: scores are computed at the
low threshold and stronger corners win within each cell.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3, 16 points, clockwise from 12 o'clock — the
# standard FAST-16 ring (same ring cv::FAST uses).  (dy, dx) pairs.
CIRCLE_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9: 9 contiguous circle pixels (cv::FastFeatureDetector::TYPE_9_16)


def fast_score(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Exact FAST-9/16 corner response for every pixel of [..., H, W] f32
    (leading dims batch — a stereo pair scores in the same ops).

    Returns a score map: 0 where not a corner at ``threshold``, else the
    maximum over qualifying 9-arcs of the minimum absolute circle difference
    (so score > t ⟺ pixel is a FAST corner at threshold t).
    """
    d = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(-2, -1)) for dy, dx in CIRCLE_OFFSETS]
    ) - img[None]  # [16, ..., H, W]

    def arc_min(v: jnp.ndarray) -> jnp.ndarray:
        """min over 9 consecutive ring entries (circular), log-depth doubling."""
        m = v                                   # runs of length 1
        m = jnp.minimum(m, jnp.roll(m, -1, 0))  # 2
        m = jnp.minimum(m, jnp.roll(m, -2, 0))  # 4
        m = jnp.minimum(m, jnp.roll(m, -4, 0))  # 8
        m = jnp.minimum(m, jnp.roll(v, -8, 0))  # 9
        return m

    score_bright = jnp.max(arc_min(d), axis=0)    # darker→negative, bright arcs
    score_dark = jnp.max(arc_min(-d), axis=0)
    score = jnp.maximum(score_bright, score_dark)
    return jnp.where(score > threshold, score, 0.0)


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3×3 non-max suppression over the trailing two axes: keep pixels equal
    to their neighbourhood max.  Leading dims batch."""
    nb = score.ndim - 2
    window = (1,) * nb + (3, 3)
    strides = (1,) * nb + (1, 1)
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, window, strides, "SAME"
    )
    return jnp.where(score >= pooled, score, 0.0)


def select_keypoints(
    score: jnp.ndarray,
    capacity: int,
    border: int,
    cell: int = 16,
    topk_per_cell: int = 4,
    strong_threshold: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Spatially-uniform top-``capacity`` corner selection (quadtree replacement).

    Returns (uv [capacity, 2] f32 in (u=x, v=y) order, response [capacity],
    valid [capacity] bool).  Ranking key: (rank within cell, −score), so
    coverage beats raw response — the quadtree's behaviour.  Corners at or
    above ``strong_threshold`` outrank weaker ones one rank-class earlier,
    emulating the reference's high/low FAST threshold preference.
    """
    h, w = score.shape
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    in_border = (
        (row_ids >= border) & (row_ids < h - border)
        & (col_ids >= border) & (col_ids < w - border)
    )
    # stay in the map's native dtype (bf16 image plane) until after the cell
    # reduction — casting the whole [H, W] map to f32 costs a full extra pass
    score = jnp.where(in_border, score, jnp.zeros((), score.dtype))

    hc, wc = -(-h // cell), -(-w // cell)
    pad_h, pad_w = hc * cell - h, wc * cell - w
    sp = jnp.pad(score, ((0, pad_h), (0, pad_w)))
    cells = sp.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(hc * wc, cell * cell)

    k = topk_per_cell
    vals, idx = jax.lax.top_k(cells, k)               # [hc*wc, k]
    vals = vals.astype(jnp.float32)
    cell_row = jax.lax.broadcasted_iota(jnp.int32, (hc * wc, k), 0) // wc
    cell_col = jax.lax.broadcasted_iota(jnp.int32, (hc * wc, k), 0) % wc
    py = cell_row * cell + idx // cell
    px = cell_col * cell + idx % cell
    rank = jax.lax.broadcasted_iota(jnp.int32, (hc * wc, k), 1)
    # weak corners are demoted by k rank-classes relative to strong ones
    rank = rank + jnp.where(vals >= strong_threshold, 0, k)

    flat_vals = vals.reshape(-1)
    flat_rank = rank.reshape(-1)
    flat_py = py.reshape(-1)
    flat_px = px.reshape(-1)
    valid_cand = flat_vals > 0.0

    big = jnp.float32(1e4)
    key = jnp.where(valid_cand, -flat_rank.astype(jnp.float32) * big + flat_vals, -jnp.inf)
    n_cand = key.shape[0]
    take = min(capacity, n_cand)
    top_keys, top_idx = jax.lax.top_k(key, take)
    sel_valid = jnp.isfinite(top_keys)
    uv = jnp.stack(
        [flat_px[top_idx].astype(jnp.float32), flat_py[top_idx].astype(jnp.float32)],
        axis=-1,
    )
    resp = flat_vals[top_idx]
    if take < capacity:
        pad = capacity - take
        uv = jnp.pad(uv, ((0, pad), (0, 0)))
        resp = jnp.pad(resp, (0, pad))
        sel_valid = jnp.pad(sel_valid, (0, pad))
    return uv, resp, sel_valid
