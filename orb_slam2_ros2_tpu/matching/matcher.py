"""Descriptor matching suite: dense, masked, batched.

The reference walks grid buckets per query and scans candidate lists with
best/second-best bookkeeping (reference: src/ORBMatcher.cc — searchByProjection
×2 at :265-347/:561-612, getBestMatch :967-990, verifyAngle :1013-1051,
VirtualFrame::findFeaturesInArea src/Frame.cc:286-311).  This design drops
the 48×64 grid entirely: every search is a full Q×T hamming matrix (one
matmul) with a geometric candidate mask, one masked argmin, and vectorized
ratio / rotation-histogram post-filters.  At Q, T ≤ 2048 the dense matrix
replaces gather-based bucketing.

Conventions: invalid entries never match (masks), −1 indices mean "no match".
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..features.frame import FrameFeatures
from ..geometry import se3
from ..geometry.camera import CameraParams, project
from ..ops.hamming import hamming_matrix

BIG = 1 << 20


class MatchResult(NamedTuple):
    """Per-query match: index into the target set (−1 = none) and distance."""

    idx: jnp.ndarray    # i32[Q]
    dist: jnp.ndarray   # i32[Q]

    @property
    def found(self) -> jnp.ndarray:
        return self.idx >= 0


def best_match(
    dist: jnp.ndarray,
    cand_mask: jnp.ndarray,
    max_dist: int,
    ratio: float,
) -> MatchResult:
    """Masked best/second-best selection with ratio test per query row.

    Mirrors getBestMatch + the ``best < threshold && best/second < ratio``
    acceptance used at every call site (e.g. ORBMatcher.cc:339, :591).
    A query with a single candidate passes the ratio test trivially
    (second-best = BIG ⇒ ratio ≈ 0), like the reference's INT_MAX second.
    """
    masked = jnp.where(cand_mask, dist, BIG)
    # best + second-best via two min passes (row-wise top_k is sort-based)
    best = jnp.min(masked, axis=1)
    best_idx = jnp.argmin(masked, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, masked.shape, 1)
    second = jnp.min(jnp.where(cols == best_idx[:, None], BIG, masked), axis=1)
    ok = (best <= max_dist) & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    return MatchResult(idx=jnp.where(ok, best_idx, -1), dist=best)


def mutual_filter(match_qt: MatchResult, n_target: int) -> MatchResult:
    """Keep only matches where each target is claimed by a single best query
    (the reference achieves uniqueness by marking slots; here: per-target
    argmin over claiming queries)."""
    q = match_qt.idx.shape[0]
    tgt = jnp.where(match_qt.found, match_qt.idx, n_target)
    # per target, find the claiming query with smallest distance; clip the
    # distance so key construction stays inside int32 (hamming ≤ 256 anyway)
    order_key = jnp.minimum(match_qt.dist, 300) * (q + 1) + jnp.arange(q)  # unique keys
    best_key = jnp.full((n_target + 1,), jnp.iinfo(jnp.int32).max).at[tgt].min(order_key)
    keep = match_qt.found & (best_key[tgt] == order_key)
    return MatchResult(idx=jnp.where(keep, match_qt.idx, -1), dist=match_qt.dist)


def rotation_consistency(
    angle_q: jnp.ndarray,
    angle_t_of_match: jnp.ndarray,
    found: jnp.ndarray,
    n_bins: int = 30,
    n_keep: int = 3,
) -> jnp.ndarray:
    """Rotation-consistency filter: histogram the per-match angle difference,
    keep matches in the ``n_keep`` most-populated bins
    (reference verifyAngle, ORBMatcher.cc:1013-1051)."""
    diff = jnp.mod(angle_q - angle_t_of_match, 360.0)
    bins = jnp.clip((diff / (360.0 / n_bins)).astype(jnp.int32), 0, n_bins - 1)
    counts = jnp.zeros((n_bins,), jnp.int32).at[bins].add(found.astype(jnp.int32))
    topv, topi = jax.lax.top_k(counts, n_keep)
    good_bin = jnp.zeros((n_bins,), bool).at[topi].set(topv > 0)
    return found & good_bin[bins]


def area_candidates(
    query_uv: jnp.ndarray,
    query_octave: jnp.ndarray,
    target: FrameFeatures,
    radius: float,
    min_octave: jnp.ndarray,
    max_octave: jnp.ndarray,
    scale_factor: float,
) -> jnp.ndarray:
    """Dense replacement for findFeaturesInArea: mask [Q, T] of target
    keypoints within ``radius · scale^octave_q`` of each query position, with
    octave window (reference Frame.cc:286-311; radius scaling at :289)."""
    r = radius * jnp.power(jnp.float32(scale_factor), query_octave.astype(jnp.float32))
    du = jnp.abs(query_uv[:, None, 0] - target.uv[None, :, 0])
    dv = jnp.abs(query_uv[:, None, 1] - target.uv[None, :, 1])
    in_area = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (target.octave[None, :] >= min_octave[:, None]) & (
        target.octave[None, :] <= max_octave[:, None]
    )
    return in_area & oct_ok & target.valid[None, :]


def forward_backward_octaves(
    query_octave: jnp.ndarray, z_forward: jnp.ndarray, baseline: float, n_levels: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's forward/backward octave-window logic for motion-model
    matching (ORBMatcher.cc:271-309): moving forward → features appear larger
    → allow [oct, max]; backward → [0, oct]; else ±1."""
    up = z_forward > baseline
    down = z_forward < -baseline
    lo = jnp.where(up, query_octave, jnp.where(down, 0, jnp.maximum(0, query_octave - 1)))
    hi = jnp.where(
        up, n_levels - 1, jnp.where(down, query_octave, jnp.minimum(n_levels - 1, query_octave + 1))
    )
    return lo, hi


def search_by_area(
    prev: FrameFeatures,
    prev_has_mp: jnp.ndarray,
    cur: FrameFeatures,
    cur_has_mp: jnp.ndarray,
    z_forward: jnp.ndarray,
    *,
    radius: float,
    scale_factor: float,
    n_levels: int,
    baseline: float,
    max_dist: int,
    ratio: float,
    check_rotation: bool = True,
) -> MatchResult:
    """Motion-model matching: for each previous-frame keypoint that carries a
    map point, find the best current-frame keypoint near its *image position*
    (the reference searches around the last frame's pixel location rather
    than reprojecting, ORBMatcher.cc:266-347).  Current keypoints that
    already hold a map point are excluded (ORBMatcher.cc:321-334).

    Returns per-PREV-keypoint match indices into the current frame.
    """
    lo, hi = forward_backward_octaves(prev.octave, z_forward, baseline, n_levels)
    cand = area_candidates(prev.uv, prev.octave, cur, radius, lo, hi, scale_factor)
    cand = cand & prev.valid[:, None] & prev_has_mp[:, None] & (~cur_has_mp)[None, :]
    dist = hamming_matrix(prev.desc, cur.desc)
    m = best_match(dist, cand, max_dist, ratio)
    if check_rotation:
        keep = rotation_consistency(prev.angle, cur.angle[jnp.maximum(m.idx, 0)], m.found)
        m = MatchResult(idx=jnp.where(keep, m.idx, -1), dist=m.dist)
    return mutual_filter(m, cur.capacity)


def mappoint_visibility(
    cam: CameraParams,
    Tcw: jnp.ndarray,
    mp_pos: jnp.ndarray,      # [M, 3] world
    mp_normal: jnp.ndarray,   # [M, 3] mean view dir (unit)
    mp_min_dist: jnp.ndarray,
    mp_max_dist: jnp.ndarray,
    *,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
):
    """MapPoint::isInVision + predictLevel, batched (reference
    MapPoint.cc:141-171, :191-201): returns (uv [M,2], visible [M],
    pred_octave [M], cos_view [M])."""
    pc = se3.apply(Tcw, mp_pos)
    uv, in_front = project(cam, pc)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    )
    Twc = se3.inverse(Tcw)
    ray = mp_pos - se3.t_of(Twc)
    dist = jnp.linalg.norm(ray, axis=-1)
    dist_ok = (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
    cos_view = jnp.sum(ray * mp_normal, axis=-1) / jnp.maximum(dist, 1e-9)
    angle_ok = cos_view >= 0.5
    level = jnp.ceil(
        jnp.log(jnp.maximum(mp_max_dist / jnp.maximum(dist, 1e-9), 1e-9))
        / jnp.log(scale_factor)
    ).astype(jnp.int32)
    level = jnp.clip(level, 0, n_levels - 1)
    visible = in_front & in_img & dist_ok & angle_ok
    return uv, visible, level, cos_view


def search_mappoints_projection(
    cam: CameraParams,
    Tcw: jnp.ndarray,
    mp_pos: jnp.ndarray,
    mp_normal: jnp.ndarray,
    mp_min_dist: jnp.ndarray,
    mp_max_dist: jnp.ndarray,
    mp_desc: jnp.ndarray,
    mp_valid: jnp.ndarray,
    cur: FrameFeatures,
    cur_has_mp: jnp.ndarray,
    *,
    th: float,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    max_dist: int,
    ratio: float,
    exclude_taken: bool = True,
    precomputed_vis=None,
) -> MatchResult:
    """Local-map tracking search: project map points, view-angle-adaptive
    radius (2.5 if cosθ > 0.998 else 4.0, ×th), octave ±1 window around the
    predicted level, ratio + threshold gates (reference ORBMatcher.cc:561-612).

    ``precomputed_vis`` lets a caller that also needs the visibility output
    (the tracker's counter bookkeeping) pay for ``mappoint_visibility`` once.

    Returns per-MAP-POINT match indices into the current frame.
    """
    if precomputed_vis is not None:
        uv, visible, level, cos_view = precomputed_vis
    else:
        uv, visible, level, cos_view = mappoint_visibility(
            cam, Tcw, mp_pos, mp_normal, mp_min_dist, mp_max_dist,
            width=width, height=height, scale_factor=scale_factor, n_levels=n_levels,
        )
    base_r = jnp.where(cos_view > 0.998, 2.5, 4.0) * th
    r = base_r * jnp.power(jnp.float32(scale_factor), level.astype(jnp.float32))
    du = jnp.abs(uv[:, None, 0] - cur.uv[None, :, 0])
    dv = jnp.abs(uv[:, None, 1] - cur.uv[None, :, 1])
    in_area = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (cur.octave[None, :] >= jnp.maximum(level - 1, 0)[:, None]) & (
        cur.octave[None, :] <= jnp.minimum(level + 1, n_levels - 1)[:, None]
    )
    cand = in_area & oct_ok & cur.valid[None, :] & visible[:, None] & mp_valid[:, None]
    if exclude_taken:
        cand = cand & (~cur_has_mp)[None, :]
    dist = hamming_matrix(mp_desc, cur.desc)
    m = best_match(dist, cand, max_dist, ratio)
    return mutual_filter(m, cur.capacity)
