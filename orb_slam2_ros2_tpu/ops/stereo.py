"""Stereo keypoint matching: batched hamming coarse match + SAD refinement.

The reference loops over left keypoints, pulls row-bucketed right candidates,
hamming-matches, then refines disparity with an 11×11 SAD sweep ±5 px and a
sub-pixel parabola (reference: src/ORBMatcher.cc:18-81 ``searchByStereo``,
:841-905 ``pixelSADMatch``/``SAD``, :915-932 ``createRowIndexDB``).

Design: the row database disappears — one N×N hamming matrix (a matmul)
with a row/disparity/validity mask, one argmin, then a batched SAD sweep as
strip gathers from the pyramid canvas.  Gates preserved from the reference:

- candidate window: |v_L − v_R| ≤ 2·scale^octave_R, u_L − fx < u_R < u_L
- best distance ≤ mean_threshold (75)
- |octave_L − octave_R| ≤ 1
- SAD patches are center-intensity-subtracted before the L1 norm
- sub-pixel parabola accepted only when the minimum is interior and |δ| < 1

Deviation (documented): the reference adds only the sub-pixel offset to the
right keypoint's u, silently dropping the integer SAD displacement
(ORBMatcher.cc:863-878).  We add the full displacement (bestL − 5 + δ),
which is the standard (and more accurate) refinement.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .hamming import hamming_matrix


def extract_rect(canvas: jnp.ndarray, centers_yx: jnp.ndarray, half_y: int, half_x: int) -> jnp.ndarray:
    """Gather [N, 2·half_y+1, 2·half_x+1] windows around integer centers."""
    hy, hx = 2 * half_y + 1, 2 * half_x + 1

    def one(c):
        return jax.lax.dynamic_slice(canvas, (c[0] - half_y, c[1] - half_x), (hy, hx))

    return jax.vmap(one)(centers_yx)


def level_coords(uv_raw: jnp.ndarray, octave: jnp.ndarray, scale_factor: float) -> jnp.ndarray:
    """Level-0 pixel coords → the keypoint's own pyramid-level coords."""
    inv = jnp.power(jnp.float32(1.0 / scale_factor), octave.astype(jnp.float32))
    return uv_raw * inv[..., None]


def canvas_centers(
    uv_raw: jnp.ndarray, octave: jnp.ndarray, scale_factor: float, row_offsets: jnp.ndarray
) -> jnp.ndarray:
    """Integer (y, x) canvas addresses of keypoints at their own level."""
    lc = level_coords(uv_raw, octave, scale_factor)
    y = jnp.round(lc[..., 1]).astype(jnp.int32) + row_offsets[octave]
    x = jnp.round(lc[..., 0]).astype(jnp.int32)
    return jnp.stack([y, x], axis=-1)


def stereo_match(
    featL,
    featR,
    patchesL: jnp.ndarray,
    patchesR: jnp.ndarray,
    *,
    scale_factor: float,
    fx: float,
    bf: float,
    image_width: int,
    mean_threshold: int = 75,
    sad_half: int = 5,
    search_half: int = 5,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Match left→right keypoints, return (right_u [N], depth [N]); −1 = none.

    ``patchesL/R`` are the f32[N, 48, 64] keypoint patches the extractor
    already extracted for BRIEF (centred at PATCH_CENTER on each keypoint's own
    pyramid level) — the SAD windows are static sub-slices of them, so the
    refinement costs no extra image gathers at all.
    """
    uvL, uvR = featL.uv, featR.uv
    n = uvL.shape[0]

    dist = hamming_matrix(featL.desc, featR.desc)  # [N, M] int32

    scale_r = jnp.power(jnp.float32(scale_factor), featR.octave.astype(jnp.float32))
    row_slack = 2.0 * scale_r  # per right keypoint (createRowIndexDB)
    dv = jnp.abs(uvL[:, None, 1] - uvR[None, :, 1])
    du = uvL[:, None, 0] - uvR[None, :, 0]  # = disparity if matched
    cand = (
        featL.valid[:, None]
        & featR.valid[None, :]
        & (dv <= row_slack[None, :])
        & (du > 0.0)
        & (du < fx)
    )
    BIG = jnp.int32(1 << 20)
    masked = jnp.where(cand, dist, BIG)
    best_j = jnp.argmin(masked, axis=1)
    best_d = jnp.take_along_axis(masked, best_j[:, None], axis=1)[:, 0]

    # left↔right mutual-best consistency (an addition, not in the reference):
    # repetitive texture along the epipolar line produces aliased matches that
    # the reference's one-way best match lets through; requiring the right
    # keypoint to pick the same left keypoint removes most of them for free
    # (the full distance matrix is already on chip).
    best_i = jnp.argmin(masked, axis=0)
    mutual = best_i[best_j] == jnp.arange(masked.shape[0])

    oct_r = featR.octave[best_j]
    ok = (
        (best_d <= mean_threshold)
        & (jnp.abs(featL.octave - oct_r) <= 1)
        & (best_d < BIG)
        & mutual
    )

    # ---- SAD refinement on each keypoint's own pyramid level -----------------
    from .patches import CENTER as PC

    uvR_best = featR.uv_raw[best_j]

    w = sad_half
    # static sub-windows of the keypoint patches (patch centre = keypoint);
    # patches are f32 upcasts of the bf16 canvas, which the sub-pixel
    # parabola needs anyway
    patchL = patchesL[:, PC - w : PC + w + 1, PC - w : PC + w + 1]
    strip_all = patchesR[
        :, PC - w : PC + w + 1, PC - w - search_half : PC + w + search_half + 1
    ]
    strip = strip_all[best_j]                                      # [N, 11, 21]
    patchL = patchL - patchL[:, w, w][:, None, None]

    n_shifts = 2 * search_half + 1
    wins = jnp.stack([strip[:, :, s : s + 2 * w + 1] for s in range(n_shifts)], axis=1)
    centers = wins[:, :, w, w]                                     # [N, S]
    wins = wins - centers[:, :, None, None]
    scores = jnp.sum(jnp.abs(wins - patchL[:, None]), axis=(-1, -2))  # [N, S]

    best_l = jnp.argmin(scores, axis=1)
    interior = (best_l > 0) & (best_l < n_shifts - 1)
    il = jnp.clip(best_l, 1, n_shifts - 2)
    s1 = jnp.take_along_axis(scores, il[:, None] - 1, axis=1)[:, 0]
    s2 = jnp.take_along_axis(scores, il[:, None], axis=1)[:, 0]
    s3 = jnp.take_along_axis(scores, il[:, None] + 1, axis=1)[:, 0]
    denom = s1 + s3 - 2.0 * s2
    delta = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (s1 - s3) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1.0), 0.0)
    delta = jnp.where(interior & (jnp.abs(delta) < 1.0), delta, 0.0)
    shift = jnp.where(interior, best_l.astype(jnp.float32) - search_half + delta, 0.0)

    scale_best = jnp.power(jnp.float32(scale_factor), oct_r.astype(jnp.float32))
    right_u = uvR_best[:, 0] + shift * scale_best
    right_u = jnp.clip(right_u, 0.0, float(image_width - 1))
    disparity = featL.uv[:, 0] - right_u
    # fall back to the unrefined coordinate when refinement crossed zero disparity
    fallback = disparity <= 0.0
    right_u = jnp.where(fallback, uvR_best[:, 0], right_u)
    disparity = featL.uv[:, 0] - right_u
    # sub-pixel disparities below ~0.5 px give unusably noisy depth
    ok = ok & (disparity > 0.5)

    depth = jnp.where(ok, bf / jnp.where(disparity > 0, disparity, 1.0), -1.0)
    right_u = jnp.where(ok, right_u, -1.0)
    return right_u, depth
