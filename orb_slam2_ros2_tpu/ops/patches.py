"""Batched keypoint-patch extraction from the row-stacked pyramid canvas.

Every keypoint gets one ``48 × 64`` window centred at (22, 22).  The window
is wider than downstream sampling needs (the BRIEF template reach is <19 px
from the centre, plus a 3-px blur apron); the extra rows and columns hold
real neighbouring canvas pixels.  One window per keypoint serves
orientation, blurring, BRIEF sampling and stereo SAD refinement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PATCH_ROWS = 48
PATCH_COLS = 64
CENTER = 22          # patch centre offset (both axes)

# Clamp bounds: a window origin is clamped as if the window were 56 × 256.
# Changing them moves the windows of keypoints near the canvas edge, and
# with them those keypoints' descriptors.
WIN_ROWS = PATCH_ROWS + 8
WIN_COLS = PATCH_COLS + 192


def extract_patches(canvas: jnp.ndarray, centers_yx: jnp.ndarray) -> jnp.ndarray:
    """[H, W] canvas + i32[N, 2] (y, x) centres → f32[N, 48, 64] patches.

    One vmapped ``dynamic_slice``, which XLA lowers to a single gather."""
    h, w = canvas.shape

    def one(c):
        y = jnp.clip(c[0] - CENTER, 0, h - WIN_ROWS)
        x = jnp.clip(c[1] - CENTER, 0, w - WIN_COLS)
        return jax.lax.dynamic_slice(canvas, (y, x), (PATCH_ROWS, PATCH_COLS))

    return jax.vmap(one)(centers_yx).astype(jnp.float32)
