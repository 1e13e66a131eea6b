"""Keypoint-patch gather (ops.patches) against NumPy slicing."""

import jax.numpy as jnp
import numpy as np

from orb_slam2_ros2_tpu.ops.patches import CENTER, WIN_COLS, WIN_ROWS, extract_patches
from orb_slam2_ros2_tpu.ops.reference_np import patches_np


def test_patches_match_numpy_slicing():
    r = np.random.default_rng(0)
    canvas = r.uniform(0, 255, (256, 384)).astype(np.float32)
    ys = r.integers(CENTER, 256 - WIN_ROWS, 32)
    xs = r.integers(CENTER, 384 - WIN_COLS, 32)
    centers = np.stack([ys, xs], 1).astype(np.int32)
    got = np.asarray(extract_patches(jnp.asarray(canvas), jnp.asarray(centers)))
    np.testing.assert_array_equal(got, patches_np(canvas, centers))


def test_clamping_at_edges():
    r = np.random.default_rng(1)
    canvas = jnp.asarray(r.uniform(0, 255, (128, 256)).astype(np.float32)).astype(jnp.bfloat16)
    # centres near the corners: the window origin clamps against the
    # 56 × 256 bounds, exactly as the NumPy slicing reference does
    centers = np.array([[0, 0], [127, 255], [0, 255], [127, 0]] * 2, np.int32)
    got = np.asarray(extract_patches(canvas, jnp.asarray(centers)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, patches_np(np.asarray(canvas), centers))
