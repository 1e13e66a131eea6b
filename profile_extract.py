#!/usr/bin/env python
"""Sub-stage cost model of extraction-after-FAST (the C−B gap in
profile_scan): selection, canvas assembly, patch gather, moments, blur, BRIEF."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

from orb_slam2_ros2_tpu.utils import setup_compile_cache  # noqa: E402

setup_compile_cache()

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.features import extractor as ex
from orb_slam2_ros2_tpu.geometry.camera import CameraParams
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu.ops import brief, fast, stereo
from orb_slam2_ros2_tpu.ops.canvas import canvas_layout, padded_canvas_shape
from orb_slam2_ros2_tpu.ops.patches import extract_patches
from orb_slam2_ros2_tpu.ops.pyramid import build_pyramid

T0 = time.time()
def log(msg):
    print(f"[{time.time()-T0:6.1f}s] {msg}", flush=True)

T = 10

def scan_time(body, stacks, name, n_rep=3):
    @jax.jit
    def run(stacks):
        def f(carry, x):
            out = body(x)
            red = jax.tree_util.tree_reduce(
                lambda a, b: a + jnp.sum(b.astype(jnp.float32)), out, jnp.float32(0))
            return carry + red, ()
        tot, _ = jax.lax.scan(f, jnp.float32(0), stacks)
        return tot
    np.asarray(run(stacks))
    best = 1e9
    for _ in range(n_rep):
        t0 = time.perf_counter()
        np.asarray(run(stacks))
        best = min(best, time.perf_counter() - t0)
    log(f"{name}: {best/T*1000:.3f} ms/frame")
    return best

def main():
    cfg = SLAMConfig()
    o, c = cfg.orb, cfg.camera
    cam = CameraParams.from_config(cfg.camera)
    ds = SyntheticStereoDataset(cfg.camera, n_frames=T + 2, speed=0.8)
    stack_l = jnp.stack([jnp.asarray(ds.frame(i)[0]) for i in range(T)])
    stack_r = jnp.stack([jnp.asarray(ds.frame(i)[1]) for i in range(T)])
    np.asarray(stack_l)
    log(f"device={jax.devices()[0]}")

    caps = tuple(ex.level_capacities(o.max_keypoints, o.n_levels, o.scale_factor))
    row_off_np, _, _ = canvas_layout(c.height, c.width, o.n_levels, o.scale_factor)
    rows_p, cols_p = padded_canvas_shape(c.height, c.width, o.n_levels, o.scale_factor)
    row_off = jnp.asarray(row_off_np)
    B = 2

    def upto_select(x):
        levels = build_pyramid(jnp.stack([x[0], x[1]]), o.n_levels, o.scale_factor)
        select = jax.vmap(
            partial(fast.select_keypoints, border=o.edge_border, cell=o.cell_size,
                    topk_per_cell=4, strong_threshold=float(o.ini_th_fast)),
            in_axes=(0, None))
        outs = []
        for l in range(o.n_levels):
            score = fast.nms3(fast.fast_score(levels[l], float(o.min_th_fast)))
            outs.append(select(score, caps[l]))
        return outs
    scan_time(upto_select, (stack_l, stack_r), "S1 pyramid+fast+select")

    def upto_canvas(x):
        levels = build_pyramid(jnp.stack([x[0], x[1]]), o.n_levels, o.scale_factor)
        select = jax.vmap(
            partial(fast.select_keypoints, border=o.edge_border, cell=o.cell_size,
                    topk_per_cell=4, strong_threshold=float(o.ini_th_fast)),
            in_axes=(0, None))
        uts, octs = [], []
        for l in range(o.n_levels):
            score = fast.nms3(fast.fast_score(levels[l], float(o.min_th_fast)))
            uv_l, _, _ = select(score, caps[l])
            uts.append(uv_l * (o.scale_factor ** l))
            octs.append(jnp.full((B, caps[l]), l, jnp.int32))
        canvas = jnp.zeros((B * rows_p, cols_p), levels[0].dtype)
        for b in range(B):
            off = b * rows_p
            for l in range(o.n_levels):
                canvas = jax.lax.dynamic_update_slice(
                    canvas, levels[l][b], (off + int(row_off_np[l]), 0))
        return canvas, jnp.concatenate(uts, 1), jnp.concatenate(octs, 1)
    scan_time(upto_canvas, (stack_l, stack_r), "S2 +canvas")

    def upto_patches(x):
        canvas, uv_raw, octave = upto_canvas(x)
        centers = stereo.canvas_centers(uv_raw, octave, o.scale_factor, row_off)
        centers = centers + (jnp.arange(B, dtype=jnp.int32)[:, None, None]
                             * jnp.asarray([rows_p, 0], jnp.int32)[None, None, :])
        N = uv_raw.shape[1]
        return extract_patches(canvas, centers.reshape(B * N, 2))
    scan_time(upto_patches, (stack_l, stack_r), "S3 +patches")

    def upto_orient(x):
        p = upto_patches(x)
        return brief.orientations(p)
    scan_time(upto_orient, (stack_l, stack_r), "S4 +moments")

    def upto_desc(x):
        # describe() folds the pre-compare blur into its sampling matrix —
        # matches the production extractor (features/extractor.py)
        p = upto_patches(x)
        a = brief.orientations(p)
        return brief.describe(p, a)
    scan_time(upto_desc, (stack_l, stack_r), "S5 +describe (blur folded)")

if __name__ == "__main__":
    main()
