#!/usr/bin/env python
"""Microbenchmarks: batched-vs-unbatched formulations of frontend stages."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax, jax.numpy as jnp, numpy as np
from functools import partial

from orb_slam2_ros2_tpu.utils import setup_compile_cache  # noqa: E402

setup_compile_cache()

from orb_slam2_ros2_tpu.ops import fast
from orb_slam2_ros2_tpu.ops.pyramid import build_pyramid, resize_bilinear_matmul, level_shapes

T0 = time.time()
def log(m): print(f"[{time.time()-T0:6.1f}s] {m}", flush=True)

T = 10
H, W = 376, 1241

def scan_time(body, stacks, name, n_rep=3):
    @jax.jit
    def run(stacks):
        def f(c, x):
            out = body(x)
            red = jax.tree_util.tree_reduce(
                lambda a, b: a + jnp.sum(b.astype(jnp.float32)), out, jnp.float32(0))
            return c + red, ()
        tot, _ = jax.lax.scan(f, jnp.float32(0), stacks)
        return tot
    np.asarray(run(stacks))
    best = 1e9
    for _ in range(n_rep):
        t0 = time.perf_counter()
        np.asarray(run(stacks))
        best = min(best, time.perf_counter() - t0)
    log(f"{name}: {best/T*1000:.3f} ms/frame")

def main():
    r = np.random.default_rng(0)
    stack = jnp.asarray(r.uniform(0, 255, (T, 2, H, W)).astype(np.float32))
    np.asarray(stack)
    log(f"device={jax.devices()[0]}")
    shapes = level_shapes(H, W, 8, 1.2)

    # --- FAST score+nms ---
    def f_batched(x):
        img = x.astype(jnp.bfloat16)
        return fast.nms3(fast.fast_score(img, 7.0))
    scan_time(f_batched, stack, "fast+nms batched [2,H,W]")

    def f_unbatched(x):
        img = x.astype(jnp.bfloat16)
        return [fast.nms3(fast.fast_score(img[0], 7.0)),
                fast.nms3(fast.fast_score(img[1], 7.0))]
    scan_time(f_unbatched, stack, "fast+nms 2x[H,W]")

    # --- pyramid ---
    def p_mm_batched(x):
        return build_pyramid(x, 8, 1.2)
    scan_time(p_mm_batched, stack, "pyramid matmul batched")

    def p_mm_single(x):
        return build_pyramid(x[0], 8, 1.2) + build_pyramid(x[1], 8, 1.2)
    scan_time(p_mm_single, stack, "pyramid matmul 2x single")

    def p_resize(x):
        out = []
        for b in range(2):
            lv = [x[b].astype(jnp.bfloat16)]
            for l in range(1, 8):
                lv.append(jax.image.resize(lv[-1], shapes[l], method="linear"))
            out += lv
        return out
    scan_time(p_resize, stack, "pyramid jax.image.resize 2x")

    # --- select_keypoints ---
    sel = partial(fast.select_keypoints, border=23, cell=32,
                  topk_per_cell=4, strong_threshold=20.0)
    def s_vmap(x):
        score = fast.nms3(fast.fast_score(x.astype(jnp.bfloat16), 7.0))
        return jax.vmap(lambda s: sel(s, 616))(score)
    scan_time(s_vmap, stack, "select vmapped [2,...]")

    def s_loop(x):
        outs = []
        for b in range(2):
            score = fast.nms3(fast.fast_score(x[b].astype(jnp.bfloat16), 7.0))
            outs.extend(sel(score, 616))
        return outs
    scan_time(s_loop, stack, "select 2x loop")

if __name__ == "__main__":
    main()
