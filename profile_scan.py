#!/usr/bin/env python
"""Scan-amortized per-stage cost model of the frame loop on the device.

Each variant scans over T frames doing progressively more of the pipeline;
deltas between variants give dispatch-overhead-free stage costs.
"""
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
    o, c, m = cfg.orb, cfg.camera, cfg.matcher
    cam = CameraParams.from_config(cfg.camera)
    ds = SyntheticStereoDataset(cfg.camera, n_frames=T + 2, speed=0.8)
    stack_l = jnp.stack([jnp.asarray(ds.frame(i)[0]) for i in range(T)])
    stack_r = jnp.stack([jnp.asarray(ds.frame(i)[1]) for i in range(T)])
    np.asarray(stack_l)
    log(f"device={jax.devices()[0]}")

    caps = tuple(ex.level_capacities(o.max_keypoints, o.n_levels, o.scale_factor))

    # A: pyramid (both images batched)
    def a(x):
        return build_pyramid(jnp.stack([x[0], x[1]]), o.n_levels, o.scale_factor)
    scan_time(a, (stack_l, stack_r), "A pyramid (batched x2)")

    # B: + fast + nms
    def b(x):
        lv = build_pyramid(jnp.stack([x[0], x[1]]), o.n_levels, o.scale_factor)
        return [fast.nms3(fast.fast_score(l, float(o.min_th_fast))) for l in lv]
    scan_time(b, (stack_l, stack_r), "B +fast+nms")

    # C: full batched extraction (features + patches)
    exf = partial(ex.extract_features_batch, cam=cam, h=c.height, w=c.width,
                  n_levels=o.n_levels, scale_factor=o.scale_factor, caps=caps,
                  border=o.edge_border, min_th=float(o.min_th_fast),
                  ini_th=float(o.ini_th_fast), cell=o.cell_size,
                  undistort=c.has_distortion)
    def cfun(x):
        return exf(jnp.stack([x[0], x[1]]))
    scan_time(cfun, (stack_l, stack_r), "C full extract (batched x2)")

    # D: full frontend (extract + stereo match)
    frontend_fn = ex.make_stereo_frontend(cfg)
    fr_inner = frontend_fn.__wrapped__ if hasattr(frontend_fn, "__wrapped__") else frontend_fn
    def dfun(x):
        return fr_inner(x[0], x[1], cam)
    scan_time(dfun, (stack_l, stack_r), "D full frontend")

    # E: full odometry step
    from orb_slam2_ros2_tpu.pipeline.tracking import (
        TrackedFrame, make_fused_odometry_step, unproject_frame)
    frontend = jax.jit(frontend_fn)
    sf0 = frontend(stack_l[0], stack_r[0], cam)
    Tcw0 = jnp.eye(4, dtype=jnp.float32)
    pw, has = jax.jit(unproject_frame)(cam, sf0, Tcw0)
    state0 = TrackedFrame(frame=sf0, Tcw=Tcw0, pw=pw, has_pw=has)
    vel0 = jnp.eye(4, dtype=jnp.float32)
    step = make_fused_odometry_step(cfg)
    step_fn = step.__wrapped__ if hasattr(step, "__wrapped__") else step

    @jax.jit
    def run_seq(sl, sr, st, v):
        def bdy(carry, ims):
            st, v = carry
            st, v, Tcw, nm, ni = step_fn(cam, ims[0], ims[1], st, v)
            return (st, v), Tcw
        (_, _), tcws = jax.lax.scan(bdy, (st, v), (sl, sr))
        return tcws
    np.asarray(run_seq(stack_l, stack_r, state0, vel0))
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(run_seq(stack_l, stack_r, state0, vel0))
        best = min(best, time.perf_counter() - t0)
    log(f"E full odometry step: {best/T*1000:.3f} ms/frame")

if __name__ == "__main__":
    main()
