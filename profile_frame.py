#!/usr/bin/env python
"""Stage-level breakdown of the PRODUCTION per-frame program (r3 VERDICT
weak#1: "nobody has published a stage-level breakdown of the 13.8 ms").

Builds a real map with full SLAM (same as bench.py), then scans cumulative
truncations of ``slam_track_step`` (static ``stop_after``) over the return
pass; deltas between variants are dispatch-free per-stage costs:

  frontend  = pyramid + FAST + BRIEF + stereo SAD
  match1    = + motion-model hamming/area/mutual (incl. r->2r retry branch)
  opt1      = + stage-1 pose LM (rounds//2 x iters)
  match2    = + local-map projection search ([8192,2048] hamming)
  vis       = + standalone visibility pass
  opt2      = + stage-3 pose LM (rounds x iters)
  full      = + counters/stats tail of slam_track_step
  frame     = + bump_tracking_counters + best_ref + nRefMatches (_frame_program)
  frame+snap= + per-frame local_map_snapshot_frame (the bench body)
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
from orb_slam2_ros2_tpu.geometry.camera import CameraParams
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset

T0 = time.time()
def log(msg):
    print(f"[{time.time()-T0:6.1f}s] {msg}", flush=True)

T = 20
WARM = 44


def main():
    import dataclasses as _dc
    cfg = SLAMConfig()
    cfg = cfg.replace(tracking=_dc.replace(cfg.tracking, th_depth=60.0))
    cam = CameraParams.from_config(cfg.camera)
    ds = SyntheticStereoDataset(cfg.camera, n_frames=WARM, speed=0.8,
                                box_scale=2.5, sky=True)
    frames_l, frames_r = [], []
    for i in range(WARM):
        l, r, _ = ds.frame(i)
        frames_l.append(l); frames_r.append(r)
    jax.block_until_ready(frames_l[-1])
    log(f"rendered, device={jax.devices()[0]}")

    from orb_slam2_ros2_tpu.pipeline.system import SLAM, slam_track_step, STAT_KEYS
    slam = SLAM(cfg, enable_loop_closing=False)
    for i in range(WARM):
        slam.track(frames_l[i], frames_r[i])
    slam.flush()
    log(f"map built ({slam.n_keyframes} kfs, {slam.n_mappoints} mps)")

    rev = list(range(WARM - 2, WARM - 2 - T, -1))
    stack_l = jnp.stack([frames_l[i] for i in rev])
    stack_r = jnp.stack([frames_r[i] for i in rev])

    o, c, m, t, b = cfg.orb, cfg.camera, cfg.matcher, cfg.tracking, cfg.ba
    track_common = dict(
        radius=t.motion_search_radius, proj_th=3.0,
        scale_factor=o.scale_factor, n_levels=o.n_levels,
        baseline=c.baseline, width=c.width, height=c.height,
        max_dist=m.min_threshold, ratio_track=m.nn_ratio_track,
        chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
        depth_threshold=c.baseline * t.th_depth,
        min_motion_matches=t.min_motion_matches,
        pose_rounds=b.pose_rounds, pose_iters=b.pose_iters_per_round,
    )
    from orb_slam2_ros2_tpu.features.extractor import make_stereo_frontend
    fe = make_stereo_frontend(cfg)
    fe_inner = fe.__wrapped__ if hasattr(fe, "__wrapped__") else fe

    last, vel, local, mapstate = slam.last, slam.velocity, slam.local, slam.map
    ref_kf = jnp.asarray(slam.ref_kf, jnp.int32)

    def scan_time(body, name, n_rep=3):
        @jax.jit
        def run(sl, sr):
            def f(carry, x):
                out = body(x[0], x[1])
                red = jax.tree_util.tree_reduce(
                    lambda a, bb: a + jnp.sum(bb.astype(jnp.float32)), out,
                    jnp.float32(0))
                return carry + red, ()
            tot, _ = jax.lax.scan(f, jnp.float32(0), (sl, sr))
            return tot
        np.asarray(run(stack_l, stack_r))
        best = 1e9
        for _ in range(n_rep):
            t0 = time.perf_counter()
            np.asarray(run(stack_l, stack_r))
            best = min(best, time.perf_counter() - t0)
        log(f"{name:>14}: {best/T*1000:7.3f} ms/frame")
        return best / T * 1000

    results = {}
    results["frontend"] = scan_time(lambda il, ir: fe_inner(il, ir, cam), "frontend")
    for stage in ("match1", "opt1", "match2", "vis", "opt2", "full"):
        def body(il, ir, _stage=stage):
            cur = fe_inner(il, ir, cam)
            return slam_track_step(
                cam, cur, last, vel, local, mapstate.mp_pos, mapstate.mp_valid,
                stop_after=_stage, **track_common)
        results[stage] = scan_time(body, stage)

    # full _frame_program (stats tail on top of slam_track_step)
    step_fn = slam._frame_fn
    def frame_body(il, ir):
        st, v, hv, ms, lm = step_fn(cam, il, ir, last, vel, local, mapstate, ref_kf)
        return hv
    results["frame"] = scan_time(frame_body, "frame")

    # the snapshot refresh now rides the frame program itself (r5) — keep
    # the label for breakdown continuity; the body is identical plus the
    # snapshot output being materialized
    def frame_snap_body(il, ir):
        st, v, hv, ms, lm = step_fn(cam, il, ir, last, vel, local, mapstate, ref_kf)
        return hv, lm.pos
    results["frame+snap"] = scan_time(frame_snap_body, "frame+snap")

    log("---- deltas ----")
    keys = list(results)
    prev = 0.0
    for k in keys:
        log(f"{k:>14}: +{results[k]-prev:7.3f} ms  (cum {results[k]:7.3f})")
        prev = results[k]


if __name__ == "__main__":
    main()
