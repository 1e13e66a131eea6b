#!/usr/bin/env python
"""Micro-profile of the keyframe-path sub-programs on the live backend.

Builds a live map with a short full-SLAM run, then times each sub-program of
the keyframe path in isolation (insert / MP-cull / triangulate / forward fuse
/ backward fuse / snapshot / local BA / KF-cull / loop add+detect).  Each
timing is best-of-3 with a device sync, so numbers INCLUDE one
dispatch-and-fetch floor — subtract the reported floor for device time.

Usage: python profile_kf.py [n_warm_frames]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam2_ros2_tpu.utils import setup_compile_cache  # noqa: E402

setup_compile_cache()

from functools import partial

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM

WARM = int(sys.argv[1]) if len(sys.argv) > 1 else 30


def bench(name, fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"  {name:22s} {best * 1000:8.2f} ms")
    return out


def main():
    cfg = SLAMConfig()
    ds = SyntheticStereoDataset(cfg.camera, n_frames=WARM + 2, speed=0.8)
    frames = [ds.frame(i)[:2] for i in range(WARM)]
    slam = SLAM(cfg)
    for i in range(WARM):
        slam.track(*frames[i])
    slam.flush()
    print(f"map: {slam.n_keyframes} kfs, {slam.n_mappoints} mps")

    # dispatch-and-fetch floor
    f = jax.jit(lambda a: a + 1)
    x = jnp.zeros((4,), jnp.float32)
    np.asarray(f(x))
    t0 = time.perf_counter()
    for _ in range(5):
        np.asarray(f(x))
    floor = (time.perf_counter() - t0) / 5
    print(f"sync floor {floor * 1000:.2f} ms (included in every number below)")

    c, o, t, b, mp = cfg.camera, cfg.orb, cfg.tracking, cfg.ba, cfg.mapping
    cam = slam.cam
    state = slam.map
    cur = slam.last
    kf_id = jnp.asarray(slam.ref_kf, jnp.int32)

    # ---- full fused programs (re-jitted WITHOUT donation so repeated
    # benchmark calls can reuse the same inputs) ----
    frame_nd = jax.jit(slam._frame_fn)
    bench("frame (full)", frame_nd, cam, frames[-1][0], frames[-1][1],
          slam.last, slam.velocity, slam.local, state, kf_id)
    front_nd = jax.jit(slam._map_front.__wrapped__)
    bench("map_front (full)", front_nd, state, cur.frame, cur.Tcw,
          cur.mp_ids, jnp.asarray(999, jnp.int32), cam)
    tail_nd = jax.jit(slam._map_tail.__wrapped__)
    bench("map_tail (full)", tail_nd, state, kf_id, cam)

    # ---- map_front pieces ----
    from orb_slam2_ros2_tpu.mapstate.map_state import insert_keyframe
    from orb_slam2_ros2_tpu.mapstate.mapping import (
        cull_keyframes, cull_mappoints, fuse_into_keyframe,
        fuse_keyframe_into_neighbors, triangulate_new_points,
    )
    from orb_slam2_ros2_tpu.mapstate.local_map import (
        local_map_snapshot, local_map_snapshot_frame,
    )
    from orb_slam2_ros2_tpu.solvers.local_ba import local_ba

    ins = jax.jit(partial(
        insert_keyframe, depth_threshold=c.baseline * t.th_depth,
        scale_factor=o.scale_factor, n_levels=o.n_levels,
        min_covis_weight=mp.min_covis_weight))
    st2, new_kf = bench("  insert_keyframe", ins,
                        state, cur.frame, cur.Tcw,
                        cur.mp_ids, jnp.asarray(999, jnp.int32), cam)

    cull_mp = jax.jit(partial(cull_mappoints, cull_score=mp.mp_cull_score))
    bench("  cull_mappoints", cull_mp, st2, new_kf)

    tri = jax.jit(partial(
        triangulate_new_points, n_neighbors=mp.n_triangulate_kfs,
        scale_factor=o.scale_factor, n_levels=o.n_levels, baseline=c.baseline,
        rank_gate=mp.triangulation_rank_gate, chi2_mono=b.chi2_mono,
        chi2_stereo=b.chi2_stereo))
    st3 = bench("  triangulate", tri, st2, new_kf, cam)

    fwd = jax.jit(partial(
        fuse_into_keyframe, width=c.width, height=c.height,
        scale_factor=o.scale_factor, n_levels=o.n_levels))
    st4 = bench("  fuse fwd", fwd, st3, new_kf, cam)

    bwd = jax.jit(partial(
        fuse_keyframe_into_neighbors, width=c.width, height=c.height,
        scale_factor=o.scale_factor, n_levels=o.n_levels,
        n_neighbors=mp.backward_fuse_neighbors, allow_merge=mp.backward_fuse_merge))
    st5 = bench("  fuse bwd", bwd, st4, new_kf, cam)

    snap = jax.jit(partial(local_map_snapshot, max_kfs=t.max_local_keyframes,
                           max_mps=t.max_local_mappoints))
    bench("  snapshot(kf)", snap, st5, new_kf)
    bench("  snapshot(frame)", slam._snapshot_frame, st5, cur.mp_ids)

    # ---- map_tail pieces ----
    ba = jax.jit(partial(
        local_ba, max_free=b.max_local_ba_kfs, max_fixed=b.max_local_ba_fixed,
        max_points=b.local_ba_points, chi2_mono=b.chi2_mono,
        chi2_stereo=b.chi2_stereo, lam=b.lm_lambda_init,
        scale_factor=o.scale_factor, phase_iters=tuple(b.local_ba_phase_iters)))
    bench("  local_ba", ba, st5, new_kf, cam)

    cull_kf = jax.jit(partial(cull_keyframes, redundancy=mp.kf_cull_ratio))
    bench("  cull_keyframes", cull_kf, st5, new_kf)

    # ---- loop path ----
    if slam.loop_closer is not None:
        lc = slam.loop_closer
        bench("  loop add+detect", lambda: lc._add_detect(lc.db, state, kf_id)
              if hasattr(lc, "_add_detect") else lc.detect(state, int(kf_id)))

    # ---- GBA chunk ----
    from orb_slam2_ros2_tpu.solvers.global_ba import (
        commit_global_ba, start_global_ba, step_global_ba)

    pend = start_global_ba(state, o.scale_factor)
    bench("  gba chunk (1 GN)", lambda: step_global_ba(
        pend, cam, n_iters=1, pcg_iters=b.pcg_iters,
        chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo).Tcw)
    bench("  gba commit", lambda: commit_global_ba(state, pend).kf_Tcw)


if __name__ == "__main__":
    main()
