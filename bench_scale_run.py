#!/usr/bin/env python
"""In-system scale proof (r3 VERDICT next#6): ONE long live run that
exercises, together, everything tested only in isolation before —

- ≥500 live keyframes built by full SLAM (tracking + mapping + loop closing),
- ≥2 auto-grow doublings of both stores (starts at K=160 / M=32768),
- the PCG essential-graph solver selected IN-SYSTEM (kf capacity > 256
  after the first doubling → pose_graph dispatches matrix-free PCG),
- loop closures at scale (multi-lap world),
- an fps-vs-K curve + map-store memory over the run.

Output: one JSON line + a markdown table fragment on stderr.
The reference runs KITTI-00's ~1400-KF maps with no ceilings (Map.cc);
this proves the padded-SoA design scales the same way live.
"""
import dataclasses as dc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam2_ros2_tpu.utils import setup_compile_cache  # noqa: E402

setup_compile_cache()

from orb_slam2_ros2_tpu.config import MapConfig, SLAMConfig
from orb_slam2_ros2_tpu.io.synthetic import (
    SyntheticStereoDataset,
    multi_lap_circle_trajectory,
)
from orb_slam2_ros2_tpu.pipeline.system import SLAM

T0 = time.time()
def log(m):
    print(f"[scale {time.time()-T0:7.1f}s] {m}", file=sys.stderr, flush=True)


def map_bytes(state) -> int:
    return int(sum(np.prod(a.shape) * a.dtype.itemsize
                   for a in jax.tree_util.tree_leaves(state)))


def main():
    n_frames = int(os.environ.get("SCALE_FRAMES", 3200))
    lap = int(os.environ.get("SCALE_LAP", 800))
    cfg = SLAMConfig()
    cfg = cfg.replace(
        # eager keyframing (thRefRatio -> inf makes c2 vacuous, so the
        # c1b idle-mapper term inserts every ~3rd frame): the point of this
        # run is map-LENGTH scaling, so drive insertion hard — at the stock
        # gates the fixed tracker holds ratio > thRefRatio nearly everywhere
        # on this world and the run never leaves ~30 KFs
        # ThDepth=160 (close < 80 m): this big world's content sits at
        # 30-80 m — the reference's own per-dataset ThDepth tuning (35
        # KITTI / 40 TUM); at 60 the close-seed gate starves the map and
        # tracking dies by frame ~92
        tracking=dc.replace(cfg.tracking, th_depth=160.0, ref_ratio_th=1e9,
                            min_frames=2, max_frames=5),
        # start SMALL so the run crosses ≥2 doublings and the in-system
        # PCG essential-graph threshold (DENSE_MAX_K=256) on the way up
        map=MapConfig(max_keyframes=160, max_mappoints=1 << 15,
                      max_obs_per_mp=24, auto_grow=True),
    )
    ds = SyntheticStereoDataset(cfg.camera, n_frames=4, speed=0.8,
                                box_scale=2.5, sky=True)
    # big multi-lap circle: long laps → many keyframes per lap, revisits
    # → loop closures at scale
    ds.poses_wc = multi_lap_circle_trajectory(
        n_frames, frames_per_lap=lap, radius=30.0, z_center=40.0)
    ds.n_frames = n_frames

    slam = SLAM(cfg)
    grow_events, curve = [], []
    cap0 = (slam.map.kf_capacity, slam.map.mp_capacity)
    window_t = time.perf_counter()
    window_n = 0
    lost = 0
    for i in range(n_frames):
        imgL, imgR, _ = ds.frame(i)
        cap_before = (slam.map.kf_capacity, slam.map.mp_capacity)
        pose, stats = slam.track(imgL, imgR)
        if pose is None:
            lost += 1
        cap_after = (slam.map.kf_capacity, slam.map.mp_capacity)
        if cap_after != cap_before:
            grow_events.append(dict(frame=i, frm=cap_before, to=cap_after))
            log(f"auto-grow at frame {i}: {cap_before} -> {cap_after}")
        window_n += 1
        if window_n == 100:
            dt = time.perf_counter() - window_t
            curve.append(dict(
                frame=i + 1, n_kf=slam._n_kf,
                live_kf=int(np.asarray(jnp.sum(slam.map.kf_valid.astype(jnp.int32)))),
                fps=round(100.0 / dt, 2),
                map_mb=round(map_bytes(slam.map) / 1e6, 1),
                loops=getattr(slam, "loops_closed", 0),
            ))
            log(f"frame {i+1}: {curve[-1]}")
            window_t = time.perf_counter()
            window_n = 0
    slam.flush()

    live = int(np.asarray(jnp.sum(slam.map.kf_valid.astype(jnp.int32))))
    result = dict(
        frames=n_frames, lost=lost,
        keyframes_inserted=slam._n_kf, keyframes_live=live,
        loops_closed=getattr(slam, "loops_closed", 0),
        grow_events=len(grow_events),
        start_capacity=list(cap0),
        final_capacity=[slam.map.kf_capacity, slam.map.mp_capacity],
        final_map_mb=round(map_bytes(slam.map) / 1e6, 1),
        pcg_essential_in_system=slam.map.kf_capacity > 256,
        fps_curve=curve,
    )
    print(json.dumps(result), flush=True)
    log("| frames | live KFs | fps (last window) | map MB | loops |")
    if curve:
        c = curve[-1]
        log(f"| {n_frames} | {live} | {c['fps']} | {c['map_mb']} | "
            f"{result['loops_closed']} |")


if __name__ == "__main__":
    main()
