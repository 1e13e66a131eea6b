#!/usr/bin/env python
"""Per-stage wall-time breakdown of the full SLAM host loop on the live
backend (SLAM.profile=True adds a block_until_ready sync per stage, so the
numbers INCLUDE one host sync each — read deltas, not absolutes).

Usage: python profile_full.py [n_frames]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

from orb_slam2_ros2_tpu.utils import setup_compile_cache  # noqa: E402

setup_compile_cache()

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM

N = int(sys.argv[1]) if len(sys.argv) > 1 else 60
WARM = 40


def main():
    cfg = SLAMConfig()
    ds = SyntheticStereoDataset(cfg.camera, n_frames=N + WARM + 2, speed=0.8)
    frames = [ds.frame(i)[:2] for i in range(N + WARM)]
    jax.block_until_ready(frames[-1][0])

    slam = SLAM(cfg)
    for i in range(WARM):
        slam.track(*frames[i])
    slam.flush()
    print(f"warm: {slam.n_keyframes} kfs", file=sys.stderr)

    slam.profile = True
    slam.stage_times = {}
    slam.frame_times_ms = []
    t0 = time.perf_counter()
    for i in range(WARM, WARM + N):
        slam.track(*frames[i])
    slam.flush()
    dt = time.perf_counter() - t0

    print(f"\n{N} frames in {dt:.2f}s = {N/dt:.2f} fps ({1000*dt/N:.1f} ms/frame)")
    total_ms = 1000.0 * dt
    for name, ts in sorted(slam.stage_times.items()):
        arr = np.asarray(ts) * 1000.0
        print(
            f"  {name:12s} n={len(arr):3d}  mean={arr.mean():7.1f} ms  "
            f"median={np.median(arr):7.1f}  max={arr.max():7.1f}  "
            f"total={arr.sum():8.1f} ms ({100*arr.sum()/total_ms:4.1f}%)"
        )
    ft = np.asarray(slam.frame_times_ms)
    print(f"  frame_total  mean={ft.mean():.1f} median={np.median(ft):.1f} max={ft.max():.1f}")


if __name__ == "__main__":
    main()
