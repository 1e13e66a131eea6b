#!/usr/bin/env python
"""Where does the full-SLAM host loop's wall time go on the device?

Splits every `track()` call into three phases without adding device syncs:
  pre   — host Python up to the per-frame stats fetch (dispatch of the fused
          frame program + pytree flatten + image upload),
  fetch — the blocking `np.asarray(host_vec)` (transfer + any device work
          still draining ahead of the stats vector),
  post  — host Python after the fetch (KF decision, snapshot dispatch,
          mapping-front / deferred-tail / loop dispatches).
Prints per-frame-class (track / KF / tail) phase medians.  Companion to
bench_full.py (same world, same warmup).
"""
import json
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

T0 = time.time()


def log(msg):
    print(f"[profile_loop {time.time() - T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def main():
    import dataclasses as _dc

    N_FRAMES = 80
    cfg = SLAMConfig()
    cfg = cfg.replace(tracking=_dc.replace(cfg.tracking, th_depth=60.0))
    ds = SyntheticStereoDataset(cfg.camera, n_frames=N_FRAMES + 42, speed=0.8,
                                box_scale=2.5, sky=True)
    frames = [ds.frame(i)[:2] for i in range(N_FRAMES + 40)]
    jax.block_until_ready(frames[-1][0])
    log("rendered")

    slam = SLAM(cfg)
    WARM = 40
    for i in range(WARM):
        slam.track(*frames[i])
    slam.flush()
    log(f"warm ({slam.n_keyframes} kfs)")

    # timestamp the first jax-array np.asarray inside each track() call
    marks = {}
    real_asarray = np.asarray

    def patched(a, *args, **kw):
        if isinstance(a, jax.Array) and "t_fetch0" not in marks:
            marks["t_fetch0"] = time.perf_counter()
            r = real_asarray(a, *args, **kw)
            marks["t_fetch1"] = time.perf_counter()
            return r
        return real_asarray(a, *args, **kw)

    np.asarray = patched
    rows = []
    try:
        for i in range(WARM, WARM + N_FRAMES):
            marks.clear()
            n_kf_before = slam._n_kf
            pend_before = slam._pending_kf is not None
            t0 = time.perf_counter()
            slam.track(*frames[i])
            t1 = time.perf_counter()
            is_kf = slam._n_kf > n_kf_before
            rows.append(dict(
                cls="kf" if is_kf else ("tail" if pend_before else "track"),
                pre=(marks.get("t_fetch0", t1) - t0) * 1e3,
                fetch=(marks.get("t_fetch1", t1) - marks.get("t_fetch0", t1)) * 1e3,
                post=(t1 - marks.get("t_fetch1", t1)) * 1e3,
                total=(t1 - t0) * 1e3,
            ))
    finally:
        np.asarray = real_asarray
    slam.flush()

    out = {}
    for cls in ("track", "tail", "kf"):
        sel = [r for r in rows if r["cls"] == cls]
        if not sel:
            continue
        out[cls] = {k: round(float(np.median([r[k] for r in sel])), 1)
                    for k in ("pre", "fetch", "post", "total")}
        out[cls]["n"] = len(sel)
    out["all_mean_ms"] = round(float(np.mean([r["total"] for r in rows])), 1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
