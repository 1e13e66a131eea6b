#!/usr/bin/env python
"""Full-SLAM throughput: tracking + keyframe insertion + mapping
(triangulate/fuse/cull + deferred local BA) + loop closing, KITTI-size.

``bench.py`` calls ``main()`` in its own process after its tracking scan;
``python bench_full.py`` runs it alone.  The full pipeline's cold compile is
minutes, so a warm-up pass runs every program before the timed window.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

from orb_slam2_ros2_tpu.utils import setup_compile_cache

setup_compile_cache()

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM

N_FRAMES = 80
T0 = time.time()


def log(msg):
    print(f"[bench_full {time.time() - T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def main():
    import dataclasses as _dc

    # per-dataset tuning, exactly like the reference's per-config ThDepth
    # (35 KITTI / 40 TUM): the synthetic box's close-point band at ThDepth=35
    # is a thin floor strip whose features churn every frame, which reads as
    # permanent close-point starvation (needClose) and keyframe-spams;
    # ThDepth=60 puts the 10-35 m structure in the close band
    cfg = SLAMConfig()
    # pipelined=True is the deployment mode: the per-frame device→host fetch
    # and host decision logic overlap the next frame's device execution
    # (tracking.pipelined docs)
    cfg = cfg.replace(tracking=_dc.replace(cfg.tracking, th_depth=60.0,
                                           pipelined=True))
    # alternate the BA / KF-cull halves of the mapping tail (they dominate
    # its cost; the reference trades the same way under load via
    # setAbortBA + idle-queue culling, LocalMapping.cc:96-109)
    cfg = cfg.replace(mapping=_dc.replace(cfg.mapping, ba_stride=2,
                                          kf_cull_stride=2))
    # local-BA window: 8/16/3072 instead of the 12/24/4096 default, measured
    # with equal-or-better final ATE (0.053 vs 0.060 m on the 95 m path) —
    # the ATE gate below guards the trade.  Override with
    # BENCH_BA_WINDOW="free,fixed,points".
    import os as _os
    f, x, p = (int(v) for v in
               _os.environ.get("BENCH_BA_WINDOW", "8,16,3072").split(","))
    cfg = cfg.replace(ba=_dc.replace(cfg.ba, max_local_ba_kfs=f,
                                     max_local_ba_fixed=x,
                                     local_ba_points=p))
    # box_scale=2.5 gives the world KITTI-00 depth statistics (facades
    # 10-30 m); the default close-quarters box (walls ≤ 8 m) drives the
    # reference's close-point KF term permanently and measures a harder-
    # than-KITTI keyframe cadence
    ds = SyntheticStereoDataset(cfg.camera, n_frames=N_FRAMES + 42, speed=0.8,
                                box_scale=2.5, sky=True)
    raw = [ds.frame(i) for i in range(N_FRAMES + 40)]
    frames = [(l, r) for l, r, _ in raw]
    gt_twc = {i: np.asarray(g) for i, (_, _, g) in enumerate(raw)}
    jax.block_until_ready(frames[-1][0])
    log("rendered")

    slam = SLAM(cfg)
    # warmup: compile every program variant — init, track, KF insert, mapping
    # front, deferred BA tail, BA-abort path, loop-detect (first full run at
    # kf_id ≥ 10).  Programs compile lazily on first use, so the warmup must
    # RUN every path or their multi-second compiles pollute the measurement.
    WARM = 40
    for i in range(WARM):
        slam.track(*frames[i])
    slam.flush()
    log(f"warm ({slam.n_keyframes} kfs)")

    t0 = time.perf_counter()
    kf_flags, inliers = [], []
    n_ft0 = len(slam.frame_times_ms)
    for i in range(WARM, WARM + N_FRAMES):
        n_kf_before = slam._n_kf
        Tcw, stats = slam.track(*frames[i])
        kf_flags.append(slam._n_kf > n_kf_before)
        # pipelined track() returns the PREVIOUS frame's stats; the first
        # call's fill marker has no n_tracked — skip it rather than record a
        # fabricated 0 in the median
        if "n_tracked" in stats:
            inliers.append(stats["n_tracked"])
    slam.flush()
    jax.block_until_ready(slam.map.kf_Tcw)
    dt = time.perf_counter() - t0
    # tracked frames counted from the resolve-time trajectory records (the
    # per-call return is one frame late under pipelining)
    tracked = sum(1 for f, _ in slam.trajectory if WARM <= f < WARM + N_FRAMES)

    fps = N_FRAMES / dt
    ms = 1000.0 * dt / N_FRAMES
    # per-frame wall-time split: keyframe frames (insert + mapping front) vs
    # pure tracking frames (which may still absorb a deferred BA tail)
    ft = np.asarray(slam.frame_times_ms[n_ft0:n_ft0 + N_FRAMES])
    kf_mask = np.asarray(kf_flags)

    def pct(a, q):
        return round(float(np.percentile(a, q)), 1) if len(a) else None

    # ---- ATE-at-speed gate (r4 VERDICT next#3): the throughput number is
    # only valid if the trajectory it produced stays in the accuracy class.
    # Live ATE < 5% of path length; final (relative-pose × optimized-KF
    # export) < 3% — the same bounds CI enforces (tests/test_adversarial.py).
    from orb_slam2_ros2_tpu.io.trajectory import ate_rmse

    def _ate(pairs):
        est = [np.linalg.inv(T) for f, T in pairs if f in gt_twc]
        gt = [gt_twc[f] for f, _T in pairs if f in gt_twc]
        return ate_rmse(est, gt) if len(est) >= 3 else float("nan")

    ate_live = _ate(slam.trajectory)
    ate_final = _ate(slam.final_trajectory())
    fids = sorted(f for f, _ in slam.trajectory if f in gt_twc)
    path_len = float(sum(
        np.linalg.norm(gt_twc[b][:3, 3] - gt_twc[a][:3, 3])
        for a, b in zip(fids, fids[1:])
    ))
    ate_gate_pass = bool(
        path_len > 0 and ate_live < 0.05 * path_len
        and ate_final < 0.03 * path_len
    )

    out = {
        "metric": "kitti_size_full_slam_fps",
        "value": round(fps, 2),
        "unit": "frames/s",
        "detail": {
            "ate_live_m": round(float(ate_live), 3),
            "ate_final_m": round(float(ate_final), 3),
            "path_len_m": round(path_len, 1),
            "ate_gate_pass": ate_gate_pass,
            "ms_per_frame": round(ms, 2),
            "tracked": tracked,
            "keyframes_inserted": int(kf_mask.sum()),
            "kf_frame_ms_p50": pct(ft[kf_mask], 50),
            "kf_frame_ms_p99": pct(ft[kf_mask], 99),
            "track_frame_ms_p50": pct(ft[~kf_mask], 50),
            "track_frame_ms_p99": pct(ft[~kf_mask], 99),
            "median_inliers": int(np.median(inliers)),
            "keyframes": slam.n_keyframes,
            "mappoints": slam.n_mappoints,
            "device": str(jax.devices()[0]),
            "n_frames": N_FRAMES,
        },
    }
    print(json.dumps(out))
    if not ate_gate_pass:
        log(f"ATE GATE FAILED: live {ate_live:.2f} m / final {ate_final:.2f} m "
            f"on a {path_len:.1f} m path")
        sys.exit(1)


if __name__ == "__main__":
    main()
