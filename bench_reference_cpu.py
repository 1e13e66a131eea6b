#!/usr/bin/env python
"""Measured support for the 25 fps reference baseline (BASELINE.md).

The reference itself cannot be built here (needs rclcpp/g2o/DBoW3/Pangolin,
none installed, installs forbidden), so this measures the dominant per-frame
cost of its tracking path with the same OpenCV ORB code family the
reference's extractor derives from, at the bench's exact workload: dual
KITTI-size extraction (2000 features, 8 levels, ×1.2, FAST 20) plus the two
hamming match passes (stereo + motion model).  The real reference adds g2o
pose optimization, projection searches and keyframe work on top, and
overlaps L/R extraction on two threads (Frame.cc:100-105).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import cv2

import jax

jax.config.update("jax_platforms", "cpu")

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset


def main():
    cfg = SLAMConfig()
    ds = SyntheticStereoDataset(cfg.camera, n_frames=12, speed=0.8)
    frames = [
        (np.asarray(ds.frame(i)[0]).astype(np.uint8),
         np.asarray(ds.frame(i)[1]).astype(np.uint8))
        for i in range(10)
    ]

    orb = cv2.ORB_create(nfeatures=2000, scaleFactor=1.2, nlevels=8, fastThreshold=20)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING)
    orb.detectAndCompute(frames[0][0], None)  # warmup

    t0 = time.perf_counter()
    prev = None
    for l, r in frames:
        _, dl = orb.detectAndCompute(l, None)
        _, dr = orb.detectAndCompute(r, None)
        bf.match(dl, dr)
        if prev is not None:
            bf.match(dl, prev)
        prev = dl
    dt = (time.perf_counter() - t0) / len(frames)
    print(json.dumps({
        "metric": "reference_equivalent_cpu_ms_per_frame",
        "value": round(dt * 1000.0, 1),
        "fps_serial_pair": round(1.0 / dt, 1),
        "fps_two_thread_extraction_estimate": round(1.0 / (dt * 0.55), 1),
        "opencv": cv2.__version__,
        "threads": cv2.getNumThreads(),
    }))


if __name__ == "__main__":
    main()
