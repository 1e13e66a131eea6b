#!/usr/bin/env python
"""ORBvoc-scale (10⁶-word) vocabulary on the LIVE keyframe path, on device
(r4 VERDICT next#6): run a full-SLAM loop-closure sequence with a k=10 L=6
DBoW-format vocabulary and measure what the 10⁶-word tree costs per keyframe
— the fused add+detect program (BoW transform + sparse row insert + loop
query) and the relocalization query — against the same costs at the shipped
10⁵-word default.  The reference loads the real ORBvoc at startup
(System.cc:92-95) and pays its transform on every KF and frame.

Prints one JSON line; the 10⁶ vocabulary is the test-generated random-
centroid one (tests/test_orbvoc_scale.py) — descent-consistent, so the
timing is representative even though its recall is not ORBvoc's.
"""

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

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM

T0 = time.time()
N_FRAMES = 84


def log(msg):
    print(f"[orbvoc {time.time() - T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def bench_prog(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best * 1000.0


def run_one(vocab_path: str, label: str, frames, cfg):
    import dataclasses as _dc

    cfg = cfg.replace(bow=_dc.replace(cfg.bow, vocab_path=vocab_path))
    t0 = time.perf_counter()
    slam = SLAM(cfg)
    for il, ir in frames:
        slam.track(il, ir)
    slam.flush()
    lc = slam.loop_closer
    n_words = lc.vocab.n_words if lc is not None else 0
    out = {
        "label": label, "n_words": int(n_words),
        "keyframes": int(slam.n_keyframes),
        "loops_closed": int(getattr(slam, "loops_closed", 0)),
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    if lc is not None:
        # the fused per-KF program: transform + DB row insert + loop query.
        # Time WITHOUT donation side effects by timing on a copy.
        kf_id = jnp.asarray(int(slam.ref_kf))
        db = lc.db

        def add_detect():
            db2, out_dev = lc._add_detect_prog(
                jax.tree.map(jnp.copy, db), slam.map, kf_id)
            return out_dev

        out["kf_add_detect_ms"] = round(bench_prog(add_detect), 2)
        # relocalization DB query (transform + sparse BoW + reloc retrieval)
        if slam._reloc_query_jit is None:
            from orb_slam2_ros2_tpu.bow.keyframe_db import (
                find_reloc_candidates, sparse_bow)
            from orb_slam2_ros2_tpu.bow.vocabulary import transform

            vocab = lc.vocab
            max_q = cfg.bow.max_words_per_query

            def _query(db_, state, desc, valid):
                words = transform(vocab, desc, valid)
                qvec = sparse_bow(vocab, words, max_q)
                ids, _ = find_reloc_candidates(db_, state, qvec,
                                               n_words=vocab.n_words)
                return ids

            slam._reloc_query_jit = jax.jit(_query)
        feats = slam.last.frame.feats
        out["reloc_query_ms"] = round(bench_prog(
            slam._reloc_query_jit, lc.db, slam.map, feats.desc, feats.valid), 2)
    return out


def main():
    import dataclasses as _dc

    cfg = SLAMConfig()
    cfg = cfg.replace(tracking=_dc.replace(cfg.tracking, th_depth=60.0))
    ds = SyntheticStereoDataset(cfg.camera, n_frames=N_FRAMES + 2, speed=0.8,
                                box_scale=2.5, sky=True, circle=True)
    frames = [ds.frame(i)[:2] for i in range(N_FRAMES)]
    jax.block_until_ready(frames[-1][0])
    log("rendered")

    # 10⁶-word DBoW-text vocabulary (test generator; cached across runs)
    voc_path = "/tmp/orbvoc_1e6.txt"
    if not os.path.exists(voc_path):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        from test_orbvoc_scale import _write_orbvoc_scale

        t0 = time.perf_counter()
        _write_orbvoc_scale(voc_path, np.random.default_rng(0))
        log(f"wrote 10^6-word vocab in {time.perf_counter() - t0:.0f}s")

    results = []
    results.append(run_one("", "default_1e5", frames, cfg))
    log(f"default done: {results[-1]}")
    results.append(run_one(voc_path, "orbvoc_1e6", frames, cfg))
    log(f"1e6 done: {results[-1]}")
    print(json.dumps({"orbvoc_live": results,
                      "device": str(jax.devices()[0])}))


if __name__ == "__main__":
    main()
