#!/usr/bin/env python
"""Map-persistence format benchmark: npz vs protobuf vs txt save/load.

The reference's only compiled test is exactly this comparison
(/root/reference/src/ORB_SLAM2/test/TxtVsProto.cc:10-48; README.md:22 claims
protobuf is -78% time / -50% size vs txt).  Here all three of our formats are
timed on the same synthetic map, and the same sanity statistic is printed
(max keyframe translation norm, TxtVsProto.cc:16-27).

Runs on CPU — this is host-side I/O, no accelerator involved.
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def build_state(cfg, K=48, P=4000, N=512, seed=0):
    import jax.numpy as jnp

    from orb_slam2_ros2_tpu.mapstate.map_state import empty_map

    rng = np.random.default_rng(seed)
    st = empty_map(cfg)
    O = st.mp_obs_kf.shape[1]
    KC, MC = cfg.map.max_keyframes, cfg.map.max_mappoints

    kf_valid = np.zeros(KC, bool)
    kf_valid[:K] = True
    Tcw = np.tile(np.eye(4, dtype=np.float32), (KC, 1, 1))
    Tcw[:K, 0, 3] = 0.4 * np.arange(K)
    uv = np.zeros((KC, N, 2), np.float32)
    uv[:K] = rng.uniform(5, 370, (K, N, 2)).astype(np.float32)
    desc = np.zeros((KC, N, 8), np.uint32)
    desc[:K] = rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32)
    fv = np.zeros((KC, N), bool)
    fv[:K] = True
    depth = rng.uniform(4, 40, (KC, N)).astype(np.float32)
    mp_idx = np.full((KC, N), -1, np.int32)
    # each KF observes a contiguous window of points
    per_kf = min(N, P)
    for k in range(K):
        start = (k * P // K) % max(P - per_kf, 1)
        mp_idx[k, :per_kf] = (start + np.arange(per_kf)) % P

    mp_valid = np.zeros(MC, bool)
    mp_valid[:P] = True
    pos = np.zeros((MC, 3), np.float32)
    pos[:P] = rng.uniform([-20, -5, 4], [20, 5, 60], (P, 3)).astype(np.float32)
    normal = np.zeros((MC, 3), np.float32)
    normal[:P, 2] = -1.0
    mdesc = np.zeros((MC, 8), np.uint32)
    mdesc[:P] = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    obs_kf = np.full((MC, O), -1, np.int32)
    obs_feat = np.full((MC, O), -1, np.int32)
    n_obs = np.zeros(MC, np.int32)
    ks, js = np.nonzero(mp_idx >= 0)
    for k, j in zip(ks, js):
        m = mp_idx[k, j]
        o = n_obs[m]
        if o < O:
            obs_kf[m, o], obs_feat[m, o] = k, j
            n_obs[m] = o + 1
    covis = np.zeros((KC, KC), np.int32)
    covis[:K, :K] = 30
    np.fill_diagonal(covis, 0)
    parent = np.full(KC, -1, np.int32)
    parent[1:K] = np.arange(K - 1)

    return st._replace(
        kf_Tcw=jnp.asarray(Tcw), kf_valid=jnp.asarray(kf_valid),
        kf_uv=jnp.asarray(uv), kf_desc=jnp.asarray(desc),
        kf_feat_valid=jnp.asarray(fv), kf_depth=jnp.asarray(depth),
        kf_mp_idx=jnp.asarray(mp_idx),
        mp_pos=jnp.asarray(pos), mp_normal=jnp.asarray(normal),
        mp_desc=jnp.asarray(mdesc), mp_valid=jnp.asarray(mp_valid),
        mp_min_dist=jnp.asarray(np.where(mp_valid, 2.0, 0.0).astype(np.float32)),
        mp_max_dist=jnp.asarray(np.where(mp_valid, 80.0, 1e9).astype(np.float32)),
        mp_ref_kf=jnp.asarray(np.where(mp_valid, 0, -1).astype(np.int32)),
        mp_obs_kf=jnp.asarray(obs_kf), mp_obs_feat=jnp.asarray(obs_feat),
        mp_n_obs=jnp.asarray(n_obs), covis=jnp.asarray(covis),
        kf_parent=jnp.asarray(parent),
        next_kf=jnp.asarray(K, jnp.int32), next_mp=jnp.asarray(P, jnp.int32),
    )


def _dir_size(path):
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, fs in os.walk(path) for f in fs
    )


def main():
    from orb_slam2_ros2_tpu.config import MapConfig, ORBConfig, SLAMConfig
    from orb_slam2_ros2_tpu.io.persistence import load_map, save_map
    from orb_slam2_ros2_tpu.io.proto_map import load_proto_map, save_proto_map
    from orb_slam2_ros2_tpu.io.txt_map import load_txt_map, save_txt_map

    cfg = SLAMConfig(
        orb=ORBConfig(max_keypoints=512),
        map=MapConfig(max_keyframes=64, max_mappoints=8192, max_obs_per_mp=12),
    )
    st = build_state(cfg)
    # sanity statistic the reference prints (TxtVsProto.cc:16-27)
    t_norm = float(np.linalg.norm(np.asarray(st.kf_Tcw)[:, :3, 3], axis=1).max())

    tmp = tempfile.mkdtemp(prefix="bench_io_")
    results = {}
    try:
        p = os.path.join(tmp, "m.map.npz")
        t0 = time.perf_counter(); save_map(p, st, cfg); t_save = time.perf_counter() - t0
        t0 = time.perf_counter(); st_npz, _ = load_map(p); t_load = time.perf_counter() - t0
        results["npz"] = dict(save_s=round(t_save, 3), load_s=round(t_load, 3),
                              bytes=_dir_size(p))

        p = os.path.join(tmp, "m.pb")
        t0 = time.perf_counter(); save_proto_map(p, st, cfg); t_save = time.perf_counter() - t0
        t0 = time.perf_counter(); st_pb = load_proto_map(p, cfg); t_load = time.perf_counter() - t0
        results["proto"] = dict(save_s=round(t_save, 3), load_s=round(t_load, 3),
                                bytes=_dir_size(p))

        p = os.path.join(tmp, "txt")
        t0 = time.perf_counter(); save_txt_map(p, st, cfg); t_save = time.perf_counter() - t0
        t0 = time.perf_counter(); st_txt = load_txt_map(p, cfg); t_load = time.perf_counter() - t0
        results["txt"] = dict(save_s=round(t_save, 3), load_s=round(t_load, 3),
                              bytes=_dir_size(p))

        for name, s in (("npz", st_npz), ("proto", st_pb), ("txt", st_txt)):
            tn = float(np.linalg.norm(np.asarray(s.kf_Tcw)[:, :3, 3], axis=1).max())
            assert abs(tn - t_norm) < 1e-3, f"{name}: max|t| {tn} != {t_norm}"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({
        "metric": "map_io_formats",
        "max_kf_translation": round(t_norm, 3),
        "formats": results,
        "proto_vs_txt_time": round(
            (results["proto"]["save_s"] + results["proto"]["load_s"])
            / max(results["txt"]["save_s"] + results["txt"]["load_s"], 1e-9), 3),
        "proto_vs_txt_size": round(
            results["proto"]["bytes"] / max(results["txt"]["bytes"], 1), 3),
    }))


if __name__ == "__main__":
    main()
