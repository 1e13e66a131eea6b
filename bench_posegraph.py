#!/usr/bin/env python
"""Microbenchmark: essential-graph solver (dense Cholesky vs matrix-free PCG)
at production-and-beyond vertex counts.

The pipeline's essential graph runs at the map's keyframe capacity (1024 by
default, auto-growing), where the dense 7K×7K Hessian would be 205 MB f32 per
GN iteration; the PCG path never builds it.  Prints ms per full
20-GN-iteration optimize at each K.
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

from orb_slam2_ros2_tpu.geometry import se3, sim3
from orb_slam2_ros2_tpu.solvers.pose_graph import PoseGraphProblem, make_relative_measurements, optimize_pose_graph

T0 = time.time()


def log(m):
    print(f"[{time.time() - T0:6.1f}s] {m}", file=sys.stderr, flush=True)


def chain_problem(K: int, E_extra: int, seed: int = 0) -> PoseGraphProblem:
    """Drifted chain + random covis edges + one loop edge — the essential
    graph's edge mix at scale."""
    r = np.random.default_rng(seed)
    step = np.asarray(se3.exp(jnp.asarray([0.5, 0, 0.05, 0, 2 * np.pi / K, 0], jnp.float32)))
    gt = [np.eye(4, dtype=np.float32)]
    est = [gt[0]]
    for _ in range(1, K):
        gt.append((step @ gt[-1]).astype(np.float32))
        noise = se3.exp(jnp.asarray(np.concatenate([r.normal(0, 0.01, 3), r.normal(0, 0.002, 3)]), jnp.float32))
        est.append(((step @ np.asarray(noise)) @ est[-1]).astype(np.float32))
    S_est = sim3.from_se3(jnp.asarray(np.stack(est)))
    S_gt = sim3.from_se3(jnp.asarray(np.stack(gt)))

    ei = list(range(K - 1))
    ej = list(range(1, K))
    # covis-style extra edges between near-in-time keyframes
    a = r.integers(0, K - 3, E_extra)
    b = a + r.integers(2, 4, E_extra)
    ei += a.tolist()
    ej += b.tolist()
    # loop edge with the true relative pose
    ei.append(0)
    ej.append(K - 1)
    ei = jnp.asarray(ei, jnp.int32)
    ej = jnp.asarray(ej, jnp.int32)
    S_meas = make_relative_measurements(S_est, ei, ej)
    true_rel = make_relative_measurements(S_gt, jnp.asarray([0]), jnp.asarray([K - 1]))
    S_meas = sim3.Sim3(
        R=S_meas.R.at[-1].set(true_rel.R[0]),
        t=S_meas.t.at[-1].set(true_rel.t[0]),
        s=S_meas.s.at[-1].set(true_rel.s[0]),
    )
    E = int(ei.shape[0])
    return PoseGraphProblem(
        S_cw=S_est, kf_valid=jnp.ones(K, bool),
        kf_fixed=jnp.zeros(K, bool).at[0].set(True),
        edge_i=ei, edge_j=ej, edge_Sji=S_meas,
        edge_valid=jnp.ones(E, bool), edge_weight=jnp.ones(E),
    )


def time_solve(prob, **kw):
    fn = jax.jit(lambda p: sim3.to_se3(optimize_pose_graph(p, iters=20, **kw)))
    np.asarray(fn(prob))  # compile
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(fn(prob))
        best = min(best, time.perf_counter() - t0)
    return best * 1000.0


def main():
    import json

    out = {}
    for K, extra in ((256, 1024), (1024, 4096), (2048, 8192)):
        prob = chain_problem(K, extra)
        ms_pcg = time_solve(prob, dense_max_k=0, cg_iters=150)
        out[f"pcg_K{K}_ms"] = round(ms_pcg, 1)
        log(f"K={K} E={int(prob.edge_i.shape[0])}: pcg {ms_pcg:.1f} ms")
        if K <= 1024:
            ms_dense = time_solve(prob, dense_max_k=1 << 20)
            out[f"dense_K{K}_ms"] = round(ms_dense, 1)
            log(f"K={K}: dense {ms_dense:.1f} ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
