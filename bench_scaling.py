#!/usr/bin/env python
"""Sharded global-BA scaling probe on the virtual CPU mesh.

This runs on virtual CPU devices (SURVEY §5.8), so it measures a stand-in
for cards: wall time
of one full global-BA solve at a KITTI-00-scale problem (1024 cameras,
2·10⁵ points) across 1/2/4/8 shards of an
``xla_force_host_platform_device_count`` CPU mesh.  The numbers describe
the CPU mesh only; ``chip_smoke.py --four-cards`` runs the sharded BA on
four cards.

Run: python bench_scaling.py   (prints one JSON line)
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.geometry import se3
from orb_slam2_ros2_tpu.geometry.camera import CameraParams, project
from orb_slam2_ros2_tpu.parallel.mesh import ba_mesh
from orb_slam2_ros2_tpu.solvers.pcg_ba import (
    PointBAProblem,
    point_to_global,
    solve_global_ba,
    solve_global_ba_sharded,
)


def build_problem(C=1024, P=200_000, O=6, seed=0):
    r = np.random.default_rng(seed)
    cam = CameraParams.from_config(SLAMConfig().camera)
    pts = np.stack(
        [r.uniform(-30, 30, P), r.uniform(-6, 6, P), r.uniform(5, 80, P)], 1
    ).astype(np.float32)
    Tcw = np.stack([
        np.asarray(se3.exp(jnp.asarray(
            [0.3 * i, 0, 0.05 * i, 0, 0.002 * i, 0], jnp.float32)))
        for i in range(C)
    ])
    obs_cam = r.integers(0, C, (P, O)).astype(np.int32)
    pc = np.einsum("poij,pj->poi", Tcw[obs_cam][..., :3, :3], pts) + Tcw[obs_cam][..., :3, 3]
    uv, _ = project(cam, jnp.asarray(pc.reshape(-1, 3)))
    uv = np.asarray(uv).reshape(P, O, 2)
    valid = (pc[..., 2] > 1) & (uv[..., 0] > 0) & (uv[..., 0] < 1241) & (uv[..., 1] > 0) & (uv[..., 1] < 376)
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    prob = PointBAProblem(
        cam_Tcw=jnp.asarray(Tcw), cam_free=jnp.asarray(cam_free),
        pt_pos=jnp.asarray(pts + r.normal(0, 0.05, pts.shape).astype(np.float32)),
        pt_valid=jnp.ones(P, bool),
        obs_cam=jnp.asarray(np.where(valid, obs_cam, -1)),
        obs_uv=jnp.asarray(uv.astype(np.float32)),
        obs_right_u=jnp.full((P, O), -1.0, jnp.float32),
        obs_inv_sigma2=jnp.ones((P, O), jnp.float32),
        obs_valid=jnp.asarray(valid),
    )
    return cam, point_to_global(prob)


def time_solve(fn, reps=3):
    out = fn()
    jax.block_until_ready(out)
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    cam, prob = build_problem()
    kw = dict(phase_iters=(2, 2), pcg_iters=20, lam=1e-3)
    results = {}
    t1 = time_solve(lambda: solve_global_ba(cam, prob, **kw)[0])
    results[1] = t1
    for n in (2, 4, 8):
        mesh = ba_mesh(n)
        tn = time_solve(lambda: solve_global_ba_sharded(cam, prob, mesh, **kw)[0])
        results[n] = tn
    eff = {n: round(results[1] / (results[n] * n), 3) for n in results}
    print(json.dumps({
        "metric": "global_ba_scaling_cpu_mesh",
        "problem": "C=1024 P=200k O=6",
        "seconds": {str(n): round(t, 3) for n, t in results.items()},
        "efficiency_vs_1": {str(n): eff[n] for n in eff},
        "note": "virtual CPU mesh; says nothing about cards",
    }))


if __name__ == "__main__":
    main()
