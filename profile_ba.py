#!/usr/bin/env python
"""Micro-profile: local-BA extract vs solve vs writeback, and the big
top_k-over-M selections (snapshot, extraction) — finds where map_tail's
local_ba time actually goes.  Each timing syncs once, so it includes one
dispatch-and-fetch floor, printed first."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax, jax.numpy as jnp, numpy as np
from functools import partial

from orb_slam2_ros2_tpu.utils import setup_compile_cache  # noqa: E402

setup_compile_cache()

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu.pipeline.system import SLAM
from orb_slam2_ros2_tpu.solvers.local_ba import extract_window_points, local_ba
from orb_slam2_ros2_tpu.solvers.schur_ba import solve_ba_points

WARM = 30


def bench(name, fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"  {name:28s} {best*1000:8.2f} ms", flush=True)
    return out


def main():
    import dataclasses as _dc
    cfg = SLAMConfig()
    cfg = cfg.replace(tracking=_dc.replace(cfg.tracking, th_depth=60.0))
    ds = SyntheticStereoDataset(cfg.camera, n_frames=WARM + 2, speed=0.8,
                                box_scale=2.5, sky=True)
    slam = SLAM(cfg, enable_loop_closing=False)
    for i in range(WARM):
        slam.track(*ds.frame(i)[:2])
    slam.flush()
    print(f"map: {slam.n_keyframes} kfs, {slam.n_mappoints} mps", flush=True)

    f = jax.jit(lambda a: a + 1)
    x = jnp.zeros((4,), jnp.float32)
    np.asarray(f(x))
    t0 = time.perf_counter()
    for _ in range(5):
        np.asarray(f(x))
    print(f"sync floor {(time.perf_counter()-t0)/5*1000:.2f} ms (included below)", flush=True)

    b, o = cfg.ba, cfg.orb
    state = slam.map
    kf_id = jnp.asarray(slam.ref_kf, jnp.int32)
    cam = slam.cam

    ext = jax.jit(partial(extract_window_points, max_free=b.max_local_ba_kfs,
                          max_fixed=b.max_local_ba_fixed,
                          max_points=b.local_ba_points,
                          scale_factor=o.scale_factor))
    prob, cam_ids, pt_ids, obs_kf, obs_feat = bench("extract_window", ext, state, kf_id)

    solve = jax.jit(partial(solve_ba_points, chi2_mono=b.chi2_mono,
                            chi2_stereo=b.chi2_stereo,
                            phase_iters=tuple(b.local_ba_phase_iters),
                            lam=b.lm_lambda_init))
    bench("solve_ba_points", solve, cam, prob)

    ba = jax.jit(partial(local_ba, max_free=b.max_local_ba_kfs,
                         max_fixed=b.max_local_ba_fixed,
                         max_points=b.local_ba_points, chi2_mono=b.chi2_mono,
                         chi2_stereo=b.chi2_stereo, lam=b.lm_lambda_init,
                         scale_factor=o.scale_factor,
                         phase_iters=tuple(b.local_ba_phase_iters)))
    bench("local_ba (full)", ba, state, kf_id, cam)

    # isolated big top_k over M
    M = state.mp_capacity
    mask = state.mp_valid
    @jax.jit
    def big_topk(mask):
        score = jnp.where(mask, 1 + jnp.arange(M, dtype=jnp.int32), 0)
        return jax.lax.top_k(score, 8192)[1]
    bench("top_k M->8192 (i32)", big_topk, mask)

    @jax.jit
    def big_approx(mask):
        score = jnp.where(mask, 1.0 + jnp.arange(M, dtype=jnp.float32), 0.0)
        return jax.lax.approx_max_k(score, 8192)[1]
    bench("approx_max_k M->8192", big_approx, mask)

    # sparse_bow's top_k over the L5 vocab (W=1e5)
    from orb_slam2_ros2_tpu.bow.keyframe_db import sparse_bow
    from orb_slam2_ros2_tpu.bow.vocabulary import transform
    if slam.loop_closer is None:
        from orb_slam2_ros2_tpu.pipeline.loop_closing import LoopCloser
        slam.loop_closer = LoopCloser(cfg, slam._resolve_vocab(0))
    vocab = slam.loop_closer.vocab
    desc = state.kf_desc[0]
    valid = state.kf_feat_valid[0]
    tr = jax.jit(partial(transform, vocab))
    words = bench("vocab transform (L5)", tr, desc, valid)
    sb = jax.jit(partial(sparse_bow, vocab, max_words=cfg.bow.max_words_per_query))
    bench("sparse_bow (top_k 1e5)", sb, words)


if __name__ == "__main__":
    main()
