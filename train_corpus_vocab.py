#!/usr/bin/env python
"""Train the shipped 10^5-word vocabulary from a DIVERSE rendered corpus
(r3 VERDICT missing#1: the 10^4-word vocab trained on the synthetic box alone
is the direct cause of the 17% reloc-under-aliasing rate).

Corpus: benign forward/circle worlds at several scales, plus the adversarial
world (repeated-texture wall, distractor spheres, exposure flicker) — the
same distribution validation.py relocalizes in.  Descriptors come from the
PRODUCTION extractor (same BRIEF template the tracker uses).

Runs on CPU (JAX_PLATFORMS=cpu) so it never contends with runs on the card.
Output: orb_slam2_ros2_tpu/assets/vocab_synth_l5.npz (k=10, L=5).
"""
import os, sys, time

# force CPU: rendering the corpus on the card would contend with other runs
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.features import extractor as ex
from orb_slam2_ros2_tpu.geometry.camera import CameraParams
from orb_slam2_ros2_tpu.io.synthetic import (
    AdversarialStereoDataset,
    SyntheticStereoDataset,
)

T0 = time.time()
def log(msg):
    print(f"[{time.time()-T0:7.1f}s] {msg}", flush=True)


def main():
    cfg = SLAMConfig()
    o, c = cfg.orb, cfg.camera
    cam = CameraParams.from_config(c)
    caps = tuple(ex.level_capacities(o.max_keypoints, o.n_levels, o.scale_factor))
    pair_matrix = ex._template_pair_matrix(cfg)
    extract = jax.jit(partial(
        ex.extract_features_batch, h=c.height, w=c.width,
        n_levels=o.n_levels, scale_factor=o.scale_factor, caps=caps,
        border=o.edge_border, min_th=float(o.min_th_fast),
        ini_th=float(o.ini_th_fast), cell=o.cell_size,
        undistort=c.has_distortion, brief_pair_matrix=pair_matrix,
    ))

    datasets = [
        ("fwd-sky", SyntheticStereoDataset(c, n_frames=100, speed=0.8, box_scale=2.5, sky=True), 100),
        ("fwd-plain", SyntheticStereoDataset(c, n_frames=80, speed=1.2, box_scale=1.0), 80),
        ("circle", SyntheticStereoDataset(c, n_frames=80, circle=True, box_scale=2.5, sky=True), 80),
        ("adversarial", AdversarialStereoDataset(c, n_frames=140, frames_per_lap=52), 140),
        ("adv-notex", AdversarialStereoDataset(c, n_frames=60, frames_per_lap=40,
                                               repeat_texture=False, n_distractors=6), 60),
    ]

    cache = "/tmp/corpus_descs.npy"
    if os.path.exists(cache):
        descs = np.load(cache)
        log(f"loaded cached corpus {descs.shape}")
        train_only(descs)
        return

    alld = []
    for name, ds, n in datasets:
        for i in range(0, n - 1, 2):
            l0, r0, _ = ds.frame(i)
            l1, r1, _ = ds.frame(i + 1)
            # both eyes of both frames: rendering dominates wall time on CPU,
            # descriptors are nearly free (right-eye near-dupes are folded by
            # the unique() pass below)
            feats, _ = extract(jnp.stack([l0, l1, r0, r1]), cam)
            d = np.asarray(feats.desc).reshape(-1, 8)
            v = np.asarray(feats.valid).reshape(-1)
            alld.append(d[v].astype(np.uint32))
            if i % 20 == 0:
                log(f"{name} {i}/{n} ({sum(len(a) for a in alld)} desc)")
    descs = np.concatenate(alld)
    np.save(cache, descs)
    log(f"corpus cached to {cache}")
    train_only(descs)


def train_only(descs: np.ndarray):
    """Pure-numpy training + save (the tree never needs to touch a
    device)."""
    # cap exact repeats at 4 (the repeated-texture wall floods the corpus
    # with identical descriptors, which would waste whole subtrees on one
    # visual word — DBoW training corpora are near-duplicate-free); a small
    # cap > 1 keeps frequency signal for the idf weights
    uniq, counts = np.unique(descs, axis=0, return_counts=True)
    capped = np.repeat(uniq, np.minimum(counts, 4), axis=0)
    log(f"corpus: {len(descs)} descriptors, {len(uniq)} unique, {len(capped)} after cap")

    from orb_slam2_ros2_tpu.bow import vocabulary as V
    rng = np.random.default_rng(0)
    k, L = 10, 5
    levels = []
    groups = [capped]
    t0 = time.time()
    for d in range(L):
        table = np.zeros((k ** (d + 1), 8), np.uint32)
        next_groups = []
        for gi, g in enumerate(groups):
            centers = V._kmedians(g, k, rng)
            table[gi * k: (gi + 1) * k] = centers
            assign = (V._hamming_np(g, centers).argmin(1) if len(g)
                      else np.zeros((0,), np.int64))
            for c_ in range(k):
                next_groups.append(g[assign == c_])
        levels.append(table)
        groups = next_groups
        log(f"level {d} done ({time.time()-t0:.0f}s)")
    leaf_counts = np.array([len(g) for g in groups], np.float32)
    idf = np.log(max(len(capped), 1) / np.maximum(leaf_counts, 1.0)).astype(np.float32)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "orb_slam2_ros2_tpu", "assets", "vocab_synth_l5.npz")
    np.savez_compressed(out, branching=k, depth=L, idf=idf,
                        **{f"level_{d}": t for d, t in enumerate(levels)})
    log(f"saved {out} ({os.path.getsize(out)/1e6:.1f} MB), "
        f"{int((leaf_counts > 0).sum())}/{k**L} leaves populated")


if __name__ == "__main__":
    main()
