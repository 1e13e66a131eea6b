"""Loop closing: detection, Sim3 verification, correction, optimization.

Replaces the reference's LoopClosing thread (src/LoopClosing.cc):
- ``detect``: keyframe-database retrieval + covisibility-consistency chains
  of ≥3 consecutive detections (:218-282) — chain bookkeeping on the host
  over device query results;
- ``compute_sim3``: dense descriptor matching of map-point-bearing features,
  batched Sim3-RANSAC, GN refinement, neighbourhood-projection verification
  (:300-415, Sim3Solver.cc, Optimizer.cc:464-619);
- ``correct``: propagate the corrected Sim3 through the current covisibility
  group, transform their map points, fuse duplicates, optimize the essential
  graph, then run global BA (:432-541, :92-169).

All numeric stages are jitted; the host only sequences them and keeps the
consistency-chain sets (tiny python state, mirroring mvConsistentGroups).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bow.keyframe_db import KeyFrameDB, find_loop_candidates, sparse_bow
from ..bow.vocabulary import Vocabulary, transform
from ..config import SLAMConfig
from ..geometry import se3, sim3
from ..geometry.camera import CameraParams, project
from ..mapstate.local_map import LocalMap
from ..mapstate.map_state import (
    MapState,
    _append_observations,
    _covis_row_for_kf,
    _distill_descriptors,
    merge_mappoints,
)
from ..matching.matcher import best_match, mutual_filter
from ..ops.hamming import hamming_matrix
from ..utils import topk_bounded
from ..solvers.global_ba import global_ba
from ..solvers.pose_graph import (
    PoseGraphProblem,
    make_relative_measurements,
    optimize_pose_graph,
)
from ..solvers.sim3_solver import optimize_sim3, ransac_sim3


def _copy_async(a) -> None:
    """Start a device→host copy now so a later np.asarray does not block on
    the transfer: the async path delivers the bytes in the background."""
    try:
        a.copy_to_host_async()
    except AttributeError:  # backend without async transfers
        pass


def match_mappoint_features(
    state: MapState, kf1, kf2, *, max_dist: int = 50, ratio: float = 0.75
):
    """Dense hamming matching between the map-point-bearing features of two
    keyframes.  Returns per-feature-of-kf1 match indices into kf2 and the
    matched map-point camera-frame positions (pc1, pc2).

    Replaces the BoW-bucketed searchByBow used at LoopClosing.cc:315-320 —
    dense N×N hamming (one matmul) needs no buckets.
    """
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    has1 = state.kf_feat_valid[kf1] & (state.kf_mp_idx[kf1] >= 0)
    has2 = state.kf_feat_valid[kf2] & (state.kf_mp_idx[kf2] >= 0)
    dist = hamming_matrix(state.kf_desc[kf1], state.kf_desc[kf2])
    cand = has1[:, None] & has2[None, :]
    BIG = 1 << 20
    masked = jnp.where(cand, dist, BIG)
    best = jnp.min(masked, axis=1)
    bj = jnp.argmin(masked, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, masked.shape, 1)
    second = jnp.min(jnp.where(cols == bj[:, None], BIG, masked), axis=1)
    ok = (best <= max_dist) & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    # mutual best
    best_i = jnp.argmin(masked, axis=0)
    ok = ok & (best_i[bj] == jnp.arange(N))

    mp1 = state.kf_mp_idx[kf1]
    mp2 = state.kf_mp_idx[kf2][bj]
    p1w = state.mp_pos[jnp.clip(mp1, 0, M - 1)]
    p2w = state.mp_pos[jnp.clip(mp2, 0, M - 1)]
    pc1 = se3.apply(state.kf_Tcw[kf1], p1w)
    pc2 = se3.apply(state.kf_Tcw[kf2], p2w)
    ok = ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0)
    oct1 = state.kf_octave[kf1]
    oct2 = state.kf_octave[kf2][bj]
    return ok, bj, pc1, pc2, oct1, oct2, mp1, mp2


def _predict_level(max_dist, d, scale_factor: float, n_levels: int):
    """MapPoint::predictLevel (reference MapPoint.cc:191-201)."""
    lvl = jnp.ceil(
        jnp.log(jnp.maximum(max_dist / jnp.maximum(d, 1e-9), 1e-9))
        / jnp.log(scale_factor)
    ).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


def search_by_sim3_pair(
    state: MapState,
    cam: CameraParams,
    kf_cur,
    kf_cand,
    S12: sim3.Sim3,
    ok: jnp.ndarray,
    bj: jnp.ndarray,
    *,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    th: float = 7.5,
    max_dist: int = 50,
    ratio: float = 0.75,
):
    """Sim3-guided bidirectional projection matching between two keyframes —
    the missing ``searchBySim3`` (reference ORBMatcher.cc:425-484 with the
    per-point SIM3Project at :370-412): project each side's map points into
    the other camera through the candidate Sim3, search MP-bearing features
    in a ``th``-radius window around the prediction, and ADD matches on top
    of the existing (ok, bj) set.  Existing matches always win; forward
    (cur→cand) additions beat backward ones, mirroring the reference's
    map-insert precedence (ORBMatcher.cc:476-481).

    Returns (ok2, bj2, n_matches).
    """
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    BIG = 1 << 20

    mp1 = state.kf_mp_idx[kf_cur]
    mp2 = state.kf_mp_idx[kf_cand]
    has1 = state.kf_feat_valid[kf_cur] & (mp1 >= 0) & state.mp_valid[jnp.clip(mp1, 0, M - 1)]
    has2 = state.kf_feat_valid[kf_cand] & (mp2 >= 0) & state.mp_valid[jnp.clip(mp2, 0, M - 1)]
    pw1 = state.mp_pos[jnp.clip(mp1, 0, M - 1)]
    pw2 = state.mp_pos[jnp.clip(mp2, 0, M - 1)]
    pc1 = se3.apply(state.kf_Tcw[kf_cur], pw1)
    pc2 = se3.apply(state.kf_Tcw[kf_cand], pw2)
    minD1 = state.mp_min_dist[jnp.clip(mp1, 0, M - 1)]
    maxD1 = state.mp_max_dist[jnp.clip(mp1, 0, M - 1)]
    minD2 = state.mp_min_dist[jnp.clip(mp2, 0, M - 1)]
    maxD2 = state.mp_max_dist[jnp.clip(mp2, 0, M - 1)]

    D = hamming_matrix(state.kf_desc[kf_cur], state.kf_desc[kf_cand])

    # already-matched flags on both sides (goodflagC/goodflagM)
    matched2 = jnp.zeros((N,), bool).at[jnp.where(ok, bj, N)].set(True, mode="drop")

    def one_direction(p_src_cam, S_to_other, src_free, src_minD, src_maxD,
                      tgt_uv, tgt_oct, tgt_has_mp, dist_matrix):
        """Project source-camera points through S_to_other into the target
        camera and match against the target's MP-bearing features."""
        p_t = sim3.apply(S_to_other, p_src_cam)            # [N, 3] (scaled)
        uv_t, in_front = project(cam, p_t)
        in_img = (
            (uv_t[:, 0] >= 0) & (uv_t[:, 0] < width)
            & (uv_t[:, 1] >= 0) & (uv_t[:, 1] < height)
        )
        d = jnp.linalg.norm(p_t, axis=-1) / S_to_other.s   # world-scale distance
        dist_ok = (d >= 0.8 * src_minD) & (d <= 1.2 * src_maxD)
        lvl = _predict_level(src_maxD, d, scale_factor, n_levels)
        r = th * jnp.power(jnp.float32(scale_factor), lvl.astype(jnp.float32))
        du = jnp.abs(uv_t[:, None, 0] - tgt_uv[None, :, 0])
        dv = jnp.abs(uv_t[:, None, 1] - tgt_uv[None, :, 1])
        in_area = (du <= r[:, None]) & (dv <= r[:, None])
        oct_ok = (tgt_oct[None, :] >= (lvl - 1)[:, None]) & (
            tgt_oct[None, :] <= (lvl + 1)[:, None]
        )
        q_ok = src_free & in_front & in_img & dist_ok
        cand = in_area & oct_ok & tgt_has_mp[None, :] & q_ok[:, None]
        return best_match(dist_matrix, cand, max_dist, ratio)

    # forward: cur's unmatched MPs → cand frame (Smc = S12⁻¹)
    S_mc = sim3.inverse(S12)
    fwd = one_direction(
        pc1, S_mc, has1 & ~ok, minD1, maxD1,
        state.kf_uv[kf_cand], state.kf_octave[kf_cand], has2, D,
    )
    # backward: cand's unmatched MPs → cur frame (S12)
    bwd = one_direction(
        pc2, S12, has2 & ~matched2, minD2, maxD2,
        state.kf_uv[kf_cur], state.kf_octave[kf_cur], has1, D.T,
    )

    # merge with precedence existing > forward > backward
    ok2 = ok
    bj2 = jnp.where(ok, bj, -1)
    fill_f = ~ok2 & fwd.found
    bj2 = jnp.where(fill_f, fwd.idx, bj2)
    ok2 = ok2 | fill_f
    # backward: per-cur-feature pick the claiming cand feature with min dist,
    # excluding cand features already taken by existing/forward matches —
    # without this, one cand feature (and its map point) can be assigned to
    # two current features, breaking the one-MP-per-KF invariant downstream
    # (the reference's agreement check, ORBMatcher.cc:476-481)
    used_cand = jnp.zeros((N + 1,), bool).at[jnp.where(ok2, bj2, N)].set(True, mode="drop")
    bwd_found = bwd.found & ~used_cand[:N]
    brow = jnp.where(bwd_found, bwd.idx, N)                # cur feature claimed
    key = jnp.minimum(bwd.dist, 300) * (N + 1) + jnp.arange(N)
    best_key = jnp.full((N + 1,), jnp.iinfo(jnp.int32).max).at[brow].min(key)
    claimed = best_key[:N] < jnp.iinfo(jnp.int32).max
    claim_j = best_key[:N] % (N + 1)
    fill_b = ~ok2 & claimed
    bj2 = jnp.where(fill_b, claim_j, bj2)
    ok2 = ok2 | fill_b
    return ok2, jnp.where(ok2, bj2, -1), jnp.sum(ok2.astype(jnp.int32))


def gather_match_pairs(state: MapState, kf_cur, kf_cand, ok, bj):
    """Camera-frame point pairs + octaves for a per-cur-feature match set
    (the inputs Sim3 RANSAC / OptimizeSim3 consume)."""
    M = state.mp_capacity
    bjc = jnp.clip(bj, 0, state.kf_uv.shape[1] - 1)
    mp1 = state.kf_mp_idx[kf_cur]
    mp2 = state.kf_mp_idx[kf_cand][bjc]
    p1w = state.mp_pos[jnp.clip(mp1, 0, M - 1)]
    p2w = state.mp_pos[jnp.clip(mp2, 0, M - 1)]
    pc1 = se3.apply(state.kf_Tcw[kf_cur], p1w)
    pc2 = se3.apply(state.kf_Tcw[kf_cand], p2w)
    ok = ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0) & (mp1 >= 0) & (mp2 >= 0)
    oct1 = state.kf_octave[kf_cur]
    oct2 = state.kf_octave[kf_cand][bjc]
    return ok, pc1, pc2, oct1, oct2, mp2


def loop_group_snapshot(state: MapState, kf_cand, *, min_covis_weight: int, max_mps: int) -> LocalMap:
    """Bounded snapshot of the loop group's map points: the candidate KF's
    covisibility group (getConnectedKfs at LoopClosing.cc:381-401) and every
    map point they observe."""
    K = state.kf_capacity
    M = state.mp_capacity
    kf_mask = (state.covis[kf_cand] >= min_covis_weight) & state.kf_valid
    kf_mask = kf_mask.at[kf_cand].set(state.kf_valid[kf_cand])

    rows = jnp.where(kf_mask[:, None], state.kf_mp_idx, -1)  # [K, N]
    mp_mask = jnp.zeros((M,), bool)
    mp_mask = mp_mask.at[jnp.where(rows >= 0, rows, M).reshape(-1)].set(True, mode="drop")
    mp_mask = mp_mask & state.mp_valid

    score = jnp.where(mp_mask, 1 + jnp.arange(M, dtype=jnp.int32), 0)
    top, mp_ids = jax.lax.top_k(score, min(max_mps, M))
    okm = top > 0
    mp_ids = jnp.where(okm, mp_ids, -1)
    idc = jnp.clip(mp_ids, 0, M - 1)
    return LocalMap(
        mp_ids=mp_ids,
        pos=state.mp_pos[idc],
        normal=state.mp_normal[idc],
        desc=state.mp_desc[idc],
        min_dist=state.mp_min_dist[idc],
        max_dist=state.mp_max_dist[idc],
        valid=okm,
        kf_ids=jnp.zeros((1,), jnp.int32),
        kf_mask=kf_mask,
    )


def search_loop_group_projection(
    state: MapState,
    cam: CameraParams,
    kf_cur,
    S_cw: sim3.Sim3,
    group: LocalMap,
    matched_mp: jnp.ndarray,
    *,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    th: float = 10.0,
    max_dist: int = 50,
    ratio: float = 0.75,
):
    """Project the loop group's map points into the current keyframe through
    the optimized Scw — the second ``searchBySim3`` variant (reference
    ORBMatcher.cc:501-549): distance/view-angle/level gates, ``th``-radius
    window over ALL current features (fusion doesn't require the feature to
    hold a map point), hamming ≤ 50 + ratio.  Updates the per-feature
    matched-map-point table and returns (matched_mp', n_total)."""
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    L = group.mp_ids.shape[0]

    already = jnp.zeros((M + 1,), bool).at[
        jnp.where(matched_mp >= 0, matched_mp, M)
    ].set(True, mode="drop")
    fresh = group.valid & ~already[jnp.clip(group.mp_ids, 0, M - 1)]

    p_c = sim3.apply(S_cw, group.pos)                   # [L, 3] scaled cam pts
    uv_c, in_front = project(cam, p_c)
    in_img = (
        (uv_c[:, 0] >= 0) & (uv_c[:, 0] < width)
        & (uv_c[:, 1] >= 0) & (uv_c[:, 1] < height)
    )
    dws = jnp.linalg.norm(p_c, axis=-1)
    d = dws / S_cw.s
    dist_ok = (d >= 0.8 * group.min_dist) & (d <= 1.2 * group.max_dist)
    # view angle: rotate the stored normal into the camera and compare with
    # the viewing ray (cos ≥ 0.5, ORBMatcher.cc:532-533)
    n_c = jnp.einsum("ij,lj->li", S_cw.R, group.normal)
    angle_ok = jnp.sum(n_c * p_c, axis=-1) >= 0.5 * dws
    lvl = _predict_level(group.max_dist, d, scale_factor, n_levels)
    r = th * jnp.power(jnp.float32(scale_factor), lvl.astype(jnp.float32))

    cur_uv = state.kf_uv[kf_cur]
    cur_oct = state.kf_octave[kf_cur]
    du = jnp.abs(uv_c[:, None, 0] - cur_uv[None, :, 0])
    dv = jnp.abs(uv_c[:, None, 1] - cur_uv[None, :, 1])
    in_area = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (cur_oct[None, :] >= (lvl - 1)[:, None]) & (cur_oct[None, :] <= (lvl + 1)[:, None])
    q_ok = fresh & in_front & in_img & dist_ok & angle_ok
    # features already carrying a verified (stage-B) match are off limits —
    # the reference's SearchByProjection skips vpMatched-set slots
    # (ORBMatcher.cc:515-517)
    free_feat = matched_mp < 0
    cand = (
        in_area & oct_ok & state.kf_feat_valid[kf_cur][None, :]
        & free_feat[None, :] & q_ok[:, None]
    )

    Dm = hamming_matrix(group.desc, state.kf_desc[kf_cur])
    m = best_match(Dm, cand, max_dist, ratio)
    m = mutual_filter(m, N)                              # one MP per feature

    tgt = jnp.where(m.found, m.idx, N)
    matched_mp2 = matched_mp.at[tgt].set(group.mp_ids, mode="drop")
    n = jnp.sum((matched_mp2 >= 0).astype(jnp.int32))
    return matched_mp2, n


def attach_matched_mps(state: MapState, kf_cur, matched_mp: jnp.ndarray) -> MapState:
    """Fuse the Sim3-matched loop map points into the current keyframe
    (reference correctLoop at LoopClosing.cc:497-513): empty feature slots
    adopt the loop point; occupied slots merge, the current keyframe's own
    point surviving (MapPoint::replace(pMpC, matched), :507)."""
    N = state.kf_uv.shape[1]
    M = state.mp_capacity
    cur_mp = state.kf_mp_idx[kf_cur]
    valid_m = (matched_mp >= 0) & state.mp_valid[jnp.clip(matched_mp, 0, M - 1)]

    attach = valid_m & (cur_mp < 0) & state.kf_feat_valid[kf_cur]
    feats = jnp.arange(N)
    st = state._replace(
        kf_mp_idx=state.kf_mp_idx.at[kf_cur, jnp.where(attach, feats, N)].set(
            jnp.where(attach, matched_mp, -1), mode="drop"
        )
    )
    st = _append_observations(st, kf_cur, matched_mp, feats, attach)

    merge = valid_m & (cur_mp >= 0) & (cur_mp != matched_mp)
    st = merge_mappoints(st, winner=cur_mp, loser=matched_mp, mask=merge)
    st = _distill_descriptors(st, jnp.where(attach | merge, jnp.where(merge, cur_mp, matched_mp), -1))

    row = _covis_row_for_kf(st, kf_cur)
    covis = st.covis.at[kf_cur, :].set(row).at[:, kf_cur].set(row)
    return st._replace(covis=covis)


def fuse_group_into_kfs(
    state: MapState,
    cam: CameraParams,
    group: LocalMap,
    kf_ids: jnp.ndarray,
    *,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
) -> MapState:
    """Project the loop group's map points into each current-group keyframe
    and fuse with loop priority (reference LoopClosing.cc:515-517:
    matcher.fuse(pKf, mvLoopGroupMps, map, true, 4.0))."""
    from ..mapstate.mapping import fuse_candidates_into_keyframe

    def body(i, st):
        kf = kf_ids[i]
        return jax.lax.cond(
            kf >= 0,
            lambda s: fuse_candidates_into_keyframe(
                s, jnp.maximum(kf, 0), cam, group,
                width=width, height=height, scale_factor=scale_factor,
                n_levels=n_levels, th=4.0, max_dist=50, ratio=0.8,
                loop_priority=True,
            ),
            lambda s: s,
            st,
        )

    return jax.lax.fori_loop(0, kf_ids.shape[0], body, state)


class LoopCloser:
    """Host orchestrator of the loop-closing stages."""

    def __init__(self, cfg: SLAMConfig, vocab: Vocabulary):
        self.cfg = cfg
        self.vocab = vocab
        self.db = KeyFrameDB.empty(cfg.map.max_keyframes, cfg.bow.max_words_per_query)
        # consistency chains: list of (covis-group set, consecutive count)
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.last_loop_kf = -1
        # deferred Sim3 verification in flight (sim3_begin/sim3_step)
        self.pending_sim3 = None

        self._transform = jax.jit(partial(transform, vocab))
        self._bowvec = jax.jit(partial(sparse_bow, vocab, max_words=cfg.bow.max_words_per_query))

        def _add_and_detect_program(db, state, kf_id):
            """DB insertion + transform → sparse BoW → candidate query →
            candidate covis rows, as ONE program: the host pays a single
            dispatch+fetch per keyframe instead of six dependent ones)."""
            from ..bow.keyframe_db import add_keyframe

            words = transform(vocab, state.kf_desc[kf_id], state.kf_feat_valid[kf_id])
            q = sparse_bow(vocab, words, cfg.bow.max_words_per_query)
            db = KeyFrameDB(
                word_ids=db.word_ids.at[kf_id].set(q.ids),
                weights=db.weights.at[kf_id].set(q.weights),
            )
            cand_ids, scores = find_loop_candidates(
                db, state, q, kf_id, n_candidates=5, n_words=vocab.n_words,
                min_covis_weight=cfg.mapping.min_covis_weight,
            )
            rows = state.covis[jnp.clip(cand_ids, 0, state.kf_capacity - 1)]
            rows = jnp.where((cand_ids >= 0)[:, None], rows, 0)
            # ids embedded in column 0 → ONE host fetch for the whole result
            return db, jnp.concatenate([cand_ids[:, None], rows], axis=1)

        self._add_detect_prog = jax.jit(_add_and_detect_program, donate_argnums=(0,))

        def _frame_detect_program(db, state, desc, valid, ref_kf):
            """Loop-candidate query from a FRAME's descriptors (no DB
            registration), anchored at the tracking reference keyframe for
            the connected-KF exclusion — detection density for the
            starved-keyframe regime (LoopConfig.frame_query_stride)."""
            words = transform(vocab, desc, valid)
            q = sparse_bow(vocab, words, cfg.bow.max_words_per_query)
            cand_ids, scores = find_loop_candidates(
                db, state, q, ref_kf, n_candidates=5, n_words=vocab.n_words,
                min_covis_weight=cfg.mapping.min_covis_weight,
            )
            rows = state.covis[jnp.clip(cand_ids, 0, state.kf_capacity - 1)]
            rows = jnp.where((cand_ids >= 0)[:, None], rows, 0)
            return jnp.concatenate([cand_ids[:, None], rows], axis=1)

        self._frame_detect_prog = jax.jit(_frame_detect_program)
        self._match = jax.jit(partial(match_mappoint_features))
        self._pose_graph = jax.jit(partial(optimize_pose_graph, iters=20))
        # the whole essential-graph stage as ONE program: its body is ~200
        # jnp ops, and eagerly each op is a separate dispatch
        self._essential = jax.jit(partial(
            optimize_essential,
            essential_weight=cfg.loop.essential_graph_weight,
            pose_graph_fn=partial(optimize_pose_graph, iters=20),
        ))
        self._essential_mesh = None  # built lazily when a mesh is passed
        o = cfg.orb
        c = cfg.camera
        geom = dict(width=c.width, height=c.height,
                    scale_factor=o.scale_factor, n_levels=o.n_levels)
        self._attach = jax.jit(attach_matched_mps)
        self._fuse_group = jax.jit(partial(fuse_group_into_kfs, **geom))
        inv_sigma2 = lambda oct: jnp.power(  # noqa: E731
            jnp.float32(1.0 / (o.scale_factor**2)), oct.astype(jnp.float32)
        )
        self._inv_sigma2 = inv_sigma2

        # --- the Sim3 verification cascade as three fused stages ----------
        # (one dispatch + one scalar fetch per stage: most attempts die at
        # stage A, costing a single fetch instead of ~10)
        fix_scale = cfg.camera.camera_type in (0, 1)  # stereo/RGBD
        chi2 = cfg.ba.chi2_sim3

        def _pair_valid(state, kf_cur, kf_cand):
            # gate element guarding the DEFERRED cascade: a keyframe culled
            # between stage dispatches (the cascade spans idle frames)
            # invalidates the attempt — the reference's equivalent is its
            # mspLoopKfs erase hooks (KeyFrame::SetBadFlag)
            return (state.kf_valid[kf_cur] & state.kf_valid[kf_cand]).astype(jnp.int32)

        def _stage_a(state, cam, kf_cur, kf_cand, key):
            ok, bj, pc1, pc2, oct1, oct2, _, _ = match_mappoint_features(
                state, kf_cur, kf_cand
            )
            n_matches = jnp.sum(ok.astype(jnp.int32))
            S12, inl, n_in = ransac_sim3(
                pc1, pc2, ok, cam, inv_sigma2(oct1), inv_sigma2(oct2), key,
                fix_scale=fix_scale, chi2_th=chi2,
            )
            return S12, ok, bj, jnp.stack(
                [n_matches, n_in, _pair_valid(state, kf_cur, kf_cand)]
            )

        def _stage_b(state, cam, kf_cur, kf_cand, S12, ok, bj):
            ok, bj, n_exp = search_by_sim3_pair(
                state, cam, kf_cur, kf_cand, S12, ok, bj, th=7.5, **geom
            )
            ok2, pc1, pc2, oct1, oct2, mp2 = gather_match_pairs(
                state, kf_cur, kf_cand, ok, bj
            )
            S12b, inl2, n_in2 = optimize_sim3(
                S12, pc1, pc2, ok2, cam, inv_sigma2(oct1), inv_sigma2(oct2),
                fix_scale=fix_scale, chi2_th=chi2,
            )
            matched_mp = jnp.where(ok2 & inl2, mp2, -1)
            return S12b, matched_mp, jnp.stack(
                [n_exp, n_in2, _pair_valid(state, kf_cur, kf_cand)]
            )

        def _stage_c(state, cam, kf_cur, kf_cand, S12, matched_mp):
            group = loop_group_snapshot(
                state, kf_cand,
                min_covis_weight=cfg.mapping.min_covis_weight, max_mps=8192,
            )
            S_cw = sim3.compose(S12, sim3.from_se3(state.kf_Tcw[kf_cand]))
            matched_mp, n_total = search_loop_group_projection(
                state, cam, kf_cur, S_cw, group, matched_mp, th=10.0, **geom
            )
            return matched_mp, group, jnp.stack(
                [n_total, _pair_valid(state, kf_cur, kf_cand)]
            )

        self._sim3_a = jax.jit(_stage_a)
        self._sim3_b = jax.jit(_stage_b)
        self._sim3_c = jax.jit(_stage_c)

    def grow(self, n_keyframes: int) -> None:
        """Re-pad the sparse BoW rows when the map's keyframe capacity grows
        (SLAM._grow); row ids are stable so existing entries carry over."""
        dK = n_keyframes - self.db.word_ids.shape[0]
        if dK <= 0:
            return
        S = self.db.max_words
        self.db = KeyFrameDB(
            word_ids=jnp.concatenate(
                [self.db.word_ids, jnp.full((dK, S), -1, jnp.int32)]
            ),
            weights=jnp.concatenate(
                [self.db.weights, jnp.zeros((dK, S), jnp.float32)]
            ),
        )

    # ------------------------------------------------------------------
    def add_keyframe_to_db(self, state: MapState, kf_id: int) -> None:
        from ..bow.keyframe_db import add_keyframe

        self.db = add_keyframe(
            self.db, self.vocab, kf_id,
            state.kf_desc[kf_id], state.kf_feat_valid[kf_id],
        )

    # ------------------------------------------------------------------
    def detect_async(self, state: MapState, kf_id: int):
        """DB registration + candidate query, dispatched WITHOUT a host
        fetch.  Returns the device-resident result to resolve later with
        ``detect_resolve`` (resolving on a later idle frame takes the fetch
        off the keyframe's critical path), or None when detection is suppressed
        (the keyframe is still registered in the database)."""
        self.db, out_dev = self._add_detect_prog(self.db, state, jnp.asarray(kf_id))
        if kf_id < 10 or kf_id - self.last_loop_kf < 10:
            # match the reference's early-out: no loops right after start or
            # a recent correction (LoopClosing.cc:222-231)
            return None
        # start the device→host copy NOW: by the time an idle frame resolves
        # the FIFO entry, the bytes are already local and np.asarray returns
        # without waiting on the transfer
        try:
            out_dev.copy_to_host_async()
        except AttributeError:  # backend without async transfers
            pass
        return out_dev

    def detect_frame_async(self, state: MapState, desc, valid, ref_kf: int):
        """Frame-level candidate query (starved-KF regime): dispatched
        without a host fetch, resolved later through the same pending FIFO
        and consistency chains as keyframe detections.  Returns None while
        the map is too young.  Post-closure suppression is FRAME-based and
        handled by the caller (SLAM._want_frame_loop_query): the reference's
        10-keyframe window (LoopClosing.cc:222-231) never expires in the
        starved regime this path exists for — 15 KFs can be a whole run."""
        if ref_kf < 10:
            return None
        out_dev = self._frame_detect_prog(
            self.db, state, desc, valid, jnp.asarray(ref_kf)
        )
        try:
            out_dev.copy_to_host_async()
        except AttributeError:
            pass
        return out_dev

    def detect(self, state: MapState, kf_id: int) -> Optional[int]:
        """DB registration + consistency-chained loop detection
        (LoopClosing::insertKeyFrame + detectLoop, LoopClosing.cc:218-282),
        one dispatch + at most one fetch per keyframe."""
        out_dev = self.detect_async(state, kf_id)
        if out_dev is None:
            return None
        return self.detect_resolve(kf_id, out_dev)

    def detect_resolve(self, kf_id: int, out_dev,
                       kf_window: bool = True) -> Optional[int]:
        """Host half of detection: fetch the candidate rows and run the
        covisibility-consistency chains (LoopClosing.cc:218-282).
        ``kf_window=False`` for frame-level queries, whose post-closure
        suppression is frame-based at the dispatch site."""
        if kf_window and kf_id - self.last_loop_kf < 10:
            return None  # a closure landed between dispatch and resolve
        out = np.asarray(out_dev)
        cand_all, covis_rows = out[:, 0], out[:, 1:]   # one host fetch total
        keep = cand_all >= 0
        cand_ids = [int(c) for c in cand_all[keep]]
        covis_rows = covis_rows[keep]
        if not cand_ids:
            self.consistent_groups = []
            return None

        th = self.cfg.loop.consistency_th
        new_groups: List[Tuple[Set[int], int]] = []
        enough: List[int] = []
        for ci, c in enumerate(cand_ids):
            group = set(np.nonzero(covis_rows[ci] >= self.cfg.mapping.min_covis_weight)[0].tolist())
            group.add(c)
            best = 0
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    best = max(best, count + 1)
            new_groups.append((group, best))
            if best + 1 >= th:
                enough.append(c)
        self.consistent_groups = new_groups
        return enough[0] if enough else None

    # ------------------------------------------------------------------
    def compute_sim3(
        self, state: MapState, cam: CameraParams, kf_cur: int, kf_cand: int, key
    ):
        """The full Sim3 verification cascade (LoopClosing.cc:300-415):
        descriptor match ≥20 → Sim3 RANSAC → searchBySim3 expansion ≥50 →
        OptimizeSim3 >50 inliers → loop-group projection ≥40.

        Returns (S12, matched_mp, group) with S12 mapping cand-cam → cur-cam,
        ``matched_mp`` the per-current-feature loop map point, and ``group``
        the loop-group snapshot for the correction fuse — or None."""
        lc = self.cfg.loop
        # stage A: descriptor match + Sim3 RANSAC (one dispatch, one fetch)
        S12, ok, bj, gates_a = self._sim3_a(state, cam, kf_cur, kf_cand, key)
        n_matches, n_in, _ = np.asarray(gates_a).tolist()
        if n_matches < lc.min_bow_matches or n_in < lc.min_sim3_inliers:
            return None

        # stage B: searchBySim3 expansion ≥50 + OptimizeSim3 ≥50
        # (LoopClosing.cc:367-369, :404-408)
        S12, matched_mp, gates_b = self._sim3_b(state, cam, kf_cur, kf_cand, S12, ok, bj)
        n_exp, n_in2, _ = np.asarray(gates_b).tolist()
        if n_exp < lc.min_expanded_matches or n_in2 < lc.min_sim3_opt_inliers:
            return None

        # stage C: loop-group projection check ≥40 (LoopClosing.cc:410-412):
        # matched table seeded from the optimizer's inliers, then expanded by
        # projecting the whole loop group through Scw = S12 ∘ S_cand_w
        matched_mp, group, gates_c = self._sim3_c(state, cam, kf_cur, kf_cand, S12, matched_mp)
        if int(np.asarray(gates_c)[0]) < lc.min_group_proj_matches:
            return None
        return S12, matched_mp, group

    # ------------------------------------------------------------------
    # Deferred cascade: the reference runs the whole Sim3 verification on
    # its LoopClosing THREAD (LoopClosing.cc:53-90), so tracking never
    # blocks on it.  Here the equivalent is a state machine over idle
    # frames: each stage is dispatched async (gates copy_to_host_async'd at
    # dispatch), and the NEXT idle frame reads the gates for free and
    # dispatches the following stage.  A full attempt spans ≤3 idle frames;
    # a stage-A rejection (the overwhelmingly common case) costs zero
    # blocking time on any frame.
    def sim3_begin(self, state: MapState, cam: CameraParams,
                   kf_cur: int, kf_cand: int) -> None:
        """Dispatch stage A of the verification cascade without a fetch.
        A cascade already in flight keeps priority — the new candidate is
        dropped (the reference's queue back-pressure does the same; the
        next keyframe re-detects)."""
        if self.pending_sim3 is not None:
            return
        key = jax.random.PRNGKey(kf_cur)
        S12, ok, bj, gates = self._sim3_a(state, cam, kf_cur, kf_cand, key)
        _copy_async(gates)
        self.pending_sim3 = dict(stage="a", kf_cur=kf_cur, kf_cand=kf_cand,
                                 S12=S12, ok=ok, bj=bj, gates=gates)

    def sim3_step(self, state: MapState, cam: CameraParams):
        """Advance the pending cascade one stage (call on idle frames).
        Returns None while in flight or on rejection, or the verified
        ``(kf_cur, kf_cand, S12, matched_mp, group)`` on success."""
        p = self.pending_sim3
        if p is None:
            return None
        lc = self.cfg.loop
        g = np.asarray(p["gates"]).tolist()
        kf_cur, kf_cand = p["kf_cur"], p["kf_cand"]
        if p["stage"] == "a":
            n_matches, n_in, valid = g
            if (not valid or n_matches < lc.min_bow_matches
                    or n_in < lc.min_sim3_inliers):
                self.pending_sim3 = None
                return None
            S12, matched_mp, gates = self._sim3_b(
                state, cam, kf_cur, kf_cand, p["S12"], p["ok"], p["bj"]
            )
            _copy_async(gates)
            self.pending_sim3 = dict(stage="b", kf_cur=kf_cur, kf_cand=kf_cand,
                                     S12=S12, matched_mp=matched_mp, gates=gates)
            return None
        if p["stage"] == "b":
            n_exp, n_in2, valid = g
            if (not valid or n_exp < lc.min_expanded_matches
                    or n_in2 < lc.min_sim3_opt_inliers):
                self.pending_sim3 = None
                return None
            matched_mp, group, gates = self._sim3_c(
                state, cam, kf_cur, kf_cand, p["S12"], p["matched_mp"]
            )
            _copy_async(gates)
            self.pending_sim3 = dict(stage="c", kf_cur=kf_cur, kf_cand=kf_cand,
                                     S12=p["S12"], matched_mp=matched_mp,
                                     group=group, gates=gates)
            return None
        # stage C gates
        n_total, valid = g
        self.pending_sim3 = None
        if not valid or n_total < lc.min_group_proj_matches:
            return None
        return kf_cur, kf_cand, p["S12"], p["matched_mp"], p["group"]

    # ------------------------------------------------------------------
    def warmup(self, state: MapState, cam: CameraParams, mesh=None) -> None:
        """Pre-compile the detection + verification + correction programs on
        dummy inputs so a mid-run first loop attempt doesn't stall tracking
        for the compile (measured: ~45 s for stage A alone).  With the
        persistent compile cache this costs seconds after the first-ever run
        — the reference analogously eats minutes loading ORBvoc at startup
        (System.cc:92-95)."""
        kf0 = jnp.asarray(0)
        self.db, out = self._add_detect_prog(self.db, state, kf0)
        key = jax.random.PRNGKey(0)
        S12, ok, bj, _ = self._sim3_a(state, cam, kf0, kf0, key)
        S12, matched_mp, _ = self._sim3_b(state, cam, kf0, kf0, S12, ok, bj)
        matched_mp2, group, _ = self._sim3_c(state, cam, kf0, kf0, S12, matched_mp)
        # correction path (group propagation, fuse passes, essential graph,
        # global BA): run once with an identity constraint and DISCARD the
        # result — none of these programs donate their inputs, so the live
        # state is untouched and the first real loop closure pays no compile
        saved = (self.last_loop_kf, self.consistent_groups)
        ident = sim3.Sim3(
            R=jnp.eye(3, dtype=jnp.float32),
            t=jnp.zeros(3, jnp.float32),
            s=jnp.asarray(1.0, jnp.float32),
        )
        self.correct(state, cam, 0, 0, ident, matched_mp2, group,
                     run_gba=False, mesh=mesh)
        self.last_loop_kf, self.consistent_groups = saved

    # ------------------------------------------------------------------
    def correct(
        self,
        state: MapState,
        cam: CameraParams,
        kf_cur: int,
        kf_cand: int,
        S12: sim3.Sim3,
        matched_mp: jnp.ndarray,
        group: LocalMap,
        *,
        run_gba: bool = True,
        mesh=None,
    ) -> MapState:
        """Loop correction: group pose/point propagation, matched-MP fuse,
        loop-group fuse into the current neighbourhood, essential-graph
        optimization, global BA (LoopClosing.cc:432-541)."""
        mw = self.cfg.mapping.min_covis_weight
        pre_conn = state.covis > 0

        state, S_nc, group_mask = correct_group(
            state, kf_cur, kf_cand, S12, min_covis_weight=mw,
        )
        # fuse pass A: Sim3-matched loop points into the current keyframe
        state = self._attach(state, kf_cur, matched_mp)
        # fuse pass B: the loop group's points into the current covis group
        # (top neighbours by weight; reference iterates all connected KFs)
        w = np.asarray(state.covis[kf_cur])
        ids = np.argsort(-w)[:16]
        ids = ids[w[ids] >= mw]
        kf_ids = jnp.asarray(
            np.pad(ids.astype(np.int32), (0, 16 - len(ids)), constant_values=-1)
        )
        state = self._fuse_group(state, cam, group, kf_ids)

        if mesh is not None:
            # edge-sharded pose-graph PCG: the whole closure rides the mesh
            # (pose_graph._gn_step_pcg_sharded; SURVEY §5.8)
            if self._essential_mesh is None:
                self._essential_mesh = jax.jit(partial(
                    optimize_essential,
                    essential_weight=self.cfg.loop.essential_graph_weight,
                    pose_graph_fn=partial(
                        optimize_pose_graph, iters=20, mesh=mesh,
                        mesh_axis=self.cfg.dist.mesh_axis),
                ))
            ess = self._essential_mesh
        else:
            ess = self._essential
        state = ess(
            state, jnp.asarray(kf_cur), jnp.asarray(kf_cand), S12, S_nc,
            group_mask, pre_conn,
        )
        if run_gba:
            state = global_ba(
                state, cam, scale_factor=self.cfg.orb.scale_factor,
                phase_iters=tuple(self.cfg.loop.global_ba_phase_iters),
                pcg_iters=self.cfg.ba.pcg_iters, mesh=mesh,
            )
        self.last_loop_kf = kf_cur
        self.consistent_groups = []
        return state


@partial(jax.jit, static_argnames=("min_covis_weight",))
def correct_group(
    state: MapState,
    kf_cur,
    kf_cand,
    S12: sim3.Sim3,
    *,
    min_covis_weight: int,
) -> Tuple[MapState, sim3.Sim3, jnp.ndarray]:
    """Pose/point correction of the current covisibility group.

    The corrected pose of the current keyframe is S_cw^corr = S12 ∘ T_cand_w
    composed with scale-aware algebra (LoopClosing.cc:458-513); the current
    covisibility group is dragged along via its relative poses, and every map
    point observed by the group is remapped via S_new_wc ∘ S_old_cw.

    Returns (state, S_nc, group_mask) where ``S_nc`` holds the NON-corrected
    Sim3 poses of every keyframe (the reference's NonCorrectedSim3 — the
    essential graph measures its drift edges from these).
    """
    K = state.kf_capacity

    # --- corrected Sim3 pose of the current KF ---------------------------
    S_cand = sim3.from_se3(state.kf_Tcw[kf_cand])
    S_cw_corr = sim3.compose(S12, S_cand)          # world → cur (corrected)
    S_cw_old = sim3.from_se3(state.kf_Tcw[kf_cur])

    # --- current covisibility group --------------------------------------
    group_mask = (state.covis[kf_cur] >= min_covis_weight) & state.kf_valid
    group_mask = group_mask.at[kf_cur].set(True)

    # per-group-KF: S_iw_corr = (S_i_old ∘ S_cur_old⁻¹) ∘ S_cw_corr
    S_all = sim3.from_se3(state.kf_Tcw)            # [K]
    S_rel = sim3.compose(S_all, sim3.inverse(S_cw_old))  # S_i←cur (old chain)
    S_corr = sim3.compose(S_rel, S_cw_corr)        # corrected world→i
    kf_Tcw_new = jnp.where(
        group_mask[:, None, None], sim3.to_se3(S_corr), state.kf_Tcw
    )

    # --- correct map points observed by the group -------------------------
    # p_new = S_iw_corr⁻¹ ∘ S_iw_old ∘ p  for the group member that owns it
    obs0_kf = jnp.clip(state.mp_obs_kf[:, 0], 0, K - 1)   # reference observer
    owner_in_group = group_mask[obs0_kf] & state.mp_valid
    S_old_o = jax.tree.map(lambda a: a[obs0_kf], S_all)
    S_corr_o = jax.tree.map(lambda a: a[obs0_kf], S_corr)
    p_cam = sim3.apply(S_old_o, state.mp_pos)
    p_new = sim3.apply(sim3.inverse(S_corr_o), p_cam)
    mp_pos_new = jnp.where(owner_in_group[:, None], p_new, state.mp_pos)

    state = state._replace(kf_Tcw=kf_Tcw_new, mp_pos=mp_pos_new)

    # --- record the loop edge ---------------------------------------------
    free_slots = state.loop_edges[:, 0] < 0
    # guard full list: when no slot is free, drop the edge instead of
    # overwriting slot 0 (argmax of all-False is 0)
    slot = jnp.where(jnp.any(free_slots), jnp.argmax(free_slots), state.loop_edges.shape[0])
    loop_edges = state.loop_edges.at[slot].set(
        jnp.stack([jnp.asarray(kf_cur), jnp.asarray(kf_cand)]), mode="drop"
    )
    state = state._replace(loop_edges=loop_edges)
    return state, S_all, group_mask


def optimize_essential(
    state: MapState,
    kf_cur,
    kf_cand,
    S12: sim3.Sim3,
    S_nc: sim3.Sim3,
    group_mask: jnp.ndarray,
    pre_conn: jnp.ndarray,
    *,
    essential_weight: int,
    pose_graph_fn,
    max_edges: int = 8192,
    max_new_conn: int = 256,
) -> MapState:
    """Essential-graph optimization after correction + fuse.

    Drift edges (spanning tree ∪ loop edges ∪ covis ≥ 100) are measured from
    the PRE-correction poses ``S_nc`` — the reference's NonCorrectedSim3
    (Optimizer.cc:836-877); measuring from the corrected poses would make
    every residual identically zero and the optimization a no-op.  The NEW
    cross-loop connections created by the fuse (not connected before the
    correction, weight ≥ 100 now) are measured from the corrected vertex
    poses (Optimizer.cc:804-833) so they hold the loop closed while the
    drift relaxes through the rest of the graph.
    """
    K = state.kf_capacity

    S_now = sim3.from_se3(state.kf_Tcw)            # corrected vertex init
    # edge budget scales with the (possibly auto-grown) capacity: the spanning
    # tree alone is K slots, so a fixed budget would go negative at large K
    budget = max(max_edges - max_new_conn,
                 K + state.loop_edges.shape[0] + 1 + 256)
    ei, ej, ew = collect_essential_edges(state, essential_weight, budget)
    # the slot collect_essential_edges RESERVED (the last of its own block)
    n_collect = ei.shape[0]
    S_meas = make_relative_measurements(S_nc, jnp.maximum(ei, 0), jnp.maximum(ej, 0))

    # --- new loop connections: group KF ↔ outside, unconnected pre-fuse ----
    new_mask = (
        group_mask[:, None] & ~group_mask[None, :] & ~pre_conn
        & (state.covis >= essential_weight)
        & state.kf_valid[:, None] & state.kf_valid[None, :]
    )
    flat_w = jnp.where(new_mask, state.covis, 0).reshape(-1)
    topw, topi = topk_bounded(flat_w, max_new_conn)
    ni = jnp.where(topw > 0, topi // K, -1)
    nj = jnp.where(topw > 0, topi % K, -1)
    S_meas_new = make_relative_measurements(S_now, jnp.maximum(ni, 0), jnp.maximum(nj, 0))

    ei = jnp.concatenate([ei, ni])
    ej = jnp.concatenate([ej, nj])
    ew = jnp.concatenate([ew, jnp.ones_like(ni, jnp.float32)])
    S_meas = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b]), S_meas, S_meas_new
    )

    # the loop edge gets its measured constraint S12: S_cur←cand, written at
    # the slot collect_essential_edges RESERVED (the last slot of its own
    # block, measured from the ACTUAL block length — small graphs return fewer
    # than the budget) — writing at -1 would clobber the weakest
    # new-connection slot above when all max_new_conn slots are in use
    res = n_collect - 1
    ei = ei.at[res].set(kf_cand)
    ej = ej.at[res].set(kf_cur)
    S_meas = sim3.Sim3(
        R=S_meas.R.at[res].set(S12.R),
        t=S_meas.t.at[res].set(S12.t),
        s=S_meas.s.at[res].set(S12.s),
    )
    ew = ew.at[res].set(1.0)
    valid_e = (ei >= 0) & (ej >= 0)
    fixed = jnp.zeros((K,), bool).at[kf_cand].set(True) | ~state.kf_valid
    prob = PoseGraphProblem(
        S_cw=S_now, kf_valid=state.kf_valid, kf_fixed=fixed,
        edge_i=jnp.maximum(ei, 0), edge_j=jnp.maximum(ej, 0),
        edge_Sji=S_meas, edge_valid=valid_e, edge_weight=ew,
    )
    S_opt = pose_graph_fn(prob)

    # commit: poses back to SE3 (divide translation by scale), points corrected
    # via S_wc_new ∘ S_cw_old (Optimizer.cc:898-918)
    obs0_kf2 = jnp.clip(state.mp_obs_kf[:, 0], 0, K - 1)
    S_old_o2 = jax.tree.map(lambda a: a[obs0_kf2], S_now)
    S_new_o2 = jax.tree.map(lambda a: a[obs0_kf2], S_opt)
    p_cam2 = sim3.apply(S_old_o2, state.mp_pos)
    p_new2 = sim3.apply(sim3.inverse(S_new_o2), p_cam2)
    mp_pos2 = jnp.where(state.mp_valid[:, None], p_new2, state.mp_pos)
    kf_Tcw2 = jnp.where(state.kf_valid[:, None, None], sim3.to_se3(S_opt), state.kf_Tcw)
    return state._replace(kf_Tcw=kf_Tcw2, mp_pos=mp_pos2)


def collect_essential_edges(state: MapState, essential_weight: int, max_edges: int):
    """Essential-graph edge set: spanning tree ∪ loop edges ∪ covis ≥ 100
    (reference Optimizer.cc:790-877).  Returns padded (ei, ej, weight); the
    LAST slot is reserved for the new loop constraint."""
    K = state.kf_capacity
    # spanning tree
    child = jnp.arange(K)
    parent = state.kf_parent
    tree_ok = (parent >= 0) & state.kf_valid

    # strong covisibility (upper triangle)
    iu = jnp.triu_indices(K, k=1)
    w = state.covis[iu]
    covis_ok = (w >= essential_weight) & state.kf_valid[iu[0]] & state.kf_valid[iu[1]]

    # bounded compaction: tree edges first, then strongest covis (clamped: at
    # grown capacities the tree alone can exceed a stale budget)
    score = jnp.where(covis_ok, w, 0)
    n_covis = max(0, min(max_edges - K - state.loop_edges.shape[0] - 1, int(score.shape[0])))
    topw, topi = topk_bounded(score, n_covis) if n_covis else (score[:0], score[:0].astype(jnp.int32))
    cov_i = jnp.where(topw > 0, iu[0][topi], -1)
    cov_j = jnp.where(topw > 0, iu[1][topi], -1)

    le = state.loop_edges
    le_ok = (
        (le[:, 0] >= 0)
        & state.kf_valid[jnp.clip(le[:, 0], 0, K - 1)]
        & state.kf_valid[jnp.clip(le[:, 1], 0, K - 1)]
    )

    ei = jnp.concatenate([
        jnp.where(tree_ok, parent, -1),
        cov_i,
        jnp.where(le_ok, le[:, 0], -1),
        jnp.asarray([-1]),
    ])
    ej = jnp.concatenate([
        jnp.where(tree_ok, child, -1),
        cov_j,
        jnp.where(le_ok, le[:, 1], -1),
        jnp.asarray([-1]),
    ])
    ew = jnp.ones_like(ei, jnp.float32)
    return ei, ej, ew
