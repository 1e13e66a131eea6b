"""Device-resident SLAM map: fixed-capacity struct-of-arrays pytrees.

The reference's map is a pointer web — KeyFrame/MapPoint objects with
observation maps, covisibility dictionaries, spanning-tree pointers and ~20
mutexes (reference: src/KeyFrame.cc, src/MapPoint.cc, src/Map.cc; SURVEY.md
§5.2).  This design replaces all of it with padded arrays updated
functionally inside jit:

- KeyFrame store: poses + full per-KF feature tables ``[K, N]``;
- the observation graph IS the table ``kf_mp_idx[K, N]`` (map-point id per
  feature slot, −1 = none) — the reference's per-MP observation map is a
  bounded reverse index ``mp_obs_kf/mp_obs_feat [M, O]`` maintained alongside;
- MapPoint store: position, view normal, distilled descriptor, scale range,
  tracking counters ``[M]``;
- covisibility: a dense int32 weight matrix ``[K, K]`` updated incrementally
  per insertion (shared-map-point counts, reference KeyFrame.cc:54-112);
- spanning tree: parent id per KF (reference KeyFrame.h:180-193).

Slot allocation is a monotone bump pointer + validity masks; erased slots are
masked, not compacted (XLA static shapes).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import SLAMConfig
from ..features.frame import StereoFrame
from ..geometry import se3
from ..ops.hamming import hamming_matrix


class MapState(NamedTuple):
    # --- keyframe store [K] ---
    kf_Tcw: jnp.ndarray        # f32[K, 4, 4]
    kf_valid: jnp.ndarray      # bool[K]
    kf_frame_id: jnp.ndarray   # i32[K] source frame index (timestamps)
    # per-KF feature tables [K, N]
    kf_uv: jnp.ndarray         # f32[K, N, 2]
    kf_right_u: jnp.ndarray    # f32[K, N]
    kf_depth: jnp.ndarray      # f32[K, N]
    kf_octave: jnp.ndarray     # i32[K, N]
    kf_angle: jnp.ndarray      # f32[K, N]
    kf_desc: jnp.ndarray       # u32[K, N, 8]
    kf_feat_valid: jnp.ndarray  # bool[K, N]
    kf_mp_idx: jnp.ndarray     # i32[K, N] map-point id per slot (−1 = none)
    # --- map point store [M] ---
    mp_pos: jnp.ndarray        # f32[M, 3]
    mp_normal: jnp.ndarray     # f32[M, 3]
    mp_desc: jnp.ndarray       # u32[M, 8]
    mp_min_dist: jnp.ndarray   # f32[M]
    mp_max_dist: jnp.ndarray   # f32[M]
    mp_valid: jnp.ndarray      # bool[M]
    mp_ref_kf: jnp.ndarray     # i32[M]
    mp_n_obs: jnp.ndarray      # i32[M]
    mp_visible: jnp.ndarray    # i32[M] tracking "visible" counter (culling)
    mp_found: jnp.ndarray      # i32[M] tracking "found/matched" counter
    mp_first_kf: jnp.ndarray   # i32[M] KF id at creation (culling window)
    # bounded reverse observation index [M, O]
    mp_obs_kf: jnp.ndarray     # i32[M, O] (−1 = empty)
    mp_obs_feat: jnp.ndarray   # i32[M, O]
    # --- graph ---
    covis: jnp.ndarray         # i32[K, K] shared-MP counts (0 on diagonal)
    kf_parent: jnp.ndarray     # i32[K] spanning-tree parent (−1 = root)
    # pose relative to the parent, frozen at CULL time (the reference's
    # KeyFrame::mTcp, KeyFrame.cc SetBadFlag): culled keyframes stop being
    # optimized, so the final-trajectory export walks culled references up
    # the tree composing these (System::SaveTrajectoryKITTI)
    kf_Tcp: jnp.ndarray        # f32[K, 4, 4] (identity until culled)
    # loop edges, bounded list of KF id pairs
    loop_edges: jnp.ndarray    # i32[E, 2] (−1 = empty)
    # --- allocation ---
    next_kf: jnp.ndarray       # i32[] bump pointer
    next_mp: jnp.ndarray       # i32[]

    @property
    def kf_capacity(self) -> int:
        return self.kf_Tcw.shape[0]

    @property
    def mp_capacity(self) -> int:
        return self.mp_pos.shape[0]


def grow_map(
    state: MapState,
    *,
    kf_capacity: int | None = None,
    mp_capacity: int | None = None,
) -> MapState:
    """Copy of ``state`` with enlarged capacities (map-length scaling, SURVEY
    §5.7).  The reference's pointer-web map grows implicitly; here the padded
    SoA stores are re-padded to the new capacity on the host — slot ids are
    stable so no relinking is needed, and every downstream jitted program
    simply recompiles once at the new shapes (capacities double, so the
    recompile bursts amortize; a persistent compile cache makes repeats free).
    New slots carry the same padding values as ``empty_map``."""
    K0, M0 = state.kf_capacity, state.mp_capacity
    K = kf_capacity if kf_capacity is not None else K0
    M = mp_capacity if mp_capacity is not None else M0
    if K < K0 or M < M0:
        raise ValueError(f"capacities cannot shrink: {(K0, M0)} -> {(K, M)}")
    dK, dM = K - K0, M - M0
    if dK == 0 and dM == 0:
        return state

    def pad(a, n, fill, axis=0):
        if n == 0:
            return a
        shape = list(a.shape)
        shape[axis] = n
        return jnp.concatenate([a, jnp.full(shape, fill, a.dtype)], axis=axis)

    eye_pad = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (dK, 4, 4))
    return state._replace(
        kf_Tcw=jnp.concatenate([state.kf_Tcw, eye_pad]) if dK else state.kf_Tcw,
        kf_valid=pad(state.kf_valid, dK, False),
        kf_frame_id=pad(state.kf_frame_id, dK, -1),
        kf_uv=pad(state.kf_uv, dK, 0.0),
        kf_right_u=pad(state.kf_right_u, dK, -1.0),
        kf_depth=pad(state.kf_depth, dK, -1.0),
        kf_octave=pad(state.kf_octave, dK, 0),
        kf_angle=pad(state.kf_angle, dK, 0.0),
        kf_desc=pad(state.kf_desc, dK, 0),
        kf_feat_valid=pad(state.kf_feat_valid, dK, False),
        kf_mp_idx=pad(state.kf_mp_idx, dK, -1),
        mp_pos=pad(state.mp_pos, dM, 0.0),
        mp_normal=pad(state.mp_normal, dM, 0.0),
        mp_desc=pad(state.mp_desc, dM, 0),
        mp_min_dist=pad(state.mp_min_dist, dM, 0.0),
        mp_max_dist=pad(state.mp_max_dist, dM, 1e9),
        mp_valid=pad(state.mp_valid, dM, False),
        mp_ref_kf=pad(state.mp_ref_kf, dM, -1),
        mp_n_obs=pad(state.mp_n_obs, dM, 0),
        mp_visible=pad(state.mp_visible, dM, 1),
        mp_found=pad(state.mp_found, dM, 1),
        mp_first_kf=pad(state.mp_first_kf, dM, -1),
        mp_obs_kf=pad(state.mp_obs_kf, dM, -1),
        mp_obs_feat=pad(state.mp_obs_feat, dM, -1),
        covis=pad(pad(state.covis, dK, 0, axis=0), dK, 0, axis=1),
        kf_parent=pad(state.kf_parent, dK, -1),
        kf_Tcp=jnp.concatenate([state.kf_Tcp, eye_pad]) if dK else state.kf_Tcp,
    )


def empty_map(cfg: SLAMConfig) -> MapState:
    K = cfg.map.max_keyframes
    N = cfg.orb.max_keypoints
    M = cfg.map.max_mappoints
    O = cfg.map.max_obs_per_mp
    E = 64
    f32, i32, u32 = jnp.float32, jnp.int32, jnp.uint32
    return MapState(
        kf_Tcw=jnp.broadcast_to(jnp.eye(4, dtype=f32), (K, 4, 4)),
        kf_valid=jnp.zeros(K, bool),
        kf_frame_id=jnp.full((K,), -1, i32),
        kf_uv=jnp.zeros((K, N, 2), f32),
        kf_right_u=jnp.full((K, N), -1.0, f32),
        kf_depth=jnp.full((K, N), -1.0, f32),
        kf_octave=jnp.zeros((K, N), i32),
        kf_angle=jnp.zeros((K, N), f32),
        kf_desc=jnp.zeros((K, N, 8), u32),
        kf_feat_valid=jnp.zeros((K, N), bool),
        kf_mp_idx=jnp.full((K, N), -1, i32),
        mp_pos=jnp.zeros((M, 3), f32),
        mp_normal=jnp.zeros((M, 3), f32),
        mp_desc=jnp.zeros((M, 8), u32),
        mp_min_dist=jnp.zeros(M, f32),
        mp_max_dist=jnp.full((M,), 1e9, f32),
        mp_valid=jnp.zeros(M, bool),
        mp_ref_kf=jnp.full((M,), -1, i32),
        mp_n_obs=jnp.zeros(M, i32),
        mp_visible=jnp.ones(M, i32),
        mp_found=jnp.ones(M, i32),
        mp_first_kf=jnp.full((M,), -1, i32),
        mp_obs_kf=jnp.full((M, O), -1, i32),
        mp_obs_feat=jnp.full((M, O), -1, i32),
        covis=jnp.zeros((K, K), i32),
        kf_parent=jnp.full((K,), -1, i32),
        kf_Tcp=jnp.broadcast_to(jnp.eye(4, dtype=f32), (K, 4, 4)),
        loop_edges=jnp.full((E, 2), -1, i32),
        next_kf=jnp.asarray(0, i32),
        next_mp=jnp.asarray(0, i32),
    )


# --------------------------------------------------------------------------
# observation bookkeeping helpers
# --------------------------------------------------------------------------

def _append_observations(state: MapState, kf_id, mp_ids: jnp.ndarray, feat_ids: jnp.ndarray, mask: jnp.ndarray) -> MapState:
    """Append (kf_id, feat) to each map point's bounded observation list.

    ``mp_ids/feat_ids/mask [B]``.  Entries beyond the per-MP capacity O are
    dropped (the covisibility matrix still counts them).
    """
    O = state.mp_obs_kf.shape[1]
    raw_slot = state.mp_n_obs[jnp.clip(mp_ids, 0, state.mp_capacity - 1)]
    # a full fan-out list (slot ≥ O) really drops the new observation — never
    # overwrite the last entry, and never count past O (culling/fuse read
    # mp_n_obs as a true list length)
    ok = mask & (raw_slot < O)
    m = jnp.where(ok, mp_ids, state.mp_capacity)  # invalid/full → scratch row
    slot = jnp.clip(raw_slot, 0, O - 1)
    obs_kf = state.mp_obs_kf.at[m, slot].set(
        jnp.where(ok, kf_id, -1), mode="drop"
    )
    obs_feat = state.mp_obs_feat.at[m, slot].set(
        jnp.where(ok, feat_ids, -1), mode="drop"
    )
    n_obs = state.mp_n_obs.at[m].add(jnp.where(ok, 1, 0), mode="drop")
    return state._replace(mp_obs_kf=obs_kf, mp_obs_feat=obs_feat, mp_n_obs=n_obs)


def merge_mappoints(state: MapState, winner: jnp.ndarray, loser: jnp.ndarray, mask: jnp.ndarray) -> MapState:
    """Batched MapPoint::replace (reference MapPoint.cc:213-233): the loser's
    keyframe slots are repointed to the winner, its observations transferred
    into the winner's bounded list (entries in keyframes the winner already
    observes are dropped, mirroring the isInKeyFrame skip at MapPoint.cc:223),
    the loser is invalidated and cleared, and the winner inherits the loser's
    tracking counters (updateTrackParam).  Observations past the winner's list
    capacity are dropped (the repointed kf_mp_idx slots still count toward
    covisibility recounts of those keyframes' own rows).

    ``winner/loser [B]`` map-point ids, ``mask [B]`` selects live merges.
    Rows where winner == loser or mask is False are no-ops.  Duplicate
    winners across rows write overlapping list slots (last write wins) —
    acceptable for the rare many-into-one merge.
    """
    K = state.kf_capacity
    M = state.mp_capacity
    N = state.kf_uv.shape[1]
    O = state.mp_obs_kf.shape[1]
    live = mask & (winner != loser) & (winner >= 0) & (loser >= 0)
    # one merge per loser: a loser appearing in several rows would transfer
    # its observation list to EVERY winner while each keyframe slot repoints
    # to only one — keep the first row, drop the rest
    B = winner.shape[0]
    row_ids = jnp.arange(B)
    first_row = jnp.full((M + 1,), B, jnp.int32).at[
        jnp.where(live, loser, M)
    ].min(row_ids, mode="drop")
    live = live & (first_row[jnp.clip(loser, 0, M - 1)] == row_ids)
    lid = jnp.where(live, loser, M)
    lcl = jnp.clip(lid, 0, M - 1)
    wcl = jnp.clip(jnp.where(live, winner, M), 0, M - 1)
    lo_kf = jnp.where(live[:, None], state.mp_obs_kf[lcl], -1)   # [B, O]
    lo_feat = state.mp_obs_feat[lcl]
    wo_kf = state.mp_obs_kf[wcl]                                 # [B, O]

    # duplicate check: does the winner already observe this keyframe?
    dup = jnp.any(
        (lo_kf[:, :, None] == wo_kf[:, None, :]) & (wo_kf[:, None, :] >= 0), axis=-1
    )
    valid_o = lo_kf >= 0
    transfer = valid_o & ~dup

    # repoint non-duplicate slots to the winner; clear duplicate slots
    winner_b = jnp.broadcast_to(winner[:, None], lo_kf.shape)
    new_slot_val = jnp.where(transfer, winner_b, -1)
    flat_kf = jnp.where(valid_o, lo_kf, K).reshape(-1)
    flat_feat = jnp.clip(lo_feat, 0, N - 1).reshape(-1)
    kf_mp_idx = state.kf_mp_idx.at[flat_kf, flat_feat].set(
        new_slot_val.reshape(-1), mode="drop"
    )

    # append transferred observations to the winner's list
    n_w = state.mp_n_obs[wcl]                                     # [B]
    pos = jnp.cumsum(transfer.astype(jnp.int32), axis=1) - 1      # [B, O]
    slot = n_w[:, None] + pos
    keep = transfer & (slot < O)
    w_idx = jnp.where(keep, winner_b, M)
    s_idx = jnp.clip(slot, 0, O - 1)
    mp_obs_kf = state.mp_obs_kf.at[w_idx, s_idx].set(
        jnp.where(keep, lo_kf, -1), mode="drop"
    )
    mp_obs_feat = state.mp_obs_feat.at[w_idx, s_idx].set(
        jnp.where(keep, lo_feat, -1), mode="drop"
    )
    wid = jnp.where(live, winner, M)
    mp_n_obs = state.mp_n_obs.at[wid].add(
        jnp.sum(keep.astype(jnp.int32), axis=1), mode="drop"
    )

    # clear + invalidate the loser
    mp_obs_kf = mp_obs_kf.at[lid].set(-1, mode="drop")
    mp_obs_feat = mp_obs_feat.at[lid].set(-1, mode="drop")
    mp_n_obs = mp_n_obs.at[lid].set(0, mode="drop")
    mp_valid = state.mp_valid.at[lid].set(False, mode="drop")
    mp_visible = state.mp_visible.at[wid].add(state.mp_visible[lcl], mode="drop")
    mp_found = state.mp_found.at[wid].add(state.mp_found[lcl], mode="drop")
    return state._replace(
        kf_mp_idx=kf_mp_idx, mp_valid=mp_valid,
        mp_obs_kf=mp_obs_kf, mp_obs_feat=mp_obs_feat, mp_n_obs=mp_n_obs,
        mp_visible=mp_visible, mp_found=mp_found,
    )


def _distill_descriptors(state: MapState, mp_ids: jnp.ndarray) -> MapState:
    """Recompute the representative descriptor for the given map points:
    the observation descriptor with minimal median hamming distance to the
    others (reference MapPoint::updateDescriptor, MapPoint.cc:336-369).

    ``mp_ids [B]`` may contain duplicates / −1 (ignored via clamping).
    """
    O = state.mp_obs_kf.shape[1]
    ids = jnp.clip(mp_ids, 0, state.mp_capacity - 1)
    obs_kf = state.mp_obs_kf[ids]      # [B, O]
    obs_feat = state.mp_obs_feat[ids]  # [B, O]
    ok = obs_kf >= 0
    descs = state.kf_desc[jnp.clip(obs_kf, 0, state.kf_capacity - 1),
                          jnp.clip(obs_feat, 0, state.kf_desc.shape[1] - 1)]  # [B, O, 8]

    def per_mp(desc_set, okm):
        D = hamming_matrix(desc_set, desc_set)  # [O, O]
        D = jnp.where(okm[None, :], D, 0)
        n = jnp.maximum(jnp.sum(okm), 1)
        # median over valid columns ≈ sorted value at n//2 (invalid cols sorted
        # to front as 0; shift index by number of invalid)
        Ds = jnp.sort(jnp.where(okm[None, :], D, -1), axis=1)
        med_idx = (O - n) + n // 2
        med = Ds[:, jnp.clip(med_idx, 0, O - 1)]
        med = jnp.where(okm, med, jnp.iinfo(jnp.int32).max)
        best = jnp.argmin(med)
        return desc_set[best]

    new_desc = jax.vmap(per_mp)(descs, ok)
    valid = (mp_ids >= 0) & (jnp.sum(ok, axis=1) > 0)
    mp_desc = state.mp_desc.at[jnp.where(valid, mp_ids, state.mp_capacity)].set(new_desc, mode="drop")
    return state._replace(mp_desc=mp_desc)


def _update_normals_and_depth(state: MapState, mp_ids: jnp.ndarray, scale_factor: float, n_levels: int) -> MapState:
    """Mean viewing direction + scale-invariance distance range from the
    reference KF octave (reference MapPoint::updateNormalAndDepth,
    MapPoint.cc:71-90, 429-484)."""
    ids = jnp.clip(mp_ids, 0, state.mp_capacity - 1)
    obs_kf = state.mp_obs_kf[ids]  # [B, O]
    ok = obs_kf >= 0
    kfc = jnp.clip(obs_kf, 0, state.kf_capacity - 1)
    R = state.kf_Tcw[kfc][..., :3, :3]
    t = state.kf_Tcw[kfc][..., :3, 3]
    Twc_t = -jnp.einsum("...ji,...j->...i", R, t)  # [B, O, 3] camera centres
    pos = state.mp_pos[ids][:, None, :]  # [B, 1, 3]
    rays = pos - Twc_t
    norms = jnp.linalg.norm(rays, axis=-1)
    rays_u = rays / jnp.maximum(norms, 1e-9)[..., None]
    mean_dir = jnp.sum(jnp.where(ok[..., None], rays_u, 0.0), axis=1)
    mean_dir = mean_dir / jnp.maximum(jnp.linalg.norm(mean_dir, axis=-1, keepdims=True), 1e-9)

    # distance range from the reference KF (first observation)
    ref_kf = jnp.clip(state.mp_ref_kf[ids], 0, state.kf_capacity - 1)
    ref_feat_octave = jnp.zeros_like(ids)
    # locate the octave of the observation in the reference KF: use obs 0
    feat0 = jnp.clip(state.mp_obs_feat[ids][:, 0], 0, state.kf_octave.shape[1] - 1)
    kf0 = jnp.clip(state.mp_obs_kf[ids][:, 0], 0, state.kf_capacity - 1)
    octave0 = state.kf_octave[kf0, feat0]
    Tcw0 = state.kf_Tcw[kf0]
    centre0 = -jnp.einsum("bij,bj->bi", jnp.swapaxes(Tcw0[:, :3, :3], -1, -2), Tcw0[:, :3, 3])
    dist0 = jnp.linalg.norm(state.mp_pos[ids] - centre0, axis=-1)
    level_scale = jnp.power(jnp.float32(scale_factor), octave0.astype(jnp.float32))
    max_dist = dist0 * level_scale
    min_dist = max_dist / (scale_factor ** (n_levels - 1))

    valid = mp_ids >= 0
    tgt = jnp.where(valid, mp_ids, state.mp_capacity)
    return state._replace(
        mp_normal=state.mp_normal.at[tgt].set(mean_dir, mode="drop"),
        mp_max_dist=state.mp_max_dist.at[tgt].set(max_dist, mode="drop"),
        mp_min_dist=state.mp_min_dist.at[tgt].set(min_dist, mode="drop"),
    )


def _covis_row_for_kf(state: MapState, kf_id) -> jnp.ndarray:
    """Shared-map-point counts between ``kf_id`` and every other KF, computed
    from the reverse observation index of the KF's own map points
    (reference KeyFrame::updateConnections, KeyFrame.cc:54-112)."""
    K = state.kf_capacity
    mp = state.kf_mp_idx[kf_id]                      # [N]
    has = mp >= 0
    ids = jnp.clip(mp, 0, state.mp_capacity - 1)
    obs = state.mp_obs_kf[ids]                       # [N, O]
    ok = has[:, None] & (obs >= 0) & (obs != kf_id)
    flat = jnp.where(ok, obs, K)                     # overflow row dropped
    counts = jnp.zeros((K + 1,), jnp.int32).at[flat.reshape(-1)].add(1)
    return counts[:K]


# --------------------------------------------------------------------------
# keyframe insertion
# --------------------------------------------------------------------------

def insert_keyframe(
    state: MapState,
    frame: StereoFrame,
    Tcw: jnp.ndarray,
    tracked_mp: jnp.ndarray,
    frame_id,
    cam,
    *,
    depth_threshold: float,
    scale_factor: float,
    n_levels: int,
    min_covis_weight: int = 15,
    seed_floor: int = 100,
) -> Tuple[MapState, jnp.ndarray]:
    """Insert a keyframe (functional).  Mirrors Tracking::insertKeyFrame +
    LocalMapping::processNewKeyFrame (reference Tracking.cc:167-185,
    LocalMapping.cc:121-148):

    1. copy the frame's feature table into the KF store;
    2. attach tracked map points (``tracked_mp[n]`` = MP id from local-map
       tracking, −1 otherwise) as observations;
    3. create NEW map points from stereo depth for close (< depth_threshold)
       unmatched features (reference Tracking.cc:754-789 close-point logic);
    4. refresh distilled descriptors / normals / distance ranges of every
       touched map point;
    5. update the covisibility row and spanning-tree parent.

    Returns (new_state, kf_id).
    """
    k = state.next_kf
    N = frame.feats.capacity

    st = state._replace(
        kf_Tcw=state.kf_Tcw.at[k].set(Tcw),
        kf_valid=state.kf_valid.at[k].set(True),
        kf_frame_id=state.kf_frame_id.at[k].set(frame_id),
        kf_uv=state.kf_uv.at[k].set(frame.feats.uv),
        kf_right_u=state.kf_right_u.at[k].set(frame.right_u),
        kf_depth=state.kf_depth.at[k].set(frame.depth),
        kf_octave=state.kf_octave.at[k].set(frame.feats.octave),
        kf_angle=state.kf_angle.at[k].set(frame.feats.angle),
        kf_desc=state.kf_desc.at[k].set(frame.feats.desc),
        kf_feat_valid=state.kf_feat_valid.at[k].set(frame.feats.valid),
        next_kf=state.next_kf + 1,
    )

    # -- 2. attach tracked map points --------------------------------------
    feat_ids = jnp.arange(N, dtype=jnp.int32)
    tracked_ok = (tracked_mp >= 0) & frame.feats.valid
    tracked_ok = tracked_ok & st.mp_valid[jnp.clip(tracked_mp, 0, st.mp_capacity - 1)]
    st = st._replace(kf_mp_idx=st.kf_mp_idx.at[k].set(jnp.where(tracked_ok, tracked_mp, -1)))
    st = _append_observations(st, k, tracked_mp, feat_ids, tracked_ok)

    # -- 3. create new map points from stereo depth -------------------------
    # original ORB-SLAM2 CreateNewKeyFrame policy (ORB_SLAM2 Tracking.cc,
    # CreateNewKeyFrame): seed CLOSE features (depth < baseline·ThDepth)
    # always, and top up with the NEAREST far features to a floor of
    # ``seed_floor`` points when close features run short.  THIS reference
    # seeds every valid-depth feature instead (Frame::unProject,
    # Frame.cc:179-202) — deliberate deviation back to the original:
    # measured on the full-size circle world, ~13% of far stereo matches
    # carry >10% depth error (block-texture aliasing, biased toward
    # over-disparity because the du>0 mask removes the opposite alias), and
    # all-depth seeding floods the local map with them whenever the view
    # opens up, driving multi-degree per-frame yaw slips.  Far structure
    # enters through multi-view triangulation instead, whose two-view
    # reprojection gates alias-check it (mapping.triangulate_new_points).
    seedable = frame.feats.valid & (frame.depth > 0) & (~tracked_ok)
    is_close = seedable & (frame.depth < depth_threshold)
    n_close = jnp.sum(is_close.astype(jnp.int32))
    need_far = jnp.maximum(seed_floor - n_close, 0)
    far_depth = jnp.where(seedable & ~is_close, frame.depth, jnp.inf)
    far_rank = jnp.argsort(jnp.argsort(far_depth))  # rank by nearness
    close = is_close | (jnp.isfinite(far_depth) & (far_rank < need_far))
    n_new = jnp.cumsum(close.astype(jnp.int32)) - 1
    new_ids = jnp.where(close, state.next_mp + n_new, -1)
    cap_ok = new_ids < st.mp_capacity
    close = close & cap_ok
    new_ids = jnp.where(close, new_ids, -1)

    from ..geometry.camera import unproject as cam_unproject  # local import to avoid cycle

    depth = jnp.where(close, frame.depth, 1.0)
    pc = cam_unproject(cam, frame.feats.uv, depth)
    Twc = se3.inverse(Tcw)
    pw = se3.apply(Twc, pc)
    centre = se3.t_of(Twc)
    normal0 = pw - centre
    normal0 = normal0 / jnp.maximum(jnp.linalg.norm(normal0, axis=-1, keepdims=True), 1e-9)

    tgt = jnp.where(close, new_ids, st.mp_capacity)
    st = st._replace(
        mp_pos=st.mp_pos.at[tgt].set(pw, mode="drop"),
        mp_normal=st.mp_normal.at[tgt].set(normal0, mode="drop"),
        mp_valid=st.mp_valid.at[tgt].set(True, mode="drop"),
        mp_ref_kf=st.mp_ref_kf.at[tgt].set(k, mode="drop"),
        mp_first_kf=st.mp_first_kf.at[tgt].set(k, mode="drop"),
        mp_desc=st.mp_desc.at[tgt].set(frame.feats.desc, mode="drop"),
        mp_n_obs=st.mp_n_obs.at[tgt].set(0, mode="drop"),
        mp_visible=st.mp_visible.at[tgt].set(1, mode="drop"),
        mp_found=st.mp_found.at[tgt].set(1, mode="drop"),
        mp_obs_kf=st.mp_obs_kf.at[tgt].set(-1, mode="drop"),
        mp_obs_feat=st.mp_obs_feat.at[tgt].set(-1, mode="drop"),
        next_mp=jnp.minimum(state.next_mp + jnp.sum(close.astype(jnp.int32)), st.mp_capacity),
    )
    st = st._replace(kf_mp_idx=st.kf_mp_idx.at[k].set(jnp.where(close, new_ids, st.kf_mp_idx[k])))
    st = _append_observations(st, k, new_ids, feat_ids, close)

    touched = jnp.where(close, new_ids, jnp.where(tracked_ok, tracked_mp, -1))
    st = _distill_descriptors(st, touched)
    st = _update_normals_and_depth(st, touched, scale_factor, n_levels)

    # -- 5. covisibility + spanning tree -----------------------------------
    row = _covis_row_for_kf(st, k)
    covis = st.covis.at[k, :].set(row).at[:, k].set(row)
    parent = jnp.argmax(row)
    parent_ok = (row[parent] >= min_covis_weight) & (state.next_kf > 0)
    st = st._replace(
        covis=covis,
        kf_parent=st.kf_parent.at[k].set(jnp.where(parent_ok, parent, -1)),
    )
    return st, k
