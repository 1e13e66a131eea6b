"""Keyframe database for place recognition — sparse top-words tf-idf rows.

The reference keeps an inverted index word→{KF} and scores candidates with
shared-word counts, covisibility-group accumulation and best-of-group
selection (reference: src/KeyFrameDB.cc — addKeyFrame :8-36, findRelocKfs
:39-173, findLoopCloseKfs :181-242).

Redesign: each keyframe stores its top-``S`` words by tf-idf weight as a
fixed-shape (ids, weights) pair — memory is O(K·S) instead of the dense
O(K·W) rows of round 1, which made a DBoW3-scale vocabulary (10⁶ words)
impossible (4 GB).  A query scatters its own sparse vector into a transient
dense [W] scratch (4 MB at W=10⁶) and every keyframe score is one gather +
row-sum: ``score[k] = Σ_s scratch[word_ids[k, s]] · weights[k, s]`` — the
sparse dot product of L2-normalized tf-idf vectors (cosine score; documented
deviation from DBoW3's L1 score, same retrieval ordering in practice).

The reference's featvec/levelsUp node grouping (Frame.h:224-231) exists to
prune C++ descriptor matching; our matching is a dense hamming matrix (one
matmul), so no counterpart is needed (documented deviation).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..utils import topk_bounded

from ..mapstate.map_state import MapState
from .vocabulary import Vocabulary, transform


# minimum vocabulary size for the shared-word prefilter (see
# find_reloc_candidates): below this the rows saturate and word counts stop
# being a place signal
WORD_GATE_MIN_VOCAB = 10_000


class BowVec(NamedTuple):
    """Sparse tf-idf vector: top-S (word id, weight) pairs, L2-normalized."""

    ids: jnp.ndarray      # i32[S], −1 = empty slot
    weights: jnp.ndarray  # f32[S]


class KeyFrameDB(NamedTuple):
    """Sparse BoW store: top-S word (id, weight) rows per keyframe slot."""

    word_ids: jnp.ndarray  # i32[K, S], −1 = empty
    weights: jnp.ndarray   # f32[K, S]

    @staticmethod
    def empty(n_keyframes: int, max_words: int) -> "KeyFrameDB":
        return KeyFrameDB(
            word_ids=jnp.full((n_keyframes, max_words), -1, jnp.int32),
            weights=jnp.zeros((n_keyframes, max_words), jnp.float32),
        )

    @property
    def max_words(self) -> int:
        return self.word_ids.shape[1]


def sparse_bow(vocab: Vocabulary, word_ids: jnp.ndarray, max_words: int) -> BowVec:
    """Word histogram → top-``max_words`` tf-idf entries, L2-normalized over
    the kept entries (replaces the dense ``bow_vector`` for the database).

    Cost is O(N log N) in the DESCRIPTOR count, not the vocabulary size: the
    word ids are sorted and run-length counted via two-sided searchsorted,
    so no [W] dense histogram or top-k over W ever exists (r5: the dense
    form's ``top_k`` over W=10⁵ was ~1/3 of the per-KF loop-detect program,
    and W=10⁶ made it the dominant cost)."""
    W = vocab.n_words
    N = word_ids.shape[0]
    s = jnp.sort(jnp.where(word_ids >= 0, word_ids, W))          # [N], W = pad
    lo = jnp.searchsorted(s, s, side="left")
    hi = jnp.searchsorted(s, s, side="right")
    count = (hi - lo).astype(jnp.float32)                        # occurrences
    first = jnp.arange(N) == lo                                  # one per word
    valid = first & (s < W)
    v = jnp.where(valid, count * vocab.idf[jnp.clip(s, 0, W - 1)], 0.0)
    k = min(max_words, N)
    top_w, top_i = jax.lax.top_k(v, k)                           # over [N]
    norm = jnp.linalg.norm(top_w)
    w = jnp.where(top_w > 0, top_w / jnp.maximum(norm, 1e-9), 0.0)
    ids = jnp.where(top_w > 0, s[top_i].astype(jnp.int32), -1)
    if k < max_words:  # fewer descriptor slots than row width: pad
        pad = max_words - k
        ids = jnp.concatenate([ids, jnp.full((pad,), -1, jnp.int32)])
        w = jnp.concatenate([w, jnp.zeros((pad,), jnp.float32)])
    return BowVec(ids=ids, weights=w)


def rebuild(vocab: Vocabulary, state: MapState, max_words: int = 1024,
            chunk: int = 16) -> KeyFrameDB:
    """Recompute every valid keyframe's BoW row — the reference's database
    refill after map load (System.cc:104-110).

    Keyframes are processed in ``chunk``-row batches under ``lax.map`` (NOT
    one big vmap): the tree-descent transform materializes a
    [rows, N, k, 256] f32 sign tensor per level, which at full keyframe
    capacity × 2048 descriptors × a 10⁵-word vocabulary is ~20 GB — a vmap
    over all slots ran out of device memory on ``SLAM.load()`` (r5).  Chunked, the
    peak is ~chunk/K of that with identical results."""
    def one(desc, valid, kf_ok):
        words = transform(vocab, desc, valid & kf_ok)
        return sparse_bow(vocab, words, max_words)

    K = state.kf_desc.shape[0]
    C = max(1, min(chunk, K))
    pad = (-K) % C

    def _pad(a):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)

    desc = _pad(state.kf_desc).reshape(-1, C, *state.kf_desc.shape[1:])
    fval = _pad(state.kf_feat_valid).reshape(-1, C, state.kf_feat_valid.shape[1])
    kval = _pad(state.kf_valid).reshape(-1, C, 1)
    rows = jax.lax.map(lambda t: jax.vmap(one)(*t), (desc, fval, kval))
    ids = rows.ids.reshape(-1, rows.ids.shape[-1])[:K]
    weights = rows.weights.reshape(-1, rows.weights.shape[-1])[:K]
    return KeyFrameDB(
        word_ids=jnp.where(state.kf_valid[:, None], ids, -1),
        weights=jnp.where(state.kf_valid[:, None], weights, 0.0),
    )


def add_keyframe(
    db: KeyFrameDB, vocab: Vocabulary, kf_id, desc: jnp.ndarray, valid: jnp.ndarray
) -> KeyFrameDB:
    """Compute and store the keyframe's BoW row (KeyFrameDB::addKeyFrame)."""
    words = transform(vocab, desc, valid)
    v = sparse_bow(vocab, words, db.max_words)
    return KeyFrameDB(
        word_ids=db.word_ids.at[kf_id].set(v.ids),
        weights=db.weights.at[kf_id].set(v.weights),
    )


def query_scores(
    db: KeyFrameDB, query: BowVec, kf_valid: jnp.ndarray, *, n_words: int
) -> jnp.ndarray:
    """Cosine similarity of the query against every keyframe row [K]:
    scatter the query into a dense [W] scratch, gather at each row's ids."""
    scratch = jnp.zeros((n_words + 1,), jnp.float32).at[
        jnp.where(query.ids >= 0, query.ids, n_words)
    ].set(query.weights, mode="drop")
    g = scratch[jnp.clip(db.word_ids, 0, n_words - 1)]          # [K, S]
    s = jnp.sum(jnp.where(db.word_ids >= 0, g * db.weights, 0.0), axis=1)
    return jnp.where(kf_valid, s, 0.0)


def shared_word_counts(
    db: KeyFrameDB, query: BowVec, kf_valid: jnp.ndarray, *, n_words: int
) -> jnp.ndarray:
    """Shared-word count of the query against every keyframe row [K] — the
    reference's first retrieval stage (KeyFrameDB.cc:39-58 builds lKfsSharingWords
    via the inverted index and counts words per KF).  A cheap signal
    independent of the tf-idf cosine: perceptually-aliased views can score a
    high cosine on few very-heavy words, but genuine revisits share MANY
    words; the 0.8·max gate on this count suppresses the aliased candidates."""
    scratch = jnp.zeros((n_words + 1,), bool).at[
        jnp.where(query.ids >= 0, query.ids, n_words)
    ].set(True, mode="drop")
    g = scratch[jnp.clip(db.word_ids, 0, n_words - 1)] & (db.word_ids >= 0)
    return jnp.where(kf_valid, jnp.sum(g.astype(jnp.int32), axis=1), 0)


def _group_scores(
    state: MapState, s: jnp.ndarray, top_covis: int = 10, top_rows: int = 64
) -> jnp.ndarray:
    """Covisibility-group accumulated score (KeyFrameDB.cc:125-173): each
    keyframe's score plus its top-``top_covis`` covisible neighbours'.

    Computed only for the ``top_rows`` highest-scoring keyframes (other rows
    return 0): candidates are selected by own-score among group-passers, so
    only high-s rows can ever be picked, and the 0.75·max(gs) threshold can
    at worst be slightly UNDER-estimated (more permissive — benign).  This
    replaces a [K, K] row-top-k (the single biggest op in the per-keyframe
    detection program at K=1024) with a [top_rows, K] one."""
    K = s.shape[0]
    R = min(top_rows, K)
    sv, rows = jax.lax.top_k(s, R)                       # high-s keyframes
    rows_c = jnp.clip(rows, 0, K - 1)
    covis_rows = state.covis[rows_c] * state.kf_valid.astype(jnp.int32)[None, :]
    w, ids = jax.lax.top_k(covis_rows, min(top_covis, K))  # [R, top_covis]
    nb_sum = jnp.sum(jnp.where(w > 0, s[jnp.clip(ids, 0, K - 1)], 0.0), axis=1)
    gs_rows = jnp.where(sv > 0, sv + nb_sum, 0.0)
    return jnp.zeros((K,), s.dtype).at[rows_c].max(gs_rows)


def find_reloc_candidates(
    db: KeyFrameDB,
    state: MapState,
    query: BowVec,
    *,
    n_words: int,
    n_candidates: int = 5,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Relocalization candidates (findRelocKfs, KeyFrameDB.cc:39-173):
    shared-word prefilter at 0.8·max (the reference's minCommonWords gate,
    :58-76), score the survivors, group-accumulate over covisibility, keep
    groups above 0.75·best, return each group's best member.

    The word gate assumes an ORBvoc-class vocabulary: with 10^5-10^6 words a
    frame's words are a discriminative place fingerprint.  With a TINY
    vocabulary the per-KF rows saturate (every KF holds most words) and the
    count degenerates into a texture-frequency signal — measured on the
    aliased adversarial world with a 216-word vocab, the repeated-texture
    wall out-shared every genuine revisit and the gate pruned exactly the
    right candidates.  So the gate activates only at vocabulary sizes where
    its premise holds."""
    s = query_scores(db, query, state.kf_valid, n_words=n_words)
    if n_words >= WORD_GATE_MIN_VOCAB:
        shared = shared_word_counts(db, query, state.kf_valid, n_words=n_words)
        word_ok = shared.astype(jnp.float32) > 0.8 * jnp.max(shared).astype(jnp.float32)
        s = jnp.where(word_ok, s, 0.0)
    gs = _group_scores(state, s)
    th = 0.75 * jnp.max(gs)
    ok = (gs >= th) & (s > 0)
    masked = jnp.where(ok, s, -1.0)
    top, ids = topk_bounded(masked, n_candidates)
    return jnp.where(top > 0, ids, -1), top


def find_loop_candidates(
    db: KeyFrameDB,
    state: MapState,
    query: BowVec,
    query_kf,
    *,
    n_words: int,
    n_candidates: int = 5,
    min_covis_weight: int = 15,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Loop-closure candidates (findLoopCloseKfs, KeyFrameDB.cc:181-242):
    like reloc retrieval, but keyframes covisible with the query are excluded
    and candidates must beat the query's own neighbourhood minimum score.
    The shared-word prefilter (0.8·max over NON-connected KFs) applies here
    too (KeyFrameDB.cc:181-213), subject to the same vocabulary-size premise
    as find_reloc_candidates."""
    K = state.kf_capacity
    s = query_scores(db, query, state.kf_valid, n_words=n_words)
    shared = shared_word_counts(db, query, state.kf_valid, n_words=n_words)
    use_gate = n_words >= WORD_GATE_MIN_VOCAB

    # min score among the query's covisible neighbours = base threshold
    nb_w = state.covis[query_kf] * state.kf_valid.astype(jnp.int32)
    nb_mask = nb_w >= min_covis_weight
    nb_scores = jnp.where(nb_mask, s, jnp.inf)
    min_nb = jnp.min(nb_scores)
    min_score = jnp.where(jnp.isfinite(min_nb), min_nb, 0.0)

    connected = (state.covis[query_kf] > 0)
    excluded = connected | (jnp.arange(K) == query_kf) | ~state.kf_valid
    s = jnp.where(excluded, 0.0, s)
    # shared-word gate over the non-excluded set (the reference's max runs
    # over lKfsSharingWords, which already excludes connected KFs)
    if use_gate:
        shared = jnp.where(excluded, 0, shared)
        word_ok = shared.astype(jnp.float32) > 0.8 * jnp.max(shared).astype(jnp.float32)
        s = jnp.where(word_ok, s, 0.0)
    gs = _group_scores(state, s)
    th = jnp.maximum(0.75 * jnp.max(gs), min_score)
    ok = (gs >= th) & (s >= min_score) & (s > 0)
    masked = jnp.where(ok, s, -1.0)
    top, ids = topk_bounded(masked, n_candidates)
    return jnp.where(top > 0, ids, -1), top
