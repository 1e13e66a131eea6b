"""Bag-of-binary-words vocabulary: array-resident k-ary tree.

Replaces DBoW3 (reference: loaded at src/System.cc:93, used via
``transform(desc, bowVec, featVec, 4)`` in include/ORB_SLAM2/Frame.h:224-231).
The reference parses the ~1M-word ORBvoc text file for minutes at startup;
here the vocabulary is a flat array tree — ``transform`` is a batched
hamming tree-descent over all descriptors at once (one fused program), and a
trainer is provided so the system is self-contained without shipping ORBvoc
(hierarchical k-medians with bitwise-majority centroids, the DBoW recipe).

Tree layout: ``branching = k``, ``depth = L``.  Depth-d nodes (1-indexed
levels) are stored contiguously: children of node i at depth d are
``[i·k, (i+1)·k)`` at depth d+1.  Word id = leaf index in [0, k^L).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..ops.hamming import hamming_matrix, unpack_signs


class Vocabulary(NamedTuple):
    """Array-resident vocabulary.  levels[d] = uint32[k^(d+1), 8] centroids."""

    levels: tuple            # tuple of uint32[k^(d+1), 8]
    idf: jnp.ndarray         # f32[n_words] inverse-document-frequency weights
    branching: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth


def _bit_majority(descs: np.ndarray, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Bitwise-majority centroid of packed uint32[N, 8] descriptors."""
    bits = np.unpackbits(descs.view(np.uint8), axis=1)  # [N, 256]
    if weights is None:
        maj = bits.mean(axis=0) >= 0.5
    else:
        w = weights[:, None]
        maj = (bits * w).sum(0) / max(w.sum(), 1e-9) >= 0.5
    return np.packbits(maj.astype(np.uint8)).view(np.uint32)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 8] × [M, 8] → [N, M] hamming distances (numpy, training only)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8).reshape(x.shape[0], x.shape[1], -1), axis=2).sum(2)


def _kmedians(descs: np.ndarray, k: int, rng, iters: int = 8) -> np.ndarray:
    """Binary k-medians: k centroids for packed descriptors [N, 8]."""
    n = len(descs)
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    init = rng.choice(n, size=min(k, n), replace=False)
    centers = descs[init]
    if len(centers) < k:
        centers = np.concatenate([centers, rng.integers(0, 2**32, (k - len(centers), 8), dtype=np.uint32)])
    for _ in range(iters):
        d = _hamming_np(descs, centers)
        assign = d.argmin(1)
        for c in range(k):
            sel = descs[assign == c]
            if len(sel):
                centers[c] = _bit_majority(sel)
    return centers.astype(np.uint32)


def train_vocabulary(
    descriptors: np.ndarray, branching: int = 10, depth: int = 4, seed: int = 0
) -> Vocabulary:
    """Hierarchical k-medians over training descriptors uint32[N, 8]."""
    rng = np.random.default_rng(seed)
    k, L = branching, depth
    levels: List[np.ndarray] = []
    # recursively split; store per-level centroid tables
    groups = [descriptors]
    for d in range(L):
        table = np.zeros((k ** (d + 1), 8), np.uint32)
        next_groups: List[np.ndarray] = []
        for gi, g in enumerate(groups):
            centers = _kmedians(g, k, rng)
            table[gi * k : (gi + 1) * k] = centers
            if len(g):
                assign = _hamming_np(g, centers).argmin(1)
            else:
                assign = np.zeros((0,), np.int64)
            for c in range(k):
                next_groups.append(g[assign == c])
        levels.append(table)
        groups = next_groups

    # idf from training counts (DBoW TF-IDF weighting)
    counts = np.array([len(g) for g in groups], np.float32)
    n_total = max(len(descriptors), 1)
    idf = np.log(n_total / np.maximum(counts, 1.0)).astype(np.float32)
    return Vocabulary(
        levels=tuple(jnp.asarray(t) for t in levels),
        idf=jnp.asarray(idf),
        branching=k,
        depth=L,
    )


def transform(vocab: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Batched tree descent: descriptors uint32[N, 8] → word ids i32[N]
    (−1 for invalid rows).  Replaces DBoW3::Vocabulary::transform."""
    k = vocab.branching
    n = desc.shape[0]
    node = jnp.zeros((n,), jnp.int32)  # parent index at current depth
    sd = unpack_signs(desc).astype(jnp.float32)                          # [N, 256]
    for d in range(vocab.depth):
        table = vocab.levels[d]  # [k^(d+1), 8]
        # children of `node` are rows [node*k, node*k+k)
        child_idx = node[:, None] * k + jnp.arange(k)[None, :]          # [N, k]
        cands = table[child_idx]                                         # [N, k, 8]
        # hamming via sign-matmul per row
        sc = unpack_signs(cands.reshape(-1, 8)).reshape(n, k, 256)
        dot = jnp.einsum("nb,nkb->nk", sd, sc.astype(jnp.float32))
        best = jnp.argmin((256.0 - dot) * 0.5, axis=1)
        node = node * k + best.astype(jnp.int32)
    return jnp.where(valid, node, -1)


def bow_vector(vocab: Vocabulary, word_ids: jnp.ndarray) -> jnp.ndarray:
    """Sparse word histogram → dense tf-idf L2-normalized vector f32[n_words].

    Deviation from DBoW3 (documented): scoring uses the cosine of tf-idf
    vectors instead of DBoW3's L1 score — same retrieval behaviour, one
    matmul per query against the whole keyframe database.
    """
    W = vocab.n_words
    counts = jnp.zeros((W + 1,), jnp.float32).at[
        jnp.where(word_ids >= 0, word_ids, W)
    ].add(1.0, mode="drop")[:W]
    v = counts * vocab.idf
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-9)


def load_dbow_text(path: str) -> Vocabulary:
    """Parse a DBoW2/DBoW3 text vocabulary (the ORBvoc.txt the reference
    loads for minutes at startup, System.cc:92-95) into the array tree.

    Format: first line ``k L scoring weighting``; then one node per line:
    ``parent_id is_leaf d0 … d31 weight`` in depth-first parent order.  Nodes
    are re-laid out into this module's contiguous-children level tables; a
    parent with fewer than k children keeps duplicate filler centroids (its
    own descriptor), which never win the hamming argmin ties meaningfully.
    """
    # vectorized parse: every node line is exactly 35 numeric tokens
    # (parent, is_leaf, 32 descriptor bytes, weight), so the whole file after
    # the header is one C-speed np.loadtxt — the Python per-line loop took
    # minutes at ORBvoc scale (10⁶ words, ~1.1M lines)
    with open(path) as f:
        first = f.readline().split()
        k, L = int(first[0]), int(first[1])
        try:
            data = np.loadtxt(f, dtype=np.float64, ndmin=2)
        except ValueError:
            # real-world files carry trailing junk / blank-ish lines; fall
            # back to a tolerant pass that keeps only well-formed node lines
            # (≥35 numeric tokens), like the original per-line parser
            f.seek(0)
            f.readline()
            rows = [ln.split()[:35] for ln in f if len(ln.split()) >= 35]
            data = np.asarray(rows, dtype=np.float64).reshape(-1, 35)
    if data.shape[1] < 35:
        raise ValueError(f"malformed DBoW text vocabulary: {data.shape[1]} columns")
    parents = data[:, 0].astype(np.int64)
    desc_u32 = np.ascontiguousarray(data[:, 2:34].astype(np.uint8)).view(np.uint32)
    weights = data[:, 34].astype(np.float32)

    # children lists grouped by parent, preserving file order (stable sort)
    order = np.argsort(parents, kind="stable")
    sp = parents[order]
    uniq, starts = np.unique(sp, return_index=True)
    bounds = np.append(starts[1:], len(order))
    children = {int(p): order[s:e] for p, s, e in zip(uniq, starts, bounds)}

    levels_np = [np.zeros((k ** (d + 1), 8), np.uint32) for d in range(L)]
    idf = np.zeros((k**L,), np.float32)
    # DBoW node 0 is the root (implicit, not in the file when parent ids are
    # offset); iterative DFS assigning contiguous slots (the recursive
    # version was bounded by L but carried per-call overhead at 10⁶ nodes).
    # A parent with fewer than k children keeps duplicate filler centroids
    # (its first child's descriptor), which never win the hamming argmin
    # ties meaningfully.
    stack = [(children.get(0, np.empty(0, np.int64)), 0, 0)]
    while stack:
        node_file_ids, depth, base = stack.pop()
        n_ids = min(len(node_file_ids), k)
        if n_ids:
            levels_np[depth][base:base + n_ids] = desc_u32[node_file_ids[:n_ids]]
            if n_ids < k:  # pad missing children with the first child
                levels_np[depth][base + n_ids:base + k] = desc_u32[node_file_ids[0]]
        if depth + 1 < L:
            for ci in range(n_ids):
                fid = int(node_file_ids[ci])
                stack.append((
                    children.get(fid + 1, np.empty(0, np.int64)),
                    depth + 1, (base + ci) * k,
                ))
        else:
            for ci in range(n_ids):
                idf[base + ci] = weights[node_file_ids[ci]]
    return Vocabulary(
        levels=tuple(jnp.asarray(t) for t in levels_np),
        idf=jnp.asarray(np.maximum(idf, 1e-3)),
        branching=k,
        depth=L,
    )


def save_vocabulary(vocab: Vocabulary, path: str) -> None:
    np.savez_compressed(
        path,
        branching=vocab.branching, depth=vocab.depth,
        idf=np.asarray(vocab.idf),
        **{f"level_{d}": np.asarray(t) for d, t in enumerate(vocab.levels)},
    )


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    depth = int(z["depth"])
    return Vocabulary(
        levels=tuple(jnp.asarray(z[f"level_{d}"]) for d in range(depth)),
        idf=jnp.asarray(z["idf"]),
        branching=int(z["branching"]),
        depth=depth,
    )
