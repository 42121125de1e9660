"""Bag-of-binary-words place recognition, batched on the device.

Capability equivalent of the reference's vendored DBoW3
(reference: Thirdparty/DBow3 — Vocabulary/BowVector/ScoringObject; the
reference links it and typedefs ORBVocabulary, Include/GlobalTypes.h:217,
but ships no trained vocabulary: loop closure is a declared capability,
SURVEY.md §0). Re-designed as batched array code:

  * the vocabulary is a k^L tree of binary centroids stored as dense
    arrays (level-major); training is batched k-medians on descriptor
    bits (majority vote instead of DBoW3's sequential k-means++);
  * quantization descends the tree for all descriptors in parallel —
    per level one (N, k) Hamming distance + argmin;
  * BoW vectors are fixed-size dense tf (term-frequency) vectors over the
    leaf words; similarity is the DBoW3 L1 score
    s(v, w) = 1 - 0.5 * |v/|v| - w/|w||_1.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Vocabulary(NamedTuple):
    centroids: jnp.ndarray    # (L, max_nodes, 8) uint32 binary centroids
    k: int                    # branching factor
    levels: int               # tree depth
    n_words: int              # k ** levels
    idf: jnp.ndarray          # (n_words,) inverse document frequency


def _popcount_dist(a, b):
    """(N, 8) x (M, 8) uint32 -> (N, M) int32."""
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    return jnp.sum(jnp.bitwise_count(x).astype(jnp.int32), axis=-1)


def _majority_centroid(descs: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Bitwise majority vote over masked descriptors: (N, 8) uint32 -> (8,)."""
    if mask.sum() == 0:
        return descs[0]
    bits = np.unpackbits(
        descs[mask].view(np.uint8), axis=1, bitorder="little"
    )
    maj = (bits.mean(axis=0) >= 0.5).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     iters: int = 8, seed: int = 0,
                     doc_ids: np.ndarray | None = None) -> Vocabulary:
    """Host-side k-medians tree training (one-off; numpy).

    descriptors: (N, 8) uint32. Returns a Vocabulary with k^levels words.
    `doc_ids` (N,) optionally assigns each training descriptor to a document
    (keyframe/image); when given, per-word idf = log(n_docs / n_docs_with_word)
    is computed the DBoW3 way (TF_IDF weighting, ScoringObject); without it
    idf stays uniform (tf-only scoring).
    """
    rng = np.random.RandomState(seed)
    N = len(descriptors)
    max_nodes = k ** levels
    cents = np.zeros((levels, max_nodes, 8), np.uint32)

    pop_lut = np.array([bin(i).count("1") for i in range(256)], np.uint16)

    def hdist(a, b):
        """(N, 8) x (M, 8) -> (N, M) hamming distances (byte-LUT popcount —
        8x less memory traffic than unpackbits, matters at 10^4-word
        vocabulary scale)."""
        x = a[:, None, :] ^ b[None, :, :]
        return pop_lut[x.view(np.uint8)].sum(-1, dtype=np.int32)

    def kmedians(data, kk):
        if len(data) == 0:
            return np.zeros((kk, 8), np.uint32), np.zeros(0, np.int64)
        # farthest-point initialization: real descriptor sets are heavily
        # correlated; random init + majority vote collapses every centroid
        # onto the global median and the whole tree degenerates
        c = np.zeros((kk, 8), np.uint32)
        c[0] = data[rng.randint(len(data))]
        dmin = hdist(data, c[:1])[:, 0]
        for j in range(1, kk):
            c[j] = data[int(dmin.argmax())]
            dmin = np.minimum(dmin, hdist(data, c[j : j + 1])[:, 0])
        assign = np.zeros(len(data), np.int64)
        for _ in range(iters):
            d = hdist(data, c)
            assign = d.argmin(-1)
            for j in range(kk):
                mask = assign == j
                if mask.sum() == 0:
                    # reseed an empty cluster with the farthest point
                    far = int(d[np.arange(len(data)), assign].argmax())
                    c[j] = data[far]
                    assign[far] = j
                else:
                    c[j] = _majority_centroid(data, mask)
        return c, assign

    # recursive split, materialized level-major
    groups = {(): np.arange(N)}
    for lvl in range(levels):
        new_groups = {}
        for path, idx in groups.items():
            node_base = 0
            for p_ in path:
                node_base = node_base * k + p_
            c, assign = kmedians(descriptors[idx], k)
            for j in range(k):
                cents[lvl, node_base * k + j, :] = c[j]
                new_groups[path + (j,)] = idx[assign == j]
        groups = new_groups

    n_words = k ** levels
    idf = np.ones(n_words, np.float32)
    if doc_ids is not None and N > 0:
        voc_tmp = Vocabulary(
            centroids=jnp.asarray(cents), k=k, levels=levels,
            n_words=n_words, idf=jnp.ones(n_words, jnp.float32))
        words = np.asarray(
            quantize(voc_tmp, jnp.asarray(descriptors),
                     jnp.ones(N, bool)))
        docs = np.asarray(doc_ids)
        n_docs = len(np.unique(docs))
        # docs containing each word (presence, not frequency — DBoW3 Ni)
        seen = np.unique(np.stack([words, docs], 1), axis=0)
        ni = np.bincount(seen[:, 0], minlength=n_words)
        idf = np.where(
            ni > 0, np.log(n_docs / np.maximum(ni, 1)), 0.0
        ).astype(np.float32)
    voc = Vocabulary(
        centroids=jnp.asarray(cents),
        k=k, levels=levels, n_words=n_words,
        idf=jnp.asarray(idf),
    )
    return voc


def save_vocabulary(path: str, voc: Vocabulary) -> None:
    """Persist a trained vocabulary (the reference takes a DBoW3 vocabulary
    file as a mandatory CLI argument, Main.h:81 — this is our equivalent)."""
    np.savez_compressed(
        path, centroids=np.asarray(voc.centroids), k=voc.k,
        levels=voc.levels, idf=np.asarray(voc.idf))


def load_vocabulary(path: str) -> Vocabulary:
    data = np.load(path)
    k = int(data["k"])
    levels = int(data["levels"])
    return Vocabulary(
        centroids=jnp.asarray(data["centroids"]), k=k, levels=levels,
        n_words=k ** levels, idf=jnp.asarray(data["idf"]))


def quantize(voc: Vocabulary, descs: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Descend the tree for all descriptors in parallel.

    descs: (N, 8) uint32 -> word ids (N,) int32 (invalid -> -1)."""
    N = descs.shape[0]
    k = voc.k
    node = jnp.zeros(N, jnp.int32)     # node index within its level
    for lvl in range(voc.levels):
        # children of `node` at this level occupy [node*k, node*k+k)
        child_base = node * k
        # gather the k candidate centroids per descriptor
        cand_idx = child_base[:, None] + jnp.arange(k)[None, :]     # (N, k)
        cands = voc.centroids[lvl][cand_idx]                        # (N, k, 8)
        x = jnp.bitwise_xor(descs[:, None, :], cands)
        d = jnp.sum(jnp.bitwise_count(x).astype(jnp.int32), axis=-1)
        best = jnp.argmin(d, axis=-1).astype(jnp.int32)
        node = child_base + best
    return jnp.where(valid, node, -1)


def bow_vector(word_ids: jnp.ndarray, n_words: int,
               idf: jnp.ndarray | None = None) -> jnp.ndarray:
    """tf (or tf-idf when `idf` is given) vector (n_words,), L1-normalized.
    DBoW3 TF_IDF weighting + L1_NORM (ScoringObject.cpp)."""
    oh = jax.nn.one_hot(jnp.where(word_ids >= 0, word_ids, 0), n_words)
    oh = oh * (word_ids >= 0)[:, None]
    v = jnp.sum(oh, axis=0)
    if idf is not None:
        v = v * idf
    return v / jnp.maximum(jnp.sum(v), 1e-9)


def l1_score(v: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """DBoW3 L1 scoring: s = 1 - 0.5 |v - w|_1 for L1-normalized v, w.
    v: (n_words,), db: (M, n_words) -> (M,)."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v[None, :] - db), axis=-1)


# jitted entry for the per-keyframe loop-closure scoring path (one
# executable per padded database bucket)
l1_score_jit = jax.jit(l1_score)
