"""Loop closure: batched bag-of-words scorer, candidate gating, geometric
verification, SE(3) pose-graph optimization, rigid map correction.

Capability parity with the reference's loop-closure stack (mapHandler.cpp):
dual point+line BoW scoring with count- and dispersion-weighted combination
(``insertKFBowVectorPL``, :2925-3000), temporally-consistent candidate
search (``lookForLoopCandidates``, :3002-3076), KF<->KF geometric
verification with 5 acceptance gates (``isLoopClosure`` +
``computeRelativePoseGN``, :3078-3545), and pose-graph optimization with
landmark correction (``loopClosureOptimizationEssGraphG2O``, :3950-4185).

Design decisions:

- DBoW2's hierarchical vocabulary tree (TemplatedVocabulary.h:1066-1127) is
  replaced by a flat anchor vocabulary: word(desc) = nearest of V fixed
  256-bit anchors by Hamming distance — one [N, V] popcount matrix per KF —
  with L1-normalized tf histograms and the DBoW2 L1 score
  1 - 0.5 |v1 - v2|_1 (ScoringObject.h L1Scoring). The pre-trained .yml
  vocabularies are not in the reference snapshot (build.sh:17-20), so the
  anchor set is generated deterministically; scoring semantics (sparse
  histogram + L1) are preserved.
- the conf-matrix row for a new KF against *all* past KFs is one matmul-like
  batched score; g2o's sparse PGO becomes a dense GN on [6K] twists (K <=
  512 keyframes) with autodiff edge Jacobians — small enough to solve
  on device with Cholesky.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gfplslam_tpu.config import Config
from gfplslam_tpu.models import pose_opt
from gfplslam_tpu.models.frame import StereoFrame
from gfplslam_tpu.ops.hamming import hamming_matrix
from gfplslam_tpu.ops import matching as match_ops
from gfplslam_tpu.utils import se3

# stereo features snapshotted per KF for LC verification: 512/256 covers
# the full EuRoC budgets with little truncation (256/128 dropped ~3k
# features over a 12-KF full-capacity run — weaker geometric verification
# exactly where loop closures matter most); the snapshot-drop counter
# (n_snapshot_dropped) keeps any remaining truncation observable
N_KF_PT = 512
N_KF_LN = 256


def make_vocab(v: int = 1024, seed: int = 31) -> np.ndarray:
    """[V, 8] uint32 anchor descriptors (deterministic)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(v, 8), dtype=np.uint32)


# master anchor pools; the active vocabulary is the first cfg.cap.vocab_k.
# A trained vocabulary (apps/train_vocab.py k-majority clustering over
# multi-world descriptor corpora) ships with the package and is loaded by
# default — the analog of the reference loading its pre-trained .yml
# vocabularies at startup (config.cpp:59-60, mapHandler.cpp:30-35); the
# seeded random anchors remain the fallback when the file is absent.
_VOCAB_P_FULL = make_vocab(4096, seed=31)
_VOCAB_L_FULL = make_vocab(4096, seed=67)
VOCAB_SOURCE = "random-anchors"


# trained vocabularies by word count: {k: dict(vp, vl, df_p, df_l, n_docs)}
# — every shipped capacity gets its own k-majority codebook (slicing one
# codebook to a smaller k drops half its words and breaks discrimination)
_TRAINED: dict = {}


def _load_default_vocab() -> None:
    """Load every shipped ``data/vocab_synth*.npz`` (one per word count) —
    the analog of the reference loading its pre-trained .yml vocabularies at
    startup (config.cpp:59-60, mapHandler.cpp:30-35)."""
    global VOCAB_SOURCE
    import glob
    import os
    data_dir = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "data")
    for path in sorted(glob.glob(os.path.join(data_dir, "vocab_synth*.npz"))):
        data = np.load(path)
        vp = np.asarray(data["vocab_p"], np.uint32)
        entry = dict(
            vp=vp, vl=np.asarray(data["vocab_l"], np.uint32),
            df_p=(np.asarray(data["df_p"], np.float32)
                  if "df_p" in data else None),
            df_l=(np.asarray(data["df_l"], np.float32)
                  if "df_l" in data else None),
            n_docs=float(data["n_docs"]) if "n_docs" in data else None)
        _TRAINED[vp.shape[0]] = entry
        if path.endswith("vocab_synth.npz") or VOCAB_SOURCE == "random-anchors":
            VOCAB_SOURCE = path


def active_vocab(vocab_k: int) -> tuple[np.ndarray, np.ndarray]:
    """The vocabulary used at size ``vocab_k``: the trained words when a
    codebook of that exact size is installed, random anchors otherwise."""
    t = _TRAINED.get(vocab_k)
    if t is not None:
        vl = t["vl"]
        return t["vp"], (vl if vl.shape[0] == vocab_k
                         else _VOCAB_L_FULL[:vocab_k])
    return _VOCAB_P_FULL[:vocab_k], _VOCAB_L_FULL[:vocab_k]


def active_idf(vocab_k: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Frozen training-corpus idf vectors [(V,), (V,)], or None when no
    trained document frequencies are available for this vocabulary size.

    DBoW2 computes word weights once from the training corpus and never
    updates them online (TemplatedVocabulary.h:1066-1127), which keeps every
    conf-matrix row on the same scale regardless of when it was computed;
    online-df scoring drifts across epochs as the map grows."""
    t = _TRAINED.get(vocab_k)
    if t is not None and t["df_p"] is not None:
        idf_p = np.log((t["n_docs"] + 1.0) / (t["df_p"] + 1.0))
        idf_l = np.log((t["n_docs"] + 1.0) / (t["df_l"] + 1.0))
        return idf_p.astype(np.float32), idf_l.astype(np.float32)
    return None


def set_vocab(vocab_p: np.ndarray, vocab_l: np.ndarray,
              df_p: np.ndarray = None, df_l: np.ndarray = None,
              n_docs: float = None) -> None:
    """Install a trained vocabulary (apps/train_vocab.py output) for its
    word count — the analog of loading the reference's pre-trained .yml
    files (config.cpp:59-60). Active for configs whose ``vocab_k`` equals
    the trained word count (see :func:`active_vocab`). Optional
    ``df_p/df_l/n_docs`` freeze the idf at the trained values."""
    global VOCAB_SOURCE
    vp = np.asarray(vocab_p, np.uint32)
    _TRAINED[vp.shape[0]] = dict(
        vp=vp, vl=np.asarray(vocab_l, np.uint32),
        df_p=np.asarray(df_p, np.float32) if df_p is not None else None,
        df_l=np.asarray(df_l, np.float32) if df_l is not None else None,
        n_docs=float(n_docs) if n_docs is not None else None)
    VOCAB_SOURCE = "set_vocab()"
    insert_kf_bow.clear_cache()


def load_vocab(path: str) -> None:
    data = np.load(path)
    set_vocab(data["vocab_p"], data["vocab_l"],
              df_p=data.get("df_p"), df_l=data.get("df_l"),
              n_docs=data.get("n_docs"))


_load_default_vocab()


class LoopState(NamedTuple):
    """Per-KF BoW vectors + feature snapshots + confusion matrix."""
    bow_p: jax.Array      # [K, V] raw tf histograms (points)
    bow_l: jax.Array      # [K, V] (lines)
    df_p: jax.Array       # [V] document frequencies (tf-idf weighting,
    df_l: jax.Array       # [V]  TemplatedVocabulary tf-idf semantics)
    n_docs: jax.Array     # int32
    n_pt: jax.Array       # [K] feature counts
    n_ln: jax.Array
    std_pt: jax.Array     # [K] spatial dispersion (vector_stdv x + y)
    std_ln: jax.Array
    conf: jax.Array       # [K, K] combined scores (conf_matrix)
    # feature snapshots for geometric verification
    pt_p3d: jax.Array     # [K, N_KF_PT, 3] camera-frame 3D points
    pt_uv: jax.Array      # [K, N_KF_PT, 2]
    pt_desc: jax.Array    # [K, N_KF_PT, 8] uint32
    pt_sigma2: jax.Array  # [K, N_KF_PT] per-octave sigma^2 weights
    pt_valid: jax.Array   # [K, N_KF_PT]
    ln_sp3d: jax.Array    # [K, N_KF_LN, 3]
    ln_ep3d: jax.Array    # [K, N_KF_LN, 3]
    ln_le: jax.Array      # [K, N_KF_LN, 3]
    ln_desc: jax.Array    # [K, N_KF_LN, 8]
    ln_sigma2: jax.Array  # [K, N_KF_LN]
    ln_valid: jax.Array   # [K, N_KF_LN]
    # features beyond the per-KF snapshot capacity (N_KF_PT/N_KF_LN),
    # accumulated so the cap is observable (no silent caps)
    n_snapshot_dropped: jax.Array  # int32


def empty_loop_state(cfg: Config) -> LoopState:
    k = cfg.cap.n_kf_max
    v = cfg.cap.vocab_k
    return LoopState(
        bow_p=jnp.zeros((k, v)), bow_l=jnp.zeros((k, v)),
        df_p=jnp.zeros(v, jnp.int32), df_l=jnp.zeros(v, jnp.int32),
        n_docs=jnp.asarray(0, jnp.int32),
        n_pt=jnp.zeros(k, jnp.int32), n_ln=jnp.zeros(k, jnp.int32),
        std_pt=jnp.zeros(k), std_ln=jnp.zeros(k),
        conf=jnp.zeros((k, k)),
        pt_p3d=jnp.zeros((k, N_KF_PT, 3)), pt_uv=jnp.zeros((k, N_KF_PT, 2)),
        pt_desc=jnp.zeros((k, N_KF_PT, 8), jnp.uint32),
        pt_sigma2=jnp.ones((k, N_KF_PT)),
        pt_valid=jnp.zeros((k, N_KF_PT), bool),
        ln_sp3d=jnp.zeros((k, N_KF_LN, 3)), ln_ep3d=jnp.zeros((k, N_KF_LN, 3)),
        ln_le=jnp.zeros((k, N_KF_LN, 3)),
        ln_desc=jnp.zeros((k, N_KF_LN, 8), jnp.uint32),
        ln_sigma2=jnp.ones((k, N_KF_LN)),
        ln_valid=jnp.zeros((k, N_KF_LN), bool),
        n_snapshot_dropped=jnp.asarray(0, jnp.int32))


def bow_vector(desc: jax.Array, valid: jax.Array, vocab: jax.Array
               ) -> jax.Array:
    """Raw tf histogram over nearest-anchor words
    (TemplatedVocabulary::transform on a flat vocabulary; idf weighting and
    L1 normalization are applied at scoring time from current document
    frequencies)."""
    d = hamming_matrix(desc, jnp.asarray(vocab), valid_a=valid)
    word = jnp.argmin(d, axis=1)
    return jnp.zeros(vocab.shape[0]).at[word].add(valid.astype(jnp.float32))


def _weighted_normalize(tf: jax.Array, idf: jax.Array) -> jax.Array:
    """Apply idf word weights + L1 normalize ([K?, V] tf)."""
    v = tf * idf
    return v / jnp.maximum(jnp.sum(jnp.abs(v), axis=-1, keepdims=True), 1e-9)


def _idf_normalize(tf: jax.Array, df: jax.Array, n_docs: jax.Array
                   ) -> jax.Array:
    """tf-idf weight + L1 normalize ([K?, V] tf against shared df)."""
    idf = jnp.log((n_docs + 1.0) / (df.astype(jnp.float32) + 1.0))
    return _weighted_normalize(tf, idf)


def l1_score(v1: jax.Array, v2: jax.Array) -> jax.Array:
    """DBoW2 L1 score: 1 - 0.5 |v1 - v2|_1 in [0, 1]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v1 - v2), axis=-1)


def _masked_stdv(x: jax.Array, mask: jax.Array) -> jax.Array:
    n = jnp.maximum(jnp.sum(mask), 1)
    mu = jnp.sum(jnp.where(mask, x, 0)) / n
    var = jnp.sum(jnp.where(mask, (x - mu) ** 2, 0)) / n
    return jnp.sqrt(var)


def _topk_snapshot(valid, score, n_out, *arrays):
    """Select up to n_out valid rows, BEST SCORE FIRST, from padded arrays;
    zero-pads when the frame's feature capacity is below the snapshot
    capacity (small test configs). Quality-ordered selection matters when
    the frame holds more valid features than the snapshot capacity: the
    reference verifies loops against full KF feature sets
    (mapHandler.cpp:3104-3242), so the truncated tail must be the WORST
    features, not an arbitrary (pyramid-level-ordered) slice."""
    n = valid.shape[0]
    key = jnp.where(valid, -score, jnp.inf)
    order = jnp.argsort(key)[:min(n_out, n)]
    ok = valid[order]
    outs = tuple(a[order] for a in arrays)
    if n < n_out:
        pad = n_out - n
        ok = jnp.pad(ok, (0, pad))
        outs = tuple(jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
                     for a in outs)
    return (ok,) + outs


@partial(jax.jit, static_argnames=("cfg",))
def insert_kf_bow(cfg: Config, ls: LoopState, kf_idx: jax.Array,
                  frame: StereoFrame) -> LoopState:
    """Compute this KF's dual BoW + dispersion stats, snapshot its features,
    and fill its conf-matrix row against all earlier KFs (:2976-2999):
    score = (sp*n_pt + sl*n_ln)/n_pl + (sp*std_pt + sl*std_ln)/std_pl."""
    f = frame.points
    fl = frame.lines
    vocab_p, vocab_l = active_vocab(cfg.cap.vocab_k)
    bow_p = bow_vector(f.desc, f.valid, vocab_p)
    bow_l = bow_vector(fl.desc, fl.valid, vocab_l)
    n_pt = jnp.sum(f.valid)
    n_ln = jnp.sum(fl.valid)
    std_pt = (_masked_stdv(f.xy[:, 0], f.valid)
              + _masked_stdv(f.xy[:, 1], f.valid))
    mid = 0.5 * (fl.sp + fl.ep)
    std_ln = (_masked_stdv(mid[:, 0], fl.valid)
              + _masked_stdv(mid[:, 1], fl.valid))

    df_p = ls.df_p + (bow_p > 0)
    df_l = ls.df_l + (bow_l > 0)
    n_docs = ls.n_docs + 1
    idf = active_idf(cfg.cap.vocab_k)
    if idf is not None:
        # frozen training-corpus idf (DBoW2 setNodeWeights semantics):
        # scores are epoch-consistent however many KFs accumulate
        sp = l1_score(_weighted_normalize(bow_p[None], jnp.asarray(idf[0])),
                      _weighted_normalize(ls.bow_p, jnp.asarray(idf[0])))
        sl = l1_score(_weighted_normalize(bow_l[None], jnp.asarray(idf[1])),
                      _weighted_normalize(ls.bow_l, jnp.asarray(idf[1])))
    else:
        # online-df fallback (untrained/random-anchor vocabularies)
        sp = l1_score(_idf_normalize(bow_p[None], df_p, n_docs),
                      _idf_normalize(ls.bow_p, df_p, n_docs))     # [K]
        sl = l1_score(_idf_normalize(bow_l[None], df_l, n_docs),
                      _idf_normalize(ls.bow_l, df_l, n_docs))
    n_pl = jnp.maximum(n_pt + n_ln, 1)
    std_pl = jnp.maximum(std_pt + std_ln, 1e-9)
    score = ((sp * n_pt + sl * n_ln) / n_pl
             + (sp * std_pt + sl * std_ln) / std_pl)
    prior = jnp.arange(ls.conf.shape[0]) < kf_idx
    row = jnp.where(prior, score, 0.0)
    conf = ls.conf.at[kf_idx, :].set(row)
    conf = conf.at[:, kf_idx].set(row)

    # quality keys: FAST corner response for points (frame.points rows are
    # left-feature-aligned, see stereo_match_points), length for lines (the
    # reference's own LSD budget keeps the longest/strongest-response
    # segments, stereoFrame.cpp:1155-1201)
    pt_score = frame.feat_l.pt_score
    ln_len = jnp.linalg.norm(fl.ep - fl.sp, axis=1)
    ok_p, p3, uv, dp, s2p = _topk_snapshot(f.valid, pt_score, N_KF_PT,
                                           f.p3d, f.xy, f.desc, f.sigma2)
    ok_l, s3, e3, le, dl, s2l = _topk_snapshot(fl.valid, ln_len, N_KF_LN,
                                               fl.sp3d, fl.ep3d, fl.le,
                                               fl.desc, fl.sigma2)
    return ls._replace(
        bow_p=ls.bow_p.at[kf_idx].set(bow_p),
        bow_l=ls.bow_l.at[kf_idx].set(bow_l),
        df_p=df_p, df_l=df_l, n_docs=n_docs,
        n_pt=ls.n_pt.at[kf_idx].set(n_pt),
        n_ln=ls.n_ln.at[kf_idx].set(n_ln),
        std_pt=ls.std_pt.at[kf_idx].set(std_pt),
        std_ln=ls.std_ln.at[kf_idx].set(std_ln),
        conf=conf,
        pt_p3d=ls.pt_p3d.at[kf_idx].set(p3),
        pt_uv=ls.pt_uv.at[kf_idx].set(uv),
        pt_desc=ls.pt_desc.at[kf_idx].set(dp),
        pt_sigma2=ls.pt_sigma2.at[kf_idx].set(s2p),
        pt_valid=ls.pt_valid.at[kf_idx].set(ok_p),
        ln_sp3d=ls.ln_sp3d.at[kf_idx].set(s3),
        ln_ep3d=ls.ln_ep3d.at[kf_idx].set(e3),
        ln_le=ls.ln_le.at[kf_idx].set(le),
        ln_desc=ls.ln_desc.at[kf_idx].set(dl),
        ln_sigma2=ls.ln_sigma2.at[kf_idx].set(s2l),
        ln_valid=ls.ln_valid.at[kf_idx].set(ok_l),
        n_snapshot_dropped=(ls.n_snapshot_dropped
                            + jnp.maximum(n_pt - N_KF_PT, 0)
                            + jnp.maximum(n_ln - N_KF_LN, 0)))


@partial(jax.jit, static_argnames=("cfg",))
def look_for_loop_candidates(cfg: Config, ls: LoopState,
                             full_graph: jax.Array,
                             kf_curr: jax.Array) -> jax.Array:
    """Candidate KF index or -1 (lookForLoopCandidates, :3002-3076)."""
    s = cfg.slam
    k = ls.conf.shape[0]
    ids = jnp.arange(k)
    row = ls.conf[kf_curr]
    far = ids < kf_curr - s.lc_kf_dist
    # min score among covisible/recent KFs (the adaptive threshold)
    connected = ((full_graph[:, kf_curr] + full_graph[kf_curr, :]
                  >= s.min_lm_cov_graph)
                 | ((kf_curr - ids <= s.min_kf_local_map + 3) & (ids < kf_curr)))
    cscores = jnp.where(connected & (row > 0.001), row, jnp.inf)
    lc_min_score = jnp.minimum(jnp.min(cscores), 1.0)

    cand_scores = jnp.where(far, row, -jnp.inf)
    idx_max = jnp.argmax(cand_scores)
    best = cand_scores[idx_max]
    # temporal consistency: enough KFs near idx_max also scoring high
    near = (jnp.abs(ids - idx_max) <= s.lc_kf_max_dist) & far & (ids != idx_max)
    n_closest = jnp.sum(near & (row >= lc_min_score * 0.8))
    n_far = jnp.sum(far)
    ok = ((n_far > s.lc_kf_max_dist) & (best >= lc_min_score)
          & (n_closest >= s.lc_nkf_closest))
    return jnp.where(ok, idx_max, -1)


class LoopVerification(NamedTuple):
    accepted: jax.Array   # bool
    t_rel: jax.Array      # [4,4] T_curr<-prev relative pose estimate
    n_inliers: jax.Array
    err: jax.Array


@partial(jax.jit, static_argnames=("cfg",))
def verify_loop(cfg: Config, ls: LoopState, kf_prev: jax.Array,
                kf_curr: jax.Array) -> LoopVerification:
    """KF<->KF mutual-best matching + robust GN from identity + acceptance
    gates (isLoopClosure/computeRelativePoseGN, :3078-3545): residual <
    lc_res, cov eig < lc_unc, inlier ratio > lc_inl, |t| < lc_trs,
    rot < lc_rot degrees."""
    s = cfg.slam
    dp = hamming_matrix(ls.pt_desc[kf_prev], ls.pt_desc[kf_curr],
                        ls.pt_valid[kf_prev], ls.pt_valid[kf_curr])
    mp = match_ops.mutual_best(dp)
    pts = pose_opt.PointMatches(
        p3d=ls.pt_p3d[kf_prev], obs=ls.pt_uv[kf_curr][mp.idx],
        sigma2=ls.pt_sigma2[kf_prev], valid=mp.valid)
    dl = hamming_matrix(ls.ln_desc[kf_prev], ls.ln_desc[kf_curr],
                        ls.ln_valid[kf_prev], ls.ln_valid[kf_curr])
    ml = match_ops.mutual_best(dl)
    lns = pose_opt.LineMatches(
        sp3d=ls.ln_sp3d[kf_prev], ep3d=ls.ln_ep3d[kf_prev],
        le_obs=ls.ln_le[kf_curr][ml.idx],
        sigma2=ls.ln_sigma2[kf_prev], valid=ml.valid)

    res = pose_opt.optimize_pose(cfg.camera, jnp.eye(4), pts, lns,
                                 cfg.optimizer, delta_t=1e9)
    n_match = jnp.sum(mp.valid) + jnp.sum(ml.valid)
    n_inl = jnp.sum(res.pt_inlier) + jnp.sum(res.ln_inlier)
    inl_ratio = n_inl / jnp.maximum(n_match, 1)
    tw = se3.logmap_se3(res.dt)
    trans = jnp.linalg.norm(tw[:3])
    rot_deg = jnp.linalg.norm(tw[3:]) * 180.0 / jnp.pi
    max_cov_eig = jnp.max(jnp.linalg.eigvalsh(
        res.dt_cov + 1e-12 * jnp.eye(6)))
    accepted = (res.accepted
                & (res.err < s.lc_res) & (res.err >= 0)
                & (max_cov_eig < s.lc_unc)
                & (inl_ratio > s.lc_inl)
                & (trans < s.lc_trs)
                & (rot_deg < s.lc_rot))
    return LoopVerification(accepted=accepted, t_rel=res.dt,
                            n_inliers=n_inl, err=res.err)


# ---------------------------------------------------------------------------
# Pose-graph optimization (g2o replacement)
# ---------------------------------------------------------------------------

class PoseGraphEdges(NamedTuple):
    i: jax.Array       # [E] int32
    j: jax.Array       # [E] int32
    t_ij: jax.Array    # [E, 4, 4] measured T_i^-1 T_j
    valid: jax.Array   # [E] bool


def build_edges(kf_pose: jax.Array, kf_valid: jax.Array,
                full_graph: jax.Array, min_covis: int,
                lc_i: jax.Array, lc_j: jax.Array, lc_t: jax.Array,
                max_edges: int,
                lc_valid: jax.Array | None = None) -> PoseGraphEdges:
    """Sequential + covisibility + loop edges (:4029-4066). Measurements for
    sequential/covis edges are taken from current estimates (the reference
    does the same before correction).

    ``lc_i/lc_j`` [C] and ``lc_t`` [C, 4, 4] carry one or more verified loop
    constraints (the reference accumulates lc_idx_list/lc_pose_list while
    LC_ACTIVE and adds an edge per constraint, :4052-4066).
    """
    k = kf_pose.shape[0]
    ids = jnp.arange(k)
    lc_i = jnp.atleast_1d(lc_i)
    lc_j = jnp.atleast_1d(lc_j)
    lc_t = lc_t.reshape(-1, 4, 4)
    n_lc = lc_i.shape[0]
    # sequential edges: each valid KF to the PREVIOUS valid KF (chains across
    # holes left by remove_redundant_kfs)
    vid = jnp.where(kf_valid, ids, -1)
    cm = jax.lax.cummax(vid)
    prev = jnp.concatenate([jnp.asarray([-1]), cm[:-1]])
    seq_ok = kf_valid & (prev >= 0)
    seq_i = jnp.where(seq_ok, prev, 0)[1:]
    seq_j = ids[1:]
    seq_ok = seq_ok[1:]
    # covisibility edges above threshold (upper triangle), strongest first
    counts = full_graph + full_graph.T
    iu, ju = jnp.triu_indices(k, 1)
    cov_ok = ((counts[iu, ju] >= min_covis) & kf_valid[iu] & kf_valid[ju]
              & (ju != iu + 1))
    # keep the strongest-covisibility edges within the budget
    budget = max_edges - (k - 1) - n_lc
    vals, sel_pos = jax.lax.top_k(
        jnp.where(cov_ok, counts[iu, ju], -1), budget)
    sel_ok = vals >= min_covis
    cov_i = iu[sel_pos]
    cov_j = ju[sel_pos]

    e_i = jnp.concatenate([seq_i, cov_i, lc_i])
    e_j = jnp.concatenate([seq_j, cov_j, lc_j])
    # lc_valid lets callers pad the LC-constraint set to a FIXED length so
    # the pose-graph programs compile once (every distinct constraint count
    # otherwise recompiles the whole PGO at the full KF capacity)
    lc_ok = (jnp.ones(n_lc, bool) if lc_valid is None
             else jnp.asarray(lc_valid, bool))
    e_ok = jnp.concatenate([seq_ok, sel_ok, lc_ok])

    t_inv = jax.vmap(se3.inverse_se3)(kf_pose)
    t_ij = jax.vmap(lambda a, b: t_inv[a] @ kf_pose[b])(e_i, e_j)
    # overwrite the LC edges with the verified measurements
    t_ij = t_ij.at[-n_lc:].set(lc_t)
    return PoseGraphEdges(i=e_i, j=e_j, t_ij=t_ij, valid=e_ok)


@partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(kf_pose: jax.Array, kf_valid: jax.Array,
                        edges: PoseGraphEdges, fixed: jax.Array,
                        iters: int = 50) -> jax.Array:
    """Dense GN on SE(3) pose graph: residual r = log(T_ij^-1 T_i^-1 T_j),
    identity information (:4052-4072). Replaces g2o LM + Cholmod."""
    k = kf_pose.shape[0]

    def residual(x, ei, ej, tij):
        # x: [K, 6] twist corrections applied as T <- T exp(x)
        ti = kf_pose[ei] @ se3.expmap_se3(x[ei])
        tj = kf_pose[ej] @ se3.expmap_se3(x[ej])
        return se3.logmap_se3(se3.inverse_se3(tij) @ se3.inverse_se3(ti) @ tj)

    def gn_step(x):
        def edge_terms(ei, ej, tij, ok):
            r = residual(x, ei, ej, tij)
            ji = jax.jacfwd(lambda d: residual(
                x.at[ei].add(d), ei, ej, tij))(jnp.zeros(6))
            jj = jax.jacfwd(lambda d: residual(
                x.at[ej].add(d), ei, ej, tij))(jnp.zeros(6))
            w = ok.astype(jnp.float32)
            return r * w, ji * w, jj * w
        r, ji, jj = jax.vmap(edge_terms)(edges.i, edges.j, edges.t_ij,
                                         edges.valid)
        # assemble H [K,6,K,6], b [K,6]
        h = jnp.zeros((k, 6, k, 6))
        h = h.at[edges.i, :, edges.i, :].add(
            jnp.einsum("eri,erj->eij", ji, ji))
        h = h.at[edges.j, :, edges.j, :].add(
            jnp.einsum("eri,erj->eij", jj, jj))
        h = h.at[edges.i, :, edges.j, :].add(
            jnp.einsum("eri,erj->eij", ji, jj))
        h = h.at[edges.j, :, edges.i, :].add(
            jnp.einsum("eri,erj->eij", jj, ji))
        b = jnp.zeros((k, 6))
        b = b.at[edges.i].add(jnp.einsum("eri,er->ei", ji, r))
        b = b.at[edges.j].add(jnp.einsum("eri,er->ei", jj, r))
        free = (kf_valid & ~fixed)
        mask = jnp.repeat(free, 6)
        hf = h.reshape(6 * k, 6 * k)
        hf = jnp.where(mask[:, None] & mask[None, :], hf, 0.0)
        hf = hf + jnp.diag(jnp.where(mask, 1e-8, 1.0))
        bf = jnp.where(mask, b.reshape(-1), 0.0)
        dx = jnp.linalg.solve(hf, bf).reshape(k, 6)
        return x - jnp.where(free[:, None], dx, 0.0)

    def cond(carry):
        _, it, delta = carry
        return (it < iters) & (delta > 1e-7)

    def body(carry):
        x, it, _ = carry
        x_new = gn_step(x)
        return x_new, it + 1, jnp.max(jnp.abs(x_new - x))

    x, _, _ = jax.lax.while_loop(
        cond, body, (jnp.zeros((k, 6)), jnp.asarray(0, jnp.int32),
                     jnp.asarray(jnp.inf)))
    return jax.vmap(lambda t, d: t @ se3.expmap_se3(d))(kf_pose, x)


def rigid_correct_landmarks(kf_old: jax.Array, kf_new: jax.Array,
                            lm_pos: jax.Array, lm_kf: jax.Array,
                            lm_valid: jax.Array) -> jax.Array:
    """Apply each landmark's owner-KF correction T_new T_old^-1 (:4074-4127)."""
    t_corr = jax.vmap(lambda a, b: a @ se3.inverse_se3(b))(kf_new, kf_old)
    def one(p, k, ok):
        t = t_corr[k]
        return jnp.where(ok, t[:3, :3] @ p + t[:3, 3], p)
    return jax.vmap(one)(lm_pos, lm_kf, lm_valid)
