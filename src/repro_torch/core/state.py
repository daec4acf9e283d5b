"""State encoding (§4.1-4.3): the 40-variable snapshot vector and the
(k x m) state matrix with 10-minute sampling over a 24 h history window.

Variable map (paper §4.1):
  var1        n_queued
  var2-6      queued sizes      p0/p25/p50/p75/p100
  var7-11     queued ages       p0/p25/p50/p75/p100
  var12-16    queued limits     p0/p25/p50/p75/p100
  var17       n_running
  var18-24    running sizes     p0/p25/p50/p75/p100 + mean + std  (7 stats)
  var25-29    running elapsed   p0/p25/p50/p75/p100
  var30-34    running limits    p0/p25/p50/p75/p100
  var35-38    predecessor: size, limit, queue time, elapsed runtime
  var39-40    successor:   size, limit

All features are normalized (sizes by cluster nodes, times by the 48 h
limit, counts by /100) so one trained network transfers across clusters
only in *shape* — per the paper, models must be trained per cluster.

Batch-first building blocks carry the same encoding for B lockstep
episodes: ``encode_sample_batch`` turns a flat ``repro.sim.SampleBatch``
into a (B, 40) slab with one segment-sorted percentile pass (lexsort on
(lane, value), vectorized quantile gather via the per-lane offsets) —
bit-identical to per-lane ``encode_snapshot`` — and ``StateHistoryBatch``
keeps B ring buffers with independent cursors, so done/ragged lanes can
freeze while live lanes advance. ``VectorProvisionEnv`` runs its whole
observation path on these (one numpy pass per lockstep interval).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.sim.simulator import SampleBatch

HOUR = 3600.0
STATE_DIM = 40
DEFAULT_HISTORY = 144          # 24h at 10-min sampling
SAMPLE_INTERVAL = 600.0        # 10 minutes

_QFRAC = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float64)


def _pcts(vals, scale: float) -> np.ndarray:
    """p0/p25/p50/p75/p100 via direct sort + linear interpolation —
    numerically identical to np.percentile's default method, without its
    per-call dispatch overhead (this runs per snapshot on the rollout
    hot path)."""
    v = np.asarray(vals, np.float64)
    if v.size == 0:
        return np.zeros(5, np.float32)
    v = np.sort(v)
    q = (v.size - 1) * _QFRAC
    lo = q.astype(np.int64)
    hi = np.minimum(lo + 1, v.size - 1)
    frac = q - lo
    out = v[lo] * (1.0 - frac) + v[hi] * frac
    return (out / scale).astype(np.float32)


def encode_snapshot(sample: Dict, n_nodes: int, limit: float,
                    pred: Optional[Dict] = None,
                    succ: Optional[Dict] = None) -> np.ndarray:
    """sample: SlurmSimulator.sample() output -> (40,) float32."""
    v = np.zeros(STATE_DIM, np.float32)
    v[0] = sample["n_queued"] / 100.0
    v[1:6] = _pcts(sample["queued_sizes"], n_nodes)
    v[6:11] = _pcts(sample["queued_ages"], limit)
    v[11:16] = _pcts(sample["queued_limits"], limit)
    v[16] = sample["n_running"] / 100.0
    rs = np.asarray(sample["running_sizes"], np.float64)
    v[17:22] = _pcts(rs, n_nodes)
    if rs.size:
        v[22] = float(rs.mean()) / n_nodes
        v[23] = float(rs.std()) / n_nodes
    v[24:29] = _pcts(sample["running_elapsed"], limit)
    v[29:34] = _pcts(sample["running_limits"], limit)
    if pred:
        v[34] = pred.get("size", 0) / n_nodes
        v[35] = pred.get("limit", 0) / limit
        v[36] = pred.get("queue_time", 0) / limit
        v[37] = pred.get("elapsed", 0) / limit
    if succ:
        v[38] = succ.get("size", 0) / n_nodes
        v[39] = succ.get("limit", 0) / limit
    return v


def _segment_pcts(vals: np.ndarray, off: np.ndarray, scale: float,
                  out: np.ndarray) -> None:
    """Per-lane p0/p25/p50/p75/p100 over CSR-flat ragged values -> out (B, 5).

    One lexsort on (lane, value) orders every lane's population in place;
    the five quantile gathers are then vectorized over lanes via the
    offsets. Arithmetic matches ``_pcts`` operation for operation (same
    index/frac computation, same interpolation, same final divide-and-cast),
    so the result is bit-identical to the per-lane scalar path. Empty
    lanes encode as zeros, as in ``_pcts``.
    """
    out[:] = 0.0
    counts = np.diff(off)
    nz = np.flatnonzero(counts)
    if not nz.size:
        return
    lane = np.repeat(np.arange(counts.size), counts)
    sv = vals[np.lexsort((vals, lane))]
    n1 = (counts[nz] - 1)[:, None]
    starts = off[:-1][nz][:, None]
    q = n1 * _QFRAC
    lo = q.astype(np.int64)
    hi = np.minimum(lo + 1, n1)
    frac = q - lo
    res = sv[starts + lo] * (1.0 - frac) + sv[starts + hi] * frac
    out[nz] = (res / scale).astype(np.float32)


def encode_sample_batch(sb: SampleBatch, n_nodes: int, limit: float,
                        pred_cols: Optional[np.ndarray] = None,
                        succ_cols: Optional[np.ndarray] = None,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
    """Flat-layout batched snapshot encoding -> (B, 40) float32.

    ``sb`` is ``repro.sim.sample_batch(sims)`` output. ``pred_cols`` is an
    optional (B, 4) float64 array of raw predecessor features per lane —
    columns (size, limit, queue_time, elapsed); zero rows mean "no
    predecessor" (they normalize to the zeros the scalar path writes).
    ``succ_cols`` likewise is (B, 2) raw (size, limit). With ``out`` the
    slab is written into a preallocated buffer (the vector env reuses one
    across steps). Bit-identical to per-lane ``encode_snapshot``; the
    only per-lane Python left is the running-size mean/std pair, which
    must use ``np.mean``'s pairwise summation over the lane's original
    order to preserve bit-identity.
    """
    B = sb.batch
    v = out if out is not None else np.empty((B, STATE_DIM), np.float32)
    assert v.shape == (B, STATE_DIM)
    v[:, 0] = sb.q_count / 100.0
    _segment_pcts(sb.q_sizes, sb.q_off, n_nodes, v[:, 1:6])
    _segment_pcts(sb.q_ages, sb.q_off, limit, v[:, 6:11])
    _segment_pcts(sb.q_limits, sb.q_off, limit, v[:, 11:16])
    v[:, 16] = sb.r_count / 100.0
    _segment_pcts(sb.r_sizes, sb.r_off, n_nodes, v[:, 17:22])
    v[:, 22] = 0.0
    v[:, 23] = 0.0
    off = sb.r_off
    # documented contract exception: the running-size mean/std pair must
    # keep np.mean's pairwise summation over each lane's original order
    # to stay bit-identical to the scalar path (ROADMAP "Flat batched
    # sampling")
    for b in np.flatnonzero(sb.r_count):   # repro-static: ok[lane-loop]
        seg = sb.r_sizes[off[b]:off[b + 1]]
        v[b, 22] = float(seg.mean()) / n_nodes
        v[b, 23] = float(seg.std()) / n_nodes
    _segment_pcts(sb.r_elapsed, sb.r_off, limit, v[:, 24:29])
    _segment_pcts(sb.r_limits, sb.r_off, limit, v[:, 29:34])
    if pred_cols is None:
        v[:, 34:38] = 0.0
    else:
        v[:, 34] = pred_cols[:, 0] / n_nodes
        v[:, 35] = pred_cols[:, 1] / limit
        v[:, 36] = pred_cols[:, 2] / limit
        v[:, 37] = pred_cols[:, 3] / limit
    if succ_cols is None:
        v[:, 38:40] = 0.0
    else:
        v[:, 38] = succ_cols[:, 0] / n_nodes
        v[:, 39] = succ_cols[:, 1] / limit
    return v


def _flatten_samples(samples: Sequence[Dict]) -> SampleBatch:
    """Adapt per-lane ``SlurmSimulator.sample()`` dicts to the flat layout."""
    B = len(samples)
    q_count = np.fromiter((s["n_queued"] for s in samples), np.int64, B)
    r_count = np.fromiter((s["n_running"] for s in samples), np.int64, B)
    times = np.fromiter((s.get("time", 0.0) for s in samples), np.float64, B)
    q_off = np.zeros(B + 1, np.int64)
    r_off = np.zeros(B + 1, np.int64)
    np.cumsum(q_count, out=q_off[1:])
    np.cumsum(r_count, out=r_off[1:])

    def flat(key, off):
        out = np.empty(off[-1], np.float64)
        # dict-API adapter, not the batched hot path (the vector env
        # feeds sample_batch flats directly)
        for b, s in enumerate(samples):   # repro-static: ok[lane-loop]
            if off[b + 1] > off[b]:
                out[off[b]:off[b + 1]] = np.asarray(s[key], np.float64)
        return out

    return SampleBatch(times, q_count, q_off, flat("queued_sizes", q_off),
                       flat("queued_ages", q_off), flat("queued_limits", q_off),
                       r_count, r_off, flat("running_sizes", r_off),
                       flat("running_elapsed", r_off),
                       flat("running_limits", r_off))


def pack_pair_cols(preds: Optional[Sequence[Optional[Dict]]],
                   succs: Optional[Sequence[Optional[Dict]]], B: int
                   ) -> tuple:
    """Dict-form pred/succ infos -> the (B, 4)/(B, 2) raw column arrays."""
    pred_cols = succ_cols = None
    if preds is not None:
        pred_cols = np.zeros((B, 4), np.float64)
        for b, p in enumerate(preds):  # repro-static: ok[lane-loop] adapter
            if p:
                pred_cols[b] = (p.get("size", 0), p.get("limit", 0),
                                p.get("queue_time", 0), p.get("elapsed", 0))
    if succs is not None:
        succ_cols = np.zeros((B, 2), np.float64)
        for b, s in enumerate(succs):  # repro-static: ok[lane-loop] adapter
            if s:
                succ_cols[b] = (s.get("size", 0), s.get("limit", 0))
    return pred_cols, succ_cols


def encode_snapshots(samples: Sequence[Dict], n_nodes: int, limit: float,
                     preds: Optional[Sequence[Optional[Dict]]] = None,
                     succs: Optional[Sequence[Optional[Dict]]] = None
                     ) -> np.ndarray:
    """Batched snapshot encoding -> (B, 40) float32.

    Dict-API front end of ``encode_sample_batch``: the ragged per-lane
    populations are flattened once and every percentile scan runs as one
    segment-sorted numpy pass over the whole batch, not B Python loops.
    Bit-identical to calling ``encode_snapshot`` per lane.
    """
    pred_cols, succ_cols = pack_pair_cols(preds, succs, len(samples))
    return encode_sample_batch(_flatten_samples(samples), n_nodes, limit,
                               pred_cols, succ_cols)


@dataclasses.dataclass
class StateHistory:
    """Ring buffer of snapshot vectors -> the (k, 40) state matrix.

    Index-based ring: ``push`` is an O(d) row write (no O(k*d) roll);
    ``matrix`` materializes the oldest-first view on demand.
    """
    k: int = DEFAULT_HISTORY
    _buf: Optional[np.ndarray] = None
    _pos: int = 0
    _n: int = 0

    def __post_init__(self):
        self._buf = np.zeros((self.k, STATE_DIM), np.float32)

    def push(self, v: np.ndarray) -> None:
        self._buf[self._pos] = v
        self._pos = (self._pos + 1) % self.k
        self._n = min(self._n + 1, self.k)

    def matrix(self) -> np.ndarray:
        """(k, 40): oldest row first; zero-padded during warm-up."""
        if self._pos == 0:
            return self._buf.copy()
        return np.concatenate([self._buf[self._pos:], self._buf[:self._pos]])

    @property
    def filled(self) -> int:
        return self._n


@dataclasses.dataclass
class StateHistoryBatch:
    """B ring buffers with independent cursors -> the (B, k, 40) stack.

    Each lane keeps its own write cursor, so a push may address any lane
    subset: lanes advancing together write one (n, 40) slab in place,
    while done (or warm-up-ragged) lanes simply don't advance and their
    window stays frozen — each lane's ring evolves exactly like a scalar
    ``StateHistory`` fed the same per-lane push sequence.
    """
    batch: int
    k: int = DEFAULT_HISTORY
    _buf: Optional[np.ndarray] = None
    _pos: Optional[np.ndarray] = None
    _n: Optional[np.ndarray] = None

    def __post_init__(self):
        self._buf = np.zeros((self.batch, self.k, STATE_DIM), np.float32)
        self._pos = np.zeros(self.batch, np.int64)
        self._n = np.zeros(self.batch, np.int64)

    def clear(self) -> None:
        self._buf[:] = 0.0
        self._pos[:] = 0
        self._n[:] = 0

    def push(self, v: np.ndarray, lanes: Optional[np.ndarray] = None) -> None:
        """v: (B, 40) slab — or (n_lanes, 40) with ``lanes`` indices.
        Only the addressed lanes' cursors advance."""
        if lanes is None:
            lanes = np.arange(self.batch)
        p = self._pos[lanes]
        self._buf[lanes, p] = v
        self._pos[lanes] = (p + 1) % self.k
        self._n[lanes] = np.minimum(self._n[lanes] + 1, self.k)

    def matrix_into(self, out: np.ndarray,
                    lanes: Optional[np.ndarray] = None) -> None:
        """Write oldest-row-first (k, 40) views for ``lanes`` into ``out``
        (a persistent (B, k, 40) buffer) without fresh allocation. Lanes
        sharing a cursor position (the common lockstep case) roll with two
        slab copies."""
        lanes = np.arange(self.batch) if lanes is None else np.asarray(lanes)
        pos = self._pos[lanes]
        for p in np.unique(pos):
            l = lanes[pos == p]
            if p == 0:
                out[l] = self._buf[l]
            else:
                out[l, :self.k - p] = self._buf[l, p:]
                out[l, self.k - p:] = self._buf[l, :p]

    def matrix(self) -> np.ndarray:
        """(B, k, 40): oldest row first per lane."""
        out = np.empty_like(self._buf)
        self.matrix_into(out)
        return out

    def lane(self, b: int) -> np.ndarray:
        """(k, 40) for one lane (oldest row first)."""
        p = int(self._pos[b])
        if p == 0:
            return self._buf[b].copy()
        return np.concatenate([self._buf[b, p:], self._buf[b, :p]])

    def load_lane(self, b: int, mat: np.ndarray) -> None:
        """Seed lane ``b`` with a full oldest-first (k, 40) window."""
        self._buf[b] = mat
        self._pos[b] = 0
        self._n[b] = self.k

    @property
    def filled(self) -> int:
        """Rows valid in the least-filled lane."""
        return int(self._n.min()) if self.batch else 0


def flatten_state(matrix: np.ndarray, action: int) -> np.ndarray:
    """Paper §4.3: flattened (k*40 + 1,) with the ordinal action variable
    appended (1 submit / -1 no-submit / 0 placeholder for the PG head)."""
    return np.concatenate([matrix.reshape(-1),
                           np.asarray([action], np.float32)])


def summary_offsets(k: int) -> tuple:
    """History-row indices of the trend-delta anchors (1h, 6h, 24h ago at
    10-min sampling) for a k-row window — the single source of truth for
    both the scalar ``summary_features`` and the vector env's batched
    summary writer."""
    return (max(0, k - 1 - 6), max(0, k - 1 - 36), 0)


def summary_features(matrix: np.ndarray) -> np.ndarray:
    """Compact features for the tree baselines: the current snapshot plus
    trend deltas over the history window (last - {1h, 6h, 24h} ago)."""
    cur = matrix[-1]
    deltas = [cur - matrix[i] for i in summary_offsets(matrix.shape[0])]
    return np.concatenate([cur] + deltas).astype(np.float32)


def summary_features_batch(mat: np.ndarray, lanes: np.ndarray,
                           out: np.ndarray) -> None:
    """Batched ``summary_features``: write ``lanes``' summary rows of the
    (B, k, 40) matrix stack into ``out`` (a persistent (B, 4*40) buffer).
    Row layout matches the scalar function exactly — the (B, F) block the
    tree policies consume in one batched predict."""
    k = mat.shape[1]
    i1, i6, i24 = summary_offsets(k)
    cur = mat[lanes, k - 1]
    out[lanes, 0:STATE_DIM] = cur
    out[lanes, STATE_DIM:2 * STATE_DIM] = cur - mat[lanes, i1]
    out[lanes, 2 * STATE_DIM:3 * STATE_DIM] = cur - mat[lanes, i6]
    out[lanes, 3 * STATE_DIM:4 * STATE_DIM] = cur - mat[lanes, i24]
