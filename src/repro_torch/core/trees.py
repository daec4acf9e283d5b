"""Ensemble-learning baselines (§2.4, §6): Random Forest and gradient-
boosted decision trees (the paper uses XGBoost; same algorithm family,
own numpy implementation since xgboost is not in the container).

Both are wait-time regressors over the compact summary features
(state.summary_features). Serving policy: submit the successor when the
predecessor's remaining wall-clock is <= the predicted queue wait — the
learned generalization of the `avg` heuristic.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------- CART core
@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class RegressionTree:
    """Depth-limited CART with variance-reduction splits on quantile
    candidate thresholds (histogram-style)."""

    def __init__(self, max_depth: int = 6, min_leaf: int = 8,
                 n_thresholds: int = 16, feature_frac: float = 1.0,
                 seed: int = 0):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.n_thresholds = n_thresholds
        self.feature_frac = feature_frac
        self.rng = np.random.default_rng(seed)
        self.nodes: List[_Node] = []
        self._packed = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        self.nodes = []
        self._packed = None
        self._grow(X, y, 0)
        self._pack()
        return self

    def _pack(self) -> None:
        """Freeze the node list into flat arrays once per fit, so the
        batched predict on the evaluation hot path (one call per lockstep
        decision across B lanes) doesn't rebuild them every step."""
        n = len(self.nodes)
        self._packed = (
            np.fromiter((nd.feature for nd in self.nodes), np.int64, n),
            np.fromiter((nd.threshold for nd in self.nodes), np.float64, n),
            np.fromiter((nd.left for nd in self.nodes), np.int64, n),
            np.fromiter((nd.right for nd in self.nodes), np.int64, n),
            np.fromiter((nd.value for nd in self.nodes), np.float64, n),
        )

    def _grow(self, X, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(y.mean()) if len(y) else 0.0))
        if depth >= self.max_depth or len(y) < 2 * self.min_leaf or y.std() < 1e-9:
            return idx
        n, n_feat = X.shape
        feats = self.rng.choice(
            n_feat, max(1, int(self.feature_frac * n_feat)), replace=False)
        yc = y - y.mean()      # centering: SSE is translation-invariant and
        parent_sse = float((yc ** 2).sum())   # the scan stays well-conditioned
        # score every (feature, quantile-threshold) candidate in one
        # variance-reduction pass: one batched quantile call gives the
        # (T, F) threshold grid, a (T, n, F) <= mask gives the left-prefix
        # counts/sums, and SSE(side) = sum(yc^2) - sum(yc)^2/n per side.
        # The threshold grid is cast to the column dtype so the scan, the
        # stored threshold, and the recursion partition below (a weak-
        # promotion column-dtype comparison) all count the same prefixes.
        # Memory is T*n*F bools per node — these baselines fit hundreds
        # of samples.
        Xf = X[:, feats]
        qs = np.quantile(Xf, np.linspace(0.05, 0.95, self.n_thresholds),
                         axis=0)                         # (T, F)
        if np.issubdtype(Xf.dtype, np.floating):
            qs = qs.astype(Xf.dtype)
        le = Xf[None, :, :] <= qs[:, None, :]            # (T, n, F)
        nl = le.sum(axis=1)
        nr = n - nl
        m3 = le.astype(np.float64)
        sl = np.einsum("tnf,n->tf", m3, yc)
        sl2 = np.einsum("tnf,n->tf", m3, yc * yc)
        sr = yc.sum() - sl
        sr2 = (yc * yc).sum() - sl2
        with np.errstate(divide="ignore", invalid="ignore"):
            sse = (sl2 - sl * sl / nl) + (sr2 - sr * sr / nr)
        gains = np.where((nl >= self.min_leaf) & (nr >= self.min_leaf),
                         parent_sse - sse, -np.inf)
        # first-max in (feature-order, threshold-ascending) — the original
        # nested-loop iteration order with its strict-> tie-break
        k = int(np.argmax(gains.T))
        fj, tj = divmod(k, gains.shape[0])
        if not gains[tj, fj] > 0.0:
            return idx
        f, t = int(feats[fj]), float(qs[tj, fj])
        m = X[:, f] <= t
        node = self.nodes[idx]
        node.feature, node.threshold = f, t
        node.left = self._grow(X[m], y[m], depth + 1)
        node.right = self._grow(X[~m], y[~m], depth + 1)
        return idx

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Level-synchronous batched traversal: every sample routes one
        tree level per iteration (<= max_depth iterations total)."""
        X = np.asarray(X)
        if self._packed is None:
            self._pack()
        feat, thr, left, right, val = self._packed
        if np.issubdtype(X.dtype, np.floating):
            thr = thr.astype(X.dtype)   # weak-promotion comparison semantics
        cur = np.zeros(len(X), np.int64)
        rows = np.arange(len(X))
        while True:
            f = feat[cur]
            inner = f >= 0
            if not inner.any():
                break
            r, c = rows[inner], cur[inner]
            go_left = X[r, f[inner]] <= thr[c]
            cur[r] = np.where(go_left, left[c], right[c])
        return val[cur]


class RandomForest:
    """Bootstrap-aggregated CART regressors [Breiman 2001]."""

    def __init__(self, n_trees: int = 20, max_depth: int = 8,
                 feature_frac: float = 0.5, seed: int = 0):
        self.n_trees, self.max_depth = n_trees, max_depth
        self.feature_frac = feature_frac
        self.seed = seed
        self.trees: List[RegressionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for t in range(self.n_trees):
            ids = rng.integers(0, len(X), len(X))
            tree = RegressionTree(max_depth=self.max_depth,
                                  feature_frac=self.feature_frac,
                                  seed=self.seed + t)
            self.trees.append(tree.fit(X[ids], y[ids]))
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(X) for t in self.trees], axis=0)


class GradientBoosting:
    """Squared-loss gradient boosting [Friedman 2001] (XGBoost stand-in)."""

    def __init__(self, n_rounds: int = 40, max_depth: int = 4,
                 lr: float = 0.1, seed: int = 0):
        self.n_rounds, self.max_depth, self.lr = n_rounds, max_depth, lr
        self.seed = seed
        self.trees: List[RegressionTree] = []
        self.base = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoosting":
        self.base = float(y.mean())
        pred = np.full(len(y), self.base)
        self.trees = []
        for t in range(self.n_rounds):
            resid = y - pred
            tree = RegressionTree(max_depth=self.max_depth, seed=self.seed + t)
            tree.fit(X, resid)
            pred = pred + self.lr * tree.predict(X)
            self.trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        pred = np.full(len(X), self.base)
        for t in self.trees:
            pred = pred + self.lr * t.predict(X)
        return pred
