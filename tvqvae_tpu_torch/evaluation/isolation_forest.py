"""Isolation forest in numpy: the outlier filter in front of every FID.

The JAX package filters with scikit-learn's ``IsolationForest``
(``tvqvae_tpu/evaluation/eval_utils.py::remove_outliers``); the card's
machine has no scikit-learn, so the port keeps its own copy of the
algorithm, used everywhere, so that a score never depends on what the
machine has installed. It has the one configuration ``remove_outliers``
uses (the module constants below); what sklearn does there, with
``max_features=1.0`` and no bootstrap:

- each of ``N_ESTIMATORS`` trees grows on ``int(MAX_SAMPLES * n)`` rows
  drawn without replacement, to a depth of at most
  ``ceil(log2(max(that count, 2)))``;
- a node with at least two rows splits on a feature drawn uniformly from
  those not constant over its rows, at a threshold drawn uniformly between
  that feature's min and max (the max itself maps to the min), rows
  ``<= threshold`` going left; a node whose rows agree on every feature is
  a leaf;
- a row's path length in a tree is its leaf's depth plus c(n_leaf), with
  c(n) = 2 (ln(n - 1) + Euler's gamma) - 2 (n - 1) / n, c(2) = 1, c(1) = 0;
- ``score_samples`` = -2^(-mean path length / c(rows per tree)), and
  ``offset_`` the ``100 * CONTAMINATION`` percentile of the training rows'
  scores; ``fit_predict`` says 1 (inlier) where score - offset >= 0, else
  -1.

As in sklearn, rows are compared as float32. The draws come from
``np.random.RandomState(RANDOM_STATE)``, tree after tree and level after
level, so the forest is not sklearn's tree for tree (sklearn's splitter
draws from its own C stream); the tests hold the kept sets to the spread
sklearn's own forests show across seeds.
"""

import math

import numpy as np

# sklearn's IsolationForest(max_samples=0.9, contamination=0.1,
# random_state=0), as remove_outliers builds it
N_ESTIMATORS = 100
MAX_SAMPLES = 0.9
CONTAMINATION = 0.1
RANDOM_STATE = 0


def average_path_length(n) -> np.ndarray:
    """c(n) of each entry of ``n``: the mean path length of an unsuccessful
    search in a binary search tree of n keys."""
    n = np.asarray(n, np.float64)
    out = np.zeros_like(n)
    out[n == 2] = 1.0
    big = n > 2
    out[big] = 2.0 * (np.log(n[big] - 1.0) + np.euler_gamma) - 2.0 * (n[big] - 1.0) / n[big]
    return out


class _Tree:
    """One isolation tree as flat arrays over its nodes; a leaf has
    ``left == -1``."""

    def __init__(self, X: np.ndarray, rows: np.ndarray, max_depth: int,
                 rng: np.random.RandomState):
        n_features = X.shape[1]
        cap = 2 * len(rows)  # a binary tree over m rows has at most 2m - 1 nodes
        self.feature = np.full(cap, -1, np.int64)
        self.threshold = np.zeros(cap, np.float64)
        self.left = np.full(cap, -1, np.int64)
        self.right = np.full(cap, -1, np.int64)
        self.depth = np.zeros(cap, np.float64)
        n_nodes = 1
        node = np.zeros(len(rows), np.int64)  # the node each row sits in
        level = np.zeros(1, np.int64)  # the nodes at depth d
        for d in range(max_depth):
            split = level[np.bincount(node, minlength=n_nodes)[level] >= 2]
            if not len(split):
                break
            pos = np.full(n_nodes, -1)
            pos[split] = np.arange(len(split))
            moving = np.flatnonzero(pos[node] >= 0)
            row_pos = pos[node[moving]]
            f = rng.randint(n_features, size=len(split))
            vals = X[rows[moving], f[row_pos]]
            lo = np.full(len(split), np.inf, np.float32)
            hi = np.full(len(split), -np.inf, np.float32)
            np.minimum.at(lo, row_pos, vals)
            np.maximum.at(hi, row_pos, vals)
            keep = np.ones(len(split), bool)
            for i in np.flatnonzero(lo == hi):
                # redraw among the features this node's rows do not agree on:
                # with the first draw, uniform over the non-constant features
                sub = X[rows[moving[row_pos == i]]]
                varying = np.flatnonzero(sub.max(0) > sub.min(0))
                if not len(varying):
                    keep[i] = False  # every row alike: a leaf
                    continue
                f[i] = varying[rng.randint(len(varying))]
                lo[i], hi[i] = sub[:, f[i]].min(), sub[:, f[i]].max()
            thr = rng.uniform(lo.astype(np.float64), hi.astype(np.float64))
            thr = np.where(thr == hi, lo.astype(np.float64), thr)
            split, f, thr = split[keep], f[keep], thr[keep]
            if not len(split):
                break
            kids = n_nodes + 2 * np.arange(len(split))
            n_nodes += 2 * len(split)
            self.feature[split], self.threshold[split] = f, thr
            self.left[split], self.right[split] = kids, kids + 1
            self.depth[kids] = self.depth[kids + 1] = d + 1
            pos[:] = -1
            pos[split] = np.arange(len(split))
            p = pos[node[moving]]
            go = p >= 0
            idx, p = moving[go], p[go]
            node[idx] = np.where(X[rows[idx], f[p]] <= thr[p], kids[p], kids[p] + 1)
            level = np.stack([kids, kids + 1], 1).reshape(-1)
        for name in ("feature", "threshold", "left", "right", "depth"):
            setattr(self, name, getattr(self, name)[:n_nodes])
        self.size = np.bincount(node, minlength=n_nodes)

    def path_lengths(self, X: np.ndarray) -> np.ndarray:
        """Each row's leaf depth + c(rows of the training subsample there)."""
        cur = np.zeros(len(X), np.int64)
        rows = np.arange(len(X))
        while True:
            inner = np.flatnonzero(self.left[cur] >= 0)
            if not len(inner):
                break
            c = cur[inner]
            go_left = X[rows[inner], self.feature[c]] <= self.threshold[c]
            cur[inner] = np.where(go_left, self.left[c], self.right[c])
        return self.depth[cur] + average_path_length(self.size[cur])


class IsolationForest:
    """sklearn's ``IsolationForest`` in the module constants' configuration
    (module docstring): ``fit``, ``score_samples`` and ``fit_predict``."""

    def fit(self, X) -> "IsolationForest":
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        m = self.max_samples_ = int(MAX_SAMPLES * n)
        max_depth = int(math.ceil(math.log2(max(m, 2))))
        rng = np.random.RandomState(RANDOM_STATE)
        self.trees_ = [_Tree(X, rng.choice(n, m, replace=False), max_depth, rng)
                       for _ in range(N_ESTIMATORS)]
        self.offset_ = float(np.percentile(self.score_samples(X), 100.0 * CONTAMINATION))
        return self

    def score_samples(self, X) -> np.ndarray:
        """The opposite of the anomaly score: lower is more abnormal."""
        X = np.asarray(X, np.float32)
        depths = sum(t.path_lengths(X) for t in self.trees_)
        denom = len(self.trees_) * float(average_path_length(self.max_samples_))
        ratio = depths / denom if denom != 0 else np.ones_like(depths)
        return -(2.0 ** -ratio)

    def fit_predict(self, X) -> np.ndarray:
        """Fit on ``X``; then 1 for each row scored at or above ``offset_``
        (an inlier), -1 for the rest."""
        return np.where(self.fit(X).score_samples(X) < self.offset_, -1, 1)
