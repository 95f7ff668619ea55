"""Performance models for op time vs. concurrency (paper §III-B, §III-C).

Two model families, exactly as the paper explores them:

* ``HillClimbProfiler`` (§III-C, the one the runtime uses): probe an op's
  execution time at thread counts 1, 1+x, 1+2x … (interval ``x``) per
  affinity variant, stop at the first time increase (or the core limit),
  then predict every untested count by linear interpolation between probes.

* ``RegressionSuite`` (§III-B, the rejected baseline): per-case regression
  models over normalized counter-like features.  Reimplemented in numpy
  (OLS, k-NN, decision tree, gradient boosting, Theil-Sen, passive-
  aggressive) to reproduce the paper's Table IV conclusion that these are
  too inaccurate to drive the scheduler.

Both are generic over the *measurement function* so the same algorithms
drive (a) the KNL-like simulated machine for the faithful reproduction and
(b) the shard-degree autotuner (``core/autotune.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Hashable, Protocol, Sequence

import numpy as np

from repro_torch.core.graph import Op, OpGraph

# measure(op, threads, variant) -> seconds.  ``variant`` is the affinity
# flavor (paper: cache-sharing True/False; TPU: collective-axis choice).
MeasureFn = Callable[[Op, int, bool], float]


class CurveCache(Protocol):
    """Cross-graph curve store the profiler consults before probing.

    Implemented by ``repro.multitenant.plancache.PlanCache``; kept as a
    protocol here so core has no dependency on the multitenant layer."""

    def lookup(self, key: Hashable) -> "CurveModel | None": ...

    def insert(self, key: Hashable, curve: "CurveModel") -> None: ...


def cross_graph_key(op: Op) -> Hashable:
    """Cache key for cross-graph curve reuse.

    Within one graph, ``op.size_key`` = (op_class, input_shape) determines
    cost by construction (see graph.py).  ACROSS graphs that invariant can
    break — transformer builders encode d_model/n_layers in flops, not in
    the shape — so the shared cache keys on the full analytic profile: two
    ops share a curve only if the machine would genuinely time them
    identically."""
    return (op.op_class, op.input_shape, op.flops, op.bytes_moved,
            op.working_set, op.parallel_fraction, op.tunable)


# ---------------------------------------------------------------------------
# Curve model: per-op-instance predicted time over every concurrency case.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CurveModel:
    """Piecewise-linear time curve per affinity variant."""

    samples: dict[bool, list[tuple[int, float]]]   # variant -> [(threads, s)]
    case_lists: dict[bool, list[int]]              # full prediction domains
    probes: int = 0                                # measurements consumed

    def predict(self, threads: int, variant: bool) -> float:
        pts = self.samples[variant]
        if not pts:
            raise ValueError("no samples for variant")
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        if threads <= xs[0]:
            if len(pts) >= 2:                       # linear extrapolation
                slope = (ys[1] - ys[0]) / (xs[1] - xs[0])
                return max(ys[0] + slope * (threads - xs[0]), 1e-12)
            return ys[0]
        if threads >= xs[-1]:
            if len(pts) >= 2:
                slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
                return max(ys[-1] + slope * (threads - xs[-1]), 1e-12)
            return ys[-1]
        for i in range(1, len(xs)):
            if threads <= xs[i]:
                w = (threads - xs[i - 1]) / (xs[i] - xs[i - 1])
                return ys[i - 1] * (1 - w) + ys[i] * w
        return ys[-1]

    def best(self) -> tuple[int, bool, float]:
        """(threads, variant, predicted_time) minimizing predicted time."""
        out: tuple[int, bool, float] | None = None
        for variant, cases in self.case_lists.items():
            if not self.samples.get(variant):
                continue
            for t in cases:
                y = self.predict(t, variant)
                if out is None or y < out[2]:
                    out = (t, variant, y)
        assert out is not None
        return out

    def measured_cases(self) -> list[tuple[int, bool, float]]:
        """Every measured (threads, variant, time) probe point, in the
        profiler's deterministic iteration order.  This is the candidate
        SOURCE: both the frozen ranking below and the feedback store's
        corrected re-ranking (``repro_torch.core.planstore``) draw from exactly
        this list, so the two rankings differ only by the correction
        factors — never by which cases are eligible."""
        return [(t, v, y)
                for v, pts in self.samples.items()
                for t, y in pts]

    @staticmethod
    def rank_cases(cases: list[tuple[int, bool, float]], k: int
                   ) -> list[tuple[int, bool, float]]:
        """Top-k of ``cases`` by time (stable sort), deduplicated by
        thread count — Strategy 3's candidate rule, shared by the frozen
        and corrected rankings."""
        picked: list[tuple[int, bool, float]] = []
        seen: set[int] = set()
        for t, v, y in sorted(cases, key=lambda c: c[2]):
            if t in seen:
                continue
            picked.append((t, v, y))
            seen.add(t)
            if len(picked) == k:
                break
        return picked

    def candidates(self, k: int = 3) -> list[tuple[int, bool, float]]:
        """Top-k most performant (threads, variant, time) — Strategy 3's
        three candidates.  Candidates come from the MEASURED profiling
        cases (the paper's runtime "tests a few cases ... and measures
        their execution times"), so they are spaced by the probe interval
        — that spacing is what lets a candidate drop low enough to fit
        idle cores."""
        return self.rank_cases(self.measured_cases(), k)

    def measured_best(self) -> tuple[int, bool, float]:
        out: tuple[int, bool, float] | None = None
        for v, pts in self.samples.items():
            for t, y in pts:
                if out is None or y < out[2]:
                    out = (t, v, y)
        assert out is not None
        return out


# ---------------------------------------------------------------------------
# Hill climbing profiler (§III-C)
# ---------------------------------------------------------------------------

def paper_case_lists(max_cores: int = 68, tiles: int = 34
                     ) -> dict[bool, list[int]]:
    """The paper's 68 prediction cases: variant False = no cache sharing
    (1 thread/tile, 1..34); variant True = sharing (even counts 2..68)."""
    return {
        False: list(range(1, tiles + 1)),
        True: list(range(2, max_cores + 1, 2)),
    }


def power_of_two_cases(max_degree: int, variants: Sequence[bool] = (False, True)
                       ) -> dict[bool, list[int]]:
    """Case list for the TPU shard-degree adaptation: 1,2,4,..,max."""
    cases = [1 << i for i in range(int(math.log2(max_degree)) + 1)]
    return {v: list(cases) for v in variants}


@dataclasses.dataclass
class HillClimbProfiler:
    """The paper's profiling algorithm, generic over the measure function."""

    measure: MeasureFn
    case_lists: dict[bool, list[int]]
    interval: int = 4            # the paper's x

    def _probe_schedule(self, cases: list[int]) -> list[int]:
        """Indices to probe: every ``interval``-th case, always incl. first."""
        idx = list(range(0, len(cases), max(1, self.interval)))
        if idx[-1] != len(cases) - 1:
            idx.append(len(cases) - 1)   # domain edge reachable (paper case 2)
        return idx

    def profile(self, op: Op) -> CurveModel:
        samples: dict[bool, list[tuple[int, float]]] = {}
        probes = 0
        for variant, cases in self.case_lists.items():
            sched = self._probe_schedule(cases)
            pts: list[tuple[int, float]] = []
            prev = math.inf
            for j, ci in enumerate(sched):
                t = cases[ci]
                y = self.measure(op, t, variant)
                probes += 1
                pts.append((t, y))
                if y > prev:
                    break            # first increase -> stop (paper case 1)
                prev = y
            samples[variant] = pts
        return CurveModel(samples=samples, case_lists=dict(self.case_lists),
                          probes=probes)

    def profile_graph(self, graph: OpGraph,
                      cache: "CurveCache | None" = None) -> "ProfileStore":
        """Profile every distinct (op_class, input_shape) in ``graph``.

        ``cache`` is an optional cross-graph curve cache (see
        ``repro.multitenant.plancache.PlanCache``): a curve another graph
        already paid the profiling probes for is reused instead of
        re-measured — the paper's profiling steps amortize across tenants,
        not just across steps of one job.  Cache entries are keyed by
        ``cross_graph_key`` (the op's full analytic profile), never by the
        bare size_key, so tenants whose builders hide cost parameters
        outside the input shape cannot poison each other's curves."""
        store = ProfileStore()
        for op in graph.ops.values():
            if op.size_key in store.curves:
                continue
            key = cross_graph_key(op)
            curve = cache.lookup(key) if cache is not None else None
            if curve is not None:
                # zero-probe view: this run paid nothing for the curve, so
                # ProfileStore.total_probes / profiling_cost() only count
                # probes actually measured here (the cache keeps the
                # original probe count for its own amortization stats)
                curve = dataclasses.replace(curve, probes=0)
            else:
                curve = self.profile(op)
                if cache is not None:
                    cache.insert(key, curve)
            store.curves[op.size_key] = curve
        return store


@dataclasses.dataclass
class ProfileStore:
    """Curves keyed by (op_class, input_shape) — paper's per-(op,size) unit."""

    curves: dict[Hashable, CurveModel] = dataclasses.field(default_factory=dict)

    def curve(self, op: Op) -> CurveModel:
        return self.curves[op.size_key]

    @property
    def total_probes(self) -> int:
        return sum(c.probes for c in self.curves.values())

    def prediction_accuracy(self, op: Op, oracle: MeasureFn) -> float:
        """Paper's accuracy metric 1 - mean|ŷ-y|/y over UNTESTED cases."""
        curve = self.curves[op.size_key]
        errs: list[float] = []
        for variant, cases in curve.case_lists.items():
            tested = {t for t, _ in curve.samples.get(variant, [])}
            for t in cases:
                if t in tested:
                    continue
                y = oracle(op, t, variant)
                errs.append(abs(curve.predict(t, variant) - y) / y)
        if not errs:
            return 1.0
        return 1.0 - float(np.mean(errs))


# ---------------------------------------------------------------------------
# Regression baseline (§III-B)
# ---------------------------------------------------------------------------

class _OLS:
    def fit(self, X, y):
        Xb = np.c_[X, np.ones(len(X))]
        self.w, *_ = np.linalg.lstsq(Xb, y, rcond=None)
        return self

    def predict(self, X):
        return np.c_[X, np.ones(len(X))] @ self.w


class _KNN:
    def __init__(self, k=3):
        self.k = k

    def fit(self, X, y):
        self.mu, self.sd = X.mean(0), X.std(0) + 1e-9
        self.X = (X - self.mu) / self.sd
        self.y = y
        return self

    def predict(self, X):
        Xn = (X - self.mu) / self.sd
        d = ((Xn[:, None, :] - self.X[None, :, :]) ** 2).sum(-1)
        idx = np.argsort(d, axis=1)[:, :self.k]
        return self.y[idx].mean(1)


class _Tree:
    """CART regression tree (variance-reduction splits)."""

    def __init__(self, max_depth=4, min_samples=4):
        self.max_depth, self.min_samples = max_depth, min_samples

    def fit(self, X, y):
        self.root = self._grow(X, y, 0)
        return self

    def _grow(self, X, y, depth):
        if depth >= self.max_depth or len(y) < self.min_samples or np.ptp(y) == 0:
            return float(y.mean())
        best = None
        base = ((y - y.mean()) ** 2).sum()
        for f in range(X.shape[1]):
            for thr in np.unique(np.quantile(X[:, f], [0.25, 0.5, 0.75])):
                m = X[:, f] <= thr
                if m.sum() < 2 or (~m).sum() < 2:
                    continue
                sse = (((y[m] - y[m].mean()) ** 2).sum()
                       + ((y[~m] - y[~m].mean()) ** 2).sum())
                if best is None or sse < best[0]:
                    best = (sse, f, thr, m)
        if best is None or best[0] >= base:
            return float(y.mean())
        _, f, thr, m = best
        return (f, thr, self._grow(X[m], y[m], depth + 1),
                self._grow(X[~m], y[~m], depth + 1))

    def _eval(self, node, x):
        while not isinstance(node, float):
            f, thr, lo, hi = node
            node = lo if x[f] <= thr else hi
        return node

    def predict(self, X):
        return np.array([self._eval(self.root, x) for x in X])


class _GradientBoosting:
    def __init__(self, n_estimators=50, lr=0.1, max_depth=2):
        self.n, self.lr, self.depth = n_estimators, lr, max_depth

    def fit(self, X, y):
        self.base = float(y.mean())
        self.trees = []
        resid = y - self.base
        for _ in range(self.n):
            t = _Tree(max_depth=self.depth, min_samples=3).fit(X, resid)
            pred = t.predict(X)
            self.trees.append(t)
            resid = resid - self.lr * pred
        return self

    def predict(self, X):
        out = np.full(len(X), self.base)
        for t in self.trees:
            out += self.lr * t.predict(X)
        return out


class _TheilSen:
    """Subsampled median-of-OLS Theil-Sen approximation."""

    def __init__(self, n_subsets=30, seed=0):
        self.n_subsets, self.seed = n_subsets, seed

    def fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        p = X.shape[1] + 1
        ws = []
        for _ in range(self.n_subsets):
            idx = rng.choice(len(X), size=min(len(X), p + 2), replace=False)
            Xb = np.c_[X[idx], np.ones(len(idx))]
            w, *_ = np.linalg.lstsq(Xb, y[idx], rcond=None)
            ws.append(w)
        self.w = np.median(np.stack(ws), axis=0)
        return self

    def predict(self, X):
        return np.c_[X, np.ones(len(X))] @ self.w


class _PassiveAggressive:
    """PA-I regression (epsilon-insensitive, online)."""

    def __init__(self, C=0.5, eps=0.02, epochs=5, seed=0):
        self.C, self.eps, self.epochs, self.seed = C, eps, epochs, seed

    def fit(self, X, y):
        self.mu, self.sd = X.mean(0), X.std(0) + 1e-9
        Xn = np.c_[(X - self.mu) / self.sd, np.ones(len(X))]
        w = np.zeros(Xn.shape[1])
        rng = np.random.default_rng(self.seed)
        for _ in range(self.epochs):
            for i in rng.permutation(len(Xn)):
                pred = Xn[i] @ w
                loss = max(0.0, abs(y[i] - pred) - self.eps)
                if loss > 0:
                    tau = min(self.C, loss / (Xn[i] @ Xn[i] + 1e-12))
                    w += np.sign(y[i] - pred) * tau * Xn[i]
        self.w = w
        return self

    def predict(self, X):
        return np.c_[(X - self.mu) / self.sd, np.ones(len(X))] @ self.w


REGRESSORS = {
    "GradientBoosting": _GradientBoosting,
    "KNeighbors": _KNN,
    "TSR": _TheilSen,
    "OLS": _OLS,
    "PAR": _PassiveAggressive,
    "DecisionTree": _Tree,
}


@dataclasses.dataclass
class RegressionSuite:
    """Per-case regression models (the paper trains one model per thread
    count — 68 models).  ``feature_fn(op, threads) -> dict`` supplies the
    normalized counter-like features; ``oracle`` the measured time."""

    feature_fn: Callable[[Op, int], dict[str, float]]
    oracle: MeasureFn
    cases: list[int]
    sample_counts: tuple[int, ...] = (1, 4, 8, 16)

    def _features(self, op: Op, n_samples: int) -> np.ndarray:
        # profile the op at n_samples evenly spaced thread counts and
        # concatenate their normalized features + measured times
        probe_ts = np.linspace(1, max(self.cases), n_samples).astype(int)
        feats: list[float] = []
        for t in probe_ts:
            c = self.feature_fn(op, int(t))
            feats.extend(sorted(c.values()))
            feats.append(self.oracle(op, int(t), True))
        return np.array(feats)

    def dataset(self, ops: list[Op], case: int, n_samples: int
                ) -> tuple[np.ndarray, np.ndarray]:
        X = np.stack([self._features(op, n_samples) for op in ops])
        y = np.array([self.oracle(op, case, True) for op in ops])
        return X, y

    def evaluate(self, train_ops: list[Op], test_ops: list[Op],
                 n_samples: int, regressor: str,
                 cases: list[int] | None = None) -> dict[str, float]:
        """Train per-case models on train_ops, report paper metrics on
        test_ops: accuracy = 1 - mean|ŷ-y|/y and R^2 (pooled)."""
        cases = cases or self.cases
        y_all, p_all = [], []
        for case in cases:
            Xtr, ytr = self.dataset(train_ops, case, n_samples)
            Xte, yte = self.dataset(test_ops, case, n_samples)
            model = REGRESSORS[regressor]().fit(Xtr, np.log(ytr + 1e-12))
            pred = np.exp(model.predict(Xte))
            y_all.append(yte)
            p_all.append(pred)
        y = np.concatenate(y_all)
        p = np.concatenate(p_all)
        acc = 1.0 - float(np.mean(np.abs(p - y) / y))
        ss_res = float(((y - p) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum()) + 1e-12
        return {"accuracy": acc, "r2": 1.0 - ss_res / ss_tot}
