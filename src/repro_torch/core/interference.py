"""Co-run interference recording (paper §III-D "Discussion").

The performance model predicts SOLO op times; co-running ops contend for
memory bandwidth, so observed times can exceed predictions.  The paper's
runtime "can record such cases and avoid co-running such operations in the
future training steps".  ``InterferenceRecorder`` implements exactly that:
per co-run pair (unordered op-class pair), track the observed slowdown
ratio; pairs whose EMA slowdown exceeds ``threshold`` are blacklisted and
the scheduler refuses to co-run them again.

Observations are additionally keyed by the PLACEMENT RELATION of the
co-run (``repro_torch.core.placement``): ``"any"`` is the flat-topology bucket
(the original recorder, one bucket per pair), while quadrant topology
records ``"local"`` (the launches occupied disjoint quadrants) and
``"cross"`` (they straddled into shared quadrants) separately.  Keying by
op class alone used to let one bad cross-quadrant observation blacklist
the pair EVERYWHERE — including quadrant-local co-runs that never
conflicted; splitting the key means a cross-blacklisted pair can still be
co-scheduled into disjoint quadrants, and only a local-relation blacklist
forbids the pair outright.
"""

from __future__ import annotations

import dataclasses


def _pair_key(a: str, b: str) -> tuple[str, str]:
    return (a, b) if a <= b else (b, a)


def _rel_key(a: str, b: str, relation: str) -> tuple[str, str, str]:
    return _pair_key(a, b) + (relation,)


@dataclasses.dataclass
class InterferenceRecorder:
    threshold: float = 1.35       # blacklist pairs slower than 35% over solo
    ema_alpha: float = 0.4

    def __post_init__(self) -> None:
        self._ema: dict[tuple[str, str, str], float] = {}
        self._count: dict[tuple[str, str, str], int] = {}

    def record(self, cls_a: str, cls_b: str, predicted: float,
               observed: float, relation: str = "any") -> None:
        """Record one co-run observation of op with class ``cls_a`` running
        alongside ``cls_b``: predicted = solo model time, observed = actual.
        ``relation`` is the placement relation of the co-run ("any" for
        flat topology; "local"/"cross" under quadrant placement)."""
        key = _rel_key(cls_a, cls_b, relation)
        ratio = observed / max(predicted, 1e-12)
        prev = self._ema.get(key, ratio)
        self._ema[key] = (1 - self.ema_alpha) * prev + self.ema_alpha * ratio
        self._count[key] = self._count.get(key, 0) + 1

    def slowdown(self, cls_a: str, cls_b: str,
                 relation: str = "any") -> float:
        return self._ema.get(_rel_key(cls_a, cls_b, relation), 1.0)

    def blacklisted(self, cls_a: str, cls_b: str,
                    relation: str = "any") -> bool:
        return self.slowdown(cls_a, cls_b, relation) > self.threshold

    def compatible(self, cls_a: str, running_classes: list[str],
                   relation: str = "any") -> bool:
        return not any(self.blacklisted(cls_a, r, relation)
                       for r in running_classes)

    def blacklist(self) -> frozenset[tuple[str, str, str]]:
        """Snapshot of currently blacklisted (class, class, relation)
        triples.

        The paper's contract is that recorded interference is avoided "in
        the future training steps": schedulers freeze this snapshot at the
        start of a run and enforce it on EVERY launch path, while
        observations recorded during the run only take effect on the next
        one (see ``repro_torch.core.strategy.StrategyCore.begin_run``)."""
        return frozenset(k for k in self._ema
                         if self._ema[k] > self.threshold)

    @property
    def observations(self) -> int:
        return sum(self._count.values())

    def report(self) -> dict[tuple[str, str, str], float]:
        return dict(self._ema)
