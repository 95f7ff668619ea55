"""Demand-aware job routing: which machine does an arriving job run on?

The single-machine pool answers "which ops co-run, at what widths" —
routing answers the layer above: against N machines, place each arriving
job where it finishes soonest, without re-deriving what the per-machine
planstores already know.  The policy mirrors the distributed-placement
split in TensorFlow's dataflow scheduler (PAPERS.md): a job is routed
ONCE, by re-estimated cost against per-machine state, and every
finer-grained decision stays with the machine that won it.

``JobRouter`` is deliberately pure decision logic: the ``ClusterPool``
gathers the per-machine facts (loads, demand estimates, cache warmth)
and the router ranks candidates.  Keeping it side-effect-free is what
makes the hypothesis/deterministic-twin properties in
``tests/test_cluster.py`` cheap to state: every job is routed exactly
once, to a machine the facts justify, deterministically.

Two policies:

* ``"demand"`` — bin-pack by planstore-re-estimated demand
  (core-seconds): choose the machine with the smallest projected finish
  ``(load + job demand) / cores``, breaking exact ties toward the
  machine whose ``PlanCache`` fingerprint namespace already holds the
  job's curves (its probes are already paid for) and then toward the
  lowest machine index (determinism).
* ``"round_robin"`` — arrival index modulo N; the baseline
  ``cluster_bench`` measures the demand policy against.
"""

from __future__ import annotations

import dataclasses

POLICIES = ("demand", "round_robin")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing policy knobs (frozen: a cluster's routing behavior is
    fixed for its lifetime, like every other config in the stack).

    ``rebalance`` enables the admission-level-eviction move across
    machines: a deadline-critical waiter on a busy machine is withdrawn
    (free — no started work) and resubmitted to an idle one.
    ``split`` enables MovePrice-gated cross-machine splits of
    multi-component graphs; off by default like every other priced move
    in the preemption economics."""

    policy: str = "demand"
    rebalance: bool = True
    split: bool = False
    # a job may be rebalanced at most this many times, so eviction chains
    # across machines terminate by construction
    max_moves: int = 1

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {self.policy!r}; "
                f"expected one of {POLICIES}")


@dataclasses.dataclass(frozen=True)
class MachineFacts:
    """Everything the router may consult about one machine at one
    decision instant — assembled by the ClusterPool, consumed here."""

    index: int
    cores: int
    load: float                  # outstanding core-seconds (active+queued)
    demand: float | None         # this JOB's demand here (None = unpriced)
    warm_frac: float             # fraction of the job's op keys already
                                 # cached under this machine's fingerprint

    @property
    def projected_finish(self) -> float:
        """Seconds of work ahead of this machine if the job lands here
        (None-demand machines project their load alone — the OPTIMISTIC
        lower bound the lazy-pricing loop compares against)."""
        return (self.load + (self.demand or 0.0)) / self.cores


class JobRouter:
    """Rank candidate machines for one arriving job."""

    def __init__(self, config: RouterConfig | None = None):
        self.config = config or RouterConfig()
        self._arrivals = 0

    def route(self, facts: list[MachineFacts]) -> int:
        """Choose a machine index.  Every entry in ``facts`` must carry a
        priced ``demand`` (the ClusterPool's lazy-pricing loop decides
        WHICH machines are worth pricing; by the time the router ranks
        them, the comparison is apples-to-apples)."""
        if not facts:
            raise ValueError("route() with no candidate machines")
        self._arrivals += 1
        if self.config.policy == "round_robin":
            # facts carry the live indices; cycle through ALL machines of
            # the cluster, not just the priced subset
            return (self._arrivals - 1) % (max(f.index for f in facts) + 1)
        assert all(f.demand is not None for f in facts)
        best = min(facts, key=lambda f: (f.projected_finish,
                                         -f.warm_frac, f.index))
        return best.index
