"""Versioned on-disk job store for the pool daemon.

The daemon checkpoints its whole scheduling world into one JSON document
(``store.json``) after every decision instant: the pool clock, the
effective ``PoolConfig``, every job the daemon has ever accepted (spec +
lifecycle state + restart-waste ledger), and the learned feedback state
(``CorrectionTable`` / ``TripCountEstimator``).  The shared ``PlanCache``
is persisted next to it through its own ``dump`` (both writes go through
``atomic_write_text``, so a crash mid-checkpoint leaves the PREVIOUS
good snapshot in place, never a truncated one).

A restarted daemon loads the store and rebuilds the same world:

* ``done`` / ``cancelled`` entries are history — kept for status
  reporting, never resubmitted;
* every other entry's spec is resubmitted in original ``order``, so
  queued jobs re-enter under their original submit order and
  admitted-but-unlaunched jobs are readmitted with zero waste (the
  admission-eviction semantics: deferred, never demoted);
* entries with in-flight progress (``progress_core_s`` > 0 at the last
  checkpoint) lost that work in the crash — the recovery path re-bills
  it as restart waste (``machine.spec.restart_waste`` x lost
  core-seconds) onto the fresh job's service ledger, exactly once:
  ``progress_core_s`` measures work since the LAST restart billing, so
  a second crash with no new progress re-bills nothing.

Corrupt or unreadable stores degrade to a fresh world with a warning —
same contract as ``PlanCache.load``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import warnings
from typing import Mapping

from repro_torch.core.strategy import CONFIG_SCHEMA_VERSION, _check_config_dict
from repro_torch.multitenant.plancache import atomic_write_text
from repro_torch.service.spec import JobSpec

#: schema version of ``store.json`` (bumped on layout changes; a version
#: mismatch degrades to a fresh store rather than misreading old state)
STORE_SCHEMA_VERSION = CONFIG_SCHEMA_VERSION

#: entry lifecycle states (``queued``/``admitted``/``running`` entries
#: are resubmitted on recovery; the other two are terminal history)
ENTRY_STATES = ("queued", "admitted", "running", "done", "cancelled")


@dataclasses.dataclass
class JobEntry:
    """One accepted job as the store sees it.

    ``order`` is the daemon-level submission ticket — stable across
    restarts (pool jids are not) and the basis of the client-facing job
    id.  ``carried_waste`` accumulates every restart-waste charge ever
    billed to this job; ``progress_core_s`` is the core-seconds of
    un-checkpointed-as-done work at the last checkpoint (what a crash
    would lose)."""

    spec: JobSpec
    order: int
    state: str = "queued"
    carried_waste: float = 0.0
    progress_core_s: float = 0.0
    restarts: int = 0
    result: dict | None = None        # summary, filled when state == done
    # cluster daemons record WHICH machine the job was routed to, so
    # recovery restores the checkpointed placement instead of re-routing
    # (None: single-machine daemon, or a pre-cluster store)
    machine: int | None = None

    def to_dict(self) -> dict:
        return {"spec": self.spec.to_dict(), "order": self.order,
                "state": self.state, "carried_waste": self.carried_waste,
                "progress_core_s": self.progress_core_s,
                "restarts": self.restarts, "result": self.result,
                "machine": self.machine}

    @classmethod
    def from_dict(cls, d: Mapping) -> "JobEntry":
        kw = _check_config_dict(
            cls.__name__, dict(d),
            {f.name for f in dataclasses.fields(cls)}, versioned=False)
        kw["spec"] = JobSpec.from_dict(kw["spec"])
        if kw.get("state") not in ENTRY_STATES:
            raise ValueError(f"JobEntry state {kw.get('state')!r} unknown")
        return cls(**kw)


@dataclasses.dataclass
class StoreState:
    """The whole checkpointed world (see module docstring)."""

    clock: float = 0.0
    restarts: int = 0                 # completed daemon restarts so far
    config: dict | None = None        # PoolConfig.to_dict()
    entries: list[JobEntry] = dataclasses.field(default_factory=list)
    corrections: dict | None = None   # CorrectionTable.to_dict()
    trip_counts: dict | None = None   # TripCountEstimator.to_dict()
    # cluster daemons: each member machine's local clock at checkpoint
    # (``clock`` keeps the max, for status/back-compat)
    clocks: list[float] | None = None

    def to_dict(self) -> dict:
        return {"schema": STORE_SCHEMA_VERSION, "clock": self.clock,
                "restarts": self.restarts, "config": self.config,
                "entries": [e.to_dict() for e in self.entries],
                "corrections": self.corrections,
                "trip_counts": self.trip_counts,
                "clocks": self.clocks}

    @classmethod
    def from_dict(cls, d: Mapping) -> "StoreState":
        kw = _check_config_dict(
            cls.__name__, dict(d),
            {f.name for f in dataclasses.fields(cls)})
        kw["entries"] = [JobEntry.from_dict(e)
                         for e in kw.get("entries", ())]
        return cls(**kw)


def save_store(path: str | pathlib.Path, state: StoreState) -> None:
    """Atomically persist the store (temp-write + rename: a crash during
    the write never shadows the previous good snapshot)."""
    atomic_write_text(path, json.dumps(state.to_dict()))


def load_store(path: str | pathlib.Path) -> StoreState | None:
    """Load a checkpointed store, or ``None`` for a fresh start.

    Missing file = first boot (silent).  Unreadable/corrupt/mismatched
    file = degrade to fresh with a warning — a daemon must come up even
    when its state dir was damaged, and the atomic writer makes this
    path unreachable for crashes (only external damage lands here)."""
    path = pathlib.Path(path)
    if not path.exists():
        return None
    try:
        return StoreState.from_dict(json.loads(path.read_text()))
    except Exception as exc:  # noqa: BLE001 - degrade, never crash boot
        warnings.warn(f"job store {path} unreadable ({exc}); "
                      f"starting fresh", stacklevel=2)
        return None
