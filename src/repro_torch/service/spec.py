"""``JobSpec`` — the ONE wire schema for submitting work to the pool.

Before the service redesign each entry point described a job its own
way: ``repro_torch.launch.pool`` turned CLI flags into ``pool.submit`` calls,
``ServeEngine.submit_waves_to_pool`` built its own arrival/deadline
arithmetic, and there was no way to describe a job OUTSIDE a Python
process at all.  The pool daemon needs exactly that — a job description
that survives a socket/file hop and a daemon restart — so the schema
lives here once and all three consumers speak it:

* ``repro_torch.launch.pool`` parses its flags into ``JobSpec``s (a thin
  parser over the schema, not a second submission path);
* ``ServeEngine.submit_waves_to_pool`` emits one spec per pending wave
  (with the wave's already-built op graph attached in-process);
* the service daemon's inbox accepts the JSON form verbatim, persists
  it in the job store, and REBUILDS the graph from it after a crash —
  which is why the spec records the workload + its dynamic-region
  priors rather than a pickled graph.

The JSON form is versioned and strict: unknown keys are rejected (a
typo'd field must fail loudly at submit time, not silently schedule a
default job), and the schema version is shared with the config
serialization (``repro_torch.core.strategy.CONFIG_SCHEMA_VERSION``) so one
bump covers the whole on-disk surface.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.graph import (OpGraph, build_early_exit_wave,
                              build_paper_graph,
                              build_recurrent_step_graph)
from repro_torch.core.strategy import CONFIG_SCHEMA_VERSION, _check_config_dict

# workloads a spec can (re)build by itself; "graph" marks a spec whose
# graph was attached in-process (serving waves) and cannot be rebuilt
# from the wire form alone
DYNAMIC_WORKLOADS = ("rnn", "wave")
ATTACHED_GRAPH = "graph"


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One pool job, as data.

    ``workload`` is a paper model name (``resnet50``, ``dcgan``, ... —
    anything ``build_paper_graph`` accepts), ``"rnn"``/``"wave"`` for
    the dynamic-graph mix, or ``"graph"`` for a caller-attached graph
    (e.g. a serving wave) that only exists in-process.

    ``deadline`` is ABSOLUTE (pool-clock seconds); ``latency_budget``
    is relative to ``submit_time`` — set at most one (the resolved
    deadline is ``submit_time + latency_budget``).  ``demand_hint``
    overrides the profiled core-seconds demand for admission pricing
    until the closed loop re-estimates it.  The trips/depth fields are
    the dynamic-region priors the rnn/wave builders consume."""

    workload: str
    name: str | None = None          # default: the built graph's name
    scale: int = 1                   # layer-count multiplier (paper models)
    priority: float = 1.0
    submit_time: float = 0.0
    deadline: float | None = None
    latency_budget: float | None = None
    demand_hint: float | None = None
    # dynamic-region priors (rnn: while-loop trips; wave: branch depth)
    trips: int = 4
    max_trips: int = 8
    depth: int = 1
    max_depth: int = 6
    accept: bool = True

    def __post_init__(self) -> None:
        if self.deadline is not None and self.latency_budget is not None:
            raise ValueError(
                "JobSpec: set deadline (absolute) OR latency_budget "
                "(relative to submit_time), not both")

    def resolved_deadline(self) -> float | None:
        if self.deadline is not None:
            return self.deadline
        if self.latency_budget is not None:
            return self.submit_time + self.latency_budget
        return None

    def build_graph(self) -> OpGraph:
        """Rebuild the op graph this spec describes — the call the daemon
        makes on submit AND on crash recovery, so a spec must stay
        buildable from its own fields alone."""
        if self.workload == ATTACHED_GRAPH:
            raise ValueError(
                "JobSpec(workload='graph') carries an in-process graph; "
                "pass it via submit_spec(graph=...) — it cannot be "
                "rebuilt from the wire form")
        if self.workload == "rnn":
            return build_recurrent_step_graph(
                trips=self.trips, max_trips=self.max_trips,
                name=self.name or "rnn")
        if self.workload == "wave":
            return build_early_exit_wave(
                depth=self.depth, max_depth=self.max_depth,
                accept=self.accept, name=self.name or "wave")
        return build_paper_graph(self.workload, scale=self.scale)

    # ---- wire form -----------------------------------------------------
    def to_dict(self) -> dict:
        """Versioned JSON form; defaults are written out explicitly so a
        stored spec is self-describing even across default changes."""
        d = {"schema": CONFIG_SCHEMA_VERSION}
        d.update(dataclasses.asdict(self))
        return d

    @classmethod
    def from_dict(cls, d) -> "JobSpec":
        return cls(**_check_config_dict(
            cls.__name__, dict(d),
            {f.name for f in dataclasses.fields(cls)}))


def submit_spec(pool, spec: JobSpec, *, graph: OpGraph | None = None,
                machine: int | None = None):
    """Submit one spec to a ``repro_torch.multitenant.RuntimePool`` or a
    ``repro_torch.cluster.ClusterPool`` — the ONE call every entry point
    funnels through.  Returns the created Job.  ``machine`` forces the
    cluster placement (the daemon's recovery path restoring a
    checkpointed assignment); only valid on a ClusterPool."""
    g = graph if graph is not None else spec.build_graph()
    kwargs = {"machine": machine} if machine is not None else {}
    job = pool.submit(g, priority=spec.priority,
                      name=spec.name or g.name,
                      submit_time=spec.submit_time,
                      deadline=spec.resolved_deadline(), **kwargs)
    if spec.demand_hint is not None:
        # admission prices the job at the hint instead of the profiled
        # estimate (the closed loop re-derives demand once ops finish)
        job.demand = float(spec.demand_hint)
    return job
