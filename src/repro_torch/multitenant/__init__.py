"""Multi-tenant runtime pool: many op graphs co-scheduled on one machine.

Layers (each builds on ``repro_torch.core``, none of core depends back):

  job        -- Job + JobQueue admission controller (priority, demand cap,
                weighted-fair-share accounting in perfmodel core-seconds;
                deadlines: EDF within a priority level, dynamic
                slack-scaled priority, slot reservation, per-node
                critical-path pricing for deadline slack)
  plancache  -- cross-job curve cache (keyed by the op's full analytic
                profile) so one tenant's profiling probes amortize over
                every tenant; persists across process restarts as
                versioned JSON (dump/load, LRU + stats preserved)
  pool       -- PoolScheduler: thin multi-job adapter over the shared
                ``repro_torch.core.strategy.StrategyCore`` (job-aware Strategy-2
                clamp, cross-job interference blacklist, weighted fair
                share, deadline-driven checkpoint-free preemption via
                ``PreemptionPolicy`` — off by default) + RuntimePool
                driver and serial baseline
  parity     -- differential check that a single-job pool reproduces
                CorunScheduler timelines bit-for-bit
"""

from repro_torch.core.strategy import PreemptionPolicy
from repro_torch.multitenant.job import (Job, JobQueue, downstream_critical_path,
                                   fairness_index)
from repro_torch.multitenant.parity import (check_parity, compare_timelines,
                                      corun_timeline, pool_timeline,
                                      timeline_rows)
from repro_torch.multitenant.plancache import PlanCache
from repro_torch.multitenant.pool import (PoolConfig, PoolResult, PoolScheduler,
                                    RuntimePool, SerialResult)

__all__ = [
    "Job", "JobQueue", "downstream_critical_path", "fairness_index",
    "PlanCache", "PreemptionPolicy",
    "PoolConfig", "PoolResult", "PoolScheduler", "RuntimePool",
    "SerialResult",
    "check_parity", "compare_timelines", "corun_timeline", "pool_timeline",
    "timeline_rows",
]
