"""Multi-machine cluster pool: demand-aware job routing above the
per-machine StrategyCore.

router  -- JobRouter: pure placement policy (demand bin-packing vs
           round-robin) over per-machine MachineFacts
pool    -- ClusterPool: one RuntimePool per ClusterSpec machine behind
           one shared PlanCache/jid-space, plus priced rebalance and
           (off by default) cross-machine splits
"""

from repro_torch.cluster.router import (JobRouter, MachineFacts, POLICIES,
                                  RouterConfig)
from repro_torch.cluster.pool import ClusterJob, ClusterPool, ClusterResult

__all__ = [
    "ClusterJob", "ClusterPool", "ClusterResult",
    "JobRouter", "MachineFacts", "POLICIES", "RouterConfig",
]
