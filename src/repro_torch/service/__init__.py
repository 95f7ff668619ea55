"""Pool-as-a-service: the long-lived daemon, its persistent job store,
and the one submission wire schema every entrypoint shares.

* ``JobSpec`` / ``submit_spec`` — the wire schema (``repro_torch.launch.pool``
  flags, ``ServeEngine.submit_waves_to_pool``, and the daemon inbox all
  build the same spec);
* ``PoolDaemon`` — the daemon (file inbox, per-instant checkpointing,
  crash recovery);
* ``JobEntry`` / ``StoreState`` / ``load_store`` / ``save_store`` — the
  versioned on-disk job store.
"""

from repro_torch.service.daemon import PoolDaemon
from repro_torch.service.jobstore import (JobEntry, StoreState, load_store,
                                    save_store)
from repro_torch.service.spec import (ATTACHED_GRAPH, DYNAMIC_WORKLOADS, JobSpec,
                                submit_spec)

__all__ = [
    "ATTACHED_GRAPH", "DYNAMIC_WORKLOADS", "JobSpec", "submit_spec",
    "PoolDaemon", "JobEntry", "StoreState", "load_store", "save_store",
]
