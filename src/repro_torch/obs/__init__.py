"""Observability: decision tracing, metrics, timeline export, logging.

The port's copy of ``repro.obs``, the telemetry subsystem every
scheduling layer emits into: ``repro_torch.obs.trace`` for the
``TraceSink`` seam and the six decision-event families,
``repro_torch.obs.metrics`` for the registry, ``repro_torch.obs.perfetto``
for Chrome-trace/Perfetto export, ``repro_torch.obs.log`` for the shared
``repro_torch`` logger.  This package never imports the schedulers (they
import us), so any later subsystem can emit into it without cycles.
"""

from repro_torch.obs.log import configure_logging, get_logger
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     metrics_from_events, pool_metrics,
                                     slowdown_metrics)
from repro_torch.obs.perfetto import (cluster_trace, export_cluster_trace,
                                      export_pool_trace, pool_trace, write_trace)
from repro_torch.obs.trace import (FAM_ADMISSION, FAM_CLUSTER, FAM_PLACEMENT,
                                   FAM_PLANSTORE, FAM_PREEMPTION, FAM_REGION,
                                   FAM_SERVICE, FAM_STRATEGY, FAMILIES, NULL_SINK,
                                   NullSink, RecordingSink, TraceEvent, TraceSink)

__all__ = [
    "FAM_ADMISSION", "FAM_CLUSTER", "FAM_PLACEMENT", "FAM_PLANSTORE",
    "FAM_PREEMPTION", "FAM_REGION", "FAM_SERVICE",
    "FAM_STRATEGY", "FAMILIES", "NULL_SINK", "NullSink",
    "RecordingSink",
    "TraceEvent", "TraceSink",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "metrics_from_events", "pool_metrics", "slowdown_metrics",
    "cluster_trace", "export_cluster_trace",
    "export_pool_trace", "pool_trace", "write_trace",
    "configure_logging", "get_logger",
]
