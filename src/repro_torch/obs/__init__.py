"""Observability: the decision-trace seam of the scheduling stack.

The port's copy of ``repro.obs.trace``: the six decision-event families,
``TraceEvent`` and the ``TraceSink`` implementations every scheduling
layer emits into.  The reference's metrics registry, Perfetto export and
logger come with the port's multi-tenant layer.
"""

from repro_torch.obs.trace import (FAM_ADMISSION, FAM_CLUSTER, FAM_PLACEMENT,
                                   FAM_PLANSTORE, FAM_PREEMPTION, FAM_REGION,
                                   FAM_SERVICE, FAM_STRATEGY, FAMILIES,
                                   NULL_SINK, NullSink, RecordingSink,
                                   TraceEvent, TraceSink)

__all__ = [
    "FAM_ADMISSION", "FAM_CLUSTER", "FAM_PLACEMENT", "FAM_PLANSTORE",
    "FAM_PREEMPTION", "FAM_REGION", "FAM_SERVICE",
    "FAM_STRATEGY", "FAMILIES", "NULL_SINK", "NullSink",
    "RecordingSink",
    "TraceEvent", "TraceSink",
]
