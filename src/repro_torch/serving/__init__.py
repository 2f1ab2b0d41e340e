"""Serving subsystem of the port (counterpart of ``repro.serving``).

* **core** — workload-agnostic :class:`ExecutionCore` + :class:`Workload`;
* **engine** — :class:`ServingEngine`, the trigger workload on one device;
* **resilience** — :class:`ResilientEngine`: degradation ladder,
  shedding, watchdog and health.

Not ported yet: the deadline batcher, the event loop, the LM engine and
the sentinel.
"""

from repro_torch.serving.core import (
    DeviceResult,
    ExecutionCore,
    PendingResult,
    WatchdogTimeout,
    Workload,
    serve_stream,
)
from repro_torch.serving.engine import ServingEngine, TriggerWorkload
from repro_torch.serving.faults import (
    LOUD_SEAMS,
    SEAMS,
    SILENT_SEAMS,
    Fault,
    FaultInjector,
    InjectedFault,
    StaleCacheFn,
)
from repro_torch.serving.metrics import ServingMetrics, kgps, percentile
from repro_torch.serving.resilient import (
    NonFiniteOutput,
    ResilientEngine,
    ResilientPending,
)

__all__ = [
    "LOUD_SEAMS",
    "SEAMS",
    "SILENT_SEAMS",
    "DeviceResult",
    "ExecutionCore",
    "Fault",
    "FaultInjector",
    "InjectedFault",
    "NonFiniteOutput",
    "PendingResult",
    "ResilientEngine",
    "ResilientPending",
    "ServingEngine",
    "ServingMetrics",
    "StaleCacheFn",
    "TriggerWorkload",
    "WatchdogTimeout",
    "Workload",
    "kgps",
    "percentile",
    "serve_stream",
]
