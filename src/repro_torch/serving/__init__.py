"""Serving subsystem of the port (counterpart of ``repro.serving``).

* **core** — workload-agnostic :class:`ExecutionCore` + :class:`Workload`;
* **engine** — :class:`ServingEngine`, the trigger workload on one device;
* **resilience** — :class:`ResilientEngine`: degradation ladder,
  shedding, watchdog and health; the opt-in :class:`Sentinel` adds
  golden canaries, terminal-rung shadow re-execution and canary-gated
  quarantine;
* **front-end** — :class:`ServingLoop` drains a live request queue
  through the :class:`DeadlineBatcher` into either engine, with
  bounded in-flight backpressure and per-request :class:`RequestFuture`
  completion.

Not ported yet: the LM engine.
"""

from repro_torch.serving.batcher import BatchPlan, DeadlineBatcher
from repro_torch.serving.core import (
    DeviceResult,
    ExecutionCore,
    PendingPlan,
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
from repro_torch.serving.loop import RequestFuture, ServingLoop
from repro_torch.serving.metrics import ServingMetrics, kgps, percentile
from repro_torch.serving.resilient import (
    NonFiniteOutput,
    ResilientEngine,
    ResilientPending,
    ResilientPlan,
)
from repro_torch.serving.sentinel import Sentinel, SentinelConfig

__all__ = [
    "LOUD_SEAMS",
    "SEAMS",
    "SILENT_SEAMS",
    "BatchPlan",
    "DeadlineBatcher",
    "DeviceResult",
    "ExecutionCore",
    "Fault",
    "FaultInjector",
    "InjectedFault",
    "NonFiniteOutput",
    "PendingPlan",
    "PendingResult",
    "RequestFuture",
    "ResilientEngine",
    "ResilientPending",
    "ResilientPlan",
    "Sentinel",
    "SentinelConfig",
    "ServingEngine",
    "ServingLoop",
    "ServingMetrics",
    "StaleCacheFn",
    "TriggerWorkload",
    "WatchdogTimeout",
    "Workload",
    "kgps",
    "percentile",
    "serve_stream",
]
