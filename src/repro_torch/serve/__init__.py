from .continuous import ContinuousEngine, jit_trace_count
from .engine import ServeEngine, resolve_execution
from .faults import NO_FAULTS, FaultEvent, FaultPlan, InjectedControlFault, \
    InjectedFault, InjectedOOM
from .lifecycle import (PRIORITY_CLASSES, CompletionParams, RequestLifecycle,
                        ValidationError, parse_completion_request)
from .metrics import Counter, Gauge, Histogram, Registry, ServeMetrics
from .overload import (DEFAULT_LADDER, BrownoutLevel, OverloadController,
                       compute_retry_after)
from .paged_cache import (OutOfPages, PagedKVCache, PageStateError,
                          PrefixMatch)
from .scheduler import Request, Saturated, Scheduler, Sequence
from .server import APIServer, EngineLoop
from .supervisor import (Draining, EngineDied, EngineSupervisor,
                         PoisonedRequest, Recovering, Warming,
                         WatchdogTimeout)
from .warmup import enumerate_traces, warm_engine

__all__ = ["APIServer", "BrownoutLevel", "CompletionParams",
           "ContinuousEngine", "Counter", "DEFAULT_LADDER", "Draining",
           "EngineDied", "EngineLoop", "EngineSupervisor", "FaultEvent",
           "FaultPlan", "Gauge", "Histogram", "InjectedControlFault",
           "InjectedFault", "InjectedOOM", "NO_FAULTS", "OutOfPages",
           "OverloadController", "PRIORITY_CLASSES", "PagedKVCache",
           "PageStateError", "PoisonedRequest", "PrefixMatch", "Recovering",
           "Registry", "Request", "RequestLifecycle", "Saturated",
           "Scheduler", "Sequence", "ServeEngine", "ServeMetrics",
           "ValidationError", "Warming", "WatchdogTimeout",
           "compute_retry_after", "enumerate_traces", "jit_trace_count",
           "parse_completion_request", "resolve_execution", "warm_engine"]
