from .continuous import ContinuousEngine
from .engine import ServeEngine, resolve_execution
from .faults import NO_FAULTS, FaultEvent, FaultPlan, InjectedFault, \
    InjectedOOM
from .paged_cache import OutOfPages, PagedKVCache, PageStateError, \
    PrefixMatch
from .scheduler import Request, Saturated, Scheduler, Sequence

__all__ = ["ContinuousEngine", "FaultEvent", "FaultPlan", "InjectedFault",
           "InjectedOOM", "NO_FAULTS", "OutOfPages", "PagedKVCache",
           "PageStateError", "PrefixMatch", "Request", "Saturated",
           "Scheduler", "Sequence", "ServeEngine", "resolve_execution"]
