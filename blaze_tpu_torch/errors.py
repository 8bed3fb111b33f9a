"""Failure taxonomy: every error the engine surfaces has a class.

The reference engine inherits failure semantics from Spark: a task
failure is retried by the scheduler, a plan the converter cannot handle
falls back to the JVM row engine, and OOM triggers the spill ladder
(SURVEY 5.3). A standalone serving tier must make those distinctions
explicit, because the right reaction differs per class:

  TRANSIENT           retry (bounded, exponential backoff + jitter) -
                      H2D hiccups, socket drops, spill-file IO races.
  RESOURCE_EXHAUSTED  do NOT retry the same way; degrade - re-execute
                      the partition through the host engine
                      (planner/host_engine.py), the native->Spark
                      fallback analog.
  PLAN_INVALID        fail fast, zero retries - re-running a malformed
                      plan burns retry budget for a deterministic
                      failure.
  CANCELLED           not a failure at all - cooperative unwind
                      (deadline, client disconnect, sibling fail-fast).
  INTERNAL            unclassified; treated as fatal (no retry) so an
                      engine bug is loud instead of masked by retries.

Raise sites either throw a `BlazeError` subclass directly or raise
whatever is natural and let `classify()` map it; classification walks
the `__cause__` chain so wrappers (TaskExecutionError) stay
transparent. The class travels the wire as a plain string
(`ErrorClass.value`) in query status frames.
"""

from __future__ import annotations

import enum
from typing import Optional


class ErrorClass(enum.Enum):
    TRANSIENT = "TRANSIENT"
    RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"
    PLAN_INVALID = "PLAN_INVALID"
    CANCELLED = "CANCELLED"
    INTERNAL = "INTERNAL"


#: classes for which a retry of the SAME work can possibly succeed
RETRYABLE = frozenset({ErrorClass.TRANSIENT})
#: classes that indicate the WORKER (not the task) is suspect - the
#: cluster driver quarantines a worker slot after N of these
FATAL_FOR_WORKER = frozenset(
    {ErrorClass.INTERNAL, ErrorClass.RESOURCE_EXHAUSTED}
)
#: same signal one tier up: a service replica repeatedly failing with
#: these classes is sick - the router's circuit breaker counts them
#: (PLAN_INVALID deliberately absent: the PLAN is bad, not the replica,
#: and re-routing a malformed plan would poison every breaker in turn)
FATAL_FOR_REPLICA = FATAL_FOR_WORKER


class BlazeError(RuntimeError):
    """Base of the classified error hierarchy."""

    error_class: ErrorClass = ErrorClass.INTERNAL


class TransientError(BlazeError):
    error_class = ErrorClass.TRANSIENT


class ResourceExhaustedError(BlazeError):
    error_class = ErrorClass.RESOURCE_EXHAUSTED


class PlanInvalidError(BlazeError):
    error_class = ErrorClass.PLAN_INVALID


class CancelledError(BlazeError):
    error_class = ErrorClass.CANCELLED


class ReplicaUnavailableError(TransientError):
    """Router-tier: no routable replica (all dead/quarantined, or the
    fleet is empty). TRANSIENT by design - capacity comes back when a
    replica revives or rejoins, so the client's correct reaction is
    retry-with-backoff, not abandon."""


class ReplicaDrainingError(TransientError):
    """A replica refused new work because it is DRAINING (SIGTERM
    rolling restart: finish in-flight, reject new, LEAVE when empty).
    TRANSIENT by design - the replica (or its replacement) comes back
    within one restart, so a bare client's correct reaction is the
    same retry-with-backoff it already applies to dropped
    connections; a router treats it as a placement miss and spills to
    the next replica with zero breaker strikes."""


class TenantBudgetError(TransientError):
    """The submitting tenant is over its configured budget (queued
    entries, RUNNING slots, reserved bytes) or router-tier rate
    limit. TRANSIENT by design - the budget frees as the tenant's own
    in-flight work drains (or the rate-limit window refills), so a
    bare client's correct reaction is the same retry-with-backoff it
    applies to DRAINING; a router treats a replica-side budget
    rejection as a placement miss and spills to the next replica with
    zero breaker strikes (the replica is healthy - the TENANT is
    over budget)."""


# exception type names that mean "cooperative cancellation" - matched by
# name to avoid importing the scheduler/service from this leaf module
_CANCEL_NAMES = frozenset({"PlanCancelled", "QueryCancelled"})


def _classify_one(e: BaseException) -> Optional[ErrorClass]:
    if isinstance(e, BlazeError):
        return e.error_class
    name = type(e).__name__
    # match the whole MRO, not just the leaf name: subclasses of the
    # cancel types (e.g. StreamStalled(QueryCancelled)) are
    # cooperative cancellations too
    if (
        name in _CANCEL_NAMES
        or any(c.__name__ in _CANCEL_NAMES for c in type(e).__mro__)
        or isinstance(e, (GeneratorExit, KeyboardInterrupt))
    ):
        return ErrorClass.CANCELLED
    if isinstance(e, MemoryError):
        return ErrorClass.RESOURCE_EXHAUSTED
    if name == "XlaRuntimeError" and "RESOURCE_EXHAUSTED" in str(e):
        # jax surfaces device-OOM as XlaRuntimeError with the XLA
        # status code in the message
        return ErrorClass.RESOURCE_EXHAUSTED
    if isinstance(
        e, (FileNotFoundError, PermissionError, IsADirectoryError,
            NotADirectoryError)
    ):
        # deterministic path problems (a plan naming a missing file):
        # retrying - or re-spooling to another worker - cannot help
        return ErrorClass.PLAN_INVALID
    if isinstance(
        e, (ConnectionError, TimeoutError, EOFError, OSError)
    ):
        # IOError is an alias of OSError; socket drops, spill-file IO
        # races, NFS hiccups - all plausibly recoverable on re-run
        return ErrorClass.TRANSIENT
    if isinstance(
        e,
        (ValueError, TypeError, KeyError, IndexError,
         NotImplementedError, AssertionError),
    ):
        # deterministic plan/shape problems: re-running cannot help
        return ErrorClass.PLAN_INVALID
    return None


def retry_action(ec: ErrorClass, attempt: int, max_attempts: int,
                 can_degrade: bool) -> str:
    """THE failure policy, in one place (both executors consult it -
    runtime/scheduler.py and service/service.py - so the taxonomy
    reactions cannot drift between them):

      'cancel'  - cooperative unwind, not a failure
      'degrade' - re-run the partition on the host engine
      'retry'   - back off and re-attempt (TRANSIENT with budget left)
      'fail'    - propagate now (deterministic error, or budget spent)
    """
    if ec is ErrorClass.CANCELLED:
        return "cancel"
    if ec is ErrorClass.RESOURCE_EXHAUSTED and can_degrade:
        return "degrade"
    if ec in RETRYABLE and attempt + 1 < max_attempts:
        return "retry"
    return "fail"


def classify(exc: Optional[BaseException]) -> ErrorClass:
    """Map an arbitrary exception to its ErrorClass.

    Walks the `__cause__` chain (wrappers like TaskExecutionError keep
    their cause there) and returns the first classifiable link;
    anything unrecognized is INTERNAL (fatal, never retried)."""
    seen = set()
    e = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        c = _classify_one(e)
        if c is not None:
            return c
        e = e.__cause__
    return ErrorClass.INTERNAL
