"""Batching policies shared by the measured and the simulated serving path.

A policy decides *when* waiting requests are admitted into the running
batch and *when* finished requests release their slot.  The same frozen
dataclasses drive both worlds:

  * ``repro_torch.launch.serve_batch`` sizes its real prefill/decode batch
    on the card from ``policy.max_batch`` (and, with ``--simulate``, feeds
    the policy to the model instead);
  * ``repro_torch.sim.serving.simulate_serving`` replays a request trace
    against the policy through the event engine.

The port's copy of ``repro/serve/policy.py``; it imports neither torch nor
the model stack, so the simulator loads it without them.

The three classic points on the serving design space:

``StaticBatching``
    Admission only between batches, and only when ``max_batch`` requests
    are waiting (or the trace is exhausted).  The formed batch runs
    padded to its formed size until the *longest* request finishes —
    early finishers keep burning their slot.  This is the throughput
    baseline continuous batching is measured against.

``DynamicBatching``
    Admission only between batches, but a batch also launches when the
    oldest waiting request has waited ``max_wait_s`` (the Triton-style
    max-queue-delay knob).  Finished requests are evicted at
    end-of-output, so the live batch shrinks — no padding waste — but
    free slots stay empty until the whole batch drains.

``ContinuousBatching``
    Iteration-level scheduling (Orca-style): every model step evicts
    finished requests and admits waiting ones into the freed slots, with
    the newcomers' prefill interleaved into the same step.  Slots never
    idle while work is queued.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict, Type


@dataclass(frozen=True)
class BatchingPolicy:
    """Base policy: at most ``max_batch`` requests share the model batch."""
    max_batch: int = 8
    kind: ClassVar[str] = "base"

    def ready(self, n_waiting: int, oldest_wait_s: float,
              trace_done: bool) -> bool:
        """Whether a new batch may launch *between* batches (the live batch
        has fully drained).  Continuous batching never waits for this —
        it admits into free slots every step instead."""
        raise NotImplementedError

    def launch_deadline_s(self, oldest_arrival_s: float) -> float:
        """Absolute time by which a waiting batch must launch even if it
        is not full (``inf`` = wait for a full batch forever)."""
        return float("inf")


@dataclass(frozen=True)
class StaticBatching(BatchingPolicy):
    kind: ClassVar[str] = "static"

    def ready(self, n_waiting, oldest_wait_s, trace_done):
        return n_waiting >= self.max_batch or (trace_done and n_waiting > 0)


@dataclass(frozen=True)
class DynamicBatching(BatchingPolicy):
    """Static admission plus a max-wait escape hatch."""
    max_wait_s: float = 0.010
    kind: ClassVar[str] = "dynamic"

    def ready(self, n_waiting, oldest_wait_s, trace_done):
        if n_waiting <= 0:
            return False
        return (n_waiting >= self.max_batch or trace_done
                or oldest_wait_s >= self.max_wait_s)

    def launch_deadline_s(self, oldest_arrival_s):
        return oldest_arrival_s + self.max_wait_s


@dataclass(frozen=True)
class ContinuousBatching(BatchingPolicy):
    kind: ClassVar[str] = "continuous"

    def ready(self, n_waiting, oldest_wait_s, trace_done):
        return n_waiting > 0          # any waiting request fills a free slot


POLICIES: Dict[str, Type[BatchingPolicy]] = {
    "static": StaticBatching,
    "dynamic": DynamicBatching,
    "continuous": ContinuousBatching,
}


def get_policy(name: str, **kwargs) -> BatchingPolicy:
    """Policy by name (``static`` | ``dynamic`` | ``continuous``) with
    field overrides, e.g. ``get_policy("dynamic", max_batch=16,
    max_wait_s=0.005)``."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown batching policy {name!r}; "
                       f"one of {sorted(POLICIES)}") from None
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# fleet-level policies: a router spreads a trace across N replica
# schedulers (each running a batching policy above), an autoscaler moves N


@dataclass(frozen=True)
class RouterPolicy:
    """Base router: pick a replica for each arriving request.

    ``route`` returns an index into the *active* replica list.  Routers
    with ``stateful = True`` need every replica's live queue depth at the
    arrival instant, so ``simulate_fleet`` drains all replicas up to each
    arrival before routing (slower but still O(steps)); stateless routers
    let it drain lazily, one replica at a time.
    """
    kind: ClassVar[str] = "base"
    stateful: ClassVar[bool] = False

    def route(self, rid: int, seq: int, outstanding) -> int:
        """Replica index for request ``rid``.  ``seq`` is the 0-based
        arrival ordinal, ``outstanding`` the per-active-replica count of
        queued + in-flight requests (empty for stateless routers)."""
        raise NotImplementedError


@dataclass(frozen=True)
class RoundRobin(RouterPolicy):
    """Arrival k goes to replica k mod N — the stateless baseline."""
    kind: ClassVar[str] = "round_robin"

    def route(self, rid, seq, outstanding):
        return seq


@dataclass(frozen=True)
class LeastOutstanding(RouterPolicy):
    """Join-the-shortest-queue: the replica with the fewest queued +
    in-flight requests at the arrival instant (ties to the lowest
    index).  Needs live depths, hence stateful."""
    kind: ClassVar[str] = "least_outstanding"
    stateful: ClassVar[bool] = True

    def route(self, rid, seq, outstanding):
        return min(range(len(outstanding)), key=outstanding.__getitem__)


@dataclass(frozen=True)
class SessionAffinity(RouterPolicy):
    """Deterministic hash of the request id (Knuth multiplicative), so a
    session's requests always land on the same replica — the sticky
    routing KV-cache reuse wants."""
    kind: ClassVar[str] = "session_affinity"

    def route(self, rid, seq, outstanding):
        return (rid * 2654435761) >> 12


ROUTERS: Dict[str, Type[RouterPolicy]] = {
    "round_robin": RoundRobin,
    "least_outstanding": LeastOutstanding,
    "session_affinity": SessionAffinity,
}


def get_router(name: str, **kwargs) -> RouterPolicy:
    """Router by name (``round_robin`` | ``least_outstanding`` |
    ``session_affinity``)."""
    try:
        cls = ROUTERS[name]
    except KeyError:
        raise KeyError(f"unknown router policy {name!r}; "
                       f"one of {sorted(ROUTERS)}") from None
    return cls(**kwargs)


@dataclass(frozen=True)
class QueueDepthAutoscaler:
    """Queue-depth autoscaling: at each arrival, compare the mean
    outstanding requests per active replica against the scale-up /
    scale-down thresholds, honoring a cooldown between actions.  The
    fleet simulation spawns a fresh replica on +1 and retires (drains, no
    new routes) the emptiest replica on -1."""
    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_depth: float = 16.0
    scale_down_depth: float = 2.0
    cooldown_s: float = 1.0

    def decide(self, n_active: int, mean_depth: float, t_s: float,
               last_change_s: float) -> int:
        """-1 / 0 / +1 replica delta at arrival time ``t_s``."""
        if t_s - last_change_s < self.cooldown_s:
            return 0
        if mean_depth >= self.scale_up_depth \
                and n_active < self.max_replicas:
            return 1
        if mean_depth <= self.scale_down_depth \
                and n_active > self.min_replicas:
            return -1
        return 0
