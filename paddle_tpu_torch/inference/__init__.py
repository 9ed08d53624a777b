"""Serving tier of the port (``paddle_tpu/inference``):

- :class:`DecodeEngine` (``.engine``): the static-KV-cache decode engine;
- :class:`ContinuousBatchingScheduler` (``.scheduler``): in-flight batching
  with deadlines and mid-decode cancellation;
- :class:`ServingFleet` (``.fleet``) + :class:`Router` (``.router``): N
  in-process engine replicas behind prefix-affinity placement, with
  heartbeat health, kill-safe drain/requeue (exactly-once,
  bitwise-identical completions through a mid-stream replica death), and
  queue-depth load shedding;
- :class:`ProcServingFleet` (``.procfleet``): the same over replica
  subprocesses, on the TCPStore RPC with a direct socket fast path
  (``.rpc``), surviving a real ``kill -9``;
- :class:`ServingIngress` (``.ingress``): the stdlib HTTP/1.1 front door
  over either fleet.

The reference's ``Config``/``Predictor`` are not ported (ROADMAP.md, Queue 1
item 14).
"""
from .engine import DecodeEngine, default_buckets  # noqa: F401
from .fleet import (  # noqa: F401
    EngineReplica,
    FleetDrainedError,
    FleetOverloadError,
    FleetRequest,
    ServingFleet,
    retry_after_estimate,
)
from .ingress import ServingIngress  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .procfleet import ProcReplica, ProcServingFleet, TokenStream  # noqa: F401
from .router import Router  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, Request  # noqa: F401

__all__ = [
    "DecodeEngine", "ContinuousBatchingScheduler", "Request",
    "PrefixCache", "default_buckets",
    "ServingFleet", "EngineReplica", "FleetRequest", "Router",
    "FleetOverloadError", "FleetDrainedError",
    "ProcServingFleet", "ProcReplica", "TokenStream",
    "ServingIngress", "retry_after_estimate",
]
