"""Serving path of the port: the static-KV-cache ``DecodeEngine`` and the
continuous-batching scheduler in front of it."""
from .engine import DecodeEngine, default_buckets  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, Request  # noqa: F401
