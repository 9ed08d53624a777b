"""FleetExecutor of the port (``paddle_tpu/distributed/fleet_executor.py``;
parity: paddle/fluid/distributed/fleet_executor/, ``Carrier`` carrier.h:49,
``Interceptor`` interceptor.h:46, ``TaskNode`` task_node.h).

A host-side actor runtime: a chain of ``TaskNode`` stages, each run by an
interceptor thread that drains its inbox, applies the node's function and
forwards the result, so the stages of a serving pipeline (tokenize,
predictor shard, detokenize) overlap across in-flight requests. The edges
are bounded blocking channels: a full channel blocks its producer (back
pressure), and messages cross them pickled, as the reference's cross its
native byte channel (``csrc/channel.h``) and Paddle's as protobuf
``InterceptorMessage``. The port keeps its own channel (:class:`Channel`,
a ``threading.Condition`` over a deque) with that channel's semantics:
``put`` blocks while the channel is full and returns False once it is
closed; ``get`` blocks while it is empty and returns None once it is
closed and drained. Host only: no kernel runs here.
"""
from __future__ import annotations

import collections
import pickle
import threading
from typing import Callable, List, Optional

__all__ = ["Channel", "TaskNode", "Carrier", "FleetExecutor"]

_DATA, _STOP = 0, 1


class Channel:
    """A bounded blocking channel of byte strings."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._q = collections.deque()
        self._closed = False
        self._cv = threading.Condition()

    def put(self, data: bytes) -> bool:
        """Append ``data``, waiting while the channel is full; False (and
        nothing appended) once it is closed."""
        with self._cv:
            self._cv.wait_for(lambda: self._closed or len(self._q) < self.capacity)
            if self._closed:
                return False
            self._q.append(data)
            self._cv.notify_all()
            return True

    def get(self) -> Optional[bytes]:
        """The oldest item, waiting while the channel is empty; None once it
        is closed and drained."""
        with self._cv:
            self._cv.wait_for(lambda: self._closed or self._q)
            if not self._q:
                return None
            data = self._q.popleft()
            self._cv.notify_all()
            return data

    def close(self):
        """Wake every waiter: puts fail from now on, gets drain what is
        left."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self):
        with self._cv:
            return len(self._q)


class TaskNode:
    """One node of the chain. ``role`` is informative (``'source'``,
    ``'compute'``, ``'sink'``, ``'amplifier'``); ``fn`` maps a payload to a
    payload for a compute node, to a list of payloads for an amplifier, and
    None passes the payload on."""

    def __init__(self, fn: Optional[Callable] = None, role: str = "compute",
                 task_id: Optional[int] = None, max_run_times: int = 1, name: str = ""):
        self.fn = fn
        self.role = role
        self.task_id = task_id
        self.max_run_times = max_run_times
        self.name = name or role
        self.downstream: List["TaskNode"] = []

    def add_downstream_task(self, node: "TaskNode"):
        self.downstream.append(node)
        return node


class _Interceptor(threading.Thread):
    """One actor: drains its inbox, applies its node's function and forwards
    to its outbox. A STOP message flows through and shuts the chain down in
    order; a failure is recorded and sends STOP on."""

    def __init__(self, node: TaskNode, inbox: Channel, outbox: Optional[Channel], errors: list):
        super().__init__(daemon=True, name=f"interceptor-{node.name}")
        self.node = node
        self.inbox = inbox
        self.outbox = outbox
        self.errors = errors

    def run(self):
        try:
            while True:
                raw = self.inbox.get()
                if raw is None:  # closed
                    break
                kind, seq, payload = pickle.loads(raw)
                if kind == _STOP:
                    if self.outbox is not None:
                        self.outbox.put(raw)
                    break
                outs = [payload]
                if self.node.fn is not None:
                    out = self.node.fn(payload)
                    outs = list(out) if self.node.role == "amplifier" else [out]
                if self.outbox is not None:
                    for j, o in enumerate(outs):
                        self.outbox.put(pickle.dumps((_DATA, (seq, j), o)))
        except Exception as e:  # raised by Carrier.run once the chain has stopped
            self.errors.append((self.node.name, e))
            if self.outbox is not None:
                self.outbox.put(pickle.dumps((_STOP, -1, None)))


class Carrier:
    """Owns the interceptors of one linear chain and the channels between
    them; :meth:`run` feeds payloads in and returns the outputs in order
    (an amplifier's outputs in the order it gave them)."""

    def __init__(self, chain: List[TaskNode], capacity: int = 8):
        self.chain = chain
        self.capacity = capacity

    def run(self, feeds) -> list:
        channels = [Channel(self.capacity) for _ in range(len(self.chain) + 1)]
        errors: list = []
        actors = [_Interceptor(node, channels[i], channels[i + 1], errors)
                  for i, node in enumerate(self.chain)]
        for a in actors:
            a.start()
        feeds = list(feeds)

        def feed():  # its own thread, so a full chain blocks the feeder, not the collector
            for seq, payload in enumerate(feeds):
                channels[0].put(pickle.dumps((_DATA, seq, payload)))
            channels[0].put(pickle.dumps((_STOP, len(feeds), None)))

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        outs = []
        while True:
            raw = channels[-1].get()
            if raw is None:
                break
            kind, seq, payload = pickle.loads(raw)
            if kind == _STOP:
                break
            outs.append((seq, payload))
        # closing first wakes the stages (and the feeder) a failure left
        # blocked on full channels, so the error surfaces at once
        for ch in channels:
            ch.close()
        feeder.join(timeout=30)
        for a in actors:
            a.join(timeout=30)
        if errors:
            name, exc = errors[0]
            raise RuntimeError(f"interceptor '{name}' failed: {exc!r}") from exc
        outs.sort(key=lambda t: t[0] if isinstance(t[0], tuple) else (t[0], 0))
        return [p for _, p in outs]


class FleetExecutor:
    """The entry (fleet_executor.h ``FleetExecutor::Init``/``Run``): build a
    chain of ``TaskNode``s with :meth:`init`, then :meth:`run` streams
    payloads through it with the stages overlapping. A model stage is a
    callable (e.g. an engine's or a model's forward)."""

    def __init__(self, exe_desc: Optional[dict] = None):
        self.exe_desc = exe_desc or {}
        self._carrier: Optional[Carrier] = None

    def init(self, task_nodes: List[TaskNode], capacity: int = 8):
        """A linear chain (the reference's serving topology): a node's
        ``downstream`` edges, where given, must name the next node."""
        for i, n in enumerate(task_nodes[:-1]):
            if n.downstream and task_nodes[i + 1] not in n.downstream:
                raise ValueError(f"task {n.name} downstream edges disagree with the chain order")
        self._carrier = Carrier(task_nodes, capacity)
        return self

    def run(self, feeds) -> list:
        if self._carrier is None:
            raise RuntimeError("FleetExecutor.init(task_nodes) first")
        return self._carrier.run(list(feeds))
