"""DAG building + compilation (driver side).

Reference: python/ray/dag/dag_node.py (bind/InputNode graph capture) and
compiled_dag_node.py:805 (compile to a pre-resolved schedule).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Optional

class DAGNode:
    """A bound actor-method call in the graph."""

    def __init__(self, actor, method_name: str, args: tuple):
        self.actor = actor
        self.method_name = method_name
        self.args = args

    def bindings(self):
        return [a for a in self.args if isinstance(a, (DAGNode, InputNode))]

    def experimental_compile(self, max_in_flight: int = 8) -> "CompiledDAG":
        return CompiledDAG(self, max_in_flight=max_in_flight)


class InputNode:
    """The DAG's input placeholder (reference: dag/input_node.py). The
    context-manager form mirrors the reference API; graph capture works
    purely off the args passed to bind()."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _DagResult:
    """Future-like result of one execute() (reference: CompiledDAGRef)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def result(self, timeout: float | None = 60.0):
        return self._dag._wait_result(self._seq, timeout)

    def __repr__(self):
        return f"_DagResult(seq={self._seq})"


class CompiledDAG:
    """Compiled schedule: stage tables installed on every participating
    worker; execute() feeds the input and returns a future for the output."""

    def __init__(self, output_node: DAGNode, max_in_flight: int = 8):
        from ray_tpu_torch.core import api

        self.core = api._require_worker()
        self.dag_id = os.urandom(8).hex()
        self.max_in_flight = max_in_flight
        self._inflight = threading.Semaphore(max_in_flight)
        self._seq = 0
        self._lock = threading.Lock()
        self._results: dict[int, Any] = {}
        self._events: dict[int, threading.Event] = {}
        self._closed = False
        # ---- topo order (DFS from the output) ----
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(node):
            if id(node) in seen or not isinstance(node, DAGNode):
                return
            seen.add(id(node))
            for dep in node.bindings():
                visit(dep)
            order.append(node)

        visit(output_node)
        self.nodes = order
        self.stage_ids = {id(n): i for i, n in enumerate(order)}
        self.output_stage = self.stage_ids[id(output_node)]
        # ---- per-stage wiring ----
        from ray_tpu_torch.dag.runtime import register_dag, resolve_actor_addr

        register_dag(self.core, self)
        addr_of = {}
        for n in order:
            addr_of[id(n)] = resolve_actor_addr(self.core, n.actor)
        self.input_feeds: list[tuple[str, int, int]] = []  # (worker_addr, stage, slot)
        downstream: dict[int, list] = {i: [] for i in range(len(order))}
        specs: dict[int, dict] = {}
        for n in order:
            sid = self.stage_ids[id(n)]
            arg_layout = []
            n_inputs = 0
            for a in n.args:
                if isinstance(a, InputNode):
                    arg_layout.append(("slot", n_inputs))
                    self.input_feeds.append((addr_of[id(n)], sid, n_inputs))
                    n_inputs += 1
                elif isinstance(a, DAGNode):
                    arg_layout.append(("slot", n_inputs))
                    downstream[self.stage_ids[id(a)]].append((addr_of[id(n)], sid, n_inputs))
                    n_inputs += 1
                else:
                    arg_layout.append(("const", a))
            specs[sid] = {
                "dag_id": self.dag_id,
                "stage_id": sid,
                "actor_id": n.actor._actor_id.binary(),
                "method": n.method_name,
                "arg_layout": arg_layout,
                "n_inputs": n_inputs,
            }
        for sid, spec in specs.items():
            spec["downstream"] = downstream[sid]
            spec["to_driver"] = self.core.address if sid == self.output_stage else None
        # Install each stage on its actor's worker.
        self._stage_addrs = set()
        for n in order:
            sid = self.stage_ids[id(n)]
            addr = addr_of[id(n)]
            self._stage_addrs.add(addr)
            self.core._run(self._setup_stage(addr, specs[sid]))

    async def _setup_stage(self, addr: str, spec: dict):
        conn = await self.core._peer_conn(addr)
        await conn.call("dag_setup", spec)

    # ------------------------------------------------------------------
    def execute(self, value: Any) -> _DagResult:
        if self._closed:
            raise RuntimeError("compiled DAG torn down")
        # Backpressure: bound UNDELIVERED executions (released in _deliver).
        if not self._inflight.acquire(timeout=120):
            raise TimeoutError("compiled DAG backpressure: no completion within 120s")
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._events[seq] = threading.Event()
        # Trace context captured on the CALLER's thread (the IO-loop coroutine
        # below runs in the loop's context, not ours).
        from ray_tpu_torch.util import tracing as _tracing

        self.core._run(self._feed(seq, value, _tracing.current_trace()))
        return _DagResult(self, seq)

    async def _feed(self, seq: int, value: Any, tc=None):
        from ray_tpu_torch.core import serialization

        blob, _ = serialization.serialize(value)
        for addr, stage, slot in self.input_feeds:
            conn = await self.core._peer_conn(addr)
            msg = {"dag_id": self.dag_id, "stage_id": stage, "seq": seq, "slot": slot, "blob": blob, "is_error": False}
            if tc is not None:
                msg["tc"] = tc
            await conn.notify("dag_push", msg)

    def _deliver(self, seq: int, value: Any):
        with self._lock:
            self._results[seq] = value
            ev = self._events.get(seq)
            if ev:
                ev.set()
        self._inflight.release()

    def _wait_result(self, seq: int, timeout: float | None):
        ev = self._events.get(seq)
        if ev is None and seq not in self._results:
            raise KeyError(f"unknown dag seq {seq}")
        if ev is not None and not ev.wait(timeout):
            raise TimeoutError(f"dag execute seq {seq} timed out after {timeout}s")
        with self._lock:
            self._events.pop(seq, None)
            value = self._results.pop(seq)
        if isinstance(value, Exception):
            raise value
        return value

    def teardown(self):
        if self._closed:
            return
        self._closed = True
        for addr in self._stage_addrs:
            try:
                self.core._run(self._teardown_one(addr))
            except Exception:
                pass

    async def _teardown_one(self, addr: str):
        conn = await self.core._peer_conn(addr)
        await conn.notify("dag_teardown", {"dag_id": self.dag_id})
