"""Model multiplexing: many models time-share one replica pool.

Role-equivalent to the reference's @serve.multiplexed + model-aware routing
(python/ray/serve/multiplex.py — per-replica LRU model
cache; the router prefers replicas that already hold the requested model).
Here the decorator wraps a loader method with a per-replica LRU; requests
tagged via ``handle.options(multiplexed_model_id=...)`` carry the id to the
replica (exposed through get_multiplexed_model_id()), and the handle-side
router keeps model->replica stickiness so repeat requests for a model land
where it is already loaded (client-side affinity; the reference additionally
gossips cache contents through the controller).
"""
from __future__ import annotations

import contextvars
import threading
from collections import OrderedDict
from typing import Callable, Optional

_model_id_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "raytpu_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """Inside a replica call: the model id the current request was tagged
    with (reference: serve.get_multiplexed_model_id)."""
    return _model_id_ctx.get()


def _set_model_id(model_id: str):
    return _model_id_ctx.set(model_id)


def multiplexed(max_num_models_per_replica: int = 3) -> Callable:
    """Decorate a loader method ``get_model(self, model_id) -> model``:
    calls are cached per model id with LRU eviction beyond
    ``max_num_models_per_replica``. An evicted model's ``__del__`` (or
    ``__serve_multiplex_unload__`` if defined) releases its resources."""

    def deco(load_fn: Callable) -> Callable:
        # State lives on the INSTANCE (per replica), created lazily: closure
        # state would make the decorated class unpicklable (locks don't
        # cloudpickle) and would wrongly share a cache across replicas in
        # local-mode tests.
        def _state(self) -> dict:
            state = self.__dict__.get("_raytpu_mux_state")
            if state is None:
                state = self.__dict__.setdefault(  # dict.setdefault: atomic
                    "_raytpu_mux_state",
                    {"lock": threading.Lock(), "cache": OrderedDict(), "loading": {}},
                )
            return state

        def wrapped(self, model_id: str):
            st = _state(self)
            lock, cache, loading = st["lock"], st["cache"], st["loading"]
            with lock:
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                ev = loading.get(model_id)
                if ev is None:
                    ev = loading[model_id] = threading.Event()
                    is_loader = True
                else:
                    is_loader = False
            if not is_loader:
                ev.wait(timeout=600)
                with lock:
                    if model_id in cache:
                        return cache[model_id]
                raise RuntimeError(f"concurrent load of model {model_id!r} failed")
            try:
                model = load_fn(self, model_id)
                with lock:
                    cache[model_id] = model
                    cache.move_to_end(model_id)
                    while len(cache) > max_num_models_per_replica:
                        _mid, evicted = cache.popitem(last=False)
                        unload = getattr(evicted, "__serve_multiplex_unload__", None)
                        if unload is not None:
                            try:
                                unload()
                            except Exception:
                                pass
                return model
            finally:
                with lock:
                    loading.pop(model_id, None)
                ev.set()

        wrapped.__raytpu_multiplexed__ = True
        wrapped.__wrapped__ = load_fn
        return wrapped

    return deco
