"""Actor class decorator, handles and method proxies (reference:
python/ray/actor.py — ActorClass/ActorHandle/ActorMethod,
.options(), max_restarts/max_task_retries at actor.py:382-424).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.task_spec import ActorOptions
from ray_tpu_torch.core.remote_function import _apply_options


def method(**opts):
    """Method-level options on an actor class (reference: @ray.method —
    python/ray/actor.py): ``@method(concurrency_group="io")`` or
    ``@method(num_returns=2)`` on a method of a ``@remote`` class."""
    allowed = {"concurrency_group", "num_returns"}
    bad = set(opts) - allowed
    if bad:
        raise TypeError(f"unknown @method option(s): {sorted(bad)}")

    def wrap(fn):
        fn.__raytpu_method_opts__ = opts
        return fn

    return wrap


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns=None,
                 concurrency_group: str | None = None):
        self._handle = handle
        self._name = name
        # None = not set here: fall back to the @method declaration, then 1/"".
        declared = handle._method_opts.get(name, {})
        self._num_returns = (
            num_returns if num_returns is not None
            else declared.get("num_returns", 1)
        )
        self._concurrency_group = (
            concurrency_group if concurrency_group is not None
            else declared.get("concurrency_group", "")
        )

    def options(self, num_returns=None, concurrency_group: str | None = None):
        """Per-call overrides. Omitted options keep their current value
        (@method declaration or a previous .options()); pass
        concurrency_group="" to restore the default lane."""
        m = ActorMethod(self._handle, self._name, num_returns, concurrency_group)
        if num_returns is None:
            m._num_returns = self._num_returns
        if concurrency_group is None:
            m._concurrency_group = self._concurrency_group
        return m

    def bind(self, *args):
        """Capture this call as a compiled-DAG node (ray_tpu_torch.dag;
        reference: dag/dag_node.py bind): a ``DAGNode`` whose arguments may
        be an ``InputNode``, other nodes or constants. Nothing runs until the
        graph is compiled (``experimental_compile``) and executed."""
        from ray_tpu_torch.dag.graph import DAGNode

        return DAGNode(self._handle, self._name, args)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core import api

        core = api._require_worker()
        # Stable options identity (no per-call copy): the wire layer interns
        # it per connection so repeat calls ship lean frames.
        opts = self._handle._opts
        refs = core.submit_actor_task_sync(
            self._handle._actor_id, self._name, args, kwargs, self._num_returns, opts,
            concurrency_group=self._concurrency_group,
        )
        if self._num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        return refs[0] if self._num_returns == 1 else refs


class ActorHandle:
    def __init__(self, actor_id: ActorID, opts: ActorOptions, method_opts: dict | None = None):
        self._actor_id = actor_id
        self._opts = opts
        # {method_name: {@method options}} captured from the class at
        # .remote() time, so handles (including deserialized ones) honor
        # @method(num_returns=..., concurrency_group=...) declarations.
        self._method_opts = method_opts or {}

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        # Cache the proxy on the instance: __getattr__ only fires on a MISS,
        # so repeat `h.method.remote(...)` calls skip re-constructing an
        # ActorMethod per call (a measurable slice of the tiny-call hot
        # path). Safe: ActorMethod is immutable per (handle, name) —
        # .options() returns a fresh object — and __reduce__ ignores the
        # instance dict, so pickled handles don't carry the cache.
        m = ActorMethod(self, name)
        self.__dict__[name] = m
        return m

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._opts, self._method_opts))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, options: ActorOptions | None = None):
        self._cls = cls
        self._opts = options or ActorOptions()
        self._cls_id: str | None = None
        self.__name__ = getattr(cls, "__name__", "Actor")

    def options(self, **kwargs) -> "ActorClass":
        new_opts = _apply_options(self._opts, {k: v for k, v in kwargs.items() if k not in ("name", "namespace")})
        clone = ActorClass(self._cls, new_opts)
        clone._cls_id = self._cls_id
        clone._name = kwargs.get("name", "")
        clone._namespace = kwargs.get("namespace", "default")
        return clone

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.core import api

        core = api._require_worker()
        # Re-export if the session changed (a new driver/controller has a
        # fresh KV; a cached id from a previous session would dangle).
        if self._cls_id is None or getattr(self, "_cls_session", None) is not core:
            self._cls_id = core.export_callable("cls", self._cls)
            self._cls_session = core
        blob, _ = serialization.serialize((args, kwargs))
        opts = replace(self._opts)
        if opts.runtime_env:
            from ray_tpu_torch.core.runtime_env import package_runtime_env

            opts.runtime_env = package_runtime_env(core, opts.runtime_env)
        actor_id = core.create_actor_sync(
            self._cls_id, blob, opts, name=getattr(self, "_name", ""), namespace=getattr(self, "_namespace", "default")
        )
        method_opts: dict = {}
        for klass in reversed(self._cls.__mro__):  # walk bases: subclasses win
            for n, m in vars(klass).items():
                if callable(m) and hasattr(m, "__raytpu_method_opts__"):
                    method_opts[n] = dict(m.__raytpu_method_opts__)
        return ActorHandle(actor_id, opts, method_opts)

    def __call__(self, *a, **k):
        raise TypeError(f"actor class {self.__name__} cannot be instantiated directly; use .remote()")
