"""Fire-and-forget asyncio tasks with strong references.

asyncio tracks tasks only weakly: a gc cycle landing mid-await kills an
unreferenced task with GeneratorExit (observed as lost sealed-object
reports, never-reported worker deaths, and callers that wait out their
full timeout). Every fire-and-forget create_task must keep the task
referenced until it completes — this helper is where that pattern lives
(Connection dispatch, Controller, NodeDaemon and CoreWorker all delegate
here), and the invariant is machine-enforced: graftlint's ``bg-strong-ref``
rule (``python -m ray_tpu_torch lint``) fails the tree on any bare
``create_task``/``ensure_future`` whose task object is dropped.
"""
import asyncio


def spawn_bg(registry: set, coro, loop=None, name: str | None = None) -> "asyncio.Task":
    """create_task with a strong reference held in ``registry`` until the
    task completes. Pass ``loop`` when calling from a sync context that
    holds a loop reference (no running loop to infer). ``name`` labels the
    task so leaked-task debug output (``asyncio.all_tasks()``, the loop's
    "Task was destroyed but it is pending!" warning) names the coroutine
    site instead of printing ``Task-17``."""
    if loop is not None:
        t = loop.create_task(coro, name=name)
    else:
        t = asyncio.ensure_future(coro)
        if name and hasattr(t, "set_name"):
            t.set_name(name)
    registry.add(t)
    t.add_done_callback(registry.discard)
    return t
