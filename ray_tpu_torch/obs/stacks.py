"""THE stack-walk/format helper: one frame renderer for every consumer.

Three things in the tree walk ``sys._current_frames()`` — the loop-lag
thread dump (obs/health.py), the on-demand worker CPU profile
(core/worker.py handle_profile_cpu), and the continuous sampler
(obs/profiler.py). They must never drift on frame rendering: a flamegraph
merged from one and a thread dump from another have to name the same frame
the same way, or the incident view stops cross-referencing. So the walk,
the ``func (path:line)`` render, and the plane-attribution rule all live
here and nowhere else.

Frame paths are shortened to ``ray_tpu_torch/<...>`` when the file sits anywhere
under a ``ray_tpu_torch`` package dir (that prefix is what plane attribution
keys on), else to the basename — stacks stay greppable without leaking
absolute install paths into dumps.

Plane attribution (``plane_of``): one bucket per sample, answering "whose
plane is burning this cycle?". Walking from the leaf (most recent frame)
toward the root, the FIRST ray_tpu_torch frame decides:

  ray_tpu_torch/<plane>/...      -> that plane (serve, collective, data, qos, ...)
  ray_tpu_torch/core/rpc.py      -> "rpc"   (the wire is its own cost center)
  ray_tpu_torch/core/worker.py   -> "exec" when user frames sit above it (the
                              sample is user task/actor code running under
                              the executor), else "core"
  ray_tpu_torch/serve/replica.py -> "exec" when user frames sit above it (the
                              deployment handler's own burn is the request's
                              exec hop, not serve machinery), else "serve"
  ray_tpu_torch/<mod>.py         -> the module name (dashboard, ...)

No ray_tpu_torch frame anywhere -> "app". Before any of that, a leaf parked in a
stdlib wait primitive (threading/selectors/queue/socket) is "idle" — pool
threads blocked on work and loops blocked in select are capacity, not cost.
"""
from __future__ import annotations

import functools
import sys
import threading
import traceback

# Leaf files whose presence at the top of a stack means "parked, waiting":
# sampling is wall-clock, so idle threads show up every tick and would
# otherwise pollute whichever plane happened to start them.
_IDLE_LEAF_FILES = frozenset(
    {"threading.py", "selectors.py", "queue.py", "socket.py", "ssl.py"}
)


@functools.lru_cache(maxsize=4096)
def shorten_path(path: str) -> str:
    """``/venv/.../ray_tpu_torch/serve/proxy.py`` -> ``ray_tpu_torch/serve/proxy.py``;
    anything outside a ray_tpu_torch package dir -> basename. Memoized: the
    19 Hz sampler re-renders every thread's frames each tick, and the set
    of distinct filenames in a process is small and stable."""
    i = path.rfind("/ray_tpu_torch/")
    if i >= 0:
        return path[i + 1:]
    return path.rsplit("/", 1)[-1]


def format_frame(name: str, short: str, lineno: int) -> str:
    """The one frame renderer: ``func (path:line)``."""
    return f"{name} ({short}:{lineno})"


def frame_records(frame, max_frames: int = 64) -> list[tuple[str, str, int]]:
    """Walk one thread's live frame chain into ``(func, short_path, line)``
    records, root first / leaf last, keeping the LEAF-most `max_frames`
    (the frames nearest the burn are the ones a profile can't lose)."""
    recs: list[tuple[str, str, int]] = []
    f = frame
    while f is not None and len(recs) < max_frames:
        code = f.f_code
        recs.append((code.co_name, shorten_path(code.co_filename), f.f_lineno))
        f = f.f_back
    recs.reverse()
    return recs


def collapse(recs: list[tuple[str, str, int]]) -> str:
    """Records -> one collapsed-stack line (flamegraph.pl convention:
    root;...;leaf, counts appended by the accumulator, not here)."""
    return ";".join(format_frame(*r) for r in recs)


def plane_of(recs: list[tuple[str, str, int]]) -> str:
    """One cost bucket per sample — see module docstring for the rule."""
    if not recs:
        return "app"
    leaf_short = recs[-1][1]
    if (not leaf_short.startswith("ray_tpu_torch/")
            and leaf_short.rsplit("/", 1)[-1] in _IDLE_LEAF_FILES):
        return "idle"
    last = len(recs) - 1
    for i in range(last, -1, -1):
        short = recs[i][1]
        if not short.startswith("ray_tpu_torch/"):
            continue
        parts = short.split("/")
        if len(parts) == 2:  # ray_tpu_torch/<mod>.py — top-level module
            return parts[1][:-3] if parts[1].endswith(".py") else parts[1]
        if parts[1] == "core":
            if parts[2] == "rpc.py":
                return "rpc"
            if parts[2] == "worker.py" and i < last:
                return "exec"  # user code running under the executor
            return "core"
        if parts[1] == "serve" and parts[2] == "replica.py" and i < last:
            # The replica's user-handler dispatch: frames above it are the
            # deployment's own code — that burn is the request's exec hop,
            # not serve machinery (same rule as core/worker.py above).
            return "exec"
        return parts[1]
    return "app"


def thread_dump(max_frames: int = 12) -> list[dict]:
    """Compact stacks of every live thread (sys._current_frames), rendered
    through the shared frame renderer, newest frame last — what the flight
    recorder stores on a loop-lag spike and what `raytpu debug` prints."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        recs = frame_records(frame, max_frames)
        out.append({
            "thread": names.get(ident, str(ident)),
            "stack": [format_frame(*r) for r in recs],
        })
    return out


def full_thread_dump(max_frames: int = 12) -> list[dict]:
    """Source-line variant (traceback.format_stack) for human-first dumps;
    same walk, heavier render. Kept beside thread_dump so nobody reinvents
    the walk to get source lines back."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        stack = traceback.format_stack(frame)[-max_frames:]
        out.append({
            "thread": names.get(ident, str(ident)),
            "stack": [line.strip() for line in stack],
        })
    return out
