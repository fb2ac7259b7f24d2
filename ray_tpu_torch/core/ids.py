"""Binary unique IDs for jobs, tasks, actors, objects, nodes and placement groups.

Mirrors the capability surface of the reference's ID types
(src/ray/common/id.h) with a simpler layout: every ID is a
fixed-size random byte string with a cheap hex representation. Object IDs
embed their owner's job for debuggability but are otherwise opaque.
"""
from __future__ import annotations

import itertools
import os
import threading

# Process-local entropy for the HOT id kinds only (TaskID, put ObjectID —
# minted per call on the submission path): one urandom draw per process,
# then a counter (reference does the same: ids are derived, not drawn —
# id.h TaskID::ForNormalTask composes parent id + counter). Rare id kinds
# (Node/Worker/Actor/PG) stay fully random: code may key resources on a
# TRUNCATED id (e.g. the node arena path uses node_id[:12]), and a shared
# per-process prefix would collide those truncations.
_pid = 0
_prefix = b""
_counter = itertools.count()


def _fresh_entropy():
    global _pid, _prefix, _counter
    _pid = os.getpid()
    _prefix = os.urandom(24)
    _counter = itertools.count(int.from_bytes(os.urandom(8), "little"))


# Fork guard without a per-mint getpid() syscall (from_random runs per task
# submission): reseed the child's prefix/counter at fork time. Non-fork
# process creation (spawn/exec) re-imports this module and starts fresh, so
# the hook covers every path to a duplicated prefix.
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_fresh_entropy)

_KIND_SIZES = {
    "JobID": 4,
    "NodeID": 16,
    "WorkerID": 16,
    "ActorID": 12,
    "TaskID": 16,
    "ObjectID": 16,
    "PlacementGroupID": 12,
}


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, raw: bytes):
        if len(raw) != self.SIZE:
            raise ValueError(f"{type(self).__name__} needs {self.SIZE} bytes, got {len(raw)}")
        self._bytes = raw

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return hash(self._bytes)

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]}…)" if self.SIZE > 8 else f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4
    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, i: int):
        return cls(i.to_bytes(4, "little"))

    def int(self) -> int:
        return int.from_bytes(self._bytes, "little")


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 12


class TaskID(BaseID):
    SIZE = 16

    @classmethod
    def from_random(cls):
        # Hot path (every task submission). 8-byte process prefix + counter;
        # truncated TaskID uses are logging-only, so the shared prefix is
        # safe. Fork staleness is handled by the at-fork reseed hook above —
        # no per-mint getpid().
        if not _prefix:
            _fresh_entropy()
        n = next(_counter) & 0xFFFFFFFFFFFFFFFF
        return cls(_prefix[:8] + n.to_bytes(8, "little"))


class PlacementGroupID(BaseID):
    SIZE = 12


class ObjectID(BaseID):
    """Object ID = task id (16B) + return index (4B little endian)."""

    SIZE = 20

    @classmethod
    def for_return(cls, task_id: TaskID, index: int):
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def from_put(cls):
        if not _prefix:  # fork staleness: at-fork reseed hook (see above)
            _fresh_entropy()
        n = next(_counter) & 0xFFFFFFFFFFFFFFFF
        return cls(_prefix[:8] + n.to_bytes(8, "little") + (2**32 - 1).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:16])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[16:], "little")

    def is_put(self) -> bool:
        return self.return_index() == 2**32 - 1
