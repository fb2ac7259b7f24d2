"""Parse cache: the tier-1 wrapper must not reparse an unchanged tree.

Phase 1 (parse + rule walk + suppression scan + index contribution) is the
expensive part of a lint run and is a pure function of (file bytes, analysis
sources). So each file's entire phase-1 product — raw findings with spans,
candidate suppressions, stats, and its project-index contribution — is
serialized per file, keyed by an mtime+size fast path with a blake2b content
hash behind it (a touch without an edit still hits).

One fingerprint guards the whole cache: this analysis package's own sources
plus ``ray_tpu_torch/core/task_state.py`` (FsmEmitter validates emitted kinds against the
*live* FSM table, so an edit there must invalidate worker.py's cached
findings even though worker.py's bytes didn't change). Any mismatch drops
the cache wholesale — rules changed, so every cached verdict is suspect.

Phase 2 always runs live: cross-file rules read the folded index, which is
cheap, and holding their findings per-file would reintroduce exactly the
cross-file staleness this design exists to avoid.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional


def _blake(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def rules_fingerprint() -> str:
    """Hash of every source the phase-1 verdicts depend on."""
    here = os.path.dirname(os.path.abspath(__file__))
    deps = []
    for fn in sorted(os.listdir(here)):
        if fn.endswith(".py"):
            deps.append(os.path.join(here, fn))
    task_state = os.path.normpath(
        os.path.join(here, os.pardir, "core", "task_state.py")
    )
    if os.path.exists(task_state):
        deps.append(task_state)
    h = hashlib.blake2b(digest_size=16)
    for p in deps:
        try:
            with open(p, "rb") as f:
                h.update(p.encode())
                h.update(f.read())
        except OSError:
            h.update(b"?")
    return h.hexdigest()


class ParseCache:
    """Per-file phase-1 units keyed by content identity.

    ``lookup``/``store`` work on the engine's serialized FileUnit dicts;
    ``hits``/``misses`` feed the LINT.json cache block (and the tier-1 test
    that asserts an unchanged tree reparses nothing).
    """

    VERSION = 1

    def __init__(self, path: Optional[str]):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._entries: dict = {}
        self._fingerprint = rules_fingerprint()
        if path and os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                if (
                    data.get("version") == self.VERSION
                    and data.get("fingerprint") == self._fingerprint
                ):
                    self._entries = data.get("entries", {})
            except (OSError, ValueError):
                pass  # corrupt/unreadable cache == no cache

    def lookup(self, path: str, source: bytes) -> Optional[dict]:
        key = os.path.realpath(path)
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        try:
            st = os.stat(path)
            fresh = (
                ent["mtime_ns"] == st.st_mtime_ns and ent["size"] == st.st_size
            )
        except OSError:
            fresh = False
        if not fresh and ent["hash"] != _blake(source):
            self.misses += 1
            return None
        self.hits += 1
        return ent["unit"]

    def store(self, path: str, source: bytes, unit: dict) -> None:
        key = os.path.realpath(path)
        try:
            st = os.stat(path)
            mtime_ns, size = st.st_mtime_ns, st.st_size
        except OSError:
            mtime_ns, size = 0, len(source)
        self._entries[key] = {
            "mtime_ns": mtime_ns,
            "size": size,
            "hash": _blake(source),
            "unit": unit,
        }

    def save(self) -> None:
        if not self.path:
            return
        payload = {
            "version": self.VERSION,
            "fingerprint": self._fingerprint,
            "entries": self._entries,
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass  # a cache that can't persist is a slow run, not an error


def default_cache_path() -> str:
    """Per-user cache location (never inside the repo — lint must not dirty
    the tree it checks). Its own directory, apart from ``ray_tpu``'s
    analyzer's: the two run side by side (parallel test workers) and would
    otherwise overwrite one file with caches of different fingerprints."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "graftlint-torch", "parse_cache.json")
