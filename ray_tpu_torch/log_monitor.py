"""Log monitor: tail per-worker log files and publish lines to the driver.

Role-equivalent to the reference's log monitor
(python/ray/_private/log_monitor.py): every node daemon
redirects its workers' stdout/stderr to files under
``<session_dir>/logs/worker-<id>.{out,err}``, and a LogMonitor task tails
those files and forwards new lines to the controller, which fans them out on
the ``logs`` pubsub channel. Drivers subscribe at init (``log_to_driver``)
and print each line prefixed with the worker/node that produced it — the
standard "task prints appear on the driver" UX.

Departure from the reference: the reference's log monitor is a separate
side-car process per node that publishes through GCS pubsub long-polling;
here it is an asyncio task inside the node daemon (one fewer process to
supervise) and delivery rides the controller's push-based pubsub
(controller.py `publish`).
"""
from __future__ import annotations

import asyncio
import os
from typing import Awaitable, Callable

# Files larger than this on first sight are tailed from the end minus this
# backlog, not from byte 0 (a monitor joining late must not replay megabytes).
MAX_BACKLOG_BYTES = 256 * 1024


class LogMonitor:
    """Tails ``*.out`` / ``*.err`` files in ``log_dir`` and forwards lines.

    ``publish`` is an async callable receiving
    ``{"worker_id", "stream", "lines"}`` per batch; the node daemon binds it
    to a controller notify.
    """

    def __init__(
        self,
        log_dir: str,
        publish: Callable[[dict], Awaitable[None]],
        poll_interval_s: float = 0.2,
    ):
        self.log_dir = log_dir
        self.publish = publish
        self.poll_interval_s = poll_interval_s
        self._offsets: dict[str, int] = {}
        self._inodes: dict[str, int] = {}
        self._partial: dict[str, bytes] = {}
        self._stopped = False

    def stop(self):
        self._stopped = True

    async def run(self):
        while not self._stopped:
            try:
                await self.poll_once()
            except asyncio.CancelledError:
                return
            except Exception:
                pass
            await asyncio.sleep(self.poll_interval_s)
        # Final sweep so lines written just before shutdown still land.
        try:
            await self.poll_once()
        except Exception:
            pass

    async def poll_once(self):
        if not os.path.isdir(self.log_dir):
            return
        for name in sorted(os.listdir(self.log_dir)):
            if not (name.endswith(".out") or name.endswith(".err")):
                continue
            path = os.path.join(self.log_dir, name)
            batch = self._read_new_lines(name, path)
            if batch:
                worker_id, stream = self._parse_name(name)
                await self.publish(
                    {"worker_id": worker_id, "stream": stream, "lines": batch}
                )

    @staticmethod
    def _parse_name(name: str) -> tuple[str, str]:
        stem, _, ext = name.rpartition(".")
        wid = stem[len("worker-"):] if stem.startswith("worker-") else stem
        return wid, ("stderr" if ext == "err" else "stdout")

    def _read_new_lines(self, name: str, path: str) -> list[str]:
        try:
            st = os.stat(path)
        except OSError:
            return []
        size = st.st_size
        off = self._offsets.get(name)
        if off is None:
            off = max(0, size - MAX_BACKLOG_BYTES)
        elif self._inodes.get(name, st.st_ino) != st.st_ino:
            # Rotated: a NEW file replaced the path (copytruncate-style
            # rotation renames and recreates). Size alone cannot catch this
            # once the replacement outgrows the old offset — without the
            # inode check the tail would silently skip (or misalign into)
            # the new file's bytes. Restart from the top, this same poll.
            off = 0
            self._partial.pop(name, None)
        elif size < off:
            # Truncated in place: restart from the top, this same poll —
            # a shrunk file must reset the read offset instead of silently
            # never emitting again.
            off = 0
            self._partial.pop(name, None)
        self._inodes[name] = st.st_ino
        if size <= off:
            self._offsets[name] = off
            return []
        try:
            with open(path, "rb") as f:
                f.seek(off)
                chunk = f.read(size - off)
        except OSError:
            return []
        self._offsets[name] = off + len(chunk)
        data = self._partial.pop(name, b"") + chunk
        *complete, tail = data.split(b"\n")
        if tail:
            self._partial[name] = tail
        return [
            line.decode("utf-8", errors="replace")
            for line in complete
            if line
        ]
