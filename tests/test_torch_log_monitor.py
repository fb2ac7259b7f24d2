"""The port's log monitor: the cases of ``tests/test_log_monitor.py``.

Log monitor: tailer unit tests + end-to-end worker-print-to-driver."""
import asyncio
import os
import time

import ray_tpu_torch as rt
from ray_tpu_torch.log_monitor import LogMonitor
from _torch_runtime_fixtures import _aa_port_leak_sentinel, fresh_cluster, shared_ray  # noqa: F401


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def test_tailer_reads_incrementally(tmp_path):
    batches = []

    async def publish(b):
        batches.append(b)

    mon = LogMonitor(str(tmp_path), publish)
    p = tmp_path / "worker-abc123.out"
    p.write_bytes(b"hello\nworld\npart")
    _run(mon.poll_once())
    assert batches == [
        {"worker_id": "abc123", "stream": "stdout", "lines": ["hello", "world"]}
    ]
    # The partial line is held back until its newline arrives.
    with open(p, "ab") as f:
        f.write(b"ial\n")
    _run(mon.poll_once())
    assert batches[-1]["lines"] == ["partial"]


def test_tailer_stderr_and_truncation(tmp_path):
    batches = []

    async def publish(b):
        batches.append(b)

    mon = LogMonitor(str(tmp_path), publish)
    p = tmp_path / "worker-w1.err"
    p.write_bytes(b"boom\n")
    _run(mon.poll_once())
    assert batches[-1]["stream"] == "stderr"
    # Truncation (log rotation) restarts from byte 0 on the next poll.
    p.write_bytes(b"x\n")
    _run(mon.poll_once())  # detects shrink
    _run(mon.poll_once())  # reads from the top
    assert batches[-1]["lines"] == ["x"]


def test_tailer_truncation_emits_same_poll(tmp_path):
    """A shrunk file resets the read offset AND re-reads in the same poll —
    no silent gap until the next write lands."""
    batches = []

    async def publish(b):
        batches.append(b)

    mon = LogMonitor(str(tmp_path), publish)
    p = tmp_path / "worker-w3.out"
    p.write_bytes(b"one\ntwo\n")
    _run(mon.poll_once())
    assert batches[-1]["lines"] == ["one", "two"]
    p.write_bytes(b"fresh\n")  # in-place truncate + rewrite, smaller
    _run(mon.poll_once())
    assert batches[-1]["lines"] == ["fresh"]


def test_tailer_rotation_new_inode_resets_offset(tmp_path):
    """Rotation replaces the path with a NEW file. When the replacement has
    already grown past the old offset, size alone cannot detect it — the
    inode check must reset the offset or lines are skipped/garbled."""
    batches = []

    async def publish(b):
        batches.append(b)

    mon = LogMonitor(str(tmp_path), publish)
    p = tmp_path / "worker-w4.out"
    p.write_bytes(b"aaaa\n")
    _run(mon.poll_once())
    assert batches[-1]["lines"] == ["aaaa"]
    # Rotate: move the old file away, recreate the path BIGGER than the old
    # offset (5 bytes) so the size heuristic alone would not fire.
    os.rename(p, tmp_path / "worker-w4.out.1")
    p.write_bytes(b"rotated-1\nrotated-2\n")
    assert os.path.getsize(p) > 5
    _run(mon.poll_once())
    assert batches[-1]["lines"] == ["rotated-1", "rotated-2"]
    # Tailing continues from the new file's offset afterwards.
    with open(p, "ab") as f:
        f.write(b"rotated-3\n")
    _run(mon.poll_once())
    assert batches[-1]["lines"] == ["rotated-3"]


def test_tailer_skips_huge_backlog(tmp_path):
    from ray_tpu_torch import log_monitor as lm

    batches = []

    async def publish(b):
        batches.append(b)

    mon = LogMonitor(str(tmp_path), publish)
    p = tmp_path / "worker-w2.out"
    p.write_bytes(b"y" * (lm.MAX_BACKLOG_BYTES + 50) + b"\ntail-line\n")
    _run(mon.poll_once())
    # Only the bounded backlog is replayed; the tail line must be present.
    assert batches and batches[-1]["lines"][-1] == "tail-line"


@rt.remote
def _shout(msg):
    print(msg, flush=True)
    return True


def test_worker_prints_reach_driver(capsys):
    rt.init(num_cpus=2)
    try:
        assert rt.get(_shout.remote("log-monitor-e2e-sentinel"), timeout=60)
        deadline = time.time() + 15
        seen = ""
        while time.time() < deadline:
            seen += capsys.readouterr().out
            if "log-monitor-e2e-sentinel" in seen:
                break
            time.sleep(0.2)
        assert "log-monitor-e2e-sentinel" in seen
        # The line carries the producing worker prefix.
        line = next(l for l in seen.splitlines() if "sentinel" in l)
        assert line.startswith("(")
    finally:
        rt.shutdown()
