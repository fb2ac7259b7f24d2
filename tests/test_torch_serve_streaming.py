"""The port's end-to-end response streaming: replica generators ->
streaming handle -> HTTP proxy chunked transfer -> SSE LLM tokens. The cases
of ``tests/test_serve_streaming.py`` on a port cluster; the LLM replicas run
the port's engine on the CPU (``device="cpu"``).

The load-bearing property under test: a client observes the FIRST item while
the producer is still generating (TTFT != total latency)."""
import json
import socket
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.core import api as port_api


@pytest.fixture(scope="module")
def serve_cluster():
    rt.init(num_cpus=16)
    serve.start(proxy=False)
    yield rt
    serve.shutdown()
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


# ---------------------------------------------------------------------------
# streaming through DeploymentHandle
# ---------------------------------------------------------------------------

def test_handle_stream_option(serve_cluster):
    @serve.deployment
    class Streamer:
        def __call__(self, n):
            for i in range(n):
                yield {"i": i}

        def slow(self, n, delay):
            for i in range(n):
                time.sleep(delay)
                yield i

    handle = serve.run(Streamer.bind(), name="stream_app", http=False)
    got = list(handle.options(stream=True).remote(5))
    assert got == [{"i": i} for i in range(5)]

    # Incremental delivery: first item arrives well before the stream ends.
    t0 = time.time()
    gen = handle.options(stream=True).slow.remote(5, 0.3)
    first = next(gen)
    t_first = time.time() - t0
    rest = list(gen)
    t_total = time.time() - t0
    assert first == 0 and rest == [1, 2, 3, 4]
    assert t_first < t_total - 0.5, (t_first, t_total)
    serve.delete("stream_app")


def test_handle_stream_non_generator_errors(serve_cluster):
    @serve.deployment
    def scalar(x):
        return x + 1

    handle = serve.run(scalar.bind(), name="scalar_app", http=False)
    with pytest.raises(Exception, match="not a generator"):
        list(handle.options(stream=True).remote(1))
    # Buffered path unaffected.
    assert handle.remote(1).result() == 2
    serve.delete("scalar_app")


def test_stream_releases_capacity(serve_cluster):
    """Exhausting (or closing) a stream releases the replica's ongoing slot:
    max_ongoing_requests streams in sequence never deadlock."""

    @serve.deployment(max_ongoing_requests=2)
    class Tight:
        def __call__(self, n):
            yield from range(n)

    handle = serve.run(Tight.bind(), name="tight_app", http=False)
    for _ in range(6):  # 3x the budget; fails if slots leak
        assert list(handle.options(stream=True).remote(3)) == [0, 1, 2]
    # Abandoned (closed, not exhausted) stream also releases.
    for _ in range(4):
        gen = handle.options(stream=True).remote(3)
        next(gen)
        gen.close()
    assert list(handle.options(stream=True).remote(2)) == [0, 1]
    serve.delete("tight_app")


# ---------------------------------------------------------------------------
# streaming through the HTTP proxy (chunked transfer at a raw socket)
# ---------------------------------------------------------------------------

def _read_chunked(sock_file):
    """Parse HTTP/1.1 chunked body incrementally; yields (bytes, t_arrival)."""
    while True:
        size_line = sock_file.readline()
        size = int(size_line.strip(), 16)
        if size == 0:
            sock_file.readline()  # trailing CRLF
            return
        data = sock_file.read(size)
        sock_file.read(2)  # CRLF
        yield data, time.time()


def _stream_request(port, path, payload):
    body = json.dumps(payload).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    req = (
        f"POST {path} HTTP/1.1\r\nhost: x\r\ncontent-type: application/json\r\n"
        f"content-length: {len(body)}\r\n\r\n"
    ).encode() + body
    s.sendall(req)
    f = s.makefile("rb")
    status = f.readline().decode()
    headers = {}
    while True:
        line = f.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    return s, f, status, headers


def test_proxy_chunked_streaming(serve_cluster):
    @serve.deployment
    class SSEApp:
        def __call__(self, request):
            n = int(request.json()["n"])

            def gen():
                for i in range(n):
                    time.sleep(0.25)
                    yield f"data: {i}\n\n"

            return gen()

    serve.run(SSEApp.bind(), name="sse_app", route_prefix="/sse")
    port = serve.http_port()
    t0 = time.time()
    s, f, status, headers = _stream_request(port, "/sse", {"n": 4})
    assert "200" in status
    assert headers.get("transfer-encoding") == "chunked"
    assert headers.get("content-type") == "text/event-stream"
    chunks = list(_read_chunked(f))
    s.close()
    t_first = chunks[0][1] - t0
    t_last = chunks[-1][1] - t0
    assert b"".join(c for c, _ in chunks) == b"".join(
        f"data: {i}\n\n".encode() for i in range(4)
    )
    # First chunk must land ~3 sleeps before the last one: streaming, not
    # buffering.
    assert t_first < t_last - 0.5, (t_first, t_last)
    serve.delete("sse_app")


def test_proxy_buffered_json_unaffected(serve_cluster):
    @serve.deployment
    class Plain:
        def __call__(self, request):
            return {"ok": request.json()["x"] * 2}

    serve.run(Plain.bind(), name="plain_app", route_prefix="/plain")
    port = serve.http_port()
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/plain",
        data=json.dumps({"x": 21}).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read()) == {"ok": 42}
    serve.delete("plain_app")


# ---------------------------------------------------------------------------
# LLM SSE token streaming end-to-end
# ---------------------------------------------------------------------------

def test_llm_sse_streaming_end_to_end(serve_cluster):
    from ray_tpu_torch.llm import build_llm_app

    app = build_llm_app(
        model_config=dict(
            vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, attention_impl="reference",
        ),
        engine_config={"max_slots": 4, "max_seq": 128, "prefill_buckets": (16, 32),
                       "decode_block": 4},
        device="cpu",
    )
    serve.run(app, name="llm_sse", route_prefix="/llm")
    port = serve.http_port()

    # Non-streaming reference completion (greedy -> deterministic).
    handle = serve.get_deployment_handle("llm", "llm_sse")
    expect = handle.remote({"tokens": [3, 1, 4, 1, 5], "max_tokens": 12}).result(
        timeout=120
    )["tokens"]

    s, f, status, headers = _stream_request(
        port, "/llm", {"tokens": [3, 1, 4, 1, 5], "max_tokens": 12, "stream": True}
    )
    assert "200" in status
    assert headers.get("content-type") == "text/event-stream"
    frames = []
    times = []
    for data, t in _read_chunked(f):
        frames.append(data)
        times.append(t)
    s.close()
    text = b"".join(frames).decode()
    events = []
    for line in text.split("\n\n"):
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        if payload == "[DONE]":
            events.append("DONE")
        else:
            events.append(json.loads(payload))
    assert events[-1] == "DONE"
    streamed = [t for ev in events[:-1] for t in ev["new_tokens"]]
    assert streamed == expect
    # More than one token-bearing frame: tokens streamed per decode block,
    # not buffered to completion (12 tokens / decode_block=4 >= 3 frames).
    assert len(events) - 1 >= 3
    serve.delete("llm_sse")


def test_llm_abandoned_stream_frees_engine_slot(serve_cluster):
    from ray_tpu_torch.llm import build_llm_app

    app = build_llm_app(
        model_config=dict(
            vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=512, attention_impl="reference",
        ),
        engine_config={"max_slots": 2, "max_seq": 512, "prefill_buckets": (16,),
                       "decode_block": 2},
        device="cpu",
    )
    handle = serve.run(app, name="llm_abort", http=False)
    # Long generation we will abandon after the first event.
    gen = handle.options(stream=True).generate_stream.remote([1, 2, 3], 400)
    first = next(gen)
    assert first["new_tokens"]
    gen.close()
    # The engine must retire the slot well before the 400 tokens complete.
    deadline = time.time() + 15
    while time.time() < deadline:
        stats = handle.stats.remote().result(timeout=30)
        if stats["active_slots"] == 0 and stats["waiting"] == 0:
            break
        time.sleep(0.2)
    else:
        raise AssertionError(f"slot not freed after abandon: {stats}")
    serve.delete("llm_abort")
