"""The LLM apps on the port's serve: ``build_llm_app`` and
``build_openai_app`` behind the controller, replicas, handle and HTTP proxy.

- one script run under both packages, in a subprocess each, serves
  ``build_llm_app`` from the same numpy weights (the JAX tree for
  ``ray_tpu``, ``ray_tpu_torch.convert.from_numpy_tree`` of it for the port)
  on each package's own cluster: the greedy tokens are equal, and ``params``
  given as an ``ObjectRef`` gives the tokens of the tree given directly;
- the port's copies of ``tests/test_llm.py::test_llm_serve_deployment`` and
  ``tests/test_llm_text.py::test_openai_ingress_end_to_end``;
- the text streamed over HTTP equals the in-process ``OpenAIServer``'s on
  the same seeded weights and tokenizer.

Every replica runs the port's engine on the CPU (``device="cpu"``). One
module-scoped port cluster; the fixture checks that the port's ``api``
holds no worker or cluster once the module is done (the repo's leak
sentinel watches only ``ray_tpu``).
"""
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import init_params as jax_init
from ray_tpu_torch import serve
from ray_tpu_torch.core import api as port_api
from ray_tpu_torch.llm import OpenAIServer, Tokenizer

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(vocab_size=320, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq_len=128)
PORT_MODEL = dict(MODEL, dtype=torch.float32)
ENGINE = {"max_slots": 4, "max_seq": 128, "prefill_buckets": (32,), "decode_block": 4,
          "kv_layout": "paged", "page_size": 16}
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "distributed systems schedule tasks over the cluster",
    "the scheduler places the tasks on the nodes of the cluster",
] * 4
CHATML = (
    "{% for message in messages %}"
    "<|im_start|>{{ message.role }}\n{{ message.content }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


@pytest.fixture(scope="module")
def serve_cluster():
    rt.init(num_cpus=8)
    serve.start()
    yield rt
    serve.shutdown()
    rt.shutdown()
    assert port_api._global_worker is None, "port driver session left initialized"
    assert not port_api._LIVE_CLUSTERS, "port cluster left running"


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tok.json")
    Tokenizer.train(CORPUS, vocab_size=3 + 256 + 40).save(path)
    return path


def _http(port, method, path, payload=None, timeout=120):
    body = json.dumps(payload).encode() if payload is not None else b""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    req = (
        f"{method} {path} HTTP/1.1\r\nhost: x\r\ncontent-type: application/json\r\n"
        f"content-length: {len(body)}\r\nconnection: close\r\n\r\n"
    ).encode() + body
    s.sendall(req)
    raw = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        raw += chunk
    s.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    status = head.split(b"\r\n", 1)[0].decode()
    headers = {}
    for line in head.split(b"\r\n")[1:]:
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    if headers.get("transfer-encoding") == "chunked":
        body, rest = b"", rest
        while rest:
            size_line, _, rest = rest.partition(b"\r\n")
            size = int(size_line, 16)
            if size == 0:
                break
            body, rest = body + rest[:size], rest[size + 2:]
        rest = body
    return status, headers, rest


# ---------------------------------------------------------------------------
# one script, both packages
# ---------------------------------------------------------------------------

_PARITY_SCRIPT = r'''
import json, pickle, sys

pkg_name, tree_path, out_path = sys.argv[1:4]
if pkg_name == "ray_tpu":
    import jax, jax.numpy as jnp
    import ray_tpu as rt
    from ray_tpu import serve
    from ray_tpu.llm import build_llm_app
    dtype, extra = jnp.float32, {}
    to_tree = lambda t, cfg: jax.tree.map(jnp.asarray, t)
else:
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.convert import from_numpy_tree
    from ray_tpu_torch.llm import build_llm_app
    from ray_tpu_torch.models import TransformerConfig
    dtype, extra = torch.float32, {"device": "cpu"}
    to_tree = lambda t, cfg: from_numpy_tree(t, TransformerConfig(**cfg), device="cpu")

model, engine, prompts = json.loads(sys.argv[4])
model = dict(model, dtype=dtype, attention_impl="reference")
engine["prefill_buckets"] = tuple(engine["prefill_buckets"])
with open(tree_path, "rb") as f:
    tree = to_tree(pickle.load(f), model)

rt.init(num_cpus=4)
serve.start(proxy=False)
out = {}
try:
    for how, params, replicas in (("tree", tree, 1), ("ref", rt.put(tree), 2)):
        app = build_llm_app(model, engine, num_replicas=replicas, params=params, **extra)
        handle = serve.run(app, name=f"llm_{how}", http=False)
        resps = [handle.remote({"tokens": p, "max_tokens": 10}) for p in prompts]
        out[how] = [r.result(timeout=120)["tokens"] for r in resps]
        serve.delete(f"llm_{how}")
finally:
    serve.shutdown()
    rt.shutdown()
with open(out_path, "w") as f:
    json.dump(out, f)
'''


def test_build_llm_app_greedy_tokens_match_ray_tpu(tmp_path):
    """The same script serves build_llm_app on each package's cluster from
    one numpy tree: once given the tree, once an ObjectRef to it (two
    replicas, each fetching it in its own process). All four token lists
    are equal."""
    jp = jax_init(jax.random.PRNGKey(0), JaxConfig(**MODEL))
    tree_path = tmp_path / "tree.pkl"
    with open(tree_path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jp), f)
    script = tmp_path / "parity.py"
    script.write_text(_PARITY_SCRIPT)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 300, size=n).tolist() for n in (5, 17, 9, 30)]
    arg = json.dumps([MODEL, dict(ENGINE), prompts])
    got = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        out = tmp_path / f"{pkg}.json"
        run = subprocess.run([sys.executable, str(script), pkg, str(tree_path), str(out), arg],
                             cwd=REPO, capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert run.returncode == 0, run.stderr[-4000:]
        got[pkg] = json.loads(out.read_text())
    port, ref = got["ray_tpu_torch"], got["ray_tpu"]
    assert all(len(t) == 10 for t in port["tree"])
    assert port["ref"] == port["tree"], "an ObjectRef gave other tokens than the tree"
    assert ref["ref"] == ref["tree"]
    assert port["tree"] == ref["tree"]


# ---------------------------------------------------------------------------
# the reference's app tests on the port
# ---------------------------------------------------------------------------

def test_llm_serve_deployment(serve_cluster):
    from ray_tpu_torch.llm import build_llm_app

    app = build_llm_app(
        model_config=dict(
            vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, attention_impl="reference",
        ),
        engine_config={"max_slots": 4, "max_seq": 128, "prefill_buckets": (16, 32)},
        device="cpu",
    )
    handle = serve.run(app, name="llm_app", http=False)
    # Concurrent requests batch at iteration level on one replica.
    resps = [
        handle.remote({"tokens": [3, 1, 4, 1, 5], "max_tokens": 8})
        for _ in range(4)
    ]
    outs = [r.result(timeout=120) for r in resps]
    first = outs[0]["tokens"]
    assert len(first) == 8
    for o in outs:
        assert o["tokens"] == first  # same prompt, greedy -> same output
        assert o["ttft_s"] is not None
    serve.delete("llm_app")


def test_openai_ingress_end_to_end(serve_cluster):
    from ray_tpu_torch.llm import build_openai_app

    app = build_openai_app(
        model_config=dict(
            vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, attention_impl="reference",
        ),
        engine_config={"max_slots": 4, "max_seq": 128, "prefill_buckets": (16, 32)},
        model_name="tiny-test-model",
        device="cpu",
    )
    serve.run(app, name="oai", route_prefix="/")
    port = serve.http_port()

    # /v1/models
    status, _, body = _http(port, "GET", "/v1/models")
    assert "200" in status
    models = json.loads(body)
    assert models["data"][0]["id"] == "tiny-test-model"

    # /v1/completions non-streaming (greedy => deterministic).
    req = {"model": "tiny-test-model", "prompt": "hello world", "max_tokens": 8}
    status, _, body = _http(port, "POST", "/v1/completions", req)
    assert "200" in status, body
    out = json.loads(body)
    assert out["object"] == "text_completion"
    assert out["usage"]["completion_tokens"] == 8
    text1 = out["choices"][0]["text"]
    status, _, body = _http(port, "POST", "/v1/completions", req)
    assert json.loads(body)["choices"][0]["text"] == text1
    assert json.loads(body)["choices"][0]["finish_reason"] == "length"

    # Per-request temperature: a hot request through the SAME engine.
    hot = dict(req, temperature=3.0, top_p=0.95)
    status, _, body = _http(port, "POST", "/v1/completions", hot)
    assert "200" in status

    # /v1/chat/completions streaming: OpenAI chunk objects over SSE.
    chat = {
        "model": "tiny-test-model", "stream": True, "max_tokens": 8,
        "messages": [{"role": "user", "content": "hi there"}],
    }
    status, headers, body = _http(port, "POST", "/v1/chat/completions", chat)
    assert "200" in status
    assert headers.get("content-type") == "text/event-stream"
    frames = [line[6:] for line in body.decode().split("\n") if line.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    assert chunks[0]["object"] == "chat.completion.chunk"
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")

    # Error paths: missing prompt -> 400 with an OpenAI error body.
    status, _, body = _http(port, "POST", "/v1/completions", {"model": "m"})
    assert "400" in status
    assert json.loads(body)["error"]["type"] == "invalid_request_error"
    status, _, body = _http(port, "POST", "/v1/embeddings", {"input": "x"})
    assert "404" in status

    serve.delete("oai")


def test_replica_without_a_gpu_never_falls_back_to_the_cpu(serve_cluster):
    """device=None is the GPU: on a machine without one each replica's
    constructor raises, so the app never becomes healthy (no replica runs
    on the CPU behind the caller's back)."""
    from ray_tpu_torch.llm import build_llm_app

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here: the replica would serve on it")
    app = build_llm_app(PORT_MODEL, ENGINE)
    with pytest.raises(TimeoutError, match="not HEALTHY"):
        serve.run(app, name="llm_nogpu", http=False, timeout_s=5)
    assert serve.status()["apps"]["llm_nogpu"]["llm"]["replicas"] == 0
    serve.delete("llm_nogpu")


# ---------------------------------------------------------------------------
# over HTTP == in process
# ---------------------------------------------------------------------------

def _sse_text(body: bytes, key: str) -> str:
    frames = [line[6:] for line in body.decode().split("\n") if line.startswith("data: ")]
    assert frames[-1] == "[DONE]", frames
    return "".join(json.loads(f)["choices"][0][key] if key == "text"
                   else json.loads(f)["choices"][0]["delta"].get("content", "")
                   for f in frames[:-1])


def test_http_streamed_text_equals_the_in_process_server(serve_cluster, tok_path):
    """build_openai_app behind the proxy and an in-process OpenAIServer, on
    the same seeded weights (params=None: the engine's seed) and tokenizer:
    the greedy text streamed over HTTP equals the in-process text, for
    completions and chat, and the unstreamed HTTP text equals both."""
    from ray_tpu_torch.llm import build_openai_app

    app = build_openai_app(PORT_MODEL, ENGINE, tokenizer=tok_path, model_name="tiny",
                           chat_template=CHATML, device="cpu")
    serve.run(app, name="oai_text", route_prefix="/text")
    port = serve.http_port()
    local = OpenAIServer(PORT_MODEL, ENGINE, tokenizer=tok_path, model_name="tiny",
                         chat_template=CHATML, device="cpu")
    try:
        for prompt in ("the quick brown fox", "the scheduler places"):
            req = {"prompt": prompt, "max_tokens": 12}
            want = local(req)["choices"][0]["text"]
            assert want
            status, headers, body = _http(port, "POST", "/text/v1/completions", dict(req, stream=True))
            assert "200" in status and headers.get("content-type") == "text/event-stream"
            assert _sse_text(body, "text") == want
            status, _, body = _http(port, "POST", "/text/v1/completions", req)
            assert "200" in status
            assert json.loads(body)["choices"][0]["text"] == want
        chat = {"messages": [{"role": "user", "content": "schedule the tasks"}], "max_tokens": 12}
        want = local(chat)["choices"][0]["message"]["content"]
        status, _, body = _http(port, "POST", "/text/v1/chat/completions", dict(chat, stream=True))
        assert "200" in status
        assert _sse_text(body, "delta") == want
    finally:
        local.__raytpu_exit__()
        serve.delete("oai_text")
