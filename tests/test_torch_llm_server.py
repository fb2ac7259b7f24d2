"""The port's serving surface against ray_tpu's, in-process on one tree.

Both packages' LLMServer, OpenAIServer, prefix router and batch UDF run on
the CPU over the same converted fp32 weights and the same trained
tokenizer: concurrent greedy requests through generate, generate_stream and
__call__ return identical tokens and finish reasons, and the OpenAI routes
answer identical text, usage and SSE frames (apart from `id` and
`created`). Then what only the port's server is checked for here: deadlines
and cancel events abort and free the slot, a stream closed early aborts,
apply_weights lands between requests, serve.ttft_s counts every request,
the engine's and server's spans, a step that raises ends the stepping
thread, and the servers' refusal to run off the GPU unless asked.

The JAX engines share one set of compiled programs (one model, one bucket).
"""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.batch import _EngineUDF as JaxEngineUDF
from ray_tpu.llm.openai import OpenAIServer as JaxOpenAIServer
from ray_tpu.llm.openai import make_prefix_router as jax_prefix_router
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import init_params as jax_init
from ray_tpu.serve.proxy import Request as JaxRequest
from ray_tpu_torch import qos
from ray_tpu_torch.convert import from_numpy_tree
from ray_tpu_torch.llm import LLMEngine, LLMServer, OpenAIServer, SamplingParams, Tokenizer
from ray_tpu_torch.llm.batch import _EngineUDF
from ray_tpu_torch.llm.openai import make_prefix_router
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.serve.proxy import HTTPResponse, Request
from ray_tpu_torch.util import metrics, tracing

MODEL = dict(vocab_size=320, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq_len=128)
JAX_MODEL = dict(MODEL, dtype=jnp.float32, attention_impl="reference")
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
TIMEOUT_S = 60.0  # every wait here: a dead stepping thread fails fast


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tok.json")
    Tokenizer.train(CORPUS, vocab_size=3 + 256 + 40).save(path)
    return path


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, the port's tree) of one seeded model, and a second port
    tree of other weights."""
    jp = jax_init(jax.random.PRNGKey(0), JaxConfig(**JAX_MODEL))
    cfg = TransformerConfig(**PORT_MODEL)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    other = jax_init(jax.random.PRNGKey(1), JaxConfig(**JAX_MODEL))
    return jp, tp, from_numpy_tree(jax.tree.map(np.asarray, other), cfg, device="cpu")


@pytest.fixture(scope="module")
def servers(weights, tok_path):
    """Both packages' OpenAIServer (and through it LLMServer) on one tree."""
    jp, tp, _ = weights
    ref = JaxOpenAIServer(JAX_MODEL, ENGINE, tokenizer=tok_path, model_name="tiny", chat_template=CHATML)
    mine = OpenAIServer(PORT_MODEL, ENGINE, tokenizer=tok_path, model_name="tiny", chat_template=CHATML,
                        device="cpu")
    ref._llm.apply_weights(jp)
    mine._llm.apply_weights(tp)
    yield ref, mine
    ref.__raytpu_exit__()
    mine.__raytpu_exit__()


def _port_server(params, **engine):
    return LLMServer(PORT_MODEL, dict(ENGINE, **engine), params=params, device="cpu")


def _idle(llm, timeout=2.0):
    """Waits until the engine holds no request; True when every page is back."""
    eng = llm.engine
    t_end = time.time() + timeout
    while time.time() < t_end:
        s = llm.stats()
        if s["active_slots"] == 0 and s["waiting"] == 0 and len(eng.free_pages) == eng.ec.total_pages - 1:
            return True
        time.sleep(0.01)
    return False


def _slow_steps(llm, monkeypatch, delay=0.05):
    """Makes every engine step take at least `delay` seconds."""
    step = llm.engine.step

    def slow():
        time.sleep(delay)
        return step()

    monkeypatch.setattr(llm.engine, "step", slow)


def _sse(frames):
    """SSE frames -> payloads ([DONE] kept as the string)."""
    out = []
    for f in frames:
        assert f.startswith("data: ") and f.endswith("\n\n"), f
        body = f[len("data: "):-2]
        out.append(body if body == "[DONE]" else json.loads(body))
    return out


def _strip(obj):
    """An OpenAI response or chunk without the fields that differ per call."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created", "ttft_s")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# the port against ray_tpu
# ---------------------------------------------------------------------------

def _concurrent(llm, prompts, request_cls):
    """Every request on its own thread, released together: two through
    generate, two through generate_stream, two through __call__ (a dict and
    an HTTP Request), two streamed through __call__ (SSE), one with a
    partial sampling dict. Returns {name: (tokens, finish_reason)}."""
    out, errors = {}, []
    barrier = threading.Barrier(len(prompts))

    def run(i, p):
        name, mt = f"q{i}", 6 + i
        try:
            barrier.wait(timeout=TIMEOUT_S)
            kind = i % 5
            if kind == 0:
                r = llm.generate(p, mt, timeout_s=TIMEOUT_S)
                out[name] = (r["tokens"], r["finish_reason"])
            elif kind == 1:
                evs = list(llm.generate_stream(p, mt, timeout_s=TIMEOUT_S))
                assert sum((e["new_tokens"] for e in evs), []) == evs[-1]["tokens"]
                assert [e["finished"] for e in evs] == [False] * (len(evs) - 1) + [True]
                out[name] = (evs[-1]["tokens"], evs[-1]["finish_reason"])
            elif kind == 2:
                body = {"tokens": p, "max_tokens": mt}
                r = llm(body) if i < 5 else llm(request_cls("POST", "/", {}, {}, json.dumps(body).encode()))
                out[name] = (r["tokens"], r["finish_reason"])
            elif kind == 3:
                frames = _sse(llm({"tokens": p, "max_tokens": mt, "stream": True}))
                assert frames[-1] == "[DONE]"
                out[name] = (frames[-2]["tokens"], frames[-2]["finish_reason"])
            else:  # a partial sampling dict inherits the engine's temperature (greedy)
                r = llm({"tokens": p, "max_tokens": mt, "ignore_eos": True})
                assert len(r["tokens"]) == mt
                out[name] = (r["tokens"], r["finish_reason"])
        except Exception as e:  # noqa: BLE001  (re-raised in the test's thread)
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * TIMEOUT_S)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


def test_llm_server_concurrent_greedy_matches_ray_tpu(servers):
    ref, mine = servers
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(3, MODEL["vocab_size"], n)] for n in (5, 9, 17, 30, 12, 3, 24, 8, 20, 14)]
    want = _concurrent(ref._llm, prompts, JaxRequest)
    got = _concurrent(mine._llm, prompts, Request)
    assert got == want
    assert len(got) == len(prompts)
    assert _idle(mine._llm)


def _openai_calls():
    conv = [{"role": "system", "content": "You schedule tasks."},
            {"role": "user", "content": "the quick brown fox"}]
    return [
        {"prompt": "the quick brown fox", "max_tokens": 12},
        {"prompt": "the scheduler places", "max_tokens": 9, "ignore_eos": True, "stop": ["\x00never"]},
        {"messages": conv, "max_tokens": 10},
        {"prompt": "distributed systems", "max_tokens": 11, "stream": True},
        {"messages": conv, "max_tokens": 8, "stream": True},
        {"prompt": "the quick brown fox", "max_tokens": 7, "temperature": 0.0, "top_k": 1, "stream": True},
    ]


def _answer(srv, body, request_cls):
    if body.get("stream"):
        return _sse(srv(body))
    path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
    return srv(request_cls("POST", path, {}, {}, json.dumps(body).encode()))


def test_openai_routes_match_ray_tpu(servers):
    """One request at a time (so the engine's event boundaries, and with
    them the SSE frames, are the same in both): completions and chat,
    plain and streamed, through dicts and HTTP Requests."""
    ref, mine = servers
    for body in _openai_calls():
        want = _answer(ref, body, JaxRequest)
        got = _answer(mine, body, Request)
        assert _strip(got) == _strip(want), body
        if body.get("stream"):
            assert got[-1] == "[DONE]" and len(got) >= 3
            if "messages" in body:
                assert got[0]["choices"][0]["delta"]["role"] == "assistant"
            assert all(f["id"] == got[0]["id"] for f in got[:-1])
        else:
            assert got["usage"]["completion_tokens"] <= body["max_tokens"]
            assert got["usage"]["total_tokens"] == got["usage"]["prompt_tokens"] + got["usage"]["completion_tokens"]
    # A stop string taken from the greedy text cuts both at the same place.
    text = mine({"prompt": "the quick brown fox", "max_tokens": 24, "ignore_eos": True})["choices"][0]["text"]
    stop = text[len(text) // 2:len(text) // 2 + 2]
    assert len(stop) == 2, text
    body = {"prompt": "the quick brown fox", "max_tokens": 24, "ignore_eos": True, "stop": stop}
    got = mine(body)
    assert _strip(got) == _strip(ref(body))
    assert got["choices"][0]["finish_reason"] == "stop" and stop not in got["choices"][0]["text"]
    streamed = _sse(mine(dict(body, stream=True)))
    assert _strip(streamed) == _strip(_sse(ref(dict(body, stream=True))))
    assert _idle(mine._llm)


def test_openai_models_and_errors_match_ray_tpu(servers):
    ref, mine = servers
    for method, path, body in [("GET", "/v1/models", None), ("POST", "/v1/completions", {"model": "m"}),
                               ("POST", "/v1/embeddings", {"input": "x"}), ("GET", "/v1/completions", None),
                               ("POST", "/v1/chat/completions", {"messages": [{"role": "user"}],
                                                                  "max_tokens": "many"}),
                               ("POST", "/v1/completions", {"prompt": 7}), ("POST", "/v1/completions", [1])]:
        raw = json.dumps(body).encode() if body is not None else b""
        want = ref(JaxRequest(method, path, {}, {}, raw))
        got = mine(Request(method, path, {}, {}, raw))
        if isinstance(want, dict):
            assert _strip(got) == _strip(want)
        else:
            assert isinstance(got, HTTPResponse)
            assert (got.status, got.body, got.content_type) == (want.status, want.body, want.content_type)
    models = mine(Request("GET", "/v1/models", {}, {}, b""))
    assert models["data"][0]["id"] == "tiny" and models["data"][0]["default_temperature"] == 0.0


def test_prefix_router_matches_ray_tpu(tok_path):
    bodies = [{"prompt": "the quick brown fox " * 40}, {"prompt": "short"}, {"prompt": 3},
              {"messages": [{"role": "user", "content": "the scheduler " * 50}, "junk"]}, [1, 2], None]
    for tok in (None, tok_path, Tokenizer.train(CORPUS, vocab_size=3 + 256 + 40)):
        for page in (16, 128):
            ref, mine = jax_prefix_router(tok, page), make_prefix_router(tok, page)
            for b in bodies:
                raw = json.dumps(b).encode()
                assert mine(Request("POST", "/", {}, {}, raw)) == ref(JaxRequest("POST", "/", {}, {}, raw))
            assert mine(Request("POST", "/", {}, {}, b"{not json")) == ""
    keys = {make_prefix_router(tok_path, 16)(Request("POST", "/", {}, {}, json.dumps(b).encode()))
            for b in bodies[:2]}
    assert len(keys) == 2 and "" not in keys


def test_engine_udf_matches_ray_tpu(servers, weights, tok_path):
    jp, tp, _ = weights
    args = ({"max_tokens": 8}, tok_path, "prompt", "out")  # sampling, tokenizer, columns
    ref = JaxEngineUDF(JAX_MODEL, ENGINE, *args)
    ref.engine.set_params(jp)
    first = servers[0]._llm.engine  # share the compiled programs of one model
    ref.engine._prefill_jit, ref.engine._decode_jit = first._prefill_jit, first._decode_jit
    mine = _EngineUDF(PORT_MODEL, ENGINE, *args, device="cpu")
    mine.engine.set_params(tp)
    rows = [{"prompt": "the quick brown fox", "k": 1}, {"prompt": [5, 6, 7, 300], "k": 2},
            {"prompt": "distributed systems schedule", "k": 3}, {"prompt": "x", "k": 4},
            {"prompt": "the cluster", "k": 5}]
    got = mine(rows)
    assert got == ref(rows)
    assert [r["k"] for r in got] == [1, 2, 3, 4, 5] and all(len(r["out_tokens"]) <= 8 for r in got)
    assert all(r["out"] == mine.tok.decode(r["out_tokens"]) for r in got)
    # An over-long row refuses the whole block before any row is admitted.
    bad = rows[:2] + [{"prompt": list(range(3, 3 + ENGINE["max_seq"]))}]
    for udf in (ref, mine):
        with pytest.raises(ValueError, match="max_seq"):
            udf(bad)
        assert not udf.engine.has_work()
    assert mine(rows[:1]) == got[:1]


# ---------------------------------------------------------------------------
# the port's server alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["generate", "stream", "openai"])
def test_deadline_aborts_and_frees_the_slot(weights, tok_path, monkeypatch, path):
    def n_expired():
        return sum(s["value"] for s in metrics.snapshot()
                   if s["name"] == "serve.request.expired_total" and s["tags"].get("hop") == "llm")

    before = n_expired()
    if path == "openai":
        srv = OpenAIServer(PORT_MODEL, ENGINE, tokenizer=tok_path, chat_template=CHATML, device="cpu")
        srv._llm.apply_weights(weights[1])
        llm = srv._llm
    else:
        llm = _port_server(weights[1])
    _slow_steps(llm, monkeypatch)
    try:
        with pytest.raises(qos.DeadlineExceeded):
            if path == "openai":
                srv({"messages": [{"role": "user", "content": "hi"}], "max_tokens": 64, "ignore_eos": True,
                     "timeout_s": 0.3})
            else:
                with qos.request_context(timeout_s=0.3):
                    if path == "generate":
                        llm.generate([5, 6, 7], 64, sampling={"ignore_eos": True, "max_tokens": 64})
                    else:
                        for _ in llm.generate_stream([5, 6, 7], 64, sampling={"ignore_eos": True,
                                                                              "max_tokens": 64}):
                            pass
        assert _idle(llm)
        assert n_expired() == before + 1
        assert llm.check_health()
    finally:
        llm.__raytpu_exit__()


@pytest.mark.parametrize("streaming", [False, True])
def test_cancel_event_aborts_and_frees_the_slot(weights, monkeypatch, streaming):
    llm = _port_server(weights[1])
    _slow_steps(llm, monkeypatch)
    ev, raised = threading.Event(), []

    def client():
        tok = qos.set_cancel_event(ev)
        try:
            if streaming:
                for _ in llm.generate_stream([5, 6, 7], 64, timeout_s=TIMEOUT_S):
                    pass
            else:
                llm.generate([5, 6, 7], 64, timeout_s=TIMEOUT_S)
        except qos.RequestCancelled as e:
            raised.append(e)
        finally:
            qos.reset_cancel_event(tok)

    t = threading.Thread(target=client)
    try:
        t.start()
        t_end = time.time() + TIMEOUT_S
        while llm.stats()["active_slots"] == 0 and time.time() < t_end:
            time.sleep(0.01)
        assert llm.stats()["active_slots"] == 1
        ev.set()
        t.join(timeout=TIMEOUT_S)
        assert not t.is_alive() and len(raised) == 1
        assert _idle(llm)
    finally:
        llm.__raytpu_exit__()


def test_stream_closed_early_aborts(weights, tok_path, monkeypatch):
    srv = OpenAIServer(PORT_MODEL, ENGINE, tokenizer=tok_path, device="cpu")
    _slow_steps(srv._llm, monkeypatch, delay=0.02)
    try:
        gen = srv._llm.generate_stream([5, 6, 7], 64, sampling={"ignore_eos": True, "max_tokens": 64})
        next(gen)
        gen.close()
        assert _idle(srv._llm)
        sse = srv({"prompt": "the quick brown fox", "max_tokens": 64, "ignore_eos": True, "stream": True})
        frames = [next(sse), next(sse)]
        assert all(json.loads(f[len("data: "):]) for f in frames)
        sse.close()
        assert _idle(srv._llm)
        assert srv.check_health()
    finally:
        srv.__raytpu_exit__()


def test_apply_weights_changes_the_next_request_only(weights):
    _, tp, other = weights
    llm = _port_server(tp)
    try:
        prompt = [5, 17, 42, 7, 23]
        sp = {"ignore_eos": True, "max_tokens": 12}
        before = llm.generate(prompt, 12, sampling=sp)["tokens"]
        want_other = LLMEngine(TransformerConfig(**PORT_MODEL), params=other, device="cpu").generate(
            prompt, sampling=SamplingParams(ignore_eos=True, max_tokens=12))["tokens"]
        assert want_other != before
        # A swap while a stream is in flight lands between two steps: the
        # stream finishes whole; the next request runs on the new weights.
        stream = llm.generate_stream(prompt, 40, sampling=dict(sp, max_tokens=40))
        next(stream)
        assert llm.apply_weights(other)
        rest = list(stream)
        assert rest[-1]["finished"] and len(rest[-1]["tokens"]) == 40
        assert llm.generate(prompt, 12, sampling=sp)["tokens"] == want_other
        llm.apply_weights(tp)
        assert llm.generate(prompt, 12, sampling=sp)["tokens"] == before
    finally:
        llm.__raytpu_exit__()


def test_ttft_histogram_counts_every_request(weights):
    def count():
        return sum(s.get("n", 0) for s in metrics.snapshot()
                   if s["name"] == "serve.ttft_s" and s["tags"] == {"deployment": "llm"})

    llm = _port_server(weights[1])
    try:
        n0 = count()
        threads = [threading.Thread(target=llm.generate, args=([3 + i, 4, 5], 4 + i),
                                    kwargs={"timeout_s": TIMEOUT_S}) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        list(llm.generate_stream([9, 9], 3, timeout_s=TIMEOUT_S))
        assert count() == n0 + 7
        assert "raytpu_serve_ttft_s_count" in metrics.prometheus_text(metrics.snapshot())
    finally:
        llm.__raytpu_exit__()


def test_spans_only_under_a_trace(weights, monkeypatch):
    events = []
    monkeypatch.setattr(tracing, "_record_event", events.append)
    eng = LLMEngine(TransformerConfig(**PORT_MODEL), params=weights[1], device="cpu")
    eng.generate([5, 6, 7], 3)
    assert events == [] and tracing.current_trace() is None
    with tracing.span("client") as root:
        eng.generate([5, 6, 7], 3)
        tracing.event("tick", n=1)
    names = [e["name"] for e in events]
    assert names == ["llm.engine.generate", "tick", "client"]
    gen = events[0]
    assert gen["trace_id"] == root.trace_id and gen["parent_id"] == root.span_id
    assert gen["attrs"] == {"max_tokens": 3} and gen["dur"] >= 0
    assert events[2]["parent_id"] == "" and tracing.current_trace() is None
    # The server's generate span, with the engine's generate under nothing
    # (the stepping thread runs outside the caller's trace).
    events.clear()
    llm = _port_server(weights[1])
    try:
        with tracing.span("client"):
            llm.generate([5, 6, 7], 3, timeout_s=TIMEOUT_S)
        assert [e["name"] for e in events] == ["llm.generate", "client"]
        assert events[0]["parent_id"] == events[1]["span_id"]
    finally:
        llm.__raytpu_exit__()


def test_step_that_raises_ends_the_stepping_thread(weights, monkeypatch):
    llm = _port_server(weights[1])
    seen = []
    monkeypatch.setattr(threading, "excepthook", seen.append)

    def broken():
        raise RuntimeError("step failed")

    monkeypatch.setattr(llm.engine, "step", broken)
    assert llm.check_health()
    with pytest.raises(TimeoutError):
        llm.generate([5, 6, 7], 4, timeout_s=0.5)
    llm._thread.join(timeout=TIMEOUT_S)
    assert not llm.check_health()
    assert len(seen) == 1 and isinstance(seen[0].exc_value, RuntimeError)


def test_servers_run_on_the_gpu_unless_asked(monkeypatch, tok_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = {
        "LLMServer": lambda **kw: LLMServer(PORT_MODEL, ENGINE, **kw),
        "OpenAIServer": lambda **kw: OpenAIServer(PORT_MODEL, ENGINE, tokenizer=tok_path, **kw),
        "_EngineUDF": lambda **kw: _EngineUDF(PORT_MODEL, ENGINE, None, tok_path, "prompt", "out", **kw),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        obj = make(device="cpu")
        assert str(obj.engine.device if name == "_EngineUDF" else
                   (obj._llm if name == "OpenAIServer" else obj).engine.device) == "cpu"
        if name != "_EngineUDF":
            obj.__raytpu_exit__()


def test_runtime_only_arguments_raise(weights):
    """What still waits for a later slice raises a typed error naming its
    ROADMAP item: tensor_parallel > 1 in the app builders (the mesh). A
    params ObjectRef is served since serve came to the port
    (tests/test_torch_serve_llm.py); batch_generate since Data did
    (tests/test_torch_data_actor_pool.py): here it only builds its lazy
    actor-pool stage, with the device among the UDF's arguments;
    weights_channel since the checkpoint plane did
    (tests/test_torch_checkpoint_plane.py)."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.llm import batch_generate, build_llm_app, build_openai_app
    from ray_tpu_torch.llm.batch import _EngineUDF

    stage = batch_generate(rd.from_items([{"prompt": [1, 2, 3]}]), PORT_MODEL, ENGINE,
                           device="cpu")._leaf
    assert stage.kind == "map_batches" and stage.fn is _EngineUDF
    assert stage.params["compute"] == "actors" and stage.params["max_tasks_in_flight_per_actor"] == 2
    assert stage.params["fn_constructor_args"][-1] == "cpu"
    for build in (build_llm_app, build_openai_app):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            build(PORT_MODEL, dict(ENGINE, tensor_parallel=2), device="cpu")


def test_warmup_runs_the_sampler(weights, monkeypatch):
    """Warmup is greedy, so it also runs the sampler at every batch size it
    will be handed (prefill groups and the decode slots), without drawing
    from the engine's own generator: sampled requests keep their stream."""
    import ray_tpu_torch.llm.engine as engine_mod

    seen = []
    real = engine_mod.sample_batch

    def recording(logits, *a, **kw):
        seen.append(tuple(logits.shape))
        return real(logits, *a, **kw)

    llm = _port_server(weights[1])
    try:
        sp = {"temperature": 0.8, "top_p": 0.95, "top_k": 40, "max_tokens": 10, "ignore_eos": True}
        cold = llm.generate([5, 6, 7], 10, sampling=sp)["tokens"]
    finally:
        llm.__raytpu_exit__()
    monkeypatch.setattr(engine_mod, "sample_batch", recording)
    warm = _port_server(weights[1])
    try:
        warm.engine.warmup(buckets=(32,), k_values=(2, 1))
        assert seen == [(1, MODEL["vocab_size"]), (2, MODEL["vocab_size"]), (ENGINE["max_slots"], MODEL["vocab_size"])]
        assert warm.generate([5, 6, 7], 10, sampling=sp)["tokens"] == cold
    finally:
        warm.__raytpu_exit__()


def test_stress_many_callers_with_aborts(weights):
    """More caller threads than cores, a tiny switch interval, and aborts
    (early-closed streams, passed deadlines) racing new requests: every
    request that runs to its end gets all its tokens, and afterwards the
    engine holds nothing and every page is back (a lost append or a lost
    abort would hang a caller or leak a slot)."""
    import sys

    llm = _port_server(weights[1], max_slots=3)
    sp = {"ignore_eos": True, "max_tokens": 6}
    done, errors = [], []

    def caller(i):
        try:
            for j in range(4):
                prompt = [3 + (i + j) % 50, 4, 5]
                kind = (i + j) % 3
                if kind == 0:
                    r = llm.generate(prompt, 6, timeout_s=TIMEOUT_S, sampling=sp)
                    assert len(r["tokens"]) == 6
                    done.append(r)
                elif kind == 1:
                    stream = llm.generate_stream(prompt, 6, timeout_s=TIMEOUT_S, sampling=sp)
                    next(stream)
                    stream.close()
                else:
                    try:
                        with qos.request_context(timeout_s=0.002 * (1 + i % 5)):
                            done.append(llm.generate(prompt, 6, sampling=sp))
                    except qos.DeadlineExceeded:
                        pass
        except Exception as e:  # noqa: BLE001  (asserted empty below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,)) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not errors, errors[:3]
        assert len(done) >= 32 and all(len(r["tokens"]) == 6 for r in done)
        assert _idle(llm, timeout=10.0)
        assert llm.check_health()
    finally:
        llm.__raytpu_exit__()
