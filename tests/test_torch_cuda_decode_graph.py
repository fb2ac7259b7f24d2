"""The decode graphs on the card: a paged engine on one CUDA device replays
its decode blocks from CUDA graphs (one per block size, greedy or sampled)
and hands over exactly what the eager body computes.

Each comparison drives one script of requests through a graph engine and
an eager engine on the same weights. The eager engine's sampler is wrapped
on the instance, a hook that must see every call, so its decode graphs are
turned off (``_graphs_on``). Greedy tokens must be equal bitwise: the
replay launches the kernels the eager body launches, in the same order, on
the same inputs.

Runs only where a CUDA device exists (``-m cuda``; on the chip machine run
it with ``--noconftest``, the repo conftest imports jax); elsewhere each
test skips with the reason.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

MODEL = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=512)
# Block sizes (2, 8): 2 while requests wait or a slot owes its first token.
ENGINE = dict(max_slots=4, max_seq=512, kv_layout="paged", page_size=64, prefill_buckets=(64, 128),
              decode_block=8, seed=3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")


def _engine(params=None, warm=True, **kw):
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig

    eng = LLMEngine(TransformerConfig(**MODEL), params=params, engine_config=EngineConfig(**{**ENGINE, **kw}),
                    device="cuda")
    if warm:
        eng.warmup()
    return eng


def _eager(eng):
    """Wraps ``eng``'s sampler on the instance and keeps its decode eager;
    returns the rows of every call."""
    rows = []
    sample = eng._sample

    def counted(logits, *a):
        rows.append(logits.shape[0])
        return sample(logits, *a)

    eng._sample, eng._graphs_on = counted, False
    return rows


def _toks(seed, n):
    return np.random.default_rng(seed).integers(1, MODEL["vocab_size"], n).astype(np.int32)


def _drive(eng, script, sampling=None):
    """Runs ("add", rid, prompt, max_tokens), ("step",), ("drain",) and
    ("abort", rid) on ``eng``; returns every step's events without their
    times."""
    from ray_tpu_torch.llm import SamplingParams

    record = []
    for act in script:
        if act[0] == "add":
            sp = SamplingParams(max_tokens=act[3], **(sampling or {}))
            eng.add_request(act[1], act[2], act[3], sampling=sp)
        elif act[0] == "abort":
            eng.abort(act[1])
        else:
            while eng.has_work():
                record.append({rid: {k: v for k, v in ev.items() if k != "ttft_s"}
                               for rid, ev in eng.step().items()})
                if act[0] == "step":
                    break
    return record


# Admission, a retire (and the re-sync of the mirrors) while others decode,
# short blocks while requests wait, full blocks once the queue is empty. Two
# requests pass 128 tokens (K4's shortest run at pages of 64), so K4 merges
# runs through its ticket counters.
SCRIPT = [("add", "a", _toks(1, 120), 40), ("add", "b", _toks(2, 100), 36), ("step",),
          *[("add", f"q{i}", _toks(10 + i, 30 + 17 * i), 6 + 5 * i) for i in range(4)], ("drain",)]


def _k4_launches():
    from ray_tpu_torch.ops import paged_attention

    return paged_attention.LAUNCHES


def _check_graphs(eng, before, k4_before):
    """Every block since ``before`` replayed a graph, none was captured, and
    K4's launch count rose by n_layers per token step."""
    after = eng.counters()
    blocks = after["decode_blocks"] - before["decode_blocks"]
    assert blocks > 0
    assert after["decode_graph_blocks"] - before["decode_graph_blocks"] == blocks
    assert after["decode_graph_captures"] == before["decode_graph_captures"]
    steps = after["decode_token_steps"] - before["decode_token_steps"]
    assert _k4_launches() - k4_before == MODEL["n_layers"] * steps


def test_graph_decode_matches_eager_bitwise(card):
    graph = _engine()
    assert graph.counters()["decode_graph_captures"] == 4  # block sizes 2 and 8, greedy and sampled
    eager = _engine(params=graph.params)
    rows = _eager(eager)
    want = _drive(eager, SCRIPT)
    assert eager.counters()["decode_graph_blocks"] == 0
    assert rows.count(ENGINE["max_slots"]) == eager.counters()["decode_token_steps"]

    before, k4 = graph.counters(), _k4_launches()
    got = _drive(graph, SCRIPT)
    assert got == want
    _check_graphs(graph, before, k4)
    # Both block sizes were taken: the queue held requests, then emptied.
    n_blocks = graph.counters()["decode_blocks"] - before["decode_blocks"]
    steps = graph.counters()["decode_token_steps"] - before["decode_token_steps"]
    assert 2 * n_blocks < steps < 8 * n_blocks


def test_prefix_hit_and_chunked_prefill_match_eager(card):
    """An exact prefix hit (its first token comes out of a short block) and
    a prompt prefilled in chunks of 128 while another request decodes."""
    script = [("add", "a", _toks(3, 100), 10), ("drain",),
              ("add", "hit", _toks(3, 100), 10), ("add", "long", _toks(4, 300), 10),
              ("add", "c", _toks(5, 20), 16), ("drain",)]
    kw = dict(prefix_cache=True, chunked_prefill=128)
    graph = _engine(**kw)
    eager = _engine(params=graph.params, **kw)
    _eager(eager)
    want = _drive(eager, script)
    before, k4 = graph.counters(), _k4_launches()
    got = _drive(graph, script)
    assert got == want
    assert graph.prefix_cache_stats["hits"] == 1
    _check_graphs(graph, before, k4)


def test_new_weights_drop_the_graphs(card):
    """After set_params no graph captured against the old weights replays:
    the first block of each kind runs eagerly and captures anew, and the
    tokens are the eager engine's under the new weights."""
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import init_params

    graph = _engine()
    old = _drive(graph, SCRIPT)
    new = init_params(TransformerConfig(**MODEL), torch.Generator(device="cuda").manual_seed(5), "cuda")
    graph.set_params(new)
    eager = _engine(params=new)
    _eager(eager)
    before = graph.counters()
    got = _drive(graph, SCRIPT)
    assert got == _drive(eager, SCRIPT)
    assert got != old  # the new weights decode other tokens
    after = graph.counters()
    # Greedy blocks of sizes 2 and 8: one eager block and one capture each.
    assert after["decode_graph_captures"] - before["decode_graph_captures"] == 2
    blocks = after["decode_blocks"] - before["decode_blocks"]
    assert after["decode_graph_blocks"] - before["decode_graph_blocks"] == blocks - 2


def test_sampled_graph_tokens_are_top_k_and_seeded(card):
    """A sampled batch (temperature 1, top-k 4) replays the sampled graph:
    two engines with one seed hand over the same tokens, which differ from
    greedy ones, and each is among the top 4 of its logits (read from an
    eager engine forced onto the same tokens)."""
    sampling = dict(temperature=1.0, top_k=4)
    a, b = _engine(), _engine()
    recorded = _record_tokens(a)
    before, k4 = a.counters(), _k4_launches()
    got = _drive(a, SCRIPT, sampling)
    _check_graphs(a, before, k4)
    assert got == _drive(b, SCRIPT, sampling)
    assert got != _drive(_engine(params=a.params), SCRIPT)

    forced = _engine(params=a.params, warm=False)
    calls = []

    def sample(logits, *args):
        t = recorded[len(calls)].to(logits.device)
        calls.append((logits.float().cpu(), t.cpu()))
        return t

    forced._sample, forced._graphs_on = sample, False  # the hook sees every call
    assert _drive(forced, SCRIPT, sampling) == got
    assert len(calls) == len(recorded)
    for logits, t in calls:
        top = logits.topk(4, dim=-1).indices
        assert bool((top == t.long()[:, None]).any(dim=-1).all())


def _record_tokens(eng):
    """Wraps ``eng``'s prefill groups and decode blocks on the instance
    (graphs stay on) and returns, in order, the tokens of each sampling
    call: one [k] tensor per prefill group, one [B] per token step."""
    out = []
    prefill, decode = eng._prefill_batch_impl, eng._decode

    def pre(*a):
        t = prefill(*a)
        out.append(t.cpu())
        return t

    def dec(n, gen):
        r = decode(n, gen)
        out.extend(r[0].cpu())
        return r

    eng._prefill_batch_impl, eng._decode = pre, dec
    return out


@pytest.mark.parametrize("grow", ["engine", "launch"])
def test_graphs_outlive_the_ticket_counters_they_captured(card, grow):
    """K4's ticket counters are one buffer per card that a larger batch
    replaces: a warmed-up engine with more slots, or a direct K4 launch at a
    larger batch. A graph captured before that keeps replaying against the
    old buffer's address, so the old buffer must stay allocated: the small
    engine's tokens stay the eager ones, and the tensors of its size
    allocated after the growth (where its memory would go if it were freed)
    are never written."""
    from ray_tpu_torch.ops import paged_attention as pa

    assert any(len(a[2]) + a[3] > pa.MIN_RUN_TOKENS for a in SCRIPT if a[0] == "add")
    graph = _engine()
    eager = _engine(params=graph.params)
    _eager(eager)
    want = _drive(eager, SCRIPT)
    dev = graph.d_lengths.device
    old = pa._COUNTERS[dev]
    old_ptr, old_n, kv = old.data_ptr(), old.numel(), MODEL["n_kv_heads"]
    del old
    bigger = None
    if grow == "engine":
        bigger = _engine(max_slots=old_n // kv + 1)
    else:
        B, H, D, ps = old_n // kv + 1, MODEL["n_heads"], MODEL["d_model"] // MODEL["n_heads"], 64
        pages = torch.zeros(kv, 2, ps, D, dtype=torch.bfloat16, device=dev)
        pa.paged_decode(torch.ones(B, H, D, dtype=torch.bfloat16, device=dev), pages, pages,
                        torch.ones(B, dtype=torch.int32, device=dev), torch.ones(B, 1, dtype=torch.int32, device=dev))
    assert pa._COUNTERS[dev].data_ptr() != old_ptr  # the counters grew
    # Blocks of the old buffer's rounded size, enough to take every free one.
    junk = [torch.full((-(-old_n // 128) * 128,), 7, dtype=torch.int32, device=dev) for _ in range(4096)]
    before, k4 = graph.counters(), _k4_launches()
    got = _drive(graph, SCRIPT)
    assert got == want
    _check_graphs(graph, before, k4)
    assert bool(torch.stack(junk).eq(7).all())
    del bigger


def test_capture_survives_a_collection_of_old_graphs(card):
    """An engine held only by a reference cycle keeps its graphs until the
    collector runs. A collection in the middle of another engine's capture
    would destroy them there, which invalidates the capture: the collector
    waits until the capture is over. The cycle is made during the first
    capture, so that the youngest generation holds it."""
    import gc

    held = {"old": _engine()}
    eng = _engine(warm=False)
    eager = eng._decode_eager

    def dropping(*a):
        if held and torch.cuda.is_current_stream_capturing():
            box = [held.pop("old")]
            box.append(box)
            del box  # garbage from here on: only the collector frees it
        return eager(*a)

    eng._decode_eager = dropping
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)  # collect at nearly every allocation
    try:
        eng.warmup()
    finally:
        gc.set_threshold(*thresholds)
    assert not held and eng.counters()["decode_graph_captures"] == 4
    before, k4 = eng.counters(), _k4_launches()
    _drive(eng, SCRIPT[:3])
    _check_graphs(eng, before, k4)
