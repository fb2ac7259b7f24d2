"""The port's prefix KV cache against ray_tpu's, step by step.

Both engines are built on the same weights (one numpy tree made from a
seed, carried into the port by ``from_numpy_tree``; fp32,
``attention_impl="reference"`` on the JAX side) at the tiny
configuration of tests/test_scale_plane.py (vocab 128, d_model 32, 2 layers,
max_seq 256, page 32, buckets 32-256, decode_block 4), with MHA and with GQA
(4 q heads, 2 KV heads). Each script of requests runs on both; after every
step the per-request events (tokens, ``finished``, ``finish_reason``, whether
a TTFT was reported), ``prefix_cache_stats``, the free-page count and the
page refcounts must be equal (greedy tokens: exact), and the port's pages
must be conserved (free + distinct cached + held = the pool). The scripts
mirror tests/test_prefix_cache.py; tests/test_torch_chunked_prefill.py runs
the chunked-prefill scripts through the same runner.

Then port-only checks: the tail prefill over cached pages against a cold
prefill of the whole prompt (fp32, <= 1e-4), the page copy (bitwise), which
prefill programs a hit dispatches, and per-request sampling on a hit.
"""
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu_torch.convert import from_numpy_tree
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.models.transformer import param_shapes

TINY = dict(vocab_size=128, d_model=32, n_layers=2, d_ff=64, max_seq_len=256)
MODELS = {"mha": dict(TINY, n_heads=2, n_kv_heads=2), "gqa": dict(TINY, n_heads=4, n_kv_heads=2)}
BASE = dict(max_slots=4, max_seq=256, prefill_buckets=(32, 64, 128, 256), kv_layout="paged",
            page_size=32, decode_block=4, seed=7)


def _numpy_params(cfg, seed):
    """The parameter tree with numpy leaves drawn from a seed (norms 1,
    matrices scaled by 1/sqrt of their leading input axis)."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.endswith("norm"):
            return np.ones(shape, np.float32)
        fan_in = shape[0] if len(shape) == 2 else shape[1]
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    shapes = param_shapes(cfg)
    tree = {k: leaf(k, v) for k, v in shapes.items() if k != "layers"}
    tree["layers"] = {k: leaf(k, v) for k, v in shapes["layers"].items()}
    return tree


@pytest.fixture(scope="module")
def models():
    """model name -> (JAX config, JAX params, port config, port params): one
    numpy tree, made from a seed, carried into both packages."""
    out = {}
    for name, kw in MODELS.items():
        cfg = TransformerConfig(**kw, dtype=torch.float32)
        tree = _numpy_params(cfg, seed=0)
        jcfg = JaxConfig(**kw, dtype=jnp.float32, attention_impl="reference")
        out[name] = (jcfg, jax.tree.map(jnp.asarray, tree), cfg, from_numpy_tree(tree, cfg, device="cpu"))
    return out


_PROGRAMS: dict = {}  # model name -> the first JAX engine built for it


def jax_engine(models, model, **kw):
    """A fresh JAX engine. Engines of one model share BASE's shapes, and the
    flags scripts vary (prefix_cache, chunked_prefill) are read on the host
    only, so each reuses the first one's compiled programs."""
    jcfg, jp, _, _ = models[model]
    eng = JaxLLMEngine(jcfg, params=jp, engine_config=JaxEngineConfig(**BASE, **kw))
    first = _PROGRAMS.setdefault(model, eng)
    if first is not eng:
        eng._prefill_jit, eng._tail_jit = first._prefill_jit, first._tail_jit
        eng._decode_jit, eng._copy_pages_jit = first._decode_jit, first._copy_pages_jit
    return eng


def port_engine(models, model, **kw):
    _, _, cfg, params = models[model]
    return LLMEngine(cfg, params=params, engine_config=EngineConfig(**BASE, **kw), device="cpu")


def _snapshot(eng, events):
    evs = {}
    for rid, ev in events.items():
        e = {k: v for k, v in ev.items() if k != "ttft_s"}
        e["has_ttft"] = ev.get("ttft_s") is not None
        evs[rid] = e
    return {"events": evs, "stats": eng.prefix_cache_stats, "free": len(eng.free_pages),
            "refs": dict(eng._page_refs)}


def run_script(eng, script):
    """Runs a script's actions on one engine and returns what it saw after
    every step (and every abort). Actions: ("add", rid, tokens, max_tokens),
    ("step",), ("drain",), ("abort", rid), ("pool", n) keeps only the first n
    free pages (a tight pool). Checks page conservation throughout."""
    record = []
    pool = None

    def conserved():
        held = sum(len(s.pages) for s in eng.slots if s is not None)
        return len(eng.free_pages) + len(eng._page_refs) + held == pool

    for act in script:
        if act[0] == "pool":
            eng.free_pages = deque(list(eng.free_pages)[: act[1]])
        elif act[0] == "add":
            eng.add_request(act[1], np.asarray(act[2], np.int32), act[3])
        elif act[0] == "abort":
            eng.abort(act[1])
            record.append(_snapshot(eng, {}))
        else:
            while True:
                record.append(_snapshot(eng, eng.step()))
                assert conserved(), record[-1]
                if act[0] == "step" or not eng.has_work():
                    break
        if pool is None:
            pool = len(eng.free_pages)
    return record


def assert_same_run(models, model, script, **flags):
    want = run_script(jax_engine(models, model, **flags), script)
    got = run_script(port_engine(models, model, **flags), script)
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {n}: port {g} != ray_tpu {w}"
    return got


def _toks(seed, n):
    return np.random.default_rng(seed).integers(1, 128, n).astype(np.int32)


# Lengths keep every cold prefill in the 64 bucket and every tail in the 32
# bucket over one context page: few shapes, so few JAX programs to compile.
SYS = _toks(0, 32)  # a one-page system prompt
P60, DECOY = _toks(1, 60), _toks(2, 60)


def _generate(*requests):
    """Each request alone, in turn: add it, then step until idle."""
    script = []
    for rid, toks, max_tokens in requests:
        script += [("add", rid, toks, max_tokens), ("drain",)]
    return script


SCRIPTS = {
    # test_prefix_cache.py:25: the same prompt twice -> an exact hit.
    "exact_hit": _generate(("a", _toks(3, 40), 8), ("b", _toks(3, 40), 8)),
    # :116: a prompt extending a cached page-aligned prefix -> tail prefill.
    "partial_hit": _generate(("a", np.concatenate([SYS, [3, 1, 4, 1, 5]]), 8),
                             ("b", np.concatenate([SYS, [2, 7, 1, 8]]), 8)),
    # :140: a page-aligned prompt covered by a longer prompt's chain entry.
    "page_aligned_extension": _generate(("a", _toks(4, 60), 4), ("b", _toks(4, 60)[:32], 4)),
    # :65: a tight pool evicts the least recently used prefixes.
    "lru_eviction": [("pool", 8)] + _generate(
        *[(f"p{i}", _toks(10 + i, 33), 4) for i in range(5)], ("again", _toks(14, 33), 4)),
    # :211: an admission that must evict does not evict the entry it hits.
    "own_prefix_protected": [("pool", 6)] + _generate(("a", P60, 4), ("decoy", DECOY, 4), ("b", P60, 4)),
    # The corner after it: nothing runs and only the hit's own pages could be
    # reclaimed, so the request degrades to a miss.
    "own_prefix_degrades_to_miss": [("pool", 4)] + _generate(("a", P60, 4), ("b", P60, 4)),
    # :189: partial hits retiring share the cached system-prompt pages.
    "partial_hit_retire_shares_pages": _generate(
        ("a", np.concatenate([SYS, [3, 1, 4, 1, 5]]), 4),
        *[(f"q{t}", np.concatenate([SYS, [10 + t, 2, 6]]), 4) for t in range(3)]),
    # An exact hit, a partial hit and a miss admitted in one step.
    "mixed_wave": _generate(("a", np.concatenate([SYS, [9, 9, 9]]), 4)) + [
        ("add", "exact", np.concatenate([SYS, [9, 9, 9]]), 6),
        ("add", "partial", np.concatenate([SYS, _toks(5, 20)]), 6),
        ("add", "miss", _toks(6, 50), 6),
        ("drain",)],
}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_prefix_cache_matches_jax_engine(models, name, model):
    record = assert_same_run(models, model, SCRIPTS[name], prefix_cache=True)
    stats = record[-1]["stats"]
    if name == "exact_hit":
        assert stats["hits"] == 1
    elif name == "partial_hit":
        assert stats["partial_hits"] == 1
    elif name == "own_prefix_protected":
        assert stats["hits"] == 1
    elif name == "own_prefix_degrades_to_miss":
        assert (stats["hits"], stats["misses"]) == (0, 2)
    elif name == "partial_hit_retire_shares_pages":
        assert (stats["partial_hits"], stats["cached_pages"]) == (3, 5)


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(MODELS))
def test_tail_prefill_over_cached_pages_matches_cold_prefill(models, model):
    """The tail prefill over the cached pages gives the logits of a cold
    prefill of the whole prompt (fp32; eager reduction order differs)."""
    eng = port_engine(models, model, prefix_cache=True)
    eng.generate(np.concatenate([SYS, [3, 1, 4]]), max_tokens=2)
    prompt = np.concatenate([SYS, _toks(7, 30)])
    P, start = len(prompt), len(SYS)
    ctx = np.asarray(eng._prefix_cache[eng._prefix_digests(SYS)[-1][1]]["pages"], np.int32)
    padded = np.zeros(32, np.int32)
    padded[: P - start] = prompt[start:]
    tail = eng._tail_prefill_logits(padded, start, P, ctx, np.zeros(1, np.int32))
    full = np.zeros((1, 64), np.int32)
    full[0, :P] = prompt
    cold = eng._prefill_logits(full, np.array([P], np.int32), np.zeros((1, 2), np.int32))
    assert tail.shape == cold.shape == (1, 128)
    assert (tail - cold).abs().max().item() <= 1e-4


def test_copy_pages_is_bitwise(models):
    eng = port_engine(models, "gqa", prefix_cache=True)
    eng.generate(_toks(8, 100), max_tokens=2)
    src = sorted(eng._page_refs)
    dst = [eng.free_pages[0], eng.free_pages[5], eng.free_pages[9], eng.free_pages[2]]
    eng._copy_pages(src, dst)
    rows = eng._pool_rows
    for pool in (eng.k_pages, eng.v_pages):  # every layer and kv head
        assert torch.equal(pool[:, :, rows(dst)], pool[:, :, rows(src)])


def test_copy_pages_warmup_leaves_no_trace(models):
    prompt = _toks(9, 45)
    outs = []
    for warm in (False, True):
        eng = port_engine(models, "mha", prefix_cache=True)
        if warm:
            eng.warmup(buckets=(64,), k_values=(1,))
        outs.append([eng.generate(prompt, max_tokens=6)["tokens"] for _ in range(2)])
    assert outs[0] == outs[1] and outs[0][0] == outs[0][1]


def _prefix_cache_test_engine():
    """tests/test_prefix_cache.py's setup: page 64, buckets (64, 512)."""
    cfg = TransformerConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                            max_seq_len=1024, dtype=torch.float32)
    return LLMEngine(cfg, device="cpu", engine_config=EngineConfig(
        max_slots=4, max_seq=1024, prefill_buckets=(64, 512), kv_layout="paged", page_size=64,
        prefix_cache=True))


def _count_prefills(eng):
    calls = []
    full, tail = eng._prefill_batch_impl, eng._tail_prefill_impl

    def count_full(tokens, *a):
        calls.append(("full", tokens.shape[1], tokens.shape[0]))
        return full(tokens, *a)

    def count_tail(tokens, *a):
        calls.append(("tail", len(tokens)))
        return tail(tokens, *a)

    eng._prefill_batch_impl, eng._tail_prefill_impl = count_full, count_tail
    return calls


def test_exact_hit_dispatches_no_prefill_and_partial_hit_only_its_tail():
    eng = _prefix_cache_test_engine()
    sys_prompt = (np.arange(7, 7 + 128, dtype=np.int32) % 96) + 1  # 2 pages
    q1 = np.concatenate([sys_prompt, np.array([3, 1, 4, 1, 5], np.int32)])
    q2 = np.concatenate([sys_prompt, np.array([2, 7, 1, 8], np.int32)])
    cold = eng.generate(q1, max_tokens=8)
    calls = _count_prefills(eng)
    warm = eng.generate(q1, max_tokens=8)
    assert calls == [] and warm["tokens"] == cold["tokens"]
    assert eng.prefix_cache_stats["hits"] == 1 and warm["ttft_s"] > 0
    eng.generate(q2, max_tokens=8)
    assert calls == [("tail", 64)]
    assert eng.prefix_cache_stats["partial_hits"] == 1


def test_hit_respects_per_request_sampling():
    """Two hot-sampled hits on one cached prompt diverge: the cache reuses
    KV, not tokens."""
    eng = _prefix_cache_test_engine()
    prompt = np.arange(1, 70, dtype=np.int32) % 97
    eng.generate(prompt, max_tokens=4)
    hot = SamplingParams(temperature=3.0, max_tokens=16)
    a = eng.generate(prompt, max_tokens=16, sampling=hot)
    b = eng.generate(prompt, max_tokens=16, sampling=hot)
    assert eng.prefix_cache_stats["hits"] == 2
    assert a["tokens"] != b["tokens"]


# ---------------------------------------------------------------------------
# tests/test_prefix_cache.py's cases on the port's engine alone (its CFG in
# torch's fp32, device="cpu"); test_hit_respects_per_request_sampling is
# above. The three that spy on the reference's ``_prefill`` count
# dispatches through the port's hooks (_count_prefills above: a tail
# prefill is ("tail", its padded length)).
# ---------------------------------------------------------------------------

REF_CFG = TransformerConfig(
    vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=1024, dtype=torch.float32, attention_impl="reference",
)


def _engine(**kw):
    defaults = dict(max_slots=4, max_seq=1024, prefill_buckets=(64, 512),
                    kv_layout="paged", page_size=64, prefix_cache=True)
    defaults.update(kw)
    return LLMEngine(REF_CFG, engine_config=EngineConfig(**defaults), device="cpu")


def test_hit_is_exact_and_skips_prefill():
    """A cache hit produces byte-identical greedy output with ZERO prefill
    dispatches (the whole point: prompt KV comes from the cache)."""
    eng = _engine()
    prompt = np.arange(1, 70, dtype=np.int32) % 97

    cold = eng.generate(prompt, max_tokens=8)
    # 69 tokens @ page 64: chain entry for the 64-token page-aligned prefix
    # + the full-prompt entry, sharing page 0 -> 2 distinct cached pages.
    assert eng.prefix_cache_stats == {"hits": 0, "partial_hits": 0, "misses": 1,
                                      "entries": 2, "cached_pages": 2}
    calls = _count_prefills(eng)
    warm = eng.generate(prompt, max_tokens=8)
    assert warm["tokens"] == cold["tokens"]
    assert calls == [], f"cache hit still dispatched prefill: {calls}"
    assert eng.prefix_cache_stats["hits"] == 1
    assert warm["ttft_s"] is not None and warm["ttft_s"] > 0


def test_lru_eviction_under_page_pressure():
    """A tight page pool evicts cached prefixes rather than starving
    admission; everything still completes correctly."""
    # Pool sized so ~2 cached prompts exhaust it.
    eng = _engine(max_slots=2, total_pages=9)
    prompts = [np.arange(1 + i, 66 + i, dtype=np.int32) % 97 for i in range(4)]
    outs = [eng.generate(p, max_tokens=4)["tokens"] for p in prompts]
    stats = eng.prefix_cache_stats
    assert stats["cached_pages"] <= 8
    # Re-running the LAST prompt (most recently cached) still hits.
    again = eng.generate(prompts[-1], max_tokens=4)
    assert again["tokens"] == outs[-1]


@pytest.mark.slow  # heavy battery; tier-1 budget
def test_cold_warm_ttft_gap():
    """Cache-hit TTFT beats cold TTFT (the routing payoff): prefilling a
    ~500-token prompt costs real compute; the hit replaces it with a page
    copy. Both paths pre-warmed so compile time is excluded."""
    eng = _engine()
    eng.warmup(buckets=(512,))
    warm_decoy = np.arange(3, 500, dtype=np.int32) % 97
    eng.generate(warm_decoy, max_tokens=2)  # warm every program incl. copy
    eng.generate(warm_decoy, max_tokens=2)

    prompt = np.arange(5, 500, dtype=np.int32) % 97
    colds, warms = [], []
    for trial in range(3):
        p = (prompt + trial) % 97
        colds.append(eng.generate(p, max_tokens=2)["ttft_s"])
        warms.append(eng.generate(p, max_tokens=2)["ttft_s"])
    cold, warm = min(colds), min(warms)
    assert warm < cold, f"cache-hit ttft {warm:.4f}s not below cold {cold:.4f}s"


def test_partial_prefix_tail_prefill_matches_cold():
    """The canonical shared-system-prompt workload: a prompt EXTENDING a
    cached page-aligned prefix prefills only the tail, attending over the
    cached pages — greedy output is identical to a cold engine's, and no
    full-length prefill is dispatched."""
    sys_prompt = (np.arange(7, 7 + 128, dtype=np.int32) % 96) + 1  # 2 pages
    q1 = np.concatenate([sys_prompt, np.array([3, 1, 4, 1, 5], np.int32)])
    q2 = np.concatenate([sys_prompt, np.array([2, 7, 1, 8], np.int32)])

    warm_eng = _engine()
    warm_eng.generate(q1, max_tokens=8)  # populates chain entries for sys
    calls = _count_prefills(warm_eng)
    warm = warm_eng.generate(q2, max_tokens=8)
    assert warm_eng.prefix_cache_stats["partial_hits"] == 1
    assert all(c[0] == "tail" for c in calls), f"partial hit ran full prefill: {calls}"
    assert calls and calls[0][1] == 64, f"tail bucket should be 64: {calls}"

    cold_eng = _engine()  # same seed -> same params
    cold = cold_eng.generate(q2, max_tokens=8)
    assert warm["tokens"] == cold["tokens"], (
        f"partial-prefix output diverged: {warm['tokens']} vs {cold['tokens']}"
    )


def test_partial_prefix_page_aligned_extension():
    """A prompt that extends the cached prefix by exactly whole pages (the
    new length is page-aligned and fully covered by a chain entry of an
    earlier LONGER prompt's prefix) restarts decode with no prefill."""
    base = (np.arange(11, 11 + 200, dtype=np.int32) % 96) + 1  # 3 full pages + tail
    eng = _engine()
    eng.generate(base, max_tokens=4)
    calls = _count_prefills(eng)
    # First 128 tokens = exactly 2 cached full pages -> exact-length chain
    # hit: decode re-derives position 127, no prefill of any kind.
    out = eng.generate(base[:128], max_tokens=4)
    assert calls == [], f"page-aligned covered prompt dispatched prefill: {calls}"
    assert eng.prefix_cache_stats["hits"] == 1
    cold = _engine().generate(base[:128], max_tokens=4)
    assert out["tokens"] == cold["tokens"]


def test_shared_page_refcounts_and_conservation():
    """Chain entries share pages; eviction frees a page only when its last
    referencing entry goes, and no page is ever leaked or double-freed."""
    eng = _engine(max_slots=2, total_pages=12)
    total = eng.ec.total_pages - 1  # page 0 reserved

    def conserved():
        held = sum(len(s.pages) for s in eng.slots if s is not None)
        return len(eng.free_pages) + len(eng._page_refs) + held == total

    p1 = (np.arange(1, 1 + 150, dtype=np.int32) % 96) + 1
    eng.generate(p1, max_tokens=4)
    assert conserved()
    stats = eng.prefix_cache_stats
    assert stats["entries"] == 3  # 64-prefix, 128-prefix, full 150
    assert stats["cached_pages"] == 3  # 3 distinct pages, shared by chain
    # Page 0 of the chain is referenced by all three entries.
    first_page = next(iter(eng._prefix_cache.values()))["pages"][0]
    assert eng._page_refs[first_page] == 3
    # Evict one entry's worth: LRU entry (the 64-token prefix) goes first,
    # but its page is shared -> nothing frees until all referents go.
    before_free = len(eng.free_pages)
    eng._evict_prefix_cache(1)
    assert conserved()
    assert len(eng.free_pages) >= before_free + 1
    # Full drain.
    eng._evict_prefix_cache(100)
    assert not eng._prefix_cache and not eng._page_refs
    assert len(eng.free_pages) == total
    assert conserved()


def test_partial_hit_retire_shares_prefix_pages():
    """N requests extending one system prompt must not cache N copies of
    it: a retiring partial-hit slot's new chain entries reference the
    ALREADY-cached prefix pages, and the slot's duplicate copies free."""
    sys_prompt = (np.arange(7, 7 + 128, dtype=np.int32) % 96) + 1  # 2 pages
    eng = _engine()
    q1 = np.concatenate([sys_prompt, np.array([3, 1, 4, 1, 5], np.int32)])
    eng.generate(q1, max_tokens=4)
    assert eng.prefix_cache_stats["cached_pages"] == 3  # 2 sys + 1 tail
    for t in range(3):
        q = np.concatenate([sys_prompt, np.array([10 + t, 2, 6], np.int32)])
        eng.generate(q, max_tokens=4)
    stats = eng.prefix_cache_stats
    assert stats["partial_hits"] == 3
    # Each extension adds ONE page (its own tail), never a sys copy.
    assert stats["cached_pages"] == 6, stats
    # The shared system-prompt pages are referenced by every full entry.
    first = next(iter(eng._prefix_cache.values()))["pages"][0]
    assert eng._page_refs[first] >= 4


@pytest.mark.slow  # heavy battery; tier-1 budget
def test_admission_does_not_evict_its_own_prefix():
    """Under page pressure a request must not evict the very entry it is
    about to hit (lookup now precedes eviction, hit entry protected)."""
    # Pool: 12 usable pages. Prompt ~150 tokens -> needs 4 pages/request
    # (prompt 3 + budget slack). Decoy fills the cache so admission must
    # evict; the protected entry must survive and the request must hit.
    eng = _engine(max_slots=1, total_pages=13, prefill_buckets=(64, 256))
    p1 = (np.arange(1, 1 + 150, dtype=np.int32) % 96) + 1
    decoy = (np.arange(50, 50 + 150, dtype=np.int32) % 96) + 1
    eng.generate(p1, max_tokens=4)
    eng.generate(decoy, max_tokens=4)
    # Cache now holds both prompts' chains; a re-run of p1 needs eviction
    # room but must still hit p1's own entry.
    out = eng.generate(p1, max_tokens=4)
    assert eng.prefix_cache_stats["hits"] >= 1, eng.prefix_cache_stats
    cold = _engine().generate(p1, max_tokens=4)
    assert out["tokens"] == cold["tokens"]


@pytest.mark.slow  # heavy battery; tier-1 budget
def test_partial_hit_ttft_beats_cold():
    """Tail prefill over cached pages is measurably cheaper than a cold
    full prefill (the routing payoff for shared system prompts). Programs
    pre-warmed so compile time is excluded."""
    eng = _engine()
    eng.warmup(buckets=(512,))
    sys_prompt = (np.arange(9, 9 + 448, dtype=np.int32) % 96) + 1  # 7 pages
    tails = [np.array([3 + t, 1, 4], np.int32) for t in range(8)]
    # Warm every program variant (full 512 prefill, tail-64 prefill, copy).
    eng.generate(np.concatenate([sys_prompt, tails[6]]), max_tokens=2)
    eng.generate(np.concatenate([sys_prompt, tails[7]]), max_tokens=2)
    colds, warms = [], []
    for t in range(3):
        shifted = ((sys_prompt + 17 * (t + 1)) % 96) + 1  # new sys -> cold
        colds.append(eng.generate(
            np.concatenate([shifted, tails[t]]), max_tokens=2)["ttft_s"])
        warms.append(eng.generate(
            np.concatenate([shifted, tails[t + 3]]), max_tokens=2)["ttft_s"])
    assert eng.prefix_cache_stats["partial_hits"] >= 4
    cold, warm = min(colds), min(warms)
    assert warm < cold, f"partial-hit ttft {warm:.4f}s not below cold {cold:.4f}s"


def test_dense_layout_rejects_prefix_cache():
    with pytest.raises(ValueError):
        LLMEngine(REF_CFG, engine_config=EngineConfig(
            max_slots=2, max_seq=1024, kv_layout="dense", prefix_cache=True), device="cpu")


def test_openai_prefix_router_keys():
    from ray_tpu_torch.llm.openai import openai_prefix_router
    from ray_tpu_torch.serve.proxy import Request
    import json

    def req(body):
        return Request("POST", "/v1/completions", {}, {}, json.dumps(body).encode())

    long_prefix = "shared conversation history " * 20  # > 256 chars
    a = openai_prefix_router(req({"prompt": long_prefix + "question one"}))
    b = openai_prefix_router(req({"prompt": long_prefix + "another question"}))
    c = openai_prefix_router(req({"prompt": "totally different"}))
    assert a and a == b, "same 256-char prefix must share a key"
    assert c != a
    m = openai_prefix_router(req({"messages": [{"role": "user", "content": "hi"}]}))
    assert m and m != a
    assert openai_prefix_router(req({"no": "prompt"})) == ""


def test_tokenized_router_keys_on_first_page():
    """With a tokenizer, the affinity key is the digest of the first
    page_size TOKENS — exactly the engine's first chain-digest boundary —
    so page-cache-compatible requests co-locate and others spread."""
    import json

    from ray_tpu_torch.llm.openai import make_prefix_router
    from ray_tpu_torch.llm.tokenizer import load_tokenizer
    from ray_tpu_torch.serve.proxy import Request

    tok = load_tokenizer(None)
    policy = make_prefix_router(tok, page_size=8)

    def req(prompt):
        return Request("POST", "/v1/completions", {}, {},
                       json.dumps({"prompt": prompt}).encode())

    shared = "a shared system prompt that spans well past eight tokens of text"
    a = policy(req(shared + " question one"))
    b = policy(req(shared + " other question"))
    assert a and a == b, "first-token-page sharers must co-locate"
    # Divergence INSIDE the first page -> different keys.
    c = policy(req("b shared system prompt that spans well past eight tokens"))
    assert c != a


def test_affinity_key_sticks_and_proxy_header_routes():
    import json
    import socket

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    rt.init(num_cpus=8)
    try:
        @serve.deployment(num_replicas=2, max_ongoing_requests=8)
        class Who:
            def __call__(self, request):
                import os
                return {"pid": os.getpid()}

            def pid(self):
                import os
                return os.getpid()

        serve.run(Who.bind(), name="who", route_prefix="/who")
        h = serve.get_deployment_handle("Who", "who")
        # Handle-level affinity: same key -> same replica, across calls.
        pids_a = {h.options(affinity_key="conv-a").pid.remote().result(timeout=60)
                  for _ in range(6)}
        assert len(pids_a) == 1
        # Proxy header affinity: x-affinity-key pins the replica.
        port = serve.http_port()

        def post(key):
            body = b"{}"
            s = socket.create_connection(("127.0.0.1", port), timeout=60)
            s.sendall((f"POST /who HTTP/1.1\r\nhost: x\r\nx-affinity-key: {key}\r\n"
                       f"content-length: {len(body)}\r\nconnection: close\r\n\r\n"
                       ).encode() + body)
            raw = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                raw += chunk
            s.close()
            return json.loads(raw.split(b"\r\n\r\n", 1)[1])["pid"]

        pids = {post("session-1") for _ in range(5)}
        assert len(pids) == 1, f"header affinity bounced replicas: {pids}"
        serve.delete("who")
    finally:
        serve.shutdown()
        rt.shutdown()

