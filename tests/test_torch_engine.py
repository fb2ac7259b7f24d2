"""The port's LLMEngine against ray_tpu's LLMEngine on converted fp32
weights: identical greedy tokens for a mixed batch of prompts through fewer
slots than requests (continuous batching and slot reuse), in both KV
layouts. Then the scheduler cases of tests/test_llm.py on the port alone:
EOS stops, paged admission waits for pages, pages recycle, abort frees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models import TransformerConfig as JaxConfig
from ray_tpu.models.transformer import init_params as jax_init
from ray_tpu_torch.convert import from_numpy_tree
from ray_tpu_torch.llm import EngineConfig, LLMEngine
from ray_tpu_torch.models import TransformerConfig

SMALL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128)
JCFG = JaxConfig(**SMALL, dtype=jnp.float32, attention_impl="reference")
CFG = TransformerConfig(**SMALL, dtype=torch.float32)


@pytest.fixture(scope="module")
def weights():
    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), CFG)


def _drain(eng, prompts, max_tokens):
    for i, p in enumerate(prompts):
        eng.add_request(f"r{i}", p, max_tokens[i])
    out = {}
    while eng.has_work():
        for rid, ev in eng.step().items():
            if ev.get("finished"):
                out[rid] = (ev["tokens"], ev["finish_reason"])
    return out


@pytest.mark.parametrize("layout,slots", [("paged", 3), ("dense", 2), ("paged", 4)])
def test_greedy_tokens_match_jax_engine(weights, layout, slots):
    jp, tp = weights
    rng = np.random.default_rng(slots)
    prompts = [rng.integers(1, 97, n).astype(np.int32) for n in (3, 9, 17, 30, 5, 12)]
    max_tokens = [10 + i for i in range(6)]
    kw = dict(kv_layout=layout, max_slots=slots, max_seq=128, prefill_buckets=(16, 32), decode_block=4)
    if layout == "paged":
        kw["page_size"] = 16
    want = _drain(JaxLLMEngine(JCFG, params=jp, engine_config=JaxEngineConfig(**kw)), prompts, max_tokens)
    got = _drain(LLMEngine(CFG, params=tp, engine_config=EngineConfig(**kw), device="cpu"),
                 prompts, max_tokens)
    assert got == want


def _engine(**kw):
    return LLMEngine(CFG, engine_config=EngineConfig(**kw), device="cpu")


def test_eos_stops_generation():
    eng = _engine(max_slots=2, max_seq=128, prefill_buckets=(16,))
    first = eng.generate(np.array([5, 6, 7], np.int32), max_tokens=40)["tokens"]
    eos = first[2]  # a token the model emits: generation must stop right at it
    eng = _engine(max_slots=2, max_seq=128, prefill_buckets=(16,), eos_id=eos)
    out = eng.generate(np.array([5, 6, 7], np.int32), max_tokens=40)
    assert out["tokens"] == first[: first.index(eos) + 1]


def test_paged_pool_memory_independent_of_slots():
    """Slot count is a scheduling knob, not a memory multiplier: 32 slots
    over a 16-page pool hold 17 pages of KV, not 32 x max_seq."""
    eng = _engine(max_slots=32, max_seq=128, kv_layout="paged", page_size=16, total_pages=17,
                  prefill_buckets=(16,), decode_block=2)
    assert eng.k_pages.shape[2] == 17 * 16
    assert len(eng.generate([1, 2, 3], max_tokens=4)["tokens"]) == 4


def test_paged_admission_waits_for_pages_then_proceeds():
    """Pool smaller than the aggregate demand: admission queues on the page
    budget (not slot count) and every request still completes."""
    eng = _engine(max_slots=8, max_seq=128, kv_layout="paged", page_size=16, total_pages=9,
                  prefill_buckets=(16,), decode_block=2)
    # prompt 3 + max_tokens 20 + block 2 = 25 -> 2 pages; 8 usable pages.
    for r in range(8):
        eng.add_request(f"q{r}", [1, 2, 3], 20)
    results = {}
    concurrent_seen = 0
    while eng.has_work():
        concurrent_seen = max(concurrent_seen, sum(1 for s in eng.slots if s is not None))
        for rid, ev in eng.step().items():
            if ev.get("finished"):
                results[rid] = ev["tokens"]
    assert len(results) == 8
    assert concurrent_seen <= 4  # 8 usable pages / 2 pages each
    assert all(results[f"q{r}"] == results["q0"] for r in range(8))


def test_paged_pages_recycled_after_finish():
    eng = _engine(max_slots=2, max_seq=128, kv_layout="paged", page_size=16, total_pages=9,
                  prefill_buckets=(16,), decode_block=2)
    free0 = len(eng.free_pages)
    for _ in range(3):
        eng.generate([4, 5, 6], max_tokens=6)
    assert len(eng.free_pages) == free0


def test_paged_abort_frees_pages():
    eng = _engine(max_slots=2, max_seq=128, kv_layout="paged", page_size=16, total_pages=9,
                  prefill_buckets=(16,), decode_block=2)
    free0 = len(eng.free_pages)
    eng.add_request("gone", [1, 2, 3], 100)
    eng.step()  # admitted: pages reserved, decoding
    assert len(eng.free_pages) < free0
    eng.abort("gone")
    assert len(eng.free_pages) == free0
    assert not eng.has_work()
    assert len(eng.generate([1, 2, 3], max_tokens=4)["tokens"]) == 4


def test_dense_and_paged_layouts_agree_and_warmup_leaves_no_trace():
    """The layout is a memory knob, not a numerics change, and warmup's
    dummy runs (dead page, slot 0) leave nothing behind."""
    prompt = [7, 3, 11, 2, 9]
    outs = []
    for kw, warm in ((dict(kv_layout="dense"), False), (dict(kv_layout="dense"), True),
                     (dict(kv_layout="paged", page_size=16), True)):
        eng = _engine(max_slots=2, max_seq=128, prefill_buckets=(16,), decode_block=4, **kw)
        if warm:
            eng.warmup()
        outs.append(eng.generate(prompt, max_tokens=10)["tokens"])
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("option", [dict(prefix_cache=True), dict(chunked_prefill=16),
                                    dict(tensor_parallel=2)])
def test_later_slice_options_raise(option):
    with pytest.raises(NotImplementedError, match="later slice|next serving slice"):
        _engine(kv_layout="paged", page_size=16, max_seq=128, **option)
