"""The port's LLMEngine against ray_tpu's LLMEngine on converted fp32
weights: identical greedy tokens for a mixed batch of prompts through fewer
slots than requests (continuous batching and slot reuse), in both KV
layouts, at head dim 16, 128 and 256. Then the scheduler cases of
tests/test_llm.py on the port alone: EOS stops, paged admission waits for
pages, pages recycle, abort frees; and what both engines refuse when they
are built (an MoE model; on the card, a head dim the flash kernels are not
built for).
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
from ray_tpu_torch.models import TransformerConfig, make_train_step
from ray_tpu_torch.ops.attention import HEAD_DIMS, check_head_dim

SMALL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128)
# head_dim 128 and 256 (the flash kernels' second and third instances on
# the card), MQA.
SMALL_D128 = dict(SMALL, d_model=256, n_heads=2, n_kv_heads=1)
SMALL_D256 = dict(SMALL, d_model=512, n_heads=2, n_kv_heads=1)
CFG = TransformerConfig(**SMALL, dtype=torch.float32)
MODELS = {"small": SMALL, "d128": SMALL_D128, "d256": SMALL_D256}


@pytest.fixture(scope="module")
def weights():
    """Converted weights per model, drawn once per module."""
    cache = {}

    def get(model):
        if model not in cache:
            jcfg = JaxConfig(**MODELS[model], dtype=jnp.float32, attention_impl="reference")
            tcfg = TransformerConfig(**MODELS[model], dtype=torch.float32)
            jp = jax_init(jax.random.PRNGKey(0), jcfg)
            cache[model] = jcfg, tcfg, jp, from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        return cache[model]

    return get


def _drain(eng, prompts, max_tokens):
    for i, p in enumerate(prompts):
        eng.add_request(f"r{i}", p, max_tokens[i])
    out = {}
    while eng.has_work():
        for rid, ev in eng.step().items():
            if ev.get("finished"):
                out[rid] = (ev["tokens"], ev["finish_reason"])
    return out


@pytest.mark.parametrize("layout,slots,model", [
    pytest.param("paged", 3, "small", id="paged-3"), pytest.param("dense", 2, "small", id="dense-2"),
    pytest.param("paged", 4, "small", id="paged-4"), pytest.param("paged", 3, "d128", id="paged-3-d128"),
    pytest.param("dense", 2, "d128", id="dense-2-d128"), pytest.param("paged", 3, "d256", id="paged-3-d256"),
    pytest.param("dense", 2, "d256", id="dense-2-d256")])
def test_greedy_tokens_match_jax_engine(weights, layout, slots, model):
    jcfg, tcfg, jp, tp = weights(model)
    rng = np.random.default_rng(slots)
    prompts = [rng.integers(1, 97, n).astype(np.int32) for n in (3, 9, 17, 30, 5, 12)]
    max_tokens = [10 + i for i in range(6)]
    kw = dict(kv_layout=layout, max_slots=slots, max_seq=128, prefill_buckets=(16, 32), decode_block=4)
    if layout == "paged":
        kw["page_size"] = 16
    want = _drain(JaxLLMEngine(jcfg, params=jp, engine_config=JaxEngineConfig(**kw)), prompts, max_tokens)
    got = _drain(LLMEngine(tcfg, params=tp, engine_config=EngineConfig(**kw), device="cpu"),
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


@pytest.mark.parametrize("option", [dict(kv_layout="dense", prefix_cache=True),
                                    dict(kv_layout="dense", chunked_prefill=16),
                                    dict(kv_layout="paged", page_size=16, tensor_parallel=2)])
def test_later_slice_options_raise(option, monkeypatch):
    """The prefix cache and chunked prefill are ported but need the paged
    layout (ValueError, as in ray_tpu). Tensor-parallel serving is ported:
    the tensor_parallel=2 case builds over two CPU slots and serves the
    greedy tokens of the one-slot engine."""
    if "tensor_parallel" in option:
        import dataclasses

        monkeypatch.setenv("RAY_TPU_TORCH_DEVICE_SLOTS", "2")
        cfg = dataclasses.replace(CFG, vocab_size=96)  # the vocabulary splits over the two slots
        prompt = np.array([5, 6, 7, 9], np.int32)

        def build(**kw):
            return LLMEngine(cfg, engine_config=EngineConfig(max_seq=128, prefill_buckets=(16,), **kw),
                             device="cpu")

        tp = build(**option)
        assert tp.params["layers"]["wq"].addressable_shards[0].data.shape[2] == cfg.n_heads // 2
        one = build(**dict(option, tensor_parallel=1))
        assert tp.generate(prompt, max_tokens=8)["tokens"] == one.generate(prompt, max_tokens=8)["tokens"]
        return
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        _engine(max_seq=128, **option)


def test_moe_model_is_refused_by_both_engines():
    """Serving an MoE model is not supported in either package: both engines
    raise the same ValueError when they are built, before any step."""
    kw = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq_len=256,
              n_experts=4)
    ek = dict(kv_layout="paged", page_size=32)
    with pytest.raises(ValueError, match="MoE serving not supported") as want:
        JaxLLMEngine(JaxConfig(**kw), engine_config=JaxEngineConfig(**ek))
    with pytest.raises(ValueError, match="MoE serving not supported") as got:
        LLMEngine(TransformerConfig(**kw), engine_config=EngineConfig(**ek), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
def test_flash_head_dim_is_checked_when_built(head_dim):
    """On a CUDA device the engine and the train state refuse a head dim the
    flash kernels are not built for, when they are built (the check runs
    before anything is allocated, so a device object is enough here); the
    CPU takes every head dim through the plain versions."""
    cuda = torch.device("cuda")
    check_head_dim(head_dim, torch.device("cpu"))
    if head_dim in HEAD_DIMS:
        check_head_dim(head_dim, cuda)
        return
    with pytest.raises(ValueError, match=f"head_dim {head_dim} .*supported: 64, 128, 256"):
        check_head_dim(head_dim, cuda)
    cfg = TransformerConfig(**dict(SMALL, d_model=4 * head_dim), dtype=torch.float32)
    with pytest.raises(ValueError, match=f"head_dim {head_dim}"):
        LLMEngine(cfg, engine_config=EngineConfig(kv_layout="paged", page_size=16), device=cuda)
    init_state, _ = make_train_step(cfg)
    with pytest.raises(ValueError, match=f"head_dim {head_dim}"):
        init_state(torch.Generator().manual_seed(0), device=cuda)


# ---------------------------------------------------------------------------
# The engine cases of tests/test_llm.py on the port's engine (device="cpu";
# its CFG with torch's fp32). Their eos case is test_eos_stops_generation
# above, in a stronger form.
# ---------------------------------------------------------------------------

LLM_CFG = TransformerConfig(**SMALL, dtype=torch.float32, attention_impl="reference")


def _naive_greedy(params, prompt, n):
    from ray_tpu_torch.models.transformer import forward

    toks = list(map(int, prompt))
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits, _ = forward(params, torch.tensor([toks], dtype=torch.long), LLM_CFG)
            nxt = int(torch.argmax(logits[0, -1]))
            toks.append(nxt)
            out.append(nxt)
    return out


@pytest.fixture(scope="module")
def engine():
    return LLMEngine(LLM_CFG, engine_config=EngineConfig(max_slots=4, max_seq=128, prefill_buckets=(16, 32, 64)),
                     device="cpu")


@pytest.mark.slow  # heavy battery; tier-1 budget
def test_cached_decode_matches_full_forward(engine):
    """Queue 3 entry 7's pin: ``forward`` returns ``(logits, aux)``."""
    prompt = np.array([5, 17, 42, 7, 23], np.int32)
    want = _naive_greedy(engine.params, prompt, 12)
    got = engine.generate(prompt, max_tokens=12)
    assert got["tokens"] == want
    assert got["ttft_s"] is not None and got["ttft_s"] > 0


def test_continuous_batching_matches_solo(engine):
    """A request joining mid-decode must not perturb an in-flight one, and
    both must equal their solo outputs (slot isolation)."""
    p1 = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
    p2 = np.array([2, 7, 1, 8], np.int32)
    solo1 = engine.generate(p1, max_tokens=10)["tokens"]
    solo2 = engine.generate(p2, max_tokens=10)["tokens"]

    engine.add_request("a", p1, 10)
    results = {}
    for _ in range(3):  # a starts decoding alone
        for rid, ev in engine.step().items():
            if ev.get("finished"):
                results[rid] = ev["tokens"]
    engine.add_request("b", p2, 10)  # b joins mid-flight
    while engine.has_work():
        for rid, ev in engine.step().items():
            if ev.get("finished"):
                results[rid] = ev["tokens"]
    assert results["a"] == solo1
    assert results["b"] == solo2


def test_slot_reuse_after_finish(engine):
    """More requests than slots: queueing + slot recycling must preserve
    per-request outputs."""
    prompts = [np.arange(3 + i, dtype=np.int32) % 97 for i in range(9)]
    solos = [engine.generate(p, max_tokens=6)["tokens"] for p in prompts]
    for i, p in enumerate(prompts):
        engine.add_request(f"r{i}", p, 6)
    results = {}
    while engine.has_work():
        for rid, ev in engine.step().items():
            if ev.get("finished"):
                results[rid] = ev["tokens"]
    for i in range(9):
        assert results[f"r{i}"] == solos[i], i


def test_paged_decode_matches_across_pool_layouts():
    """Same request, different page pools (dense parity vs tight pool with
    non-trivial page scatter): identical greedy tokens."""
    prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1]
    outs = []
    for total_pages in (0, 12):
        ec = EngineConfig(max_slots=3, max_seq=128, kv_layout="paged", page_size=16,
                          prefill_buckets=(16,), total_pages=total_pages,
                          decode_block=4)
        eng = LLMEngine(LLM_CFG, engine_config=ec, device="cpu")
        # Fragment the free list so page tables are non-contiguous.
        eng.generate([1, 2], max_tokens=3)
        eng.generate([3, 4, 5], max_tokens=5)
        outs.append(eng.generate(prompt, max_tokens=12)["tokens"])
    assert outs[0] == outs[1]

