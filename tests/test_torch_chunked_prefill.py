"""The port's chunked prefill against ray_tpu's, step by step, through the
runner of tests/test_torch_prefix_cache.py (same tiny MHA and GQA models,
same weights, same comparison after every step). The scripts mirror the
chunked-prefill cases of tests/test_scale_plane.py (282-397): a long prompt
chunking while another request decodes, chunking on top of a prefix-cache
partial hit, an abort mid-prefill, and two long prompts chunking at once.
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import EngineConfig, LLMEngine
from ray_tpu_torch.models import TransformerConfig
from test_torch_prefix_cache import MODELS, SYS, _toks, assert_same_run, models, port_engine  # noqa: F401

# Prompts of at most 3 chunks keep the tail prefill at context buckets 1
# and 2: few shapes, so few JAX programs to compile.
LONG, SHORT = _toks(20, 96), _toks(21, 16)

SCRIPTS = {
    # test_scale_plane.py:312: the short request decodes while the long one
    # prefills in 3 chunks of 32, one per step.
    "interleave_with_decode": [("add", "short", SHORT, 24), ("step",), ("add", "long", LONG, 8), ("drain",)],
    # :375: a cached system prompt plus a 64-token tail; the tail chunks,
    # starting at the cached prefix.
    "prefix_partial_hit_chunks_its_tail": [
        ("add", "seed", np.concatenate([SYS, [5]]), 2), ("drain",),
        ("add", "q", np.concatenate([SYS, _toks(22, 64)]), 6), ("drain",)],
    # :362: an abort mid-prefill frees the pages; the engine then serves on.
    "abort_mid_prefill": [("add", "a", LONG, 4), ("step",), ("abort", "a"),
                          ("add", "b", SHORT, 4), ("drain",)],
    # Two long prompts and a short one admitted in one step.
    "two_long_prompts_at_once": [("add", "l1", _toks(23, 70), 6), ("add", "l2", _toks(24, 90), 6),
                                 ("add", "s", SHORT, 10), ("drain",)],
}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_chunked_prefill_matches_jax_engine(models, name, model):  # noqa: F811
    cache = name == "prefix_partial_hit_chunks_its_tail"
    record = assert_same_run(models, model, SCRIPTS[name], chunked_prefill=32, prefix_cache=cache)
    if cache:
        assert record[-1]["stats"]["partial_hits"] == 1


def test_chunked_prefill_interleaves_and_matches_unchunked(models):  # noqa: F811
    """Steps that begin with the long prompt mid-prefill still emit the
    short request's tokens, and chunking leaves the greedy output as the
    unchunked engine's."""
    want = port_engine(models, "gqa").generate(LONG, max_tokens=8)["tokens"]
    eng = port_engine(models, "gqa", chunked_prefill=32)
    eng.add_request("short", SHORT, 24)
    eng.step()
    eng.add_request("long", LONG, 8)
    mid_steps = decode_during_prefill = 0
    got = None
    while eng.has_work():
        mid = bool(eng._prefilling)
        ev = eng.step()
        if mid:
            mid_steps += 1
            decode_during_prefill += bool(ev.get("short", {}).get("new_tokens"))
        if ev.get("long", {}).get("finished"):
            got = ev["long"]["tokens"]
    assert mid_steps >= 2 and decode_during_prefill >= 2
    assert got == want


def test_chunked_prefill_must_be_a_page_multiple():
    cfg = TransformerConfig(**MODELS["mha"], dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of page_size"):
        LLMEngine(cfg, device="cpu", engine_config=EngineConfig(
            max_slots=2, max_seq=256, kv_layout="paged", page_size=32, chunked_prefill=48))


# ---------------------------------------------------------------------------
# The 4 chunked-prefill cases of tests/test_scale_plane.py on the port's
# engine alone (device="cpu").
# ---------------------------------------------------------------------------

def _tiny_cfg():
    return TransformerConfig(
        vocab_size=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
        d_ff=64, max_seq_len=256, attention_impl="reference",
    )


def _mk_engine(chunked: int, seed: int = 7, slots: int = 4):
    return LLMEngine(_tiny_cfg(), engine_config=EngineConfig(
        max_slots=slots, max_seq=256, prefill_buckets=(32, 64, 128, 256),
        kv_layout="paged", page_size=32, decode_block=4, seed=seed,
        chunked_prefill=chunked,
    ), device="cpu")


def test_chunked_prefill_requires_paged_and_page_multiple():
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(_tiny_cfg(), engine_config=EngineConfig(
            max_slots=2, chunked_prefill=64), device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        LLMEngine(_tiny_cfg(), engine_config=EngineConfig(
            max_slots=2, kv_layout="paged", page_size=32, chunked_prefill=48), device="cpu")


def test_chunked_prefill_interleaves_with_decode_and_matches_unchunked():
    """The interleave contract: a long prompt's prefill spans MULTIPLE
    steps (one chunk per step) while an already-decoding slot keeps
    emitting tokens in those same steps; greedy output is identical to the
    unchunked engine's."""
    rng = np.random.default_rng(0)
    long_prompt = rng.integers(0, 128, 160).tolist()  # 5 chunks of 32
    short_prompt = rng.integers(0, 128, 16).tolist()

    ref = _mk_engine(chunked=0)
    ref.add_request("long", long_prompt, max_tokens=8)
    ref_tokens = None
    while ref.has_work():
        ev = ref.step().get("long")
        if ev and ev.get("finished"):
            ref_tokens = ev["tokens"]
    assert ref_tokens is not None

    eng = _mk_engine(chunked=32)
    eng.add_request("short", short_prompt, max_tokens=24)
    # Let the short request prefill + start decoding alone.
    first = eng.step()
    assert "short" in first and first["short"]["ttft_s"] is not None
    eng.add_request("long", long_prompt, max_tokens=8)
    decode_steps_during_prefill = 0
    prefill_steps = 0
    long_first_step = None
    tokens_long = None
    steps = 0
    while eng.has_work() and steps < 200:
        steps += 1
        mid_prefill = bool(eng._prefilling)
        ev = eng.step()
        if mid_prefill:
            prefill_steps += 1
            if "short" in ev and ev["short"].get("new_tokens"):
                decode_steps_during_prefill += 1
        if "long" in ev and long_first_step is None:
            long_first_step = steps
        if ev.get("long", {}).get("finished"):
            tokens_long = ev["long"]["tokens"]
    # 160 tokens / 32-token chunks = 5 chunks; the admission step runs
    # chunk 1, so >= 4 later steps start with the slot still mid-prefill.
    assert prefill_steps >= 4
    # Decode really interleaved: the short request made progress in steps
    # where the long prompt was still mid-prefill.
    assert decode_steps_during_prefill >= 2
    assert tokens_long == ref_tokens  # greedy: chunking must not change output


def test_chunked_prefill_abort_mid_prefill_frees_pages():
    eng = _mk_engine(chunked=32)
    total_free = len(eng.free_pages)
    prompt = list(range(100)) + list(range(60))
    eng.add_request("a", prompt, max_tokens=4)
    eng.step()  # admits + first chunk only
    assert eng._prefilling, "long prompt should be mid chunked-prefill"
    eng.abort("a")
    assert not eng._prefilling
    assert len(eng.free_pages) == total_free
    assert not eng.has_work()


def test_chunked_prefill_with_prefix_cache_partial_hit():
    """A cached system prompt + long tail: the tail itself chunks (progress
    starts at the cached prefix), and the answer matches the cold run."""
    def mk(chunked):
        return LLMEngine(_tiny_cfg(), engine_config=EngineConfig(
            max_slots=4, max_seq=256, prefill_buckets=(32, 64, 128, 256),
            kv_layout="paged", page_size=32, decode_block=4, seed=3,
            chunked_prefill=chunked, prefix_cache=True,
        ), device="cpu")

    rng = np.random.default_rng(1)
    sys_prompt = rng.integers(0, 128, 64).tolist()
    tail = rng.integers(0, 128, 96).tolist()
    cold = mk(0)
    cold.generate(sys_prompt + [5], max_tokens=2)   # seed the prefix cache
    want = cold.generate(sys_prompt + tail, max_tokens=6)["tokens"]
    eng = mk(32)
    eng.generate(sys_prompt + [5], max_tokens=2)    # seed the prefix cache
    got = eng.generate(sys_prompt + tail, max_tokens=6)
    assert eng.prefix_partial_hits >= 1
    assert got["tokens"] == want

