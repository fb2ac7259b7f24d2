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
