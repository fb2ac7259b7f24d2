"""The port's text layer against ray_tpu's: the byte-level BPE tokenizer,
per-request sampling in the engine, chat templates and stop strings.

The tokenizer, engine-sampling, chat-template and stop-string cases of
tests/test_llm_text.py run on the port (engines on the CPU, fp32); where
both packages compute the same thing from the same input (merges learned
from one corpus, encodings, stop-string truncation), the port is held equal
to ray_tpu.
"""
import sys

import numpy as np
import pytest
import torch

from ray_tpu.llm.openai import _StopTruncator as JaxStopTruncator
from ray_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams, Tokenizer
from ray_tpu_torch.llm import openai as oai
from ray_tpu_torch.llm.openai import OpenAIServer, _StopTruncator
from ray_tpu_torch.llm.tokenizer import load_tokenizer
from ray_tpu_torch.models import TransformerConfig

CFG = TransformerConfig(
    vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq_len=128, dtype=torch.float32, attention_impl="reference",
)

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the quick brown fox is quick and the dog is lazy",
    "distributed systems schedule tasks over the cluster",
    "the scheduler places the tasks on the nodes of the cluster",
] * 4


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def test_tokenizer_roundtrip_any_unicode():
    tok = Tokenizer()  # merge-less: pure byte fallback
    for s in ("hello world", "héllo wörld", "日本語のテスト", "mixed 英語 & emoji 🎉", ""):
        assert tok.decode(tok.encode(s)) == s
        assert tok.encode(s) == JaxTokenizer().encode(s)


def test_tokenizer_train_compresses_and_roundtrips(tmp_path):
    tok = Tokenizer.train(CORPUS, vocab_size=3 + 256 + 64)
    assert len(tok.merges) > 0
    s = "the quick brown fox jumps over the lazy dog"
    ids = tok.encode(s)
    assert tok.decode(ids) == s
    # Learned merges beat byte fallback on in-domain text.
    assert len(ids) < len(Tokenizer().encode(s))
    # Round-trips out-of-domain text too (byte fallback).
    assert tok.decode(tok.encode("zebra xylophone 🦓")) == "zebra xylophone 🦓"
    # Persistence.
    p = str(tmp_path / "tok.json")
    tok.save(p)
    tok2 = Tokenizer.load(p)
    assert tok2.encode(s) == ids
    assert tok2.vocab_size == tok.vocab_size


def test_tokenizer_matches_ray_tpu(tmp_path):
    """One corpus, both packages: the same merges in the same order, the
    same ids for in- and out-of-domain text, and each reads the other's
    file."""
    mine = Tokenizer.train(CORPUS, vocab_size=3 + 256 + 64)
    ref = JaxTokenizer.train(CORPUS, vocab_size=3 + 256 + 64)
    assert mine.merges == ref.merges
    for s in ("the quick brown fox jumps over the lazy dog", "zebra xylophone 🦓", " a  b\n"):
        assert mine.encode(s, add_bos=True, add_eos=True) == ref.encode(s, add_bos=True, add_eos=True)
        assert mine.decode(mine.encode(s)) == ref.decode(ref.encode(s))
    p_ref, p_mine = str(tmp_path / "ref.json"), str(tmp_path / "mine.json")
    ref.save(p_ref)
    mine.save(p_mine)
    assert load_tokenizer(p_ref).merges == mine.merges
    assert JaxTokenizer.load(p_mine).merges == ref.merges
    # Ids past the vocabulary render as nothing in both (a model whose
    # vocabulary is larger than the tokenizer's can sample them).
    ids = mine.encode("dog") + [mine.vocab_size, mine.vocab_size + 1000]
    assert mine.decode(ids) == ref.decode(ids) == "dog"


def test_tokenizer_specials():
    tok = Tokenizer()
    ids = tok.encode("hi", add_bos=True, add_eos=True)
    assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    assert tok.decode(ids) == "hi"  # specials render as nothing


def test_tokenizer_deep_merge_chain_decodes():
    """A degenerate corpus can learn a merge chain nested deeper than
    Python's recursion limit; decode must expand iteratively."""
    base = 3 + ord("a")  # byte token for 'a'
    depth = sys.getrecursionlimit() + 500
    merges = [(base, base)] + [(3 + 256 + i, base) for i in range(depth - 1)]
    tok = Tokenizer(merges)
    deepest = 3 + 256 + len(merges) - 1
    assert tok.decode([deepest]) == "a" * (depth + 1)


# ---------------------------------------------------------------------------
# per-request sampling in the port's engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    return LLMEngine(CFG, engine_config=EngineConfig(
        max_slots=4, max_seq=128, prefill_buckets=(16, 32)), device="cpu")


def _drain(engine):
    results = {}
    while engine.has_work():
        for rid, ev in engine.step().items():
            if ev.get("finished"):
                results[rid] = ev["tokens"]
    return results


def test_mixed_batch_greedy_rows_stay_deterministic(engine):
    """One batch holding a greedy row and a hot sampled row: the greedy
    row's output must equal its solo run (per-row params, no bleed)."""
    prompt = np.array([5, 17, 42, 7, 23], np.int32)
    solo = engine.generate(prompt, max_tokens=10)["tokens"]
    engine.add_request("greedy", prompt, sampling=SamplingParams(temperature=0.0, max_tokens=10))
    engine.add_request("hot", prompt, sampling=SamplingParams(temperature=1.5, max_tokens=10))
    results = _drain(engine)
    assert results["greedy"] == solo
    assert len(results["hot"]) == 10


def test_topk1_equals_greedy(engine):
    """top_k=1 at any temperature collapses to argmax."""
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    solo = engine.generate(prompt, max_tokens=8)["tokens"]
    engine.add_request("k1", prompt, sampling=SamplingParams(temperature=2.0, top_k=1, max_tokens=8))
    assert _drain(engine)["k1"] == solo


def test_temperature_actually_randomizes(engine):
    """Two hot rows with the same prompt in one batch should (overwhelmingly)
    diverge — the per-request temperature is really applied."""
    prompt = np.array([9, 9, 9, 9], np.int32)
    sp = SamplingParams(temperature=3.0, max_tokens=16)
    engine.add_request("h1", prompt, sampling=sp)
    engine.add_request("h2", prompt, sampling=sp)
    results = _drain(engine)
    assert results["h1"] != results["h2"]


def test_stop_token_ids(engine):
    """A per-request stop token retires the request the moment it appears."""
    prompt = np.array([5, 17, 42, 7, 23], np.int32)
    solo = engine.generate(prompt, max_tokens=10)["tokens"]
    stop_tok = solo[3]
    engine.add_request("s", prompt, sampling=SamplingParams(
        max_tokens=10, stop_token_ids=(int(stop_tok),)))
    got = _drain(engine)["s"]
    assert got == solo[:solo.index(stop_tok) + 1]  # stops AT the stop token (inclusive emission)


def test_finish_reason_length_at_context_cap(engine):
    """A request force-retired at the max_seq context ceiling reports
    finish_reason 'length' even though fewer than max_tokens were
    generated."""
    prompt = [3 + (i % 200) for i in range(120)]  # 120 of 128 context
    engine.add_request("ctxcap", prompt, sampling=SamplingParams(max_tokens=64))
    reasons = {}
    while engine.has_work():
        for rid, ev in engine.step().items():
            if ev.get("finished"):
                reasons[rid] = (ev.get("finish_reason"), len(ev["tokens"]))
    reason, n = reasons["ctxcap"]
    assert n < 64, "context cap should have cut generation short"
    assert reason == "length", reasons


def test_top_p_restricts_support(engine):
    """top_p≈0 keeps only the most probable token -> equals greedy."""
    prompt = np.array([2, 7, 1, 8], np.int32)
    solo = engine.generate(prompt, max_tokens=8)["tokens"]
    engine.add_request("p", prompt, sampling=SamplingParams(
        temperature=1.0, top_p=1e-6, max_tokens=8))
    assert _drain(engine)["p"] == solo


# ---------------------------------------------------------------------------
# chat templates
# ---------------------------------------------------------------------------

TINY_MODEL = dict(
    vocab_size=512, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
    d_ff=64, max_seq_len=64, attention_impl="reference", dtype=torch.float32,
)
TINY_ENGINE = {"max_slots": 2, "max_seq": 64, "prefill_buckets": (16,)}

CHATML = (
    "{% for message in messages %}"
    "<|im_start|>{{ message.role }}\n{{ message.content }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)

CONVERSATION = [
    {"role": "system", "content": "You are a helpful assistant."},
    {"role": "user", "content": "What is a TPU?"},
    {"role": "assistant", "content": "A matrix-multiply accelerator."},
    {"role": "user", "content": "Thanks!"},
]


def test_chat_template_jinja_golden():
    """A jinja chat template renders a multi-turn conversation into the
    exact prompt format the checkpoint expects (golden: ChatML)."""
    srv = OpenAIServer(TINY_MODEL, TINY_ENGINE, chat_template=CHATML, device="cpu")
    got, templated = srv._chat_prompt(CONVERSATION)
    assert templated  # rendered prompts must not get a second BOS
    assert got == (
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        "<|im_start|>user\nWhat is a TPU?<|im_end|>\n"
        "<|im_start|>assistant\nA matrix-multiply accelerator.<|im_end|>\n"
        "<|im_start|>user\nThanks!<|im_end|>\n"
        "<|im_start|>assistant\n"
    )
    # A template error surfaces as a ValueError (a 400 at the route).
    bad = OpenAIServer(TINY_MODEL, TINY_ENGINE, chat_template="{{ nope.role }}", device="cpu")
    with pytest.raises(ValueError, match="chat template error"):
        bad._chat_prompt(CONVERSATION)
    assert bad({"messages": CONVERSATION}).status == 400
    srv.__raytpu_exit__()
    bad.__raytpu_exit__()


def test_chat_template_tokenizer_precedence(monkeypatch):
    """No explicit template + a tokenizer that ships one (HF checkpoints
    do) -> the checkpoint's own template is used; an explicit template
    still wins; without either, the legacy role:content fallback."""

    class TokWithTemplate:
        eos_id, bos_id, vocab_size = 2, 1, 512
        chat_template = "non-none"

        def encode(self, text, add_bos=False, add_eos=False):
            return [1, 3, 4]

        def decode(self, ids):
            return "x"

        def apply_chat_template(self, messages, add_generation_prompt=True):
            return "|".join(m["role"] for m in messages) + (
                "|gen" if add_generation_prompt else "")

    monkeypatch.setattr(oai, "load_tokenizer", lambda spec: TokWithTemplate())
    srv = oai.OpenAIServer(TINY_MODEL, TINY_ENGINE, device="cpu")
    assert srv._chat_prompt(CONVERSATION) == ("system|user|assistant|user|gen", True)
    srv.__raytpu_exit__()
    # Explicit jinja template beats the tokenizer's.
    srv2 = oai.OpenAIServer(TINY_MODEL, TINY_ENGINE, chat_template=CHATML, device="cpu")
    assert srv2._chat_prompt([{"role": "user", "content": "q"}])[0].startswith(
        "<|im_start|>user")
    srv2.__raytpu_exit__()


def test_chat_template_legacy_fallback():
    srv = OpenAIServer(TINY_MODEL, TINY_ENGINE, device="cpu")  # byte tokenizer: no template
    got, templated = srv._chat_prompt([{"role": "user", "content": "hi"}])
    assert got == "user: hi\nassistant:" and not templated
    srv.__raytpu_exit__()


# ---------------------------------------------------------------------------
# stop strings
# ---------------------------------------------------------------------------

def test_stop_strings_truncate():
    """Stop strings are applied at the text layer, spanning decode blocks."""
    tok = Tokenizer()
    full = "abcSTOPdef"
    ids = tok.encode(full)
    tr = _StopTruncator(tok, ("STOP",))
    out = ""
    for tid in ids:  # worst case: one token per feed
        out += tr.feed([tid])
    out += tr.flush()
    assert out == "abc"
    assert tr.stopped

    # No stop present: everything (including held-back prefixes) flushes.
    tr2 = _StopTruncator(tok, ("XYZ",))
    out2 = "".join(tr2.feed([t]) for t in tok.encode("plain text X here"))
    out2 += tr2.flush()
    assert out2 == "plain text X here"
    assert not tr2.stopped


@pytest.mark.parametrize("text,stops,block", [
    ("abcSTOPdef", ("STOP",), 1), ("abcSTOPdef", ("STOP",), 3), ("plain text X here", ("XYZ", "X h"), 2),
    ("héllo wörld 🎉 end", ("end",), 1), ("héllo wörld 🎉 end", ("ö",), 2), ("no stops at all", (), 4),
])
def test_stop_truncator_matches_ray_tpu(text, stops, block):
    """The same token stream fed in the same blocks gives the same deltas,
    flush and stop flag in both packages (multi-byte characters split
    across tokens are held back alike)."""
    ids = Tokenizer().encode(text)
    mine, ref = _StopTruncator(Tokenizer(), stops), JaxStopTruncator(JaxTokenizer(), stops)
    for i in range(0, len(ids), block):
        assert mine.feed(ids[i:i + block]) == ref.feed(ids[i:i + block])
    assert mine.flush() == ref.flush()
    assert mine.stopped == ref.stopped
