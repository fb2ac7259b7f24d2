"""Byte-level BPE tokenizer: trainable, serializable, dependency-free.

Counterpart of ``ray_tpu/llm/tokenizer.py``, stdlib only (importing it
brings in no torch), so text serving works with no network: the base
vocabulary is the 256 byte values and merges are learned on top, so any
unicode string round-trips losslessly. ``load_tokenizer`` also accepts a
pretrained HF tokenizer that is already on disk.

Id layout: 0=<pad> 1=<bos> 2=<eos>, bytes at 3..258, merged tokens from 259
upward. Specials are never produced by encode() on raw text and are skipped
by decode(), as are ids past the vocabulary (a model whose vocabulary is
larger than the tokenizer's may sample them), so the ids are stable
regardless of how many merges were learned.
"""
from __future__ import annotations

import json
import re
from collections import Counter
from typing import Iterable, Optional

PAD, BOS, EOS = 0, 1, 2
_N_SPECIAL = 3
_SPECIAL_NAMES = {PAD: "<pad>", BOS: "<bos>", EOS: "<eos>"}
# Words keep their leading space (GPT-2 convention): merges learn " the",
# and no merge crosses a word boundary — keeps training tractable and
# tokenizations stable under concatenation.
_WORD_RE = re.compile(r"\s*\S+|\s+$")


class Tokenizer:
    """Trainable byte-level BPE. encode/decode/save/load + specials."""

    def __init__(self, merges: Optional[list] = None):
        # merges: list of (left_id, right_id) in learned order; merge i
        # produces id _N_SPECIAL + 256 + i.
        self.merges: list[tuple[int, int]] = [tuple(m) for m in (merges or [])]
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        self._byte_cache: dict[int, bytes] = {}  # merged id -> rendered bytes

    # -- vocabulary --------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return _N_SPECIAL + 256 + len(self.merges)

    @property
    def eos_id(self) -> int:
        return EOS

    @property
    def bos_id(self) -> int:
        return BOS

    @property
    def pad_id(self) -> int:
        return PAD

    # -- train -------------------------------------------------------------
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 1024) -> "Tokenizer":
        """Learn BPE merges from a corpus until vocab_size ids exist.
        Standard algorithm: count adjacent-pair frequencies over the word
        multiset, merge the most frequent pair, repeat."""
        if vocab_size < _N_SPECIAL + 256:
            raise ValueError(f"vocab_size must be >= {_N_SPECIAL + 256}")
        words = Counter()
        for t in texts:
            for w in _WORD_RE.findall(t):
                words[tuple(b + _N_SPECIAL for b in w.encode("utf-8"))] += 1
        merges: list[tuple[int, int]] = []
        next_id = _N_SPECIAL + 256
        while next_id < vocab_size:
            pairs: Counter = Counter()
            for w, c in words.items():
                for a, b in zip(w, w[1:]):
                    pairs[(a, b)] += c
            if not pairs:
                break
            best, count = pairs.most_common(1)[0]
            if count < 2:
                break  # nothing left worth merging
            merges.append(best)
            new_words = Counter()
            for w, c in words.items():
                out, i = [], 0
                while i < len(w):
                    if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                        out.append(next_id)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                new_words[tuple(out)] += c
            words = new_words
            next_id += 1
        return cls(merges)

    # -- encode/decode -------------------------------------------------------
    def _bpe(self, ids: list[int]) -> list[int]:
        """Apply merges greedily by rank (lowest learned rank first)."""
        while len(ids) > 1:
            best_rank, best_pos = None, -1
            for i, pair in enumerate(zip(ids, ids[1:])):
                r = self._ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_pos = r, i
            if best_rank is None:
                break
            merged = _N_SPECIAL + 256 + best_rank
            pair = self.merges[best_rank]
            out, i = [], 0
            while i < len(ids):
                if i + 1 < len(ids) and (ids[i], ids[i + 1]) == pair:
                    out.append(merged)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        return ids

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        out = [BOS] if add_bos else []
        for w in _WORD_RE.findall(text):
            out.extend(self._bpe([b + _N_SPECIAL for b in w.encode("utf-8")]))
        if add_eos:
            out.append(EOS)
        return out

    def _expand(self, tid: int, buf: bytearray):
        """Render one id's bytes. Iterative with an explicit stack — a deep
        merge chain (long repeated-byte runs make nesting ~linear in token
        length) must not hit Python's recursion limit — and memoized per
        merged id, so decode cost is amortized O(bytes)."""
        if tid < _N_SPECIAL:
            return  # specials render as nothing
        if tid < _N_SPECIAL + 256:
            buf.append(tid - _N_SPECIAL)
            return
        cached = self._byte_cache.get(tid)
        if cached is None:
            out = bytearray()
            stack = [tid]
            while stack:
                t = stack.pop()
                if t < _N_SPECIAL:
                    continue
                if t < _N_SPECIAL + 256:
                    out.append(t - _N_SPECIAL)
                    continue
                hit = self._byte_cache.get(t)
                if hit is not None:
                    out.extend(hit)
                    continue
                left, right = self.merges[t - _N_SPECIAL - 256]
                stack.append(right)
                stack.append(left)
            cached = self._byte_cache[tid] = bytes(out)
        buf.extend(cached)

    def decode(self, ids: Iterable[int]) -> str:
        buf = bytearray()
        for tid in ids:
            tid = int(tid)
            if 0 <= tid < self.vocab_size:
                self._expand(tid, buf)
        return buf.decode("utf-8", errors="replace")

    # -- persistence ---------------------------------------------------------
    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"format": "raytpu-bpe-v1", "merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != "raytpu-bpe-v1":
            raise ValueError(f"{path} is not a raytpu-bpe-v1 tokenizer file")
        return cls(d["merges"])


class HFTokenizer:
    """Adapter over a locally-available transformers tokenizer (same duck
    type as Tokenizer: encode/decode/eos_id/vocab_size). Offline only — the
    environment has no egress, so `name_or_path` must already be on disk."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    @property
    def eos_id(self) -> int:
        return self._tok.eos_token_id if self._tok.eos_token_id is not None else -1

    @property
    def bos_id(self) -> int:
        return self._tok.bos_token_id if self._tok.bos_token_id is not None else -1

    @property
    def pad_id(self) -> int:
        return self._tok.pad_token_id if self._tok.pad_token_id is not None else 0

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id >= 0:
            ids = [self.bos_id] + ids
        if add_eos and self.eos_id >= 0:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    @property
    def chat_template(self) -> Optional[str]:
        """The checkpoint's own chat template (jinja source), if it ships
        one — instruction-tuned HF checkpoints do; the ingress uses it so
        /v1/chat/completions renders the prompt format the model was tuned
        on (reference: vLLM resolves the template from the HF tokenizer)."""
        return getattr(self._tok, "chat_template", None)

    def apply_chat_template(self, messages, add_generation_prompt: bool = True) -> str:
        return self._tok.apply_chat_template(
            list(messages), tokenize=False, add_generation_prompt=add_generation_prompt
        )


def load_tokenizer(spec: Optional[str]) -> Tokenizer | HFTokenizer:
    """spec: path to a raytpu-bpe-v1 json, a local HF tokenizer dir/name, or
    None -> a merge-less byte tokenizer (works for any text; ~1 token/byte)."""
    if spec is None:
        return Tokenizer()
    if spec.endswith(".json"):
        return Tokenizer.load(spec)
    return HFTokenizer(spec)
