"""Continuous-batching LLM engine in PyTorch: block-paged or dense KV cache,
bucketed grouped prefill, fused decode blocks.

Counterpart of ``ray_tpu/llm/engine.py``. The host scheduler is the JAX
engine's, logic for logic: slots, length buckets, prefill group sizes
(k-groups), the page free list with page 0 as the dead sink, page-budgeted
admission, admission-aware decode-block sizing, discarding a block's
overshoot, and the finish reasons. The device programs are rewritten for
PyTorch's eager mode:

- Prefill runs each admitted group of k same-bucket prompts as one batch
  [k, P] through the layers (the JAX engine scanned the k requests one by
  one). Attention goes through ``flash_attention``: kernel K1 on the GPU,
  with prompt padding as its own segment (``seg = pos >= length``).
  ``_prefill_logits`` is the JAX ``_prefill_impl`` and
  ``_prefill_impl_dense`` in one: they differ only in where K/V land.
- Paged decode scatters each slot's new K/V at its linear pool position
  ``page_tables[row, len // ps] * ps + len % ps`` BEFORE attending with
  ``len + 1`` through ``paged_attention``: kernel K4 on the GPU. The pool is
  [L, KV, P_total * ps, Hd], viewed per layer as [KV, P_total, ps, Hd].
- Dense decode is plain einsum attention over each slot's [S] cache row, as
  in the JAX engine (no kernel there either).
- A decode block of n steps is a Python loop; tokens stay on the device until
  the block ends, and one copy brings the [n, B] block back to the host.
- The pools and the device mirrors (lengths, last tokens, page tables) are
  updated in place: PyTorch has no buffer donation, and an in-place write is
  what donation bought the JAX engine.
- Parameters are cast once to the activation dtype at load; the JAX engine
  kept fp32 parameters and cast each one at every matmul, which gives the
  same values.

Page-0 convention (as in the JAX engine): page 0 is never allocated; dead
page-table entries point at it, and it absorbs writes from retired or
empty slots, whose lengths are zeroed so nothing ever reads what they wrote.
Device indices that the JAX code clamped implicitly (an empty slot's length
keeps advancing inside a block) are clamped explicitly here.

Not in this slice (each raises ``NotImplementedError``): the prefix KV cache,
chunked prefill and tensor-parallel serving.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.llm.sampling import SamplingParams, sample_batch
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    attn_proj,
    cast_params,
    dense_ffn,
    init_params,
    layer_params,
    linear,
    out_proj,
    rms_norm,
    rope,
)
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.paged_attention import paged_attention


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8
    max_seq: int = 0  # 0 -> model max_seq_len
    prefill_buckets: tuple = (128, 256, 512, 1024, 2048)
    temperature: float = 0.0  # 0 => greedy
    eos_id: int = -1  # -1 => never stop on a token; set to the tokenizer's id
    seed: int = 0
    # Decode steps per host round trip: tokens of a block come back to the
    # host in one copy. Cost: admissions happen between blocks, and a slot
    # finishing mid-block discards its tail tokens.
    decode_block: int = 8
    # KV cache layout: "paged" (block-paged pool, page-budgeted admission,
    # decode through kernel K4) or "dense" (contiguous [B, max_seq] per slot,
    # einsum decode attention).
    kv_layout: str = "dense"
    # KV page size (tokens), paged layout only. max_seq must be a multiple;
    # prefill buckets are rounded up to multiples.
    page_size: int = 128
    # Page-pool size, paged layout only. 0 -> dense parity
    # (max_slots * max_seq / page_size) + 1. Admission reserves
    # ceil((prompt + max_tokens + decode_block) / page_size) pages per
    # request and queues when the pool is dry.
    total_pages: int = 0
    # Candidate cap for truncated (top-k/top-p) sampling rows; see
    # sampling.TOPK_CAP for the nucleus-width caveat.
    sample_topk_cap: int = 128
    # Not in this slice of the port (raise NotImplementedError when set):
    tensor_parallel: int = 1
    chunked_prefill: int = 0
    prefix_cache: bool = False


@dataclasses.dataclass
class _Slot:
    req_id: str
    max_tokens: int
    pages: list  # page ids owned by this request
    emitted: list = dataclasses.field(default_factory=list)
    n_generated: int = 0  # dispatched count (values may still be on device)
    arrived_at: float = 0.0
    first_token_at: Optional[float] = None
    stop_ids: tuple = ()  # per-request stop tokens (on top of engine eos)
    ignore_eos: bool = False


def _prefill_layer(x, lp, cfg: TransformerConfig, positions, seg):
    """Causal layer over the (padded) prompts; returns the new K/V for the
    cache. seg masks pad columns (pad tokens are their own segment)."""
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = attn_proj(h, lp)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, segment_ids=seg)
    x = x + out_proj(o, lp["wo"])
    h = rms_norm(x, lp["ffn_norm"])
    return x + dense_ffn(h, lp), k, v


def _decode_layer_dense(x, lp, ck, cv, cfg: TransformerConfig, lengths):
    """Dense-layout one-token step against a [B, S, KV, Hd] cache slice,
    which it updates in place: plain einsum attention."""
    dt = x.dtype
    B = x.shape[0]
    S, KV, Hd = ck.shape[1], ck.shape[2], ck.shape[3]
    group = cfg.n_heads // cfg.kv_heads
    h = rms_norm(x, lp["attn_norm"])
    q, k_new, v_new = attn_proj(h, lp)  # q: [B,1,H,Hd]  k/v: [B,1,KV,Hd]
    pos = lengths[:, None]
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    at = lengths.long().clamp(max=S - 1)  # only an empty slot's length can pass S - 1
    ck[rows, at] = k_new[:, 0]
    cv[rows, at] = v_new[:, 0]
    qg = q[:, 0].reshape(B, KV, group, Hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, ck).float() / math.sqrt(Hd)
    valid = (torch.arange(S, device=x.device)[None, :] <= lengths[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, -1e30)
    p = torch.softmax(scores, dim=-1).to(dt)
    o = torch.einsum("bkgs,bskh->bkgh", p, cv).reshape(B, 1, cfg.n_heads, Hd)
    x = x + out_proj(o, lp["wo"])
    h = rms_norm(x, lp["ffn_norm"])
    return x + dense_ffn(h, lp)


class LLMEngine:
    """Host-side continuous batching over the prefill and decode programs.

    ``device=None`` means the GPU: the constructor raises when no CUDA device
    is visible, and runs on the CPU only when asked (``device="cpu"``)."""

    def __init__(self, cfg: TransformerConfig, params=None,
                 engine_config: EngineConfig | None = None, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "LLMEngine runs on the GPU by default and no CUDA device is visible; "
                    "pass device='cpu' to run on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = cfg
        self.ec = engine_config or EngineConfig()
        if self.ec.tensor_parallel > 1:
            raise NotImplementedError(
                "tensor_parallel > 1 is not ported yet (tensor-parallel serving is a later slice)")
        if self.ec.prefix_cache:
            raise NotImplementedError(
                "prefix_cache is not ported yet (prefix cache + chunked prefill are the next serving slice)")
        if self.ec.chunked_prefill:
            raise NotImplementedError(
                "chunked_prefill is not ported yet (prefix cache + chunked prefill are the next serving slice)")
        if self.ec.max_seq <= 0:
            self.ec = dataclasses.replace(self.ec, max_seq=cfg.max_seq_len)
        S = self.ec.max_seq
        self.paged = self.ec.kv_layout == "paged"
        if self.ec.kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {self.ec.kv_layout!r} (paged|dense)")
        if not self.paged and (self.ec.total_pages > 0 or self.ec.page_size != 128):
            # Page knobs only mean something in the paged layout; silently
            # ignoring an explicit page budget could exhaust device memory.
            raise ValueError(
                "total_pages/page_size were set but kv_layout is 'dense'; "
                "pass kv_layout='paged' for page-budgeted memory"
            )
        ps = self.ec.page_size if self.paged else S
        if self.paged and S % ps:
            raise ValueError(f"max_seq {S} must be a multiple of page_size {ps}")
        if self.paged and self.ec.total_pages <= 0:
            self.ec = dataclasses.replace(self.ec, total_pages=self.ec.max_slots * (S // ps) + 1)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.ec.seed)
            params = init_params(cfg, gen, self.device)
        self.set_params(params)
        L = cfg.n_layers
        B = self.ec.max_slots
        dev = self.device

        def _zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if self.paged:
            P_total = self.ec.total_pages
            self.ppseq = S // ps  # page-table width (max pages per sequence)
            # Linear page pool: position (page, offset) lives at page*ps + offset.
            pool_shape = (L, cfg.kv_heads, P_total * ps, cfg.head_dim)
            self.k_pages = _zeros(pool_shape, cfg.dtype)
            self.v_pages = _zeros(pool_shape, cfg.dtype)
            self.free_pages: deque = deque(range(1, P_total))  # page 0 = dead sink
        else:
            # Dense per-slot cache (one virtual page of max_seq per slot).
            self.ppseq = 1
            dense_shape = (L, B, S, cfg.kv_heads, cfg.head_dim)
            self.k_pages = _zeros(dense_shape, cfg.dtype)
            self.v_pages = _zeros(dense_shape, cfg.dtype)
            self.free_pages = deque()
        self.page_tables = np.zeros((B, self.ppseq), np.int32)
        self.d_page_tables = _zeros((B, self.ppseq), torch.int32)
        self.lengths = np.zeros(B, np.int32)  # host copy drives scheduling
        # Device mirrors: decode blocks read/advance these without any
        # host->device transfer per step.
        self.d_lengths = _zeros(B, torch.int32)
        self.d_last = _zeros(B, torch.int32)
        self.slots: list[Optional[_Slot]] = [None] * B
        # Per-slot sampling params: host copies set at admission, device
        # mirrors ride into every prefill/decode call as [B] tensors.
        self.samp_temps = np.full(B, self.ec.temperature, np.float32)
        self.samp_top_ps = np.ones(B, np.float32)
        self.samp_top_ks = np.zeros(B, np.int32)
        self.d_temps = self._tensor(self.samp_temps)
        self.d_top_ps = self._tensor(self.samp_top_ps)
        self.d_top_ks = self._tensor(self.samp_top_ks)
        self.waiting: deque = deque()
        self._gen = torch.Generator(device=dev).manual_seed(self.ec.seed + 1)
        # Slots mid chunked-prefill (slot -> prompt). Always empty until
        # chunked prefill is ported; the masking below already honours it.
        self._prefilling: dict[int, np.ndarray] = {}
        # Buckets: page-size multiples only (a prefill writes whole pages;
        # dense ps == max_seq, so buckets pass through untouched).
        bucket_quantum = self.ec.page_size if self.paged else 1
        self.buckets = tuple(sorted(
            {min(bucket_quantum * math.ceil(b / bucket_quantum), S)
             for b in self.ec.prefill_buckets if b <= S} | {S}
        ))
        # Prefill group sizes, largest-first.
        self.k_buckets = (8, 4, 2, 1)
        # Decode block sizes: full (empty queue) and short (queue pressure:
        # waiting requests reach prefill sooner between shorter blocks).
        self.block_sizes = tuple(sorted({self.ec.decode_block, max(1, self.ec.decode_block // 4)}))

    def set_params(self, params) -> None:
        """Swaps in new weights (same tree layout), cast once to the
        activation dtype on this engine's device. The caller must exclude
        step() for the duration; the KV cache is kept."""
        self.params = cast_params(params, self.cfg.dtype, self.device)
        self._layers = [layer_params(self.params, i) for i in range(self.cfg.n_layers)]

    # -- page accounting ---------------------------------------------------
    def _pages_needed(self, prompt_len: int, max_tokens: int) -> int:
        if not self.paged:
            return 0  # dense: admission is bounded by slots, not pages
        # + decode_block: a block may overshoot a slot's budget before the
        # host absorbs it; the slack pages keep those writes inside the
        # request's own reservation.
        total = min(prompt_len + max_tokens + self.ec.decode_block, self.ec.max_seq)
        return math.ceil(total / self.ec.page_size)

    # -- device-mirror masking (chunked prefill) ---------------------------
    def _masked_lengths(self) -> np.ndarray:
        """Host lengths with mid-prefill slots zeroed: the decode block must
        treat them as empty (writes land in dead page 0)."""
        if not self._prefilling:
            return self.lengths
        m = self.lengths.copy()
        m[list(self._prefilling)] = 0
        return m

    def _masked_page_tables(self) -> np.ndarray:
        if not self._prefilling:
            return self.page_tables
        m = self.page_tables.copy()
        m[list(self._prefilling)] = 0
        return m

    # -- device programs ---------------------------------------------------
    def _tensor(self, a, dtype=None):
        """A device copy of host data (never a view of the numpy buffer, which
        the scheduler keeps mutating)."""
        return torch.tensor(a, dtype=dtype, device=self.device)

    def _sample(self, logits, temps, top_ps, top_ks, gen, host_temps):
        """Per-row sampling; all-greedy batches (known from the host copy of
        the temperatures) take the argmax directly."""
        if (host_temps <= 0.0).all():
            return logits.argmax(dim=-1).to(torch.int32)
        return sample_batch(logits, temps, top_ps, top_ks, gen, cap=self.ec.sample_topk_cap)

    def _prefill_logits(self, tokens, lengths, third):
        """k prompts of one length bucket as one batch: writes their K/V
        into the cache and returns the last real position's logits [k, V]
        (fp32). tokens: [k, P] (padded to the bucket); lengths: [k];
        ``third`` is the placement input: page rows [k, P // ps] (paged;
        trailing entries 0 = dead sink) or slot ids [k] (dense)."""
        cfg = self.cfg
        k, P = tokens.shape
        KV, Hd = cfg.kv_heads, cfg.head_dim
        tok = self._tensor(tokens, torch.long)
        lens = self._tensor(lengths, torch.long)
        x = self.params["embed"][tok]  # [k, P, D]
        pos = torch.arange(P, dtype=torch.int32, device=self.device).expand(k, P)
        seg = (pos >= lens[:, None]).to(torch.int32)  # pads = their own segment
        if self.paged:
            ps = self.ec.page_size
            lin = (np.asarray(third, np.int64)[:, :, None] * ps + np.arange(ps)).reshape(-1)
            lin = self._tensor(lin)  # [k * P] pool rows, page chunk by page chunk
        else:
            slots = self._tensor(third, torch.long)
        for li, lp in enumerate(self._layers):
            x, k_new, v_new = _prefill_layer(x, lp, cfg, pos, seg)
            if self.paged:
                # [k, P, KV, Hd] -> [KV, k * P, Hd]; scatter page chunks into the pool.
                self.k_pages[li].index_copy_(1, lin, k_new.permute(2, 0, 1, 3).reshape(KV, k * P, Hd))
                self.v_pages[li].index_copy_(1, lin, v_new.permute(2, 0, 1, 3).reshape(KV, k * P, Hd))
            else:
                self.k_pages[li][slots, :P] = k_new
                self.v_pages[li][slots, :P] = v_new
        last = x[torch.arange(k, device=self.device), lens - 1]  # [k, D]
        last = rms_norm(last, self.params["final_norm"])
        return linear(last, self.params["lm_head"]).float()

    def _prefill_batch_impl(self, tokens, lengths, third, gen, idxs):
        """Prefill one group and sample each request's first token -> [k]
        int32 on the device (not fetched)."""
        logits = self._prefill_logits(tokens, lengths, third)
        return self._sample(
            logits, self._tensor(self.samp_temps[idxs]), self._tensor(self.samp_top_ps[idxs]),
            self._tensor(self.samp_top_ks[idxs]), gen, self.samp_temps[idxs],
        )

    def _decode_impl(self, last_tokens, lengths, page_tables, n_steps, gen, temps, top_ps, top_ks):
        """n_steps tokens for every slot, paged layout. Returns
        (toks [n_steps, B], last', lengths'), all on the device."""
        cfg = self.cfg
        ps = self.ec.page_size
        KV, Hd = cfg.kv_heads, cfg.head_dim
        B = page_tables.shape[0]
        rows = torch.arange(B, device=self.device)
        last, lens = last_tokens, lengths
        out = []
        for _ in range(n_steps):
            x = self.params["embed"][last.long()][:, None, :]  # [B, 1, D]
            # Linear write position per slot: its page for len, plus offset.
            # (An empty slot's length may run past the table; its row is all
            # page 0, so the clamp only keeps the index in range.)
            col = (lens // ps).clamp(max=self.ppseq - 1).long()
            lin = (page_tables[rows, col] * ps + lens % ps).long()  # [B]
            pos = lens[:, None]
            for li, lp in enumerate(self._layers):
                hh = rms_norm(x, lp["attn_norm"])
                q, k_new, v_new = attn_proj(hh, lp)
                q = rope(q, pos, cfg.rope_theta)
                k_new = rope(k_new, pos, cfg.rope_theta)
                kp, vp = self.k_pages[li], self.v_pages[li]  # [KV, P_total * ps, Hd]
                kp[:, lin] = k_new[:, 0].transpose(0, 1)  # [KV, B, Hd]
                vp[:, lin] = v_new[:, 0].transpose(0, 1)
                o = paged_attention(
                    q[:, 0], kp.view(KV, -1, ps, Hd), vp.view(KV, -1, ps, Hd), lens + 1, page_tables,
                )  # [B, H, Hd]
                x = x + out_proj(o, lp["wo"])[:, None, :]
                hh = rms_norm(x, lp["ffn_norm"])
                x = x + dense_ffn(hh, lp)
            x = rms_norm(x, self.params["final_norm"])
            logits = linear(x[:, 0], self.params["lm_head"]).float()
            last = self._sample(logits, temps, top_ps, top_ks, gen, self.samp_temps)
            lens = lens + 1
            out.append(last)
        return torch.stack(out), last, lens

    def _decode_impl_dense(self, last_tokens, lengths, n_steps, gen, temps, top_ps, top_ks):
        """Dense layout: n_steps for every slot; attention is the einsum over
        each slot's contiguous [S] row."""
        last, lens = last_tokens, lengths
        out = []
        for _ in range(n_steps):
            x = self.params["embed"][last.long()][:, None, :]  # [B, 1, D]
            for li, lp in enumerate(self._layers):
                x = _decode_layer_dense(x, lp, self.k_pages[li], self.v_pages[li], self.cfg, lens)
            x = rms_norm(x, self.params["final_norm"])
            logits = linear(x[:, 0], self.params["lm_head"]).float()
            last = self._sample(logits, temps, top_ps, top_ks, gen, self.samp_temps)
            lens = lens + 1
            out.append(last)
        return torch.stack(out), last, lens

    def _decode(self, n, gen):
        if self.paged:
            return self._decode_impl(
                self.d_last, self.d_lengths, self.d_page_tables, n, gen,
                self.d_temps, self.d_top_ps, self.d_top_ks,
            )
        return self._decode_impl_dense(
            self.d_last, self.d_lengths, n, gen, self.d_temps, self.d_top_ps, self.d_top_ks,
        )

    @torch.no_grad()
    def warmup(self, buckets=None, k_values=None):
        """Runs every (bucket, k) prefill shape and both decode block sizes
        once before serving (against the dead page), so first-call costs
        (kernel builds, library handles, allocator growth) stay out of the
        first requests' TTFT; then resets the device mirrors it dirtied."""
        if buckets is None:
            buckets = self.buckets
        else:
            # Snap caller lengths to the buckets admission actually selects.
            buckets = tuple(
                sorted({next(b for b in self.buckets if b >= min(x, self.buckets[-1]))
                        for x in buckets})
            )
        k_values = tuple(k_values) if k_values is not None else self.k_buckets
        ps = self.ec.page_size
        gen = torch.Generator(device=self.device).manual_seed(0)
        for b in buckets:
            for k in k_values:
                toks = np.zeros((k, b), np.int32)
                lens = np.ones(k, np.int32)
                if self.paged:
                    third = np.zeros((k, b // ps), np.int32)  # writes -> dead page
                else:
                    third = np.zeros(k, np.int32)  # slot 0 (reset below)
                td = self._prefill_batch_impl(toks, lens, third, gen, np.zeros(k, np.int64))
                idxs = torch.zeros(k, dtype=torch.long, device=self.device)
                self.d_lengths[idxs] = self._tensor(lens)
                self.d_last[idxs] = td
                td.cpu()
        for n in self.block_sizes:
            toks, _, _ = self._decode(n, gen)
            toks.cpu()
        # Reset device mirrors dirtied by the dummy executions.
        self.d_lengths.zero_()
        self.d_last.zero_()

    # -- request lifecycle -------------------------------------------------
    def add_request(self, req_id: str, tokens, max_tokens: int = 64,
                    sampling: SamplingParams | None = None):
        """Queue a request. `sampling` carries the per-request decode params;
        without it the engine-global defaults (EngineConfig.temperature,
        greedy top) apply."""
        if sampling is None:
            sampling = SamplingParams(temperature=self.ec.temperature, max_tokens=max_tokens)
        if len(tokens) >= self.ec.max_seq:
            raise ValueError(f"prompt length {len(tokens)} >= max_seq {self.ec.max_seq}")
        need = self._pages_needed(len(tokens), sampling.max_tokens)
        if self.paged and need > self.ec.total_pages - 1:
            raise ValueError(f"request needs {need} pages > pool size {self.ec.total_pages - 1}")
        self.waiting.append((req_id, np.asarray(tokens, np.int32), sampling, time.perf_counter()))

    def abort(self, req_id: str) -> None:
        """Drop a request whose consumer went away: dequeue it, or free its
        slot so decode stops spending steps on it. Call from the stepping
        thread only (mutates scheduler state + device mirrors)."""
        self.waiting = deque(w for w in self.waiting if w[0] != req_id)
        for i, s in enumerate(self.slots):
            if s is not None and s.req_id == req_id:
                self._retire(i)
                self.d_lengths = self._tensor(self._masked_lengths())
                self.d_page_tables = self._tensor(self._masked_page_tables())
                break

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def _retire(self, i: int) -> None:
        """Free slot i's pages and zero its table row (dead slots must write
        only into page 0 while they keep decoding inside a block)."""
        slot = self.slots[i]
        if slot is not None:
            self.free_pages.extend(slot.pages)
        self._prefilling.pop(i, None)
        self.slots[i] = None
        self.lengths[i] = 0
        self.page_tables[i, :] = 0

    @torch.no_grad()
    def step(self) -> dict:
        """One engine iteration: admit waiting requests into free slots +
        free pages (prefill, grouped by length bucket, groups dispatched
        back to back then fetched in order), then one decode block for all
        slots. Returns {req_id: {"token": int, "new_tokens": [...],
        "finished": bool, "ttft_s": float|None, "tokens": [..] when done}}."""
        events: dict[str, dict] = {}
        retired = False
        ps = self.ec.page_size
        # 1. admit: page-budgeted assignment of waiting requests to free slots.
        admitted: list[tuple[int, str, np.ndarray, int, int, float]] = []
        for i in range(self.ec.max_slots):
            if not self.waiting or self.slots[i] is not None:
                continue
            req_id, tokens, sp, arrived = self.waiting[0]
            P = len(tokens)
            need = self._pages_needed(P, sp.max_tokens)
            if need > len(self.free_pages):
                break  # head-of-line blocks until pages free (FIFO fairness)
            self.waiting.popleft()
            pages = [self.free_pages.popleft() for _ in range(need)]
            self.slots[i] = _Slot(
                req_id=req_id, max_tokens=sp.max_tokens, pages=pages, n_generated=1,
                arrived_at=arrived, stop_ids=tuple(sp.stop_token_ids), ignore_eos=sp.ignore_eos,
            )
            self.samp_temps[i] = sp.temperature
            self.samp_top_ps[i] = sp.top_p
            self.samp_top_ks[i] = sp.top_k
            row = np.zeros(self.ppseq, np.int32)
            row[: len(pages)] = pages
            self.page_tables[i] = row
            self.lengths[i] = P
            bucket = next(b for b in self.buckets if b >= P)
            admitted.append((i, req_id, tokens, bucket, sp.max_tokens, arrived))
        # 2. dispatch prefill groups back to back, then fetch them in order.
        # (Eager dispatch of a group costs about as much host time as its
        # device work, so on the GPU the groups finish before the first
        # fetch and share one TTFT; see PERF.md.)
        by_bucket: dict[int, list] = {}
        for item in admitted:
            by_bucket.setdefault(item[3], []).append(item)
        dispatched: list[tuple[list, torch.Tensor]] = []  # (chunk, toks_dev)
        for bucket, group in by_bucket.items():
            n_pg = bucket // ps if self.paged else 1
            while group:
                k = next(kb for kb in self.k_buckets if kb <= len(group))
                chunk, group = group[:k], group[k:]
                idxs = np.asarray([it[0] for it in chunk], np.int64)
                padded = np.zeros((k, bucket), np.int32)
                lens = np.zeros(k, np.int32)
                pgs = np.zeros((k, n_pg), np.int32) if self.paged else None
                for j, (i, _rid, tokens, _b, _mt, _arr) in enumerate(chunk):
                    padded[j, : len(tokens)] = tokens
                    lens[j] = len(tokens)
                    if self.paged:
                        pgs[j] = self.page_tables[i, :n_pg]  # trailing zeros -> dead sink
                # Paged: per-request page rows; dense: the slot index.
                third = pgs if self.paged else idxs
                toks_dev = self._prefill_batch_impl(padded, lens, third, self._gen, idxs)
                idx_t = self._tensor(idxs)
                self.d_lengths[idx_t] = self._tensor(lens)
                self.d_last[idx_t] = toks_dev
                dispatched.append((chunk, toks_dev))
        if admitted:
            self.d_page_tables = self._tensor(self._masked_page_tables())
            self.d_temps = self._tensor(self.samp_temps)
            self.d_top_ps = self._tensor(self.samp_top_ps)
            self.d_top_ks = self._tensor(self.samp_top_ks)
        # Fetch per group, in dispatch order.
        for chunk, toks_dev in dispatched:
            group_toks = toks_dev.tolist()
            now = time.perf_counter()
            for (i, req_id, _tokens, _b, _mt, arrived), tok in zip(chunk, group_toks):
                slot = self.slots[i]
                slot.first_token_at = now
                slot.emitted.append(tok)
                events[req_id] = {
                    "token": tok,
                    "new_tokens": [tok],
                    "finished": False,
                    "ttft_s": now - arrived,
                }
                retired |= self._maybe_finish(i, events)
        # 3. decode: one block over all slots. Queue pressure shrinks the
        # block so the next admission wave starts sooner.
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._prefilling]
        toks = None
        n = 0
        if active:
            remaining = [self.slots[i].max_tokens - self.slots[i].n_generated for i in active]
            positive = [r for r in remaining if r > 0]
            cap = self.ec.max_seq - 1 - int(max(self.lengths[i] for i in active))
            if positive and cap > 0:
                block = self.block_sizes[0] if self.waiting else self.block_sizes[-1]
                # Snap DOWN to a block size that fits: an oversized block
                # advances lengths past max_seq - 1 and would overwrite the
                # longest slot's earlier KV.
                fits = [b for b in self.block_sizes if b <= min(block, cap)]
                if fits:
                    n = fits[-1]
                    toks, self.d_last, self.d_lengths = self._decode(n, self._gen)
                    for i in active:
                        self.slots[i].n_generated += n
                else:
                    # No block size fits the headroom left by the longest
                    # slot(s): retire them (they are within block_sizes[0]
                    # tokens of max_seq) so the next step has room to decode.
                    for i in active:
                        if int(self.lengths[i]) + self.block_sizes[0] >= self.ec.max_seq:
                            slot = self.slots[i]
                            ev = events.setdefault(slot.req_id, {"ttft_s": None})
                            ev["finished"] = True
                            ev["finish_reason"] = "length"  # context-cap retirement
                            ev["tokens"] = list(slot.emitted)
                            ev["ttft_s"] = ev.get("ttft_s") or (
                                (slot.first_token_at or slot.arrived_at) - slot.arrived_at
                            )
                            self._retire(i)
                            retired = True
        if toks is not None:
            block_toks = toks.cpu().numpy()  # [n, B]
            for step_i in range(n):
                for i in active:
                    slot = self.slots[i]
                    if slot is None or len(slot.emitted) >= slot.n_generated:
                        continue  # finished, or this block overshot its budget
                    tok = int(block_toks[step_i, i])
                    self.lengths[i] += 1
                    slot.emitted.append(tok)
                    ev = events.setdefault(slot.req_id, {"finished": False, "ttft_s": None})
                    ev["token"] = tok
                    ev.setdefault("new_tokens", []).append(tok)
                    retired |= self._maybe_finish(i, events)
        if retired:
            # Re-sync device mirrors so retired slots stop advancing their
            # (now meaningless) lengths toward max_seq, and their writes land
            # in the dead page.
            self.d_lengths = self._tensor(self._masked_lengths())
            self.d_page_tables = self._tensor(self._masked_page_tables())
            last = np.zeros(self.ec.max_slots, np.int32)
            for i, s in enumerate(self.slots):
                if s is not None and s.emitted:
                    last[i] = s.emitted[-1]
            self.d_last = self._tensor(last)
        return events

    def _maybe_finish(self, i: int, events: dict) -> bool:
        slot = self.slots[i]
        # Retire cause rides the event as OpenAI-style finish_reason: a
        # token-triggered stop (eos / per-request stop ids) is "stop"; any
        # budget cap (max_tokens, or the max_seq context ceiling) is "length".
        stopped = (
            (not slot.ignore_eos and self.ec.eos_id >= 0 and slot.emitted[-1] == self.ec.eos_id)
            or slot.emitted[-1] in slot.stop_ids
        )
        capped = (
            len(slot.emitted) >= slot.max_tokens
            or int(self.lengths[i]) + 1 >= self.ec.max_seq
        )
        done = stopped or capped
        if done:
            ev = events.setdefault(slot.req_id, {"ttft_s": None})
            ev["finished"] = True
            ev["finish_reason"] = "stop" if stopped else "length"
            ev["tokens"] = list(slot.emitted)
            ev["ttft_s"] = ev.get("ttft_s") or (slot.first_token_at - slot.arrived_at)
            self._retire(i)
        return bool(done)

    def generate(self, tokens, max_tokens: int = 64,
                 sampling: SamplingParams | None = None) -> dict:
        """Synchronous single-request convenience: returns {"tokens", "ttft_s"}."""
        req_id = f"g{time.monotonic_ns()}"
        self.add_request(req_id, tokens, max_tokens, sampling=sampling)
        ttft = None
        while True:
            events = self.step()
            ev = events.get(req_id)
            if ev and ev.get("ttft_s") is not None:
                ttft = ev["ttft_s"]
            if ev and ev.get("finished"):
                return {"tokens": ev["tokens"], "ttft_s": ttft}
