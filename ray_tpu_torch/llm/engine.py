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
  On one CUDA device with the paged layout that loop is captured once per
  kind of block (its n, and whether every slot is greedy) as a CUDA graph
  at B = max_slots and replayed, so a block costs one launch on the host
  instead of hundreds of eager ops a token step (``_decode``).
- The pools and the device mirrors (lengths, last tokens, page tables,
  sampling parameters) are updated in place and never rebound: PyTorch has
  no buffer donation, and an in-place write is what donation bought the JAX
  engine; the decode graphs read the mirrors at fixed addresses.
- Parameters are cast once to the activation dtype at load; the JAX engine
  kept fp32 parameters and cast each one at every matmul, which gives the
  same values.

- The prefix KV cache and chunked prefill keep the JAX engine's host logic
  (chained page-aligned digests, refcounted pages, LRU eviction that spares
  the entry being hit, one chunk per step with the slot's device rows
  masked until its last chunk). The tail prefill's attention is plain
  einsum over the context pages gathered from the pool plus the causal
  tail, as in the JAX engine (no kernel there either); the page copy is an
  ``index_select`` then an ``index_copy_`` across all layers.

Page-0 convention (as in the JAX engine): page 0 is never allocated; dead
page-table entries point at it, and it absorbs writes from retired or
empty slots, whose lengths are zeroed so nothing ever reads what they wrote.
Device indices that the JAX code clamped implicitly (an empty slot's length
keeps advancing inside a block) are clamped explicitly here.

- Tensor-parallel serving (``EngineConfig.tensor_parallel`` > 1, as in the
  JAX engine): a ``tensor`` mesh over the first tp slots of
  ``ray_tpu_torch.parallel.devices()``, the parameters split Megatron-style
  by ``ShardingStrategy.tp()`` (each leaf placed shard by shard as it is
  drawn or loaded, never whole on one device), the KV pools split by
  kv_heads ([L, KV/tp, P*ps, Hd] or [L, B, S, KV/tp, Hd] per slot), the page
  tables, lengths and sampling state replicated, so the host scheduler does
  not change. Each layer runs in phases over the slots: each slot's
  projections and attention on its own heads (K1 per slot in prefill, K4 per
  slot in decode through ``paged_attention``'s ``mesh`` branch), then the
  row-parallel partial sums after ``wo`` and ``w_down`` added in fp32 in slot
  order (psum); the embedding is a masked lookup per vocab shard plus a
  psum, and the logits are gathered over the vocabulary for the sampler.
  Slots may share one card: that checks the sharded path, not a speed-up.

- Routed experts (``cfg.n_experts``, one device): each layer's FFN routes
  its tokens (``ops.moe.route``: the router's product and softmax in fp32,
  the top k renormalised)
  and runs them through kernel K6 (``ops.moe.moe_experts``), which sorts the
  rows by expert on the device; nothing reads the routing back, so the
  decode graphs capture it. A device-side [L, E] count of the rows each
  expert received grows inside every prefill and decode block
  (``expert_load`` reads it). Tensor parallelism with experts is refused.
- Per-layer attention (``cfg.layer_types``): a sliding layer attends to its
  last ``sliding_window`` keys in prefill (K1's window instance), decode
  (K4's), the tail prefill's and the dense decode's masks; each layer
  rotates with its own RoPE (``cfg.layer_rope``: YaRN on the full layers).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import math
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.llm.sampling import SamplingParams, sample_batch
from ray_tpu_torch.models.sharded import add_psum, vocab_lookup
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    attn_proj,
    cast_params,
    dense_ffn,
    init_params,
    iter_init_params,
    layer_params,
    linear,
    out_proj,
    param_logical_axes,
    resolve_device,
    rms_norm,
    rope,
    tree_from_leaves,
    yarn_inv_freq,
)
from ray_tpu_torch.ops import moe as _moe
from ray_tpu_torch.ops import paged_attention as _k4
from ray_tpu_torch.ops.attention import WINDOW_HEAD_DIM, check_head_dim, flash_attention
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.parallel._shard_map import per_slot as _per_slot
from ray_tpu_torch.util import tracing as _tracing

_NO_PHASE = contextlib.nullcontext()


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
    # Tensor-parallel serving degree: > 1 shards the model and the KV cache
    # over a `tensor` mesh of that many slots (ray_tpu_torch.parallel.devices:
    # the visible cards, or the slots RAY_TPU_TORCH_DEVICE_SLOTS makes). Needs
    # n_heads, kv_heads, d_ff and vocab_size divisible by the degree.
    tensor_parallel: int = 1
    # Chunked prefill (paged layout only): a prompt whose un-cached span
    # exceeds this many tokens prefills in page-aligned chunks of this size,
    # one chunk per engine step, interleaved with the decode blocks, so a long
    # prompt stalls the decoding slots by one chunk per step, not by its whole
    # prefill. Must be a multiple of page_size. 0 = off.
    chunked_prefill: int = 0
    # Prefix KV cache (paged layout only). A retired request's prompt pages
    # stay in an LRU cache under chained digests, one entry per page-aligned
    # prefix plus the full prompt, the pages refcounted across entries.
    # Exact hit: copy the cached pages and start decoding at position P-1
    # (the decode block re-derives that position's KV and emits the first
    # token; no prefill). Partial hit (a prompt extending a cached
    # page-aligned prefix): copy the matched pages, then prefill only the
    # tail, attending to the cached pages.
    prefix_cache: bool = False


@dataclasses.dataclass
class _Slot:
    req_id: str
    max_tokens: int
    pages: list  # page ids owned by this request
    emitted: list = dataclasses.field(default_factory=list)
    n_generated: int = 0  # dispatched count (values may still be on device)
    arrived_at: float = 0.0
    prefill_pos: int = 0  # tokens already prefilled (chunked-prefill progress)
    first_token_at: Optional[float] = None
    stop_ids: tuple = ()  # per-request stop tokens (on top of engine eos)
    ignore_eos: bool = False
    # Prompt tokens, kept only when this prompt's pages should enter the
    # prefix cache at retire (miss or partial hit; an exact hit adds nothing).
    prompt_tokens: Optional[np.ndarray] = None
    prompt_len: int = 0
    # (trace_id, parent span id) of a traced or recorded request, and the
    # start (tracing.now()) of its span in progress: prefill, then the wait
    # of its first token.
    trace: Optional[tuple] = None
    span_t: float = 0.0


@dataclasses.dataclass
class _DecodeGraph:
    """One captured paged decode block: the graph, its static token output
    [n, B] (rewritten by each replay), and the K4 and K6 (grouped expert
    GEMM) launches it holds."""
    graph: object  # torch.cuda.CUDAGraph
    toks: torch.Tensor
    k4_launches: int
    moe_launches: int


def _dense_attend(q, k_new, v_new, ck, cv, lengths, window=0):
    """Dense-layout one-token attention of one slot: writes k/v [B,1,KV,Hd]
    at each row's length into its [B, S, KV, Hd] cache slice (in place),
    then einsum attention over the valid prefix (its last ``window`` keys
    when ``window`` > 0) -> o [B, 1, H, Hd]."""
    dt = q.dtype
    B, H, Hd = q.shape[0], q.shape[2], q.shape[3]
    S, KV = ck.shape[1], ck.shape[2]
    rows = torch.arange(B, device=q.device)
    at = lengths.long().clamp(max=S - 1)  # only an empty slot's length can pass S - 1
    ck[rows, at] = k_new[:, 0]
    cv[rows, at] = v_new[:, 0]
    qg = q[:, 0].reshape(B, KV, H // KV, Hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, ck).float() / math.sqrt(Hd)
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos <= lengths[:, None]
    if window:
        valid = valid & (pos > lengths[:, None] - window)
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bkgs,bskh->bkgh", p, cv).reshape(B, 1, H, Hd)


class LLMEngine:
    """Host-side continuous batching over the prefill and decode programs.

    ``device=None`` means the GPU: the constructor raises when no CUDA device
    is visible, and runs on the CPU only when asked (``device="cpu"``)."""

    def __init__(self, cfg: TransformerConfig, params=None,
                 engine_config: EngineConfig | None = None, device=None):
        self.device = torch.device(resolve_device(device, "LLMEngine"))
        self.cfg = cfg
        self.ec = engine_config or EngineConfig()
        if cfg.n_experts and self.ec.tensor_parallel > 1:
            raise ValueError("MoE serving not supported with tensor_parallel > 1: routed experts are served on "
                             "one device")
        check_head_dim(cfg.head_dim, self.device)  # prefill runs K1 on the card
        self.windows = [cfg.layer_window(i) for i in range(cfg.n_layers)]
        if any(self.windows) and self.device.type == "cuda" and (
                cfg.head_dim != WINDOW_HEAD_DIM or cfg.n_heads // cfg.kv_heads != 8):
            raise ValueError(f"sliding layers on the card need head_dim {WINDOW_HEAD_DIM} and 8 query heads per "
                             f"kv head (the window instances of K1 and K4), not {cfg.head_dim} and "
                             f"{cfg.n_heads // cfg.kv_heads}")
        # Tensor-parallel mesh: params shard Megatron-style, KV pools shard by
        # kv_heads; everything else (page tables, lengths, sampling state) is
        # replicated on the first slot's device, so the host scheduler below
        # is layout-oblivious.
        tp = self.ec.tensor_parallel
        self.mesh = None
        if tp > 1:
            from ray_tpu_torch.parallel.mesh import MeshSpec, devices

            devs = devices("cpu" if self.device.type == "cpu" else None)
            if len(devs) < tp:
                raise ValueError(
                    f"tensor_parallel={tp} but only {len(devs)} devices visible "
                    "(gang-schedule the replica with that many GPUs)")
            for dim_name, dim in (("n_heads", cfg.n_heads), ("kv_heads", cfg.kv_heads),
                                  ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)):
                if dim % tp:
                    raise ValueError(f"{dim_name}={dim} not divisible by tensor_parallel={tp}")
            self.mesh = MeshSpec(tensor=tp).build(devs[:tp])
            self.device = devs[0]
        self.slot_devices = self.mesh.slot_devices if self.mesh is not None else [self.device]
        # YaRN's frequencies, made once per device: a decode graph cannot
        # capture their copy from the host.
        self._yarn = None
        if cfg.rope_scaling is not None:
            theta = float(cfg.rope_scaling.get("rope_theta", cfg.rope_theta))
            freqs = yarn_inv_freq(cfg.head_dim, theta, cfg.rope_scaling)
            self._yarn = [freqs.to(d) for d in self.slot_devices]
        if self.ec.max_seq <= 0:
            self.ec = dataclasses.replace(self.ec, max_seq=cfg.max_seq_len)
        S = self.ec.max_seq
        self.paged = self.ec.kv_layout == "paged"
        if self.ec.kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {self.ec.kv_layout!r} (paged|dense)")
        # Decode blocks replay CUDA graphs on one card with the paged layout;
        # the dense layout, tensor parallelism and the CPU stay eager. A
        # caller whose hook must see every token step's call (a replay runs
        # no Python) turns it off on the instance.
        self._graphs_on = self.paged and self.mesh is None and self.device.type == "cuda"
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
        if self.ec.prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires kv_layout='paged'")
        if self.ec.chunked_prefill:
            if not self.paged:
                raise ValueError("chunked_prefill requires kv_layout='paged'")
            if self.ec.chunked_prefill % self.ec.page_size:
                raise ValueError(
                    f"chunked_prefill {self.ec.chunked_prefill} must be a "
                    f"multiple of page_size {self.ec.page_size}"
                )
        if self.paged and self.ec.total_pages <= 0:
            self.ec = dataclasses.replace(self.ec, total_pages=self.ec.max_slots * (S // ps) + 1)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.ec.seed)
            if self.mesh is not None:
                # Init directly sharded: each leaf is split as it is drawn
                # (the draws of init_params, in its order), so the whole tree
                # never sits on one device.
                params = tree_from_leaves((path, self._place(path, leaf))
                                          for path, leaf in iter_init_params(cfg, gen, self.device))
            else:
                params = init_params(cfg, gen, self.device)
        self.set_params(params)
        del params  # a tree drawn here is fp32: free it before the KV pool is allocated
        L = cfg.n_layers
        B = self.ec.max_slots
        dev = self.device

        def _zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        tp = self.ec.tensor_parallel
        KVl = cfg.kv_heads // tp
        if self.paged:
            P_total = self.ec.total_pages
            self.ppseq = S // ps  # page-table width (max pages per sequence)
            # Linear page pool: position (page, offset) lives at page*ps + offset.
            pool_shape = (L, KVl, P_total * ps, cfg.head_dim)
            kv_dim = 1
            self.free_pages: deque = deque(range(1, P_total))  # page 0 = dead sink
        else:
            # Dense per-slot cache (one virtual page of max_seq per slot).
            self.ppseq = 1
            pool_shape = (L, B, S, KVl, cfg.head_dim)
            kv_dim = 3
            self.free_pages = deque()
        # One pool per slot, each its own allocation on its slot's device.
        self._kp = [torch.zeros(pool_shape, dtype=cfg.dtype, device=d) for d in self.slot_devices]
        self._vp = [torch.zeros(pool_shape, dtype=cfg.dtype, device=d) for d in self.slot_devices]
        if self.mesh is None:
            self.k_pages, self.v_pages = self._kp[0], self._vp[0]
        else:
            from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec, ShardedTensor

            spec = PartitionSpec(*(["tensor" if d == kv_dim else None for d in range(len(pool_shape))]))
            full = list(pool_shape)
            full[kv_dim] = cfg.kv_heads
            self.k_pages = ShardedTensor(self._kp, NamedSharding(self.mesh, spec), full)
            self.v_pages = ShardedTensor(self._vp, NamedSharding(self.mesh, spec), full)
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
        # Prefix KV cache: sha1(tokens[:n]) -> {"pages": (...), "prompt_len":
        # n} for every page-aligned prefix n of a retired prompt plus its
        # full length, LRU-ordered. Pages are shared across the chain entries
        # of one prompt and refcounted (_page_refs); a page returns to the
        # free list only when its last referencing entry is evicted.
        self._prefix_cache: OrderedDict[bytes, dict] = OrderedDict()
        self._page_refs: dict[int, int] = {}
        self.prefix_hits = 0
        self.prefix_partial_hits = 0
        self.prefix_misses = 0
        # Work counters (counters() reads them), always on: steps taken and
        # the slots held over them; prefill launches (groups, and each tail
        # or chunk prefill), their real prompt tokens and their launched
        # tokens (rows x bucket: real plus padding); decode blocks and the
        # token steps inside them; decode blocks replayed from a CUDA graph,
        # and graphs captured.
        self.steps = 0
        self.slot_steps = 0
        self.prefill_groups = 0
        self.prefill_real_tokens = 0
        self.prefill_launched_tokens = 0
        self.decode_blocks = 0
        self.decode_token_steps = 0
        self.decode_graph_blocks = 0
        self.decode_graph_captures = 0
        # Routed experts: token-expert rows launched (tokens x top_k, all
        # layers) in prefill and in decode blocks, K6's grouped-GEMM
        # launches, and the device-side count of rows per (layer, expert).
        self.moe_prefill_rows = 0
        self.moe_decode_rows = 0
        self.moe_launches = 0
        self._expert_load = (torch.zeros((L, cfg.n_experts), dtype=torch.int64, device=dev)
                             if cfg.n_experts else None)
        # Slots mid chunked-prefill: slot -> full prompt tokens. Their device
        # length / page-table rows stay zeroed until the last chunk lands (the
        # decode block's writes for them go to dead page 0), so decode
        # interleaves with an unfinished prefill without touching its pages.
        self._prefilling: dict[int, np.ndarray] = {}
        # Context-page buckets of the tail prefill: powers of two up to the
        # page-table width, so its shapes are a small fixed set (the JAX
        # engine compiles one program per (tail bucket, context bucket)).
        cs, c = [], 1
        while c < self.ppseq:
            cs.append(c)
            c *= 2
        self.c_buckets = tuple(sorted(set(cs) | {self.ppseq}))
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
        activation dtype on this engine's device, or, under tensor
        parallelism, resharded onto the engine's layout (a tree of
        ShardedTensors, or of plain tensors split shard by shard). The caller
        must exclude step() for the duration; the KV cache is kept. The
        decode graphs are dropped (they replay against the old weights'
        addresses); the next block of each kind captures anew."""
        from ray_tpu_torch.parallel.sharding import ShardedTensor

        self._graphs: dict[tuple, _DecodeGraph] = {}  # (n, greedy) -> graph
        self._graph_pool = None  # one memory pool for all of them: they never run at once

        if self.mesh is None:
            def whole(t):
                return t.full() if isinstance(t, ShardedTensor) else t

            params = {k: ({n: whole(t) for n, t in v.items()} if k == "layers" else whole(v))
                      for k, v in params.items()}
            self.params = cast_params(params, self.cfg.dtype, self.device)
            self._sp = [self.params]
        else:
            self.params = {
                "embed": self._place(("embed",), params["embed"]),
                "layers": {n: self._place(("layers", n), t) for n, t in params["layers"].items()},
                "final_norm": self._place(("final_norm",), params["final_norm"]),
                "lm_head": self._place(("lm_head",), params["lm_head"]),
            }
            self._sp = [{"embed": self.params["embed"].locals[s],
                         "layers": {n: t.locals[s] for n, t in self.params["layers"].items()},
                         "final_norm": self.params["final_norm"].locals[s],
                         "lm_head": self.params["lm_head"].locals[s]} for s in range(self.mesh.size)]
        # Per slot, per layer: the layer's parameter views. Slots holding the
        # same (replicated) tensors share them, so their work runs once.
        self._sl = [[layer_params(sp, i) for i in range(self.cfg.n_layers)] for sp in self._sp]
        self._layers = self._sl[0]

    def _place(self, path: tuple, leaf):
        """One parameter leaf on the tensor-parallel layout, in the
        activation dtype: each slot's block its own tensor (split from a
        plain tensor block by block, resharded from a ShardedTensor of an
        equivalent mesh, gathered from any other)."""
        from ray_tpu_torch.parallel.sharding import ShardedTensor, ShardingStrategy, device_put

        axes = param_logical_axes(self.cfg)
        for k in path:
            axes = axes[k]
        if isinstance(leaf, ShardedTensor) and leaf.mesh != self.mesh:
            leaf = leaf.full()
        return device_put(leaf.detach(), ShardingStrategy.tp().sharding(self.mesh, axes), dtype=self.cfg.dtype)

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

    def _put(self, mirror, a) -> None:
        """Writes host data into a device mirror in place (a synchronous
        copy, as ``_tensor``'s): the decode graphs read the mirrors at fixed
        addresses, so they are never rebound."""
        mirror.copy_(torch.from_numpy(a))

    def _sample(self, logits, temps, top_ps, top_ks, gen, greedy):
        """Per-row sampling; all-greedy batches (``greedy``, known from the
        host copy of the temperatures) take the argmax directly."""
        with _tracing.phase("llm.engine.sample", rows=logits.shape[0]):
            if greedy:
                return logits.argmax(dim=-1).to(torch.int32)
            return sample_batch(logits, temps, top_ps, top_ks, gen, cap=self.ec.sample_topk_cap)

    # -- per-slot phases (one slot unless tensor-parallel) ------------------
    def _rep(self, t) -> list:
        """``t`` (on the first slot's device) at every slot: one object per
        device."""
        return [t.to(d) for d in self.slot_devices]

    def _residual(self, xs, parts) -> list:
        """x + the row-parallel partials summed over the slots (fp32, in slot
        order); one slot adds its own."""
        return add_psum(xs, parts, "tensor" if self.mesh is not None else (), self.mesh)

    def _embed(self, tok) -> list:
        """Token ids -> the residual stream at every slot. Tensor-parallel:
        each slot looks up the ids of its vocab block (zero elsewhere), then
        the psum."""
        if self.mesh is None:
            return [self.params["embed"][tok]]
        tables = [sp["embed"] for sp in self._sp]
        v0s = [s * t.shape[0] for s, t in enumerate(tables)]
        return vocab_lookup(tables, self._rep(tok), v0s, "tensor", self.mesh, self.cfg.dtype)

    def _attn_in(self, xs, li, poss):
        """Each slot's q, k, v on its own heads, rotated at positions ``poss``
        with layer li's RoPE."""
        theta, scaling = self.cfg.layer_rope(li)
        lps = [sl[li] for sl in self._sl]
        h = _per_slot(lambda x, lp: rms_norm(x, lp["attn_norm"]), xs, lps)
        qkv = [attn_proj(hh, lp) for hh, lp in zip(h, lps)]
        fr = self._yarn if scaling is not None else [None] * len(qkv)
        qs = [rope(t[0], p, theta, scaling, f) for t, p, f in zip(qkv, poss, fr)]
        ks = [rope(t[1], p, theta, scaling, f) for t, p, f in zip(qkv, poss, fr)]
        return qs, ks, [t[2] for t in qkv]

    def _attn_out_ffn(self, xs, li, os, prefill: bool = False) -> list:
        """The rest of layer li from the attention outputs ``os``
        [..., H/tp, Hd]: out projection (psum), FFN (psum); routed experts
        (one slot) through K6, their eager prefill dispatch in the phase
        ``llm.engine.prefill.moe``."""
        lps = [sl[li] for sl in self._sl]
        xs = self._residual(xs, [out_proj(o, lp["wo"]) for o, lp in zip(os, lps)])
        h = _per_slot(lambda x, lp: rms_norm(x, lp["ffn_norm"]), xs, lps)
        if not self.cfg.n_experts:
            return self._residual(xs, [dense_ffn(hh, lp) for hh, lp in zip(h, lps)])
        lp = lps[0]
        rows = h[0].shape[0] * h[0].shape[1] * self.cfg.expert_top_k
        with (_tracing.phase("llm.engine.prefill.moe", rows=rows) if prefill else _NO_PHASE):
            y, counts = _moe.moe_ffn(h[0], lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
                                     self.cfg.expert_top_k)
            self._expert_load[li].add_(counts)
        if y.is_cuda:
            self.moe_launches += _moe.GEMM_LAUNCHES_PER_CALL
        return [xs[0] + y]

    def _head(self, xs, pick, pick_first=True):
        """Final norm and the fp32 logits of the positions ``pick`` selects,
        gathered over the vocab shards on the first slot's device."""
        def norm_pick(x, w):
            return rms_norm(pick(x), w) if pick_first else pick(rms_norm(x, w))

        hs = _per_slot(norm_pick, xs, [sp["final_norm"] for sp in self._sp])
        parts = [linear(h, sp["lm_head"]).float() for h, sp in zip(hs, self._sp)]
        return parts[0] if len(parts) == 1 else torch.cat([p.to(self.device) for p in parts], dim=-1)

    def _paged_attention(self, qs, li, lens, page_tables):
        """K4 per slot (the op's ``mesh`` branch under tensor parallelism)
        over each slot's own pool at layer li -> per-slot o [B, H/tp, Hd]."""
        ps = self.ec.page_size
        Hd = self.cfg.head_dim
        kps = [kp[li].view(kp.shape[1], -1, ps, Hd) for kp in self._kp]
        vps = [vp[li].view(vp.shape[1], -1, ps, Hd) for vp in self._vp]
        q1 = [q[:, 0] for q in qs]
        if self.mesh is None:
            return [paged_attention(q1[0], kps[0], vps[0], lens, page_tables, window=self.windows[li])]
        from ray_tpu_torch.parallel.sharding import PartitionSpec as P
        from ray_tpu_torch.parallel.sharding import from_locals

        pool = P("tensor", None, None, None)
        o = paged_attention(from_locals(q1, self.mesh, P(None, "tensor", None)), from_locals(kps, self.mesh, pool),
                            from_locals(vps, self.mesh, pool), lens, page_tables, mesh=self.mesh,
                            window=self.windows[li])
        return o.locals

    def _prefill_logits(self, tokens, lengths, third):
        """k prompts of one length bucket as one batch: writes their K/V
        into the cache and returns the last real position's logits [k, V]
        (fp32). tokens: [k, P] (padded to the bucket); lengths: [k];
        ``third`` is the placement input: page rows [k, P // ps] (paged;
        trailing entries 0 = dead sink) or slot ids [k] (dense)."""
        cfg = self.cfg
        k, P = tokens.shape
        Hd = cfg.head_dim
        tok = self._tensor(tokens, torch.long)
        lens = self._tensor(lengths, torch.long)
        xs = self._embed(tok)  # [k, P, D] per slot
        pos = torch.arange(P, dtype=torch.int32, device=self.device).expand(k, P)
        seg = (pos >= lens[:, None]).to(torch.int32)  # pads = their own segment
        poss, segs = self._rep(pos), self._rep(seg)
        # Paged: [k * P] pool rows, page chunk by page chunk; dense: slot ids.
        places = self._rep(self._pool_rows(third) if self.paged else self._tensor(third, torch.long))
        for li in range(cfg.n_layers):
            qs, ks, vs = self._attn_in(xs, li, poss)
            os = [flash_attention(q, kk, v, causal=True, segment_ids=sg, window=self.windows[li])
                  for q, kk, v, sg in zip(qs, ks, vs, segs)]
            for s, (kk, v) in enumerate(zip(ks, vs)):
                KVl = kk.shape[2]
                if self.paged:
                    # [k, P, KV, Hd] -> [KV, k * P, Hd]; scatter page chunks into the pool.
                    self._kp[s][li].index_copy_(1, places[s], kk.permute(2, 0, 1, 3).reshape(KVl, k * P, Hd))
                    self._vp[s][li].index_copy_(1, places[s], v.permute(2, 0, 1, 3).reshape(KVl, k * P, Hd))
                else:
                    self._kp[s][li][places[s], :P] = kk
                    self._vp[s][li][places[s], :P] = v
            xs = self._attn_out_ffn(xs, li, os, prefill=True)
        return self._head(xs, lambda x: x[torch.arange(k, device=x.device), lens.to(x.device) - 1])

    def _prefill_batch_impl(self, tokens, lengths, third, gen, idxs):
        """Prefill one group and sample each request's first token -> [k]
        int32 on the device (not fetched)."""
        logits = self._prefill_logits(tokens, lengths, third)
        temps = self.samp_temps[idxs]
        return self._sample(
            logits, self._tensor(temps), self._tensor(self.samp_top_ps[idxs]),
            self._tensor(self.samp_top_ks[idxs]), gen, bool((temps <= 0.0).all()),
        )

    def _pool_rows(self, pages):
        """Linear pool rows of whole pages, page by page: page * ps + [0, ps)."""
        ps = self.ec.page_size
        return self._tensor((np.asarray(pages, np.int64)[..., None] * ps + np.arange(ps)).reshape(-1))

    def _copy_pages(self, src_pages, dst_pages) -> None:
        """Copies whole pages src -> dst, K and V, across all layers at once
        (every slot's pool: the copy slices the token axis, the sharded KV
        heads ride along). Everything runs on one stream per device, so the
        copy is enqueued before any later write to either page set and reads
        their bytes as they stand now, even when the source pages are
        recycled by the next admission."""
        src, dst = self._pool_rows(src_pages), self._pool_rows(dst_pages)
        for pool in self._kp + self._vp:  # [L, KV/tp, P_total * ps, Hd]
            pool.index_copy_(2, dst.to(pool.device), pool.index_select(2, src.to(pool.device)))

    def _tail_prefill_logits(self, tokens, start, length, ctx_pages, tail_pages):
        """Prefill over a cached prefix: the prompt's first ``start`` tokens
        (page-aligned) already sit in the pages ``ctx_pages``; only the tail
        is embedded and projected here. Its K/V scatter into ``tail_pages``;
        its queries attend to the context pages gathered from the pool plus,
        causally, to the tail itself. Returns the fp32 logits [1, V] at
        position ``length - 1`` (row ``length - 1 - start``).

        tokens: [Tb] padded tail; ctx_pages: [C] (entries past start // ps
        are 0, masked by position < start); tail_pages: [Tb // ps] (trailing
        0 = dead sink, which only masked reads ever see)."""
        cfg = self.cfg
        ps = self.ec.page_size
        Tb, C = len(tokens), len(ctx_pages)
        Hd = cfg.head_dim
        group = cfg.n_heads // cfg.kv_heads
        dev = self.device
        xs = self._embed(self._tensor(tokens, torch.long)[None])  # [1, Tb, D] per slot
        tpos = torch.arange(Tb, device=dev)
        pos = (start + tpos)[None]  # [1, Tb] absolute positions
        # Key validity [Tb, C*ps + Tb]: context keys below start (always at or
        # before any query), tail keys causal within the tail and real
        # (before length). One mask for all heads; a sliding layer's also
        # drops the keys at or before query position - window.
        cpos = torch.arange(C * ps, device=dev)
        ctx_valid = (cpos < start)[None, :].expand(Tb, C * ps)
        tail_valid = (tpos[None, :] <= tpos[:, None]) & ((start + tpos)[None, :] < length)
        mask = torch.cat([ctx_valid, tail_valid], dim=1)[:, None, None, :]
        poss, masks = self._rep(pos), {0: self._rep(mask)}
        for w in set(self.windows) - {0}:
            qpos = (start + tpos)[:, None]
            near = torch.cat([cpos[None, :] > qpos - w, (start + tpos)[None, :] > qpos - w], dim=1)
            masks[w] = self._rep(mask & near[:, None, None, :])
        ctx_rows, tail_rows = self._rep(self._pool_rows(ctx_pages)), self._rep(self._pool_rows(tail_pages))
        for li in range(cfg.n_layers):
            qs, ks, vs = self._attn_in(xs, li, poss)
            os = []
            for s, (q, k, v) in enumerate(zip(qs, ks, vs)):
                KVl, Hl = k.shape[2], q.shape[2]
                kt, vt = k[0].transpose(0, 1), v[0].transpose(0, 1)  # [KV, Tb, Hd]
                kp, vp = self._kp[s][li], self._vp[s][li]  # [KV, P_total * ps, Hd]
                kp.index_copy_(1, tail_rows[s], kt)
                vp.index_copy_(1, tail_rows[s], vt)
                kall = torch.cat([kp.index_select(1, ctx_rows[s]), kt], dim=1)  # [KV, C*ps + Tb, Hd]
                vall = torch.cat([vp.index_select(1, ctx_rows[s]), vt], dim=1)
                qg = q[0].reshape(Tb, KVl, group, Hd)
                scores = torch.einsum("tkgh,ksh->tkgs", qg, kall).float() / math.sqrt(Hd)
                scores = scores.masked_fill(~masks[self.windows[li]][s], -1e30)
                p = torch.softmax(scores, dim=-1).to(q.dtype)
                os.append(torch.einsum("tkgs,ksh->tkgh", p, vall).reshape(1, Tb, Hl, Hd))
            xs = self._attn_out_ffn(xs, li, os, prefill=True)
        return self._head(xs, lambda x: x[:, length - 1 - start])  # [1, V]

    def _tail_args(self, row, tokens, start, n_tok):
        """Tail prefill inputs for tokens[start:start + n_tok] of a request
        whose pages are the page-table row ``row``: the tail padded to the
        smallest bucket that holds it, the context pages (the row's first
        start // ps) padded to a context bucket (at least 1), and the row's
        pages that the tail fills (zeros past the table: dead sink).
        Returns (padded, ctx_pages, tail_pages)."""
        ps = self.ec.page_size
        tb = next(b for b in self.buckets if b >= n_tok)
        j = start // ps
        C = next(c for c in self.c_buckets if c >= max(j, 1))
        padded = np.zeros(tb, np.int32)
        padded[:n_tok] = tokens[start:start + n_tok]
        ctx = np.zeros(C, np.int32)
        ctx[:j] = row[:j]
        tpg = np.zeros(tb // ps, np.int32)
        m = min(len(tpg), self.ppseq - j)
        tpg[:m] = row[j:j + m]
        return padded, ctx, tpg

    def _tail_prefill_impl(self, tokens, start, length, ctx_pages, tail_pages, gen, i):
        """Tail prefill for slot i and its sampled token -> [1] int32 on the
        device (not fetched)."""
        logits = self._tail_prefill_logits(tokens, start, length, ctx_pages, tail_pages)
        s = slice(i, i + 1)
        return self._sample(
            logits, self._tensor(self.samp_temps[s]), self._tensor(self.samp_top_ps[s]),
            self._tensor(self.samp_top_ks[s]), gen, bool(self.samp_temps[i] <= 0.0),
        )

    def _decode_impl(self, last_tokens, lengths, page_tables, n_steps, gen, temps, top_ps, top_ks, greedy):
        """n_steps tokens for every slot, paged layout; each token step
        writes its tokens into ``last_tokens`` and advances ``lengths`` in
        place. Returns (toks [n_steps, B], last_tokens, lengths), all on the
        device. The body the decode graphs capture."""
        cfg = self.cfg
        ps = self.ec.page_size
        B = page_tables.shape[0]
        rows = torch.arange(B, device=self.device)
        out = []
        for _ in range(n_steps):
            xs = self._embed(last_tokens.long()[:, None])  # [B, 1, D] per slot
            # Linear write position per slot: its page for len, plus offset.
            # (An empty slot's length may run past the table; its row is all
            # page 0, so the clamp only keeps the index in range.)
            col = (lengths // ps).clamp(max=self.ppseq - 1).long()
            lins = self._rep((page_tables[rows, col] * ps + lengths % ps).long())  # [B]
            poss = self._rep(lengths[:, None])
            for li in range(cfg.n_layers):
                qs, ks, vs = self._attn_in(xs, li, poss)
                for s, (k_new, v_new) in enumerate(zip(ks, vs)):
                    self._kp[s][li][:, lins[s]] = k_new[:, 0].transpose(0, 1)  # [KV, B, Hd]
                    self._vp[s][li][:, lins[s]] = v_new[:, 0].transpose(0, 1)
                os = self._paged_attention(qs, li, lengths + 1, page_tables)  # [B, H, Hd] per slot
                xs = self._attn_out_ffn(xs, li, [o[:, None] for o in os])
            logits = self._head(xs, lambda x: x[:, 0], pick_first=False)
            out.append(self._sample(logits, temps, top_ps, top_ks, gen, greedy))
            last_tokens.copy_(out[-1])
            lengths.add_(1)
        return torch.stack(out), last_tokens, lengths

    def _decode_impl_dense(self, last_tokens, lengths, n_steps, gen, temps, top_ps, top_ks, greedy):
        """Dense layout: n_steps for every slot; attention is the einsum over
        each slot's contiguous [S] row. Writes and returns the mirrors as
        ``_decode_impl`` does."""
        cfg = self.cfg
        out = []
        for _ in range(n_steps):
            xs = self._embed(last_tokens.long()[:, None])  # [B, 1, D] per slot
            lenss = self._rep(lengths)
            poss = self._rep(lengths[:, None])
            for li in range(cfg.n_layers):
                qs, ks, vs = self._attn_in(xs, li, poss)
                os = [_dense_attend(q, k, v, self._kp[s][li], self._vp[s][li], lenss[s], self.windows[li])
                      for s, (q, k, v) in enumerate(zip(qs, ks, vs))]
                xs = self._attn_out_ffn(xs, li, os)
            logits = self._head(xs, lambda x: x[:, 0], pick_first=False)
            out.append(self._sample(logits, temps, top_ps, top_ks, gen, greedy))
            last_tokens.copy_(out[-1])
            lengths.add_(1)
        return torch.stack(out), last_tokens, lengths

    def _decode_eager(self, n, gen, greedy):
        if self.paged:
            return self._decode_impl(
                self.d_last, self.d_lengths, self.d_page_tables, n, gen,
                self.d_temps, self.d_top_ps, self.d_top_ks, greedy,
            )
        return self._decode_impl_dense(
            self.d_last, self.d_lengths, n, gen, self.d_temps, self.d_top_ps, self.d_top_ks, greedy,
        )

    def _decode(self, n, gen):
        """One decode block of n token steps for every slot -> (toks [n, B],
        d_last, d_lengths), on the device; the mirrors advance in place.

        With decode graphs on (one CUDA device, paged layout) the block
        replays the graph of its kind: n, and whether every slot is greedy
        (the host copy of the temperatures, as ``_sample`` decides). The
        first block of a kind runs eagerly, which sets up every kernel,
        library handle and buffer the body touches, and then captures it
        (``warmup`` captures every kind). A sampled block that draws from
        another generator than the engine's stays eager."""
        greedy = bool((self.samp_temps <= 0.0).all())
        if not (self._graphs_on and (greedy or gen is self._gen)):
            return self._decode_eager(n, gen, greedy)
        block = self._graphs.get((n, greedy))
        if block is None:
            out = self._decode_eager(n, gen, greedy)
            self._capture(n, greedy)
            return out
        block.graph.replay()
        _k4.LAUNCHES += block.k4_launches
        _moe.LAUNCHES += block.moe_launches
        self.moe_launches += block.moe_launches
        self.decode_graph_blocks += 1
        return block.toks, self.d_last, self.d_lengths

    def _capture(self, n: int, greedy: bool) -> None:
        """Captures the paged decode block of n token steps at B =
        max_slots, greedy or drawing from the engine's generator (whose
        state the graph registers, so each replay advances its stream).
        Capturing runs nothing: the engine's state is unchanged. The K4 and
        K6 launches the capture recorded are taken back out of
        ``paged_attention.LAUNCHES`` and ``moe.LAUNCHES`` (and the engine's
        counters); each replay adds them. Thread-local
        capture: the server's callers may touch the card from other
        threads meanwhile. The garbage collector pauses during the capture:
        a collection there could destroy an unreachable engine's graphs,
        which invalidates the capture."""
        graph = torch.cuda.CUDAGraph()
        if not greedy:
            graph.register_generator_state(self._gen)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        before, collecting = _k4.LAUNCHES, gc.isenabled()
        counted = (_moe.LAUNCHES, self.moe_launches)
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool, capture_error_mode="thread_local"):
                toks = self._decode_eager(n, self._gen, greedy)[0]
        finally:
            launches, _k4.LAUNCHES = _k4.LAUNCHES - before, before
            moe_launches = _moe.LAUNCHES - counted[0]
            _moe.LAUNCHES, self.moe_launches = counted
            if collecting:
                gc.enable()
        self._graphs[(n, greedy)] = _DecodeGraph(graph, toks, launches, moe_launches)
        self.decode_graph_captures += 1

    @torch.no_grad()
    def warmup(self, buckets=None, k_values=None):
        """Runs every (bucket, k) prefill shape and both decode block sizes
        once before serving (against the dead page), so first-call costs
        (kernel builds, library handles, allocator growth) stay out of the
        first requests' TTFT; with decode graphs on, captures the graph of
        every block size, greedy and sampled; then resets the device mirrors
        it dirtied."""
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
        # The runs above are greedy and take _sample's argmax shortcut: run
        # the sampler itself at every batch it is handed (prefill groups,
        # decode slots), or the first sampled request pays the first use of
        # its kernels in its TTFT.
        for k in sorted(set(k_values) | {self.ec.max_slots}):
            ones = torch.ones(k, dtype=torch.float32, device=self.device)
            logits = torch.zeros(k, self.cfg.vocab_size, dtype=torch.float32, device=self.device)
            top_ks = torch.full((k,), 2, dtype=torch.int32, device=self.device)
            sample_batch(logits, ones, ones / 2, top_ks, gen, cap=self.ec.sample_topk_cap).cpu()
        if self._graphs_on:
            for n in self.block_sizes:
                for greedy in (True, False):
                    if (n, greedy) not in self._graphs:
                        self._capture(n, greedy)
        if self.paged and self.ec.prefix_cache:
            self._copy_pages([0], [0])  # the prefix cache's page copy, dead page onto itself
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
        # The caller's trace (or a fresh one while recording), and when it queued.
        trace = _tracing.request_trace()
        if trace is not None:
            trace = (trace[0], trace[1], _tracing.now())
        self.waiting.append((req_id, np.asarray(tokens, np.int32), sampling, time.perf_counter(), trace))

    def abort(self, req_id: str) -> None:
        """Drop a request whose consumer went away: dequeue it, or free its
        slot so decode stops spending steps on it. Call from the stepping
        thread only (mutates scheduler state + device mirrors)."""
        self.waiting = deque(w for w in self.waiting if w[0] != req_id)
        for i, s in enumerate(self.slots):
            if s is not None and s.req_id == req_id:
                self._retire(i)
                self._put(self.d_lengths, self._masked_lengths())
                self._put(self.d_page_tables, self._masked_page_tables())
                break

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def _prefix_digests(self, tokens) -> list:
        """(covered_len, digest) pairs for every page-aligned prefix of the
        prompt plus the full prompt, from one incremental sha1 pass.
        Ascending; lookups probe in reverse (longest first)."""
        ps = self.ec.page_size
        buf = np.ascontiguousarray(tokens, dtype=np.int32)
        h = hashlib.sha1()
        out = []
        j = 0
        while (j + 1) * ps <= len(buf):
            h.update(buf[j * ps:(j + 1) * ps].tobytes())
            j += 1
            out.append((j * ps, h.copy().digest()))
        if len(buf) % ps:
            h.update(buf[j * ps:].tobytes())
            out.append((len(buf), h.digest()))
        return out

    def _cache_insert(self, slot: _Slot) -> set:
        """Moves a retired slot's prompt pages into the prefix cache: one
        entry per page-aligned prefix plus the full prompt, sharing and
        refcounting the pages. Where a shorter prefix is already cached (a
        partial hit retiring), the new longer entries reference that entry's
        pages for the shared span and the slot's own copies of them are
        freed, so N requests extending one system prompt hold one copy of
        it. Returns the slot pages the cache now owns; the caller frees the
        rest."""
        ps = self.ec.page_size
        slot_pages = set(slot.pages)
        used: set = set()
        base: tuple = ()  # longest already-cached page run for this prefix
        for n, dg in self._prefix_digests(slot.prompt_tokens):
            n_pg = -(-n // ps)
            if n_pg > len(slot.pages):
                break
            existing = self._prefix_cache.get(dg)
            if existing is not None:
                self._prefix_cache.move_to_end(dg)
                if len(existing["pages"]) >= len(base):
                    base = tuple(existing["pages"])
                continue
            pages = base + tuple(slot.pages[len(base):n_pg])
            self._prefix_cache[dg] = {"pages": pages, "prompt_len": n}
            for p in pages:
                self._page_refs[p] = self._page_refs.get(p, 0) + 1
            used.update(pages)
            base = pages
        return used & slot_pages

    def _evict_prefix_cache(self, need_pages: int, protect: frozenset = frozenset()) -> None:
        """LRU-evicts cache entries until need_pages pages are back in the
        free list (admission beats cached prefixes). A page shared by several
        chain entries frees only when its last referencing entry goes.
        ``protect`` exempts the entry the current admission is about to hit."""
        while need_pages > 0:
            victim = next((k for k in self._prefix_cache if k not in protect), None)
            if victim is None:
                return
            entry = self._prefix_cache.pop(victim)
            for p in entry["pages"]:
                self._page_refs[p] -= 1
                if not self._page_refs[p]:
                    del self._page_refs[p]
                    self.free_pages.append(p)
                    need_pages -= 1

    def counters(self) -> dict:
        """A snapshot of the work counters (see __init__); a reader takes
        the difference of two."""
        return {k: getattr(self, k) for k in (
            "steps", "slot_steps", "prefill_groups", "prefill_real_tokens",
            "prefill_launched_tokens", "decode_blocks", "decode_token_steps",
            "decode_graph_blocks", "decode_graph_captures", "moe_prefill_rows",
            "moe_decode_rows", "moe_launches")}

    def expert_load(self):
        """The rows each expert of each layer has received, [L, E] int64 on
        the host (one copy from the device; None without experts). Every
        prefill and decode block adds its rows, the dead slots' included."""
        return None if self._expert_load is None else self._expert_load.cpu()

    def _prefill_dispatch(self, bucket: int, rows: int, real: int):
        """Counts one prefill launch of ``rows`` x ``bucket`` tokens holding
        ``real`` prompt tokens, and opens its phase."""
        self.prefill_groups += 1
        self.prefill_real_tokens += real
        self.prefill_launched_tokens += rows * bucket
        if self.cfg.n_experts:
            self.moe_prefill_rows += rows * bucket * self.cfg.expert_top_k * self.cfg.n_layers
        return _tracing.phase("llm.engine.prefill.dispatch", bucket=bucket, rows=rows, real_tokens=real)

    @property
    def prefix_cache_stats(self) -> dict:
        return {
            "hits": self.prefix_hits,
            "partial_hits": self.prefix_partial_hits,
            "misses": self.prefix_misses,
            "entries": len(self._prefix_cache),
            "cached_pages": len(self._page_refs),  # distinct pages held
        }

    def _retire(self, i: int) -> None:
        """Free slot i's pages and zero its table row (dead slots must write
        only into page 0 while they keep decoding inside a block). With the
        prefix cache on, an uncached prompt's pages move into the cache
        instead of the free list."""
        slot = self.slots[i]
        if slot is not None:
            kept: set = set()
            if slot.prompt_tokens is not None and self.paged and i not in self._prefilling:
                # A half-prefilled prompt never enters the prefix cache: its
                # later pages hold no KV yet.
                kept = self._cache_insert(slot)
            self.free_pages.extend(p for p in slot.pages if p not in kept)
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
        "finished": bool, "ttft_s": float|None, "tokens": [..] when done}}.

        ``ttft_s`` is the first token on the host: from ``add_request`` to
        the fetch of the prefill group (or decode block) that made it; step()
        returns it after the step's decode block.

        Each part of the step is a ``tracing.phase`` (``llm.engine.step``,
        ``.admit``, ``.prefill.dispatch``, ``.prefill.fetch``,
        ``.decode.dispatch``, ``.decode.fetch``, ``.emit``; ``.sample``
        inside the dispatches); a traced or recorded request records
        ``llm.request.queue``, ``.prefill`` and ``.first_token_wait``."""
        with _tracing.phase("llm.engine.step") as step_phase:
            events: dict[str, dict] = {}
            retired = False
            ps = self.ec.page_size
            # 1. admit: page-budgeted assignment of waiting requests to free slots.
            admitted: list[tuple[int, str, np.ndarray, int, int, float]] = []
            cache_hits: list[tuple[int, int]] = []  # (slot, last prompt token)
            tail_admitted: list[tuple[int, str, np.ndarray, int, int, float]] = []
            firsts: list[tuple[tuple, float, str]] = []  # traced first tokens: (trace, fetched at, req)
            use_cache = self.paged and self.ec.prefix_cache
            use_chunked = self.paged and self.ec.chunked_prefill > 0
            chunk_size = self.ec.chunked_prefill
            n_admitted, blocked = 0, False
            with _tracing.phase("llm.engine.admit") as admit_phase:
                for i in range(self.ec.max_slots):
                    if not self.waiting or self.slots[i] is not None:
                        continue
                    req_id, tokens, sp, arrived, trace = self.waiting[0]
                    P = len(tokens)
                    need = self._pages_needed(P, sp.max_tokens)
                    # Cache lookup before eviction, longest match first: the full
                    # prompt (exact hit), then page-aligned prefixes (partial hit).
                    hit_dg = hit_entry = None
                    hit_len = 0
                    if use_cache:
                        for n, dg in reversed(self._prefix_digests(tokens)):
                            e = self._prefix_cache.get(dg)
                            if e is not None and e["prompt_len"] == n and (n == P or n % ps == 0):
                                hit_dg, hit_entry, hit_len = dg, e, n
                                break
                    if need > len(self.free_pages):
                        self._evict_prefix_cache(
                            need - len(self.free_pages),
                            protect=frozenset((hit_dg,)) if hit_dg is not None else frozenset(),
                        )
                    if need > len(self.free_pages):
                        # If nothing is running (no retire will ever free pages) and
                        # the only reclaimable pages are the would-be hit's own,
                        # degrade to a miss rather than stall the queue forever.
                        if hit_dg is not None and not any(s is not None for s in self.slots):
                            hit_dg = hit_entry = None
                            self._evict_prefix_cache(need - len(self.free_pages))
                        if need > len(self.free_pages):
                            blocked = True
                            break  # head-of-line blocks until pages free (FIFO fairness)
                    self.waiting.popleft()
                    n_admitted += 1
                    pages = [self.free_pages.popleft() for _ in range(need)]
                    exact = hit_entry is not None and hit_len == P
                    self.slots[i] = _Slot(
                        req_id=req_id, max_tokens=sp.max_tokens, pages=pages,
                        n_generated=0 if exact else 1, arrived_at=arrived,
                        stop_ids=tuple(sp.stop_token_ids), ignore_eos=sp.ignore_eos,
                        prompt_tokens=tokens if (use_cache and not exact) else None,
                        prompt_len=P,
                    )
                    if trace is not None:
                        t = _tracing.now()
                        _tracing.record_span("llm.request.queue", trace, trace[2], t, request=req_id)
                        self.slots[i].trace, self.slots[i].span_t = trace, t
                    self.samp_temps[i] = sp.temperature
                    self.samp_top_ps[i] = sp.top_p
                    self.samp_top_ks[i] = sp.top_k
                    row = np.zeros(self.ppseq, np.int32)
                    row[: len(pages)] = pages
                    self.page_tables[i] = row
                    self.lengths[i] = P
                    if hit_entry is not None:
                        # Copy the matched pages into this request's own pages now,
                        # before a later admission of this step can evict the entry
                        # and recycle its pages.
                        self._prefix_cache.move_to_end(hit_dg)
                        n_pp = len(hit_entry["pages"])
                        self._copy_pages(hit_entry["pages"], pages[:n_pp])
                        if exact:
                            # Decode from position P-1: the block re-derives that
                            # position's KV and emits the first token; no prefill.
                            self.prefix_hits += 1
                            self.lengths[i] = P - 1
                            cache_hits.append((i, int(tokens[-1])))
                        elif use_chunked and P - hit_len > chunk_size:
                            # A long tail chunks too, starting at the cached prefix.
                            self.prefix_partial_hits += 1
                            self.slots[i].n_generated = 0
                            self.slots[i].prefill_pos = hit_len
                            self._prefilling[i] = tokens
                        else:
                            # Prefill only the tail over the cached context.
                            self.prefix_partial_hits += 1
                            tail_admitted.append((i, req_id, tokens, hit_len, sp.max_tokens, arrived))
                        continue
                    if use_cache:
                        self.prefix_misses += 1
                    if use_chunked and P > chunk_size:
                        # One chunk per step, interleaved with the decode blocks.
                        self.slots[i].n_generated = 0
                        self.slots[i].prefill_pos = 0
                        self._prefilling[i] = tokens
                    else:
                        bucket = next(b for b in self.buckets if b >= P)
                        admitted.append((i, req_id, tokens, bucket, sp.max_tokens, arrived))
                admit_phase.set(admitted=n_admitted, blocked_on_pages=blocked)
            held = sum(1 for s in self.slots if s is not None)
            self.steps += 1
            self.slot_steps += held
            step_phase.set(admitted=n_admitted, slots=held)
            if cache_hits:
                idx_t = self._tensor([h[0] for h in cache_hits], torch.long)
                self.d_lengths[idx_t] = self._tensor([int(self.lengths[h[0]]) for h in cache_hits], torch.int32)
                self.d_last[idx_t] = self._tensor([h[1] for h in cache_hits], torch.int32)
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
                    with self._prefill_dispatch(bucket, k, sum(len(it[2]) for it in chunk)):
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
            # Partial prefix hits: one tail prefill each over the cached context.
            for (i, req_id, tokens, start, mt, arrived) in tail_admitted:
                P = len(tokens)
                padded, ctx, tpg = self._tail_args(self.page_tables[i], tokens, start, P - start)
                with self._prefill_dispatch(len(padded), 1, P - start):
                    toks_dev = self._tail_prefill_impl(padded, start, P, ctx, tpg, self._gen, i)
                    self.d_lengths[i] = P
                    self.d_last[i] = toks_dev[0]
                dispatched.append(([(i, req_id, tokens, None, mt, arrived)], toks_dev))
            # 2c. chunked prefill: every mid-prefill slot advances by one chunk, so
            # decode stalls by at most one chunk per unfinished prefill per step.
            # The last chunk samples the request's first token and installs the
            # slot's device rows (until then they stay zeroed: decode writes for
            # it land in dead page 0).
            chunk_dispatched = bool(self._prefilling)
            for i in sorted(self._prefilling):
                slot = self.slots[i]
                tokens = self._prefilling[i]
                P = len(tokens)
                start = slot.prefill_pos
                n_tok = min(chunk_size, P - start)
                padded, ctx, tpg = self._tail_args(self.page_tables[i], tokens, start, n_tok)
                with self._prefill_dispatch(len(padded), 1, n_tok):
                    if start + n_tok < P:
                        # An intermediate chunk: all its tokens are real, so it masks
                        # at its own end; nothing is sampled.
                        self._tail_prefill_logits(padded, start, start + n_tok, ctx, tpg)
                        slot.prefill_pos = start + n_tok
                        continue
                    toks_dev = self._tail_prefill_impl(padded, start, P, ctx, tpg, self._gen, i)
                del self._prefilling[i]
                slot.prefill_pos = P
                slot.n_generated = 1
                self.d_lengths[i] = P
                self.d_last[i] = toks_dev[0]
                dispatched.append(([(i, slot.req_id, tokens, None, slot.max_tokens, slot.arrived_at)], toks_dev))
            if admitted or cache_hits or tail_admitted or chunk_dispatched:
                self._put(self.d_page_tables, self._masked_page_tables())
                self._put(self.d_temps, self.samp_temps)
                self._put(self.d_top_ps, self.samp_top_ps)
                self._put(self.d_top_ks, self.samp_top_ks)
            # Fetch per group, in dispatch order.
            for chunk, toks_dev in dispatched:
                with _tracing.phase("llm.engine.prefill.fetch", rows=len(chunk)):
                    group_toks = toks_dev.tolist()
                    now = time.perf_counter()
                    for (i, req_id, _tokens, _b, _mt, arrived), tok in zip(chunk, group_toks):
                        slot = self.slots[i]
                        slot.first_token_at = now
                        if slot.trace is not None:
                            firsts.append(self._first_token_traced(slot))
                        slot.emitted.append(tok)
                        events[req_id] = {
                            "token": tok,
                            "new_tokens": [tok],
                            "finished": False,
                            "ttft_s": now - arrived,
                        }
                        retired |= self._maybe_finish(i, events)
            # 3. decode: one block over all slots. Queue pressure shrinks the
            # block so the next admission wave starts sooner. Slots mid chunked
            # prefill ride along masked (writes to dead page 0, tokens dropped)
            # but do not drive the block's budget arithmetic.
            active = [i for i, s in enumerate(self.slots)
                      if s is not None and i not in self._prefilling]
            toks = None
            n = 0
            if active:
                remaining = [self.slots[i].max_tokens - self.slots[i].n_generated for i in active]
                positive = [r for r in remaining if r > 0]
                cap = self.ec.max_seq - 1 - int(max(self.lengths[i] for i in active))
                if positive and cap > 0:
                    # Short block under queue pressure, or while any slot still
                    # owes its first token (an exact prefix hit gets it from this
                    # block; a full block would delay it by block_size steps).
                    awaiting_first = bool(self._prefilling) or any(
                        not self.slots[i].emitted for i in active)
                    block = (self.block_sizes[0] if (self.waiting or awaiting_first)
                             else self.block_sizes[-1])
                    # Snap DOWN to a block size that fits: an oversized block
                    # advances lengths past max_seq - 1 and would overwrite the
                    # longest slot's earlier KV.
                    fits = [b for b in self.block_sizes if b <= min(block, cap)]
                    if fits:
                        n = fits[-1]
                        self.decode_blocks += 1
                        self.decode_token_steps += n
                        self.moe_decode_rows += n * self.ec.max_slots * self.cfg.expert_top_k * (
                            self.cfg.n_layers if self.cfg.n_experts else 0)
                        replays = self.decode_graph_blocks
                        with _tracing.phase("llm.engine.decode.dispatch", n=n, slots=len(active)) as dph:
                            toks = self._decode(n, self._gen)[0]
                            dph.set(graph=int(self.decode_graph_blocks > replays))
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
                with _tracing.phase("llm.engine.decode.fetch", n=n):
                    block_toks = toks.cpu().numpy()  # [n, B]
            with _tracing.phase("llm.engine.emit") as emit_phase:
                emitted = 0
                for step_i in range(n if toks is not None else 0):
                    for i in active:
                        slot = self.slots[i]
                        if slot is None or len(slot.emitted) >= slot.n_generated:
                            continue  # finished, or this block overshot its budget
                        tok = int(block_toks[step_i, i])
                        self.lengths[i] += 1
                        slot.emitted.append(tok)
                        emitted += 1
                        ev = events.setdefault(slot.req_id, {"finished": False, "ttft_s": None})
                        if slot.first_token_at is None:
                            # An exact prefix hit's first token comes out of the block.
                            slot.first_token_at = time.perf_counter()
                            ev["ttft_s"] = slot.first_token_at - slot.arrived_at
                            if slot.trace is not None:
                                firsts.append(self._first_token_traced(slot))
                        ev["token"] = tok
                        ev.setdefault("new_tokens", []).append(tok)
                        retired |= self._maybe_finish(i, events)
                if retired:
                    # Re-sync device mirrors so retired slots stop advancing their
                    # (now meaningless) lengths toward max_seq, and their writes land
                    # in the dead page. Mid-prefill slots stay masked.
                    self._put(self.d_lengths, self._masked_lengths())
                    self._put(self.d_page_tables, self._masked_page_tables())
                    last = np.zeros(self.ec.max_slots, np.int32)
                    for i, s in enumerate(self.slots):
                        if s is not None and s.emitted:
                            last[i] = s.emitted[-1]
                    self._put(self.d_last, last)
                emit_phase.set(tokens=emitted)
            if firsts:
                t = _tracing.now()
                for trace, fetched, req_id in firsts:
                    _tracing.record_span("llm.request.first_token_wait", trace, fetched, t, request=req_id)
        return events

    def _first_token_traced(self, slot: _Slot) -> tuple:
        """Ends a traced request's prefill span at its first token's fetch;
        returns what ends its first-token wait when step() returns."""
        t = _tracing.now()
        _tracing.record_span("llm.request.prefill", slot.trace, slot.span_t, t, request=slot.req_id)
        return slot.trace, t, slot.req_id

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
        # No-op unless a trace is active in this thread.
        with _tracing.child_span("llm.engine.generate", max_tokens=max_tokens):
            self.add_request(req_id, tokens, max_tokens, sampling=sampling)
            ttft = None
            while True:
                events = self.step()
                ev = events.get(req_id)
                if ev and ev.get("ttft_s") is not None:
                    ttft = ev["ttft_s"]
                if ev and ev.get("finished"):
                    return {"tokens": ev["tokens"], "ttft_s": ttft}
