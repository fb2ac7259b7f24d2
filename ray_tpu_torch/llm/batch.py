"""LLM batch inference over Datasets: the engine as a stateful Data stage.

Counterpart of ``ray_tpu/llm/batch.py`` (the reference's vLLMEngineStage:
the engine runs inside actor-pool UDFs, so the model loads once per actor
and blocks of prompts stream through). ``_EngineUDF`` is constructed once
per pool actor (it loads the engine and the tokenizer), then called on a
block of rows; every row of a block is admitted to the engine's
continuous-batching loop TOGETHER, so the block shares prefill groups and
decode blocks. ``batch_generate`` is the actor-pool ``map_batches`` of
``ray_tpu_torch.data`` over it.
"""
from __future__ import annotations

import uuid
from typing import Optional


class _EngineUDF:
    """Loads the engine once, then maps blocks of prompts to completions.
    ``device``: None is the GPU (raising when none is visible); pass
    ``device="cpu"`` for the CPU."""

    def __init__(self, model_config: dict, engine_config: Optional[dict],
                 sampling: Optional[dict], tokenizer_spec: Optional[str],
                 input_column: str, output_column: str, device=None):
        from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
        from ray_tpu_torch.llm.sampling import SamplingParams
        from ray_tpu_torch.llm.tokenizer import load_tokenizer
        from ray_tpu_torch.models.transformer import TransformerConfig

        self.tok = load_tokenizer(tokenizer_spec)
        ec = dict(engine_config or {})
        if "eos_id" not in ec and self.tok.eos_id >= 0:
            ec["eos_id"] = self.tok.eos_id
        self.engine = LLMEngine(
            TransformerConfig(**model_config), engine_config=EngineConfig(**ec), device=device
        )
        self.sampling = SamplingParams(**(sampling or {}))
        self.input_column = input_column
        self.output_column = output_column

    def __call__(self, rows: list) -> list:
        # Pre-encode + validate EVERY row before admitting any: a mid-block
        # ValueError (e.g. over-long prompt) must not leave half a block
        # orphaned in the persistent engine.
        encoded = []
        for row in rows:
            value = row[self.input_column]
            tokens = (
                self.tok.encode(value, add_bos=True)
                if isinstance(value, str) else list(map(int, value))
            )
            if len(tokens) >= self.engine.ec.max_seq:
                raise ValueError(
                    f"prompt of {len(tokens)} tokens >= engine max_seq "
                    f"{self.engine.ec.max_seq} (row: {str(value)[:80]!r})"
                )
            encoded.append(tokens)
        # Unique ids per call: a retried or duplicated call must never
        # collide with an earlier admission of the same block; foreign
        # finished events are discarded by the `in ids` guard.
        prefix = uuid.uuid4().hex[:8]
        ids = {}
        for i, tokens in enumerate(encoded):
            rid = f"{prefix}-{i}"
            ids[rid] = i
            self.engine.add_request(rid, tokens, sampling=self.sampling)
        done: dict[int, list] = {}
        while self.engine.has_work():
            for rid, ev in self.engine.step().items():
                if ev.get("finished") and rid in ids:
                    done[ids[rid]] = ev["tokens"]
        out = []
        for i, row in enumerate(rows):
            row = dict(row)
            toks = done[i]
            row[self.output_column] = self.tok.decode(toks)
            row[self.output_column + "_tokens"] = list(map(int, toks))
            out.append(row)
        return out


def batch_generate(ds, model_config: dict, engine_config: Optional[dict] = None,
                   sampling: Optional[dict] = None, *,
                   concurrency=1,
                   tokenizer: Optional[str] = None,
                   input_column: str = "prompt",
                   output_column: str = "generated_text",
                   ray_remote_args: Optional[dict] = None,
                   device=None):
    """Map a Dataset of prompts through an actor pool of engines.

    ds rows carry `input_column` (text, or a token-id list); the result adds
    `output_column` (text) and `output_column + "_tokens"`. concurrency:
    int or (min, max) pool size; each pool actor loads the model ONCE (pass
    ray_remote_args={"num_gpus": f} to give each actor its share of a card).
    device: None is the GPU (each engine raises when its actor sees none);
    pass device="cpu" for the CPU. Lazy like every Data op: executes when
    the dataset is consumed.
    """
    return ds.map_batches(
        _EngineUDF,
        compute="actors",
        concurrency=concurrency,
        batch_format="rows",
        fn_constructor_args=(
            model_config, engine_config, sampling, tokenizer,
            input_column, output_column, device,
        ),
        ray_remote_args=ray_remote_args,
        # An engine consumes a whole block per call; queueing more than one
        # extra block per actor just pins memory.
        max_tasks_in_flight_per_actor=2,
    )
