"""ray_tpu_torch.llm: the continuous-batching engine and the in-process
serving surface on it (counterpart of ``ray_tpu.llm``).

``LLMEngine`` batches requests at iteration level; ``LLMServer`` hosts one
behind a stepping thread for concurrent blocking and streaming callers;
``OpenAIServer`` speaks text (completions, chat, SSE) through a
``Tokenizer``. ``build_llm_app`` / ``build_openai_app`` make serve
applications of them; ``batch_generate`` maps a Dataset of prompts through
an actor pool of engines.

The names below load on first use, so importing a torch-free submodule
(``ray_tpu_torch.llm.tokenizer``) does not import torch.
"""
import importlib

_EXPORTS = {
    "EngineConfig": "engine", "LLMEngine": "engine", "LLMServer": "deployment",
    "build_llm_app": "deployment", "OpenAIServer": "openai", "build_openai_app": "openai",
    "batch_generate": "batch", "SamplingParams": "sampling", "sample_batch": "sampling",
    "Tokenizer": "tokenizer", "HFTokenizer": "tokenizer", "load_tokenizer": "tokenizer",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
