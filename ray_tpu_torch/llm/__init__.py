from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
from ray_tpu_torch.llm.sampling import SamplingParams, sample_batch

__all__ = ["EngineConfig", "LLMEngine", "SamplingParams", "sample_batch"]
