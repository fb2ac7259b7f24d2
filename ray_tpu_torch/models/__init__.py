from ray_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    dense_ffn,
    forward,
    init_params,
    rms_norm,
    rope,
)

__all__ = ["Transformer", "TransformerConfig", "dense_ffn", "forward", "init_params", "rms_norm", "rope"]
