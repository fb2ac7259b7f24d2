from ray_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    adamw,
    ce_chunked,
    ce_from_logits,
    cross_entropy_loss,
    dense_ffn,
    forward,
    forward_hidden,
    init_params,
    load_balance_loss,
    make_pipeline_train_step,
    make_train_step,
    moe_ffn,
    param_logical_axes,
    rms_norm,
    rope,
    state_logical_axes,
)

__all__ = [
    "Transformer", "TransformerConfig", "adamw", "ce_chunked", "ce_from_logits", "cross_entropy_loss",
    "dense_ffn", "forward", "forward_hidden", "init_params", "load_balance_loss",
    "make_pipeline_train_step", "make_train_step", "moe_ffn", "param_logical_axes", "rms_norm", "rope",
    "state_logical_axes",
]
