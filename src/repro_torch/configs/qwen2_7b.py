"""Qwen2-7B [arXiv:2407.10671].

Dense 28L, d_model 3584, 28 q / 4 kv heads (GQA group 7), head_dim 128,
d_ff 18944 SwiGLU, vocab 152064 with an untied head, QKV bias, RMSNorm,
rope theta 1e6."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        act="swiglu",
        norm_type="rmsnorm",
        rope_theta=1_000_000.0,
        citation="arXiv:2407.10671",
    )
