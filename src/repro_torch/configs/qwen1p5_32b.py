"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family].

Dense 64L, d_model 5120, 40 heads (GQA kv=40 — i.e. MHA), d_ff 27392,
vocab 152064, QKV bias.  The decode kernels serve it at a GQA group of 1
over 40 kv heads."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        act="swiglu",
        norm_type="rmsnorm",
        rope_theta=1_000_000.0,
        citation="hf:Qwen/Qwen1.5-0.5B",
    )
