"""Llama-4 Maverick 400B / 17B-active / 128 experts
[hf:meta-llama/Llama-4-Scout-17B-16E family].

MoE 48L, d_model 5120, 40 q / 8 kv heads, expert d_ff 8192, 128 experts
top-1 + shared expert on every *other* layer (dense FFN in between),
vocab 202048.  Chunked attention modeled as sliding window 8192, as in the
reference package's entry."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=128,
        num_experts_per_tok=1,
        moe_layer_period=2,
        n_shared_experts=1,
        act="swiglu",
        norm_type="rmsnorm",
        sliding_window=8192,
        rope_theta=500_000.0,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
