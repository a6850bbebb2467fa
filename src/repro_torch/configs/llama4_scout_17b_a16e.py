"""Llama-4 Scout 17B-active / 16 experts [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE 48L, d_model 5120, 40 q / 8 kv heads, expert d_ff 8192, 16 experts
top-1 + 1 shared expert on every layer, vocab 202048.  The same model as
the reference package's entry, not Meta's release: softmax top-k routing
renormalized over the chosen experts, a sliding window of 8192 standing in
for chunked attention, and RoPE on every layer."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=16,
        num_experts_per_tok=1,
        moe_layer_period=1,
        n_shared_experts=1,
        act="swiglu",
        norm_type="rmsnorm",
        sliding_window=8192,
        rope_theta=500_000.0,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
