"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba + attention + MoE.

72L, d_model 8192, 1 attention : 7 mamba interleave (9 groups of 8,
attention mid-group), 64 q / 8 kv heads, MoE 16 experts top-2 every other
layer with d_ff 24576, vocab 65536.  SSM blocks use the Mamba-2/SSD form
(DESIGN.md notes the Mamba-1→SSD substitution): d_inner 16384, headdim 64
(256 SSD heads), state 128."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        num_experts=16,
        num_experts_per_tok=2,
        moe_layer_period=2,
        attn_layer_period=8,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=128,
        ssm_ngroups=1,
        act="swiglu",
        norm_type="rmsnorm",
        citation="arXiv:2403.19887",
    )
