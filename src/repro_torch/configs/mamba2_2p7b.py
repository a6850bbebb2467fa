"""Mamba2-2.7B [arXiv:2405.21060] — SSD (state-space duality), attention-free.

64L, d_model 2560, d_inner 5120 (expand 2), 80 SSD heads (headdim 64),
state 128, vocab 50280 (padded to 50432 for 16-way vocab TP)."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=32,          # unused (attention-free); kept for config shape
        num_kv_heads=32,
        d_ff=0,                # no FFN: pure mamba blocks
        vocab_size=50280,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=128,
        ssm_ngroups=1,
        norm_type="rmsnorm",
        tie_embeddings=True,
        citation="arXiv:2405.21060",
    )
