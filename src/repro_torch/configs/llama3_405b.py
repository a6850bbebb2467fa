"""Llama-3 405B [arXiv:2407.21783].

Dense 126L, d_model 16384, 128 q / 8 kv heads (GQA), d_ff 53248,
vocab 128256 (128k).  The largest dense arch in the zoo: d_model 16384 is
the RMSNorm kernel's widest row, and its GQA group of 16 the decode
kernels' largest."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        act="swiglu",
        norm_type="rmsnorm",
        rope_theta=500_000.0,
        citation="arXiv:2407.21783",
    )
