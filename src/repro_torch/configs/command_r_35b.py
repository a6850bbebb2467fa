"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

Dense 40L, d_model 8192, 64 q-heads / 8 kv-heads (GQA), d_ff 22528,
vocab 256000.  Cohere specifics: parallel attention+FFN residual, LayerNorm
without bias, no QKV bias, tied embeddings.  The public config.json also
carries a logit scale that this config, as the reference's, leaves out."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab_size=256000,
        act="swiglu",
        norm_type="layernorm_nobias",
        parallel_residual=True,
        tie_embeddings=True,
        rope_theta=8_000_000.0,
        citation="hf:CohereForAI/c4ai-command-r-v01",
    )
