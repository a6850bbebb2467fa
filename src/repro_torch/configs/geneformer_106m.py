"""Geneformer 106M — BioNeMo's single-cell foundation-model recipe.

BERT over rank-value-encoded gene tokens: 12L, d_model 768, 12 heads,
gene vocab ~25k, learned positions (rank encoding), MLM objective."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="geneformer-106m",
        family="bio_bert",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=25426,
        causal=False,
        objective="mlm",
        act="gelu",
        norm_type="layernorm",
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        use_rope=False,
        max_pos=4096,
        tie_embeddings=True,
        citation="BioNeMo / Geneformer (Theodoris et al. 2023)",
    )
