"""ESM-2 650M — the BioNeMo paper's flagship protein-LM recipe.

BERT-style bidirectional encoder, MLM objective, 33L, d_model 1280,
20 heads, d_ff 5120, 33-token amino-acid vocab, RoPE."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="esm2-650m",
        family="bio_bert",
        num_layers=33,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=33,
        causal=False,
        objective="mlm",
        act="gelu",
        norm_type="layernorm",
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        tie_embeddings=True,
        citation="BioNeMo / ESM-2 (Lin et al. 2022)",
    )
