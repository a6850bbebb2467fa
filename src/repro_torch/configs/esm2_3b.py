"""ESM-2 3B — the BioNeMo paper's large protein-LM throughput config."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="esm2-3b",
        family="bio_bert",
        num_layers=36,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        head_dim=64,
        d_ff=10240,
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
