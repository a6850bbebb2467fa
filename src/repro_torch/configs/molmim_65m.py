"""MolMIM-class 65M molecular seq2seq — BioNeMo's small-molecule recipe
(MegaMolBART/MolMIM lineage): 6+6 enc-dec, d_model 512, 8 heads,
d_ff 2048, 523-token SMILES vocab."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="molmim-65m",
        family="bio_encdec",
        num_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=523,
        is_encoder_decoder=True,
        encoder_layers=6,
        objective="seq2seq",
        act="gelu",
        norm_type="layernorm",
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        use_rope=True,
        citation="BioNeMo / MolMIM (Reidenbach et al. 2023)",
    )
