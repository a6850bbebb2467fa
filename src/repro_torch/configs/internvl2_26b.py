"""InternVL2-26B [arXiv:2404.16821] — VLM: InternViT + InternLM2 backbone.

The language backbone: 48L, d_model 6144, 48 q / 8 kv heads, d_ff 16384,
vocab 92553 (padded 92672).  The InternViT vision encoder is a stub: the
caller passes 256 precomputed patch embeddings per image as
``img_embeds``, which the model's projector maps into the LM stream in
front of the text."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        frontend="vision_stub",
        num_frontend_tokens=256,
        act="swiglu",
        norm_type="rmsnorm",
        rope_theta=1_000_000.0,
        citation="arXiv:2404.16821",
    )
