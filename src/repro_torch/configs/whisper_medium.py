"""Whisper-medium [arXiv:2212.04356] — encoder-decoder, audio.

24+24L, d_model 1024, 16 heads (MHA), d_ff 4096, vocab 51865 (padded
51968).  The mel-spectrogram + conv frontend is a stub: the caller passes
precomputed frame embeddings (1500 frames × d_model) as ``enc_embeds``.
LayerNorm + bias, GELU, learned positions."""
from repro_torch.configs import register
from repro_torch.core.config import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        is_encoder_decoder=True,
        encoder_layers=24,
        frontend="audio_stub",
        num_frontend_tokens=1500,
        norm_type="layernorm",
        act="gelu",
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        use_rope=False,
        max_pos=32768,          # extended decoder positions for decode_32k
        objective="seq2seq",
        citation="arXiv:2212.04356",
    )
