"""whisper-small -- encoder-decoder audio model, conv frontend (a stub).
[arXiv:2212.04356; unverified]

As in the JAX package, the conv frontend is a stub: a request carries
precomputed frame embeddings (post-conv, ``frontend_dim``), and the model
owns a linear adapter and sinusoid positions.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-small",
    family="encdec",
    source="[arXiv:2212.04356; unverified]",
    num_layers=12,  # per side
    encoder_layers=12,
    decoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,  # MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    act="gelu",
    max_target_len=448,
    frontend="conv_audio",
    frontend_dim=768,
    tie_embeddings=True,
    norm_eps=1e-5,
)

SMOKE = FULL.replace(
    name="whisper-small-smoke",
    num_layers=2,
    encoder_layers=2,
    decoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    max_target_len=32,
    frontend_dim=64,
)
