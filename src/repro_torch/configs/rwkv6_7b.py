"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="[arXiv:2404.05892; hf]",
    num_layers=32,
    d_model=4096,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab_size=65536,
    ssm_num_heads=64,  # rwkv6 heads: d_model / 64
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    name="rwkv6-7b-smoke",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=256,
    ssm_num_heads=4,
    ssm_head_dim=16,
    ssm_chunk=16,
)
