"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

54 Mamba2 blocks; a shared transformer block (attention + MLP, two distinct
parameter sets used alternately) is interleaved every ``attn_every`` blocks.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="[arXiv:2411.15242; hf]",
    num_layers=54,  # mamba2 blocks
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,  # shared attention block is MHA
    head_dim=80,
    d_ff=10240,  # shared block MLP hidden
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_num_heads=80,
    ssm_head_dim=64,  # inner = expand*d = 5120 = 80 heads x 64
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,  # shared attn block after every 6 mamba blocks
    num_shared_attn_blocks=2,
)

SMOKE = FULL.replace(
    name="zamba2-2.7b-smoke",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    ssm_state_dim=16,
    ssm_num_heads=8,
    ssm_head_dim=16,  # inner = 128 = 2*64
    ssm_chunk=16,
    attn_every=3,
)
