"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts, top-6,
first layer dense. [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="[arXiv:2401.06066; hf]",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MHA
    head_dim=128,
    d_ff=10944,  # dense first-layer MLP hidden
    vocab_size=102400,
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    shared_d_ff=2816,  # 2 shared experts x 1408
    first_dense_layers=1,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    name="deepseek-moe-16b-smoke",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    shared_d_ff=64,
    first_dense_layers=1,
    capacity_factor=4.0,  # effectively dropless at smoke scale
)
