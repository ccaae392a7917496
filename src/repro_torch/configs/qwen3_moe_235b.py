"""qwen3-moe-235b-a22b — MoE LM: 128 experts, top-8, no shared experts.
[hf:Qwen/Qwen3-235B-A22B (scaled family ref Qwen3-30B-A3B); hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # kept for reference; routed expert hidden = moe_d_ff
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    num_shared_experts=0,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    qk_norm=True,
)

SMOKE = FULL.replace(
    name="qwen3-moe-235b-a22b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32,
    capacity_factor=4.0,  # effectively dropless at smoke scale
)
