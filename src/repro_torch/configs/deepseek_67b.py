"""deepseek-67b — dense llama-arch LM. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="deepseek-67b",
    family="dense",
    source="[arXiv:2401.02954; hf]",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    name="deepseek-67b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
