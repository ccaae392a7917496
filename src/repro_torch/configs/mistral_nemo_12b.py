"""mistral-nemo-12b — dense LM, 128k ctx, head_dim 128 (< d_model/num_heads).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    source="[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
)

SMOKE = FULL.replace(
    name="mistral-nemo-12b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
)
