"""h2o-danube-3-4b — dense llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="h2o-danube3-4b",
    family="dense",
    source="[arXiv:2401.16818; unverified]",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    window_size=4096,  # mistral-style SWA on every layer
    rope_theta=10_000.0,
)

SMOKE = FULL.replace(
    name="h2o-danube3-4b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    window_size=32,
)
