"""gemma3-27b — dense LM, 5:1 local:global sliding-window attention, 128k ctx.
[hf:google/gemma-3-*-pt, the 1b card scaled to 27b; unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b",
    family="dense",
    source="[hf:google/gemma-3-*-pt; unverified]",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    window_size=1024,
    global_every=6,  # pattern: 5 local sliding-window layers then 1 global
    rope_theta=1_000_000.0,
    logit_softcap=0.0,
    act="gelu_glu",  # gemma uses GeGLU
)

SMOKE = FULL.replace(
    name="gemma3-27b-smoke",
    num_layers=7,  # exercises one full 6-layer pattern + 1 trailing local layer
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window_size=32,
)
