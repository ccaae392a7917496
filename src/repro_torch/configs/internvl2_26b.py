"""internvl2-26b -- VLM: InternViT frontend (stub) + InternLM2-20B backbone.
[arXiv:2404.16821; hf]

The modality frontend is a stub: requests carry precomputed patch
embeddings (frontend_dim wide) and the model owns only their projection
into the backbone width.  The multi-camera demo serves this model: the
cross-camera RoI masks drop redundant patches before the backbone.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    source="[arXiv:2404.16821; hf]",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    frontend="vit_patch",
    frontend_dim=3200,  # InternViT-6B output width
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    name="internvl2-26b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend_dim=48,
)
