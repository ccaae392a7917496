"""Config dataclasses: the port's copy of ``ModelConfig`` (every field of
the JAX package's, so that configurations read the same, and ``qk_norm``,
which the JAX package infers from the config's name), the input-shape
cells (``ShapeCell``, ``SHAPES``), ``TrainConfig`` and ``ServeConfig``.
Parameter counts cover every family: dense, vlm, moe, ssm (rwkv6), hybrid
(zamba2) and encdec (whisper).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""  # provenance note: [arXiv/hf ref; verification tier]

    # trunk ------------------------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0  # 0 => attention-free trunk
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP, whisper)
    tie_embeddings: bool = True

    # attention pattern -------------------------------------------------------
    window_size: int = 0  # 0 => full attention everywhere
    global_every: int = 0  # gemma3: one global layer per this many layers
    logit_softcap: float = 0.0  # gemma-style attn logit soft-capping

    # moe ---------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-(routed)-expert hidden dim
    num_shared_experts: int = 0
    shared_d_ff: int = 0  # total hidden dim of the shared-expert MLP
    first_dense_layers: int = 0  # deepseek-moe: leading dense layers
    qk_norm: bool = False  # RMSNorm on q and k per head (qwen3); the port's
    #                        own field: the JAX package keys it on the name
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25

    # ssm (mamba2 / rwkv6) ----------------------------------------------------
    ssm_state_dim: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    attn_every: int = 0  # zamba2: shared attention block every N ssm blocks
    num_shared_attn_blocks: int = 0  # zamba2: how many distinct shared blocks

    # encoder-decoder ---------------------------------------------------------
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_target_len: int = 448

    # modality frontend (a stub: inputs carry precomputed embeddings)
    frontend: str = "none"  # none | conv_audio | vit_patch
    frontend_dim: int = 0  # dim of precomputed frame/patch embeddings

    # numerics ----------------------------------------------------------------
    dtype: str = "bfloat16"
    # perf variants (defaults = the paper-era baseline)
    decode_grouped_attn: bool = False  # GQA decode without repeat_kv blowup
    kv_cache_dtype: str = "bfloat16"   # | float8_e4m3fn (halves cache bytes)

    # --- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_num_heads * self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter counting (for 6·N·D roofline cross-checks) -------------------
    def param_count(self) -> int:
        return sum(int(x) for x in _param_counts(self).values())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        counts = _param_counts(self)
        total = sum(int(v) for v in counts.values())
        if self.num_experts and self.experts_per_token:
            routed = counts["moe_routed"]
            total -= int(routed)
            total += int(routed * self.experts_per_token / self.num_experts)
        return int(total)


def _param_counts(cfg: ModelConfig) -> dict:
    """Analytic per-component parameter counts (``models/params.py``), the
    JAX package's formulas: its ssm count folds some small terms, and its
    hybrid count leaves out the conv and a few per-head vectors, so those
    two differ slightly from the parameter tree, as the JAX package's do."""
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {cfg.family}")
    d = cfg.d_model
    counts: dict = {"embed": cfg.vocab_size * d}
    if not cfg.tie_embeddings:
        counts["unembed"] = cfg.vocab_size * d

    def mlp_params(ff: int) -> int:
        if cfg.act in ("silu", "gelu_glu"):   # GLU family: 3 mats, no bias
            return 3 * d * ff
        return 2 * d * ff + ff + d            # plain gelu mlp with biases

    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.family == "ssm":                   # rwkv6
        lora_mix, lora_decay = 32, 64         # models/rwkv.py
        tmix = (5 * d * d + 2 * 5 * lora_mix * d + 2 * lora_decay * d
                + 11 * d)
        counts["tmix"] = cfg.num_layers * tmix
        counts["cmix"] = cfg.num_layers * (2 * d * cfg.d_ff + d * d + 2 * d)
        counts["norms"] = 2 * d               # ln_in + final_norm
        return counts
    if cfg.family == "hybrid":                # zamba2
        inner = cfg.ssm_inner
        per_mamba = (d * (2 * inner + 2 * cfg.ssm_state_dim
                          + cfg.ssm_num_heads) + inner * d + inner)
        counts["mamba"] = cfg.num_layers * per_mamba
        n_attn = cfg.num_shared_attn_blocks
        counts["shared_attn"] = n_attn * (attn + mlp_params(cfg.d_ff))
        counts["norms"] = cfg.num_layers * 2 * d + d + n_attn * 2 * d
        return counts
    if cfg.family == "encdec":                # whisper
        enc_l, dec_l = cfg.encoder_layers, cfg.decoder_layers
        counts["enc_attn"] = enc_l * attn
        counts["enc_mlp"] = enc_l * mlp_params(cfg.d_ff)
        counts["dec_self_attn"] = dec_l * attn
        counts["dec_cross_attn"] = dec_l * attn
        counts["dec_mlp"] = dec_l * mlp_params(cfg.d_ff)
        counts["attn_biases"] = (enc_l + 2 * dec_l) * (cfg.q_dim
                                                       + cfg.kv_dim + d)
        counts["norms"] = 2 * ((enc_l * 2 + dec_l * 3) * d + 2 * d)  # w, b
        counts["dec_pos"] = cfg.max_target_len * d
        if cfg.frontend == "conv_audio":
            counts["frontend_proj"] = cfg.frontend_dim * d + d
        return counts
    counts["attn"] = cfg.num_layers * attn
    if cfg.family == "moe":
        n_moe = cfg.num_layers - cfg.first_dense_layers
        counts["dense_mlp"] = cfg.first_dense_layers * mlp_params(cfg.d_ff)
        counts["moe_routed"] = n_moe * cfg.num_experts * 3 * d * cfg.moe_d_ff
        counts["moe_shared"] = (
            n_moe * 3 * d * cfg.shared_d_ff if cfg.num_shared_experts else 0)
        counts["router"] = n_moe * d * cfg.num_experts
    else:
        counts["mlp"] = cfg.num_layers * mlp_params(cfg.d_ff)
    counts["norms"] = cfg.num_layers * 2 * d + d
    if cfg.frontend == "vit_patch":
        counts["frontend_proj"] = cfg.frontend_dim * d + d
    return counts


# ---------------------------------------------------------------------------
# input-shape cells (the same set for every arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """Knobs of the training step (``optim.adamw``, ``models.model.
    train_loss``) and of the loop that will carry it."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatch: int = 0  # 0 => no gradient accumulation
    remat: str = "block"  # none | block | offloadable
    sharding_mode: str = "tp"  # tp (paper-era baseline) | fsdp | fsdp_pod
    grad_compression: str = "none"  # none | int8
    causal_skip: bool = False  # skip fully-masked attention chunks (perf)
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    """Knobs for the serving engine."""
    max_batch: int = 128
    max_seq: int = 32_768
    roi_sparsity: bool = False  # CrossRoI token-RoI packed prefill
    kv_seq_shard: bool = False  # shard the KV cache's sequence dim (data)
    decode_attn_impl: str = "full"  # full | banded (for SWA archs)
