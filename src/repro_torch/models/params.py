"""Parameter trees of the decoder families, under the JAX package's names:
stacked ``(L, ...)`` tensors under ``blocks_`` (a uniform stack),
``local_``/``global_``/``trail_`` (gemma3's pattern) or ``dense_`` and
``blocks_`` (moe: the first dense layers, then the MoE blocks with
``router``, ``moe_w{g,u,d}`` and ``shared_w{g,u,d}``), and
``frontend_w``, ``frontend_b`` (vlm); each attention layer has
``qnorm``/``knorm`` when ``cfg.qk_norm`` is set.  rwkv6 (ssm) has its
RWKV6 layers under ``blocks_`` and ``ln_in``; the zamba2 hybrid its
Mamba2 layers (``blocks_m_*``) and ``num_shared_attn_blocks`` shared
attention + MLP blocks under ``sa_``.  whisper (encdec) has its encoder
layers under ``e_``, its decoder's self-attention, MLP and three norms
under ``d_`` and its cross-attention under ``x_``: attention with
``bq``/``bv``/``bo`` and no ``bk``, a biased GELU MLP (``mlp_w1``,
``mlp_b1``, ``mlp_w2``, ``mlp_b2``), LayerNorms with biases (``ln1``,
``ln1_b``, ...); then ``enc_final_norm(_b)``, ``final_norm_b``, the
learned ``dec_pos`` and the frames' adapter ``frontend_w``/``frontend_b``.

``init_params`` draws random weights on a device from a
``torch.Generator`` (truncated-normal fan-in, ones for norms, zeros for
biases and mix offsets, A in [1, 16] for Mamba2's ``m_A_log`` and
RWKV6's decay ramp for ``decay_base``, as
``repro.models.params.init_params``; the bits differ from
``jax.random``'s).  ``params_from_numpy`` carries the JAX package's own
parameters across, for tests that hold the port against it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.rwkv import LORA_DECAY, LORA_MIX
from repro_torch.models.ssm import conv_dim

Creator = Callable[[str, tuple, torch.dtype, float], object]
_CHUNK = 1 << 28          # float32 elements drawn at a time (1 GiB)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _attn_block(cfg: ModelConfig, mk: Creator, L: int,
                biases: bool = False) -> Dict:
    d, dt = cfg.d_model, _dt(cfg)
    qd, kvd = cfg.q_dim, cfg.kv_dim
    p = {"wq": mk("wq", (L, d, qd), dt, d), "wk": mk("wk", (L, d, kvd), dt, d),
         "wv": mk("wv", (L, d, kvd), dt, d),
         "wo": mk("wo", (L, qd, d), dt, qd)}
    if biases:
        p.update({"bq": mk("bq", (L, qd), dt, 0),
                  "bv": mk("bv", (L, kvd), dt, 0),
                  "bo": mk("bo", (L, d), dt, 0)})
    if cfg.qk_norm:
        p["qnorm"] = mk("qnorm", (L, cfg.head_dim), torch.float32, -1)
        p["knorm"] = mk("knorm", (L, cfg.head_dim), torch.float32, -1)
    return p


def _norms(cfg: ModelConfig, mk: Creator, L: int, names=("ln1", "ln2"),
           biases: bool = False) -> Dict:
    p = {}
    for n in names:
        p[n] = mk(n, (L, cfg.d_model), torch.float32, -1)
        if biases:
            p[n + "_b"] = mk(n + "_b", (L, cfg.d_model), torch.float32, 0)
    return p


def _gelu_mlp(cfg: ModelConfig, mk: Creator, L: int) -> Dict:
    d, dt, ff = cfg.d_model, _dt(cfg), cfg.d_ff
    return {"mlp_w1": mk("mlp_w1", (L, d, ff), dt, d),
            "mlp_b1": mk("mlp_b1", (L, ff), dt, 0),
            "mlp_w2": mk("mlp_w2", (L, ff, d), dt, ff),
            "mlp_b2": mk("mlp_b2", (L, d), dt, 0)}


def _dense_stack(cfg: ModelConfig, mk: Creator, L: int) -> Dict:
    d, dt, ff = cfg.d_model, _dt(cfg), cfg.d_ff
    p = _attn_block(cfg, mk, L)
    p.update({"w1": mk("w1", (L, d, ff), dt, d),
              "w3": mk("w3", (L, d, ff), dt, d),
              "w2": mk("w2", (L, ff, d), dt, ff)})
    p.update(_norms(cfg, mk, L))
    return p


def _moe_stack(cfg: ModelConfig, mk: Creator, L: int) -> Dict:
    d, dt = cfg.d_model, _dt(cfg)
    E, Fe = cfg.num_experts, cfg.moe_d_ff
    p = _attn_block(cfg, mk, L)
    p.update(_norms(cfg, mk, L))
    p["router"] = mk("router", (L, d, E), torch.float32, d)
    p["moe_wg"] = mk("moe_wg", (L, E, d, Fe), dt, d)
    p["moe_wu"] = mk("moe_wu", (L, E, d, Fe), dt, d)
    p["moe_wd"] = mk("moe_wd", (L, E, Fe, d), dt, Fe)
    if cfg.num_shared_experts:
        Fs = cfg.shared_d_ff
        p["shared_wg"] = mk("shared_wg", (L, d, Fs), dt, d)
        p["shared_wu"] = mk("shared_wu", (L, d, Fs), dt, d)
        p["shared_wd"] = mk("shared_wd", (L, Fs, d), dt, Fs)
    return p


def _mamba_stack(cfg: ModelConfig, mk: Creator, L: int) -> Dict:
    d, dt = cfg.d_model, _dt(cfg)
    inner, N, H = cfg.ssm_inner, cfg.ssm_state_dim, cfg.ssm_num_heads
    cd, cw, f32 = conv_dim(cfg), cfg.ssm_conv_width, torch.float32
    return {
        "m_in": mk("m_in", (L, d, 2 * inner + 2 * N + H), dt, d),
        "m_conv_w": mk("m_conv_w", (L, cw, cd), f32, cw),
        "m_conv_b": mk("m_conv_b", (L, cd), f32, 0),
        "m_A_log": mk("m_A_log", (L, H), f32, -2),
        "m_D": mk("m_D", (L, H), f32, -1),
        "m_dt_bias": mk("m_dt_bias", (L, H), f32, 0),
        "m_norm": mk("m_norm", (L, inner), f32, -1),
        "m_out": mk("m_out", (L, inner, d), dt, inner),
        "m_ln": mk("m_ln", (L, d), f32, -1),
    }


def _rwkv_stack(cfg: ModelConfig, mk: Creator, L: int) -> Dict:
    d, dt, F = cfg.d_model, _dt(cfg), cfg.d_ff
    H, P, f32 = cfg.ssm_num_heads, cfg.ssm_head_dim, torch.float32
    return {
        "ln1_w": mk("ln1_w", (L, d), f32, -1),
        "ln2_w": mk("ln2_w", (L, d), f32, -1),
        "maa_x": mk("maa_x", (L, d), f32, 0),
        "maa_w1": mk("maa_w1", (L, d, 5 * LORA_MIX), dt, d),
        "maa_w2": mk("maa_w2", (L, 5, LORA_MIX, d), dt, LORA_MIX),
        "maa_wkvrg": mk("maa_wkvrg", (L, 5, d), f32, 0),
        "decay_base": mk("decay_base", (L, d), f32, -2),
        "decay_w1": mk("decay_w1", (L, d, LORA_DECAY), dt, d),
        "decay_w2": mk("decay_w2", (L, LORA_DECAY, d), dt, LORA_DECAY),
        "u": mk("u", (L, H, P), f32, 0),
        "wr": mk("wr", (L, d, d), dt, d),
        "wk": mk("wk", (L, d, d), dt, d),
        "wv": mk("wv", (L, d, d), dt, d),
        "wg": mk("wg", (L, d, d), dt, d),
        "wo": mk("wo", (L, d, d), dt, d),
        "gn_w": mk("gn_w", (L, d), f32, -1),
        "cmix_mu_k": mk("cmix_mu_k", (L, d), f32, 0),
        "cmix_mu_r": mk("cmix_mu_r", (L, d), f32, 0),
        "cmix_k": mk("cmix_k", (L, d, F), dt, d),
        "cmix_v": mk("cmix_v", (L, F, d), dt, F),
        "cmix_r": mk("cmix_r", (L, d, d), dt, d),
    }


def param_tree(cfg: ModelConfig, mk: Creator) -> Dict:
    """``mk(name, shape, dtype, scale)`` per leaf, in the JAX package's
    order; scale -1 for ones, 0 for zeros, -2 for the family's special
    init (``m_A_log``, ``decay_base``), n > 0 for the fan-in n."""
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {cfg.family}")
    d, dt, V = cfg.d_model, _dt(cfg), cfg.vocab_size
    p: Dict = {"embed": mk("embed", (V, d), dt, 1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = mk("unembed", (V, d), dt, d)
    p["final_norm"] = mk("final_norm", (d,), torch.float32, -1)

    def stack(prefix, leaves):
        p.update({prefix + k: v for k, v in leaves.items()})

    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        if nd:
            stack("dense_", _dense_stack(cfg, mk, nd))
        stack("blocks_", _moe_stack(cfg, mk, cfg.num_layers - nd))
    elif cfg.family == "ssm":
        stack("blocks_", _rwkv_stack(cfg, mk, cfg.num_layers))
        p["ln_in"] = mk("ln_in", (d,), torch.float32, -1)
    elif cfg.family == "hybrid":
        stack("blocks_", _mamba_stack(cfg, mk, cfg.num_layers))
        # the shared attention + MLP blocks, alternated over the stack
        stack("sa_", _dense_stack(cfg, mk, cfg.num_shared_attn_blocks))
    elif cfg.family == "encdec":
        stack("e_", {**_attn_block(cfg, mk, cfg.encoder_layers, True),
                     **_gelu_mlp(cfg, mk, cfg.encoder_layers),
                     **_norms(cfg, mk, cfg.encoder_layers, biases=True)})
        dec = cfg.decoder_layers
        stack("d_", _attn_block(cfg, mk, dec, True))
        stack("x_", _attn_block(cfg, mk, dec, True))
        stack("d_", {**_gelu_mlp(cfg, mk, dec),
                     **_norms(cfg, mk, dec, ("ln1", "ln2", "ln3"), True)})
        f32 = torch.float32
        p["enc_final_norm_b"] = mk("enc_final_norm_b", (d,), f32, 0)
        p["enc_final_norm"] = mk("enc_final_norm", (d,), f32, -1)
        p["final_norm_b"] = mk("final_norm_b", (d,), f32, 0)
        p["dec_pos"] = mk("dec_pos", (cfg.max_target_len, d), dt, 1.0)
    elif cfg.global_every > 1:            # gemma3's local/global pattern
        n_super = cfg.num_layers // cfg.global_every
        n_trail = cfg.num_layers - n_super * cfg.global_every
        stack("local_", _dense_stack(cfg, mk,
                                     n_super * (cfg.global_every - 1)))
        stack("global_", _dense_stack(cfg, mk, n_super))
        if n_trail:
            stack("trail_", _dense_stack(cfg, mk, n_trail))
    else:
        stack("blocks_", _dense_stack(cfg, mk, cfg.num_layers))
    if cfg.frontend in ("vit_patch", "conv_audio"):
        p["frontend_w"] = mk("frontend_w", (cfg.frontend_dim, d), dt,
                             cfg.frontend_dim)
        p["frontend_b"] = mk("frontend_b", (d,), dt, 0)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters on ``device`` (the card unless the caller passes
    one), drawn from ``generator`` (on the same device): truncated normal
    in [-2 std, 2 std] with std 1/sqrt(fan-in) (0.02 for fan-in <= 1),
    cast to the leaf's dtype, in float32 chunks of at most 1 GiB (whole
    rows over the leaf's leading dims).  The -2 leaves: ``m_A_log`` is
    log(U[1, 16]) (Mamba2's default A), ``decay_base`` the ramp -6 + 5 i /
    (n - 1) over its channels."""
    device = resolve_device(device)

    def mk(name, shape, dtype, scale):
        if scale == -1:
            return torch.ones(shape, dtype=dtype, device=device)
        if scale == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        if scale == -2:
            if name == "m_A_log":
                u = torch.empty(shape, dtype=torch.float32, device=device)
                return torch.log(u.uniform_(1.0, 16.0, generator=generator))
            if name == "decay_base":
                n = shape[-1]
                ramp = torch.arange(n, dtype=torch.float32,
                                    device=device) / max(n - 1, 1)
                return (-6.0 + 5.0 * ramp).expand(shape).contiguous()
            return torch.zeros(shape, dtype=torch.float32, device=device)
        std = 1.0 / math.sqrt(max(scale, 1.0)) if scale > 1 else 0.02
        out = torch.empty(shape, dtype=dtype, device=device)
        # rows over the fewest leading dims whose row fits in a chunk
        lead = next(i for i in range(1, len(shape) + 1)
                    if math.prod(shape[i:]) <= _CHUNK)
        rows = out.view(math.prod(shape[:lead]), -1)
        step = max(1, _CHUNK // rows.shape[1])
        for i in range(0, rows.shape[0], step):
            tmp = torch.empty(rows[i:i + step].shape, dtype=torch.float32,
                              device=device)
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
            rows[i:i + step] = tmp
        return out

    return param_tree(cfg, mk)


def params_from_numpy(tree: Dict, device=None) -> Dict:
    """The JAX package's parameters, as numpy arrays, on ``device`` (the
    card unless given).  bfloat16 leaves (``ml_dtypes.bfloat16``) go
    through float32, which holds every bfloat16 value exactly."""
    device = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[name] = t.to(device)
    return out


def param_specs(cfg: ModelConfig) -> Dict:
    """The parameter tree as ``meta`` tensors of each leaf's shape and
    dtype (the JAX package's ShapeDtypeStructs): nothing is allocated."""
    def mk(name, shape, dtype, scale):
        return torch.empty(shape, dtype=dtype, device="meta")
    return param_tree(cfg, mk)


def count_params(tree: Dict) -> int:
    return sum(int(v.numel()) for v in tree.values())
