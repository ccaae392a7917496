"""Roofline terms of a dry-run cell, per device, on the H100's constants
(``launch.mesh``):

    compute    = flops_per_device / PEAK_FLOPS_BF16
    memory     = hbm_bytes_per_device / HBM_BW
    collective = coll_bytes_per_device / COLL_BW

The JAX package reads the three inputs from XLA's ``cost_analysis`` and
the partitioned HLO text; the port counts them as one rank's step runs
(``launch.counter``: FLOPs of matmuls, convolutions and attention; each
op's inputs read and outputs written, with no fusion; each
collective's result, an all-reduce's twice).

Depth calibration: XLA counts a ``lax.scan`` body once, so the JAX
package compiles each cell at two small depths (``calib_depths``), fits
cost(L) = slope * L + intercept and extrapolates to the full depth.  The
port's layer loops are Python and run every layer, so a count is whole
at any depth; ``extrapolate`` of two depths' counts must equal the full
depth's count -- the dry run's ``--calibrate`` checks exactly that.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import COLL_BW, HBM_BW, PEAK_FLOPS_BF16


@dataclass
class RooflineTerms:
    arch: str
    cell: str
    mesh: str
    flops: float                 # per device
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    model_flops: float           # analytic 6*N*D (global)
    chips: int
    calibrated: bool = True
    mem_per_device: float = 0.0  # the counter's peak of live bytes

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / COLL_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global counted flops (remat/redundancy waste
        catch)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term bound that is useful model
        compute: (model_flops/chips/peak) / bound_time."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS_BF16
        return ideal / self.bound_time if self.bound_time else 0.0

    def row(self) -> str:
        return (f"{self.arch:22s} {self.cell:12s} {self.mesh:9s} "
                f"c={self.t_compute:9.3e} m={self.t_memory:9.3e} "
                f"x={self.t_collective:9.3e} dom={self.dominant:10s} "
                f"useful={self.useful_ratio:6.3f} "
                f"roof={self.roofline_fraction:6.3f}")


def model_flops_for(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Analytic useful FLOPs per step: 6*N*D train, 2*N*D forward-only
    (D = tokens processed; decode: one token per sequence)."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        toks = cell.global_batch * cell.seq_len
        return 6.0 * n * toks
    if cell.kind == "prefill":
        toks = cell.global_batch * cell.seq_len
        return 2.0 * n * toks
    toks = cell.global_batch * 1
    return 2.0 * n * toks


# ---------------------------------------------------------------------------
# calibration depths per arch family (structure-respecting small configs)
# ---------------------------------------------------------------------------

def calib_depths(cfg: ModelConfig) -> Tuple[int, int]:
    if cfg.family in ("dense", "vlm") and cfg.global_every > 1:
        g = cfg.global_every
        return g, 2 * g
    if cfg.family == "moe" and cfg.first_dense_layers:
        f = cfg.first_dense_layers
        return f + 1, f + 3
    if cfg.family == "hybrid":
        a = cfg.attn_every
        return a, 2 * a
    if cfg.family == "encdec":
        return 2, 4            # encoder+decoder layers together
    return 1, 2


def with_depth(cfg: ModelConfig, L: int) -> ModelConfig:
    if cfg.family == "encdec":
        return cfg.replace(num_layers=2 * L, encoder_layers=L,
                           decoder_layers=L)
    if cfg.family == "hybrid":
        blocks = max(L // cfg.attn_every, 1)
        return cfg.replace(num_layers=L,
                           num_shared_attn_blocks=min(
                               cfg.num_shared_attn_blocks, blocks))
    return cfg.replace(num_layers=L)


def full_depth(cfg: ModelConfig) -> int:
    if cfg.family == "encdec":
        return cfg.encoder_layers
    return cfg.num_layers


def extrapolate(c1: float, c2: float, l1: int, l2: int, lf: int) -> float:
    slope = (c2 - c1) / max(l2 - l1, 1)
    intercept = c1 - slope * l1
    return max(slope * lf + intercept, 0.0)


__all__ = ["RooflineTerms", "model_flops_for", "calib_depths",
           "with_depth", "full_depth", "extrapolate"]
