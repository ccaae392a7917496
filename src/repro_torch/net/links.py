"""Per-camera uplink models: bandwidth traces, jitter, congestion, FIFO.

The analytic online model prices the whole group's segment through one
steady pipe (``tx = seg_bytes / bandwidth + rtt/2``).  This module is the
transport layer underneath that formula: every camera gets its own uplink
with a per-segment bandwidth *trace* (base share x lognormal jitter x
scripted congestion episodes) and a FIFO transmit queue, all evaluated as
array ops over the full (cameras, segments) grid — no Python event loop.

Two structural choices tie the simulation to the analytic model:

* **Proportional share** — the default calibration splits the group's
  shared uplink budget across cameras proportionally to each camera's
  per-segment load, which is exactly what fair queuing on a shared
  bottleneck converges to when every camera is backlogged.  Under it each
  camera's transmit time equals the analytic ``seg_bytes / bandwidth``,
  so with zero jitter and no congestion the simulation degenerates to the
  analytic formula *identically* (tests pin rel err < 1e-6).
* **Closed-form FIFO** — the queue recursion
  ``dep[i] = max(arr[i], dep[i-1]) + tx[i]`` collapses to
  ``dep = cummax(arr - cumsum_excl(tx)) + cumsum(tx)``, one prefix sum and
  one running max along the segment axis for all cameras at once.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "traces")


@dataclass(frozen=True)
class UplinkTrace:
    """A measured uplink bandwidth trace replayed as the group's shared
    budget.

    ``t_s`` are sample timestamps (monotone, starting at 0) and ``mbps``
    the measured throughput at each timestamp; replay is piecewise-
    constant (each sample holds until the next) and wraps
    **deterministically** when the simulation horizon outruns the trace
    (``sample(t) == sample(t % duration_s)``), so a short drive log can
    price an arbitrarily long window reproducibly.  The scripted
    ``CongestionEpisode`` path stays available as the synthetic fallback
    — episodes multiply on top of whatever budget the trace replays."""
    t_s: np.ndarray                    # (T,) seconds, monotone from 0
    mbps: np.ndarray                   # (T,) measured uplink throughput
    name: str = "trace"

    def __post_init__(self):
        t = np.asarray(self.t_s, np.float64)
        m = np.asarray(self.mbps, np.float64)
        if t.ndim != 1 or t.shape != m.shape or t.size == 0:
            raise ValueError("trace needs matching 1-D t_s/mbps samples")
        if t[0] != 0.0 or (np.diff(t) <= 0).any():
            raise ValueError("trace timestamps must start at 0 and be "
                             "strictly increasing")
        object.__setattr__(self, "t_s", t)
        object.__setattr__(self, "mbps", m)

    @property
    def duration_s(self) -> float:
        """Replay period: the last sample holds for the trace's median
        sample interval, then the trace wraps."""
        if self.t_s.size == 1:
            return 1.0
        return float(self.t_s[-1] + np.median(np.diff(self.t_s)))

    def sample(self, t: np.ndarray) -> np.ndarray:
        """Piecewise-constant bandwidth (Mbps) at wall times ``t`` with
        deterministic wrap-around past ``duration_s``."""
        tm = np.mod(np.asarray(t, np.float64), self.duration_s)
        idx = np.searchsorted(self.t_s, tm, side="right") - 1
        return self.mbps[np.maximum(idx, 0)]

    @classmethod
    def from_csv(cls, path: str, name: Optional[str] = None
                 ) -> "UplinkTrace":
        """Load a ``time_s,mbps`` CSV (``#`` comment lines ignored)."""
        rows = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
        if rows.shape[1] != 2:
            raise ValueError(f"{path}: expected 2 columns (time_s,mbps), "
                             f"got {rows.shape[1]}")
        base = os.path.splitext(os.path.basename(path))[0]
        return cls(rows[:, 0] - rows[0, 0], rows[:, 1], name or base)


def load_bundled_trace(name: str = "lte_uplink") -> UplinkTrace:
    """A cellular uplink trace checked into the repo
    (``net/traces/<name>.csv``, Ghent 4G/LTE drive-log format:
    per-second throughput samples with deep fades and recovery ramps) —
    the real-world bandwidth axis for the SLO frontier sweeps."""
    path = os.path.join(TRACE_DIR, f"{name}.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no bundled trace {name!r}; available: "
            f"{sorted(os.path.splitext(f)[0] for f in os.listdir(TRACE_DIR) if f.endswith('.csv'))}")
    return UplinkTrace.from_csv(path, name)


@dataclass(frozen=True)
class CongestionEpisode:
    """Bandwidth depression over a wall-clock interval [t0_s, t1_s).

    ``factor`` multiplies the affected cameras' bandwidth (0.3 = the link
    drops to 30%).  ``cams`` is a tuple of positional camera indices, or
    None for every camera (a shared-bottleneck event)."""
    t0_s: float
    t1_s: float
    factor: float
    cams: Optional[Tuple[int, ...]] = None


@dataclass
class LinkConfig:
    """Per-camera uplink model parameters.

    ``share='proportional'`` splits the group bandwidth by per-segment
    load (the analytic-equivalent calibration); ``'equal'`` gives every
    camera bandwidth/C — cameras with heavy masks then straggle, which is
    the camera-skew regime ReXCam describes."""
    share: str = "proportional"          # proportional | equal
    jitter_std: float = 0.0              # lognormal sigma per (cam, seg)
    seed: int = 0
    congestion: Tuple[CongestionEpisode, ...] = ()
    # real-trace replay: when set, the group's shared uplink budget per
    # segment comes from the measured trace (sampled at each segment's
    # close time, deterministic wrap) instead of the constant
    # ``bandwidth_mbps``; share/jitter/congestion semantics are
    # unchanged on top of it.  ``trace_scale`` rescales the replayed
    # Mbps (sweep severity without editing the file).
    trace: Optional[UplinkTrace] = None
    trace_scale: float = 1.0


def default_congestion_trace(duration_s: float,
                             factor: float = 0.30,
                             start_frac: float = 0.25,
                             stop_frac: float = 0.75
                             ) -> Tuple[CongestionEpisode, ...]:
    """The standard benchmark trace: one shared-bottleneck episode over
    the middle half of the window at 30% capacity — deep enough that a
    full-frame fleet backlogs (tx > segment duration) while CrossRoI
    masks, at 42-65% fewer bytes, keep draining."""
    return (CongestionEpisode(duration_s * start_frac,
                              duration_s * stop_frac, factor),)


def bandwidth_traces(cfg: LinkConfig, bandwidth_mbps: float,
                     load_bytes: np.ndarray, segment_s: float
                     ) -> np.ndarray:
    """(C, S) per-camera bandwidth traces in bytes/second.

    ``load_bytes`` is the (C, S) per-segment byte load used for the
    proportional split (zero-load cameras get an equal share so their
    trace stays finite).  Jitter and congestion multiply the base share;
    congestion episodes are evaluated against each segment's close time.
    With ``cfg.trace`` set, the shared budget is the replayed
    measurement sampled at each segment's close instead of the constant
    ``bandwidth_mbps`` — the share split, jitter, and episode semantics
    are identical either way, so a constant-valued trace reproduces the
    analytic calibration exactly.
    """
    C, S = load_bytes.shape
    if cfg.trace is not None:
        close = (np.arange(S) + 1.0) * segment_s
        budget_Bps = cfg.trace.sample(close) * cfg.trace_scale * 1e6 / 8.0
        budget_Bps = budget_Bps[None, :]                    # (1, S)
    else:
        budget_Bps = np.full((1, S), bandwidth_mbps * 1e6 / 8.0)
    if cfg.share == "proportional":
        tot = load_bytes.sum(axis=0, keepdims=True)         # (1, S)
        frac = np.where(tot > 0, load_bytes / np.maximum(tot, 1e-300),
                        1.0 / C)
        bw = budget_Bps * frac
    elif cfg.share == "equal":
        bw = np.broadcast_to(budget_Bps / C, (C, S)).copy()
    else:
        raise ValueError(f"unknown share mode {cfg.share!r}")

    if cfg.jitter_std > 0.0:
        rng = np.random.default_rng(cfg.seed)
        # mean-one lognormal so jitter perturbs but does not bias capacity
        sig = cfg.jitter_std
        bw = bw * rng.lognormal(-0.5 * sig * sig, sig, size=(C, S))

    if cfg.congestion:
        close = (np.arange(S) + 1.0) * segment_s            # (S,)
        for ep in cfg.congestion:
            hit = (close > ep.t0_s) & (close <= ep.t1_s)    # (S,)
            if ep.cams is None:
                bw = np.where(hit[None, :], bw * ep.factor, bw)
            else:
                rows = np.asarray(ep.cams, np.int64)
                bw[rows] = np.where(hit[None, :], bw[rows] * ep.factor,
                                    bw[rows])
    return bw


def outage_effective(arrivals: np.ndarray, bw: np.ndarray,
                     segment_s: float, fallback_Bps: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rewrite a (C, S) bandwidth grid with zero-rate segments (uplink
    outages) into an *outage-effective* form the closed-form FIFO can
    price without emitting inf/NaN.

    During an outage nothing transmits: bytes that arrive sit in the
    queue and drain when the link comes back.  Pricing that exactly per
    row: a segment arriving while ``bw == 0`` cannot *start* service
    before the first later segment boundary where ``bw > 0``, and it is
    transmitted at that restored rate.  So per (cam, seg):

    * ``eff_bw``  — the rate of the next up segment (>= s); when the
      outage runs past the window end, ``fallback_Bps`` (the caller's
      nominal rate) prices the eventual drain.
    * ``eff_arr`` — ``max(arrivals, restore_t)`` where ``restore_t`` is
      the open time of that next up segment.  On non-outage segments
      ``restore_t = s * segment_s <= arrivals`` (arrivals sit at or
      after their segment close), so the floor is a no-op there and the
      transform is *bit-identical* to the input when no zeros exist.

    Returns ``(eff_arrivals, eff_bw, restore_t)``; ``eff_arrivals``
    stays monotone along the segment axis because both inputs to the
    max are monotone."""
    C, S = bw.shape
    idx = np.arange(S)
    # first segment index >= s with positive bandwidth (S when none):
    # reversed running-min of (idx where up, else S).
    nxt = np.where(bw > 0, idx[None, :], S)
    nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
    eff_bw = np.where(
        nxt < S,
        np.take_along_axis(np.concatenate(
            [bw, np.full((C, 1), fallback_Bps)], axis=1), nxt, axis=1),
        fallback_Bps)
    restore_t = np.where(nxt < S, nxt * segment_s, S * segment_s)
    eff_arr = np.maximum(arrivals, restore_t)
    return eff_arr, eff_bw, restore_t


def fifo_departures(arrivals: np.ndarray, tx_s: np.ndarray) -> np.ndarray:
    """Vectorized FIFO queue: per row (camera), segments enter the link at
    ``arrivals`` (monotone along the last axis) and each occupies the link
    for ``tx_s`` seconds.  Returns departure times.

    Closed form of ``dep[i] = max(arr[i], dep[i-1]) + tx[i]``:
    ``dep[i] = max_{j<=i}(arr[j] - cum_excl_tx[j]) + cum_tx[i]`` — exact,
    one pass, no Python loop over segments."""
    cum = np.cumsum(tx_s, axis=-1)
    slack = arrivals - (cum - tx_s)
    return np.maximum.accumulate(slack, axis=-1) + cum


def queue_wait(arrivals: np.ndarray, tx_s: np.ndarray) -> np.ndarray:
    """Time each segment spends waiting behind earlier segments (the
    backlog signal the rate controller reacts to): dep - arr - tx."""
    return fifo_departures(arrivals, tx_s) - arrivals - tx_s
