"""Batched serving engine with RoI-packed prefill and batched decode, the
port's copy of ``repro.serving.engine``.

When a prompt is a multi-camera patch stream (VLM), the offline set-cover
mask gives a keep-list.  The engine packs the kept tokens into a dense
prefix (``kernels.ops.pack_tokens``), prefills only the packed rows, and
decodes against the packed KV cache: positions travel with the tokens
(RoPE at original positions, causality in original order), so attention
stays right.

Decode is batched across a request group: prefills stay per request
(keep-lists are ragged), each into its slot of one persistent group cache
ring, and each greedy step is one batched ``decode_step`` over the group,
with per-request positions as a (G,) vector -- so RoI-packed (start =
n_kept) and dense (start = S) requests share a batch.

The spans (``serve``, ``serve_flush``, ``serve_deadline``) and the
``SERVE_EVENTS`` and ``BACKLOG_DEPTH`` metrics are recorded in ``obs`` at
the JAX engine's points.  Differences from the JAX engine: ring slots are
views of the ring (batch axis 1 of every cache tensor); prefill writes KV
caches into them in place, and the recurrent states it returns (rwkv6,
zamba2) are copied in, cast to the ring's dtype as the JAX engine's
``_ring_write`` casts (the JAX engine donates the ring to a jitted
update).  As there, prefill starts from the slot's contents and the ring
keeps the decoded caches, so a recurrent slot seeds its next request's
prefill with the last request's state (ROADMAP C-R6).  The prefill runs
the layers' ``blockwise_attention``, as the JAX engine does, not the B12
kernel (``kernels.ops.roi_attention``).

Over a model axis above 1 (``dist`` on a ``launch.mesh.TrainMesh``)
each rank serves on its model shard of the parameters and of the ring
(``model.init_cache``), and every rank runs the same requests and
returns the same tokens.  The batch axes split nothing: the JAX engine
places nothing on them, so each batch rank serves the whole group, the
ring's batch rows whole (only the model split cuts the ring) -- but
under ``kv_seq_shard``, where the ring's sequence lies over the batch
axes too (``models.cache_layout``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import model as M
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace


@dataclass
class Request:
    rid: int
    tokens: Optional[np.ndarray] = None          # (S,) int prompt, or the
    #                                              (S, D) VLM patch stream
    patches: Optional[np.ndarray] = None         # (S_img, D) VLM stream
    keep: Optional[np.ndarray] = None            # (S,) bool RoI keep-list
    max_new_tokens: int = 16
    # deadline-batched serving (serve_deadline): the request's camera
    # group, and when it arrived at the server
    group: Optional[int] = None
    arrival_s: float = 0.0


@dataclass
class ServeReport:
    """Accounting from ``serve_deadline``: how request groups formed."""
    complete_flushes: int = 0        # group reached its expected size
    deadline_flushes: int = 0        # released early by the deadline
    straggler_requests: int = 0      # arrived after their group released
    release_s: Dict[int, float] = field(default_factory=dict)  # rid -> t

    def wait_s(self, req: "Request") -> float:
        """Batching delay this request paid in the group former."""
        return self.release_s[req.rid] - req.arrival_s


@dataclass
class RoIPrefillResult:
    logits: torch.Tensor
    caches: Any
    n_kept: int
    n_total: int

    @property
    def compute_fraction(self) -> float:
        return self.n_kept / max(self.n_total, 1)


def _round_up(x: int, block: int) -> int:
    return -(-x // block) * block


def _tree_map(fn, *trees):
    """``fn`` over the tensors of cache trees of one structure (dicts,
    tuples and tensors)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return tuple(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _write_slot(slot, new) -> None:
    """Copy what prefill returned into the ring's slot, cast to the ring's
    dtype (the JAX engine's ``_ring_write``).  KV caches written in place
    come back as the slot's own tensors and are left alone."""
    def put(s, n):
        if n is not s:
            s.copy_(n)
    _tree_map(put, slot, new)


class ServingEngine:
    """``params`` live on the device the engine serves from (the card in
    production; tests pass CPU parameters).  ``dist``: the JAX engine's
    ``DistContext``; over a model axis above 1 ``params`` is this rank's
    model shard (``Placement.shard`` of ``param_pspecs(cfg, specs,
    "tp")``), and the group is replicated over the batch axes."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: Dict,
                 dist=None):
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        # every batch rank serves the whole group: no batch axis splits
        # its rows, only the sequence under kv_seq_shard
        self.dist = None if dist is None or dist.mesh is None \
            else dist if dist.kv_seq_shard else replace(dist, batch_axes=())
        self.device = params["embed"].device
        # the persistent group cache ring: ``init_cache``'s tree at batch
        # G, one batch row a request, reused across flushes.  Stale KV rows
        # are harmless: decode attends only rows this request's prefill and
        # decode wrote (rows past the current position are masked).  Stale
        # recurrent states are not: they seed the next prefill (C-R6).
        self._ring = None
        self._ring_sig: Optional[Tuple[int, int]] = None
        self.ring_rebuilds = 0          # ring (re)allocations
        self.cache_stack_count = 0      # decode_tokens_group's stacks

    def _decode_group(self, tokens, caches, pos):
        """The group decode step: one batched dispatch for the whole
        group, ``pos`` a (G,) vector."""
        return M.decode_step(self.params, self.cfg, tokens, caches, pos,
                             dist=self.dist)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # -- plain prefill -----------------------------------------------------
    def prefill(self, batch: Dict, max_seq: Optional[int] = None,
                caches=None):
        """``caches`` (optional) supplies preallocated caches: ``serve``
        passes a slot of the persistent ring."""
        batch = {k: self._tensor(v) for k, v in batch.items()}
        B = next(iter(batch.values())).shape[0]
        max_seq = max_seq or self.scfg.max_seq
        if caches is None:
            caches = M.init_cache(self.cfg, B, max_seq, self.device,
                                  dist=self.dist)
        return M.prefill(self.params, self.cfg, batch, caches,
                         dist=self.dist)

    # -- RoI-packed prefill --------------------------------------------------
    def roi_prefill(self, tokens, keep, block: int = 128,
                    max_seq: Optional[int] = None,
                    caches=None) -> RoIPrefillResult:
        """tokens: (S,) or (S, D) stream; keep: (S,) bool.  Packs the kept
        tokens and prefills the packed prefix at their original positions.
        ``max_seq`` sizes the KV cache (>= the packed length; decode masks
        slots past the current position, so a longer cache is safe)."""
        tokens, keep = self._tensor(tokens), self._tensor(keep)
        S = tokens.shape[0]
        packed, positions, n_kept = kops.pack_tokens(tokens, keep, block)
        Sp = packed.shape[0]
        # padding rows carry PAD_POS: no real row attends them, their own
        # rows are discarded, and decode masks cache slots >= n_kept
        if packed.ndim == 1:
            batch = {"tokens": packed[None]}
        else:                         # a patch stream: the VLM frontend
            batch = {"tokens": torch.zeros((1, 0), dtype=torch.long,
                                           device=self.device),
                     "patches": packed[None]}
        if caches is None:
            caches = M.init_cache(self.cfg, 1, max(max_seq or Sp, Sp, 1),
                                  self.device, dist=self.dist)
        logits, caches = M.prefill(self.params, self.cfg, batch, caches,
                                   positions=positions[None],
                                   last_index=n_kept - 1, dist=self.dist)
        return RoIPrefillResult(logits, caches, n_kept, S)

    # -- decode ---------------------------------------------------------------
    def decode_tokens(self, caches, first_token: torch.Tensor, start_pos: int,
                      n_steps: int) -> Tuple[np.ndarray, Any]:
        B = first_token.shape[0]
        out = []
        tok = first_token.reshape(B, 1)
        for i in range(n_steps):
            logits, caches = M.decode_step(self.params, self.cfg, tok, caches,
                                           start_pos + i, dist=self.dist)
            tok = torch.argmax(logits[:, -1], dim=-1).reshape(B, 1)
            out.append(tok.to(torch.int32).cpu().numpy())
        return np.concatenate(out, axis=1), caches

    def decode_tokens_group(self, caches_list: List[Any],
                            first_tokens: List[torch.Tensor],
                            start_pos: List[int],
                            n_steps: int) -> Tuple[np.ndarray, Any]:
        """Greedy-decode G same-shape requests together.  caches_list:
        per-request caches (B = 1, allocated at a group-common max_seq).
        Returns (G, n_steps) tokens.  Stacks the per-request caches on
        every call (counted in ``cache_stack_count``); ``serve`` prefills
        straight into the persistent ring instead."""
        self.cache_stack_count += 1
        caches = _tree_map(lambda *xs: torch.cat(xs, dim=1), *caches_list)
        return self._decode_stacked(caches, first_tokens, start_pos, n_steps)

    def _decode_stacked(self, caches, first_tokens, start_pos,
                        n_steps: int) -> Tuple[np.ndarray, Any]:
        tok = torch.stack([self._tensor(t).reshape(1)
                           for t in first_tokens])            # (G, 1)
        pos0 = torch.as_tensor(start_pos, dtype=torch.int64,
                               device=self.device)            # (G,)
        out = []
        for i in range(n_steps):
            logits, caches = self._decode_group(tok, caches, pos0 + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]      # (G, 1)
            out.append(tok[:, 0].to(torch.int32).cpu().numpy())
        return np.stack(out, axis=1), caches

    # -- persistent group cache ring ------------------------------------------
    def _ensure_ring(self, G: int, max_seq: int):
        """(Re)allocate the group ring only when a flush needs a different
        group size or a longer sequence than it holds."""
        if (self._ring is None or self._ring_sig[0] != G
                or self._ring_sig[1] < max_seq):
            self._ring = None           # free the old ring first
            self._ring = M.init_cache(self.cfg, G, max_seq, self.device,
                                      dist=self.dist)
            self._ring_sig = (G, max_seq)
            self.ring_rebuilds += 1
        return self._ring

    # -- batched request driver ----------------------------------------------
    def serve(self, requests: List[Request], greedy_steps: int = 8
              ) -> Dict[int, np.ndarray]:
        """Group requests to ``max_batch``, prefill each (RoI-packed when
        it has a keep-list and ``roi_sparsity`` is on) into its slot of
        the persistent ring, then greedy-decode the group in lockstep, one
        batched step each.  Returns {rid: generated tokens}."""
        results: Dict[int, np.ndarray] = {}
        group: List[Request] = []
        with obs_trace.span("serve", requests=len(requests)):
            obs_metrics.SERVE_EVENTS.inc(len(requests), event="request")
            for r in requests:
                group.append(r)
                if len(group) >= self.scfg.max_batch:
                    self._flush_group(group, greedy_steps, results)
                    group = []
            self._flush_group(group, greedy_steps, results)
        return results

    def _flush_group(self, group: List[Request], greedy_steps: int,
                     results: Dict[int, np.ndarray]) -> None:
        """Prefill every request of ``group`` into the ring and decode the
        batch in lockstep (``serve`` and the deadline former)."""
        if not group:
            return
        pack_block = 128
        steps = [min(r.max_new_tokens, greedy_steps) for r in group]
        gsteps = max(steps)
        # group-common cache length: every packed or dense prompt plus the
        # GROUP's decode steps (a shorter budget must not let KV writes
        # clamp onto the cache end)
        need = []
        for r in group:
            if r.keep is not None and self.scfg.roi_sparsity:
                need.append(_round_up(len(r.tokens), pack_block) + gsteps)
            else:
                need.append(len(r.tokens) + gsteps)
        with obs_trace.span("serve_flush", batch=len(group),
                            decode_steps=gsteps):
            ring = self._ensure_ring(len(group), max(need))
            firsts, starts = [], []
            for gi, r in enumerate(group):   # ragged per-request packing
                slot = _tree_map(lambda t: t[:, gi:gi + 1], ring)
                if r.keep is not None and self.scfg.roi_sparsity:
                    res = self.roi_prefill(r.tokens, r.keep,
                                           block=pack_block, caches=slot)
                    logits, new_slot = res.logits, res.caches
                    starts.append(res.n_kept)
                else:
                    batch = {"tokens": np.asarray(r.tokens)[None]}
                    logits, new_slot = self.prefill(batch, caches=slot)
                    starts.append(len(r.tokens))
                firsts.append(torch.argmax(logits[:, -1], dim=-1))
                _write_slot(slot, new_slot)
            # the ring keeps the decoded caches for the next flush
            toks, self._ring = self._decode_stacked(ring, firsts, starts,
                                                    gsteps)
        for gi, (r, ns) in enumerate(zip(group, steps)):
            results[r.rid] = toks[gi, :ns]

    # -- deadline-based group forming -----------------------------------------
    def serve_deadline(self, requests: List[Request],
                       group_sizes: Dict[int, int],
                       deadline_s: float, greedy_steps: int = 8
                       ) -> Tuple[Dict[int, np.ndarray], ServeReport]:
        """Deadline-based group former over a timestamped request stream.
        Requests carry ``(group, arrival_s)``; a group flushes the moment
        ``group_sizes[gid]`` members are pending, or when its oldest
        pending member has waited ``deadline_s`` on the stream clock,
        which advances with each arrival.  Members that show up after
        their batch left are stragglers: they ride the group's next flush
        and are counted.  Each flush is one lockstep batch, as ``serve``'s."""
        results: Dict[int, np.ndarray] = {}
        report = ServeReport()
        pending: Dict[int, List[Request]] = {}
        # after a deadline flush releases k of a group's N members, the
        # next N - k arrivals of that group are that cycle's stragglers;
        # a complete flush clears the quota
        late_quota: Dict[int, int] = {}

        def flush(gid: int, now: float, by_deadline: bool) -> None:
            members = pending.pop(gid, [])
            if not members:
                return
            obs_metrics.BACKLOG_DEPTH.observe(len(members))
            obs_metrics.SERVE_EVENTS.inc(
                1, event="deadline_flush" if by_deadline
                else "complete_flush")
            self._flush_group(members, greedy_steps, results)
            for r in members:
                report.release_s[r.rid] = now
            if by_deadline:
                report.deadline_flushes += 1
                late_quota[gid] = (group_sizes.get(gid, self.scfg.max_batch)
                                   - len(members))
            else:
                report.complete_flushes += 1
                late_quota[gid] = 0

        with obs_trace.span("serve_deadline", requests=len(requests)):
            obs_metrics.SERVE_EVENTS.inc(len(requests), event="request")
            for r in sorted(requests, key=lambda r: r.arrival_s):
                now = r.arrival_s
                # deadlines that expired while the stream was quiet
                for gid in list(pending):
                    oldest = min(m.arrival_s for m in pending[gid])
                    if now - oldest >= deadline_s:
                        flush(gid, oldest + deadline_s, by_deadline=True)
                gid = r.group if r.group is not None else -1
                if late_quota.get(gid, 0) > 0:
                    report.straggler_requests += 1
                    obs_metrics.SERVE_EVENTS.inc(1,
                                                 event="straggler_request")
                    late_quota[gid] -= 1
                pending.setdefault(gid, []).append(r)
                if len(pending[gid]) >= group_sizes.get(
                        gid, self.scfg.max_batch):
                    flush(gid, now, by_deadline=False)
            for gid in list(pending):
                oldest = min(m.arrival_s for m in pending[gid])
                flush(gid, oldest + deadline_s, by_deadline=True)
        return results, report
