"""The JAX oracle of the port's tests: the JAX package's kernel wrappers
swapped for ``repro.kernels.ref`` and pure jnp.

The JAX package's Pallas kernels do not trace on this jax, so the tests
that run its detector (``test_torch_fleet.py``, ``test_torch_transport.py``,
``test_torch_obs.py``) take the ``jax_oracle`` fixture: it swaps
(``monkeypatch``) the ten kernel wrappers the detector calls for
compositions of ``repro.kernels.ref`` and pure jnp that also count their
dispatches, as the real wrappers do.  Import the fixture into a test
module with ``from torch_jax_oracle import jax_oracle``.
``detector_pair`` builds the two packages' detectors on the same
weights.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.roi_conv import assemble_rims
from repro.serving import detector as jdet
from repro_torch.serving import detector as tdet


# ---------------------------------------------------------------------------
# the ten detector-facing wrappers as ref compositions
# ---------------------------------------------------------------------------

def _by_camera(idx):
    idx = np.asarray(idx)
    for c in np.unique(idx[:, 0]):
        rows = np.nonzero(idx[:, 0] == c)[0]
        yield int(c), rows, jnp.asarray(idx[rows, 1:])


def _fleet_conv_body(x, w, idx, th, tw):
    out = jnp.zeros((idx.shape[0], th, tw, w.shape[-1]), x.dtype)
    for c, rows, cidx in _by_camera(idx):
        out = out.at[rows].set(jref.roi_conv(x[c], w, cidx, th, tw))
    return out


def _entry(x, w, idx, th, tw, block=1, interpret=True):
    if idx.shape[0] == 0:
        return jnp.zeros((0, th, tw, w.shape[-1]), x.dtype)
    jops.record_dispatch("roi_conv_entry")
    return jax.nn.relu(_fleet_conv_body(x, w, idx, th, tw))


def _packed_layer(packed, w, nbr):
    """One packed layer, no ReLU: halo rims from the neighbour table (zero
    at -1 slots), a VALID conv."""
    rt, rb, rl, rr = assemble_rims(packed, jnp.asarray(nbr))
    mid = jnp.concatenate([rl[:, :, None], packed, rr[:, :, None]], axis=2)
    win = jnp.concatenate([rt[:, None], mid, rb[:, None]], axis=1)
    return jax.lax.conv_general_dilated(
        win, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _stack(packed, ws, nbr, block=128, interpret=True):
    jops.record_dispatch("roi_conv_stack")
    for w in ws:
        packed = jax.nn.relu(_packed_layer(packed, w, nbr))
    return packed


# the per-layer and single-camera wrappers: the JAX package counts them
# whatever the row count
def _roi_conv(x, w, idx, th, tw, interpret=True):
    jops.record_dispatch("roi_conv")
    return jref.roi_conv(x, w, idx, th, tw)


def _fleet_conv(x, w, idx, th, tw, interpret=True):
    jops.record_dispatch("roi_conv_fleet")
    return _fleet_conv_body(x, w, idx, th, tw)


def _roi_conv_packed(packed, w, nbr, interpret=True):
    jops.record_dispatch("roi_conv_packed")
    return _packed_layer(packed, w, nbr)


def _scatter_one(packed, idx, base, interpret=True):
    jops.record_dispatch("sbnet_scatter")
    th, tw = packed.shape[1:3]
    return jref.sbnet_scatter(packed, idx, base, th, tw)


def _scatter(name):
    def scatter(packed, idx, base, block=1, interpret=True, donate=False):
        if packed.shape[0] == 0:
            return base
        jops.record_dispatch(name)
        th, tw = packed.shape[1:3]
        for c, rows, cidx in _by_camera(idx):
            base = base.at[c].set(jref.sbnet_scatter(
                packed[jnp.asarray(rows)], cidx, base[c], th, tw))
        return base
    return scatter


def _gate(cur_p, ref_c, idx, th, tw, qstep=8.0, coef_bits=6, run_bits=10,
          block=1, interpret=True):
    jops.record_dispatch("tile_delta_gate")
    return jnp.asarray(jref.tile_delta_gate(
        np.asarray(cur_p)[:, 1:-1, 1:-1], np.asarray(ref_c)[:, 1:-1, 1:-1],
        np.asarray(idx), th, tw, qstep, coef_bits, run_bits))


def _gate_packed(cur_p, ref_win, idx, th, tw, qstep=8.0, coef_bits=6,
                 run_bits=10, block=1, interpret=True):
    """The packed gate: per row, ``ref.tile_delta`` over the body and over
    the whole window of the (current, reference) window pair."""
    jops.record_dispatch("tile_delta_gate")
    cw = np.asarray(jops.gather_windows(cur_p, jnp.asarray(idx), th, tw))
    one = np.zeros((1, 2), np.int32)
    rows = np.zeros((cw.shape[0], 8), np.int32)
    for i, (c, p) in enumerate(zip(cw, np.asarray(ref_win))):
        body = jref.tile_delta(c[1:-1, 1:-1], p[1:-1, 1:-1], one, th, tw,
                               qstep, coef_bits, run_bits)[0]
        win = jref.tile_delta(c, p, one, th + 2, tw + 2, qstep, coef_bits,
                              run_bits)[0]
        rows[i, :4] = body[:4]
        rows[i, 4] = int((c != p).sum())
        rows[i, 5] = win[0]
    return jnp.asarray(rows), jnp.asarray(cw)


@pytest.fixture
def jax_oracle(monkeypatch):
    monkeypatch.setattr(jops, "roi_conv_entry", _entry)
    monkeypatch.setattr(jops, "roi_conv_stack", _stack)
    monkeypatch.setattr(jops, "sbnet_scatter_fleet",
                        _scatter("sbnet_scatter_fleet"))
    monkeypatch.setattr(jops, "sbnet_scatter_changed",
                        _scatter("sbnet_scatter_changed"))
    monkeypatch.setattr(jops, "tile_delta_gate_canvas", _gate)
    monkeypatch.setattr(jops, "tile_delta_gate", _gate_packed)
    monkeypatch.setattr(jops, "roi_conv", _roi_conv)
    monkeypatch.setattr(jops, "roi_conv_fleet", _fleet_conv)
    monkeypatch.setattr(jops, "roi_conv_packed", _roi_conv_packed)
    monkeypatch.setattr(jops, "sbnet_scatter", _scatter_one)


def detector_pair(seed=0, channels=(8, 16, 16), tile=8):
    """The JAX package's detector from ``PRNGKey(seed)`` and the port's
    with the same weights, on the CPU."""
    jd = jdet.RoIDetector(jdet.DetectorConfig(channels=channels, tile=tile),
                          jax.random.PRNGKey(seed))
    td = tdet.RoIDetector.from_numpy(
        tdet.DetectorConfig(channels=channels, tile=tile),
        [np.asarray(w) for w in jd.weights], np.asarray(jd.head),
        device="cpu")
    return jd, td
