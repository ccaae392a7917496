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

The JAX package's sharded runtime (``repro.fleet.sharded``) calls four
Pallas kernels under module-level names inside ``shard_map`` programs.
The ``jax_sharded_oracle`` fixture swaps them for traceable jnp
compositions (``install_sharded_shims``), which count nothing: the
runtime counts each kernel itself, once per step.  ``run_jax_sharded``
runs a script against the shimmed runtime in a subprocess with several
forced host devices, as ``tests/test_sharded.py`` runs its multi-shard
case.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tile_delta as jtile_delta
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


# ---------------------------------------------------------------------------
# the sharded runtime's four kernels as traceable jnp
# ---------------------------------------------------------------------------

def _sh_gate(xp, ref_c, idx, th, tw, qstep=8.0, coef_bits=6, run_bits=10,
             block=1, interpret=True):
    """``tile_delta_gate_canvas``: the body and window stats of the
    kernel's ``_batched_stats`` on the gathered window pairs, and the
    exact ``!=`` count."""
    cur = jops.gather_windows(xp, idx, th, tw)
    prev = jops.gather_windows(ref_c, idx, th, tw)
    body = jtile_delta._batched_stats(cur[:, 1:1 + th, 1:1 + tw],
                                      prev[:, 1:1 + th, 1:1 + tw], qstep,
                                      coef_bits, run_bits)
    win_bytes = jtile_delta._batched_stats(cur, prev, qstep, coef_bits,
                                           run_bits)[0]
    exact = jnp.sum((cur != prev).astype(jnp.int32), axis=(1, 2, 3))
    out = jnp.zeros((idx.shape[0], 8), jnp.int32)
    for c, v in enumerate(body):
        out = out.at[:, c].set(v)
    return out.at[:, jops.GATE_WIN_EXACT].set(exact) \
              .at[:, jops.GATE_WIN_BYTES].set(win_bytes)


def _sh_entry(x, w, idx, th, tw, block=1, interpret=True):
    """``roi_conv_entry``: the SAME-padded frames' haloed windows, a VALID
    3x3 conv, ReLU."""
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    win = jops.gather_windows(xp, idx, th, tw)
    return jax.nn.relu(jax.lax.conv_general_dilated(
        win, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")))


def _sh_stack(packed, ws, nbr, block=128, interpret=True):
    """``roi_conv_stack``: the ``assemble_rims`` layers, each with ReLU."""
    for w in ws:
        packed = jax.nn.relu(_packed_layer(packed, w, nbr))
    return packed


def _sh_scatter(packed, idx, base, block=1, interpret=True):
    """``sbnet_scatter_changed``: the rows in order, each tile written over
    ``base`` (a later row wins a shared target)."""
    th, tw = packed.shape[1:3]

    def one(i, b):
        r = idx[i]
        return jax.lax.dynamic_update_slice(
            b, packed[i][None], (r[0], r[1] * th, r[2] * tw, 0))

    return jax.lax.fori_loop(0, packed.shape[0], one, base)


SHARDED_SHIMS = {"_raw_gate_canvas": _sh_gate, "_raw_entry": _sh_entry,
                 "_raw_stack": _sh_stack,
                 "_raw_scatter_changed": _sh_scatter}


def install_sharded_shims(setattr_fn=setattr):
    """Swap the four kernels of ``repro.fleet.sharded`` for the jnp
    compositions above (``setattr_fn``: a monkeypatch's ``setattr`` in a
    test, plain ``setattr`` in a subprocess)."""
    from repro.fleet import sharded as jsharded
    for name, fn in SHARDED_SHIMS.items():
        setattr_fn(jsharded, name, fn)


@pytest.fixture
def jax_sharded_oracle(monkeypatch):
    install_sharded_shims(monkeypatch.setattr)


def run_jax_sharded(script: str, devices: int = 2, timeout: int = 600):
    """Run ``script`` in a fresh interpreter that sees ``devices`` host
    devices, with ``src/`` and ``tests/`` importable and the sharded
    shims installed; returns its standard output."""
    tests = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(tests)
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(root, "src"), tests])
    code = ("from torch_jax_oracle import install_sharded_shims\n"
            "install_sharded_shims()\n" + textwrap.dedent(script))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, \
        f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    return r.stdout
