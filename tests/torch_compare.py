"""Structural equality between the port's host objects and the JAX
package's: the port copies ``repro.core``, ``repro.net`` and ``repro.obs``
into ``repro_torch``, so the same seeded call must give the same values
in objects of same-named classes.

``assert_same(port, ref)`` walks dataclasses (by field, class names
equal), dicts, sequences, sets and numpy arrays.  Integers, bools,
strings and arrays must be equal (arrays also in dtype and shape, with
NaNs equal); floats must be ``==`` (NaN equals NaN).  Fields named in
``skip`` (by default the host wall clocks, ``wall_s``) are not compared:
they time the run, not its result."""
import dataclasses
import math

import numpy as np

WALL_FIELDS = frozenset({"wall_s"})


def assert_same(port, ref, path="", skip=WALL_FIELDS):
    if dataclasses.is_dataclass(ref) and not isinstance(ref, type):
        assert type(port).__name__ == type(ref).__name__, \
            f"{path}: {type(port).__name__} vs {type(ref).__name__}"
        for f in dataclasses.fields(ref):
            if f.name in skip:
                continue
            assert_same(getattr(port, f.name), getattr(ref, f.name),
                        f"{path}.{f.name}", skip)
        return
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), f"{path}: {type(port)}"
        assert port.dtype == ref.dtype and port.shape == ref.shape, \
            f"{path}: {port.dtype}{port.shape} vs {ref.dtype}{ref.shape}"
        assert np.array_equal(port, ref,
                              equal_nan=ref.dtype.kind in "fc"), path
        return
    if isinstance(ref, dict):
        assert isinstance(port, dict), f"{path}: {type(port)}"
        assert list(port) == list(ref), f"{path}: keys differ"
        for k in ref:
            assert_same(port[k], ref[k], f"{path}[{k!r}]", skip)
        return
    if isinstance(ref, (list, tuple)):
        assert type(port) is type(ref), f"{path}: {type(port)}"
        assert len(port) == len(ref), f"{path}: {len(port)} vs {len(ref)}"
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{path}[{i}]", skip)
        return
    if isinstance(ref, (set, frozenset)):
        assert type(port) is type(ref) and port == ref, path
        return
    if isinstance(ref, (float, np.floating)):
        assert isinstance(port, (float, np.floating)), f"{path}: {port!r}"
        assert port == ref or (math.isnan(port) and math.isnan(ref)), \
            f"{path}: {port!r} vs {ref!r}"
        return
    assert type(port) is type(ref) and port == ref, \
        f"{path}: {port!r} vs {ref!r}"
