"""Checkpointing with elastic restore, the port's copy of
``repro.checkpoint.ckpt`` with the same layout on disk::

    <dir>/step_000123/
        MANIFEST.json     -- step, per group each leaf's file, shape, dtype
        arrays/<group>__<name>.npy -- one file per leaf (the full array)
        COMMIT            -- written last; a step without it is torn and
                             ignored

Leaf names are the JAX package's: dict keys in sorted order, NamedTuple
fields in field order written with a leading dot (``opt/.m/embed``),
list and tuple indices; so a checkpoint of either package loads in the
other.  bfloat16 leaves are stored as their raw ``uint16`` view under the
dtype name ``"bfloat16"``.

Restore is elastic: leaves load as full arrays, fresh tensors on the
target device, and a placement tree (``distributed.shardings.named``)
cuts each into this rank's shard, whatever mesh saved them.  Templates
are trees of tensors whose shapes the files must match (``meta`` tensors
serve).  ``CheckpointManager.save`` snapshots to host memory before it
returns and writes in a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def _items(tree):
    """(key, child) of one level of a tree, or None at a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{leaf name: leaf}, names as the JAX package's ``_flatten`` gives
    them, in its order."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for key, child in items:
        flat.update(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return flat


def _unflatten(template, leaves, prefix: str = ""):
    """``template``'s structure with ``leaves[name]`` at each leaf."""
    items = _items(template)
    if items is None:
        return leaves[prefix]
    kids = [_unflatten(c, leaves, f"{prefix}/{k}" if prefix else k)
            for k, c in items]
    if isinstance(template, dict):          # in the template's key order
        got = {k: v for (k, _), v in zip(items, kids)}
        return {k: got[str(k)] for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*kids)
    return type(template)(kids)


def _snapshot(leaf):
    """A leaf's copy in host memory: a CPU tensor, or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _array(leaf) -> Tuple[np.ndarray, bool]:
    """(the leaf as a numpy array, whether it is bfloat16 stored as its
    raw uint16 view)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), False
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def save_checkpoint(directory: str, step: int, trees: Dict[str, Any]):
    """trees: {"state": ..., ...} trees of tensors or numpy arrays."""
    d = os.path.join(directory, f"step_{step:06d}")
    arrays = os.path.join(d, "arrays")
    os.makedirs(arrays, exist_ok=True)
    manifest = {"step": step, "groups": {}}
    for group, tree in trees.items():
        names = {}
        for name, leaf in _flatten(tree).items():
            arr, bf16 = _array(leaf)
            fname = f"{group}__{name.replace('/', '__')}.npy"
            np.save(os.path.join(arrays, fname), arr)
            names[name] = {"file": fname, "shape": list(arr.shape),
                           "dtype": "bfloat16" if bf16 else str(arr.dtype)}
        manifest["groups"][group] = names
    with open(os.path.join(d, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(d, "COMMIT"), "w") as f:
        f.write("ok")


def _complete_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "COMMIT")):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _tensor(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """A fresh tensor on ``device`` from a loaded array."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device.type != "cpu" else t


def load_checkpoint(directory: str, template: Dict[str, Any],
                    step: Optional[int] = None,
                    shardings: Optional[Dict[str, Any]] = None,
                    device=None) -> Tuple[int, Dict[str, Any]]:
    """Restore trees shaped like ``template`` (the latest complete step
    unless ``step`` is given) as fresh tensors on ``device`` (the card
    unless the caller passes another, ``resolve_device``); with
    ``shardings`` ({group: a placement tree}) each leaf becomes this
    rank's shard.  A leaf whose shape is not the template's raises
    AssertionError.  Returns (step, trees)."""
    device = resolve_device(device)
    steps = _complete_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    step = steps[-1] if step is None else step
    d = os.path.join(directory, f"step_{step:06d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    out = {}
    for group, tmpl in template.items():
        names = manifest["groups"][group]
        places = _flatten(shardings[group]) if shardings and \
            shardings.get(group) is not None else {}
        restored = {}
        for name, leaf in _flatten(tmpl).items():
            info = names[name]
            arr = np.load(os.path.join(d, "arrays", info["file"]))
            assert tuple(arr.shape) == tuple(leaf.shape), \
                f"{group}/{name}: ckpt {arr.shape} vs template " \
                f"{tuple(leaf.shape)}"
            t = _tensor(arr, info["dtype"], device)
            restored[name] = places[name].shard(t) if name in places else t
        out[group] = _unflatten(tmpl, restored)
    return step, out


@dataclass
class CheckpointManager:
    """Saves every call's trees, keeps the newest ``keep`` steps.
    ``last_snapshot_s``: the newest save's host snapshot, in seconds;
    ``write_s``: each finished save's file write."""
    directory: str
    keep: int = 3
    async_save: bool = True
    last_snapshot_s: float = 0.0
    write_s: List[float] = field(default_factory=list)
    _thread: Optional[threading.Thread] = field(default=None, repr=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, trees: Dict[str, Any]):
        self.wait()
        t0 = time.perf_counter()
        # snapshot to host before returning (only the file I/O is async):
        # the parameters and moments are updated in place afterwards
        host = {g: _unflatten(t, {n: _snapshot(v) for n, v in
                                  _flatten(t).items()})
                for g, t in trees.items()}
        self.last_snapshot_s = time.perf_counter() - t0

        def run():
            t1 = time.perf_counter()
            save_checkpoint(self.directory, step, host)
            self._gc()
            self.write_s.append(time.perf_counter() - t1)

        if self.async_save:
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            run()

    def restore(self, template, shardings=None, step=None, device=None):
        self.wait()
        return load_checkpoint(self.directory, template, step, shardings,
                               device)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = _complete_steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self):
        steps = _complete_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:06d}"),
                          ignore_errors=True)
