"""Build and load the CUDA kernels under ``csrc/``.

Each ``.cu`` file has a plain C interface.  At first use every source is
compiled by its own ``nvcc`` process, all started together, for
``sm_90a`` (no ``--use_fast_math``: the gate's rounding and the
convolutions' bits must stay exact), and the objects are linked into one
shared library that is loaded with ``ctypes``.  The library lives under ``build/repro_torch/<hash>/`` at the
root of the checkout, keyed on a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.

``LAUNCHES`` counts kernel launches under the counter name of the TPU
kernel each one replaces (``sbnet_scatter_fleet`` for the scatter that
also serves the changed-only scatter).  Each wrapper adds one right after
its kernel was launched and nowhere else, so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("tile_delta_gate.cu", "tile_delta.cu", "roi_conv_entry.cu",
           "roi_conv_stack.cu", "roi_conv_layers.cu", "sbnet.cu",
           "roi_attention.cu")
HEADERS = ("tile_delta_common.cuh", "roi_conv_layer.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# sources whose ptxas report (registers, shared memory, spills per kernel
# instance) is kept beside the library as ``ptxas.log``
PTXAS_VERBOSE = ("roi_attention.cu", "roi_conv_entry.cu",
                 "roi_conv_stack.cu", "roi_conv_layers.cu",
                 "tile_delta_gate.cu", "tile_delta.cu")

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _declare(lib: ctypes.CDLL) -> None:
    """Argument and result types of the C entry points.  Each launcher
    returns the cudaError_t of its launch as an int."""
    # cur, ref, idx, out, n, C, Hp, Wp, Cin, th, tw, qstep, coef, run, stream
    lib.tile_delta_gate_canvas_launch.argtypes = \
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
    # cur, ref_win, idx, out, win, n, C, Hp, Wp, Cin, th, tw, qstep, coef,
    # run, stream
    lib.tile_delta_gate_launch.argtypes = \
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
    # Cin, th, tw, Wp, cur, ref, win -> 1 for the detector's instance, 0
    # generic
    lib.tile_delta_gate_route.argtypes = [_I, _I, _I, _I, _P, _P, _P]
    # cur, prev, idx, out, n, H, W, C, th, tw, qstep, coef, run, stream
    for f in (lib.tile_delta_launch, lib.tile_delta_halo_launch):
        f.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
    # C, th, tw, W, cur, prev -> 1 for the detector's instance, 0 generic
    lib.tile_delta_route.argtypes = [_I, _I, _I, _I, _P, _P]
    # x, w, idx, out, n, C (B frames for roi_conv), H, W, Cin, Cout, th,
    # tw, stream
    for f in (lib.roi_conv_entry_launch, lib.roi_conv_fleet_launch,
              lib.roi_conv_launch):
        f.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    # Cin, Cout, th, tw, W, x -> 1 for the detector's instance, 0 generic
    lib.roi_conv_entry_route.argtypes = [_I, _I, _I, _I, _I, _P]
    # packed, wcat, chans (host int array), nbr, out, n, th, tw, L,
    # relu_last, stream
    lib.roi_conv_stack_launch.argtypes = \
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    # packed, wcat, chans (host int array), chans (on the card), nbr, act0,
    # act1, out, n, th, tw, L, stream
    lib.roi_conv_layers_launch.argtypes = \
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    # chans (host int array), L, th, tw -> bytes of shared memory per CTA
    for f in (lib.roi_conv_stack_smem_bytes, lib.roi_conv_layers_smem_bytes):
        f.argtypes = [_P, _I, _I, _I]
    # packed, idx, base, n, th, tw, A, C, H, W, stream
    lib.sbnet_scatter_fleet_launch.argtypes = \
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    # packed, idx, base / x, idx, out; n, th, tw, A, H, W, stream
    for f in (lib.sbnet_scatter_launch, lib.sbnet_gather_launch):
        f.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    # q, k, v, positions, kmin, out, visited, S, H, D, bq, bk, causal_skip,
    # bf16, scale, stream
    lib.roi_attention_launch.argtypes = \
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    for f in (lib.tile_delta_gate_canvas_launch, lib.tile_delta_gate_launch,
              lib.tile_delta_gate_route, lib.tile_delta_launch,
              lib.tile_delta_halo_launch, lib.tile_delta_route,
              lib.roi_conv_entry_launch, lib.roi_conv_fleet_launch,
              lib.roi_conv_launch, lib.roi_conv_entry_route,
              lib.roi_conv_stack_launch,
              lib.roi_conv_stack_smem_bytes, lib.roi_conv_layers_launch,
              lib.roi_conv_layers_smem_bytes, lib.sbnet_scatter_fleet_launch,
              lib.sbnet_scatter_launch, lib.sbnet_gather_launch,
              lib.roi_attention_launch):
        f.restype = ctypes.c_int
    lib.repro_cuda_error_name.argtypes = [_I]
    lib.repro_cuda_error_name.restype = ctypes.c_char_p


_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:                       # one nvcc per source, all at once
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(CSRC / name),
               "-o", str(obj)]
        if name in PTXAS_VERBOSE:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed, reports = [], []
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name}\n{log}")
        elif name in PTXAS_VERBOSE:
            reports.append(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    (out_dir / "ptxas.log").write_text("".join(reports))
    objs = [str(out_dir / (Path(n).stem + ".o")) for n in SOURCES]
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / "libkernels.so"),
         *objs], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = BUILD_ROOT / _digest()
        so = target / "libkernels.so"
        if not so.exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
            try:
                _compile(tmp)
                try:
                    os.replace(tmp, target)     # atomic: the first one wins
                except OSError:
                    if not so.exists():
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _LIB = lib
        return lib


def ptxas_report() -> list:
    """(kernel, registers, static shared-memory bytes, spill-store bytes,
    spill-load bytes) for each kernel instance of ``PTXAS_VERBOSE``, from
    the ptxas log the build kept; names as the compiler mangled them."""
    library()
    rows, name, spills = [], None, (0, 0)
    log = BUILD_ROOT / _digest() / "ptxas.log"
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2) or 0),
                         *spills))
            name, spills = None, (0, 0)
    return rows


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        what = library().repro_cuda_error_name(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {what} ({err})")


def stream_handle(device: torch.device) -> int:
    """The current PyTorch stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def cuda_device(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raises otherwise.  The
    launchers make it the current device around their launch, since a
    kernel launches on the calling thread's current device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: takes CUDA or CPU tensors, not {dev}")
    return dev


def expect(name: str, arg: str, t: torch.Tensor, dtype: torch.dtype,
           shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    (``None`` entries match any size)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
    if t.ndim != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
