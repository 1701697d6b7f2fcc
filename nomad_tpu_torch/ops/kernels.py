"""Build and bind the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc -gencode arch=compute_90a,code=sm_90a`
into a CPython extension module named after it, whose functions are the
source's `extern "C"` launchers (`PY_LAUNCHERS`, csrc/py_launchers.cuh:
arguments go from Python ints to the launchers' own parameter types;
only Python.h is included, no PyTorch headers, so a build takes
seconds).  All sources build together, one `nvcc` process each, at the
first launch of any kernel; the modules land in `BUILD_DIR` (listed in
.gitignore) under a name carrying a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.  Each source built
is noted in the compile ledger (core/profiling.COMPILE) as a miss on
`kernels.nvcc/<source>`.  The native bridge's library (csrc/bridge.cu
with the two sources it drives, no Python) builds the same way, at its
first use or with `build_all(bridge=True)`, as `kernels.nvcc/bridge`.

Each `Kernel` carries `launches`, the count its wrappers bump once per
launch of the CUDA kernel (never for the plain version), so a run can
show that the main path went through the kernel.

The launch path is kept lean, since the small kernels' wall time is
mostly host time: a `Kernel` binds its launchers on first use and keeps
them (no lock, no module lookup after that), a launcher converts its
arguments in C (METH_FASTCALL, not ctypes), and `Kernel.launch` reads
the raw `cudaStream_t` without building a `torch.cuda.Stream` and
enters a device guard only for a device other than the current one.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# -fmad=false: no multiply-add contraction the source does not spell out
# (the reference's XLA fuses some and not others; the kernels write each
# fma it has as __fmaf_rn)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# every source with launchers (the .cuh headers are included by them)
SOURCES = ("compact_rounds.cu", "landscape.cu", "place_scan.cu",
           "preempt.cu", "scatter_add.cu")
# the native bridge's library (csrc/bridge.cu, native/bridge.py): the
# sources it links, with PY_LAUNCHERS compiled out, and cudart only
BRIDGE_SOURCES = ("bridge.cu", "landscape.cu", "compact_rounds.cu")
BRIDGE_FLAGS = ("-DNTB_NO_PYTHON",)
# PyTorch's current CUDA device and the raw handle of a device's current
# stream (PyTorch's generated Triton launchers read it the same way);
# None in a CPU build, where nothing launches
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class Kernel:
    """One hand-written kernel: its source, the TPU-side function it
    replaces, and the launch count of its wrappers."""

    def __init__(self, name: str, source: str, replaces: str) -> None:
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fns: Dict[str, object] = {}

    def fn(self, symbol: str):
        """The launcher `symbol` of this kernel's module (built and
        loaded at the first call, then kept here): it takes the
        launcher's C arguments as Python ints (a pointer may be None)
        and returns its cudaError."""
        f = self._fns.get(symbol)
        if f is None:
            f = self._fns[symbol] = getattr(_library(self.source), symbol)
        return f

    def launch(self, device: int, symbol: str, *args) -> None:
        """Call one launcher on PyTorch's current stream of the CUDA
        device with index `device` (the stream is its last argument),
        under a device guard only when that is not the current device,
        and raise when CUDA refused the launch."""
        f = self._fns.get(symbol) or self.fn(symbol)
        if device == _current_device():
            rc = f(*args, _raw_stream(device))
        else:
            with torch.cuda.device(device):
                rc = f(*args, _raw_stream(device))
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch of {symbol} failed with "
                f"cudaError {rc}")
        self.launches += 1


LANDSCAPE = Kernel("landscape", "landscape.cu",
                   "nomad_tpu/ops/feasibility.py:29")
MULTI_COMPACT = Kernel("multi_compact", "compact_rounds.cu",
                       "nomad_tpu/ops/select.py:836")
MULTI_FLAT = Kernel("multi_flat", "compact_rounds.cu",
                    "nomad_tpu/ops/select.py:733")
SCATTER_ADD = Kernel("scatter_add", "scatter_add.cu",
                     "nomad_tpu/ops/engine.py:50")
PLACE_SCAN = Kernel("place_scan", "place_scan.cu",
                    "nomad_tpu/ops/select.py:297")
MULTI_BULK = Kernel("multi_bulk", "compact_rounds.cu",
                    "nomad_tpu/ops/select.py:554")
PREEMPT_BULK = Kernel("preempt_bulk", "preempt.cu",
                      "nomad_tpu/ops/preempt.py:108")
FEASIBLE = Kernel("feasible_mask", "landscape.cu",
                  "nomad_tpu/ops/feasibility.py:75")
# the node-sharded mesh on one card (parallel/mesh.py)
PLACE_SCAN_SHARDED = Kernel("place_scan_sharded", "place_scan.cu",
                            "nomad_tpu/parallel/mesh.py:221")
MULTI_BULK_SHARDED = Kernel("multi_bulk_sharded", "compact_rounds.cu",
                            "nomad_tpu/parallel/mesh.py:645")
MULTI_FLAT_SHARDED = Kernel("multi_flat_sharded", "compact_rounds.cu",
                            "nomad_tpu/parallel/mesh.py:454")
MULTI_COMPACT_SHARDED = Kernel("multi_compact_sharded",
                               "compact_rounds.cu",
                               "nomad_tpu/parallel/mesh.py:590")
SCATTER_ADD_SHARDED = Kernel("scatter_add_sharded", "scatter_add.cu",
                             "nomad_tpu/ops/engine.py:96")
# the mesh across parts (parallel/xmesh.py): one launch a part, the parts
# meeting through a hand-written exchange (csrc/xmesh.cuh)
PLACE_SCAN_XMESH = Kernel("place_scan_xmesh", "place_scan.cu",
                          "nomad_tpu/parallel/mesh.py:221")
MULTI_BULK_XMESH = Kernel("multi_bulk_xmesh", "compact_rounds.cu",
                          "nomad_tpu/parallel/mesh.py:645")
MULTI_FLAT_XMESH = Kernel("multi_flat_xmesh", "compact_rounds.cu",
                          "nomad_tpu/parallel/mesh.py:454")
MULTI_COMPACT_XMESH = Kernel("multi_compact_xmesh", "compact_rounds.cu",
                             "nomad_tpu/parallel/mesh.py:590")
SCATTER_ADD_XMESH = Kernel("scatter_add_xmesh", "scatter_add.cu",
                           "nomad_tpu/ops/engine.py:96")
KERNELS = (LANDSCAPE, MULTI_COMPACT, MULTI_FLAT, SCATTER_ADD, PLACE_SCAN,
           MULTI_BULK, PREEMPT_BULK, FEASIBLE, PLACE_SCAN_SHARDED,
           MULTI_BULK_SHARDED, MULTI_FLAT_SHARDED, MULTI_COMPACT_SHARDED,
           SCATTER_ADD_SHARDED, PLACE_SCAN_XMESH, MULTI_BULK_XMESH,
           MULTI_FLAT_XMESH, MULTI_COMPACT_XMESH, SCATTER_ADD_XMESH)

_lock = threading.Lock()
_bridge_lock = threading.Lock()
_libs: Dict[str, object] = {}
build_seconds: Optional[float] = None


def _sources_hash(extra=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra)).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def bridge_path() -> Path:
    """Where the native bridge's library (csrc/bridge.cu) lies once
    built: BUILD_DIR, under a hash of the sources and its flags."""
    return BUILD_DIR / f"libnomad_tpu_bridge.{_sources_hash(BRIDGE_FLAGS)}.so"


def _targets(sources, bridge: bool):
    """name -> (library path, nvcc arguments after the flags) of each
    target to build: an extension module per source, and the bridge's
    library."""
    tag = _sources_hash()
    py_include = sysconfig.get_paths()["include"]
    out = {src: (BUILD_DIR / f"{Path(src).stem}.{tag}.so",
                 ["-I", py_include, str(CSRC / src)]) for src in sources}
    if bridge:
        out["bridge"] = (bridge_path(), [
            *BRIDGE_FLAGS, *[str(CSRC / src) for src in BRIDGE_SOURCES]])
    return out


def _build(targets) -> Dict[str, Path]:
    """Compile every target that has no current library yet, one `nvcc`
    process each, all started together.  Returns the library paths by
    target name; raises with nvcc's output when a build fails."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: t for name, t in targets.items() if not t[0].exists()}
    t0 = time.perf_counter()
    procs = {}
    nvcc = _nvcc() if todo else ""
    for name, (p, args) in todo.items():
        tmp = p.with_name(p.name + f".{os.getpid()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), *args],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, targets[name][0])
    if failed:
        logs = "\n".join(
            targets[s][0].with_suffix(".log").read_text()[-4000:]
            for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    if todo:
        build_seconds = time.perf_counter() - t0
        # the port's analogue of a jit compile: one miss per target built,
        # each with its share of the parallel build's seconds (a cached
        # build notes nothing)
        from nomad_tpu_torch.core.profiling import COMPILE
        for name in todo:
            COMPILE.note_miss(f"kernels.nvcc/{name}",
                              build_seconds / len(todo))
    return {name: t[0] for name, t in targets.items()}


def build_all(bridge: bool = False) -> Dict[str, Path]:
    """Compile every source that has no current library yet (and, with
    `bridge`, the native bridge's library under the name "bridge"), one
    `nvcc` process each, all started together.  Returns the library
    paths by name; raises with nvcc's output when a build fails."""
    return _build(_targets(SOURCES, bridge))


def build_bridge() -> Path:
    """The native bridge's library, built at its first use: one `nvcc
    -shared` over BRIDGE_SOURCES with -DNTB_NO_PYTHON (no libpython, no
    libtorch), noted as `kernels.nvcc/bridge`.  Raises with nvcc's
    output when the build fails."""
    with _bridge_lock:
        return _build(_targets((), True))["bridge"]


def build_logs() -> Dict[str, str]:
    """nvcc's output (ptxas register and spill report) per source (and
    `bridge`), from the current build."""
    out = {}
    for name, (path, _) in _targets(SOURCES, True).items():
        log = path.with_suffix(".log")
        if log.exists():
            out[name] = log.read_text()
    return out


def _library(source: str):
    """The extension module of `source`, every source built and loaded
    at the first call."""
    with _lock:
        if not _libs:
            for src, path in build_all().items():
                spec = importlib.util.spec_from_file_location(
                    f"nomad_tpu_torch.csrc.{Path(src).stem}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _libs[src] = mod
        return _libs[source]


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# The main path's eager device ops: PyTorch calls around the kernels that
# run a device op of their own (a copy, a fill, a stack), counted at
# their call sites as the wrappers count launches, so a run can show
# which of them remain (chip_smoke.py prints them per phase).
EAGER: Dict[str, int] = {}


def count_eager(name: str) -> None:
    EAGER[name] = EAGER.get(name, 0) + 1


def reset_eager() -> None:
    EAGER.clear()


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on `t`'s (CUDA) device,
    read without building a `torch.cuda.Stream`."""
    return _raw_stream(t.get_device())


def check_cuda(name: str, **tensors) -> None:
    """Wrapper-side validation before a launch: every tensor lies on one
    CUDA device and is contiguous (shape and dtype checks are the
    wrapper's own)."""
    dev = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def wrap_rows(rows, n: int):
    """K4/K13's row ids for a table of `n` rows as the reference indexes
    them (numpy's rules), as int64: r in [-n, 0) becomes r + n; rows
    outside [0, n) after that are dropped by the caller."""
    r = rows.long()
    return torch.where(r < 0, r + n, r)


_I32 = torch.int32


def check_scatter(name: str, used, rows, vals):
    """K4/K13's checks in one pass: used [N, 3], rows [M] and vals
    [M, 3], all int32, contiguous and on one CUDA device.  Returns the
    device index, N and M."""
    d = used.get_device()
    us, rs, vs = used.shape, rows.shape, vals.shape
    if (not used.is_cuda or rows.get_device() != d
            or vals.get_device() != d):
        raise ValueError(f"{name}: used on {used.device}, rows on "
                         f"{rows.device}, vals on {vals.device}: not one "
                         "CUDA device")
    if used.dtype is not _I32 or rows.dtype is not _I32 or (
            vals.dtype is not _I32):
        raise ValueError(f"{name}: expected {_I32}, got {used.dtype}, "
                         f"{rows.dtype}, {vals.dtype}")
    if len(us) != 2 or us[1] != 3 or len(rs) != 1 or vs != (rs[0], 3):
        raise ValueError(f"{name}: expected used [N, 3], rows [M], vals "
                         f"[M, 3], got {tuple(us)}, {tuple(rs)}, "
                         f"{tuple(vs)}")
    if not (used.is_contiguous() and rows.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError(f"{name}: used, rows and vals must be contiguous")
    return d, us[0], rs[0]


def check_launch(name: str, specs) -> int:
    """A launch's checks in two lean passes over `specs`, a sequence of
    (key, tensor, dtype, ndim): every dtype and rank first, then that
    every tensor is contiguous on the first one's CUDA device.  Returns
    that device's index."""
    for key, t, dtype, ndim in specs:
        if t.dtype is not dtype:
            raise ValueError(f"{name}.{key}: expected {dtype}, got "
                             f"{t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}.{key}: expected {ndim} dims, got "
                             f"{tuple(t.shape)}")
    d = specs[0][1].get_device()
    for key, t, _, _ in specs:
        if not t.is_cuda or t.get_device() != d:
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA "
                             f"device {d}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    return d


def check_dtype(name: str, t, dtype, ndim: Optional[int] = None) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
