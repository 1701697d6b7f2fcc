"""Build and bind the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc -gencode arch=compute_90a,code=sm_90a`
into its own shared library with a plain C interface, loaded through
`ctypes` (no PyTorch headers: a build takes seconds, not minutes).  All
sources build together, one `nvcc` process each, at the first launch of
any kernel; the libraries land in `BUILD_DIR` (listed in .gitignore)
under a name carrying a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

Each `Kernel` carries `launches`, the count its wrappers bump once per
launch of the CUDA kernel (never for the plain version), so a run can
show that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# -fmad=false: no multiply-add contraction the source does not spell out
# (the reference's XLA fuses some and not others; the kernels write each
# fma it has as __fmaf_rn)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures of every exported launcher, by source file.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "landscape.cu": {
        # attrs n a | con u c | luts l v | elig base u_mask | out | stream
        "landscape_mask": [_P, _I, _I, _P, _I, _I, _P, _I, _I,
                           _P, _P, _P, _P, _P],
        # attrs n a | rows n_rowsets nc | aff ua af | luts l v | out | stream
        "landscape_affinity": [_P, _I, _I, _P, _I, _I, _P, _I, _I,
                               _P, _I, _I, _P, _P],
        # attrs n a | con g c | luts l v | elig base u_mask | out | stream
        "feasible_mask": [_P, _I, _I, _P, _I, _I, _P, _I, _I,
                          _P, _P, _P, _P, _P],
    },
    "multi_rounds.cu": {
        # 18 tensors | n n_lanes nc ua af steps spread rs fill_k |
        # 5 scratch | stream
        "multi_compact": [_P] * 18 + [_I] * 9 + [_P] * 6,
        # 16 tensors | n ua af rounds spread rs | 4 scratch | stream
        "multi_flat": [_P] * 16 + [_I] * 6 + [_P] * 5,
        # 14 tensors | n ua af rounds spread rs | mode fill_k fills |
        # 4 scratch | stream
        "multi_bulk": [_P] * 14 + [_I] * 6 + [_I, _I, _P] + [_P] * 5,
        # x y n | stream (check entry: the kernels' device 10^x)
        "pow10_f32": [_P, _P, ctypes.c_longlong, _P],
        # rounds sink | stream (probe: the cost of one barrier round)
        "barrier_probe": [_I, _P, _P],
        # rounds cluster rows sink | stream (probe: one cluster exchange)
        "cluster_barrier_probe": [_I, _I, _P, _P, _P],
        # multi_compact's arguments | n_shards n_jrows | 3 exchange |
        # stream
        "multi_compact_sharded": ([_P] * 18 + [_I] * 9 + [_P] * 5
                                  + [_I, _I] + [_P] * 4),
        # multi_flat's arguments | n_shards | 3 exchange | stream
        "multi_flat_sharded": [_P] * 16 + [_I] * 6 + [_P] * 4 + [_I]
                              + [_P] * 4,
        # 14 tensors | n ua af rounds spread rs | 4 scratch | n_shards |
        # 3 exchange | stream
        "multi_bulk_sharded": [_P] * 14 + [_I] * 6 + [_P] * 4 + [_I]
                              + [_P] * 4,
    },
    "place_scan.cu": {
        # 21 tensors | 3 scratch | n g s k d kd steps spread | seed |
        # stream
        "place_scan": [_P] * 24 + [_I] * 8 + [ctypes.c_uint, _P],
        # place_scan's arguments | n_shards exchange | stream
        "place_scan_sharded": [_P] * 24 + [_I] * 8 + [ctypes.c_uint, _I,
                                                      _P, _P],
    },
    "preempt.cu": {
        # 8 tensors | m a dh n_place n_real | 2 outputs 2 scratch | stream
        "preempt_bulk": [_P] * 8 + [_I] * 5 + [_P] * 5,
    },
    "scatter_add.cu": {
        # used n | rows vals m | stream
        "scatter_add": [_P, _I, _P, _P, _I, _P],
        # used npad | rows vals m | n_shards | stream
        "scatter_add_sharded": [_P, _I, _P, _P, _I, _I, _P],
    },
}


class Kernel:
    """One hand-written kernel: its source, the TPU-side function it
    replaces, and the launch count of its wrappers."""

    def __init__(self, name: str, source: str, replaces: str) -> None:
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def fn(self, symbol: str):
        return _library(self.source)[symbol]

    def launch(self, symbol: str, *args, stream) -> None:
        """Call one C launcher on `stream` (PyTorch's current stream of
        the tensors' device) and raise when CUDA refused the launch."""
        rc = self.fn(symbol)(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch of {symbol} failed with "
                f"cudaError {rc}")
        self.launches += 1


LANDSCAPE = Kernel("landscape", "landscape.cu",
                   "nomad_tpu/ops/feasibility.py:29")
MULTI_COMPACT = Kernel("multi_compact", "multi_rounds.cu",
                       "nomad_tpu/ops/select.py:836")
MULTI_FLAT = Kernel("multi_flat", "multi_rounds.cu",
                    "nomad_tpu/ops/select.py:733")
SCATTER_ADD = Kernel("scatter_add", "scatter_add.cu",
                     "nomad_tpu/ops/engine.py:50")
PLACE_SCAN = Kernel("place_scan", "place_scan.cu",
                    "nomad_tpu/ops/select.py:297")
MULTI_BULK = Kernel("multi_bulk", "multi_rounds.cu",
                    "nomad_tpu/ops/select.py:554")
PREEMPT_BULK = Kernel("preempt_bulk", "preempt.cu",
                      "nomad_tpu/ops/preempt.py:108")
FEASIBLE = Kernel("feasible_mask", "landscape.cu",
                  "nomad_tpu/ops/feasibility.py:75")
# the node-sharded mesh on one card (parallel/mesh.py)
PLACE_SCAN_SHARDED = Kernel("place_scan_sharded", "place_scan.cu",
                            "nomad_tpu/parallel/mesh.py:221")
MULTI_BULK_SHARDED = Kernel("multi_bulk_sharded", "multi_rounds.cu",
                            "nomad_tpu/parallel/mesh.py:645")
MULTI_FLAT_SHARDED = Kernel("multi_flat_sharded", "multi_rounds.cu",
                            "nomad_tpu/parallel/mesh.py:454")
MULTI_COMPACT_SHARDED = Kernel("multi_compact_sharded", "multi_rounds.cu",
                               "nomad_tpu/parallel/mesh.py:590")
SCATTER_ADD_SHARDED = Kernel("scatter_add_sharded", "scatter_add.cu",
                             "nomad_tpu/ops/engine.py:96")
KERNELS = (LANDSCAPE, MULTI_COMPACT, MULTI_FLAT, SCATTER_ADD, PLACE_SCAN,
           MULTI_BULK, PREEMPT_BULK, FEASIBLE, PLACE_SCAN_SHARDED,
           MULTI_BULK_SHARDED, MULTI_FLAT_SHARDED, MULTI_COMPACT_SHARDED,
           SCATTER_ADD_SHARDED)

_lock = threading.Lock()
_libs: Dict[str, Dict[str, object]] = {}
build_seconds: Optional[float] = None


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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


def build_all() -> Dict[str, Path]:
    """Compile every source that has no current library yet, one `nvcc`
    process per source, all started together.  Returns the library
    paths by source name; raises with nvcc's output when a build fails."""
    global build_seconds
    tag = _sources_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src: BUILD_DIR / f"{Path(src).stem}.{tag}.so"
             for src in SIGNATURES}
    todo = {src: p for src, p in paths.items() if not p.exists()}
    t0 = time.perf_counter()
    procs = {}
    nvcc = _nvcc() if todo else ""
    for src, p in todo.items():
        tmp = p.with_name(p.name + f".{os.getpid()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        procs[src] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for src, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(src)
            continue
        os.replace(tmp, paths[src])
    if failed:
        logs = "\n".join(paths[s].with_suffix(".log").read_text()[-4000:]
                         for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    if todo:
        build_seconds = time.perf_counter() - t0
    return paths


def build_logs() -> Dict[str, str]:
    """nvcc's output (ptxas register and spill report) per source, from
    the current build."""
    tag = _sources_hash()
    out = {}
    for src in SIGNATURES:
        log = BUILD_DIR / f"{Path(src).stem}.{tag}.log"
        if log.exists():
            out[src] = log.read_text()
    return out


def _library(source: str) -> Dict[str, object]:
    with _lock:
        if not _libs:
            for src, path in build_all().items():
                lib = ctypes.CDLL(str(path))
                fns = {}
                for sym, argtypes in SIGNATURES[src].items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[sym] = fn
                _libs[src] = fns
        return _libs[source]


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on `t`'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


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


def check_dtype(name: str, t, dtype, ndim: Optional[int] = None) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
