"""ctypes bindings for the port's native CUDA bridge (csrc/bridge.cu)
(reference: nomad_tpu/native/bridge.py).

The bridge is the production seam: a non-Python worker links
`libnomad_tpu_bridge.so` through its flat C ABI and runs the multi-eval
placement kernels with no Python runtime.  The library is built by nvcc
from the port's own `csrc/` sources (`ops.kernels.build_bridge`: at its
first use, into `csrc/build/`), calls the same `extern "C"` launchers as
the Python bindings, and owns one CUDA stream and every device buffer it
hands out.  These bindings test that seam from the in-process harness
and carry `ops.executor.BridgeExecutor`.

A program is one of the reference's jitted entries plus its static
arguments (`PROGRAMS`), its inputs in the fixed order of `program_inputs`
and its three outputs as that entry returns them:

  place_multi_packed          K1 + K3: (buf, used, jc)
  place_multi_compact_packed  K1 + K2: (buf_small, fills_full, used)
  place_bulk_packed           K8 + K1 + K6: (buf, used, jc)

`spread_algo` and the presence of `node_ok` are static arguments, not
buffers; so are the bulk rounds' `g`, `p_real` and `seed` (Python values
in the port's BulkInputs, host ints in K6's launcher).

Differences from the reference:
  - `CudaBridge(device=0)` takes a CUDA ordinal, not a PJRT plugin path,
    and `platform()` is "gpu";
  - `compile(program, statics)` names a program instead of taking
    StableHLO text, so `export_stablehlo`, `compile_options_bytes` and
    `default_plugin_options` have no counterpart: the port's kernels are
    hand-written CUDA compiled by nvcc ahead of time, and there is no
    XLA program or compile option to hand over;
  - `execute_resident` only enqueues on the library's stream; `fetch`
    is the synchronisation point;
  - `buffer_info`, `live_buffers`, `live_bytes`, `launches` and
    `reset_launches` read the library's counters (`chip_smoke.py` and the
    tests gate on them), and `close()` leaves the live-buffer count it
    found in `leaked`;
  - `PlainBridge` is the plain version: the same methods on CPU tensors
    in a handle table, whose programs call the plain functions
    (`select.place_multi_packed_plain`, ...).  Tests pass it to
    `BridgeExecutor`; `make_executor` never picks it.

This module imports numpy and ctypes only, so a worker without torch
loads a built library by path (`CudaBridge(lib=...)`); building it
(`build_bridge`) and `PlainBridge` import torch when called.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# PJRT_Buffer_Type values (the reference's ABI, kept by csrc/bridge.cu)
_PJRT_TYPE = {
    np.dtype(np.bool_): 1,    # PRED
    np.dtype(np.int8): 2,
    np.dtype(np.int16): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.int64): 5,
    np.dtype(np.uint8): 6,
    np.dtype(np.uint16): 7,
    np.dtype(np.uint32): 8,
    np.dtype(np.uint64): 9,
    np.dtype(np.float16): 10,
    np.dtype(np.float32): 11,
    np.dtype(np.float64): 12,
}
_DTYPE_OF = {v: k for k, v in _PJRT_TYPE.items()}
_U32 = 0xFFFFFFFF

# program -> its static arguments, in order
PROGRAMS = {
    "place_multi_packed": ("round_size", "spread_algo", "has_node_ok"),
    "place_multi_compact_packed": ("round_size", "n_lanes", "spread_algo"),
    "place_bulk_packed": ("round_size", "n_rounds", "with_scores",
                          "spread_algo", "g", "p_real", "seed"),
}
# the inputs of each program, in order (MultiEvalInputs' and BulkInputs'
# field order less the static fields)
MULTI_INPUTS = ("attrs", "cap", "used0", "elig", "luts", "base_mask", "con",
                "u_mask", "aff", "req", "desired", "dh_limit", "g_static",
                "g_aff", "g_job", "job_count0", "round_g", "round_want",
                "seed")
COMPACT_INPUTS = MULTI_INPUTS + ("cand_rows", "cand_valid")
BULK_INPUTS = ("attrs", "cap", "used0", "elig", "dc_mask", "pool_mask",
               "luts", "con", "aff", "req", "desired", "dh_limit",
               "job_count0")
N_OUTPUTS = 3


class BridgeError(RuntimeError):
    pass


def program_inputs(program: str, statics: Sequence[int]) -> Tuple[str, ...]:
    """The names of `program`'s inputs, in the order it takes them."""
    if program == "place_multi_packed":
        return MULTI_INPUTS + (("node_ok",) if statics[2] else ())
    if program == "place_multi_compact_packed":
        return COMPACT_INPUTS
    if program == "place_bulk_packed":
        return BULK_INPUTS
    raise BridgeError(f"unknown program {program!r} (expected one of "
                      f"{tuple(PROGRAMS)})")


def check_program(program: str, statics: Sequence[int]) -> None:
    """The checks `ntb_compile` makes, raising BridgeError as it fails."""
    if program not in PROGRAMS:
        raise BridgeError(
            f"compile: unknown program '{program}' (expected "
            "place_multi_packed, place_multi_compact_packed or "
            "place_bulk_packed)")
    names = PROGRAMS[program]
    if len(statics) != len(names):
        raise BridgeError(
            f"compile: {program} takes {len(names)} static arguments "
            f"({', '.join(names)}), got {len(statics)}")
    if not 1 <= statics[0] <= 1024:
        raise BridgeError(f"compile: {program}: round_size {statics[0]} "
                          "outside 1..1024")
    if program == "place_multi_compact_packed" and statics[1] < 1:
        raise BridgeError("compile: place_multi_compact_packed: n_lanes < 1")
    if program == "place_bulk_packed" and min(statics[1], statics[4],
                                              statics[5]) < 0:
        raise BridgeError("compile: place_bulk_packed: negative n_rounds, "
                          "g or p_real")


def multi_program(inp, round_size: int, cand_rows=None, cand_valid=None,
                  n_lanes: int = 1):
    """(program, statics, [(input name, leaf)]) of one multi-eval launch
    on `inp` (select.MultiEvalInputs): the flat program, or with the
    compact frames the laned one (whose frames are masked already, so it
    takes no node_ok)."""
    spread = int(bool(inp.spread_algo))
    if cand_rows is None:
        statics = (int(round_size), spread, int(inp.node_ok is not None))
        program = "place_multi_packed"
        leaves = [(k, getattr(inp, k))
                  for k in program_inputs(program, statics)]
        return program, statics, leaves
    statics = (int(round_size), int(n_lanes), spread)
    leaves = [(k, getattr(inp, k)) for k in MULTI_INPUTS]
    leaves += [("cand_rows", cand_rows), ("cand_valid", cand_valid)]
    return "place_multi_compact_packed", statics, leaves


def bulk_program(inp, round_size: int, n_rounds: int,
                 with_scores: bool = False):
    """(program, statics, [(input name, leaf)]) of K6's rounds on `inp`
    (select.BulkInputs, full or scored layout; no extra_mask)."""
    if inp.extra_mask is not None:
        raise BridgeError("place_bulk_packed takes no extra_mask")
    statics = (int(round_size), int(n_rounds), int(bool(with_scores)),
               int(bool(inp.spread_algo)), int(inp.g), int(inp.p_real),
               int(inp.seed) & _U32)
    return ("place_bulk_packed", statics,
            [(k, getattr(inp, k)) for k in BULK_INPUTS])


def build_bridge() -> str:
    """Build the library if it is not built yet (ops.kernels: nvcc into
    csrc/build/); returns its path.  Raises BridgeError with nvcc's
    output when the build fails."""
    from nomad_tpu_torch.ops import kernels
    try:
        return str(kernels.build_bridge())
    except RuntimeError as e:
        raise BridgeError(f"bridge library build failed: {e}") from e


def bridge_available() -> bool:
    """A CUDA device is present and the library builds."""
    import torch
    if not torch.cuda.is_available():
        return False
    try:
        build_bridge()
    except BridgeError:
        return False
    return True


def _c_array(ctype, values):
    values = list(values)
    return (ctype * max(len(values), 1))(*values)


class CudaBridge:
    """One client of the native library: a CUDA device and the stream and
    buffers the library owns on it."""

    def __init__(self, device: int = 0, lib: Optional[str] = None) -> None:
        self.lib_path = str(lib) if lib is not None else build_bridge()
        lib = ctypes.CDLL(self.lib_path)
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        C, S = ctypes.c_char_p, ctypes.c_size_t
        sig = {
            "ntb_create": (P, [I, C, S]),
            "ntb_destroy": (None, [P]),
            "ntb_device_count": (I, [P]),
            "ntb_platform": (I, [P, C, S]),
            "ntb_compile": (P, [P, C, ctypes.POINTER(I64), I, C, S]),
            "ntb_executable_destroy": (None, [P, P]),
            "ntb_num_outputs": (ctypes.c_long, [P, P, C, S]),
            "ntb_execute": (I, [
                P, P, I, ctypes.POINTER(I), ctypes.POINTER(I64),
                ctypes.POINTER(I), ctypes.POINTER(P), I, ctypes.POINTER(P),
                ctypes.POINTER(I64), ctypes.POINTER(I64), ctypes.POINTER(I),
                ctypes.POINTER(I), ctypes.POINTER(I64), C, S]),
            "ntb_upload": (P, [P, I, ctypes.POINTER(I64), I, P, C, S]),
            "ntb_buffer_free": (None, [P, P]),
            "ntb_buffer_info": (I, [P, P, ctypes.POINTER(I),
                                    ctypes.POINTER(I64), I]),
            "ntb_execute_resident": (I, [P, P, I, ctypes.POINTER(P), I,
                                         ctypes.POINTER(P), C, S]),
            "ntb_fetch": (I64, [P, P, P, I64, C, S]),
            "ntb_live_buffers": (I64, [P]),
            "ntb_live_bytes": (I64, [P]),
            "ntb_launcher_count": (I, []),
            "ntb_launcher_name": (C, [I]),
            "ntb_launches": (I64, [P, I]),
            "ntb_reset_launches": (None, [P]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        self._lib = lib
        self._tls = threading.local()
        self.launcher_names = [lib.ntb_launcher_name(i).decode()
                               for i in range(lib.ntb_launcher_count())]
        self.device = int(device)
        self.leaked: Optional[int] = None
        self._execs: List[int] = []
        err = self._err()
        self._h = lib.ntb_create(self.device, err, len(err))
        if not self._h:
            raise BridgeError(f"ntb_create: {err.value.decode()}")

    def _err(self):
        """This thread's error buffer (ctypes calls release the GIL)."""
        buf = getattr(self._tls, "err", None)
        if buf is None:
            buf = self._tls.err = ctypes.create_string_buffer(4096)
        return buf

    # ------------------------------------------------------------- intro

    def device_count(self) -> int:
        return self._lib.ntb_device_count(self._h)

    def platform(self) -> str:
        buf = ctypes.create_string_buffer(256)
        if self._lib.ntb_platform(self._h, buf, 256) != 0:
            raise BridgeError("ntb_platform failed")
        return buf.value.decode()

    # ----------------------------------------------------------- compile

    def compile(self, program, statics: Sequence[int] = ()) -> int:
        """An executable handle for `program` (a name of PROGRAMS, str or
        bytes) at its static arguments."""
        if isinstance(program, str):
            program = program.encode()
        st = _c_array(ctypes.c_int64, [int(v) for v in statics])
        err = self._err()
        h = self._lib.ntb_compile(self._h, program, st, len(statics), err,
                                  len(err))
        if not h:
            raise BridgeError(f"compile: {err.value.decode()}")
        self._execs.append(h)
        return h

    def num_outputs(self, exec_h: int) -> int:
        err = self._err()
        n = self._lib.ntb_num_outputs(self._h, exec_h, err, len(err))
        if n < 0:
            raise BridgeError(err.value.decode())
        return n

    # ----------------------------------------------------------- execute

    def execute(self, exec_h: int, inputs: Sequence[np.ndarray],
                out_specs: Sequence[tuple]) -> List[np.ndarray]:
        """Host in, host out; `out_specs`: (shape, dtype) per output."""
        arrs = [np.asarray(a, order="C") for a in inputs]
        n_in = len(arrs)
        dtypes = _c_array(ctypes.c_int, [self._type(a) for a in arrs])
        dims = _c_array(ctypes.c_int64, [d for a in arrs for d in a.shape])
        ndims = _c_array(ctypes.c_int, [a.ndim for a in arrs])
        data = _c_array(ctypes.c_void_p, [a.ctypes.data for a in arrs])
        outs = [np.empty(shape, dtype=dtype) for shape, dtype in out_specs]
        n_out = len(outs)
        out_data = _c_array(ctypes.c_void_p, [o.ctypes.data for o in outs])
        out_cap = _c_array(ctypes.c_int64, [o.nbytes for o in outs])
        odims = _c_array(ctypes.c_int64, [d for o in outs for d in o.shape])
        out_ndims = _c_array(ctypes.c_int, [o.ndim for o in outs])
        out_elem = _c_array(ctypes.c_int, [o.itemsize for o in outs])
        out_sizes = (ctypes.c_int64 * max(n_out, 1))()
        err = self._err()
        rc = self._lib.ntb_execute(
            self._h, exec_h, n_in, dtypes, dims, ndims, data, n_out,
            out_data, out_cap, odims, out_ndims, out_elem, out_sizes, err,
            len(err))
        if rc != 0:
            raise BridgeError(f"execute: {err.value.decode()}")
        for i, o in enumerate(outs):
            if out_sizes[i] != o.nbytes:
                raise BridgeError(f"output {i}: got {out_sizes[i]} bytes, "
                                  f"expected {o.nbytes}")
        return outs

    # ------------------------------------------ persistent device buffers

    @staticmethod
    def _type(a: np.ndarray) -> int:
        t = _PJRT_TYPE.get(a.dtype)
        if t is None:
            raise BridgeError(f"unsupported dtype {a.dtype}")
        return t

    def upload(self, arr: np.ndarray) -> int:
        """One host array into a new device buffer; returns its handle
        (free with buffer_free, or feed to execute_resident)."""
        a = np.asarray(arr, order="C")
        dims = _c_array(ctypes.c_int64, a.shape)
        err = self._err()
        h = self._lib.ntb_upload(self._h, self._type(a), dims, a.ndim,
                                 a.ctypes.data, err, len(err))
        if not h:
            raise BridgeError(f"upload: {err.value.decode()}")
        return h

    def buffer_free(self, buf_h: int) -> None:
        if self._h and buf_h:
            self._lib.ntb_buffer_free(self._h, buf_h)

    def buffer_info(self, buf_h: int) -> Tuple[tuple, np.dtype]:
        """(shape, dtype) of a live buffer."""
        t = ctypes.c_int()
        dims = (ctypes.c_int64 * 8)()
        nd = self._lib.ntb_buffer_info(self._h, buf_h, ctypes.byref(t),
                                       dims, 8)
        if nd < 0:
            raise BridgeError("buffer_info: not a live buffer")
        return tuple(dims[i] for i in range(nd)), _DTYPE_OF[t.value]

    def execute_resident(self, exec_h: int, in_handles: Sequence[int],
                         n_out: int = N_OUTPUTS) -> List[int]:
        """Run a program on device buffers; its outputs stay on the device
        as new handles (chainable into later executes: the proposed-usage
        tensor across waves)."""
        n_in = len(in_handles)
        ins = _c_array(ctypes.c_void_p, in_handles)
        outs = (ctypes.c_void_p * max(n_out, 1))()
        err = self._err()
        rc = self._lib.ntb_execute_resident(self._h, exec_h, n_in, ins,
                                            n_out, outs, err, len(err))
        if rc != 0:
            raise BridgeError(f"execute_resident: {err.value.decode()}")
        return [outs[i] for i in range(n_out)]

    def fetch(self, buf_h: int, shape=None, dtype=None) -> np.ndarray:
        """One device buffer to host (dense row-major), after all the work
        enqueued before it; shape and dtype default to the buffer's."""
        if shape is None or dtype is None:
            shape, dtype = self.buffer_info(buf_h)
        out = np.empty(shape, dtype=dtype)
        err = self._err()
        size = self._lib.ntb_fetch(self._h, buf_h, out.ctypes.data,
                                   out.nbytes, err, len(err))
        if size < 0:
            raise BridgeError(f"fetch: {err.value.decode()}")
        if size != out.nbytes:
            raise BridgeError(f"fetch: got {size} bytes, expected "
                              f"{out.nbytes}")
        return out

    # ---------------------------------------------------------- counters

    def live_buffers(self) -> int:
        return self._lib.ntb_live_buffers(self._h)

    def live_bytes(self) -> int:
        return self._lib.ntb_live_bytes(self._h)

    def launches(self) -> Dict[str, int]:
        """Launches by launcher since creation or reset_launches."""
        return {name: self._lib.ntb_launches(self._h, i)
                for i, name in enumerate(self.launcher_names)}

    def reset_launches(self) -> None:
        self._lib.ntb_reset_launches(self._h)

    # ------------------------------------------------------------- close

    def close(self) -> None:
        if self._h:
            for e in self._execs:
                self._lib.ntb_executable_destroy(self._h, e)
            self._execs.clear()
            self.leaked = self.live_buffers()
            h, self._h = self._h, None
            self._lib.ntb_destroy(h)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class PlainBridge:
    """The plain version of CudaBridge: the same methods on CPU tensors
    held in a handle table, whose programs run the plain functions of
    ops/select.py.  `launches` counts executions by program."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bufs: Dict[int, np.ndarray] = {}
        self._execs: Dict[int, tuple] = {}
        self._next = 1
        self._launches = {p: 0 for p in PROGRAMS}
        self.leaked: Optional[int] = None
        self.closed = False

    def _new(self, table: dict, value) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            table[h] = value
        return h

    def device_count(self) -> int:
        return 1

    def platform(self) -> str:
        return "cpu"

    def compile(self, program, statics: Sequence[int] = ()) -> int:
        if isinstance(program, bytes):
            program = program.decode(errors="replace")
        statics = tuple(int(v) for v in statics)
        check_program(program, statics)
        return self._new(self._execs, (program, statics))

    def num_outputs(self, exec_h: int) -> int:
        if exec_h not in self._execs:
            raise BridgeError("unknown executable")
        return N_OUTPUTS

    def upload(self, arr: np.ndarray) -> int:
        a = np.array(arr, copy=True, order="C")
        if a.dtype not in _PJRT_TYPE:
            raise BridgeError(f"unsupported dtype {a.dtype}")
        return self._new(self._bufs, a)

    def buffer_free(self, buf_h: int) -> None:
        with self._lock:
            self._bufs.pop(buf_h, None)

    def buffer_info(self, buf_h: int) -> Tuple[tuple, np.dtype]:
        a = self._bufs.get(buf_h)
        if a is None:
            raise BridgeError("buffer_info: not a live buffer")
        return a.shape, a.dtype

    def execute_resident(self, exec_h: int, in_handles: Sequence[int],
                         n_out: int = N_OUTPUTS) -> List[int]:
        if exec_h not in self._execs:
            raise BridgeError("execute_resident: unknown executable")
        if n_out != N_OUTPUTS:
            raise BridgeError(f"execute_resident: executable has 3 outputs, "
                              f"caller provided {n_out}")
        program, statics = self._execs[exec_h]
        names = program_inputs(program, statics)
        if len(in_handles) != len(names):
            raise BridgeError(f"execute_resident: {program} takes "
                              f"{len(names)} inputs, got {len(in_handles)}")
        arrays = {}
        for i, (name, h) in enumerate(zip(names, in_handles)):
            a = self._bufs.get(h)
            if a is None:
                raise BridgeError(f"execute_resident: input {i} is not a "
                                  "live buffer")
            arrays[name] = a
        outs = _run_plain(program, statics, arrays)
        with self._lock:
            self._launches[program] += 1
        return [self._new(self._bufs, o) for o in outs]

    def fetch(self, buf_h: int, shape=None, dtype=None) -> np.ndarray:
        a = self._bufs.get(buf_h)
        if a is None:
            raise BridgeError("fetch: not a live buffer")
        if shape is not None and (tuple(shape) != a.shape
                                  or np.dtype(dtype) != a.dtype):
            raise BridgeError(f"fetch: buffer is {a.shape} {a.dtype}, "
                              f"expected {tuple(shape)} {np.dtype(dtype)}")
        return a.copy()

    def execute(self, exec_h: int, inputs: Sequence[np.ndarray],
                out_specs: Sequence[tuple]) -> List[np.ndarray]:
        ins = [self.upload(a) for a in inputs]
        outs = []
        try:
            outs = self.execute_resident(exec_h, ins, len(out_specs))
            return [self.fetch(h, *spec) for h, spec in zip(outs, out_specs)]
        finally:
            for h in ins + outs:
                self.buffer_free(h)

    def live_buffers(self) -> int:
        return len(self._bufs)

    def live_bytes(self) -> int:
        return sum(a.nbytes for a in list(self._bufs.values()))

    def launches(self) -> Dict[str, int]:
        return dict(self._launches)

    def reset_launches(self) -> None:
        self._launches = {p: 0 for p in PROGRAMS}

    def close(self) -> None:
        if not self.closed:
            self.leaked = self.live_buffers()
            self._bufs.clear()
            self._execs.clear()
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _run_plain(program: str, statics, arrays) -> List[np.ndarray]:
    """One program's plain version on the host arrays by input name."""
    import torch

    from nomad_tpu_torch.ops import select

    def t(name):
        a = arrays[name]
        if name == "seed":
            a = a.astype(np.int64)
        return torch.from_numpy(np.asarray(a, order="C"))

    if program == "place_bulk_packed":
        rs, n_rounds, with_scores, spread, g, p_real, seed = statics
        inp = select.BulkInputs(
            **{k: t(k) for k in BULK_INPUTS}, spread_algo=bool(spread),
            g=g, p_real=p_real, seed=seed)
        outs = select.place_bulk_packed_plain(inp, rs, n_rounds,
                                              bool(with_scores))
    else:
        names = program_inputs(program, statics)
        fields = {k: t(k) for k in names if k in select.MultiEvalInputs._fields}
        spread = statics[1] if program == "place_multi_packed" else statics[2]
        inp = select.MultiEvalInputs(**fields, spread_algo=bool(spread))
        if program == "place_multi_packed":
            outs = select.place_multi_packed_plain(inp, statics[0])
        else:
            outs = select.place_multi_compact_packed_plain(
                inp, t("cand_rows"), t("cand_valid"), statics[0],
                statics[1])
    return [o.contiguous().numpy() for o in outs]


def save_program(path: str, program: str, statics: Sequence[int],
                 leaves) -> None:
    """One program's call as an .npz (`program`, `statics`, each input
    by name as a host array) for `main` to replay."""
    arrays = {name: (leaf.cpu().numpy() if hasattr(leaf, "cpu")
                     else np.asarray(leaf)) for name, leaf in leaves}
    np.savez(path, program=np.array(program),
             statics=np.array(statics, np.int64), **arrays)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """python -m nomad_tpu_torch.native.bridge LIB CALL.npz [DEVICE]

    Replays one program's call (`save_program`) through the library at
    LIB with ctypes and numpy alone (no torch needed) and prints one JSON
    line: the platform, the outputs' shapes and the sha256 of each
    output's bytes, and the live buffers left."""
    import hashlib
    import json
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) not in (2, 3):
        print(main.__doc__.strip().splitlines()[0], file=sys.stderr)
        return 2
    call = np.load(args[1])
    program = str(call["program"])
    statics = [int(v) for v in call["statics"]]
    with CudaBridge(int(args[2]) if len(args) == 3 else 0,
                    lib=args[0]) as br:
        ex = br.compile(program, statics)
        ins = [br.upload(call[name])
               for name in program_inputs(program, statics)]
        outs = br.execute_resident(ex, ins, N_OUTPUTS)
        got = [br.fetch(h) for h in outs]
        for h in ins + outs:
            br.buffer_free(h)
        print(json.dumps({
            "platform": br.platform(), "program": program,
            "shapes": [list(g.shape) for g in got],
            "sha256": [hashlib.sha256(g.tobytes()).hexdigest()
                       for g in got],
            "live_buffers": br.live_buffers()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
