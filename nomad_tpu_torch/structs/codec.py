"""Wire codec: dataclasses <-> Nomad-API-shaped JSON dicts.

The reference's `api/` package defines the public JSON shapes (CamelCase
field names, durations as nanosecond ints).  Rather than hand-writing a
converter per struct, this module derives the wire form from the dataclass
definitions:

  - snake_case -> CamelCase with Nomad's acronym conventions
    (`id`->`ID`, `cpu`->`CPU`, `memory_mb`->`MemoryMB`, ...)
  - fields ending in `_s` (seconds) encode as nanosecond ints under the
    suffix-less name (`interval_s` -> `Interval`), matching Go
    `time.Duration` JSON encoding; decode also accepts Go duration strings.
  - Optional/None fields are omitted on encode.

Used by the jobspec JSON path, the HTTP API, and the api SDK.

Difference from the reference (nomad_tpu/structs/codec.py): each field
name's wire name and each dataclass's decode plan (its fields' wire
names and resolved type hints) are computed once per process and kept,
where the reference resolves `get_type_hints` on every decoded object.
The bytes and objects are the reference's; a 50,000-node snapshot
restore (a pool worker's bootstrap) spent most of its time in that
resolution.
"""

from __future__ import annotations

import dataclasses
import functools
import typing
from typing import Any, Dict, Optional, get_args, get_origin, get_type_hints

_ACRONYMS = {
    "id": "ID", "cpu": "CPU", "mb": "MB", "mhz": "MHz", "dc": "DC",
    "dcs": "DCs", "csi": "CSI", "acl": "ACL", "ip": "IP", "url": "URL",
    "ttl": "TTL", "tg": "TG", "gc": "GC", "http": "HTTP", "tls": "TLS",
    "ns": "NS", "rpc": "RPC", "os": "OS", "hcl": "HCL",
}

# Hand overrides where mechanical conversion diverges from the reference API.
_FIELD_OVERRIDES = {
    "memory_max_mb": "MemoryMaxMB",
    "mbits": "MBits",
    "port_label": "PortLabel",
    "ltarget": "LTarget",
    "rtarget": "RTarget",
    "node_class": "NodeClass",
}


@functools.lru_cache(maxsize=None)
def wire_name(py_name: str) -> str:
    if py_name in _FIELD_OVERRIDES:
        return _FIELD_OVERRIDES[py_name]
    dur = py_name.endswith("_s") and py_name not in ("status_s",)
    parts = py_name[:-2].split("_") if dur else py_name.split("_")
    return "".join(_ACRONYMS.get(p, p.capitalize()) for p in parts if p)


def _is_duration(py_name: str) -> bool:
    return py_name.endswith("_s")


def encode(obj: Any) -> Any:
    """Dataclass/list/dict/scalar -> JSON-safe wire value."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            if _is_duration(f.name) and isinstance(v, (int, float)):
                out[wire_name(f.name)] = int(v * 1e9)
            else:
                out[wire_name(f.name)] = encode(v)
        return out
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    if isinstance(obj, bytes):
        import base64
        return base64.b64encode(obj).decode()
    return obj


def _strip_optional(tp):
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def decode(cls, data: Any):
    """Wire value -> instance of dataclass `cls` (recursive, tolerant of
    missing/extra fields)."""
    if data is None:
        return None
    tp = _strip_optional(cls)
    origin = get_origin(tp)
    if origin in (list, tuple):
        (item_tp,) = get_args(tp)[:1] or (Any,)
        seq = [decode(item_tp, v) for v in (data or [])]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        args = get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: decode(val_tp, v) for k, v in (data or {}).items()}
    if not (isinstance(tp, type) and dataclasses.is_dataclass(tp)):
        if tp is bytes and isinstance(data, str):
            import base64
            return base64.b64decode(data)
        return data
    kwargs: Dict[str, Any] = {}
    lower = {k.lower(): k for k in (data or {})}
    for wname, name, hint in _decode_plan(tp):
        if wname in data:
            raw = data[wname]
        elif wname.lower() in lower:
            raw = data[lower[wname.lower()]]
        else:
            continue
        if _is_duration(name):
            kwargs[name] = _decode_duration(raw)
        else:
            kwargs[name] = decode(hint, raw)
    return tp(**kwargs)


@functools.lru_cache(maxsize=None)
def _decode_plan(tp) -> tuple:
    """(wire name, field name, type hint) of each field of dataclass
    `tp`, in field order."""
    hints = get_type_hints(tp)
    return tuple((wire_name(f.name), f.name, hints.get(f.name, Any))
                 for f in dataclasses.fields(tp))


def _decode_duration(raw: Any) -> Optional[float]:
    if raw is None:
        return None
    if isinstance(raw, str):
        from nomad_tpu_torch.jobspec.schema import parse_duration
        return parse_duration(raw)
    # Go time.Duration marshals to a nanosecond integer — always, even for
    # sub-millisecond values, so ints convert unconditionally (a 500_000
    # wire int is 0.5ms, not 500k seconds).  Floats only appear from our
    # own encoder, which writes seconds.
    if isinstance(raw, int):
        return raw / 1e9
    return float(raw)
