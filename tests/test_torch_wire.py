"""The port's wire codec (nomad_tpu_torch/core/wire.py over its own
core/_msgpack.py) against the reference's (nomad_tpu/core/wire.py over
the `msgpack` package), on the CPU.

`packb` must give the reference's bytes, and `msgpack.packb`'s, for every
struct of a `mock` corpus, sets, ndarrays and nested plans; frames made
by either package decode in the other, with and without a key; replayed,
stale and re-targeted frames are rejected as the reference rejects them.

Each package keeps its own process-global key and replay cache.  The
keyed cases install the same secret in both (`force=True`) and remove it
in a `finally`; no frame is decoded twice across packages except where
a case shows a replay."""

import dataclasses
import math

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_parity import (PACKAGES, add_jobs, build_zoned_cluster,
                          make_evals, pinned, pkg,  # noqa: F401
                          reset_mock_counters, run_batch_wave)

REF, PORT = PACKAGES
SECRET = "wire-parity-secret"


def wire(name):
    return pkg(name, "core.wire")


def codec():
    return pkg(PORT, "core._msgpack")


@pytest.fixture
def same_ids(pinned, monkeypatch):  # noqa: F811
    """`reset(seed)`: `pinned`'s ids, and both packages' mock name
    counters from 0 (mock names nodes and allocs from a module counter
    that other tests in the process have advanced)."""
    def reset(seed: int) -> None:
        pinned(seed)
        reset_mock_counters(monkeypatch)
    return reset


@pytest.fixture
def keyed():
    """Both packages on one shared secret for the case, then plaintext."""
    for name in PACKAGES:
        wire(name).set_key(SECRET, force=True)
    try:
        yield
    finally:
        for name in PACKAGES:
            wire(name).set_key(None)


# ------------------------------------------------------------ the codec


FORMAT_CASES = {
    "nil": None, "true": True, "false": False,
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2**31, -2**31 - 1, -2**63],
    "floats": [0.0, -1.5, math.inf, -math.inf, 1e300, 5e-324],
    "str_lengths": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
                    "a" * 65535, "a" * 65536],
    "utf8": ["é", "€uro", "\U0001f600", "日本語"],
    "bin_lengths": [b"", b"x" * 255, b"x" * 256, b"x" * 65535,
                    b"x" * 65536],
    "bytearray_memoryview": [bytearray(b"ab"), memoryview(b"cd")],
    "array_lengths": [[], list(range(15)), list(range(16)),
                      list(range(65536))],
    "tuple": (1, (2, 3), []),
    "map_lengths": [{}, {i: i for i in range(15)},
                    {str(i): i for i in range(16)},
                    {i: None for i in range(65536)}],
    "mixed_keys": {1: "a", "b": 2, 3.5: [None], b"k": True, None: 0},
    "numpy_scalars": [np.float64(2.5), np.float32(1.5), np.int64(-7),
                      np.int32(9), np.bool_(True), np.uint8(200)],
}


def _numpy_default(o):
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(type(o).__name__)


@pytest.mark.parametrize("case", sorted(FORMAT_CASES))
def test_codec_bytes_equal_msgpack(case):
    """Every format boundary: the port's codec writes msgpack's bytes and
    reads them back as msgpack does (raw=False, strict_map_key=False)."""
    obj = FORMAT_CASES[case]
    want = msgpack.packb(obj, default=_numpy_default, use_bin_type=True)
    assert codec().packb(obj, _numpy_default) == want
    got = codec().unpackb(want)
    assert got == msgpack.unpackb(want, raw=False, strict_map_key=False)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 8, 16, 17, 255, 256,
                               65536])
def test_codec_ext_lengths(n):
    """fixext 1/2/4/8/16 and ext 8/16/32, packed and hooked."""
    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    want = msgpack.packb(msgpack.ExtType(42, data), use_bin_type=True)
    assert codec().packb(codec().ExtType(42, data)) == want
    assert codec().unpackb(want) == codec().ExtType(42, data)
    assert codec().unpackb(want, lambda c, d: (c, d)) == (42, data)


@pytest.mark.parametrize("data", [b"\xc1", b"\x92\x01", b"\x01\x02",
                                  b"\xd9\x05ab", b"\xdc\x00", b""])
def test_codec_bad_input_fails_as_msgpack(data):
    """Truncated input, trailing bytes and the unused byte 0xc1 raise a
    ValueError in both codecs, of the same kind."""
    errors = []
    for unpack in (lambda d: msgpack.unpackb(d, raw=False),
                   codec().unpackb):
        with pytest.raises(ValueError) as info:
            unpack(data)
        errors.append(type(info.value).__name__)
    names = {"ExtraData", "FormatError", "ValueError"}
    assert errors[0] in names and errors[1] == errors[0]


def test_codec_refuses_what_msgpack_refuses():
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(bad)
        with pytest.raises(OverflowError):
            codec().packb(bad)
    with pytest.raises(TypeError):
        codec().packb(object())
    # an array as a map key packs, but decodes to an unhashable list
    keyed_by_array = msgpack.packb({(1, 2): 0})
    assert codec().packb({(1, 2): 0}) == keyed_by_array
    for unpack in (lambda d: msgpack.unpackb(d, strict_map_key=False),
                   codec().unpackb):
        with pytest.raises(TypeError):
            unpack(keyed_by_array)
    deep = []
    for _ in range(600):
        deep = [deep]
    with pytest.raises(ValueError):
        msgpack.packb(deep)
    with pytest.raises(ValueError):
        codec().packb(deep)


plain = st.recursive(
    st.none() | st.booleans()
    | st.integers(min_value=-2**63, max_value=2**64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40)
    | st.binary(max_size=40),
    lambda children: (st.lists(children, max_size=6)
                      | st.dictionaries(
                          st.text(max_size=8)
                          | st.integers(min_value=-2**63,
                                        max_value=2**64 - 1),
                          children, max_size=6)),
    max_leaves=40)


@settings(max_examples=300, deadline=None)
@given(obj=plain)
def test_nested_plain_data_packs_as_reference(obj):
    """Nested plain data: the port's wire bytes equal the reference's
    wire bytes and msgpack's, and decode to what msgpack decodes."""
    want = msgpack.packb(obj, use_bin_type=True)
    assert wire(REF).packb(obj) == want
    assert wire(PORT).packb(obj) == want
    assert wire(PORT).unpackb(want) == msgpack.unpackb(
        want, raw=False, strict_map_key=False)


# ------------------------------------------------------- the struct corpus


def _corpus(name):
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    node = mock.node(id="node-0001")
    job = mock.job(id="job-0001")
    return {
        "node": node,
        "job": job,
        "batch_job": mock.batch_job(id="batch-0001"),
        "system_job": mock.system_job(id="system-0001"),
        "sysbatch_job": mock.sysbatch_job(id="sysbatch-0001"),
        "spread_job": mock.spread_job(id="spread-0001"),
        "alloc": mock.alloc(id="alloc-0001", node_id=node.id, job=job),
        "eval": mock.eval(id="eval-0001", job_id=job.id),
        "csi_volume": structs.CSIVolume(
            id="vol-zone0", plugin_id="ebs0",
            access_mode="multi-node-multi-writer",
            topology_node_ids=("node-0001", "node-0002")),
        "scheduler_config": structs.SchedulerConfiguration(),
        "namespace": structs.Namespace(name="team-a"),
        "sets": {"plain": {3, 1, 2}, "frozen": frozenset({"b", "a"})},
        "ndarrays": [np.arange(12, dtype=np.int32).reshape(3, 4),
                     np.array([1.5, -2.0], dtype=np.float32),
                     np.zeros((0, 3), dtype=np.int64),
                     np.asfortranarray(np.eye(3, dtype=np.float64)),
                     np.array([True, False])],
        "command": ("upsert_nodes", ([node],), {}),
    }


CORPUS = sorted(_corpus(PORT))


@pytest.mark.parametrize("item", CORPUS)
def test_struct_corpus_packs_as_reference(same_ids, item):
    """Each struct built the same way in both packages packs to the same
    bytes, and each package decodes the other's bytes into an object of
    its own class that its own packb gives back byte for byte (tuples
    come back as lists, as the reference's docstring says)."""
    out = {}
    for name in PACKAGES:
        same_ids(3)
        obj = _corpus(name)[item]
        out[name] = (obj, wire(name).packb(obj))
    (ref_obj, ref_b), (port_obj, port_b) = out[REF], out[PORT]
    assert port_b == ref_b
    assert wire(PORT).packb(wire(PORT).unpackb(ref_b)) == ref_b
    assert wire(REF).packb(wire(REF).unpackb(port_b)) == port_b
    if dataclasses.is_dataclass(port_obj):
        assert type(wire(PORT).unpackb(ref_b)) is type(port_obj)
        assert type(wire(REF).unpackb(port_b)) is type(ref_obj)


def _wave_plans(name):
    """The plans of a small zoned batch wave from each package's Harness:
    64 placements an eval, the reconciler's block threshold, so each plan
    carries an AllocBlock (ndarray picks, metrics, a node table)."""
    h = build_zoned_cluster(name, n_nodes=60, n_zones=2)
    jobs, _ = add_jobs(name, h, n_items=3, count=64, zones=2)
    run_batch_wave(name, h, make_evals(name, jobs))
    for plan in h.plans:
        # wall time: the scheduler's clock and its placement timer
        for block in plan.alloc_blocks:
            block.template.create_time = block.template.modify_time = 0.0
            for m in block.metrics:
                m.allocation_time_ns = 0
    return h.plans


def test_nested_plans_pack_as_reference(same_ids):
    """Plans with AllocBlocks (ndarray picks), their results and the
    replicated plan-commit command: same bytes in both packages."""
    packed = {}
    for name in PACKAGES:
        same_ids(5)
        plans = _wave_plans(name)
        assert plans and any(p.alloc_blocks for p in plans)
        packed[name] = [wire(name).packb(p) for p in plans]
        packed[name].append(wire(name).packb(
            ("upsert_plan_results", (plans[0],), {"fence": None})))
    assert packed[PORT] == packed[REF]
    for b in packed[REF]:
        assert wire(PORT).packb(wire(PORT).unpackb(b)) == b


def test_unregistered_dataclass_is_refused():
    @dataclasses.dataclass
    class Stranger:
        x: int = 1

    for name in PACKAGES:
        with pytest.raises(TypeError, match="not registered"):
            wire(name).packb(Stranger())
        with pytest.raises(TypeError, match="cannot encode"):
            wire(name).packb(object())
    forged = wire(REF).packb(msgpack.ExtType(
        1, msgpack.packb(["Stranger", {"x": 1}])))
    for name in PACKAGES:
        with pytest.raises(ValueError, match="unknown dataclass"):
            wire(name).unpackb(forged)


# ---------------------------------------------------------------- frames


MSG = {"type": "append", "term": 3, "leader": "s1", "prev_idx": 7,
       "prev_term": 2, "entries": [[3, 8, b"\x93\xa4noop\x90\x80"]],
       "commit": 7}


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_plaintext_frames_cross_decode(direction):
    src, dst = (REF, PORT) if direction == "ref_to_port" else (PORT, REF)
    tag = wire(src).channel_tag("raft", "req", ("127.0.0.1", 4647))
    assert tag == wire(dst).channel_tag("raft", "req", ("127.0.0.1", 4647))
    frame = wire(src).encode_frame(MSG, tag=tag)
    assert frame == wire(dst).encode_frame(MSG, tag=tag)
    assert wire(dst).decode_body(frame[4:], tag=tag) == MSG


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_keyed_frames_cross_decode(keyed, direction):
    src, dst = (REF, PORT) if direction == "ref_to_port" else (PORT, REF)
    tag = wire(src).channel_tag("rpc", "rep", ("127.0.0.1", 4648))
    frame = wire(src).encode_frame(MSG, tag=tag)
    assert MSG["leader"].encode() not in frame       # encrypted
    assert wire(dst).decode_body(frame[4:], tag=tag) == MSG


def _rejection(name, frame, tag):
    try:
        wire(name).decode_body(frame[4:], tag=tag)
    except ValueError as e:
        return str(e)
    return None


def test_replayed_frame_rejected_as_reference(keyed):
    """A frame decodes once; the same bytes again are a replay, in each
    package (each against its own replay cache)."""
    tag = wire(REF).channel_tag("serf", "req", ("127.0.0.1", 4649))
    out = []
    for name in PACKAGES:
        frame = wire(name).encode_frame(MSG, tag=tag)
        out.append((_rejection(name, frame, tag),
                    _rejection(name, frame, tag)))
    assert out[0] == out[1] == (None, "replayed frame")


def test_stale_frame_rejected_as_reference(keyed):
    """A frame stamped outside the freshness window is stale in both."""
    out = []
    for name in PACKAGES:
        w = wire(name)
        clock = pkg(name, "chaos.clock")
        tag = w.channel_tag("raft", "req", ("127.0.0.1", 4647))
        old = clock.VirtualClock(start=clock.SystemClock().time()
                                 - 2 * w.REPLAY_WINDOW_S)
        w.set_clock(old)
        try:
            frame = w.encode_frame(MSG, tag=tag)
        finally:
            w.set_clock(clock.SystemClock())
        out.append(_rejection(name, frame, tag))
    assert out[0] == out[1] == "stale frame"


@pytest.mark.parametrize("wrong", ["channel", "direction", "port",
                                   "host", "no_tag"])
def test_channel_tag_is_authenticated(keyed, wrong):
    """A keyed frame decodes only under the tag it was sealed with: a
    frame for another plane, direction or listener fails authentication
    in both packages, as does a truncated body."""
    good = ("raft", "req", ("127.0.0.1", 4647))
    bad = {"channel": ("rpc", "req", ("127.0.0.1", 4647)),
           "direction": ("raft", "rep", ("127.0.0.1", 4647)),
           "port": ("raft", "req", ("127.0.0.1", 4648)),
           "host": ("raft", "req", ("127.0.0.2", 4647)),
           "no_tag": None}[wrong]
    out = []
    for name in PACKAGES:
        w = wire(name)
        frame = w.encode_frame(MSG, tag=w.channel_tag(*good))
        tag = b"" if bad is None else w.channel_tag(*bad)
        out.append((_rejection(name, frame, tag),
                    _rejection(name, frame[:30], w.channel_tag(*good))))
    assert out[0] == out[1] == ("frame authentication failed",
                                "unauthenticated frame")


def test_key_rules_match_reference():
    """set_key is idempotent for one secret, refuses a second one unless
    forced, and an empty secret resets to plaintext, in both."""
    out = []
    for name in PACKAGES:
        w = wire(name)
        row = []
        try:
            w.set_key("one")
            w.set_key("one")
            row.append(w.has_key())
            try:
                w.set_key("two")
            except ValueError as e:
                row.append(str(e))
            w.set_key("two", force=True)
            row.append(w.has_key())
        finally:
            w.set_key(None)
        row.append(w.has_key())
        out.append(row)
    assert out[0] == out[1]
    assert out[0][0] is True and out[0][-1] is False
