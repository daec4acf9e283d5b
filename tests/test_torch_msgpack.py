"""``repro_torch._msgpack`` against the ``msgpack`` module the JAX package
packs with: the same bytes for every value the decision journal and the
checkpoint payload hold, round trips, and the errors a corrupt record must
raise for ``DecisionJournal.replay``."""
import struct
import zlib

import msgpack
import numpy as np
import pytest

from repro_torch import _msgpack

# every integer width boundary, both signs
INTS = sorted({v for b in (0, 1, 4, 5, 7, 8, 15, 16, 31, 32, 63, 64)
               for v in (2 ** b - 1, 2 ** b, 2 ** b + 1,
                         -2 ** b - 1, -2 ** b, -2 ** b + 1)
               if -2 ** 63 <= v < 2 ** 64})
VALUES = {
    "nil_bool": [None, True, False],
    "floats": [0.0, -0.0, 1.5, -2.25e-300, 1e300, float("inf"),
               float("-inf"), 3.141592653589793],
    "str": ["", "a", "é" * 15, "x" * 31, "x" * 32, "x" * 255, "x" * 256,
            "x" * 65535, "x" * 65536, "ü∂ß"],
    "bin": [b"", b"\x00", b"x" * 255, b"x" * 256, b"x" * 65535,
            b"x" * 65536, bytearray(b"ab")],
    "array": [[], [1], list(range(15)), list(range(16)),
              list(range(65536)), (1, "a", b"b"), [[[]]]],
    "map": [{}, {"a": 1}, {str(i): i for i in range(15)},
            {str(i): i for i in range(16)},
            {str(i): i for i in range(65536)}, {b"k": None}],
    # the journal's records as the reference writes them: a lane's header
    # and decisions, a co-sim lane's header (with the shared episode start)
    # and round-tagged decisions
    "journal": [{"v": 2, "seed": 11, "links": 2},
                {"i": 0, "a": 1, "fb": False},
                {"i": 300, "a": 0, "fb": True},
                {"v": 2, "seed": 2 ** 31, "links": 3, "co": 1024,
                 "t0": 1234567.891},
                {"i": 5, "a": 1, "fb": False, "r": 70000}],
    # a checkpoint payload: leaf keys to raw bytes
    "checkpoint": [{"params/embed_in/w": np.arange(300, dtype=np.float32)
                    .tobytes(),
                    "params/trunk/segments/0/b0/attn/q": bytes(70000),
                    "step": np.int32(7).tobytes()}],
    "nested": [{"a": {"b": [1, {"c": [b"z", -1, 2.5, None]}]}, "d": []}],
}
CASES = [(k, v) for k, vs in VALUES.items() for v in vs] + \
    [("int", v) for v in INTS]


@pytest.mark.parametrize("kind,value", CASES,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(CASES)])
def test_bytes_equal_msgpack(kind, value):
    want = msgpack.packb(value, use_bin_type=True)
    got = _msgpack.packb(value, use_bin_type=True)
    assert got == want
    assert _msgpack.unpackb(want, raw=False) == \
        msgpack.unpackb(want, raw=False)


def test_round_trips():
    for _, value in CASES:
        back = _msgpack.unpackb(_msgpack.packb(value))
        want = msgpack.unpackb(msgpack.packb(value, use_bin_type=True),
                               raw=False)
        assert back == want
    # a longer form than the shortest, as other packers may write, reads
    assert _msgpack.unpackb(b"\xd9\x01a") == "a"
    assert _msgpack.unpackb(b"\xcd\x00\x05") == 5


@pytest.mark.parametrize("blob", [
    b"", b"\x92\x01", b"\xcd\x01", b"\xd9\x05abc", b"\xc4\x03ab",
    b"\x81\xa1a", b"\xde\x00\x02\xa1a\x01"], ids=lambda b: b.hex() or "empty")
def test_truncated_input_raises(blob):
    with pytest.raises(ValueError):
        msgpack.unpackb(blob, raw=False)
    with pytest.raises(ValueError, match="incomplete"):
        _msgpack.unpackb(blob)


@pytest.mark.parametrize("blob", [b"\x01\x02", b"\x90\x00", b"\xc0\xc0"],
                         ids=lambda b: b.hex())
def test_trailing_bytes_raise(blob):
    with pytest.raises(ValueError):
        msgpack.unpackb(blob, raw=False)
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(blob)


@pytest.mark.parametrize("blob", [b"\xc1", b"\xd4\x01\x02", b"\xc7\x01\x05x",
                                  b"\x81\x01\x02"], ids=lambda b: b.hex())
def test_unknown_codes_and_keys_raise(blob):
    """0xc1 is never used; ext types are not read; map keys must be str or
    bytes (msgpack's ``strict_map_key``)."""
    with pytest.raises(ValueError):
        _msgpack.unpackb(blob)


def test_unsupported_values_raise_as_msgpack():
    for value, err in ((2 ** 64, OverflowError), (-2 ** 63 - 1, OverflowError),
                       (np.int64(3), TypeError), (object(), TypeError)):
        with pytest.raises(err):
            msgpack.packb(value, use_bin_type=True)
        with pytest.raises(err):
            _msgpack.packb(value)


def test_journal_records_cross_packages(tmp_path):
    """A journal file framed and packed by the reference's
    ``DecisionJournal`` replays in the port's, and the reverse; a corrupt
    complete record raises ``JournalCorruptionError`` in the port too."""
    from repro.core import DecisionJournal as JJournal
    from repro_torch.core import DecisionJournal as TJournal
    from repro_torch.core import JournalCorruptionError
    records = VALUES["journal"]
    for writer, reader in ((JJournal, TJournal), (TJournal, JJournal)):
        path = str(tmp_path / f"{writer.__module__}.journal")
        for rec in records:
            writer(path).append(rec)
        assert reader(path).replay() == records
    path = str(tmp_path / "bad.journal")
    body = b"\xc1"
    with open(path, "wb") as f:
        f.write(struct.pack("<II", len(body), zlib.crc32(body)) + body)
        f.write(struct.pack("<II", 1, zlib.crc32(b"\x01")) + b"\x01")
    with pytest.raises(JournalCorruptionError, match="undecodable"):
        TJournal(path).replay()


BIN_MAPS = [{}, {"a": b""}, {"k" * 40: b"x" * 300, b"raw": b"y" * 70000},
            {str(i): bytes([i]) * i for i in range(20)},
            {"k" * 300: memoryview(b"z" * 65536)}]


@pytest.mark.parametrize("i", range(len(BIN_MAPS)))
def test_iter_bin_map_reads_msgpacks_maps(i):
    """``iter_bin_map`` on ``msgpack``'s bytes of a map of str or bytes
    keys to bin values, in every header width (fixmap and map16, fixstr,
    str8 and str16, bin8, bin16, bin32), the values read by the caller;
    ``map_header``/``bin_header`` are ``packb``'s."""
    want = {k: bytes(v) for k, v in BIN_MAPS[i].items()}
    blob = msgpack.packb(want, use_bin_type=True)
    assert _msgpack.packb(BIN_MAPS[i]) == blob
    mv, off = memoryview(blob), [0]

    def read(n):
        off[0] += n
        if off[0] > len(mv):
            raise ValueError("short")
        return mv[off[0] - n:off[0]]
    got = {key: bytes(read(n)) for key, n in _msgpack.iter_bin_map(read)}
    assert got == want and off[0] == len(blob)
    assert blob.startswith(_msgpack.map_header(len(want)))
    for n in (0, 255, 256, 65535, 65536):
        assert _msgpack.bin_header(n) == msgpack.packb(
            bytes(n), use_bin_type=True)[:-n or None]


@pytest.mark.parametrize("blob", [msgpack.packb([b"a"]),
                                  msgpack.packb({1: b"a"}),
                                  msgpack.packb({"a": "text"})])
def test_iter_bin_map_refuses_other_types(blob):
    mv, off = memoryview(blob), [0]

    def read(n):
        off[0] += n
        return mv[off[0] - n:off[0]]
    with pytest.raises(ValueError, match="Unpack failed"):
        list(_msgpack.iter_bin_map(read))
