"""Checkpointing: compressed msgpack shards with integrity manifests and
async writes (port of ``repro.train.checkpoint``).

This is the substrate Mirage's chained sub-jobs stand on: a sub-job
checkpoints at (or before) its wall-clock limit and the successor resumes.

Format, the reference's: one directory per step:
  step_000123/
    manifest.json   — leaf keys, shapes, dtypes, blake2 digests, step,
                      compression codec
    data.msgpack.zst — flattened leaves (row-major bytes)

Leaves are keyed and ordered as JAX's ``tree_flatten_with_path`` keys and
orders them (dict keys sorted, list items by index), so a checkpoint
written by either package restores in the other. A leaf may be a torch
tensor on any device, a numpy array or a Python scalar. numpy has no
bfloat16: a bf16 tensor is written as its raw bytes with the dtype
``"bfloat16"``, the name JAX records, and read back through an int16 view.
Restored leaves are tensors on the caller's device.

Compression: ``zstandard`` when available, stdlib ``zlib`` otherwise. The
codec is recorded in the manifest so shards restore on any host; restoring
a zstd shard on a host without ``zstandard`` raises a clear error. The
shard is the reference's byte for byte once decompressed; zlib writes it
at level 0 (``LEVELS``: stored blocks), where the reference compresses at
3.

Both directions stream: the writer packs one leaf at a time straight into
the file and the reader reads one leaf at a time into a buffer of its own,
so the host holds the state once (the asynchronous writer's snapshot) and
not the payload besides. The blake2b digests and zlib's Adler-32 run in
threads beside the stream. A stored zlib stream is read as it lies on
disk; a compressed one (the reference's) is inflated.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import shutil
import struct
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import _msgpack as msgpack
from repro_torch.device import resolve_device

try:                                 # optional: faster, smaller shards
    import zstandard as zstd
except ImportError:                  # pragma: no cover - env-dependent
    zstd = None

DEFAULT_CODEC = "zstd" if zstd is not None else "zlib"
# zstd at the reference's level 3. zlib at level 0, stored blocks, written
# here straight from the leaves' host buffers: on an H100 machine's 8-core
# host zlib compresses fp32 weights at ~19 MB/s at levels 1 and 3 (12
# minutes for TinyLlama-1.1B's 13.2 GB state) and writes level 0 at 0.68
# GB/s (PERF.md §6); both packages' ``zlib.decompress`` read the stream
LEVELS = {"zstd": 3, "zlib": 0}
_CHUNK = 64 << 20           # bytes a compressor, a checksum or a read takes
# blake2b, Adler-32 and the compressors release the GIL: the digests and
# checksums run in these threads beside the stream
_THREADS = max(1, min(8, (os.cpu_count() or 2) - 2))
_BLOCK = 65535              # a stored deflate block's most bytes
_STORED = struct.Struct("<BHH")     # its header: BFINAL/BTYPE, LEN, NLEN
_ADLER = 65521


def _adler32_combine(a1: int, a2: int, len2: int) -> int:
    """The Adler-32 of A + B from A's (``a1``), B's (``a2``) and B's
    length (zlib's ``adler32_combine``)."""
    rem = len2 % _ADLER
    s1 = ((a1 & 0xFFFF) + (a2 & 0xFFFF) + _ADLER - 1) % _ADLER
    s2 = (rem * (a1 & 0xFFFF) + (a1 >> 16) + (a2 >> 16) + _ADLER - rem) \
        % _ADLER
    return s1 | (s2 << 16)


class _Stored:
    """A zlib stream of stored blocks (level 0) into the file ``f``: the
    two-byte header, each block's five-byte header before at most 65,535
    bytes copied from the caller's buffer, an empty final block and the
    Adler-32 of every byte, computed in ``pool`` a chunk at a time and
    combined in order."""

    def __init__(self, f, pool):
        self._f, self._pool = f, pool
        self._sums = []
        self._out = bytearray(_CHUNK + _STORED.size * (_CHUNK // _BLOCK + 1))
        f.write(b"\x78\x01")

    def write(self, data) -> None:
        mv = memoryview(data).cast("B")
        for i in range(0, len(mv), _CHUNK):
            piece = mv[i:i + _CHUNK]
            self._sums.append((self._pool.submit(zlib.adler32, piece),
                               len(piece)))
            o = 0
            for j in range(0, len(piece), _BLOCK):
                n = min(_BLOCK, len(piece) - j)
                _STORED.pack_into(self._out, o, 0, n, n ^ 0xFFFF)
                self._out[o + 5:o + 5 + n] = piece[j:j + n]
                o += 5 + n
            self._f.write(memoryview(self._out)[:o])

    def close(self) -> None:
        adler = 1
        for s, n in self._sums:
            adler = _adler32_combine(adler, s.result(), n)
        self._f.write(_STORED.pack(1, 0, 0xFFFF) + struct.pack(">I", adler))


class _Compressed:
    """zstd's stream (``compress`` then ``flush``) into ``f``."""

    def __init__(self, f, comp):
        self._f, self._comp = f, comp

    def write(self, data) -> None:
        mv = memoryview(data).cast("B")
        for i in range(0, len(mv), _CHUNK):
            self._f.write(self._comp.compress(mv[i:i + _CHUNK]))

    def close(self) -> None:
        self._f.write(self._comp.flush())


def _sink(f, codec: str, size: int, pool):
    """The writer of a shard of ``size`` raw bytes into ``f``. zstd's frame
    records ``size`` so that a one-shot ``ZstdDecompressor().decompress``
    (the reference's reader) takes it."""
    if codec == "zstd":
        return _Compressed(f, zstd.ZstdCompressor(
            level=LEVELS["zstd"]).compressobj(size=size))
    if codec == "zlib":
        return _Stored(f, pool)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


class _NotStored(Exception):
    """A zlib stream that is not stored blocks throughout."""


class _StoredReader:
    """``readinto`` over a zlib stream of stored blocks, the bytes read
    from the file straight into the caller's buffer. Raises
    ``_NotStored`` at a compressed block. Its Adler-32 is not checked:
    the leaves' digests are."""

    def __init__(self, f):
        self._f = f
        self._left = 0
        self._final = False
        if not _stored_start(f.read(3)):
            raise _NotStored
        f.seek(2)

    def readinto(self, out) -> int:
        mv = memoryview(out).cast("B")
        got = 0
        while got < len(mv):
            if not self._left:
                if self._final:
                    break
                head = self._f.read(_STORED.size)
                if len(head) < _STORED.size:
                    raise ValueError("checkpoint shard: truncated zlib "
                                     "stream")
                flags, n, check = _STORED.unpack(head)
                if flags & 0x06:
                    raise _NotStored
                if check != n ^ 0xFFFF:
                    raise ValueError("checkpoint shard: corrupt stored "
                                     "block")
                self._left, self._final = n, bool(flags & 1)
                continue
            k = self._f.readinto(mv[got:got + min(self._left,
                                                  len(mv) - got)])
            if not k:
                raise ValueError("checkpoint shard: truncated zlib stream")
            got += k
            self._left -= k
        return got


def _stored_start(head: bytes) -> bool:
    """Whether a zlib stream's first three bytes are its header (deflate,
    no preset dictionary) and a stored block's."""
    return (len(head) == 3 and (head[0] << 8 | head[1]) % 31 == 0
            and head[0] & 0x0F == 8 and not head[1] & 0x20
            and not head[2] & 0x06)


class _Inflater:
    """A zlib stream read through ``readinto``, at most the asked bytes
    decompressed a call."""

    def __init__(self, f):
        self._f = f
        self._d = zlib.decompressobj()

    def readinto(self, out) -> int:
        mv = memoryview(out).cast("B")
        got = 0
        while got < len(mv) and not self._d.eof:
            data = self._d.unconsumed_tail or self._f.read(_CHUNK)
            piece = self._d.decompress(data, len(mv) - got)
            if not piece and not data:
                raise ValueError("checkpoint shard: truncated zlib stream")
            mv[got:got + len(piece)] = piece
            got += len(piece)
        return got


def _source(f, codec: str, inflate: bool = False):
    """The raw bytes of the shard open as ``f``, through ``readinto``: a
    zlib stream of stored blocks read as it lies unless ``inflate``."""
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "checkpoint shard is zstd-compressed but the optional "
                "'zstandard' module is not installed; install it or "
                "re-save the checkpoint with the zlib codec")
        return zstd.ZstdDecompressor().stream_reader(f, read_size=_CHUNK)
    if codec == "zlib":
        if not inflate:
            return _StoredReader(f)
        return _Inflater(f)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _read_into(src, out) -> None:
    """Fill ``out`` from ``src`` or raise on a short stream."""
    mv = memoryview(out).cast("B")
    got = 0
    while got < len(mv):
        n = src.readinto(mv[got:])
        if not n:
            raise ValueError("checkpoint shard: incomplete input")
        got += n


def _read(src, n: int) -> bytearray:
    buf = bytearray(n)
    _read_into(src, buf)
    return buf


def _tree_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in JAX's flattening order: dict keys sorted,
    lists and tuples by index, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [kv for k, v in items for kv in _tree_paths(v, prefix + (k,))]


def _unflatten(template, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``template``'s structure with each leaf replaced by ``leaves[key]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(template))
    return leaves["/".join(prefix)]


def _host(leaf):
    """A snapshot of ``leaf`` on the host that later in-place updates of
    the leaf cannot reach: a CPU tensor copy, or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _nbytes(leaf) -> int:
    if isinstance(leaf, _Snapshot):
        return leaf.nbytes
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def _leaf_array(leaf) -> Tuple[np.ndarray, List[int], str]:
    """A leaf's row-major bytes as a flat uint8 array (a view where the
    leaf is a contiguous host tensor or array: no copy), its shape and its
    dtype name. A ``_Snapshot`` is waited for."""
    if isinstance(leaf, _Snapshot):
        leaf = leaf.future.result()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        shape = list(t.shape)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().reshape(-1).view(np.uint8), \
                shape, "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        shape = list(arr.shape)
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8), shape, \
        str(arr.dtype)


def _digest(buf) -> str:
    return hashlib.blake2b(buf, digest_size=16).hexdigest()


def _leaf_tensor(buf: np.ndarray, shape: List[int], dtype: str,
                 device: torch.device) -> torch.Tensor:
    """The leaf held by the uint8 array ``buf``; on the CPU it keeps
    ``buf``'s storage."""
    arr = buf.view(np.int16 if dtype == "bfloat16" else dtype).reshape(shape)
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


_STEP_RE = re.compile(r"^step_(\d+)$")


def _step_of(p: pathlib.Path) -> Optional[int]:
    m = _STEP_RE.match(p.name)
    return int(m.group(1)) if m else None


def _fsync_path(path: pathlib.Path) -> None:
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durable(path: pathlib.Path, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _is_valid(d: pathlib.Path) -> bool:
    """A publishable checkpoint directory: parsable manifest naming the
    step, and the data shard present. (Digest verification happens at
    restore; this guards against torn publishes, not bit rot.)"""
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, ValueError):
        return False
    return (isinstance(manifest.get("step"), int)
            and (d / "data.msgpack.zst").is_file())


def save_checkpoint(directory: str, step: int, state: Dict,
                    keep_last: int = 3) -> pathlib.Path:
    """Synchronous save. state: a tree of dicts and lists whose leaves are
    tensors, numpy arrays or scalars.

    Crash-safe publish: both files are fsynced inside the ``.tmp``
    staging directory, the directory itself is fsynced, and only then is
    it renamed into place (with the parent directory fsynced to make the
    rename durable). A pre-existing checkpoint for the same step is
    moved aside — never deleted — until its replacement is durable, so a
    crash at any byte leaves either the old or the new checkpoint whole.
    """
    base = pathlib.Path(directory)
    tmp = base / f"step_{step:09d}.tmp"
    final = base / f"step_{step:09d}"
    if tmp.exists():                        # stale staging from a crash
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": [], "time": time.time(),
                "treedef": None, "codec": DEFAULT_CODEC}
    _write_shard(tmp / "data.msgpack.zst", state, manifest)
    _write_durable(tmp / "manifest.json", json.dumps(manifest).encode())
    _fsync_path(tmp)
    old = base / f"step_{step:09d}.old"
    if old.exists():
        shutil.rmtree(old)
    moved_aside = final.exists()
    if moved_aside:
        final.rename(old)                   # keep until replacement lands
    tmp.rename(final)                       # atomic publish
    _fsync_path(base)                       # make both renames durable
    if moved_aside:
        shutil.rmtree(old)
    _gc(base, keep_last)
    return final


def _write_shard(path: pathlib.Path, state, manifest: Dict) -> None:
    """The msgpack map {key: bin} of ``state``'s leaves in ``_tree_paths``
    order, the bytes the reference's ``packb`` gives, streamed leaf by
    leaf through the codec's writer (``_sink``) into ``path`` and fsynced.
    The host holds no copy of the payload: a chunk of it, and a leaf that
    was on the card. Each leaf's digest, computed beside the stream, goes
    into ``manifest["leaves"]``."""
    leaves = _tree_paths(state)
    sizes = [_nbytes(leaf) for _, leaf in leaves]
    heads = [msgpack.packb(key) + msgpack.bin_header(n)
             for (key, _), n in zip(leaves, sizes)]
    head = msgpack.map_header(len(leaves))
    size = len(head) + sum(map(len, heads)) + sum(sizes)
    digests = []
    with ThreadPoolExecutor(_THREADS) as pool, open(path, "wb") as f:
        sink = _sink(f, manifest["codec"], size, pool)
        sink.write(head)
        for (key, leaf), header in zip(leaves, heads):
            buf, shape, dtype = _leaf_array(leaf)
            digests.append(pool.submit(_digest, buf))
            sink.write(header)
            sink.write(buf)
            manifest["leaves"].append({"key": key, "shape": shape,
                                       "dtype": dtype})
        sink.close()
        f.flush()
        os.fsync(f.fileno())
    for m, d in zip(manifest["leaves"], digests):
        m["digest"] = d.result()


def _gc(base: pathlib.Path, keep_last: int) -> None:
    """Retire old checkpoints, counting only *valid* ones against
    ``keep_last`` — torn directories (crashed publishes, ``.tmp``/``.old``
    leftovers) are swept but never crowd a good checkpoint out of the
    keep window, so the only valid checkpoint is never deleted."""
    valid: List[pathlib.Path] = []
    for p in base.glob("step_*"):
        if not p.is_dir():
            continue
        if _step_of(p) is None:             # .tmp / .old crash leftovers
            shutil.rmtree(p, ignore_errors=True)
        elif _is_valid(p):
            valid.append(p)
        else:                               # torn publish: unrestorable
            shutil.rmtree(p, ignore_errors=True)
    valid.sort(key=_step_of)
    if keep_last > 0:
        for p in valid[:-keep_last]:
            shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """Newest step with a *valid* (restorable) checkpoint directory —
    a torn newest directory falls back to the previous good one."""
    base = pathlib.Path(directory)
    if not base.exists():
        return None
    steps = sorted(s for p in base.glob("step_*")
                   if p.is_dir() and (s := _step_of(p)) is not None
                   and _is_valid(p))
    return steps[-1] if steps else None


def _at_path(tree, key: str):
    """The subtree of ``tree`` at a '/'-joined path of ``_tree_paths``."""
    for part in key.split("/") if key else ():
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) \
            else tree[part]
    return tree


def _place(t: torch.Tensor, sharding):
    """A whole leaf placed by ``sharding``, a (DeviceMesh, placements)
    pair, on the mesh's device type: this rank keeps its shards. Every
    rank read the same bytes, so no rank sends any."""
    import inspect
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = sharding
    kw = {}
    if "src_data_rank" in inspect.signature(distribute_tensor).parameters:
        kw["src_data_rank"] = None
    return distribute_tensor(t.to(mesh.device_type), mesh, list(placements),
                             **kw)


def restore_checkpoint(directory: str, template, step: Optional[int] = None,
                       shardings=None, verify: bool = True, device=None):
    """Restore into the structure of ``template`` (a tree of dicts and
    lists; its leaves only name the keys) as tensors on ``device`` (CUDA
    unless ``device="cpu"``). Returns ``(tree, step)``.

    With ``shardings`` (the same structure, each leaf a (DeviceMesh,
    placements) pair, as ``dist.sharding.to_shardings`` gives them), each
    leaf is read, checked against its digest, and placed as a DTensor on
    its mesh's device type by ``distribute_tensor`` (``device`` is then
    not read). This is the elastic-restart path: a checkpoint has no mesh
    baked in, so any mesh shape restores it."""
    dev = resolve_device(device) if shardings is None else None
    if dev is not None and dev.type == "cuda" and dev.index is None:
        # the copies run in worker threads: name this thread's card
        dev = torch.device("cuda", torch.cuda.current_device())
    base = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = base / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    codec = manifest.get("codec", "zstd")   # pre-codec shards were zstd
    meta = {m["key"]: m for m in manifest["leaves"]}
    wanted = [key for key, _ in _tree_paths(template)]
    for key in wanted:
        if key not in meta:
            raise KeyError(f"checkpoint missing leaf {key!r}")
    wanted = set(wanted)

    def read(pool, inflate):
        """Stream the shard leaf by leaf: each leaf's bytes read into a
        buffer of its own, digested in ``pool`` and made a tensor on
        ``dev`` there (on the CPU, the buffer itself; onto the card, a copy
        under the next leaf's read)."""
        out, checks = {}, []
        with open(d / "data.msgpack.zst", "rb") as f:
            src = _source(f, codec, inflate)
            for key, n in msgpack.iter_bin_map(lambda k: _read(src, k)):
                buf = np.empty(n, np.uint8)
                _read_into(src, buf)
                if key not in wanted:
                    continue
                m = meta[key]
                if verify:
                    checks.append((key, m["digest"],
                                   pool.submit(_digest, buf)))
                if shardings is None:
                    out[key] = pool.submit(_leaf_tensor, buf, m["shape"],
                                           m["dtype"], dev)
                else:
                    out[key] = _place(_leaf_tensor(
                        buf, m["shape"], m["dtype"], torch.device("cpu")),
                        _at_path(shardings, key))
            if src.readinto(bytearray(1)):
                raise ValueError("checkpoint shard: data after the payload")
        return out, checks

    with ThreadPoolExecutor(_THREADS) as pool:
        try:
            out, checks = read(pool, inflate=False)
        except _NotStored:      # a compressed zlib stream (the reference's)
            out, checks = read(pool, inflate=True)
    for key, want, dig in checks:
        if dig.result() != want:
            raise IOError(f"digest mismatch for {key!r} (corrupt shard)")
    if shardings is None:
        out = {k: t.result() for k, t in out.items()}
    for key in wanted - out.keys():
        raise KeyError(f"checkpoint shard missing leaf {key!r}")
    return _unflatten(template, out), manifest["step"]


class _Snapshot:
    """A leaf whose host snapshot ``AsyncCheckpointer.save`` is still
    taking: its byte count now, the snapshot through ``future``."""

    def __init__(self, leaf):
        self.nbytes = _nbytes(leaf)
        self.future = Future()


class AsyncCheckpointer:
    """Background-thread checkpoint writer: the train loop hands off a
    host snapshot and keeps stepping (standard async-ckpt overlap)."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    def save(self, step: int, state) -> None:
        """Snapshot every leaf on the host, then return; the writer
        starts on the first leaf while the others are copied."""
        self.wait()
        paths = _tree_paths(state)
        snaps = {k: _Snapshot(v) for k, v in paths}
        lazy = _unflatten(state, snaps)

        def work():
            try:
                save_checkpoint(self.directory, step, lazy, self.keep_last)
            except BaseException as e:   # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        try:
            for k, v in paths:
                snaps[k].future.set_result(_host(v))
        except BaseException as e:
            for snap in snaps.values():
                if not snap.future.done():
                    snap.future.set_exception(e)
            self._thread.join()
            self._thread, self._last_error = None, None
            raise

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err
