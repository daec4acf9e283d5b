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
a zstd shard on a host without ``zstandard`` raises a clear error.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import shutil
import threading
import time
import zlib
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


def _compress(raw: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return zstd.ZstdCompressor(level=3).compress(raw)
    if codec == "zlib":
        return zlib.compress(raw, 3)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decompress(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "checkpoint shard is zstd-compressed but the optional "
                "'zstandard' module is not installed; install it or "
                "re-save the checkpoint with the zlib codec")
        return zstd.ZstdDecompressor().decompress(blob)
    if codec == "zlib":
        return zlib.decompress(blob)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


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


def _leaf_bytes(leaf) -> Tuple[bytes, List[int], str]:
    """Row-major bytes, shape and dtype name of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                    "bfloat16")
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf_tensor(buf: bytes, shape: List[int], dtype: str,
                 device: torch.device) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).to(device)
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    return torch.from_numpy(arr).to(device)


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
    payload = {}
    for key, leaf in _tree_paths(state):
        buf, shape, dtype = _leaf_bytes(leaf)
        manifest["leaves"].append({
            "key": key, "shape": shape, "dtype": dtype,
            "digest": hashlib.blake2b(buf, digest_size=16).hexdigest(),
        })
        payload[key] = buf
    raw = msgpack.packb(payload, use_bin_type=True)
    _write_durable(tmp / "data.msgpack.zst", _compress(raw, DEFAULT_CODEC))
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
    base = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = base / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    codec = manifest.get("codec", "zstd")   # pre-codec shards were zstd
    raw = _decompress((d / "data.msgpack.zst").read_bytes(), codec)
    payload = msgpack.unpackb(raw, raw=False)
    meta = {m["key"]: m for m in manifest["leaves"]}

    out = {}
    for key, _ in _tree_paths(template):
        m = meta.get(key)
        if m is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        buf = payload[key]
        if verify:
            dig = hashlib.blake2b(buf, digest_size=16).hexdigest()
            if dig != m["digest"]:
                raise IOError(f"digest mismatch for {key!r} (corrupt shard)")
        if shardings is None:
            out[key] = _leaf_tensor(buf, m["shape"], m["dtype"], dev)
        else:
            out[key] = _place(_leaf_tensor(buf, m["shape"], m["dtype"],
                                           torch.device("cpu")),
                              _at_path(shardings, key))
    return _unflatten(template, out), manifest["step"]


class AsyncCheckpointer:
    """Background-thread checkpoint writer: the train loop hands off a
    host snapshot and keeps stepping (standard async-ckpt overlap)."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    def save(self, step: int, state) -> None:
        self.wait()
        host_state = _unflatten(state, {k: _host(v)
                                        for k, v in _tree_paths(state)})

        def work():
            try:
                save_checkpoint(self.directory, step, host_state,
                                self.keep_last)
            except BaseException as e:   # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err
