"""Where the time of a full-width checkpoint goes: TinyLlama-1.1B's
parameters and AdamW moments (1.1 B fp32 parameters, 13.2 GB with m and
v) saved and restored stage by stage, with the host's memory beside each
stage.

    PYTHONPATH=src python -m repro_torch.analysis.ckpt_stages [whole|stream]

On the card (the state is drawn there; m and v filled with random values,
as a trained state holds them, where zeros would compress as no trained
state does). Prints one ``[ckpt_stage]`` line of JSON a stage; writes
under ``build/ckpt_stages/`` and removes it at the end.

``whole`` times the writer and reader that hold the whole payload at once,
each stage on its own: the host snapshot (``checkpoint._host``), each
leaf's ``tobytes()``, the blake2b digests on one thread, msgpack packing
of {key: bytes}, zlib at levels 3 and 1 over a sample of the payload (they
take minutes over all of it) and at 0 over all of it, and the level-0
shard written and fsynced; then reading the shard, decompressing it,
unpacking it, the digests and each leaf made a tensor on the card.
``stream`` times the checkpoint module's own writer and reader:
``AsyncCheckpointer.save`` until ``wait`` returns and
``restore_checkpoint`` onto the card, each leaf held to its original's
bits, and the disk's raw write of the same number of bytes to the same
directory. Without an argument both run, ``whole`` first.

``RssPeak`` and ``raw_write_s`` are also what ``chip_smoke.py`` measures
the launcher's checkpoints with.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import resource
import shutil
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch import _msgpack
from repro_torch.convert import tree_map
from repro_torch.models import registry, transformer
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

OUT = pathlib.Path("build") / "ckpt_stages"
SAMPLE_BYTES = 256 << 20     # the levels above 0 compress this much
_WRITE_CHUNK = 64 << 20


def rss_gb() -> float:
    """This process's resident set now, in GB."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e9


class RssPeak:
    """The resident set sampled every ``period`` seconds by a thread
    while the ``with`` block runs: ``start_gb`` on entry, ``peak_gb`` the
    most seen (the block's own peak, where ``ru_maxrss`` holds the
    process's whole life)."""

    def __init__(self, period: float = 0.02):
        self.period = period
        self.start_gb = self.peak_gb = 0.0
        self._stop = threading.Event()
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.peak_gb = max(self.peak_gb, rss_gb())

    def __enter__(self):
        self.start_gb = self.peak_gb = rss_gb()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gb = max(self.peak_gb, rss_gb())
        return False


def raw_write_s(directory, nbytes: int) -> float:
    """Seconds to write ``nbytes`` random bytes into a new file in
    ``directory`` in 64 MiB writes and fsync it (the file is removed
    after): the disk's own rate for a shard of that size."""
    buf = np.random.default_rng(0).integers(0, 256, _WRITE_CHUNK,
                                            dtype=np.uint8)
    path = pathlib.Path(directory) / "raw_write.bin"
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        left = nbytes
        while left:
            n = min(left, buf.size)
            f.write(buf[:n])
            left -= n
        f.flush()
        os.fsync(f.fileno())
    dt = time.perf_counter() - t0
    path.unlink()
    return dt


def tinyllama_state(device="cuda") -> dict:
    """TinyLlama-1.1B's {"params", "opt"} at full width, seeded, m and v
    random (m ~ N(0, 1e-3), v = |N(0, 1e-3)|^2)."""
    cfg = registry.get_config("tinyllama-1.1b")
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init(gen, cfg)
    opt = init_opt_state(params, OptimizerConfig())
    tree_map(lambda m: m.normal_(0.0, 1e-3, generator=gen), opt["m"])
    tree_map(lambda v: v.normal_(0.0, 1e-3, generator=gen).square_(),
             opt["v"])
    return {"params": params, "opt": opt}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _line(stage: str, s: float, nbytes: int, rss: RssPeak, **kw) -> None:
    print("[ckpt_stage] " + json.dumps(dict(
        stage=stage, s=s, gb=nbytes / 1e9, gb_per_s=nbytes / 1e9 / s,
        rss_start_gb=rss.start_gb, rss_peak_gb=rss.peak_gb, **kw)),
        flush=True)


def _timed(stage: str, nbytes: int, fn, **kw):
    with RssPeak() as rss:
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
    _line(stage, dt, nbytes, rss, **kw)
    return out


def whole(state: dict, nbytes: int, device="cuda") -> None:
    """The whole-payload writer's and reader's stages, one at a time."""
    keys = [k for k, _ in checkpoint._tree_paths(state)]
    host = _timed("save: host snapshot", nbytes, lambda: [
        checkpoint._host(v) for _, v in checkpoint._tree_paths(state)])
    leaf = _timed("save: leaf bytes (tobytes)", nbytes,
                  lambda: [t.numpy().tobytes() for t in host])
    digests = _timed("save: blake2b digests, one thread", nbytes, lambda: [
        hashlib.blake2b(b, digest_size=16).hexdigest() for b in leaf])
    raw = _timed("save: msgpack packb of {key: bytes}", nbytes,
                 lambda: _msgpack.packb(dict(zip(keys, leaf))))
    held = 4 * nbytes / 1e9
    del host, leaf
    sample = memoryview(raw)[:SAMPLE_BYTES]
    for level in (3, 1):
        _timed(f"save: zlib level {level}, a sample", len(sample),
               lambda: zlib.compress(sample, level))
    del sample
    blob = _timed("save: zlib level 0 (stored)", len(raw),
                  lambda: zlib.compress(raw, 0))
    del raw
    d = OUT / "whole"
    d.mkdir(parents=True, exist_ok=True)
    _timed("save: write and fsync the shard", len(blob),
           lambda: checkpoint._write_durable(d / "data.msgpack.zst", blob),
           note="the disk's raw write rate too")
    size = len(blob)
    del blob
    blob = _timed("restore: read the shard", size,
                  lambda: (d / "data.msgpack.zst").read_bytes(),
                  note="warm: the file was just written")
    raw = _timed("restore: zlib decompress", size,
                 lambda: zlib.decompress(blob))
    del blob
    payload = _timed("restore: msgpack unpackb", nbytes,
                     lambda: _msgpack.unpackb(raw))
    del raw
    _timed("restore: blake2b digests, one thread", nbytes, lambda: [
        hashlib.blake2b(payload[k], digest_size=16).hexdigest()
        for k in keys] == digests)
    shapes = [tuple(v.shape) for _, v in checkpoint._tree_paths(state)]
    dtypes = [str(v.dtype).replace("torch.", "")
              for _, v in checkpoint._tree_paths(state)]

    def to_card():
        out = [torch.from_numpy(np.frombuffer(payload[k], dt).reshape(sh)
                                .copy()).to(device)
               for k, sh, dt in zip(keys, shapes, dtypes)]
        _sync(device)
        return out
    _timed("restore: leaves copied and put on the card", nbytes, to_card)
    del payload
    shutil.rmtree(d)
    print("[ckpt_stage] " + json.dumps({
        "stage": "whole: the payload's copies held at once at packing",
        "held_gb": held, "process_peak_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6}), flush=True)


def stream(state: dict, nbytes: int, device="cuda") -> None:
    """The checkpoint module's writer and reader at full width."""
    d = OUT / "stream"
    shutil.rmtree(d, ignore_errors=True)
    ck = checkpoint.AsyncCheckpointer(str(d))

    def save():
        ck.save(1, state)
        ck.wait()
    _timed("stream: AsyncCheckpointer.save until wait returns", nbytes,
           save, codec=checkpoint.DEFAULT_CODEC,
           level=checkpoint.LEVELS[checkpoint.DEFAULT_CODEC])
    shard = sum(f.stat().st_size for f in (d / "step_000000001").iterdir())

    def restore():
        out = checkpoint.restore_checkpoint(str(d), state, device=device)[0]
        _sync(device)
        return out
    back = _timed("stream: restore_checkpoint onto the card", nbytes,
                  restore, digests_checked=True)
    unequal = [k for (k, a), (_, b) in zip(checkpoint._tree_paths(back),
                                           checkpoint._tree_paths(state))
               if not torch.equal(a, b)]
    del back
    if unequal:
        raise RuntimeError(f"restored leaves differ: {unequal[:5]}")
    dt = raw_write_s(d, shard)
    print("[ckpt_stage] " + json.dumps({
        "stage": "stream: raw write and fsync of the shard's bytes",
        "s": dt, "gb": shard / 1e9, "gb_per_s": shard / 1e9 / dt,
        "leaves_bit_equal": True}), flush=True)
    shutil.rmtree(d)


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or ["whole",
                                                             "stream"]
    t0 = time.perf_counter()
    state = tinyllama_state()
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in checkpoint._tree_paths(state))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("[ckpt_stage] " + json.dumps({
        "stage": "state drawn on the card", "s": time.perf_counter() - t0,
        "gb": nbytes / 1e9, "leaves": len(checkpoint._tree_paths(state)),
        "card": card.strip(), "cpus": os.cpu_count()}), flush=True)
    for w in which:
        {"whole": whole, "stream": stream}[w](state, nbytes)
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
