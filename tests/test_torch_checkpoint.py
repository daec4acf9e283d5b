"""The port's checkpoint store against the JAX package's: the same on-disk
format, so a tree saved by either restores in the other bit for bit (bf16
leaves included), and the crash-consistency tests of
``tests/test_checkpoint_crash.py`` on the port's API."""
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import (AsyncCheckpointer, latest_step,
                               restore_checkpoint, save_checkpoint)

STATE = {"w": torch.arange(6.0), "n": {"b": torch.ones(2, dtype=torch.int32)}}


def _tree():
    """fp32, bf16 and int leaves in nested dicts and a list; dict keys out
    of order, so the flattening order is JAX's sorted one."""
    g = torch.Generator().manual_seed(0)
    return {"z": {"w": torch.randn(3, 5, generator=g),
                  "b16": torch.randn(4, 7, generator=g).to(torch.bfloat16)},
            "a": [torch.arange(5, dtype=torch.int32),
                  torch.randn(2, generator=g).to(torch.bfloat16),
                  np.full((2, 2), 0.5, np.float32)],
            "step": np.int32(12)}


def _as_jax(tree):
    def leaf(t):
        if isinstance(t, torch.Tensor):
            if t.dtype == torch.bfloat16:
                return jnp.asarray(t.view(torch.int16).numpy()).view(
                    jnp.bfloat16)
            return jnp.asarray(t.numpy())
        return jnp.asarray(t)
    return jax.tree.map(leaf, tree)


def _bits(x):
    """A leaf's dtype name, shape and raw bytes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy() \
                .tobytes()
        x = x.numpy()
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def _leaves(tree):
    return [leaf for _, leaf in jckpt._tree_paths(tree)]


def test_tree_keys_and_order_are_jax():
    tree = _tree()
    assert [k for k, _ in tckpt._tree_paths(tree)] == \
        [k for k, _ in jckpt._tree_paths(_as_jax(tree))]


CODECS = ["zlib", "zstd"]


def _codec(monkeypatch, codec):
    """Both packages write ``codec``'s shards."""
    monkeypatch.setattr(jckpt, "DEFAULT_CODEC", codec)
    monkeypatch.setattr(tckpt, "DEFAULT_CODEC", codec)


@pytest.mark.parametrize("codec", CODECS)
def test_port_checkpoint_restores_in_jax(tmp_path, monkeypatch, codec):
    _codec(monkeypatch, codec)
    tree = _tree()
    save_checkpoint(str(tmp_path), 3, tree)
    restored, step = jckpt.restore_checkpoint(str(tmp_path), _as_jax(tree))
    assert step == 3
    for got, want in zip(_leaves(restored), _leaves(tree)):
        assert _bits(np.asarray(got)) == _bits(want)
    assert restored["z"]["b16"].dtype == jnp.bfloat16


@pytest.mark.parametrize("codec", CODECS)
def test_jax_checkpoint_restores_in_port(tmp_path, monkeypatch, codec):
    _codec(monkeypatch, codec)
    tree = _tree()
    jckpt.save_checkpoint(str(tmp_path), 4, _as_jax(tree))
    restored, step = restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert step == 4
    assert restored.keys() == tree.keys() and len(restored["a"]) == 3
    for (key, got), (_, want) in zip(tckpt._tree_paths(restored),
                                     tckpt._tree_paths(tree)):
        assert isinstance(got, torch.Tensor), key
        assert _bits(got) == _bits(want), key
    assert restored["z"]["b16"].dtype == torch.bfloat16


def _written(base, codec):
    """The decompressed shard and the manifest (its wall-clock time
    dropped) of the step-1 checkpoint under ``base``."""
    d = base / "step_000000001"
    blob = (d / "data.msgpack.zst").read_bytes()
    raw = zlib.decompress(blob) if codec == "zlib" else \
        jckpt.zstd.ZstdDecompressor().decompress(blob)
    man = json.loads((d / "manifest.json").read_text())
    man.pop("time")
    return raw, man


def test_same_bytes_on_disk(tmp_path, monkeypatch):
    """Both packages write the same shard, once decompressed, and the same
    manifest (but its wall-clock time) for the same tree and codec. The
    compressed bytes differ: the port's zlib writes stored blocks (level
    0), the reference's compresses at level 3."""
    _codec(monkeypatch, "zlib")
    tree = _tree()
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, tree)
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, _as_jax(tree))
    (raw_t, man_t), (raw_j, man_j) = (_written(tmp_path / p, "zlib")
                                      for p in "tj")
    assert raw_t == raw_j
    assert man_t == man_j and man_t["codec"] == "zlib"


@pytest.mark.parametrize("codec", CODECS)
def test_streamed_shard_is_the_references_payload(tmp_path, monkeypatch,
                                                  codec):
    """The shard the port streams leaf by leaf, decompressed, is the
    reference's ``msgpack.packb`` of the tree's leaf bytes, byte for byte;
    the manifest is the reference's but for its time."""
    import msgpack
    _codec(monkeypatch, codec)
    tree = _tree()
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, tree)
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, _as_jax(tree))
    raw, man = _written(tmp_path / "t", codec)
    payload = {key: np.asarray(leaf).tobytes()
               for key, leaf in jckpt._tree_paths(_as_jax(tree))}
    assert raw == msgpack.packb(payload, use_bin_type=True)
    assert man == _written(tmp_path / "j", codec)[1]


@pytest.mark.parametrize("codec", CODECS)
def test_large_and_many_leaves_round_trip(tmp_path, monkeypatch, codec):
    """A leaf of 68 MB (past one 64 MiB chunk of the stream) among 300
    small ones, fp32, bf16 and int: the same bits back, every leaf's
    digest checked, and a wrong digest of the large leaf refused."""
    _codec(monkeypatch, codec)
    rng = np.random.default_rng(0)
    tree = {"big": torch.from_numpy(rng.standard_normal(17_000_000,
                                                        np.float32)),
            "small": [torch.from_numpy(rng.standard_normal(
                (i % 7, 3), np.float32)).to(torch.bfloat16 if i % 2
                                            else torch.float32)
                      for i in range(300)],
            "ids": torch.arange(1000, dtype=torch.int64)}
    save_checkpoint(str(tmp_path), 1, tree)
    shard = tmp_path / "step_000000001" / "data.msgpack.zst"
    if codec == "zlib":     # the stream's Adler-32, summed over chunks
        assert len(zlib.decompress(shard.read_bytes())) > 68_000_000
    checked = []
    real = tckpt._digest

    def digest(buf):
        checked.append(buf.size)
        return real(buf)
    monkeypatch.setattr(tckpt, "_digest", digest)
    restored, step = restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert step == 1 and len(checked) == 302
    for (key, got), (_, want) in zip(tckpt._tree_paths(restored),
                                     tckpt._tree_paths(tree)):
        assert _bits(got) == _bits(want), key
    manifest = tmp_path / "step_000000001" / "manifest.json"
    m = json.loads(manifest.read_text())
    assert m["leaves"][0]["key"] == "big"
    m["leaves"][0]["digest"] = "0" * 32
    manifest.write_text(json.dumps(m))
    with pytest.raises(IOError, match="digest mismatch for 'big'"):
        restore_checkpoint(str(tmp_path), tree, device="cpu")


def test_zlib_stream_stored_then_compressed_restores(tmp_path,
                                                     monkeypatch):
    """A zlib shard whose first blocks are stored and the rest compressed
    (a stream deflate may write): the stored reader meets a compressed
    block, and the restore starts over inflating the stream."""
    _codec(monkeypatch, "zlib")
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    shard = tmp_path / "step_000000001" / "data.msgpack.zst"
    raw = zlib.decompress(shard.read_bytes())
    cut = len(raw) // 3
    rest = zlib.compressobj(6, zlib.DEFLATED, -15)
    mixed = (b"\x78\x01" + tckpt._STORED.pack(0, cut, cut ^ 0xFFFF)
             + raw[:cut] + rest.compress(raw[cut:]) + rest.flush()
             + zlib.adler32(raw).to_bytes(4, "big"))
    assert zlib.decompress(mixed) == raw
    shard.write_bytes(mixed)
    restored, _ = restore_checkpoint(str(tmp_path), tree, device="cpu")
    for (key, got), (_, want) in zip(tckpt._tree_paths(restored),
                                     tckpt._tree_paths(tree)):
        assert _bits(got) == _bits(want), key


def test_zstd_shard_without_zstandard_raises(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 1, STATE)
    manifest = tmp_path / "step_000000001" / "manifest.json"
    m = json.loads(manifest.read_text())
    m["codec"] = "zstd"
    manifest.write_text(json.dumps(m))
    monkeypatch.setattr(tckpt, "zstd", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        restore_checkpoint(str(tmp_path), STATE, device="cpu")


def test_restore_refuses_shardings_and_checks_digests(tmp_path):
    save_checkpoint(str(tmp_path), 1, STATE)
    # shardings that do not cover every leaf are refused (placing leaves
    # on a mesh: tests/test_torch_restore.py)
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), STATE, shardings={}, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), {"other": torch.zeros(1)},
                           device="cpu")
    manifest = tmp_path / "step_000000001" / "manifest.json"
    m = json.loads(manifest.read_text())
    m["leaves"][0]["digest"] = "0" * 32
    manifest.write_text(json.dumps(m))
    with pytest.raises(IOError, match="digest mismatch"):
        restore_checkpoint(str(tmp_path), STATE, device="cpu")
    assert restore_checkpoint(str(tmp_path), STATE, verify=False,
                              device="cpu")[1] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            restore_checkpoint(str(tmp_path), STATE)


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The background writer saves the values handed to ``save``, not
    what an in-place update writes into the tensors afterwards."""
    w = torch.zeros(4)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"w": w})
    w.add_(5.0)
    ck.wait()
    restored, _ = restore_checkpoint(str(tmp_path), {"w": w}, device="cpu")
    assert torch.equal(restored["w"], torch.zeros(4))


def test_async_snapshot_failure_raises_at_save(tmp_path):
    """The writer starts on the first leaves while ``save`` snapshots the
    rest: a snapshot that fails raises from ``save`` itself, the writer
    publishes nothing, and the next ``wait`` and ``save`` start clean."""
    class Bad:
        def __array__(self, *args, **kwargs):
            raise ValueError("no host copy")
    ck = AsyncCheckpointer(str(tmp_path))
    with pytest.raises(ValueError, match="no host copy"):
        ck.save(1, {"a": torch.ones(4), "z": Bad()})
    ck.wait()
    assert latest_step(str(tmp_path)) is None
    ck.save(2, {"a": torch.ones(4)})
    ck.wait()
    assert latest_step(str(tmp_path)) == 2


# ------------------------------------------- tests/test_checkpoint_crash.py
def _torn(base, step, kind):
    """Fabricate a crashed publish: a step directory that is present but
    not restorable."""
    d = base / f"step_{step:09d}"
    d.mkdir()
    if kind == "no_manifest":
        (d / "data.msgpack.zst").write_bytes(b"\x00\x01")
    elif kind == "bad_json":
        (d / "manifest.json").write_text("{not json")
        (d / "data.msgpack.zst").write_bytes(b"\x00\x01")
    elif kind == "no_data":
        (d / "manifest.json").write_text(json.dumps({"step": step,
                                                     "leaves": []}))
    return d


def test_latest_step_skips_torn_newest(tmp_path):
    save_checkpoint(str(tmp_path), 5, STATE)
    for step, kind in ((6, "no_manifest"), (7, "bad_json"), (8, "no_data")):
        _torn(tmp_path, step, kind)
    assert latest_step(str(tmp_path)) == 5       # newest *valid* step
    restored, step = restore_checkpoint(str(tmp_path), STATE, device="cpu")
    assert step == 5
    assert float(restored["w"][3]) == 3.0


def test_latest_step_none_when_nothing_valid(tmp_path):
    _torn(tmp_path, 1, "no_manifest")
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), STATE, device="cpu")


def test_gc_counts_only_valid_checkpoints(tmp_path):
    save_checkpoint(str(tmp_path), 1, STATE)
    for step in (2, 3, 4):
        _torn(tmp_path, step, "no_manifest")
    save_checkpoint(str(tmp_path), 9, STATE, keep_last=2)
    names = sorted(p.name for p in tmp_path.glob("step_*"))
    assert names == ["step_000000001", "step_000000009"]
    assert latest_step(str(tmp_path)) == 9
    restored, step = restore_checkpoint(str(tmp_path), STATE, step=1,
                                        device="cpu")
    assert step == 1


def test_save_sweeps_stale_tmp_and_old_leftovers(tmp_path):
    stale_tmp = tmp_path / "step_000000003.tmp"
    stale_tmp.mkdir()
    (stale_tmp / "data.msgpack.zst").write_bytes(b"junk")
    stale_old = tmp_path / "step_000000003.old"
    stale_old.mkdir()
    save_checkpoint(str(tmp_path), 3, STATE)
    assert not stale_tmp.exists() and not stale_old.exists()
    save_checkpoint(str(tmp_path), 3, STATE)
    restored, step = restore_checkpoint(str(tmp_path), STATE, device="cpu")
    assert step == 3 and float(restored["w"][5]) == 5.0


def test_async_checkpointer_surfaces_error_on_wait(tmp_path):
    blocker = tmp_path / "ckpts"
    blocker.write_text("a file where the checkpoint dir should be")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, {"w": torch.zeros(4)})            # background thread fails
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                    # error cleared, no re-raise


def test_async_checkpointer_surfaces_error_on_next_save(tmp_path):
    blocker = tmp_path / "ckpts"
    blocker.write_text("a file where the checkpoint dir should be")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, {"w": torch.zeros(4)})
    with pytest.raises(OSError):
        ck.save(2, {"w": torch.zeros(4)})        # save() drains the error
    ck.directory = str(tmp_path / "ok")
    ck.save(3, {"w": torch.full((4,), 7.0)})
    ck.wait()
    assert latest_step(ck.directory) == 3
