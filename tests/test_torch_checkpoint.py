"""The port's checkpoints (``repro_torch.checkpoint.io``) and trainer CLI
(``repro_torch.launch.train``) against the JAX package's.

A checkpoint is the JAX package's layout and bytes: the port's own msgpack
encoder gives ``msgpack.packb(..., use_bin_type=True)``'s bytes, leaves go
in ``jax.tree`` order, and a checkpoint written by either package's
trainer restores in the other's and trains on.  A restart from a
checkpoint ends bit for bit where the uninterrupted run ends.
"""
import os
import shutil
import zlib

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro_torch import tree as tree_util
from repro_torch.checkpoint import io
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw

# losses of a run resumed in the other package: the same data and a
# restored state, then fp32 sum orders and Adam's amplification of ulps
# (tests/test_torch_train.py).  Measured: the first resumed loss equal
# (JAX to port) or 3.7e-6 apart (port to JAX), the second 2.7e-5 at most.
RESUME_LOSS_RTOL = 1e-4
TRAIN = dict(steps=4, seq_len=16, batch=4, ckpt_every=2, lr=3e-3,
             log_every=100)


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, 1.5, -0.0,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40, b"", b"x" * 300,
    b"y" * 70000, list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"version": 1, "leaves": [{"dtype": "float32", "shape": [2, 3],
                               "data": np.arange(6, dtype=np.float32)
                               .tobytes()}]}])
def test_msgpack_subset_equals_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert io.packb(obj) == want
    assert io.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_shard_bytes_equal_the_reference_encoding(tmp_path):
    tree = {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "a": {"z": torch.tensor([1.5, -2.0]).to(torch.bfloat16),
                  "y": torch.tensor(7, dtype=torch.int32)}}
    io.save(str(tmp_path), 5, tree)
    blob = (tmp_path / "step_000000005" / "shard_0.msgpack.zst").read_bytes()
    # the JAX package's leaf encoding of the same leaves, in jax.tree order
    want = {"version": 1, "leaves": [
        {"dtype": "int32", "shape": [], "data": np.int32(7).tobytes()},
        {"dtype": "bfloat16", "shape": [2],
         "data": (np.array([1.5, -2.0], np.float32).view(np.uint32) >> 16)
         .astype(np.uint16).tobytes()},
        {"dtype": "float32", "shape": [2, 3],
         "data": np.arange(6, dtype=np.float32).tobytes()}]}
    assert zlib.decompress(blob) == msgpack.packb(want, use_bin_type=True)
    back, manifest = io.restore(str(tmp_path), tree)
    assert manifest["step"] == 5 and manifest["nshards"] == 1
    for a, b in zip(tree_util.leaves(back), tree_util.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_commit_prune_and_partial_writes(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones(3)}
    for s in (1, 2, 3, 4):
        io.save(d, s, tree, keep=2)
    assert io.all_steps(d) == [3, 4] == jio.all_steps(d)
    os.makedirs(os.path.join(d, "step_000000009.tmp"))
    os.makedirs(os.path.join(d, "step_000000008"))     # no manifest
    assert io.latest_step(d) == 4
    with pytest.raises(FileNotFoundError):
        io.restore(str(tmp_path / "empty"), tree)
    with pytest.raises(ValueError, match="shape"):
        io.restore(d, {"w": torch.ones(4)})


def test_zstd_shards_restore_where_zstandard_imports(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    tree = {"w": np.arange(4, dtype=np.float32)}
    monkeypatch.setattr(jio, "zstandard", __import__("zstandard"))
    jio.save(str(tmp_path), 1, tree)
    back, _ = io.restore(str(tmp_path), {"w": torch.zeros(4)})
    assert torch.equal(back["w"], torch.arange(4, dtype=torch.float32))
    import builtins

    real_import = builtins.__import__

    def no_zstd(name, *a, **k):
        if name == "zstandard":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_zstd)
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        io.restore(str(tmp_path), {"w": torch.zeros(4)})


def _only_step(src, dst, step):
    """A copy of ``src`` holding its checkpoint of ``step`` alone: the run
    that wrote it stopped there."""
    os.makedirs(dst)
    name = f"step_{step:09d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return dst


def test_jax_checkpoint_restores_in_the_port_and_trains_on(tmp_path):
    dj = str(tmp_path / "jax")
    _, jopt, jlosses = jtrain.train("qwen3-4b", ckpt_dir=dj, **TRAIN)
    d = _only_step(dj, str(tmp_path / "resume"), 2)
    params, opt, losses = ttrain.train("qwen3-4b", ckpt_dir=d, device="cpu",
                                       **TRAIN)
    assert losses == pytest.approx(jlosses[2:], rel=RESUME_LOSS_RTOL)
    assert isinstance(opt, adamw.OptState) and int(opt.step) == 4
    assert int(jopt.step) == 4


def test_port_checkpoint_restores_in_jax_and_trains_on(tmp_path):
    dt = str(tmp_path / "port")
    _, _, losses = ttrain.train("qwen3-4b", ckpt_dir=dt, device="cpu",
                                **TRAIN)
    d = _only_step(dt, str(tmp_path / "resume"), 2)
    jparams, jopt, jlosses = jtrain.train("qwen3-4b", ckpt_dir=d, **TRAIN)
    assert jlosses == pytest.approx(losses[2:], rel=RESUME_LOSS_RTOL)
    assert isinstance(jopt, jadamw.OptState) and int(jopt.step) == 4
    # the port's params and moments, read by the reference's own restore
    ref, _ = jio.restore(dt, (jparams, jopt), step=4)
    assert [np.shape(a) for a in jax.tree.leaves(ref)] == \
        [np.shape(a) for a in jax.tree.leaves((jparams, jopt))]


def test_restart_is_exact(tmp_path):
    d = str(tmp_path / "run")
    kw = dict(steps=6, seq_len=16, batch=4, ckpt_every=3, lr=3e-3,
              log_every=100, device="cpu")
    p1, o1, l1 = ttrain.train("mamba2-130m", ckpt_dir=d, **kw)
    assert io.all_steps(d) == [3, 6]
    d2 = _only_step(d, str(tmp_path / "restart"), 3)
    p2, o2, l2 = ttrain.train("mamba2-130m", ckpt_dir=d2, **kw)
    assert l2 == l1[3:]
    for a, b in zip(tree_util.leaves((p1, o1)), tree_util.leaves((p2, o2))):
        assert torch.equal(a, b)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    ttrain.main(["--arch", "qwen3-4b", "--steps", "3", "--seq-len", "8",
                 "--batch", "2", "--device", "cpu", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "[train] qwen3-4b step     0 loss" in out
    assert io.all_steps(d) == [3]
    ttrain.main(["--arch", "qwen3-4b", "--steps", "4", "--seq-len", "8",
                 "--batch", "2", "--device", "cpu", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert "restored step 3" in out and "step     3 loss" in out
    assert io.all_steps(d) == [3, 4]
