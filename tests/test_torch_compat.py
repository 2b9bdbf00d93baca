"""The port's checkpoint interop against the JAX package's.

- ``Session.from_pretrained("resnet18", <committed fixture>)`` gives
  tensors equal bit for bit to ``resnet18_reference.npz``, and the same
  logits as the JAX package's session over the same file;
- an export -> reload round trip is bit-exact, and a file the port writes
  loads in ``repro.compat`` and back;
- the port's safetensors reader reads every committed fixture (single,
  sharded) exactly as the JAX package's does, and its writer, the mapping
  DSL and the torch-pickle reader agree with the reference's;
- malformed files raise one-line ``CompatError``s naming the file;
- loader errors as the reference's (an unregistered family, unmapped and
  missing keys); whisper-tiny loads (its converter is held in
  tests/test_torch_whisper.py);
- the qwen3-4b converter: the committed sharded fixture loads bit for bit
  equal to the JAX loader's trees and ``qwen3-4b_reference.npz``, an export
  reload is bit-exact (the config JSON in the reference's format), and
  ``Session.from_pretrained("qwen3-4b", ...)`` generates the JAX session's
  greedy tokens under the four presets.
"""
import os

import numpy as np
import pytest
import torch

from repro import compat as jax_compat
from repro.session import Session as JaxSession
from repro_torch import compat
from repro_torch.compat import CompatError, MapRule, Mapping, flatten_tree
from repro_torch.session import Session

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "compat")
RESNET = os.path.join(GOLDEN, "resnet18")
QWEN = os.path.join(GOLDEN, "qwen3-4b")


def _native(sess):
    flat = flatten_tree(sess.params)
    flat.update(flatten_tree(sess._state))
    return flat


def test_resnet18_fixture_loads_bit_exact():
    sess = Session.from_pretrained("resnet18", RESNET, device="cpu")
    ref = dict(np.load(os.path.join(GOLDEN, "resnet18_reference.npz")))
    got = _native(sess)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert sess.config.widths == (4, 8) and sess.config.blocks == (1, 1)
    assert isinstance(sess.params["stem"], torch.Tensor)


def test_resnet18_fixture_logits_match_jax(rng):
    images = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    mine = Session.from_pretrained("resnet18", RESNET, device="cpu")
    ref = JaxSession.from_pretrained("resnet18", RESNET)
    want = np.asarray(ref.apply(images))
    got = mine.apply(images).numpy()
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


def test_export_reload_round_trip_is_bit_exact(tmp_path):
    sess = Session.from_pretrained("resnet18", RESNET, device="cpu")
    path = tmp_path / "model.safetensors"
    sess.export(path)
    again = Session.from_pretrained("resnet18", path, device="cpu")
    a, b = _native(sess), _native(again)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert again.config == sess.config
    # the written file is the committed one, tensor for tensor
    want, meta = jax_compat.load_checkpoint(RESNET)
    got, got_meta = compat.read_safetensors(path)
    assert got_meta == meta and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_written_file_loads_in_jax_and_back(tmp_path):
    from repro_torch.bench.table4_resnet import seeded_resnet
    from repro_torch.models import resnet

    cfg = resnet.ResNetConfig(widths=(4, 8, 8, 12))
    params, state = seeded_resnet(cfg, seed=5, device="cpu", bn_batch=4)
    mine = Session.from_resnet(cfg, params, state, device="cpu")
    path = tmp_path / "mine.safetensors"
    mine.export(path)
    ref = JaxSession.from_pretrained("resnet18", path)
    assert tuple(ref.config.widths) == cfg.widths
    want = _native(mine)
    got = jax_compat.flatten_tree(ref.params)
    got.update(jax_compat.flatten_tree(ref._state))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    # and back: the JAX package's export loads in the port unchanged
    back = tmp_path / "back.safetensors"
    ref.export(back)
    again = _native(Session.from_pretrained("resnet18", back, device="cpu"))
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)


@pytest.mark.parametrize("family", ["qwen3-4b", "whisper-tiny", "resnet18"])
def test_reader_matches_jax_on_every_fixture(family):
    got, meta = compat.load_checkpoint(os.path.join(GOLDEN, family))
    want, want_meta = jax_compat.load_checkpoint(os.path.join(GOLDEN, family))
    assert meta == want_meta and sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_writer_round_trips_through_both_readers(tmp_path, rng):
    sd = {"a.f32": rng.standard_normal((3, 4)).astype(np.float32),
          "b.f64": rng.standard_normal(5),
          "c.i8": rng.integers(-5, 5, (2, 2)).astype(np.int8),
          "d.u16": rng.integers(0, 9, 3).astype(np.uint16),
          "e.bool": np.array([True, False]),
          "f.scalar": np.float32(2.5).reshape(())}
    one = tmp_path / "one.safetensors"
    compat.write_safetensors(one, sd, {"k": "v"})
    idx = compat.write_sharded_checkpoint(tmp_path / "sharded", sd,
                                          {"k": "v"}, max_shard_bytes=64)
    for path in (one, idx):
        for reader in (compat.load_checkpoint, jax_compat.load_checkpoint):
            got, meta = reader(path)
            assert meta == {"k": "v"} and sorted(got) == sorted(sd)
            for k in sd:
                assert got[k].dtype == sd[k].dtype
                np.testing.assert_array_equal(got[k], sd[k])


@pytest.mark.parametrize("damage,match", [
    (lambda raw: raw[:4], "truncated"),
    (lambda raw: (10 ** 6).to_bytes(8, "little") + raw[8:], "overruns"),
    (lambda raw: raw[:8] + b"]" + raw[9:], "bad JSON header"),
    (lambda raw: raw[:-4], "offsets"),
])
def test_malformed_files_raise_one_line_errors(damage, match, tmp_path):
    raw = open(os.path.join(RESNET, "model.safetensors"), "rb").read()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(damage(raw))
    with pytest.raises(CompatError, match=match) as e:
        compat.read_safetensors(path)
    assert str(path) in str(e.value) and "\n" not in str(e.value)


def test_loader_errors_match_jax(tmp_path):
    for mod in (compat, jax_compat):
        with pytest.raises(mod.CompatError, match="no checkpoint converter"):
            mod.load_pretrained("alexnet", "nowhere")
    # whisper-tiny is a supported family (tests/test_torch_whisper.py)
    assert compat.families() == jax_compat.families()
    assert Session.from_pretrained("whisper-tiny",
                                   os.path.join(GOLDEN, "whisper-tiny"),
                                   device="cpu").config.encoder_layers == 2
    foreign, meta = compat.load_checkpoint(RESNET)
    foreign = dict(foreign, **{"bn1.num_batches_tracked":
                               np.zeros((), np.float32)})
    path = tmp_path / "extra.safetensors"
    compat.write_safetensors(path, foreign, meta)
    for mod in (compat, jax_compat):
        with pytest.raises(mod.CompatError, match="unmapped"):
            mod.load_pretrained("resnet18", path)
    loaded = compat.load_pretrained("resnet18", path, unknown="ignore")
    np.testing.assert_array_equal(loaded.params["fc"], foreign["fc.weight"].T)
    del foreign["fc.bias"]
    compat.write_safetensors(path, foreign, meta)
    with pytest.raises(CompatError, match="missing 'fc.bias'"):
        compat.load_pretrained("resnet18", path, unknown="ignore")


def test_mapping_dsl_matches_jax(rng):
    """Stacked, transposed, permuted, reshaped and shifted rules import and
    export as the reference's do; all but the shift (an fp32 add) invert
    exactly."""
    foreign = {f"l.{i}.w": rng.standard_normal((3, 4)).astype(np.float32)
               for i in range(4)}
    foreign["conv"] = rng.standard_normal((2, 3, 1, 1)).astype(np.float32)
    foreign["norm"] = rng.standard_normal(5).astype(np.float32)
    spec = [dict(src="l.{i}.w", dst="even.w", transpose=True, stack=2,
                 start=0, stride=2),
            dict(src="l.{i}.w", dst="odd.w", stack=2, start=1, stride=2),
            dict(src="conv", dst="conv", permute=(2, 3, 1, 0),
                 reshape=(3, 2), src_shape=(2, 3, 1, 1)),
            dict(src="norm", dst="norm.scale", shift=-1.0)]
    mine = Mapping([MapRule(**r) for r in spec])
    ref = jax_compat.Mapping([jax_compat.MapRule(**r) for r in spec])
    got, want = mine.to_native(foreign), ref.to_native(foreign)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back, ref_back = mine.to_foreign(got), ref.to_foreign(want)
    for k in foreign:
        np.testing.assert_array_equal(back[k], ref_back[k], err_msg=k)
        if k != "norm":
            np.testing.assert_array_equal(back[k], foreign[k], err_msg=k)


def test_torch_pickle_reader_matches_jax(tmp_path, rng):
    sd = {"w": torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32)),
          "b": torch.arange(4, dtype=torch.int64), "step": 7}
    path = tmp_path / "w.pt"
    torch.save(sd, path)
    got = compat.read_torch_checkpoint(path)
    want = jax_compat.read_torch_checkpoint(path)
    assert sorted(got) == sorted(want) == ["b", "w"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_qwen3_fixture_loads_bit_exact():
    """The sharded qwen3-4b fixture through the port's converter: the same
    names, dtypes and bits as the JAX loader's trees and the committed
    reference, at the reduced config the file's metadata names."""
    sess = Session.from_pretrained("qwen3-4b", QWEN, device="cpu")
    ref = dict(np.load(os.path.join(GOLDEN, "qwen3-4b_reference.npz")))
    theirs = jax_compat.flatten_tree(
        jax_compat.load_pretrained("qwen3-4b", QWEN).params)
    got = flatten_tree(sess.params)
    assert sorted(got) == sorted(ref) == sorted(theirs)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got[k], np.asarray(theirs[k]), err_msg=k)
    assert sess.config.d_model == 64 and sess.arch_id == "qwen3-4b"
    assert isinstance(sess.params["embed"], torch.Tensor)
    assert "qwen3-4b" in compat.families()


def test_qwen3_export_reload_round_trip_is_bit_exact(tmp_path):
    """Export then reload gives the same bits; the written file equals the
    JAX package's export of the same fixture tensor for tensor (the norms'
    import shift of -1 and export shift of +1 need not give the fixture's
    own bits back, on either side), with the reference's config JSON, and
    the JAX package's export loads in the port."""
    sess = Session.from_pretrained("qwen3-4b", QWEN, device="cpu")
    path = tmp_path / "model.safetensors"
    sess.export(path)
    again = Session.from_pretrained("qwen3-4b", path, device="cpu")
    a, b = flatten_tree(sess.params), flatten_tree(again.params)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert again.config == sess.config
    back = tmp_path / "back.safetensors"
    JaxSession.from_pretrained("qwen3-4b", QWEN).export(back)
    want, meta = jax_compat.load_checkpoint(back)
    got, got_meta = compat.read_safetensors(path)
    assert got_meta == meta and sorted(got) == sorted(want)
    assert sorted(got) == sorted(jax_compat.load_checkpoint(QWEN)[0])
    assert got_meta["repro.config"] == '{"arch_id": "qwen3-4b", "reduced": true}'
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = flatten_tree(Session.from_pretrained("qwen3-4b", back,
                                                 device="cpu").params)
    for k in a:
        np.testing.assert_array_equal(again[k], a[k], err_msg=k)


@pytest.mark.parametrize("preset", ["exact", "segmented3", "segmented2",
                                    "segmented1"])
def test_qwen3_from_pretrained_tokens_match_jax(preset, rng):
    prompts = rng.integers(0, 256, (2, 11))
    mine = Session.from_pretrained("qwen3-4b", QWEN, policy=preset,
                                   device="cpu")
    ref = JaxSession.from_pretrained("qwen3-4b", QWEN, policy=preset)
    np.testing.assert_array_equal(
        mine.generate(prompts=prompts, gen_len=8).tokens,
        ref.generate(prompts=prompts, gen_len=8).tokens)


def test_lm_converter_refuses_what_the_reference_refuses():
    """The LM converter maps dense GQA stacks only, as the reference's:
    SSD and shared blocks (mamba2, zamba2) raise one-line errors."""
    from repro_torch.configs import get_arch

    conv = compat.converter_for("qwen3-4b")
    for arch, match in [("mamba2-130m", "kind='ssm'"),
                        ("zamba2-7b", "kind='ssm'")]:
        with pytest.raises(CompatError, match=match):
            conv.mapping(get_arch(arch).reduced())
    spec = conv.config_json(get_arch("qwen3-4b"))
    assert spec == jax_compat.converter_for("qwen3-4b").config_json(
        __import__("repro.configs", fromlist=["get_arch"]).get_arch("qwen3-4b"))
    assert conv.config_from_json(spec) == get_arch("qwen3-4b")
