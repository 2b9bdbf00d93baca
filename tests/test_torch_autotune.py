"""The port's kernel autotuner (``repro_torch.kernels.autotune``) against
the JAX package's contract (``tests/test_kernels_autotune.py``), on the
port's own grids and backends (``hopper``, ``torch``):

1. the ``repro-tune/1`` artifact round-trips, saves atomically, and every
   malformed artifact (the JAX package's own, with its backends, among
   them) is a one-line ``TuneError``;
2. the sweep takes the measured argmin, keeps today's static choice in
   every grid, clips only the SSD chunk and skips untunable pairs;
3. the wrappers' launch shapes (K1's ``plan``, K2's CTA shape, K3's chunk)
   follow an active table for the operand's device kind, and with none
   (or one for another kind) are the static ones;
4. ``Session(tune=)`` and the session CLI's ``--tune`` activate a table; a
   bad path raises one line.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import afpm_bitwise as k2
from repro_torch.kernels import afpm_matmul as k1
from repro_torch.kernels import autotune, dispatch
from repro_torch.kernels.autotune import TuneError, TuningTable

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_activation(monkeypatch):
    """Every test starts and ends with no active table and no env var."""
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    autotune.deactivate()
    yield
    autotune.deactivate()


def make_table(device="cpu", **entries):
    t = TuningTable(device=device)
    for key, block in entries.items():
        kernel, backend, bucket = key.split("__")
        t.put(kernel, backend, bucket, block, 1.0)
    return t


# -- artifact contract -------------------------------------------------------

def test_schema_round_trip(tmp_path):
    t = make_table(matmul__hopper__large=(32, 64, 1),
                   bitwise__hopper__medium=(128, 4096),
                   ssd__torch__large=256)
    t.meta["fast"] = True
    path = tmp_path / "TUNE_test.json"
    t.save(str(path))
    loaded = autotune.load(str(path))
    assert loaded.device == "cpu" and loaded.meta == {"fast": True}
    assert loaded.lookup("matmul", "hopper", "large") == (32, 64, 1)
    assert loaded.lookup("bitwise", "hopper", "medium") == (128, 4096)
    assert loaded.lookup("ssd", "torch", "large") == 256
    assert loaded.lookup("ssd", "torch", "small") is None
    assert json.loads(path.read_text())["schema"] == autotune.SCHEMA


def test_save_is_atomic_and_leaves_no_temp(tmp_path):
    path = tmp_path / "TUNE_a.json"
    make_table(ssd__torch__small=64).save(str(path))
    make_table(ssd__torch__small=128).save(str(path))
    assert autotune.load(str(path)).lookup("ssd", "torch", "small") == 128
    assert [p.name for p in tmp_path.iterdir()] == ["TUNE_a.json"]


def _artifact(entries):
    return json.dumps({"schema": autotune.SCHEMA, "device": "cpu",
                       "entries": entries})


@pytest.mark.parametrize("name,content", [
    ("missing.json", None),
    ("not_json.json", "{oops"),
    ("bad_schema.json", json.dumps({"schema": "repro-tune/999",
                                    "device": "cpu", "entries": {}})),
    ("no_device.json", json.dumps({"schema": autotune.SCHEMA,
                                   "entries": {}})),
    ("bad_key.json", _artifact({"matmul/small": {"block": 1,
                                                 "median_us": 1.0}})),
    ("bad_kernel.json", _artifact({"conv/torch/small": {"block": 1,
                                                        "median_us": 1.0}})),
    ("bad_block.json", _artifact({"ssd/torch/small": {"block": -8,
                                                      "median_us": 1.0}})),
    ("no_median.json", _artifact({"ssd/torch/small": {"block": 64}})),
])
def test_load_rejects_malformed_artifacts(tmp_path, name, content):
    p = tmp_path / name
    if content is not None:
        p.write_text(content)
    with pytest.raises(TuneError) as err:
        autotune.load(str(p))
    assert "\n" not in str(err.value)


def test_a_jax_artifact_is_refused_in_one_line():
    """The JAX package's own artifact (its backends pallas / interpret /
    xla) applies to nothing here: one line naming the port's backends."""
    path = ROOT / "kernels" / "TUNE_cpu_ci.json"
    with pytest.raises(TuneError) as err:
        autotune.load(str(path))
    msg = str(err.value)
    assert "\n" not in msg and "hopper/torch" in msg
    assert "JAX package" in msg and str(path) in msg


def test_entry_key_validates_names():
    assert autotune.entry_key("ssd", "torch", "large") == "ssd/torch/large"
    for bad in (("conv", "torch", "large"), ("ssd", "xla", "large"),
                ("ssd", "cuda", "large"), ("ssd", "torch", "huge")):
        with pytest.raises(TuneError):
            autotune.entry_key(*bad)


def test_grids_hold_the_static_choice_and_clip_only_the_chunk():
    for bucket in autotune.BUCKETS:
        assert autotune.candidates("matmul", "hopper", bucket)[0] == \
            autotune.MATMUL_STATIC
        assert autotune.candidates("bitwise", "hopper", bucket)[0] == \
            k2.STATIC_BLOCK
        for backend in ("hopper", "torch"):
            assert dispatch.SCAN_CHUNKS[(backend, bucket)] in \
                autotune.candidates("ssd", backend, bucket)
    # K1's and K2's blocks are launch shapes, not extents: never clipped
    assert autotune.candidates("matmul", "hopper", "small", max_extent=8) \
        == autotune.candidates("matmul", "hopper", "small")
    assert autotune.candidates("ssd", "hopper", "small", max_extent=150) \
        == [64, 128]
    assert autotune.candidates("ssd", "torch", "small", max_extent=8) == [32]
    # the plain K1 and K2 take no launch shape: not tunable
    assert not autotune.tunable("matmul", "torch")
    assert not autotune.tunable("bitwise", "torch")
    assert autotune.tunable("ssd", "torch")
    with pytest.raises(TuneError):
        autotune.candidates("matmul", "torch", "small")


# -- sweep core (a fake measure_fn: no kernels, no timing) -------------------

def test_sweep_picks_the_measured_argmin():
    def fake_measure(kernel, backend, bucket, block, size):
        dims = block if isinstance(block, tuple) else (block,)
        return 1.0 if dims[0] in (64, 32) else 100.0

    table = autotune.sweep(fake_measure, kernels=("ssd",),
                           buckets=("small", "medium"), device="testdev")
    assert table.device == "testdev"
    assert table.lookup("ssd", "hopper", "small") == 64
    assert table.lookup("ssd", "torch", "small") == 32
    assert table.lookup("ssd", "torch", "medium") == 64
    entry = table.entries["ssd/torch/medium"]
    assert entry["median_us"] == 1.0
    assert set(entry["candidates"]) == {"64", "128", "256"}


def test_sweep_skips_untunable_pairs_and_clips_by_size():
    seen = []

    def fake_measure(kernel, backend, bucket, block, size):
        seen.append((kernel, backend, bucket, block))
        return float(len(seen))

    table = autotune.sweep(fake_measure, kernels=("matmul", "bitwise", "ssd"),
                           backends=("torch",), buckets=("small",),
                           sizes={"small": 40}, device="testdev")
    assert all(k == "ssd" for k, *_ in seen)
    assert set(table.entries) == {"ssd/torch/small"}
    assert [b for *_, b in seen] == [32]
    table = autotune.sweep(fake_measure, kernels=("matmul",),
                           buckets=("large",), device="testdev")
    assert table.lookup("matmul", "hopper", "large") == autotune.MATMUL_STATIC


def test_device_kind():
    assert autotune.device_kind() == autotune.device_kind("cpu") == "cpu"
    assert autotune.device_kind(torch.device("meta")) == "cpu"
    assert autotune._sanitize("NVIDIA H100 80GB HBM3") == \
        "nvidia_h100_80gb_hbm3"
    assert autotune.artifact_name("nvidia_h100_80gb_hbm3") == \
        "TUNE_nvidia_h100_80gb_hbm3.json"


# -- the wrappers' launch shapes ---------------------------------------------

# (M, K, N): qwen3-4b's decode and prefill projections, a lone-CTA shape, a
# shape that splits K and one that runs whole
SHAPES = [(4, 2560, 4096), (4, 2560, 1024), (150, 2560, 9728),
          (150, 9728, 2560), (4, 512, 64), (2048, 4096, 4096)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_k1_plan_static_without_a_table(M, K, N):
    assert k1.tuned_tile(M, K, N, "cpu") is None
    assert k1.plan(M, K, N) == k1.plan(M, K, N, autotune.MATMUL_STATIC)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_k1_plan_under_a_tuned_table(M, K, N):
    tile = (16, 64, 1)
    autotune.activate(make_table(matmul__hopper__large=tile,
                                 matmul__hopper__medium=tile,
                                 matmul__hopper__small=tile))
    assert k1.tuned_tile(M, K, N, "cpu") == tile
    p = k1.plan(M, K, N, k1.tuned_tile(M, K, N, "cpu"))
    static = k1.plan(M, K, N)
    # the rows a CTA still follow M, up to the tile's cap of 16
    assert p.mt == min(static.mt, 2)
    assert p.bn == k1.BN and not p.split
    # the same K chunks in every plan: a tile never changes the arithmetic
    assert p.grid[2] * 8 * p.mt >= M
    # a table for another device kind applies to nothing
    assert k1.tuned_tile(M, K, N, "meta") == tile   # meta is the CPU kind
    autotune.activate(make_table(device="nvidia_h100_80gb_hbm3",
                                 matmul__hopper__large=tile))
    assert k1.tuned_tile(M, K, N, "cpu") is None


def test_k1_plan_rejects_a_tile_the_kernel_cannot_take():
    for tile in ((24, 64, 2), (64, 96, 2), (64, 64, 0)):
        with pytest.raises(ValueError, match="bad tile"):
            k1.plan(4, 512, 64, tile)


def test_k2_launch_shape_static_and_tuned():
    for n in (512 * 512, 8192 * 8192, 7):
        assert k2.launch_block(n, "cpu") == k2.STATIC_BLOCK
    autotune.activate(make_table(bitwise__hopper__medium=(128, 1056)))
    assert k2.launch_block(512 * 512, "cpu") == (128, 1056)
    # 65536 elements tile a 256-square: "small", not covered
    assert k2.launch_block(65536, "cpu") == k2.STATIC_BLOCK
    assert k2.launch_block(8192 * 8192, "cpu") == k2.STATIC_BLOCK


def test_k2_block_changes_no_product_on_the_cpu():
    """On the CPU the wrapper takes the plain version whatever the block;
    the products are bit for bit the dispatch's."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((64, 64)).astype(np.float32))
    y = torch.tensor(rng.standard_normal((64, 64)).astype(np.float32))
    want = dispatch.multiply(x, y)
    got = dispatch.multiply(x, y, block=(64, 8))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_scan_chunk_static_and_tuned():
    static = {(b, L): dispatch.scan_chunk(b, L, "cpu")
              for b in ("hopper", "torch") for L in (150, 600, 2048)}
    assert static == {(b, L): dispatch.SCAN_CHUNKS[(b, autotune.shape_bucket(L))]
                      for b, L in static}
    autotune.activate(make_table(ssd__torch__small=32, ssd__hopper__large=512))
    assert dispatch.scan_chunk("torch", 150, "cpu") == 32
    assert dispatch.scan_chunk("hopper", 2048, "cpu") == 512
    assert dispatch.scan_chunk("torch", 600, "cpu") == static[("torch", 600)]
    autotune.deactivate()
    assert {(b, L): dispatch.scan_chunk(b, L, "cpu") for b, L in static} \
        == static


def test_plain_ssd_under_a_tuned_chunk_equals_the_explicit_chunk():
    rng = np.random.default_rng(3)
    L, H, P, N = 150, 3, 8, 16
    x = torch.tensor(rng.standard_normal((L, H, P)).astype(np.float32))
    dt = torch.tensor(rng.uniform(0.01, 0.2, (L, H)).astype(np.float32))
    A = torch.tensor(-rng.uniform(0.5, 2.0, (H,)).astype(np.float32))
    B = torch.tensor(rng.standard_normal((L, N)).astype(np.float32))
    C = torch.tensor(rng.standard_normal((L, N)).astype(np.float32))
    for chunk in autotune.candidates("ssd", "torch", "small"):
        autotune.activate(make_table(ssd__torch__small=chunk))
        tuned = dispatch.ssd(x, dt, A, B, C, backend="torch")
        autotune.deactivate()
        want = dispatch.ssd(x, dt, A, B, C, chunk=chunk, backend="torch")
        assert torch.equal(tuned, want), chunk
    # with no table: the static chunk
    assert torch.equal(dispatch.ssd(x, dt, A, B, C, backend="torch"),
                       dispatch.ssd(x, dt, A, B, C, backend="torch",
                                    chunk=dispatch.SCAN_CHUNKS[("torch",
                                                                "small")]))


def test_matmul_tile_override_reaches_the_kernel_route(monkeypatch):
    """``dispatch.matmul(tile=)`` hands the tile to K1's wrapper (what a
    measure_fn times); without one the wrapper looks the table up."""
    seen = []

    def fake(x, w, passes=3, tile=None):
        seen.append(tile)
        return torch.zeros(x.shape[:-1] + (w.shape[1],))

    monkeypatch.setattr(dispatch, "resolve_backend", lambda b, x: "hopper")
    monkeypatch.setattr(dispatch.custom_ops, "afpm_matmul", fake)
    x, w = torch.ones(4, 8), torch.ones(8, 16)
    dispatch.matmul(x, w, 3, tile=(32, 64, 1))
    dispatch.matmul(x, w, 3)
    assert seen == [(32, 64, 1), None]


def test_table_for_other_device_kind_never_applies():
    t = make_table(device="nvidia_h100_80gb_hbm3", ssd__torch__small=999)
    autotune.activate(t)
    assert autotune.active_table() is t
    assert dispatch.scan_chunk("torch", 96, "cpu") == \
        dispatch.SCAN_CHUNKS[("torch", "small")]


def test_env_var_activates_lazily_on_first_lookup(tmp_path, monkeypatch):
    path = tmp_path / "TUNE_env.json"
    make_table(ssd__torch__small=64).save(str(path))
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    autotune.deactivate()
    assert dispatch.scan_chunk("torch", 96, "cpu") == 64
    assert autotune.active_source() == str(path)


def test_activate_path_errors_are_structured(tmp_path):
    with pytest.raises(TuneError, match="cannot read"):
        autotune.activate(str(tmp_path / "nope.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{truncated")
    with pytest.raises(TuneError, match="unreadable"):
        autotune.activate(str(bad))
    assert autotune.active_table() is None


# -- Session(tune=) and --tune -----------------------------------------------

def test_session_tune_knob_activates_and_rejects_bad_artifacts(tmp_path):
    from repro_torch.session import Session, SessionError

    path = tmp_path / "TUNE_sess.json"
    make_table(ssd__torch__small=64).save(str(path))
    s = Session("qwen3-4b", tune=str(path), device="cpu")
    assert autotune.active_source() == str(path)
    assert dispatch.scan_chunk("torch", 96, "cpu") == 64
    # replace carries tune and mesh
    autotune.deactivate()
    r = s.replace(seed=1)
    assert autotune.active_source() == str(path) and r._tune == str(path)
    assert Session("qwen3-4b", mesh="multi", device="cpu").replace(
        seed=2).mesh == "multi"
    autotune.deactivate()
    with pytest.raises(SessionError) as err:
        Session("qwen3-4b", tune=str(tmp_path / "missing.json"), device="cpu")
    assert "\n" not in str(err.value)
    with pytest.raises(SessionError, match="hopper/torch"):
        Session("qwen3-4b", tune=str(ROOT / "kernels" / "TUNE_cpu_ci.json"),
                device="cpu")


def test_from_pretrained_carries_tune(tmp_path):
    from repro_torch.session import Session

    path = tmp_path / "TUNE_fp.json"
    make_table(ssd__torch__small=64).save(str(path))
    s = Session.from_pretrained("qwen3-4b",
                                ROOT / "tests" / "golden" / "compat" / "qwen3-4b",
                                mesh="multi", device="cpu", tune=str(path))
    assert s._tune == str(path) and s.mesh == "multi"
    assert autotune.active_source() == str(path)


def test_cli_tune_flag(tmp_path, capsys):
    from repro_torch.session import main

    path = tmp_path / "TUNE_cli.json"
    make_table(ssd__torch__small=64).save(str(path))
    assert main(["ppa", "--device", "cpu", "--tune", str(path)]) == 0
    assert autotune.active_source() == str(path)
    autotune.deactivate()
    assert main(["ppa", "--device", "cpu", "--tune",
                 str(tmp_path / "missing.json")]) == 2
    err = capsys.readouterr().err.strip()
    assert err.startswith("error: cannot read tuning artifact")
    assert "\n" not in err
