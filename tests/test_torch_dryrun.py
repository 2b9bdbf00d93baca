"""The port's dry-run (``repro_torch.launch.{specs,dryrun,hlo_analysis}``,
``repro_torch.distributed.sharding``, ``transformer.param_specs``) against
the JAX package:

- every parameter's logical axes equal the JAX initializers' (``unzip``),
  leaf by leaf, for all ten architectures;
- ``SHAPES``, ``shape_applicable`` and ``model_flops`` equal the JAX
  package's for 10 archs x 4 shapes;
- the per-chip ``argument_bytes`` of every full-size cell on both
  production meshes equals the sum the JAX package's own ``spec_for``
  gives over its abstract params, optimizer state, serving state and
  batch (pure arithmetic: a stub mesh, no devices);
- the counted FLOPs of reduced steps equal ``loop_aware_cost`` of the same
  JAX step compiled on one CPU device;
- ``Session.dryrun`` and the CLIs on one reduced cell.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.core.numerics import NumericsConfig as JaxNC
from repro.distributed import sharding as jsh
from repro.launch import hlo_analysis as jh
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.numerics import NumericsConfig
from repro_torch.launch import dryrun, hlo_analysis, specs, steps
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.session import Session, SessionError

ARCHS = list_archs()


class StubMesh:
    """What the JAX package's spec_for reads of a mesh: its shape."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}."))
        return out
    return {pre[:-1]: tree}


def test_arch_lists_match():
    assert ARCHS == jax_list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_jax_initializers(arch):
    cfg = jax_get_arch(arch).reduced()
    pp = jax.eval_shape(functools.partial(jtr.init, cfg), jax.random.PRNGKey(0))
    want = {k: tuple(v) for k, v in _flat(unzip(pp)[1]).items()}
    assert transformer.param_specs(get_arch(arch).reduced()) == want


def test_shapes_match():
    assert specs.SHAPES == jspecs.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_applicability_and_model_flops_match(arch):
    for shape in specs.SHAPES:
        mine = specs.cell_config(get_arch(arch), shape)
        ref = jspecs.cell_config(jax_get_arch(arch), shape)
        assert specs.shape_applicable(mine, shape) == \
            jspecs.shape_applicable(ref, shape)
        assert specs.model_flops(mine, shape) == jspecs.model_flops(ref, shape)
        assert mine.active_param_count() == ref.active_param_count()


# -- argument_bytes at full size ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The full-size abstract params and their specs (one eval_shape an
    arch)."""
    return jspecs.abstract_params(jax_get_arch(arch))


def _jax_local_bytes(tree, axes_tree, mesh, rules):
    total = 0
    leaves = jax.tree.leaves(tree)
    axes = jax.tree.leaves(axes_tree, is_leaf=jsh.is_axes_leaf)
    assert len(leaves) == len(axes)
    for leaf, ax in zip(leaves, axes):
        spec = jsh.spec_for(ax, leaf.shape, mesh, rules)
        n = 1
        for d, a in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            n *= d // jsh._axis_size(mesh, a)
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


def _jax_argument_bytes(arch, shape, multi_pod):
    """The JAX dry-run's arguments of a cell, summed per chip with the JAX
    package's own spec_for over a stub mesh."""
    mesh = StubMesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                    else {"data": 16, "model": 16})
    cfg = jspecs.cell_config(jax_get_arch(arch), shape)
    sh = jspecs.SHAPES[shape]
    params32, pspecs = _jax_params(arch)
    if sh["kind"] == "train":
        rules = jsh.rules_for(cfg, "train")
        pdt = jnp.dtype(cfg.param_dtype)
        params = jax.tree.map(lambda s: jspecs.SDS(s.shape, pdt), params32)
        opt_cfg, opt_init, _, opt_specs_fn = jsteps.make_optimizer(cfg)
        opt = jax.eval_shape(functools.partial(opt_init, cfg=opt_cfg), params)
        batch = jspecs.batch_specs(cfg, shape)
        return (_jax_local_bytes(params, pspecs, mesh, rules)
                + _jax_local_bytes(opt, opt_specs_fn(pspecs), mesh, rules)
                + _jax_local_bytes(batch, jspecs.batch_axes_tree(batch), mesh,
                                   rules))
    rules = jsh.rules_for(cfg, "serve")
    params = jax.tree.map(lambda s: jspecs.SDS(s.shape, jnp.bfloat16),
                          params32)
    total = _jax_local_bytes(params, pspecs, mesh, rules)
    if sh["kind"] == "prefill":
        batch = jspecs.batch_specs(cfg, shape)
        return total + _jax_local_bytes(batch, jspecs.batch_axes_tree(batch),
                                        mesh, rules)
    B, S = sh["batch"], sh["seq"]
    max_len = min(S, 4096) if cfg.frontend == "audio_stub" else S
    state = jspecs.abstract_state(cfg, B, max_len)
    total += _jax_local_bytes(state, jspecs.state_axes_tree(state), mesh, rules)
    # the token: the batch over (pod, data) when it divides by data
    data = mesh.shape["data"] * mesh.shape.get("pod", 1)
    tok = B * 4 // (data if B % mesh.shape["data"] == 0 else 1)
    return total + tok + 4   # and the 0-d int32 position


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_at_full_size_equal_the_jax_count(arch):
    cfg = get_arch(arch)
    for shape in specs.SHAPES:
        for multi_pod in (False, True):
            mesh = make_production_mesh(multi_pod=multi_pod)
            got = dryrun.cell_memory(specs.cell_config(cfg, shape), shape,
                                     mesh)["argument_bytes"]
            assert got == _jax_argument_bytes(arch, shape, multi_pod), \
                (arch, shape, mesh.tag)


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v3-671b"])
def test_tree_shardings_equal_the_jax_specs(arch):
    """Full-size params on the multi-pod mesh under the train rules: the
    port's partition specs are the JAX package's spec_for, leaf by leaf;
    logical_constraint is the identity in a mesh context too."""
    from repro_torch.distributed import sharding

    mesh = make_production_mesh(multi_pod=True)
    cfg = get_arch(arch)
    params, pspecs = specs.abstract_params(cfg)
    rules = sharding.rules_for(cfg, "train")
    mine = _flat(sharding.tree_shardings(pspecs, params, mesh, rules))
    jparams, jpspecs = _jax_params(arch)
    jrules = jsh.rules_for(jax_get_arch(arch), "train")
    leaves = _flat(jparams)
    want = {k: tuple(jsh.spec_for(ax, leaves[k].shape, StubMesh(mesh.shape),
                                  jrules))
            for k, ax in _flat(jpspecs).items()}
    assert {k: tuple(v) for k, v in mine.items()} == want
    assert any(any(a is not None for a in v) for v in want.values())
    x = torch.empty((4, 8), device="meta")
    with sharding.use_mesh_rules(mesh, rules):
        assert sharding.current_mesh_rules() == (mesh, rules)
        assert sharding.logical_constraint(x, ("batch", None)) is x
    assert sharding.current_mesh_rules() is None


@pytest.mark.parametrize("arch", ARCHS)
def test_status_follows_shape_applicable(arch):
    sess = Session(arch, reduced=False, device="cpu")
    for shape in specs.SHAPES:
        ok, reason = jspecs.shape_applicable(
            jspecs.cell_config(jax_get_arch(arch), shape), shape)
        if ok:
            continue   # counted cells: see the reduced cells below
        for multi_pod in (False, True):
            rec = sess.dryrun(shape, multi_pod=multi_pod)
            assert rec["status"] == reason == "skipped(full-attention)"
    assert sess._params is None   # no weight was drawn
    # an applicable cell counts: the reduced config's decode step
    assert Session(arch, device="cpu").dryrun("decode_32k")["status"] == "ok"


# -- counted FLOPs against loop_aware_cost -----------------------------------

def _seg3(cfg, nc):
    return dataclasses.replace(cfg, numerics=nc(mode="segmented", seg_passes=3,
                                               backend="xla" if nc is JaxNC
                                               else "torch"))


@pytest.mark.parametrize("arch,kind,seg", [
    ("qwen3-4b", "prefill", False), ("qwen3-4b", "decode", False),
    ("qwen3-4b", "prefill", True), ("qwen3-4b", "decode", True),
    ("mamba2-130m", "prefill", False), ("deepseek-v3-671b", "prefill", False),
])
def test_counted_flops_equal_loop_aware_cost(arch, kind, seg):
    """One reduced step on meta tensors counts the FLOPs that XLA's module
    of the same JAX step holds (every dot: 2 x out x contracted)."""
    B, S = 2, 64
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if seg:
        jcfg, tcfg = _seg3(jcfg, JaxNC), _seg3(tcfg, NumericsConfig)
    jparams, _ = jspecs.abstract_params(jcfg, dtype=jnp.bfloat16)
    tparams, _ = specs.abstract_params(tcfg, torch.bfloat16)
    shape = dict(kind=kind, seq=S, batch=B)
    if kind == "prefill":
        jb = {"tokens": jspecs.SDS((B, S), jnp.int32)}
        lowered = jax.jit(jsteps.make_prefill_step(jcfg, max_len=S)).lower(
            jparams, jb)
        cost = hlo_analysis.step_cost(steps.make_prefill_step(tcfg, max_len=S),
                                      tparams, specs.batch_specs(tcfg, shape))
    else:
        jst = jspecs.abstract_state(jcfg, B, S)
        lowered = jax.jit(jsteps.make_decode_step(jcfg)).lower(
            jparams, jst, jspecs.SDS((B, 1), jnp.int32),
            jspecs.SDS((), jnp.int32))
        cost = hlo_analysis.step_cost(
            steps.make_decode_step(tcfg), tparams,
            specs.abstract_state(tcfg, B, S),
            torch.empty((B, 1), dtype=torch.int32, device="meta"), S - 1)
    want = jh.loop_aware_cost(lowered.compile().as_text())["flops"]
    assert cost["flops"] == want
    assert cost["bytes_stream"] > cost["bytes_fused"] > 0


def test_step_cost_counts_products_and_live_bytes():
    a = torch.empty((8, 16), device="meta")
    b = torch.empty((16, 32), device="meta")

    def step(a, b):
        c = a @ b            # 2 * 8 * 32 * 16 flops, 1 KiB
        d = torch.einsum("ik,kj->ij", a, b)
        return (c + d).sum()

    cost = hlo_analysis.step_cost(step, a, b)
    assert cost["flops"] == 2 * 2 * 8 * 32 * 16
    assert cost["peak_bytes"] >= 2 * 8 * 32 * 4
    assert cost["bytes_fused"] == (8 * 16 + 16 * 32 + 1) * 4
    x = torch.zeros(3)
    with pytest.raises(Exception):
        hlo_analysis.step_cost(lambda t: int(t.sum()), x.to("meta"))


@pytest.mark.parametrize("device_type,kind,factor", [
    ("cuda", "all-to-all", 1), ("cpu", "all-gather", 2)])
def test_step_cost_counts_a_shard_to_shard_move(device_type, kind, factor):
    """A placed step over a fake group: DTensor moves a (Replicate,
    Shard(1)) tensor to (Replicate, Shard(2)) by an all-to-all over CUDA
    ranks (``_dtensor.shard_dim_alltoall``) and by a gather and a chunk
    over CPU ranks; the count sees either, in this rank's bytes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import P, place_tensor
    from repro_torch.launch.mesh import fake_mesh

    x = torch.empty(4, 16, 16, device="meta")
    with fake_mesh((2, 2), ("data", "model"), device_type=device_type) as m:
        placed = place_tensor(x, P(None, "model"), m)
        cost = hlo_analysis.step_cost(lambda t: t.redistribute(
            m.device_mesh, [Replicate(), Shard(2)]), placed)
    local = 4 * 16 * 8 * 4
    assert dict(cost["collectives"].by_kind) == {kind: factor * local}


def test_roofline_terms_keep_the_reference_keys():
    cost = {"flops": 2e12, "bytes_stream": 5e10, "bytes_fused": 1e10}
    mine = hlo_analysis.roofline_terms(cost, 256, model_flops=4e14,
                                       compute_scale=0.5)
    ref = jh.roofline_terms(dict(cost), jh.CollectiveStats(0.0, {}), 256,
                            model_flops=4e14, compute_scale=0.5)
    assert set(ref) <= set(mine)
    assert mine["card"] == "H100 SXM"
    assert mine["t_compute_s"] == 2e12 * 0.5 / 989e12
    assert mine["t_memory_s"] == 1e10 / 3.35e12
    assert mine["dominant"] == "memory" and mine["t_collective_s"] is None
    assert hlo_analysis.card_peaks("NVIDIA H100 80GB HBM3") == \
        (3.35e12, 989e12, 67e12)
    with pytest.raises(RuntimeError):
        hlo_analysis.card_peaks("a card with no data sheet")


# -- Session.dryrun and the CLIs ---------------------------------------------

def test_session_dryrun_on_a_reduced_cell():
    sess = Session("qwen3-4b", device="cpu")
    rec = sess.dryrun("decode_32k")
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert set(rec) >= {"memory", "roofline", "param_count",
                        "active_param_count", "count_s"}
    mem = rec["memory"]
    assert mem["argument_bytes"] == dryrun.cell_memory(
        specs.cell_config(sess.config, "decode_32k"), "decode_32k",
        make_production_mesh())["argument_bytes"]
    # the placed step's count: one chip's peak and its collectives
    assert rec["sharded"] and mem["temp_bytes"] > 0
    assert mem["peak_estimate_bytes"] == (
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
        - mem["alias_bytes"])
    roof = rec["roofline"]
    assert roof["collective_bytes_per_chip"] == sum(
        roof["collective_by_kind"].values()) > 0
    assert roof["t_collective_s"] == (roof["collective_bytes_per_chip"]
                                      / roof["link_bytes_per_s"])
    assert rec["roofline"]["n_chips"] == 256
    assert sess.replace(mesh="multi").dryrun("decode_32k")["mesh"] == "2x16x16"
    # one chip: the counter's peak prices the step
    one = dryrun.lower_session_cell(sess, dict(kind="train", seq=16, batch=2),
                                    mesh=Mesh((1, 1), ("data", "model")))
    m = one["memory"]
    assert m["temp_bytes"] > 0 and m["peak_estimate_bytes"] == (
        m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
        - m["alias_bytes"])
    assert sess._params is None


def test_session_dryrun_errors():
    with pytest.raises(SessionError, match="unknown dryrun shape"):
        Session("qwen3-4b", device="cpu").dryrun("train_1m")
    from repro_torch.models import resnet

    cfg = resnet.ResNetConfig(widths=(4, 8), blocks=(1, 1))
    params, state = resnet.init(cfg, 0, "cpu")
    with pytest.raises(SessionError, match="ResNet"):
        Session.from_resnet(cfg, params, state, device="cpu").dryrun(
            "train_4k")


def test_session_cli_dryrun(capsys):
    from repro_torch.session import main

    assert main(["dryrun", "--arch", "mamba2-130m", "--shape", "long_500k",
                 "--reduced", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["status"] == "ok" and rec["arch"] == "mamba2-130m"
    assert main(["dryrun", "--arch", "qwen3-4b", "--shape", "long_500k",
                 "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["status"].startswith("skipped")
    assert main(["dryrun", "--arch", "qwen3-4b", "--shape", "nope",
                 "--device", "cpu"]) == 2


def test_dryrun_cli_writes_records(tmp_path, capsys):
    rc = dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                      "--both-meshes", "--device", "cpu", "--out-dir",
                      str(tmp_path)])
    assert rc == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["qwen3-4b__long_500k__16x16.json",
                     "qwen3-4b__long_500k__2x16x16.json"]
    out = capsys.readouterr().out
    assert out.count("skipped(full-attention)") == 2
    assert dryrun.ARTIFACT_DIR.parts[-3:] == ("build", "repro_torch", "dryrun")
