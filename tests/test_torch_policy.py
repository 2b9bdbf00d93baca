"""The port's per-layer numerics policies against the JAX package's.

- every resolution case of ``tests/golden/policy_golden.json`` resolves to
  the same config in both packages;
- a policy file written by either package loads in the other, with the
  backend names mapped (``xla``/``interpret`` <-> ``torch``, ``pallas``
  <-> ``hopper``, ``auto`` <-> ``auto``);
- ``Session(policy=<json>)`` and a mixed policy give qwen3-4b (reduced,
  the committed fixture's weights) logits and greedy tokens equal to
  JAX's, to the bounds of ``tests/test_torch_model.py``;
- policies reach the serving engine's tiers and ``launch.serve``;
- the operand tap sees every call site under its full path;
- ``ppa_report`` and ``layer_paths`` equal the JAX package's.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jax_policy
from repro.core.numerics import NumericsConfig as JaxConfig
from repro.models import transformer as jax_tr
from repro.session import Session as JaxSession
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core import policy
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.policy import NumericsPolicy, ScopedPolicy
from repro_torch.models import transformer as t_tr
from repro_torch.numerics import (layer_scope, nmatmul, numerics_scope,
                                  set_operand_tap)
from repro_torch.serving import TierSpec
from repro_torch.session import Session, SessionError

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIXTURE = os.path.join(GOLDEN, "compat", "qwen3-4b")
with open(os.path.join(GOLDEN, "policy_golden.json")) as _f:
    POLICY_GOLDEN = json.load(_f)
CASES = POLICY_GOLDEN["resolution_cases"]
TAGS = POLICY_GOLDEN["config_tags"]
JAX_TO_PORT = {"xla": "torch", "interpret": "torch", "pallas": "hopper",
               "auto": "auto"}

SEG3 = NumericsConfig(mode="segmented", seg_passes=3)
SEG1 = NumericsConfig(mode="segmented", seg_passes=1)
# attention projections 3-pass, MLPs 1-pass, the rest (lm_head) exact bf16
MIXED = NumericsPolicy((("blocks.*.attn.*", SEG3), ("blocks.*.mlp.*", SEG1)))


def _port_config(tag):
    d = dict(TAGS[tag])
    if "backend" in d:
        d["backend"] = JAX_TO_PORT[d["backend"]]
    return NumericsConfig(**d)


@pytest.fixture(scope="module")
def jax_session():
    return JaxSession.from_pretrained("qwen3-4b", FIXTURE)


@pytest.fixture(scope="module")
def port_params(jax_session):
    tree = jax.tree.map(np.asarray, jax_session.params)
    return params_from_numpy(tree, get_arch("qwen3-4b").reduced(), "cpu")


@pytest.mark.parametrize("case", CASES, ids=[c["label"] for c in CASES])
def test_golden_resolution_cases_match_jax(case):
    mine = NumericsPolicy(
        tuple((p, _port_config(t)) for p, t in case["rules"]),
        _port_config(case["default"]))
    ref = jax_policy.NumericsPolicy(
        tuple((p, JaxConfig(**TAGS[t])) for p, t in case["rules"]),
        JaxConfig(**TAGS[case["default"]]))
    for path in case["paths"]:
        want = case["expected"][path]
        assert mine.lookup(path) == _port_config(want), path
        got = dataclasses.asdict(mine.lookup(path))
        ref_d = dataclasses.asdict(ref.lookup(path))
        ref_d["backend"] = JAX_TO_PORT[ref_d["backend"]]
        assert got == ref_d, path


@pytest.mark.parametrize("jax_backend", ["xla", "interpret", "pallas",
                                         "auto"])
def test_jax_written_policy_loads_in_the_port(jax_backend, tmp_path):
    seg = JaxConfig(mode="segmented", seg_passes=2, backend=jax_backend)
    ref = jax_policy.NumericsPolicy(
        (("blocks.0.*", seg),
         ("lm_head", JaxConfig(mode="emulated", multiplier="ACL5"))),
        JaxConfig(mode="exact", compute_dtype="float32"))
    path = tmp_path / "policy.json"
    path.write_text(ref.to_json())
    mine = Session("qwen3-4b", str(path), device="cpu").numerics
    assert isinstance(mine, NumericsPolicy)
    assert mine.lookup("blocks.0.attn.wq") == NumericsConfig(
        mode="segmented", seg_passes=2, backend=JAX_TO_PORT[jax_backend])
    assert mine.lookup("lm_head") == NumericsConfig(mode="emulated",
                                                    multiplier="ACL5")
    assert mine.lookup("blocks.1.mlp.wo") == NumericsConfig(
        mode="exact", compute_dtype="float32")


@pytest.mark.parametrize("backend,jax_backend", [("torch", "xla"),
                                                 ("hopper", "pallas"),
                                                 ("auto", "auto")])
def test_port_written_policy_loads_in_jax(backend, jax_backend, tmp_path):
    seg = NumericsConfig(mode="segmented", seg_passes=1, backend=backend)
    sess = Session("qwen3-4b", NumericsPolicy((("*.mlp.*", seg),)),
                   device="cpu")
    path = tmp_path / "policy.json"
    sess.save_policy(str(path))
    ref = jax_policy.NumericsPolicy.from_json(path.read_text())
    assert ref.lookup("blocks.1.mlp.wi") == JaxConfig(
        mode="segmented", seg_passes=1, backend=jax_backend)
    assert ref.lookup("blocks.1.attn.wi").mode == "exact"
    # and back: the port reads its own file to the same policy
    assert Session("qwen3-4b", str(path), device="cpu").numerics == \
        sess.numerics


def test_policy_files_are_checked(tmp_path):
    bad = tmp_path / "bad.json"
    for text, match in [("{not json", "invalid policy JSON"),
                        ('{"default": {"mode": "exact", "bogus": 1}}',
                         "unknown NumericsConfig fields"),
                        ('{"default": {"backend": "tpu"}}',
                         "unknown backend")]:
        bad.write_text(text)
        with pytest.raises(SessionError, match=match):
            Session("qwen3-4b", str(bad), device="cpu")
    with pytest.raises(SessionError, match="ScopedPolicy"):
        Session("qwen3-4b", MIXED.scope("blocks.0"), device="cpu")


def test_scoped_views_and_helpers_match_jax():
    ref = jax_policy.NumericsPolicy(
        (("blocks.3.mlp.wi", JaxConfig(mode="segmented", seg_passes=1)),))
    mine = NumericsPolicy((("blocks.3.mlp.wi", SEG1),))
    view = policy.scoped(mine, "blocks.3", "mlp")
    ref_view = jax_policy.scoped(ref, "blocks.3", "mlp")
    assert isinstance(view, ScopedPolicy) and policy.is_policy(view)
    assert view.full_path("wi") == ref_view.full_path("wi") == \
        "blocks.3.mlp.wi"
    assert view.lookup("wi") == SEG1
    assert view.lookup("wo").mode == ref_view.lookup("wo").mode == "exact"
    assert policy.resolve(None) == policy.resolve(None, "x") == \
        NumericsConfig()
    assert policy.resolve(SEG1, "anything") is SEG1
    assert policy.scoped(SEG1, "a", "b") is SEG1
    assert policy.expert_paths(3, prefix="mlp") == \
        jax_policy.expert_paths(3, prefix="mlp")
    got = NumericsPolicy.from_assignments({"fc": SEG3}, default=SEG1)
    assert got.lookup("fc") == SEG3 and got.lookup("stem") == SEG1


def test_operand_tap_sees_full_paths(rng):
    x = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    seen = []
    prev = set_operand_tap(lambda p, a, b: seen.append((p, a is x, b is w)))
    try:
        with numerics_scope(MIXED), layer_scope("blocks.2"), \
                layer_scope("mlp"), layer_scope("wi"):
            got = nmatmul(x, w)
        # a scoped ambient resolves relative paths but reports full ones
        with numerics_scope(MIXED.scope("blocks.5")), layer_scope("attn.wq"):
            nmatmul(x, w)
    finally:
        assert set_operand_tap(prev) is not None
    assert seen == [("blocks.2.mlp.wi", True, True),
                    ("blocks.5.attn.wq", True, True)]
    with numerics_scope(SEG1):
        assert torch.equal(got, nmatmul(x, w))


@pytest.mark.parametrize("spec", ["json", "mixed"])
def test_policy_session_logits_and_tokens_match_jax(spec, jax_session,
                                                    port_params, rng,
                                                    tmp_path):
    """A JAX-written policy file (``json``: every projection 3-pass, the
    head exact) and a mixed policy object (``mixed``: 3-pass attention,
    1-pass MLPs) give the JAX package's logits within one bf16 ulp of the
    largest (2**-8, as segmented3 in tests/test_torch_model.py: 3-pass
    projections keep fp32 low bits that can flip a bf16 rounding inside
    attention) and its greedy tokens."""
    seg = lambda p: JaxConfig(mode="segmented", seg_passes=p, backend="xla")
    if spec == "json":
        ref_pol = jax_policy.NumericsPolicy((("blocks.*", seg(3)),))
        path = tmp_path / "policy.json"
        path.write_text(ref_pol.to_json())
        mine_pol = str(path)
    else:
        ref_pol = jax_policy.NumericsPolicy((("blocks.*.attn.*", seg(3)),
                                             ("blocks.*.mlp.*", seg(1))))
        mine_pol = MIXED
    js = jax_session.replace(policy=ref_pol)
    ts = Session("qwen3-4b", mine_pol, params=port_params, device="cpu")
    assert ts.is_policy and ts.layer_paths() == js.layer_paths()
    prompts = rng.integers(0, 256, (2, 11))
    want, _ = jax_tr.prefill(js.params, js.config,
                             {"tokens": jnp.asarray(prompts, jnp.int32)},
                             max_len=20)
    got, _ = t_tr.prefill(ts.params, ts.config,
                          {"tokens": torch.as_tensor(prompts)}, max_len=20)
    want = np.asarray(want)
    err = np.max(np.abs(got.numpy() - want))
    assert err <= 2.0 ** -8 * np.max(np.abs(want)), err
    np.testing.assert_array_equal(
        ts.generate(prompts=prompts, gen_len=6).tokens,
        js.generate(prompts=prompts, gen_len=6).tokens)


def test_engine_tiers_take_policies(port_params, rng, tmp_path):
    """A tier's policy (object or JSON path) serves the same tokens as a
    solo generate under it."""
    path = tmp_path / "mixed.json"
    path.write_text(MIXED.to_json())
    ts = Session("qwen3-4b", params=port_params, device="cpu")
    tiers = (TierSpec("mixed", MIXED, 0), TierSpec("file", str(path), 1))
    eng = ts.serving_engine(tiers, slots=2, max_len=16, page_size=4)
    prompts = [rng.integers(0, 256, n) for n in (7, 5)]
    reqs = [eng.submit(p, tier=t.name, max_new_tokens=4)
            for p, t in zip(prompts, tiers)]
    eng.run()
    for p, t, r in zip(prompts, tiers, reqs):
        solo = ts.replace(policy=t.policy).generate(prompts=p[None],
                                                    gen_len=4)
        np.testing.assert_array_equal(r.result(), solo.tokens[0])


def test_serve_takes_a_policy_file(tmp_path, capsys):
    from repro_torch.launch.serve import main

    path = tmp_path / "policy.json"
    path.write_text(MIXED.to_json())
    assert main(["--policy", str(path), "--batch", "1", "--gen-len", "2",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] policy over" in out and "numerics=policy" in out
    assert main(["--policy", str(tmp_path / "missing.json"),
                 "--device", "cpu"]) == 2
    assert "cannot read policy file" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-130m"])
def test_ppa_report_and_layer_paths_match_jax(arch):
    mine = Session(arch, MIXED, device="cpu")
    seg = lambda p: JaxConfig(mode="segmented", seg_passes=p, backend="xla")
    ref = JaxSession(arch, jax_policy.NumericsPolicy(
        (("blocks.*.attn.*", seg(3)), ("blocks.*.mlp.*", seg(1)))))
    assert mine.layer_paths() == ref.layer_paths()
    assert mine.layer_path_counts() == ref.layer_path_counts() == {}
    assert mine.ppa_report() == ref.ppa_report()
    assert Session(arch, "segmented2", device="cpu").ppa_report() == \
        JaxSession(arch, "segmented2").ppa_report()
