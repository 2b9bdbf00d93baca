"""The port's dense decoder against the JAX package's, on shared weights.

Weights come from the committed tiny qwen3-4b checkpoint, loaded by the
JAX package (``Session.from_pretrained``) and carried across with
``repro_torch.compat.params_from_numpy``; prompts are numpy ints from the
``rng`` fixture, handed to both.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jax_tr
from repro.session import Session as JaxSession
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.numerics import NumericsConfig
from repro_torch.models import transformer as t_tr
from repro_torch.numerics import nmatmul, numerics_scope
from repro_torch.session import Session, SessionError

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "compat",
                       "qwen3-4b")
PRESETS = ["exact", "segmented3", "segmented2", "segmented1"]

# logits bound, in units of the largest |logit|.  exact and segmented1 feed
# bf16-rounded operands to every projection, so both sides differ only by
# fp32 summation order: 1e-4.  segmented3/2 keep fp32 low bits, and an
# fp32-ulp difference in q/k/v (1-3 ulps per projection, checked in
# test_torch_afpm_matmul.py) can flip one bf16 rounding inside attention:
# one bf16 ulp, 2**-8 (ROADMAP.md section 3; measured 4.3e-4).
LOGIT_BOUND = {"exact": 1e-4, "segmented1": 1e-4,
               "segmented3": 2.0 ** -8, "segmented2": 2.0 ** -8}


@pytest.fixture(scope="module")
def jax_session():
    return JaxSession.from_pretrained("qwen3-4b", FIXTURE)


@pytest.fixture(scope="module")
def port_params(jax_session):
    tree = jax.tree.map(np.asarray, jax_session.params)
    return params_from_numpy(tree, get_arch("qwen3-4b").reduced(), "cpu")


def test_reduced_config_matches_jax_field_by_field():
    mine = get_arch("qwen3-4b").reduced()
    ref = jax_get_arch("qwen3-4b").reduced()
    for f in dataclasses.fields(mine):
        if f.name == "numerics":
            continue
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name == "segments":
            a = [(r, [dataclasses.asdict(s) for s in p]) for r, p in a]
            b = [(r, [dataclasses.asdict(s) for s in p]) for r, p in b]
        assert a == b, f.name
    assert {f.name for f in dataclasses.fields(mine)} == \
        {f.name for f in dataclasses.fields(ref)}
    assert mine.numerics.mode == ref.numerics.mode == "exact"
    assert mine.param_count() == ref.param_count()
    assert get_arch("qwen3-4b").param_count() == \
        jax_get_arch("qwen3-4b").param_count()


@pytest.mark.parametrize("preset", PRESETS)
def test_prefill_logits_and_tokens_match_jax(preset, jax_session,
                                             port_params, rng):
    prompts = rng.integers(0, 256, (2, 11))
    js = jax_session.replace(policy=preset)
    ts = Session("qwen3-4b", preset, params=port_params, device="cpu")
    want, _ = jax_tr.prefill(js.params, js.config,
                             {"tokens": jnp.asarray(prompts, jnp.int32)},
                             max_len=20)
    got, _ = t_tr.prefill(ts.params, ts.config,
                          {"tokens": torch.as_tensor(prompts)}, max_len=20)
    want = np.asarray(want)
    err = np.max(np.abs(got.numpy() - want))
    assert err <= LOGIT_BOUND[preset] * np.max(np.abs(want)), (preset, err)
    np.testing.assert_array_equal(
        ts.generate(prompts=prompts, gen_len=6).tokens,
        js.generate(prompts=prompts, gen_len=6).tokens)


def test_segmented1_logits_equal_exact_bit_for_bit(port_params, rng):
    """hi(x)·hi(w) with fp32 accumulation is the exact tier's bf16 dot."""
    prompts = torch.as_tensor(rng.integers(0, 256, (2, 9)))
    out = {}
    for preset in ("exact", "segmented1"):
        s = Session("qwen3-4b", preset, params=port_params, device="cpu")
        out[preset], _ = t_tr.prefill(s.params, s.config, {"tokens": prompts})
    assert torch.equal(out["exact"], out["segmented1"])


def test_generate_eos_pins_tail(port_params, rng):
    s = Session("qwen3-4b", params=port_params, device="cpu")
    prompts = rng.integers(0, 256, (2, 5))
    base = s.generate(prompts=prompts, gen_len=6)
    eos = int(base.tokens[0, 1])
    res = s.generate(prompts=prompts, gen_len=6, eos_id=eos)
    n = int(res.gen_lengths[0])
    np.testing.assert_array_equal(res.tokens[0, :n], base.tokens[0, :n])
    assert (res.tokens[0, n:] == eos).all()


def test_nmatmul_ambient_resolution(rng):
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    bf = lambda t: t.to(torch.bfloat16).float()
    assert torch.equal(nmatmul(x, w), bf(x) @ bf(w))     # EXACT by default

    class Policy:  # the duck-typed policy branch: lookup(path) -> config
        def lookup(self, path):
            return NumericsConfig(mode="exact", compute_dtype="float32")

    with numerics_scope(Policy()):
        assert torch.equal(nmatmul(x, w), x @ w)
    # emulated mode runs the bit-level multiplier (AC5-5 by default) on
    # every product; tests/test_torch_afpm_bitwise.py holds it against JAX
    from repro_torch.core.afpm import AFPMConfig, afpm_matmul_emulated

    with numerics_scope(NumericsConfig(mode="emulated")):
        assert torch.equal(nmatmul(x, w),
                           afpm_matmul_emulated(x, w, AFPMConfig(n=5)))


def test_session_rejects_policies_of_later_slices(tmp_path):
    # policy files load since the ResNet slice: a missing one is a
    # one-line SessionError (tests/test_torch_policy.py loads real ones)
    with pytest.raises(SessionError, match="cannot read policy file"):
        Session("qwen3-4b", str(tmp_path / "policy.json"), device="cpu")
    with pytest.raises(SessionError, match="unknown Session.replace"):
        Session("qwen3-4b", device="cpu").replace(shards=2)
    # the dry-run's mesh is a Session field
    assert Session("qwen3-4b", device="cpu").replace(
        mesh="multi").mesh == "multi"
    seg = Session("qwen3-4b", "segmented3", device="cpu")
    assert seg.numerics.backend == "auto" and seg.numerics.seg_passes == 3
    assert seg.replace(backend="torch").numerics.backend == "torch"
