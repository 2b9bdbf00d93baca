"""The port's MoE layer (``repro_torch.models.moe``) and llama4-maverick-
400b-a17b against the JAX package's, on shared weights.

The layer alone: a JAX ``moe_init`` tree on the deepseek-v3 family config
with small widths (as ``tests/conftest.py::small_moe`` builds it), carried
across as numpy, on seeded numpy inputs.  The model: the reduced llama4
config (2 x (moe, dense), 4 experts, top-1 plus one shared expert,
capacity factor 4.0), its weights from a JAX ``Session`` carried across
with ``repro_torch.compat.params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro.session import Session as JaxSession
from repro_torch import tree as tree_util
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core import sensitivity, sweep
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.policy import NumericsPolicy, PolicyRule
from repro_torch.kernels import dispatch
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models import transformer as ttr
from repro_torch.numerics import current_path
from repro_torch.serving import TierSpec
from repro_torch.session import Session

ARCH = "llama4-maverick-400b-a17b"
PRESETS = ["exact", "segmented3", "segmented2", "segmented1"]
EXACT_F32 = dict(mode="exact", compute_dtype="float32")
# moe_apply alone with fp32 activations: the routed outputs within 1e-5
# of the largest (fp32 sums in each package's own order)
MOE_BOUND = 1e-5
# logits in units of the largest |logit|: one bf16 ulp, as
# tests/test_torch_dense_zoo.py holds the dense decoders
LOGIT_BOUND = 2.0 ** -8
LOSS_RTOL = 1e-5
GRAD_BOUND = 2.0 ** -6
TIERS = (TierSpec("premium", "exact", priority=0),
         TierSpec("bulk", "segmented1", priority=1),
         TierSpec("standard", "segmented3", priority=2))
POLICY = {t.name: t.policy for t in TIERS}
NUMERICS = {"exact": (JaxNumerics(**EXACT_F32), NumericsConfig(**EXACT_F32)),
            "segmented3": (JaxNumerics(mode="segmented", seg_passes=3,
                                       backend="xla"),
                           NumericsConfig(mode="segmented", seg_passes=3))}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _layer(E, K, D=16, FF=32, cf=8.0, n_shared=0, seed=0):
    """(jax cfg, port cfg, numpy params) of one MoE layer."""
    def shrink(cfg):
        moe_cfg = dataclasses.replace(cfg.moe, n_experts=E, top_k=K,
                                      capacity_factor=cf, n_shared=n_shared)
        return dataclasses.replace(cfg, d_model=D, d_ff=FF, moe=moe_cfg)

    cj = shrink(jax_get_arch("deepseek-v3-671b").reduced())
    ct = shrink(get_arch("deepseek-v3-671b").reduced())
    params = jax.tree.map(np.asarray, unzip(jmoe.moe_init(
        jax.random.PRNGKey(seed), cj))[0])
    return cj, ct, params


def _torch(tree):
    return tree_util.map(lambda a: torch.as_tensor(np.array(a, np.float32)),
                         tree)


def _plan(eidx, E, C):
    """The reference's routing plan in numpy (``moe.py::route_group``):
    each row's assignments sorted stably by expert, the first C of an
    expert kept; the slot of each assignment, -1 where dropped."""
    B, S, K = eidx.shape
    inv = np.empty((B, S * K), np.int64)
    for b in range(B):
        ea = eidx[b].reshape(-1)
        order = np.argsort(ea, kind="stable")
        es = ea[order]
        counts = np.bincount(es, minlength=E)
        starts = np.cumsum(counts) - counts
        pos = np.arange(S * K) - starts[es]
        inv[b, order] = np.where(pos < C, es * C + np.where(pos < C, pos, 0),
                                 -1)
    return inv.reshape(B, S, K)


def _jax_route(params, x, K):
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x),
                        jnp.asarray(params["router"]))
    gate, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    return np.asarray(gate), np.asarray(eidx)


CASES = {  # name: (E, K, n_shared, capacity factor, tokens a row)
    "top1": (4, 1, 0, 8.0, 12),
    "top2": (4, 2, 0, 8.0, 12),
    "top1_shared": (4, 1, 1, 8.0, 12),
    "top2_shared": (4, 2, 1, 8.0, 12),
    "top2_drops": (4, 2, 0, 0.25, 32),
    "top1_shared_drops": (4, 1, 1, 0.25, 32),
}


@pytest.mark.parametrize("numerics", ["exact", "segmented3"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, numerics, rng):
    """moe_apply on 2 rows (each its own routing group): the same expert
    choices as ``jax.lax.top_k``, the same dropped assignments as the
    reference's sort-based plan (the low capacity factors drop some),
    and outputs within 1e-5 of the largest, through the fused all-expert
    einsum (exact) and the per-expert ``nmatmul`` path (segmented3)."""
    E, K, n_shared, cf, S = CASES[case]
    cj, ct, params = _layer(E, K, cf=cf, n_shared=n_shared)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    jn, tn = NUMERICS[numerics]
    want = jmoe.moe_apply(params, jnp.asarray(x), cj, jn)
    got = moe.moe_apply(_torch(params), torch.as_tensor(x), ct, tn)
    assert _rel(got, want) <= MOE_BOUND

    gate_j, eidx_j = _jax_route(params, x, K)
    logits = torch.einsum("bsd,de->bse", torch.as_tensor(x),
                          torch.as_tensor(np.array(params["router"])))
    gate, eidx = moe.route(torch.softmax(logits, -1), K)
    np.testing.assert_array_equal(eidx.numpy(), eidx_j)
    np.testing.assert_allclose(gate.numpy(),
                               gate_j / gate_j.sum(-1, keepdims=True),
                               rtol=1e-6)
    C = moe.capacity(ct, S)
    _, inv = moe.dispatch_plan(eidx, E, C)
    want_inv = _plan(eidx_j, E, C)
    np.testing.assert_array_equal(inv.numpy(), want_inv)
    assert ((want_inv < 0).sum() > 0) == (cf < 1.0), case


def test_routing_ties_pick_the_lower_expert_as_jax(rng):
    """Equal probabilities (a zero router: all equal; a router with two
    equal columns: pairs equal) route as ``jax.lax.top_k`` does, to the
    lower expert index, and the layers' outputs agree."""
    cj, ct, params = _layer(8, 2)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    zero = dict(params, router=np.zeros_like(params["router"]))
    pairs = dict(params, router=params["router"].copy())
    pairs["router"][:, 5] = pairs["router"][:, 2]
    pairs["router"][:, 7] = pairs["router"][:, 0]
    for p in (zero, pairs):
        _, eidx_j = _jax_route(p, x, 2)
        logits = torch.einsum("bsd,de->bse", torch.as_tensor(x),
                              torch.as_tensor(np.array(p["router"])))
        _, eidx = moe.route(torch.softmax(logits, -1), 2)
        np.testing.assert_array_equal(eidx.numpy(), eidx_j)
        want = jmoe.moe_apply(p, jnp.asarray(x), cj, JaxNumerics(**EXACT_F32))
        got = moe.moe_apply(_torch(p), torch.as_tensor(x), ct,
                            NumericsConfig(**EXACT_F32))
        assert _rel(got, want) <= MOE_BOUND
        if p is zero:
            assert (eidx_j == [0, 1]).all()
        else:   # some token's top two are a tied pair
            assert ((eidx_j == [0, 7]).all(-1) | (eidx_j == [2, 5]).all(-1)).any()


def test_gates_renormalized_and_router_shift_invariant(rng):
    """The top-k gates sum to 1; a constant added to the router's weights
    shifts every logit alike and leaves the output as it was."""
    _, ct, params = _layer(4, 2)
    x = torch.as_tensor(rng.standard_normal((2, 12, 16)).astype(np.float32))
    probs = torch.softmax(torch.as_tensor(rng.standard_normal((5, 7, 4))), -1)
    gate, _ = moe.route(probs, 2)
    np.testing.assert_allclose(gate.sum(-1).numpy(), 1.0, rtol=1e-6)
    n = NumericsConfig(**EXACT_F32)
    p = _torch(params)
    a = moe.moe_apply(p, x, ct, n)
    b = moe.moe_apply(dict(p, router=p["router"] + 3.0), x, ct, n)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_aux_load_balance_loss_matches_jax(rng):
    for T, E in [(64, 4), (512, 8)]:
        logits = rng.standard_normal((T, E)).astype(np.float32) * 3
        eidx = rng.integers(0, E, (T, 2))
        want = jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                          jnp.asarray(eidx), E)
        got = moe.aux_load_balance_loss(torch.as_tensor(logits),
                                        torch.as_tensor(eidx), E)
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_routed_expert_configs_resolution():
    seg1 = NumericsConfig(mode="segmented", seg_passes=1)
    ex = NumericsConfig(**EXACT_F32)
    pol = NumericsPolicy((PolicyRule("expert0.*", seg1),), default=ex)
    cfgs = moe.routed_expert_configs(pol, 2)
    assert cfgs["wi"] == (seg1, ex) and cfgs["wo"] == (seg1, ex)
    assert moe.routed_expert_configs(seg1, 3)["wg"] == (seg1,) * 3


def test_policy_puts_two_experts_on_different_multipliers(monkeypatch, rng):
    """Reduced llama4 under a policy with block 0's expert 0 on
    segmented1 and expert 1 on segmented3 (everything else exact): a spy
    on the segmented matmul's dispatch sees exactly those six projections,
    each resolved under ``blocks.0.mlp.expert{k}.w*`` with its own passes,
    and the plain config's LM head (the one-pass product, outside any
    layer scope); and the logits differ from the all-exact run's."""
    seen = []
    real = dispatch.matmul

    def spy(x, w, passes, backend="auto", **kw):
        seen.append((current_path(), passes))
        return real(x, w, passes, backend=backend, **kw)

    monkeypatch.setattr(dispatch, "matmul", spy)
    seg = {k: NumericsConfig(mode="segmented", seg_passes=p)
           for k, p in ((0, 1), (1, 3))}
    pol = NumericsPolicy((PolicyRule("blocks.0.mlp.expert0.*", seg[0]),
                          PolicyRule("blocks.0.mlp.expert1.*", seg[1])),
                         default=NumericsConfig(**EXACT_F32))
    sess = Session(ARCH, pol, device="cpu")
    tokens = torch.as_tensor(rng.integers(0, 256, (2, 16)))
    with torch.inference_mode():
        mixed, _ = ttr.prefill(sess.params, sess.config, {"tokens": tokens})
        exact, _ = ttr.prefill(sess.params, sess.replace(
            policy=NumericsConfig(**EXACT_F32)).config, {"tokens": tokens})
    assert sorted(seen) == sorted(
        [(f"blocks.0.mlp.expert{k}.{n}", seg[k].seg_passes)
         for k in (0, 1) for n in ("wi", "wg", "wo")] + [("", 1)])
    assert not torch.equal(mixed, exact)


def test_all_exact_policy_takes_the_fused_path_bit_for_bit(monkeypatch, rng):
    """A policy that maps every expert (and the shared expert) to exact
    keeps the fused all-expert einsum: bit for bit the plain exact
    config's output, with no per-expert ``nmatmul``."""
    _, ct, params = _layer(2, 1, n_shared=1)
    x = torch.as_tensor(rng.standard_normal((2, 8, 16)).astype(np.float32))
    ex = NumericsConfig(**EXACT_F32)
    pol = NumericsPolicy((PolicyRule("expert*", ex), PolicyRule("shared.*", ex)),
                         default=ex)
    calls = []
    monkeypatch.setattr(moe, "_experts_matmul",
                        lambda *a: calls.append(a) or None)
    got = moe.moe_apply(_torch(params), x, ct, pol)
    want = moe.moe_apply(_torch(params), x, ct, ex)
    assert not calls
    assert torch.equal(got, want)


def test_calibration_records_per_expert_sites(rng):
    """The calibration tap (the sensitivity model's one instrumented pass)
    records every routed expert's three sites, as in the reference's
    tests/test_sensitivity.py: with a tap installed the layer takes the
    per-expert path even though every expert resolves to exact."""
    _, ct, params = _layer(2, 2)
    x = torch.as_tensor(rng.standard_normal((2, 8, 16)).astype(np.float32))
    p = _torch(params)

    def eval_fn(policy):
        moe.moe_apply(p, x, ct, policy)
        return 0.0

    model = sensitivity.calibrate(eval_fn,
                                  default=NumericsConfig(**EXACT_F32))
    for k in range(2):
        for name in ("wi", "wg", "wo"):
            assert f"expert{k}.{name}" in model.sites, sorted(model.sites)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_layer_paths_count_every_expert_and_the_roll_up_does(arch):
    """``layer_paths`` has n_moe_blocks x E x 3 routed-expert paths and
    the shared expert's, equal to the reference's; the PPA roll-up counts
    each path once (as the reference's tests/test_sensitivity.py holds)."""
    cfg = get_arch(arch).reduced()
    paths = ttr.layer_paths(cfg)
    assert paths == jtr.layer_paths(jax_get_arch(arch).reduced())
    n_moe = sum(r * sum(s.kind == "moe" for s in p) for r, p in cfg.segments)
    assert len([p for p in paths if ".mlp.expert" in p]) \
        == n_moe * cfg.moe.n_experts * 3
    assert len([p for p in paths if ".mlp.shared." in p]) == n_moe * 3
    ex = NumericsConfig(**EXACT_F32)
    assert sweep.policy_area(NumericsPolicy((), default=ex), paths) \
        == pytest.approx(sweep.config_ppa(ex).logic_area_um2 * len(paths))
    full = ttr.layer_paths(get_arch(arch))
    want = {ARCH: 24 * 128 * 3, "deepseek-v3-671b": 58 * 256 * 3}[arch]
    assert len([p for p in full if ".mlp.expert" in p]) == want


# ---------------------------------------------------------------------------
# llama4 (reduced) through the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, JaxSession(ARCH).params)


@pytest.fixture(scope="module")
def port_session(tree):
    return Session(ARCH, params=params_from_numpy(
        tree, get_arch(ARCH).reduced(), "cpu"), device="cpu")


@pytest.mark.parametrize("preset", PRESETS)
def test_prefill_decode_logits_match_jax(preset, tree, port_session, rng):
    """A 40-token prefill then 6 decode steps fed the JAX package's greedy
    tokens: every step's logits within one bf16 ulp of the largest."""
    js = JaxSession(ARCH, preset).replace(params=jax.tree.map(jnp.asarray,
                                                              tree))
    ts = port_session.replace(policy=preset)
    cj, ct = js.config, ts.config
    prompts = rng.integers(0, 256, (2, 40))
    prefill = jax.jit(lambda p, t: jtr.prefill(p, cj, {"tokens": t},
                                               max_len=48))
    decode = jax.jit(lambda p, t, s, pos: jtr.decode_step(
        p, cj, {"token": t}, s, pos))
    want, sj = prefill(js.params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        got, st = ttr.prefill(ts.params, ct, {"tokens": torch.as_tensor(
            prompts)}, max_len=48)
    for step in range(7):
        assert _rel(got, want) <= LOGIT_BOUND, (preset, step)
        if step == 6:
            break
        tok = np.asarray(want[:, -1]).argmax(-1)[:, None]
        want, sj = decode(js.params, jnp.asarray(tok, jnp.int32), sj,
                          jnp.int32(40 + step))
        with torch.inference_mode():
            got, st = ttr.decode_step(ts.params, ct,
                                      {"token": torch.as_tensor(tok)}, st,
                                      40 + step)


@pytest.mark.parametrize("mode", ["exact", "segmented3"])
def test_loss_and_grads_match_jax(mode, tree):
    """fp32 training at 2 x 24 tokens (fp32 products, or the 3-pass split
    product through the per-expert path): the loss within 1e-5 and every
    leaf's gradient within 2**-6 of ``jax.grad``'s largest, the router's
    and the expert stacks' among them."""
    jn, tn = NUMERICS[mode]
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), numerics=jn)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), numerics=tn)
    toks = np.random.default_rng(5).integers(0, 256, (2, 25))
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = steps.grads_of(ttr.loss_fn, params_from_numpy(tree, tcfg,
                                                                "cpu"), tcfg,
                                 {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    named = tree_util.named(jax.tree.map(np.asarray, jgrads))
    noise = 1e-6 * max(np.abs(w).max() for _, w in named)
    names = []
    for (name, want), g in zip(named, tree_util.leaves(grads)):
        assert g is not None and g.shape == want.shape, name
        if np.abs(want).max() <= noise:
            # top-1 renormalises its one gate to 1: the router's gradient
            # is zero but for rounding, on both sides
            assert float(g.abs().max()) <= noise, name
            continue
        assert _rel(g, want) <= GRAD_BOUND, name
        names.append(name)
    assert "seg0_p0.mlp.router" not in names
    assert {"seg0_p0.mlp.wi", "seg0_p0.mlp.wo",
            "seg0_p0.mlp.shared.wo"} <= set(names)


def test_engine_equals_solo_generate(port_session, rng):
    """Reduced llama4 through the port engine (chunked prefill in chunks
    of 32, mixed tiers, more requests than slots): every request's tokens
    equal the port's solo generate.  Capacity depends on a routing
    group's length, so chunked and whole prefills would route alike only
    without drops: the reduced capacity factor of 4.0 gives every expert
    a slot for each token of a group."""
    spec = [(rng.integers(0, 256, n), tier, k) for n, tier, k in
            [(40, "standard", 6), (70, "premium", 4), (12, "bulk", 6),
             (35, "standard", 5), (9, "standard", 3)]]
    eng = port_session.serving_engine(TIERS, slots=2, max_len=80)
    reqs = [eng.submit(p, tier=t, max_new_tokens=k) for p, t, k in spec]
    stats = eng.run()
    assert all(r.done for r in reqs)
    assert stats["standard"].n_prefill_chunks >= 4
    for r in reqs:
        solo = port_session.replace(policy=POLICY[r.tier]).generate(
            prompts=r.prompt[None], gen_len=r.max_new_tokens)
        np.testing.assert_array_equal(r.result(), solo.tokens[0],
                                      err_msg=r.id)


def test_params_from_numpy_checks_moe_leaves_by_name_and_shape(tree):
    """The MoE leaves carry across by name and shape: a missing router
    or a mis-shaped expert stack raises a one-line ``ValueError``."""
    cfg = get_arch(ARCH).reduced()
    params = params_from_numpy(tree, cfg, "cpu")
    E, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(params["seg0_p0"]["mlp"]["wi"].shape) == (2, E, d, ff)
    assert tuple(params["seg0_p0"]["mlp"]["shared"]["wo"].shape) == (2, ff, d)
    flat = dict(tree_util.named(tree))
    with pytest.raises(ValueError, match=r"missing \['seg0_p0.mlp.router'\]"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "seg0_p0.mlp.router"}, cfg, "cpu")
    bad = dict(flat, **{"seg0_p0.mlp.wo": flat["seg0_p0.mlp.wo"][:, :2]})
    with pytest.raises(ValueError, match="seg0_p0.mlp.wo: shape"):
        params_from_numpy(bad, cfg, "cpu")
