"""The port's MLA attention (``repro_torch.models.attention.mla_apply``)
and deepseek-v3-671b against the JAX package's, on shared weights.

MLA alone: a JAX ``mla_init`` tree at the reduced deepseek config (d 64,
4 heads, q rank 48, kv rank 32, rope 8, nope 16, v 16), carried across as
numpy, in each of its three forms.  The model: the reduced config (2
dense MLA blocks, then 2 MoE MLA blocks of 4 experts, top-2, one shared
expert, capacity factor 4.0), its weights from a JAX ``Session`` carried
across with ``repro_torch.compat.params_from_numpy``; the engine pages
the latent ``ckv`` / ``kpe`` caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro.numerics import numerics_scope as jax_numerics_scope
from repro.session import Session as JaxSession
from repro_torch import tree as tree_util
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.numerics import NumericsConfig
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models.layers import fp64_sums
from repro_torch.models import transformer as ttr
from repro_torch.numerics import numerics_scope
from repro_torch.serving import TierSpec, kvcache
from repro_torch.session import Session

ARCH = "deepseek-v3-671b"
PRESETS = ["exact", "segmented3", "segmented2", "segmented1"]
EXACT_F32 = dict(mode="exact", compute_dtype="float32")
# mla_apply alone, fp32 projections: the attention's operands are rounded
# to bf16 on both sides, and a projection's one-ulp difference can move
# such a rounding (measured up to 3.2e-4 of the largest output)
MLA_BOUND = 2.0 ** -10
# logits in units of the largest |logit|: one bf16 ulp, as
# tests/test_torch_dense_zoo.py holds the dense decoders
LOGIT_BOUND = 2.0 ** -8
# the port's prefill-then-decode against its own full forward (fp32
# products): a decode step takes the absorbed form, which rounds other
# operands to bf16 than the expanded form does (the reference's two
# forms differ alike)
FORWARD_BOUND = 2.0 ** -6
LOSS_RTOL = 1e-5
GRAD_BOUND = 2.0 ** -6
TIERS = (TierSpec("premium", "exact", priority=0),
         TierSpec("bulk", "segmented1", priority=1),
         TierSpec("standard", "segmented3", priority=2))
POLICY = {t.name: t.policy for t in TIERS}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, JaxSession(ARCH).params)


@pytest.fixture(scope="module")
def port_session(tree):
    return Session(ARCH, params=params_from_numpy(
        tree, get_arch(ARCH).reduced(), "cpu"), device="cpu")


def _mla(seed):
    cj, ct = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    p = jax.tree.map(np.asarray, unzip(jattn.mla_init(
        jax.random.PRNGKey(seed), cj))[0])
    return cj, ct, p, tree_util.map(lambda a: torch.as_tensor(np.array(a)), p)


@pytest.mark.parametrize("seed", [0, 1])
def test_mla_apply_three_forms_match_jax(seed, rng):
    """MLA's three forms against the reference's on the same weights and
    inputs (fp32 projections): a no-cache prefill of 32 tokens; a chunked
    prefill of the last 12 over a cache holding the first 20 (the
    expanded form over the cache); a decode step at per-row positions
    (the absorbed form against the latent cache).  Outputs within
    MLA_BOUND of the largest, and the updated caches too."""
    cj, ct, pj, pt = _mla(seed)
    spec_j, spec_t = cj.segments[0][1][0], ct.segments[0][1][0]
    B, P, S, L = 2, 20, 12, 40
    x = rng.standard_normal((B, P + S, cj.d_model)).astype(np.float32)
    pos = np.tile(np.arange(P + S), (B, 1))
    rows = np.array([P, P - 3])
    with jax_numerics_scope(JaxNumerics(**EXACT_F32)):
        full_j, _ = jattn.mla_apply(pj, jnp.asarray(x), cj, spec_j,
                                    jnp.asarray(pos))
        _, c1 = jattn.mla_apply(pj, jnp.asarray(x[:, :P]), cj, spec_j,
                                jnp.asarray(pos[:, :P]))
        cache_j = {k: jnp.zeros((B, L, v.shape[-1])).at[:, :P].set(v)
                   for k, v in c1.items()}
        chunk_j, cc_j = jattn.mla_apply(pj, jnp.asarray(x[:, P:]), cj, spec_j,
                                        jnp.asarray(pos[:, P:]),
                                        cache=cache_j, q_offset=P)
        dec_j, cd_j = jattn.mla_apply(
            pj, jnp.asarray(x[:, P:P + 1]), cj, spec_j,
            jnp.asarray(rows[:, None]), cache=cache_j,
            q_offset=jnp.asarray(rows, jnp.int32))
    with numerics_scope(NumericsConfig(**EXACT_F32)), torch.no_grad():
        full_t, _ = tattn.mla_apply(pt, torch.as_tensor(x), ct, spec_t,
                                    torch.as_tensor(pos))
        _, c1t = tattn.mla_apply(pt, torch.as_tensor(x[:, :P]), ct, spec_t,
                                 torch.as_tensor(pos[:, :P]))

        def cache():
            return {k: torch.zeros((B, L, v.shape[-1])).index_copy_(
                1, torch.arange(P), v) for k, v in c1t.items()}

        chunk_t, cc_t = tattn.mla_apply(pt, torch.as_tensor(x[:, P:]), ct,
                                        spec_t, torch.as_tensor(pos[:, P:]),
                                        cache=cache(), q_offset=P)
        dec_t, cd_t = tattn.mla_apply(pt, torch.as_tensor(x[:, P:P + 1]), ct,
                                      spec_t, torch.as_tensor(rows[:, None]),
                                      cache=cache(),
                                      q_offset=torch.as_tensor(rows))
    assert _rel(full_t, full_j) <= MLA_BOUND
    assert _rel(chunk_t, chunk_j) <= MLA_BOUND
    assert _rel(dec_t, dec_j) <= MLA_BOUND
    for k in ("ckv", "kpe"):
        assert _rel(cc_t[k], cc_j[k]) <= MLA_BOUND
        assert _rel(cd_t[k], cd_j[k]) <= MLA_BOUND
    # the chunk's rows are the no-cache prefill's rows, bit for bit
    assert torch.equal(chunk_t, full_t[:, P:])


@pytest.mark.parametrize("chunk", [7, 30])
def test_chunked_prefill_equals_whole_prefill_bit_for_bit(chunk, port_session,
                                                          rng):
    """Within the port, the reduced model's prompt run in chunks over the
    cache (``backbone`` with caches under the serving sums, as
    ``decode_step`` with S > 1 runs it) gives the whole prefill's hidden
    states and its ``ckv`` / ``kpe`` rows in all four blocks, bit for bit
    (exact preset: bf16 products).  The hidden states, not the logits: a
    whole prefill's head takes the last row alone, a chunk's all of its
    rows."""
    s = port_session.replace(policy="exact")
    prompt = torch.as_tensor(rng.integers(0, 256, (1, 30)))
    with torch.inference_mode(), fp64_sums():
        want, _ = ttr.backbone(s.params, s.config, {"tokens": prompt})
        _, whole = ttr.prefill(s.params, s.config, {"tokens": prompt},
                               max_len=32)
        state = ttr.init_state(s.config, 1, 32, dtype=torch.float32,
                               device="cpu")
        got = torch.cat([ttr.backbone(
            s.params, s.config, {"tokens": prompt[:, i:i + chunk]},
            caches=state["layers"], q_offset=i)[0]
            for i in range(0, 30, chunk)], dim=1)
    assert torch.equal(got, want)
    for seg_w, seg_c in zip(whole["layers"], state["layers"]):
        for leaf in ("ckv", "kpe"):
            assert torch.equal(seg_c[0][leaf], seg_w[0][leaf])


def test_block_cache_and_pool_hold_the_latent(port_session):
    """An MLA block's cache is the latent ``ckv`` (kv rank) and ``kpe``
    (rope dim), no head axis, as in the reference's ``_block_cache``; the
    paged pool pages both."""
    cfg = port_session.config
    state = ttr.init_state(cfg, 3, 24, device="cpu")
    m = cfg.mla
    for seg, (r, _) in zip(state["layers"], cfg.segments):
        assert {k: tuple(v.shape) for k, v in seg[0].items()} == {
            "ckv": (r, 3, 24, m.kv_lora_rank), "kpe": (r, 3, 24,
                                                       m.rope_head_dim)}
    assert kvcache.paged_layout(cfg) == (frozenset({0}), frozenset({0}))
    pool = kvcache.paged_pool_init(cfg, 2, 5, 8, device="cpu")
    assert tuple(pool["layers"][1][0]["ckv"].shape) == (2, 6, 8,
                                                        m.kv_lora_rank)


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


def test_prefill_then_decode_matches_the_full_forward(port_session, rng):
    """fp32 products: the logits of a 24-token prefill and of 8 decode
    steps fed the next tokens equal the full 32-token forward's logits at
    the same positions, within FORWARD_BOUND of the largest."""
    cfg = dataclasses.replace(port_session.config,
                              numerics=NumericsConfig(**EXACT_F32))
    params = port_session.params
    tokens = torch.as_tensor(rng.integers(0, 256, (2, 32)))
    with torch.inference_mode():
        hidden, _ = ttr.backbone(params, cfg, {"tokens": tokens})
        full = ttr.logits_fn(params, cfg, hidden)
        got, state = ttr.prefill(params, cfg, {"tokens": tokens[:, :24]},
                                 max_len=32)
        steps_ = [got]
        for i in range(24, 31):
            got, state = ttr.decode_step(params, cfg,
                                         {"token": tokens[:, i:i + 1]}, state, i)
            steps_.append(got)
    assert _rel(torch.cat(steps_, 1), full[:, 23:31].numpy()) <= FORWARD_BOUND


@pytest.mark.parametrize("mode", ["exact", "segmented3"])
def test_loss_and_grads_match_jax(mode, tree):
    """fp32 training at 2 x 24 tokens: the loss within 1e-5 and every
    leaf's gradient within 2**-6 of ``jax.grad``'s largest, MLA's and the
    MoE layer's leaves among them (``wk_b`` and ``wv_b`` included)."""
    if mode == "exact":
        jn, tn = JaxNumerics(**EXACT_F32), NumericsConfig(**EXACT_F32)
    else:
        jn = JaxNumerics(mode="segmented", seg_passes=3, backend="xla")
        tn = NumericsConfig(mode="segmented", seg_passes=3)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), numerics=jn)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), numerics=tn)
    toks = np.random.default_rng(7).integers(0, 256, (2, 25))
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = steps.grads_of(ttr.loss_fn, params_from_numpy(tree, tcfg,
                                                                "cpu"), tcfg,
                                 {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    names = []
    for (name, want), g in zip(tree_util.named(jax.tree.map(np.asarray,
                                                            jgrads)),
                               tree_util.leaves(grads)):
        assert g is not None and g.shape == want.shape, name
        assert _rel(g, want) <= GRAD_BOUND, name
        names.append(name)
    assert {"seg0_p0.attn.wk_b", "seg0_p0.attn.wv_b", "seg1_p0.attn.wq_a",
            "seg1_p0.mlp.router", "seg1_p0.mlp.wi"} <= set(names)


def test_engine_equals_solo_generate_with_paged_latent(port_session, rng):
    """Reduced deepseek through the port engine (the latent caches paged
    in pages of 16, chunked prefill in chunks of 32, mixed tiers, more
    requests than slots): every request's tokens equal the port's solo
    generate."""
    spec = [(rng.integers(0, 256, n), tier, k) for n, tier, k in
            [(45, "standard", 6), (70, "premium", 4), (12, "bulk", 6),
             (33, "standard", 5), (8, "standard", 3)]]
    eng = port_session.serving_engine(TIERS, slots=2, max_len=80)
    reqs = [eng.submit(p, tier=t, max_new_tokens=k) for p, t, k in spec]
    stats = eng.run()
    assert all(r.done for r in reqs)
    assert stats["standard"].n_prefill_chunks >= 5
    for r in reqs:
        solo = port_session.replace(policy=POLICY[r.tier]).generate(
            prompts=r.prompt[None], gen_len=r.max_new_tokens)
        np.testing.assert_array_equal(r.result(), solo.tokens[0],
                                      err_msg=r.id)
