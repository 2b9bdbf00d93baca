"""The port's zamba2-7b (SSD blocks plus one shared attention block) against
the JAX package's, on shared weights, at the reduced config: 2 x (5 SSD +
1 shared attention) + 2 x 1 SSD blocks, d 64.

Weights come from a JAX ``Session("zamba2-7b")`` (reduced), made livelier
with seeded numpy changes handed to both sides, and carried across with
``repro_torch.compat.params_from_numpy``.  Prompts and batches are numpy
ints.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import policy as jax_policy
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro.serving import TierSpec as JaxTier
from repro.session import Session as JaxSession
from repro_torch import tree as tree_util
from repro_torch.compat import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.launch import steps
from repro_torch.models import transformer as ttr
from repro_torch.serving import TierSpec, kvcache
from repro_torch.session import Session

ARCH = "zamba2-7b"
PRESETS = ["exact", "segmented3", "segmented2", "segmented1"]
# logits in units of the largest |logit|: one bf16 ulp, as
# tests/test_torch_ssm.py holds mamba2 (the SSD blocks compute in fp32 with
# other op orders on the two sides, and a 1-ulp difference can flip the
# bf16 rounding of out_proj's operand under any preset)
LOGIT_BOUND = 2.0 ** -8
# final hidden states with fp32 activations and fp32 compute on both sides
HIDDEN_BOUND = 1e-4
# training at fp32 (4 x 24 tokens), as tests/test_torch_train.py holds
# qwen3-4b and mamba2-130m
LOSS_RTOL = 1e-5
GRAD_BOUND = 2.0 ** -6
TIERS = (TierSpec("premium", "exact", priority=0),
         TierSpec("bulk", "segmented1", priority=1),
         TierSpec("standard", "segmented3", priority=2))
POLICY = {t.name: t.policy for t in TIERS}
# the two applications of the reduced config's shared block
SHARED_BLOCKS = (5, 11)


def _lively(tree):
    """Spread dt biases, a seeded numpy change that makes the SSD branches
    carry the logits (at the init's zero biases every greedy stream is one
    repeated token); the same tree goes to both packages.  Scaling the
    residual's embedding down as tests/test_torch_ssm.py does makes this
    14-block stack chaotic: fp32 hidden states then differ between the
    packages by more than HIDDEN_BOUND."""
    t = jax.tree.map(lambda a: np.array(a, np.float32), tree)
    rng = np.random.default_rng(1)
    for si, p in [(0, p) for p in range(5)] + [(1, 0)]:
        blk = t[f"seg{si}_p{p}"]["ssm"]
        blk["dt_bias"] = rng.uniform(-3, 0, blk["dt_bias"].shape).astype(
            np.float32)
    return t


@pytest.fixture(scope="module")
def tree():
    return _lively(JaxSession(ARCH).params)


@pytest.fixture(scope="module")
def jax_session(tree):
    return JaxSession(ARCH).replace(params=jax.tree.map(jnp.asarray, tree))


@pytest.fixture(scope="module")
def port_session(tree):
    return Session(ARCH, params=params_from_numpy(
        tree, get_arch(ARCH).reduced(), "cpu"), device="cpu")


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _assert_same_greedy(mine, theirs, js, prompts):
    """Greedy streams equal to the JAX package's; a row may part only at a
    near-tie of the JAX side's own logits (top-2 margin within
    LOGIT_BOUND of the largest |logit|, the gap the two packages' logits
    may have), after which the streams are different prompts."""
    for r in np.nonzero((mine != theirs).any(axis=1))[0]:
        i = int(np.argmax(mine[r] != theirs[r]))
        seq = np.concatenate([prompts[r], theirs[r, :i]])[None]
        logits, _ = jtr.prefill(js.params, js.config,
                                {"tokens": jnp.asarray(seq, jnp.int32)})
        top = np.sort(np.asarray(logits[0, -1], np.float64))[::-1]
        margin = (top[0] - top[1]) / np.max(np.abs(top))
        assert margin <= LOGIT_BOUND, (r, i, margin)


def test_config_and_param_count_match_jax():
    for mine, ref in [(get_arch(ARCH), jax_get_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced())]:
        for f in dataclasses.fields(mine):
            if f.name in ("numerics", "segments", "ssm"):
                continue
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(ref.ssm)
        assert [(r, [dataclasses.asdict(s) for s in p]) for r, p in mine.segments] \
            == [(r, [dataclasses.asdict(s) for s in p]) for r, p in ref.segments]
        assert mine.param_count() == ref.param_count()
    small = get_arch(ARCH).reduced()
    assert [(r, len(p)) for r, p in small.segments] == [(2, 6), (2, 1)]
    assert small.d_model == 64 and small.n_layers == 14


@pytest.mark.parametrize("reduced", [True, False])
def test_param_names_and_shapes_match_jax_eval_shape(reduced):
    """``param_shapes`` against ``jax.eval_shape`` of the reference's init:
    every name and shape, the shared entry without a repeats axis; at
    full width 5,737,364,864 parameters (the config's ``param_count``
    counts the shared block once per repeat)."""
    cfg_j = jax_get_arch(ARCH)
    cfg_t = get_arch(ARCH)
    if reduced:
        cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
    pp = jax.eval_shape(lambda k: jtr.init(cfg_j, k), jax.random.PRNGKey(0))
    want = {".".join(str(getattr(p, "key", p)) for p in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(unzip(pp)[0])[0]}
    got = {k: tuple(shape) for k, (shape, _) in ttr.param_shapes(cfg_t).items()}
    assert got == want
    d, ff = cfg_t.d_model, cfg_t.d_ff
    assert got["seg0_p5.mlp.wi"] == (d, ff)          # shared: no repeats axis
    assert got["seg0_p0.ssm.in_proj"][0] == (2 if reduced else 13)
    if not reduced:
        assert sum(int(np.prod(s)) for s in got.values()) == 5_737_364_864
        assert got["seg0_p0.ssm.in_proj"] == (13, 3584, 14576)


def test_params_carry_across_and_init_shares_one_weight_set(tree):
    cfg = get_arch(ARCH).reduced()
    params = params_from_numpy(tree, cfg, "cpu")
    np.testing.assert_array_equal(params["seg0_p5"]["attn"]["wq"].numpy(),
                                  tree["seg0_p5"]["attn"]["wq"])
    mine = ttr.init(cfg, seed=0)
    assert mine["seg0_p5"]["attn"]["wq"].shape == (64, 64)
    bad = dict(tree, seg0_p5=jax.tree.map(lambda a: np.stack([a, a]),
                                          tree["seg0_p5"]))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, cfg)


def test_layer_paths_match_jax():
    for cfg_t, cfg_j in [(get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()),
                         (get_arch(ARCH), jax_get_arch(ARCH))]:
        assert ttr.layer_paths(cfg_t) == jtr.layer_paths(cfg_j)
        assert ttr.layer_path_counts(cfg_t) == jtr.layer_path_counts(cfg_j)
    paths = ttr.layer_paths(get_arch(ARCH))
    shared = sorted({int(p.split(".")[1]) for p in paths if ".attn." in p})
    assert shared == list(range(5, 78, 6)) and len(paths) == 68 * 3 + 13 * 7 + 1


@pytest.mark.parametrize("preset", PRESETS)
def test_prefill_decode_logits_and_tokens_match_jax(preset, jax_session,
                                                    port_session, rng):
    prompts = rng.integers(0, 256, (2, 21))
    js = jax_session.replace(policy=preset)
    ts = port_session.replace(policy=preset)
    want, state_j = jtr.prefill(js.params, js.config,
                                {"tokens": jnp.asarray(prompts, jnp.int32)},
                                max_len=24)
    got, state_t = ttr.prefill(ts.params, ts.config,
                               {"tokens": torch.as_tensor(prompts)}, max_len=24)
    assert _rel(got, want) <= LOGIT_BOUND, preset
    nxt = rng.integers(0, 256, (2, 1))
    want, _ = jtr.decode_step(js.params, js.config,
                              {"token": jnp.asarray(nxt, jnp.int32)}, state_j, 21)
    got, _ = ttr.decode_step(ts.params, ts.config,
                             {"token": torch.as_tensor(nxt)}, state_t, 21)
    assert _rel(got, want) <= LOGIT_BOUND, preset
    mine = ts.generate(prompts=prompts, gen_len=8).tokens
    _assert_same_greedy(mine, js.generate(prompts=prompts, gen_len=8).tokens,
                        js, prompts)
    assert len(set(mine[0].tolist())) > 1    # not one repeated token


def test_float32_hidden_states_match_jax(tree, rng):
    """fp32 activations and fp32 compute, read before the head: prefill
    and a decode step (through the shared block's per-application KV
    caches) agree with the JAX package to HIDDEN_BOUND."""
    f32 = dict(dtype="float32")
    cfg_j = dataclasses.replace(jax_get_arch(ARCH).reduced(), **f32,
                                numerics=JaxNumerics(mode="exact",
                                                     compute_dtype="float32"))
    cfg_t = dataclasses.replace(get_arch(ARCH).reduced(), **f32,
                                numerics=NumericsConfig(
                                    mode="exact", compute_dtype="float32"))
    p_j = jax.tree.map(jnp.asarray, tree)
    p_t = params_from_numpy(tree, cfg_t, "cpu")
    prompts = rng.integers(0, 256, (2, 21))
    nxt = rng.integers(0, 256, (2, 1))
    want, _, _ = jtr.backbone(p_j, cfg_j,
                              {"tokens": jnp.asarray(prompts, jnp.int32)},
                              "prefill")
    got, _ = ttr.backbone(p_t, cfg_t, {"tokens": torch.as_tensor(prompts)})
    assert _rel(got, want) <= HIDDEN_BOUND
    _, state_j = jtr.prefill(p_j, cfg_j,
                             {"tokens": jnp.asarray(prompts, jnp.int32)},
                             max_len=24)
    _, state_t = ttr.prefill(p_t, cfg_t, {"tokens": torch.as_tensor(prompts)},
                             max_len=24)
    kv = state_t["layers"][0][5]["k"]
    assert kv.shape == (2, 2, 24, 4, 16)       # one cache per application
    assert _rel(kv[:, :, :21], np.asarray(state_j["layers"][0][5]["k"])
                [:, :, :21]) <= HIDDEN_BOUND
    want, _, _ = jtr.backbone(p_j, cfg_j, {"tokens": jnp.asarray(nxt, jnp.int32)},
                              "decode", caches=state_j["layers"], q_offset=21)
    got, _ = ttr.backbone(p_t, cfg_t, {"tokens": torch.as_tensor(nxt)},
                          caches=state_t["layers"], q_offset=21)
    assert _rel(got, want) <= HIDDEN_BOUND


def test_shared_block_under_two_configs_matches_jax(tree, jax_session, rng,
                                                    monkeypatch):
    """One weight set under two numerics: the policy gives the shared
    block's first application segmented3 and its second segmented1 (the
    rest segmented2).  The port resolves each application under its own
    ``blocks.{i}`` path, as the JAX package does (it unrolls the segment):
    the one ``wq`` tensor reaches the segmented matmul once with 3 passes
    and once with 1, and the logits and greedy tokens match the JAX
    package's."""
    from repro_torch.core import policy as port_policy
    from repro_torch.kernels import dispatch

    seg = lambda n, b: dict(mode="segmented", seg_passes=n, backend=b)

    def policies(b, cls, pol):
        return pol.NumericsPolicy(
            ((f"blocks.{SHARED_BLOCKS[0]}.*", cls(**seg(3, b))),
             (f"blocks.{SHARED_BLOCKS[1]}.*", cls(**seg(1, b)))),
            default=cls(**seg(2, b)))

    mine = policies("torch", NumericsConfig, port_policy)
    ref = policies("xla", JaxNumerics, jax_policy)
    p_t = params_from_numpy(tree, get_arch(ARCH).reduced(), "cpu")
    wq = p_t["seg0_p5"]["attn"]["wq"]
    passes_on_wq = []
    real = dispatch.matmul

    def spy(x, w, passes=3, **kw):
        if w is wq:
            passes_on_wq.append(passes)
        return real(x, w, passes, **kw)

    monkeypatch.setattr(dispatch, "matmul", spy)
    prompts = rng.integers(0, 256, (2, 15))
    js = jax_session.replace(policy=ref)
    want, _ = jtr.prefill(js.params, js.config,
                          {"tokens": jnp.asarray(prompts, jnp.int32)})
    cfg_t = dataclasses.replace(get_arch(ARCH).reduced(), numerics=mine)
    got, _ = ttr.prefill(p_t, cfg_t, {"tokens": torch.as_tensor(prompts)})
    assert passes_on_wq == [3, 1]
    assert _rel(got, want) <= LOGIT_BOUND
    mine_tok = Session(ARCH, mine, params=p_t, device="cpu").generate(
        prompts=prompts, gen_len=6).tokens
    _assert_same_greedy(mine_tok, js.generate(prompts=prompts,
                                              gen_len=6).tokens, js, prompts)


def test_pool_mixes_paged_and_per_slot_leaves(port_session, rng):
    """The lane's pool pages the shared block's per-application KV caches
    and keeps the SSD states per slot; a whole-prompt prefill written into
    it reads back bit for bit (the paged leaves through the page table,
    the per-slot leaves in their row), and one pool decode step gives the
    token a solo decode gives."""
    s = port_session
    eng = s.serving_engine(TIERS, slots=3, max_len=32, page_size=8)
    runner = eng._lanes["premium"].runner
    assert runner.chunked is False
    assert kvcache.paged_layout(s.config) == (frozenset({5}), frozenset())
    seg0 = runner.pool["layers"][0]
    assert seg0[5]["k"].shape == (2, runner.n_pages + 1, 8, 4, 16)
    assert seg0[0]["state"].shape == (2, 3, 16, 16, 8)
    prompt = rng.integers(0, 256, 11)
    table = np.full(runner.max_pages, runner.n_pages, np.int32)
    table[:2] = [3, 1]
    tok = runner.prefill_full(2, prompt, table)
    _, solo = ttr.prefill(s.params, s.config,
                          {"tokens": torch.as_tensor(prompt[None])}, max_len=16)
    tables = np.full((3, runner.max_pages), runner.n_pages, np.int32)
    tables[2] = table
    dense = kvcache.gather_state(runner.pool, runner._layout,
                                 torch.as_tensor(tables))
    for si, seg in enumerate(solo["layers"]):
        for pi, leaves in seg.items():
            for k, want in leaves.items():
                got = dense["layers"][si][pi][k][:, 2]
                if pi in runner._layout[si]:
                    got = got[:, :16]
                assert torch.equal(got, want[:, 0]), (si, pi, k)
    nxt = runner.decode(np.array([0, 0, tok]), np.array([0, 0, 11]), tables)
    logits, _ = ttr.decode_step(s.params, s.config,
                                {"token": torch.tensor([[tok]])}, solo, 11)
    assert nxt[2] == int(logits[0, -1].argmax())


def test_engine_standard_equals_solo_and_jax(jax_session, port_session, rng):
    """Reduced zamba2 through the port engine (whole-prompt prefill, mixed
    tiers, more requests than slots): every tier's tokens equal the port's
    solo generate, and the JAX engine's on the same weights."""
    spec = [(rng.integers(0, 256, n), tier, k) for n, tier, k in
            [(9, "premium", 4), (4, "standard", 5), (6, "bulk", 3),
             (7, "standard", 4), (5, "premium", 6), (3, "bulk", 5),
             (12, "standard", 3)]]
    eng = port_session.serving_engine(TIERS, slots=2, max_len=24)
    reqs = [eng.submit(p, tier=t, max_new_tokens=k) for p, t, k in spec]
    stats = eng.run()
    assert all(r.done for r in reqs)
    assert sum(st.n_prefill_chunks for st in stats.values()) == len(spec)
    for r in reqs:
        solo = port_session.replace(policy=POLICY[r.tier]).generate(
            prompts=r.prompt[None], gen_len=r.max_new_tokens)
        np.testing.assert_array_equal(r.result(), solo.tokens[0], err_msg=r.id)
    tiers_j = tuple(JaxTier(t.name, t.policy, t.priority) for t in TIERS)
    eng_j = jax_session.serving_engine(tiers_j, slots=2, max_len=24)
    served = [(r, eng_j.submit(p, tier=t, max_new_tokens=k))
              for r, (p, t, k) in zip(reqs, spec)]
    eng_j.run()
    for mine, theirs in served:
        np.testing.assert_array_equal(mine.result(), theirs.result(),
                                      err_msg=mine.id)


@pytest.mark.parametrize("mode", ["float32", "segmented3"])
def test_loss_and_grads_match_jax(mode, tree):
    """fp32 training at 4 x 24 tokens (fp32 activations; fp32 products,
    or the 3-pass split-float product): the loss within 1e-5 and every
    leaf's gradient within 2**-6 of ``jax.grad``'s largest, the shared
    block's leaves (the sum over both applications) among them.  With
    bf16 products (``exact``) one fp32 ulp can flip a bf16 operand's
    rounding in any of the 14 blocks, and the losses differ by more than
    1e-5 (ROADMAP.md section 3)."""
    jcfg, tcfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    if mode == "float32":
        jn = JaxNumerics(mode="exact", compute_dtype="float32")
        tn = NumericsConfig(mode="exact", compute_dtype="float32")
    else:
        jn = JaxNumerics(mode="segmented", seg_passes=3, backend="xla")
        tn = NumericsConfig(mode="segmented", seg_passes=3)
    jcfg = dataclasses.replace(jcfg, numerics=jn)
    tcfg = dataclasses.replace(tcfg, numerics=tn)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, tcfg, "cpu")
    b = lm_batch(DataConfig(vocab=tcfg.vocab, seq_len=24, global_batch=4,
                            seed=1), 0)
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = steps.grads_of(ttr.loss_fn, params, tcfg,
                                 {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    names = []
    for (name, want), g in zip(tree_util.named(jax.tree.map(np.asarray,
                                                            jgrads)),
                               tree_util.leaves(grads)):
        assert g is not None and torch.isfinite(g).all(), name
        assert g.shape == want.shape, name
        assert _rel(g.numpy(), want) <= GRAD_BOUND, name
        names.append(name)
    assert sum(n.startswith("seg0_p5") for n in names) == 9


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_of_shared_blocks_changes_no_bit(remat, tree):
    """Checkpointed shared blocks hand the one weight set to each
    application's recompute (nothing copied per application): every
    gradient equals the one without remat bit for bit, and the shared
    leaf's gradient is the sum over its applications (nonzero in both
    halves of the stack)."""
    cfg = get_arch(ARCH).reduced()
    b = {k: torch.as_tensor(v) for k, v in lm_batch(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3), 0).items()}
    out = {}
    for r in ("none", remat):
        params = params_from_numpy(tree, cfg, "cpu")
        _, g = steps.grads_of(ttr.loss_fn, params,
                              dataclasses.replace(cfg, remat=r), b)
        out[r] = dict(tree_util.named(g))
    for name, g in out["none"].items():
        assert torch.equal(g, out[remat][name]), name
    assert out["none"]["seg0_p5.attn.wq"].abs().max() > 0
