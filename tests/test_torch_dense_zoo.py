"""The port's last three dense decoders against the JAX package's, on
shared weights, at their reduced configs (d 64, local windows cut to 64):

- gemma2-9b: local and global layers alternating 1:1, attention softcap
  50 and logit softcap 30, tied head;
- gemma3-12b: 5 local to 1 global (12 layers reduced), qk-norm, RoPE
  theta 1e6, tied head;
- minitron-8b: global layers only, untied head.

They need no module of their own: the port's attention has taken
``window`` and ``attn_cap`` and ``logits_fn`` the logit softcap since the
first slice, and these tests hold that code against the reference.
Weights come from a JAX ``Session(arch)`` (reduced) and are carried across
with ``repro_torch.compat.params_from_numpy``; prompts are numpy ints of
80 tokens, longer than the reduced window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro.session import Session as JaxSession
from repro_torch import tree as tree_util
from repro_torch.compat import params_from_numpy
from repro_torch.configs import LayerSpec, get_arch
from repro_torch.core.numerics import NumericsConfig
from repro_torch.launch import steps
from repro_torch.models import transformer as ttr
from repro_torch.serving import TierSpec
from repro_torch.session import Session

ARCHS = ["gemma2-9b", "gemma3-12b", "minitron-8b"]
# the config and parameter-layout checks also hold the last three families
# (tests/test_torch_{vlm,moe,mla}.py hold their models) and qwen3-4b and
# mamba2-130m, so that with tests/test_torch_{hybrid,whisper}.py every one
# of the ten architectures is held against jax.eval_shape
PARAM_ARCHS = ARCHS + ["qwen2-vl-72b", "llama4-maverick-400b-a17b",
                       "deepseek-v3-671b", "qwen3-4b", "mamba2-130m"]
TIED = ("gemma2-9b", "gemma3-12b", "qwen3-4b", "mamba2-130m")
PRESETS = ["exact", "segmented3", "segmented2", "segmented1"]
PROMPT = 80   # longer than the reduced window of 64
# logits in units of the largest |logit|, every preset: one bf16 ulp.  The
# packages' fp32 exp, rsqrt and silu differ by an ulp here and there, and
# such a difference can flip the bf16 rounding of a projection's or the
# attention's operand; through gemma3's 12 reduced layers the flips move
# the logits by up to 8.5e-4 of the largest under exact (measured), so
# exact and segmented1 are held as segmented3 and segmented2 are
# (tests/test_torch_hybrid.py holds zamba2 alike)
LOGIT_BOUND = 2.0 ** -8
# training at fp32 (2 x 80 tokens), as tests/test_torch_hybrid.py holds
# zamba2
LOSS_RTOL = 1e-5
GRAD_BOUND = 2.0 ** -6
EXACT_F32 = dict(mode="exact", compute_dtype="float32")
TIERS = (TierSpec("premium", "exact", priority=0),
         TierSpec("bulk", "segmented1", priority=1),
         TierSpec("standard", "segmented3", priority=2))
POLICY = {t.name: t.policy for t in TIERS}


@pytest.fixture(scope="module")
def trees():
    return {}


def _tree(trees, arch):
    if arch not in trees:
        trees[arch] = jax.tree.map(np.asarray, JaxSession(arch).params)
    return trees[arch]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _sessions(tree, arch, policy=None):
    js = JaxSession(arch, policy).replace(params=jax.tree.map(jnp.asarray,
                                                               tree))
    ts = Session(arch, policy, params=params_from_numpy(
        tree, get_arch(arch).reduced(), "cpu"), device="cpu")
    return js, ts


def _segments(cfg):
    return [(r, [dataclasses.asdict(s) for s in p]) for r, p in cfg.segments]


@pytest.mark.parametrize("arch", PARAM_ARCHS)
def test_config_and_param_count_match_jax(arch):
    for mine, ref in [(get_arch(arch), jax_get_arch(arch)),
                      (get_arch(arch).reduced(), jax_get_arch(arch).reduced())]:
        for f in dataclasses.fields(mine):
            if f.name in ("numerics", "segments", "moe", "mla", "ssm"):
                continue
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        for f in ("moe", "mla", "ssm"):   # the packages' own dataclasses
            a, b = getattr(mine, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            assert a is None or dataclasses.asdict(a) == dataclasses.asdict(b)
        assert _segments(mine) == _segments(ref)
        assert mine.param_count() == ref.param_count()
    want = {"gemma2-9b": 9_241_100_288, "gemma3-12b": 11_765_022_720,
            "minitron-8b": 9_881_780_224, "qwen2-vl-72b": 72_704_065_536,
            "llama4-maverick-400b-a17b": 397_691_453_440,
            "deepseek-v3-671b": 669_968_433_152, "qwen3-4b": 4_022_272_000,
            "mamba2-130m": 128_859_264}
    assert get_arch(arch).param_count() == want[arch]
    windows = {s.window for _, p in get_arch(arch).reduced().segments
               for s in p if s.attn == "local"}
    assert windows == ({64} if arch in ("gemma2-9b", "gemma3-12b") else set())


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", PARAM_ARCHS)
def test_param_names_and_shapes_match_jax_eval_shape(arch, reduced):
    cfg_j, cfg_t = jax_get_arch(arch), get_arch(arch)
    if reduced:
        cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
    pp = jax.eval_shape(lambda k: jtr.init(cfg_j, k), jax.random.PRNGKey(0))
    want = {".".join(str(getattr(p, "key", p)) for p in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(unzip(pp)[0])[0]}
    got = {k: tuple(s) for k, (s, _) in ttr.param_shapes(cfg_t).items()}
    assert got == want
    assert ("unembed" in got) == (not cfg_t.tie_embeddings)
    assert cfg_t.tie_embeddings == (arch in TIED)
    assert ttr.layer_paths(cfg_t) == jtr.layer_paths(cfg_j)
    assert ttr.layer_path_counts(cfg_t) == jtr.layer_path_counts(cfg_j) == {}


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_and_tokens_match_jax(arch, preset, trees,
                                                    rng):
    """An 80-token prefill (past the reduced window of 64, so the local
    layers mask), then 8 decode steps fed the JAX package's greedy
    tokens: every step's logits within LOGIT_BOUND, and the port's greedy
    token equal to JAX's except at a near-tie of JAX's own logits (top-2
    margin within LOGIT_BOUND of the largest)."""
    js, ts = _sessions(_tree(trees, arch), arch, preset)
    cj, ct = js.config, ts.config
    prompts = rng.integers(0, 256, (2, PROMPT))
    prefill = jax.jit(lambda p, t: jtr.prefill(p, cj, {"tokens": t},
                                               max_len=PROMPT + 8))
    decode = jax.jit(lambda p, t, s, pos: jtr.decode_step(
        p, cj, {"token": t}, s, pos))
    want, state_j = prefill(js.params, jnp.asarray(prompts, jnp.int32))
    with torch.inference_mode():
        got, state_t = ttr.prefill(ts.params, ct,
                                   {"tokens": torch.as_tensor(prompts)},
                                   max_len=PROMPT + 8)
    for step in range(9):
        assert _rel(got, want) <= LOGIT_BOUND, (arch, preset, step)
        if cj.logit_softcap:
            assert float(got.abs().max()) <= cj.logit_softcap
        w = np.asarray(want[:, -1], np.float64)
        mine, theirs = got[:, -1].argmax(-1).numpy(), w.argmax(-1)
        for r in np.nonzero(mine != theirs)[0]:
            top = np.sort(w[r])[::-1]
            assert (top[0] - top[1]) / np.max(np.abs(w[r])) <= LOGIT_BOUND
        if step == 8:
            break
        tok = theirs[:, None]
        want, state_j = decode(js.params, jnp.asarray(tok, jnp.int32),
                               state_j, jnp.int32(PROMPT + step))
        with torch.inference_mode():
            got, state_t = ttr.decode_step(ts.params, ct,
                                           {"token": torch.as_tensor(tok)},
                                           state_t, PROMPT + step)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_vs_global_window_effect(arch, trees, rng):
    """The reference's tests/test_models_smoke.py check on the port: every
    layer made local with a window of 4 changes the hidden states against
    the config's own layers; and the port's hidden states equal the JAX
    package's under both layouts (fp32 products; one bf16 ulp, as the
    attention's operands still round to bf16)."""
    tree = _tree(trees, arch)

    def local(cfg, spec_cls):
        return dataclasses.replace(cfg, segments=tuple(
            (r, tuple(spec_cls(**dict(dataclasses.asdict(s), attn="local",
                                      window=4)) for s in p))
            for r, p in cfg.segments))

    cfg_t = dataclasses.replace(get_arch(arch).reduced(),
                                numerics=NumericsConfig(**EXACT_F32))
    cfg_j = dataclasses.replace(jax_get_arch(arch).reduced(),
                                numerics=JaxNumerics(**EXACT_F32))
    p_t = params_from_numpy(tree, cfg_t, "cpu")
    p_j = jax.tree.map(jnp.asarray, tree)
    tokens = rng.integers(0, 256, (2, PROMPT))
    hidden = {}
    for name, ct, cj in [("own", cfg_t, cfg_j),
                         ("local4", local(cfg_t, LayerSpec),
                          local(cfg_j, JaxLayerSpec))]:
        with torch.no_grad():
            h, _ = ttr.backbone(p_t, ct, {"tokens": torch.as_tensor(tokens)},
                                train=True)
        want, _, _ = jtr.backbone(p_j, cj,
                                  {"tokens": jnp.asarray(tokens, jnp.int32)},
                                  mode="train")
        assert _rel(h, want) <= LOGIT_BOUND, name
        hidden[name] = h.numpy()
    assert not np.allclose(hidden["own"], hidden["local4"], atol=1e-3)


def test_gemma2_logits_stay_within_the_softcap(trees, rng):
    """With the head scaled up so its raw logits run past 30, gemma2's
    logits (``tanh(x / 30) * 30``) stay within +-30, reach within 1 of
    it, and equal the JAX package's."""
    arch = "gemma2-9b"
    tree = jax.tree.map(np.copy, _tree(trees, arch))
    tree["embed"] = tree["embed"] * 40.0
    js, ts = _sessions(tree, arch)
    prompts = rng.integers(0, 256, (2, PROMPT))
    want, _ = jtr.prefill(js.params, js.config,
                          {"tokens": jnp.asarray(prompts, jnp.int32)})
    with torch.inference_mode():
        got, _ = ttr.prefill(ts.params, ts.config,
                             {"tokens": torch.as_tensor(prompts)})
    top = float(got.abs().max())
    assert 29.0 < top <= 30.0
    assert _rel(got, want) <= LOGIT_BOUND


def _sharp(tree):
    """gemma2's queries scaled up 8x so the attention scores reach the
    softcap's bend (|s| of tens against its 50); the same tree goes to
    both packages."""
    t = jax.tree.map(np.copy, tree)
    for k in ("seg0_p0", "seg0_p1"):
        t[k]["attn"]["wq"] = t[k]["attn"]["wq"] * 8.0
    return t


@pytest.mark.parametrize("mode", ["float32", "segmented3"])
def test_gemma2_loss_and_grads_match_jax(mode, trees):
    """gemma2 training at fp32 (2 x 80 tokens, queries sharpened so the
    attention softcap bends): the loss within 1e-5 and every leaf's
    gradient within 2**-6 of ``jax.grad``'s largest.  The reference
    differentiates the softcap by hand in its custom VJP (``1 - t**2``);
    the port by autograd through ``tanh``."""
    arch = "gemma2-9b"
    tree = _sharp(_tree(trees, arch))
    if mode == "float32":
        jn, tn = JaxNumerics(**EXACT_F32), NumericsConfig(**EXACT_F32)
    else:
        jn = JaxNumerics(mode="segmented", seg_passes=3, backend="xla")
        tn = NumericsConfig(mode="segmented", seg_passes=3)
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), numerics=jn)
    tcfg = dataclasses.replace(get_arch(arch).reduced(), numerics=tn)
    toks = np.random.default_rng(11).integers(0, 256, (2, PROMPT + 1))
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in b.items()})
    params = params_from_numpy(tree, tcfg, "cpu")
    loss, grads = steps.grads_of(ttr.loss_fn, params, tcfg,
                                 {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for (name, want), g in zip(tree_util.named(jax.tree.map(np.asarray,
                                                            jgrads)),
                               tree_util.leaves(grads)):
        assert g is not None and g.shape == want.shape, name
        assert _rel(g, want) <= GRAD_BOUND, name
    # the scores did reach the bend: without the attention softcap the
    # queries' gradient moves by several times the tolerance
    _, bare = steps.grads_of(ttr.loss_fn, params_from_numpy(tree, tcfg, "cpu"),
                             dataclasses.replace(tcfg, attn_softcap=None),
                             {k: torch.as_tensor(v) for k, v in b.items()})
    wq = grads["seg0_p0"]["attn"]["wq"]
    assert _rel(bare["seg0_p0"]["attn"]["wq"], wq.numpy()) > 4 * GRAD_BOUND


def test_gemma2_engine_equals_solo_generate(trees, rng):
    """Reduced gemma2 through the port engine with prompts longer than the
    window (chunked prefill in chunks of 32 over a paged cache, the window
    masked over the gathered pages), mixed tiers and more requests than
    slots: every request's tokens equal the port's solo generate, the
    standard tier's among them."""
    arch = "gemma2-9b"
    _, ts = _sessions(_tree(trees, arch), arch)
    spec = [(rng.integers(0, 256, n), tier, k) for n, tier, k in
            [(70, "standard", 6), (90, "premium", 4), (66, "standard", 5),
             (12, "bulk", 6), (99, "standard", 3)]]
    eng = ts.serving_engine(TIERS, slots=2, max_len=112)
    reqs = [eng.submit(p, tier=t, max_new_tokens=k) for p, t, k in spec]
    stats = eng.run()
    assert all(r.done for r in reqs)
    assert stats["standard"].n_prefill_chunks >= 3 * 3
    for r in reqs:
        solo = ts.replace(policy=POLICY[r.tier]).generate(
            prompts=r.prompt[None], gen_len=r.max_new_tokens)
        np.testing.assert_array_equal(r.result(), solo.tokens[0],
                                      err_msg=r.id)
