"""The port's qwen2-vl-72b (M-RoPE, ``embeds`` and 3-D ``positions``)
against the JAX package's, on shared weights, at the reduced config: 2
dense GQA blocks, d 64, 4 heads of 16, M-RoPE sections (2, 3, 3) of the 8
frequency bands, untied head.

The vision tower is a stub in both packages: an image enters as
precomputed patch embeddings ``embeds`` (B, S, d) with their (t, h, w)
positions ``positions`` (B, S, 3).  Weights come from a JAX
``Session("qwen2-vl-72b")`` (reduced) and are carried across with
``repro_torch.compat.params_from_numpy``; inputs are seeded numpy arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.session import Session as JaxSession
from repro_torch import tree as tree_util
from repro_torch.compat import params_from_numpy
from repro_torch.configs import LayerSpec, get_arch, list_archs
from repro_torch.core.numerics import NumericsConfig
from repro_torch.launch import steps
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.serving import TierSpec
from repro_torch.session import Session

ARCH = "qwen2-vl-72b"
PRESETS = ["exact", "segmented3", "segmented2", "segmented1"]
EXACT_F32 = dict(mode="exact", compute_dtype="float32")
# apply_rope alone: fp32 cos / sin of the same fp32 angles in both
# packages, which may differ by an ulp
ROPE_BOUND = 1e-6
# logits in units of the largest |logit|: one bf16 ulp, as
# tests/test_torch_dense_zoo.py holds the dense decoders
LOGIT_BOUND = 2.0 ** -8
# training on the image path (unscaled unit-variance embeddings): the
# attention's bf16 operands flip on one-ulp differences and move the
# hidden states by up to 3.6e-4 of the largest (measured, four seeds),
# the mean loss by up to 1.34e-5 under segmented3 (the token-path files
# hold 1e-5); ROADMAP.md queue 3 explains the flips
LOSS_RTOL = 2.0 ** -14
GRAD_BOUND = 2.0 ** -6
TIERS = (TierSpec("premium", "exact", priority=0),
         TierSpec("bulk", "segmented1", priority=1),
         TierSpec("standard", "segmented3", priority=2))
POLICY = {t.name: t.policy for t in TIERS}
GRID = 6          # an image of 6 x 6 patches: 36 embedded positions


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _image(rng, B, d, t=0):
    """Seeded patch embeddings of a GRID x GRID image and their 3-D
    positions: t fixed, h = i // GRID, w = i % GRID (three streams that
    differ, unlike text's)."""
    S = GRID * GRID
    embeds = rng.standard_normal((B, S, d)).astype(np.float32)
    i = np.arange(S)
    pos = np.stack([np.full(S, t), i // GRID, i % GRID], -1)
    return embeds, np.broadcast_to(pos, (B, S, 3)).astype(np.int64)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, JaxSession(ARCH).params)


@pytest.fixture(scope="module")
def port_session(tree):
    return Session(ARCH, params=params_from_numpy(
        tree, get_arch(ARCH).reduced(), "cpu"), device="cpu")


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_every_architecture_is_registered_and_supported(arch):
    """All ten of the JAX package's architectures have a port config that
    ``check_supported`` accepts, at full width and reduced."""
    assert arch in list_archs()
    for cfg in (get_arch(arch), get_arch(arch).reduced()):
        ttr.check_supported(cfg)


@pytest.mark.parametrize("kind,attn,arch", [
    ("dense", "none", "qwen3-4b"),       # attention-free: no config has it
    ("moe", "global", "qwen3-4b"),       # MoE without a moe section
    ("dense", "mla", "qwen3-4b"),        # MLA without an mla section
    ("ssm", "none", "qwen3-4b")])        # SSD without an ssm section
def test_check_supported_refuses_what_no_config_has(kind, attn, arch):
    cfg = dataclasses.replace(get_arch(arch), segments=(
        (1, (LayerSpec(kind=kind, attn=attn),)),))
    with pytest.raises(NotImplementedError, match="has no layer"):
        ttr.check_supported(cfg)


@pytest.mark.parametrize("head_dim,sections", [(16, (2, 3, 3)),
                                               (128, (16, 24, 24))])
def test_apply_rope_sections_matches_jax(head_dim, sections, rng):
    """M-RoPE against the reference's on positions whose t / h / w streams
    differ (each band must follow its own stream); with three equal
    streams it is plain RoPE, and with differing ones it is not."""
    x = rng.standard_normal((2, 9, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9, 3))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections)
    got = tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                             sections)
    assert _rel(got, want) <= ROPE_BOUND
    plain = tlayers.apply_rope(torch.as_tensor(x),
                               torch.as_tensor(pos[..., 0]), 1e6)
    assert _rel(got, plain.numpy()) > 1e-2
    same = np.repeat(pos[..., :1], 3, -1)
    assert torch.equal(
        tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(same), 1e6,
                           sections),
        tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(same[..., 0]),
                           1e6))
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                           (1, 2, 3))


@pytest.mark.parametrize("path", ["tokens", "embeds"])
@pytest.mark.parametrize("preset", PRESETS)
def test_prefill_decode_logits_match_jax(preset, path, tree, port_session,
                                         rng):
    """A prefill, of 40 text tokens or of a 6 x 6 image's embeddings at
    its 3-D positions, then 6 decode steps fed the JAX package's greedy
    tokens (at the positions the reference's ``_positions_for`` gives a
    decode step: the absolute position in all three streams): every
    step's logits within one bf16 ulp of the largest."""
    js = JaxSession(ARCH, preset).replace(params=jax.tree.map(jnp.asarray,
                                                              tree))
    ts = port_session.replace(policy=preset)
    cj, ct = js.config, ts.config
    if path == "tokens":
        batch = {"tokens": rng.integers(0, 256, (2, 40))}
    else:
        e, p = _image(rng, 2, cj.d_model)
        batch = {"embeds": e, "positions": p}
    S = next(iter(batch.values())).shape[1]
    want, sj = jtr.prefill(js.params, cj, {k: jnp.asarray(v) for k, v in
                                            batch.items()}, max_len=S + 8)
    decode = jax.jit(lambda p, t, s, pos: jtr.decode_step(
        p, cj, {"token": t}, s, pos))
    with torch.inference_mode():
        got, st = ttr.prefill(ts.params, ct, {k: torch.as_tensor(v) for k, v
                                              in batch.items()}, max_len=S + 8)
    for step in range(7):
        assert _rel(got, want) <= LOGIT_BOUND, (preset, path, step)
        if step == 6:
            break
        tok = np.asarray(want[:, -1]).argmax(-1)[:, None]
        want, sj = decode(js.params, jnp.asarray(tok, jnp.int32), sj,
                          jnp.int32(S + step))
        with torch.inference_mode():
            got, st = ttr.decode_step(ts.params, ct,
                                      {"token": torch.as_tensor(tok)}, st,
                                      S + step)


def test_image_prefill_then_decode_matches_the_full_forward(port_session,
                                                            rng):
    """fp32 products: an image prefill (36 embedded patches at 3-D
    positions) then 8 decode steps fed text tokens give the logits of one
    full forward over the same sequence (the image's embeddings, then the
    tokens' scaled embeddings at the positions a decode step gives them),
    within one bf16 ulp of the largest."""
    cfg = dataclasses.replace(port_session.config,
                              numerics=NumericsConfig(**EXACT_F32))
    params = port_session.params
    e, p = _image(rng, 2, cfg.d_model)
    S, n = e.shape[1], 8
    tokens = torch.as_tensor(rng.integers(0, 256, (2, n)))
    with torch.inference_mode():
        text = params["embed"][tokens] * cfg.d_model ** 0.5
        tpos = torch.arange(S, S + n).expand(2, n)[..., None].expand(2, n, 3)
        full_b = {"embeds": torch.cat([torch.as_tensor(e), text], 1),
                  "positions": torch.cat([torch.as_tensor(p), tpos], 1)}
        hidden, _ = ttr.backbone(params, cfg, full_b)
        full = ttr.logits_fn(params, cfg, hidden)
        image = {"embeds": torch.as_tensor(e), "positions": torch.as_tensor(p)}
        got, state = ttr.prefill(params, cfg, image, max_len=S + n)
        out = [got]
        for i in range(n - 1):
            got, state = ttr.decode_step(params, cfg,
                                         {"token": tokens[:, i:i + 1]}, state,
                                         S + i)
            out.append(got)
    assert _rel(torch.cat(out, 1), full[:, S - 1:S + n - 1].numpy()) \
        <= LOGIT_BOUND


@pytest.mark.parametrize("mode", ["exact", "segmented3"])
def test_loss_and_grads_match_jax(mode, tree, rng):
    """fp32 training on the image path (2 x 36 embedded patches at their
    3-D positions, seeded targets): the loss within 1e-5 and every leaf's
    gradient within 2**-6 of ``jax.grad``'s largest; the token table,
    which this path never reads, has no gradient in the port and a zero
    one in the reference."""
    if mode == "exact":
        jn, tn = JaxNumerics(**EXACT_F32), NumericsConfig(**EXACT_F32)
    else:
        jn = JaxNumerics(mode="segmented", seg_passes=3, backend="xla")
        tn = NumericsConfig(mode="segmented", seg_passes=3)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), numerics=jn)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), numerics=tn)
    e, p = _image(rng, 2, tcfg.d_model)
    b = {"embeds": e, "positions": p,
         "targets": rng.integers(0, 256, (2, e.shape[1]))}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = steps.grads_of(ttr.loss_fn, params_from_numpy(tree, tcfg,
                                                                "cpu"), tcfg,
                                 {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = dict(tree_util.named(jax.tree.map(np.asarray, jgrads)))
    got = dict(tree_util.named(grads))
    # the token embedding is not reached by a batch of embeds: its
    # gradient is zero on both sides, as jax.grad gives it
    assert not got.pop("embed").any() and not want.pop("embed").any()
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g.shape == want[name].shape, name
        assert _rel(g, want[name]) <= GRAD_BOUND, name


def test_engine_equals_solo_generate(port_session, rng):
    """Reduced qwen2-vl serving text through the port engine (chunked
    prefill in chunks of 32, M-RoPE positions broadcast per row, mixed
    tiers, more requests than slots): every request's tokens equal the
    port's solo generate."""
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
