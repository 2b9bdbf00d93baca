"""The port's whisper-tiny (encoder, cross-attention, ``WhisperConverter``)
against the JAX package's, on shared weights, at the reduced config: a
2-layer bidirectional encoder over ``enc_embeds`` and 2 decoder blocks
that cross-attend its output, d 64.

Weights come from a JAX ``Session("whisper-tiny")`` (reduced) and are
carried across with ``repro_torch.compat.params_from_numpy``; tokens and
encoder inputs are numpy arrays handed to both.  Whisper has no
``generate`` in either package (the JAX package's raises ``KeyError:
'enc_embeds'``), so its path is the model API: ``prefill`` with
``{"tokens", "enc_embeds"}``, then ``decode_step`` against
``state["enc_out"]``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat as jax_compat
from repro.configs import get_arch as jax_get_arch
from repro.core import sweep as jax_sweep
from repro.core.numerics import NumericsConfig as JaxNumerics
from repro.core.policy import NumericsPolicy as JaxPolicy
from repro.models import transformer as jtr
from repro.models.layers import unzip
from repro.serving import ServingError as JaxServingError
from repro.serving import kvcache as jax_kvcache
from repro.session import Session as JaxSession
from repro_torch import compat
from repro_torch import tree as tree_util
from repro_torch.compat import CompatError, flatten_tree, params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core import sensitivity, sweep
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.launch import steps
from repro_torch.models import transformer as ttr
from repro_torch.numerics import numerics_scope
from repro_torch.serving import ServingError, kvcache
from repro_torch.session import Session, SessionError, main

ARCH = "whisper-tiny"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "compat")
FIXTURE = os.path.join(GOLDEN, ARCH)
PRESETS = ["exact", "segmented3", "segmented2", "segmented1"]
# logits in units of the largest |logit|, every preset: one bf16 ulp.  The
# two packages' fp32 exp, rsqrt and silu differ by an ulp here and there,
# which can flip the bf16 rounding of a projection's or the attention's
# operand; one such flip in the encoder moves the decoder's logits by up
# to some 2**-9 of the largest (measured 2.6e-3 under exact with 48
# frames), so exact and segmented1 are held as segmented3 and segmented2
# are (tests/test_torch_hybrid.py holds zamba2 alike)
LOGIT_BOUND = 2.0 ** -8
# the encoder's output with fp32 activations and fp32 products, in units
# of its largest |element|: the attention's score and PV operands are
# still rounded to bf16, and the packages' few-ulp differences flip some
# of those roundings (48 frames: one flipped v element in layer 0, six in
# layer 1 moved the output by 2.6e-4), so one bf16 ulp, as for the logits
ENC_BOUND = 2.0 ** -8
# training at fp32 (2 x 12 tokens against 48 frames), as
# tests/test_torch_hybrid.py holds zamba2
LOSS_RTOL = 1e-5
GRAD_BOUND = 2.0 ** -6
EXACT_F32 = dict(mode="exact", compute_dtype="float32")


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, JaxSession(ARCH).params)


@pytest.fixture(scope="module")
def port_params(tree):
    return params_from_numpy(tree, get_arch(ARCH).reduced(), "cpu")


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _inputs(rng, B, S, Se, d=64):
    tokens = rng.integers(0, 256, (B, S))
    enc = rng.standard_normal((B, Se, d)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens, jnp.int32),
             "enc_embeds": jnp.asarray(enc)},
            {"tokens": torch.as_tensor(tokens),
             "enc_embeds": torch.as_tensor(enc)})


def test_config_and_param_count_match_jax():
    for mine, ref in [(get_arch(ARCH), jax_get_arch(ARCH)),
                      (get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced())]:
        for f in dataclasses.fields(mine):
            if f.name in ("numerics", "segments"):
                continue
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert [(r, [dataclasses.asdict(s) for s in p]) for r, p in mine.segments] \
            == [(r, [dataclasses.asdict(s) for s in p]) for r, p in ref.segments]
        assert mine.param_count() == ref.param_count()
    full = get_arch(ARCH)
    assert (full.encoder_layers, full.decoder_len, full.frontend,
            full.tie_embeddings) == (4, 256, "audio_stub", False)
    assert full.param_count() == 61_065_984
    assert get_arch(ARCH).reduced().encoder_layers == 2


@pytest.mark.parametrize("reduced", [True, False])
def test_param_names_and_shapes_match_jax_eval_shape(reduced):
    cfg_j, cfg_t = jax_get_arch(ARCH), get_arch(ARCH)
    if reduced:
        cfg_j, cfg_t = cfg_j.reduced(), cfg_t.reduced()
    pp = jax.eval_shape(lambda k: jtr.init(cfg_j, k), jax.random.PRNGKey(0))
    want = {".".join(str(getattr(p, "key", p)) for p in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(unzip(pp)[0])[0]}
    got = {k: tuple(s) for k, (s, _) in ttr.param_shapes(cfg_t).items()}
    assert got == want
    n_enc = cfg_t.encoder_layers
    assert got["encoder.blocks.attn.wq"][0] == n_enc
    assert "encoder.blocks.cross.wq" not in got
    assert got["seg0_p0.cross.wk"][1:] == (cfg_t.d_model, cfg_t.d_model)
    if not reduced:
        # the config's count leaves out the 22 norms' 8,448 scales
        assert sum(int(np.prod(s)) for s in got.values()) == 61_074_432


def test_layer_paths_and_counts_match_jax():
    for cfg_t, cfg_j in [(get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()),
                         (get_arch(ARCH), jax_get_arch(ARCH))]:
        paths = ttr.layer_paths(cfg_t)
        assert paths == jtr.layer_paths(cfg_j)
        assert ttr.layer_path_counts(cfg_t) == jtr.layer_path_counts(cfg_j)
    cfg = get_arch(ARCH)
    paths = ttr.layer_paths(cfg)
    enc = [p for p in paths if p.startswith("encoder.")]
    assert enc == [f"encoder.blocks.{s}" for s in (
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi", "mlp.wg",
        "mlp.wo")]
    assert ttr.layer_path_counts(cfg) == {p: 4 for p in enc}
    assert "blocks.3.cross.wv" in paths and len(paths) == 4 * 11 + 7 + 1


def test_encoder_apply_matches_jax(tree, port_params, rng):
    """fp32 activations and fp32 products over 48 frames: the encoder's
    output (bidirectional blocks, then its norm) within ENC_BOUND of the
    largest, and the train-mode encoder (``remat`` full) equal to it bit
    for bit."""
    cfg_j = dataclasses.replace(jax_get_arch(ARCH).reduced(),
                                numerics=JaxNumerics(**EXACT_F32))
    cfg_t = dataclasses.replace(get_arch(ARCH).reduced(),
                                numerics=NumericsConfig(**EXACT_F32))
    bj, bt = _inputs(rng, 2, 4, 48)
    p_j = jax.tree.map(jnp.asarray, tree)
    with jtr.numerics_scope(cfg_j.numerics):
        want = jtr.encoder_apply(p_j["encoder"], cfg_j, bj)
    with numerics_scope(cfg_t.numerics):
        got = ttr.encoder_apply(port_params["encoder"], cfg_t, bt)
        again = ttr.encoder_apply(port_params["encoder"],
                                  dataclasses.replace(cfg_t, remat="full"),
                                  bt, train=True)
    assert got.shape == (2, 48, 64)
    assert _rel(got, want) <= ENC_BOUND
    assert torch.equal(again, got)


@pytest.mark.parametrize("Se", [48, 1100])
@pytest.mark.parametrize("preset", PRESETS)
def test_prefill_decode_logits_and_tokens_match_jax(preset, Se, tree,
                                                    port_params, rng):
    """Prefill of 6 tokens against ``Se`` frames, then 8 decode steps
    against ``state["enc_out"]``, fed the JAX package's greedy tokens:
    every step's logits within LOGIT_BOUND, and the port's greedy token
    equal to JAX's except at a near-tie of JAX's own logits (top-2 margin
    within LOGIT_BOUND of the largest).  At 1100 frames the
    cross-attention's keys fill two chunks of 1024, the second padded by
    948 rows that must add an exact zero."""
    js = JaxSession(ARCH).replace(params=jax.tree.map(jnp.asarray, tree),
                                  policy=preset)
    ts = Session(ARCH, policy=preset, params=port_params, device="cpu")
    cj, ct = js.config, ts.config
    bj, bt = _inputs(rng, 2, 6, Se)
    prefill = jax.jit(lambda p, b: jtr.prefill(p, cj, b, max_len=16))
    decode = jax.jit(lambda p, t, s, pos: jtr.decode_step(
        p, cj, {"token": t}, s, pos))
    want, state_j = prefill(js.params, bj)
    with torch.inference_mode():
        got, state_t = ttr.prefill(ts.params, ct, bt, max_len=16)
    assert state_t["enc_out"].shape == (2, Se, 64)
    assert _rel(state_t["enc_out"], state_j["enc_out"]) <= LOGIT_BOUND
    for step in range(9):
        assert _rel(got, want) <= LOGIT_BOUND, (preset, Se, step)
        w = np.asarray(want[:, -1], np.float64)
        mine = got[:, -1].argmax(-1).numpy()
        theirs = w.argmax(-1)
        for r in np.nonzero(mine != theirs)[0]:
            top = np.sort(w[r])[::-1]
            assert (top[0] - top[1]) / np.max(np.abs(w[r])) <= LOGIT_BOUND
        if step == 8:
            break
        tok = theirs[:, None]
        want, state_j = decode(js.params, jnp.asarray(tok, jnp.int32),
                               state_j, jnp.int32(6 + step))
        with torch.inference_mode():
            got, state_t = ttr.decode_step(ts.params, ct,
                                           {"token": torch.as_tensor(tok)},
                                           state_t, 6 + step)


def test_cross_attention_padding_adds_exact_zero(rng):
    """The cross-attention's shape at 1100 frames: keys in two chunks of
    1024, the second padded by 948 rows.  ``causal=False`` keeps the
    key-validity mask, so the padded rows add an exact zero: the output
    equals the JAX package's and a dense fp64 softmax over the 1100 keys
    within one bf16 ulp (the blockwise form rounds its weights to bf16,
    and the packages' exp differ by an ulp here and there, which can flip
    a rounding), where 948 leaked zero keys would pull every row toward
    0."""
    from repro.models import attention as jat
    from repro_torch.models import attention

    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 1100, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 1100, 4, 16)).astype(np.float32)
    got = attention.blockwise_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        causal=False)
    want = jat.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False)
    assert got.shape == (2, 3, 4, 16)
    assert _rel(got, want) <= LOGIT_BOUND
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16).double()
    s = torch.einsum("bqhd,bkhd->bhqk", bf(q), bf(k)) * 16 ** -0.5
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), bf(v))
    assert _rel(got, dense.numpy()) <= LOGIT_BOUND


@pytest.mark.parametrize("mode", ["float32", "segmented3"])
def test_loss_and_grads_match_jax(mode, tree):
    """fp32 training, 2 x 12 decoder tokens against 48 frames: the loss
    within 1e-5 and every leaf's gradient (the encoder's and the
    cross-attention's among them) within 2**-6 of ``jax.grad``'s largest."""
    if mode == "float32":
        jn, tn = JaxNumerics(**EXACT_F32), NumericsConfig(**EXACT_F32)
    else:
        jn = JaxNumerics(mode="segmented", seg_passes=3, backend="xla")
        tn = NumericsConfig(mode="segmented", seg_passes=3)
    jcfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), numerics=jn)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), numerics=tn)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (2, 13))
    enc = rng.standard_normal((2, 48, 64)).astype(np.float32)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "enc_embeds": enc}
    jloss, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in b.items()})
    params = params_from_numpy(tree, tcfg, "cpu")
    loss, grads = steps.grads_of(ttr.loss_fn, params, tcfg,
                                 {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    names = []
    for (name, want), g in zip(tree_util.named(jax.tree.map(np.asarray,
                                                            jgrads)),
                               tree_util.leaves(grads)):
        assert g is not None and g.shape == want.shape, name
        assert _rel(g, want) <= GRAD_BOUND, name
        names.append(name)
    assert sum(n.startswith("encoder.") for n in names) == 10
    assert sum(".cross." in n for n in names) == 4


def test_from_pretrained_fixture_and_export_match_jax(tmp_path):
    """The committed fixture through ``Session.from_pretrained``: every
    tensor equal bit for bit to ``whisper-tiny_reference.npz`` and to the
    JAX loader's; the port's export equal to the JAX package's export
    tensor for tensor (metadata included), and reloaded bit for bit."""
    sess = Session.from_pretrained(ARCH, FIXTURE, device="cpu")
    ref = dict(np.load(os.path.join(GOLDEN, "whisper-tiny_reference.npz")))
    jax_tree = jax_compat.flatten_tree(
        jax_compat.load_pretrained(ARCH, FIXTURE).params)
    got = flatten_tree(sess.params)
    assert sorted(got) == sorted(ref) == sorted(jax_tree)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      v.view(np.uint32), err_msg=k)
        np.testing.assert_array_equal(got[k], np.asarray(jax_tree[k]),
                                      err_msg=k)
    assert sess.config == get_arch(ARCH).reduced()
    mine, theirs = tmp_path / "mine.safetensors", tmp_path / "theirs.safetensors"
    sess.export(mine)
    JaxSession.from_pretrained(ARCH, FIXTURE).export(theirs)
    a, meta_a = compat.read_safetensors(mine)
    b, meta_b = jax_compat.load_checkpoint(theirs)
    assert meta_a == meta_b and sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    again = flatten_tree(Session.from_pretrained(ARCH, mine,
                                                 device="cpu").params)
    for k, v in got.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_encoder_decoder_prefix_split():
    """``model.encoder.*`` and ``model.decoder.*`` land in disjoint native
    subtrees (the reference's tests/test_compat.py check, on the port):
    ``encoder.blocks.*`` stacks the encoder's 2 layers, the decoder's
    segment its 2 blocks, and only the decoder has cross-attention."""
    sess = Session.from_pretrained(ARCH, FIXTURE, device="cpu")
    foreign, _ = compat.load_checkpoint(FIXTURE)
    enc = sess.params["encoder"]["blocks"]["attn"]["wq"]
    dec = sess.params["seg0_p0"]["attn"]["wq"]
    assert enc.shape[0] == 2 and dec.shape[0] == 2
    np.testing.assert_array_equal(
        enc[1].numpy(),
        foreign["model.encoder.layers.1.self_attn.q_proj.weight"].T)
    np.testing.assert_array_equal(
        dec[0].numpy(),
        foreign["model.decoder.layers.0.self_attn.q_proj.weight"].T)
    np.testing.assert_array_equal(
        sess.params["seg0_p0"]["cross"]["wk"][1].numpy(),
        foreign["model.decoder.layers.1.encoder_attn.k_proj.weight"].T)
    assert "cross" in sess.params["seg0_p0"]
    assert "cross" not in sess.params["encoder"]["blocks"]
    assert "whisper-tiny" in compat.families()
    conv = compat.converter_for(ARCH)
    with pytest.raises(CompatError, match="needs an encoder"):
        conv.mapping(dataclasses.replace(get_arch(ARCH).reduced(),
                                         encoder_layers=0))


def _calib_eval(params, cfg, batch):
    def eval_fn(policy):
        pcfg = dataclasses.replace(cfg, numerics=policy)
        with torch.no_grad():
            h, _ = ttr.backbone(params, pcfg, batch)
            ttr.logits_fn(params, pcfg, h)
        return 0.0
    return eval_fn


def test_calibration_records_every_encoder_site(port_params, rng):
    """The port runs the encoder eagerly, so one instrumented pass sees
    each unindexed ``encoder.blocks.*`` site once a layer: ``calls ==
    encoder_layers``, as tests/test_sensitivity.py holds the reference;
    the proxy's baseline area counts one instance per physical layer."""
    cfg = get_arch(ARCH).reduced()
    _, bt = _inputs(rng, 1, 8, 16)
    default = NumericsConfig(mode="exact")
    eval_fn = _calib_eval(port_params, cfg, bt)
    model = sensitivity.calibrate(eval_fn, default=default)
    paths = ttr.layer_paths(cfg)
    enc = {p for p in paths if p.startswith("encoder.blocks.")}
    assert {p for p in model.sites if p.startswith("encoder.")} == enc
    for p in enc:
        assert model.sites[p].calls == cfg.encoder_layers
        assert model.alpha[p] > 0
    assert all(model.sites[p].calls == 1 for p in paths if p not in enc)
    seg = [("segmented-1", NumericsConfig(mode="segmented", seg_passes=1,
                                          backend="torch"))]
    res = sweep.auto_configure(eval_fn, paths, 1e6, candidates=seg,
                               method="proxy", default=default,
                               device="cpu")
    assert any(p.startswith("encoder.blocks.") for p, _ in res.assignments)
    exact_area = sweep.config_ppa(default).logic_area_um2
    assert res.baseline_area_um2 == pytest.approx(
        exact_area * (len(paths) + (cfg.encoder_layers - 1) * len(enc)))


def test_auto_configure_calibrates_on_the_jax_batch(monkeypatch):
    """``Session.auto_configure`` on whisper draws the JAX package's
    calibration batch (the same generator, tokens 2 x 16 then enc_embeds 2
    x 16 x d) and emits a policy over the encoder's sites too; with the
    same weights it calibrates the same sites as the JAX session, each
    the same number of times."""
    seen = {}
    real_j, real_t = jtr.backbone, ttr.backbone

    def spy_j(params, cfg, batch, *a, **kw):
        seen.setdefault("jax", batch)
        return real_j(params, cfg, batch, *a, **kw)

    def spy_t(params, cfg, batch, *a, **kw):
        seen.setdefault("port", batch)
        return real_t(params, cfg, batch, *a, **kw)

    monkeypatch.setattr(jtr, "backbone", spy_j)
    monkeypatch.setattr(ttr, "backbone", spy_t)
    js = JaxSession(ARCH)
    ts = Session(ARCH, params=params_from_numpy(
        jax.tree.map(np.asarray, js.params), get_arch(ARCH).reduced(),
        "cpu"), device="cpu")
    res_t = ts.auto_configure(budget=1e6)
    res_j = js.auto_configure(budget=1e6)
    for k in ("tokens", "enc_embeds"):
        np.testing.assert_array_equal(seen["port"][k].numpy(),
                                      np.asarray(seen["jax"][k]), err_msg=k)
    assert seen["port"]["enc_embeds"].shape == (2, 16, 64)
    assert res_t.n_evals == res_j.n_evals == 1
    enc_t = {p for p, _ in res_t.assignments if p.startswith("encoder.")}
    assert enc_t and enc_t == {p for p, _ in res_j.assignments
                               if p.startswith("encoder.")}
    assert ts.is_policy


def test_policy_area_and_ppa_report_weight_the_encoder():
    cfg_t, cfg_j = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    exact = dict(mode="exact", compute_dtype="float32")
    seg1 = dict(mode="segmented", seg_passes=1)
    mine = NumericsPolicy((("encoder.blocks.mlp.*", NumericsConfig(**seg1)),),
                          default=NumericsConfig(**exact))
    ref = JaxPolicy((("encoder.blocks.mlp.*", JaxNumerics(**seg1)),),
                    default=JaxNumerics(**exact))
    paths, counts = ttr.layer_paths(cfg_t), ttr.layer_path_counts(cfg_t)
    area = sweep.policy_area(mine, paths, counts=counts)
    assert area == pytest.approx(jax_sweep.policy_area(
        ref, jtr.layer_paths(cfg_j), counts=jtr.layer_path_counts(cfg_j)),
        rel=1e-12)
    assert area != pytest.approx(sweep.policy_area(mine, paths))
    for policy in ("segmented1", mine):
        got = Session(ARCH, policy, device="cpu").ppa_report()
        want = JaxSession(ARCH, policy if isinstance(policy, str)
                          else ref).ppa_report()
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_engine_pool_and_generate_refuse_whisper(port_params, capsys):
    """No whisper serving and no whisper ``generate``, as in the
    reference: the engine and the paged pool raise ``ServingError`` with
    the reference's message; ``generate`` raises a one-line
    ``SessionError`` (the reference's is ``KeyError: 'enc_embeds'``), as
    does ``auto_configure`` on a calibration batch without encoder inputs,
    and the CLI's ``generate --arch whisper-tiny`` exits 2 with one line."""
    cfg = get_arch(ARCH).reduced()
    sess = Session(ARCH, params=port_params, device="cpu")
    with pytest.raises(ServingError, match="not servable") as e:
        sess.serving_engine(slots=2, max_len=16)
    with pytest.raises(JaxServingError, match="not servable") as e_j:
        JaxSession(ARCH).serving_engine(slots=2, max_len=16)
    assert str(e.value) == str(e_j.value)
    with pytest.raises(ServingError, match="not servable") as e:
        kvcache.paged_pool_init(cfg, 2, 4, 8, device="cpu")
    with pytest.raises(JaxServingError, match="not servable") as e_j:
        jax_kvcache.paged_pool_init(jax_get_arch(ARCH).reduced(), 2, 4, 8)
    assert str(e.value) == str(e_j.value)
    with pytest.raises(SessionError, match="enc_embeds"):
        sess.auto_configure(1e6, calib={"tokens": np.zeros((1, 4), int)})
    with pytest.raises(SessionError, match="enc_embeds") as e:
        sess.generate(batch=1, prompt_len=4, gen_len=2)
    assert "\n" not in str(e.value)
    with pytest.raises(KeyError, match="enc_embeds"):
        JaxSession(ARCH).generate(batch=1, prompt_len=4, gen_len=2)
    capsys.readouterr()
    assert main(["generate", "--arch", ARCH, "--device", "cpu"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and out.err.count("\n") == 1
    assert out.err.startswith("error: whisper-tiny: generate()")
