"""The port's CIFAR ResNet-18 against the JAX package's, on shared weights.

Weights come from ``repro.models.resnet.init`` (the JAX PRNG) at a tiny
width and are carried across with
``repro_torch.compat.resnet_from_numpy``; images are numpy from the
``rng`` fixture, handed to both.  Bounds, in units of the largest output:

- exact (native conv on both sides; XLA's and oneDNN's convs sum in
  different orders): logits within 1e-4;
- segmented 1/2/3 (plain route): every conv within 64 ulps of its largest
  output on the same operands, logits within 2**-8;
- emulated (AC5-5 and the registry baseline MMBS5, on a one-block-a-stage
  net): every conv within 64 ulps on the same operands; logits within
  2**-8, argmax equal.  Not 1e-4: the bit-level designs are not
  continuous, a one-ulp change of an operand moves an MMBS5 product's sum
  by up to 2.8e-3 of the largest output (AC5-5: 3e-5), and the two
  packages' fp32 sums differ by an ulp from the first conv on (ROADMAP.md
  section 3);
- train-mode batch-norm statistics within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.numerics import NumericsConfig as JaxConfig
from repro.core.numerics import set_operand_tap as jax_set_tap
from repro.models import resnet as jr
from repro.models.layers import unzip
from repro.numerics import nmatmul as jax_nmatmul
from repro.numerics import numerics_scope as jax_scope
from repro_torch.compat import resnet_from_numpy
from repro_torch.core.numerics import NumericsConfig
from repro_torch.kernels import afpm_matmul as k1
from repro_torch.models import resnet
from repro_torch.numerics import nmatmul, numerics_scope
from repro_torch.session import Session, SessionError

WIDTHS = (8, 16, 24, 32)
ULPS = 64


def _jax_cfg(**kw):
    return JaxConfig(**{"backend": "xla", **kw}) if kw.get("mode") == \
        "segmented" else JaxConfig(**kw)


def _carry(widths, blocks, seed):
    """(JAX cfg, params, state) and the port's, carried across."""
    cfg = jr.ResNetConfig(widths=widths, blocks=blocks)
    pp, state = jr.init(cfg, jax.random.PRNGKey(seed))
    params, _ = unzip(pp)
    mine = resnet.ResNetConfig(widths=widths, blocks=blocks)
    tp, ts = resnet_from_numpy(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), mine, "cpu")
    return (cfg, params, state), (mine, tp, ts)


@pytest.fixture(scope="module")
def nets():
    return _carry(WIDTHS, (2, 2, 2, 2), 3)


@pytest.fixture(scope="module")
def small_nets():
    # the emulated reference is slow on the CPU: one block a stage
    return _carry((8, 16), (1, 1), 4)


def _images(rng, n=3, size=16):
    return rng.standard_normal((n, size, size, 3)).astype(np.float32)


def _logits(nets, images, jax_num, port_num):
    (jc, jp, js), (tc, tp, ts) = nets
    want, _ = jr.apply(jp, js, jnp.asarray(images),
                       dataclasses.replace(jc, numerics=jax_num))
    got, _ = resnet.apply(tp, ts, torch.from_numpy(images),
                          dataclasses.replace(tc, numerics=port_num))
    return np.asarray(want), got.numpy()


def _per_conv_ulps(nets, images, jax_num, port_num):
    """Every call site's operands as the JAX forward gives them, through
    both packages' nmatmul: the worst error in ulps of that site's largest
    output, and the number of sites."""
    (jc, jp, js), _ = nets
    sites = []
    prev = jax_set_tap(lambda path, x, w: sites.append(
        (path, np.asarray(x), np.asarray(w))))
    try:
        jr.apply(jp, js, jnp.asarray(images),
                 dataclasses.replace(jc, numerics=jax_num))
    finally:
        jax_set_tap(prev)
    worst = 0.0
    for path, x, w in sites:
        with jax_scope(jax_num):
            want = np.asarray(jax_nmatmul(jnp.asarray(x), jnp.asarray(w)))
        with numerics_scope(port_num):
            got = nmatmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        ulp = np.spacing(np.float32(np.max(np.abs(want))))
        worst = max(worst, float(np.max(np.abs(got - want)) / ulp))
    return worst, [p for p, _, _ in sites]


@pytest.mark.parametrize("widths", [(64, 128, 256, 512), WIDTHS, (4, 8)])
def test_layer_paths_and_shapes_match_jax(widths):
    blocks = (1, 1) if len(widths) == 2 else (2, 2, 2, 2)
    ref_cfg = jr.ResNetConfig(widths=widths, blocks=blocks)
    cfg = resnet.ResNetConfig(widths=widths, blocks=blocks)
    assert resnet.layer_paths(cfg) == jr.layer_paths(ref_cfg)
    pp, state = jax.eval_shape(lambda k: jr.init(ref_cfg, k),
                               jax.random.PRNGKey(0))
    params, _ = unzip(pp)
    flat = lambda t, pre="": (
        {k2: v2 for k, v in t.items()
         for k2, v2 in flat(v, f"{pre}{k}.").items()}
        if isinstance(t, dict) else {pre[:-1]: tuple(t.shape)})
    want_p, want_s = flat(params), flat(state)
    got_p, got_s = resnet.shapes(cfg)
    assert {k: tuple(s) for k, (s, _) in got_p.items()} == want_p
    assert {k: tuple(s) for k, (s, _) in got_s.items()} == want_s
    if widths[0] == 64:   # the paper's network: about 11.2 M parameters
        assert sum(int(np.prod(s)) for s, _ in got_p.values()) == 11_173_962


def test_exact_logits_match_jax(nets, rng):
    want, got = _logits(nets, _images(rng),
                        JaxConfig(mode="exact", compute_dtype="float32"),
                        NumericsConfig(mode="exact", compute_dtype="float32"))
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_segmented_convs_and_logits_match_jax(passes, nets, rng):
    images = _images(rng)
    jnum = _jax_cfg(mode="segmented", seg_passes=passes)
    tnum = NumericsConfig(mode="segmented", seg_passes=passes,
                          backend="torch")
    worst, paths = _per_conv_ulps(nets, images, jnum, tnum)
    assert paths == jr.layer_paths(nets[0][0])      # 20 convs + fc
    assert worst <= ULPS, worst
    want, got = _logits(nets, images, jnum, tnum)
    assert np.max(np.abs(got - want)) <= 2.0 ** -8 * np.max(np.abs(want))
    # the session's preset takes backend "auto": the plain route on CPU
    _, (tc, tp, ts) = nets
    sess = Session.from_resnet(tc, tp, ts, policy=f"segmented{passes}",
                               device="cpu")
    np.testing.assert_array_equal(sess.apply(images).numpy(), got)


@pytest.mark.parametrize("design", ["AC5-5", "MMBS5"])
def test_emulated_convs_and_logits_match_jax(design, small_nets, rng):
    images = _images(rng, n=2, size=8)
    jnum = JaxConfig(mode="emulated", multiplier=design, seg_n=5)
    tnum = NumericsConfig(mode="emulated", multiplier=design, seg_n=5)
    worst, paths = _per_conv_ulps(small_nets, images, jnum, tnum)
    assert len(paths) == 7 and worst <= ULPS, worst
    want, got = _logits(small_nets, images, jnum, tnum)
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# the largest |logit| difference at 2-2-2-2 depth, in units of the largest
# |logit|: about twice the drift measured between the packages (AC5-5
# 6.7e-5, MMBS5 1.44e-3; ROADMAP.md section 3)
DEEP_BOUND = {"AC5-5": 1.5e-4, "MMBS5": 2.0 ** -8}


@pytest.mark.parametrize("design", ["AC5-5", "MMBS5"])
def test_emulated_logits_at_full_depth_match_jax(design, nets, rng):
    """ResNet-18's 2-2-2-2 blocks emulated: the argmax equal, the logits
    within the drift bound (the two packages' fp32 chunk sums differ by an
    ulp from the first conv on, and the bit-level designs are not
    continuous)."""
    images = _images(rng, n=2, size=8)
    jnum = JaxConfig(mode="emulated", multiplier=design, seg_n=5)
    tnum = NumericsConfig(mode="emulated", multiplier=design, seg_n=5)
    want, got = _logits(nets, images, jnum, tnum)
    assert np.max(np.abs(got - want)) <= \
        DEEP_BOUND[design] * np.max(np.abs(want))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("size,k,stride", [(9, 3, 2), (8, 3, 2), (7, 1, 2),
                                           (6, 3, 1), (5, 1, 1)])
@pytest.mark.parametrize("mode", ["exact", "segmented3", "exact-tapped"])
def test_single_conv_matches_jax(size, k, stride, mode, rng):
    """One conv alone: odd and even inputs under stride 2 take XLA's
    asymmetric SAME padding (the extra row and column at the end), on the
    native conv, the im2col route and the tapped exact route."""
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = (rng.standard_normal((k, k, 5, 6)) * 0.3).astype(np.float32)
    if mode == "segmented3":
        jnum = _jax_cfg(mode="segmented", seg_passes=3)
        tnum = NumericsConfig(mode="segmented", seg_passes=3)
    else:
        jnum = JaxConfig(mode="exact", compute_dtype="float32")
        tnum = NumericsConfig(mode="exact", compute_dtype="float32")
    tap = mode == "exact-tapped"
    prev_j = jax_set_tap((lambda *a: None) if tap else None)
    from repro_torch.numerics import set_operand_tap
    prev_t = set_operand_tap((lambda *a: None) if tap else None)
    try:
        with jax_scope(jnum):
            want = np.asarray(jr.conv2d(jnp.asarray(x), jnp.asarray(w),
                                        stride))
        with numerics_scope(tnum):
            got = resnet.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                stride).numpy()
    finally:
        jax_set_tap(prev_j)
        set_operand_tap(prev_t)
    assert got.shape == want.shape == (2, -(-size // stride),
                                       -(-size // stride), 6)
    ulp = np.spacing(np.float32(np.max(np.abs(want))))
    assert np.max(np.abs(got - want)) <= ULPS * ulp


def test_im2col_column_order(rng):
    """Column ``(i * kw + j) * cin + c`` of a patch row is input pixel
    (i, j) of the padded window, channel c: the reference's order, which
    the segmented kernel's fixed K chunks depend on."""
    x = torch.from_numpy(rng.standard_normal((1, 5, 5, 3)).astype(np.float32))
    cols, (Ho, Wo) = resnet.im2col(x, 3, 3, 2)
    assert (Ho, Wo) == (3, 3) and cols.shape == (9, 27)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    for r, (oy, ox) in enumerate([(a, b) for a in range(3) for b in range(3)]):
        for i in range(3):
            for j in range(3):
                torch.testing.assert_close(
                    cols[r, (i * 3 + j) * 3:(i * 3 + j + 1) * 3],
                    xp[0, 2 * oy + i, 2 * ox + j], rtol=0, atol=0)


def test_train_mode_batchnorm_statistics_match_jax(nets, rng):
    (jc, jp, js), (tc, tp, ts) = nets
    images = _images(rng, n=4)
    want_l, want_s = jr.apply(jp, js, jnp.asarray(images), jc, train=True)
    got_l, got_s = resnet.apply(tp, ts, torch.from_numpy(images), tc,
                                train=True)
    flat_w = jax.tree_util.tree_flatten_with_path(want_s)[0]
    assert len(flat_w) == 2 * (1 + 2 * 8 + 3)
    for path, leaf in flat_w:
        node = got_s
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), rtol=0,
                                   atol=1e-6, err_msg=str(path))
    w = np.asarray(want_l)
    assert np.max(np.abs(got_l.numpy() - w)) <= 1e-4 * np.max(np.abs(w))
    # momentum 0 sets the running statistics to the batch's own
    _, fresh = resnet.apply(tp, ts, torch.from_numpy(images), tc,
                            train=True, momentum=0.0)
    h = torch.from_numpy(images)
    stem = resnet.conv2d(h, tp["stem"], 1)
    torch.testing.assert_close(fresh["bn_stem"]["mean"],
                               stem.mean(dim=(0, 1, 2)))


def test_native_conv_turns_tf32_off_for_its_call_only(rng):
    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark,
              cudnn.deterministic)
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **kw):
        seen.append(cudnn.allow_tf32)
        return real(*a, **kw)

    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 4)).astype(np.float32))
    torch.nn.functional.conv2d = spy
    try:
        resnet.conv2d(x, w, 2)
    finally:
        torch.nn.functional.conv2d = real
    assert seen == [False]
    assert (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark,
            cudnn.deterministic) == before


def test_segmented_kernel_plan_refuses_batches_beyond_its_grid():
    """The stem's im2col has B * 1024 rows: the kernel's 65535 blocks of
    64 rows hold B <= 4095; a larger batch raises instead of truncating."""
    assert k1.plan(4095 * 1024, 27, 64).grid[2] == 65520
    for K, N in [(27, 64), (576, 64)]:
        with pytest.raises(ValueError, match="exceeds the kernel grid"):
            k1.plan(4096 * 1024, K, N)


def test_session_resnet_entry_points(nets, rng):
    _, (tc, tp, ts) = nets
    images = _images(rng, n=2)
    sess = Session.from_resnet(tc, tp, ts, device="cpu")
    got = sess.apply(images)
    want, _ = resnet.apply(tp, ts, torch.from_numpy(images), tc)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert sess.layer_paths() == resnet.layer_paths(tc)
    for call in (lambda: sess.generate(), lambda: sess.serving_engine(),
                 lambda: Session(tc, device="cpu").params,
                 lambda: Session("qwen3-4b", device="cpu").apply(images)):
        with pytest.raises(SessionError):
            call()
    # replace() keeps the weights and state; a policy object applies
    seg = sess.replace(policy=NumericsConfig(mode="segmented", seg_passes=1))
    assert seg._state is ts and seg.params is tp
    assert not torch.equal(seg.apply(images), got)


@pytest.mark.parametrize("seed,step,n", [(0, 0, 64), (999, 10_000, 5),
                                         (123, 20_000, 3)])
def test_cifar_like_images_equal_jax_bit_for_bit(seed, step, n):
    from repro.data.synthetic import DataConfig as JaxData
    from repro.data.synthetic import cifar_like as jax_cifar_like
    from repro_torch.data.synthetic import DataConfig, cifar_like

    got = cifar_like(DataConfig(global_batch=n, seed=seed), step)
    want = jax_cifar_like(JaxData(global_batch=n, seed=seed), step)
    for k in ("images", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
