"""The port's bit-level multiplier path against the JAX package's.

The same numpy inputs go through ``repro`` (JAX on the CPU: its datapath
``afpm_mult_f32``, the baselines, ``dispatch.multiply`` on the xla backend)
and ``repro_torch`` (the plain PyTorch versions that CPU tensors take).
Integer datapaths are compared bit for bit, NaNs by NaN-ness.  The Hopper
kernel itself runs only on an NVIDIA GPU: tests/test_torch_kernels_cuda.py
holds it.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import afpm as j_afpm
from repro.core import baselines as j_base
from repro.core import exact_mult as j_exact
from repro.core import formats as j_formats
from repro.core import metrics as j_metrics
from repro.core import registry as j_registry
from repro.core.numerics import NumericsConfig as JNumericsConfig
from repro.core.numerics import apply_elementwise as j_apply
from repro.core.numerics import nmatmul as j_nmatmul
from repro.kernels import dispatch as j_dispatch
from repro_torch import numerics as t_numerics
from repro_torch.core import afpm as t_afpm
from repro_torch.core import baselines as t_base
from repro_torch.core import exact_mult as t_exact
from repro_torch.core import formats as t_formats
from repro_torch.core import metrics as t_metrics
from repro_torch.core import registry as t_registry
from repro_torch.kernels import afpm_bitwise as t_kernel
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import ops as t_ops

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "afpm_golden.json"
F32 = np.finfo(np.float32)
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40,
                     F32.tiny, -F32.tiny, F32.max, -F32.max, 1.0, -1.0, 3e38,
                     1e-30, 65504.0, 1e5, 6e-5, 1.5e-5], np.float32)
AFPM_NAMES = [n for n in t_registry.available() if t_registry.afpm_config(n)]
BASELINE_NAMES = ["MMBS5", "MMBS6", "MMBS7", "CSS12", "CSS14", "CSS16",
                  "CSS18", "NC", "LPC", "HPC"]
ABLATIONS = [dict(n=5, conditional=False), dict(n=5, skip_bd=False),
             dict(n=5, compensation=False), dict(n=4, conditional=False, skip_bd=False),
             dict(n=3, fmt="bf16", skip_bd=False, compensation=False),
             dict(n=11), dict(n=0), dict(n=23, mode="acl"),
             dict(n=1, fmt="fp8_e4m3"), dict(n=2, mode="acl", fmt="fp8_e5m2"),
             dict(n=5, fmt="afp20"), dict(n=4, mode="acl", fmt="bf16")]


def _inputs(rng, n=4096):
    """fp32 values over the whole exponent range, with the specials mixed in."""
    with np.errstate(over="ignore"):
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 39, n)).astype(np.float32)
    idx = rng.integers(0, n, n // 6)
    v[idx] = rng.choice(SPECIALS, idx.size)
    return v


def _jbits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _tbits(t):
    return t.detach().numpy().view(np.uint32)


def _is_nan(bits):
    return (((bits >> 23) & 0xFF) == 255) & ((bits & 0x7FFFFF) != 0)


def _assert_bits_equal(got, want, what):
    """Bit for bit; NaNs by NaN-ness only (payloads are unspecified)."""
    got, want = np.asarray(got, np.uint32), np.asarray(want, np.uint32)
    assert got.shape == want.shape, what
    ok = (got == want) | (_is_nan(got) & _is_nan(want))
    bad = np.flatnonzero(~ok)
    assert bad.size == 0, (what, [(hex(int(got.flat[i])), hex(int(want.flat[i])))
                                  for i in bad[:8]])


# -- formats -----------------------------------------------------------------

def test_get_format_and_aliases():
    assert sorted(t_formats.FORMATS) == sorted(j_formats.FORMATS)
    for name, f in j_formats.FORMATS.items():
        tf = t_formats.get_format(name)
        assert dataclasses.asdict(tf) == dataclasses.asdict(f)
        for prop in ("bias", "total_bits", "max_exp_field", "sig_bits",
                     "max_finite", "min_normal"):
            assert getattr(tf, prop) == getattr(f, prop), (name, prop)
    with pytest.raises(ValueError, match="unknown float format"):
        t_formats.get_format("fp7")


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "fp16", "fp8_e4m3", "fp8_e5m2",
                                 "afp24", "afp20"])
def test_quantize_bit_exact(fmt, rng):
    x = _inputs(rng)
    want = j_formats.quantize(jnp.asarray(x), fmt)
    got = t_formats.quantize(torch.from_numpy(x), fmt)
    _assert_bits_equal(_tbits(got), _jbits(want), fmt)
    f = t_formats.get_format(fmt)
    got2 = t_formats.quantize_to_format(torch.from_numpy(x), f)
    _assert_bits_equal(_tbits(got2), _jbits(want), fmt)


@pytest.mark.parametrize("keep", [0, 3, 7, 10, 22, 23, 30])
def test_truncate_mantissa_bit_exact(keep, rng):
    x = _inputs(rng)
    want = j_formats.truncate_mantissa(jnp.asarray(x), keep)
    got = t_formats.truncate_mantissa(torch.from_numpy(x), keep)
    _assert_bits_equal(_tbits(got), _jbits(want), keep)


def test_numpy_helpers_and_torch_bitcasts(rng):
    x = _inputs(rng)
    bits = t_formats.np_f32_to_bits(x)
    np.testing.assert_array_equal(bits, j_formats.np_f32_to_bits(x))
    for name in ("bf16", "fp16", "fp8_e4m3"):
        jf, tf = j_formats.get_format(name), t_formats.get_format(name)
        vals = x.astype(np.float64)
        np.testing.assert_array_equal(t_formats.np_encode_from_value(vals, tf),
                                      j_formats.np_encode_from_value(vals, jf))
        enc = j_formats.np_encode_from_value(vals, jf)
        np.testing.assert_array_equal(t_formats.np_decode_to_value(enc, tf),
                                      j_formats.np_decode_to_value(enc, jf))
    # the int64-masked bitcasts round-trip every pattern, sign bit included
    tb = t_formats.f32_to_bits(torch.from_numpy(x))
    assert tb.dtype == torch.int64 and int(tb.min()) >= 0
    np.testing.assert_array_equal(tb.numpy(), bits)
    _assert_bits_equal(_tbits(t_formats.bits_to_f32(tb)), x.view(np.uint32), "rt")
    s, e, m = t_formats.decode_f32(torch.from_numpy(x))
    _assert_bits_equal(_tbits(t_formats.encode_f32(s, e, m)), x.view(np.uint32),
                       "decode/encode")


# -- the AFPM datapath ---------------------------------------------------------

@pytest.mark.parametrize("name", AFPM_NAMES)
def test_afpm_registry_entry_bit_exact(name, rng):
    x, y = _inputs(rng), _inputs(rng)
    jcfg = j_registry._AFPM_CONFIGS[name]
    tcfg = t_registry.afpm_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.label == jcfg.label
    want = j_afpm.afpm_mult_f32(jnp.asarray(x), jnp.asarray(y), jcfg)
    got = t_afpm.afpm_mult_f32(torch.from_numpy(x), torch.from_numpy(y), tcfg)
    _assert_bits_equal(_tbits(got), _jbits(want), name)
    # the registered function and the substrate's plain backend agree too
    reg = t_registry.get_multiplier(name)(torch.from_numpy(x), torch.from_numpy(y))
    sub = t_dispatch.multiply(torch.from_numpy(x), torch.from_numpy(y), tcfg,
                              backend="torch")
    assert torch.equal(reg.view(torch.int32), got.view(torch.int32))
    assert torch.equal(sub.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("kw", ABLATIONS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_afpm_ablation_configs_bit_exact(kw, rng):
    x, y = _inputs(rng), _inputs(rng)
    jcfg, tcfg = j_afpm.AFPMConfig(**kw), t_afpm.AFPMConfig(**kw)
    assert t_afpm.AFPMConfig(**dataclasses.asdict(jcfg)) == tcfg
    want = j_afpm.afpm_mult_f32(jnp.asarray(x), jnp.asarray(y), jcfg)
    got = t_afpm.afpm_mult_f32(torch.from_numpy(x), torch.from_numpy(y), tcfg)
    _assert_bits_equal(_tbits(got), _jbits(want), kw)


def _golden_cases():
    return json.loads(GOLDEN.read_text())["cases"]


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: c["label"])
def test_afpm_golden_vectors(case):
    cfg = t_afpm.AFPMConfig(n=case["n"], mode=case["mode"], fmt=case["fmt"])
    x = np.asarray(case["x_bits"], np.uint32).view(np.float32)
    y = np.asarray(case["y_bits"], np.uint32).view(np.float32)
    got = t_kernel.afpm_bitwise(torch.from_numpy(x), torch.from_numpy(y), cfg)
    _assert_bits_equal(_tbits(got), case["out_bits"], case["label"])


def test_afpm_broadcasts_like_jax(rng):
    x = _inputs(rng, 24).reshape(4, 6)
    y = _inputs(rng, 6)
    cfg = t_afpm.AFPMConfig(n=4)
    want = j_afpm.afpm_mult_f32(jnp.asarray(x), jnp.asarray(y), j_afpm.AFPMConfig(n=4))
    got = t_afpm.afpm_mult_f32(torch.from_numpy(x), torch.from_numpy(y), cfg)
    _assert_bits_equal(_tbits(got), _jbits(want), "broadcast")


@pytest.mark.parametrize("kw", [dict(mode="bogus"), dict(n=12), dict(n=9, fmt="bf16"),
                                dict(n=24, mode="acl"), dict(fmt="fp7"), dict(n=-1)])
def test_afpm_invalid_configs_raise_as_jax(kw):
    one = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        j_afpm.afpm_mult_f32(jnp.asarray(one), jnp.asarray(one), j_afpm.AFPMConfig(**kw))
    cfg = t_afpm.AFPMConfig(**kw)
    with pytest.raises(ValueError):
        t_afpm.afpm_mult_f32(torch.from_numpy(one), torch.from_numpy(one), cfg)
    with pytest.raises(ValueError):
        t_kernel.afpm_bitwise(torch.from_numpy(one), torch.from_numpy(one), cfg)


def test_ste_gradient_matches_jax():
    x = np.random.default_rng(7).standard_normal(32).astype(np.float32)
    y = np.random.default_rng(8).standard_normal(32).astype(np.float32)
    jcfg = j_afpm.AFPMConfig(n=5)
    gx, gy = jax.grad(lambda a, b: jnp.sum(j_afpm.afpm_mult_ste(a, b, jcfg)),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    out = t_afpm.afpm_mult_ste(tx, ty, t_afpm.AFPMConfig(n=5))
    _assert_bits_equal(_tbits(out), _jbits(j_afpm.afpm_mult_f32(x, y, jcfg)), "fwd")
    out.sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(gx))
    np.testing.assert_array_equal(ty.grad.numpy(), np.asarray(gy))


def test_ste_gradient_reduces_broadcast_operands():
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).requires_grad_()
    w = torch.randn(5, generator=torch.Generator().manual_seed(1)).requires_grad_()
    t_afpm.afpm_mult_ste(x, w, t_afpm.AFPMConfig()).sum().backward()
    assert torch.equal(x.grad, w.detach().expand(3, 5))
    assert torch.equal(w.grad, x.detach().sum(0))


# -- baselines and the exact multiplier ----------------------------------------

@pytest.mark.parametrize("name", BASELINE_NAMES)
def test_baseline_bit_exact(name, rng):
    x, y = _inputs(rng), _inputs(rng)
    want = j_registry.get_multiplier(name)(jnp.asarray(x), jnp.asarray(y))
    got = t_registry.get_multiplier(name)(torch.from_numpy(x), torch.from_numpy(y))
    _assert_bits_equal(_tbits(got), _jbits(want), name)
    # non-AFPM names take their registered function under get_elementwise
    assert t_registry.get_elementwise(name) is t_registry.get_multiplier(name)


def test_baseline_configs_round_trip_and_raise():
    for jc, tc in [(j_base.MMBSConfig(k=5), t_base.MMBSConfig(k=5)),
                   (j_base.CSSConfig(m=14), t_base.CSSConfig(m=14)),
                   (j_base.LogConfig(comp="hpc"), t_base.LogConfig(comp="hpc"))]:
        assert type(tc)(**dataclasses.asdict(jc)) == tc and tc.label == jc.label
    with pytest.raises(ValueError):
        t_base.log_mult_f32(torch.ones(2), torch.ones(2), t_base.LogConfig(comp="x"))


def test_exact_mult_normal_range_bit_exact(rng):
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-15, 15, 4096)).astype(np.float32)
    y = (rng.standard_normal(4096) * 10.0 ** rng.integers(-15, 15, 4096)).astype(np.float32)
    want = j_exact.exact_mult_f32(jnp.asarray(x), jnp.asarray(y))
    got = t_exact.exact_mult_f32(torch.from_numpy(x), torch.from_numpy(y))
    _assert_bits_equal(_tbits(got), _jbits(want), "exact")
    # the numpy oracle is a copy: equal on every input, specials included
    xi, yi = _inputs(rng), _inputs(rng)
    xb, yb = t_formats.np_f32_to_bits(xi), t_formats.np_f32_to_bits(yi)
    np.testing.assert_array_equal(t_exact.np_exact_mult_bits(xb, yb),
                                  j_exact.np_exact_mult_bits(xb, yb))
    _assert_bits_equal(t_exact.np_exact_mult_f32(x, y).view(np.uint32),
                       _jbits(want), "oracle")


def test_exact_mult_subnormals_follow_ieee_where_xla_cpu_flushes():
    """XLA on the CPU flushes subnormal fp32 products and operands to zero;
    PyTorch keeps them, as the bit-level IEEE oracle does (ROADMAP.md
    section 3).  The port agrees with the oracle."""
    x = np.array([1e-20, -1e-20, 1e-38, 2.0, 1e-45], np.float32)
    y = np.array([1e-20, 1e-20, 0.5, 1e-39, 1.0], np.float32)
    got = t_exact.exact_mult_f32(torch.from_numpy(x), torch.from_numpy(y))
    _assert_bits_equal(_tbits(got), t_exact.np_exact_mult_f32(x, y).view(np.uint32),
                       "ieee")
    jax_side = np.asarray(j_exact.exact_mult_f32(jnp.asarray(x), jnp.asarray(y)))
    assert np.all(jax_side == 0.0) and np.all(got.numpy() != 0.0)


# -- metrics -------------------------------------------------------------------

def test_metrics_match_jax(rng):
    a = rng.standard_normal(1000).astype(np.float32)
    e = a + rng.standard_normal(1000).astype(np.float32) * 1e-3
    e[::97] = 0.0
    for fn in ("mred", "nmed", "max_red"):
        assert getattr(t_metrics, fn)(torch.from_numpy(a), e) == getattr(j_metrics, fn)(a, e)
    assert t_metrics.psnr(a, e) == j_metrics.psnr(a, e)
    assert t_metrics.psnr(torch.from_numpy(a), e, peak=255.0) == j_metrics.psnr(a, e, peak=255.0)
    assert t_metrics.psnr(a, a) == float("inf")
    logits = rng.standard_normal((64, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 64)
    for k in (1, 3):
        assert t_metrics.top_k_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k) \
            == j_metrics.top_k_accuracy(logits, labels, k)


# -- registry, dispatch and the emulated numerics --------------------------------

def test_registry_names_match_jax():
    assert t_registry.available() == j_registry.available()
    assert AFPM_NAMES == sorted(j_registry._AFPM_CONFIGS)
    with pytest.raises(ValueError, match="unknown multiplier"):
        t_registry.get_multiplier("AC9-9x")


def test_multiply_broadcasts_like_jax(rng):
    cfg_j, cfg_t = j_afpm.AFPMConfig(n=4, mode="acl"), t_afpm.AFPMConfig(n=4, mode="acl")
    a = _inputs(rng, 12).reshape(3, 1, 4)
    b = _inputs(rng, 20).reshape(5, 4)
    for x, y in [(a, b), (a, np.float32(0.6)), (np.float32(-2.5), b)]:
        want = j_dispatch.multiply(jnp.asarray(x), jnp.asarray(y), cfg_j, backend="xla")
        tx = torch.from_numpy(np.asarray(x))
        ty = torch.from_numpy(np.asarray(y))
        for backend in ("auto", "torch"):
            got = t_dispatch.multiply(tx, ty, cfg_t, backend=backend)
            _assert_bits_equal(_tbits(got), _jbits(want), (x.shape, backend))
        _assert_bits_equal(_tbits(t_ops.afpm_multiply(tx, ty, cfg_t)),
                           _jbits(want), "ops")
    # a Python number is an fp32 scalar operand
    want = j_dispatch.multiply(jnp.asarray(b), jnp.float32(0.6), cfg_j, backend="xla")
    got = t_dispatch.multiply(torch.from_numpy(b), 0.6, cfg_t)
    _assert_bits_equal(_tbits(got), _jbits(want), "python scalar")


def test_multiply_backend_rules():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="hopper"):
        t_dispatch.multiply(x, x, backend="hopper")
    with pytest.raises(ValueError, match="unknown backend"):
        t_dispatch.multiply(x, x, backend="xla")
    with pytest.raises(RuntimeError):
        t_dispatch.multiply(torch.ones(3), torch.ones(4))


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing(rng):
    x = torch.from_numpy(_inputs(rng, 64))
    y = torch.from_numpy(_inputs(rng, 64))
    before = t_kernel.afpm_bitwise.launches
    out = t_kernel.afpm_bitwise(x, y, t_afpm.AFPMConfig(n=6))
    assert torch.equal(out.view(torch.int32),
                       t_kernel.afpm_bitwise_plain(x, y, t_afpm.AFPMConfig(n=6)).view(torch.int32))
    assert t_kernel.afpm_bitwise.launches == before


@pytest.mark.parametrize("name", ["AC5-5", "ACL5", "AC-fp16", "MMBS6", "exact"])
def test_apply_elementwise_matches_jax(name, rng):
    x, y = _inputs(rng, 256), _inputs(rng, 256)
    if name == "exact":   # normal range: XLA on the CPU flushes subnormals
        x, y = (rng.standard_normal((2, 256)) * 10).astype(np.float32)
    want = j_apply(jnp.asarray(x), jnp.asarray(y), name, backend="xla")
    got = t_numerics.apply_elementwise(torch.from_numpy(x), torch.from_numpy(y), name)
    _assert_bits_equal(_tbits(got), _jbits(want), name)


def _assert_ulp_close(got, want, what, ulps=64):
    """ulps of the LARGEST output magnitude: the products are bit-exact, the
    fp32 sums are taken in another order."""
    scale = np.float32(max(np.max(np.abs(want)), F32.tiny))
    worst = np.max(np.abs(np.asarray(got) - np.asarray(want)))
    assert worst <= ulps * np.spacing(scale), (what, float(worst))


@pytest.mark.parametrize("mult", ["AC5-5", "ACL5", "MMBS6"])
def test_emulated_nmatmul_matches_jax(mult, rng):
    x = rng.standard_normal((2, 5, 70)).astype(np.float32)
    w = (rng.standard_normal((70, 9)) / np.sqrt(70)).astype(np.float32)
    jcfg = JNumericsConfig(mode="emulated", multiplier=mult)
    tcfg = t_numerics.NumericsConfig(mode="emulated", multiplier=mult)
    assert dataclasses.asdict(tcfg.afpm()) == dataclasses.asdict(jcfg.afpm())
    from repro.numerics import numerics_scope as j_scope

    with j_scope(jcfg):
        want = np.asarray(j_nmatmul(jnp.asarray(x), jnp.asarray(w)))
    with t_numerics.numerics_scope(tcfg):
        got = t_numerics.nmatmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_ulp_close(got.numpy(), want, mult)


def test_afpm_matmul_emulated_matches_jax_and_elementwise_sum(rng):
    x = rng.standard_normal((3, 17, 33)).astype(np.float32)
    w = rng.standard_normal((33, 9)).astype(np.float32)
    jcfg, tcfg = j_afpm.AFPMConfig(n=5), t_afpm.AFPMConfig(n=5)
    want = np.asarray(j_afpm.afpm_matmul_emulated(x, w, jcfg, k_chunk=16))
    got = t_afpm.afpm_matmul_emulated(torch.from_numpy(x), torch.from_numpy(w), tcfg,
                                      k_chunk=16)
    _assert_ulp_close(got.numpy(), want, "k_chunk=16")
    prods = t_afpm.afpm_mult_f32(torch.from_numpy(x)[..., :, None],
                                 torch.from_numpy(w), tcfg)
    _assert_ulp_close(got.numpy(), prods.sum(-2).numpy(), "elementwise sum")
    with pytest.raises(ValueError, match="contraction"):
        t_afpm.afpm_matmul_emulated(torch.ones(2, 3), torch.ones(4, 2), tcfg)
