"""The port's segmented matmul against the JAX package's.

The same numpy inputs go through ``repro`` (JAX on the CPU, its oracle and
its Pallas kernel in interpret mode) and ``repro_torch`` (the plain
PyTorch version that CPU tensors take).  The Hopper kernel itself runs
only on an NVIDIA GPU: tests/test_torch_kernels_cuda.py holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jax_dispatch
from repro.kernels import ref as jax_ref
from repro_torch.kernels import afpm_matmul as t_kernel
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import ref as t_ref

# agreement bound: ulps of the LARGEST output magnitude, as in
# tests/test_backend_fuzz.py -- the two sides sum in different orders, so
# per-element wobble scales with the accumulated magnitude
ULP_BOUND = 64


def _assert_ulp_close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = np.float32(max(np.max(np.abs(want)), np.finfo(np.float32).tiny))
    worst = np.max(np.abs(got - want))
    assert worst <= ULP_BOUND * np.spacing(scale), (what, float(worst))


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def _split_both(vals):
    jh, jl = jax_ref.split_hi_lo_ref(jnp.asarray(vals))
    th, tl = t_ref.split_hi_lo_ref(torch.from_numpy(vals))
    return (np.asarray(jh).view(np.uint16), np.asarray(jl).view(np.uint16),
            _bits(th), _bits(tl))


def test_split_hi_lo_bit_exact_in_normal_range(rng):
    f32 = np.finfo(np.float32)
    bf16_max = np.float32(3.3895314e38)
    vals = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
        [0.0, -0.0, f32.tiny, -f32.tiny, bf16_max, -bf16_max,
         np.float32(3.39e38), f32.max, -f32.max, 1.0000001, -3.1415927],
    ]).astype(np.float32)
    jh, jl, th, tl = _split_both(vals)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tl, jl)


def test_split_hi_lo_specials(rng):
    vals = np.array([np.inf, -np.inf, np.nan], np.float32)
    jh, _, th, _ = _split_both(vals)
    np.testing.assert_array_equal(th[:2], jh[:2])     # +-inf stay +-inf
    j_hi, j_lo = (np.asarray(a, np.float32)
                  for a in jax_ref.split_hi_lo_ref(jnp.asarray(vals)))
    t_hi, t_lo = (a.float().numpy()
                  for a in t_ref.split_hi_lo_ref(torch.from_numpy(vals)))
    # NaN payloads and signs differ between the two frameworks; what must
    # agree is that hi(nan) and every lo here (inf - inf, nan) are NaN
    assert np.isnan(j_hi[2]) and np.isnan(t_hi[2])
    assert np.isnan(j_lo).all() and np.isnan(t_lo).all()


def test_split_hi_lo_subnormals_agree_in_value(rng):
    """fp32 subnormal inputs: hi is bit-exact; lo is zero on both sides,
    but XLA on the CPU flushes the subnormal residual to +0 where PyTorch
    keeps its sign (-0 for a negative residual).  Recorded in ROADMAP.md
    section 3; the values agree."""
    vals = (rng.standard_normal(512) * 1e-39).astype(np.float32)
    jh, jl, th, tl = _split_both(vals)
    np.testing.assert_array_equal(th, jh)
    j_lo = np.asarray(jax_ref.split_hi_lo_ref(jnp.asarray(vals))[1],
                      np.float32)
    t_lo = t_ref.split_hi_lo_ref(torch.from_numpy(vals))[1].float().numpy()
    np.testing.assert_array_equal(t_lo, j_lo)


SHAPES = {
    "1d": ((37,), (37, 21)),
    "2d": ((16, 32), (32, 48)),
    "batched3d": ((3, 5, 40), (40, 24)),
    "ragged": ((7, 13, 50), (50, 33)),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_port_matmul_matches_jax(passes, dtype, shape, rng):
    xs, ws = SHAPES[shape]
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(ws[0])).astype(np.float32)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)  # same bits
    else:
        xj = jnp.asarray(x)
    got = t_dispatch.matmul(xt, torch.from_numpy(w), passes, backend="torch")
    assert got.dtype == torch.float32
    want_ref = jax_ref.afpm_matmul_ref(
        xj if xj.ndim > 1 else xj[None], jnp.asarray(w), passes)
    if xj.ndim == 1:
        want_ref = want_ref[0]
    want_interp = jax_dispatch.matmul(xj, jnp.asarray(w), passes,
                                      backend="interpret")
    _assert_ulp_close(got.numpy(), want_ref, ("ref", passes, dtype, shape))
    _assert_ulp_close(got.numpy(), want_interp,
                      ("interpret", passes, dtype, shape))
    # auto on CPU tensors is the plain version, bit for bit
    auto = t_dispatch.matmul(xt, torch.from_numpy(w), passes, backend="auto")
    assert torch.equal(auto, got)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing(rng):
    x = torch.from_numpy(rng.standard_normal((4, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 8)).astype(np.float32))
    before = t_kernel.afpm_matmul.launches
    out = t_kernel.afpm_matmul(x, w, 3)
    assert torch.equal(out, t_kernel.afpm_matmul_plain(x, w, 3))
    assert t_kernel.afpm_matmul.launches == before


def test_hopper_backend_on_cpu_tensor_raises(rng):
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="hopper"):
        t_dispatch.matmul(x, w, 3, backend="hopper")
    with pytest.raises(ValueError, match="unknown backend"):
        t_dispatch.matmul(x, w, 3, backend="pallas")


def test_dispatch_input_rules(rng):
    w = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="contraction mismatch"):
        t_dispatch.matmul(torch.zeros(3, 7), w, backend="torch")
    assert t_dispatch.matmul(torch.ones(8), w, backend="torch").shape == (4,)
    assert [t_dispatch.shape_bucket(*d) for d in [(256,), (257, 3), (1025,)]] \
        == ["small", "medium", "large"]


# (K, N) of every projection the serving path gives the kernel: qwen3-4b's
# wq, wk/wv, wo, mlp.wi/wg, mlp.wo and mamba2-130m's in_proj, out_proj
SERVED_KN = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728),
             (9728, 2560), (768, 3352), (1536, 768)]
# decode (solo, engine), prefill tails, chunks, whole prompts, and more
SERVED_M = [1, 4, 8, 13, 22, 32, 40, 77, 150, 300, 2048]


@pytest.mark.parametrize("K", [0, 1, 7, 31, 32, 511, 512, 513, 768, 2500,
                               2560, 4096, 9728])
def test_kernel_chunks_depend_on_K_alone(K):
    """The canonical split of K is fixed by K: contiguous chunks of KCHUNK
    covering [0, K), and every plan either splits at exactly those points
    or walks them all in one CTA, whatever M and N are."""
    bounds = t_kernel.chunk_bounds(K)
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(b == a + t_kernel.KCHUNK for a, b in bounds[:-1])
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(len(bounds) - 1))
    for M in SERVED_M:
        for N in (5, 768, 1024, 9728):
            p = t_kernel.plan(M, K, N)
            assert p.grid[1] == (len(bounds) if p.split else 1)
            assert not p.split or len(bounds) > 1


@pytest.mark.parametrize("kn", SERVED_KN)
def test_plan_covers_every_served_shape(kn):
    K, N = kn
    for M in SERVED_M:
        p = t_kernel.plan(M, K, N)
        assert p.mt in (1, 2, 4, 8)
        gx, gy, gz = p.grid
        assert p.bn in (t_kernel.BN, t_kernel.WIDE_BN)
        assert gx * p.bn >= N > (gx - 1) * p.bn
        assert gz * 8 * p.mt >= M > (gz - 1) * 8 * p.mt
        assert max(gy, gz) <= t_kernel.MAX_GRID_YZ
        if p.split:
            assert gy * M * N * 4 <= t_kernel.MAX_SPLIT_BYTES
        if M <= 32 and K * N * 4 > 40e6:
            # the 42-100 MB projections at decode and prefill chunks give
            # two CTAs an SM or more (the 3-10 MB ones are bound by one
            # CTA's latency, not by how many run)
            assert gx * gy * gz >= 2 * t_kernel.SMS, (M, kn, p)


def test_plan_takes_wide_tiles_only_where_the_grid_fills_the_card():
    """128-column tiles (8 warps) up to 32 rows, and only where the grid
    they give still has two CTAs an SM; the 100 MB projections at decode
    take them, the 3-42 MB ones keep 64 columns."""
    for K, N in SERVED_KN:
        for M in SERVED_M:
            p = t_kernel.plan(M, K, N)
            wide_ctas = -(-N // t_kernel.WIDE_BN) * p.grid[1] * p.grid[2]
            assert (p.bn == t_kernel.WIDE_BN) == (
                p.mt <= 4 and wide_ctas >= 2 * t_kernel.SMS), (M, K, N, p)
    assert t_kernel.plan(4, 2560, 9728).bn == t_kernel.WIDE_BN
    assert t_kernel.plan(4, 9728, 2560).bn == t_kernel.WIDE_BN
    assert t_kernel.plan(4, 2560, 4096).bn == t_kernel.BN
    assert t_kernel.plan(150, 2560, 9728).bn == t_kernel.BN


def test_plan_states_its_limits():
    with pytest.raises(ValueError, match="grid"):
        t_kernel.plan(1, t_kernel.KCHUNK * t_kernel.MAX_GRID_YZ + 1, 8)
    with pytest.raises(ValueError, match="grid"):
        t_kernel.plan(t_kernel.MAX_TILE_ROWS * t_kernel.MAX_GRID_YZ + 1, 8, 8)
    with pytest.raises(ValueError, match="out of range"):
        t_kernel.plan(1, 2 ** 31, 8)
    # the largest split workspace stays within its cap; beyond it, whole mode
    p = t_kernel.plan(64, 9728 * 8, 9728)
    assert not p.split and p.grid[1] == 1
