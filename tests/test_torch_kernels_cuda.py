"""The port's hand-written CUDA kernels against their plain versions, on
the card.

Marked ``cuda``: they skip without an NVIDIA GPU.  This file imports only
torch and numpy, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.afpm import AFPMConfig, afpm_matmul_emulated
from repro_torch.core.registry import afpm_config
from repro_torch.kernels import afpm_bitwise as k2
from repro_torch.kernels import afpm_matmul as k1
from repro_torch.kernels import dispatch
from repro_torch.kernels import ssd_scan as k3

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "afpm_golden.json"

# ulps of the largest output magnitude (as in tests/test_backend_fuzz.py):
# the kernel and the plain version sum over K in different orders
ULP_BOUND = 64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with sm_90a and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_afpm_matmul_kernel_matches_plain(passes, rng):
    _need_card()
    # zamba2-7b's projections at a 4-slot decode and a 150-token prefill;
    # whisper-tiny's encoder and cross K/V over 4 x 1500 frames, and the
    # wide projections of gemma2-9b, gemma3-12b and minitron-8b at decode
    zamba2 = [((M, K), (K, N)) for K, N in ZAMBA2_PROJ for M in (4, 150)]
    zoo = [((6000, 384), (384, 384)), ((6000, 1536), (1536, 384)),
           ((4, 3584), (3584, 14336)), ((4, 15360), (15360, 3840)),
           ((4, 4096), (4096, 16384))]
    for xs, ws in [((4, 2560), (2560, 1024)), ((32, 9728), (9728, 2560)),
                   ((3, 5, 2500), (2500, 1000)), ((1, 7), (7, 5))] + zamba2 \
            + zoo:
        x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.standard_normal(ws).astype(np.float32)).cuda()
        for xx in (x, x.to(torch.bfloat16)):
            before = k1.afpm_matmul.launches
            got = k1.afpm_matmul(xx, w, passes)
            torch.cuda.synchronize()
            assert k1.afpm_matmul.launches == before + 1
            want = k1.afpm_matmul_plain(xx, w, passes)
            scale = want.abs().max().item()
            tol = ULP_BOUND * np.spacing(np.float32(scale))
            err = (got - want).abs().max().item()
            assert got.shape == want.shape and err <= tol, (xs, xx.dtype, err)


# every M the serving path gives the kernel (decode 1 and 4, prefill tails
# 8 / 13 / 22, chunks of 32, whole prompts 40 / 77 / 150) and 300, which
# takes whole mode at (2560, 4096); every other (M, shape) is split mode.
# (9728, 2560) takes 128-column tiles up to M = 32
INVARIANCE_M = (1, 4, 8, 13, 22, 32, 40, 77, 150, 300)
# (K, N) of zamba2-7b's projections: in_proj (N 14576 = 16 x 911, ragged
# at every column tile from 32 up), out_proj, the shared block's wq / wk /
# wv / wo, wi / wg and mlp.wo
ZAMBA2_PROJ = [(3584, 14576), (7168, 3584), (3584, 3584), (3584, 14336),
               (14336, 3584)]
INVARIANCE_KN = [(2560, 4096), (2560, 1024), (9728, 2560)] + ZAMBA2_PROJ


# (K, N) of the last three families' projections: qwen2-vl-72b's MLP
# (its attention's are among them), llama4's expert slabs, attention and
# dense MLP, deepseek-v3's MLA projections (wq_a, wq_b, wkv_a, wo), expert
# slabs and dense MLP
GIANT_PROJ = [(8192, 8192), (8192, 1024), (8192, 29568), (29568, 8192),
              (5120, 8192), (8192, 5120), (5120, 5120), (5120, 1024),
              (5120, 16384), (16384, 5120), (7168, 1536), (1536, 24576),
              (7168, 576), (16384, 7168), (7168, 2048), (2048, 7168),
              (7168, 18432), (18432, 7168)]


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_afpm_matmul_kernel_at_the_giants_shapes(passes, dtype, rng):
    """The last three families' projections at M = 4 (a decode step), 16
    (an expert's rows in a 4-slot decode step: 4 slots x capacity 4) and
    32: within 64 ulps of the plain version, and every row equal to the
    same row computed alone, bit for bit."""
    _need_card()
    for K, N in GIANT_PROJ:
        x = torch.from_numpy(rng.standard_normal((32, K)).astype(np.float32)
                             ).cuda().to(getattr(torch, dtype))
        w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K))
                             .astype(np.float32)).cuda()
        alone = torch.cat([k1.afpm_matmul(x[i:i + 1], w, passes)
                           for i in range(32)])
        for M in (4, 16, 32):
            got = k1.afpm_matmul(x[:M], w, passes)
            want = k1.afpm_matmul_plain(x[:M], w, passes)
            torch.cuda.synchronize()
            tol = ULP_BOUND * np.spacing(np.float32(want.abs().max().item()))
            assert (got - want).abs().max().item() <= tol, ((K, N), M)
            same = (got.view(torch.int32) == alone[:M].view(torch.int32)).all(1)
            assert same.all(), ((K, N), M, torch.nonzero(~same).flatten()[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_afpm_matmul_kernel_rows_do_not_depend_on_M(passes, dtype, rng):
    """Every row of a call equals the same row computed alone (M = 1), bit
    for bit: the engine's batched decode and chunked prefill must give a
    solo generate's tokens."""
    _need_card()
    plans = [k1.plan(M, K, N) for K, N in INVARIANCE_KN for M in INVARIANCE_M]
    whole = [(M, K, N) for K, N in INVARIANCE_KN
             for M in INVARIANCE_M if not k1.plan(M, K, N).split]
    # both modes are exercised: qwen3-4b's shapes take whole mode only at
    # (300, 2560, 4096), zamba2-7b's at 300 and its wide ones at 77 and 150
    assert whole == [(300, 2560, 4096), (77, 3584, 14576), (150, 3584, 14576),
                     (300, 3584, 14576), (300, 7168, 3584), (300, 3584, 3584),
                     (77, 3584, 14336), (150, 3584, 14336), (300, 3584, 14336),
                     (300, 14336, 3584)], whole
    assert {p.bn for p in plans} == {k1.BN, k1.WIDE_BN}
    for K, N in INVARIANCE_KN:
        x = torch.from_numpy(rng.standard_normal((max(INVARIANCE_M), K))
                             .astype(np.float32)).cuda().to(getattr(torch, dtype))
        w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K))
                             .astype(np.float32)).cuda()
        alone = torch.cat([k1.afpm_matmul(x[i:i + 1], w, passes)
                           for i in range(x.shape[0])])
        for M in INVARIANCE_M:
            got = k1.afpm_matmul(x[:M], w, passes)
            torch.cuda.synchronize()
            same = (got.view(torch.int32) == alone[:M].view(torch.int32)).all(1)
            assert same.all(), ((K, N), M, torch.nonzero(~same).flatten()[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
def test_afpm_matmul_kernel_ragged_and_unaligned(passes, rng):
    """K not a multiple of 32 or of 4, N not a multiple of 4 or 8, and x
    and w at a storage offset of one element (base not 16-byte aligned):
    the masked path of the same kernel."""
    _need_card()

    def at_offset(a):   # a contiguous copy whose base is 4 bytes off
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")
        view = buf[1:].view(a.shape)
        view.copy_(a)
        return view

    for M in (1, 4, 13, 77):
        for K in (7, 2500):
            for N in (5, 1000, 1030):
                x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda()
                w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).cuda()
                for xx, ww in [(x, w), (at_offset(x), w), (x, at_offset(w)),
                               (at_offset(x.to(torch.bfloat16)), w)]:
                    assert xx.is_contiguous() and ww.is_contiguous()
                    got = k1.afpm_matmul(xx, ww, passes)
                    torch.cuda.synchronize()
                    _assert_within_ulps(got, k1.afpm_matmul_plain(xx, ww, passes),
                                        (M, K, N, xx.dtype, xx.storage_offset(),
                                         ww.storage_offset()))


@pytest.mark.cuda
def test_afpm_matmul_kernel_rejects_what_it_does_not_take():
    _need_card()
    x = torch.zeros(4, 8, device="cuda")
    w = torch.zeros(8, 8, device="cuda")
    with pytest.raises(TypeError):
        k1.afpm_matmul(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        k1.afpm_matmul(x, w.t())
    with pytest.raises(ValueError, match="one CUDA device"):
        k1.afpm_matmul(x, w.cpu())


def _is_nan(bits):
    return (((bits >> 23) & 0xFF) == 255) & ((bits & 0x7FFFFF) != 0)


def _assert_same_bits(got, want, what):
    """Bit for bit; NaNs by NaN-ness only."""
    g = got.cpu().numpy().view(np.uint32)
    w = want.cpu().numpy().view(np.uint32) if torch.is_tensor(want) else want
    ok = (g == w) | (_is_nan(g) & _is_nan(w))
    assert ok.all(), (what, int((~ok).sum()))


def _inputs(rng, shape):
    """fp32 over the whole exponent range, with zeros, subnormals, infs,
    NaNs and the extreme normals mixed in."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 39, n)).astype(np.float32)
    f32 = np.finfo(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                         f32.tiny, -f32.tiny, f32.max, -f32.max], np.float32)
    idx = rng.integers(0, n, n // 8)
    v[idx] = rng.choice(specials, idx.size)
    return torch.from_numpy(v.reshape(shape)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 150])
def test_afpm_matmul_kernel_every_tuner_tile_gives_the_same_bits(M, rng):
    """Every K1 tile the autotuner can choose computes the static plan's
    output bit for bit (a tile never changes an element's arithmetic)."""
    from repro_torch.kernels import autotune

    _need_card()
    for K, N in ((2560, 1024), (9728, 2560), (512, 64)):
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).cuda()
        want = k1.afpm_matmul(x, w, 3)
        for tile in autotune.candidates("matmul", "hopper", "large"):
            got = k1.afpm_matmul(x, w, 3, tile=tile)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), tile


@pytest.mark.cuda
def test_afpm_bitwise_kernel_every_tuner_block_gives_the_same_bits(rng):
    from repro_torch.kernels import autotune

    _need_card()
    cfg = afpm_config("AC5-5")
    for n in (7, 1001, 512 * 512):
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        y = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        want = k2.afpm_bitwise(x, y, cfg)
        for block in autotune.candidates("bitwise", "hopper", "large"):
            got = k2.afpm_bitwise(x, y, cfg, block)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), block
    with pytest.raises(RuntimeError, match="launch failed"):
        k2.afpm_bitwise(x, y, cfg, (512, 64))   # more threads than the kernel's


@pytest.mark.cuda
def test_afpm_bitwise_kernel_golden_vectors():
    _need_card()
    for case in json.loads(GOLDEN.read_text())["cases"]:
        cfg = AFPMConfig(n=case["n"], mode=case["mode"], fmt=case["fmt"])
        x = torch.from_numpy(np.asarray(case["x_bits"], np.uint32).view(np.float32)).cuda()
        y = torch.from_numpy(np.asarray(case["y_bits"], np.uint32).view(np.float32)).cuda()
        got = k2.afpm_bitwise(x, y, cfg)
        torch.cuda.synchronize()
        _assert_same_bits(got, np.asarray(case["out_bits"], np.uint32), case["label"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AC3-3", "AC5-5", "AC7-7", "ACL4", "ACL8",
                                  "AC-fp16", "AC-afp24", "AC-bf16"])
def test_afpm_bitwise_kernel_matches_plain(name, rng):
    _need_card()
    cfg = afpm_config(name)
    for shape in [(512, 512), (3, 1001, 7)]:
        x, y = _inputs(rng, shape), _inputs(rng, shape)
        before = k2.afpm_bitwise.launches
        got = k2.afpm_bitwise(x, y, cfg)
        torch.cuda.synchronize()
        assert k2.afpm_bitwise.launches == before + 1
        _assert_same_bits(got, k2.afpm_bitwise_plain(x, y, cfg), (name, shape))
    for kw in [dict(n=5, conditional=False), dict(n=5, skip_bd=False),
               dict(n=5, compensation=False), dict(n=11), dict(n=23, mode="acl")]:
        x, y = _inputs(rng, (4097,)), _inputs(rng, (4097,))
        _assert_same_bits(k2.afpm_bitwise(x, y, AFPMConfig(**kw)),
                          k2.afpm_bitwise_plain(x, y, AFPMConfig(**kw)), kw)


@pytest.mark.cuda
def test_afpm_bitwise_kernel_rejects_what_it_does_not_take():
    _need_card()
    x = torch.ones(4, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        k2.afpm_bitwise(x[:, ::2], x[:, ::2])
    with pytest.raises(ValueError, match="shape mismatch"):
        k2.afpm_bitwise(x, x[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        k2.afpm_bitwise(x, x.cpu())
    with pytest.raises(ValueError, match="hopper"):
        dispatch.multiply(x.cpu(), x.cpu(), backend="hopper")
    # the dispatcher broadcasts first, a 0-d scalar included, and launches
    before = k2.afpm_bitwise.launches
    got = dispatch.multiply(x, torch.tensor(3.0), backend="hopper")
    assert k2.afpm_bitwise.launches == before + 1
    _assert_same_bits(got, k2.afpm_bitwise_plain(x, torch.full_like(x, 3.0)), "0-d")


def _ssd_inputs(rng, b, L, H, P, N, strided=False):
    """fp32 SSD operands on the card; ``strided`` takes x, B, C and dt as
    slices of one fused projection, as the SSM block hands them over."""
    if strided:
        proj = rng.standard_normal((b, L, H * P + 2 * N + H)).astype(np.float32)
        proj = torch.from_numpy(proj).cuda()
        x = proj[..., :H * P].reshape(b, L, H, P)
        B = proj[..., H * P:H * P + N]
        C = proj[..., H * P + N:H * P + 2 * N]
        dt = proj[..., H * P + 2 * N:].abs() * 0.1 + 0.01
    else:
        x = torch.from_numpy(rng.standard_normal((b, L, H, P)).astype(np.float32)).cuda()
        B = torch.from_numpy(rng.standard_normal((b, L, N)).astype(np.float32)).cuda()
        C = torch.from_numpy(rng.standard_normal((b, L, N)).astype(np.float32)).cuda()
        dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, L, H)).astype(np.float32)).cuda()
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, H).astype(np.float32)).cuda()
    return x, dt, A, B, C


def _assert_within_ulps(got, want, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert got.shape == want.shape and torch.isfinite(got).all(), what
    assert err <= ULP_BOUND * np.spacing(np.float32(scale)), (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    # (batch, L, H, P, N, chunk, strided): the full-width mamba2-130m
    # prefill shapes, chunk 256, and the reduced config's shapes
    (1, 256, 24, 64, 128, 128, False),
    (4, 40, 24, 64, 128, 128, True),
    # a 77-token prompt: Q = 77, four 16-row sub-tiles and a 13-row one
    (1, 77, 24, 64, 128, 77, False),
    (1, 512, 24, 64, 128, 256, False),
    (2, 64, 16, 8, 16, 16, True),
    (1, 96, 3, 8, 4, 32, False),
    # rows of 35 floats: x and B are not 16-byte aligned, 4-byte copies
    (1, 96, 3, 8, 4, 32, True),
    # a chunk of 1024: shared memory grows by only 8 bytes a step of Q
    (1, 1024, 1, 128, 128, 1024, False),
    # zamba2-7b's prompts of 40 / 77 (padded to 128) and 150 (to 256)
    # tokens: H 112, N 64
    (4, 128, 112, 64, 64, 128, True),
    (4, 256, 112, 64, 64, 128, True),
])
def test_ssd_scan_kernel_matches_plain(dims, rng):
    _need_card()
    b, L, H, P, N, chunk, strided = dims
    x, dt, A, B, C = _ssd_inputs(rng, b, L, H, P, N, strided)
    before = k3.ssd_scan.launches
    got = k3.ssd_scan(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert k3.ssd_scan.launches == before + 1
    _assert_within_ulps(got, k3.ssd_scan_plain(x, dt, A, B, C, chunk), dims)


@pytest.mark.cuda
@pytest.mark.parametrize("L,H,N,strided", [
    # mamba2-130m's served prompt; zamba2-7b's at every served length
    (150, 24, 128, False), (40, 112, 64, True), (77, 112, 64, True),
    (150, 112, 64, True)])
def test_ssd_scan_kernel_pads_any_length_and_is_batch_invariant(L, H, N,
                                                                strided, rng):
    _need_card()
    x, dt, A, B, C = _ssd_inputs(rng, 4, L, H, 64, N, strided)
    got = dispatch.ssd(x, dt, A, B, C, chunk=128, backend="hopper")
    want = dispatch.ssd(x, dt, A, B, C, chunk=128, backend="torch")
    torch.cuda.synchronize()
    _assert_within_ulps(got, want, f"L={L} H={H} N={N} padded")
    # an element depends only on its (batch row, head): batch 1 == batch 4
    for i in range(4):
        one = dispatch.ssd(x[i], dt[i], A, B[i], C[i], chunk=128,
                           backend="hopper")
        assert torch.equal(one, got[i]), i
    assert torch.equal(dispatch.ssd(x, dt, A, B, C, chunk=128,
                                    backend="hopper"), got)   # repeatable
    # the reduced config's ragged shape: N 16, P 8, Q 16, L 50
    x, dt, A, B, C = _ssd_inputs(rng, 1, 50, 16, 8, 16)
    _assert_within_ulps(dispatch.ssd(x, dt, A, B, C, chunk=16, backend="hopper"),
                        k3.ssd_scan_plain(*_pad_dt0(x, dt, A, B, C, 64), 16)[:, :50],
                        "L=50 padded to 64")


def _pad_dt0(x, dt, A, B, C, L):
    pad = L - x.shape[1]
    f = torch.nn.functional.pad
    return (f(x, (0, 0, 0, 0, 0, pad)), f(dt, (0, 0, 0, pad)), A,
            f(B, (0, 0, 0, pad)), f(C, (0, 0, 0, pad)))


@pytest.mark.cuda
def test_ssd_scan_kernel_rejects_what_it_does_not_take(rng):
    _need_card()
    x, dt, A, B, C = _ssd_inputs(rng, 1, 32, 2, 8, 4)
    with pytest.raises(TypeError):
        k3.ssd_scan(x.to(torch.bfloat16), dt, A, B, C, 16)
    with pytest.raises(ValueError, match="one CUDA device"):
        k3.ssd_scan(x, dt, A.cpu(), B, C, 16)
    gappy = torch.zeros(1, 32, 8, device="cuda")[..., ::2]
    gappy.copy_(B)
    with pytest.raises(ValueError, match="contiguous"):
        k3.ssd_scan(x, dt, A, gappy, C, 16)
    with pytest.raises(ValueError, match="divisible"):
        k3.ssd_scan(x[:, :30], dt[:, :30], A, B[:, :30], C[:, :30], 16)
    # the kernels stage a chunk's l and dt in shared memory
    with pytest.raises(ValueError, match="shared memory"):
        k3.ssd_scan(*_ssd_inputs(rng, 1, 32768, 1, 8, 4), 32768)
    # the batch is the grid's second dimension (at most 65535 rows)
    z = torch.zeros(65536, 1, 1, 1, device="cuda")
    with pytest.raises(ValueError, match="launch limits"):
        k3.ssd_scan(z, z[..., 0], A[:1], z[..., 0], z[..., 0], 16)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2, 3, 16, 17])
def test_ssd_scan_kernel_chunk_counts_at_full_width(chunks, rng):
    """mamba2-130m's full width (H 24, P 64, N 128, Q 128) with one chunk
    (no carry, no state), two, three, 16 (L 2048) and 17."""
    _need_card()
    x, dt, A, B, C = _ssd_inputs(rng, 1, 128 * chunks, 24, 64, 128)
    got = k3.ssd_scan(x, dt, A, B, C, 128)
    torch.cuda.synchronize()
    _assert_within_ulps(got, k3.ssd_scan_plain(x, dt, A, B, C, 128),
                        f"{chunks} chunks")


@pytest.mark.cuda
def test_ssd_scan_kernel_takes_the_large_chunk_row(rng):
    """L 2048 falls in the ``large`` row of SCAN_CHUNKS: Q 256."""
    _need_card()
    assert dispatch.scan_chunk("hopper", 2048) == 256
    x, dt, A, B, C = _ssd_inputs(rng, 1, 2048, 24, 64, 128)
    got = dispatch.ssd(x, dt, A, B, C, backend="hopper")
    torch.cuda.synchronize()
    _assert_within_ulps(got, k3.ssd_scan_plain(x, dt, A, B, C, 256), "Q 256")


@pytest.mark.cuda
def test_ssd_scan_kernel_is_deterministic_and_batch_invariant_at_2048(rng):
    """No float is summed by atomics, so two calls give the same bits; an
    element depends only on its (batch row, head), so batch 1 == batch 4
    row by row."""
    _need_card()
    x, dt, A, B, C = _ssd_inputs(rng, 4, 2048, 24, 64, 128)
    got = k3.ssd_scan(x, dt, A, B, C, 128)
    assert torch.equal(k3.ssd_scan(x, dt, A, B, C, 128), got)
    for i in range(4):
        one = k3.ssd_scan(x[i:i + 1], dt[i:i + 1], A, B[i:i + 1], C[i:i + 1],
                          128)
        assert torch.equal(one[0], got[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 2, 3])
def test_segmented_matmul_grad_runs_the_kernel(passes, rng):
    """Under autograd the forward is still K1 (one launch, the kernel's
    bits), and the gradients equal the plain route's autograd within one
    bf16 ulp of the largest (both round each product's cotangent to bf16;
    the kernel's fp32 sum order can flip a rounding downstream)."""
    _need_card()
    from repro_torch.kernels import autograd

    x = torch.from_numpy(rng.standard_normal((3, 40, 2560))
                         .astype(np.float32)).cuda()
    w = torch.from_numpy((rng.standard_normal((2560, 1024)) * 0.02)
                         .astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((3, 40, 1024))
                         .astype(np.float32)).cuda()
    grads = {}
    for backend in ("hopper", "torch"):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = k1.afpm_matmul.launches
        out = dispatch.matmul(xx, ww, passes, backend=backend)
        assert k1.afpm_matmul.launches == before + (backend == "hopper")
        if backend == "hopper":
            assert out.grad_fn is not None
            torch.testing.assert_close(out, k1.afpm_matmul(x, w, passes),
                                       rtol=0, atol=0)
        (out * g).sum().backward()
        grads[backend] = (xx.grad, ww.grad)
    for a, b in zip(grads["hopper"], grads["torch"]):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 2.0 ** -8


@pytest.mark.cuda
def test_ssd_scan_grad_runs_the_kernel(rng):
    """K3 forward under autograd, gradients as the plain route's autograd
    of the chunked version within 1e-5 of the largest (fp32 throughout)."""
    _need_card()
    L, H, P, N = 150, 24, 64, 128
    ins = [rng.standard_normal((2, L, H, P)), rng.uniform(0.01, 0.2, (2, L, H)),
           -rng.uniform(1.0, 16.0, (H,)), rng.standard_normal((2, L, N)),
           rng.standard_normal((2, L, N))]
    ins = [torch.from_numpy(np.asarray(t, np.float32)).cuda() for t in ins]
    g = torch.from_numpy(rng.standard_normal((2, L, H, P))
                         .astype(np.float32)).cuda()
    grads = {}
    for backend in ("hopper", "torch"):
        ts = [t.clone().requires_grad_(True) for t in ins]
        before = k3.ssd_scan.launches
        y = dispatch.ssd(*ts, backend=backend)
        assert k3.ssd_scan.launches == before + (backend == "hopper")
        (y * g).sum().backward()
        grads[backend] = [t.grad for t in ts]
    for a, b in zip(grads["hopper"], grads["torch"]):
        assert torch.isfinite(a).all()
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-5


# ResNet-18's 21 matmuls (CIFAR 32 x 32, im2col): (rows an image, K, N)
RESNET_MATMULS = ([(1024, 27, 64)] + [(1024, 576, 64)] * 4
                  + [(256, 576, 128), (256, 1152, 128), (256, 64, 128)]
                  + [(256, 1152, 128)] * 2
                  + [(64, 1152, 256), (64, 2304, 256), (64, 128, 256)]
                  + [(64, 2304, 256)] * 2
                  + [(16, 2304, 512), (16, 4608, 512), (16, 256, 512)]
                  + [(16, 4608, 512)] * 2 + [(1, 512, 10)])
EMULATED_DESIGNS = ["AC4-4", "AC5-5", "AC6-6", "ACL5"]


def _emulated_operands(rng, M, K, N):
    """ReLU'd activations (half zeros, as im2col of a ReLU output) and
    weights of scale 1/sqrt(K), on the card."""
    x = np.maximum(rng.standard_normal((M, K)), 0).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(max(K, 1))).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AC3-3", "AC4-4", "AC5-5", "AC6-6", "AC7-7",
                                  "ACL4", "ACL5", "ACL8", "AC-fp16",
                                  "AC-afp24", "AC-bf16", "conditional=False",
                                  "skip_bd=False", "compensation=False",
                                  "n=11", "n=23,acl"])
def test_emulated_matmul_k1_equals_afpm_bitwise(name, rng):
    """A K = 1 emulated matmul (one chunk) is +0 plus the elementwise
    product of the broadcast operands, bit for bit, specials included."""
    _need_card()
    kw = {"conditional=False": dict(n=5, conditional=False),
          "skip_bd=False": dict(n=5, skip_bd=False),
          "compensation=False": dict(n=5, compensation=False),
          "n=11": dict(n=11), "n=23,acl": dict(n=23, mode="acl")}
    cfg = AFPMConfig(**kw[name]) if name in kw else afpm_config(name)
    x, w = _inputs(rng, (300, 1)), _inputs(rng, (1, 257))
    before = k2.emulated_matmul.launches
    got = k2.emulated_matmul(x, w, cfg)
    torch.cuda.synchronize()
    assert k2.emulated_matmul.launches == before + 1
    prod = k2.afpm_bitwise(x.expand(300, 257).contiguous(),
                           w.expand(300, 257).contiguous(), cfg)
    _assert_same_bits(got, torch.zeros_like(prod) + prod, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EMULATED_DESIGNS)
def test_emulated_matmul_matches_plain(name, rng):
    """Every ResNet-18 matmul shape at batch 8, ragged shapes, k_chunk 16
    and 64 and leading batch dims, within 64 ulps of the plain version's
    largest output (the plain version sums a chunk in torch.sum's order)."""
    _need_card()
    cfg = afpm_config(name)
    shapes = [((8 * r, K), (K, N), 64) for r, K, N in sorted(set(RESNET_MATMULS))]
    shapes += [((77, 1001), (1001, 93), 16), ((1, 27), (27, 10), 64),
               ((130, 200), (200, 65), 16), ((2, 3, 50, 130), (130, 70), 64),
               ((5, 4608), (4608, 3), 16)]
    for xs, ws, kc in shapes:
        x, w = _emulated_operands(rng, int(np.prod(xs[:-1])), xs[-1], ws[1])
        x = x.reshape(xs)
        got = k2.emulated_matmul(x, w, cfg, kc)
        want = afpm_matmul_emulated(x, w, cfg, kc)
        _assert_within_ulps(got, want, (name, xs, ws, kc))


@pytest.mark.cuda
def test_emulated_matmul_specials_in_k(rng):
    """inf, NaN and zeros inside a longer K: the same NaN and inf
    positions and signs as the plain version (IEEE sums give them in any
    order), the finite outputs within 64 ulps."""
    _need_card()
    cfg = afpm_config("AC5-5")
    x, w = _inputs(rng, (40, 90)), _inputs(rng, (90, 33))
    x = torch.where(x.abs() > 1e3, torch.ones_like(x), x)
    w = torch.where(w.abs() > 1e3, torch.full_like(w, 2.0), w)
    x[3, 5], w[7, 2], x[8, 9] = float("inf"), float("-inf"), float("nan")
    got = k2.emulated_matmul(x, w, cfg, 16)
    want = afpm_matmul_emulated(x, w, cfg, 16)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    fin = want.isfinite()
    _assert_within_ulps(got[fin], want[fin], "finite")


# (K, N, k_chunk) of the M-invariance checks: the plan splits the first two
# at M < 300 and not at M = 300, so split-mode rows are held against
# whole-mode rows; the third (stage 3's conv2) splits at every M
EMU_INVARIANCE_KN = [(576, 1600, 64), (1001, 1600, 16), (4608, 512, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", EMULATED_DESIGNS)
def test_emulated_matmul_rows_do_not_depend_on_M(name, rng):
    """Every row of a call equals the same row computed at any other M, bit
    for bit, split-mode rows against whole-mode rows among them."""
    _need_card()
    cfg = afpm_config(name)
    modes = set()
    for K, N, kc in EMU_INVARIANCE_KN:
        x, w = _emulated_operands(rng, 300, K, N)
        full = k2.emulated_matmul(x, w, cfg, kc)
        modes.add(k2.plan(300, K, N, kc).split)
        for M in (1, 2, 7, 13, 64, 65, 128, 150, 200, 299):
            modes.add(k2.plan(M, K, N, kc).split)
            _assert_same_bits(k2.emulated_matmul(x[:M].contiguous(), w, cfg, kc),
                              full[:M], (name, K, N, kc, M))
    assert modes == {True, False}


@pytest.mark.cuda
@pytest.mark.parametrize("name", EMULATED_DESIGNS)
def test_emulated_matmul_split_equals_whole_and_repeats(name, rng):
    """Two calls give the same bits, in split mode (the tile's last CTA
    folds the workspace) and in whole mode; a split call's rows equal a
    whole call's (the M-invariance test holds every row)."""
    _need_card()
    cfg = afpm_config(name)
    x, w = _emulated_operands(rng, 300, 576, 1600)
    whole = k2.emulated_matmul(x, w, cfg)
    split = k2.emulated_matmul(x[:200].contiguous(), w, cfg)
    assert k2.plan(200, 576, 1600).split and not k2.plan(300, 576, 1600).split
    _assert_same_bits(split, whole[:200], (name, "split vs whole"))
    for M, K, N, kc in [(128, 4608, 512, 64), (8, 512, 10, 64),
                        (300, 1000, 70, 16), (300, 576, 1600, 64)]:
        x, w = _emulated_operands(rng, M, K, N)
        a = k2.emulated_matmul(x, w, cfg, kc)
        b = k2.emulated_matmul(x, w, cfg, kc)
        _assert_same_bits(a, b, (name, M, K, N, "two calls"))


@pytest.mark.cuda
def test_emulated_matmul_rejects_what_it_does_not_take():
    _need_card()
    x = torch.ones(4, 8, device="cuda")
    w = torch.ones(8, 6, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        k2.emulated_matmul(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match="one CUDA device"):
        k2.emulated_matmul(x, w.cpu())
    with pytest.raises(ValueError, match="x \\(..., K\\) @ w"):
        k2.emulated_matmul(x, w[:5])
    with pytest.raises(ValueError, match="k_chunk"):
        k2.emulated_matmul(x, w, AFPMConfig(), 0)
    with pytest.raises(ValueError, match="too narrow"):
        k2.emulated_matmul(x, w, AFPMConfig(n=12))
    with pytest.raises(ValueError, match="hopper"):
        dispatch.emulated_matmul(x.cpu(), w.cpu(), backend="hopper")
    # K = 0: the empty sum, +0, from one launch
    before = k2.emulated_matmul.launches
    z = k2.emulated_matmul(x[:, :0].contiguous(), w[:0].contiguous())
    assert k2.emulated_matmul.launches == before + 1
    assert z.shape == (4, 6) and (z.view(torch.int32) == 0).all()


@pytest.mark.cuda
def test_emulated_matmul_grad_runs_the_kernel(rng):
    """Under autograd the forward is still the kernel (one launch, its
    bits); the straight-through gradients equal the plain route's within
    1e-5 of each input's largest gradient."""
    _need_card()
    cfg = afpm_config("AC5-5")
    x, w = _emulated_operands(rng, 2 * 64, 1152, 256)
    x = x.reshape(2, 64, 1152)
    g = torch.from_numpy(rng.standard_normal((2, 64, 256))
                         .astype(np.float32)).cuda()
    grads = {}
    for backend in ("hopper", "torch"):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = k2.emulated_matmul.launches
        out = dispatch.emulated_matmul(xx, ww, cfg, backend=backend)
        assert k2.emulated_matmul.launches == before + (backend == "hopper")
        if backend == "hopper":
            assert out.grad_fn is not None
            _assert_same_bits(out.detach(), k2.emulated_matmul(x, w, cfg), "fwd")
        (out * g).sum().backward()
        grads[backend] = (xx.grad, ww.grad)
    for a, b in zip(grads["hopper"], grads["torch"]):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AC-fp16", "AC-bf16", "AC-afp24"])
def test_nmatmul_ac_fmt_runs_the_kernel(name, rng):
    """An emulated AC-<fmt> matmul runs the kernel once, at the registry
    entry's storage format, within 64 ulps of the registry's plain route,
    and carries no gradient (as that route)."""
    _need_card()
    from repro_torch.core.afpm import chunked_emulated_matmul
    from repro_torch.core.registry import get_multiplier
    from repro_torch.numerics import NumericsConfig, nmatmul, numerics_scope

    x, w = _emulated_operands(rng, 96, 200, 48)
    before = k2.emulated_matmul.launches
    with numerics_scope(NumericsConfig(mode="emulated", multiplier=name)):
        got = nmatmul(x.clone().requires_grad_(True), w)
    assert k2.emulated_matmul.launches == before + 1
    assert got.grad_fn is None
    _assert_within_ulps(got, chunked_emulated_matmul(x, w, get_multiplier(name)),
                        name)
    _assert_same_bits(got, k2.emulated_matmul(x, w, afpm_config(name)), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["AC5-5", "ACL5", "AC-fp16", "AC-bf16"])
def test_afpm_bitwise_kernel_vector_and_scalar_paths(name, rng):
    """The elementwise entry's 16-byte loop, its tail and its scalar loop
    (pointers off 16-byte alignment) all give the plain version's bits."""
    _need_card()
    cfg = afpm_config(name)
    x, y = _inputs(rng, (4099,)), _inputs(rng, (4099,))
    for off, n in [(0, 4099), (0, 4096), (1, 4098), (2, 4097), (3, 5), (0, 3)]:
        xs, ys = x[off:off + n], y[off:off + n]
        _assert_same_bits(k2.afpm_bitwise(xs, ys, cfg),
                          k2.afpm_bitwise_plain(xs, ys, cfg), (name, off, n))


@pytest.mark.cuda
def test_one_rank_nccl_expert_parallel_decode_equals_group_local(tmp_path, rng):
    """MoE's expert-parallel path on a one-rank NCCL group ((1, 1) mesh):
    a 4-slot decode step under segmented3 runs K1 on every local expert
    (4 rows an expert, 16 group-local), and its output equals the
    group-local path's bit for bit (K1's rows do not depend on M)."""
    _need_card()
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import rules_for, use_mesh_rules
    from repro_torch.launch.mesh import init_ranks, make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models.layers import fp64_sums
    from repro_torch.numerics import NumericsConfig

    base = get_arch("deepseek-v3-671b").reduced()
    E, D, F = 16, 256, 512
    cfg = dataclasses.replace(base, d_model=D, d_ff=F, moe=dataclasses.replace(
        base.moe, n_experts=E, top_k=4, n_shared=1))
    shapes = {"router": (D, E), "wi": (E, D, F), "wg": (E, D, F),
              "wo": (E, F, D)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  * s[-2] ** -0.5).cuda()
              for k, s in shapes.items()}
    params["shared"] = {k: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32) * s[0] ** -0.5).cuda() for k, s in (
        ("wi", (D, F)), ("wg", (D, F)), ("wo", (F, D)))}
    x = torch.from_numpy(rng.standard_normal((4, 1, D)).astype(
        np.float32)).cuda()
    seg3 = NumericsConfig(mode="segmented", seg_passes=3)
    with fp64_sums():   # a decode step's router
        want = moe.moe_apply(params, x, cfg, seg3)
    init_ranks("cuda", init_method=f"file://{tmp_path}/store")
    try:
        mesh = make_test_mesh((1, 1), device="cuda")
        before = k1.afpm_matmul.launches
        with use_mesh_rules(mesh, rules_for(cfg, "serve")), fp64_sums(), \
                collectives.count_collectives() as stats:
            got = moe.moe_apply(params, x, cfg, seg3)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert k1.afpm_matmul.launches - before == 3 * E + 3
    assert stats.by_kind["all-to-all"] == 2 * E * 4 * D * 4
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_exact_tier_and_tied_head_run_k1_rows_invariant(rng):
    """On the card the exact tier's product is K1 at one pass, one launch,
    equal to segmented1 bit for bit; and a tied LM head (the table as K1's
    x) gives a token the same logits at 1, 4 and 32 tokens."""
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.core.numerics import NumericsConfig
    from repro_torch.models import transformer
    from repro_torch.numerics import nmatmul, numerics_scope

    x = torch.from_numpy(rng.standard_normal((32, 2560)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((2560, 1024)).astype(
        np.float32)).cuda()
    out = {}
    seg1 = NumericsConfig(mode="segmented", seg_passes=1)
    for name, cfg in (("exact", NumericsConfig(mode="exact")), ("seg1", seg1)):
        before = k1.afpm_matmul.launches
        with numerics_scope(cfg):
            out[name] = nmatmul(x, w)
        assert k1.afpm_matmul.launches == before + 1
    assert torch.equal(out["exact"], out["seg1"])
    cfg = get_arch("qwen3-4b").reduced()
    assert cfg.tie_embeddings
    params = transformer.init(cfg, seed=0, device="cuda")
    h = torch.from_numpy(rng.standard_normal((1, 32, cfg.d_model)).astype(
        np.float32)).cuda()
    full = transformer.logits_fn(params, cfg, h)
    for m in (1, 4):
        assert torch.equal(transformer.logits_fn(params, cfg, h[:, :m]),
                           full[:, :m])


# --- the decode step's fused attention core (kernels/decode_attention.py) --

def _decode_inputs(rng, B, S, H, KH, D, pos, *, cache_dtype=torch.bfloat16,
                   norm=True):
    """A decode layer's q, k, v (as K1 returns them), its cache (random
    rows, so masked keys would show if read), norm scales and positions."""
    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    q, k, v = f32(B, 1, H, D), f32(B, 1, KH, D), f32(B, 1, KH, D)
    cache = {n: f32(B, S, KH, D).to(cache_dtype) for n in ("k", "v")}
    scales = (f32(D, scale=0.1), f32(D, scale=0.1)) if norm else None
    if isinstance(pos, int):
        positions = (torch.arange(1, device="cuda") + pos)[None].expand(B, 1)
    else:
        pos = torch.as_tensor(pos, dtype=torch.int64, device="cuda")
        positions = pos[:, None]
    return q, k, v, cache, scales, pos, positions


def _plain_cfg(norm, cap=None, theta=1e6):
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("qwen3-4b"), qk_norm=norm,
                               attn_softcap=cap, rope_theta=theta)


def _decode_both(q, k, v, cache, scales, pos, positions, *, window=None,
                 cap=None, out_dtype=torch.bfloat16):
    """The kernel and its plain chain on the same inputs, each on its own
    copy of the cache: (kernel out, kernel cache, plain out rounded as the
    caller rounds it, plain cache)."""
    from repro_torch.kernels import decode_attention as fused
    from repro_torch.models import attention
    from repro_torch.models.layers import fp64_sums

    cfg = _plain_cfg(scales is not None, cap)
    params = ({} if scales is None else
              {"q_norm": {"scale": scales[0]}, "k_norm": {"scale": scales[1]}})
    kc = {n: t.clone() for n, t in cache.items()}
    pc = {n: t.clone() for n, t in cache.items()}
    before = fused.decode_core.launches
    got = fused.decode_core(q, k, v, kc["k"], kc["v"], pos, positions,
                            scales=scales, eps=cfg.norm_eps,
                            theta=cfg.rope_theta, window=window, cap=cap,
                            out_dtype=out_dtype)
    assert fused.decode_core.launches == before + 1
    with fp64_sums():
        want, _ = attention.decode_core_plain(params, q, k, v, pc, cfg,
                                              window, positions, pos)
    torch.cuda.synchronize()
    return got, kc, want.to(out_dtype), pc


def _ties(got, want):
    """(elements that differ, their largest distance in ulps of the dtype).

    Tolerance: the kernel and the plain chain sum every dot, norm and
    softmax in fp64, in different orders, so their sums lie a few fp64
    ulps apart; a rounding to fp32 or bf16 can then flip only where the
    exact value sits that close to a rounding boundary (about 2**-40 of
    the cases for a bf16 rounding).  Such a tie moves its element by one
    ulp, and ties are counted, not hidden: at most 1 in 10**4 elements
    (and 2 in any call) may be one."""
    width = {torch.float32: 32, torch.bfloat16: 16}[want.dtype]
    it = {32: torch.int32, 16: torch.int16}[width]

    def ordered(t):
        b = t.contiguous().view(it).to(torch.int64)
        mag = b & ((1 << (width - 1)) - 1)
        return torch.where(b < 0, -mag, mag)

    gap = (ordered(got) - ordered(want)).abs()
    return int((gap > 0).sum()), int(gap.max())


def _assert_ties(got, want, what):
    n, worst = _ties(got, want)
    assert torch.isfinite(got.float()).all(), what
    assert worst <= 1 and n <= max(2, got.numel() // 10 ** 4), \
        (what, n, worst)


# (B, S, H, KH, D, positions, norm, window, cap, cache dtype, out dtype):
# qwen3-4b at batch-short's fill (96 rows of a 640 view, rows at their own
# positions) and lockstep; gemma2's heads with a window and a softcap;
# zamba2's shared block (112-wide heads, no qk-norm); llama4's group of
# 5; fp32 caches and outputs (the reduced configs); a 4096 cache, whose
# scores take the scratch buffer
DECODE_CASES = {
    "qwen3-batch-short": (96, 640, 32, 8, 128, "rows", True, None, None,
                          "bfloat16", "bfloat16"),
    "qwen3-lockstep": (4, 256, 32, 8, 128, 200, True, None, None,
                       "bfloat16", "bfloat16"),
    "gemma2-window-cap": (4, 512, 16, 8, 256, "rows", False, 100, 50.0,
                          "bfloat16", "bfloat16"),
    "zamba2-shared": (4, 256, 32, 32, 112, "rows", False, None, None,
                      "bfloat16", "bfloat16"),
    "llama4-group5": (4, 256, 40, 8, 128, "rows", False, None, None,
                      "bfloat16", "bfloat16"),
    "fp32-cache": (4, 256, 4, 4, 16, "rows", True, None, None, "float32",
                   "float32"),
    "long-4096": (4, 4096, 32, 8, 128, "rows", True, None, None, "bfloat16",
                  "bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_kernel_matches_its_plain_chain(case, rng):
    """The kernel against ``attention.decode_core_plain`` on the same
    inputs: the cache rows it writes and its outputs are equal but for
    counted ties (``_ties``), and it writes nothing but row ``pos``."""
    _need_card()
    B, S, H, KH, D, where, norm, window, cap, cdt, odt = DECODE_CASES[case]
    pos = (rng.integers(0, S, B).tolist() if where == "rows" else where)
    ins = _decode_inputs(rng, B, S, H, KH, D, pos, norm=norm,
                         cache_dtype=getattr(torch, cdt))
    got, kc, want, pc = _decode_both(*ins, window=window, cap=cap,
                                     out_dtype=getattr(torch, odt))
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_ties(got, want, (case, "out"))
    cache, p = ins[3], ins[5]
    rows = torch.arange(B, device="cuda")
    for n in ("k", "v"):
        _assert_ties(kc[n][rows, p], pc[n][rows, p], (case, n))
        kept = torch.ones(B, S, dtype=torch.bool, device="cuda")
        kept[rows, p] = False
        assert torch.equal(kc[n][kept], cache[n][kept]), (case, n)


@pytest.mark.cuda
def test_decode_attention_kernel_rows_do_not_depend_on_the_batch_or_view(rng):
    """A row's output and cache row are the same bits alone and among 96
    rows, in a 640-position view and a 4096 one (its keys past ``pos``
    random), and a scalar position equals the same position per row."""
    _need_card()
    from repro_torch.kernels import decode_attention as fused

    B, S, H, KH, D = 96, 640, 32, 8, 128
    q, k, v, cache, scales, pos, positions = _decode_inputs(
        rng, B, S, H, KH, D, rng.integers(0, S, B).tolist())

    def run(rows, length, p, pp):
        kc = {n: t[rows].clone() for n, t in cache.items()}
        if length > S:
            pad = torch.randn((len(rows), length - S, KH, D), device="cuda")
            kc = {n: torch.cat([t, pad.to(t.dtype)], 1) for n, t in kc.items()}
        out = fused.decode_core(q[rows], k[rows], v[rows], kc["k"], kc["v"],
                                p, pp, scales=scales, theta=1e6)
        return out, kc

    full, fc = run(list(range(B)), S, pos, positions)
    for r in (0, 37, 95):
        for length in (S, 4096):
            one, oc = run([r], length, pos[r:r + 1], positions[r:r + 1])
            assert torch.equal(one[0], full[r]), (r, length)
            for n in ("k", "v"):
                assert torch.equal(oc[n][0, pos[r]], fc[n][r, pos[r]])
    # lockstep: one position for every row, as a scalar or per row
    same = torch.full((8,), 300, dtype=torch.int64, device="cuda")
    rows = list(range(8))
    a, _ = run(rows, S, 300, same[:, None])
    b, _ = run(rows, S, same, same[:, None])
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_decode_attention_kernel_rejects_what_it_does_not_take(rng):
    _need_card()
    from repro_torch.kernels import decode_attention as fused

    q, k, v, cache, scales, pos, positions = _decode_inputs(
        rng, 4, 64, 8, 2, 128, [1, 2, 3, 4])

    def call(**kw):
        a = dict(q=q, k=k, v=v, k_cache=cache["k"], v_cache=cache["v"],
                 pos=pos, positions=positions)
        a.update(kw)
        return fused.decode_core(a["q"], a["k"], a["v"], a["k_cache"],
                                 a["v_cache"], a["pos"], a["positions"],
                                 scales=scales)

    with pytest.raises(ValueError, match="not on a CUDA device"):
        call(q=q.cpu(), k=k.cpu(), v=v.cpu(), k_cache=cache["k"].cpu(),
             v_cache=cache["v"].cpu(), pos=pos.cpu(), positions=positions.cpu())
    with pytest.raises(ValueError, match="fp32"):
        call(q=q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        call(k_cache=cache["k"].half(), v_cache=cache["v"].half())
    with pytest.raises(ValueError, match="contiguous"):
        call(k_cache=cache["k"].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="outside a cache"):
        call(pos=64, positions=positions)


@pytest.mark.cuda
def test_decode_steps_take_the_kernel_where_their_features_allow(rng):
    """qwen3's reduced decode step launches the kernel once a layer and
    gives the plain chain's greedy tokens; qwen2-vl's (M-RoPE) launches it
    never."""
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as fused
    from repro_torch.models import attention, transformer

    for arch, per_step in (("qwen3-4b", 2), ("qwen2-vl-72b", 0)):
        cfg = get_arch(arch).reduced()
        params = transformer.init(cfg, seed=0, device="cuda")
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 12))).cuda()
        logits = {}
        for take in (True, False):
            with torch.inference_mode():
                _, state = transformer.prefill(params, cfg,
                                               {"tokens": tok[:, :8]},
                                               max_len=16)
                before = fused.decode_core.launches
                orig = attention.takes_decode_kernel
                if not take:
                    attention.takes_decode_kernel = lambda *a, **k: False
                try:
                    out = []
                    for t in range(8, 12):
                        lg, state = transformer.decode_step(
                            params, cfg, {"token": tok[:, t:t + 1]}, state, t)
                        out.append(lg)
                finally:
                    attention.takes_decode_kernel = orig
                got = fused.decode_core.launches - before
            assert got == (4 * per_step if take else 0), (arch, take, got)
            logits[take] = torch.cat(out, 1)
        assert torch.equal(logits[True].argmax(-1), logits[False].argmax(-1))
