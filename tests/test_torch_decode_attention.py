"""The decode step's attention core on the CPU: its plain chain and the
dispatch to the fused kernel (``kernels/decode_attention.py``).

``attention.decode_core_plain`` (qk-norm, RoPE, the cache write, the fp64
decode attention) is the chain that ``gqa_apply``'s decode branch ran
inline; here it and ``gqa_apply`` are held bit for bit to that former
composition, written out below, for qwen3's qk-norm at per-row and scalar
positions, gemma2's softcap and window, and qwen2-vl's M-RoPE.  The
dispatch predicate takes the kernel for qwen3-4b's layers on CUDA operands
(fake tensors: this machine has no card) and refuses M-RoPE, a DTensor,
CPU operands and steps outside the serving path's fp64 sums.  The kernel
itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""
import warnings

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import reshape
from repro_torch.kernels import decode_attention as fused
from repro_torch.models import attention, transformer
from repro_torch.models.layers import apply_rope, fp64_sums, rmsnorm
from repro_torch.numerics import layer_scope, nmatmul, numerics_scope

B, S = 3, 96

# (arch, index of the layer's spec in its pattern, per-row positions);
# gemma2's first spec is its local layer (a window of 64 at the reduced
# size, under the positions below) and both carry its softcap
CASES = {
    "qwen3-rows": ("qwen3-4b", 0, True),
    "qwen3-scalar": ("qwen3-4b", 0, False),
    "gemma2-local": ("gemma2-9b", 0, True),
    "gemma2-global": ("gemma2-9b", 1, False),
    "qwen2vl-mrope": ("qwen2-vl-72b", 0, True),
}


def _former_decode(params, x, cfg, spec, positions, cache, q_offset):
    """``gqa_apply``'s decode branch as it was, inline."""
    B_, S_, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    with layer_scope("wq"):
        q = reshape(nmatmul(x, params["wq"]), B_, S_, H, hd)
    with layer_scope("wk"):
        k = reshape(nmatmul(x, params["wk"]), B_, S_, KH, hd)
    with layer_scope("wv"):
        v = reshape(nmatmul(x, params["wv"]), B_, S_, KH, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    window = spec.window if spec.attn == "local" else None
    k_cache = attention._cache_update(cache["k"], k, q_offset)
    v_cache = attention._cache_update(cache["v"], v, q_offset)
    out = attention.decode_attention(q, k_cache, v_cache, q_offset,
                                     window=window, attn_cap=cfg.attn_softcap)
    out = reshape(out.to(x.dtype), B_, S_, H * hd)
    with layer_scope("wo"):
        return (nmatmul(out, params["wo"]).to(x.dtype),
                {"k": k_cache, "v": v_cache}, out)


def _case(name, rng, cache_dtype):
    arch, pi, rows = CASES[name]
    cfg = get_arch(arch).reduced()
    spec = cfg.segments[0][1][pi]
    params = transformer._take(transformer.init(cfg)[f"seg0_p{pi}"], 0)["attn"]
    hd = cfg.resolved_head_dim
    for norm in ("q_norm", "k_norm"):
        if norm in params:   # nonzero scales, so the norm's product counts
            params[norm] = {"scale": torch.from_numpy(
                rng.standard_normal(hd).astype(np.float32) * 0.1)}
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model))
                         .astype(np.float32)).to(transformer.torch_dtype(
                             cfg.dtype))
    cache = {n: torch.from_numpy(rng.standard_normal(
        (B, S, cfg.n_kv_heads, hd)).astype(np.float32)).to(cache_dtype)
        for n in ("k", "v")}
    if rows:   # past gemma2's reduced window of 64 for two of the rows
        pos = torch.tensor([90, 5, 70])
        positions = pos[:, None]
    else:
        pos = 41
        positions = (torch.arange(1) + pos)[None, :].expand(B, 1)
    if cfg.mrope_sections is not None:   # three streams, unequal
        positions = torch.stack([positions, positions // 2, positions + 3],
                                dim=-1)
    return cfg, spec, params, x, cache, pos, positions


def _cloned(cache):
    return {n: t.clone() for n, t in cache.items()}


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(CASES))
def test_gqa_decode_equals_the_former_composition(name, cache_dtype, rng):
    cfg, spec, params, x, cache, pos, positions = _case(
        name, rng, getattr(torch, cache_dtype))
    with torch.inference_mode(), fp64_sums(), numerics_scope(cfg.numerics):
        want, want_cache, _ = _former_decode(params, x, cfg, spec, positions,
                                             _cloned(cache), pos)
        got, got_cache = attention.gqa_apply(params, x, cfg, spec, positions,
                                             cache=_cloned(cache),
                                             q_offset=pos)
    assert torch.equal(got, want)
    for n in ("k", "v"):
        assert torch.equal(got_cache[n], want_cache[n])


@pytest.mark.parametrize("name", list(CASES))
def test_the_plain_chain_equals_the_composition_it_replaces(name, rng):
    cfg, spec, params, x, cache, pos, positions = _case(name, rng,
                                                        torch.bfloat16)
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = spec.window if spec.attn == "local" else None
    with torch.inference_mode(), fp64_sums(), numerics_scope(cfg.numerics):
        _, want_cache, want = _former_decode(params, x, cfg, spec, positions,
                                             _cloned(cache), pos)
        q = reshape(nmatmul(x, params["wq"]), B, 1, H, hd)
        k = reshape(nmatmul(x, params["wk"]), B, 1, KH, hd)
        v = reshape(nmatmul(x, params["wv"]), B, 1, KH, hd)
        got, got_cache = attention.decode_core_plain(
            params, q, k, v, _cloned(cache), cfg, window, positions, pos)
    assert got.dtype == torch.float64
    assert torch.equal(reshape(got.to(x.dtype), B, 1, H * hd), want)
    for n in ("k", "v"):
        assert torch.equal(got_cache[n], want_cache[n])
    if window is not None:   # the window masks keys of the rows past it
        assert int(pos.max()) >= window


def _fake_operands(cfg, rows=96, length=640, scalar=False):
    """qwen3-4b-shaped CUDA operands of one decode layer, as fake tensors
    (shapes, dtypes and devices only)."""
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.empty((rows, 1, H, hd), device="cuda")
    k = torch.empty((rows, 1, KH, hd), device="cuda")
    v = torch.empty((rows, 1, KH, hd), device="cuda")
    cache = {n: torch.empty((rows, length, KH, hd), dtype=torch.bfloat16,
                            device="cuda") for n in ("k", "v")}
    pos = 100 if scalar else torch.zeros(rows, dtype=torch.int64,
                                         device="cuda")
    streams = () if cfg.mrope_sections is None else (3,)
    positions = torch.zeros((rows, 1, *streams), dtype=torch.int64,
                            device="cuda")
    scales = None
    if cfg.qk_norm:
        scales = (torch.empty(hd, device="cuda"),
                  torch.empty(hd, device="cuda"))
    return q, k, v, cache, positions, pos, scales


def _takes(cfg, operands, **kw):
    q, k, v, cache, positions, pos, scales = operands
    with warnings.catch_warnings():   # a fake tensor's data_ptr() warns
        warnings.simplefilter("ignore", UserWarning)
        return attention.takes_decode_kernel(
            q, k, v, cache, cfg, positions, pos, kw.get("out", torch.bfloat16),
            scales)


@pytest.mark.parametrize("scalar", [False, True])
def test_the_dispatch_takes_the_kernel_for_qwen3s_layers(scalar):
    cfg = get_arch("qwen3-4b")
    with FakeTensorMode():
        ops = _fake_operands(cfg, scalar=scalar)
        with fp64_sums():
            assert _takes(cfg, ops)
            assert _takes(cfg, ops, out=torch.float32)
        # training and prefill keep fp32 sums: not the kernel's
        assert not _takes(cfg, ops)


def test_the_dispatch_refuses_mrope_dtensor_and_cpu(monkeypatch):
    qwen3, vl = get_arch("qwen3-4b"), get_arch("qwen2-vl-72b")
    with fp64_sums():
        with FakeTensorMode():
            assert not _takes(vl, _fake_operands(vl))
            ops = _fake_operands(qwen3)
            with monkeypatch.context() as m:   # every operand a DTensor
                m.setattr(fused, "is_dtensor", lambda x: True)
                assert not _takes(qwen3, ops)
            assert _takes(qwen3, ops)
            # a cache whose rows the kernel cannot read 16 bytes at a time
            bad = list(ops)
            bad[3] = {n: torch.empty_strided(
                c.shape, (640 * 8 * 136, 8 * 136, 136, 1),
                dtype=torch.bfloat16, device="cuda")
                for n, c in ops[3].items()}
            assert not _takes(qwen3, bad)
        q = torch.zeros((2, 1, 32, 128))
        k = torch.zeros((2, 1, 8, 128))
        cache = {n: torch.zeros((2, 8, 8, 128), dtype=torch.bfloat16)
                 for n in ("k", "v")}
        positions = torch.zeros((2, 1), dtype=torch.int64)
        assert not attention.takes_decode_kernel(
            q, k, k.clone(), cache, qwen3, positions, 0, torch.bfloat16)
        assert fused.refusal(q, k, k.clone(), cache["k"], cache["v"],
                             positions, 0, torch.bfloat16).startswith(
                                 "operands on cpu")


def test_the_wrapper_refuses_cpu_tensors():
    q = torch.zeros((2, 1, 4, 16))
    k = torch.zeros((2, 1, 2, 16))
    cache = torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16)
    positions = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fused.decode_core(q, k, k, cache, cache.clone(), 0, positions)


def test_the_group_block_divides_every_familys_group():
    # qwen3 4, gemma2 / gemma3 2, llama4 5, minitron 6, whisper / zamba2 1
    assert [fused.group_block(g) for g in (4, 2, 5, 6, 1, 8)] == \
        [4, 2, 1, 2, 1, 4]
    for arch in ("qwen3-4b", "gemma2-9b", "gemma3-12b", "minitron-8b",
                 "llama4-maverick-400b-a17b", "zamba2-7b", "whisper-tiny"):
        cfg = get_arch(arch)
        group = cfg.n_heads // cfg.n_kv_heads
        assert group % fused.group_block(group) == 0
        assert cfg.resolved_head_dim % 8 == 0 and \
            cfg.resolved_head_dim <= fused.MAX_HEAD_DIM, arch
