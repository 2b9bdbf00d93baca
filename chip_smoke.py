#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Three phases, each printing one line; any failed check ends the run with
a nonzero exit and no result line:

1. device: the card, its power limit, torch and the kernels' build time
   (every kernel is built from ``src/repro_torch/kernels/csrc/`` here);
2. kernel: the segmented matmul kernel against its plain PyTorch version
   at the full-width qwen3-4b projection shapes, passes 1/2/3, fp32 and
   bf16 activations, within 64 ulps of the largest output; timed with CUDA
   events (L2 flushed before every launch) beside the plain version, a
   bf16 ``torch.matmul`` yardstick and the card's bound;
3. serve: full-width qwen3-4b (36 layers, seeded random weights) served by
   the continuous-batching engine under the premium/standard/bulk tiers;
   every request completes, the kernel ran 7 x 36 times per segmented
   forward, and a standard-tier request's tokens equal a solo
   ``Session.generate`` bit for bit.

Then one JSON line on the kernels, the card's name and power limit, and
the result line.  Per-shape kernel timings go to
``chiprun_out/chip_smoke_kernels.json``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ULP_BOUND = 64
D, FF, KVD = 2560, 9728, 1024
# (K, N) of the seven projections of one qwen3-4b layer: wq, wk, wv, wo,
# mlp.wi, mlp.wg, mlp.wo
LAYER_PROJ = [(D, 4096), (D, KVD), (D, KVD), (4096, D), (D, FF), (D, FF),
              (FF, D)]
SHAPES = sorted(set(LAYER_PROJ))


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def card_peaks(name: str):
    """(bytes/s, dense bf16 FLOP/s) from NVIDIA's data sheets."""
    if "H200" in name:
        return 4.8e12, 989e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 756e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 835e12
    if "H100" in name:
        return 3.35e12, 989e12
    raise RuntimeError(f"no published peaks known for {name!r}")


def timed_ms(fn, iters: int, flush) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each one timed by
    CUDA events after an L2 flush (the serving path reads every weight
    once a forward, cold); one warmup call first."""
    import torch

    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def phase_device():
    import torch

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    print(f"[device] {torch.cuda.get_device_name(0)} | power limit "
          f"{smi('power.limit')} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | built {len(logs)} of "
          f"{len(_build.sources())} kernel libraries in {build_s:.1f} s")


def phase_kernel(peaks):
    import numpy as np
    import torch

    from repro_torch.kernels import afpm_matmul as k1

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_ulp, worst_abs, n_cases = 0.0, 0.0, 0
    cases = [((M, K), (K, N)) for K, N in SHAPES for M in (4, 32)]
    cases.append(((3, 5, 2500), (2500, 1000)))   # ragged, batched
    for xs, ws in cases:
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda") * ws[0] ** -0.5
        for xx in (x, x.to(torch.bfloat16)):
            for passes in (1, 2, 3):
                got = k1.afpm_matmul(xx, w, passes)
                want = k1.afpm_matmul_plain(xx, w, passes)
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"afpm_matmul {xs}@{ws}: bad output")
                err = (got - want).abs().max().item()
                ulp = err / float(np.spacing(np.float32(want.abs().max().item())))
                if ulp > ULP_BOUND:
                    raise AssertionError(
                        f"afpm_matmul {xs}@{ws} passes={passes} {xx.dtype}: "
                        f"{ulp:.1f} ulps of the largest output > {ULP_BOUND}")
                worst_ulp, worst_abs = max(worst_ulp, ulp), max(worst_abs, err)
                n_cases += 1

    # timing at the main path's shapes: bf16 activations (the full-width
    # model's dtype), decode M = 4 slots and prefill-chunk M = 32
    bw, flops = peaks
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    rows = []
    for K, N in SHAPES:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        wb = w.to(torch.bfloat16)
        for M in (4, 32):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            for passes in (1, 3):
                lib = lambda: [torch.matmul(x, wb) for _ in range(passes)]
                bytes_ms = (K * N * 4 + M * K * 2 + M * N * 4) / bw * 1e3
                ops_ms = 2 * passes * M * N * K / flops * 1e3
                rows.append(dict(
                    M=M, K=K, N=N, passes=passes,
                    kernel_ms=timed_ms(lambda: k1.afpm_matmul(x, w, passes), 20, flush),
                    plain_ms=timed_ms(lambda: k1.afpm_matmul_plain(x, w, passes), 10, flush),
                    library_ms=timed_ms(lib, 20, flush),
                    bytes_ms=bytes_ms, ops_ms=ops_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations"))
    # the kernels line: one decode layer of the standard tier (7 projections,
    # M = 4 slots, passes = 3)
    def layer_sum(key):
        return sum(next(r[key] for r in rows if (r["K"], r["N"]) == kn
                        and r["M"] == 4 and r["passes"] == 3)
                   for kn in LAYER_PROJ)

    layer = {k: layer_sum(k) for k in ("kernel_ms", "plain_ms", "library_ms")}
    b_ms, o_ms = layer_sum("bytes_ms"), layer_sum("ops_ms")
    layer["bound_ms"] = max(b_ms, o_ms)
    layer["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
    (ROOT / "chiprun_out" / "chip_smoke_kernels.json").write_text(
        json.dumps({"card": smi("name,power.limit"), "rows": rows}, indent=1))
    print(f"[kernel] afpm_matmul: {n_cases} cases within {ULP_BOUND} ulps "
          f"(worst {worst_ulp:.2f} ulps, {worst_abs:.3g} abs); one decode "
          f"layer (M=4, passes=3): kernel {layer['kernel_ms']:.4f} ms, plain "
          f"{layer['plain_ms']:.4f} ms, bf16 torch.matmul x3 "
          f"{layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.4f} ms")
    return dict(max_abs_err=worst_abs, max_ulp_err=worst_ulp, **layer)


def phase_serve():
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS
    from repro_torch.session import Session

    cfg = get_arch("qwen3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (36, 2560, 151936)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = Session(cfg, seed=0)
    sess.params  # seeded random init on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = sess.serving_engine(slots=4, max_len=256)
    rng = np.random.default_rng(0)
    lengths = (40, 77, 150)
    reqs = []
    for i in range(6):
        tier = DEFAULT_TIERS[i % 3].name
        plen = lengths[(i + i // 3) % 3]
        reqs.append(eng.submit(rng.integers(0, cfg.vocab, plen), tier=tier,
                               max_new_tokens=16))

    k1.afpm_matmul.launches = 0
    t0 = time.perf_counter()
    stats = eng.run()
    serve_s = time.perf_counter() - t0
    launches = k1.afpm_matmul.launches

    bad = [r.id for r in reqs if not r.done or len(r.result()) != 16]
    if bad:
        raise AssertionError(f"requests did not finish with 16 tokens: {bad}")
    segmented = [t.name for t in DEFAULT_TIERS if t.policy != "exact"]
    forwards = sum(stats[n].n_prefill_chunks + stats[n].n_decode_steps
                   for n in segmented)
    per_forward = 7 * cfg.n_layers
    if launches <= 0 or launches != per_forward * forwards:
        raise AssertionError(f"afpm_matmul launched {launches} times, "
                             f"expected {per_forward} x {forwards} segmented "
                             f"forwards")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    std = [r for r in reqs if r.tier == "standard"]
    solo_sess = sess.replace(policy="segmented3")
    for r in std:
        solo = solo_sess.generate(prompts=r.prompt[None], gen_len=16)
        if not np.array_equal(solo.tokens[0], r.result()):
            raise AssertionError(
                f"standard request {r.id}: engine {r.result().tolist()} != "
                f"solo generate {solo.tokens[0].tolist()}")
    with torch.inference_mode():
        logits, _ = transformer.prefill(
            sess.params, sess.config,
            {"tokens": torch.as_tensor(std[0].prompt[None], device="cuda")})
    if logits.shape != (1, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits bad: {tuple(logits.shape)}")

    parts = []
    for t in DEFAULT_TIERS:
        s = stats[t.name]
        dec_tokens = s.n_tokens - s.n_finished   # first tokens come from prefill
        parts.append(f"{t.name}({t.policy}) decode {dec_tokens / s.decode_s:.1f} "
                     f"tok/s {1e3 * s.decode_s / s.n_decode_steps:.1f} ms/step "
                     f"prefill {1e3 * s.prefill_s / s.n_prefill_chunks:.1f} "
                     f"ms/chunk")
    print(f"[serve] qwen3-4b full width ({cfg.param_count() / 1e9:.2f} B params, "
          f"init {init_s:.1f} s): 6 requests x 16 tokens in {serve_s:.2f} s; "
          f"{'; '.join(parts)}; afpm_matmul launches {launches} = "
          f"{per_forward} x {forwards} segmented forwards; standard tokens "
          f"== solo generate; peak memory {peak_gb:.2f} GB")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    phase_device()
    k = phase_kernel(peaks)
    launches = phase_serve()
    print(json.dumps({"kernels": [{
        "name": "afpm_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/afpm_matmul.cu",
        "replaces": "src/repro/kernels/afpm_matmul.py:94",
        "launches": launches,
        "max_abs_err": k["max_abs_err"], "max_ulp_err": k["max_ulp_err"],
        "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "library_ms": k["library_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"]}]}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
