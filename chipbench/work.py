"""The yardstick's arithmetic: the card's peaks, K1's operations and bytes
per call, and a dense decoder's model FLOPs per token.

Peaks are NVIDIA's data sheet for the H100 SXM part (dense, no sparsity),
which assumes the full 700 W power limit; every result carries the card's
name and its ``power.limit`` beside them.
"""
from __future__ import annotations

import subprocess

__all__ = ["PEAKS", "k1_bound_s", "k1_calls", "model_flops", "peaks_for",
           "power_limit"]

#: name fragment -> (bf16 dense FLOP/s, fp32 FLOP/s outside the tensor
#: cores, HBM bytes/s)
PEAKS = {
    "H100": (989e12, 67e12, 3.35e12),
}


def peaks_for(kind: str):
    for key, val in PEAKS.items():
        if key in kind:
            return val
    raise KeyError(f"no peaks for device {kind!r}")


def power_limit() -> str:
    """``nvidia-smi``'s power limit of the card (text), or ``"unknown"``."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def projections(cfg: dict) -> list:
    """A dense GQA block's projections ``(K, N)`` in call order."""
    d, H, KH = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd, ff = cfg["head_dim"], cfg["intermediate_size"]
    return [(d, H * hd), (d, KH * hd), (d, KH * hd), (H * hd, d),
            (d, ff), (d, ff), (ff, d)]


def k1_calls(cfg: dict, rows: int, passes: int) -> list:
    """The K1 calls of one forward over ``rows`` rows: every projection of
    every layer at the tier's ``passes`` (bf16 x, fp32 w), then the tied
    head (the fp32 table as x, the rows' hidden as an fp32 w) at the
    configuration's head passes.  Each call ``(M, K, N, passes,
    x_bytes)``."""
    calls = [(rows, K, N, passes, 2) for _ in range(cfg["num_hidden_layers"])
             for K, N in projections(cfg)]
    calls.append((cfg["vocab_size"], cfg["hidden_size"], rows,
                  cfg["numerics"]["lm_head_passes"], 4))
    return calls


def k1_bound_s(call, peaks) -> float:
    """The least time of one K1 call: the larger of its operations over
    the bf16 peak (each pass one bf16 product) and its bytes (x and the
    fp32 w read once, the fp32 output written once) over the bandwidth."""
    M, K, N, passes, xb = call
    flops, _, bw = peaks
    ops = 2.0 * M * K * N * passes
    nbytes = M * K * xb + K * N * 4 + M * N * 4
    return max(ops / flops, nbytes / bw)


def model_flops(cfg: dict, n_tokens: int, ctx_sum: int) -> float:
    """Model FLOPs of ``n_tokens`` tokens whose attended positions sum to
    ``ctx_sum``: 2 x the parameters a token touches (the projections and
    the head) plus QK and PV over the context it had, counted once
    whatever the tier's passes."""
    params = sum(K * N for K, N in projections(cfg)) \
        * cfg["num_hidden_layers"] + cfg["vocab_size"] * cfg["hidden_size"]
    attn = 4.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] \
        * cfg["head_dim"]
    return 2.0 * params * n_tokens + attn * ctx_sum
