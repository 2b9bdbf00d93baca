"""Plain reference of a dense GQA decoder with qk-norm and RoPE (qwen3).

Written from the configuration file's sizes and its ``numerics`` section
alone: it imports nothing of the program.  It recomputes, for one served
request, the logits at every position whose token was served: the prompt
as a prefill (its last position gives the first served token), then the
served tokens as decode steps (each gives the next).  The teacher-forced
positions are run layer by layer over the whole sequence, which for a
causal model is the same function, position by position, as the
program's chunked prefill and its one-token decode steps.

The arithmetic is the one the configuration states:

- activations and the K/V cache in bf16, parameters in fp32;
- every projection a product of the tier's segments, summed here in fp64
  and rounded to fp32 (the program's kernel sums in fp32: the two differ
  by the order of an fp32 sum);
- RMSNorm, attention scores, softmax and the PV sum in fp64 from bf16
  operands, rounded once: a prompt position as an online softmax over
  key blocks of ``attention_kv_chunk`` keys with the unnormalised
  probabilities rounded to bf16, a served position as a normalised
  softmax rounded to bf16;
- RoPE on split halves in fp32; the tied head at one pass, times
  ``hidden_size ** -0.5``.

``prod`` is the product: ``1`` or ``3`` passes of the segmented
multiplier (bf16 hi / lo segments, the BD term omitted), or
``"fp8_e4m3"``: both operands rounded to e4m3 with a scale per row of x
and per column of w (the control).  TF32 is off throughout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
F64 = torch.float64
BF16 = torch.bfloat16
E4M3_MAX = 448.0

__all__ = ["Reference"]


def _segments(t: torch.Tensor, lo: bool):
    hi = t.to(BF16)
    if not lo or t.dtype == BF16:
        return hi, None
    return hi, (t.to(torch.float32) - hi.to(torch.float32)).to(BF16)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 under a scale that maps each slice's largest
    magnitude (along ``dim``) to e4m3's largest, as fp64."""
    t = t.to(F64)
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F64) * scale


def product(x: torch.Tensor, w: torch.Tensor, prod) -> torch.Tensor:
    """``x (S, K) @ w (K, N)`` in the stated arithmetic -> fp32."""
    if prod == "fp8_e4m3":
        return (_fp8(x, -1) @ _fp8(w, 0)).to(torch.float32)
    passes = int(prod)
    xh, xl = _segments(x, passes >= 2)
    wh, wl = _segments(w, passes >= 3)
    xh, wh = xh.to(F64), wh.to(F64)
    out = xh @ wh
    if xl is not None:
        out += xl.to(F64) @ wh
    if wl is not None:
        out += xh @ wl.to(F64)
    return out.to(torch.float32)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F64)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F64))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (S, H, D) fp32, positions (S,) -> x rotated on split halves."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[:, None, None].to(torch.float32) * freqs
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _prompt_attention(q, k, v, n_prompt: int, kv_chunk: int):
    """Prompt rows: online softmax over key blocks of ``kv_chunk`` from
    position 0.  q (P, H, D) bf16; k, v (S, H, D) bf16 (heads repeated).
    Returns (P, H, D) fp64."""
    P, H, D = q.shape
    scale = D ** -0.5
    qpos = torch.arange(P, device=q.device)
    m = torch.full((H, P), NEG_INF, dtype=F64, device=q.device)
    l = torch.zeros((H, P), dtype=F64, device=q.device)
    o = torch.zeros((P, H, D), dtype=F64, device=q.device)
    for j0 in range(0, n_prompt, kv_chunk):
        j1 = min(j0 + kv_chunk, n_prompt)
        kb, vb = k[j0:j1], v[j0:j1]
        s = torch.einsum("qhd,khd->hqk", q.to(F64), kb.to(F64)) * scale
        kpos = torch.arange(j0, j1, device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :])[None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("hqk,khd->qhd", p.to(BF16).to(F64), vb.to(F64))
        o = o * alpha.transpose(0, 1)[..., None] + pv
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return o / l.transpose(0, 1)[..., None]


def _served_attention(q, k, v, first: int):
    """Rows ``first..`` (served tokens' decode steps): a normalised
    softmax over the keys up to each row's position.  q (R, H, D) bf16;
    k, v (S, H, D) bf16.  Returns (R, H, D) fp64."""
    R, H, D = q.shape
    S = k.shape[0]
    s = torch.einsum("qhd,khd->hqk", q.to(F64), k.to(F64)) * (D ** -0.5)
    pos = first + torch.arange(R, device=q.device)
    mask = torch.arange(S, device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p.to(BF16).to(F64), v.to(F64))


class Reference:
    """The reference over one set of weights (the run's), for one
    configuration file."""

    def __init__(self, params: dict, cfg: dict):
        self.p = params
        self.d = int(cfg["hidden_size"])
        self.H = int(cfg["num_attention_heads"])
        self.KH = int(cfg["num_key_value_heads"])
        self.hd = int(cfg["head_dim"])
        self.L = int(cfg["num_hidden_layers"])
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        num = cfg["numerics"]
        if (num["activations"], num["kv_cache"]) != ("bfloat16", "bfloat16"):
            raise ValueError("this reference states bf16 activations and "
                             "cache")
        self.kv_chunk = int(num["attention_kv_chunk"])
        self.head_passes = num["lm_head_passes"]
        if not cfg["tie_word_embeddings"]:
            raise ValueError("this reference states a tied head")
        self._table = None

    def _layer(self, i: int) -> dict:
        def take(t):
            return t[i] if isinstance(t, torch.Tensor) else {
                k: take(v) for k, v in t.items()}
        return take(self.p["seg0_p0"])

    def _head(self, h: torch.Tensor, prod) -> torch.Tensor:
        """The tied head: the table (V, d) is the product's x and the
        hidden's transpose its w, at one pass unless ``prod`` says."""
        if prod == 1:
            if self._table is None:
                self._table = self.p["embed"].to(BF16).to(F64)
            w = h.to(torch.float32).T.to(BF16).to(F64)
            out = (self._table @ w).to(torch.float32)
        else:
            out = product(self.p["embed"], h.to(torch.float32).T, prod)
        return out.T.contiguous() * (self.d ** -0.5)

    @torch.no_grad()
    def logits(self, prompt, served, prod, head_prod=None) -> torch.Tensor:
        """Logits (n, V) fp32 at the positions that produced the ``n``
        served tokens: the prompt's last and each served token's but the
        last."""
        dev = self.p["embed"].device
        prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
        served = torch.as_tensor(served, dtype=torch.long, device=dev)
        toks = torch.cat([prompt, served[:-1]])
        P, S = prompt.numel(), toks.numel()
        pos = torch.arange(S, device=dev)
        x = F.embedding(toks, self.p["embed"]).to(BF16)
        x = x * torch.tensor(self.d ** 0.5, dtype=BF16)
        H, KH, hd = self.H, self.KH, self.hd
        for i in range(self.L):
            p = self._layer(i)
            a = p["attn"]
            h = rmsnorm(x, p["ln1"]["scale"], self.eps)
            q = product(h, a["wq"], prod).reshape(S, H, hd)
            k = product(h, a["wk"], prod).reshape(S, KH, hd)
            v = product(h, a["wv"], prod).reshape(S, KH, hd)
            q = rmsnorm(q, a["q_norm"]["scale"], self.eps)
            k = rmsnorm(k, a["k_norm"]["scale"], self.eps)
            q = rope(q, pos, self.theta).to(BF16)
            k = rope(k, pos, self.theta).to(BF16)
            v = v.to(BF16)
            k = k.repeat_interleave(H // KH, dim=1)
            v = v.repeat_interleave(H // KH, dim=1)
            o = torch.cat([
                _prompt_attention(q[:P], k, v, P, self.kv_chunk),
                _served_attention(q[P:], k, v, P)])
            o = o.to(BF16).reshape(S, H * hd)
            x = x + product(o, a["wo"], prod).to(BF16)
            h = rmsnorm(x, p["ln2"]["scale"], self.eps)
            m = p["mlp"]
            u = product(h, m["wi"], prod) * F.silu(product(h, m["wg"], prod))
            x = x + product(u.to(BF16), m["wo"], prod).to(BF16)
        x = rmsnorm(x[P - 1:], self.p["final_norm"]["scale"], self.eps)
        return self._head(x, self.head_passes if head_prod is None
                          else head_prod)
