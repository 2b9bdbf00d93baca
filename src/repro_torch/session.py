"""Session facade: one spec (arch, policy, backend, device) + params.

>>> from repro_torch.session import Session
>>> s = Session("qwen3-4b", policy="segmented1", device="cpu")
>>> out = s.generate(batch=2, prompt_len=16, gen_len=8)
>>> eng = s.serving_engine(slots=4, max_len=64)

``arch`` is ``qwen3-4b`` (dense GQA) or ``mamba2-130m`` (SSD blocks, whose
every prefill runs the SSD scan kernel on the card).

``policy`` accepts a :class:`~repro_torch.core.numerics.NumericsConfig` or
a preset name (``exact`` / ``segmented1|2|3``).  Per-layer policies
(``NumericsPolicy`` objects and policy JSON files) arrive in a later slice
of the port and raise :class:`SessionError` here.

The segmented presets take ``backend="auto"``: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.  (The JAX package's
presets pin its XLA reference instead; both compute the same function
within the kernel's tolerance.)

Sessions run on ``cuda`` unless ``device="cpu"`` is passed; with no CUDA
on the host a CUDA session raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.numerics import NumericsConfig

__all__ = ["GenerateResult", "SEGMENTED_CANDIDATES", "Session",
           "SessionError"]


class SessionError(RuntimeError):
    """A session-level configuration error with a one-line message."""


SEGMENTED_CANDIDATES: Tuple[Tuple[str, NumericsConfig], ...] = (
    ("segmented-1", NumericsConfig(mode="segmented", seg_passes=1, backend="auto")),
    ("segmented-2", NumericsConfig(mode="segmented", seg_passes=2, backend="auto")),
    ("segmented-3", NumericsConfig(mode="segmented", seg_passes=3, backend="auto")),
)

# "exact" keeps the arch's own numerics (exact by default)
_PRESETS = {"exact": None,
            **{name.replace("-", ""): cfg
               for name, cfg in SEGMENTED_CANDIDATES}}

_LATER = ("per-layer numerics policies (NumericsPolicy objects and policy "
          "JSON files) arrive in a later slice of the PyTorch port")


def _coerce_numerics(policy) -> Optional[NumericsConfig]:
    """policy arg -> NumericsConfig override (None = keep the arch's own)."""
    if policy is None or isinstance(policy, NumericsConfig):
        return policy
    if isinstance(policy, str):
        if policy in _PRESETS:
            return _PRESETS[policy]
        raise SessionError(f"unknown preset {policy!r} (expected one of "
                           f"{'/'.join(_PRESETS)}); {_LATER}")
    raise SessionError(f"unsupported policy spec {policy!r}: {_LATER}")


@dataclasses.dataclass(frozen=True)
class GenerateResult:
    tokens: np.ndarray        # (batch, gen_len) int32 greedy continuations
    seconds: float
    tokens_per_s: float
    # per-row emitted-token counts (EOS included); rows that hit the EOS
    # stop token have their remaining columns pinned to eos_id
    gen_lengths: Optional[np.ndarray] = None


class Session:
    """(arch, policy, backend, device) + params: the one public spec.

    ``arch`` is an arch id from ``repro_torch.configs`` (reduced to the
    CPU-sized config unless ``reduced=False``) or a ready
    :class:`~repro_torch.configs.base.ArchConfig`.  ``params`` (a nested
    dict of tensors in the JAX package's layout, e.g. from
    :func:`repro_torch.compat.jax_params.params_from_numpy`) must live on
    ``device``; without them seeded random weights are drawn there.
    """

    def __init__(self, arch, policy=None, backend: Optional[str] = None, *,
                 seed: int = 0, reduced: bool = True, params=None,
                 device=None):
        if isinstance(arch, str):
            from repro_torch.configs import get_arch

            try:
                base = get_arch(arch)
            except ValueError as e:
                raise SessionError(str(e)) from e
            self.arch_id = arch
            self._base_cfg = base.reduced() if reduced else base
        elif isinstance(arch, ArchConfig):
            self.arch_id = arch.arch_id
            self._base_cfg = arch
        else:
            raise SessionError(f"unsupported arch spec {arch!r}: expected "
                               f"an arch id or ArchConfig")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # fp32 matmuls stand in for bf16 dots with fp32 accumulation:
            # TF32 would round their operands
            torch.backends.cuda.matmul.allow_tf32 = False
        self.backend = backend
        self.seed = seed
        self._numerics_override = _coerce_numerics(policy)
        if params is not None and params["embed"].device != self.device:
            raise SessionError(f"params live on {params['embed'].device}, "
                               f"the session on {self.device}")
        self._params = params

    # -- configuration ------------------------------------------------------

    @property
    def numerics(self) -> NumericsConfig:
        """The effective numerics (override > arch default > backend)."""
        num = (self._numerics_override
               if self._numerics_override is not None
               else self._base_cfg.numerics)
        if self.backend is not None:
            num = dataclasses.replace(num, backend=self.backend)
        return num

    @property
    def config(self) -> ArchConfig:
        """The arch config with this session's numerics applied."""
        return dataclasses.replace(self._base_cfg, numerics=self.numerics)

    def replace(self, **kw) -> "Session":
        """A new Session with fields replaced (policy/backend/seed/params/
        device); params are shared unless overridden."""
        args = dict(policy=self._numerics_override, backend=self.backend,
                    seed=self.seed, params=self._params, device=self.device)
        unknown = set(kw) - set(args)
        if unknown:
            raise SessionError(
                f"unknown Session.replace field(s) {sorted(unknown)}; "
                f"expected a subset of {sorted(args)}")
        args.update(kw)
        return Session(self._base_cfg, args["policy"], args["backend"],
                       seed=args["seed"], params=args["params"],
                       device=args["device"])

    # -- parameters ---------------------------------------------------------

    @property
    def params(self):
        """Model parameters (seeded random init on first use)."""
        if self._params is None:
            from repro_torch.models import transformer

            self._params = transformer.init(self.config, self.seed,
                                            self.device)
        return self._params

    # -- generation ---------------------------------------------------------

    @torch.inference_mode()
    def generate(self, batch: int = 4, prompt_len: int = 32,
                 gen_len: int = 16, prompts=None,
                 eos_id: Optional[int] = None) -> GenerateResult:
        """Batched prefill + greedy decode loop.

        ``prompts`` (batch, prompt_len) ints override the seeded random
        prompts.  ``eos_id`` enables stop-token handling: rows that emit
        it are finished, the loop exits once every row is, and finished
        rows' remaining columns come back pinned to ``eos_id``
        (``gen_lengths`` carries the per-row counts, EOS included).  The
        decode always advances the full batch, so a row's tokens do not
        depend on other rows finishing.
        """
        from repro_torch.models import transformer

        cfg = self.config
        params = self.params
        if prompts is None:
            rng = np.random.default_rng(self.seed)
            prompts = rng.integers(0, cfg.vocab, (batch, prompt_len))
        prompts = torch.as_tensor(np.asarray(prompts, np.int64),
                                  device=self.device)
        batch, prompt_len = prompts.shape
        max_len = prompt_len + gen_len

        t0 = time.perf_counter()
        logits, state = transformer.prefill(params, cfg, {"tokens": prompts},
                                            max_len=max_len)
        tok = logits[:, -1:].argmax(dim=-1)
        out = [tok]
        finished = (tok[:, 0].cpu().numpy() == eos_id
                    if eos_id is not None else None)
        for i in range(gen_len - 1):
            if finished is not None and finished.all():
                break
            logits, state = transformer.decode_step(
                params, cfg, {"token": tok}, state, prompt_len + i)
            tok = logits[:, -1:].argmax(dim=-1)
            out.append(tok)
            if finished is not None:
                finished = finished | (tok[:, 0].cpu().numpy() == eos_id)
        gen = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        dt = time.perf_counter() - t0
        if eos_id is None:
            return GenerateResult(tokens=gen, seconds=dt,
                                  tokens_per_s=batch * gen_len / dt,
                                  gen_lengths=np.full(batch, gen_len,
                                                      np.int64))
        emitted = gen.shape[1]
        lengths = np.full(batch, gen_len, np.int64)
        full = np.full((batch, gen_len), eos_id, np.int32)
        full[:, :emitted] = gen
        for b in range(batch):
            hits = np.nonzero(gen[b] == eos_id)[0]
            if hits.size:
                lengths[b] = hits[0] + 1
                full[b, hits[0] + 1:] = eos_id
        return GenerateResult(tokens=full, seconds=dt,
                              tokens_per_s=int(lengths.sum()) / dt,
                              gen_lengths=lengths)

    # -- serving (continuous batching) -------------------------------------

    def serving_engine(self, tiers=None, *, slots: int = 4,
                       max_len: int = 64, page_size=None, pages=None,
                       prefill_chunk=None, clock=None, aging=None):
        """A continuous-batching :class:`repro_torch.serving.Engine` over
        this session's resident weights: one paged KV pool per accuracy
        tier on the session's device.

        ``tiers`` is a sequence of :class:`repro_torch.serving.TierSpec`
        (default: the premium/standard/bulk ladder); ``page_size``
        (default 16), ``pages`` (default ``slots * ceil(max_len /
        page_size)``) and ``prefill_chunk`` (default 32) size the pool and
        the chunked prefill."""
        from repro_torch.serving import DEFAULT_TIERS, Engine

        tiers = DEFAULT_TIERS if tiers is None else tuple(tiers)
        return Engine.from_session(self, tiers, slots=slots, max_len=max_len,
                                   page_size=page_size, pages=pages,
                                   prefill_chunk=prefill_chunk,
                                   clock=clock, aging=aging)
