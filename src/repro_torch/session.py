"""Session facade: one spec (arch, policy, backend, device) + params.

>>> from repro_torch.session import Session
>>> s = Session("qwen3-4b", policy="segmented1", device="cpu")
>>> out = s.generate(batch=2, prompt_len=16, gen_len=8)
>>> eng = s.serving_engine(slots=4, max_len=64)
>>> s.ppa_report()["area_reduction"]                      # Table II roll-up
>>> r = Session.from_pretrained("resnet18", "ckpt/", device="cpu")
>>> logits = r.apply(images)                              # Table IV forward
>>> res = r.auto_configure(1e-2, calib=images)            # proxy sweep
>>> r.save_policy("policy.json")

``arch`` is a dense decoder (``qwen3-4b``, ``minitron-8b``; ``gemma2-9b``
and ``gemma3-12b`` with sliding-window layers, gemma2 with softcaps;
``qwen2-vl-72b`` with M-RoPE, whose image input goes through the model
API as ``{"embeds", "positions"}``), a MoE decoder
(``llama4-maverick-400b-a17b``; ``deepseek-v3-671b`` with MLA attention),
``mamba2-130m`` (SSD blocks, whose every prefill runs the SSD scan kernel
on the card), ``zamba2-7b`` (SSD blocks and one shared attention block) or
``whisper-tiny`` (an encoder-decoder), or a
:class:`~repro_torch.models.resnet.ResNetConfig` (see :meth:`from_resnet`
and :meth:`from_pretrained`).  An encoder-decoder has no
:meth:`generate` and no serving engine (a request carries no encoder
inputs, as in the reference): drive it through
``repro_torch.models.transformer.prefill`` / ``decode_step`` with
``{"tokens", "enc_embeds"}``, ``loss_fn``, :meth:`auto_configure` and
:meth:`ppa_report`.

``policy`` accepts a :class:`~repro_torch.core.policy.NumericsPolicy`, a
:class:`~repro_torch.core.numerics.NumericsConfig`, a preset name
(``exact`` / ``segmented1|2|3``) or the path of a policy JSON file (the
JAX package's schema; its backend names are mapped, see
:mod:`repro_torch.core.policy`); a malformed file raises
:class:`SessionError` with a one-line message.

The segmented presets take ``backend="auto"``: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.  (The JAX package's
presets pin its XLA reference instead; both compute the same function
within the kernel's tolerance.)

Sessions run on ``cuda`` unless ``device="cpu"`` is passed; with no CUDA
on the host a CUDA session raises.

The module is also the session CLI, with the JAX package's subcommands,
flags, defaults (the reduced config unless ``--full-size``), output lines
and exit codes (2 and a one-line error for a :class:`SessionError`), plus
``--device``:

    python -m repro_torch.session generate       --arch zamba2-7b
    python -m repro_torch.session serve-loop     --weights ckpt/ --tiers premium:exact,standard:segmented3
    python -m repro_torch.session auto-configure --arch qwen3-4b --budget 1e-2 --out p.json
    python -m repro_torch.session ppa            --arch qwen3-4b --policy p.json
    python -m repro_torch.session dryrun         --arch qwen3-4b --shape train_4k

``--tune TUNE_JSON`` activates a kernel-tuning artifact
(:mod:`repro_torch.kernels.autotune`), as ``Session(tune=...)`` does.
``dryrun`` counts one full-size (arch x shape x mesh) cell on meta tensors
(:mod:`repro_torch.launch.dryrun`): it draws no weights and allocates
nothing on any device.

``--backend`` takes the port's names (``auto``, ``hopper``, ``torch``) or
the JAX package's, mapped as policy files map them (``xla`` and
``interpret`` -> ``torch``, ``pallas`` -> ``hopper``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.numerics import NumericsConfig
from repro_torch.core.policy import (BACKEND_FROM_JAX, NumericsPolicy,
                                     PolicyRule, is_policy)

__all__ = ["GenerateResult", "SEGMENTED_CANDIDATES", "Session",
           "SessionError", "build_parser", "load_policy", "main",
           "parse_tiers", "print_ppa_report"]


class SessionError(RuntimeError):
    """A session-level configuration error with a one-line message."""


# the split-float ladder: the segmented presets, and the default
# auto-configure candidate set
SEGMENTED_CANDIDATES: Tuple[Tuple[str, NumericsConfig], ...] = (
    ("segmented-1", NumericsConfig(mode="segmented", seg_passes=1, backend="auto")),
    ("segmented-2", NumericsConfig(mode="segmented", seg_passes=2, backend="auto")),
    ("segmented-3", NumericsConfig(mode="segmented", seg_passes=3, backend="auto")),
)

# "exact" keeps the arch's own numerics (exact by default)
_PRESETS = {"exact": None,
            **{name.replace("-", ""): cfg
               for name, cfg in SEGMENTED_CANDIDATES}}


def load_policy(path: str) -> NumericsPolicy:
    """Load a NumericsPolicy from a JSON file with one-line errors."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise SessionError(
            f"cannot read policy file {path!r}: {e.strerror or e}") from e
    try:
        return NumericsPolicy.from_json(text)
    except (json.JSONDecodeError, ValueError, KeyError, TypeError) as e:
        raise SessionError(f"invalid policy JSON in {path!r}: {e}") from e


def _coerce_numerics(policy):
    """policy arg -> Numerics override (None = keep the arch's own)."""
    if policy is None or isinstance(policy, (NumericsConfig, NumericsPolicy)):
        return policy
    if is_policy(policy):  # ScopedPolicy view: prefixed, not servable as-is
        raise SessionError(
            "a ScopedPolicy view cannot configure a session: pass the root "
            "NumericsPolicy (views are created per layer during resolution)")
    if isinstance(policy, str):
        if policy in _PRESETS:
            return _PRESETS[policy]
        return load_policy(policy)
    raise SessionError(
        f"unsupported policy spec {policy!r}: expected a NumericsConfig, "
        f"NumericsPolicy, preset name ({'/'.join(_PRESETS)}) or a JSON path")


def _with_backend(numerics, backend: str):
    """Force the kernel backend on every config a Numerics can resolve to."""
    if isinstance(numerics, NumericsConfig):
        return dataclasses.replace(numerics, backend=backend)
    return NumericsPolicy(
        tuple(PolicyRule(r.pattern, dataclasses.replace(r.config,
                                                        backend=backend))
              for r in numerics.rules),
        dataclasses.replace(numerics.default, backend=backend))


def _as_policy(numerics) -> NumericsPolicy:
    return (numerics if isinstance(numerics, NumericsPolicy)
            else NumericsPolicy((), default=numerics))


def _to_device(tree, device):
    """A nested dict of numpy arrays as fp32-or-native tensors on
    ``device`` (copied: the checkpoint's arrays may be read-only views)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def print_ppa_report(ppa: dict, tag: str = "session") -> None:
    """One-line summary of a :meth:`Session.ppa_report` dict."""
    print(f"[{tag}] policy over {ppa['n_sites']} call sites: "
          f"area {ppa['area_um2']:,.0f} um^2 "
          f"(-{ppa['area_reduction']:.1%} vs exact), "
          f"power {ppa['power_w']:.3f} W "
          f"(-{ppa['power_reduction']:.1%}), "
          f"modeled compute passes x{ppa['compute_scale']:.2f}")


@dataclasses.dataclass(frozen=True)
class GenerateResult:
    tokens: np.ndarray        # (batch, gen_len) int32 greedy continuations
    seconds: float
    tokens_per_s: float
    # per-row emitted-token counts (EOS included); rows that hit the EOS
    # stop token have their remaining columns pinned to eos_id
    gen_lengths: Optional[np.ndarray] = None


class Session:
    """(arch, policy, backend, mesh, device) + params: the one public spec.

    ``arch`` is an arch id from ``repro_torch.configs`` (reduced to the
    CPU-sized config unless ``reduced=False``), a ready
    :class:`~repro_torch.configs.base.ArchConfig`, or a
    :class:`~repro_torch.models.resnet.ResNetConfig` (with ``params`` and
    its batch-norm ``state``; see :meth:`from_resnet`).  ``params`` (a
    nested dict of tensors in the JAX package's layout, e.g. from
    :func:`repro_torch.compat.jax_params.params_from_numpy`) must live on
    ``device``; without them an LM session draws seeded random weights
    there.

    ``mesh`` is carried for the dry-run (``"multi"`` selects the 2x16x16
    multi-pod mesh, anything else the single-pod 16x16).  ``tune`` is a
    kernel-tuning artifact (a path or a
    :class:`~repro_torch.kernels.autotune.TuningTable`) activated
    process-wide, as the JAX package's ``Session(tune=)``; a bad artifact
    raises a one-line :class:`SessionError`.
    """

    def __init__(self, arch, policy=None, backend: Optional[str] = None,
                 mesh: Optional[str] = None, *, seed: int = 0,
                 reduced: bool = True, params=None, state=None, device=None,
                 tune=None):
        from repro_torch.models.resnet import ResNetConfig

        if isinstance(arch, str):
            from repro_torch.configs import get_arch

            try:
                base = get_arch(arch)
            except ValueError as e:
                raise SessionError(str(e)) from e
            self.arch_id = arch
            self._base_cfg = base.reduced() if reduced else base
            self._family = "lm"
        elif isinstance(arch, ArchConfig):
            self.arch_id = arch.arch_id
            self._base_cfg = arch
            self._family = "lm"
        elif isinstance(arch, ResNetConfig):
            self.arch_id = "resnet18"
            self._base_cfg = arch
            self._family = "resnet"
        else:
            raise SessionError(f"unsupported arch spec {arch!r}: expected "
                               f"an arch id, ArchConfig or ResNetConfig")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # fp32 matmuls stand in for bf16 dots with fp32 accumulation
            # (and are the ResNet's exact fc): TF32 would round operands
            torch.backends.cuda.matmul.allow_tf32 = False
        self.backend = backend
        self.mesh = mesh
        self.seed = seed
        self._numerics_override = _coerce_numerics(policy)
        # activation is process-wide: the wrappers' lookups are module-level,
        # like the static rules they replace
        self._tune = tune
        if tune is not None:
            from repro_torch.kernels import autotune

            try:
                autotune.activate(tune)
            except autotune.TuneError as e:
                raise SessionError(str(e)) from e
        if params is not None:
            leaf = params["embed" if self._family == "lm" else "stem"]
            if leaf.device != self.device:
                raise SessionError(f"params live on {leaf.device}, the "
                                   f"session on {self.device}")
        self._params = params
        self._state = state  # resnet batch-norm running statistics

    # -- configuration ------------------------------------------------------

    @property
    def numerics(self):
        """The effective Numerics (override > arch default > backend)."""
        num = (self._numerics_override
               if self._numerics_override is not None
               else self._base_cfg.numerics)
        if self.backend is not None:
            num = _with_backend(num, self.backend)
        return num

    @property
    def config(self):
        """The arch config with this session's numerics applied."""
        return dataclasses.replace(self._base_cfg, numerics=self.numerics)

    @property
    def is_policy(self) -> bool:
        return is_policy(self.numerics)

    def replace(self, **kw) -> "Session":
        """A new Session with fields replaced (policy/backend/mesh/seed/
        params/state/device/tune); params and state are shared unless
        overridden."""
        args = dict(policy=self._numerics_override, backend=self.backend,
                    mesh=self.mesh, seed=self.seed, params=self._params,
                    state=self._state, device=self.device, tune=self._tune)
        unknown = set(kw) - set(args)
        if unknown:
            raise SessionError(
                f"unknown Session.replace field(s) {sorted(unknown)}; "
                f"expected a subset of {sorted(args)}")
        args.update(kw)
        return Session(self._base_cfg, args["policy"], args["backend"],
                       args["mesh"], seed=args["seed"], params=args["params"],
                       state=args["state"], device=args["device"],
                       tune=args["tune"])

    # -- parameters ---------------------------------------------------------

    @property
    def params(self):
        """Model parameters (seeded random init on first use for the LM
        zoo; a ResNet session is built with its params)."""
        if self._params is None:
            if self._family != "lm":
                raise SessionError(
                    "resnet sessions need params: use "
                    "Session.from_resnet(cfg, params, state) or "
                    "Session.from_pretrained('resnet18', path)")
            from repro_torch.models import transformer

            self._params = transformer.init(self.config, self.seed,
                                            self.device)
        return self._params

    @classmethod
    def from_resnet(cls, cfg, params, state, policy=None,
                    backend: Optional[str] = None, seed: int = 0,
                    device=None) -> "Session":
        """Session over a ResNet: ``cfg`` is a ResNetConfig,
        ``params``/``state`` its trees (:mod:`repro_torch.models.resnet`)
        on ``device``."""
        return cls(cfg, policy, backend, seed=seed, params=params,
                   state=state, device=device)

    @classmethod
    def from_pretrained(cls, family: str, path, policy=None,
                        backend: Optional[str] = None,
                        mesh: Optional[str] = None, *, cfg=None,
                        reduced: bool = True, unknown: str = "error",
                        cast: bool = True, seed: int = 0,
                        device=None, tune=None) -> "Session":
        """A Session over pretrained weights (:mod:`repro_torch.compat`).

        ``family`` names a registered checkpoint converter (``qwen3-4b``,
        ``whisper-tiny``, ``resnet18``);
        ``path`` is a safetensors file, a sharded
        ``*.safetensors.index.json`` (or a directory holding either), or a
        torch pickle.  The architecture comes from ``cfg`` when given,
        else the checkpoint's ``repro.config`` metadata, else the family's
        default.  ``unknown``/``cast`` go to
        :func:`repro_torch.compat.load_pretrained`; interop failures raise
        one-line :class:`repro_torch.compat.CompatError`\\ s.  The weights
        are copied to ``device`` (``cuda`` unless ``"cpu"``).  ``mesh`` and
        ``tune`` are the constructor's.
        """
        from repro_torch import compat

        dev = resolve_device(device)
        loaded = compat.load_pretrained(family, path, cfg=cfg,
                                        reduced=reduced, unknown=unknown,
                                        cast=cast)
        return cls(loaded.cfg, policy, backend, mesh, seed=seed,
                   params=_to_device(loaded.params, dev),
                   state=(None if loaded.state is None
                          else _to_device(loaded.state, dev)),
                   device=dev, tune=tune)

    def export(self, path) -> None:
        """Write this session's params (+ ResNet batch-norm state) as one
        safetensors checkpoint in the family's foreign naming scheme: the
        exact inverse of :meth:`from_pretrained`, so an export/reload round
        trip is bit-exact."""
        from repro_torch import compat

        foreign, meta = compat.export_pretrained(
            self.arch_id, self._base_cfg, self.params, self._state)
        compat.write_safetensors(path, foreign, meta)

    # -- layer enumeration / PPA -------------------------------------------

    def layer_paths(self) -> list:
        if self._family == "resnet":
            from repro_torch.models import resnet

            return resnet.layer_paths(self._base_cfg)
        from repro_torch.models import transformer

        return transformer.layer_paths(self.config)

    def layer_path_counts(self) -> Mapping[str, int]:
        if self._family == "resnet":
            return {}
        from repro_torch.models import transformer

        return transformer.layer_path_counts(self.config)

    def ppa_report(self) -> dict:
        """Modeled PPA of this session's numerics over every call site: the
        Table II area/power roll-up plus the pass scale
        (:func:`repro_torch.launch.hlo_analysis.policy_ppa_summary`)."""
        from repro_torch.launch import hlo_analysis

        return hlo_analysis.policy_ppa_summary(
            _as_policy(self.numerics), self.layer_paths(),
            counts=self.layer_path_counts())

    def save_policy(self, path: str) -> None:
        """Write this session's numerics as a policy JSON file (loadable by
        either package)."""
        with open(path, "w") as f:
            f.write(_as_policy(self.numerics).to_json())

    # -- forward ------------------------------------------------------------

    @torch.inference_mode()
    def apply(self, images) -> torch.Tensor:
        """ResNet inference under the session numerics: NHWC ``images``
        (numpy or tensor) -> logits on the session's device."""
        if self._family != "resnet":
            raise SessionError("apply(images) is the ResNet entry point; "
                               "use generate() for the LM zoo")
        from repro_torch.models import resnet

        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        logits, _ = resnet.apply(self.params, self._state, x, self.config,
                                 train=False)
        return logits

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
        if self._family != "lm":
            raise SessionError("generate() is the LM entry point; use "
                               "apply(images) for ResNet sessions")
        from repro_torch.models import transformer

        cfg = self.config
        if cfg.encoder_layers:
            raise SessionError(
                f"{self.arch_id}: generate() has no encoder inputs to give "
                f"an encoder-decoder; call transformer.prefill / "
                f"decode_step with {{'tokens', 'enc_embeds'}}")
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
        if self._family != "lm":
            raise SessionError("serving_engine() is the LM entry point; "
                               "ResNet sessions have no decode loop")
        from repro_torch.serving import DEFAULT_TIERS, Engine

        tiers = DEFAULT_TIERS if tiers is None else tuple(tiers)
        return Engine.from_session(self, tiers, slots=slots, max_len=max_len,
                                   page_size=page_size, pages=pages,
                                   prefill_chunk=prefill_chunk,
                                   clock=clock, aging=aging)

    # -- auto-configuration (the sweep) ------------------------------------

    def auto_configure(self, budget: float, calib=None, candidates=None,
                       method: str = "proxy", default=None,
                       verbose: bool = False):
        """Budget-driven per-layer numerics selection over this session's
        network; adopts the emitted policy as the session numerics and
        returns the :class:`repro_torch.core.sweep.AutoConfigResult`.

        ``calib`` is the calibration input: an image batch for ResNet
        sessions (required), a token batch dict ``{"tokens": ...}`` for
        the LM zoo, plus ``"enc_embeds"`` for an encoder-decoder (default:
        seeded random tokens, 2 x 16, then for an encoder-decoder seeded
        normal encoder inputs, 2 x min(enc_len, 16) x d, drawn from the
        same generator as the JAX package draws them).
        ``candidates`` is a ``(name, NumericsConfig)`` list,
        ``"segmented"`` (default: the split-float ladder) or
        ``"emulated"`` (the bit-level Pareto designs).
        ``method="proxy"`` fits the composed-error model from ONE
        instrumented pass (:mod:`repro_torch.core.sensitivity`);
        ``"greedy"`` measures the network per candidate assignment.
        """
        from repro_torch.core import sweep
        from repro_torch.core.metrics import mred

        if candidates is None or candidates == "segmented":
            cand: Optional[Sequence] = list(SEGMENTED_CANDIDATES)
        elif candidates == "emulated":
            cand = None  # sweep's default: the emulated Pareto frontier
        else:
            cand = list(candidates)

        params = self.params
        if self._family == "resnet":
            from repro_torch.models import resnet

            if calib is None:
                raise SessionError(
                    "resnet auto_configure needs a calibration image batch "
                    "(calib=images)")
            images = torch.as_tensor(calib, dtype=torch.float32,
                                     device=self.device)
            # the reference is the exact fp32 forward, whatever the default
            ref_numerics = NumericsConfig(mode="exact",
                                          compute_dtype="float32")
            default = default or ref_numerics

            def forward(numerics):
                acfg = dataclasses.replace(self._base_cfg, numerics=numerics)
                with torch.no_grad():
                    return resnet.apply(params, self._state, images, acfg,
                                        train=False)[0]
        else:
            from repro_torch.models import transformer

            cfg = self.config
            if calib is None:
                rng = np.random.default_rng(self.seed)
                calib = {"tokens": rng.integers(0, cfg.vocab, (2, 16))}
                if cfg.encoder_layers:
                    calib["enc_embeds"] = rng.standard_normal(
                        (2, min(cfg.enc_len, 16), cfg.d_model)).astype(
                            np.float32)
            batch = {"tokens": torch.as_tensor(np.asarray(calib["tokens"]),
                                               dtype=torch.int64,
                                               device=self.device)}
            if cfg.encoder_layers:
                if "enc_embeds" not in calib:
                    raise SessionError(
                        f"{self.arch_id}: the calibration batch needs "
                        f"'enc_embeds' (B, Se, {cfg.d_model})")
                batch["enc_embeds"] = torch.as_tensor(
                    np.asarray(calib["enc_embeds"]), dtype=torch.float32,
                    device=self.device)
            # the default must match the network's own exact numerics
            # (bf16 for the LM zoo) so the baseline reads as zero error
            default = ref_numerics = default or NumericsConfig(mode="exact")

            def forward(numerics):
                pcfg = dataclasses.replace(cfg, numerics=numerics)
                with torch.no_grad():
                    hidden, _ = transformer.backbone(params, pcfg, batch)
                    return transformer.logits_fn(params, pcfg, hidden)

        ref = forward(ref_numerics).cpu().numpy().astype(np.float64)

        def eval_fn(policy):
            return mred(forward(policy), ref)

        res = sweep.auto_configure(eval_fn, self.layer_paths(), budget,
                                   candidates=cand, default=default,
                                   method=method, verbose=verbose,
                                   device=self.device)
        self._numerics_override = res.policy
        return res

    # -- dry-run (counted, not compiled) ------------------------------------

    def dryrun(self, shape: str, multi_pod: Optional[bool] = None) -> dict:
        """Count one (arch x shape x mesh) cell on meta tensors and return
        the memory / roofline record (:mod:`repro_torch.launch.dryrun`).
        The session's weights are never drawn, and nothing is allocated on
        any device; ``multi_pod=None`` takes the session's ``mesh``."""
        if self._family != "lm":
            raise SessionError("dryrun() is the LM entry point; ResNet "
                               "sessions have no launch shapes")
        from repro_torch.launch import specs

        if shape not in specs.SHAPES:
            raise SessionError(f"unknown dryrun shape {shape!r}; expected "
                               f"one of {sorted(specs.SHAPES)}")
        from repro_torch.launch import dryrun as dryrun_mod

        if multi_pod is None:
            multi_pod = self.mesh == "multi"
        return dryrun_mod.lower_session_cell(self, shape, multi_pod)


# ---------------------------------------------------------------------------
# the session CLI (generate / serve-loop / auto-configure / ppa / dryrun)
# ---------------------------------------------------------------------------

def _add_common(ap):
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--policy", default=None,
                    help="NumericsPolicy JSON file, or a preset "
                         "(exact/segmented1/segmented2/segmented3)")
    ap.add_argument("--backend", default=None,
                    choices=["auto", "hopper", "torch", *sorted(
                        set(BACKEND_FROM_JAX) - {"auto"})],
                    help="kernel backend: auto (the kernel for CUDA "
                         "tensors), hopper or torch; the JAX package's "
                         "pallas / interpret / xla map to hopper / torch / "
                         "torch")
    ap.add_argument("--tune", default=None, metavar="TUNE_JSON",
                    help="kernel-tuning artifact to activate "
                         "(TUNE_<device>.json, written by "
                         "repro_torch.kernels.autotune.sweep). Default: the "
                         "REPRO_TUNE_FILE env var if set, else the static "
                         "launch shapes")
    ap.add_argument("--weights", default=None, metavar="CKPT",
                    help="pretrained checkpoint loaded through the compat "
                         "converter registered for --arch (safetensors "
                         "file, sharded *.safetensors.index.json or its "
                         "directory, or a torch pickle)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full arch config (default: reduced)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")


def parse_tiers(spec: str):
    """``name:policy,name:policy`` -> TierSpec tuple (priority = listed
    order; policy is a preset name or a policy-JSON path).  The wire
    format of ``python -m repro_torch.session serve-loop --tiers``."""
    from repro_torch.serving import TierSpec

    tiers = []
    for i, part in enumerate(p for p in spec.split(",") if p.strip()):
        name, _, pol = part.partition(":")
        if not name.strip() or not pol.strip():
            raise SessionError(f"bad tier spec {part.strip()!r}: expected "
                               f"name:policy (e.g. premium:exact)")
        if any(t.name == name.strip() for t in tiers):
            raise SessionError(f"duplicate tier {name.strip()!r} in --tiers")
        tiers.append(TierSpec(name.strip(), pol.strip(), priority=i))
    if not tiers:
        raise SessionError(f"empty tier spec {spec!r}: expected "
                           f"name:policy[,name:policy...]")
    return tuple(tiers)


def build_parser() -> argparse.ArgumentParser:
    """The session CLI's argument parser."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.session",
        description="Session CLI: generate / serve-loop / auto-configure / "
                    "ppa / dryrun over one (arch, policy, backend, device) "
                    "spec")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="batched prefill + greedy decode")
    _add_common(g)
    g.add_argument("--batch", type=int, default=4)
    g.add_argument("--prompt-len", type=int, default=32)
    g.add_argument("--gen-len", type=int, default=16)
    g.add_argument("--eos-id", type=int, default=None,
                   help="stop token: rows retire when they emit it "
                        "(default: none)")

    sl = sub.add_parser(
        "serve-loop",
        help="continuous-batching serving demo: a synthetic mixed-tier "
             "workload decodes on one resident weight set")
    _add_common(sl)
    sl.add_argument("--tiers", default="premium:exact,bulk:segmented1",
                    help="comma list of name:policy tiers, priority in "
                         "listed order (policy: preset name or policy-JSON "
                         "path; overrides --policy per lane)")
    sl.add_argument("--requests", type=int, default=8,
                    help="synthetic workload size (round-robin over tiers)")
    sl.add_argument("--slots", type=int, default=4,
                    help="KV-pool slots per tier")
    sl.add_argument("--max-len", type=int, default=64,
                    help="per-request KV position cap")
    sl.add_argument("--page-size", type=int, default=None,
                    help="tokens per paged-KV page (default 16)")
    sl.add_argument("--pages", type=int, default=None,
                    help="physical KV pages per tier (default: "
                         "slots * ceil(max_len / page_size))")
    sl.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens prefilled per engine step "
                         "(default 32)")
    sl.add_argument("--prompt-len", type=int, default=16)
    sl.add_argument("--gen-len", type=int, default=16)
    sl.add_argument("--aging", type=float, default=None,
                    help="scheduler aging bound in seconds (default: off)")

    a = sub.add_parser("auto-configure",
                       help="budget-driven per-layer numerics sweep "
                            "(proxy: ONE gain-aware calibration pass)")
    _add_common(a)
    a.add_argument("--budget", type=float, required=True)
    a.add_argument("--method", choices=["proxy", "greedy"], default="proxy")
    a.add_argument("--candidates", choices=["segmented", "emulated"],
                   default="segmented")
    a.add_argument("--out", default=None, help="write the policy JSON here")

    p = sub.add_parser("ppa", help="Table II PPA roll-up of the policy")
    _add_common(p)

    d = sub.add_parser(
        "dryrun",
        help="count one full-size cell's memory and FLOPs on meta tensors "
             "(as python -m repro_torch.launch.dryrun)")
    _add_common(d)
    d.add_argument("--shape", required=True)
    d.add_argument("--multi-pod", action="store_true")
    d.add_argument("--reduced", action="store_true",
                   help="count the reduced CPU-sized config instead of the "
                        "full arch (dryrun defaults to full size so records "
                        "match python -m repro_torch.launch.dryrun)")
    return ap


def _session(args) -> Session:
    backend = (None if args.backend is None
               else BACKEND_FROM_JAX.get(args.backend, args.backend))
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no card: a one-line error, not a traceback
        raise SessionError(str(e)) from e
    # dryrun counts the full-size arch by default (its records must match
    # the launch.dryrun CLI's); every other subcommand works on the reduced
    # config unless --full-size
    reduced = args.reduced if args.cmd == "dryrun" else not args.full_size
    if args.weights:
        from repro_torch.compat import CompatError

        try:
            return Session.from_pretrained(
                args.arch, args.weights, policy=args.policy, backend=backend,
                seed=args.seed, reduced=reduced, device=device,
                tune=args.tune)
        except CompatError as e:
            raise SessionError(str(e)) from e
    return Session(args.arch, policy=args.policy, backend=backend,
                   seed=args.seed, reduced=reduced, device=device,
                   tune=args.tune)


def _serve_loop(sess: Session, args) -> None:
    from repro_torch.serving import ServingError

    tiers = parse_tiers(args.tiers)
    try:
        eng = sess.serving_engine(tiers, slots=args.slots,
                                  max_len=args.max_len,
                                  page_size=args.page_size, pages=args.pages,
                                  prefill_chunk=args.prefill_chunk,
                                  aging=args.aging)
        rng = np.random.default_rng(args.seed)
        for i in range(args.requests):
            spec = tiers[i % len(tiers)]
            plen = int(rng.integers(max(2, args.prompt_len // 2),
                                    args.prompt_len + 1))
            eng.submit(rng.integers(0, sess.config.vocab, plen),
                       tier=spec.name, max_new_tokens=args.gen_len)
        t0 = time.perf_counter()
        stats = eng.run()
        dt = time.perf_counter() - t0
    except ServingError as e:
        raise SessionError(str(e)) from e
    total = sum(s.n_tokens for s in stats.values())
    print(f"[serve-loop] {args.arch}: {args.requests} requests, "
          f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s "
          f"aggregate)")
    for spec in tiers:
        s = stats[spec.name]
        print(f"[serve-loop]   {spec.name} ({spec.policy}): "
              f"{s.n_finished} finished, {s.n_tokens} tokens, "
              f"{s.n_decode_steps} decode steps, mean batch "
              f"{s.mean_occupancy:.2f}")
        print_ppa_report(sess.replace(policy=spec.policy).ppa_report(),
                         tag=f"tier:{spec.name}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        sess = _session(args)
        if args.cmd == "generate":
            if sess.is_policy:
                print_ppa_report(sess.ppa_report())
            res = sess.generate(batch=args.batch, prompt_len=args.prompt_len,
                                gen_len=args.gen_len, eos_id=args.eos_id)
            print(f"[session] {args.arch}: {res.tokens.shape[0]}x"
                  f"{res.tokens.shape[1]} tokens "
                  f"({int(res.gen_lengths.sum())} emitted) in "
                  f"{res.seconds:.2f}s ({res.tokens_per_s:.1f} tok/s)")
        elif args.cmd == "serve-loop":
            _serve_loop(sess, args)
        elif args.cmd == "auto-configure":
            res = sess.auto_configure(args.budget, method=args.method,
                                      candidates=args.candidates, verbose=True)
            print(f"[session] {res.method} error={res.error:.3e} "
                  f"(budget {args.budget:g})  area {res.area_um2:,.0f} um^2 "
                  f"(-{res.area_reduction:.1%} vs exact)  "
                  f"[{res.n_evals} calibration evals]")
            if args.out:
                sess.save_policy(args.out)
                print(f"[session] policy written to {args.out}")
        elif args.cmd == "ppa":
            print_ppa_report(sess.ppa_report())
        elif args.cmd == "dryrun":
            rec = sess.dryrun(args.shape, multi_pod=args.multi_pod)
            print(json.dumps(rec, indent=1))
            return 0 if rec.get("status", "error").startswith(
                ("ok", "skipped")) else 1
    except SessionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
