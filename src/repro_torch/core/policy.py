"""Per-layer numerics policies: the compiler's per-layer configuration map.

The port's counterpart of ``repro.core.policy``.  A :class:`NumericsPolicy`
is an ordered list of ``(glob pattern, NumericsConfig)`` rules over layer
paths plus a default, so one forward pass can run exact attention,
segmented-1 MLPs and an exact ``lm_head`` at the same time.

Layer paths
-----------
=====================  ====================================================
model                  paths
=====================  ====================================================
transformer (LM)       ``blocks.{i}.attn.{wq,wk,wv,wo}``,
                       ``blocks.{i}.mlp.{wi,wg,wo}``,
                       ``blocks.{i}.ssm.{in_proj,out_proj,scan}``,
                       ``lm_head``
resnet (Table IV)      ``stem``, ``s{stage}b{block}.{conv1,conv2,proj}``,
                       ``fc``
=====================  ====================================================

Rules match with :func:`fnmatch.fnmatchcase`, in order; the first match
wins and ``default`` applies when none does.

Serialization and backend names
-------------------------------
``to_json`` / ``from_json`` use the JAX package's schema, so a policy file
written by either package loads in the other.  The two packages name their
kernel backends differently; the port maps them on the way in and out:

==================  ===========  ==================
JAX package writes  port reads   port writes
==================  ===========  ==================
``xla``             ``torch``    ``torch`` -> ``xla``
``interpret``       ``torch``
``pallas``          ``hopper``   ``hopper`` -> ``pallas``
``auto``            ``auto``     ``auto`` -> ``auto``
==================  ===========  ==================

So a JAX policy pinned to ``xla`` (its segmented presets are) runs the
plain PyTorch version here, on either device.

The JAX package's ``force_unroll`` escape hatch is not ported: the port
runs every layer eagerly, so the calibration tap sees every call site.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Mapping, Sequence, Tuple, Union

from .numerics import EXACT, NumericsConfig

#: JAX backend name -> the port's (on load)
BACKEND_FROM_JAX = {"xla": "torch", "interpret": "torch", "pallas": "hopper",
                    "auto": "auto"}
#: the port's backend name -> the JAX package's (on save)
BACKEND_TO_JAX = {"torch": "xla", "hopper": "pallas", "auto": "auto"}


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One ``pattern -> config`` entry; ``pattern`` is a shell glob."""

    pattern: str
    config: NumericsConfig

    def matches(self, path: str) -> bool:
        return fnmatch.fnmatchcase(path, self.pattern)


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """Ordered glob rules over layer paths; first match wins, else default."""

    rules: Tuple[PolicyRule, ...] = ()
    default: NumericsConfig = EXACT

    def __post_init__(self):
        # accept any iterable of rules / (pattern, config) pairs
        norm = tuple(r if isinstance(r, PolicyRule) else PolicyRule(*r)
                     for r in self.rules)
        object.__setattr__(self, "rules", norm)

    def lookup(self, path: str) -> NumericsConfig:
        """Resolve one layer path to its NumericsConfig."""
        for rule in self.rules:
            if rule.matches(path):
                return rule.config
        return self.default

    def scope(self, prefix: str) -> "ScopedPolicy":
        """View of this policy with ``prefix.`` prepended to every lookup."""
        return ScopedPolicy(self, prefix)

    def full_path(self, path: str = "") -> str:
        """The absolute layer path a relative ``path`` resolves under (the
        root policy is unscoped, so this is the identity)."""
        return path

    @classmethod
    def from_assignments(cls, assignments: Mapping[str, NumericsConfig],
                         default: NumericsConfig = EXACT) -> "NumericsPolicy":
        """Exact-path rules from a {path: config} map (auto-configurer output)."""
        return cls(tuple(PolicyRule(p, c) for p, c in assignments.items()),
                   default)

    def to_dict(self) -> dict:
        return {
            "default": _config_to_dict(self.default),
            "rules": [{"pattern": r.pattern, "config": _config_to_dict(r.config)}
                      for r in self.rules],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping) -> "NumericsPolicy":
        default = _config_from_dict(d.get("default", {}))
        rules = tuple(
            PolicyRule(r["pattern"], _config_from_dict(r.get("config", {})))
            for r in d.get("rules", ()))
        return cls(rules, default)

    @classmethod
    def from_json(cls, text: str) -> "NumericsPolicy":
        return cls.from_dict(json.loads(text))


@dataclasses.dataclass(frozen=True)
class ScopedPolicy:
    """A policy view rooted at a path prefix."""

    policy: NumericsPolicy
    prefix: str

    def lookup(self, path: str = "") -> NumericsConfig:
        return self.policy.lookup(_join(self.prefix, path))

    def scope(self, prefix: str) -> "ScopedPolicy":
        return ScopedPolicy(self.policy, _join(self.prefix, prefix))

    def full_path(self, path: str = "") -> str:
        return _join(self.prefix, path)


Numerics = Union[NumericsConfig, NumericsPolicy, ScopedPolicy]


def _join(prefix: str, path: str) -> str:
    if not prefix:
        return path
    if not path:
        return prefix
    return f"{prefix}.{path}"


def _config_to_dict(cfg: NumericsConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["backend"] = BACKEND_TO_JAX[d["backend"]]
    return d


_CONFIG_FIELDS = {f.name for f in dataclasses.fields(NumericsConfig)}


def _config_from_dict(d: Mapping) -> NumericsConfig:
    unknown = set(d) - _CONFIG_FIELDS
    if unknown:
        raise ValueError(
            f"unknown NumericsConfig fields {sorted(unknown)}; "
            f"expected a subset of {sorted(_CONFIG_FIELDS)}")
    d = dict(d)
    if "backend" in d:
        if d["backend"] not in BACKEND_FROM_JAX:
            raise ValueError(f"unknown backend {d['backend']!r}; expected one "
                             f"of {sorted(BACKEND_FROM_JAX)}")
        d["backend"] = BACKEND_FROM_JAX[d["backend"]]
    return NumericsConfig(**d)


def is_policy(ncfg) -> bool:
    return isinstance(ncfg, (NumericsPolicy, ScopedPolicy))


def resolve(ncfg, path: str = "") -> NumericsConfig:
    """Resolve a config-or-policy to the concrete config for ``path``."""
    if ncfg is None:
        return EXACT
    if isinstance(ncfg, NumericsConfig):
        return ncfg
    return ncfg.lookup(path)


def scoped(ncfg, *parts: str):
    """Scope a policy under ``parts`` (no-op for a plain NumericsConfig)."""
    if is_policy(ncfg):
        for p in parts:
            ncfg = ncfg.scope(p)
    return ncfg


def expert_paths(n_experts: int, names: Sequence[str] = ("wi", "wg", "wo"),
                 prefix: str = "") -> Tuple[str, ...]:
    """Per-expert MoE call-site paths: ``expert{k}.{name}`` under ``prefix``
    (one multiplier array instance per expert in the PPA roll-up)."""
    return tuple(_join(prefix, f"expert{k}.{name}")
                 for k in range(n_experts) for name in names)
