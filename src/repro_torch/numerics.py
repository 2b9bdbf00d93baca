"""Public numerics API: context-scoped accuracy configuration.

>>> from repro_torch.numerics import NumericsConfig, numerics_scope, nmatmul
>>> seg1 = NumericsConfig(mode="segmented", seg_passes=1)
>>> with numerics_scope(seg1):
...     y = nmatmul(x, w)                 # runs under the ambient config

Per-layer policies resolve against the full path of the nested
``layer_scope`` stack:

>>> pol = NumericsPolicy((("blocks.*.mlp.*", seg1),))
>>> with numerics_scope(pol), layer_scope("blocks.3"), layer_scope("mlp"):
...     with layer_scope("wi"):
...         h = nmatmul(x, w)             # resolves blocks.3.mlp.wi -> seg1
"""
from __future__ import annotations

from repro_torch.core.numerics import (BACKENDS, EXACT, NumericsConfig,
                                       apply_elementwise, nmatmul,
                                       operand_tap_active, set_operand_tap)
from repro_torch.core.policy import (Numerics, NumericsPolicy, PolicyRule,
                                     ScopedPolicy, expert_paths, is_policy,
                                     resolve, scoped)
from repro_torch.core.scope import (current_numerics, current_path,
                                    layer_scope, numerics_scope,
                                    resolve_here)

__all__ = [
    "BACKENDS",
    "EXACT",
    "Numerics",
    "NumericsConfig",
    "NumericsPolicy",
    "PolicyRule",
    "ScopedPolicy",
    "apply_elementwise",
    "current_numerics",
    "current_path",
    "expert_paths",
    "is_policy",
    "layer_scope",
    "nmatmul",
    "numerics_scope",
    "operand_tap_active",
    "resolve",
    "resolve_here",
    "scoped",
    "set_operand_tap",
]
