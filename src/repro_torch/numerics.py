"""Public numerics API: context-scoped accuracy configuration.

>>> from repro_torch.numerics import NumericsConfig, numerics_scope, nmatmul
>>> seg1 = NumericsConfig(mode="segmented", seg_passes=1)
>>> with numerics_scope(seg1):
...     y = nmatmul(x, w)                 # runs under the ambient config
"""
from __future__ import annotations

from repro_torch.core.numerics import (BACKENDS, EXACT, NumericsConfig,
                                       apply_elementwise, nmatmul)
from repro_torch.core.scope import (current_numerics, current_path,
                                    layer_scope, numerics_scope,
                                    resolve_here)

__all__ = [
    "BACKENDS",
    "EXACT",
    "NumericsConfig",
    "apply_elementwise",
    "current_numerics",
    "current_path",
    "layer_scope",
    "nmatmul",
    "numerics_scope",
    "resolve_here",
]
