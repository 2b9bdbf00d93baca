"""ResNet-18 (CIFAR variant): the paper's Table IV workload.

The port's counterpart of ``repro.models.resnet``, with its layout:
activations NHWC, conv weights HWIO, parameters and batch-norm statistics
as two nested dicts (``params``, ``state``).  Convolutions route through
the numerics config: an exact conv is the native convolution (cuDNN on the
card, with TF32 off); an approximate one is im2col + :func:`nmatmul`
(``segmented``: the Hopper split-float kernel on the card; ``emulated``:
every scalar product through the bit-level multiplier's plain datapath).

``ResNetConfig.numerics`` may be a per-layer
:class:`~repro_torch.core.policy.NumericsPolicy`; the layer paths are
``stem``, ``s{stage}b{block}.{conv1,conv2,proj}`` and ``fc``
(:func:`layer_paths`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.numerics import (NumericsConfig, current_numerics,
                                  layer_scope, nmatmul, numerics_scope,
                                  operand_tap_active, resolve_here)

from .layers import normal
from .transformer import unflatten


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    widths: tuple = (64, 128, 256, 512)
    blocks: tuple = (2, 2, 2, 2)
    numerics: object = NumericsConfig(mode="exact", compute_dtype="float32")


def _blocks(cfg: ResNetConfig):
    """``(name, cin, cout, stride, has_proj)`` of every basic block, in
    execution order."""
    out = []
    cin = cfg.widths[0]
    for si, (w, n) in enumerate(zip(cfg.widths, cfg.blocks)):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            out.append((f"s{si}b{bi}", cin, w, stride,
                        stride != 1 or cin != w))
            cin = w
    return out


def layer_paths(cfg: ResNetConfig) -> list:
    """All policy paths of this network, in execution order."""
    paths = ["stem"]
    for name, _, _, _, proj in _blocks(cfg):
        paths += [f"{name}.conv1", f"{name}.conv2"]
        if proj:
            paths.append(f"{name}.proj")
    paths.append("fc")
    return paths


def shapes(cfg: ResNetConfig):
    """Flat ``{name: (shape, init)}`` of the parameters and of the
    batch-norm state, in the reference's names; ``init`` is ``("he",)``
    (He-normal over the conv's fan-in), ``("normal", scale)``,
    ``("ones",)`` or ``("zeros",)``."""
    params, state = {}, {}

    def conv(name, kh, cin, cout):
        params[name] = ((kh, kh, cin, cout), ("he",))

    def bn(pre, c):
        params[f"{pre}.scale"] = ((c,), ("ones",))
        params[f"{pre}.bias"] = ((c,), ("zeros",))
        state[f"{pre}.mean"] = ((c,), ("zeros",))
        state[f"{pre}.var"] = ((c,), ("ones",))

    conv("stem", 3, 3, cfg.widths[0])
    bn("bn_stem", cfg.widths[0])
    for name, cin, cout, _, proj in _blocks(cfg):
        conv(f"{name}.conv1", 3, cin, cout)
        bn(f"{name}.bn1", cout)
        conv(f"{name}.conv2", 3, cout, cout)
        bn(f"{name}.bn2", cout)
        if proj:
            conv(f"{name}.proj", 1, cin, cout)
            bn(f"{name}.bn_proj", cout)
    params["fc"] = ((cfg.widths[-1], cfg.num_classes),
                    ("normal", cfg.widths[-1] ** -0.5))
    params["fc_b"] = ((cfg.num_classes,), ("zeros",))
    return params, state


def init(cfg: ResNetConfig, seed: int = 0, device=None):
    """Seeded random ``(params, state)`` drawn on ``device`` by a
    :class:`torch.Generator`: He-normal convs, unit batch-norm scales and
    zero biases, running statistics at mean 0 and variance 1 (the JAX
    package's PRNG stream cannot be reproduced; equivalence tests carry
    its weights across instead)."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(shape, how):
        if how[0] == "he":
            kh, kw, cin, _ = shape
            return normal(gen, shape, (2.0 / (kh * kw * cin)) ** 0.5, device)
        if how[0] == "normal":
            return normal(gen, shape, how[1], device)
        fill = torch.ones if how[0] == "ones" else torch.zeros
        return fill(shape, dtype=torch.float32, device=device)

    p_shapes, s_shapes = shapes(cfg)
    return (unflatten({k: draw(*v) for k, v in p_shapes.items()}),
            unflatten({k: draw(*v) for k, v in s_shapes.items()}))


def _same_padding(H: int, W: int, kh: int, kw: int, stride: int):
    """Output size and the (lo, hi) pads of XLA's SAME padding: the total
    pad is split with ``lo = total // 2``, so under stride the extra row
    and column go at the end."""
    Ho, Wo = -(-H // stride), -(-W // stride)
    th = max((Ho - 1) * stride + kh - H, 0)
    tw = max((Wo - 1) * stride + kw - W, 0)
    return Ho, Wo, (th // 2, th - th // 2), (tw // 2, tw - tw // 2)


def _native_conv(x, w, stride: int):
    """The exact conv: NHWC x HWIO through ``F.conv2d`` with the
    reference's SAME pads made explicit (``padding="same"`` rejects
    stride > 1).  cuDNN runs fp32 convs in TF32 by default; it is off for
    this call (the process-wide flag is left as it was)."""
    kh, kw = w.shape[:2]
    _, _, ph, pw = _same_padding(x.shape[1], x.shape[2], kh, kw, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (*pw, *ph))
    if xn.device.type == "cpu":
        # PyTorch's CPU (oneDNN) backward of a strided 1x1 conv crashes on
        # a channels-last input: hand it a contiguous one
        xn = xn.contiguous()
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic,
                     allow_tf32=False):
        out = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1)


def im2col(x, kh: int, kw: int, stride: int):
    """``(B * Ho * Wo, kh * kw * cin)`` patches of NHWC ``x`` under SAME
    padding, column ``(i * kw + j) * cin + c`` (the reference's order,
    which the segmented kernel's fixed K chunks depend on), and
    ``(Ho, Wo)``."""
    B, H, W, cin = x.shape
    Ho, Wo, ph, pw = _same_padding(H, W, kh, kw, stride)
    xp = F.pad(x, (0, 0, *pw, *ph))
    patches = [xp[:, i:i + (Ho - 1) * stride + 1:stride,
                  j:j + (Wo - 1) * stride + 1:stride, :]
               for i in range(kh) for j in range(kw)]
    return torch.cat(patches, dim=-1).reshape(B * Ho * Wo, kh * kw * cin), \
        (Ho, Wo)


def conv2d(x, w, stride: int = 1):
    """NHWC conv under the ambient numerics at the current layer path.

    With no ambient scope, or an exact config, the native conv runs;
    approximate configs (and exact ones while a calibration tap is
    installed, so the pass records this site) run im2col + ``nmatmul``.
    """
    resolved = resolve_here() if current_numerics() is not None else None
    if resolved is None or (resolved.mode == "exact"
                            and not operand_tap_active()):
        return _native_conv(x, w, stride)
    kh, kw, cin, cout = w.shape
    cols, (Ho, Wo) = im2col(x, kh, kw, stride)
    out = nmatmul(cols, w.reshape(kh * kw * cin, cout))
    return out.reshape(x.shape[0], Ho, Wo, cout)


def batchnorm(params, state, x, train: bool, momentum: float = 0.9,
              eps: float = 1e-5):
    """Batch norm over N, H, W: the batch's statistics in train mode (and
    the running ones updated with ``momentum``), the running ones
    otherwise; ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` as the
    reference orders it.  Returns ``(y, new_state)``."""
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), correction=0)
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mean,
            "var": momentum * state["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + eps) * params["scale"]
    return (x - mean) * inv + params["bias"], new_state


def _block_apply(p, s, x, stride, train, momentum):
    with layer_scope("conv1"):
        c1 = conv2d(x, p["conv1"], stride)
    h, s1 = batchnorm(p["bn1"], s["bn1"], c1, train, momentum)
    h = torch.relu(h)
    with layer_scope("conv2"):
        c2 = conv2d(h, p["conv2"], 1)
    h, s2 = batchnorm(p["bn2"], s["bn2"], c2, train, momentum)
    new_s = {"bn1": s1, "bn2": s2}
    if "proj" in p:
        with layer_scope("proj"):
            cp = conv2d(x, p["proj"], stride)
        x, new_s["bn_proj"] = batchnorm(p["bn_proj"], s["bn_proj"], cp, train,
                                        momentum)
    return torch.relu(h + x), new_s


def apply(params, state, x, cfg: ResNetConfig, train: bool = False,
          momentum: float = 0.9):
    """x: (B, H, W, 3) NHWC -> logits (B, classes); returns
    ``(logits, new_state)``.

    Every conv and the fc resolve their numerics from ``cfg.numerics`` at
    their layer path.  ``train=True`` normalises with the batch's
    statistics and returns the running ones updated with ``momentum``
    (0.0 sets them to this batch's)."""
    with numerics_scope(cfg.numerics):
        new_state = {}
        with layer_scope("stem"):
            cs = conv2d(x, params["stem"], 1)
        h, new_state["bn_stem"] = batchnorm(
            params["bn_stem"], state["bn_stem"], cs, train, momentum)
        h = torch.relu(h)
        for name, _, _, stride, _ in _blocks(cfg):
            with layer_scope(name):
                h, new_state[name] = _block_apply(
                    params[name], state[name], h, stride, train, momentum)
        h = h.mean(dim=(1, 2))
        with layer_scope("fc"):
            logits = nmatmul(h, params["fc"])
        return logits + params["fc_b"], new_state


def loss_fn(params, state, batch, cfg: ResNetConfig, momentum: float = 0.9):
    """Mean cross-entropy of ``batch["labels"]`` under a train-mode forward
    (batch statistics); returns ``(loss, new_state)``, the running
    statistics updated with ``momentum`` and detached: they are state, not
    parameters."""
    logits, new_state = apply(params, state, batch["images"], cfg,
                              train=True, momentum=momentum)
    labels = batch["labels"].to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return (lse - gold).mean(), _detached(new_state)


def _detached(tree):
    return {k: (_detached(v) if isinstance(v, dict) else v.detach())
            for k, v in tree.items()}
