"""Table III: image blending + edge detection PSNR per multiplier.

The port's counterpart of ``benchmarks/table3_image.py``.  Every scalar
multiplication of the two image kernels goes through the multiplier under
test (the CiM array does the multiplies; additions are the macro's exact
adder tree).  PSNR is taken against the exact-fp32 result, on the
deterministic synthetic grayscale images of
:func:`repro_torch.data.synthetic.gray_images` (seed 42).

The multipliers come from :func:`repro_torch.core.registry.get_elementwise`,
so the AFPM designs (AC4-4, AC5-5, AC6-6, ACL5) run the bit-level Hopper
kernel on the card; the reference benchmark takes ``get_multiplier``.  The
function computed is the same bit for bit.

    python -m repro_torch.bench.table3_image                  # on the card
    python -m repro_torch.bench.table3_image --device cpu --size 64
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.metrics import psnr
from repro_torch.core.registry import get_elementwise, get_multiplier
from repro_torch.data.synthetic import gray_images

MULTS = ["AC4-4", "AC5-5", "AC6-6", "ACL5", "MMBS5", "MMBS6", "MMBS7",
         "CSS12", "CSS16", "NC", "LPC", "HPC"]

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = SOBEL_X.T.copy()

ALPHA = 0.6
SEED = 42


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number rounded once to an fp32 0-d tensor on ``like``'s
    device (the reference's ``jnp.float32(v)``)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def blend(a, b, alpha: float, mult):
    """alpha-blend: every product through the multiplier under test."""
    # 1 - alpha is taken in Python double, then rounded once to fp32
    return mult(a, _scalar(alpha, a)) + mult(b, _scalar(1.0 - alpha, a))


def conv3x3(img, kernel, mult):
    """3x3 correlation with multiplier-under-test products, exact adds
    (taken row-major over the nonzero taps, as the reference adds them)."""
    H, W = img.shape
    pad = torch.nn.functional.pad(img, (1, 1, 1, 1))
    out = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for i in range(3):
        for j in range(3):
            k = float(kernel[i, j])
            if k == 0.0:
                continue
            out = out + mult(pad[i:i + H, j:j + W], _scalar(k, img))
    return out


def edge_detect(img, mult):
    gx = conv3x3(img, SOBEL_X, mult)
    gy = conv3x3(img, SOBEL_Y, mult)
    # magnitude: squares also go through the multiplier under test.  The
    # root is taken in float64 and rounded once to float32, which is the
    # correctly rounded float32 root (53 >= 2 * 24 + 2 bits) on any device,
    # as the reference's is; PyTorch's float32 sqrt on the CPU is not
    # always correctly rounded.
    sq = mult(gx, gx) + mult(gy, gy)
    return torch.sqrt(sq.to(torch.float64)).to(torch.float32)


class Table3(NamedTuple):
    psnr: dict      # design -> [blend PSNR per pair..., edge PSNR per image...]
    seconds: dict   # design -> wall seconds (host clock, ends in host copies)
    outputs: dict   # design -> [blend..., edge...] float32 host arrays


def run(n_images: int = 3, size: int = 128, *, device=None,
        backend: str = "auto") -> Table3:
    """Table III on ``n_images`` blend pairs and edge images of
    ``size`` x ``size``, for every design in :data:`MULTS`.

    Runs on the card unless ``device="cpu"``; ``backend`` goes to the AFPM
    designs' :func:`~repro_torch.kernels.dispatch.multiply`."""
    dev = resolve_device(device)
    imgs = torch.from_numpy(gray_images(seed=SEED, n=2 * n_images, size=size)).to(dev)
    exact = get_multiplier("exact")
    ref_blend = [blend(imgs[2 * i], imgs[2 * i + 1], ALPHA, exact).cpu().numpy()
                 for i in range(n_images)]
    ref_edge = [edge_detect(imgs[i], exact).cpu().numpy() for i in range(n_images)]
    results, seconds, outputs = {}, {}, {}
    for name in MULTS:
        mult = get_elementwise(name, backend=backend)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = [blend(imgs[2 * i], imgs[2 * i + 1], ALPHA, mult).cpu().numpy()
               for i in range(n_images)]
        got += [edge_detect(imgs[i], mult).cpu().numpy() for i in range(n_images)]
        seconds[name] = time.perf_counter() - t0
        row = [psnr(g, r, peak=255.0) for g, r in zip(got, ref_blend)]
        row += [psnr(g, r, peak=float(np.max(np.abs(r))))
                for g, r in zip(got[n_images:], ref_edge)]
        results[name], outputs[name] = row, got
    return Table3(results, seconds, outputs)


def paper_claims(results: dict) -> tuple:
    """The Table III rankings: (PSNR rises with n for AC4-4 < AC5-5 <
    AC6-6, AC5-5 beats MMBS5 and HPC), both on the first blend pair."""
    blend0 = {k: v[0] for k, v in results.items()}
    ok1 = blend0["AC4-4"] < blend0["AC5-5"] < blend0["AC6-6"]
    ok2 = blend0["AC5-5"] > blend0["MMBS5"] and blend0["AC5-5"] > blend0["HPC"]
    return ok1, ok2


def report(t: Table3) -> list:
    """The table's lines: a header, one row per design, the paper claims."""
    n = len(next(iter(t.psnr.values()))) // 2
    lines = [f"{'design':8s} "
             + " ".join(f"{'blend' + str(i + 1):>8s}" for i in range(n)) + " "
             + " ".join(f"{'edge' + str(i + 1):>8s}" for i in range(n))
             + f" {'seconds':>8s}"]
    for name, row in t.psnr.items():
        lines.append(f"{name:8s} " + " ".join(f"{v:8.2f}" for v in row)
                     + f" {t.seconds[name]:8.3f}")
    ok1, ok2 = paper_claims(t.psnr)
    lines.append(f"paper-claim check: PSNR increases with n: {ok1}; "
                 f"AC5-5 beats MMBS5 & HPC: {ok2}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-images", type=int, default=3)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="auto",
                    help="auto | hopper | torch, for the AFPM designs")
    args = ap.parse_args(argv)
    t = run(args.n_images, args.size, device=args.device, backend=args.backend)
    print("== Table III: image-processing PSNR (dB) vs exact fp32 ==")
    print("\n".join(report(t)))


if __name__ == "__main__":
    main()
