"""The port's Table III image pipeline against the JAX package's.

The images come from one seed on both sides; every design's blend and
edge outputs are compared bit for bit with the reference benchmark's
functions (``benchmarks/table3_image.py``) on the CPU, and the PSNRs of
the reference's own CPU run (``benchmarks/BENCH_cpu_ci.json``) are
reproduced to 1e-9 dB.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import table3_image as j_t3
from repro.core.registry import get_multiplier as j_get_multiplier
from repro.data.synthetic import gray_images as j_gray_images
from repro_torch.bench import table3_image as t_t3
from repro_torch.core.registry import get_elementwise
from repro_torch.data.synthetic import gray_images
from repro_torch.kernels import afpm_bitwise as t_kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = 32


@pytest.fixture(scope="module")
def images():
    return gray_images(seed=42, n=2, size=SIZE)


def test_gray_images_bit_identical():
    for seed, n, size in [(42, 2, 32), (0, 3, 17)]:
        np.testing.assert_array_equal(gray_images(seed, n, size),
                                      j_gray_images(seed, n, size))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", ["exact"] + t_t3.MULTS)
def test_blend_and_edge_bit_identical(name, images):
    a, b = images
    jm, tm = j_get_multiplier(name), get_elementwise(name)
    want_blend = j_t3.blend(jnp.asarray(a), jnp.asarray(b), 0.6, jm)
    got_blend = t_t3.blend(torch.from_numpy(a), torch.from_numpy(b), 0.6, tm)
    np.testing.assert_array_equal(_bits(got_blend), _bits(want_blend))
    want_edge = j_t3.edge_detect(jnp.asarray(a), jm)
    got_edge = t_t3.edge_detect(torch.from_numpy(a), tm)
    np.testing.assert_array_equal(_bits(got_edge), _bits(want_edge))


def test_run_psnrs_equal_jax_on_cpu():
    t = t_t3.run(n_images=1, size=SIZE, device="cpu")
    a, b = j_gray_images(42, 2, SIZE)
    exact = j_get_multiplier("exact")
    ref_b = np.asarray(j_t3.blend(jnp.asarray(a), jnp.asarray(b), 0.6, exact))
    ref_e = np.asarray(j_t3.edge_detect(jnp.asarray(a), exact))
    from repro.core.metrics import psnr

    assert list(t.psnr) == t_t3.MULTS == j_t3.MULTS
    for name in t_t3.MULTS:
        m = j_get_multiplier(name)
        want = [psnr(np.asarray(j_t3.blend(jnp.asarray(a), jnp.asarray(b), 0.6, m)),
                     ref_b, peak=255.0),
                psnr(np.asarray(j_t3.edge_detect(jnp.asarray(a), m)), ref_e,
                     peak=float(np.max(np.abs(ref_e))))]
        assert t.psnr[name] == want, name
        assert len(t.outputs[name]) == 2 and t.seconds[name] >= 0.0


def test_run_reproduces_the_reference_cpu_bench():
    """All 24 PSNRs of the reference's Table III CPU run (size 96, 2 pairs)."""
    bench = json.loads((ROOT / "benchmarks" / "BENCH_cpu_ci.json").read_text())
    t = t_t3.run(n_images=2, size=96, device="cpu")
    for name, row in t.psnr.items():
        for kind, got in (("blend", row[0]), ("edge", row[2])):
            want = bench["metrics"][f"table3_{name}_psnr_{kind}"]["value"]
            assert abs(got - want) <= 1e-9, (name, kind, got, want)
    assert t_t3.paper_claims(t.psnr) == (True, True)
    lines = t_t3.report(t)
    assert len(lines) == 2 + len(t_t3.MULTS) and "AC5-5" in lines[2]


def test_cpu_run_counts_no_kernel_launch():
    before = t_kernel.afpm_bitwise.launches
    t_t3.run(n_images=1, size=8, device="cpu")
    assert t_kernel.afpm_bitwise.launches == before


def test_main_prints_the_table(capsys):
    t_t3.main(["--n-images", "1", "--size", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Table III" in out and "paper-claim check" in out
