"""The benchmark's command on the card: one short run of each cell of
``BENCHMARK.json`` prints one JSON line with the contract's keys and comes
out correct.  Needs a CUDA device; run on the card with
``pytest -m cuda chipbench/tests``."""
import json
import pathlib
import subprocess
import sys

import pytest

import tiny_chipbench  # noqa: F401
from chipbench import tracing

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_one_short_run_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", name, "--seed",
         "2147483711", "--seconds", "30", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


class _Ev:
    def __init__(self, name, start, end, device, parent=None):
        import torch

        self.name = name
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.cpu_parent = parent


def test_trace_reduction_on_synthetic_events():
    span = _Ev(tracing.SPAN, 0, 100, False)
    dec = _Ev("chipbench.decode.premium", 10, 60, False)
    op = _Ev("aten::to", 30, 40, False, parent=dec)
    k1 = _Ev("void afpm_matmul_kernel<bf16, 1>(...)", 20, 30, True)
    other = _Ev("gemm", 25, 50, True)
    late = _Ev("copy", 90, 120, True)         # clipped at the span's end
    got = tracing.reduce_events([span, dec, op, k1, other, late])
    assert got["window_s"] == 100e-6
    assert got["busy_s"] == pytest.approx((50 - 20 + 100 - 90) * 1e-6)
    assert got["k1_kernels"] == 1 and got["k1_s"] == pytest.approx(10e-6)
    idle = dict(got["idle_gaps"])
    # 0-20: no annotation open at 0; 50-90: in decode until 60 (the gap
    # starts at 50, inside decode, after aten::to ended)
    assert idle["harness"] == pytest.approx(20e-6)
    assert idle["decode.premium"] == pytest.approx(40e-6)
