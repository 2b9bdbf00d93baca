"""Run one cell of the port's benchmark once and print one JSON line.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled span of the window.  A machine without
them, or a checkout without the program, exits non-zero with no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache a run may fill lives at a fixed path in the checkout
    build = ROOT / "build" / "chipbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    from chipbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
