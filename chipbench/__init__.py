"""chipbench: the benchmark of the PyTorch and CUDA port (``repro_torch``)
on one NVIDIA H100.  ``python3 chipbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell once and prints one JSON
line."""
