"""PyTorch/CUDA port of :mod:`repro` for one NVIDIA H100 (Hopper, sm_90a).

The package keeps ``repro``'s module layout and public names, so each
module's counterpart is easy to find, but it is written in PyTorch idiom
and imports neither ``jax`` nor anything of ``repro``.  Entry points
(:class:`repro_torch.session.Session` with ``from_resnet`` and
``from_pretrained``, the serving engine,
:func:`repro_torch.launch.serve.serve`, the Table II, III and IV drivers
under :mod:`repro_torch.bench`) run on ``cuda`` unless the caller passes
``device="cpu"``; on a host with no CUDA they raise instead of carrying on
on the CPU.

The reference's three TPU kernels are hand-written CUDA C++ kernels here,
built with ``nvcc`` at first use: the segmented split-float matmul of the
serving path and the ResNet's approximate convs
(``kernels/csrc/afpm_matmul.cu``), the paper's bit-level AC-n-n / ACL-n
multiplier of the image-processing path and Table III
(``kernels/csrc/afpm_bitwise.cu``), and the Mamba2 SSD chunked scan
(``kernels/csrc/ssd_scan.cu``).  On CPU tensors their plain PyTorch
versions run.
"""
