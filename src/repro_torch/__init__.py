"""PyTorch/CUDA port of :mod:`repro` for one NVIDIA H100 (Hopper, sm_90a).

The package keeps ``repro``'s module layout and public names, so each
module's counterpart is easy to find, but it is written in PyTorch idiom
and imports neither ``jax`` nor anything of ``repro``.  Entry points
(:class:`repro_torch.session.Session`, the serving engine,
:func:`repro_torch.launch.serve.serve`) run on ``cuda`` unless the caller
passes ``device="cpu"``; on a host with no CUDA they raise instead of
carrying on on the CPU.

The one TPU kernel on this slice's path, the segmented split-float matmul,
is a hand-written CUDA C++ kernel (``kernels/csrc/afpm_matmul.cu``) built
with ``nvcc`` at first use; on CPU tensors its plain PyTorch version runs.
"""
