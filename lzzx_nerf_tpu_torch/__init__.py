"""PyTorch/CUDA port of lzzx_nerf_tpu: the serving path and the training
recipe (head, lips finetune with LPIPS, torso), whose production state the
port's own session serves.

A second package beside the JAX one: plain tensor code is PyTorch, and the
two Pallas kernels of the serving frame (the fused field MLP and the nb5w
march select) are hand-written CUDA kernels for Hopper (``csrc/``), built
with nvcc at first use (``kernels.py``). Training runs PyTorch autograd
(the JAX package differentiates plain XLA there: no kernel to port), and
LPIPS's convolutions are PyTorch's. ``parallel/`` trains data-parallel
over a torch.distributed group (NCCL on GPUs) and serves frame-parallel
over several devices.

The package imports torch, numpy and the standard library only — never
JAX and never ``lzzx_nerf_tpu``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a CPU tensor every kernel wrapper runs
its plain PyTorch version instead.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
