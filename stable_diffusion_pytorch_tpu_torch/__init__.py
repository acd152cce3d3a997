"""stable_diffusion_pytorch_tpu_torch: the PyTorch/CUDA port of stable_diffusion_pytorch_tpu.

The JAX package beside it is the reference; this package computes the same
functions in PyTorch, with the same parameter layouts, and runs them on an
NVIDIA Hopper card. Every Pallas kernel on the ported path has a kernel
written by hand for Hopper here:

    ops/        attention and GroupNorm dispatch; the kernel wrappers
                (flash_attention.py: CUDA C++; fused_groupnorm.py: Triton)
    csrc/       CUDA C++ sources, built with nvcc at first use
    models/     nn.Modules in the JAX package's NHWC layout, reference torch
                parameter names (UNet, VAE), HF names (CLIP)
    utils/      weight conversion from the JAX parameter trees, image IO
    pipeline.py text-to-image sampling; scripts/txt2img.py is its CLI

A wrapper runs its kernel's plain PyTorch version only for a tensor on the
CPU; a CUDA tensor launches the kernel or raises. The package never imports
jax or flax.
"""

__version__ = "0.1.0"
