"""Tensor ops of the port: plain PyTorch versions and the CUDA kernel wrappers.

* :mod:`.color`, :mod:`.resize`, :mod:`.srcnn`, :mod:`.vdsr`,
  :mod:`.rcan`, :mod:`.swinir`, :mod:`.quantize` — plain PyTorch, any
  device;
* :mod:`.cuda_resize` (K2), :mod:`.cuda_srcnn` (K1, K4 conv+merge, K5
  f32-output conv), :mod:`.cuda_merge` (K3), :mod:`.cuda_vdsr` (the VDSR
  chain), :mod:`.cuda_rcan` (RCAN), :mod:`.cuda_swinir` (SwinIR) —
  wrappers that launch a hand-written CUDA kernel for CUDA tensors and
  run their plain version for CPU tensors.
"""
