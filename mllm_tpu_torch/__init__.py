"""mllm_tpu_torch: the PyTorch / CUDA (Hopper) port of mllm_tpu.

The JAX package `mllm_tpu` is the reference; this package mirrors its layout
(core/, nn/, kv/, ops/, models/, generation/, utils/) and never imports it or
JAX. Its attention kernels are hand-written CUDA in csrc/, compiled by nvcc
at first use (ops/_build.py); on CPU tensors every kernel wrapper runs its
plain PyTorch version.
"""
