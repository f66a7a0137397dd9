"""PyTorch + CUDA port of hierdiff_tpu: the coarse stage (sampler and
training), the fine and refine stages (sampling with the native and Python
searches, the round-based sampler, training), the overlapped ``generate``
pipeline, the chemistry and the evaluation panel, the JT-VAE stack, the
preprocessing CLI and the run utilities; every module of ``hierdiff_tpu``
has its counterpart here.

The layout mirrors ``hierdiff_tpu`` module for module. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; the two fused EGNN
layers launch hand-written Hopper kernels (``csrc/``) on CUDA tensors and use
their plain PyTorch versions only on CPU tensors. Under autograd the GCL's
kernel runs as an autograd Function whose backward is a kernel too.
"""
