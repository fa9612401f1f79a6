"""SeCluD (Search with Clustered Documents) on PyTorch and CUDA.

The port of the JAX package ``repro`` to one NVIDIA GPU: the same host
clustering and planner (numpy), a device-resident index held as torch
tensors, and hand-written CUDA kernels (``csrc/``) for the multi-stage
fold and the intersect trio.  Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions.
"""
