"""Hand-written CUDA kernels of the search path (sources in ``csrc/``).

* ``intersect`` — the multi-stage fold of the device engine
                  (``segment_fold``) and the intersect trio of the block
                  serving path; each with its plain PyTorch version
                  (``ref.py``), its ctypes launcher (``kernel.py``) and
                  the public wrapper (``ops.py``) that takes the plain
                  version for CPU tensors and the kernel for CUDA tensors.
"""
