"""Hand-written CUDA kernels of the port (sources in ``csrc/``).

* ``build``         — one ``nvcc`` build per source for ``sm_90a``, the
                      ``ctypes`` loader and the launch counters of every
                      kernel (:data:`repro_torch.kernels.build.LAUNCHES`).
* ``intersect``     — the multi-stage fold of the device engine
                      (``segment_fold``) and the intersect trio of the
                      block serving path.
* ``cluster_score`` — the δ⁺ scoring gather of the device K-means
                      (``cluster_scores``) and ``embedding_bag``.
* ``flash_attention`` — attention, forward and backward.
* ``segment_aggregate`` — PNA's aggregation (mean, max, min, std, degree)
                      over destination-sorted edges, forward and backward.

Each kernel package has its plain PyTorch version (``ref.py``), its
ctypes launcher (``kernel.py``) and the public wrapper (``ops.py``) that
takes the plain version for CPU tensors and the kernel for CUDA tensors.
"""
from repro_torch.kernels.intersect.ops import intersect_count, intersect_members, segment_fold
from repro_torch.kernels.intersect.ref import PAD, intersect_count_ref

__all__ = ["PAD", "intersect_count", "intersect_count_ref", "intersect_members", "segment_fold"]
