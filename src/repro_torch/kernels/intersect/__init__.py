from repro_torch.kernels.intersect.ops import intersect_count, intersect_members, segment_fold
from repro_torch.kernels.intersect.ref import PAD, intersect_count_ref

__all__ = ["PAD", "intersect_count", "intersect_count_ref", "intersect_members", "segment_fold"]
