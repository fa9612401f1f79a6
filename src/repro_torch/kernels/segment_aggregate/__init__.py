from repro_torch.kernels.segment_aggregate.ops import EdgeCSR, edge_csr, segment_aggregate
from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref

__all__ = ["EdgeCSR", "edge_csr", "segment_aggregate", "segment_aggregate_ref"]
