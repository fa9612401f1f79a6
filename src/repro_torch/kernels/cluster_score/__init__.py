from repro_torch.kernels.cluster_score.ops import cluster_scores, embedding_bag
from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

__all__ = ["cluster_scores", "cluster_scores_ref", "embedding_bag"]
