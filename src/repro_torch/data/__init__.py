"""Synthetic corpora and query logs (seeded numpy generators)."""

from repro_torch.data.corpus import Corpus, CorpusSpec, corpus_stats, synth_corpus
from repro_torch.data.query_log import QueryLog, synth_query_log, term_probabilities

__all__ = [
    "Corpus",
    "CorpusSpec",
    "synth_corpus",
    "corpus_stats",
    "QueryLog",
    "synth_query_log",
    "term_probabilities",
]
