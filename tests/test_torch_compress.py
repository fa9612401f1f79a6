"""The port's posting compression (``repro_torch.index.compress``, the
paper's Appendix A) against the JAX package's ``repro.index.compress``:
bit counts and packed bytes equal for every code, the encode/decode
round trip for every code, and bits per posting over the port's index
of ``small_corpus`` equal to the reference's over its own.  Everything is
integer arithmetic: equality, no tolerance."""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st  # hypothesis, or fallback

from repro.index import compress as ref
from repro.index.build import build_index as ref_build_index
from repro_torch.data.corpus import Corpus
from repro_torch.index import compress as port
from repro_torch.index.build import build_index

CODES = ("gamma", "delta", "varbyte", "golomb")


def _golomb_b(code, gaps):
    return max(1, int(np.median(gaps))) if code == "golomb" else None


def test_port_module_is_its_own_copy():
    assert port is not ref
    assert port.__file__ != ref.__file__


@pytest.mark.parametrize("code", CODES)
def test_packed_words_equal_the_reference_and_round_trip(code, rng):
    gaps = rng.integers(1, 20_000, size=300)
    b = _golomb_b(code, gaps)
    packed, nbits = port.encode_gaps(gaps, code, b=b)
    want_packed, want_nbits = ref.encode_gaps(gaps, code, b=b)
    assert nbits == want_nbits
    np.testing.assert_array_equal(packed, want_packed)
    np.testing.assert_array_equal(port.decode_gaps(packed, nbits, len(gaps), code, b=b), gaps)


@settings(max_examples=30, deadline=None)
@given(
    st.lists(st.integers(0, 1 << 20), min_size=1, max_size=60, unique=True),
    st.sampled_from(CODES),
)
def test_bits_and_words_equal_the_reference_property(doc_ids, code):
    postings = np.sort(np.asarray(doc_ids, dtype=np.int64))
    n_docs = int(postings[-1]) + 1
    assert port.posting_bits(postings, n_docs, code) == ref.posting_bits(postings, n_docs, code)
    np.testing.assert_array_equal(port.gaps_of(postings), ref.gaps_of(postings))
    b = port.golomb_parameter(n_docs, len(postings)) if code == "golomb" else None
    assert b == (ref.golomb_parameter(n_docs, len(postings)) if code == "golomb" else None)
    packed, nbits = port.encode_gaps(port.gaps_of(postings), code, b=b)
    want_packed, want_nbits = ref.encode_gaps(ref.gaps_of(postings), code, b=b)
    assert nbits == want_nbits == port.posting_bits(postings, n_docs, code)
    np.testing.assert_array_equal(packed, want_packed)
    got = port.decode_gaps(packed, nbits, len(postings), code, b=b)
    np.testing.assert_array_equal(np.cumsum(got) - 1, postings)


def test_golomb_round_trips_for_every_parameter(rng):
    for b in (1, 2, 3, 5, 7, 16, 100, 4096):
        gaps = rng.integers(1, 8 * b + 2, size=80)
        packed, nbits = port.encode_gaps(gaps, "golomb", b=b)
        np.testing.assert_array_equal(packed, ref.encode_gaps(gaps, "golomb", b=b)[0])
        np.testing.assert_array_equal(port.decode_gaps(packed, nbits, len(gaps), "golomb", b=b),
                                      gaps)


def test_index_bits_per_posting_equals_the_reference(small_corpus):
    corpus = Corpus(doc_ptr=small_corpus.doc_ptr.copy(), doc_terms=small_corpus.doc_terms.copy(),
                    n_terms=small_corpus.n_terms)
    codes = ("golomb", "gamma", "delta", "varbyte", "raw")
    got = port.index_bits_per_posting(build_index(corpus), codes=codes)
    want = ref.index_bits_per_posting(ref_build_index(small_corpus), codes=codes)
    assert got == want
    assert got["raw"] == 32.0 and 0 < got["gamma"] < 32


def test_clustered_order_compresses_better(rng):
    """Appendix A's effect, on the port: cluster-contiguous posting lists
    compress better under Elias codes than uniformly random ids."""
    n_docs, ln = 1 << 16, 4096
    uniform = np.sort(rng.choice(n_docs, ln, replace=False))
    clustered = np.sort(rng.choice(n_docs // 10, ln, replace=False)) + 1000
    for code in ("gamma", "delta"):
        assert port.posting_bits(clustered, n_docs, code) < port.posting_bits(uniform, n_docs, code)


def test_unknown_code_and_unsorted_postings_raise():
    with pytest.raises(ValueError):
        port.posting_bits(np.array([1, 2]), 10, "huffman")
    with pytest.raises(ValueError):
        port.gaps_of(np.array([3, 3]))
