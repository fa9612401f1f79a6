"""Posting-list compression (paper Appendix A): the port's own copy of
``repro.index.compress`` (pure numpy; it imports nothing of the JAX package).

Posting lists are stored as gaps ``g_i = d_i - d_{i-1}`` (g_0 = d_0 + 1,
all gaps >= 1) and the gaps entropy-coded.  The paper compares Golomb
coding (best WITHOUT clustering) against Elias-gamma/delta (best WITH
clustering, because they adapt to the locally varying gap distribution
that cluster-contiguous reordering creates).

We implement bit-exact encoders/decoders (for tests) plus fast
vectorized bit-counting (for the Figure-8 benchmark, which only needs
sizes).

Codes
-----
* unary(q):        q ones then a zero                  -> q + 1 bits
* Elias-gamma(g):  floor(log2 g) zeros, then g         -> 2*floor(log2 g) + 1
* Elias-delta(g):  gamma(floor(log2 g)+1) then g's low -> log g + 2 log log g + O(1)
* Golomb(g; b):    unary((g-1) // b) + truncated-binary remainder
  with the Gallager–van Voorhis optimal b from the list density.
* varbyte:         7 data bits / byte, MSB continuation.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np

__all__ = [
    "gaps_of",
    "posting_bits",
    "index_bits_per_posting",
    "encode_gaps",
    "decode_gaps",
    "golomb_parameter",
]


def gaps_of(postings: np.ndarray) -> np.ndarray:
    """Doc-id list -> gap list (all >= 1)."""
    postings = np.asarray(postings, dtype=np.int64)
    if len(postings) == 0:
        return postings
    g = np.empty_like(postings)
    g[0] = postings[0] + 1
    np.subtract(postings[1:], postings[:-1], out=g[1:])
    if (g <= 0).any():
        raise ValueError("postings must be strictly increasing")
    return g


def golomb_parameter(n_docs: int, list_len: int) -> int:
    """Gallager–van Voorhis optimal Golomb parameter for a Bernoulli gap
    model with density p = list_len / n_docs:  b = ceil(log(2-p)/-log(1-p)),
    commonly approximated b ~ 0.69 * mean_gap."""
    if list_len <= 0:
        return 1
    p = min(list_len / max(n_docs, 1), 1 - 1e-12)
    if p <= 1e-12:
        return max(1, int(0.69 * n_docs))
    return max(1, int(math.ceil(math.log(2.0 - p) / -math.log(1.0 - p))))


# ---------------------------------------------------------------------------
# Bit counting (vectorized; used by benchmarks)
# ---------------------------------------------------------------------------


def _floor_log2(g: np.ndarray) -> np.ndarray:
    return np.frexp(g.astype(np.float64))[1] - 1  # exact for g < 2^52


def _gamma_bits(g: np.ndarray) -> np.ndarray:
    return 2 * _floor_log2(g) + 1


def _delta_bits(g: np.ndarray) -> np.ndarray:
    L = _floor_log2(g)
    return L + _gamma_bits(L + 1)


def _golomb_bits(g: np.ndarray, b: int) -> np.ndarray:
    q = (g - 1) // b
    # truncated binary: ceil(log2 b) bits for small remainders else floor+1
    k = int(math.ceil(math.log2(b))) if b > 1 else 0
    cut = (1 << k) - b  # remainders < cut use k-1 bits
    r = (g - 1) % b
    rbits = np.where(r < cut, max(k - 1, 0), k) if b > 1 else 0
    return q + 1 + rbits


def _varbyte_bits(g: np.ndarray) -> np.ndarray:
    nbytes = np.maximum(1, (_floor_log2(g) + 7) // 7)
    return 8 * nbytes


def posting_bits(postings: np.ndarray, n_docs: int, code: str) -> int:
    """Exact encoded size in bits of one posting list under ``code``."""
    if len(postings) == 0:
        return 0
    g = gaps_of(postings)
    if code == "gamma":
        return int(_gamma_bits(g).sum())
    if code == "delta":
        return int(_delta_bits(g).sum())
    if code == "golomb":
        return int(_golomb_bits(g, golomb_parameter(n_docs, len(postings))).sum())
    if code == "varbyte":
        return int(_varbyte_bits(g).sum())
    if code == "raw":
        return 32 * len(postings)
    raise ValueError(f"unknown code {code!r}")


def index_bits_per_posting(index, codes: Iterable[str] = ("golomb", "gamma", "delta", "varbyte")) -> Dict[str, float]:
    """Average bits per posting over a whole InvertedIndex (Figure 8):
    the port's :class:`repro_torch.index.build.InvertedIndex` (``post_ptr``,
    ``postings(t)``, ``n_docs``)."""
    lens = np.diff(index.post_ptr)
    out: Dict[str, float] = {}
    for code in codes:
        total = 0
        for t in np.flatnonzero(lens):
            total += posting_bits(index.postings(int(t)), index.n_docs, code)
        out[code] = total / max(int(lens.sum()), 1)
    return out


# ---------------------------------------------------------------------------
# Bit-exact encode/decode (tests prove losslessness)
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def write(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def write_unary(self, q: int) -> None:
        self.bits.extend([1] * q)
        self.bits.append(0)

    def pack(self) -> np.ndarray:
        return np.packbits(np.asarray(self.bits, dtype=np.uint8))


class _BitReader:
    def __init__(self, packed: np.ndarray, nbits: int):
        self.bits = np.unpackbits(packed)[:nbits]
        self.pos = 0

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v

    def read_unary(self) -> int:
        q = 0
        while self.bits[self.pos] == 1:
            q += 1
            self.pos += 1
        self.pos += 1
        return q


def encode_gaps(gaps: np.ndarray, code: str, b: int | None = None) -> Tuple[np.ndarray, int]:
    """Encode gaps; returns (packed uint8 array, total bits)."""
    w = _BitWriter()
    for g in np.asarray(gaps, dtype=np.int64):
        g = int(g)
        if code == "gamma":
            L = g.bit_length() - 1
            w.write_unary(L)
            w.write(g - (1 << L), L)
        elif code == "delta":
            L = g.bit_length() - 1
            LL = (L + 1).bit_length() - 1
            w.write_unary(LL)
            w.write((L + 1) - (1 << LL), LL)
            w.write(g - (1 << L), L)
        elif code == "golomb":
            assert b is not None and b >= 1
            q, r = divmod(g - 1, b)
            w.write_unary(q)
            if b > 1:
                k = int(math.ceil(math.log2(b)))
                cut = (1 << k) - b
                if r < cut:
                    w.write(r, k - 1)
                else:
                    w.write(r + cut, k)
        elif code == "varbyte":
            chunks = []
            v = g
            while True:
                chunks.append(v & 0x7F)
                v >>= 7
                if v == 0:
                    break
            for i, c in enumerate(reversed(chunks)):
                cont = 0x80 if i < len(chunks) - 1 else 0
                w.write(cont | c, 8)
        else:
            raise ValueError(code)
    packed = w.pack()
    return packed, len(w.bits)


def decode_gaps(packed: np.ndarray, nbits: int, n: int, code: str, b: int | None = None) -> np.ndarray:
    """Inverse of encode_gaps (n gaps)."""
    r = _BitReader(packed, nbits)
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        if code == "gamma":
            L = r.read_unary()
            out[i] = (1 << L) | r.read(L)
        elif code == "delta":
            LL = r.read_unary()
            L = ((1 << LL) | r.read(LL)) - 1
            out[i] = (1 << L) | r.read(L)
        elif code == "golomb":
            assert b is not None and b >= 1
            q = r.read_unary()
            rem = 0
            if b > 1:
                k = int(math.ceil(math.log2(b)))
                cut = (1 << k) - b
                rem = r.read(k - 1)
                if rem >= cut:
                    rem = ((rem << 1) | r.read(1)) - cut
            out[i] = q * b + rem + 1
        elif code == "varbyte":
            v = 0
            while True:
                byte = r.read(8)
                v = (v << 7) | (byte & 0x7F)
                if not byte & 0x80:
                    break
            out[i] = v
        else:
            raise ValueError(code)
    return out
