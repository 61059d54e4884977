"""KmerPatternDb — the k-mer pattern database.

Replaces the reference's PrefixKmerDb (src/prefix_kmer_db.{h,cpp}):
instead of 2^prefix_bits linear-probing hashtables plus an
Elias-gamma-compressed pattern forest (src/pattern.h), the database is
a set of flat tensors designed for device-resident querying:

* ``kmers``            uint64[N]  sorted ascending — membership is a
                                   vectorized binary search, insertion
                                   is a sorted merge (no hashtables);
* ``kmer_pattern_ids`` int32[N]   pattern id per k-mer;
* pattern CSR          (``pattern_offsets`` int64[P+1],
                        ``pattern_sample_ids`` uint32[nnz]) — each
                        pattern is the exact set of samples containing
                        its k-mers, ids ascending;
* ``pattern_num_kmers`` uint32[P] — k-mers carrying that pattern
                                    (the Gram-matrix weight w_p).

Semantics are identical to the reference's pattern decomposition: a
pattern is a distinct sample-set, and common-kmer counts decompose as
C = B^T diag(w) B over pattern incidence vectors
(similarity_calculator.cpp:42-438's HOT LOOP B re-expressed as
matrix contractions — see ops/gram.py).

Unlike the reference's per-sample incremental insert (addKmers,
prefix_kmer_db.cpp:244-434), construction is *batched*: see
models/builder.py.
"""

from dataclasses import dataclass, field

import numpy as np


@dataclass
class KmerPatternDb:
    kmer_length: int = 0
    fraction: float = 1.0
    start_fraction: float = 0.0
    alphabet_name: str = "nt"

    sample_names: list = field(default_factory=list)
    sample_kmer_counts: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.uint32))

    kmers: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    kmer_pattern_ids: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.int32))

    pattern_offsets: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.int64))
    pattern_sample_ids: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.uint32))
    pattern_num_kmers: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.uint32))

    @property
    def n_samples(self) -> int:
        return len(self.sample_names)

    @property
    def n_kmers(self) -> int:
        return int(self.kmers.size)

    @property
    def n_patterns(self) -> int:
        return int(self.pattern_num_kmers.size)

    @property
    def is_initialized(self) -> bool:
        return self.kmer_length > 0 and self.n_samples > 0

    def pattern_samples(self, pid: int) -> np.ndarray:
        lo, hi = self.pattern_offsets[pid], self.pattern_offsets[pid + 1]
        return self.pattern_sample_ids[lo:hi]

    def element_pattern_ids(self) -> np.ndarray:
        """int32[nnz]: CSR row index per flat pattern-sample element."""
        lens = np.diff(self.pattern_offsets)
        return np.repeat(np.arange(self.n_patterns, dtype=np.int32), lens)

    def check_sample_compat(self, kmer_length: int, fraction: float,
                            alphabet_name: str) -> None:
        """Consistency checks per AbstractKmerDb::addKmers (kmer_db.h:112-125)."""
        if not self.is_initialized:
            return
        if kmer_length != self.kmer_length:
            raise ValueError("k-mer length mismatch with database")
        if fraction != self.fraction:
            raise ValueError("minhash fraction mismatch with database")
        if alphabet_name != self.alphabet_name:
            raise ValueError("alphabet mismatch with database")
