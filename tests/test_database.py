"""Database build + counting vs. the reference's synth golden matrix.

test/synth/a2a was produced by the reference CLI on synth.fa
(k=21, multisample fasta); its counts are the ground truth for the
whole build->all2all path.
"""

import numpy as np
import pytest

from kmerdb_jax.ops.alphabet import get_alphabet
from kmerdb_jax.io import fasta, ingest, dbfile
from kmerdb_jax.models.database import KmerPatternDb
from kmerdb_jax.models import builder
from kmerdb_jax.ops import intersect

K = 21


def _build_synth_db(reference_test_dir, batch=None):
    path = reference_test_dir / "synth" / "synth.fa"
    headers, seqs = fasta.split_contigs(fasta.read_raw(str(path)))
    alph = get_alphabet("nt")
    samples = [(h.decode(), ingest.extract_sample_kmers([s], K, alph))
               for h, s in zip(headers, seqs)]
    db = KmerPatternDb(kmer_length=K, fraction=1.0, alphabet_name="nt")
    if batch is None:
        return builder.add_samples(db, samples)
    for i in range(0, len(samples), batch):
        db = builder.add_samples(db, samples[i:i + batch])
    return db


def _golden_counts(reference_test_dir):
    lines = (reference_test_dir / "synth" / "a2a").read_text().splitlines()
    names = [t for t in lines[0].split(",db-samples ,")[1].split(",") if t]
    totals = [int(t) for t in lines[1].split(",")[2:] if t]
    S = len(names)
    C = np.zeros((S, S), dtype=np.uint32)
    for i, line in enumerate(lines[2:]):
        parts = [p for p in line.split(",")[2:] if p]
        for j, v in enumerate(parts):
            C[i, j] = C[j, i] = int(v)
    return names, totals, C


def test_build_counts_match_golden(reference_test_dir):
    db = _build_synth_db(reference_test_dir)
    names, totals, want = _golden_counts(reference_test_dir)
    assert db.sample_names == names
    assert [int(c) for c in db.sample_kmer_counts] == totals

    got = intersect.all2all_counts(db)
    # compare strict lower triangle
    S = len(names)
    tri = np.tril_indices(S, k=-1)
    np.testing.assert_array_equal(got[tri], want[tri])
    # diagonal must equal per-sample totals
    np.testing.assert_array_equal(np.diag(got).astype(int), totals)


def test_incremental_build_equals_batch(reference_test_dir):
    """extend ≡ rebuild (the reference CI's -extend metamorphic test)."""
    full = _build_synth_db(reference_test_dir)
    inc = _build_synth_db(reference_test_dir, batch=2)
    assert full.sample_names == inc.sample_names
    np.testing.assert_array_equal(full.kmers, inc.kmers)
    np.testing.assert_array_equal(
        intersect.all2all_counts(full), intersect.all2all_counts(inc))
    # pattern decomposition must partition the k-mer set identically
    for db in (full, inc):
        assert int(db.pattern_num_kmers.sum()) == db.n_kmers


def test_one2all_matches_all2all_rows(reference_test_dir):
    db = _build_synth_db(reference_test_dir)
    C = intersect.all2all_counts(db)
    path = reference_test_dir / "synth" / "synth.fa"
    _, seqs = fasta.split_contigs(fasta.read_raw(str(path)))
    alph = get_alphabet("nt")
    for i, s in enumerate(seqs):
        q = ingest.extract_sample_kmers([s], K, alph)
        sims = intersect.one2all_counts(db, q)
        np.testing.assert_array_equal(sims, C[i])


def test_db2db_matches_all2all(reference_test_dir):
    """Cross-DB counts over a 2/3 sample split == monolithic counts."""
    path = reference_test_dir / "synth" / "synth.fa"
    headers, seqs = fasta.split_contigs(fasta.read_raw(str(path)))
    alph = get_alphabet("nt")
    samples = [(h.decode(), ingest.extract_sample_kmers([s], K, alph))
               for h, s in zip(headers, seqs)]
    empty = KmerPatternDb(kmer_length=K, fraction=1.0, alphabet_name="nt")
    db_a = builder.add_samples(empty, samples[:2])
    db_b = builder.add_samples(empty, samples[2:])
    full = builder.add_samples(empty, samples)
    C = intersect.all2all_counts(full)
    X = intersect.db2db_counts(db_a, db_b)
    np.testing.assert_array_equal(X, C[:2, 2:])


def test_serialization_roundtrip(tmp_path, reference_test_dir):
    db = _build_synth_db(reference_test_dir)
    p = str(tmp_path / "synth.db")
    dbfile.save_db(db, p)
    full = dbfile.load_db(p, dbfile.EVERYTHING)
    np.testing.assert_array_equal(full.kmers, db.kmers)
    np.testing.assert_array_equal(full.pattern_sample_ids, db.pattern_sample_ids)
    assert full.sample_names == db.sample_names
    assert full.kmer_length == K and full.fraction == 1.0

    part = dbfile.load_db(p, dbfile.PATTERNS)
    assert part.n_kmers == 0
    np.testing.assert_array_equal(part.pattern_num_kmers, db.pattern_num_kmers)

    hdr = dbfile.load_db(p, dbfile.SAMPLES_ONLY)
    assert hdr.sample_names == db.sample_names
    assert hdr.n_patterns == 0
