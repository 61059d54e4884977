"""Device build tier (ops/device_build.py) must be BIT-identical to
the host C++ merge + dedup, including pattern id order, across
partitions and the -extend path (reference write path
src/prefix_kmer_db.cpp:244-434)."""

import os

import numpy as np
import pytest

from kmerdb_jax.models.database import KmerPatternDb
from kmerdb_jax.models import builder
from kmerdb_jax.utils import native

_FIELDS = ("kmers", "kmer_pattern_ids", "pattern_offsets",
           "pattern_sample_ids", "pattern_num_kmers")


def _build(samples, split, device):
    old = os.environ.get("KMERDB_BUILD_DEVICE")
    os.environ["KMERDB_BUILD_DEVICE"] = "1" if device else "0"
    try:
        db = builder.add_samples(
            KmerPatternDb(kmer_length=18, fraction=1.0,
                          alphabet_name="nt"), samples[:split])
        return builder.add_samples(db, samples[split:])
    finally:
        if old is None:
            del os.environ["KMERDB_BUILD_DEVICE"]
        else:
            os.environ["KMERDB_BUILD_DEVICE"] = old


@pytest.mark.parametrize("seed,partition_elems", [(4, 5000), (9, 800)])
def test_device_build_bit_identical(seed, partition_elems, monkeypatch):
    if not native.available:
        pytest.skip("no native lib")
    monkeypatch.setattr(builder, "_PARTITION_ELEMS", partition_elems)
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 34, size=3000, dtype=np.uint64)
    samples = []
    for i in range(24):
        ks = rng.choice(pool, size=int(rng.integers(200, 1200)),
                        replace=False)
        priv = rng.integers(1 << 40, 1 << 41, size=60, dtype=np.uint64)
        samples.append((f"s{i}", np.unique(np.concatenate([ks, priv]))))

    db_host = _build(samples, 16, device=False)
    db_dev = _build(samples, 16, device=True)
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(db_host, f),
                                      getattr(db_dev, f), err_msg=f)


def test_streamed_rows_match_full_matrix():
    """all2all_device_rows (stripe streaming, overlap handling,
    resident groups) emits exactly the full matrix's rows."""
    from kmerdb_jax.ops import intersect, device_a2a
    rng = np.random.default_rng(31)
    samples = [(f"s{i}", np.unique(rng.integers(
        0, 1 << 36, size=int(rng.integers(300, 1500))).astype(np.uint64)))
        for i in range(200)]    # 200 rows -> 2 x 128-row stripes, ragged
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)
    C = intersect.all2all_counts(db)
    rows = {}
    device_a2a.all2all_device_rows(
        db, lambda i, r: rows.__setitem__(i, r.copy()), stripe_rows=128)
    got = np.stack([rows[i] for i in range(db.n_samples)])
    np.testing.assert_array_equal(got, C)


def test_device_build_k32_all_set_key():
    """k = 32 makes the all-set 64-bit key a VALID k-mer, colliding
    with the device kernel's pad sentinel; the forced group boundary
    at n_valid must keep it out of the pad run (advisor round-2
    finding).  Host and device builds must stay bit-identical."""
    if not native.available:
        pytest.skip("no native lib")
    rng = np.random.default_rng(12)
    top = np.uint64(0xFFFFFFFFFFFFFFFF)
    samples = []
    for i in range(6):
        ks = rng.integers(0, 1 << 62, size=300, dtype=np.uint64)
        # every sample holds the all-set key plus a near-top cluster
        ks = np.concatenate([ks, [top, top - np.uint64(1 + i)]])
        samples.append((f"s{i}", np.unique(ks)))

    def build(device):
        old = os.environ.get("KMERDB_BUILD_DEVICE")
        os.environ["KMERDB_BUILD_DEVICE"] = "1" if device else "0"
        try:
            db = builder.add_samples(
                KmerPatternDb(kmer_length=32, fraction=1.0,
                              alphabet_name="nt"), samples[:3])
            return builder.add_samples(db, samples[3:])
        finally:
            if old is None:
                del os.environ["KMERDB_BUILD_DEVICE"]
            else:
                os.environ["KMERDB_BUILD_DEVICE"] = old

    db_host = build(False)
    db_dev = build(True)
    assert np.uint64(top) in db_host.kmers
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(db_host, f),
                                      getattr(db_dev, f), err_msg=f)


def test_streamed_sparse_pull_matches_filtered_dense():
    """Device-side filter before the pull: rows handed out equal the
    dense stripe rows with out-of-bounds cells zeroed; survivors are
    bit-exact."""
    from kmerdb_jax.ops import intersect, device_a2a
    rng = np.random.default_rng(37)
    samples = [(f"s{i}", np.unique(rng.integers(
        0, 1 << 20, size=int(rng.integers(300, 1500))).astype(np.uint64)))
        for i in range(150)]
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)
    C = intersect.all2all_counts(db)
    for lo, hi in ((1, 0xFFFFFFFF), (50, 0xFFFFFFFF), (30, 200),
                   (10**9, 0xFFFFFFFF)):
        want = np.where((C >= lo) & (C <= hi), C, 0)
        rows = {}
        device_a2a.all2all_device_rows(
            db, lambda i, r: rows.__setitem__(i, r.copy()),
            stripe_rows=128, cell_bounds=(lo, hi))
        got = np.stack([rows[i] for i in range(db.n_samples)])
        np.testing.assert_array_equal(got, want, err_msg=f"{lo}-{hi}")
        sp = device_a2a.last_stats.get("sparse_pull", {})
        assert sp.get("stripes", 0) > 0
        assert sp["survivor_cells"] >= np.count_nonzero(want)


def test_cli_sparse_stream_device_filter(tmp_path, monkeypatch):
    """`all2all -sparse -min N` through the forced streamed tier:
    byte-identical to the matrix path (device count filter is a
    superset; emit() re-applies the exact filter)."""
    from kmerdb_jax.cli.main import main as cli
    rng = np.random.default_rng(43)
    paths = []
    for i in range(24):
        seq = "".join(rng.choice(list("ACGT"), size=800))
        f = tmp_path / f"s{i}.fasta"
        f.write_text(f">s{i}\n{seq}\n")
        paths.append(str(f))
    lst = tmp_path / "samples.list"
    lst.write_text("\n".join(paths) + "\n")
    assert cli(["build", "-k", "14", str(lst), str(tmp_path / "db")]) == 0
    assert cli(["all2all", "-sparse", "-min", "2",
                str(tmp_path / "db"), str(tmp_path / "dense.csv")]) == 0
    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")
    assert cli(["all2all", "-sparse", "-min", "2",
                str(tmp_path / "db"), str(tmp_path / "stream.csv")]) == 0
    assert (tmp_path / "dense.csv").read_bytes() == \
        (tmp_path / "stream.csv").read_bytes()
