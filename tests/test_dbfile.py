"""Database container: varint codecs, partial loads, compatibility.

The container (io/dbfile.py) is the checkpoint artifact; these tests
pin exact roundtrips of the compressed sections, the pure-NumPy
decoder fallback, raw-section compatibility, and truncation errors.
"""

import numpy as np
import pytest

from kmerdb_jax.io import dbfile
from kmerdb_jax.models.database import KmerPatternDb
from kmerdb_jax.utils import native

pytestmark = pytest.mark.skipif(not native.available,
                                reason="needs the C++ runtime")


@pytest.mark.parametrize("n", [0, 1, 7, 100_000])
def test_vb_delta_u64_roundtrip(n):
    rng = np.random.default_rng(n)
    a = np.sort(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    blob = native.vb_encode_delta_u64(a) if n else np.empty(0, np.uint8)
    assert np.array_equal(native.vb_decode_delta_u64(blob, n), a)
    # pure-NumPy decoder agrees (the no-compiler load path)
    assert np.array_equal(
        dbfile._vb_decode_py(np.asarray(blob), n, delta=True), a)


def test_vb_delta_u64_extremes():
    a = np.array([0, 0, 1, (1 << 64) - 1], dtype=np.uint64)
    blob = native.vb_encode_delta_u64(a)
    assert np.array_equal(native.vb_decode_delta_u64(blob, a.size), a)
    assert np.array_equal(
        dbfile._vb_decode_py(np.asarray(blob), a.size, delta=True), a)


@pytest.mark.parametrize("n", [0, 1, 100_000])
def test_vb_u32_roundtrip(n):
    rng = np.random.default_rng(n + 1)
    a = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    blob = native.vb_encode_u32(a) if n else np.empty(0, np.uint8)
    assert np.array_equal(native.vb_decode_u32(blob, n), a)
    assert np.array_equal(dbfile._vb_decode_py(
        np.asarray(blob), n, delta=False).astype(np.uint32), a)


def _tiny_db():
    return KmerPatternDb(
        kmer_length=18, fraction=0.5, start_fraction=0.0,
        alphabet_name="nt", sample_names=["a", "b", "c"],
        sample_kmer_counts=np.array([5, 7, 9], np.uint32),
        kmers=np.sort(np.array([3, 9, 12, 99, 1 << 35], np.uint64)),
        kmer_pattern_ids=np.array([0, 1, 1, 0, 2], np.int32),
        pattern_offsets=np.array([0, 2, 3, 6], np.int64),
        pattern_sample_ids=np.array([0, 1, 2, 0, 1, 2], np.uint32),
        pattern_num_kmers=np.array([2, 2, 1], np.uint32))


_ARRS = ("kmers", "kmer_pattern_ids", "pattern_offsets",
         "pattern_sample_ids", "pattern_num_kmers", "sample_kmer_counts")


def test_db_roundtrip_compressed(tmp_path):
    db = _tiny_db()
    p = str(tmp_path / "c.db")
    dbfile.save_db(db, p)
    back = dbfile.load_db(p)
    for a in _ARRS:
        assert np.array_equal(getattr(db, a), getattr(back, a)), a
    assert back.sample_names == db.sample_names
    # partial loads
    pat = dbfile.load_db(p, dbfile.PATTERNS)
    assert pat.n_patterns == 3 and pat.kmers.size == 0
    hdr = dbfile.load_db(p, dbfile.SAMPLES_ONLY)
    assert hdr.sample_names == ["a", "b", "c"]


def test_db_raw_sections_still_load(tmp_path, monkeypatch):
    """A file written without the native codecs (raw sections) loads
    identically — forward compatibility both ways."""
    db = _tiny_db()
    p = str(tmp_path / "raw.db")
    monkeypatch.setattr(native, "available", False)
    dbfile.save_db(db, p)
    monkeypatch.undo()
    back = dbfile.load_db(p)
    for a in _ARRS:
        assert np.array_equal(getattr(db, a), getattr(back, a)), a


def test_compressed_loads_without_native(tmp_path, monkeypatch):
    db = _tiny_db()
    p = str(tmp_path / "c2.db")
    dbfile.save_db(db, p)          # native codecs
    monkeypatch.setattr(native, "available", False)
    back = dbfile.load_db(p)       # NumPy varint decoder
    for a in _ARRS:
        assert np.array_equal(getattr(db, a), getattr(back, a)), a


def test_truncated_db_raises(tmp_path):
    db = _tiny_db()
    p = str(tmp_path / "t.db")
    dbfile.save_db(db, p)
    data = open(p, "rb").read()
    open(p, "wb").write(data[:len(data) - 4])
    with pytest.raises(IOError, match="Truncated"):
        dbfile.load_db(p)
