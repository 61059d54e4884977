"""KMC input round-trip, -sample-rows, and Phylip output tests.

No reference goldens exist for these paths (CI never exercises KMC or
sampling), so they are locked down with round-trip and self-consistency
oracles instead.
"""

import os
import pathlib

import numpy as np
import pytest

from kmerdb_jax.cli.main import main
from kmerdb_jax.io import kmc
from kmerdb_jax.ops.alphabet import get_alphabet
from kmerdb_jax.io import ingest

REF = pathlib.Path("/root/reference")


def _random_kmer_set(rng, k, n):
    kmers = rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64)
    return np.unique(kmers)


def test_kmc1_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    k = 18
    kmers = _random_kmer_set(rng, k, 5000)
    base = str(tmp_path / "sample")
    kmc.write_kmc1(base, kmers, k)
    out = kmc.load(base, fraction=1.0)
    assert out is not None
    got, got_k = out
    assert got_k == k
    # loader output order is record order == sorted; the >=8-bit-prefix
    # shift is applied on load (prefix_bits = 36-32 = 4 < 8 for k=18)
    from kmerdb_jax.ops import extract
    shift, tail = extract.prefix_shift(k, 2)
    want = (kmers << np.uint64(shift)) | (kmers & np.uint64(tail))
    np.testing.assert_array_equal(np.sort(got), np.sort(want))


def test_kmc1_roundtrip_k32_and_minhash(tmp_path):
    rng = np.random.default_rng(6)
    k = 24  # prefix_bits = 16 >= 8: no shift
    kmers = _random_kmer_set(rng, k, 3000)
    base = str(tmp_path / "s24")
    kmc.write_kmc1(base, kmers, k, lut_prefix_len=4)
    got, got_k = kmc.load(base, fraction=1.0)
    np.testing.assert_array_equal(np.sort(got), kmers)
    # minhash filtering on load matches the host filter
    from kmerdb_jax.ops import minhash
    got_f, _ = kmc.load(base, fraction=0.25)
    keep = minhash.accept_mask_np(kmers, k, 0.25, 0.0)
    np.testing.assert_array_equal(np.sort(got_f), kmers[keep])


def test_build_from_kmers_cli(tmp_path):
    """build -from-kmers == build from the FASTA that generated them."""
    rng = np.random.default_rng(7)
    k = 18
    alph = get_alphabet("nt")
    names = []
    for i in range(3):
        seq = bytes(rng.choice(list(b"ACGT"), size=4000).astype(np.uint8))
        fa = tmp_path / f"g{i}.fasta"
        fa.write_bytes(b">g%d\n" % i + seq + b"\n")
        kmers = ingest.extract_sample_kmers([seq], k, alph)
        # undo the >=8-bit-prefix shift: KMC stores plain packed k-mers
        from kmerdb_jax.ops import extract
        shift, tail = extract.prefix_shift(k, 2)
        plain = np.sort(np.unique(kmers >> np.uint64(shift)))
        kmc.write_kmc1(str(tmp_path / f"g{i}"), plain, k)
        names.append(f"g{i}")

    lst_fa = tmp_path / "fa.list"
    lst_fa.write_text("".join(f"{tmp_path}/g{i}.fasta\n" for i in range(3)))
    lst_kmc = tmp_path / "kmc.list"
    lst_kmc.write_text("".join(f"{tmp_path}/g{i}\n" for i in range(3)))

    db_fa = str(tmp_path / "fa.db")
    db_kmc = str(tmp_path / "kmc.db")
    assert main(["build", "-k", str(k), str(lst_fa), db_fa]) == 0
    assert main(["build", "-from-kmers", str(lst_kmc), db_kmc]) == 0
    out_fa = str(tmp_path / "fa.a2a")
    out_kmc = str(tmp_path / "kmc.a2a")
    assert main(["all2all", db_fa, out_fa]) == 0
    assert main(["all2all", db_kmc, out_kmc]) == 0
    # same counts; sample names differ (.fasta suffix) -> compare cells
    fa_lines = pathlib.Path(out_fa).read_text().splitlines()
    kmc_lines = pathlib.Path(out_kmc).read_text().splitlines()
    assert [l.split(",", 1)[1] for l in fa_lines[1:]] == \
        [l.split(",", 1)[1] for l in kmc_lines[1:]]


@pytest.fixture(scope="module")
def synth_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("sampler")
    cwd = os.getcwd()
    os.chdir(REF)
    db = str(d / "synth.db")
    assert main(["build", "-multisample-fasta", "-k", "21",
                 "./test/synth/synth.list", db]) == 0
    os.chdir(cwd)
    return db


def test_sample_rows_best(synth_db, tmp_path):
    """-sample-rows best:1 keeps exactly the best-scoring cell per row."""
    full = str(tmp_path / "full")
    sampled = str(tmp_path / "top1")
    assert main(["all2all-sp", synth_db, full]) == 0
    assert main(["all2all-sp", "-sample-rows", "num-kmers:1",
                 synth_db, sampled]) == 0

    # reconstruct the full symmetric matrix from the sparse output
    lines = pathlib.Path(full).read_text().splitlines()[2:]
    S = len(lines)
    M = np.zeros((S, S), dtype=int)
    for i, line in enumerate(lines):
        for tok in line.split(",")[2:]:
            if tok:
                j, v = tok.split(":")
                M[i, int(j) - 1] = M[int(j) - 1, i] = int(v)

    out_lines = pathlib.Path(sampled).read_text().splitlines()[2:]
    for i, line in enumerate(out_lines):
        toks = [t for t in line.split(",")[2:] if t]
        if M[i].max() == 0:
            assert toks == []
            continue
        assert len(toks) == 1
        j, v = toks[0].split(":")
        assert int(v) == M[i].max()
        # ties broken toward the smaller column id
        assert int(v) == M[i, int(j) - 1]
        best_cols = np.flatnonzero(M[i] == M[i].max())
        assert int(j) - 1 == best_cols[0]


def test_sample_rows_random_deterministic(synth_db, tmp_path):
    """random strategy is seeded per row -> byte-identical across runs."""
    a = str(tmp_path / "r1")
    b = str(tmp_path / "r2")
    assert main(["all2all-sp", "-sample-rows", "2", synth_db, a]) == 0
    assert main(["all2all-sp", "-sample-rows", "2", synth_db, b]) == 0
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


def test_distance_phylip(synth_db, tmp_path):
    a2a = str(tmp_path / "a2a")
    assert main(["all2all", synth_db, a2a]) == 0
    out = str(tmp_path / "phy")
    assert main(["distance", "-phylip-out", "mash", a2a, out]) == 0
    lines = pathlib.Path(out).read_text().splitlines()
    assert lines[0] == "5"
    # triangle input: row i has i space-separated values (+ trailing sp)
    assert lines[1] == "A "
    parts = lines[2].split()
    assert parts[0] == "B" and len(parts) == 2
    assert lines[5].split()[0] == "E" and len(lines[5].split()) == 5