"""End-to-end CLI byte-parity against test/virus goldens (164 SARS-CoV-2
genomes), mirroring the CI virus-dna suite
(.github/workflows/self-hosted.yml:235-365): build/extend/new2all/
all2all/distance/minhash/one2all/parts."""

import os
import pathlib
import shutil

import pytest

from kmerdb_jax.cli.main import main

REF = pathlib.Path("/root/reference")
GOLD = REF / "test" / "virus"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("virus")
    cwd = os.getcwd()
    os.chdir(REF)
    yield d
    os.chdir(cwd)


def _cmp(out_path, golden_name):
    got = pathlib.Path(out_path).read_bytes()
    want = (GOLD / golden_name).read_bytes()
    assert got == want, f"output differs from golden {golden_name}"


@pytest.fixture(scope="module")
def parts_db(workdir):
    """build part1 -> extend part2 (the -k 25 must be ignored on extend)."""
    db = str(workdir / "k18.parts.db")
    assert main(["build", "./test/virus/seqs.part1.list", db]) == 0
    return db


def test_new2all(parts_db, workdir):
    out = str(workdir / "k18.n2a.csv")
    assert main(["new2all", parts_db, "./test/virus/seqs.part2.list", out]) == 0
    _cmp(out, "k18.n2a.csv")


def test_new2all_sparse(parts_db, workdir):
    out = str(workdir / "k18.n2a.sparse.csv")
    assert main(["new2all", "-sparse", parts_db,
                 "./test/virus/seqs.part2.list", out]) == 0
    _cmp(out, "k18.n2a.sparse.csv")


@pytest.fixture(scope="module")
def extended_db(parts_db, workdir):
    assert main(["build", "-extend", "-k", "25",
                 "./test/virus/seqs.part2.list", parts_db]) == 0
    return parts_db


@pytest.fixture(scope="module")
def k18_csv(extended_db, workdir):
    out = str(workdir / "k18.csv")
    assert main(["all2all", extended_db, out]) == 0
    return out


def test_all2all_after_extend(k18_csv):
    _cmp(k18_csv, "k18.csv")


def test_all2all_sparse(extended_db, workdir):
    out = str(workdir / "k18.sparse.csv")
    assert main(["all2all", "-sparse", extended_db, out]) == 0
    _cmp(out, "k18.sparse.csv")


@pytest.mark.parametrize("metric", ["jaccard", "min", "max", "cosine", "mash"])
def test_distance(k18_csv, workdir, metric):
    out = str(workdir / f"k18.csv.{metric}")
    assert main(["distance", metric, k18_csv, out]) == 0
    _cmp(out, f"k18.csv.{metric}")


def test_multifasta_equivalence(workdir):
    """multisample fasta build == per-file build (CI :309-319).
    data/seqs.fasta is not committed in the snapshot; it is the
    concatenation of the two committed parts."""
    combined = workdir / "seqs.fasta"
    combined.write_bytes(
        (GOLD / "data" / "seqs.part1.fasta").read_bytes()
        + (GOLD / "data" / "seqs.part2.fasta").read_bytes())
    db = str(workdir / "k18.multi.db")
    out = str(workdir / "k18.multi.csv")
    assert main(["build", "-multisample-fasta", str(combined), db]) == 0
    assert main(["all2all", db, out]) == 0
    _cmp(out, "k18.csv")


def test_multifasta_split_equivalence(workdir):
    db = str(workdir / "k18.multi.split.db")
    out = str(workdir / "k18.multi.split.csv")
    assert main(["build", "-multisample-fasta",
                 "./test/virus/multi.split.list", db]) == 0
    assert main(["all2all", db, out]) == 0
    _cmp(out, "k18.csv")


def test_fraction_build(workdir):
    db = str(workdir / "k18.frac.db")
    out = str(workdir / "k18.frac.csv")
    assert main(["build", "-f", "0.1", "./test/virus/seqs.list", db]) == 0
    assert main(["all2all", db, out]) == 0
    _cmp(out, "k18.frac.csv")


def test_minhash_files_equivalence(workdir, tmp_path_factory):
    """minhash -f 0.1 + build -from-minhash == build -f 0.1 (CI :326-339).
    .minhash files are written next to inputs, so work on a copy."""
    data = tmp_path_factory.mktemp("mh")
    names = [pathlib.Path(line).name
             for line in (GOLD / "seqs.list").read_text().split()]
    for n in names:
        shutil.copy(GOLD / "data" / (n + ".fasta"), data / (n + ".fasta"))
    lst = data / "seqs.list"
    lst.write_text("".join(f"{data}/{n}\n" for n in names))

    assert main(["minhash", "-f", "0.1", str(lst)]) == 0
    assert (data / (names[0] + ".minhash")).exists()

    db = str(workdir / "k18.minhash.db")
    out = str(workdir / "k18.minhash.csv")
    assert main(["build", "-from-minhash", str(lst), db]) == 0
    assert main(["all2all", db, out]) == 0

    # golden was produced with names as listed (no directory); ours have
    # tmp paths -> compare values by replacing the name column
    got = pathlib.Path(out).read_text().splitlines(keepends=True)
    want = (GOLD / "k18.frac.csv").read_text().splitlines(keepends=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.split(",", 1)[1] == w.split(",", 1)[1]


def test_k24(workdir):
    db = str(workdir / "k24.db")
    out = str(workdir / "k24.csv")
    assert main(["build", "-k", "24", "./test/virus/seqs.list", db]) == 0
    assert main(["all2all", db, out]) == 0
    _cmp(out, "k24.csv")


def test_one2all_k25_frac(workdir):
    db = str(workdir / "k25.db")
    out = str(workdir / "MT159713.csv")
    assert main(["build", "-k", "25", "-f", "0.1",
                 "./test/virus/seqs.part1.list", db]) == 0
    assert main(["one2all", db, "./test/virus/data/MT159713", out]) == 0
    _cmp(out, "MT159713.csv")


def test_new2all_itself(workdir):
    db = str(workdir / "k18.db")
    out = str(workdir / "k18.n2a.itself.csv")
    assert main(["build", "./test/virus/seqs.list", db]) == 0
    assert main(["new2all", db, "./test/virus/seqs.list", out]) == 0
    _cmp(out, "k18.n2a.itself.csv")


def test_all2all_parts(workdir):
    db1 = str(workdir / "k18.parts1.db")
    db2 = str(workdir / "k18.parts2.db")
    assert main(["build", "./test/virus/seqs.part1.list", db1]) == 0
    assert main(["build", "./test/virus/seqs.part2.list", db2]) == 0
    lst = workdir / "db.list"
    lst.write_text(f"{db1}\n{db2}\n")
    out = str(workdir / "k18.parts.csv")
    assert main(["all2all-parts", str(lst), out]) == 0
    _cmp(out, "k18.sparse.csv")
