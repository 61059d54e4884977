"""End-to-end CLI byte-parity against test/synth goldens.

Mirrors the reference CI synth-dna suite
(.github/workflows/self-hosted.yml:91-233) step by step; every output
must be byte-identical to the committed golden (`cmp` in CI).
"""

import os
import pathlib

import pytest

from kmerdb_jax.cli.main import main

REF = pathlib.Path("/root/reference")
GOLD = REF / "test" / "synth"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    cwd = os.getcwd()
    os.chdir(REF)  # list files use ./test/... relative paths
    yield d
    os.chdir(cwd)


@pytest.fixture(scope="module")
def synth_db(workdir):
    db = str(workdir / "synth.db")
    assert main(["build", "-multisample-fasta", "-k", "21",
                 "./test/synth/synth.list", db]) == 0
    return db


def _cmp(out_path, golden_name):
    got = pathlib.Path(out_path).read_bytes()
    want = (GOLD / golden_name).read_bytes()
    assert got == want, f"output differs from golden {golden_name}"


def test_all2all_dense(synth_db, workdir):
    out = str(workdir / "a2a")
    assert main(["all2all", synth_db, out]) == 0
    _cmp(out, "a2a")


def test_all2all_sparse(synth_db, workdir):
    out = str(workdir / "a2a-sparse")
    assert main(["all2all", "-sparse", synth_db, out]) == 0
    _cmp(out, "a2a-sparse")


def test_all2all_sparse_minmax(synth_db, workdir):
    out = str(workdir / "a2a-sparse-minmax")
    assert main(["all2all", "-sparse", "-max", "39",
                 "-min", "num-kmers:31", synth_db, out]) == 0
    _cmp(out, "a2a.sparse.above-below")


def test_all2all_sp(synth_db, workdir):
    out = str(workdir / "a2a-sp")
    assert main(["all2all-sp", synth_db, out]) == 0
    _cmp(out, "a2a-sparse")


def test_all2all_sp_minmax(synth_db, workdir):
    out = str(workdir / "a2a-sp-minmax")
    assert main(["all2all-sp", "-max", "39", "-min", "num-kmers:31",
                 synth_db, out]) == 0
    _cmp(out, "a2a.sparse.above-below")


def test_distance_dense_to_dense(synth_db, workdir):
    a2a = str(workdir / "a2a")
    for metric, golden in (("mash", "a2a.mash"), ("ani", "a2a.ani")):
        out = str(workdir / f"a2a.{metric}")
        assert main(["distance", metric, a2a, out]) == 0
        _cmp(out, golden)


def test_distance_dense_to_sparse(synth_db, workdir):
    a2a = str(workdir / "a2a")
    out = str(workdir / "a2a.ani-sparse")
    assert main(["distance", "-sparse", "ani", a2a, out]) == 0
    _cmp(out, "a2a-sparse.ani")
    out = str(workdir / "a2a.mash-sparse")
    assert main(["distance", "-sparse", "-max", "1.0", "-min", "-1.0",
                 "mash", a2a, out]) == 0
    _cmp(out, "a2a-sparse.mash")


def test_distance_sparse_to_sparse(synth_db, workdir):
    a2a_sp = str(workdir / "a2a-sparse")
    for metric, golden in (("mash", "a2a-sparse.mash"),
                           ("ani", "a2a-sparse.ani")):
        out = str(workdir / f"a2a-sparse.{metric}2")
        assert main(["distance", metric, a2a_sp, out]) == 0
        _cmp(out, golden)


def test_distance_sparse_minmax(synth_db, workdir):
    a2a_sp = str(workdir / "a2a-sparse")
    out = str(workdir / "a2a-sparse.mash-minmax")
    assert main(["distance", "-sparse", "mash", "-min", "0.03",
                 "-max", "mash:1.0", a2a_sp, out]) == 0
    _cmp(out, "a2a.mash.above-below")


def test_distance_dense_double_minmax(synth_db, workdir):
    a2a = str(workdir / "a2a")
    out = str(workdir / "a2a.mash-sparse-min2max")
    assert main(["distance", "-sparse", "-min", "0.03", "-max", "mash:1.0",
                 "-min", "num-kmers:36", "mash", a2a, out]) == 0
    _cmp(out, "a2a.mash-sparse-min2max")


def test_new2all_dense(synth_db, workdir):
    out = str(workdir / "n2a")
    assert main(["new2all", "-multisample-fasta", synth_db,
                 "./test/synth/synth.list", out]) == 0
    _cmp(out, "n2a")


def test_new2all_sparse(synth_db, workdir):
    out = str(workdir / "n2a-sparse")
    assert main(["new2all", "-multisample-fasta", "-sparse", synth_db,
                 "./test/synth/synth.list", out]) == 0
    _cmp(out, "n2a-sparse")


def test_new2all_sparse_minmax(synth_db, workdir):
    out = str(workdir / "n2a-sparse-minmax")
    assert main(["new2all", "-multisample-fasta", "-sparse", "-max", "69",
                 "-min", "num-kmers:21", synth_db,
                 "./test/synth/synth.list", out]) == 0
    _cmp(out, "n2a.sparse.above-below")


def test_new2all_distances(synth_db, workdir):
    n2a = str(workdir / "n2a")
    for metric, golden in (("mash", "n2a.mash"), ("ani", "n2a.ani")):
        out = str(workdir / f"n2a.{metric}")
        assert main(["distance", metric, n2a, out]) == 0
        _cmp(out, golden)
    out = str(workdir / "n2a.ani-sparse")
    assert main(["distance", "-sparse", "ani", n2a, out]) == 0
    _cmp(out, "n2a-sparse.ani")
    n2a_sp = str(workdir / "n2a-sparse")
    out = str(workdir / "n2a-sparse.mash2")
    assert main(["distance", "mash", n2a_sp, out]) == 0
    _cmp(out, "n2a-sparse.mash")
