"""CLI mesh routing: the same command must produce byte-identical
output with and without `-mesh N` (VERDICT r2 item 2 — the reference's
`-t` reaching every mode, params.cpp:103-108, as a device mesh).

Runs in-process on the conftest's 8 virtual CPU devices; covers
build, all2all (+sparse), all2all-sp, new2all and all2all-parts.
"""

import pathlib

import numpy as np
import pytest

from kmerdb_jax.cli.main import main as cli
from kmerdb_jax.parallel import runtime


@pytest.fixture(autouse=True)
def _reset_mesh():
    yield
    runtime.configure(None)


def _fasta_corpus(tmp_path, n=15, seed=7):
    tmp_path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), size=900))
        f = tmp_path / f"s{i}.fasta"
        f.write_text(f">s{i}\n{seq}\n")
        paths.append(str(f))
    lst = tmp_path / "samples.list"
    lst.write_text("\n".join(paths) + "\n")
    return lst


def _run(args):
    assert cli([str(a) for a in args]) == 0


@pytest.mark.parametrize("n_dev", ["3", "8"])
def test_mesh_build_all2all_new2all_identical(tmp_path, n_dev):
    lst = _fasta_corpus(tmp_path)
    q_lst = _fasta_corpus(tmp_path / "q", n=5, seed=8)
    base, meshed = tmp_path / "base", tmp_path / "mesh"
    base.mkdir(), meshed.mkdir()

    for d, extra in ((base, []), (meshed, ["-mesh", n_dev])):
        _run(["build", "-k", "16", lst, d / "db"] + extra)
        _run(["all2all", d / "db", d / "a2a.csv"] + extra)
        _run(["all2all", "-sparse", d / "db", d / "a2a.sparse.csv"]
             + extra)
        _run(["all2all-sp", d / "db", d / "a2a.sp.csv"] + extra)
        _run(["new2all", d / "db", q_lst, d / "n2a.csv"] + extra)

    assert (base / "db").read_bytes() == (meshed / "db").read_bytes()
    for f in ("a2a.csv", "a2a.sparse.csv", "a2a.sp.csv", "n2a.csv"):
        assert (base / f).read_bytes() == (meshed / f).read_bytes(), f


def test_mesh_parts_identical(tmp_path):
    lists = [_fasta_corpus(tmp_path / f"p{i}", n=6, seed=20 + i)
             for i in range(3)]
    dbs = []
    for i, lst in enumerate(lists):
        db = tmp_path / f"part{i}.db"
        _run(["build", "-k", "16", lst, db])
        dbs.append(db)
    db_list = tmp_path / "dbs.list"
    db_list.write_text("\n".join(str(d) for d in dbs) + "\n")

    _run(["all2all-parts", db_list, tmp_path / "base.csv"])
    _run(["all2all-parts", db_list, tmp_path / "mesh.csv",
          "-mesh", "8"])
    assert (tmp_path / "base.csv").read_bytes() == \
        (tmp_path / "mesh.csv").read_bytes()


def test_mesh_env_knob(tmp_path, monkeypatch):
    """KMERDB_MESH env reaches the same routing as -mesh."""
    lst = _fasta_corpus(tmp_path, n=8, seed=9)
    _run(["build", "-k", "16", lst, tmp_path / "db"])
    _run(["all2all", tmp_path / "db", tmp_path / "base.csv"])
    monkeypatch.setenv("KMERDB_MESH", "8")
    runtime.configure(None)
    _run(["all2all", tmp_path / "db", tmp_path / "env.csv"])
    assert (tmp_path / "base.csv").read_bytes() == \
        (tmp_path / "env.csv").read_bytes()


def test_mesh_one_device_is_noop():
    runtime.configure("1")
    assert runtime.active_mesh() is None
    runtime.configure("0")
    assert runtime.active_mesh() is None


@pytest.mark.parametrize("n_dev", ["2", "8"])
def test_mesh_streamed_all2all_identical(tmp_path, n_dev, monkeypatch):
    """-mesh composed with the streamed large-S path (KMERDB_A2A_STREAM
    forces the stripe tier below its 16k default): byte-identical CSV,
    dense and sparse."""
    lst = _fasta_corpus(tmp_path, n=21, seed=11)
    base, meshed = tmp_path / "base", tmp_path / "mesh"
    base.mkdir(), meshed.mkdir()

    _run(["build", "-k", "16", lst, base / "db"])
    _run(["all2all", base / "db", base / "a2a.csv"])
    _run(["all2all", "-sparse", "-min", "2", base / "db",
          base / "a2a.sparse.csv"])

    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")
    _run(["build", "-k", "16", lst, meshed / "db"])
    _run(["all2all", "-mesh", n_dev, meshed / "db", meshed / "a2a.csv"])
    _run(["all2all", "-sparse", "-min", "2", "-mesh", n_dev,
          meshed / "db", meshed / "a2a.sparse.csv"])

    for f in ("a2a.csv", "a2a.sparse.csv"):
        assert (base / f).read_bytes() == (meshed / f).read_bytes(), f
