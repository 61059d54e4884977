"""Fused FASTA -> all2all pipeline (ops/fused.py): the group-Gram
formulation must match the pattern path bit-for-bit, host and device
tiers alike, and the CLI mode must be byte-identical to build+all2all."""

import os
import pathlib

import numpy as np
import pytest

from kmerdb_jax.models.database import KmerPatternDb
from kmerdb_jax.models import builder
from kmerdb_jax.ops import fused, intersect
from kmerdb_jax.cli.main import main as cli


def _rand_streams(rng, n, pool_size=4000, lo=100, hi=900):
    pool = rng.integers(0, 1 << 40, size=pool_size, dtype=np.uint64)
    return [np.unique(rng.choice(pool, size=int(rng.integers(lo, hi)),
                                 replace=False)) for _ in range(n)]


@pytest.mark.parametrize("n,seed", [(5, 0), (23, 1), (64, 2)])
def test_group_counts_match_pattern_path(n, seed):
    rng = np.random.default_rng(seed)
    streams = _rand_streams(rng, n)
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        [(f"s{i}", s) for i, s in enumerate(streams)])
    want = intersect.all2all_counts(db)
    got_host = fused._host_group_counts(streams)
    np.testing.assert_array_equal(got_host, want)
    # both device wire formats: raw k-mer groups and set-hash-deduped
    # patterns (the slow-link route) must be bit-identical
    for dedup in ("0", "1"):
        os.environ["KMERDB_FUSED_DEDUP"] = dedup
        try:
            got_dev = fused.all2all_group_counts(streams, force=True)
        finally:
            del os.environ["KMERDB_FUSED_DEDUP"]
        np.testing.assert_array_equal(got_dev, want,
                                      err_msg=f"dedup={dedup}")


def test_group_counts_multi_partition(monkeypatch):
    """Partitioned merge (several k-mer ranges) must stitch into the
    same matrix as the single-partition result."""
    from kmerdb_jax.models import builder as b
    rng = np.random.default_rng(3)
    streams = _rand_streams(rng, 16, pool_size=20_000, lo=2000, hi=4000)
    want = fused._host_group_counts(streams)
    monkeypatch.setattr(b, "_PARTITION_ELEMS", 4096)
    got = fused._host_group_counts(streams)
    np.testing.assert_array_equal(got, want)
    got_dev = fused.all2all_group_counts(streams, force=True)
    np.testing.assert_array_equal(got_dev, want)


def test_empty_and_single():
    assert fused.all2all_group_counts([], force=True).shape == (0, 0)
    s = [np.array([1, 5, 9], dtype=np.uint64)]
    C = fused.all2all_group_counts(s, force=True)
    assert C.shape == (1, 1) and C[0, 0] == 3


def test_device_worthwhile_gate():
    """Tiny jobs stay on host (must not pay backend init); huge
    related collections go to device under accelerator constants."""
    assert not fused.device_worthwhile(8, 4000)
    os.environ["KMERDB_COST_DEV_FLOPS"] = "2e14"
    os.environ["KMERDB_COST_DEV_FIXED_S"] = "2"
    os.environ["KMERDB_COST_PUSH_BPS"] = "1e9"
    os.environ["KMERDB_COST_PULL_BPS"] = "1e7"
    try:
        assert fused.device_worthwhile(4096, 123_000_000)
    finally:
        for k in ("KMERDB_COST_DEV_FLOPS", "KMERDB_COST_DEV_FIXED_S",
                  "KMERDB_COST_PUSH_BPS", "KMERDB_COST_PULL_BPS"):
            os.environ.pop(k, None)


def test_cli_from_fasta_matches_build_all2all(tmp_path, reference_test_dir):
    """`all2all -from-fasta` == `build` + `all2all` byte-for-byte on
    the reference synth corpus, dense and sparse+filtered."""
    lst = reference_test_dir / "synth" / "list.txt"
    if not lst.exists():
        # fall back to the virus corpus lists
        p1 = reference_test_dir / "virus" / "seqs.part1.list"
        lines = p1.read_text().splitlines()[:12]
        lst = tmp_path / "list.txt"
        lst.write_text("".join(
            str(reference_test_dir.parent / l.lstrip("./")) + "\n"
            for l in lines if l.strip()))
    else:
        lines = [l for l in lst.read_text().splitlines() if l.strip()]
        lst = tmp_path / "list.txt"
        lst.write_text("".join(
            str((reference_test_dir / "synth" / l)) + "\n"
            for l in lines))

    db = tmp_path / "x.db"
    ref_csv = tmp_path / "ref.csv"
    fus_csv = tmp_path / "fus.csv"
    assert cli(["build", "-k", "15", str(lst), str(db)]) == 0
    assert cli(["all2all", str(db), str(ref_csv)]) == 0
    assert cli(["all2all", "-from-fasta", "-k", "15", str(lst),
                str(fus_csv)]) == 0
    assert fus_csv.read_bytes() == ref_csv.read_bytes()

    ref_sp = tmp_path / "ref.sp"
    fus_sp = tmp_path / "fus.sp"
    assert cli(["all2all", "-sparse", "-min", "2", "-max", "jaccard:0.9",
                str(db), str(ref_sp)]) == 0
    assert cli(["all2all", "-from-fasta", "-sparse", "-min", "2",
                "-max", "jaccard:0.9", "-k", "15", str(lst),
                str(fus_sp)]) == 0
    assert fus_sp.read_bytes() == ref_sp.read_bytes()


def test_cli_from_fasta_device_forced(tmp_path, reference_test_dir):
    """The forced device tier (the Gram engine on this backend)
    produces the same bytes through the CLI."""
    p1 = reference_test_dir / "virus" / "seqs.part1.list"
    lines = p1.read_text().splitlines()[:10]
    lst = tmp_path / "list.txt"
    lst.write_text("".join(
        str(reference_test_dir.parent / l.lstrip("./")) + "\n"
        for l in lines if l.strip()))
    a = tmp_path / "a.csv"
    b = tmp_path / "b.csv"
    assert cli(["all2all", "-from-fasta", str(lst), str(a)]) == 0
    os.environ["KMERDB_FUSED_DEVICE"] = "1"
    try:
        assert cli(["all2all", "-from-fasta", str(lst), str(b)]) == 0
    finally:
        del os.environ["KMERDB_FUSED_DEVICE"]
    assert a.read_bytes() == b.read_bytes()


def _parts_dbs(rng, sizes, pool_size=6000):
    pool = rng.integers(0, 1 << 40, size=pool_size, dtype=np.uint64)
    core = np.unique(pool[:2500])
    dbs = []
    for pi, n in enumerate(sizes):
        samples = []
        for i in range(n):
            extra = np.unique(rng.choice(
                pool, size=int(rng.integers(60, 500)), replace=False))
            samples.append((f"p{pi}s{i}", np.unique(
                np.concatenate([core, extra]))))
        dbs.append(builder.add_samples(
            KmerPatternDb(kmer_length=18, fraction=1.0,
                          alphabet_name="nt"), samples))
    return dbs


def test_grid_group_counts_matches_cell_kernels():
    """Every grid cell (diagonal + cross, mixed part sizes) equals the
    per-cell pattern kernels."""
    rng = np.random.default_rng(7)
    dbs = _parts_dbs(rng, [9, 5, 12])
    cells = fused.grid_group_counts(dbs)
    for i in range(3):
        np.testing.assert_array_equal(
            cells[(i, i)], intersect.all2all_counts(dbs[i]),
            err_msg=f"diag {i}")
        for j in range(i):
            np.testing.assert_array_equal(
                cells[(i, j)], intersect.db2db_counts(dbs[i], dbs[j]),
                err_msg=f"cross {i},{j}")


def test_grid_disjoint_parts():
    """Disjoint parts: cross cells all zero, diagonals intact."""
    rng = np.random.default_rng(8)
    a = _parts_dbs(rng, [4], pool_size=3000)[0]
    b_samples = [(f"q{i}", np.unique(
        rng.integers(1 << 41, 1 << 42, size=300, dtype=np.uint64)))
        for i in range(6)]
    b = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        b_samples)
    cells = fused.grid_group_counts([a, b])
    assert cells[(1, 0)].max() == 0
    np.testing.assert_array_equal(cells[(0, 0)],
                                  intersect.all2all_counts(a))
    np.testing.assert_array_equal(cells[(1, 1)],
                                  intersect.all2all_counts(b))


def test_cli_parts_grid_device(tmp_path, reference_test_dir):
    """all2all-parts with the forced device grid == the default path,
    byte-for-byte, including filters."""
    p1 = reference_test_dir / "virus" / "seqs.part1.list"
    lines = [l for l in p1.read_text().splitlines() if l.strip()][:18]
    plists = []
    for pi in range(3):
        pl = tmp_path / f"p{pi}.list"
        pl.write_text("".join(
            str(reference_test_dir.parent / l.lstrip("./")) + "\n"
            for l in lines[pi * 6:(pi + 1) * 6]))
        plists.append(pl)
    dbl = tmp_path / "dbs.list"
    entries = []
    for pi, pl in enumerate(plists):
        dbp = tmp_path / f"p{pi}.db"
        assert cli(["build", str(pl), str(dbp)]) == 0
        entries.append(str(dbp))
    dbl.write_text("".join(e + "\n" for e in entries))
    a = tmp_path / "a.pp"
    b = tmp_path / "b.pp"
    assert cli(["all2all-parts", "-min", "2", str(dbl), str(a)]) == 0
    os.environ["KMERDB_GRID_DEVICE"] = "1"
    try:
        assert cli(["all2all-parts", "-min", "2", str(dbl), str(b)]) == 0
    finally:
        del os.environ["KMERDB_GRID_DEVICE"]
    assert a.read_bytes() == b.read_bytes()


def test_cli_from_fasta_fraction_and_minhash(tmp_path, reference_test_dir):
    """-from-fasta with -f (minhash fraction) and with -from-minhash
    input both match build+all2all byte-for-byte."""
    p1 = reference_test_dir / "virus" / "seqs.part1.list"
    lines = [l for l in p1.read_text().splitlines() if l.strip()][:8]
    paths = [str(reference_test_dir.parent / l.lstrip("./"))
             for l in lines]
    lst = tmp_path / "list.txt"
    lst.write_text("".join(p + "\n" for p in paths))

    db = tmp_path / "f.db"
    a = tmp_path / "a.csv"
    b = tmp_path / "b.csv"
    assert cli(["build", "-k", "16", "-f", "0.3", str(lst), str(db)]) == 0
    assert cli(["all2all", str(db), str(a)]) == 0
    assert cli(["all2all", "-from-fasta", "-k", "16", "-f", "0.3",
                str(lst), str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()

    # minhash files: build -from-minhash vs fused -from-minhash
    import shutil
    mh_dir = tmp_path / "mh"
    mh_dir.mkdir()
    mh_paths = []
    for p in paths:
        # list entries are extensionless; the loader probes .fasta etc.
        src = p if os.path.exists(p) else p + ".fasta"
        shutil.copy(src, mh_dir)
        mh_paths.append(mh_dir / os.path.basename(p))
    mh_lst = tmp_path / "mh.list"
    mh_lst.write_text("".join(str(p) + "\n" for p in mh_paths))
    assert cli(["minhash", "-k", "16", "-f", "0.3", str(mh_lst)]) == 0
    db2 = tmp_path / "mh.db"
    c = tmp_path / "c.csv"
    d = tmp_path / "d.csv"
    assert cli(["build", "-from-minhash", str(mh_lst), str(db2)]) == 0
    assert cli(["all2all", str(db2), str(c)]) == 0
    assert cli(["all2all", "-from-fasta", "-from-minhash", str(mh_lst),
                str(d)]) == 0
    assert c.read_bytes() == d.read_bytes()


def test_merge_groups_hashes_off_matches_on():
    """merge_groups(hashes=False) — the fused path's merge — must
    produce the same merged stream and group geometry as the hashed
    form (only h1/h2 become empty)."""
    from kmerdb_jax.utils import native
    if not native.available:
        import pytest
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(11)
    streams = [np.unique(rng.integers(0, 500, size=n, dtype=np.uint64))
               for n in (120, 80, 1, 300)]
    cvals = list(range(len(streams)))
    vals = [None] * len(streams)
    mv_a, gk_a, gs_a, gl_a, h1_a, h2_a = native.merge_groups(
        streams, vals, cvals)
    mv_b, gk_b, gs_b, gl_b, h1_b, h2_b = native.merge_groups(
        streams, vals, cvals, hashes=False)
    np.testing.assert_array_equal(mv_a, mv_b)
    np.testing.assert_array_equal(gk_a, gk_b)
    np.testing.assert_array_equal(gs_a, gs_b)
    np.testing.assert_array_equal(gl_a, gl_b)
    assert h1_a.size == gk_a.size and h2_a.size == gk_a.size
    assert h1_b.size == 0 and h2_b.size == 0


def test_cli_sp_from_fasta_matches_build_all2all_sp(tmp_path,
                                                    reference_test_dir):
    """`all2all-sp -from-fasta` == `build` + `all2all-sp` byte-for-byte
    — plain, filtered, and with best-sampling."""
    p1 = reference_test_dir / "virus" / "seqs.part1.list"
    lines = p1.read_text().splitlines()[:12]
    lst = tmp_path / "list.txt"
    lst.write_text("".join(
        str(reference_test_dir.parent / l.lstrip("./")) + "\n"
        for l in lines if l.strip()))

    db = tmp_path / "x.db"
    assert cli(["build", "-k", "15", str(lst), str(db)]) == 0

    for extra in ([],
                  ["-min", "2", "-max", "jaccard:0.9"],
                  ["-sample-rows", "mash:3"],
                  ["-min", "num-kmers:2", "-sample-rows", "jaccard:2"]):
        ref_csv = tmp_path / "ref.sp"
        fus_csv = tmp_path / "fus.sp"
        assert cli(["all2all-sp", *extra, str(db), str(ref_csv)]) == 0
        assert cli(["all2all-sp", "-from-fasta", "-k", "15", *extra,
                    str(lst), str(fus_csv)]) == 0
        assert fus_csv.read_bytes() == ref_csv.read_bytes(), extra


def test_cli_sp_from_fasta_minhash_input(tmp_path, reference_test_dir):
    """all2all-sp -from-fasta -from-minhash (minhash-file ingest into
    the fused sparse console) == build -from-minhash + all2all-sp."""
    import shutil
    p1 = reference_test_dir / "virus" / "seqs.part1.list"
    lines = [l for l in p1.read_text().splitlines() if l.strip()][:8]
    srcs = [str(reference_test_dir.parent / l.lstrip("./"))
            for l in lines]
    paths = []
    for p in srcs:
        src = p if os.path.exists(p) else p + ".fasta"
        dst = tmp_path / os.path.basename(p)
        shutil.copy(src, dst)
        paths.append(str(dst))
    lst = tmp_path / "list.txt"
    lst.write_text("".join(p + "\n" for p in paths))

    assert cli(["minhash", "-k", "16", "-f", "0.4", str(lst)]) == 0
    db = tmp_path / "mh.db"
    a = tmp_path / "a.sp"
    b = tmp_path / "b.sp"
    assert cli(["build", "-from-minhash", str(lst), str(db)]) == 0
    assert cli(["all2all-sp", "-min", "2", str(db), str(a)]) == 0
    assert cli(["all2all-sp", "-from-fasta", "-from-minhash",
                "-min", "2", str(lst), str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_grid_rows_streamed_matches_cell_kernels():
    """Streamed grid tier (row-part resident, once-per-row pushes):
    every cell equals the per-cell pattern kernels, resident and
    re-push (tiny KMERDB_A2A_RESIDENT_MB) modes."""
    rng = np.random.default_rng(9)
    dbs = _parts_dbs(rng, [9, 5, 12])
    sizes = [db.n_samples for db in dbs]
    for budget in (None, "0"):
        if budget is None:
            os.environ.pop("KMERDB_A2A_RESIDENT_MB", None)
        else:
            os.environ["KMERDB_A2A_RESIDENT_MB"] = budget
        try:
            got = {}
            for i_row, cells in fused.grid_rows_streamed(
                    lambda i: dbs[i], sizes):
                got[i_row] = cells
        finally:
            os.environ.pop("KMERDB_A2A_RESIDENT_MB", None)
        for i in range(3):
            np.testing.assert_array_equal(
                got[i][i], intersect.all2all_counts(dbs[i]),
                err_msg=f"diag {i} budget={budget}")
            for j in range(i):
                np.testing.assert_array_equal(
                    got[i][j], intersect.db2db_counts(dbs[i], dbs[j]),
                    err_msg=f"cross {i},{j} budget={budget}")


def test_cli_parts_grid_streamed(tmp_path, reference_test_dir):
    """all2all-parts forced through the streamed grid (cache budget
    exceeded) == the default path, byte-for-byte."""
    p1 = reference_test_dir / "virus" / "seqs.part1.list"
    lines = [l for l in p1.read_text().splitlines() if l.strip()][:16]
    plists = []
    for pi in range(4):
        pl = tmp_path / f"p{pi}.list"
        pl.write_text("".join(
            str(reference_test_dir.parent / l.lstrip("./")) + "\n"
            for l in lines[pi * 4:(pi + 1) * 4]))
        plists.append(pl)
    dbl = tmp_path / "dbs.list"
    entries = []
    for pi, pl in enumerate(plists):
        dbp = tmp_path / f"p{pi}.db"
        assert cli(["build", str(pl), str(dbp)]) == 0
        entries.append(str(dbp))
    dbl.write_text("".join(e + "\n" for e in entries))
    a = tmp_path / "a.pp"
    b = tmp_path / "b.pp"
    assert cli(["all2all-parts", "-min", "2", str(dbl), str(a)]) == 0
    os.environ["KMERDB_GRID_DEVICE"] = "1"
    os.environ["KMERDB_GRID_STREAM"] = "1"
    try:
        assert cli(["all2all-parts", "-min", "2", str(dbl), str(b)]) == 0
    finally:
        del os.environ["KMERDB_GRID_DEVICE"]
        del os.environ["KMERDB_GRID_STREAM"]
    assert a.read_bytes() == b.read_bytes()
