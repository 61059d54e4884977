"""Differential parity fuzzing against the reference kmer-db binary.

Runs only when /tmp/refbuild/bin/kmer-db exists (build it with
tools/build_reference.sh).  Random corpora exercise semantic corners
the committed goldens don't: gzip inputs, lowercase/ambiguity codes,
multisample headers with comments, fractional minhash, filters,
protein alphabets, extend chains, new2all/one2all/distance — outputs
are compared byte-for-byte.
"""

import gzip
import os
import pathlib
import subprocess

import numpy as np
import pytest

from kmerdb_jax.cli.main import main

REF_BIN = "/tmp/refbuild/bin/kmer-db"

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_BIN), reason="reference binary not built "
    "(run tools/build_reference.sh)")


def ref(args):
    r = subprocess.run([REF_BIN, *args], capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]


def ours(args):
    assert main(list(args)) == 0


def _random_corpus(tmp, rng, n=8, length=3000, alphabet=b"ACGT",
                   mutate_from_common=True, gz_some=True, noise=b""):
    base = rng.choice(list(alphabet), size=length).astype(np.uint8)
    paths = []
    for i in range(n):
        if mutate_from_common:
            seq = base.copy()
            pos = rng.integers(0, length, size=length // 20)
            seq[pos] = rng.choice(list(alphabet + noise),
                                  size=pos.size).astype(np.uint8)
        else:
            seq = rng.choice(list(alphabet + noise), size=length
                             ).astype(np.uint8)
        body = b">seq%d extra header words\n" % i
        raw = bytes(seq)
        # mixed case + line wrapping
        wrapped = b"\n".join(raw[j:j + 61] for j in range(0, len(raw), 61))
        if i % 3 == 1:
            wrapped = wrapped.lower()
        data = body + wrapped + b"\n"
        if gz_some and i % 4 == 3:
            p = tmp / f"g{i}.fasta.gz"
            p.write_bytes(gzip.compress(data))
            paths.append(str(tmp / f"g{i}.fasta"))  # probe adds .gz
        else:
            p = tmp / f"g{i}.fasta"
            p.write_bytes(data)
            paths.append(str(p))
    lst = tmp / "corpus.list"
    lst.write_text("".join(p + "\n" for p in paths))
    return str(lst)


def _cmp(a, b, what):
    ba, bb = pathlib.Path(a).read_bytes(), pathlib.Path(b).read_bytes()
    assert ba == bb, f"{what}: outputs differ"


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_dna_pipeline(tmp_path, seed):
    rng = np.random.default_rng(seed)
    lst = _random_corpus(tmp_path, rng, noise=b"NRYX")
    k = str(int(rng.integers(11, 28)))

    for tag, build_args in [("plain", []), ("frac", ["-f", "0.3"])]:
        rdb, odb = str(tmp_path / f"r{tag}.db"), str(tmp_path / f"o{tag}.db")
        ref(["build", "-k", k, *build_args, lst, rdb])
        ours(["build", "-k", k, *build_args, lst, odb])

        ra, oa = str(tmp_path / f"r{tag}.a2a"), str(tmp_path / f"o{tag}.a2a")
        ref(["all2all", rdb, ra])
        ours(["all2all", odb, oa])
        _cmp(ra, oa, f"all2all {tag} k={k}")

        rs, osp = str(tmp_path / f"r{tag}.sp"), str(tmp_path / f"o{tag}.sp")
        ref(["all2all", "-sparse", "-min", "2", "-max", "jaccard:0.9",
             rdb, rs])
        ours(["all2all", "-sparse", "-min", "2", "-max", "jaccard:0.9",
              odb, osp])
        _cmp(rs, osp, f"all2all sparse+filters {tag}")

        for metric in ("jaccard", "mash", "ani", "cosine", "min", "max",
                       "ani-shorter"):
            rm, om = str(tmp_path / f"r.{metric}"), str(tmp_path / f"o.{metric}")
            ref(["distance", metric, ra, rm])
            ours(["distance", metric, oa, om])
            _cmp(rm, om, f"distance {metric} {tag}")


def test_new2all_one2all_extend(tmp_path):
    rng = np.random.default_rng(21)
    lst = _random_corpus(tmp_path, rng, n=10)
    paths = pathlib.Path(lst).read_text().split()
    l1, l2 = tmp_path / "p1.list", tmp_path / "p2.list"
    l1.write_text("".join(p + "\n" for p in paths[:6]))
    l2.write_text("".join(p + "\n" for p in paths[6:]))

    rdb, odb = str(tmp_path / "r.db"), str(tmp_path / "o.db")
    ref(["build", str(l1), rdb])
    ours(["build", str(l1), odb])

    rn, on = str(tmp_path / "r.n2a"), str(tmp_path / "o.n2a")
    ref(["new2all", rdb, str(l2), rn])
    ours(["new2all", odb, str(l2), on])
    _cmp(rn, on, "new2all")

    rns, ons = str(tmp_path / "r.n2s"), str(tmp_path / "o.n2s")
    ref(["new2all", "-sparse", "-min", "mash:0.0", rdb, str(l2), rns])
    ours(["new2all", "-sparse", "-min", "mash:0.0", odb, str(l2), ons])
    _cmp(rns, ons, "new2all sparse")

    r1, o1 = str(tmp_path / "r.o2a"), str(tmp_path / "o.o2a")
    ref(["one2all", rdb, paths[7], r1])
    ours(["one2all", odb, paths[7], o1])
    _cmp(r1, o1, "one2all")

    # extend + all2all
    ref(["build", "-extend", str(l2), rdb])
    ours(["build", "-extend", str(l2), odb])
    ra, oa = str(tmp_path / "r.a2a"), str(tmp_path / "o.a2a")
    ref(["all2all", rdb, ra])
    ours(["all2all", odb, oa])
    _cmp(ra, oa, "all2all after extend")

    # all2all-parts over split DBs
    rdb1, rdb2 = str(tmp_path / "r1.db"), str(tmp_path / "r2.db")
    odb1, odb2 = str(tmp_path / "o1.db"), str(tmp_path / "o2.db")
    ref(["build", str(l1), rdb1])
    ref(["build", str(l2), rdb2])
    ours(["build", str(l1), odb1])
    ours(["build", str(l2), odb2])
    rl, ol = tmp_path / "rdb.list", tmp_path / "odb.list"
    rl.write_text(f"{rdb1}\n{rdb2}\n")
    ol.write_text(f"{odb1}\n{odb2}\n")
    rp, op = str(tmp_path / "r.parts"), str(tmp_path / "o.parts")
    ref(["all2all-parts", str(rl), rp])
    ours(["all2all-parts", str(ol), op])
    _cmp(rp, op, "all2all-parts")


def test_protein_and_multisample(tmp_path):
    rng = np.random.default_rng(31)
    # multisample protein fasta
    aa = b"ARNDCQEGHILKMFPSTWYV"
    recs = []
    for i in range(12):
        seq = rng.choice(list(aa + b"BZX*"), size=400).astype(np.uint8)
        recs.append(b">p%d desc\n" % i + bytes(seq) + b"\n")
    fa = tmp_path / "prot.fasta"
    fa.write_bytes(b"".join(recs))

    for alph in ("aa", "aa11_diamond", "aa12_mmseqs", "aa6_dayhoff"):
        rdb, odb = str(tmp_path / f"r{alph}.db"), str(tmp_path / f"o{alph}.db")
        ref(["build", "-multisample-fasta", "-k", "7", "-alphabet", alph,
             str(fa), rdb])
        ours(["build", "-multisample-fasta", "-k", "7", "-alphabet", alph,
              str(fa), odb])
        ra, oa = str(tmp_path / f"r{alph}.a2a"), str(tmp_path / f"o{alph}.a2a")
        ref(["all2all", rdb, ra])
        ours(["all2all", odb, oa])
        _cmp(ra, oa, f"all2all {alph}")


def test_preserve_strand_and_phylip(tmp_path):
    rng = np.random.default_rng(51)
    lst = _random_corpus(tmp_path, rng, n=6)
    rdb, odb = str(tmp_path / "r.db"), str(tmp_path / "o.db")
    ref(["build", "-k", "24", "-preserve-strand", lst, rdb])
    ours(["build", "-k", "24", "-preserve-strand", lst, odb])
    ra, oa = str(tmp_path / "r.a2a"), str(tmp_path / "o.a2a")
    ref(["all2all", rdb, ra])
    ours(["all2all", odb, oa])
    _cmp(ra, oa, "all2all preserve-strand")

    rp, op = str(tmp_path / "r.phy"), str(tmp_path / "o.phy")
    ref(["distance", "-phylip-out", "mash", ra, rp])
    ours(["distance", "-phylip-out", "mash", oa, op])
    _cmp(rp, op, "distance phylip")

    rsd, osd = str(tmp_path / "r.spd"), str(tmp_path / "o.spd")
    ref(["distance", "-sparse", "ani", "-min", "0.5", ra, rsd])
    ours(["distance", "-sparse", "ani", "-min", "0.5", oa, osd])
    _cmp(rsd, osd, "distance sparse+min")


def test_fraction_start(tmp_path):
    rng = np.random.default_rng(61)
    lst = _random_corpus(tmp_path, rng, n=5)
    rdb, odb = str(tmp_path / "r.db"), str(tmp_path / "o.db")
    ref(["build", "-k", "20", "-f", "0.25", "-f-start", "0.5", lst, rdb])
    ours(["build", "-k", "20", "-f", "0.25", "-f-start", "0.5", lst, odb])
    ra, oa = str(tmp_path / "r.a2a"), str(tmp_path / "o.a2a")
    ref(["all2all", rdb, ra])
    ours(["all2all", odb, oa])
    _cmp(ra, oa, "all2all f-start")


def test_extreme_k(tmp_path):
    """k=11 (heavy prefix widening) and k=25 (wide prefix).  k>25 is
    not differential-tested: the reference allocates 2^(2k-32)
    hashtable bins (prefix_kmer_db.cpp:48-63), i.e. 2^30 objects at
    k=31, which exceeds this host.  Our flat-tensor design has no such
    blowup — k up to 31 is covered by our own unit tests instead."""
    rng = np.random.default_rng(71)
    lst = _random_corpus(tmp_path, rng, n=5, length=2000)
    for k in ("11", "25"):
        rdb, odb = str(tmp_path / f"r{k}.db"), str(tmp_path / f"o{k}.db")
        ref(["build", "-k", k, lst, rdb])
        ours(["build", "-k", k, lst, odb])
        ra, oa = str(tmp_path / f"r{k}.a2a"), str(tmp_path / f"o{k}.a2a")
        ref(["all2all", rdb, ra])
        ours(["all2all", odb, oa])
        _cmp(ra, oa, f"all2all k={k}")


def test_minhash_roundtrip(tmp_path):
    rng = np.random.default_rng(41)
    lst = _random_corpus(tmp_path, rng, n=6, gz_some=False)
    # minhash files written next to inputs by both tools; use copies
    ref(["minhash", "-f", "0.2", "-k", "21", lst])
    paths = pathlib.Path(lst).read_text().split()
    ref_mh = {p: pathlib.Path(p + ".minhash").read_bytes() for p in paths}
    for p in paths:
        os.unlink(p + ".minhash")
    ours(["minhash", "-f", "0.2", "-k", "21", lst])
    for p in paths:
        assert pathlib.Path(p + ".minhash").read_bytes() == ref_mh[p], \
            f".minhash differs for {p}"

    rdb, odb = str(tmp_path / "rm.db"), str(tmp_path / "om.db")
    ref(["build", "-from-minhash", lst, rdb])
    ours(["build", "-from-minhash", lst, odb])
    ra, oa = str(tmp_path / "rm.a2a"), str(tmp_path / "om.a2a")
    ref(["all2all", rdb, ra])
    ours(["all2all", odb, oa])
    _cmp(ra, oa, "all2all from minhash")


def _parse_sparse(path):
    """{row_name: {col_index: value}} of a sparse common table."""
    rows = {}
    lines = pathlib.Path(path).read_text().splitlines()
    for line in lines[2:]:
        toks = line.split(",")
        cells = {}
        for t in toks[2:]:
            if t:
                c, v = t.split(":")
                cells[int(c)] = int(v)
        rows[toks[0]] = cells
    return rows


def test_all2all_sp_sampling(tmp_path):
    """all2all-sp with -sample-rows.

    'best' (criterion heap, ties by item id) is deterministic and must
    match the reference byte-for-byte.  'random' cannot be byte-matched:
    the reference's draw sequence depends on its hash-table memory
    layout and pattern-creation history (add_to_sampler iterates
    hash_map_lp slots, array.h:493), which are implementation artifacts
    — so for 'random' the check is structural: every sampled cell must
    carry the exact full-matrix value and every row must keep
    min(N, row population) cells, for BOTH tools."""
    rng = np.random.default_rng(81)
    lst = _random_corpus(tmp_path, rng, n=10)
    rdb, odb = str(tmp_path / "r.db"), str(tmp_path / "o.db")
    ref(["build", "-k", "15", lst, rdb])
    ours(["build", "-k", "15", lst, odb])

    for tag, args in [
        ("plain", []),
        ("best", ["-sample-rows", "jaccard:3"]),
        ("best+filter", ["-sample-rows", "mash:2", "-min", "1"]),
    ]:
        rs = str(tmp_path / f"r.{tag}.sp")
        os_ = str(tmp_path / f"o.{tag}.sp")
        ref(["all2all-sp", *args, rdb, rs])
        ours(["all2all-sp", *args, odb, os_])
        _cmp(rs, os_, f"all2all-sp {tag}")

    # random sampling: structural equivalence
    full = _parse_sparse(str(tmp_path / "r.plain.sp"))
    # full matrix incl. transposed feeds: row gets (i, j) and (j, i)
    names = list(full.keys())
    sym = {n: dict(c) for n, c in full.items()}
    for i, n in enumerate(names):
        for c, v in full[n].items():
            sym[names[c - 1]][i + 1] = v
    N = 4
    rr = str(tmp_path / "r.rand.sp")
    oo = str(tmp_path / "o.rand.sp")
    ref(["all2all-sp", "-sample-rows", str(N), rdb, rr])
    ours(["all2all-sp", "-sample-rows", str(N), odb, oo])
    for tool, out in (("ref", rr), ("ours", oo)):
        got = _parse_sparse(out)
        assert set(got) == set(sym), f"{tool}: row set differs"
        for name, cells in got.items():
            want = sym[name]
            assert len(cells) == min(N, len(want)), \
                f"{tool}: row {name} kept {len(cells)}/{min(N, len(want))}"
            for c, v in cells.items():
                assert want.get(c) == v, \
                    f"{tool}: row {name} cell {c} value {v} != {want.get(c)}"


def test_all2all_parts_sampling(tmp_path):
    """all2all-parts with 'best' row sampling across a 3-part split:
    byte parity with the reference (the best-strategy heap is
    feed-order independent, so the parts grid order doesn't matter)."""
    rng = np.random.default_rng(91)
    lst = _random_corpus(tmp_path, rng, n=9, gz_some=False)
    paths = pathlib.Path(lst).read_text().split()
    dbs_r, dbs_o = [], []
    for i, chunk in enumerate((paths[:3], paths[3:6], paths[6:])):
        part = tmp_path / f"part{i}.list"
        part.write_text("".join(p + "\n" for p in chunk))
        rdb, odb = str(tmp_path / f"r{i}.db"), str(tmp_path / f"o{i}.db")
        ref(["build", "-k", "16", str(part), rdb])
        ours(["build", "-k", "16", str(part), odb])
        dbs_r.append(rdb)
        dbs_o.append(odb)
    rl, ol = tmp_path / "r.list", tmp_path / "o.list"
    rl.write_text("".join(p + "\n" for p in dbs_r))
    ol.write_text("".join(p + "\n" for p in dbs_o))
    for tag, args in [("sampled", ["-sample-rows", "jaccard:2"]),
                      ("filtered", ["-min", "2", "-max", "mash:0.9"])]:
        rp, op = str(tmp_path / f"r.{tag}"), str(tmp_path / f"o.{tag}")
        ref(["all2all-parts", *args, str(rl), rp])
        ours(["all2all-parts", *args, str(ol), op])
        _cmp(rp, op, f"all2all-parts {tag}")


def test_kmc_input_cross_tool(tmp_path):
    """Synthesized KMC1 databases are read identically by both tools
    (the writer follows real KMC conventions: header_offset includes
    the version word, LUT carries the trailing sentinel)."""
    from kmerdb_jax.io import kmc
    rng = np.random.default_rng(61)
    lst = tmp_path / "kmc.list"
    entries = []
    for i, k in enumerate((12, 20, 24)):
        ks = np.unique(rng.integers(0, 1 << (2 * k),
                                    size=rng.integers(500, 3000),
                                    dtype=np.uint64))
        base = str(tmp_path / f"s{i}_k{k}")
        kmc.write_kmc1(base, np.sort(ks), k)
        entries.append(base)
    # one DB per k (k must be uniform within a database)
    for i, base in enumerate(entries):
        one = tmp_path / f"one{i}.list"
        one.write_text(base + "\n")
        rdb, odb = str(tmp_path / f"r{i}.db"), str(tmp_path / f"o{i}.db")
        ref(["build", "-from-kmers", str(one), rdb])
        ours(["build", "-from-kmers", str(one), odb])
        ra, oa = str(tmp_path / f"r{i}.a2a"), str(tmp_path / f"o{i}.a2a")
        ref(["all2all", rdb, ra])
        ours(["all2all", odb, oa])
        _cmp(ra, oa, f"kmc k={12 + 4 * i}")
    # fractional minhash over KMC input
    one = tmp_path / "one1.list"
    rdb, odb = str(tmp_path / "rf.db"), str(tmp_path / "of.db")
    ref(["build", "-from-kmers", "-f", "0.5", str(one), rdb])
    ours(["build", "-from-kmers", "-f", "0.5", str(one), odb])
    ra, oa = str(tmp_path / "rf.a2a"), str(tmp_path / "of.a2a")
    ref(["all2all", rdb, ra])
    ours(["all2all", odb, oa])
    _cmp(ra, oa, "kmc fractional")
    # minhash -from-kmers: KMC sets -> .minhash files, byte-identical
    base = entries[1]
    ref(["minhash", "-from-kmers", "-f", "0.4", str(one)])
    mh_ref = pathlib.Path(base + ".minhash").read_bytes()
    os.unlink(base + ".minhash")
    ours(["minhash", "-from-kmers", "-f", "0.4", str(one)])
    assert pathlib.Path(base + ".minhash").read_bytes() == mh_ref, \
        "minhash -from-kmers files differ"


def test_fraction_start_overflow(tmp_path):
    """start + fraction >= 1.0: the reference's double->uint64 cast
    saturates to UINT64_MAX, clamping the acceptance window to
    [start, 1.0) instead of wrapping to empty (filter.h:42-43 UB,
    behavior measured from the binary)."""
    rng = np.random.default_rng(63)
    lst = _random_corpus(tmp_path, rng, n=5, length=2500)
    for f, fs in (("0.9", "0.3"), ("0.7", "0.3"), ("0.5", "0.6")):
        rdb, odb = str(tmp_path / f"r{f}{fs}.db"), str(tmp_path / f"o{f}{fs}.db")
        ref(["build", "-k", "18", "-f", f, "-f-start", fs, lst, rdb])
        ours(["build", "-k", "18", "-f", f, "-f-start", fs, lst, odb])
        ra, oa = str(tmp_path / f"r{f}{fs}.a"), str(tmp_path / f"o{f}{fs}.a")
        ref(["all2all", rdb, ra])
        ours(["all2all", odb, oa])
        _cmp(ra, oa, f"all2all f={f} fs={fs}")
        # query-time re-filtering: the reference db never persists
        # startFraction (kmer_db.h:63 default 0, never assigned), so
        # one2all/new2all re-filter with start=0
        q = pathlib.Path(lst).read_text().split()[0]
        ro, oo = str(tmp_path / f"r{f}{fs}.o"), str(tmp_path / f"o{f}{fs}.o")
        ref(["one2all", rdb, q, ro])
        ours(["one2all", odb, q, oo])
        _cmp(ro, oo, f"one2all f={f} fs={fs}")
        # extend re-ingests with the db's (zero) startFraction
        ref(["build", "-extend", lst, rdb])
        ours(["build", "-extend", lst, odb])
        ref(["all2all", rdb, ra])
        ours(["all2all", odb, oa])
        _cmp(ra, oa, f"extend f={f} fs={fs}")


def test_minhash_ignores_fstart(tmp_path):
    """The reference's minhash console hardcodes startValue=0
    (console_minhash.cpp:19): -f-start must not affect the stored
    .minhash files."""
    rng = np.random.default_rng(65)
    lst = _random_corpus(tmp_path, rng, n=4, gz_some=False, length=2000)
    paths = pathlib.Path(lst).read_text().split()
    ref(["minhash", "-f", "0.42", "-f-start", "0.37", "-k", "16", lst])
    blobs = {x: pathlib.Path(x + ".minhash").read_bytes() for x in paths}
    for x in paths:
        os.unlink(x + ".minhash")
    ours(["minhash", "-f", "0.42", "-f-start", "0.37", "-k", "16", lst])
    for x in paths:
        assert pathlib.Path(x + ".minhash").read_bytes() == blobs[x], x
