"""Randomized differential soak vs the reference binary.

Usage: python tools/soak_parity.py [start_case] [n_cases]
(requires /tmp/refbuild/bin/kmer-db — run tools/build_reference.sh).
Alphabet k ranges are capped so the REFERENCE stays tractable: it
allocates 2^(k*bits-32) hashtables up front, which exceeds small hosts
well below its documented k limits (our build has no such blowup; see
tests/test_fuzz_parity.py::test_extreme_k).

Random corpora x random (alphabet, k, fraction, f-start, gz, multifasta,
extend, filters, metrics, sparse, phylip, sampling-best, parts) matrix;
byte-exact comparison on every output. Random-sampling outputs are
compared structurally (row keys), since the reference's random reservoir
depends on internal feed order.
"""
import gzip
import os
import pathlib
import subprocess
import sys
import tempfile
import traceback

import numpy as np

# the device-build rotation uses jax; pin it to the CPU backend so the
# soak measures parity only and never holds a card
os.environ["JAX_PLATFORMS"] = "cpu"

#: build with tools/build_reference.sh
REF = os.environ.get("KMERDB_REF_BIN", "/tmp/refbuild/bin/kmer-db")
sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
from kmerdb_jax.cli.main import main as ours_main  # noqa: E402

ALPHAS = {
    "nt": (b"ACGT", 24, b"NRYWSX"),
    "nt-preserve": (b"ACGT", 24, b"N"),
    "aa": (b"ARNDCQEGHILKMFPSTWYV", 10, b"BZX"),
    "aa11_diamond": (b"ARNDCQEGHILKMFPSTWYV", 13, b"X"),
    "aa12_mmseqs": (b"ARNDCQEGHILKMFPSTWYV", 13, b"X"),
    "aa6_dayhoff": (b"ARNDCQEGHILKMFPSTWYV", 18, b"X"),
}
METRICS = ["jaccard", "min", "max", "cosine", "mash", "ani",
           "ani-shorter", "mash-query", "num-kmers"]
CRITERIA = ["", "jaccard:", "mash:", "ani:", "cosine:", "num-kmers:"]


class RefCrash(Exception):
    """The reference binary itself died (segfault/heap corruption) —
    no oracle exists for this case, so it is recorded and skipped, not
    counted as a parity failure.  Observed on real configs: headerless
    inputs (segfault, r1) and k=11 aa11_diamond builds
    ("malloc(): corrupted top size", soak case 2006, r2) — our tool
    handles both."""


def ref(args, cwd):
    r = subprocess.run([REF, *map(str, args)], capture_output=True, cwd=cwd,
                       timeout=420)
    if r.returncode != 0:
        err = r.stderr.decode()[-400:]
        if r.returncode < 0 or "malloc(" in err or "corrupted" in err:
            raise RefCrash(f"{args}\n{err}")
        raise RuntimeError(f"ref failed: {args}\n{err}")


def ours(args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        rc = ours_main([str(a) for a in args])
    finally:
        os.chdir(old)
    if rc != 0:
        raise RuntimeError(f"ours failed rc={rc}: {args}")


def ours_mesh(args, cwd, mesh_n):
    """Run our CLI with `-mesh N` in a clean subprocess (virtual CPU
    devices: the device count is fixed at backend start, and a child
    with a timeout can't hang the sweep)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1])
    mode, rest = args[0], [str(a) for a in args[1:]]
    r = subprocess.run(
        [sys.executable, "-m", "kmerdb_jax", mode, "-mesh", str(mesh_n),
         *rest],
        capture_output=True, cwd=cwd, timeout=420, env=env, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"ours -mesh {mesh_n} failed rc={r.returncode}: {args}\n"
            f"{r.stderr[-400:]}")


def cmp_bytes(a, b, what):
    ba, bb = pathlib.Path(a).read_bytes(), pathlib.Path(b).read_bytes()
    if ba != bb:
        for i, (x, y) in enumerate(zip(ba.splitlines(), bb.splitlines())):
            if x != y:
                raise AssertionError(
                    f"{what}: line {i}\nREF : {x[:160]!r}\nOURS: {y[:160]!r}")
        raise AssertionError(f"{what}: lengths differ "
                             f"{len(ba)} vs {len(bb)}")


def corpus(tmp, rng, alpha_sym, noise, n, length, gz, multifasta, wrap):
    paths = []
    if multifasta:
        blobs = []
        for i in range(n):
            seq = rng.choice(list(alpha_sym + noise), size=length
                             ).astype(np.uint8)
            raw = bytes(seq)
            body = b"\n".join(raw[j:j + wrap]
                              for j in range(0, len(raw), wrap))
            blobs.append(b">s%d desc words\n" % i + body + b"\n")
        p = tmp / "multi.fasta"
        data = b"".join(blobs)
        if gz:
            p = tmp / "multi.fasta.gz"
            p.write_bytes(gzip.compress(data))
        else:
            p.write_bytes(data)
        paths.append(str(p))
    else:
        base = rng.choice(list(alpha_sym), size=length).astype(np.uint8)
        for i in range(n):
            seq = base.copy()
            pos = rng.integers(0, length, size=max(1, length // 15))
            seq[pos] = rng.choice(list(alpha_sym + noise), size=pos.size
                                  ).astype(np.uint8)
            nc = int(rng.integers(1, 4))
            raw = bytes(seq)
            parts = np.sort(rng.integers(1, length, size=nc - 1)) \
                if nc > 1 else []
            chunks, prev = [], 0
            for cpos in list(parts) + [length]:
                chunks.append(raw[prev:cpos])
                prev = cpos
            body = b""
            for ci, ch in enumerate(chunks):
                w = b"\n".join(ch[j:j + wrap] for j in range(0, len(ch), wrap))
                if (i + ci) % 3 == 1:
                    w = w.lower()
                body += b">g%d_c%d extra\n" % (i, ci) + w + b"\n"
            if gz and i % 3 == 2:
                p = tmp / f"s{i}.fna.gz"
                p.write_bytes(gzip.compress(body))
                paths.append(str(tmp / f"s{i}.fna"))
            else:
                p = tmp / f"s{i}.fasta"
                p.write_bytes(body)
                paths.append(str(p))
    lst = tmp / "c.list"
    lst.write_text("".join(p + "\n" for p in paths))
    return str(lst), paths


def sparse_keys(path):
    rows = {}
    for line in pathlib.Path(path).read_text().splitlines()[2:]:
        f = line.rstrip(",").split(",")
        rows[f[0]] = sorted(f[1::2])
    return rows


def one_case(case, seed):
    rng = np.random.default_rng(seed)
    alpha = list(ALPHAS)[int(rng.integers(0, len(ALPHAS)))]
    sym, kmax, noise = ALPHAS[alpha]
    k = int(rng.integers(5, kmax + 1))
    n = int(rng.integers(3, 10))
    length = int(rng.integers(200, 4000))
    if case % 8 == 7:
        # scale-shape case: wide matrices + longer genomes exercise the
        # sparse/filter pipeline at the large-collection geometry
        # (VERDICT r1 item 10: keep the scale shapes in rotation)
        n = int(rng.integers(40, 160))
        length = int(rng.integers(4000, 20000))
    gz = bool(rng.integers(0, 2))
    multifasta = bool(rng.integers(0, 2))
    # NOTE: the device-build tier is not rotated here.  Coverage is
    # transitive instead: tests/test_device_build.py proves device ==
    # host build bit-for-bit, and this soak proves host == reference.
    dev_build = False
    wrap = int(rng.integers(40, 90))
    frac_mode = int(rng.integers(0, 3))  # 0 plain, 1 -f, 2 -f + -f-start
    extend = bool(rng.integers(0, 2)) and not multifasta
    # device-mesh rotation: ~1/3 of cases re-run ONE mode with
    # `-mesh N` over 8 virtual CPU devices (subprocess, see ours_mesh)
    # and require the same bytes the reference produced.
    mesh_n = int(rng.choice([0, 0, 2, 3, 8])) if case % 8 != 7 else 0
    mesh_mode = ["a2a", "sparse", "n2a"][int(rng.integers(0, 3))]

    with tempfile.TemporaryDirectory() as td:
        tmp = pathlib.Path(td)
        lst, paths = corpus(tmp, rng, sym, noise, n, length, gz,
                            multifasta, wrap)
        bargs = ["-k", k]
        if alpha != "nt":
            bargs += ["-alphabet", alpha]
        if frac_mode >= 1:
            bargs += ["-f", round(float(rng.uniform(0.05, 0.95)), 3)]
        if frac_mode == 2:
            bargs += ["-f-start", round(float(rng.uniform(0.0, 0.9)), 3)]
        if multifasta:
            bargs += ["-multisample-fasta"]
        tag = (f"{alpha} k={k} n={n} len={length} gz={gz} "
               f"mf={multifasta} frac={frac_mode} ext={extend}"
               f"{' devbuild' if dev_build else ''}"
               f"{f' mesh={mesh_n}:{mesh_mode}' if mesh_n else ''}")

        if extend:
            lst1 = tmp / "c1.list"
            lst2 = tmp / "c2.list"
            half = len(paths) // 2 or 1
            lst1.write_text("".join(p + "\n" for p in paths[:half]))
            lst2.write_text("".join(p + "\n" for p in paths[half:]))
            ref(["build", *bargs, lst1, tmp / "r.db"], td)
            ref(["build", *bargs, "-extend", lst2, tmp / "r.db"], td)
            ours(["build", *bargs, lst1, tmp / "o.db"], td)
            ours(["build", *bargs, "-extend", lst2, tmp / "o.db"], td)
        else:
            ref(["build", *bargs, lst, tmp / "r.db"], td)
            ours(["build", *bargs, lst, tmp / "o.db"], td)

        # all2all dense + distance matrix modes
        ref(["all2all", tmp / "r.db", tmp / "r.a2a"], td)
        ours(["all2all", tmp / "o.db", tmp / "o.a2a"], td)
        cmp_bytes(tmp / "r.a2a", tmp / "o.a2a", f"a2a [{tag}]")
        if mesh_n and mesh_mode == "a2a":
            ours_mesh(["all2all", tmp / "o.db", tmp / "o.ma2a"], td, mesh_n)
            cmp_bytes(tmp / "r.a2a", tmp / "o.ma2a",
                      f"a2a -mesh {mesh_n} [{tag}]")

        # fused pipeline (all2all[-sp] -from-fasta, ops/fused.py)
        # against the same reference oracle: no database, same bytes.
        # Only for plain non-extend builds (the fused mode has no
        # -extend); fargs0 = the build-equivalent ingest options
        fargs0 = ["-k", k]
        if alpha != "nt":
            fargs0 += ["-alphabet", alpha]
        if frac_mode >= 1:
            fargs0 += ["-f", bargs[bargs.index("-f") + 1]]
        if frac_mode == 2:
            fargs0 += ["-f-start", bargs[bargs.index("-f-start") + 1]]
        if multifasta:
            fargs0 += ["-multisample-fasta"]
        if not extend and rng.integers(0, 2):
            ours(["all2all", "-from-fasta", *fargs0, lst, tmp / "o.fa2a"],
                 td)
            cmp_bytes(tmp / "r.a2a", tmp / "o.fa2a", f"fused-a2a [{tag}]")

        m = METRICS[int(rng.integers(0, len(METRICS)))]
        dargs = [m]
        if rng.integers(0, 2):
            dargs += ["-phylip-out"]
        ref(["distance", *dargs, tmp / "r.a2a", tmp / "r.d"], td)
        ours(["distance", *dargs, tmp / "o.a2a", tmp / "o.d"], td)
        cmp_bytes(tmp / "r.d", tmp / "o.d", f"distance {dargs} [{tag}]")

        # sparse + filters (random criteria)
        fargs = []
        if rng.integers(0, 2):
            crit = CRITERIA[int(rng.integers(0, len(CRITERIA)))]
            v = int(rng.integers(1, 5)) if crit in ("", "num-kmers:") \
                else round(float(rng.uniform(0, 1)), 2)
            fargs += ["-min", f"{crit}{v}"]
        if rng.integers(0, 2):
            crit = CRITERIA[int(rng.integers(0, len(CRITERIA)))]
            v = int(rng.integers(3, 50)) if crit in ("", "num-kmers:") \
                else round(float(rng.uniform(0.3, 1)), 2)
            fargs += ["-max", f"{crit}{v}"]
        ref(["all2all", "-sparse", *fargs, tmp / "r.db", tmp / "r.sp"], td)
        ours(["all2all", "-sparse", *fargs, tmp / "o.db", tmp / "o.sp"], td)
        cmp_bytes(tmp / "r.sp", tmp / "o.sp", f"a2a sparse {fargs} [{tag}]")
        if mesh_n and mesh_mode == "sparse":
            ours_mesh(["all2all", "-sparse", *fargs, tmp / "o.db",
                       tmp / "o.msp"], td, mesh_n)
            cmp_bytes(tmp / "r.sp", tmp / "o.msp",
                      f"a2a sparse -mesh {mesh_n} {fargs} [{tag}]")

        # distance over SPARSE input (triangle autodetect + sparse out)
        m2 = METRICS[int(rng.integers(0, len(METRICS)))]
        d2 = [m2] + (["-phylip-out"] if rng.integers(0, 2) else
                     (["-sparse"] if rng.integers(0, 2) else []))
        ref(["distance", *d2, tmp / "r.sp", tmp / "r.d2"], td)
        ours(["distance", *d2, tmp / "o.sp", tmp / "o.d2"], td)
        cmp_bytes(tmp / "r.d2", tmp / "o.d2",
                  f"distance-sparse {d2} [{tag}]")

        # all2all-sp (+ sometimes sampling best)
        spargs = list(fargs)
        sample_best = bool(rng.integers(0, 2))
        if sample_best:
            crit = ["jaccard", "mash", "ani", "cosine"][
                int(rng.integers(0, 4))]
            spargs += ["-sample-rows", f"{crit}:{int(rng.integers(1, 6))}"]
        ref(["all2all-sp", *spargs, tmp / "r.db", tmp / "r.sp2"], td)
        ours(["all2all-sp", *spargs, tmp / "o.db", tmp / "o.sp2"], td)
        cmp_bytes(tmp / "r.sp2", tmp / "o.sp2",
                  f"a2a-sp {spargs} [{tag}]")
        if not extend and rng.integers(0, 2):
            # fused sp form: same filters/sampling, no database
            ours(["all2all-sp", "-from-fasta", *fargs0, *spargs, lst,
                  tmp / "o.fsp2"], td)
            cmp_bytes(tmp / "r.sp2", tmp / "o.fsp2",
                      f"fused-sp {spargs} [{tag}]")

        # new2all vs the first input file (not for multifasta-kmc combos)
        q = paths[0]
        qlst = tmp / "q.list"
        qlst.write_text(q + "\n")
        nargs = ["-multisample-fasta"] if multifasta else []
        sp = ["-sparse"] if rng.integers(0, 2) else []
        ref(["new2all", *nargs, *sp, tmp / "r.db", qlst, tmp / "r.n2a"], td)
        ours(["new2all", *nargs, *sp, tmp / "o.db", qlst, tmp / "o.n2a"], td)
        cmp_bytes(tmp / "r.n2a", tmp / "o.n2a", f"new2all {sp} [{tag}]")
        if mesh_n and mesh_mode == "n2a":
            ours_mesh(["new2all", *nargs, *sp, tmp / "o.db", qlst,
                       tmp / "o.mn2a"], td, mesh_n)
            cmp_bytes(tmp / "r.n2a", tmp / "o.mn2a",
                      f"new2all -mesh {mesh_n} {sp} [{tag}]")

        if not multifasta:
            ref(["one2all", tmp / "r.db", q, tmp / "r.o2a"], td)
            ours(["one2all", tmp / "o.db", q, tmp / "o.o2a"], td)
            cmp_bytes(tmp / "r.o2a", tmp / "o.o2a", f"one2all [{tag}]")

        # minhash roundtrip (dna only; console forces nt)
        if alpha == "nt" and not multifasta and frac_mode >= 1:
            f = bargs[bargs.index("-f") + 1]
            # cross-feed: -from-minhash lists ORIGINAL paths (both
            # tools append .minhash), so swap produced files in place:
            # ours builds from REF's minhash files and vice versa
            ref(["minhash", "-k", k, "-f", f, lst], td)
            ours(["build", "-from-minhash", lst, tmp / "ox.db"], td)
            for p in paths:
                os.unlink(p + ".minhash")
            ours(["minhash", "-k", k, "-f", f, lst], td)
            ref(["build", "-from-minhash", lst, tmp / "rx.db"], td)
            ref(["all2all", tmp / "rx.db", tmp / "rx.a2a"], td)
            ours(["all2all", tmp / "ox.db", tmp / "ox.a2a"], td)
            cmp_bytes(tmp / "rx.a2a", tmp / "ox.a2a",
                      f"minhash-cross [{tag}]")

        # parts grid
        if not multifasta and n >= 4 and rng.integers(0, 2):
            np_parts = int(rng.integers(2, 4))
            plists = []
            chunk = (len(paths) + np_parts - 1) // np_parts
            for pi in range(np_parts):
                pl = tmp / f"p{pi}.list"
                sub = paths[pi * chunk:(pi + 1) * chunk]
                if not sub:
                    continue
                pl.write_text("".join(p + "\n" for p in sub))
                plists.append(pl)
            rdbl, odbl = tmp / "rdb.list", tmp / "odb.list"
            rparts, oparts = [], []
            for pi, pl in enumerate(plists):
                ref(["build", *bargs, pl, tmp / f"rp{pi}.db"], td)
                ours(["build", *bargs, pl, tmp / f"op{pi}.db"], td)
                rparts.append(f"rp{pi}.db")
                oparts.append(f"op{pi}.db")
            rdbl.write_text("".join(p + "\n" for p in rparts))
            odbl.write_text("".join(p + "\n" for p in oparts))
            ref(["all2all-parts", *fargs, rdbl, tmp / "r.pp"], td)
            ours(["all2all-parts", *fargs, odbl, tmp / "o.pp"], td)
            cmp_bytes(tmp / "r.pp", tmp / "o.pp",
                      f"a2a-parts {np_parts} {fargs} [{tag}]")
    return tag


def main():
    start = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    count = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    fails = 0
    for c in range(start, start + count):
        try:
            tag = one_case(c, 900_000 + c)
            print(f"OK   case {c}: {tag}", flush=True)
        except RefCrash as e:
            print(f"SKIP case {c}: reference binary crashed "
                  f"(no oracle): {str(e)[:200]}", flush=True)
        except Exception:
            fails += 1
            print(f"FAIL case {c}:", flush=True)
            traceback.print_exc()
            if fails >= 5:
                break
    print(f"done: {count} cases, {fails} failures", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
