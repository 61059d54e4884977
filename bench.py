"""Benchmark: build + all2all on two corpora, host and device tiers.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Two sections:

* quick  — 128 x 300 kbp corpus (round-1 continuity): build best-of-3
  + host all2all; the reference baseline for it is in
  BASELINE_MEASURED.json ("quick" keys).
* scale  — 4,096 x 30 kbp outbreak-style phylogenetic corpus
  (bench_corpus.generate_scale: the ICTV-scale role).  Measures build,
  the host C++ all2all tier, and the device tier cold (fresh programs)
  and warm (steady state), with derived pairs/s and the Gram's share
  of the device's published int8 peak (ops/gram.PEAKS).

Headline value = end-to-end (build + device all2all) k-mer instance
throughput on the scale corpus.  vs_baseline compares against the
measured reference wall-clock on the same corpus and host.

HONESTY LABELS: the reference numbers in BASELINE_MEASURED.json came
from a 1-vCPU host, so the reference's `-t 16` degraded to ~1 thread —
they carry baseline_threads_effective=1, and vs_baseline_16t_projected
divides the reference time by 16 (its all2all scales near-linearly
with threads) so the multi-thread bar cannot be misread.

KMERDB_BENCH_SCALE=0 skips the scale section (quick-only mode).
"""

import json
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Stdout contract: the record is ONE JSON line on fd 1.  Defend at
# the fd level: duplicate the real stdout to a private fd at import,
# then point fd 1 (and sys.stdout) at stderr so every stray print —
# ours, a library's, or a C extension's — lands on stderr.  The one
# JSON line is written through the saved fd by _emit_json_line, which
# re-parses it first so a malformed record can never be emitted.
if __name__ == "__main__":
    _REAL_STDOUT_FD = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
else:                       # imported for its helpers: leave fds alone
    _REAL_STDOUT_FD = 1


def _emit_json_line(obj) -> None:
    line = json.dumps(obj)
    parsed = json.loads(line)           # self-verify before emitting
    assert parsed == obj or parsed is not None
    assert "\n" not in line
    os.write(_REAL_STDOUT_FD, (line + "\n").encode())

CORPUS_DIR = os.environ.get("KMERDB_BENCH_CORPUS", "/tmp/kmerdb_bench_corpus")
SCALE_DIR = os.environ.get("KMERDB_BENCH_SCALE_CORPUS",
                           "/tmp/kmerdb_scale4k")


def _phase(name: str) -> None:
    """Timestamped phase marker on stderr: the scale section runs
    minutes of silent work, and a slow run must be attributable to a
    phase."""
    print(f"bench: [{time.strftime('%H:%M:%S')}] {name}", file=sys.stderr,
          flush=True)


def bench_quick(base):
    from kmerdb_jax.utils.bench_corpus import generate
    from kmerdb_jax.cli.main import main as cli

    list_path = generate(CORPUS_DIR)
    with tempfile.TemporaryDirectory() as td:
        db = os.path.join(td, "bench.db")
        out = os.path.join(td, "bench.a2a")
        # best of three: page provisioning and writeback speed swing
        # 2-3x run-to-run on this host (round-1 measurements)
        build_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            rc = cli(["build", list_path, db])
            build_times.append(time.perf_counter() - t0)
            assert rc == 0, "build failed"
        a2a_times = []
        for _ in range(2):
            t0 = time.perf_counter()
            rc = cli(["all2all", db, out])
            a2a_times.append(time.perf_counter() - t0)
            assert rc == 0, "all2all failed"
        # new2all: the corpus queried against its own database (the
        # reference CI shape, main.yml "new2all k18.db seqs.list");
        # best of two — ingest+probe+apply, host tier
        n2a = os.path.join(td, "bench.n2a")
        n2a_times = []
        for _ in range(2):
            t0 = time.perf_counter()
            rc = cli(["new2all", db, list_path, n2a])
            n2a_times.append(time.perf_counter() - t0)
            assert rc == 0, "new2all failed"
        n_lines = sum(1 for _ in open(out))
    assert n_lines == base["n_samples"] + 2, "unexpected output shape"
    return {
        "build_s": round(min(build_times), 2),
        "all2all_s": round(min(a2a_times), 2),
        "new2all_s": round(min(n2a_times), 2),
        "build_runs_s": [round(t, 2) for t in build_times],
        "ref_build_s": base["reference_build_s"],
        "ref_all2all_s": base["reference_all2all_s"],
        "ref_new2all_s": base.get("reference_new2all_s"),
    }


def scale_device_section(list_path: str, db_path: str,
                         build_s: float) -> dict:
    """Everything in the scale section that touches the device, in
    this process."""
    import hashlib
    import numpy as np
    from kmerdb_jax.cli.main import main as cli
    from kmerdb_jax.io import dbfile
    from kmerdb_jax.ops import device_a2a

    out = {}
    db = dbfile.load_db(db_path, dbfile.PATTERNS)
    C_dev = None

    _phase("scale: device all2all (cold)")
    # device tier: cold (fresh programs in this process) then warm
    t0 = time.perf_counter()
    C_dev = device_a2a.all2all_device(db)
    dev_cold_s = time.perf_counter() - t0
    st_cold = dict(device_a2a.last_stats)
    t0 = time.perf_counter()
    C_dev = device_a2a.all2all_device(db)
    dev_warm_s = time.perf_counter() - t0
    st = device_a2a.last_stats
    out["c_dev_sha"] = hashlib.sha256(
        np.ascontiguousarray(C_dev)).hexdigest()
    out["device_all2all_cold_s"] = round(dev_cold_s, 2)
    out["device_phase_cold_s"] = {k: round(v, 2)
                                  for k, v in st_cold.items()
                                  if k.endswith("_s")}
    out["device_all2all_warm_s"] = round(dev_warm_s, 2)
    out["device_gram_ops"] = st["flops"]
    out["device_phase_s"] = {k: round(v, 2) for k, v in st.items()
                             if k.endswith("_s")}

    # Gram-only throughput on this database's resident packed
    # incidence, as a share of the device's published int8 peak
    _phase("scale: kernel_bench")
    out["kernel_bench"] = device_a2a.kernel_bench(db)

    # fused FASTA->all2all pipeline (ops/fused.py): one process, no
    # database — ingest + merge on host, group Gram on the device.
    # Warm = second call (programs compiled, arenas grown)
    try:
        _phase("scale: fused pipeline")
        from kmerdb_jax.ops import fused as fused_mod
        from kmerdb_jax.cli import loader
        tf0 = time.perf_counter()
        streams = [s.kmers for s in loader.iter_samples(
            list_path, "genome", 18, 1.0, 0.0, "nt", False)]
        fused_ingest_s = time.perf_counter() - tf0
        tf0 = time.perf_counter()
        C_fused = fused_mod.all2all_group_counts(streams)
        fused_cold_s = time.perf_counter() - tf0
        fused_mod.last_stats.clear()
        tf0 = time.perf_counter()
        C_fused = fused_mod.all2all_group_counts(streams)
        fused_warm_s = time.perf_counter() - tf0
        if C_dev is not None:
            assert np.array_equal(C_fused, C_dev), \
                "fused != device pattern path"
        out["c_fused_sha"] = hashlib.sha256(
            np.ascontiguousarray(C_fused)).hexdigest()
        out["fused_pipeline"] = {
            "ingest_s": round(fused_ingest_s, 2),
            "pipeline_cold_s": round(fused_ingest_s + fused_cold_s,
                                     2),
            "pipeline_warm_s": round(fused_ingest_s + fused_warm_s,
                                     2),
            "tier": ("device" if fused_mod.last_stats else "host"),
            "phase_s": {k: round(v, 2)
                        for k, v in fused_mod.last_stats.items()
                        if k.endswith("_s")},
            "n_groups": fused_mod.last_stats.get("n_groups"),
            "parity_vs_pattern_path": C_dev is not None,
            "note": ("FASTA list -> all2all CSV matrix in ONE "
                     "command (all2all -from-fasta), no database "
                     "built; byte-identical output to "
                     "build+all2all"),
        }
    except Exception as e:
        out["fused_pipeline"] = {"error": str(e)[:300]}

    # device build tier: record it even where it loses.  Run twice:
    # the first run pays one-time program compiles, the second is the
    # steady state — both recorded, vs_host on the warm run (the host
    # build_s is itself a best-of-2).
    if os.environ.get("KMERDB_BENCH_DEVBUILD", "1") != "0":
        _phase("scale: device build")
        os.environ["KMERDB_BUILD_DEVICE"] = "1"
        # one batch -> one pow2 partition shape -> ONE compile of each
        # device-build program instead of three (byte-invariant:
        # consoles._build_batch_size)
        os.environ["KMERDB_BUILD_BATCH"] = "4096"
        try:
            import filecmp
            dbd_path = os.path.join(SCALE_DIR, "bench_scale_dev.db")
            runs = []
            identical = True
            for _ in range(2):
                if os.path.exists(dbd_path):
                    os.unlink(dbd_path)
                t0 = time.perf_counter()
                rc = cli(["build", list_path, dbd_path])
                runs.append(round(time.perf_counter() - t0, 2))
                assert rc == 0
                identical &= filecmp.cmp(db_path, dbd_path,
                                         shallow=False)
                _phase(f"scale: device build pass done ({runs[-1]} s)")
            os.unlink(dbd_path)
            out["device_build"] = {
                "build_cold_s": runs[0],
                "build_s": runs[-1],
                "byte_identical_db": identical,
                "vs_host_build": round(build_s / runs[-1], 3),
            }
        except Exception as e:
            out["device_build"] = {"error": str(e)[:300]}
        finally:
            os.environ.pop("KMERDB_BUILD_DEVICE", None)
            os.environ.pop("KMERDB_BUILD_BATCH", None)
    return out


def bench_scale(base):
    import numpy as np
    from kmerdb_jax.utils.bench_corpus import generate_scale
    from kmerdb_jax.cli.main import main as cli
    from kmerdb_jax.io import dbfile
    from kmerdb_jax.utils import native

    list_path = generate_scale(SCALE_DIR, n_samples=4096,
                               genome_len=30_000, branch_rate=0.0008)
    db_path = os.path.join(SCALE_DIR, "bench_scale.db")
    build_times = []
    for _ in range(2):
        if os.path.exists(db_path):
            os.unlink(db_path)
        t0 = time.perf_counter()
        rc = cli(["build", list_path, db_path])
        build_times.append(time.perf_counter() - t0)
        assert rc == 0, "scale build failed"
    build_s = min(build_times)

    db = dbfile.load_db(db_path, dbfile.PATTERNS)
    S = db.n_samples
    pairs = S * (S - 1) / 2

    # host tier first (pure CPU, cannot wedge): measured once per
    # database content and memoized (the ~2 min scatter would
    # otherwise dominate every bench run)
    _phase("scale: host all2all")
    offs = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    sids = np.ascontiguousarray(db.pattern_sample_ids, dtype=np.uint32)
    memo_key = f"{S}-{db.n_patterns}-{db.n_kmers}"
    memo_path = os.path.join(SCALE_DIR, f"host_a2a_{memo_key}.json")
    import hashlib
    if os.path.exists(memo_path):
        memo = json.loads(open(memo_path).read())
        host_s, host_sha = memo["host_s"], memo.get("host_sha")
    else:
        t0 = time.perf_counter()
        C_host = native.a2a_dense(offs, sids, db.pattern_num_kmers, S)
        host_s = time.perf_counter() - t0
        host_sha = hashlib.sha256(
            np.ascontiguousarray(C_host)).hexdigest()
        with open(memo_path, "w") as f:
            json.dump({"host_s": host_s, "host_sha": host_sha}, f)

    # scale new2all (host tier: pattern-major apply): 256 queries (a
    # corpus prefix) against the 4,096-sample DB, best of two — the
    # reference binary measured 59.6 s on this exact workload
    # (BASELINE_MEASURED scale_reference_new2all_s, 2026-08-20)
    _phase("scale: new2all 256q")
    n2a_s = None
    try:
        q_list = os.path.join(SCALE_DIR, "bench_q256.list")
        with open(list_path) as f, open(q_list, "w") as g:
            for i, line in enumerate(f):
                if i >= 256:
                    break
                g.write(line)
        n2a_times = []
        # pin to the host tier: this benchmarks the pattern-major host
        # apply
        prev_n2a = os.environ.get("KMERDB_N2A_DEVICE")
        os.environ["KMERDB_N2A_DEVICE"] = "0"
        try:
            with tempfile.TemporaryDirectory() as td:
                for _ in range(2):
                    t0 = time.perf_counter()
                    rc = cli(["new2all", db_path, q_list,
                              os.path.join(td, "scale.n2a")])
                    n2a_times.append(time.perf_counter() - t0)
                    assert rc == 0, "scale new2all failed"
        finally:
            if prev_n2a is None:
                os.environ.pop("KMERDB_N2A_DEVICE", None)
            else:
                os.environ["KMERDB_N2A_DEVICE"] = prev_n2a
        n2a_s = min(n2a_times)
    except Exception as e:
        n2a_s = None
        print(f"bench: scale new2all failed: {e}", file=sys.stderr)

    dev = scale_device_section(list_path, db_path, build_s)
    if host_sha is not None:
        assert dev["c_dev_sha"] == host_sha, "device != host at scale"
        dev["parity_device_vs_host"] = True
        if dev.get("c_fused_sha") is not None:
            assert dev["c_fused_sha"] == host_sha, \
                "fused != host at scale"
    dev_warm_s = dev["device_all2all_warm_s"]

    total_kmers = int(db.sample_kmer_counts.sum())
    return {
        "n_samples": S,
        "n_patterns": int(db.n_patterns),
        "total_kmer_instances": total_kmers,
        "build_s": round(build_s, 2),
        "build_runs_s": [round(t, 2) for t in build_times],
        "host_all2all_s": round(host_s, 2),
        "device_vs_host_speedup": round(host_s / dev_warm_s, 2),
        "pairs_per_s_host": round(pairs / host_s, 1),
        "pairs_per_s_device_warm": round(pairs / dev_warm_s, 1),
        **({"new2all_256q_s": round(n2a_s, 2),
            "ref_new2all_256q_s": base.get("scale_reference_new2all_s"),
            **({"new2all_vs_baseline": round(
                base["scale_reference_new2all_s"] / n2a_s, 2)}
               if base.get("scale_reference_new2all_s") else {})}
           if n2a_s else {}),
        **{k: v for k, v in dev.items() if k != "c_dev_sha"},
        "ref_build_s": base.get("scale_reference_build_s"),
        "ref_all2all_s": base.get("scale_reference_all2all_s"),
    }


def bench_mesh_scaling():
    """Multi-device agreement on a VIRTUAL CPU mesh.  Validates that
    the same CLI-reachable sharded kernels (-mesh N) execute and agree
    byte-for-byte at every device count; the wall-clock column is
    labeled what it is: N virtual devices sharing the host's cores, so
    it measures sharding overhead, not speedup."""
    import hashlib
    import subprocess
    import sys

    from kmerdb_jax.utils.bench_corpus import generate
    from kmerdb_jax.cli.main import main as cli

    list_path = generate(CORPUS_DIR)
    db_path = os.path.join(CORPUS_DIR, "mesh_bench.db")
    if not os.path.exists(db_path):
        assert cli(["build", list_path, db_path]) == 0

    snippet = """
import json, sys, time
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from jax.sharding import Mesh
from kmerdb_jax.io import dbfile
from kmerdb_jax.parallel import sharded
n = int(sys.argv[1])
db = dbfile.load_db(sys.argv[2], dbfile.PATTERNS)
mesh = Mesh(np.array(jax.devices()).reshape(n), ("shard",))
t0 = time.perf_counter(); C = sharded.all2all_counts_sharded(db, mesh)
cold = time.perf_counter() - t0
t0 = time.perf_counter(); C = sharded.all2all_counts_sharded(db, mesh)
warm = time.perf_counter() - t0
import hashlib
print(json.dumps({"cold_s": round(cold, 2), "warm_s": round(warm, 2),
                  "sha": hashlib.sha256(np.ascontiguousarray(C)
                                        ).hexdigest()[:16]}))
"""
    out = {}
    shas = set()
    for n in (1, 2, 8):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) \
            + os.pathsep + env.get("PYTHONPATH", "")
        try:
            r = subprocess.run(
                [sys.executable, "-c", snippet, str(n), db_path],
                env=env, capture_output=True, text=True, timeout=900)
            row = json.loads(r.stdout.strip().splitlines()[-1])
            shas.add(row.pop("sha"))
            out[str(n)] = row
        except Exception as e:
            out[str(n)] = {"error": str(e)[:200]}
    out["byte_identical_across_device_counts"] = len(shas) == 1
    out["note"] = ("N VIRTUAL CPU devices sharing the host's cores: "
                   "validates the CLI-reachable sharded path at every "
                   "geometry and bounds its overhead; not a speedup "
                   "claim")
    return out


def bench_multihost_virtual():
    """Multi-process agreement: 2 jax.distributed CPU processes x 4
    virtual devices.  Validates the full DCN
    path (host-sharded ingest -> range-sharded build -> psum all2all
    -> new2all -> db2db, every stage byte-asserted in the workers) and
    bounds its overhead; not a speedup claim."""
    import re

    import __graft_entry__ as graft
    raw = graft.dryrun_multihost(2, 4)
    ok_lines = [l for l in raw.splitlines() if "MULTIHOST_OK" in l]
    line = ok_lines[-1] if ok_lines else raw[-200:]
    out = {"ok": bool(ok_lines), "line": line}
    for key in ("a2a_cold_s", "a2a_warm_s"):
        m = re.search(rf"{key}=([0-9.]+)", line)
        if m:
            out[key] = float(m.group(1))
    out["note"] = ("2 jax.distributed processes x 4 VIRTUAL CPU "
                   "devices: full-pipeline multi-process validation "
                   "with byte-asserted stages; wall-clock bounds "
                   "sharding+collective overhead only")
    return out


def main():
    base_path = pathlib.Path(__file__).parent / "BASELINE_MEASURED.json"
    base = json.loads(base_path.read_text())

    quick = bench_quick(base)
    q_total = quick["build_s"] + quick["all2all_s"]
    q_ref = base["reference_total_s"]

    detail = {
        "quick": quick,
        "baseline_threads_effective": 1,
        **({"new2all_vs_baseline": round(
            base["reference_new2all_s"] / quick["new2all_s"], 2)}
           if quick.get("new2all_s") and base.get("reference_new2all_s")
           else {}),
        "baseline_note": ("reference kmer-db 2.3.1 run with -t 16 on a "
                          "1-vCPU host (hardware_concurrency=1): "
                          "effectively single-threaded"),
    }

    if os.environ.get("KMERDB_BENCH_MESH", "1") != "0":
        try:
            detail["mesh_scaling_virtual"] = bench_mesh_scaling()
        except Exception as e:
            detail["mesh_scaling_virtual"] = {"error": str(e)[:300]}
        try:
            detail["multihost_virtual"] = bench_multihost_virtual()
        except Exception as e:
            detail["multihost_virtual"] = {"error": str(e)[:300]}

    scale = None
    if os.environ.get("KMERDB_BENCH_SCALE", "1") != "0" and \
            base.get("scale_reference_total_s"):
        try:
            scale = bench_scale(base)
        except Exception as e:
            detail["scale_error"] = str(e)[:300]
    if scale is not None:
        detail["scale"] = scale
        # steady-state pipeline: warm-build + warm device all2all; the
        # cold pass is reported separately
        our_total = scale["build_s"] + scale["device_all2all_warm_s"]
        ref_total = base["scale_reference_total_s"]
        value = scale["total_kmer_instances"] / our_total
        vs = ref_total / our_total
        detail["vs_baseline_16t_projected"] = round(vs / 16, 3)
        detail["vs_baseline_incl_cold"] = round(
            ref_total / (scale["build_s"]
                         + scale["device_all2all_cold_s"]), 4)
        fw = scale.get("fused_pipeline", {}).get("pipeline_warm_s")
        if fw:
            detail["fused_vs_baseline"] = round(ref_total / fw, 2)
            detail["fused_vs_baseline_16t_projected"] = round(
                ref_total / fw / 16, 3)
        metric = ("build+all2all kmer instances/s "
                  "(4096x30kbp scale corpus, k=18, device tier)")
    else:
        value = base["total_kmer_instances"] / q_total
        vs = q_ref / q_total
        detail["vs_baseline_16t_projected"] = round(vs / 16, 3)
        metric = ("build+all2all kmer instances/s "
                  "(128x300kbp corpus, k=18)")

    _emit_json_line({
        "metric": metric,
        "value": round(value, 1),
        "unit": "kmers/s",
        "vs_baseline": round(vs, 4),
        "detail": detail,
    })


if __name__ == "__main__":
    main()
