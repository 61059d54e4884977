"""One process of the multi-host dryrun (launched by
__graft_entry__.dryrun_multihost / tests/test_multihost.py).

Usage: python tools/multihost_worker.py <proc_id> <n_procs> \
           <devices_per_proc> <port>

Each process owns `devices_per_proc` virtual CPU devices; the
processes join one jax.distributed runtime (the analogue of several
hosts) and run the FULL pipeline over the GLOBAL mesh —
the same five stages as the single-process dryrun
(__graft_entry__.dryrun_multichip):

  1. host-sharded k-mer extraction (each process pushes only its own
     sample slice; parallel/sharded._to_global slices by process)
  2. k-mer-range-sharded database build (merge + set-hash dedup per
     range, per-range outputs allgathered so every process assembles
     the identical DB)
  3. pattern-sharded all2all with psum merge
  4. query-sharded batched new2all
  5. pattern-pair-sharded db2db

Every process asserts byte equality of every stage against the
single-host reference kernels (SURVEY §5 "Distributed communication
backend" / §7.2 step 7; the reference has no multi-node story at
all — its closest analogue is the reader/worker thread pools,
src/loader_ex.cpp:55-66, lifted to DCN here).
"""

import os
import sys


def main():
    pid, nproc, ndev, port = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={ndev}")
    os.environ["KMERDB_COORD"] = f"127.0.0.1:{port}"
    os.environ["KMERDB_NUM_PROCS"] = str(nproc)
    os.environ["KMERDB_PROC_ID"] = str(pid)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", ndev)

    import numpy as np
    from kmerdb_jax.parallel.mesh import init_distributed
    assert init_distributed(), "KMERDB_COORD must select multi-process"
    assert jax.process_count() == nproc

    from jax.sharding import Mesh
    from kmerdb_jax.models.database import KmerPatternDb
    from kmerdb_jax.models import builder
    from kmerdb_jax.ops import extract, intersect
    from kmerdb_jax.ops.alphabet import get_alphabet
    from kmerdb_jax.types import KMER_SENTINEL
    from kmerdb_jax.parallel import sharded

    D = nproc * ndev
    mesh = Mesh(np.array(jax.devices()).reshape(D), ("shard",))
    assert sharded._multiproc()

    # deterministic corpus, identical in every process (stands in for
    # a shared filesystem); mixed lengths + shared ancestry so the
    # patterns are non-trivial and weights span multiple limbs
    rng = np.random.default_rng(11)
    k = 18
    L = 512
    n_samp = 2 * D          # divisible by D: even device slices
    alph = get_alphabet("nt")
    seqs = np.zeros((n_samp, L), dtype=np.uint8)
    lengths = np.zeros(n_samp, dtype=np.int32)
    ancestor = rng.choice(list(b"ACGT"), size=L).astype(np.uint8)
    for i in range(n_samp):
        ln = int(rng.integers(150, L))
        g = ancestor[:ln].copy()
        pos = rng.integers(0, ln, size=int(ln * 0.05))
        g[pos] = rng.choice(list(b"ACGT"), size=pos.size).astype(np.uint8)
        seqs[i, :ln] = g
        lengths[i] = ln

    # stage 1: host-sharded extraction — this process pushes only its
    # own sample slice; the gathered result must equal host extraction
    kmer_blocks = np.asarray(sharded.extract_sharded(
        seqs, lengths, k, "nt", mesh))
    host_blocks = extract.extract_block_np(seqs, lengths, k, alph)
    np.testing.assert_array_equal(kmer_blocks, host_blocks)

    samples = []
    for i in range(n_samp):
        flat = np.sort(kmer_blocks[i])
        flat = flat[:np.searchsorted(flat, KMER_SENTINEL)]
        samples.append((f"s{i}", np.unique(flat)))

    # stage 2: k-mer-range-sharded build over the global mesh
    db = sharded.build_sharded(
        KmerPatternDb(kmer_length=k, fraction=1.0, alphabet_name="nt"),
        samples, mesh)
    db_host = builder.add_samples(
        KmerPatternDb(kmer_length=k, fraction=1.0, alphabet_name="nt"),
        samples)
    np.testing.assert_array_equal(db.kmers, db_host.kmers)
    np.testing.assert_array_equal(db.kmer_pattern_ids,
                                  db_host.kmer_pattern_ids)
    np.testing.assert_array_equal(db.pattern_num_kmers,
                                  db_host.pattern_num_kmers)
    np.testing.assert_array_equal(db.pattern_sample_ids,
                                  db_host.pattern_sample_ids)

    # stage 3: pattern-sharded all2all (psum over the global mesh);
    # timed cold/warm so the bench can record a measured (virtual,
    # honestly-labeled) N-process row for the north star's N-hosts axis
    import time
    t0 = time.perf_counter()
    C = sharded.all2all_counts_sharded(db, mesh)
    a2a_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    C2 = sharded.all2all_counts_sharded(db, mesh)
    a2a_warm_s = time.perf_counter() - t0
    np.testing.assert_array_equal(C, intersect.all2all_counts(db))
    np.testing.assert_array_equal(C, C2)

    # stage 4: query-sharded new2all
    queries = [ks for _, ks in samples[: D + 1]]
    M = sharded.many2all_counts_sharded(db, queries, mesh)
    M_ref = intersect.many2all_counts(db, queries, use_device=False)
    np.testing.assert_array_equal(M, M_ref)

    # stage 5: pattern-pair-sharded db2db
    half = n_samp // 2
    dbA = builder.add_samples(
        KmerPatternDb(kmer_length=k, fraction=1.0, alphabet_name="nt"),
        samples[:half])
    dbB = builder.add_samples(
        KmerPatternDb(kmer_length=k, fraction=1.0, alphabet_name="nt"),
        samples[half:])
    X = sharded.db2db_counts_sharded(dbA, dbB, mesh)
    np.testing.assert_array_equal(X, intersect.db2db_counts(dbA, dbB))

    if pid == 0:
        print(f"MULTIHOST_OK procs={nproc} devs={D} stages=5 "
              f"S={db.n_samples} P={db.n_patterns} "
              f"a2a_cold_s={a2a_cold_s:.2f} a2a_warm_s={a2a_warm_s:.2f}",
              flush=True)


if __name__ == "__main__":
    main()
