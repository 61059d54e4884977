"""Odd-geometry automation (VERDICT r2 item 8): device counts that do
NOT divide the pattern/sample axes (3, 5) run the full five-stage
dryrun, and the streamed device path handles S % tile != 0 with
multi-limb heavy weights."""

import os
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_devices", [3, 5])
def test_dryrun_multichip_odd(n_devices):
    """dryrun_multichip at non-power-of-two device counts: 3 and 5
    devices against a 3*n+1-sample corpus (neither patterns nor
    samples divide evenly).  Subprocess: the dryrun reconfigures the
    virtual device count, which must happen before backend init."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c",
         f"import __graft_entry__ as g; g.dryrun_multichip({n_devices})"],
        env=env, capture_output=True, text=True, timeout=560, cwd=_REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"dryrun_multichip({n_devices})" in r.stdout


def test_streamed_rows_ragged_heavy():
    """all2all_device_rows with S % 128 != 0, a
    sub-tile stripe request, and heavy multi-limb pattern weights ==
    host path."""
    from kmerdb_jax.models.database import KmerPatternDb
    from kmerdb_jax.models import builder
    from kmerdb_jax.ops import device_a2a, intersect

    rng = np.random.default_rng(41)
    pool = rng.integers(0, 1 << 40, size=3000, dtype=np.uint64)
    # 23 shared k-mer cores -> heavy patterns with counts >= 2^8
    core = np.unique(pool[:1500])
    samples = []
    for i in range(23):
        extra = np.unique(rng.choice(pool, size=rng.integers(50, 400),
                                     replace=False))
        samples.append((f"s{i}", np.unique(np.concatenate(
            [core, extra]))))
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)
    assert int(db.pattern_num_kmers.max()) >= 256   # multi-limb

    want = intersect.all2all_counts(db)
    rows = {}
    device_a2a.all2all_device_rows(db, lambda i, r: rows.update(
        {i: r.copy()}), stripe_rows=128)
    got = np.stack([rows[i] for i in range(db.n_samples)])
    np.testing.assert_array_equal(got, want)
