"""End-to-end check of the device path on one GPU.

    python chip_smoke.py                 # one card, every phase
    python chip_smoke.py --four-cards    # the -mesh 4 path on four cards

Builds the 4,096-genome x 30 kbp scale corpus (utils/bench_corpus,
k = 18, the reference's ICTV-collection role) and drives the CLI the
way a user would, comparing every device-tier output byte-for-byte
with the host C++ tier on the same input:

  1 main      build, then all2all dense and -sparse -min num-kmers:11
              with default routing (must pick the GPU tier)
  2 streamed  KMERDB_A2A_STREAM=1, dense and sparse (on-device filter)
  3 fused     all2all -from-fasta with KMERDB_FUSED_DEVICE=1
  4 new2all   KMERDB_N2A_DEVICE=1, 256 queries from the corpus
  5 parts     all2all-parts over 4 parts: device grid, streamed grid,
              and the db2db device tier for the off-diagonal cells
  6 build     KMERDB_BUILD_DEVICE=1 and KMERDB_DEVICE_INGEST=1 DBs are
              byte-identical to the host build
  7 kernel    the Gram engine vs its bf16 reference and the host
              a2a_dense at S = 4,096 (multi-limb weights, u32 wrap)

--four-cards runs only `build -mesh 4`, `all2all -mesh 4` (dense and
streamed-sparse) and `new2all -mesh 4`, each compared with the same
command on one card.

The first stdout line is the card's name and power limit (nvidia-smi);
phase results follow; the last line is one JSON object.  Exits
non-zero, printing no result, when JAX has no GPU backend or any phase
fails.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

N_SAMPLES = 4096
GENOME_LEN = 30_000
SPARSE = ["-sparse", "-min", "num-kmers:11"]


def say(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def env(**kv):
    """Set (value str) or unset (value None) env vars for one block."""
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Smoke:
    #: Gram-kernel check shape (phase 7)
    kernel_S = 4096
    kernel_rows = 64 * 1024

    def __init__(self, work: str, platform: str, n_samples: int,
                 genome_len: int):
        from kmerdb_jax.utils.bench_corpus import generate_scale
        self.work = work
        self.platform = platform
        t0 = time.perf_counter()
        self.list = generate_scale(os.path.join(work, "corpus"),
                                   n_samples=n_samples,
                                   genome_len=genome_len,
                                   branch_rate=0.0008)
        self.paths = open(self.list).read().split()
        say(f"setup corpus: {len(self.paths)} genomes x {genome_len} bp "
            f"in {time.perf_counter() - t0:.1f} s")

    def p(self, name):
        return os.path.join(self.work, name)

    def cli(self, *args):
        from kmerdb_jax.cli.main import main
        t0 = time.perf_counter()
        rc = main([str(a) for a in args])
        if rc != 0:
            raise RuntimeError(f"`{' '.join(map(str, args))}` exited {rc}")
        return time.perf_counter() - t0

    @staticmethod
    def same(a, b, what):
        if not _same_bytes(a, b):
            raise AssertionError(f"{what}: {a} and {b} differ")

    def device_ran(self, stats, what):
        if stats.get("platform") != self.platform:
            raise AssertionError(f"{what}: device tier did not run on "
                                 f"{self.platform} (stats {stats})")

    def write_list(self, name, paths):
        with open(self.p(name), "w") as f:
            f.write("".join(x + "\n" for x in paths))
        return self.p(name)

    # -- one card ---------------------------------------------------------

    def main_path(self):
        from kmerdb_jax.ops import costcal, device_a2a
        t = self.cli("build", "-k", "18", self.list, self.p("db"))
        say(f"  build (host) {t:.1f} s")
        with env(KMERDB_A2A_DEVICE="0"):
            t = self.cli("all2all", self.p("db"), self.p("host.csv"))
            t_sp = self.cli("all2all", *SPARSE, self.p("db"),
                            self.p("host_sp.csv"))
        say(f"  all2all host tier: dense {t:.1f} s, sparse {t_sp:.1f} s")
        with env(KMERDB_A2A_DEVICE=None, KMERDB_A2A_STREAM=None):
            for out, args in (("dev.csv", []), ("dev_sp.csv", SPARSE)):
                device_a2a.last_stats.clear()
                t = self.cli("all2all", *args, self.p("db"), self.p(out))
                self.device_ran(device_a2a.last_stats, "default routing")
                say(f"  all2all {out} default routing -> device {t:.1f} s "
                    f"({_phases(device_a2a.last_stats)})")
        self.same(self.p("dev.csv"), self.p("host.csv"), "dense")
        self.same(self.p("dev_sp.csv"), self.p("host_sp.csv"), "sparse")
        c = costcal.resolve()
        say("  calibrated: " + ", ".join(
            f"{k}={c[k]:.4g}" for k in costcal.DEVICE_KEYS + ("host_rate_big",)
            if k in c))

    def streamed(self):
        from kmerdb_jax.ops import device_a2a
        with env(KMERDB_A2A_STREAM="1"):
            for out, ref, args in (("str.csv", "host.csv", []),
                                   ("str_sp.csv", "host_sp.csv", SPARSE)):
                device_a2a.last_stats.clear()
                t = self.cli("all2all", *args, self.p("db"), self.p(out))
                st = device_a2a.last_stats
                self.device_ran(st, "streamed")
                assert st["streamed"] and (not args or "sparse_pull" in st)
                self.same(self.p(out), self.p(ref), out)
                say(f"  {out} {t:.1f} s ({_phases(st)})")

    def fused(self):
        from kmerdb_jax.ops import fused
        with env(KMERDB_FUSED_DEVICE="1"):
            fused.last_stats.clear()
            t = self.cli("all2all", "-from-fasta", "-k", "18", self.list,
                         self.p("fused.csv"))
        self.device_ran(fused.last_stats, "fused")
        self.same(self.p("fused.csv"), self.p("host.csv"), "fused")
        say(f"  all2all -from-fasta {t:.1f} s "
            f"({_phases(fused.last_stats)})")

    def new2all(self):
        from kmerdb_jax.ops import intersect
        q = self.write_list("q256.list", self.paths[:256])
        with env(KMERDB_N2A_DEVICE="0"):
            th = self.cli("new2all", self.p("db"), q, self.p("n2a_host.csv"))
        intersect.last_device.clear()
        with env(KMERDB_N2A_DEVICE="1"):
            td = self.cli("new2all", self.p("db"), q, self.p("n2a_dev.csv"))
        self.device_ran(intersect.last_device, "new2all")
        self.same(self.p("n2a_dev.csv"), self.p("n2a_host.csv"), "new2all")
        say(f"  new2all 256 queries: host {th:.1f} s, device {td:.1f} s")

    def parts(self):
        from kmerdb_jax.ops import intersect
        quarter = len(self.paths) // 4
        dbs = []
        for i in range(4):
            lst = self.write_list(f"part{i}.list",
                                  self.paths[i * quarter:(i + 1) * quarter])
            self.cli("build", "-k", "18", lst, self.p(f"part{i}.db"))
            dbs.append(self.p(f"part{i}.db"))
        plist = self.write_list("parts.list", dbs)
        host = dict(KMERDB_GRID_DEVICE="0", KMERDB_A2A_DEVICE="0",
                    KMERDB_D2D_DEVICE="0")
        with env(**host):
            t = self.cli("all2all-parts", *SPARSE[1:], plist,
                         self.p("parts_host.csv"))
        say(f"  parts host tier {t:.1f} s")
        for name, kv in (("grid", dict(KMERDB_GRID_DEVICE="1")),
                         ("grid-stream", dict(KMERDB_GRID_DEVICE="1",
                                              KMERDB_GRID_STREAM="1")),
                         ("db2db", dict(host, KMERDB_D2D_DEVICE="1"))):
            intersect.last_device.clear()
            with env(**kv):
                t = self.cli("all2all-parts", *SPARSE[1:], plist,
                             self.p(f"parts_{name}.csv"))
            if name == "db2db":
                self.device_ran(intersect.last_device, "db2db")
            self.same(self.p(f"parts_{name}.csv"),
                      self.p("parts_host.csv"), name)
            say(f"  parts {name} {t:.1f} s")

    def device_build(self):
        for name, kv in (("build-device", dict(KMERDB_BUILD_DEVICE="1")),
                         ("ingest-device", dict(KMERDB_DEVICE_INGEST="1"))):
            with env(**kv):
                t = self.cli("build", "-k", "18", self.list,
                             self.p(f"{name}.db"))
            self.same(self.p(f"{name}.db"), self.p("db"), name)
            say(f"  {name} {t:.1f} s: DB byte-identical to the host build")

    def kernel(self):
        import numpy as np
        import jax
        import jax.numpy as jnp
        from kmerdb_jax.ops import gram
        from kmerdb_jax.utils import native
        rng = np.random.default_rng(20261016)
        S, rows = self.kernel_S, self.kernel_rows
        B = (rng.random((rows, S)) < 0.1).astype(np.uint8)
        w = rng.integers(0, 2 ** 32, size=rows, dtype=np.uint64
                         ).astype(np.uint32)
        Bp, wd = jax.device_put(gram.pack_rows(B)), jax.device_put(w)
        nl = gram.n_limbs(int(w.max()))

        def step():
            return gram.gram_step(jnp.zeros((S, S), jnp.uint32), Bp, wd,
                                  n_limbs=nl)

        got = np.asarray(step())
        ref = np.asarray(gram.reference_gram(
            jax.device_put(B.astype(np.int8)), wd, n_limbs=4))
        if not np.array_equal(got, ref):
            raise AssertionError("Gram engine != bf16 reference")
        lens = B.sum(axis=1).astype(np.int64)
        offs = np.zeros(rows + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        sids = np.nonzero(B)[1].astype(np.uint32)
        host = native.a2a_dense(offs, sids, w, S)
        if not np.array_equal(got, host):
            raise AssertionError("Gram engine != host a2a_dense")
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            step().block_until_ready()
            ts.append(time.perf_counter() - t0)
        dt = sorted(ts)[2]
        ops = 2.0 * rows * S * S * nl
        say(f"  S={S} rows={rows} limbs={nl}: equal to reference and "
            f"host; step {dt * 1e3:.2f} ms = {ops / dt / 1e12:.1f} TOP/s")

    # -- four cards -------------------------------------------------------

    def four_cards(self):
        q = self.write_list("q256.list", self.paths[:256])
        runs = [("build", ["build", "-k", "18", self.list], "db"),
                ("all2all", ["all2all", "DB"], "a2a.csv"),
                ("all2all-sparse-streamed", ["all2all", *SPARSE, "DB"],
                 "a2a_sp.csv"),
                ("new2all", ["new2all", "DB", q], "n2a.csv")]
        for name, args, out in runs:
            stream = "1" if "streamed" in name else None
            times = []
            for tag, mesh in (("one", []), ("mesh4", ["-mesh", "4"])):
                argv = [self.p("one_db") if a == "DB" else a for a in args]
                with env(KMERDB_A2A_STREAM=stream):
                    times.append(self.cli(*argv, *mesh,
                                          self.p(f"{tag}_{out}")))
            self.same(self.p(f"mesh4_{out}"), self.p(f"one_{out}"), name)
            say(f"  {name}: one card {times[0]:.1f} s, -mesh 4 "
                f"{times[1]:.1f} s, byte-identical")


def _same_bytes(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def _phases(stats) -> str:
    return " ".join(f"{k}={v:.2f}" for k, v in stats.items()
                    if k.endswith("_s"))


def _card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run(smoke: Smoke, four_cards: bool) -> None:
    phases = ([("four-cards", smoke.four_cards)] if four_cards else
              [("1 main", smoke.main_path), ("2 streamed", smoke.streamed),
               ("3 fused", smoke.fused), ("4 new2all", smoke.new2all),
               ("5 parts", smoke.parts), ("6 build", smoke.device_build),
               ("7 kernel", smoke.kernel)])
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        say(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the -mesh 4 path on four cards, nothing else")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
              f"not a GPU", file=sys.stderr)
        return 1
    devices = jax.devices()
    if args.four_cards and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 1
    import kmerdb_jax  # noqa: F401 — fails here outside a checkout
    say(_card_line())
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run(Smoke(work, "gpu", N_SAMPLES, GENOME_LEN), args.four_cards)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
