"""Entry point: `python -m kmerdb_jax <mode> [options] <args>`.

Mirrors the reference CLI contract (src/main.cpp:22-62): dispatch on
mode, usage text on errors, exit code -1 on failure.
"""

import sys

from . import consoles
from .params import MODES, UsageError, parse_args

_RUNNERS = {
    "build": consoles.run_build,
    "minhash": consoles.run_minhash,
    "all2all": consoles.run_all2all,
    "all2all-sp": consoles.run_all2all_sp,
    "new2all": consoles.run_new2all,
    "one2all": consoles.run_one2all,
    "distance": consoles.run_distance,
}


_MODE_HELP = {
    "build": """Building a database:
    kmer-db-jax build [-k <kmer-length>] [-f <fraction>] [-f-start <value>]
        [-multisample-fasta] [-extend] [-alphabet <type>] [-preserve-strand]
        [-t <threads>] <samples> <database>
    kmer-db-jax build -from-kmers [-f <fraction>] [-extend] <samples> <database>
    kmer-db-jax build -from-minhash [-extend] <samples> <database>
  samples: FASTA file (fa/fna/fasta[.gz]) or list of FASTA/KMC/minhash paths
  -k  k-mer length (default 18; max depends on alphabet, 31 for nt)
  -f  minhash fraction (default 1)
  -alphabet  nt | aa | aa12_mmseqs | aa11_diamond | aa6_dayhoff""",
    "all2all": """Counting common k-mers for all samples in the database:
    kmer-db-jax all2all [-buffer <mb>] [-t <threads>]
        [-sparse [-min [<criterion>:]<value>]* [-max [<criterion>:]<value>]*]
        <database> <common_table>
    kmer-db-jax all2all -from-fasta [build ingest options]
        <samples> <common_table>     (fused pipeline, no database)""",
    "all2all-sp": """Counting common k-mers (sparse computation):
    kmer-db-jax all2all-sp [-min ...]* [-max ...]*
        [-sample-rows [<criterion>:]<count>] <database> <common_table>
    kmer-db-jax all2all-sp -from-fasta [build ingest options]
        [-min ...]* [-max ...]* [-sample-rows ...]
        <samples> <common_table>     (fused pipeline, no database)""",
    "all2all-parts": """Counting common k-mers over database parts:
    kmer-db-jax all2all-parts [-min ...]* [-max ...]*
        [-sample-rows [<criterion>:]<count>] <db_list> <common_table>""",
    "new2all": """Counting common k-mers: new samples versus database:
    kmer-db-jax new2all [-multisample-fasta | -from-kmers | -from-minhash]
        [-sparse [-min ...]* [-max ...]*] <database> <samples> <common_table>""",
    "one2all": """Counting common k-mers: single sample versus database:
    kmer-db-jax one2all [-from-kmers | -from-minhash]
        <database> <sample> <common_table>""",
    "distance": """Calculating similarities/distances from a common-table:
    kmer-db-jax distance <measure> [-sparse] [-phylip-out]
        [-min [<criterion>:]<value>]* [-max [<criterion>:]<value>]*
        <common_table> <output_table>
  measure: jaccard | min | max | cosine | mash | ani | ani-shorter""",
    "minhash": """Storing minhashed k-mers (.minhash next to each input):
    kmer-db-jax minhash [-f <fraction>] [-k <kmer-length>]
        [-multisample-fasta] [-alphabet <type>] [-preserve-strand] <samples>
  default fraction: 0.01""",
}


def _usage(mode=None):
    if mode in _MODE_HELP:
        print(_MODE_HELP[mode], file=sys.stderr)
        print("\n<criterion>: num-kmers (default) or jaccard/min/max/cosine/"
              "mash/ani/ani-shorter.", file=sys.stderr)
        return
    print("USAGE\n    kmer-db-jax <mode> [options] <positional arguments>\n",
          file=sys.stderr)
    print("Modes: " + ", ".join(MODES), file=sys.stderr)
    print("Run `kmer-db-jax <mode> -help` for mode-specific options "
          "(option surface matches kmer-db 2.x).", file=sys.stderr)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        params = parse_args(argv)
        if params is None:
            return 0
        from ..utils import log
        log.set_level(log.DEBUG if params.debug
                      else log.VERBOSE if params.verbose else log.NORMAL)
        from ..parallel import runtime
        runtime.configure(params.mesh)
        if params.num_threads:
            # -t reaches the native host kernels too (the reference's
            # numThreads feeds every worker pool, params.cpp:103-108);
            # 0/absent = auto (hardware_concurrency)
            from ..utils import native
            native.set_threads(params.num_threads)
        if params.mode == "all2all-parts":
            from .parts import run_all2all_parts
            run_all2all_parts(params)
        else:
            _RUNNERS[params.mode](params)
        return 0
    except UsageError as e:
        _usage(e.mode)
        return -1 & 0xFF
    except Exception as e:  # noqa: BLE001 — CLI boundary (main.cpp:51-59)
        print(str(e), file=sys.stderr)
        return -1 & 0xFF


if __name__ == "__main__":
    sys.exit(main())
