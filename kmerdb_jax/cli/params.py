"""Command-line parameter parsing.

Faithful to the reference's hand-rolled scanner (src/params.h:115-156,
src/params.cpp:60-710): switches/options are searched anywhere in the
argument list and consumed; whatever remains becomes the positional
file arguments.  Same option names, same defaults (params.h:72-88).
"""

import math

from ..utils.filters import AVAILABLE_METRICS, MetricFilter, KmerFilter

MODES = ("build", "minhash", "all2all", "all2all-sp", "all2all-parts",
         "new2all", "one2all", "distance")

GENOME, KMC, MINHASH = "genome", "kmc", "minhash"


class UsageError(Exception):
    def __init__(self, mode=None, message=None):
        super().__init__(message or f"usage error in mode {mode}")
        self.mode = mode


class Params:
    def __init__(self):
        self.fraction = 1.0
        self.fraction_start = 0.0
        self.fraction_specified = False
        self.kmer_length = 18
        self.num_threads = 0
        self.num_reader_threads = 0
        self.cache_buffer_mb = 8
        self.bubble_size = 8000
        self.multisample_fasta = False
        self.sparse_out = False
        self.extend_db = False
        self.phylip_out = False
        self.sampling_size = 0
        self.sampling_criterion = None      # metric fn or None (random)
        self.input_format = GENOME
        self.mode = None
        self.alphabet_name = "nt"
        self.files: list[str] = []
        self.metric_filters: dict[str, MetricFilter] = {}
        self.kmer_filter = KmerFilter()
        self.metric_name = ""
        self.verbose = False
        self.debug = False
        self.mesh = None          # -mesh <n|auto>: device-mesh SPMD
        self.from_fasta = False   # all2all -from-fasta: fused pipeline


def find_switch(args: list[str], name: str) -> bool:
    if name in args:
        args.remove(name)
        return True
    return False


def find_option(args: list[str], name: str, conv=str):
    """Find `name value`, consume both, return converted value or None.
    The option name is never matched at the last position
    (params.h:126-138)."""
    for i in range(len(args) - 1):
        if args[i] == name:
            try:
                v = conv(args[i + 1])
            except ValueError:
                return None
            del args[i:i + 2]
            return v
    return None


def _parse_filters(params: Params, args: list[str], default_metric="num-kmers"):
    """-min/-max [criterion:]value, repeatable (params.cpp:418-455).
    distance mode passes default_metric='?' (resolved later,
    params.cpp:612-651)."""
    for i, opt in enumerate(("-min", "-max")):
        while True:
            value_str = find_option(args, opt)
            if value_str is None:
                break
            sep = value_str.rfind(":")
            if sep >= 0:
                metric = value_str[:sep]
                num = value_str[sep + 1:]
            else:
                metric = default_metric
                num = value_str
            try:
                value = float(num)
            except ValueError:
                raise UsageError(params.mode,
                                 f"Filtering error - unable to parse numerical value: {value_str}")
            if metric == "num-kmers":
                params.kmer_filter.bounds[i] = int(round(value))
            elif metric in AVAILABLE_METRICS:
                f = params.metric_filters.setdefault(metric, MetricFilter())
                f.metric = AVAILABLE_METRICS[metric]
                f.bounds[i] = value
            elif metric == "?":
                params.metric_filters.setdefault("?", MetricFilter()).bounds[i] = value
            else:
                raise UsageError(params.mode,
                                 f"Filtering error - unknown metric: {metric}")


def parse_args(argv: list[str]) -> Params | None:
    """Returns populated Params, or None when help/usage was shown."""
    from ..ops.alphabet import get_alphabet

    p = Params()
    args = list(argv)

    if find_switch(args, "-version"):
        from .. import __version__
        print(__version__)
        return None
    help_wanted = find_switch(args, "-help")
    if not args:
        raise UsageError(None)

    p.mode = args.pop(0)
    if help_wanted or not args or p.mode not in MODES:
        raise UsageError(p.mode if p.mode in MODES else None)

    p.verbose = find_switch(args, "-v")
    p.debug = find_switch(args, "-vv")
    t = find_option(args, "-t", int)
    if t is not None:
        p.num_threads = t
    rt = find_option(args, "-rt", int)
    if rt is not None:
        p.num_reader_threads = rt
    # extension of this system: -mesh <n|auto> routes the mode's compute
    # through a device mesh (the reference's -t reaches its thread
    # pools the same way, params.cpp:103-108)
    p.mesh = find_option(args, "-mesh", str)

    if p.mode == "build":
        _parse_build(p, args, get_alphabet)
    elif p.mode in ("all2all", "all2all-sp", "all2all-parts"):
        _parse_all2all(p, args)
    elif p.mode in ("new2all", "one2all"):
        _parse_new2all(p, args)
    elif p.mode == "distance":
        _parse_distance(p, args)
    elif p.mode == "minhash":
        _parse_minhash(p, args, get_alphabet)

    if p.mode == "minhash" and not p.fraction_specified:
        p.fraction = 0.01

    p.files = args
    return p


def _apply_alphabet_options(p: Params, args, get_alphabet):
    name = find_option(args, "-alphabet")
    if name is not None:
        get_alphabet(name)  # validates
        p.alphabet_name = name
    if find_switch(args, "-preserve-strand"):
        if p.alphabet_name == "nt":
            p.alphabet_name = "nt-preserve"
        else:
            raise UsageError(p.mode, "-preserve-strand applies only to nt alphabet")


def _check_kmer_length(p: Params, get_alphabet):
    alph = get_alphabet(p.alphabet_name)
    if p.kmer_length > alph.max_kmer_len:
        raise UsageError(
            p.mode, "K-mer length for the given alphabet cannot exceed "
            f"{alph.max_kmer_len}")


def _parse_build(p: Params, args, get_alphabet):
    kmc = find_switch(args, "-from-kmers")
    mh = find_switch(args, "-from-minhash")
    if not mh:
        f = find_option(args, "-f", float)
        if f is not None:
            p.fraction = f
            p.fraction_specified = True
        fs = find_option(args, "-f-start", float)
        if fs is not None:
            p.fraction_start = fs
        if not kmc:
            p.multisample_fasta = find_switch(args, "-multisample-fasta")
            p.input_format = GENOME
            _apply_alphabet_options(p, args, get_alphabet)
            k = find_option(args, "-k", int)
            if k is not None:
                p.kmer_length = k
            _check_kmer_length(p, get_alphabet)
        else:
            p.input_format = KMC
            p.kmer_length = 0
    else:
        if kmc:
            raise UsageError(p.mode,
                             "-from-kmers and -from-minhash switches exclude one another.")
        p.input_format = MINHASH
        p.fraction = 1.0
        p.kmer_length = 0
    p.extend_db = find_switch(args, "-extend")


def _parse_all2all(p: Params, args):
    if p.mode in ("all2all", "all2all-sp"):
        # extension of this system: `all2all[-sp] -from-fasta
        # <sample-list> <csv>` runs the fused ingest->Gram pipeline
        # (ops/fused.py) without building a database; ingest options
        # mirror build's.  In the -sp form the fused matrix feeds the
        # same filter/sampler/writer stack as a loaded database.
        p.from_fasta = find_switch(args, "-from-fasta")
        if p.from_fasta:
            from ..ops.alphabet import get_alphabet
            kmc = find_switch(args, "-from-kmers")
            mh = find_switch(args, "-from-minhash")
            if kmc and mh:
                raise UsageError(p.mode, "-from-kmers and -from-minhash "
                                 "switches exclude one another.")
            if mh:
                p.input_format = MINHASH
                p.kmer_length = 0
            else:
                f = find_option(args, "-f", float)
                if f is not None:
                    p.fraction = f
                    p.fraction_specified = True
                fs = find_option(args, "-f-start", float)
                if fs is not None:
                    p.fraction_start = fs
                if kmc:
                    p.input_format = KMC
                    p.kmer_length = 0
                else:
                    p.multisample_fasta = find_switch(
                        args, "-multisample-fasta")
                    p.input_format = GENOME
                    _apply_alphabet_options(p, args, get_alphabet)
                    k = find_option(args, "-k", int)
                    if k is not None:
                        p.kmer_length = k
                    _check_kmer_length(p, get_alphabet)
    buf = find_option(args, "-buffer", int)
    if buf is not None and buf > 0:
        p.cache_buffer_mb = buf
    bubble = find_option(args, "-bubble-size", int)
    if bubble is not None:
        p.bubble_size = bubble
    p.sparse_out = find_switch(args, "-sparse")
    if p.sparse_out or p.mode in ("all2all-parts", "all2all-sp"):
        _parse_filters(p, args)
    if p.mode in ("all2all-parts", "all2all-sp"):
        value_str = find_option(args, "-sample-rows")
        if value_str is not None:
            sep = value_str.rfind(":")
            if sep >= 0:
                measure = value_str[:sep]
                if measure not in AVAILABLE_METRICS:
                    raise UsageError(p.mode,
                                     f"Sampling parameters error - unknown measure: {measure}")
                p.sampling_criterion = AVAILABLE_METRICS[measure]
                value_str = value_str[sep + 1:]
            try:
                p.sampling_size = int(value_str)
            except ValueError:
                raise UsageError(p.mode,
                                 "Sampling parameters error - unable to parse numerical value")


def _parse_new2all(p: Params, args):
    kmc = find_switch(args, "-from-kmers")
    mh = find_switch(args, "-from-minhash")
    if mh and kmc:
        raise UsageError(p.mode,
                         "-from-kmers and -from-minhash switches exclude one another.")
    if mh:
        p.input_format = MINHASH
    elif kmc:
        p.input_format = KMC
    else:
        p.multisample_fasta = find_switch(args, "-multisample-fasta")
        p.input_format = GENOME
    if p.mode == "new2all":
        p.sparse_out = find_switch(args, "-sparse")
        if p.sparse_out:
            _parse_filters(p, args)


def _parse_distance(p: Params, args):
    p.sparse_out = find_switch(args, "-sparse")
    p.phylip_out = find_switch(args, "-phylip-out")
    if p.phylip_out:
        p.sparse_out = False
    _parse_filters(p, args, default_metric="?")
    if not args:
        raise UsageError(p.mode, "No distance/similarity metric specified")
    p.metric_name = args.pop(0)
    if p.metric_name not in AVAILABLE_METRICS:
        raise UsageError(p.mode, f"Unknown metric: {p.metric_name}")
    # resolve '?' placeholder filters to the chosen metric (params.cpp:660-667)
    if "?" in p.metric_filters:
        mf = p.metric_filters.pop("?")
        mf.metric = AVAILABLE_METRICS[p.metric_name]
        p.metric_filters[p.metric_name] = mf


def _parse_minhash(p: Params, args, get_alphabet):
    f = find_option(args, "-f", float)
    if f is not None:
        p.fraction = f
        p.fraction_specified = True
    fs = find_option(args, "-f-start", float)
    if fs is not None:
        p.fraction_start = fs
    if find_switch(args, "-from-kmers"):
        p.input_format = KMC
        p.kmer_length = 0
    else:
        p.multisample_fasta = find_switch(args, "-multisample-fasta")
        k = find_option(args, "-k", int)
        if k is not None:
            p.kmer_length = k
        p.input_format = GENOME
        _apply_alphabet_options(p, args, get_alphabet)
        _check_kmer_length(p, get_alphabet)
