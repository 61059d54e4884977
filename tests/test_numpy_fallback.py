"""No-compiler operation: every consumer of utils.native has a NumPy
fallback; this runs the CLI pipeline with `native.available` forced
False and byte-compares all outputs against the native-path run.
(The reference has no analogue — it simply requires its C++; we keep a
portable mode so the package works where g++ is absent.)
"""

import pathlib

import numpy as np
import pytest

from kmerdb_jax.cli.main import main
from kmerdb_jax.utils import native

pytestmark = pytest.mark.skipif(not native.available,
                                reason="needs the native path to diff "
                                       "against")


def _corpus(tmp_path):
    rng = np.random.default_rng(17)
    paths = []
    for i in range(6):
        seq = rng.choice(list(b"ACGTN"), size=1500).astype(np.uint8)
        p = tmp_path / f"s{i}.fasta"
        p.write_bytes(b">s%d\n" % i + bytes(seq) + b"\n")
        paths.append(str(p))
    lst = tmp_path / "c.list"
    lst.write_text("".join(p + "\n" for p in paths))
    return str(lst), paths


def _pipeline(tmp_path, tag, lst, q):
    db = str(tmp_path / f"{tag}.db")
    outs = []
    assert main(["build", "-k", "15", "-f", "0.8", lst, db]) == 0
    for name, args in [
        ("a2a", ["all2all", db]),
        ("sp", ["all2all", "-sparse", "-min", "1", db]),
        ("asp", ["all2all-sp", "-sample-rows", "jaccard:3", db]),
        ("o2a", ["one2all", db, q]),
    ]:
        out = str(tmp_path / f"{tag}.{name}")
        assert main(args + [out]) == 0, name
        outs.append(out)
    d = str(tmp_path / f"{tag}.mash")
    assert main(["distance", "mash", outs[0], d]) == 0
    outs.append(d)
    return outs


def test_numpy_fallback_outputs_match(tmp_path, monkeypatch):
    lst, paths = _corpus(tmp_path)
    fast = _pipeline(tmp_path, "fast", lst, paths[0])
    monkeypatch.setattr(native, "available", False)
    slow = _pipeline(tmp_path, "slow", lst, paths[0])
    for a, b in zip(fast, slow):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes(), \
            (a, b)
