"""CLI byte-parity for the protein/alphabet suite
(.github/workflows/self-hosted.yml:367-430): k=24 nt ± preserve-strand
and k=8 over the four amino-acid alphabets."""

import os
import pathlib

import pytest

from kmerdb_jax.cli.main import main

REF = pathlib.Path("/root/reference")
GOLD = REF / "test" / "protein"

CASES = [
    ("dna", ["-k", "24"], "dna_100x1000.fasta", "dna.a2a"),
    ("dna-preserve", ["-k", "24", "-preserve-strand"],
     "dna_100x1000.fasta", "dna-preserve.a2a"),
    ("aa", ["-k", "8", "-alphabet", "aa"], "aa_100x1000.fasta", "aa.a2a"),
    ("aa11", ["-k", "8", "-alphabet", "aa11_diamond"],
     "aa_100x1000.fasta", "aa11_diamond.a2a"),
    ("aa12", ["-k", "8", "-alphabet", "aa12_mmseqs"],
     "aa_100x1000.fasta", "aa12_mmseqs.a2a"),
    ("aa6", ["-k", "8", "-alphabet", "aa6_dayhoff"],
     "aa_100x1000.fasta", "aa6_dayhoff.a2a"),
]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("protein")
    cwd = os.getcwd()
    os.chdir(REF)
    yield d
    os.chdir(cwd)


@pytest.mark.parametrize("tag,opts,fasta,golden", CASES,
                         ids=[c[0] for c in CASES])
def test_protein_suite(workdir, tag, opts, fasta, golden):
    db = str(workdir / f"{tag}.db")
    out = str(workdir / f"{tag}.a2a")
    assert main(["build", *opts, "-multisample-fasta",
                 f"./test/protein/{fasta}", db]) == 0
    assert main(["all2all", db, out]) == 0
    got = pathlib.Path(out).read_bytes()
    want = (GOLD / golden).read_bytes()
    assert got == want, f"output differs from golden {golden}"
