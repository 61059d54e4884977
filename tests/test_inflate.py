"""libdeflate fast-inflate path (io/inflate.py).

Role parity with the reference's isa-l/zlib-ng gz engines
(libs/refresh/compression/lib/file_wrapper.h:333,472): whole-buffer
gzip inflate must be byte-identical to stdlib gzip on single-member,
multi-member (cat'ed/bgzf-style) and empty streams, and read_raw must
survive corrupt tails by falling back to the stdlib envelope.
"""

import gzip
import os

import pytest

from kmerdb_jax.io import fasta, inflate


def _gz(data: bytes, mtime=0) -> bytes:
    return gzip.compress(data, mtime=mtime)


@pytest.mark.skipif(not inflate.available(), reason="libdeflate absent")
class TestLibdeflate:
    def test_single_member(self):
        data = os.urandom(1 << 16) + b">" * 100
        assert inflate.gzip_decompress(_gz(data)) == data

    def test_multi_member(self):
        parts = [b"alpha" * 1000, b"", b"beta" * 3333, os.urandom(4096)]
        blob = b"".join(_gz(p) for p in parts)
        assert inflate.gzip_decompress(blob) == b"".join(parts)

    def test_zero_padding_between_members(self):
        blob = _gz(b"x" * 10) + b"\x00" * 8 + _gz(b"y" * 10)
        assert inflate.gzip_decompress(blob) == b"x" * 10 + b"y" * 10

    def test_empty_payload(self):
        assert inflate.gzip_decompress(_gz(b"")) == b""

    def test_cap_growth_on_multi_member(self):
        # the ISIZE hint reads the LAST member's trailer; a huge highly
        # compressible FIRST member (so 4*len(input) is also far too
        # small) forces the INSUFFICIENT_SPACE growth loop
        big, tiny = b"A" * (8 << 20), b"z"
        blob = _gz(big) + _gz(tiny)
        assert inflate.gzip_decompress(blob) == big + tiny

    def test_corrupt_stream_raises(self):
        blob = bytearray(_gz(b"payload" * 100))
        blob[len(blob) // 2] ^= 0xFF
        with pytest.raises(ValueError):
            inflate.gzip_decompress(bytes(blob))


def test_read_raw_gz_roundtrip(tmp_path):
    data = b">s1\nACGT\n>s2\nGGGG\n"
    p = tmp_path / "x.fa.gz"
    p.write_bytes(_gz(data))
    assert fasta.read_raw(str(p)) == data


def test_read_raw_env_disable(tmp_path, monkeypatch):
    # env kill-switch must force the stdlib path and agree byte-for-byte
    data = os.urandom(4096)
    p = tmp_path / "x.gz"
    p.write_bytes(_gz(data))
    import importlib
    monkeypatch.setenv("KMERDB_NO_LIBDEFLATE", "1")
    importlib.reload(inflate)
    try:
        assert not inflate.available()
        assert fasta.read_raw(str(p)) == data
    finally:
        monkeypatch.delenv("KMERDB_NO_LIBDEFLATE")
        importlib.reload(inflate)
