"""Formatting parity: Python reference vs C++ row formatters, plus
Double2PChar edge cases pinned against the algorithm's definition."""

import numpy as np
import pytest

from kmerdb_jax.utils import native
from kmerdb_jax.utils.num2str import (double2str, num2str_float,
                                      format_double_cpp, ints_row,
                                      ints_row_sparse)


def test_double2str_cases():
    assert num2str_float(0.0) == "0"
    assert num2str_float(1.0) == "1.000000"
    assert num2str_float(0.038024157) == "0.038024"
    assert num2str_float(-0.5) == "-0.500000"
    assert double2str(123.4567894) == "123.456789"
    assert double2str(0.0000004) == "0.000000"
    # rounding at the .5 boundary goes up (x + 0.5 truncation)
    assert double2str(0.0000005) == "0.000001"
    assert num2str_float(12.0) == "12.000000"


def test_format_double_cpp():
    assert format_double_cpp(1.0) == "1"
    assert format_double_cpp(0.1) == "0.1"
    assert format_double_cpp(0.05) == "0.05"


@pytest.mark.skipif(not native.available, reason="no native lib")
def test_native_rows_match_python():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    vals[::7] = 0
    want_dense = "".join(f"{int(v)}," for v in vals)
    assert native.row_dense(vals).decode() == want_dense
    idx = np.flatnonzero(vals)
    want_sparse = "".join(f"{int(i)+1}:{int(vals[i])}," for i in idx)
    assert native.row_sparse(vals).decode() == want_sparse
    assert ints_row(vals) == want_dense
    assert ints_row_sparse(vals) == want_sparse


@pytest.mark.skipif(not native.available, reason="no native lib")
def test_native_double6_matches_python():
    rng = np.random.default_rng(1)
    vals = np.concatenate([
        rng.random(2000),
        rng.random(100) * 1000,
        -rng.random(100),
        np.array([0.0, 1.0, 0.9999995, 0.99999949, 123456.9999996]),
    ])
    got = native.row_double6(vals).decode().split(",")[:-1]
    want = [num2str_float(float(v)) for v in vals]
    assert got == want
