"""Blocked host all2all scatter (native kmerdb_a2a_dense).

Large-S C spills this rig's ~1 MB effective cache; the tile-blocked
form walks C one cache-resident sub-block at a time (measured 1.5x at
S=4096).  uint32 adds commute, so blocked and direct must be
byte-identical at every tile size, including ragged tiles and the
S % tile != 0 boundary.
"""

import numpy as np
import pytest

from kmerdb_jax.utils import native


@pytest.mark.skipif(not native.available, reason="native runtime only")
@pytest.mark.parametrize("tile", ["97", "512", "1024"])
def test_blocked_matches_direct(monkeypatch, tile):
    rng = np.random.default_rng(17)
    S = 1319                      # crosses the default tile, not round
    n_pat = 900
    lens = rng.integers(1, 120, size=n_pat)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    sids = np.concatenate([
        np.sort(rng.choice(S, size=l, replace=False)).astype(np.uint32)
        for l in lens])
    w = rng.integers(1, 1 << 20, size=n_pat).astype(np.uint32)

    monkeypatch.setenv("KMERDB_A2A_HOST_TILE", "0")
    C_direct = native.a2a_dense(offs, sids, w, S)
    monkeypatch.setenv("KMERDB_A2A_HOST_TILE", tile)
    C_blocked = native.a2a_dense(offs, sids, w, S)
    np.testing.assert_array_equal(C_direct, C_blocked)
