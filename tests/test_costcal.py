"""Cost-model calibration: resolution order, cache round-trip, host
probes (the device probes need a GPU; chip_smoke.py's default-routing
phase runs them on the card)."""

import json
import os

import numpy as np
import pytest

from kmerdb_jax.ops import costcal


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("KMERDB_COST_CACHE_DIR", str(tmp_path))
    return tmp_path


def test_resolve_defaults(cache_dir):
    c = costcal.resolve()
    assert c == costcal.DEFAULTS


def test_env_overrides_cache(cache_dir, monkeypatch):
    (cache_dir / "cost.json").write_text(json.dumps(
        {"version": costcal._VERSION, "push_Bps": 5e9, "fixed_s": 1.0}))
    monkeypatch.setenv("KMERDB_COST_PUSH_BPS", "7e9")
    c = costcal.resolve()
    assert c["push_Bps"] == 7e9          # env beats cache
    assert c["fixed_s"] == 1.0           # cache beats default
    assert "pull_Bps" not in c           # device constants: no default
    assert not costcal.has_device(c)


def test_stale_cache_version_ignored(cache_dir):
    (cache_dir / "cost.json").write_text(json.dumps(
        {"version": costcal._VERSION - 1, "push_Bps": 5e9}))
    assert "push_Bps" not in costcal.resolve()


def test_host_probe_calibrates_and_caches(cache_dir):
    from kmerdb_jax.utils import native
    if not native.available:
        pytest.skip("native module unavailable")
    c = costcal.calibrate()
    data = json.loads((cache_dir / "cost.json").read_text())
    assert data["version"] == costcal._VERSION
    # host rates measured, positive, and fed into resolution
    assert data["host_rate"] > 0
    assert data["fill_Bps"] > 0
    assert c["host_rate"] == data["host_rate"]
    # no GPU in the test env: no device constants are measured
    assert not costcal.has_device(c)
    # second calibrate() is a cache hit (no re-probe): timestamps equal
    costcal.calibrate()
    assert json.loads(
        (cache_dir / "cost.json").read_text())["ts"] == data["ts"]


def test_ensure_calibrated_no_gpu_no_probe(cache_dir):
    costcal.ensure_calibrated()
    # no GPU: no cache written, defaults returned
    assert not (cache_dir / "cost.json").exists()


def test_calibrate_disabled(cache_dir, monkeypatch):
    monkeypatch.setenv("KMERDB_COST_CALIBRATE", "0")
    c = costcal.ensure_calibrated()
    assert c == costcal.DEFAULTS
    assert not (cache_dir / "cost.json").exists()


def test_resolve_memo_invalidation(monkeypatch, tmp_path):
    """resolve() is memoized (called per dispatch decision) but must
    recompute when the cache file or a KMERDB_COST_* env changes."""
    import json
    from kmerdb_jax.ops import costcal

    monkeypatch.setenv("KMERDB_COST_CACHE_DIR", str(tmp_path))
    r1 = costcal.resolve()
    assert costcal.resolve() == r1

    (tmp_path / "cost.json").write_text(json.dumps(
        {"version": costcal._VERSION, "push_Bps": 123.0}))
    assert costcal.resolve()["push_Bps"] == 123.0

    monkeypatch.setenv("KMERDB_COST_PUSH_BPS", "456")
    assert costcal.resolve()["push_Bps"] == 456.0


def test_device_constants_gate(cache_dir, monkeypatch):
    """Small jobs never touch jax; without a GPU nothing prices the
    device, even with every device constant supplied."""
    from kmerdb_jax import _jaxinit
    calls = []
    monkeypatch.setattr(_jaxinit, "on_gpu",
                        lambda: calls.append(1) or False)
    assert costcal.device_constants(costcal.GATE_S / 2) is None
    assert not calls, "the host gate must decide before jax"
    for k in costcal.DEVICE_KEYS:
        monkeypatch.setenv(costcal._ENV[k], "1")
    assert costcal.device_constants(costcal.GATE_S * 10) is None
    assert calls
    monkeypatch.setattr(_jaxinit, "on_gpu", lambda: True)
    assert costcal.has_device(costcal.device_constants(costcal.GATE_S * 10))
