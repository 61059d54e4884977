"""Measured-on-this-machine cost-model calibration.

The device/host tier dispatch prices both tiers with machine constants:
push and pull bandwidth, sustained Gram rate, a per-process fixed cost
(compiling the step programs), the host scatter rates and the packed
incidence fill rate.  This module plays the reference's
measure-the-machine role (runtime CPUID dispatch,
src/instr_set_detect.h:26-57): a one-time microprobe suite, cached to
~/.cache/kmerdb_jax/cost.json, so every process on the same machine
picks the right tier with no env vars.

Resolution order for each constant: KMERDB_COST_* env override >
cached calibration > built-in default.  Only the host constants have
defaults; the device ones exist only once this machine's card has been
measured, and the first job big enough to consider the device (host
estimate >= GATE_S, decided before jax is imported) runs the probes.
"""

import json
import os
import pathlib
import time

import numpy as np

#: host-tier defaults (conservative: higher host speed keeps jobs off
#: the device until this machine is calibrated)
DEFAULTS = {
    "host_rate": 2.0e10,
    "host_rate_big": 3.0e9,
    "fill_Bps": 2.0e9,
}

#: device constants, present only after calibration (or via env)
DEVICE_KEYS = ("push_Bps", "pull_Bps", "dev_flops", "fixed_s")

#: a job whose host-tier estimate is below this many seconds stays on
#: the host without touching jax: starting the backend and compiling
#: the step programs cost seconds of their own
GATE_S = 2.0

_ENV = {
    "push_Bps": "KMERDB_COST_PUSH_BPS",
    "pull_Bps": "KMERDB_COST_PULL_BPS",
    "dev_flops": "KMERDB_COST_DEV_FLOPS",
    "host_rate": "KMERDB_COST_HOST_RATE",
    "host_rate_big": "KMERDB_COST_HOST_RATE_BIG",
    "fixed_s": "KMERDB_COST_DEV_FIXED_S",
    "fill_Bps": "KMERDB_COST_FILL_BPS",
}

#: bump when the probe protocol changes (invalidates old caches)
#: v4: device probes time the XLA int8 Gram and sync with
#: block_until_ready
_VERSION = 4


def cache_path() -> pathlib.Path:
    base = os.environ.get("KMERDB_COST_CACHE_DIR") or os.path.join(
        os.environ.get("XDG_CACHE_HOME")
        or os.path.join(os.path.expanduser("~"), ".cache"),
        "kmerdb_jax")
    return pathlib.Path(base) / "cost.json"


def _load_cache() -> dict | None:
    try:
        d = json.loads(cache_path().read_text())
        if d.get("version") == _VERSION:
            return d
    except (OSError, ValueError):
        pass
    return None


#: memo for resolve(): (env values + cache-file stat) -> constants.
#: The dispatch calls resolve() per cost decision — O(P^2) times in a
#: parts grid — and the constants can only change via env (keyed) or a
#: cache rewrite (stat-keyed).
_memo: tuple | None = None


def resolve() -> dict:
    """Effective cost constants: env > cache > defaults.  Never runs
    probes (call calibrate() for that)."""
    global _memo
    env_vals = tuple(os.environ.get(e) for e in _ENV.values())
    env_vals += (os.environ.get("KMERDB_COST_CACHE_DIR"),
                 os.environ.get("XDG_CACHE_HOME"))
    try:
        st = cache_path().stat()
        stamp = (st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = None
    key = (env_vals, stamp)
    if _memo is not None and _memo[0] == key:
        return dict(_memo[1])
    out = dict(DEFAULTS)
    cached = _load_cache()
    if cached:
        for k in _ENV:
            if k in cached:
                out[k] = float(cached[k])
    for k, env in _ENV.items():
        v = os.environ.get(env)
        if v is not None:
            out[k] = float(v)
    _memo = (key, dict(out))
    return out


def has_device(c: dict) -> bool:
    """True when c can price the device tier."""
    return all(k in c for k in DEVICE_KEYS)


def _probe_device() -> dict:
    """Push/pull bandwidth, sustained Gram rate and the fixed per-run
    cost on the attached device."""
    from .._jaxinit import jax_modules
    from . import gram
    jax, jnp = jax_modules()
    res: dict = {"device_kind": jax.devices()[0].device_kind}
    rng = np.random.default_rng(0)

    # fixed cost: compile + first run of one Gram step (the backend is
    # already up — on_gpu() started it)
    rows, S = 64 * 1024, 1024
    Bp = rng.integers(0, 256, size=(rows // 8, S), dtype=np.uint8)
    w = np.ones(rows, dtype=np.uint32)
    t0 = time.perf_counter()
    C = gram.gram_step(jnp.zeros((S, S), jnp.uint32), jax.device_put(Bp),
                       jax.device_put(w), n_limbs=1)
    C.block_until_ready()
    res["fixed_s"] = time.perf_counter() - t0

    # push / pull: 64 MB of random bytes
    buf = rng.integers(0, 256, size=64 << 20, dtype=np.uint8)
    t0 = time.perf_counter()
    x = jax.device_put(buf)
    x.block_until_ready()
    res["push_Bps"] = buf.nbytes / max(time.perf_counter() - t0, 1e-6)
    t0 = time.perf_counter()
    np.asarray(x)
    res["pull_Bps"] = buf.nbytes / max(time.perf_counter() - t0, 1e-6)

    # Gram rate on resident data: median of several synced steps
    Bd, wd = jax.device_put(Bp), jax.device_put(w)

    def step():
        t0 = time.perf_counter()
        gram.gram_step(jnp.zeros((S, S), jnp.uint32), Bd, wd,
                       n_limbs=1).block_until_ready()
        return time.perf_counter() - t0

    step()
    dt = float(np.median([step() for _ in range(9)]))
    res["dev_flops"] = 2.0 * rows * S * S / max(dt, 1e-9)
    return res


def _probe_host() -> dict:
    """Host scatter rates (cache-resident and spilled) and packed
    incidence fill bandwidth."""
    from ..utils import native
    res: dict = {}
    rng = np.random.default_rng(1)

    def scatter_rate(S, n_pat, plen):
        offs = np.arange(0, n_pat * plen + 1, plen, dtype=np.int64)
        # ascending within each pattern: the kernel's documented
        # precondition (real pattern/group id lists are ascending)
        sids = np.sort(rng.integers(0, S, size=(n_pat, plen),
                                    dtype=np.uint32), axis=1).ravel()
        w = np.ones(n_pat, dtype=np.uint32)
        t0 = time.perf_counter()
        native.a2a_dense(offs, sids, w, S)
        dt = time.perf_counter() - t0
        return n_pat * plen * plen / max(dt, 1e-6)

    if native.available:
        # the threaded kernels use their live thread count, so these
        # rates reflect the machine's parallel host tier; the count is
        # recorded so a calibration from a different -t is explainable
        res["host_threads"] = native.get_threads()
        res["host_rate"] = scatter_rate(512, 20_000, 24)
        res["host_rate_big"] = scatter_rate(2048, 8_000, 24)
        # fill: bit-packed incidence of 20k patterns x 2048 samples
        n_pat, S, plen = 20_000, 2048, 24
        offs = np.arange(0, n_pat * plen + 1, plen, dtype=np.int64)
        sids = rng.integers(0, S, size=n_pat * plen, dtype=np.uint32)
        gp = np.arange(n_pat, dtype=np.int64)
        buf = np.zeros((-(-n_pat // 8), S), dtype=np.uint8)
        t0 = time.perf_counter()
        native.fill_incidence_bits(gp, offs, sids, buf)
        dt = time.perf_counter() - t0
        res["fill_Bps"] = buf.nbytes / max(dt, 1e-6)
    return res


def calibrate(force: bool = False) -> dict:
    """Run the probes (device ones when JAX's backend is a GPU) and
    write the cache; returns the resolved constants.  A failing device
    probe raises: a broken card must not pass for a slow one."""
    if not force:
        cached = _load_cache()
        if cached:
            return resolve()
    from .._jaxinit import on_gpu
    data: dict = {"version": _VERSION, "ts": time.time()}
    data.update(_probe_host())
    if on_gpu():
        data.update(_probe_device())
    p = cache_path()
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(data, indent=1))
        os.replace(tmp, p)
    except OSError:
        pass
    return resolve()


def ensure_calibrated() -> dict:
    """resolve(), running calibrate() first when a GPU is attached and
    this machine's device constants are not known yet (the one-time
    measure-the-machine moment; KMERDB_COST_CALIBRATE=0 disables)."""
    c = resolve()
    if has_device(c) or os.environ.get("KMERDB_COST_CALIBRATE", "1") == "0":
        return c
    from .._jaxinit import on_gpu
    if on_gpu():
        return calibrate(force=True)
    return c


def device_constants(host_s: float) -> dict | None:
    """Constants to price the device tier with, or None when the host
    tier wins without asking: a host estimate under GATE_S (decided
    before jax is touched), no GPU backend, or no device constants."""
    if host_s < GATE_S:
        return None
    from .._jaxinit import on_gpu
    if not on_gpu():
        return None
    c = ensure_calibrated()
    return c if has_device(c) else None
