"""Environment rules: the one backend gate, the compile-cache
location, the source-keyed native library, and that a failing device
tier surfaces as a CLI error."""

import numpy as np
import pytest

from kmerdb_jax import _jaxinit


def test_backend_gate(monkeypatch):
    """on_gpu() is JAX's own answer and nothing else."""
    import jax
    assert _jaxinit.on_gpu() is False          # tests pin the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _jaxinit.on_gpu() is True


def _configure(monkeypatch, env_value):
    """Re-run the one-time configuration, recording config updates."""
    import jax
    seen = {}
    monkeypatch.setattr(_jaxinit, "_configured", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
    _jaxinit.jax_modules()
    return seen


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself and the code
    configures no other directory."""
    seen = _configure(monkeypatch, str(tmp_path))
    assert "jax_compilation_cache_dir" not in seen
    assert seen["jax_enable_x64"] is True


def test_compile_cache_env_unset(monkeypatch):
    """Unset: a fixed .jax_cache/ in the checkout."""
    seen = _configure(monkeypatch, None)
    assert seen["jax_compilation_cache_dir"] == str(_jaxinit.CACHE_DIR)
    assert _jaxinit.CACHE_DIR.name == ".jax_cache"
    assert (_jaxinit.CACHE_DIR.parent / "kmerdb_jax").is_dir()


def test_native_lib_keyed_by_source(tmp_path):
    """The shared object lives under the checkout's build/ and its path
    changes with the source bytes, so a library built from other
    source is never loaded."""
    from kmerdb_jax.utils import native
    a = tmp_path / "a.cpp"
    b = tmp_path / "b.cpp"
    a.write_text("int f() { return 1; }\n")
    b.write_text("int f() { return 2; }\n")
    pa, pb = native.lib_path(a), native.lib_path(b)
    assert pa != pb
    assert pa == native.lib_path(a)
    assert pa.parts[-4:-2] == ("build", "native")
    assert native.lib_path().parent.parent.parent == \
        native._ROOT / "build"


def test_failing_device_tier_exits_nonzero(tmp_path, monkeypatch, capsys):
    """A forced device tier that fails makes the CLI exit non-zero with
    the error, and writes no silently recomputed output."""
    from kmerdb_jax.cli.main import main as cli
    from kmerdb_jax.ops import device_a2a
    rng = np.random.default_rng(3)
    paths = []
    for i in range(4):
        seq = "".join(rng.choice(list("ACGT"), size=400))
        f = tmp_path / f"s{i}.fasta"
        f.write_text(f">s{i}\n{seq}\n")
        paths.append(str(f))
    lst = tmp_path / "samples.list"
    lst.write_text("\n".join(paths) + "\n")
    assert cli(["build", "-k", "12", str(lst), str(tmp_path / "db")]) == 0

    def boom(db):
        raise RuntimeError("device tier exploded")

    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    monkeypatch.setattr(device_a2a, "all2all_device", boom)
    rc = cli(["all2all", str(tmp_path / "db"), str(tmp_path / "a.csv")])
    assert rc != 0
    assert "exploded" in capsys.readouterr().err


def test_small_jobs_never_import_jax(tmp_path):
    """Host-sized CLI jobs decide their tier before jax is imported:
    build, all2all, new2all, all2all-parts and the fused -from-fasta
    form on a small corpus leave jax out of sys.modules."""
    import subprocess
    import sys
    rng = np.random.default_rng(9)
    paths = []
    for i in range(6):
        seq = "".join(rng.choice(list("ACGT"), size=600))
        f = tmp_path / f"s{i}.fasta"
        f.write_text(f">s{i}\n{seq}\n")
        paths.append(str(f))
    for name, sel in (("all", paths), ("a", paths[:3]), ("b", paths[3:])):
        (tmp_path / f"{name}.list").write_text("\n".join(sel) + "\n")
    (tmp_path / "parts.list").write_text(
        f"{tmp_path / 'a.db'}\n{tmp_path / 'b.db'}\n")
    script = f"""
import sys
from kmerdb_jax.cli.main import main
d = {str(tmp_path)!r}
for args in (["build", "-t", "1", d + "/all.list", d + "/all.db"],
             ["build", "-t", "1", d + "/a.list", d + "/a.db"],
             ["build", "-t", "1", d + "/b.list", d + "/b.db"],
             ["all2all", d + "/all.db", d + "/x.csv"],
             ["new2all", "-t", "1", d + "/all.db", d + "/a.list",
              d + "/n.csv"],
             ["all2all-parts", d + "/parts.list", d + "/p.csv"],
             ["all2all", "-from-fasta", "-t", "1", d + "/all.list",
              d + "/f.csv"]):
    assert main(args) == 0, args
assert "jax" not in sys.modules, "a small job imported jax"
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300,
                       cwd=str(_jaxinit.CACHE_DIR.parent))
    assert r.returncode == 0, r.stderr[-2000:]
