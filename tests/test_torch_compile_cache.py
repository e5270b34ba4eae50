"""The port's kernel compile cache (``repro_torch.core.compile_cache``) and
the bookkeeping of ``kernels/_cuda.build_all`` under it.

There is no ``nvcc`` on the CPU test machines, so a fake compiler script on
``PATH`` stands in for it: it writes the library file ``-o`` names and
prints a line of ``ptxas`` output. What is held is the directory choice
(``configure``, ``REPRO_TORCH_COMPILE_CACHE``, the default), the
hit/miss/put counts of one process and of a second one on the same
directory, a failed build, the exit-time stats line and its summary.
"""
import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import obs
from repro_torch.core import compile_cache
from repro_torch.kernels import _cuda

ROOT = Path(__file__).resolve().parents[1]
FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
if "{fail}" and src.endswith("{fail}.cu"):
    print("error: fake compiler refuses " + src)
    sys.exit(1)
with open(out, "wb") as f:
    f.write(b"fake library of " + src.encode())
print("ptxas info    : Used 32 registers")
"""


def _fake_nvcc(bin_dir: Path, fail: str = "") -> Path:
    bin_dir.mkdir(exist_ok=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, fail=fail))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return nvcc


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """A process state with no directory configured, zero counters, no
    library built yet, the fake compiler first on PATH and tracing on."""
    monkeypatch.delenv(compile_cache.ENV_DIR, raising=False)
    monkeypatch.delenv(compile_cache.ENV_STATS, raising=False)
    monkeypatch.setattr(compile_cache, "_state",
                        {"dir": None, "atexit": False})
    monkeypatch.setattr(compile_cache, "counters",
                        {"hits": 0, "misses": 0, "puts": 0,
                         "instrumented": True})
    monkeypatch.setattr(_cuda, "_built", {})
    _fake_nvcc(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}"
                               f"{os.environ['PATH']}")
    obs.disable()
    obs.reset()
    obs.enable()
    yield tmp_path
    obs.disable()
    obs.reset()


def _counts():
    return {k: compile_cache.counters[k] for k in ("hits", "misses", "puts")}


def test_default_directory_is_the_package_build_dir(fresh):
    assert compile_cache.configure() is None
    assert compile_cache.cache_dir() == str(
        ROOT / "src" / "repro_torch" / "build")
    assert _cuda.build_dir() == ROOT / "src" / "repro_torch" / "build"
    assert compile_cache.counters["instrumented"] is True


def test_configure_and_env_choose_the_directory(fresh, monkeypatch):
    env_dir = fresh / "from_env"
    monkeypatch.setenv(compile_cache.ENV_DIR, str(env_dir))
    assert compile_cache.cache_dir() == str(env_dir)   # resolved lazily
    assert env_dir.is_dir()
    chosen = compile_cache.configure(str(fresh / "chosen"))
    assert chosen == str(fresh / "chosen") == compile_cache.cache_dir()
    assert _cuda.build_dir() == fresh / "chosen"
    assert _cuda._lib_path("quant_matmul").parent == fresh / "chosen"


def test_build_all_counts_misses_puts_then_hits(fresh):
    kdir = fresh / "kernels"
    compile_cache.configure(str(kdir))
    paths = _cuda.build_all()
    n = len(_cuda.SOURCES)
    assert _counts() == {"hits": 0, "misses": n, "puts": n}
    assert set(paths) == set(_cuda.SOURCES)
    for name, path in paths.items():
        assert path.parent == kdir and path.exists()
        assert path.read_bytes().endswith(f"{name}.cu".encode())
        assert "Used 32 registers" in (kdir / f"{name}.log").read_text()
    assert not list(kdir.glob("*.tmp"))
    # the same process decides once per directory
    assert _cuda.build_all() == paths
    assert _counts() == {"hits": 0, "misses": n, "puts": n}
    # a fresh process (no memory of the build) finds every library
    _cuda._built.clear()
    assert _cuda.build_all() == paths
    assert _counts() == {"hits": n, "misses": n, "puts": n}
    counters = obs.metrics_snapshot()["counters"]
    assert counters == {"compile_cache.miss": n, "compile_cache.put": n,
                        "compile_cache.hit": n}
    st = compile_cache.stats()
    assert st["dir"] == str(kdir) and st["entries"] == n
    assert st["bytes"] == sum(p.stat().st_size for p in paths.values())
    assert (st["hits"], st["misses"], st["puts"]) == (n, n, n)


def test_changed_source_misses_and_rebuilds_only_itself(fresh, monkeypatch):
    compile_cache.configure(str(fresh / "kernels"))
    _cuda.build_all()
    csrc = fresh / "csrc"
    csrc.mkdir()
    for f in _cuda.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    (csrc / "moe_gather.cu").write_text(
        (csrc / "moe_gather.cu").read_text() + "\n// edited\n")
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    _cuda._built.clear()
    _cuda.build_all()
    n = len(_cuda.SOURCES)
    assert _counts() == {"hits": n - 1, "misses": n + 1, "puts": n + 1}


def test_failed_build_raises_with_the_compiler_output(fresh):
    _fake_nvcc(fresh / "bin", fail="quant_matmul")
    compile_cache.configure(str(fresh / "kernels"))
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        _cuda.build_all()
    n = len(_cuda.SOURCES)
    assert _counts() == {"hits": 0, "misses": n, "puts": n - 1}
    assert not _cuda._built        # nothing remembered: the next call retries


def _build_in_subprocess(tmp_path, kdir, stats):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}",
               **{compile_cache.ENV_DIR: str(kdir),
                  compile_cache.ENV_STATS: str(stats)})
    code = ("import json; from repro_torch.kernels import _cuda; "
            "from repro_torch.core import compile_cache as c; "
            "_cuda.build_all(); print(json.dumps(c.counters))")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_second_process_on_the_directory_only_hits(fresh):
    kdir, stats = fresh / "kernels", fresh / "stats.jsonl"
    n = len(_cuda.SOURCES)
    first = _build_in_subprocess(fresh, kdir, stats)
    second = _build_in_subprocess(fresh, kdir, stats)
    assert (first["hits"], first["misses"], first["puts"]) == (0, n, n)
    assert (second["hits"], second["misses"], second["puts"]) == (n, 0, 0)
    lines = [json.loads(x) for x in stats.read_text().splitlines()]
    assert [(x["misses"], x["hits"]) for x in lines] == [(n, 0), (0, n)]
    assert all(x["dir"] == str(kdir) and x["entries"] == n for x in lines)
    table = compile_cache.summarize([str(stats)])
    assert f"| 2 | {n} | {n} | {n} | 50% | {n} |" in table


def test_summarize_cli(fresh, capsys):
    stats = fresh / "stats.jsonl"
    stats.write_text(json.dumps({"hits": 6, "misses": 0, "puts": 0,
                                 "entries": 6, "bytes": 3e6,
                                 "dir": "k"}) + "\n")
    md = fresh / "summary.md"
    assert compile_cache.main(["summarize", str(stats), str(fresh / "no"),
                               "--summary", str(md)]) == 0
    out = capsys.readouterr().out
    assert "| 1 | 6 | 0 | 0 | 100% | 6 | 3.0 MB |" in out
    assert md.read_text() == compile_cache.summarize([str(stats)])
    assert "no stats recorded" in compile_cache.summarize([str(fresh / "no")])
