"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. All sources build in parallel, one
``nvcc`` each, with ``csrc/`` on the include path for the shared headers
(``*.cuh``). Libraries are named by the hash of their source and of every
header, and land in the compile cache's directory
(``core.compile_cache.cache_dir()``, resolved at build time: by default
``<package>/build/``, git-ignored; ``REPRO_TORCH_COMPILE_CACHE`` or
``compile_cache.configure`` point it elsewhere), so an edited source or
header rebuilds and an unchanged one is reused. Each library found there
counts a cache hit, each one compiled a miss and then a put.

``launch_counts`` holds one plain integer per kernel; each kernel wrapper
adds one exactly where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..core import compile_cache

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("spike_pipeline", "quant_matmul", "spike_sparse", "event_accum",
           "spike_compact", "moe_gather")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts = {"fused_spike_accum": 0, "quant_matmul": 0,
                 "fused_spike_accum_sparse": 0, "event_accum": 0,
                 "spike_compact": 0, "moe_gather": 0}

_libs: dict[str, ctypes.CDLL] = {}
_built: dict[str, dict[str, Path]] = {}   # build dir -> library paths


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def build_dir() -> Path:
    """Where the libraries live: the compile cache's directory."""
    return Path(compile_cache.cache_dir())


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by the hash of the source,
    every shared header ``csrc/*.cuh`` (sorted) and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no up-to-date library in the build
    directory; returns the library paths. Raises with the compiler's output
    if a build fails. A process decides (and counts) once per directory."""
    build = build_dir()
    done = _built.get(str(build))
    if done is not None:
        return done
    build.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            compile_cache.count("hit")
            continue
        compile_cache.count("miss")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        (build / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[name])
            compile_cache.count("put")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    _built[str(build)] = paths
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _libs[name] = lib
    return lib


@functools.cache
def kernel_fn(name: str, symbol: str, argtypes: tuple):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, typed once.

    Pointers and the stream must be ``c_void_p``: ctypes would otherwise
    pass them as 32-bit ints. Every launcher returns a ``cudaError_t``.
    """
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
