"""Content-addressed artifact cache for the staged Study pipeline (port of
``repro.study.cache``; the same keys for the same content, the same
``REPRO_STUDY_CACHE`` directory, and the same numpy payloads on disk, so
the two packages' ``train_*.pkl`` files are interchangeable).

Every stage keys its artifact by a sha256 over the *content* that determines
it — actual parameter arrays (a tensor on any device hashes as its numpy
bytes), actual calibration/eval pixels, and the exact option values — never
by names alone, so the shim and the declarative paths share work: the same
params + images hash to the same key no matter who passes them.

Two tiers:

- **memory** — every artifact, per :class:`StudyCache` instance. This is
  what makes a pricing sweep run SNN inference once.
- **disk** — pickled numpy payloads under ``dir/`` for the expensive stages
  (train, convert by default). Filenames embed the key, so a config change
  can never alias an old file; unrecognized/legacy files are simply ignored.

Tracing (``repro_torch.obs``): ``study.cache.{kind}.{mem_hit,disk_hit,miss}``
per lookup and a ``study.{kind}`` span around each build, as the reference.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Callable

import numpy as np
import torch

from .. import obs


def _feed(h, obj) -> None:
    """Stable recursive content walk (arrays by dtype/shape/bytes)."""
    if obj is None or isinstance(obj, (bool, int, str)):
        h.update(repr(obj).encode())
    elif isinstance(obj, float):
        h.update(repr(float(obj)).encode())
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj):
            _feed(h, k)
            _feed(h, obj[k])
        h.update(b"}")
    elif isinstance(obj, (list, tuple)):
        h.update(b"[")
        for x in obj:
            _feed(h, x)
        h.update(b"]")
    else:  # tensor (any device) / ndarray / numpy scalar
        if isinstance(obj, torch.Tensor):
            # audit: allow[host-sync] a content key hashes the bytes: once
            # per stage key
            obj = obj.detach().cpu().numpy()
        a = np.asarray(obj)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(b";")


def content_key(*parts) -> str:
    """sha256 hex digest (16 chars) of the parts' content."""
    h = hashlib.sha256()
    for p in parts:
        _feed(h, p)
    return h.hexdigest()[:16]


class StudyCache:
    """Memory (+ optional disk) cache, one entry per (stage kind, key).

    ``dir=None`` keeps everything in memory. With a directory, stages listed
    in ``disk_kinds`` round-trip through ``{kind}_{tag}_{key}.pkl`` files:
    the build function's payload is converted to numpy by the stage's
    ``save``/``load`` hooks so pickles stay framework-free. Disk writes go
    through a unique temp file + atomic rename (concurrent processes can
    share a dir), and an unreadable/corrupt pickle is discarded and rebuilt
    rather than crashing every later run.

    Bulky kinds (``collect`` holds eval images + per-sample records) are
    LRU-bounded per kind via ``mem_caps`` so a long-lived process sweeping
    many study points cannot grow without bound; unlisted kinds
    (train/convert artifacts — small) are kept indefinitely.
    """

    def __init__(self, dir: str | None = None,
                 disk_kinds: tuple = ("train", "convert", "train_snn"),
                 mem_caps: dict | None = None):
        self.dir = dir
        self.disk_kinds = disk_kinds
        self.mem_caps = {"collect": 16} if mem_caps is None else dict(mem_caps)
        self._mem: dict = {}   # (kind, key) -> artifact, insertion-ordered

    def _path(self, kind: str, tag: str, key: str) -> str:
        safe_tag = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in tag) or "x"
        return os.path.join(self.dir, f"{kind}_{safe_tag}_{key}.pkl")

    def _remember(self, kind: str, key: str, art) -> None:
        self._mem[(kind, key)] = art
        cap = self.mem_caps.get(kind)
        if cap is not None:
            kind_keys = [k for k in self._mem if k[0] == kind]
            for stale in kind_keys[: max(0, len(kind_keys) - cap)]:
                del self._mem[stale]

    def get_or_build(
        self,
        kind: str,
        key: str,
        build: Callable[[], object],
        *,
        tag: str = "",
        save: Callable[[object], object] | None = None,
        load: Callable[[object], object] | None = None,
    ):
        mem_key = (kind, key)
        if mem_key in self._mem:
            art = self._mem.pop(mem_key)   # re-insert: LRU recency
            self._mem[mem_key] = art
            obs.counter(f"study.cache.{kind}.mem_hit")
            return art

        use_disk = self.dir is not None and kind in self.disk_kinds
        if use_disk:
            path = self._path(kind, tag, key)
            if os.path.exists(path):
                try:
                    with open(path, "rb") as f:
                        payload = pickle.load(f)
                    art = load(payload) if load else payload
                except Exception:
                    pass  # truncated/corrupt/stale-format file: rebuild
                else:
                    self._remember(kind, key, art)
                    obs.counter(f"study.cache.{kind}.disk_hit")
                    return art

        obs.counter(f"study.cache.{kind}.miss")
        with obs.span(f"study.{kind}", key=key, tag=tag):
            art = build()
        self._remember(kind, key, art)
        if use_disk:
            os.makedirs(self.dir, exist_ok=True)
            payload = save(art) if save else art
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(payload, f)
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        return art

    def clear(self):
        self._mem.clear()


# the process-wide default used when stages are called without a cache;
# REPRO_STUDY_CACHE points it at a directory for cross-process persistence
DEFAULT_CACHE = StudyCache(dir=os.environ.get("REPRO_STUDY_CACHE") or None)
