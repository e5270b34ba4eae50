"""Fault-tolerant checkpointing: atomic, sharded, async (port of
``repro.checkpoint.checkpoint``).

Layout of a checkpoint directory, the reference's byte for byte in its
structure, so each package restores what the other saved:

    <root>/step_000000123/
        manifest.json      # leaf paths, shapes, dtypes, shard files, hashes
        shard_00000.npz    # one file per host; keys are '|'-joined paths
    <root>/step_000000123.COMMITTED   # atomic commit marker

- **atomicity**: data is written to ``step_X.tmp-<nonce>`` and renamed; a
  checkpoint without its COMMITTED marker is ignored by ``latest_step``.
- **integrity**: every leaf carries a sha256[:16] of its bytes in the
  manifest; ``restore`` verifies before use and falls back to the previous
  checkpoint.
- **async**: :class:`AsyncCheckpointer` snapshots tensors to the host, then
  writes on a background thread.

Trees are nests of dicts (sorted keys), NamedTuples (field names) and
lists/tuples (indices), with tensors or arrays at the leaves; a tensor is
saved as its host numpy copy. ``restore`` puts each leaf on its template
leaf's device and dtype when the template leaf is a tensor, and returns the
numpy array otherwise. :func:`reshard_on_load` places a restored tree's
leaves onto the devices or shardings given for them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """Flatten a tree of leaves to {path: leaf} with stable paths."""
    flat = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            flat.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}/{i}"))
    else:
        flat[prefix] = tree
    return flat


def _restore_leaf(template, arr: np.ndarray):
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(device=template.device,
                                        dtype=template.dtype)
    return arr


def _unflatten_like(template, flat, prefix="", leaf=_restore_leaf):
    """``template``'s structure, each leaf ``leaf(template_leaf,
    flat[path])`` at ``_flatten``'s path."""
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], flat, f"{prefix}/{k}", leaf)
                for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_like(v, flat, f"{prefix}/{k}", leaf)
            for k, v in zip(template._fields, template)])
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, f"{prefix}/{i}", leaf)
            for i, v in enumerate(template))
    return leaf(template, flat[prefix])


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # audit: allow[host-sync] a checkpoint writes host bytes
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _tree_map(fn, tree):
    """``fn`` over a tree's leaves, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _hash(arr: np.ndarray) -> str:
    """sha256[:16] of the array's bytes (the reference's digest), read in
    place rather than through a ``tobytes`` copy."""
    data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(data).hexdigest()[:16]


def _hashes(arrays) -> list[str]:
    """``_hash`` of each array, on worker threads (sha256 releases the GIL,
    so a checkpoint of many large leaves hashes on several cores)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(_hash, arrays))


def _committed_steps(root: str) -> list[int]:
    return sorted({
        int(n[len("step_"):-len(".COMMITTED")])
        for n in os.listdir(root)
        if n.startswith("step_") and n.endswith(".COMMITTED")})


def save(root: str, step: int, tree, *, process_index: int = 0,
         num_processes: int = 1) -> str:
    """Synchronous sharded save. Returns the committed directory path."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:09d}.tmp-", dir=root)

    flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
    paths = sorted(flat)
    mine = [p for i, p in enumerate(paths) if i % num_processes == process_index]

    digests = dict(zip(paths, _hashes([flat[p] for p in paths])))
    shard_file = f"shard_{process_index:05d}.npz"
    np.savez(os.path.join(tmp, shard_file),
             **{p.replace("/", "|"): flat[p] for p in mine})

    manifest = {
        "step": step,
        "num_processes": num_processes,
        "leaves": {
            p: {
                "shape": list(flat[p].shape),
                "dtype": str(flat[p].dtype),
                "shard": f"shard_{paths.index(p) % num_processes:05d}.npz",
                "hash": digests[p],
            }
            for p in paths
        },
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # commit marker: rename is atomic on POSIX
    open(final + ".COMMITTED", "w").close()
    return final


def latest_step(root: str) -> int | None:
    """Newest *committed and intact* checkpoint step (or None)."""
    if not os.path.isdir(root):
        return None
    for s in reversed(_committed_steps(root)):
        if _verify(os.path.join(root, f"step_{s:09d}")):
            return s
    return None


def _verify(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        for shard in {m["shard"] for m in manifest["leaves"].values()}:
            if not os.path.exists(os.path.join(path, shard)):
                return False
        return True
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def restore(root: str, template, *, step: int | None = None,
            verify_hashes: bool = True):
    """Restore into the structure of ``template``. Returns (tree, step).

    Tries checkpoints newest-first; a corrupt one (missing shard, bad hash)
    is skipped, so a node failing mid-save never bricks the job.
    """
    if step is not None:
        candidates = [step]
    else:
        if not os.path.isdir(root):
            raise FileNotFoundError(root)
        candidates = list(reversed(_committed_steps(root)))

    last_err = None
    for s in candidates:
        path = os.path.join(root, f"step_{s:09d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            shards = {}
            for shard in {m["shard"] for m in manifest["leaves"].values()}:
                shards[shard] = np.load(os.path.join(path, shard))
            flat = {p: shards[meta["shard"]][p.replace("/", "|")]
                    for p, meta in manifest["leaves"].items()}
            if verify_hashes:
                for p, h in zip(flat, _hashes(flat.values())):
                    if h != manifest["leaves"][p]["hash"]:
                        raise IOError(f"hash mismatch for {p}")
            return _unflatten_like(template, flat), s
        except Exception as e:  # noqa: BLE001 — any corruption => try older
            last_err = e
            continue
    raise IOError(f"no restorable checkpoint under {root}: {last_err}")


def reshard_on_load(tree, placements):
    """Place restored leaves (arrays or tensors) onto (possibly other)
    devices, dtypes kept.

    ``placements`` has ``tree``'s structure; each of its leaves is a device
    (a ``torch.device`` or its name), a mesh (``parallel.DataMesh``), whose
    first device takes the leaf (the sharded runners replicate params from
    there to each shard's device), or a ``sharding.NamedSharding``, which
    lays the leaf out on its mesh (``NamedSharding.place``: the reference's
    ``jax.device_put(x, sharding)``).
    """
    from ..sharding.resolver import NamedSharding

    where = _flatten(placements)
    paths = set(_flatten(tree))
    if paths != set(where):
        raise ValueError(
            f"placements do not match the tree: leaves without a placement "
            f"{sorted(paths - set(where))}, placements without a leaf "
            f"{sorted(set(where) - paths)}")

    def place(leaf, p):
        if isinstance(p, NamedSharding):
            return p.place(torch.as_tensor(leaf))
        device = p.devices[0] if hasattr(p, "devices") else torch.device(p)
        return torch.as_tensor(leaf, device=device)

    return _unflatten_like(tree, where, leaf=place)


class AsyncCheckpointer:
    """Snapshot-then-write-in-background; at most one write in flight."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None

    def save(self, step: int, tree):
        self.wait()
        host_tree = _tree_map(_to_host, tree)   # device -> host snapshot

        def _write():
            save(self.root, step, host_tree)
            self.last_saved = step
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in _committed_steps(self.root)[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.root, f"step_{s:09d}.COMMITTED"))
            except OSError:
                pass
        # sweep orphaned tmp dirs (killed writers)
        for n in os.listdir(self.root):
            if ".tmp-" in n:
                shutil.rmtree(os.path.join(self.root, n), ignore_errors=True)
