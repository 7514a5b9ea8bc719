"""Atomic, async checkpoints (the JAX package's
``checkpoint/checkpointing.py``), in its on-disk format.

Layout:  <dir>/step_<N>/
            manifest.json        — step, each leaf's file, shape and
                                   dtype, and ``extra`` (the data cursor)
            <leaf-path>.npy      — one file per leaf
         <dir>/LATEST            — atomic pointer (written last)

A leaf's key is its path in the tree joined by ``/`` (dict keys, list and
tuple indices), as ``jax.tree_util.tree_flatten_with_path`` names it, so
a checkpoint written by either package is read by the other wherever
JAX can read the dtype. Leaves are torch tensors (on any device) or
numpy arrays. bfloat16, which numpy lacks, is written as two-byte
``'<V2'`` arrays with ``"dtype": "bfloat16"`` in the manifest (what
``np.save`` writes for JAX's bfloat16) and read back by the manifest's
dtype, never by the ``.npy`` descr. (The JAX ``restore`` cannot read
those leaves: ``jnp.asarray`` refuses ``|V2``; ROADMAP.md, Queue 3.)

Guarantees:
* atomicity — a checkpoint is visible only after its manifest and LATEST
  pointer land (rename(2) is atomic); a crash mid-save leaves the previous
  checkpoint intact.
* restart — ``restore_latest`` rebuilds the tree and returns the step and
  data cursor, so training resumes where it stopped (the data pipeline is
  a pure function of (seed, step)).
* async — ``AsyncCheckpointer.save`` takes a finished host copy of every
  leaf before it returns (the port's AdamW updates params and moments in
  place, so the next step must not reach the writer), then writes on a
  background thread.

Resharding onto a mesh (the JAX ``restore``'s ``shardings``) waits for
the port's distribution slice; on one card every leaf goes to
``device``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} in ``tree_flatten_with_path`` order (dict keys
    sorted); None is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    """A tree shaped like ``like`` whose leaves are ``leaves[path]``."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, key(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, key(i))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[prefix]


def _host_copy(leaf):
    """A host copy of one leaf that nothing else writes: a CUDA tensor
    copied into pinned memory without a wait (the caller synchronizes), a
    CPU tensor cloned (``.numpy()`` of it would share its memory), a
    numpy array copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type == "cpu":
            return t.clone()
        return t.to("cpu", non_blocking=True)
    return np.array(leaf, copy=True)


def _as_numpy(leaf) -> tuple:
    """(numpy array, manifest dtype name) of a host leaf; bfloat16 as its
    bits (int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False,
            "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _read_leaf(path: str, info: dict, device) -> torch.Tensor:
    arr = np.load(path)
    if info["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, np.dtype(info["dtype"]),
                                        order="C"))
    return t.to(device)


def save(directory: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3):
    """Synchronous atomic save of a tree of tensors and arrays."""
    tmp = os.path.join(directory, f"_tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _as_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        _write_leaf(os.path.join(tmp, fname), arr, dtype)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # atomic LATEST pointer
    ptr_tmp = os.path.join(directory, "_LATEST_tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.rename(ptr_tmp, os.path.join(directory, "LATEST"))
    _gc(directory, keep)


def _gc(directory: str, keep: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to host immediately; write in a background thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Waits for the previous write, then copies every leaf to the
        host and returns once the copies are finished (CUDA copies run
        without a wait each, then the streams that made them are
        synchronized once); the files are written on a thread."""
        self.wait()
        flat = _flatten(tree)
        host = {k: _host_copy(v) for k, v in flat.items()}
        for dev in {v.device for v in flat.values()
                    if isinstance(v, torch.Tensor) and v.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        self._thread = threading.Thread(
            target=save, args=(self.directory, step, host, extra,
                               self.keep), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def save_async(checkpointer: AsyncCheckpointer, step: int, tree: Any,
               extra: Optional[dict] = None) -> None:
    """Atomic async save through a long-lived ``AsyncCheckpointer``:
    snapshot now, write in the background, the previous checkpoint stays
    intact until the new LATEST pointer lands."""
    checkpointer.save(step, tree, extra)


def _intact_steps(directory: str) -> list[int]:
    """Steps whose dir holds a readable manifest (i.e. fully committed)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if not d.startswith("step_"):
            continue
        try:
            step = int(d.split("_", 1)[1])
        except ValueError:
            continue
        if os.path.exists(os.path.join(directory, d, "manifest.json")):
            steps.append(step)
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Step the LATEST pointer names — or, when the pointer is missing,
    unreadable, or DANGLING (a crash between step-dir GC and the pointer
    rewrite leaves it naming a deleted dir), the newest step with an intact
    manifest. Returns None when no intact checkpoint exists."""
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                step = int(f.read().strip())
        except ValueError:
            step = None
        if step is not None and os.path.exists(
                os.path.join(directory, f"step_{step}", "manifest.json")):
            return step
    steps = _intact_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like: Any,
            device="cuda") -> tuple[Any, dict]:
    """Restore a tree saved by ``save`` (either package's): ``like``
    gives the structure (its leaves are not read); each leaf comes back
    as a tensor on ``device`` in the manifest's dtype and shape (0-d
    leaves such as ``step`` as 0-d tensors). Returns (tree, extra)."""
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for key in _flatten(like):
        info = manifest["leaves"][key]
        out[key] = _read_leaf(os.path.join(d, info["file"]), info, device)
    return _unflatten(like, out), manifest["extra"]


def restore_latest(directory: str, like: Any, device="cuda"):
    step = latest_step(directory)
    if step is None:
        return None, None, None
    tree, extra = restore(directory, step, like, device)
    return tree, step, extra
