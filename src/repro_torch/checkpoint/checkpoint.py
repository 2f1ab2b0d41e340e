"""Checkpointing: async, atomic, with retention.

Port of ``repro.checkpoint.checkpoint`` with the same on-disk layout, so
a checkpoint written by either package is read by the other:

* **Layout** — one directory per step, ``<dir>/step_<n:08d>/``, holding a
  ``manifest.json`` (tree structure, and each leaf's file, shape and
  dtype) and one ``.npy`` per leaf, named by its tree path with ``/`` as
  ``__``.  A bf16 leaf is stored as the reference's ``.npy`` holds it:
  its raw 2-byte words (numpy dtype ``V2``) with ``"bfloat16"`` in the
  manifest, and comes back as a bf16 tensor.
* **Atomicity** — writes go to ``step_<n>.tmp`` then ``os.rename``
  (POSIX atomic), so a preempted save never corrupts the latest
  checkpoint; a partial tmp dir is replaced by the next save.
* **Async** — ``save_async`` copies every leaf to host memory before it
  returns (the optimizer updates the params in place, and would rewrite
  tensors the writer is still saving) and runs the file I/O on a
  non-daemon thread; ``wait()`` joins it.
* **Retention** — ``keep_last`` prunes old steps after a successful save.

``restore`` places the leaves on one device.  The reference's
``shardings`` (elastic restore onto a mesh) waits for the multi-device
slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import path_map

#: numpy has no bf16: such a leaf travels as its raw 2-byte words
_BF16_WORDS = np.dtype("V2")


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array that shares no memory with the leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORDS)
        return t.numpy()
    return np.array(leaf, copy=True)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_WORDS else str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _leaf_paths(tree) -> dict:
    """{path_string: leaf} for every array leaf."""
    out = {}
    path_map(lambda p, leaf: out.__setitem__(p, leaf) or leaf, tree)
    return out


def _unflatten(manifest: dict, payload: dict):
    """Rebuild the tree from manifest structure + loaded arrays."""

    def build(node):
        if isinstance(node, dict) and node.get("__leaf__"):
            return payload[node["path"]]
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return node

    return build(manifest["tree"])


def _tree_manifest(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_manifest(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_manifest(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return {"__leaf__": True, "path": prefix[:-1]}


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # --- save ---------------------------------------------------------------

    def _write(self, step: int, host_tree: Any):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "tree": _tree_manifest(host_tree),
                    "leaves": {}}
        for path, arr in _leaf_paths(host_tree).items():
            fname = path.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][path] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": _dtype_name(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any):
        self._write(step, path_map(lambda _p, leaf: _to_host(leaf), tree))

    def save_async(self, step: int, tree: Any):
        self.wait()
        host = path_map(lambda _p, leaf: _to_host(leaf), tree)
        # NON-daemon: on a crash (injected failure, unhandled exception) the
        # interpreter joins this thread at exit, so an in-flight save always
        # finalizes its atomic rename instead of dying as a stale .tmp —
        # that durability is what crash-restart recovery restores from.
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=False)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --- restore ------------------------------------------------------------

    def all_steps(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, device="cuda"):
        """Load a checkpoint (the latest by default) as a tree of tensors
        on ``device``; returns ``(tree, step)``."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        payload = {}
        for path, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(d, meta["file"]))
            payload[path] = _to_tensor(arr, meta["dtype"], dev)
        return _unflatten(manifest, payload), step
