"""Checkpointing: asynchronous, integrity-checked (port of
``repro.runtime.checkpoint``, same on-disk format).

Layout on disk (one directory per step)::

    <dir>/step_000000100/
        manifest.json     # step, leaf shapes/dtypes, sha256-16 digests
        arr_0000.npy ...  # one file per leaf
        _COMMITTED        # written last — partial checkpoints never load

A step is written to ``step_….tmp`` and renamed when complete.  Saves run
on a background thread: the state is first copied to host numpy, so
training goes on while it is written.  ``keep`` bounds the committed steps
kept.  Leaves are flattened in JAX's order — dict keys sorted, lists,
tuples and NamedTuple fields in order, ``None`` an empty subtree — so a
float32 checkpoint of ``(params, opt_state)`` written by the JAX package
restores here leaf for leaf.  ``restore`` puts each leaf on the
template's device in the template's dtype.

bfloat16 has no numpy dtype without ``ml_dtypes``: a bfloat16 leaf is
stored as its 16-bit patterns (``uint16``), with ``bfloat16`` named in the
manifest, and read back as bfloat16.  The bytes, and so the digests, are
those the JAX package writes for the same values.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def tree_flatten(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts, lists, tuples and NamedTuples, in
    JAX's flatten order (``None`` holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_flatten(t)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in flatten
    order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            made = {k: build(t[k]) for k in sorted(t)}
            return {k: made[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _to_host(x: Any) -> Tuple[np.ndarray, str]:
    """(array to write, dtype name for the manifest)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
        arr = x.numpy().copy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C").copy())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, tree: Any, step: int, blocking: bool = False):
        self.wait()
        host = [_to_host(x) for x in tree_flatten(tree)]

        def work():
            try:
                self._write(host, step)
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, leaves, step: int):
        path = os.path.join(self.dir, f"step_{step:09d}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "n_leaves": len(leaves), "leaves": []}
        for i, (arr, dtype) in enumerate(leaves):
            fname = f"arr_{i:04d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"file": fname, "shape": list(arr.shape),
                                       "dtype": dtype, "sha256": _digest(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)
        self._gc()

    def _gc(self):
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    def wait(self):
        """Wait for the save in flight; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(self.dir, name, "_COMMITTED"))):
                out.append(int(name.split("_")[1]))
        return out

    def restore(self, template: Any, step: int) -> Any:
        """The tree saved at ``step``, shaped like ``template``, each leaf
        on the template leaf's device in its dtype.  Raises ``IOError`` on
        a digest mismatch."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        want = tree_flatten(template)
        if len(manifest["leaves"]) != len(want):
            raise ValueError(f"checkpoint at step {step} holds {len(manifest['leaves'])} "
                             f"leaves, the template {len(want)}")
        leaves = []
        for meta, t in zip(manifest["leaves"], want):
            arr = np.load(os.path.join(path, meta["file"]))
            if _digest(arr) != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {meta['file']}")
            x = _from_host(arr, meta["dtype"])
            if isinstance(t, torch.Tensor):
                x = x.to(device=t.device, dtype=t.dtype)
            leaves.append(x)
        return tree_unflatten(template, leaves)

    def restore_latest(self, template: Any) -> Optional[Tuple[Any, int]]:
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(template, steps[-1]), steps[-1]
