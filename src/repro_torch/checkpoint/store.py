"""Fault-tolerant checkpoints: the port of ``repro/checkpoint/store.py``,
with its on-disk format and protocol, so either store reads what the
other wrote.

Write protocol (crash-safe at every point):
  1. serialize the named trees to <dir>/tmp.step_N/arrays.npz (one array a
     leaf, keyed ``name::path``, paths as ``repro_torch.tree`` names them)
     and manifest.json (step, each tree's sorted keys, each key's dtype
     string, ``extra``), fsync the manifest;
  2. rename to <dir>/step_N;
  3. update <dir>/LATEST (write a tmp file, fsync, rename).
Restore reads LATEST, falls back to the newest step directory that holds a
manifest, so a torn write is never loaded.  ``keep_last`` old steps are
removed after a successful write.

Types numpy cannot write are stored as a flat uint8 view with their dtype
string in the manifest: bf16 as ``"bfloat16"``, read back through torch
(``.view(torch.bfloat16)``), so no ``ml_dtypes`` is needed.  Leaves are
restored in the template's dtype, on the template's device.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

MANIFEST = "manifest.json"


def _host(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor (a numpy array is taken as it is)."""
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf)
    return leaf.detach().cpu()


def _snapshot(leaf) -> torch.Tensor:
    """A copy of a leaf on the host, one copy whatever its device."""
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf.copy())
    return leaf.detach().to("cpu", copy=True)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    """key -> (the array as saved, the leaf's dtype string)."""
    flat = {}
    for key, leaf in tree_lib.leaves_with_paths(tree):
        t = _host(leaf).contiguous()
        if t.dtype == torch.bfloat16:
            flat[key] = (t.reshape(-1).view(torch.uint8).numpy(), "bfloat16")
        else:
            raw = t.numpy()
            flat[key] = (raw, str(raw.dtype))
    return flat


def _leaf(arr: np.ndarray, dtype_str: str, like) -> torch.Tensor:
    """The saved array as a tensor of ``like``'s shape, dtype and device."""
    if dtype_str == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
        t = t.view(torch.bfloat16)
    elif arr.dtype == np.uint8 and dtype_str not in ("", "uint8"):
        raise ValueError(f"cannot read a leaf stored as {dtype_str!r}")
    else:
        t = torch.from_numpy(np.array(arr))
    shape = tuple(like.shape)
    if t.numel() != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"checkpoint leaf of {t.numel()} values for a "
                         f"template of shape {shape}")
    return t.reshape(shape).to(device=like.device, dtype=like.dtype)


class CheckpointStore:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[Dict] = None) -> str:
        """trees: named trees, e.g. {'params': ..., 'opt_state': ...}."""
        tmp = os.path.join(self.dir, f"tmp.step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        arrays = {}
        manifest = {"step": step, "trees": {}, "dtypes": {}, "extra": extra or {}}
        for name, tree in trees.items():
            flat = _flatten(tree)
            manifest["trees"][name] = sorted(flat)
            for k, (v, dtype_str) in flat.items():
                arrays[f"{name}::{k}"] = v
                manifest["dtypes"][f"{name}::{k}"] = dtype_str
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, MANIFEST)):
                out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            with contextlib.suppress(ValueError), open(path) as f:
                step = int(f.read().strip())
                if os.path.exists(os.path.join(self.dir, f"step_{step}", MANIFEST)):
                    return step
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, templates: Dict[str, Any],
                step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
        """The named trees of ``step`` (the latest by default), each
        shaped, typed and placed as its template."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        out = {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for name, template in templates.items():
                def fill(key, like, name=name):
                    full = f"{name}::{key}"
                    return _leaf(data[full], dtypes.get(full, ""), like)

                out[name] = tree_lib.map_with_paths(fill, template)
        return step, out


class AsyncCheckpointWriter:
    """Copy to the host, then write on a background thread; ``wait()``
    joins it and raises what the write raised.

    The copy to the host is synchronous (consistency: the trees may be
    replaced or updated in place by the next step); serialization, fsync
    and the renames run off the loop's thread.
    """

    def __init__(self, store: CheckpointStore):
        self.store = store
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, trees: Dict[str, Any], extra=None):
        self.wait()
        host_trees = {name: tree_lib.map_with_paths(lambda _, x: _snapshot(x),
                                                    tree)
                      for name, tree in trees.items()}

        def _write():
            try:
                self.store.save(step, host_trees, extra)
            except BaseException as e:  # noqa: BLE001  (raised by wait())
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
