"""Checkpointing with atomic manifest commit + async writes, over torch trees.

The port of ``repro/checkpoint/ckpt.py``, in its on-disk format: a
checkpoint written by either package restores in the other.

Layout (one directory per step):

    <dir>/step_000120/
        manifest.json       # {"step", "arrays": {key: {"file", "shape",
                            #  "dtype"}}, "extra"} (data cursor, step, ...)
        arrays/<leaf-id>.npy

* keys — dict keys, sequence indices and NamedTuple field names joined by
  ``/`` with no leading slash (``params/segments/0/pos0/attn/wq``,
  ``opt_state/m/embed``, ``opt_state/step``); files are numbered by the
  sorted key, as the JAX module numbers them;
* dtypes — numpy names (``float32``, ``int32``, ``bfloat16``); a bfloat16
  leaf is stored as its raw ``uint16`` lanes and read back through an
  ``int16`` view, so restoring needs neither JAX nor ``ml_dtypes``;
* atomic commit — arrays land in ``.tmp_step_*``, the manifest is written
  last and the directory renamed; :func:`latest_step` counts committed
  steps only;
* async — :meth:`CheckpointManager.save_async` copies every leaf to host
  memory before its writer thread starts (the train step updates the
  parameters and the optimiser state in place, so the snapshot must not
  share their storage), and blocks only on the previous save.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]


def _children(tree):
    """``(key, child)`` pairs of a dict, NamedTuple (by field name) or
    sequence, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaf_fn(key, leaf)``,
    the key as the JAX module's ``_flatten`` makes it."""
    kids = _children(tree)
    if kids is None:
        return leaf_fn(prefix, tree)
    new = [_rebuild(sub, leaf_fn, f"{prefix}/{k}" if prefix else k) for k, sub in kids]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), new))
    if hasattr(tree, "_fields"):
        return type(tree)(*new)
    return type(tree)(new)


def _flatten(tree) -> Dict[str, Any]:
    """``{key: leaf}`` with the JAX module's keys."""
    out = {}
    _rebuild(tree, out.__setitem__)
    return out


def _host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The leaf as a C-ordered numpy array to write (a 0-d leaf stays 0-d),
    and its logical dtype."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no native bfloat16: persist the raw 2-byte lanes
        arr, logical = t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    else:
        arr = t.numpy()
        logical = str(arr.dtype)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    return arr, logical


def save_checkpoint(
    directory: str | Path,
    step: int,
    tree,
    *,
    extra: Optional[dict] = None,
) -> Path:
    """Synchronous save with atomic commit. Returns the committed path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    flat = _flatten(tree)
    meta = {}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        arr, logical = _host(leaf)
        np.save(tmp / "arrays" / f"{i}.npy", arr)
        meta[key] = {"file": f"{i}.npy", "shape": list(arr.shape), "dtype": logical}
    manifest = {"step": step, "arrays": meta, "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.glob("step_*"):
        if (p / "manifest.json").exists():  # committed only
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(
    directory: str | Path,
    tree_like,
    *,
    step: Optional[int] = None,
    shardings=None,
) -> Tuple[Any, dict]:
    """Restore into the structure of ``tree_like``: each leaf in the
    manifest's dtype on the device of ``tree_like``'s leaf, or, where
    ``shardings`` is given (a matching tree of ``torch.device``, the
    single-device counterpart of the JAX module's ``NamedSharding`` tree),
    on that device.  A key the checkpoint lacks keeps ``tree_like``'s leaf;
    a key ``tree_like`` lacks is skipped.  Returns ``(tree, extra)``, the
    manifest's ``extra`` as it was saved."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    src = directory / f"step_{step:09d}"
    manifest = json.loads((src / "manifest.json").read_text())
    arrays = manifest["arrays"]
    flat_sh = _flatten(shardings) if shardings is not None else {}

    def leaf(key, like):
        if key not in arrays:
            return like
        info = arrays[key]
        t = _load(src / "arrays" / info["file"], info["dtype"])
        return t.to(flat_sh.get(key, like.device))

    return _rebuild(tree_like, leaf), manifest["extra"]


class CheckpointManager:
    """Async double-buffered writer + retention."""

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, *, extra: Optional[dict] = None):
        self.wait()  # block on the previous save only
        # snapshot now, into host memory of its own: ``Tensor.cpu()`` of a
        # CPU tensor would return the same storage, which the next in-place
        # step changes while the thread writes it
        tree = _rebuild(tree, lambda _, t: t.detach().to("cpu", copy=True))

        def work():
            try:
                save_checkpoint(self.directory, step, tree, extra=extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.directory.glob("step_*")
            if (p / "manifest.json").exists()
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:09d}", ignore_errors=True)
