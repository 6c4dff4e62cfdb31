"""Asynchronous, verified checkpointing of nested-dict tensor trees
(``repro.checkpoint.manager``, same on-disk contract):

  * **Leaf-per-file layout** with a JSON manifest (leaf keys, shapes,
    dtypes, step); arrays are saved as plain ``.npy`` files, so a
    checkpoint restores onto any device.
  * **Async writes**: ``save`` copies every leaf to host memory before it
    returns, then hands the file I/O to a background thread. The copy must
    be complete on return: the trainer's next optimizer step updates the
    same device tensors in place (the reference gets this from
    ``device_get`` and buffer donation).
  * **Atomicity**: writes go to ``<dir>.tmp`` then rename; ``latest_step``
    only sees complete manifests.
  * **Integrity**: each leaf records a CRC32; restore verifies it. A
    corrupt step is quarantined (renamed ``.corrupt``) and the previous
    complete one restored; ``last_restored_step`` says which.
  * ``keep`` newest complete checkpoints survive garbage collection.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_items

Tree = Any

_SEP = "__"


def _flatten(tree: Tree) -> List[Tuple[str, Any]]:
    """(key, leaf) in sorted-key order; keys join the path with ``__``."""
    return [(path.replace("/", _SEP), leaf)
            for path, leaf in tree_items(tree)]


def _unflatten_like(like: Tree, leaves: List[Any]) -> Tree:
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(like)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the step restore() actually loaded: older than the requested one
        # when a corrupt checkpoint was quarantined
        self.last_restored_step: Optional[int] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Tree, *, blocking: bool = False
             ) -> None:
        """Copy to host now, write asynchronously (unless blocking)."""
        self.wait()  # one outstanding write at a time
        leaves = [(key, leaf.detach().to("cpu", copy=True).numpy()
                   if isinstance(leaf, torch.Tensor) else np.array(leaf))
                  for key, leaf in _flatten(state)]

        def write() -> None:
            try:
                final = os.path.join(self.directory, f"step_{step:08d}")
                tmp = final + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest = {"step": step,
                            "treedef": [key for key, _ in leaves],
                            "leaves": {}}
                for key, arr in leaves:
                    fn = key + ".npy"
                    np.save(os.path.join(tmp, fn), arr)
                    manifest["leaves"][key] = {
                        "file": fn, "shape": list(arr.shape),
                        "dtype": str(arr.dtype), "crc32": _crc(arr),
                    }
                with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                    json.dump(manifest, fh)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as exc:  # surfaced on next wait()
                self._error = exc

        if blocking:
            write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for step in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{step:08d}"))

    # --------------------------------------------------------------- restore

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            # strict step_<digits>: skips ".tmp" partials and ".corrupt"
            # quarantined dirs
            if not name.startswith("step_") or not name[5:].isdigit():
                continue
            if os.path.exists(os.path.join(self.directory, name,
                                           "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Tree,
                shard_fn: Optional[Callable[[str, np.ndarray], Any]] = None
                ) -> Tree:
        """Restore into the structure of ``like``; each leaf lands on the
        device of ``like``'s leaf, or wherever ``shard_fn(key, array)``
        puts it. A corrupt checkpoint (CRC mismatch or unreadable leaf) is
        quarantined and the previous complete one restored, falling back
        as far as needed; only when none survives does the ``IOError``
        propagate."""
        while True:
            try:
                out = self._restore_step(step, like, shard_fn)
                self.last_restored_step = step
                return out
            except IOError:
                self._quarantine(step)
                earlier = [s for s in self.all_steps() if s < step]
                if not earlier:
                    raise
                step = earlier[-1]

    def _quarantine(self, step: int) -> None:
        path = os.path.join(self.directory, f"step_{step:08d}")
        if not os.path.isdir(path):
            return
        target = path + ".corrupt"
        if os.path.exists(target):
            shutil.rmtree(target)
        os.rename(path, target)

    def _restore_step(self, step: int, like: Tree,
                      shard_fn: Optional[Callable[[str, np.ndarray], Any]]
                      ) -> Tree:
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        leaves = []
        for key, leaf in _flatten(like):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            try:
                arr = np.load(os.path.join(path, meta["file"]))
            except (OSError, ValueError, EOFError) as exc:
                # truncated/unreadable leaf: the same corruption class as a
                # checksum mismatch, handled by the same quarantine
                raise IOError(f"checksum mismatch restoring {key!r} "
                              f"(corrupt checkpoint: {exc})") from exc
            if _crc(arr) != meta["crc32"]:
                raise IOError(f"checksum mismatch restoring {key!r} "
                              "(corrupt checkpoint)")
            want_shape = tuple(leaf.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(
                    f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                    f"model {want_shape}")
            if shard_fn is not None:
                leaves.append(shard_fn(key, arr))
            else:
                device = leaf.device if isinstance(leaf, torch.Tensor) \
                    else "cpu"
                leaves.append(torch.from_numpy(arr).to(device))
        return _unflatten_like(like, leaves)
