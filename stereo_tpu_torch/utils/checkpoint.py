"""Versioned, atomic, optionally-async checkpointing of optimization state
(port of stereo_tpu/utils/checkpoint.py).

The reference's save_progress.m re-saves the disparity map every fusion
iteration (ojw_stereo_optim.m:134); this captures any nest of arrays —
label / plane fields, TRW-S messages, energy traces — so a simultaneous
fusion can resume mid-sweep with an identical trajectory.

Format: one ``<name>-<step>.npz`` per step, the nest flattened to string key
paths, written to a temporary file and atomically renamed; an optional
background thread makes saves non-blocking.  A bfloat16 leaf (narrow
message storage) is written as its 2-byte patterns, ``|V2``, and loads as
such, as in the JAX package.  The key paths are the JAX
package's (``"['a']"``, ``"['b']/['c']"``, ``"[0]"``, ``".x"`` for a named
tuple's field), so each package loads the other's files.
"""

from __future__ import annotations

import os
import queue
import re
import threading

import numpy as np
import torch


def _leaves(tree, path=()):
    """(key path, leaf) pairs in the JAX package's order: dict keys sorted,
    sequences by index, named tuples by field; ``None`` holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    else:
        yield path, tree


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array a checkpoint holds: a tensor copied to the
    host; a bfloat16 one, which numpy has no type for, as its 2-byte
    patterns (``|V2``), as the JAX package's ``Checkpointer`` writes a
    bfloat16 array (``convert.problem_from_numpy`` reads them back)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    """The nest as {key path: numpy array}; tensors are copied to the host."""
    return {"/".join(path): to_numpy(leaf) for path, leaf in _leaves(tree)}


class Checkpointer:
    def __init__(self, directory: str, name: str = "state", keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.name = name
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._queue: queue.Queue | None = None
        self._error: BaseException | None = None
        if async_save:
            self._queue = queue.Queue()
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, state) -> None:
        self._raise_pending()
        flat = _flatten(state)  # copied to the host on the caller's thread
        if self._queue is not None:
            self._queue.put((step, flat))
        else:
            self._write(step, flat)

    def wait(self) -> None:
        """Block until all queued saves are on disk."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    def _raise_pending(self):
        """Surface an async write failure on the caller's thread."""
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _drain(self):
        # A failed write must not kill the worker: record the error (surfaced
        # on the next save()/wait()) and keep draining so later saves and
        # wait()'s queue.join() still make progress.
        while True:
            step, flat = self._queue.get()
            try:
                self._write(step, flat)
            except BaseException as e:  # noqa: BLE001
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, flat: dict):
        path = os.path.join(self.directory, f"{self.name}-{step}.npz")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            try:
                os.remove(os.path.join(self.directory, f"{self.name}-{s}.npz"))
            except OSError:
                pass

    # ------------------------------------------------------------------ load
    def steps(self) -> list[int]:
        pat = re.compile(rf"^{re.escape(self.name)}-(\d+)\.npz$")
        out = []
        for fn in os.listdir(self.directory):
            m = pat.match(fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def load(self, step: int | None = None) -> tuple[int, dict]:
        """Returns (step, flat dict of numpy arrays). step=None -> latest."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(
                f"no checkpoints named {self.name!r} in {self.directory}"
            )
        if step is None:
            step = steps[-1]
        path = os.path.join(self.directory, f"{self.name}-{step}.npz")
        with np.load(path) as z:
            return step, {k: z[k] for k in z.files}
