"""Fault-tolerant checkpointing: atomic, async, device-free.

Mirror of the JAX package's ``train/checkpoint.py``:

* atomic: write to ``step_NNN.pkl.tmp`` then ``os.replace`` — a crash
  mid-write never corrupts the latest checkpoint;
* async: ``save_async`` copies the state to host numpy before it returns
  and hands the file write to a background thread; the train loop never
  blocks on disk (``flush`` joins the writers);
* device-free: a checkpoint is a pickled tree of numpy arrays, and
  ``restore`` puts it on the device the caller names;
* GC: the ``keep`` most recent checkpoints are retained.

numpy has no bfloat16 of its own (the reference's files hold
``ml_dtypes.bfloat16`` arrays, a package the port does not need), so a
bf16 tensor is stored as its 16-bit pattern (``uint16``) under a dtype
tag and comes back bit for bit.
"""
from __future__ import annotations

import os
import pickle
import re
import threading
from typing import Any, Optional

import numpy as np
import torch

_PAT = re.compile(r"step_(\d+)\.pkl$")
_BF16 = "__bfloat16__"
_save_lock = threading.Lock()
_pending: list = []


def _to_host(tree: Any) -> Any:
    """Tensors -> numpy arrays (bf16 -> {_BF16: uint16 bits}); dicts,
    lists and tuples keep their shape; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        # a copy: later in-place updates of the tensor must not reach
        # the snapshot (.cpu() of a CPU tensor is the tensor itself)
        t = tree.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return {_BF16: t.view(torch.int16).numpy().view(np.uint16)}
        return t.numpy()
    return tree


def _from_host(tree: Any, device) -> Any:
    """Inverse of ``_to_host``: numpy arrays -> tensors on ``device``."""
    if isinstance(tree, dict):
        if set(tree) == {_BF16}:
            bits = torch.from_numpy(tree[_BF16].view(np.int16).copy())
            return bits.view(torch.bfloat16).to(device)
        return {k: _from_host(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_host(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


def _write(ckpt_dir: str, step: int, host: Any, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    _gc(ckpt_dir, keep)
    return path


def save(ckpt_dir: str, step: int, state: Any, keep: int = 3) -> str:
    """Write ``state`` as ``step_<step>.pkl`` now.  -> its path."""
    with _save_lock:
        return _write(ckpt_dir, step, _to_host(state), keep)


def save_async(ckpt_dir: str, step: int, state: Any, keep: int = 3
               ) -> threading.Thread:
    """Copy ``state`` to the host now (later updates of its tensors do not
    reach the file), write it on a background thread."""
    host = _to_host(state)

    def work():
        with _save_lock:
            _write(ckpt_dir, step, host, keep)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    _pending.append(t)
    return t


def flush() -> None:
    """Wait for every ``save_async`` writer."""
    for t in list(_pending):
        t.join()
    _pending.clear()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := _PAT.search(f))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, device="cuda"
            ) -> Any:
    """The checkpoint of ``step`` (default: the latest) with its tensors on
    ``device``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step}.pkl"), "rb") as f:
        return _from_host(pickle.load(f), torch.device(device))


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                   if (m := _PAT.search(f)))
    for s in steps[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{s}.pkl"))
        except FileNotFoundError:
            pass
