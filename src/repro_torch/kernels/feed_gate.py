"""The pipelined restore's gate on the card: wrapper of
``csrc/feed_gate.cu``.

Replaces no TPU kernel: it stands for the ordered ``io_callback`` by
which the reference's jitted ``recompute_pipelined`` takes each layer's
disk rows (``src/repro/models/dense.py:567``).  ``feed_gate`` launches
one thread that waits on the device until the restore's feed has
published layer ``layer`` in the page-locked word ``flags[layer]``
(design, status codes and bound in the CUDA source's note); the plain
version is ``kernels/ref.py::feed_gate_plain``, and ``kernels/ops.py``
dispatches between the two by the device of ``status``.  ``publisher``
gives the feed's side: a release store of a word through the same
library, a host function that makes no CUDA call.

The wrapper checks the flags (int32, page-locked, on the host) and the
device tensors, launches on the current stream without synchronising,
raises if the launch was refused, and adds one to
``feed_gate.launches`` per call.  Nothing is built or loaded when the
module is imported.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from repro_torch.kernels import build

_LIB = None
_DEVICE_PTR: Dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("feed_gate")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.feed_gate.argtypes = [vp, ci, vp, vp, vp, vp, vp]
        lib.feed_gate.restype = ci
        lib.feed_publish.argtypes = [vp, ci, ci]
        lib.feed_publish.restype = None
        lib.feed_flags_device_pointer.argtypes = [vp, ctypes.POINTER(vp)]
        lib.feed_flags_device_pointer.restype = ci
        _LIB = lib
    return _LIB


def _check_flags(flags: torch.Tensor) -> None:
    if flags.device.type != "cpu" or flags.dtype != torch.int32 or \
            flags.dim() != 1 or not flags.is_contiguous():
        raise ValueError("feed_gate: flags must be a contiguous (L,) int32 "
                         "tensor on the host")
    if not flags.is_pinned():
        raise ValueError("feed_gate: flags must be page-locked (the card "
                         "reads them)")


def device_pointer(flags: torch.Tensor) -> int:
    """The card's pointer to the page-locked words of ``flags``."""
    host = flags.data_ptr()
    got = _DEVICE_PTR.get(host)
    if got is None:
        _check_flags(flags)
        out = ctypes.c_void_p()
        err = _lib().feed_flags_device_pointer(host, ctypes.byref(out))
        if err != 0 or not out.value:
            raise RuntimeError(f"feed_gate: the flags are not mapped for the "
                               f"card (error {err})")
        got = _DEVICE_PTR[host] = out.value
    return got


def feed_gate(flags: torch.Tensor, layer: int, gen: torch.Tensor,
              deadline_ns: torch.Tensor, status: torch.Tensor,
              wait_ns: torch.Tensor) -> None:
    """Wait on the card for ``flags[layer] == gen`` (``status`` 1 on
    ``-gen``, 2 past ``deadline_ns``).  flags (L,) int32 page-locked;
    gen () int32, deadline_ns () int64, status (1,) int32, wait_ns (L,)
    int64, all CUDA.  Writes status and wait_ns in place."""
    L = flags.shape[0]
    for name, t, dt, shape in (("gen", gen, torch.int32, ()),
                               ("deadline_ns", deadline_ns, torch.int64, ()),
                               ("status", status, torch.int32, (1,)),
                               ("wait_ns", wait_ns, torch.int64, (L,))):
        if not t.is_cuda or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"feed_gate: {name} must be a CUDA {dt} tensor "
                             f"of shape {shape}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"feed_gate: layer {layer} outside 0 .. {L - 1}")
    dev = status.device
    with torch.cuda.device(dev):
        err = _lib().feed_gate(
            device_pointer(flags), int(layer), gen.data_ptr(),
            deadline_ns.data_ptr(), status.data_ptr(), wait_ns.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"feed_gate launch failed (error {err})")
    feed_gate.launches += 1


feed_gate.launches = 0


def publisher(flags: torch.Tensor) -> Callable[[int, int], None]:
    """The feed's side over the page-locked ``flags``: ``publish(layer,
    word)``, a release store through ``csrc/feed_gate.cu``
    (``feed_publish``), which makes no CUDA call and releases the GIL."""
    _check_flags(flags)
    fn, host = _lib().feed_publish, flags.data_ptr()

    def publish(layer: int, word: int) -> None:
        fn(host, int(layer), int(word))
    return publish


def reset_launches() -> None:
    feed_gate.launches = 0
