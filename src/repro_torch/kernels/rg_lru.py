"""The RG-LRU scan on Hopper: the hand-written CUDA kernel and its wrapper.

The kernel (``csrc/rg_lru.cu``) replaces the Pallas TPU kernel
``_rglru_kernel`` of the reference package; its source note gives its
bound and design.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``, at
first use (``kernels.nvcc``).

The kernel has two hand-written routes: ``"tma"``, a TMA ring in shared
memory fed by a producer warp, for inputs that TMA can describe; and
``"generic"``, one thread per channel loading ahead, for any strides.
:func:`route` chooses between them from the inputs alone.

:func:`rg_lru` computes ``h_t = a_t h_{t-1} + b_t`` over (B, S, R).  On a
CPU tensor it computes the kernel's plain version (``kernels.ref``); on
a CUDA tensor it launches one of the two routes or raises — it never
falls back.  ``launches`` counts the kernel launches of this process and
``route_launches`` splits them by route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.nvcc import KernelLibrary

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"generic": 0, "tma": 1}
# the ring route's tile, as ``csrc/rg_lru.cu`` builds it: channel bytes
# per block, sequence steps per TMA box, stages of the a and b ring,
# staging boxes of h
TILE_BYTES, BOX_S, STAGES, OUT_BOXES = 256, 64, 3, 2

# kernel launches made by this process, in all and by route (plain
# integers, read by the chip smoke run to show the main path went
# through the kernel and which route it took)
launches = 0
route_launches = dict.fromkeys(ROUTES, 0)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.toast_rg_lru_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 +
                   [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


_LIB = KernelLibrary("rg_lru.cu", "libtoast_rg_lru.so", _declare)
build, build_dir, build_log = _LIB.build, _LIB.build_dir, _LIB.build_log

reference = ref.reference_rg_lru
reference_bwd = ref.reference_rg_lru_bwd


def _strides(t) -> list[int]:
    """Element strides of dims (B, S) as the kernel takes them.

    A dim of size 1 is never stepped over, so it is given the stride it
    would have in a packed tensor, whatever view made it.
    """
    return [st if n > 1 else math.prod(t.shape[i + 1:])
            for i, (n, st) in enumerate(zip(t.shape[:2], t.stride()[:2]))]


def route(a, b) -> str:
    """The route that takes a and b: ``"tma"`` or ``"generic"``.

    The TMA ring copies a and b in and h (allocated packed, so with
    strides S*R and R) out.  TMA needs each base 16-byte aligned and the
    batch and sequence strides (``_strides``) in multiples of 16 bytes,
    below 2**40 bytes.  Inputs that meet that take the ring, the others
    the generic route.  A pure function of shape, strides, dtype and data
    pointers.
    """
    _, S, R = a.shape
    size = a.element_size()
    strides = [*_strides(a), *_strides(b), S * R, R]
    if a.data_ptr() % 16 or b.data_ptr() % 16 or any(
            st * size % 16 or st * size >= 1 << 40 for st in strides):
        return "generic"
    return "tma"


def _check(a, b) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rg_lru takes a and b of one (B,S,R) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.numel() == 0:
        raise ValueError("rg_lru needs non-empty tensors")
    if a.shape[0] > 65535:
        raise ValueError(f"rg_lru takes at most 65535 batch rows, got "
                         f"{a.shape[0]}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"rg_lru takes float32 or bfloat16 a and b of one "
                        f"dtype, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("rg_lru needs a contiguous channel dim")


def launch(lib: ctypes.CDLL, a, b, which: str):
    """Launches route ``which`` of ``lib``'s kernel on checked CUDA a, b.

    Raises:
        RuntimeError: when the launch fails (the ``"tma"`` route refuses
            inputs TMA cannot describe).
    """
    global launches
    B, S, R = a.shape
    h = torch.empty((B, S, R), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.toast_rg_lru_fwd(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, R, _DTYPES[a.dtype],
        ROUTES[which], *_strides(a), *_strides(b), *_strides(h), stream)
    if err != 0:
        raise RuntimeError(f"rg_lru kernel launch ({which} route) failed "
                           f"with CUDA error {err}")
    launches += 1
    route_launches[which] += 1
    return h


def rg_lru(a, b):
    """The gated linear recurrence: a, b (B,S,R) -> h (B,S,R).

    Args:
        a: decay gates, float32 or bfloat16, unit channel stride.
        b: inputs, a's shape and dtype.

    Returns:
        ``h_t = a_t h_{t-1} + b_t`` from h = 0, carried in float32 and
        returned in a's dtype.

    Raises:
        ValueError, TypeError: for inputs the kernel does not take (on a
            CUDA device).
        RuntimeError: when the build or the launch fails.
    """
    if a.device.type == "cpu":
        return reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru runs on CUDA or CPU tensors, got "
                         f"{a.device}")
    _check(a, b)
    return launch(build(), a, b, route(a, b))
