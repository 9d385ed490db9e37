"""The RG-LRU scan on Hopper: the hand-written CUDA kernel and its wrapper.

The kernel (``csrc/rg_lru.cu``) replaces the Pallas TPU kernel
``_rglru_kernel`` of the reference package; its source note gives its
bound and design.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``, at
first use (``kernels.nvcc``).

:func:`rg_lru` computes ``h_t = a_t h_{t-1} + b_t`` over (B, S, R).  On a
CPU tensor it computes the kernel's plain version (``kernels.ref``); on
a CUDA tensor it launches the kernel or raises — it never falls back.
``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.nvcc import KernelLibrary

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by this process (plain integer, read by the chip
# smoke run to show the main path went through the kernel)
launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.toast_rg_lru_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 +
                   [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


_LIB = KernelLibrary("rg_lru.cu", "libtoast_rg_lru.so", _declare)
build, build_dir, build_log = _LIB.build, _LIB.build_dir, _LIB.build_log

reference = ref.reference_rg_lru


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
    global launches
    if a.device.type == "cpu":
        return reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru runs on CUDA or CPU tensors, got "
                         f"{a.device}")
    _check(a, b)
    B, S, R = a.shape
    h = torch.empty((B, S, R), dtype=a.dtype, device=a.device)
    lib = build()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.toast_rg_lru_fwd(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, R, _DTYPES[a.dtype],
        *a.stride()[:2], *b.stride()[:2], *h.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"rg_lru kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return h
