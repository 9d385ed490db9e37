"""Flash attention on Hopper: the hand-written CUDA kernel and its wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``_flash_kernel`` of the reference package; its source note gives its
bound and design.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``, at
first use (``kernels.nvcc``).

:func:`flash_attention` takes model-layout tensors.  On a CPU tensor it
computes the kernel's plain version (``kernels.ref``); on a CUDA tensor
it launches the kernel or raises — it never falls back.  ``launches``
counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref, registry
from repro_torch.kernels.nvcc import KernelLibrary

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by this process (plain integer, read by the chip
# smoke run to show the main path went through the kernel)
launches = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.toast_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
                   [ctypes.c_longlong] * 12 +
                   [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


_LIB = KernelLibrary("flash_attention.cu", "libtoast_flash_attention.so",
                     _declare)
build, build_dir, build_log = _LIB.build, _LIB.build_dir, _LIB.build_log


def reference(q, k, v, *, causal: bool = True,
              sm_scale: float | None = None):
    """The kernel's plain version, in model layout (B,S,H,hd)."""
    out = ref.reference_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, sm_scale=sm_scale)
    return out.transpose(1, 2)


def reference_bwd(q, k, v, do, *, causal: bool = True):
    """The plain version's vjp, in model layout: ``(dq, dk, dv)``."""
    t = lambda x: x.transpose(1, 2)
    dq, dk, dv = ref.reference_attention_bwd(t(q), t(k), t(v), t(do),
                                             causal=causal)
    return t(dq), t(dk), t(dv)


def _strides(t) -> list[int]:
    """Element strides of dims (B, S, H) as the kernel takes them.

    A dim of size 1 is never stepped over, so it is given the stride it
    would have in a packed tensor, whatever view made it.
    """
    return [st if n > 1 else math.prod(t.shape[i + 1:])
            for i, (n, st) in enumerate(zip(t.shape[:3], t.stride()[:3]))]


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B,S,H,hd) q and "
                         "(B,T,H,hd) k, v")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, hd):
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match (GQA groups are expanded by the caller)")
    if S == 0 or k.shape[1] == 0 or B == 0 or H == 0:
        raise ValueError("flash_attention needs non-empty tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous head dim")
    if q.dtype == torch.bfloat16 and (
            any(st % 8 for t in (q, k, v) for st in _strides(t)) or
            any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash_attention loads bf16 tiles with TMA: "
                         "tensors must be 16-byte aligned and their batch, "
                         "sequence and head strides multiples of 16 bytes")
    if not registry.cuda_feasible("flash_attention", {"head_dim": hd}):
        raise ValueError(f"the CUDA flash-attention kernel takes head_dim "
                         f"in {sorted(registry.CUDA_HEAD_DIMS)}, got {hd}")


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """Attention forward: q (B,S,H,hd); k, v (B,T,H,hd) -> (B,S,H,hd).

    Args:
        q: queries, model layout, float32 or bfloat16.
        k: keys, same head count as ``q`` (GQA expanded by the caller).
        v: values, shaped like ``k``.
        causal: mask ``q_pos >= k_pos`` on absolute positions.
        sm_scale: score scale, ``1/sqrt(hd)`` by default.

    Returns:
        The attention output in q's dtype and layout.

    Raises:
        ValueError, TypeError: for inputs the kernel does not take (on a
            CUDA device).
        RuntimeError: when the build or the launch fails.
    """
    global launches
    if q.device.type == "cpu":
        return reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    _check(q, k, v)
    B, S, H, hd = q.shape
    T = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.toast_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, T, H, hd, _DTYPES[q.dtype],
        *_strides(q), *_strides(k), *_strides(v), *_strides(o),
        int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with "
                           f"CUDA error {err}")
    launches += 1
    return o
