"""Flash attention on Hopper: the hand-written CUDA kernel and its wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``_flash_kernel`` of the reference package; its source note gives its
bound and design.  It is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``, at
first use, into ``_build/<hash of the source and flags>/`` beside this
module — so a fresh checkout builds it in seconds and an edited source
rebuilds.

:func:`flash_attention` takes model-layout tensors.  On a CPU tensor it
computes the kernel's plain version (``kernels.ref``); on a CUDA tensor
it launches the kernel or raises — it never falls back.  ``launches``
counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import ref, registry

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BUILD_ROOT = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by this process (plain integer, read by the chip
# smoke run to show the main path went through the kernel)
launches = 0

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA flash-attention "
                           "kernel is built from source at first use")
    return found


def build_dir() -> Path:
    """The build directory for the current source and flags."""
    key = hashlib.sha256(_SRC.read_bytes() +
                         " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_ROOT / key


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.

    Returns:
        The loaded library with its C entry point's signature declared.

    Raises:
        RuntimeError: when ``nvcc`` is missing or fails.
    """
    global _lib
    if _lib is not None:
        return _lib
    out = build_dir()
    so = out / "libtoast_flash_attention.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True)
        (out / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {_SRC.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.toast_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
                   [ctypes.c_longlong] * 12 +
                   [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build_log() -> str:
    """``nvcc``'s output (registers, shared memory, spills) of the build."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def reference(q, k, v, *, causal: bool = True,
              sm_scale: float | None = None):
    """The kernel's plain version, in model layout (B,S,H,hd)."""
    out = ref.reference_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, sm_scale=sm_scale)
    return out.transpose(1, 2)


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
            any(st % 2 for t in (q, k, v) for st in t.stride()[:3]) or
            any(t.data_ptr() % 4 for t in (q, k, v))):
        raise ValueError("flash_attention reads bf16 in pairs: strides "
                         "must be even and tensors 4-byte aligned")
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
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with "
                           f"CUDA error {err}")
    launches += 1
    return o
