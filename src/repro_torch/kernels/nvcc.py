"""Build and load a hand-written CUDA kernel library at first use.

Each kernel source under ``csrc/`` has a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library and loaded
with ``ctypes`` into ``_build/<hash of the source, the shared headers
and the flags>/`` beside this module, so a fresh checkout builds it in
seconds and an edited source or header rebuilds.  Nothing is built when
a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD_ROOT = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source at first use")
    return found


class KernelLibrary:
    """One ``csrc/`` source built into one shared library.

    Args:
        source: file name under ``csrc/`` (or an absolute path; it may
            include the ``csrc/*.cuh`` headers).
        lib_name: file name of the shared library.
        declare: sets the C entry points' ``argtypes`` / ``restype`` on
            the loaded library.
    """

    def __init__(self, source: str, lib_name: str,
                 declare: Callable[[ctypes.CDLL], None]) -> None:
        self.source = _CSRC / source
        self.lib_name = lib_name
        self._declare = declare
        self._lib: ctypes.CDLL | None = None

    def build_dir(self) -> Path:
        """The build directory for the current source, headers and flags."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(_CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return _BUILD_ROOT / digest.hexdigest()[:16]

    def build(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library.

        Returns:
            The loaded library with its entry points declared.

        Raises:
            RuntimeError: when ``nvcc`` is missing or fails.
        """
        if self._lib is not None:
            return self._lib
        out = self.build_dir()
        so = out / self.lib_name
        if not so.exists():
            out.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
            os.close(fd)
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", tmp,
                 str(self.source)],
                capture_output=True, text=True)
            (out / "build.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        self._declare(lib)
        self._lib = lib
        return lib

    def build_log(self) -> str:
        """``nvcc``'s output (registers, shared memory, spills)."""
        path = self.build_dir() / "build.log"
        return path.read_text() if path.exists() else ""
