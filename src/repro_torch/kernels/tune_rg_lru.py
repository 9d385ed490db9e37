"""Times variants of the RG-LRU kernel's TMA ring on one CUDA card.

Each variant is ``csrc/rg_lru.cu`` with other values of the ring's
constants (``kTileBytes`` channel bytes per block, ``kBoxS`` steps per box,
``kStages`` stages of the a and b ring, ``kOutBoxes`` staging boxes of
h), written under ``_build/variants/`` and built there, all at once.
Each variant is held against the plain version, then timed with CUDA
events at the recurrentgemma_2b slice shape (4, 4096, 3840) in f32 and
bf16 and at (1, 4096, 3840) f32, beside the generic route of the
shipped build, in passes whose order alternates.

    PYTHONPATH=src python -m repro_torch.kernels.tune_rg_lru [--out FILE]

Needs one CUDA card and ``nvcc``.  Prints one line per variant and
shape, and writes every time as JSON to FILE
(``chiprun_out/rg_lru_variants.json`` by default).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels import rg_lru as lru

# (kTileBytes, kBoxS, kStages, kOutBoxes); the first is the shipped one
VARIANTS = [(256, 64, 3, 2), (256, 32, 4, 2), (256, 32, 3, 2),
            (256, 32, 6, 2), (256, 32, 6, 3), (256, 64, 4, 2),
            (128, 32, 4, 2), (128, 32, 6, 2), (512, 32, 3, 2),
            (512, 32, 4, 2)]
SHAPES = [((4, 4096, 3840), torch.float32), ((4, 4096, 3840), torch.bfloat16),
          ((1, 4096, 3840), torch.float32)]
PASSES = 2
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
PEAK_HBM_BYTES = 3.35e12   # H100 SXM data sheet


def variant_source(spec) -> str:
    """``rg_lru.cu`` with the ring constants of ``spec``."""
    src = (nvcc._CSRC / "rg_lru.cu").read_text()
    for name, value in zip(("kTileBytes", "kBoxS", "kStages", "kOutBoxes"),
                           spec):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"rg_lru.cu has {n} lines '{name} = ...'")
    return src


def variant_library(spec) -> nvcc.KernelLibrary:
    tag = "t{}_b{}_s{}_o{}".format(*spec)
    path = nvcc._BUILD_ROOT / "variants" / f"rg_lru_{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(variant_source(spec))
    return nvcc.KernelLibrary(str(path), "libtoast_rg_lru.so", lru._declare)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(gen, shape, dtype):
    a = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda"))
    b = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/rg_lru_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_rg_lru: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(card, flush=True)

    names = ["generic"] + ["tile {} B box {} stages {} out {}".format(*v)
                           for v in VARIANTS]
    libs = [variant_library(v) for v in VARIANTS]
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        for fut in [pool.submit(lib.build) for lib in [lru._LIB, *libs]]:
            fut.result()
    for name, lib in zip(names[1:], libs):
        regs = [line.strip() for line in lib.build_log().splitlines()
                if "registers" in line]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {n: {} for n in names}
    for shape, dtype in SHAPES:
        a, b = inputs(gen, shape, dtype)
        want = lru.reference(a, b).float()
        calls = {"generic": lambda: lru.launch(lru._LIB.build(), a, b,
                                               "generic")}
        for name, lib in zip(names[1:], libs):
            calls[name] = (lambda lib=lib:
                           lru.launch(lib.build(), a, b, "tma"))
        for name, fn in calls.items():
            torch.testing.assert_close(fn().float(), want, rtol=TOL[dtype],
                                       atol=TOL[dtype])
        key = f"{tuple(shape)} {str(dtype).removeprefix('torch.')}"
        bound = 3.0 * a.numel() * a.element_size() / PEAK_HBM_BYTES * 1e3
        order = list(calls)
        for p in range(PASSES):
            for name in order if p % 2 == 0 else order[::-1]:
                runs[name].setdefault(key, []).append(cuda_ms(calls[name]))
        for name in order:
            ms = runs[name][key]
            print(f"[variant] {card}: {name:32s} {key}: "
                  + " / ".join(f"{t:.4f}" for t in ms)
                  + f" ms, bound {bound:.4f} ms -> "
                  f"{bound / min(ms):.1%} of bound", flush=True)
        del a, b, want
        torch.cuda.empty_cache()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "ms": runs}, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
