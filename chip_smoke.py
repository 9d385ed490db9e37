#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path — partition and serve the ``qwen2_05b``
prefill step with the fused-attention sites on the hand-written CUDA
flash-attention kernel — through the entry points a user calls:

1. print the card's name and power limit; build the kernel from the
   sources in this checkout;
2. hold the kernel against its plain PyTorch version on the card, at the
   slice shape and at edge shapes;
3. trace and analyze the full-width prefill step on ``meta`` tensors
   (``Session``);
4. search a plan for an 8-card node (2x4 mesh) on the host and check its
   JSON round trip;
5. search the one-card plan, check every kernel site chose ``"cuda"``,
   and apply it on the card with seeded random weights;
6. answer 3 requests of 4 prompts x 2048 tokens, count the kernel's
   launches, and hold the last-token logits against the same requests
   with every site forced to the plain version; check a small f32 model
   against the plain path too;
7. time the kernel at the slice shape beside its bound, its plain
   version and ``scaled_dot_product_attention`` (a yardstick only: the
   port never calls it).

Run from the root of a checkout: ``python3 chip_smoke.py``.  Needs one
CUDA card (sm_90a) and ``nvcc``; exits non-zero, printing no result,
without them.  Any failed check raises.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it holds
the kernel measurements as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# the slice: qwen2_05b prefill, 3 requests of 4 prompts x 2048 tokens
BATCH, SEQ, REQUESTS = 4, 2048, 3
# kernel vs plain version (tests/test_kernels.py's tolerances)
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# last-token logits of the bf16 model, kernel sites vs plain sites: the
# two round attention at different points (the kernel rounds the
# unnormalized probabilities to bf16 and normalizes after the PV product,
# the plain version normalizes first) and the difference compounds over
# 24 bf16 layers; bound on max|diff| relative to max|plain logits|
LOGITS_REL_TOL = 2e-2
# small f32 model, kernel sites vs plain sites
SMALL_TOL = 1e-4
# H100 SXM data sheet (dense bf16 FLOP/s, HBM bytes/s)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls."""
    import torch
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


def check_kernel(fa, torch, gen, B, S, T, H, hd, dtype, causal,
                 strided=False) -> float:
    """Kernel vs plain version on one shape; returns max |error|."""
    shape_q, shape_kv = (B, S, H, hd), (B, T, H, hd)
    if strided:
        # q, k, v as views of one packed projection: non-trivial strides
        packed = torch.randn((B, S, 3, H, hd), generator=gen,
                             device="cuda").to(dtype)
        q, k, v = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
    else:
        q = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
        k = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal)
    want = fa.reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = KERNEL_TOL[str(dtype).removeprefix("torch.")]
    err = (out.float() - want.float()).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    log(f"[kernel] B={B} S={S} T={T} H={H} hd={hd} "
        f"{str(dtype).removeprefix('torch.')} causal={causal} "
        f"strided={strided}: max|err|={err:.3e} (tol {tol}) ok")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the root of a checkout of the "
              "repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.api import Request, Session
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step

    # -- 1: the card and the build ------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    fa.build()
    log(f"[build] flash_attention built/loaded in "
        f"{time.perf_counter() - t0:.1f} s ({fa.build_dir().name})")
    for line in fa.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")

    # -- 2: the kernel against its plain version -------------------------
    cfg = dataclasses.replace(get_config("qwen2_05b"), use_pallas=True)
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    slice_err = check_kernel(fa, torch, gen, BATCH, SEQ, SEQ, H, hd, bf16,
                             True)
    for args in [(2, 200, 333, 4, 64, f32, True),
                 (2, 200, 333, 4, 64, f32, False),
                 (2, 333, 200, 4, 64, bf16, True),
                 (1, 1000, 1000, 2, 64, bf16, True),
                 (1, 1000, 1000, 2, 64, f32, False),
                 (2, 256, 256, 4, 16, f32, True),
                 (2, 256, 256, 4, 16, bf16, True),
                 (2, 256, 256, 4, 128, f32, True),
                 (2, 256, 256, 4, 128, bf16, False),
                 (1, 257, 300, 3, 48, f32, True),
                 (1, 257, 300, 3, 48, bf16, True),
                 (2, 100, 100, 2, 96, bf16, False),
                 (2, 128, 128, 4, 64, bf16, True)]:
        check_kernel(fa, torch, gen, *args)
    for dtype in (f32, bf16):
        check_kernel(fa, torch, gen, 2, 190, 190, 4, 64, dtype, True,
                     strided=True)

    # -- 3: trace and analyze at full width on meta tensors --------------
    step = make_prefill_step(cfg)
    batch_spec = {"tokens": torch.empty((BATCH, SEQ), dtype=torch.int32,
                                        device="meta")}
    sess = Session(step, (T.param_specs(cfg), batch_spec))
    art = sess.artifacts
    log(f"[session] {cfg.name} B={BATCH} S={SEQ}: {len(art.prog.ops)} ops, "
        f"{len(art.nda.color_summary())} colors, "
        f"{len(art.analysis.conflicts)} conflicts, phases "
        + json.dumps({k: round(v, 4) for k, v in
                      art.phase_seconds.items()}))

    # -- 4: the plan for an 8-card node (host only) ----------------------
    plan8 = sess.partition(Request(mesh=MeshSpec(("data", "model"), (2, 4))))
    if ShardingPlan.from_json(plan8.to_json()).as_dict() != plan8.as_dict():
        raise AssertionError("2x4 plan JSON does not round-trip")
    log(f"[partition 2x4] cost={plan8.cost:.6f} "
        f"kernel_sites={len(plan8.kernel_sites)} "
        f"search={plan8.search_seconds:.3f} s "
        f"evaluations={plan8.evaluations} json round-trip ok")

    # -- 5: the one-card plan, applied on the card ------------------------
    plan1 = sess.partition(Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    impls = [r["impl"] for r in plan1.kernel_sites]
    if not impls or any(i != "cuda" for i in impls):
        raise AssertionError(f"1x1 plan kernel sites chose {impls}")
    log(f"[partition 1x1] cost={plan1.cost:.6f} sites="
        + json.dumps({r["site"]: r["impl"] for r in plan1.kernel_sites}))
    applied = plan1.apply(step)
    wgen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, wgen)
    tgen = torch.Generator(device="cuda").manual_seed(1)
    requests = [{"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                         generator=tgen, device="cuda",
                                         dtype=torch.int32)}
                for _ in range(REQUESTS)]
    applied(params, requests[0])            # warm-up, not counted
    torch.cuda.synchronize()

    # -- 6: serve the requests --------------------------------------------
    def serve(fn, label):
        outs = []
        for i, req in enumerate(requests):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = fn(params, req)
            end.record()
            torch.cuda.synchronize()
            if logits.shape != (BATCH, cfg.vocab_size) or \
                    not torch.isfinite(logits).all():
                raise AssertionError(f"{label} request {i}: logits "
                                     f"{tuple(logits.shape)} not finite "
                                     f"or misshapen")
            ids = logits.float().argmax(-1).tolist()
            log(f"[serve {label}] request {i}: next tokens {ids} "
                f"prefill {start.elapsed_time(end):.3f} ms")
            outs.append(logits.float())
        return outs

    fa.launches = 0
    kernel_logits = serve(applied, "cuda")
    launches = fa.launches
    if launches != cfg.num_layers * REQUESTS:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{cfg.num_layers} x {REQUESTS}")
    log(f"[serve] kernel launches {launches} = {cfg.num_layers} layers x "
        f"{REQUESTS} requests")
    plain_plan = dataclasses.replace(
        plan1, kernel_sites=[{**r, "impl": "ref"}
                             for r in plan1.kernel_sites])
    plain_logits = serve(plain_plan.apply(step), "plain")
    if fa.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    for i, (a, b) in enumerate(zip(kernel_logits, plain_logits)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).sum().item()
        log(f"[serve] request {i}: max|kernel-plain|/max|plain| = "
            f"{rel:.3e} (tol {LOGITS_REL_TOL}), argmax agree {agree}/"
            f"{BATCH}")
        if rel > LOGITS_REL_TOL:
            raise AssertionError("kernel and plain logits disagree")

    small = dataclasses.replace(get_config("qwen2_05b").reduced(),
                                use_pallas=True)
    small_step = make_prefill_step(small)
    small_batch = {"tokens": torch.randint(0, small.vocab_size, (2, 64),
                                           generator=tgen, device="cuda",
                                           dtype=torch.int32)}
    small_sess = Session(small_step, (T.param_specs(small), {
        "tokens": torch.empty((2, 64), dtype=torch.int32, device="meta")}))
    small_plan = small_sess.partition(
        Request(mesh=MeshSpec(("data", "model"), (1, 1))))
    small_params = T.init_params(small, wgen)
    got = small_plan.apply(small_step)(small_params, small_batch)
    want = dataclasses.replace(
        small_plan, kernel_sites=[{**r, "impl": "ref"} for r in
                                  small_plan.kernel_sites]
    ).apply(small_step)(small_params, small_batch)
    torch.testing.assert_close(got, want, rtol=SMALL_TOL, atol=SMALL_TOL)
    log(f"[small] {small.name} f32 logits kernel vs plain: max|diff| "
        f"{(got - want).abs().max().item():.3e} (tol {SMALL_TOL}) ok")

    # -- 7: the kernel's time at the slice shape --------------------------
    q = torch.randn((BATCH, SEQ, H, hd), generator=gen, device="cuda",
                    dtype=bf16)
    k = torch.randn((BATCH, SEQ, H, hd), generator=gen, device="cuda",
                    dtype=bf16)
    v = torch.randn((BATCH, SEQ, H, hd), generator=gen, device="cuda",
                    dtype=bf16)
    n = fa.launches
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
    plain_ms = cuda_ms(lambda: fa.reference(q, k, v, causal=True), 10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True), 20)
    fa.launches = n
    # the work this run needs: the causal (k <= q) pairs, two products
    flops = 4.0 * BATCH * H * hd * SEQ * (SEQ + 1) / 2
    nbytes = 4.0 * BATCH * SEQ * H * hd * q.element_size()
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"[time] {card}: flash_attention {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB) -> {bound_ms / kernel_ms:.3%} of bound")

    log(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": launches, "max_abs_err": slice_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
