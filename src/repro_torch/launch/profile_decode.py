"""Profiles the decode step on one CUDA card: where a token's time goes.

For each model: weights from a seed, B = 4, a cache of 256 slots; 64
prompt tokens go through the decode step unprofiled, then ``--steps``
greedy decode steps run once timed with CUDA events and once under
``torch.profiler``.  Prints per token: the wall time, the aten ops
dispatched from Python, the work items the card ran (kernels, copies,
fills), the card's busy time (the union of their intervals) and its idle
share, and the heaviest host ops and device kernels; writes the numbers
as JSON.  ``--capture`` profiles each model a second time through the
decode step's one-device TOAST plan applied with capture (as
``launch/serve.py --plan toast`` serves it): one CUDA graph, replayed
for every token, beside the eager numbers.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        [--archs qwen2_05b recurrentgemma_2b] [--capture] [--out FILE]

``--device cpu --reduced`` runs it on the CPU at a small size, where no
device number is taken.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.core.cost_model import MeshSpec
from repro_torch.launch.serve import (decode_request, decode_session,
                                      serve_loop)
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_decode_step

B, MAX_SEQ, PROMPT = 4, 256, 64


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _device_us(avg) -> float:
    return getattr(avg, "self_device_time_total",
                   getattr(avg, "self_cuda_time_total", 0.0))


def profile(arch: str, reduced: bool, steps: int, dev,
            capture: bool = False) -> dict:
    """Profile ``steps`` decode steps of one model; returns the numbers.

    With ``capture`` the step runs through its one-device plan applied
    with capture (a CUDA graph, replayed), else eagerly.
    """
    from torch.profiler import ProfilerActivity
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                            device=dev, dtype=torch.int32)
    dec = make_decode_step(cfg)
    if capture:
        sess, names = decode_session(cfg, B, MAX_SEQ)
        plan = sess.partition(decode_request(
            cfg, names, MeshSpec(("data", "model"), (1, 1))))
        dec = plan.apply(dec, device=dev, capture=True)
    res = serve_loop(dec, params, T.init_cache(cfg, B, MAX_SEQ, device=dev),
                     prompts, 2)
    cache, pos0 = res.cache, PROMPT + 1
    token = res.tokens[:, -1:]
    positions = torch.arange(MAX_SEQ, dtype=torch.int32, device=dev)
    cuda = dev.type == "cuda"

    def run(n, c, tok):
        for t in range(n):
            logits, c = dec(params, c, tok, positions[pos0 + t])
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        return c, tok

    # timed without the profiler (the cache is functional: rerunnable)
    run(2, cache, token)
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run(steps, cache, token)
    if cuda:
        torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(steps, cache, token)
        if cuda:
            torch.cuda.synchronize(dev)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.events()
    top_ops = [e for e in events if e.name.startswith("aten::") and
               (e.cpu_parent is None or
                not e.cpu_parent.name.startswith("aten::"))]
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {
        "arch": cfg.name, "device": (torch.cuda.get_device_name(dev)
                                     if cuda else "cpu"),
        "mode": "captured" if capture else "eager",
        "captures": dec.captures if capture else 0,
        "capture_seconds": (dec.graphs[0].seconds if capture else None),
        "batch": B, "cache": MAX_SEQ, "steps": steps,
        "wall_ms_per_token": wall_ms,
        "profiled_wall_ms_per_token": prof_wall_ms,
        "aten_ops_per_token": len(top_ops) / steps,
        "device_items_per_token": len(dev_events) / steps,
        "device_busy_ms_per_token": None, "device_idle_share": None,
    }
    if dev_events:
        busy = _busy_us((e.time_range.start, e.time_range.end)
                        for e in dev_events) / 1e3 / steps
        out["device_busy_ms_per_token"] = busy
        out["device_idle_share"] = 1 - busy / prof_wall_ms
    avgs = prof.key_averages()
    out["host_ops"] = [
        {"name": a.key, "calls_per_token": a.count / steps,
         "self_cpu_ms_per_token": a.self_cpu_time_total / 1e3 / steps}
        for a in sorted(avgs, key=lambda a: -a.self_cpu_time_total)[:10]]
    out["device_kernels"] = [
        {"name": a.key[:80], "calls_per_token": a.count / steps,
         "ms_per_token": _device_us(a) / 1e3 / steps}
        for a in sorted(avgs, key=lambda a: -_device_us(a))[:8]
        if _device_us(a) > 0]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+",
                    default=["qwen2_05b", "recurrentgemma_2b"])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--capture", action="store_true",
                    help="also profile the decode step captured as a CUDA "
                         "graph (needs the card)")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    ap.add_argument("--out", default="results/decode_profile.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    modes = [False, True] if args.capture else [False]
    for arch, capture in ((a, c) for a in args.archs for c in modes):
        r = profile(arch, args.reduced, args.steps, dev, capture)
        rows.append(r)
        busy = r["device_busy_ms_per_token"]
        dev_txt = "not measured" if busy is None else \
            f"{busy:.3f} ms busy, idle share {r['device_idle_share']:.3f}"
        print(f"[profile] {r['device']}: {r['arch']} {r['mode']} B={B} "
              f"cache={MAX_SEQ}: "
              f"{r['wall_ms_per_token']:.3f} ms per token "
              f"({r['profiled_wall_ms_per_token']:.3f} profiled), "
              f"{r['aten_ops_per_token']:.0f} aten ops and "
              f"{r['device_items_per_token']:.0f} device items per token, "
              f"device {dev_txt}", flush=True)
        if capture:
            print(f"[profile]   {r['captures']} capture in "
                  f"{r['capture_seconds']:.3f} s, replayed for every token")
        for h in r["host_ops"][:6]:
            print(f"[profile]   host {h['name']}: {h['calls_per_token']:.0f}"
                  f" calls, {h['self_cpu_ms_per_token']:.3f} ms per token")
        for k in r["device_kernels"][:5]:
            print(f"[profile]   device {k['name']}: "
                  f"{k['calls_per_token']:.0f} calls, "
                  f"{k['ms_per_token']:.4f} ms per token")
        del r
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
