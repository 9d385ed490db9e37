"""Profiles the train step on one CUDA card: where a step's time goes.

The full-width ``qwen2_05b`` (or ``--arch recurrentgemma_2b``) with its
fused sites on the CUDA kernels, weights from a seed, at the train
phase's shape and optimizer (``qwen2_05b``: B 4 x S 2048, the prefill
path's shape; ``recurrentgemma_2b``: B 1 x S 4096, twice its local
window, with bf16 moments), the config's remat.  Times (host clock around
work that ends in a synchronize) the parts of a step apart — the loss's
forward alone, the forward and backward (``value_and_grad``), the AdamW
update, and within the backward one backward of each fused kernel the
model runs (the plain vjp: attention, RG-LRU) and the loss head (the f32
cross-entropy over the logits, forward and backward) — and ``--steps``
whole steps; then profiles one step under
``torch.profiler``: the aten ops dispatched
from Python, the work items the card ran, the card's busy time (the
union of their intervals) and idle share, and the heaviest device
kernels.  Writes the numbers as JSON.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        [--arch qwen2_05b] [--steps 4] [--out FILE]

``--device cpu --reduced`` runs it on the CPU at a small size, where no
device number is taken.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.profile_decode import _busy_us, _device_us
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
from repro_torch.optim import adam
from repro_torch.train import steps as TS

OPT = adam.AdamConfig(lr=1e-3, warmup_steps=2, total_steps=8)
# per model: batch x tokens and the optimizer of its train phase
TRAIN = {
    "qwen2_05b": ((4, 2048), OPT),
    "recurrentgemma_2b": ((1, 4096), dataclasses.replace(
        OPT, state_dtype="bfloat16")),
}


def _timed(fn, dev, n: int = 1) -> float:
    """Milliseconds per call of ``fn`` over ``n`` calls, after one more."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / n


def profile(arch: str, reduced: bool, steps: int, dev) -> dict:
    """Time and profile the train step of one model; returns the numbers."""
    from torch.profiler import ProfilerActivity
    cfg = get_config(arch)
    (b, s), opt = TRAIN.get(arch, TRAIN["qwen2_05b"])
    if reduced:
        cfg, b, s = cfg.reduced(), 2, 64
    cfg = dataclasses.replace(cfg, use_pallas=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = TS.init_train_state(cfg, gen, opt, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    loss_fn = TS.make_loss_fn(cfg)
    grads_fn = TS.value_and_grad(loss_fn, remat=cfg.remat)
    step = TS.make_train_step(cfg, opt)
    cuda = dev.type == "cuda"
    # each fused kernel's backward sites per step: one per forward site
    sites = {k: T.n_scan_blocks(cfg) * p + t
             for k, (p, t) in T.kernel_sites(cfg).items()}
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        with torch.no_grad():
            forward_ms = _timed(lambda: loss_fn(state.params, batch), dev)
        grads = grads_fn(state.params, batch)[2]
        fwd_bwd_ms = _timed(lambda: grads_fn(state.params, batch), dev)
        adam_ms = _timed(lambda: adam.apply_updates(
            opt, state.opt, state.params, grads), dev)
        del grads
        # one backward of each fused kernel at the layer's shape
        bwd_ms = {}
        if sites["flash_attention"]:
            H, hd = cfg.num_heads, cfg.resolved_head_dim
            q, k, v, do = (torch.randn((b, s, H, hd), generator=gen,
                                       device=dev, dtype=cfg.dtype)
                           for _ in range(4))
            bwd_ms["flash_attention"] = _timed(
                lambda: torch.ops.repro_torch.flash_attention_bwd(
                    q, k, v, do, True), dev, 3)
            del q, k, v, do
        if sites["rg_lru"]:
            a, x, dh = (torch.rand((b, s, L.rnn_width(cfg)), generator=gen,
                                   device=dev) for _ in range(3))
            bwd_ms["rg_lru"] = _timed(
                lambda: torch.ops.repro_torch.rg_lru_bwd(a, x, dh), dev, 3)
            del a, x, dh
        # the loss head
        logits = torch.randn((b, s, cfg.vocab_size), generator=gen,
                             device=dev, dtype=cfg.dtype).requires_grad_()

        def head():
            loss, _ = TS.cross_entropy(logits, batch["targets"])
            torch.autograd.grad(loss, logits)

        head_ms = _timed(head, dev, 3)
        del logits
        step_ms = _timed(lambda: step(state, batch), dev, steps)
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            if cuda:
                torch.cuda.synchronize(dev)
            prof_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    top_ops = [e for e in events if e.name.startswith("aten::") and
               (e.cpu_parent is None or
                not e.cpu_parent.name.startswith("aten::"))]
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {
        "arch": cfg.name, "device": (torch.cuda.get_device_name(dev)
                                     if cuda else "cpu"),
        "batch": b, "seq": s, "remat": cfg.remat, "steps": steps,
        "forward_ms": forward_ms, "forward_backward_ms": fwd_bwd_ms,
        "adamw_ms": adam_ms, "backward_ms": bwd_ms,
        "backward_sites": {k: n for k, n in sites.items() if n},
        "loss_head_ms": head_ms,
        "step_ms": step_ms,
        "profiled_step_ms": prof_ms, "aten_ops": len(top_ops),
        "device_items": len(dev_events),
        "device_busy_ms": None, "device_idle_share": None,
    }
    if dev_events:
        busy = _busy_us((e.time_range.start, e.time_range.end)
                        for e in dev_events) / 1e3
        out["device_busy_ms"] = busy
        out["device_idle_share"] = 1 - busy / prof_ms
    avgs = prof.key_averages()
    out["device_kernels"] = [
        {"name": a.key[:80], "calls": a.count, "ms": _device_us(a) / 1e3}
        for a in sorted(avgs, key=lambda a: -_device_us(a))[:12]
        if _device_us(a) > 0]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_05b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    ap.add_argument("--out", default="results/train_profile.json")
    args = ap.parse_args(argv)
    # read by the CUDA allocator at its first use: segments that grow in
    # place keep the hybrid's step (two train states, its gradients and
    # AdamW's f32 temporaries at once) from fragmenting the card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = resolve_device(args.device)
    r = profile(args.arch, args.reduced, args.steps, dev)
    busy = r["device_busy_ms"]
    dev_txt = "not measured" if busy is None else \
        f"{busy:.3f} ms busy, idle share {r['device_idle_share']:.3f}"
    print(f"[profile] {r['device']}: {r['arch']} train B={r['batch']} "
          f"S={r['seq']} remat={r['remat']}: step {r['step_ms']:.3f} ms "
          f"({r['profiled_step_ms']:.3f} profiled) = forward+backward "
          f"{r['forward_backward_ms']:.3f} ms (forward alone "
          f"{r['forward_ms']:.3f}) + AdamW {r['adamw_ms']:.3f} ms; "
          f"{r['aten_ops']} aten ops, {r['device_items']} device items, "
          f"device {dev_txt}", flush=True)
    within = ", ".join(f"{n} {k} backwards (plain vjp) x "
                       f"{r['backward_ms'][k]:.3f} ms"
                       for k, n in r["backward_sites"].items())
    print(f"[profile]   within: {within}, loss head forward+backward "
          f"{r['loss_head_ms']:.3f} ms")
    for k in r["device_kernels"]:
        print(f"[profile]   device {k['name']}: {k['calls']} calls, "
              f"{k['ms']:.3f} ms")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(r, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
