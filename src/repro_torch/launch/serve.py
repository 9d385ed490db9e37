"""Batched serving launcher: prefill through the decode step, then
greedy decode.

A batch of prompts is fed token by token through the decode step, which
fills the KV / recurrent caches, then decoded greedily from them, as the
reference's serving launcher does.  ``--plan toast`` plans the decode
step with TOAST first, through ``Session`` / ``Request`` with the
reference serving launcher's request: the cache pinned ``Replicate`` (the
classic serving layout: weights sharded, KV cache replicated per
data-parallel group), and runs the one-device plan with ``plan.apply``,
which on the card captures the decode step as one CUDA graph (the
prompt's steps and the generating steps share its signature) and
replays it for every token.

On a process group of two or more ranks (``torchrun``, or
:func:`repro_torch.launch.mesh.run_ranks`) ``--plan toast`` serves as
the reference's launcher does on a mesh: the decode step is planned for
the ``(data, model)`` mesh of ``(max(1, n // 2), min(2, n))`` devices,
and runs eagerly on DTensors under the plan's logical rules, whose
``constrain`` hooks place the activations; the parameters, the cache and
the prompts are replicated on the mesh, as the reference's jit receives
them unplaced.  Only rank 0 prints.

An encoder-decoder model (``whisper_small``) encodes the request's
frame embeddings once (``transformer.encode``; 16 frames drawn from the
seed, as the reference's launcher draws them) and hands the encoder's
output to every decode step.  On a mesh each rank encodes them before
anything is placed, as the reference's launcher encodes outside its
mesh context, and the encoder's output is replicated beside the cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_05b \\
        --reduced --batch 4 --prompt-len 16 --gen 16 --plan toast \\
        --device cpu

Without ``--device`` it runs on the CUDA card, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import MeshSpec
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as M
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_decode_step


def decode_request(cfg, names, mesh: MeshSpec):
    """The serving launcher's ``Request`` for the decode step on ``mesh``:
    greedy, ``min_dims=4``, the step's logical names, and the KV cache
    pinned replicated when the model has full attention blocks."""
    from repro_torch.api import Replicate, Request
    has_kv = "attn" in cfg.pattern and not cfg.is_encoder_decoder
    return Request(mesh=mesh, backend="greedy", min_dims=4,
                   logical_axes=names,
                   constraints=(Replicate("['k']"), Replicate("['v']"))
                   if has_kv else ())


def decode_session(cfg, batch: int, max_seq: int):
    """Trace and analyze the decode step on ``meta`` inputs.

    Returns:
        ``(session, names)``: the ``Session`` and the step's logical
        names (for :func:`decode_request`).
    """
    from repro_torch.api import Session
    from repro_torch.launch.specs import step_and_inputs
    fn, args, names = step_and_inputs(
        cfg, ShapeConfig("serve", max_seq, batch, "decode"))
    return Session(fn, args), names


def decode_plan(cfg, batch: int, max_seq: int, n_dev: int):
    """The decode step's plan for the launcher's mesh of ``n_dev``
    devices, ``(data, model)`` of ``(max(1, n_dev // 2), min(2, n_dev))``
    as the reference's, searched with :func:`decode_request`."""
    sess, names = decode_session(cfg, batch, max_seq)
    return sess.partition(decode_request(cfg, names, MeshSpec(
        ("data", "model"), (max(1, n_dev // 2), min(2, n_dev)))))


def toast_decode_rules(cfg, batch: int, max_seq: int, n_dev: int,
                       device=None):
    """The decode step's logical rules for ``n_dev`` devices.

    Args:
        cfg: model config (reduced or full).
        batch: decode batch size.
        max_seq: cache depth (prompt + generated tokens).
        n_dev: the number of devices the step runs on (the process
            group's size).
        device: the mesh's device type (``None``: the CUDA cards).

    Returns:
        ``(rules, mesh)``: ``({}, None)`` on one device, as the
        reference does (every placement is the same there); on two or
        more, the plan's logical rules (:func:`decode_plan`) and the
        ``DeviceMesh`` over the process group they apply on.
    """
    if n_dev < 2:
        return {}, None

    def search():
        plan = decode_plan(cfg, batch, max_seq, n_dev)
        M.print0(f"[toast] cost={plan.cost:.4f} rules={plan.logical_rules} "
                 f"search={plan.search_seconds:.1f}s")
        return dict(plan.logical_rules), plan.mesh
    # searched on rank 0, as the reference's one controller searches
    rules, spec = M.from_rank0(search)
    return rules, M.build_mesh(spec, device)


@dataclasses.dataclass
class ServeResult:
    """What :func:`serve_loop` returns.

    Attributes:
        tokens: (B, gen) int32 greedy tokens.
        prompt_logits: (B, 1, vocab) logits after the last prompt token.
        cache: the cache after the last step.
        prefill_ms: time of the prompt's decode steps, all together.
        step_ms: time of each generating decode step.
    """

    tokens: torch.Tensor
    prompt_logits: torch.Tensor
    cache: dict
    prefill_ms: float
    step_ms: list[float]


def serve_loop(decode, params, cache, prompts, gen: int,
               enc_out=None) -> ServeResult:
    """Prefill ``prompts`` token by token through ``decode``, then
    generate ``gen`` greedy tokens.

    The loop never waits on the device: positions are made on the device
    once, and each greedy token stays there.  On a CUDA device the times
    are CUDA-event times (on a mesh, this rank's card), else host times.
    On a mesh the prompts are DTensors; the positions are replicated
    beside them, and the tokens stay DTensors.

    Args:
        decode: ``decode(params, cache, token, pos[, enc_out]) ->
            (logits, cache)``.
        params: the parameter tree.
        cache: the empty cache (``transformer.init_cache``).
        prompts: (B, P) int32 prompt tokens.
        gen: the number of tokens to generate (at least 1).
        enc_out: an encoder-decoder model's encoder output, handed to
            every step (``None``: the step takes four arguments).

    Returns:
        The :class:`ServeResult`.
    """
    dev = prompts.device
    P = prompts.shape[1]
    positions = sharding.replicate_like(
        torch.arange(P + gen, dtype=torch.int32, device=dev), prompts)
    cuda = dev.type == "cuda"

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(a, b) -> float:
        return a.elapsed_time(b) if cuda else (b - a) * 1e3

    extra = () if enc_out is None else (enc_out,)
    t0 = mark()
    logits = None
    for t in range(P):
        logits, cache = decode(params, cache, prompts[:, t:t + 1],
                               positions[t], *extra)
    t1 = mark()
    prompt_logits = logits
    tokens = [logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)]
    marks = [t1]
    for g in range(gen - 1):
        logits, cache = decode(params, cache, tokens[-1], positions[P + g],
                               *extra)
        tokens.append(logits[:, 0].argmax(-1, keepdim=True).to(torch.int32))
        marks.append(mark())
    if cuda:
        torch.cuda.synchronize(dev)
    return ServeResult(
        tokens=torch.cat(tokens, 1), prompt_logits=prompt_logits,
        cache=cache, prefill_ms=ms(t0, t1),
        step_ms=[ms(a, b) for a, b in zip(marks, marks[1:])])


def serve_replicated(decode, params, cache, prompts, gen: int, rules,
                     mesh, enc_out=None) -> ServeResult:
    """The launcher's route on a mesh: :func:`serve_loop` on the
    parameters, the cache, the prompts and an encoder-decoder model's
    ``enc_out`` replicated on ``mesh``, as the reference's jit receives
    them unplaced, under ``rules`` (the decode plan's logical rules,
    whose ``constrain`` hooks place the activations).

    The replicas are the tensors themselves, not copies: nothing is
    donated or written in place, and a full-width MoE model held twice
    on one card (two ranks sharing it) would not fit.

    Returns:
        The :class:`ServeResult` (its tensors DTensors).
    """
    from torch.distributed.tensor import DTensor, Replicate
    params, cache, prompts, enc_out = pytree.tree_map(
        lambda x: DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False),
        (params, cache, prompts, enc_out))
    with M.mesh_context(mesh), sharding.logical_rules(rules or None):
        return serve_loop(decode, params, cache, prompts, gen, enc_out)


def parse_args(argv=None) -> argparse.Namespace:
    """The reference serving launcher's command line, with ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_05b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--plan", choices=["manual", "toast"],
                    default="manual")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    serve(parse_args(argv))


def serve(args, cfg=None) -> ServeResult:
    """Serve one batch of seeded prompts as :func:`main` does.

    Args:
        args: the command line (:func:`parse_args`).
        cfg: the model configuration (``None``: ``--arch``'s, reduced
            under ``--reduced``).

    Returns:
        The :class:`ServeResult` (on a mesh its tensors are DTensors).
    """
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    n_dev = M.init_from_env()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    max_seq = P + G
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev, dtype=torch.int32)
    cache = T.init_cache(cfg, B, max_seq, device=dev)
    enc_out = None
    if cfg.is_encoder_decoder:
        frames = torch.randn((B, 16, cfg.d_model), generator=gen,
                             device=dev)
        enc_out = T.encode(cfg, params, frames)

    dec = make_decode_step(cfg)
    rules, mesh = {}, None
    if args.plan == "toast":
        rules, mesh = toast_decode_rules(cfg, B, max_seq, n_dev, dev)
        if mesh is None:
            sess, names = decode_session(cfg, B, max_seq)
            plan = sess.partition(decode_request(
                cfg, names, MeshSpec(("data", "model"), (1, 1))))
            M.print0(f"[toast] cost={plan.cost:.4f} "
                     f"rules={plan.logical_rules} "
                     f"search={plan.search_seconds:.1f}s")
            dec = plan.apply(dec, device=dev)
    if mesh is not None:
        res = serve_replicated(dec, params, cache, prompts, G, rules, mesh,
                               enc_out)
    else:
        res = serve_loop(dec, params, cache, prompts, G, enc_out)
    tokens = res.tokens.full_tensor() if mesh is not None else res.tokens
    out = tokens.cpu().numpy()
    per_token = sum(res.step_ms) / max(len(res.step_ms), 1)
    M.print0(f"prefill: {res.prefill_ms:.1f}ms  decode: {per_token:.2f}"
             f"ms/token")
    if args.plan == "toast" and mesh is None:
        M.print0(f"[toast] captures={dec.captures} replays={dec.replays} "
                 f"({'CUDA graph' if dec.capture else 'eager'})")
    elif mesh is not None:
        M.print0(f"[toast] {'x'.join(map(str, mesh.shape))} mesh of "
                 f"{n_dev} ranks, eager on DTensors")
    for b in range(B):
        M.print0(f"request {b}: prompt={prompts[b].cpu().numpy()[:8]}... "
                 f"generated={out[b][:12]}...")
    return res


if __name__ == "__main__":
    main()
