"""End-to-end training launcher with fault tolerance, the port of the
reference's ``launch/train.py``.

Runs a (reduced or full) config on one device or on a mesh of ranks,
with:

- on one device, the train step compiled with its state donated, as the
  reference's ``jax.jit(train_step, donate_argnums=0)``: ``--plan toast``
  plans the step with TOAST first (the reference launcher's request) and
  runs ``plan.apply(train_step, donate_argnums=0)``; ``--plan manual``
  runs ``repro_torch.jit.jit(train_step, donate_argnums=0)``.  On the
  card each attempt captures the step as one CUDA graph that writes the
  new state into the old state's buffers;
- on a mesh of two or more ranks (one process per device in a process
  group: ``torchrun`` or :func:`repro_torch.launch.mesh.run_ranks`), the
  reference's rules route: the mesh is ``(data, model)`` sized
  ``(max(1, n // 2), min(2, n))``; ``--plan toast`` searches the plan
  and takes ``plan.logical_rules or MANUAL_RULES``, ``--plan manual``
  takes ``MANUAL_RULES``; the state is placed by ``specs_from_rules`` on
  its logical names, and the step runs eagerly on DTensors, donated, under
  ``mesh_context`` and ``logical_rules``, whose ``constrain`` hooks place
  the activations.  The reference hands jit the batch unplaced and lets
  GSPMD place it; the port places it by ``specs_from_rules`` on the
  batch's logical names (every rank draws the same global batch and keeps
  its block).  No plan dispatch is installed, as in the reference, so a
  fused kernel site runs on whole inputs (``kernels.ops``);
- the deterministic data pipeline with prefetch (``data/pipeline.py``),
  its numpy batches moved to the device each step;
- periodic async checkpointing and resume from the latest checkpoint
  on start (``ckpt/checkpoint.py``, the reference's files; on a mesh
  saved from the shards and restored onto them);
- a supervisor loop (``--max-failures``) that restarts the training loop
  after a failure (``--fail-at`` injects one on the first attempt, at
  the same step on every rank): the restart builds the mesh and the step
  anew, restores the latest checkpoint and continues from its step.  A
  failed attempt's graph and its memory pool are freed, and its
  in-flight checkpoint write is committed, before the next attempt
  starts.  On a mesh any other failure ends the rank with its traceback
  (one rank cannot restart alone while the others wait in a collective),
  which ends the group.

Example (CPU, reduced config; two ranks)::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen2_05b --reduced --steps 30 --batch 8 --seq 64 \\
        --plan toast --device cpu

Without ``--device`` it runs on the CUDA card (each rank on card
``LOCAL_RANK % device_count``), and raises without one.  Every model
family trains on one device and on meshes alike: the MoE configs
(``mixtral_8x22b``, ``arctic_480b``) with their expert stacks placed by
the rules' ``"experts"`` entry; the encoder-decoder and frontend models
(``whisper_small``, ``phi3_vision``) with the batch's ``frames`` and
``patch_embeds`` placed by the rules as the tokens are; ``xlstm_350m``
with each sLSTM's time loop run per shard
(``sharding.scan_per_shard``).  Only rank 0 prints.
``--compress`` is parsed and unused, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any

import torch

from repro_torch import pytree
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cost_model import MeshSpec
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.jit import jit
from repro_torch.launch import mesh as M
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     train_state_specs)


class InjectedFailure(RuntimeError):
    """The failure ``--fail-at`` injects (at the same step on every
    rank)."""


def mesh_for(n_dev: int) -> MeshSpec:
    """The launcher's mesh for ``n_dev`` devices, as the reference's:
    ``(data, model)`` of ``(max(1, n_dev // 2), min(2, n_dev))``."""
    return MeshSpec(("data", "model"), (max(1, n_dev // 2), min(2, n_dev)))


def toast_plan(cfg: ModelConfig, shape: ShapeConfig, mesh_spec: MeshSpec):
    """Plan the train step with the reference launcher's request: the
    step traced on ``meta`` inputs, MCTS for 6 rounds, ``min_dims=4``
    and the state's and batch's logical names."""
    from repro_torch.api import Request, Session
    from repro_torch.core.mcts import MCTSConfig
    from repro_torch.launch.specs import step_and_inputs
    fn, args, names = step_and_inputs(cfg, shape)
    sess = Session(fn, args)
    return sess.partition(Request(mesh=mesh_spec, backend="mcts",
                                  search_config=MCTSConfig(rounds=6),
                                  min_dims=4, logical_axes=names))


@dataclasses.dataclass
class Attempt:
    """What one attempt of :func:`run_once` did (on a mesh, on this
    rank).

    Attributes:
        attempt: its index (0 first).
        start_step: the step it resumed from (0 without a checkpoint).
        restore_s: seconds to restore the checkpoint (``None``: none).
        state_bytes: bytes of the train state (on a mesh: this rank's
            shards).
        captures: CUDA graphs it captured (0 when eager).
        replays: graph replays, one per step it ran (0 when eager).
        rules: the logical rules on a mesh (``None`` on one device).
        mesh: the mesh's sizes (``None`` on one device).
        step_ms: host ms of each step it ran, the device synchronized.
        losses: each step's loss and grad norm.
        collectives: on a mesh, the collectives its steps issued on this
            rank (``launch.mesh.collective_tally``): ``calls``, ``bytes``
            (of their results) and host ``seconds``, each by kind.
        saves: its checkpoint writes (``CheckpointManager.saves``).
        injected: whether ``--fail-at`` ended it.
        error: the failure that ended it, if any.
        state: the final train state, when the attempt completed.
    """

    attempt: int
    start_step: int = 0
    restore_s: float | None = None
    state_bytes: int = 0
    captures: int = 0
    replays: int = 0
    rules: dict | None = None
    mesh: tuple | None = None
    step_ms: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    collectives: dict = dataclasses.field(default_factory=dict)
    saves: list = dataclasses.field(default_factory=list)
    injected: bool = False
    error: str | None = None
    state: Any = None


def mesh_rules(cfg: ModelConfig, shape: ShapeConfig, mesh_spec: MeshSpec,
               plan: str) -> dict:
    """The logical rules of the launcher on a mesh, as the reference's:
    ``--plan toast`` searches (:func:`toast_plan`, on rank 0, the rules
    sent to every rank) and takes ``plan.logical_rules or MANUAL_RULES``;
    ``--plan manual`` takes ``MANUAL_RULES``."""
    from repro_torch.models.sharding import MANUAL_RULES
    if plan != "toast":
        return dict(MANUAL_RULES)

    def search():
        p = toast_plan(cfg, shape, mesh_spec)
        rules = p.logical_rules or dict(MANUAL_RULES)
        M.print0(f"[toast] cost={p.cost:.4f} rules={rules} "
                 f"search={p.search_seconds:.1f}s")
        return rules
    return M.from_rank0(search)


def _scalar(x) -> float:
    from repro_torch.models.sharding import is_dtensor
    return (x.full_tensor() if is_dtensor(x) else x).item()


def _placed_as(tree, like):
    """``tree``'s DTensor leaves redistributed to the placements of
    ``like``'s leaves (the new state placed as the old, so that it
    takes the old one's buffers)."""
    return pytree.unflatten(tree, [
        x if tuple(x.placements) == tuple(o.placements)
        else x.redistribute(o.device_mesh, o.placements)
        for x, o in zip(pytree.tree_leaves(tree), pytree.tree_leaves(like))])


def run_once(cfg: ModelConfig, args, attempt: int, report: Attempt) -> bool:
    """One attempt: build the step, resume, train to ``args.steps``.

    On a process group of two or more ranks every rank runs it alike,
    on its shards of the state (see the module docstring).

    Args:
        cfg: the model configuration.
        args: the parsed command line (:func:`parse_args`).
        attempt: the attempt's index (``--fail-at`` fails attempt 0).
        report: the attempt's record, filled in as it runs.

    Returns:
        True when every step ran and the last checkpoint is committed.

    Raises:
        RuntimeError: the injected failure, or any failure of a step.
    """
    from contextlib import nullcontext

    from repro_torch.launch.specs import (batch_specs, shardings_from_rules,
                                          state_logical_axes)
    from repro_torch.models.sharding import logical_rules
    dev = resolve_device(args.device)
    n_dev = M.group_size()
    mesh_spec = mesh_for(n_dev)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    train_step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    mesh = None
    if n_dev >= 2:
        mesh = M.build_mesh(mesh_spec, dev)
        rules = mesh_rules(cfg, shape, mesh_spec, args.plan)
        report.rules, report.mesh = rules, tuple(mesh.shape)
        like = train_state_specs(cfg)
        state_sh = shardings_from_rules(
            like, state_logical_axes(cfg, like), rules, mesh)
        batch_sh = shardings_from_rules(*batch_specs(cfg, shape), rules, mesh)

        def placed_step(state, batch):
            new, metrics = train_step(state, batch)
            return _placed_as(new, state), metrics

        step = jit(placed_step, dev, capture=False, donate_argnums=0)
        context = (M.mesh_context(mesh), logical_rules(rules))
    else:
        if args.plan == "toast":
            plan = toast_plan(cfg, shape, mesh_spec)
            M.print0(f"[toast] cost={plan.cost:.4f} "
                     f"rules={plan.logical_rules} "
                     f"search={plan.search_seconds:.1f}s")
            step = plan.apply(train_step, device=dev, donate_argnums=0)
        else:
            step = jit(train_step, dev, donate_argnums=0)
        context = (nullcontext(), nullcontext())
    start_step = 0
    if ckpt.latest_step() is None:
        state = init_train_state(cfg, gen, device=dev)
        if mesh is not None:
            state = pytree.unflatten(state, [
                M.distribute(x, sh) for x, sh in zip(
                    pytree.tree_leaves(state), pytree.tree_leaves(state_sh))])
    else:
        t0 = time.perf_counter()
        if mesh is None:
            state = init_train_state(cfg, gen, device=dev)
            start_step, state = ckpt.restore(state)
        else:
            # into meta leaves: no rank holds the whole state on the card
            start_step, state = ckpt.restore(like, shardings=state_sh)
        report.restore_s = time.perf_counter() - t0
    report.state_bytes = sum(
        (x.to_local() if mesh is not None else x).numel() * x.element_size()
        for x in pytree.tree_leaves(state))
    if report.restore_s is not None:
        M.print0(f"[resume] from step {start_step} "
                 f"({report.state_bytes / 1e9:.3f} GB in "
                 f"{report.restore_s:.3f} s)")
    report.start_step = start_step
    pipe = Pipeline(cfg, shape, DataConfig(seed=args.seed),
                    start_step=start_step)
    tally = M.collective_tally() if mesh is not None else None
    t0 = time.perf_counter()
    try:
        with context[0], context[1]:
            for i in range(start_step, args.steps):
                _, batch = next(pipe)
                if args.fail_at is not None and i == args.fail_at and \
                        attempt == 0:
                    report.injected = True
                    raise RuntimeError("injected node failure")
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
                if mesh is not None:
                    batch = {k: M.distribute(v, batch_sh[k])
                             for k, v in batch.items()}
                s0 = time.perf_counter()
                with tally or nullcontext():
                    state, metrics = step(state, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                report.step_ms.append((time.perf_counter() - s0) * 1e3)
                report.losses.append((_scalar(metrics["loss"]),
                                      _scalar(metrics["grad_norm"])))
                if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                    ckpt.save_async(i + 1, state)
                if (i + 1) % args.log_every == 0:
                    dt = (time.perf_counter() - t0) / args.log_every
                    t0 = time.perf_counter()
                    loss, gnorm = report.losses[-1]
                    M.print0(f"step {i+1}: loss={loss:.4f} gnorm={gnorm:.3f} "
                             f"{dt*1e3:.0f}ms/step")
        ckpt.wait()
        report.state = state
        return True
    finally:
        pipe.close()
        if tally is not None:
            report.collectives = {"calls": dict(tally.calls),
                                  "bytes": dict(tally.bytes),
                                  "seconds": dict(tally.seconds)}
        report.captures, report.replays = step.captures, step.replays
        step.release()
        state = None
        # the restart must find this attempt's last checkpoint committed;
        # on a mesh only an injected failure brings every rank here
        ckpt.wait(sync=report.injected)
        report.saves = list(ckpt.saves)
        if M.group_rank() == 0:
            for s in report.saves:
                snap = "" if s["snapshot_s"] is None else \
                    f"host copy {s['snapshot_s']:.3f} s, "
                print(f"[ckpt] step {s['step']}: {s['bytes'] / 1e9:.3f} GB, "
                      f"{snap}written in {s['write_s']:.3f} s", flush=True)


def supervise(cfg: ModelConfig, args) -> list[Attempt]:
    """Run attempts until one completes, at most ``args.max_failures``
    restarts.

    On a mesh only the injected failure restarts (every rank raises it
    at the same step); any other failure is raised, ending the rank.

    Returns:
        Every attempt's :class:`Attempt`, the completed one last.

    Raises:
        RuntimeError: without the device asked for (no restart can help);
            on a mesh, a failure other than the injected one.
        SystemExit: when every attempt failed.
    """
    resolve_device(args.device)
    attempts = []
    for attempt in range(args.max_failures + 1):
        report = Attempt(attempt)
        attempts.append(report)
        try:
            if run_once(cfg, args, attempt, report):
                M.print0("training complete")
                return attempts
        except RuntimeError as e:
            report.error = f"{type(e).__name__}: {e}"
            if M.group_size() > 1 and not report.injected:
                raise
            M.print0(f"[supervisor] attempt {attempt} failed: {e}; restarting")
    raise SystemExit("exceeded max failures")


def parse_args(argv=None) -> argparse.Namespace:
    """The reference launcher's command line, with ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_05b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--plan", choices=["manual", "toast"], default="manual")
    ap.add_argument("--compress", default="none",
                    help="parsed and unused, as in the reference")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (first attempt)")
    ap.add_argument("--max-failures", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    M.init_from_env()
    supervise(cfg, args)


if __name__ == "__main__":
    main()
