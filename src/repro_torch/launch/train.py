"""End-to-end training launcher with fault tolerance, the port of the
reference's ``launch/train.py``.

Runs a (reduced or full) config on one device, with:

- the train step compiled with its state donated, as the reference's
  ``jax.jit(train_step, donate_argnums=0)``: ``--plan toast`` plans the
  step with TOAST first (the reference launcher's request) and runs
  ``plan.apply(train_step, donate_argnums=0)``; ``--plan manual`` runs
  ``repro_torch.jit.jit(train_step, donate_argnums=0)``.  On the card
  each attempt captures the step as one CUDA graph that writes the new
  state into the old state's buffers;
- the deterministic data pipeline with prefetch (``data/pipeline.py``),
  its numpy batches moved to the device each step;
- periodic async checkpointing and resume from the latest checkpoint
  on start (``ckpt/checkpoint.py``, the reference's files);
- a supervisor loop (``--max-failures``) that restarts the training loop
  after a failure (``--fail-at`` injects one on the first attempt): the
  restart builds the step anew, restores the latest checkpoint and
  continues from its step.  A failed attempt's graph and its memory pool
  are freed, and its in-flight checkpoint write is committed, before the
  next attempt starts.

Example (CPU, reduced config)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_05b \\
        --reduced --steps 30 --batch 8 --seq 64 --plan toast --device cpu

Without ``--device`` it runs on the CUDA card, and raises without one.
With two or more cards it raises: the multi-device launchers are ROADMAP
queue 1, item 8b.  ``--compress`` is parsed and unused, as in the reference.
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
from repro_torch.train.steps import init_train_state, make_train_step


def mesh_for(n_dev: int) -> MeshSpec:
    """The launcher's mesh for ``n_dev`` devices.

    Args:
        n_dev: the number of devices the launcher sees.

    Returns:
        The 1x1 ``("data", "model")`` mesh on one device.

    Raises:
        NotImplementedError: on two or more devices; the sharded train
            launcher is ROADMAP queue 1, item 8b.
    """
    if n_dev < 2:
        return MeshSpec(("data", "model"), (1, 1))
    raise NotImplementedError(
        f"training on {n_dev} devices needs the multi-device launcher, "
        f"which is not ported yet (ROADMAP queue 1, item 8b)")


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
    """What one attempt of :func:`run_once` did.

    Attributes:
        attempt: its index (0 first).
        start_step: the step it resumed from (0 without a checkpoint).
        restore_s: seconds to restore the checkpoint (``None``: none).
        state_bytes: bytes of the train state.
        captures: CUDA graphs it captured (0 when eager).
        replays: graph replays, one per step it ran (0 when eager).
        saves: its checkpoint writes (``CheckpointManager.saves``).
        error: the failure that ended it, if any.
        state: the final train state, when the attempt completed.
    """

    attempt: int
    start_step: int = 0
    restore_s: float | None = None
    state_bytes: int = 0
    captures: int = 0
    replays: int = 0
    saves: list = dataclasses.field(default_factory=list)
    error: str | None = None
    state: Any = None


def run_once(cfg: ModelConfig, args, attempt: int, report: Attempt) -> bool:
    """One attempt: build the step, resume, train to ``args.steps``.

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
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh_spec = mesh_for(n_dev)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    train_step = make_train_step(cfg)
    if args.plan == "toast":
        plan = toast_plan(cfg, shape, mesh_spec)
        print(f"[toast] cost={plan.cost:.4f} rules={plan.logical_rules} "
              f"search={plan.search_seconds:.1f}s", flush=True)
        step = plan.apply(train_step, device=dev, donate_argnums=0)
    else:
        step = jit(train_step, dev, donate_argnums=0)
    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    report.state_bytes = sum(x.numel() * x.element_size()
                             for x in pytree.tree_leaves(state))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    start_step = 0
    if ckpt.latest_step() is not None:
        t0 = time.perf_counter()
        start_step, state = ckpt.restore(state)
        report.restore_s = time.perf_counter() - t0
        print(f"[resume] from step {start_step} "
              f"({report.state_bytes / 1e9:.3f} GB in "
              f"{report.restore_s:.3f} s)", flush=True)
    report.start_step = start_step
    pipe = Pipeline(cfg, shape, DataConfig(seed=args.seed),
                    start_step=start_step)
    t0 = time.perf_counter()
    try:
        for i in range(start_step, args.steps):
            _, batch = next(pipe)
            if args.fail_at is not None and i == args.fail_at and \
                    attempt == 0:
                raise RuntimeError("injected node failure")
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            state, metrics = step(state, batch)
            if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                ckpt.save_async(i + 1, state)
            if (i + 1) % args.log_every == 0:
                dt = (time.perf_counter() - t0) / args.log_every
                t0 = time.perf_counter()
                print(f"step {i+1}: loss={metrics['loss'].item():.4f} "
                      f"gnorm={metrics['grad_norm'].item():.3f} "
                      f"{dt*1e3:.0f}ms/step", flush=True)
        ckpt.wait()
        report.state = state
        return True
    finally:
        pipe.close()
        report.captures, report.replays = step.captures, step.replays
        step.release()
        state = None
        # the restart must find this attempt's last checkpoint committed
        ckpt.wait()
        report.saves = list(ckpt.saves)
        for s in report.saves:
            snap = "" if s["snapshot_s"] is None else \
                f"host copy {s['snapshot_s']:.3f} s, "
            print(f"[ckpt] step {s['step']}: {s['bytes'] / 1e9:.3f} GB, "
                  f"{snap}written in {s['write_s']:.3f} s", flush=True)


def supervise(cfg: ModelConfig, args) -> list[Attempt]:
    """Run attempts until one completes, at most ``args.max_failures``
    restarts.

    Returns:
        Every attempt's :class:`Attempt`, the completed one last.

    Raises:
        RuntimeError: without the device asked for (no restart can help).
        SystemExit: when every attempt failed.
    """
    resolve_device(args.device)
    attempts = []
    for attempt in range(args.max_failures + 1):
        report = Attempt(attempt)
        attempts.append(report)
        try:
            if run_once(cfg, args, attempt, report):
                print("training complete", flush=True)
                return attempts
        except RuntimeError as e:
            report.error = f"{type(e).__name__}: {e}"
            print(f"[supervisor] attempt {attempt} failed: {e}; "
                  f"restarting", flush=True)
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
    supervise(cfg, args)


if __name__ == "__main__":
    main()
