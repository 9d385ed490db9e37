"""Deterministic synthetic token pipeline, a copy of the reference's
``data/pipeline.py`` (which imports ``jax`` but computes with numpy
alone).

Batches are a pure function of ``(seed, step, host)`` — a restarted or
replaced host regenerates exactly its shard with no coordination, which is
the straggler/elasticity story for the data layer: no host ever blocks on
a data service, and recovery after preemption is recompute-free.  They
are numpy arrays, bit-identical to the reference's for every
``(seed, step, host)``; the launcher moves them to the device.

A background prefetch thread keeps ``prefetch`` batches ready so host-side
data generation overlaps device compute.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


def _batch_for(cfg: ModelConfig, shape: ShapeConfig, dcfg: DataConfig,
               step: int) -> dict[str, np.ndarray]:
    """The global batch restricted to this host's rows."""
    B, S = shape.global_batch, shape.seq_len
    if B % dcfg.num_hosts:
        raise ValueError(f"global batch {B} must divide over "
                         f"{dcfg.num_hosts} hosts")
    local_b = B // dcfg.num_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed, step, dcfg.host_id]))
    out = {}
    if cfg.is_encoder_decoder:
        S_tok = S // 2
        out["frames"] = rng.standard_normal(
            (local_b, S // 2, cfg.d_model), dtype=np.float32)
    elif cfg.frontend == "vision":
        S_tok = S - cfg.num_patches
        out["patch_embeds"] = rng.standard_normal(
            (local_b, cfg.num_patches, cfg.d_model), dtype=np.float32)
    else:
        S_tok = S
    # markov-ish synthetic tokens: next-token structure a model can learn
    tok = rng.integers(0, cfg.vocab_size, (local_b, S_tok), dtype=np.int32)
    tok[:, 1::2] = (tok[:, 0::2] * 31 + 7) % cfg.vocab_size
    out["tokens"] = tok
    if shape.kind == "train":
        out["targets"] = np.roll(tok, -1, axis=1)
    return out


class Pipeline:
    """Batches from ``start_step`` on, made ahead by a prefetch thread;
    ``next(pipe)`` returns ``(step, batch)``.  Call :meth:`close` when
    done."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 dcfg: DataConfig = DataConfig(), start_step: int = 0):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(dcfg.prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = _batch_for(self.cfg, self.shape, self.dcfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def __iter__(self):
        return self

    def close(self) -> None:
        """Stop the prefetch thread and drop the batches it made."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def batch_at(cfg: ModelConfig, shape: ShapeConfig, dcfg: DataConfig,
             step: int) -> dict[str, np.ndarray]:
    """Random access for tests and recovery checks."""
    return _batch_for(cfg, shape, dcfg, step)
