"""The port's data pipeline and checkpoints against the reference's, on
the CPU.

``repro_torch.data.pipeline`` is a copy of the reference's pipeline: its
batches must equal the reference's bit for bit for every ``(seed, step,
host)`` and every config.  ``repro_torch.ckpt.checkpoint`` keeps the
reference's layout: the two packages write the same files byte for byte
and read each other's, except that the reference cannot read a bfloat16
leaf back (``np.load`` returns ``|V2``, which ``jax.device_put`` refuses)
while the port reads it through an ``int16`` view; that difference is
pinned here.  The reference's own ``TestDataPipeline`` and
``TestCheckpoint`` cases (``tests/test_substrate.py``, which skips where
``hypothesis`` is missing) run here on the port's modules.
"""

import filecmp
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as jpipe
from repro.train import steps as jsteps
from repro_torch import pytree
from repro_torch.ckpt.checkpoint import CheckpointManager, latest_step, save
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, Pipeline, batch_at
from repro_torch.models import transformer as T
from repro_torch.train.steps import train_state_from_numpy

CFG = get_config("qwen2_05b").reduced()
SHAPE = ShapeConfig("t", 32, 8, "train")


def _decoder_only(arch):
    cfg = get_config(arch)
    return not cfg.is_encoder_decoder and not cfg.frontend


# every config reduced; the decoder-only ones at full width too
CASES = [(a, r) for a in ARCH_IDS for r in (False, True)
         if r or _decoder_only(a)]
DRAWS = [(0, 0, 1, 0), (7, 3, 1, 0), (2, 17, 4, 3), (5, 1, 2, 1),
         (123, 100000, 8, 5)]


def _configs(arch, reduced):
    cfg, jcfg = get_config(arch), jget_config(arch)
    return (cfg.reduced(), jcfg.reduced()) if reduced else (cfg, jcfg)


def _assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


class TestBatchesEqualTheReference:
    @pytest.mark.parametrize("arch,reduced", CASES)
    @pytest.mark.parametrize("kind", ["train", "prefill"])
    def test_batch_at(self, arch, reduced, kind):
        cfg, jcfg = _configs(arch, reduced)
        for seed, step, hosts, host in DRAWS:
            got = batch_at(cfg, ShapeConfig("t", 32, 8, kind),
                           DataConfig(seed, hosts, host), step)
            want = jpipe.batch_at(jcfg, JShapeConfig("t", 32, 8, kind),
                                  jpipe.DataConfig(seed, hosts, host), step)
            _assert_same_batch(got, want)

    def test_pipeline(self):
        jcfg = jget_config("qwen2_05b").reduced()
        pipe = Pipeline(CFG, SHAPE, DataConfig(seed=3), start_step=5)
        jp = jpipe.Pipeline(jcfg, JShapeConfig("t", 32, 8, "train"),
                            jpipe.DataConfig(seed=3), start_step=5)
        try:
            for want_step in range(5, 9):
                step, got = next(pipe)
                jstep, want = next(jp)
                assert step == jstep == want_step
                _assert_same_batch(got, want)
        finally:
            pipe.close()
            jp.close()


class TestDataPipeline:
    def test_deterministic_per_step(self):
        d = DataConfig(seed=7)
        b1 = batch_at(CFG, SHAPE, d, step=3)
        b2 = batch_at(CFG, SHAPE, d, step=3)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_steps_differ(self):
        d = DataConfig(seed=7)
        assert not np.array_equal(batch_at(CFG, SHAPE, d, 0)["tokens"],
                                  batch_at(CFG, SHAPE, d, 1)["tokens"])

    def test_host_sharding_disjoint(self):
        b0 = batch_at(CFG, SHAPE, DataConfig(num_hosts=2, host_id=0), 0)
        b1 = batch_at(CFG, SHAPE, DataConfig(num_hosts=2, host_id=1), 0)
        assert b0["tokens"].shape[0] == SHAPE.global_batch // 2
        assert not np.array_equal(b0["tokens"], b1["tokens"])

    def test_prefetch_iterator_matches_random_access(self):
        d = DataConfig(seed=1)
        pipe = Pipeline(CFG, SHAPE, d, start_step=5)
        try:
            step, batch = next(pipe)
            assert step == 5
            np.testing.assert_array_equal(
                batch["tokens"], batch_at(CFG, SHAPE, d, 5)["tokens"])
        finally:
            pipe.close()

    def test_restart_recovery(self):
        """A restarted host regenerates its exact shard (straggler /
        preemption recovery without coordination)."""
        d = DataConfig(seed=2, num_hosts=4, host_id=3)
        before = batch_at(CFG, SHAPE, d, 17)
        after = batch_at(CFG, SHAPE, d, 17)        # "after restart"
        np.testing.assert_array_equal(before["targets"], after["targets"])

    def test_a_batch_that_does_not_divide_over_hosts_raises(self):
        with pytest.raises(ValueError, match="must divide over 3 hosts"):
            batch_at(CFG, SHAPE, DataConfig(num_hosts=3), 0)


class TestCheckpoint:
    def _tree(self, k=0):
        return {"a": torch.arange(12.0).reshape(3, 4) + k,
                "b": {"c": torch.ones((5,), dtype=torch.int32) * k}}

    def test_roundtrip(self, tmp_path):
        save(tmp_path, 3, self._tree(1))
        mgr = CheckpointManager(tmp_path)
        step, restored = mgr.restore(self._tree(0))
        assert step == 3
        assert torch.equal(restored["a"], self._tree(1)["a"])
        assert torch.equal(restored["b"]["c"], self._tree(1)["b"]["c"])

    def test_atomic_no_tmp_visible(self, tmp_path):
        save(tmp_path, 1, self._tree())
        names = [p.name for p in pathlib.Path(tmp_path).iterdir()]
        assert "step_00000001" in names
        assert not any(n.endswith(".tmp") for n in names)

    def test_latest_and_retention(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, self._tree(s))
        assert mgr.latest_step() == 4
        steps = sorted(p.name for p in pathlib.Path(tmp_path).iterdir())
        assert steps == ["step_00000003", "step_00000004"]
        assert [s["step"] for s in mgr.saves] == [1, 2, 3, 4]

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save_async(7, self._tree(7))
        mgr.wait()
        assert latest_step(tmp_path) == 7
        (rec,) = mgr.saves
        assert rec["bytes"] == 12 * 4 + 5 * 4 and rec["snapshot_s"] >= 0

    def test_async_save_snapshots_before_it_returns(self, tmp_path):
        """A donated state is overwritten in place by the next step: the
        save must hold the values it was given, not the later ones."""
        tree = self._tree(1)
        mgr = CheckpointManager(tmp_path)
        mgr.save_async(1, tree)
        tree["a"].add_(100.0)
        mgr.wait()
        _, restored = mgr.restore(self._tree())
        assert torch.equal(restored["a"], self._tree(1)["a"])

    def test_restore_onto_shardings_takes_one_per_leaf(self, tmp_path):
        """``shardings`` mirrors ``like``: one ``NamedSharding`` per leaf
        (restoring onto meshes is tested on gloo ranks,
        ``tests/test_torch_launch_mesh*.py``)."""
        save(tmp_path, 1, self._tree(2))
        mgr = CheckpointManager(tmp_path)
        with pytest.raises(ValueError, match="0 shardings for 2 leaves"):
            mgr.restore(self._tree(), shardings={"a": None})

    def test_shape_mismatch_rejected(self, tmp_path):
        save(tmp_path, 1, self._tree())
        mgr = CheckpointManager(tmp_path)
        bad = {"a": torch.zeros((2, 2)),
               "b": {"c": torch.zeros((5,), dtype=torch.int32)}}
        with pytest.raises(ValueError, match="shape mismatch"):
            mgr.restore(bad)

    def test_dtype_mismatch_rejected(self, tmp_path):
        save(tmp_path, 1, self._tree())
        bad = {"a": torch.zeros((3, 4), dtype=torch.float64),
               "b": {"c": torch.zeros((5,), dtype=torch.int32)}}
        with pytest.raises(ValueError, match="dtype mismatch"):
            CheckpointManager(tmp_path).restore(bad)

    def test_no_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(tmp_path).restore(self._tree())


# --- the two packages' checkpoint files -------------------------------------


def _jax_state():
    """A reduced f32 reference train state."""
    return jsteps.init_train_state(jget_config("qwen2_05b").reduced(),
                                   jax.random.PRNGKey(0))


def _jax_bf16_tree():
    """A bfloat16 tree (the reduced parameters cast), with an int32 leaf."""
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                    _jax_state().params)
    return {"params": params, "step": jnp.asarray(3, jnp.int32)}


def _port_tree(jtree):
    if isinstance(jtree, jsteps.TrainState):
        return train_state_from_numpy(jtree, device="cpu")
    return T.params_from_numpy(jtree, device="cpu")


def _bits(x):
    x = x.detach()
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _assert_bits_equal(port, jtree):
    leaves, paths = pytree.flatten_with_paths(port)
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert paths == [jax.tree_util.keystr(p) for p, _ in jflat]
    for got, (_, want) in zip(leaves, jflat):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            want = want.view(np.int16)
        assert torch.equal(_bits(got), torch.from_numpy(np.array(want)))


TREES = {"f32_train_state": _jax_state, "bf16_tree": _jax_bf16_tree}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, tree):
    jtree = TREES[tree]()
    jckpt.save(tmp_path, 5, jtree)
    step, got = CheckpointManager(tmp_path).restore(_port_tree(jtree))
    assert step == 5
    _assert_bits_equal(got, jtree)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_the_port_writes_the_reference_files_byte_for_byte(tmp_path, tree):
    jtree = TREES[tree]()
    jdir = jckpt.save(tmp_path / "ref", 2, jtree)
    pdir = save(tmp_path / "port", 2, _port_tree(jtree))
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    assert "manifest.json" in names and len(names) > 10
    for name in names:
        assert filecmp.cmp(jdir / name, pdir / name, shallow=False), name


def test_an_f32_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate = _jax_state()
    save(tmp_path, 9, _port_tree(jstate))
    step, got = jckpt.CheckpointManager(tmp_path).restore(jstate)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_the_reference_cannot_restore_a_bf16_checkpoint(tmp_path):
    """By design, not a fault of the port: the reference reads a bfloat16
    leaf back as ``|V2``, which ``jax.device_put`` refuses; the port
    reads the same file (test above)."""
    jtree = _jax_bf16_tree()
    jckpt.save(tmp_path, 1, jtree)
    with pytest.raises(TypeError, match="V2"):
        jckpt.CheckpointManager(tmp_path).restore(jtree)
