"""The port's ``phi3_vision`` (patch embeddings before the tokens)
against the JAX package: the model, its inputs and names, its fused
attention site and its plans.

The same inputs, made from a numpy seed, and the reference's own
parameters carried over by ``params_from_numpy`` go through both
packages on the CPU, at reduced width (``.reduced()``: d_model 64, 4
heads of 16, 8 patches) and 2 or 4 layers.  Decode is text only, as the
reference's decode step takes no patches.

Tolerances: the logits and final caches in f32 against the reference,
and the port's decode against its own forward: 1e-4.  Exact: the serve
loop's greedy tokens, ``param_logical_axes`` leaf by leaf, the carried
parameters, the empty caches, the abstract inputs and their logical
names.

The plans: both packages trace the prefill step from their
``launch/specs.step_and_inputs`` at B 4 x S 64 reduced (8 patches + 56
tokens) and 4 x 2048 at full width and depth (576 patches + 1472
tokens), and the decode step at B 4 with a cache of 32 and 256, and
search a greedy 2x2 plan each (the decode step with the serving
launcher's request, the KV cache pinned ``Replicate``).  The plans have
identical input paths, specs, rules, conflicts, compat sets, resolution
bits, colors (all of them, those on live values, and the partition of
the inputs' and outputs' dims) and communication and peak bytes; the
costs agree within 2% relative.  The programs differ only by the
reference's extra ops that every model has
(``tests/test_torch_decode_plans.py``).  With ``logits_vocab_shard``
set (no config sets it) the reduced prefill plan equals the
reference's too: both constrain the logits on the vocab, not the
sequence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Replicate as JReplicate
from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro_torch import pytree
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import ShardingPlan, flatten_logical_axes
from repro_torch.kernels import registry
from repro_torch.launch import serve, specs
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_decode_step, make_train_step
from test_torch_core import io_color_labels
from test_torch_decode import (close, jtree_flat, reference_loop,
                               ttree_flat)
from test_torch_hybrid_plans import live_colors

ARCH = "phi3_vision"
TOL = 1e-4
B, S = 2, 16
COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")


def configs(num_layers=None, **kw):
    """The reference's and the port's reduced config, with ``kw``."""
    if num_layers is not None:
        kw["num_layers"] = num_layers
    return (dataclasses.replace(jax_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def reference_and_port(num_layers=None, seed=0):
    jcfg, tcfg = configs(num_layers)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, T.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def tokens_of(seed, vocab, steps=S):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, steps)).astype(np.int32)


# -- the model --------------------------------------------------------------


class TestModel:
    @pytest.mark.parametrize("num_layers", [2, 4])
    def test_forward_with_patches(self, num_layers):
        jcfg, tcfg, jp, tp = reference_and_port(num_layers)
        tokens = tokens_of(6, jcfg.vocab_size)
        patches = np.random.default_rng(7).standard_normal(
            (B, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
        want = jax.jit(lambda p, t, e: JT.forward(jcfg, p, t,
                                                  patch_embeds=e))(
            jp, jnp.asarray(tokens), jnp.asarray(patches))
        got = T.forward(tcfg, tp, torch.from_numpy(tokens),
                        patch_embeds=torch.from_numpy(patches))
        assert tuple(got.shape) == (B, jcfg.num_patches + S,
                                    jcfg.vocab_size)
        close(got, want, TOL)

    @pytest.mark.parametrize("num_layers", [2, 4])
    def test_decode_steps_and_caches(self, num_layers):
        jcfg, tcfg, jp, tp = reference_and_port(num_layers)
        steps = 12
        tokens = tokens_of(8, jcfg.vocab_size, steps)
        jdec = jax.jit(lambda *a: JT.decode_step(jcfg, *a))
        tdec = make_decode_step(tcfg)
        jc = JT.init_cache(jcfg, B, steps)
        tc = T.init_cache(tcfg, B, steps, device="cpu")
        for t in range(steps):
            jlog, jc = jdec(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.int32(t))
            tlog, tc = tdec(tp, tc, torch.from_numpy(tokens[:, t:t + 1]),
                            torch.tensor(t, dtype=torch.int32))
            close(tlog, jlog, TOL)
        want, got = jtree_flat(jc), ttree_flat(tc)
        assert list(got) == list(want)
        for path, x in got.items():
            close(x, want[path], TOL)

    def test_decode_reproduces_the_text_forward(self):
        _, tcfg, _, tp = reference_and_port(4, seed=2)
        tokens = torch.from_numpy(tokens_of(9, tcfg.vocab_size))
        full = T.forward(tcfg, tp, tokens)
        dec = make_decode_step(tcfg)
        cache = T.init_cache(tcfg, B, S, device="cpu")
        for t in range(S):
            logits, cache = dec(tp, cache, tokens[:, t:t + 1],
                                torch.tensor(t, dtype=torch.int32))
            close(logits[:, 0], full[:, t].numpy(), TOL)

    def test_serve_loop_tokens_equal_the_reference_loop(self):
        jcfg, tcfg, jp, tp = reference_and_port(4, seed=3)
        prompts = tokens_of(10, jcfg.vocab_size, 6)
        want = reference_loop(jcfg, jp, jnp.asarray(prompts), 10)
        res = serve.serve_loop(make_decode_step(tcfg), tp,
                               T.init_cache(tcfg, B, 16, device="cpu"),
                               torch.from_numpy(prompts), 10)
        np.testing.assert_array_equal(res.tokens.numpy(), want)

    def test_serve_cli_on_the_cpu(self, capsys):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--prompt-len", "4", "--gen", "4", "--batch", "2",
                    "--plan", "toast"])
        out = capsys.readouterr().out
        assert "[toast] cost=" in out and "ms/token" in out
        assert out.count("generated=") == 2

    def test_serves_and_trains_on_two_ranks(self, tmp_path):
        # no longer refused: training is ported on one device (item 11f),
        # and both launchers run on two ranks (item 11g), the served
        # tokens equal one process's, the loss within 1e-4
        _, tcfg = configs()
        make_train_step(tcfg)
        _, (_, batch), _ = specs.step_and_inputs(
            tcfg, ShapeConfig("s", 64, 4, "train"))
        P = tcfg.num_patches
        assert tuple(batch["patch_embeds"].shape) == (4, P, tcfg.d_model)
        assert tuple(batch["tokens"].shape) == (4, 64 - P)
        assert tuple(batch["targets"].shape) == (4, 64 - P)
        from test_torch_xlstm_mesh_train import \
            check_entry_points_on_two_ranks
        check_entry_points_on_two_ranks(ARCH, tmp_path)


# -- parameters, caches, specs, the fused site ------------------------------


def _is_names(x):
    return isinstance(x, tuple) and len(x) > 0 and \
        all(isinstance(e, (str, type(None))) for e in x)


class TestParams:
    @pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
    def test_param_logical_axes(self, full):
        jcfg, tcfg = (jax_config(ARCH), get_config(ARCH)) if full else \
            configs()
        jp, tp = JT.param_specs(jcfg), T.param_specs(tcfg)
        assert {p: tuple(x.shape) for p, x in ttree_flat(tp).items()} == \
            {p: x.shape for p, x in jtree_flat(jp).items()}
        flat, _ = jax.tree_util.tree_flatten_with_path(
            JT.param_logical_axes(jcfg, jp), is_leaf=_is_names)
        want = {jax.tree_util.keystr(k): v for k, v in flat}
        got = dict(zip(pytree.flatten_with_paths(tp)[1],
                       flatten_logical_axes(T.param_logical_axes(tcfg, tp))))
        assert got == want
        if full:
            n = sum(x.numel() for x in pytree.tree_leaves(tp))
            assert 3.7e9 < n < 3.9e9

    def test_params_from_numpy(self):
        _, _, jp, tp = reference_and_port()
        want, got = jtree_flat(jp), ttree_flat(tp)
        assert list(got) == list(want)
        for path, x in got.items():
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[path]))

    def test_init_cache_matches_the_reference(self):
        jcfg, tcfg = configs()
        want = jtree_flat(JT.init_cache(jcfg, 2, 8))
        got = ttree_flat(T.init_cache(tcfg, 2, 8, device="cpu"))
        assert list(got) == list(want)
        for path, x in got.items():
            assert tuple(x.shape) == want[path].shape, path
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[path]))

    @pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
    @pytest.mark.parametrize("kind", ["prefill", "decode"])
    def test_specs_match_the_reference(self, kind, full):
        jcfg, tcfg = (jax_config(ARCH), get_config(ARCH)) if full else \
            configs()
        seq = 2048 if full else 64
        _, jargs, jnames = jspecs.step_and_inputs(
            jcfg, JShapeConfig("s", seq, 4, kind))
        _, targs, tnames = specs.step_and_inputs(
            tcfg, ShapeConfig("s", seq, 4, kind))
        want = {p: (x.shape, str(x.dtype)) for p, x in
                jtree_flat(jargs).items()}
        got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
               for p, x in ttree_flat(targs).items()}
        assert got == want
        assert flatten_logical_axes(tnames) == jax.tree_util.tree_leaves(
            jnames, is_leaf=lambda x: x is None or _is_names(x))
        P = tcfg.num_patches
        if kind == "prefill":
            assert got["[1]['patch_embeds']"][0] == (4, P, tcfg.d_model)
            assert got["[1]['tokens']"][0] == (4, seq - P)
            assert tnames[1]["patch_embeds"] == ("batch", None, "embed")
        else:
            assert len(targs) == 4

    def test_one_causal_site_at_head_dim_96(self):
        full = get_config(ARCH)
        assert full.resolved_head_dim == 96 in registry.CUDA_HEAD_DIMS
        assert T.kernel_sites(full) == {"flash_attention": (1, 0),
                                        "rg_lru": (0, 0)}
        dims = {"batch": 4, "q_seq": 2048, "kv_seq": 2048, "heads": 32,
                "head_dim": 96}
        assert registry.KERNELS["flash_attention"].feasible("cuda", dims)
        cfg = dataclasses.replace(configs()[1], use_pallas=True)
        fn, args, _ = specs.step_and_inputs(
            cfg, ShapeConfig("s", 64, 2, "prefill"))
        sess = Session(fn, args)
        prog = sess.artifacts.prog
        (op,) = [op for op in prog.ops if op.prim.startswith("kernel:")]
        assert op.params == {"kernel": "flash_attention", "causal": True}
        # the patches and the tokens make one sequence: 8 + 56
        assert prog.types[op.operands[0]].shape == (2, 64, 4, 16)
        plan = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1))))
        assert [(r["site"], r["impl"]) for r in plan.kernel_sites] == \
            [("flash_attention:0", "cuda")]


# -- the plans ----------------------------------------------------------------


CASES = [(s, k) for s in ("reduced", "full") for k in ("prefill", "decode")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def plans(request):
    size, kind = request.param
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if size == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    seq = {"prefill": 2048, "decode": 256}[kind] if size == "full" else \
        {"prefill": 64, "decode": 32}[kind]
    jfn, jargs, jnames = jspecs.step_and_inputs(
        jcfg, JShapeConfig("s", seq, 4, kind))
    js = JSession(jfn, jargs)
    if kind == "prefill":
        tfn, targs, _ = specs.step_and_inputs(
            tcfg, ShapeConfig("s", seq, 4, kind))
        ts = Session(tfn, targs)
        jp = js.partition(JRequest(mesh=JMeshSpec(AXES, (2, 2)),
                                   hw=JHardwareSpec(**HW), backend="greedy"))
        tp = ts.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                                  hw=HardwareSpec(**HW), backend="greedy"))
        return js, ts, jp, tp
    jp = js.partition(JRequest(
        mesh=JMeshSpec(AXES, (2, 2)), hw=JHardwareSpec(**HW),
        backend="greedy", min_dims=4, logical_axes=jnames,
        constraints=(JReplicate("['k']"), JReplicate("['v']"))))
    ts, tnames = serve.decode_session(tcfg, 4, seq)
    req = serve.decode_request(tcfg, tnames, MeshSpec(AXES, (2, 2)))
    assert len(req.constraints) == 2
    tp = ts.partition(dataclasses.replace(req, hw=HardwareSpec(**HW)))
    assert tp.check(req.constraints)
    return js, ts, jp, tp


class TestPlanParity:
    def test_identical_specs_and_rules(self, plans):
        _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]
        assert tp.logical_rules == jp.logical_rules

    def test_identical_analysis_counts_and_colors(self, plans):
        js, ts, jp, tp = plans
        assert (tp.num_conflicts, tp.num_colors, tp.num_compat_sets,
                tp.num_resolution_bits) == \
            (jp.num_conflicts, jp.num_colors, jp.num_compat_sets,
             jp.num_resolution_bits)
        jart, tart = js.artifacts, ts.artifacts
        assert io_color_labels(tart.prog, tart.nda) == \
            io_color_labels(jart.prog, jart.nda)
        assert len(live_colors(tart.prog, tart.nda)) == \
            len(live_colors(jart.prog, jart.nda))

    def test_cost_and_bytes(self, plans):
        _, _, jp, tp = plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        assert tp.breakdown["comm_bytes"] == jp.breakdown["comm_bytes"]
        assert tp.breakdown["peak_bytes"] == jp.breakdown["peak_bytes"]

    def test_reference_plan_json_loads_into_the_port(self, plans):
        _, _, jp, tp = plans
        loaded = ShardingPlan.from_json(jp.to_json())
        assert loaded.in_specs == tp.in_specs
        again = ShardingPlan.from_json(tp.to_json())
        assert again.as_dict() == tp.as_dict()


def test_logits_vocab_shard_plans_as_the_reference():
    # the reference's logits_vocab_shard branch of forward: the logits
    # constrained on the vocab, not the sequence
    jcfg, tcfg = (dataclasses.replace(c, logits_vocab_shard=True)
                  for c in configs())
    jfn, jargs, _ = jspecs.step_and_inputs(
        jcfg, JShapeConfig("s", 64, 4, "prefill"))
    tfn, targs, _ = specs.step_and_inputs(
        tcfg, ShapeConfig("s", 64, 4, "prefill"))
    jp = JSession(jfn, jargs).partition(JRequest(
        mesh=JMeshSpec(AXES, (2, 2)), hw=JHardwareSpec(**HW),
        backend="greedy"))
    tp = Session(tfn, targs).partition(Request(
        mesh=MeshSpec(AXES, (2, 2)), hw=HardwareSpec(**HW),
        backend="greedy"))
    assert [tuple(s) for s in tp.in_specs] == \
        [tuple(s) for s in jp.in_specs]
    assert [tuple(s) for s in tp.out_specs] == \
        [tuple(s) for s in jp.out_specs]
    assert (tp.num_conflicts, tp.num_colors, tp.logical_rules) == \
        (jp.num_conflicts, jp.num_colors, jp.logical_rules)
    assert tp.breakdown["comm_bytes"] == jp.breakdown["comm_bytes"]
