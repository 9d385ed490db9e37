"""The port's xLSTM blocks and ``xlstm_350m`` against the JAX package.

The same inputs, made from a numpy seed, and the reference's own
parameters carried over by ``params_from_numpy`` go through both
packages on the CPU.  The stock ``.reduced()`` config has 4 layers and a
pattern of period 8, so it holds no layer scan and no sLSTM (all four
layers are mLSTM tail layers); the models are therefore also held at 16
layers (two scanned super-blocks, each with an sLSTM whose time scan is
nested in the layer scan's body) and at 10 (one super-block plus a
two-mLSTM tail).

Tolerances: each block (``mlstm_apply``, ``slstm_apply``, and their
decode forms step by step with their caches) 1e-5 in f32 and 2e-2 in
bf16, the same bf16 weights and inputs in both packages; with the gate
weights scaled x20 (the gate pre-activations reach the tens, so the
mLSTM's ``exp(-F)`` of the log-forget prefix sum overflows in f32: only
the stabilised forms stay finite) 1e-5 in f32, but for the mLSTM's
parallel form, held within 1e-5 x max|F| (~2.5e-3 here): its
exponents are differences ``F_i - F_j`` of prefix sums of |F| up to
~250, whose f32 spacing each package rounds in its own order, and the
normaliser then cancels; each package lies ~3e-5-1.4e-4 from a float64
evaluation of the same formula, the two ~1.1e-4 apart.  The models' logits and
final caches in f32, against the reference and the port's decode
against its own forward: 1e-4.  Exact: the serve loop's greedy tokens,
``param_logical_axes``, the abstract inputs and their logical names, the
carried parameters and the empty caches, and the traced prims' params.
The plans are ``tests/test_torch_xlstm_plans.py``'s.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.ir import extract_program as jax_extract
from repro.launch import specs as jspecs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ir
from repro_torch.core.ir import UnsupportedOpError, extract_program
from repro_torch.core.partitioner import flatten_logical_axes
from repro_torch.launch import serve, specs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_decode_step, make_prefill_step
from test_torch_decode import (close, jtree_flat, normal, reference_loop,
                               ttree_flat)

ARCH = "xlstm_350m"
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL = 1e-4
B, S = 2, 24
# 4: the stock reduced config (mLSTM tail only); 10: one super-block and
# a two-mLSTM tail; 16: two super-blocks
DEPTHS = [4, 10, 16]


def configs(num_layers=None, **kw):
    """The reference's and the port's reduced config, with ``kw``."""
    if num_layers is not None:
        kw["num_layers"] = num_layers
    return (dataclasses.replace(jax_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def to_port(tree):
    return T.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")


def both(jfn, tfn, *arrays, dtype="float32"):
    """``jfn`` and ``tfn`` on the same numpy arrays, cast to ``dtype``."""
    want = jfn(*(jnp.asarray(a).astype(dtype) for a in arrays))
    got = tfn(*(torch.from_numpy(a).to(getattr(torch, dtype))
                for a in arrays))
    return got, want


def block_params(kind, jcfg, gates=1.0):
    """One block's reference parameters (the gate weights times
    ``gates``) and the port's copy."""
    init = JL.init_mlstm if kind == "mlstm" else JL.init_slstm
    jp = init(jcfg, jax.random.PRNGKey(1))
    for k in ("wi", "wf", "W"):
        if k in jp:
            jp[k] = (jp[k].astype(jnp.float32) * gates).astype(jp[k].dtype)
    return jp, to_port(jp)


def log_forget_prefix(tp, x):
    """The mLSTM's ``F``, the prefix sum of log sigmoid(forget gate)."""
    fg = L.matmul(L.rmsnorm(torch.from_numpy(x), tp["ln"]), tp["wf"])
    return torch.cumsum(-L.softplus(-fg), dim=1)


BLOCK_CASES = [("float32", 1.0), ("bfloat16", 1.0), ("float32", 20.0)]
BLOCK_IDS = ["f32", "bf16", "f32-gates-x20"]


# -- the blocks -------------------------------------------------------------


class TestBlocks:
    @pytest.mark.parametrize("dtype,gates", BLOCK_CASES, ids=BLOCK_IDS)
    @pytest.mark.parametrize("kind", ["mlstm", "slstm"])
    def test_apply(self, kind, dtype, gates):
        jcfg, tcfg = configs(param_dtype=dtype)
        jp, tp = block_params(kind, jcfg, gates)
        jfn = JL.mlstm_apply if kind == "mlstm" else JL.slstm_apply
        tfn = L.mlstm_apply if kind == "mlstm" else L.slstm_apply
        x = normal(2, (B, S, jcfg.d_model))
        got, want = both(lambda a: jfn(jcfg, jp, a),
                         lambda a: tfn(tcfg, tp, a), x, dtype=dtype)
        assert got.dtype == getattr(torch, dtype)
        assert torch.isfinite(got.float()).all()
        tol = BLOCK_TOL[dtype]
        if kind == "mlstm" and gates != 1.0:
            tol *= float(log_forget_prefix(tp, x).abs().max())
            assert 100 < tol / BLOCK_TOL[dtype] < 1000
        close(got, want, tol)

    def test_gates_x20_overflow_an_unstabilised_mlstm(self):
        _, tp = block_params("mlstm", configs()[0], 20.0)
        F = log_forget_prefix(tp, normal(2, (B, S, tp["ln"].shape[0])))
        assert torch.isinf(torch.exp(-F)).any()

    @pytest.mark.parametrize("dtype,gates", BLOCK_CASES, ids=BLOCK_IDS)
    @pytest.mark.parametrize("kind", ["mlstm", "slstm"])
    def test_decode_steps_and_caches(self, kind, dtype, gates):
        jcfg, tcfg = configs(param_dtype=dtype)
        jp, tp = block_params(kind, jcfg, gates)
        jmod = {"mlstm": (JL.mlstm_init_cache, JL.mlstm_decode),
                "slstm": (JL.slstm_init_cache, JL.slstm_decode)}[kind]
        tmod = {"mlstm": (L.mlstm_init_cache, L.mlstm_decode),
                "slstm": (L.slstm_init_cache, L.slstm_decode)}[kind]
        jc = jmod[0](jcfg, B)
        tc = tmod[0](tcfg, B, device="cpu")
        xs = normal(3, (B, 8, jcfg.d_model))
        for t in range(xs.shape[1]):
            x = xs[:, t:t + 1]
            want, jc = jmod[1](jcfg, jp, jnp.asarray(x).astype(dtype), jc,
                               jnp.int32(t))
            got, tc = tmod[1](tcfg, tp, torch.from_numpy(x).to(
                getattr(torch, dtype)), tc, torch.tensor(t, dtype=torch.int32))
            close(got, want, BLOCK_TOL[dtype])
            assert list(tc) == list(jc)
            for k in jc:
                assert tc[k].dtype == torch.float32
                close(tc[k], jc[k], BLOCK_TOL[dtype])

    @pytest.mark.parametrize("kind", ["mlstm", "slstm"])
    def test_decode_reproduces_apply(self, kind):
        _, tcfg = configs()
        _, tp = block_params(kind, configs()[0])
        apply, init, dec = {
            "mlstm": (L.mlstm_apply, L.mlstm_init_cache, L.mlstm_decode),
            "slstm": (L.slstm_apply, L.slstm_init_cache, L.slstm_decode),
        }[kind]
        x = torch.from_numpy(normal(4, (B, S, tcfg.d_model)))
        full = apply(tcfg, tp, x)
        cache = init(tcfg, B, device="cpu")
        for t in range(S):
            y, cache = dec(tcfg, tp, x[:, t:t + 1], cache,
                           torch.tensor(t, dtype=torch.int32))
            close(y[:, 0], full[:, t].numpy(), BLOCK_TOL["float32"])


# -- the models -------------------------------------------------------------


def reference_and_port(num_layers, seed=0):
    jcfg, tcfg = configs(num_layers)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, to_port(jp)


class TestModels:
    @pytest.mark.parametrize("num_layers", DEPTHS)
    def test_forward(self, num_layers):
        jcfg, tcfg, jp, tp = reference_and_port(num_layers)
        tokens = np.random.default_rng(6).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        want = JT.forward(jcfg, jp, jnp.asarray(tokens))
        got = T.forward(tcfg, tp, torch.from_numpy(tokens))
        assert tuple(got.shape) == (B, S, jcfg.vocab_size)
        close(got, want, TOL)

    @pytest.mark.parametrize("num_layers", DEPTHS)
    def test_decode_steps_and_caches(self, num_layers):
        jcfg, tcfg, jp, tp = reference_and_port(num_layers)
        steps = 12
        tokens = np.random.default_rng(7).integers(
            0, jcfg.vocab_size, (B, steps)).astype(np.int32)
        jdec, tdec = jax.jit(lambda *a: JT.decode_step(jcfg, *a)), \
            make_decode_step(tcfg)
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

    @pytest.mark.parametrize("num_layers", [10, 16])
    def test_decode_reproduces_forward(self, num_layers):
        # the reference's own check (tests/test_archs.py), on the port
        _, tcfg, _, tp = reference_and_port(num_layers, seed=2)
        tokens = torch.from_numpy(np.random.default_rng(9).integers(
            0, tcfg.vocab_size, (B, S)).astype(np.int32))
        full = T.forward(tcfg, tp, tokens)
        dec = make_decode_step(tcfg)
        cache = T.init_cache(tcfg, B, S, device="cpu")
        for t in range(S):
            logits, cache = dec(tp, cache, tokens[:, t:t + 1],
                                torch.tensor(t, dtype=torch.int32))
            close(logits[:, 0], full[:, t].numpy(), TOL)

    def test_serve_loop_tokens_equal_the_reference_loop(self):
        jcfg, tcfg, jp, tp = reference_and_port(16, seed=3)
        prompts = np.random.default_rng(8).integers(
            0, jcfg.vocab_size, (B, 10)).astype(np.int32)
        want = reference_loop(jcfg, jp, jnp.asarray(prompts), 14)
        res = serve.serve_loop(make_decode_step(tcfg), tp,
                               T.init_cache(tcfg, B, 24, device="cpu"),
                               torch.from_numpy(prompts), 14)
        np.testing.assert_array_equal(res.tokens.numpy(), want)

    def test_serve_cli_on_the_cpu(self, capsys):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--prompt-len", "4", "--gen", "4", "--batch", "2",
                    "--plan", "toast"])
        out = capsys.readouterr().out
        assert "[toast] cost=" in out and "ms/token" in out
        assert out.count("generated=") == 2


# -- parameters, caches, specs ---------------------------------------------


def _is_names(x):
    return isinstance(x, tuple) and len(x) > 0 and \
        all(isinstance(e, (str, type(None))) for e in x)


class TestParams:
    @pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
    def test_param_logical_axes(self, full):
        jcfg, tcfg = (jax_config(ARCH), get_config(ARCH)) if full else \
            configs(16)
        jp, tp = JT.param_specs(jcfg), T.param_specs(tcfg)
        assert {p: tuple(x.shape) for p, x in ttree_flat(tp).items()} == \
            {p: x.shape for p, x in jtree_flat(jp).items()}
        flat, _ = jax.tree_util.tree_flatten_with_path(
            JT.param_logical_axes(jcfg, jp), is_leaf=_is_names)
        want = {jax.tree_util.keystr(k): v for k, v in flat}
        got = dict(zip(pytree.flatten_with_paths(tp)[1],
                       flatten_logical_axes(T.param_logical_axes(tcfg, tp))))
        assert got == want
        m, s = "['layers'][0]['mix']", "['layers'][7]['mix']"
        assert got[m + "['wi']"] == got[m + "['wf']"] == \
            (None, "embed", "heads")
        assert got[s + "['W']"] == (None, "embed", "heads")
        assert got[s + "['R']"] == (None, "heads", None, None)

    def test_params_from_numpy(self):
        jcfg, _, jp, tp = reference_and_port(16)
        want, got = jtree_flat(jp), ttree_flat(tp)
        assert list(got) == list(want)
        for path, x in got.items():
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[path]))

    def test_init_params_shapes_and_zero_bias(self):
        _, tcfg = configs(16)
        tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert ttree_flat(T.param_specs(tcfg)).keys() == ttree_flat(tp).keys()
        assert not tp["layers"][7]["mix"]["b"].any()
        assert tp["layers"][7]["mix"]["R"].std() > 0

    @pytest.mark.parametrize("num_layers", DEPTHS)
    def test_init_cache_matches_the_reference(self, num_layers):
        jcfg, tcfg = configs(num_layers)
        want = jtree_flat(JT.init_cache(jcfg, 2, 8))
        got = ttree_flat(T.init_cache(tcfg, 2, 8, device="cpu"))
        assert list(got) == list(want)
        for path, x in got.items():
            assert tuple(x.shape) == want[path].shape, path
            assert str(x.dtype).removeprefix("torch.") == \
                str(want[path].dtype), path
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[path]))

    @pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
    @pytest.mark.parametrize("kind", ["prefill", "decode"])
    def test_specs_match_the_reference(self, kind, full):
        jcfg, tcfg = (jax_config(ARCH), get_config(ARCH)) if full else \
            configs(16)
        _, jargs, jnames = jspecs.step_and_inputs(
            jcfg, JShapeConfig("s", 256, 4, kind))
        _, targs, tnames = specs.step_and_inputs(
            tcfg, ShapeConfig("s", 256, 4, kind))
        want = {p: (x.shape, str(x.dtype)) for p, x in
                jtree_flat(jargs).items()}
        got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
               for p, x in ttree_flat(targs).items()}
        assert got == want
        assert flatten_logical_axes(tnames) == jax.tree_util.tree_leaves(
            jnames, is_leaf=lambda x: x is None or _is_names(x))

    def test_no_kernel_site_and_no_kv_pin(self):
        for cfg in (get_config(ARCH), configs(16)[1]):
            assert T.kernel_sites(cfg) == {"flash_attention": (0, 0),
                                           "rg_lru": (0, 0)}
            assert serve.decode_request(cfg, None, None).constraints == ()
        cfg = dataclasses.replace(configs(16)[1], use_pallas=True)
        prog = extract_program(make_prefill_step(cfg), T.param_specs(cfg), {
            "tokens": torch.empty((2, 8), dtype=torch.int32,
                                  device="meta")})
        assert not [op for op in prog.ops if op.prim.startswith("kernel:")]

    @pytest.mark.parametrize("arch", ["whisper_small", "phi3_vision"])
    def test_other_families_build_their_steps(self, arch):
        # whisper and phi3_vision serve (items 11b, 11c) and train on one
        # device (item 11f) and on meshes (item 11g: their own test
        # files); nothing raises for two or more ranks any more
        jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
        assert {p: tuple(x.shape) for p, x in
                ttree_flat(T.param_specs(cfg)).items()} == \
            {p: x.shape for p, x in jtree_flat(JT.param_specs(jcfg)).items()}
        specs.step_and_inputs(cfg, ShapeConfig("s", 64, 4, "prefill"))
        specs.step_and_inputs(cfg, ShapeConfig("s", 64, 4, "train"))
        from repro_torch.train import steps
        steps.make_train_step(cfg)
        assert not hasattr(steps, "check_train_supported")


# -- the tracer -------------------------------------------------------------


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def prims_and_params(prog):
    return [(op.prim, {k: tuple(int(n) for n in v) if k == "sizes" else v
                       for k, v in op.params.items()
                       if k not in ("sharding", "accuracy")})
            for op in prog.ops]


class TestTracer:
    def test_cumsum_is_the_reference_prim(self):
        tprog = extract_program(lambda x: torch.cumsum(x, dim=1),
                                meta(2, 8, 4))
        jprog = jax_extract(lambda x: jnp.cumsum(x, axis=1),
                            jnp.zeros((2, 8, 4)))
        assert prims_and_params(tprog) == prims_and_params(jprog) == \
            [("cumsum", {"axis": 1, "reverse": False})]

    def test_four_way_split_is_one_prim(self):
        tprog = extract_program(
            lambda x: [a * 2 for a in torch.split(x, 16, dim=-1)],
            meta(2, 4, 64))
        jprog = jax_extract(
            lambda x: [a * 2 for a in jnp.split(x, 4, axis=-1)],
            jnp.zeros((2, 4, 64)))
        assert prims_and_params(tprog) == prims_and_params(jprog)
        (split,) = [op for op in tprog.ops if op.prim == "split"]
        assert split.params == {"sizes": (16, 16, 16, 16), "axis": 2}
        assert [tprog.types[v].shape for v in split.results] == \
            [(2, 4, 16)] * 4

    def test_split_with_sizes_and_a_remainder(self):
        prog = extract_program(lambda x: torch.split(x, [3, 5], dim=0),
                               meta(8, 2))
        assert prims_and_params(prog) == [
            ("split", {"sizes": (3, 5), "axis": 0})]
        prog = extract_program(lambda x: torch.split(x, 3, dim=0),
                               meta(8, 2))
        assert prims_and_params(prog) == [
            ("split", {"sizes": (3, 3, 2), "axis": 0})]

    def test_the_causal_mask_lowers_as_jnp_tril(self):
        def tfn(x):
            m = torch.tril(torch.ones((6, 6), dtype=torch.bool,
                                      device=x.device))
            return torch.where(m[None, None], x, -float("inf"))

        def jfn(x):
            m = jnp.tril(jnp.ones((6, 6), bool))
            return jnp.where(m[None, None], x, -jnp.inf)

        tprog = extract_program(tfn, meta(2, 3, 6, 6))
        jprog = jax_extract(jfn, jnp.zeros((2, 3, 6, 6)))
        # jnp.where converts its weakly typed scalar (rank 0) first
        want = [p for p in prims_and_params(jprog)
                if p[0] != "convert_element_type"]
        assert prims_and_params(tprog) == want
        assert [p for p, _ in want] == [
            "broadcast_in_dim", "iota", "add", "iota", "ge",
            "broadcast_in_dim", "select_n", "broadcast_in_dim",
            "broadcast_in_dim", "broadcast_in_dim", "select_n"]

    def test_nested_time_scan_trip_counts(self):
        jcfg, tcfg = configs(16)
        n_scan, seq = JT.n_scan_blocks(jcfg), 8
        tok = {"tokens": torch.empty((2, seq), dtype=torch.int32,
                                     device="meta")}
        ep, leaves, _ = ir.export_graph(make_prefill_step(tcfg),
                                        (T.param_specs(tcfg), tok))
        ex = ir._Extractor()
        ex.walk(ep.graph_module, [ex.prog.new_value(x.shape, x.dtype)
                                  for x in leaves])
        tprog = ex.prog
        jprog = jax_extract(jax_prefill(jcfg), JT.param_specs(jcfg), {
            "tokens": jax.ShapeDtypeStruct((2, seq), jnp.int32)})

        def trips(prog):
            return collections.Counter(
                (op.prim, prog.trip_counts[i])
                for i, op in enumerate(prog.ops))

        want, got = trips(jprog), trips(tprog)
        # the named differences (tests/test_torch_xlstm_plans.py)
        assert want - got == {("convert_element_type", n_scan): 7,
                              ("lt", 1): 2, ("add", 1): 2,
                              ("select_n", 1): 2, ("dynamic_slice", 1): 1}
        assert got - want == {("slice", 1): 1}
        inner = [op.prim for i, op in enumerate(tprog.ops)
                 if tprog.trip_counts[i] == n_scan * seq]
        assert "split" in inner and "tanh" in inner and \
            len(inner) == sum(n for (_, t), n in want.items()
                              if t == n_scan * seq)
        # one scan record, the layer scan's: the time scan is nested
        assert [s.length for s in ex.scans] == [n_scan]

    def test_a_top_level_time_scan_is_recorded(self):
        _, tcfg = configs()
        p = {k: meta(*shape, dtype=torch.float32)
             for k, (shape, _) in L.slstm_param_shapes(tcfg).items()}
        ep, leaves, _ = ir.export_graph(
            lambda p, x: L.slstm_apply(tcfg, p, x),
            (p, meta(2, 5, tcfg.d_model)))
        ex = ir._Extractor()
        ex.walk(ep.graph_module, [ex.prog.new_value(x.shape, x.dtype)
                                  for x in leaves])
        assert [s.length for s in ex.scans] == [5]

    def test_unknown_ops_still_raise(self):
        with pytest.raises(UnsupportedOpError, match="cummax"):
            extract_program(lambda x: torch.cummax(x, 1).values,
                            meta(2, 8))
        with pytest.raises(UnsupportedOpError, match="tril"):
            extract_program(lambda x: torch.tril(x), meta(2, 4, 4))
