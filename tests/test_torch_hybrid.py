"""The port's hybrid slice against the JAX package: the RG-LRU scan, the
RG-LRU block and the ``recurrentgemma_2b`` prefill step, through
Session → Request → plan → ``plan.apply``.

*Modules.*  Inputs come from numpy seeds and are handed to both
packages; weights go across with ``params_from_numpy``.  The scan's
plain version (``kernels/ref.py``) is held against the reference's
Pallas kernel in interpret mode and against its jnp oracle, at 1e-5
(f32) and 3e-2 (bf16), the tolerances of ``tests/test_kernels.py``;
the block's pieces and the reduced f32 prefill logits at 1e-5 and 1e-4
(f32 sums taken in another order).

The plans of the whole step are held against the reference's in
``tests/test_torch_hybrid_plans.py``.

*Fused sites.*  With ``use_pallas=True`` the 26-layer stack (8 scanned
super-blocks and a 2-layer tail) traces to four ``kernel:rg_lru`` ops,
and the eager model calls its sites under the traced site keys.

*Repairs.*  ``param_logical_axes`` gives the RG-LRU keys the
reference's names, and the CUDA impl of ``rg_lru`` is priced as the
reference prices its Pallas kernel (one pass).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.ir import extract_program as jax_extract
from repro.kernels import ref as jref
from repro.kernels import registry as jregistry
from repro.kernels.rg_lru import rg_lru_scan
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch import pytree
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import MeshSpec
from repro_torch.core.ir import UnsupportedOpError, extract_program
from repro_torch.kernels import ops, ref, registry
from repro_torch.kernels import rg_lru as lru
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
from repro_torch.train.steps import make_prefill_step

ARCH = "recurrentgemma_2b"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
LOGITS_TOL = 1e-4
AXES = ("data", "model")


def both(x, dtype="float32"):
    """The same numpy array as a jnp and a torch array of ``dtype``."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(
                getattr(torch, dtype)))


def gates(seed, shape):
    """Scan inputs as the reference's tests draw them: a = sigmoid of
    normals, b = 0.1 x normals."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal(shape)))
    b = 0.1 * rng.standard_normal(shape)
    return a.astype(np.float32), b.astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def meta(*s):
    return torch.empty(s, device="meta")


# -- the scan's plain version -------------------------------------------


class TestPlainScan:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_interpret_and_oracle(self, dtype):
        a, b = gates(0, (2, 512, 256))
        (ja, ta), (jb, tb) = both(a, dtype), both(b, dtype)
        got = ref.reference_rg_lru(ta, tb)
        assert got.dtype == ta.dtype
        close(got, rg_lru_scan(ja, jb, block_r=128, block_s=128,
                               interpret=True), TOL[dtype])
        close(got, jref.reference_rg_lru(ja, jb), TOL[dtype])

    @pytest.mark.parametrize("shape", [(1, 64, 131), (2, 37, 5)])
    def test_prime_and_odd_shapes(self, shape):
        (ja, ta), (jb, tb) = (both(x) for x in gates(1, shape))
        close(ref.reference_rg_lru(ta, tb), jref.reference_rg_lru(ja, jb),
              TOL["float32"])

    def test_decay_stability(self):
        S = 2048
        (ja, ta), (jb, tb) = both(np.full((1, S, 128), 0.999, np.float32)), \
            both(np.full((1, S, 128), 0.01, np.float32))
        got = ref.reference_rg_lru(ta, tb)
        assert torch.isfinite(got).all()
        close(got, jref.reference_rg_lru(ja, jb), TOL["float32"])
        np.testing.assert_allclose(got[0, -1, 0].item(),
                                   0.01 * (1 - 0.999 ** S) / 0.001,
                                   rtol=1e-3)

    @pytest.mark.parametrize("S", [1, 2, 7, 8, 64])
    def test_traces_to_the_reference_structure(self, S):
        """The odd/even recursion gives the reference's slices, products,
        concatenations and pads, prim for prim."""
        jprog = jax_extract(jref.reference_rg_lru,
                            jax.ShapeDtypeStruct((2, S, 4), jnp.float32),
                            jax.ShapeDtypeStruct((2, S, 4), jnp.float32))
        tprog = extract_program(ref.reference_rg_lru, meta(2, S, 4),
                                meta(2, S, 4))
        jprims = [(op.prim, op.params.get("padding_config"))
                  for op in jprog.ops]
        tprims = [(op.prim, op.params.get("padding_config"))
                  for op in tprog.ops]
        assert tprims == jprims
        assert [tprog.types[v].shape for op in tprog.ops
                for v in op.results] == \
            [jprog.types[v].shape for op in jprog.ops for v in op.results]


class TestWrapperOnCpu:
    @pytest.mark.parametrize("impl", ["cuda", "ref"])
    def test_cpu_tensors_take_the_plain_version(self, impl):
        (_, ta), (_, tb) = (both(x) for x in gates(2, (2, 96, 128)))
        before = lru.launches
        with kernel_dispatch(KernelDispatch(impls={"rg_lru:0": impl})) \
                as disp:
            got = ops.rg_lru(ta, tb)
            assert disp.next_site("rg_lru") == "rg_lru:1"
        assert lru.launches == before
        torch.testing.assert_close(got, ref.reference_rg_lru(ta, tb),
                                   rtol=0, atol=0)
        torch.testing.assert_close(lru.rg_lru(ta, tb), got, rtol=0, atol=0)

    def test_unknown_impl_raises(self):
        t = torch.zeros((1, 8, 16))
        with kernel_dispatch(KernelDispatch(default_impl="pallas")):
            with pytest.raises(ValueError, match="unknown rg_lru impl"):
                ops.rg_lru(t, t)

    def test_wrapper_rejects_what_the_kernel_does_not_take(self):
        ok = torch.zeros((1, 8, 16))
        lru._check(ok, ok)
        lru._check(ok.bfloat16(), ok.bfloat16())
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            lru._check(ok.half(), ok.half())
        with pytest.raises(TypeError, match="one dtype"):
            lru._check(ok, ok.bfloat16())
        with pytest.raises(ValueError, match="one \\(B,S,R\\) shape"):
            lru._check(ok, torch.zeros((1, 8, 17)))
        with pytest.raises(ValueError, match="contiguous channel"):
            strided = torch.zeros((1, 8, 32))[..., ::2]
            lru._check(strided, strided)
        with pytest.raises(ValueError, match="non-empty"):
            empty = torch.zeros((1, 0, 16))
            lru._check(empty, empty)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            m = meta(1, 8, 16)
            lru.rg_lru(m, m)


# -- the RG-LRU block -----------------------------------------------------


def block_params(cfg, seed=0):
    """One reference RG-LRU block's parameters, in both packages."""
    jp = JL.init_rglru(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # nonzero biases so the bias paths are exercised
    for k in ("conv_b", "ga_b", "gi_b"):
        jp[k] = jnp.asarray(0.1 * rng.standard_normal(jp[k].shape),
                            jnp.float32)
    return jp, T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")


def act(seed, shape):
    return both(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32))


class TestBlock:
    cfg = jax_config(ARCH).reduced()

    def test_param_shapes_match_the_reference(self):
        jp, tp = block_params(self.cfg)
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        assert set(L.rglru_param_shapes(self.cfg)) == set(jp)

    def test_causal_conv4(self):
        jp, tp = block_params(self.cfg)
        ju, tu = act(3, (2, 40, 96))
        jout, jstate = JL._causal_conv4(ju, jp["conv_w"], jp["conv_b"])
        tout, tstate = L._causal_conv4(tu, tp["conv_w"], tp["conv_b"])
        close(tout, jout, TOL["float32"])
        close(tstate, jstate, 0)

    def test_gates(self):
        jp, tp = block_params(self.cfg)
        ju, tu = act(4, (2, 40, 96))
        for got, want in zip(L._rglru_gates(tp, tu),
                             JL._rglru_gates(jp, ju)):
            assert got.dtype == torch.float32
            close(got, want, TOL["float32"])

    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_rglru_apply(self, use_pallas):
        jp, tp = block_params(self.cfg)
        jx, tx = act(5, (2, 40, 64))
        tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                                   use_pallas=use_pallas)
        close(L.rglru_apply(tcfg, tp, tx), JL.rglru_apply(self.cfg, jp, jx),
              TOL["float32"])

    def test_gelu_and_softplus_match_jax(self):
        x = np.linspace(-30, 30, 4001).astype(np.float32)
        jx, tx = both(x)
        close(L.gelu(tx), jax.nn.gelu(jx), 1e-6)
        close(L.softplus(tx), jax.nn.softplus(jx), 1e-6)

    def test_bf16_constants_round_like_the_reference(self):
        assert L.round_to(torch.bfloat16, 0.044715) == \
            float(jnp.asarray(0.044715, jnp.bfloat16))
        assert L.round_to(torch.bfloat16, float(np.sqrt(2 / np.pi))) == \
            float(np.sqrt(2 / np.pi).astype(jnp.bfloat16))


# -- parameters ----------------------------------------------------------


def flat(tree):
    leaves, paths = pytree.flatten_with_paths(tree)
    return dict(zip(paths, leaves))


class TestParams:
    @pytest.mark.parametrize("full", [False, True])
    def test_specs_and_logical_axes_match_the_reference(self, full):
        jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
        if not full:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        jspecs = JT.param_specs(jcfg)
        jflat, _ = jax.tree_util.tree_flatten_with_path(jspecs)
        want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                for p, x in jflat}
        specs = T.param_specs(tcfg)
        assert {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
                for p, x in flat(specs).items()} == want
        jaxes, _ = jax.tree_util.tree_flatten_with_path(
            JT.param_logical_axes(jcfg, jspecs), is_leaf=_is_names)
        got = flat_names(T.param_logical_axes(tcfg, specs))
        assert got == {jax.tree_util.keystr(p): n for p, n in jaxes}

    def test_init_kinds(self):
        cfg = get_config(ARCH).reduced()
        p = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        mix = p["layers"][0]["mix"]
        assert mix["lam"].min() >= 4 and mix["lam"].max() < 6
        assert abs(mix["conv_w"].std().item() - 0.5) < 0.1
        assert abs(mix["ga_w"].std().item() - 1.0) < 0.2
        for k in ("conv_b", "ga_b", "gi_b"):
            assert torch.equal(mix[k], torch.zeros_like(mix[k]))
        assert abs(mix["wx"].std().item() * cfg.d_model ** 0.5 - 1) < 0.1


def _is_names(x):
    return isinstance(x, tuple) and len(x) > 0 and \
        all(isinstance(e, (str, type(None))) for e in x)


def flat_names(tree, prefix=""):
    """Key path -> logical names, in the reference's key-path spelling."""
    if _is_names(tree):
        return {prefix: tree}
    out = {}
    items = sorted(tree.items()) if isinstance(tree, dict) else \
        enumerate(tree)
    for k, v in items:
        out.update(flat_names(v, f"{prefix}[{k!r}]" if isinstance(k, str)
                              else f"{prefix}[{k}]"))
    return out


# -- the prefill step -----------------------------------------------------


class TestPrefillLogits:
    @pytest.mark.parametrize("use_pallas", [False, True])
    @pytest.mark.parametrize("num_layers", [3, 5])
    def test_matches_reference_prefill(self, num_layers, use_pallas):
        jcfg = dataclasses.replace(jax_config(ARCH).reduced(),
                                   num_layers=num_layers)
        tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                                   num_layers=num_layers,
                                   use_pallas=use_pallas)
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        # S = 48 > the reduced local window (16): the window mask cuts
        tokens = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (2, 48)).astype(np.int32)
        want_last = jax_prefill(jcfg)(jparams,
                                      {"tokens": jnp.asarray(tokens)})
        want_all = JT.forward(jcfg, jparams, jnp.asarray(tokens))
        params = T.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        tok = torch.from_numpy(tokens)
        close(make_prefill_step(tcfg)(params, {"tokens": tok}), want_last,
              LOGITS_TOL)
        close(T.forward(tcfg, params, tok), want_all, LOGITS_TOL)


# -- fused sites ----------------------------------------------------------


@pytest.fixture(scope="module")
def fused():
    # the full depth (8 super-blocks + a 2-layer tail) at reduced width
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_layers=26,
                              use_pallas=True)
    step = make_prefill_step(cfg)
    sess = Session(step, (T.param_specs(cfg), {
        "tokens": torch.empty((2, 64), dtype=torch.int32, device="meta")}))
    return cfg, step, sess


class TestFusedSites:
    def test_four_kernel_ops_with_trip_counts(self, fused):
        _, _, sess = fused
        prog = sess.artifacts.prog
        idx = [i for i, op in enumerate(prog.ops)
               if op.prim.startswith("kernel:")]
        assert [prog.ops[i].prim for i in idx] == ["kernel:rg_lru"] * 4
        assert all(prog.ops[i].params == {"kernel": "rg_lru"} for i in idx)
        assert [prog.trip_counts[i] for i in idx] == [8, 8, 1, 1]

    def test_roles_match_the_registry(self, fused):
        _, _, sess = fused
        prog, nda = sess.artifacts.prog, sess.artifacts.nda
        spec = registry.KERNELS["rg_lru"]
        for op in prog.ops:
            if op.prim != spec.prim:
                continue
            colors: dict = {}
            for roles, vid in list(zip(spec.operand_roles, op.operands)) + \
                    list(zip(spec.result_roles, op.results)):
                assert prog.types[vid].dtype == "float32"
                for role, c in zip(roles, nda.colors_of_value(vid)):
                    colors.setdefault(role, set()).add(c)
            assert all(len(c) == 1 for c in colors.values())
            assert len({next(iter(c)) for c in colors.values()}) == 3

    def test_eager_site_keys_follow_the_traced_ones(self, fused):
        cfg, step, sess = fused
        plan = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1))))
        traced = [r["site"] for r in plan.kernel_sites]
        assert traced == [f"rg_lru:{i}" for i in range(4)]
        assert all(r["impl"] == "cuda" for r in plan.kernel_sites)
        seen = []

        class Recording(KernelDispatch):
            def next_site(self, kernel):
                site = super().next_site(kernel)
                seen.append(site)
                return site

        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tok = torch.randint(0, cfg.vocab_size, (1, 16), dtype=torch.int32)
        with kernel_dispatch(Recording()):
            T.forward(cfg, params, tok)
        assert seen == ["rg_lru:0", "rg_lru:1"] * 8 + ["rg_lru:2",
                                                      "rg_lru:3"]
        got = plan.apply(step, device="cpu")(params, {"tokens": tok})
        torch.testing.assert_close(got, step(params, {"tokens": tok}),
                                   rtol=0, atol=0)


# -- repairs and the tracer -----------------------------------------------


class TestRepairs:
    def test_cuda_is_priced_as_the_reference_prices_pallas(self):
        spec, jspec = registry.KERNELS["rg_lru"], jregistry.KERNELS["rg_lru"]
        d = {"batch": 4, "seq": 4096, "channels": 3840}
        for db in (2, 4):
            assert spec.bytes_moved("cuda", d, {}, db) == \
                jspec.bytes_moved("pallas", d, {}, db) == 3.0 * 4 * 4096 * \
                3840 * db
            assert spec.bytes_moved("ref", d, {}, db) == \
                jspec.bytes_moved("ref", d, {}, db)
        assert spec.flops(d, {}) == jspec.flops(d, {})
        assert spec.impls == ("cuda", "ref")
        assert registry.cuda_feasible("rg_lru", {"channels": 131,
                                                 "seq": 1})

    def test_rnn_out_projection_is_named_rnn(self):
        cfg = get_config(ARCH)
        axes = T.param_logical_axes(cfg, T.param_specs(cfg))
        assert axes["layers"][0]["mix"]["wo"] == (None, "rnn", "embed")
        assert axes["layers"][2]["mix"]["wo"] == (None, "heads", "embed")
        assert axes["tail"][0]["mix"]["conv_w"] == (None, "rnn")


class TestTracerLowerings:
    def test_fills_lower_to_broadcast_literals(self):
        prog = extract_program(
            lambda x: torch.cat([torch.zeros_like(x), x.new_zeros(x.shape),
                                 torch.full(x.shape, 2.0, device=x.device),
                                 torch.zeros(x.shape, device=x.device)], 0),
            meta(2, 3))
        assert [op.prim for op in prog.ops] == ["broadcast_in_dim"] * 4 + \
            ["concatenate"]
        assert all(prog.ops[i].params["broadcast_dimensions"] == ()
                   for i in range(4))

    def test_slice_scatter_into_a_fill_is_a_pad(self):
        prog = extract_program(
            lambda x: torch.slice_scatter(x.new_zeros((2, 7, 3)), x, 1, 1,
                                          None, 2), meta(2, 3, 3))
        (op,) = prog.ops
        assert op.prim == "pad"
        assert op.params["padding_config"] == ((0, 0, 0), (1, 1, 1),
                                               (0, 0, 0))

    def test_raises_on_what_it_cannot_lower(self):
        with pytest.raises(UnsupportedOpError, match="constant fill"):
            extract_program(lambda x, y: torch.slice_scatter(x, y, 0, 0,
                                                             None, 2),
                            meta(4, 3), meta(2, 3))
        with pytest.raises(UnsupportedOpError, match="exponent"):
            extract_program(lambda x: x ** 2.5, meta(4))

    def test_elementwise_prims(self):
        prog = extract_program(
            lambda x: torch.where(x != x, 1.0 - x, torch.maximum(
                x, x.abs().sqrt()) + torch.log1p(x) ** 3), meta(4))
        assert [op.prim for op in prog.ops] == [
            "ne", "sub", "abs", "sqrt", "max", "log1p", "integer_pow",
            "add", "select_n"]
        sub = prog.ops[1]
        assert prog.types[sub.operands[0]].shape == ()
