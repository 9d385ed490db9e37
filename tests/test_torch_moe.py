"""The port's mixture-of-experts block and models against the JAX package.

``mixtral_8x22b`` and ``arctic_480b`` (its dense residual path) at
``.reduced()`` size in f32 (4 experts, top-2): the same inputs, made from
a numpy seed, and the reference's own parameters carried over by
``params_from_numpy``, go through both packages on the CPU.

Tolerances, all f32: the router's weights, the experts' FFN, every
dispatch mode of ``moe_apply`` (global, batch, local), each at the
reduced configs' capacity factor 4.0 (no token dropped) and at 1.0
(tokens dropped), the dense residual, ``forward``'s logits and
``decode_step``'s logits and caches over 24 steps: 1e-4.  Exact: the
greedy tokens of the serve loop, ``top_k``'s values and indices on
inputs full of ties, the tokens each expert selects, ``param_logical_axes``,
the MoE block's logical specs under the manual rules and the carried
parameters.  Training is held in ``tests/test_torch_moe_train.py``.

*Ties.*  ``lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order, so the port's ``layers.top_k`` is a
stable descending sort.  Duplicated tokens give identical router rows,
so their weights tie at the capacity cut and the tie order decides which
copy is dropped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.launch import specs as jspecs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.steps import make_decode_step as jax_decode
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.partitioner import flatten_logical_axes
from repro_torch.launch import serve, specs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_decode_step
from test_torch_decode import (close, jtree_flat, normal, reference_loop,
                               ttree_flat)

ARCHS = ["mixtral_8x22b", "arctic_480b"]
MODES = ["global", "batch", "local"]
TOL = 1e-4
B, S = 2, 32
# four sequence pools of 8 tokens in the local mode
POOLS = 4


def configs(arch, **kw):
    """The reference's and the port's reduced config, with ``kw``."""
    kw.setdefault("moe_local_pools", POOLS)
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def to_port(tree):
    return T.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")


def moe_params(jcfg, seed=0):
    jp = JL.init_moe(jcfg, jax.random.PRNGKey(seed))
    return jp, to_port(jp)


def both(jfn, tfn, *arrays):
    """``jfn`` and ``tfn`` on the same numpy arrays; numpy results."""
    want = jfn(*(jnp.asarray(a) for a in arrays))
    got = tfn(*(torch.from_numpy(a) for a in arrays))
    return got, want


# -- top_k ----------------------------------------------------------------


class TestTopK:
    @pytest.mark.parametrize("k", [1, 3, 16])
    def test_ties_break_as_lax_top_k(self, k):
        # values from a set of 4: every row is full of ties
        x = np.random.default_rng(k).integers(0, 4, (6, 5, 16)).astype(
            np.float32)
        (tv, ti), (jv, ji) = both(lambda a: jax.lax.top_k(a, k),
                                  lambda a: L.top_k(a, k), x)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.dtype == torch.int64

    def test_zero_weights_keep_their_order(self):
        # the capacity selection's case: a few routed weights and exact
        # zeros for every token routed elsewhere
        x = np.zeros((3, 40), np.float32)
        x[:, [5, 17, 30]] = [0.5, 0.25, 0.5]
        _, ti = L.top_k(torch.from_numpy(x), 40)
        _, ji = jax.lax.top_k(jnp.asarray(x), 40)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti[0, :3].tolist() == [5, 30, 17]

    @pytest.mark.parametrize("mode", MODES)
    def test_duplicated_tokens_drop_as_the_reference(self, mode):
        # every token four times: identical router rows, ties at the
        # capacity cut of factor 1.0
        jcfg, tcfg = configs("mixtral_8x22b", moe_dispatch=mode,
                             moe_capacity_factor=1.0)
        jp, tp = moe_params(jcfg)
        x = np.repeat(normal(1, (B, S // 4, jcfg.d_model)), 4, axis=1)
        got, want = both(lambda a: JL.moe_apply(jcfg, jp, a),
                         lambda a: L.moe_apply(tcfg, tp, a), x)
        close(got, want, TOL)
        # the tokens each expert of each row selects, cut inside ties
        C = L.capacity(tcfg, S, 1.0)
        (_, tsel), (_, jsel) = both(
            lambda a: jax.lax.top_k(JL._router(jcfg, jp, a).transpose(
                0, 2, 1), C),
            lambda a: L.top_k(L._router(tcfg, tp, a).transpose(1, 2), C), x)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))


# -- the block's parts ----------------------------------------------------


class TestParts:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_router(self, arch):
        jcfg, tcfg = configs(arch)
        jp, tp = moe_params(jcfg)
        h = normal(2, (B, S, jcfg.d_model))
        got, want = both(lambda a: JL._router(jcfg, jp, a),
                         lambda a: L._router(tcfg, tp, a), h)
        close(got, want, TOL)
        # top-2 of 4 experts: two non-zero weights a token, summing to 1
        assert ((got > 0).sum(-1) == 2).all()
        torch.testing.assert_close(got.sum(-1), torch.ones(B, S))

    @pytest.mark.parametrize("lead", [(), (B,), (B, POOLS)],
                             ids=["global", "batch", "local"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_expert_ffn(self, arch, lead):
        jcfg, tcfg = configs(arch)
        jp, tp = moe_params(jcfg)
        xe = normal(3, (*lead, jcfg.num_experts, 8, jcfg.d_model))
        got, want = both(lambda a: JL._expert_ffn(jp, a),
                         lambda a: L._expert_ffn(tp, a), xe)
        close(got, want, TOL)

    @pytest.mark.parametrize("capacity_factor", [4.0, 1.0],
                             ids=["no-drop", "drop"])
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("arch", ARCHS)
    def test_moe_apply(self, arch, mode, capacity_factor):
        jcfg, tcfg = configs(arch, moe_dispatch=mode,
                             moe_capacity_factor=capacity_factor)
        jp, tp = moe_params(jcfg)
        x = normal(4, (B, S, jcfg.d_model))
        got, want = both(lambda a: JL.moe_apply(jcfg, jp, a),
                         lambda a: L.moe_apply(tcfg, tp, a), x)
        close(got, want, TOL)
        n = dropped(tcfg, tp, torch.from_numpy(x))
        assert n == 0 if capacity_factor == 4.0 else n > 0

    def test_dense_residual(self):
        # arctic's block less the same block without its dense path is
        # the dense SwiGLU alone, in both packages
        jcfg, tcfg = configs("arctic_480b")
        jp, tp = moe_params(jcfg)
        assert {"dense_wi", "dense_wg", "dense_wo"} <= set(tp)
        jno, tno = configs("arctic_480b", moe_dense_residual=False)
        x = normal(5, (B, S, jcfg.d_model))
        got, want = both(
            lambda a: JL.moe_apply(jcfg, jp, a) - JL.moe_apply(jno, jp, a),
            lambda a: L.moe_apply(tcfg, tp, a) - L.moe_apply(tno, tp, a), x)
        close(got, want, TOL)
        assert got.abs().max() > 0.1


def dropped(cfg, p, x) -> int:
    """Routed (token, expert) pairs that find no room in ``cfg``'s
    dispatch of ``x``: each pool's routed pairs less those among the
    tokens its experts select."""
    W = L._router(cfg, p, L.rmsnorm(x, p["ln"]))
    pools = {"global": 1, "batch": B, "local": B * POOLS}[cfg.moe_dispatch]
    W = W.reshape(pools, -1, W.shape[-1])
    C = L.capacity(cfg, W.shape[1], cfg.moe_capacity_factor)
    wsel, _ = L.top_k(W.transpose(1, 2), C)
    return int((W > 0).sum() - (wsel > 0).sum())


# -- the models -----------------------------------------------------------


def _is_names(x):
    return isinstance(x, tuple) and len(x) > 0 and \
        all(isinstance(e, (str, type(None))) for e in x)


def reference_and_port(arch, seed=0):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, to_port(jp)


class TestModels:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_forward(self, arch):
        jcfg, tcfg, jp, tp = reference_and_port(arch)
        tokens = np.random.default_rng(6).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        got, want = both(lambda a: JT.forward(jcfg, jp, a),
                         lambda a: T.forward(tcfg, tp, a), tokens)
        assert tuple(got.shape) == (B, S, jcfg.vocab_size)
        close(got, want, TOL)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_decode_step_for_24_steps(self, arch):
        # past mixtral's 16-token window: its ring wraps
        jcfg, tcfg, jp, tp = reference_and_port(arch)
        steps, max_seq = 24, 32
        tokens = np.random.default_rng(7).integers(
            0, jcfg.vocab_size, (B, steps)).astype(np.int32)
        jdec, tdec = jax.jit(jax_decode(jcfg)), make_decode_step(tcfg)
        jc = JT.init_cache(jcfg, B, max_seq)
        tc = T.init_cache(tcfg, B, max_seq, device="cpu")
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

    @pytest.mark.parametrize("arch", ARCHS)
    def test_serve_loop_tokens_equal_the_reference_loop(self, arch):
        jcfg, tcfg, jp, tp = reference_and_port(arch, seed=3)
        prompts = np.random.default_rng(8).integers(
            0, jcfg.vocab_size, (B, 10)).astype(np.int32)
        want = reference_loop(jcfg, jp, jnp.asarray(prompts), 14)
        res = serve.serve_loop(make_decode_step(tcfg), tp,
                               T.init_cache(tcfg, B, 24, device="cpu"),
                               torch.from_numpy(prompts), 14)
        np.testing.assert_array_equal(res.tokens.numpy(), want)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_serve_cli_on_the_cpu(self, arch, capsys):
        # the default plan: the decode plans are test_torch_moe_plans.py's
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--prompt-len", "4", "--gen", "4", "--batch", "2"])
        out = capsys.readouterr().out
        assert "ms/token" in out and out.count("generated=") == 2


class TestParams:
    @pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_param_logical_axes(self, arch, full):
        jcfg, tcfg = jax_config(arch), get_config(arch)
        if not full:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        jp, tp = JT.param_specs(jcfg), T.param_specs(tcfg)
        assert {p: tuple(x.shape) for p, x in ttree_flat(tp).items()} == \
            {p: x.shape for p, x in jtree_flat(jp).items()}
        flat, _ = jax.tree_util.tree_flatten_with_path(
            JT.param_logical_axes(jcfg, jp), is_leaf=_is_names)
        want = {jax.tree_util.keystr(k): v for k, v in flat}
        got = dict(zip(pytree.flatten_with_paths(tp)[1],
                       flatten_logical_axes(T.param_logical_axes(tcfg, tp))))
        assert got == want
        ffn = "['layers'][0]['ffn']"
        assert got[ffn + "['wi']"] == (None, "experts", "embed", "hidden")
        assert got[ffn + "['wo']"] == (None, "experts", "hidden", "embed")
        assert got[ffn + "['wg']"] == (None, "embed", "experts")

    @pytest.mark.parametrize("arch", ARCHS)
    def test_params_from_numpy(self, arch):
        jcfg, _, jp, tp = reference_and_port(arch)
        want, got = jtree_flat(jp), ttree_flat(tp)
        assert list(got) == list(want)
        for path, x in got.items():
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[path]))
        wi = got["['layers'][0]['ffn']['wi']"]
        assert tuple(wi.shape) == (jcfg.num_layers, jcfg.num_experts,
                                   jcfg.d_model, jcfg.d_ff)

    @pytest.mark.parametrize("kind", ["prefill", "decode"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_specs_match_the_reference(self, arch, kind):
        jcfg, tcfg = jax_config(arch), get_config(arch)
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

    def test_constrain_takes_the_moe_specs(self):
        # the MoE block's logical specs, None entries and the rank-sliced
        # ones of _expert_ffn, under the manual rules: the reference's
        from repro.models import sharding as JS
        from repro_torch.models import sharding as TS
        ffn = ("act_batch", "experts", None, "hidden")
        names = [("experts", None, None), ("act_batch", "experts", None,
                                           None),
                 ("act_batch", "seq", "experts", None, None), ffn[-3:],
                 ffn[-4:], ffn[-5:]]
        with JS.logical_rules(JS.MANUAL_RULES), \
                TS.logical_rules(TS.MANUAL_RULES):
            for n in names:
                assert tuple(TS.spec_for(n)) == tuple(JS.spec_for(n)), n

    def test_moe_train_cell_builds(self):
        """No guard is left on MoE training (meshes:
        ``tests/test_torch_moe_mesh.py`` and
        ``tests/test_torch_moe_mesh_train*.py``): ``specs.step_and_inputs``
        builds an MoE train cell as it builds a dense one."""
        from repro_torch.train import steps as TS
        cfg = get_config("mixtral_8x22b").reduced()
        fn, args, _ = specs.step_and_inputs(cfg,
                                            ShapeConfig("s", 64, 4, "train"))
        assert callable(fn) and len(args) == 2
        assert not hasattr(TS, "check_trainable")
        for c in (cfg, get_config("arctic_480b"), get_config("qwen2_05b")):
            assert callable(TS.make_train_step(c))
        assert not hasattr(T, "check_devices")
