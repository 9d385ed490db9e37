"""The port's decode path against the JAX package: the block decode
forms, the caches, the decode step, ``launch/specs.py``, the serve loop
and the tracer's lowerings for what the decode step exports.

The same inputs, made from a numpy seed (or the reference's parameters
carried over by ``params_from_numpy``), go through the reference and
the port on the CPU.  Tolerances, all f32: the conv with state 1e-6;
one block's decode 1e-5; the decode step's logits and every cache leaf
at every step 1e-4 (24 steps, past the hybrid's 16-token local window,
so its ring buffer wraps); the caches and the specs' names exactly; the
greedy tokens of the serve loop exactly.  The tracer's lowerings give
the same color partition of inputs and outputs, conflicts and compat
sets as the reference's tracer on micro-programs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core import conflicts as j_conflicts
from repro.core import nda as j_nda
from repro.core.ir import extract_program as jax_extract
from repro.launch import specs as jspecs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.steps import make_decode_step as jax_decode
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import conflicts as t_conflicts
from repro_torch.core import nda as t_nda
from repro_torch.core.ir import UnsupportedOpError, extract_program
from repro_torch.core.partitioner import PartitionSpec
from repro_torch.launch import serve, specs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_decode_step
from test_torch_core import io_color_labels

ARCHS = ["qwen2_05b", "phi3_mini", "recurrentgemma_2b"]
CONV_TOL = 1e-6
BLOCK_TOL = 1e-5
STEP_TOL = 1e-4


def to_port(tree):
    """A reference tree (params, caches) as CPU tensors of its dtypes."""
    return T.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jtree_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): x for p, x in flat}


def ttree_flat(tree):
    leaves, paths = pytree.flatten_with_paths(tree)
    return dict(zip(paths, leaves))


# -- the block decode forms -----------------------------------------------


class TestBlockDecode:
    def test_causal_conv4_with_state(self):
        cfg = jax_config("recurrentgemma_2b").reduced()
        jp = JL.init_rglru(cfg, jax.random.PRNGKey(0))
        tp = to_port(jp)
        b = normal(1, (96,))
        for S in (1, 5):
            u, state = normal(2 + S, (2, S, 96)), normal(9 + S, (2, 3, 96))
            jout, jstate = JL._causal_conv4(jnp.asarray(u), jp["conv_w"],
                                            jnp.asarray(b), jnp.asarray(state))
            tout, tstate = L._causal_conv4(torch.from_numpy(u), tp["conv_w"],
                                           torch.from_numpy(b),
                                           torch.from_numpy(state))
            close(tout, jout, CONV_TOL)
            close(tstate, jstate, 0)

    def test_zero_state_is_the_prefill_form(self):
        u, w, b = (torch.from_numpy(normal(s, sh)) for s, sh in
                   ((0, (2, 7, 8)), (1, (4, 8)), (2, (8,))))
        out, state = L._causal_conv4(u, w, b)
        out0, state0 = L._causal_conv4(u, w, b, torch.zeros(2, 3, 8))
        assert torch.equal(out, out0) and torch.equal(state, state0)

    @pytest.mark.parametrize("arch,window,pos", [
        ("qwen2_05b", 0, 21), ("recurrentgemma_2b", 16, 21),
        ("recurrentgemma_2b", 16, 5)])
    def test_attn_decode(self, arch, window, pos):
        jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
        jp = JL.init_attn(jcfg, jax.random.PRNGKey(1))
        if jcfg.qkv_bias:
            for k in ("bq", "bk", "bv"):
                jp[k] = jnp.asarray(0.1 * normal(len(k), jp[k].shape))
        tp = to_port(jp)
        B, T_, kv, hd = 2, window or 24, jcfg.num_kv_heads, 16
        # a ring that held positions up to pos - 1, the rest empty
        slot_pos = np.full((T_,), -1, np.int32)
        for p_ in range(pos):
            slot_pos[p_ % T_] = p_
        cache = {"k": normal(3, (B, T_, kv, hd)), "v": normal(4, (B, T_, kv,
                                                                   hd)),
                 "slot_pos": slot_pos}
        x = normal(5, (B, 1, jcfg.d_model))
        jout, jc = JL.attn_decode(jcfg, jp, jnp.asarray(x),
                                  jax.tree_util.tree_map(jnp.asarray, cache),
                                  jnp.int32(pos), window=window)
        tout, tc = L.attn_decode(tcfg, tp, torch.from_numpy(x),
                                 to_port(cache),
                                 torch.tensor(pos, dtype=torch.int32),
                                 window=window)
        close(tout, jout, BLOCK_TOL)
        for k in ("k", "v"):
            close(tc[k], jc[k], BLOCK_TOL)
        assert tc["slot_pos"].dtype == torch.int32
        np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))

    def test_rglru_decode(self):
        jcfg = jax_config("recurrentgemma_2b").reduced()
        tcfg = get_config("recurrentgemma_2b").reduced()
        jp = JL.init_rglru(jcfg, jax.random.PRNGKey(2))
        for k in ("conv_b", "ga_b", "gi_b"):
            jp[k] = jnp.asarray(0.1 * normal(len(k), jp[k].shape))
        tp = to_port(jp)
        cache = {"h": normal(6, (2, 96)), "conv": normal(7, (2, 3, 96))}
        x = normal(8, (2, 1, 64))
        jout, jc = JL.rglru_decode(jcfg, jp, jnp.asarray(x),
                                   jax.tree_util.tree_map(jnp.asarray, cache),
                                   jnp.int32(9))
        tout, tc = L.rglru_decode(tcfg, tp, torch.from_numpy(x),
                                  to_port(cache),
                                  torch.tensor(9, dtype=torch.int32))
        close(tout, jout, BLOCK_TOL)
        assert tc["h"].dtype == torch.float32
        close(tc["h"], jc["h"], BLOCK_TOL)
        close(tc["conv"], jc["conv"], BLOCK_TOL)

    def test_cross_attention_decode_raises(self):
        # cross-attention decode is ported (item 11b): it no longer
        # raises, and matches the reference, handing the cache back
        jcfg, tcfg = jax_config("qwen2_05b").reduced(), \
            get_config("qwen2_05b").reduced()
        jp = JL.init_attn(jcfg, jax.random.PRNGKey(0))
        x, enc = normal(1, (2, 1, 64)), normal(2, (2, 6, 64))
        want, jc = JL.attn_decode(jcfg, jp, jnp.asarray(x), None,
                                  jnp.int32(3), enc_out=jnp.asarray(enc))
        got, tc = L.attn_decode(tcfg, to_port(jp), torch.from_numpy(x),
                                None, torch.tensor(3, dtype=torch.int32),
                                enc_out=torch.from_numpy(enc))
        assert jc is None and tc is None
        close(got, want, BLOCK_TOL)


# -- the caches -----------------------------------------------------------


class TestInitCache:
    @pytest.mark.parametrize("max_seq", [8, 40])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_leaves_match_the_reference(self, arch, max_seq):
        jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
        want = jtree_flat(JT.init_cache(jcfg, 2, max_seq))
        got = ttree_flat(T.init_cache(tcfg, 2, max_seq, device="cpu"))
        assert list(got) == list(want)
        for path, x in got.items():
            assert tuple(x.shape) == want[path].shape, path
            assert str(x.dtype).removeprefix("torch.") == \
                str(want[path].dtype), path
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[path]))
        metas = ttree_flat(T.init_cache(tcfg, 2, max_seq, device="meta"))
        assert all(x.is_meta for x in metas.values())
        assert {p: tuple(x.shape) for p, x in metas.items()} == \
            {p: tuple(x.shape) for p, x in got.items()}

    def test_local_ring_is_the_window(self):
        cfg = get_config("recurrentgemma_2b").reduced()
        cache = T.init_cache(cfg, 1, 40, device="cpu")
        assert cache["layers"][2]["k"].shape[2] == cfg.local_window == 16
        assert cache["layers"][0]["h"].shape == (1, 1, 96)

    def test_unported_kinds_raise(self):
        # every kind's cache is ported (xLSTM item 11a, whisper item 11b):
        # whisper's is the decoder's self-attention rings, as the
        # reference's (no cross-attention cache)
        T.init_cache(get_config("xlstm_350m").reduced(), 1, 8, device="cpu")
        want = jtree_flat(JT.init_cache(
            jax_config("whisper_small").reduced(), 1, 8))
        got = ttree_flat(T.init_cache(get_config("whisper_small").reduced(),
                                      1, 8, device="cpu"))
        assert {p: tuple(x.shape) for p, x in got.items()} == \
            {p: x.shape for p, x in want.items()}
        assert {p.rsplit("[", 1)[1] for p in got} == \
            {"'k']", "'v']", "'slot_pos']"}

    def test_no_card_no_cache(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_cache(get_config("qwen2_05b").reduced(), 1, 8)


# -- the decode step ------------------------------------------------------


def reference_and_port(arch, seed=0):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, to_port(jp)


class TestDecodeStep:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_matches_the_reference_for_24_steps(self, arch):
        jcfg, tcfg, jp, tp = reference_and_port(arch)
        B, steps, max_seq = 2, 24, 32
        tokens = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (B, steps)).astype(np.int32)
        jdec = jax.jit(jax_decode(jcfg))
        tdec = make_decode_step(tcfg)
        jc = JT.init_cache(jcfg, B, max_seq)
        tc = T.init_cache(tcfg, B, max_seq, device="cpu")
        for t in range(steps):
            jlog, jc = jdec(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.int32(t))
            tlog, tc = tdec(tp, tc, torch.from_numpy(tokens[:, t:t + 1]),
                            torch.tensor(t, dtype=torch.int32))
            assert tuple(tlog.shape) == (B, 1, jcfg.vocab_size)
            close(tlog, jlog, STEP_TOL)
            want = jtree_flat(jc)
            got = ttree_flat(tc)
            assert list(got) == list(want)
            for path, x in got.items():
                close(x, want[path], STEP_TOL)
        if arch == "recurrentgemma_2b":
            # the local ring wrapped: every slot holds one of the last 16
            slot_pos = tc["layers"][2]["slot_pos"][0]
            assert sorted(slot_pos.tolist()) == list(range(8, 24))

    def test_the_old_cache_is_not_written(self):
        _, tcfg, _, tp = reference_and_port("recurrentgemma_2b")
        cache = T.init_cache(tcfg, 2, 8, device="cpu")
        before = [x.clone() for x in pytree.tree_leaves(cache)]
        T.decode_step(tcfg, tp, cache, torch.zeros(2, 1, dtype=torch.int32),
                      torch.tensor(0, dtype=torch.int32))
        assert all(torch.equal(a, b) for a, b in
                   zip(before, pytree.tree_leaves(cache)))


def stepped_logits(cfg, params, tokens, max_seq):
    """Decode ``tokens`` one by one; (B, S, V) logits."""
    B, S = tokens.shape
    cache = T.init_cache(cfg, B, max_seq, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = T.decode_step(cfg, params, cache,
                                      tokens[:, t:t + 1],
                                      torch.tensor(t, dtype=torch.int32))
        outs.append(logits[:, 0])
    return torch.stack(outs, 1)


class TestDecodeMatchesForward:
    """Token-by-token decode reproduces the teacher-forced forward
    logits, as the reference's own ``test_decode_matches_forward`` and
    ``test_ring_buffer_windowed_decode`` check it."""

    @pytest.mark.parametrize("arch", ARCHS)
    def test_decode_matches_forward(self, arch):
        cfg = get_config(arch).reduced()
        params = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
        B, S = 2, 24
        tokens = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(3),
                               dtype=torch.int32)
        close(stepped_logits(cfg, params, tokens, S),
              T.forward(cfg, params, tokens).numpy(), STEP_TOL)

    def test_ring_buffer_windowed_decode(self):
        # a sliding window on the dense model, and a cache the window's
        # size: the ring wraps after 16 of the 24 tokens
        cfg = dataclasses.replace(get_config("qwen2_05b").reduced(),
                                  sliding_window=16)
        params = T.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
        tokens = torch.randint(0, cfg.vocab_size, (1, 24),
                               generator=torch.Generator().manual_seed(5),
                               dtype=torch.int32)
        close(stepped_logits(cfg, params, tokens, cfg.sliding_window),
              T.forward(cfg, params, tokens).numpy(), STEP_TOL)

    def test_scan_layers_stacks_ys_like_lax_scan(self):
        ws = torch.from_numpy(normal(6, (3, 4, 4)))
        h0 = torch.from_numpy(normal(7, (2, 4)))

        def body(h, w):
            h = torch.tanh(h @ w)
            return h, {"h": h, "w": w[0]}

        h, ys = T.scan_layers(body, h0, ws, with_ys=True)
        jh, jys = jax.lax.scan(
            lambda c, w: (jnp.tanh(c @ w), {"h": jnp.tanh(c @ w),
                                            "w": w[0]}),
            jnp.asarray(h0.numpy()), jnp.asarray(ws.numpy()))
        close(h, jh, 1e-6)
        close(ys["h"], jys["h"], 1e-6)
        assert torch.equal(ys["w"], ws[:, 0])


# -- launch/specs.py -------------------------------------------------------


def _is_names(x):
    return x is None or (isinstance(x, tuple) and len(x) > 0 and
                         all(isinstance(e, (str, type(None))) for e in x))


def spec_leaves(tree):
    """The specs of a tree of ``PartitionSpec`` leaves, in flattening
    order."""
    if isinstance(tree, PartitionSpec):
        return [tree]
    kids = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) \
        else tree
    return [s for kid in kids for s in spec_leaves(kid)]


class TestSpecs:
    @pytest.mark.parametrize("full", [False, True])
    @pytest.mark.parametrize("kind", ["prefill", "decode"])
    @pytest.mark.parametrize("arch", ["qwen2_05b", "recurrentgemma_2b"])
    def test_inputs_and_names_match_the_reference(self, arch, kind, full):
        jcfg, tcfg = jax_config(arch), get_config(arch)
        if not full:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        S = 256 if kind == "decode" else 64
        _, jargs, jnames = jspecs.step_and_inputs(
            jcfg, JShapeConfig("s", S, 4, kind))
        _, targs, tnames = specs.step_and_inputs(
            tcfg, ShapeConfig("s", S, 4, kind))
        want = {p: (x.shape, str(x.dtype)) for p, x in
                jtree_flat(jargs).items()}
        got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
               for p, x in ttree_flat(targs).items()}
        assert got == want
        assert all(x.is_meta for x in pytree.tree_leaves(targs))
        jflat = jax.tree_util.tree_leaves(jnames, is_leaf=_is_names)
        from repro_torch.core.partitioner import flatten_logical_axes
        assert flatten_logical_axes(tnames) == jflat

    def test_what_is_not_ported_raises(self):
        # the train kind is ported (item 4), an encoder-decoder's too
        # (item 11f), with the frames in half the positions; its decode
        # step is (item 11b), with a fifth input, the encoder's output
        _, (_, batch), _ = specs.step_and_inputs(
            get_config("whisper_small").reduced(),
            ShapeConfig("s", 64, 4, "train"))
        assert sorted(batch) == ["frames", "targets", "tokens"]
        assert tuple(batch["frames"].shape) == (4, 32, 64)
        _, args, names = specs.step_and_inputs(
            get_config("whisper_small").reduced(),
            ShapeConfig("s", 64, 4, "decode"))
        assert tuple(args[4].shape) == (4, 32, 64)
        assert names[4] == ("batch", "seq", "embed")

    def test_specs_from_rules_match_the_reference(self):
        jcfg, tcfg = jax_config("qwen2_05b").reduced(), \
            get_config("qwen2_05b").reduced()
        rules = {"batch": ("data",), "kv_heads": ("model", "data"),
                 "heads": ("model",), "vocab": ("model",),
                 "hidden": ("data", "model")}
        sizes = {"data": 2, "model": 4}
        _, jargs, jnames = jspecs.step_and_inputs(
            jcfg, JShapeConfig("s", 32, 4, "decode"))
        _, targs, tnames = specs.step_and_inputs(
            tcfg, ShapeConfig("s", 32, 4, "decode"))
        want = jax.tree_util.tree_leaves(jspecs.specs_from_rules(
            jargs, jnames, rules, sizes), is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))
        got = spec_leaves(specs.specs_from_rules(targs, tnames, rules,
                                                 sizes))
        assert len(got) == len(pytree.tree_leaves(targs))
        assert [tuple(s) for s in got] == [tuple(s) for s in want]


# -- the serving launcher -----------------------------------------------------


def reference_loop(cfg, params, prompts, gen):
    """The reference serve launcher's loop (``launch/serve.py``), on one
    device with no rules."""
    B, P = prompts.shape
    dec = jax.jit(jax_decode(cfg))
    cache = JT.init_cache(cfg, B, P + gen)
    logits = None
    for t in range(P):
        logits, cache = dec(params, cache, prompts[:, t:t + 1],
                            jnp.int32(t))
    tokens = [jnp.argmax(logits[:, 0], axis=-1, keepdims=True)]
    for g in range(gen - 1):
        logits, cache = dec(params, cache, tokens[-1], jnp.int32(P + g))
        tokens.append(jnp.argmax(logits[:, 0], axis=-1, keepdims=True))
    return np.asarray(jnp.concatenate(tokens, axis=1))


class TestServe:
    @pytest.mark.parametrize("arch", ["qwen2_05b", "recurrentgemma_2b"])
    def test_same_greedy_tokens_as_the_reference_loop(self, arch):
        jcfg, tcfg, jp, tp = reference_and_port(arch, seed=3)
        prompts = np.random.default_rng(4).integers(
            0, jcfg.vocab_size, (2, 10)).astype(np.int32)
        want = reference_loop(jcfg, jp, jnp.asarray(prompts), 14)
        res = serve.serve_loop(make_decode_step(tcfg), tp,
                               T.init_cache(tcfg, 2, 24, device="cpu"),
                               torch.from_numpy(prompts), 14)
        np.testing.assert_array_equal(res.tokens.numpy(), want)
        assert res.tokens.dtype == torch.int32
        assert len(res.step_ms) == 13 and res.prefill_ms > 0
        assert tuple(res.prompt_logits.shape) == (2, 1, jcfg.vocab_size)

    def test_the_applied_plan_serves_the_same_tokens(self):
        cfg = get_config("qwen2_05b").reduced()
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        prompts = torch.randint(0, cfg.vocab_size, (2, 6),
                                generator=torch.Generator().manual_seed(1),
                                dtype=torch.int32)
        sess, names = serve.decode_session(cfg, 2, 12)
        plan = sess.partition(serve.decode_request(
            cfg, names, serve.MeshSpec(("data", "model"), (1, 1))))
        assert plan.kernel_sites == []
        dec = make_decode_step(cfg)
        got = serve.serve_loop(plan.apply(dec, device="cpu"), params,
                               T.init_cache(cfg, 2, 12, device="cpu"),
                               prompts, 6)
        want = serve.serve_loop(dec, params,
                                T.init_cache(cfg, 2, 12, device="cpu"),
                                prompts, 6)
        assert torch.equal(got.tokens, want.tokens)

    def test_rules_on_one_device_and_more(self):
        cfg = get_config("qwen2_05b").reduced()
        assert serve.toast_decode_rules(cfg, 4, 32, 1) == ({}, None)
        # two devices: the (1, 2) plan's rules, on a mesh over the process
        # group, which a lone process lacks (served on ranks in
        # tests/test_torch_serve_mesh.py)
        assert serve.decode_plan(cfg, 4, 32, 2).mesh.sizes == (1, 2)
        with pytest.raises(RuntimeError, match="initialised process group"):
            serve.toast_decode_rules(cfg, 4, 32, 2, "cpu")

    def test_the_request_pins_the_kv_cache(self):
        dense = get_config("qwen2_05b").reduced()
        mesh = serve.MeshSpec(("data", "model"), (2, 2))
        req = serve.decode_request(dense, None, mesh)
        assert (req.backend, req.min_dims) == ("greedy", 4)
        assert [c.target for c in req.constraints] == ["['k']", "['v']"]
        hybrid = get_config("recurrentgemma_2b").reduced()
        assert serve.decode_request(hybrid, None, mesh).constraints == ()

    def test_cli_on_the_cpu(self, capsys):
        serve.main(["--reduced", "--device", "cpu", "--plan", "toast",
                    "--prompt-len", "4", "--gen", "4", "--batch", "2"])
        out = capsys.readouterr().out
        assert "[toast] cost=" in out and "ms/token" in out
        assert out.count("generated=") == 2

    def test_cli_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--reduced", "--gen", "2"])


# -- the tracer's lowerings ---------------------------------------------------


def jsd(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def tmeta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def j_ring(c, u, pos):
    slot = (pos % c.shape[1]).astype(jnp.int32)
    return jax.lax.dynamic_update_slice(c, u, (0, slot, 0))


def t_ring(c, u, pos):
    return c.index_copy(1, (pos % c.shape[1]).to(torch.int64)[None], u)


def j_masks(x, pos):
    m = (x % 3 == 0) & (x <= pos)
    return jnp.where(m[:, None, None], 1.0, 0.0)


def t_masks(x, pos):
    m = (x % 3 == 0) & (x <= pos)
    return torch.where(m[:, None, None], 1.0, 0.0)


MICRO = {
    # decode's ring write: dynamic_update_slice at a scalar slot
    "ring": (j_ring, t_ring,
             [((4, 16, 8), "float32"), ((4, 1, 8), "float32"),
              ((), "int32")]),
    # rem, eq, le, and a chain of Nones as one broadcast
    "masks": (j_masks, t_masks, [((6,), "int32"), ((), "int32")]),
    # a[:, 0]: slice + squeeze
    "select": (lambda a, h: a[:, 0] * h, lambda a, h: a[:, 0] * h,
               [((4, 1, 8), "float32"), ((4, 8), "float32")]),
}


class TestTracerLowerings:
    @pytest.mark.parametrize("name", sorted(MICRO))
    def test_same_colors_and_conflicts_as_reference(self, name):
        jfn, tfn, shapes = MICRO[name]
        jprog = jax_extract(jfn, *(jsd(s, getattr(jnp, d))
                                   for s, d in shapes))
        tprog = extract_program(tfn, *(tmeta(s, getattr(torch, d))
                                       for s, d in shapes))
        jres, tres = j_nda.run_nda(jprog), t_nda.run_nda(tprog)
        assert io_color_labels(jprog, jres) == io_color_labels(tprog, tres)
        jca = j_conflicts.analyze_conflicts(jres)
        tca = t_conflicts.analyze_conflicts(tres)
        assert len(jca.conflicts) == len(tca.conflicts)
        assert [cs.signature for cs in jca.compat_sets] == \
            [cs.signature for cs in tca.compat_sets]
        assert jca.num_resolution_bits == tca.num_resolution_bits
        # every prim the port emits is one the reference emits too
        assert {op.prim for op in tprog.ops} <= {op.prim for op in jprog.ops}

    def test_ring_write_is_one_dynamic_update_slice(self):
        prog = extract_program(t_ring, tmeta((4, 16, 8)), tmeta((4, 1, 8)),
                               tmeta((), torch.int32))
        (dus,) = [op for op in prog.ops if op.prim == "dynamic_update_slice"]
        c, u, pos = prog.inputs
        assert dus.operands[:2] == [c, u]
        starts = dus.operands[2:]
        assert [prog.types[s].shape for s in starts] == [()] * 3
        # the fixed dims' starts are literals, the written one is computed
        producers = {r for op in prog.ops for r in op.results}
        assert [s in producers for s in starts] == [False, True, False]
        assert not any(op.prim == "broadcast_in_dim" for op in prog.ops)
        assert [op.prim for op in prog.ops] == [
            "rem", "convert_element_type", "dynamic_update_slice"]

    def test_none_chain_is_one_broadcast(self):
        prog = extract_program(lambda m: m[:, None, None],
                               tmeta((2, 3, 5), torch.bool))
        (op,) = prog.ops
        assert op.prim == "broadcast_in_dim"
        assert op.params["broadcast_dimensions"] == (0, 3, 4)
        assert op.params["shape"] == (2, 1, 1, 3, 5)

    def test_what_it_cannot_lower_still_raises(self):
        with pytest.raises(UnsupportedOpError, match="one scalar slot"):
            extract_program(lambda c, u, i: c.index_copy(1, i, u),
                            tmeta((4, 16, 8)), tmeta((4, 2, 8)),
                            tmeta((2,), torch.int64))
        with pytest.raises(UnsupportedOpError, match="flip"):
            extract_program(lambda x: torch.flip(x, [0]) @ x, tmeta((4, 4)))

    def test_decode_step_keeps_pos_a_traced_input(self):
        cfg = get_config("qwen2_05b").reduced()
        _, args, _ = specs.step_and_inputs(cfg, ShapeConfig("s", 32, 4,
                                                            "decode"))
        prog = extract_program(make_decode_step(cfg), *args)
        assert prog.input_paths[-1] == "[0][3]"
        pos = prog.inputs[-1]
        assert prog.types[pos].shape == () and prog.types[pos].dtype == \
            "int32"
        assert sum(op.prim == "dynamic_update_slice" for op in prog.ops) == 3
        assert any(pos in op.operands for op in prog.ops
                   if op.prim == "rem")
