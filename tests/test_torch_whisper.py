"""The port's ``whisper_small`` (encoder-decoder) against the JAX package.

The same inputs, made from a numpy seed, and the reference's own
parameters carried over by ``params_from_numpy`` go through both
packages on the CPU, at reduced width (``.reduced()``: 2 encoder layers,
d_model 64, 4 heads of 16).  The decoder is held at 2 and 4 layers.

Tolerances: each block (cross-attention prefill and its decode form step
by step, the GELU MLP, ``encode``) 1e-5 in f32 and 2e-2 in bf16, the
same bf16 weights and inputs in both packages; the models' logits and
final caches in f32 against the reference, and the port's decode against
its own forward: 1e-4; the reference's fused path (its Pallas kernel in
interpret mode, at an encoder length that is no multiple of the port's
128-row tile) against the port's plain sites: 1e-4.  Exact: the serve
loop's greedy tokens, ``param_logical_axes`` leaf by leaf (the
reference names a cross block's ``wo`` ``("hidden", "embed")``: its
parent key is ``cross``, not ``mix``), the carried parameters, the empty
caches, the abstract inputs and their logical names.  The plans are
``tests/test_torch_whisper_plans.py``'s.
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
from repro.models.sharding import KernelDispatch as JKernelDispatch
from repro.models.sharding import kernel_dispatch as jkernel_dispatch
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.partitioner import flatten_logical_axes
from repro_torch.launch import serve, specs
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
from repro_torch.train.steps import make_decode_step, make_train_step
from test_torch_decode import close, jtree_flat, normal, ttree_flat

ARCH = "whisper_small"
BLOCK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL = 1e-4
B, S, S_ENC = 2, 16, 24
DTYPES = ["float32", "bfloat16"]


def configs(num_layers=None, **kw):
    """The reference's and the port's reduced config, with ``kw``."""
    if num_layers is not None:
        kw["num_layers"] = num_layers
    return (dataclasses.replace(jax_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def to_port(tree):
    return T.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")


def as_j(a, dtype):
    return jnp.asarray(a).astype(dtype)


def as_t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def attn_params(jcfg, seed=1):
    jp = JL.init_attn(jcfg, jax.random.PRNGKey(seed))
    return jp, to_port(jp)


# -- the blocks -------------------------------------------------------------


class TestBlocks:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_cross_attention(self, dtype):
        jcfg, tcfg = configs(param_dtype=dtype)
        jp, tp = attn_params(jcfg)
        x, enc = normal(2, (B, S, 64)), normal(3, (B, S_ENC, 64))
        pos = np.arange(S, dtype=np.int32)[None]
        # the encoder's output comes in f32 and is cast to x's dtype
        want = JL.attn_apply(jcfg, jp, as_j(x, dtype), jnp.asarray(pos),
                             enc_out=jnp.asarray(enc))
        got = L.attn_apply(tcfg, tp, as_t(x, dtype), torch.from_numpy(pos),
                           enc_out=torch.from_numpy(enc))
        assert got.dtype == getattr(torch, dtype)
        close(got, want, BLOCK_TOL[dtype])

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_cross_attention_decode_steps(self, dtype):
        jcfg, tcfg = configs(param_dtype=dtype)
        jp, tp = attn_params(jcfg)
        xs, enc = normal(4, (B, 8, 64)), normal(5, (B, S_ENC, 64))
        full = L.attn_apply(tcfg, tp, as_t(xs, dtype),
                            torch.arange(8, dtype=torch.int32)[None],
                            enc_out=as_t(enc, dtype))
        for t in range(xs.shape[1]):
            want, jc = JL.attn_decode(jcfg, jp, as_j(xs[:, t:t + 1], dtype),
                                      None, jnp.int32(t),
                                      enc_out=as_j(enc, dtype))
            got, tc = L.attn_decode(tcfg, tp, as_t(xs[:, t:t + 1], dtype),
                                    None, torch.tensor(t, dtype=torch.int32),
                                    enc_out=as_t(enc, dtype))
            # no cross cache: the one handed in comes back
            assert jc is None and tc is None
            close(got, want, BLOCK_TOL[dtype])
            # a query attends to the same keys at every position
            close(got[:, 0], full[:, t].float().numpy(), BLOCK_TOL[dtype])

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_gelu_mlp(self, dtype):
        jcfg, tcfg = configs(param_dtype=dtype)
        jp = JL.init_mlp(jcfg, jax.random.PRNGKey(2))
        tp = to_port(jp)
        assert sorted(tp) == ["ln", "wi", "wo"]
        assert {k: s for k, (s, _) in L.mlp_param_shapes(tcfg).items()} == \
            {k: v.shape for k, v in jp.items()}
        x = normal(6, (B, S, 64)) * 3
        want = JL.mlp_apply(jcfg, jp, as_j(x, dtype))
        got = L.mlp_apply(tcfg, tp, as_t(x, dtype))
        close(got, want, BLOCK_TOL[dtype])

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_encode(self, dtype):
        jcfg, tcfg = configs(param_dtype=dtype)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
        tp = to_port(jp)
        frames = normal(7, (B, S_ENC, 64))
        want = JT.encode(jcfg, jp, jnp.asarray(frames))
        got = T.encode(tcfg, tp, torch.from_numpy(frames))
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == (B, S_ENC, 64)
        close(got, want, BLOCK_TOL[dtype])

    def test_reference_fused_path_at_a_ragged_encoder_length(self):
        # 150 frames: the reference's Pallas kernel (interpret mode) tiles
        # them in blocks of 75, the port's CUDA kernel in 128-row tiles
        # with a ragged last one; on the CPU the port's sites run the
        # plain version
        jcfg, tcfg = configs(use_pallas=True)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(4))
        tp = to_port(jp)
        frames = normal(8, (B, 150, 64))
        tokens = np.random.default_rng(9).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        with jkernel_dispatch(JKernelDispatch(default_impl="pallas",
                                              interpret=True)):
            want_enc, want = jax.jit(lambda p, t, f: (
                JT.encode(jcfg, p, f), JT.forward(jcfg, p, t, frames=f)))(
                    jp, jnp.asarray(tokens), jnp.asarray(frames))
        seen = []

        class Recording(KernelDispatch):
            def next_site(self, kernel):
                seen.append(super().next_site(kernel))
                return seen[-1]

        with kernel_dispatch(Recording(default_impl="ref")):
            got = T.forward(tcfg, tp, torch.from_numpy(tokens),
                            frames=torch.from_numpy(frames))
        # the encoder's site, then the decoder's, each for its own layers
        assert seen == ["flash_attention:0"] * 2 + \
            ["flash_attention:1"] * tcfg.num_layers
        close(got, want, TOL)
        close(T.encode(tcfg, tp, torch.from_numpy(frames)), want_enc, TOL)


# -- the models -------------------------------------------------------------


def reference_and_port(num_layers=None, seed=0):
    jcfg, tcfg = configs(num_layers)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, to_port(jp)


def inputs(seed, vocab, steps=S, frames=S_ENC):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, steps)).astype(np.int32),
            rng.standard_normal((B, frames, 64)).astype(np.float32))


def reference_loop(cfg, params, prompts, gen, enc_out):
    """The reference serve launcher's loop (``launch/serve.py``) with the
    encoder's output, on one device with no rules."""
    P = prompts.shape[1]
    dec = jax.jit(lambda *a: JT.decode_step(cfg, *a[:4], enc_out=a[4]))
    cache = JT.init_cache(cfg, B, P + gen)
    logits = None
    for t in range(P):
        logits, cache = dec(params, cache, prompts[:, t:t + 1],
                            jnp.int32(t), enc_out)
    tokens = [jnp.argmax(logits[:, 0], axis=-1, keepdims=True)]
    for g in range(gen - 1):
        logits, cache = dec(params, cache, tokens[-1], jnp.int32(P + g),
                            enc_out)
        tokens.append(jnp.argmax(logits[:, 0], axis=-1, keepdims=True))
    return np.asarray(jnp.concatenate(tokens, axis=1))


class TestModels:
    @pytest.mark.parametrize("num_layers", [2, 4])
    def test_forward_with_frames(self, num_layers):
        jcfg, tcfg, jp, tp = reference_and_port(num_layers)
        tokens, frames = inputs(6, jcfg.vocab_size)
        want = jax.jit(lambda p, t, f: JT.forward(jcfg, p, t, frames=f))(
            jp, jnp.asarray(tokens), jnp.asarray(frames))
        got = T.forward(tcfg, tp, torch.from_numpy(tokens),
                        frames=torch.from_numpy(frames))
        assert tuple(got.shape) == (B, S, jcfg.vocab_size)
        close(got, want, TOL)

    @pytest.mark.parametrize("num_layers", [2, 4])
    def test_decode_steps_and_caches(self, num_layers):
        jcfg, tcfg, jp, tp = reference_and_port(num_layers)
        steps = 12
        tokens, frames = inputs(7, jcfg.vocab_size, steps)
        jenc = JT.encode(jcfg, jp, jnp.asarray(frames))
        tenc = T.encode(tcfg, tp, torch.from_numpy(frames))
        jdec = jax.jit(lambda *a: JT.decode_step(jcfg, *a[:4], enc_out=a[4]))
        tdec = make_decode_step(tcfg)
        jc = JT.init_cache(jcfg, B, steps)
        tc = T.init_cache(tcfg, B, steps, device="cpu")
        for t in range(steps):
            jlog, jc = jdec(jp, jc, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.int32(t), jenc)
            tlog, tc = tdec(tp, tc, torch.from_numpy(tokens[:, t:t + 1]),
                            torch.tensor(t, dtype=torch.int32), tenc)
            close(tlog, jlog, TOL)
        want, got = jtree_flat(jc), ttree_flat(tc)
        assert list(got) == list(want)
        for path, x in got.items():
            close(x, want[path], TOL)

    def test_decode_reproduces_forward(self):
        # the reference's own check (tests/test_archs.py), on the port
        _, tcfg, _, tp = reference_and_port(4, seed=2)
        tokens, frames = inputs(9, tcfg.vocab_size)
        tokens, frames = torch.from_numpy(tokens), torch.from_numpy(frames)
        full = T.forward(tcfg, tp, tokens, frames=frames)
        enc_out = T.encode(tcfg, tp, frames)
        dec = make_decode_step(tcfg)
        cache = T.init_cache(tcfg, B, S, device="cpu")
        for t in range(S):
            logits, cache = dec(tp, cache, tokens[:, t:t + 1],
                                torch.tensor(t, dtype=torch.int32), enc_out)
            close(logits[:, 0], full[:, t].numpy(), TOL)

    def test_serve_loop_tokens_equal_the_reference_loop(self):
        jcfg, tcfg, jp, tp = reference_and_port(4, seed=3)
        prompts, frames = inputs(8, jcfg.vocab_size, 6)
        want = reference_loop(jcfg, jp, jnp.asarray(prompts), 10,
                              JT.encode(jcfg, jp, jnp.asarray(frames)))
        res = serve.serve_loop(make_decode_step(tcfg), tp,
                               T.init_cache(tcfg, B, 16, device="cpu"),
                               torch.from_numpy(prompts), 10,
                               T.encode(tcfg, tp, torch.from_numpy(frames)))
        np.testing.assert_array_equal(res.tokens.numpy(), want)

    def test_serve_cli_on_the_cpu(self, capsys):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--prompt-len", "4", "--gen", "4", "--batch", "2",
                    "--plan", "toast"])
        out = capsys.readouterr().out
        assert "[toast] cost=" in out and "ms/token" in out
        assert out.count("generated=") == 2

    def test_serves_on_two_ranks(self, tmp_path):
        # no longer refused (item 11g): the serving launcher runs on two
        # ranks, each encoding the frames before placement, the encoder's
        # output replicated; its tokens equal one process's
        from test_torch_xlstm_mesh_train import \
            check_entry_points_on_two_ranks
        check_entry_points_on_two_ranks(ARCH, tmp_path, training=False)

    def test_trains_on_two_ranks(self, tmp_path):
        # training is ported on one device (item 11f) and on meshes (item
        # 11g): the launcher trains on two ranks, the frames placed by the
        # rules as the tokens are, its loss within 1e-4 of one process's
        _, tcfg = configs()
        make_train_step(tcfg)
        _, (_, batch), (_, names) = specs.step_and_inputs(
            tcfg, ShapeConfig("s", 64, 4, "train"))
        assert tuple(batch["frames"].shape) == (4, 32, tcfg.d_model)
        assert tuple(batch["tokens"].shape) == (4, 32)
        assert tuple(batch["targets"].shape) == (4, 32)
        assert names["frames"] == ("batch", "seq", "embed")
        from test_torch_xlstm_mesh_train import \
            check_entry_points_on_two_ranks
        check_entry_points_on_two_ranks(ARCH, tmp_path, serving=False)


# -- parameters, caches, specs ---------------------------------------------


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
        c, m = "['layers'][0]['cross']", "['layers'][0]['mix']"
        # the reference's names, quirk included: a cross block's wo is
        # named as an MLP's
        assert got[c + "['wo']"] == (None, "hidden", "embed")
        assert got[m + "['wo']"] == (None, "heads", "embed")
        assert got[c + "['wq']"] == (None, "embed", "heads")
        assert got["['enc_layers']['mix']['wk']"] == \
            (None, "embed", "kv_heads")
        assert got["['enc_ln']"] == (None,)
        n = sum(x.numel() for x in pytree.tree_leaves(tp))
        if full:
            assert 0.27e9 < n < 0.29e9

    def test_params_from_numpy(self):
        _, _, jp, tp = reference_and_port()
        want, got = jtree_flat(jp), ttree_flat(tp)
        assert list(got) == list(want)
        assert any("['enc_layers']" in p for p in got)
        assert any("['cross']" in p for p in got)
        for path, x in got.items():
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[path]))

    def test_init_params_shapes(self):
        _, tcfg = configs()
        tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert ttree_flat(T.param_specs(tcfg)).keys() == ttree_flat(tp).keys()
        assert "wg" not in tp["enc_layers"]["ffn"]
        assert not (tp["enc_ln"] - 1).any()

    @pytest.mark.parametrize("num_layers", [2, 4])
    def test_init_cache_matches_the_reference(self, num_layers):
        # the decoder's self-attention rings only: no cross cache
        jcfg, tcfg = configs(num_layers)
        want = jtree_flat(JT.init_cache(jcfg, 2, 8))
        got = ttree_flat(T.init_cache(tcfg, 2, 8, device="cpu"))
        assert list(got) == list(want)
        assert sorted({p.split("]")[-2] + "]" for p in got}) == \
            ["['k']", "['slot_pos']", "['v']"]
        for path, x in got.items():
            assert tuple(x.shape) == want[path].shape, path
            assert str(x.dtype).removeprefix("torch.") == \
                str(want[path].dtype), path
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[path]))

    @pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
    @pytest.mark.parametrize("kind", ["prefill", "decode"])
    def test_specs_match_the_reference(self, kind, full):
        jcfg, tcfg = (jax_config(ARCH), get_config(ARCH)) if full else \
            configs()
        seq = 3000 if full else 64
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
        if kind == "prefill":
            assert got["[1]['frames']"][0] == (4, seq // 2, jcfg.d_model)
            assert got["[1]['tokens']"][0] == (4, seq // 2)
        else:
            assert len(targs) == 5
            assert tuple(targs[4].shape) == \
                (4, min(1500, seq // 2), jcfg.d_model)
            assert tnames[4] == ("batch", "seq", "embed")

    def test_kernel_sites_and_no_kv_pin(self):
        for cfg in (get_config(ARCH), configs(4)[1]):
            # the encoder's non-causal site and the decoder's causal one
            assert T.kernel_sites(cfg) == {"flash_attention": (2, 0),
                                           "rg_lru": (0, 0)}
            # the reference launcher pins no cache of an encoder-decoder
            assert serve.decode_request(cfg, None, None).constraints == ()
