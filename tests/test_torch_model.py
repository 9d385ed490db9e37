"""The port's configs and dense model against the JAX package.

The reference's parameters (drawn with ``jax.random``) are carried into
the port with ``params_from_numpy``; tokens come from a numpy seed.  The
port's prefill step — einsum path and fused-kernel path (on CPU tensors
the fused op is the kernel's plain version) — must match the
reference's einsum-path ``make_prefill_step`` on the reduced f32
configs within atol = rtol = 1e-4 (f32 sums taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import get_config as jax_config
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch import pytree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
from repro_torch.train.steps import make_prefill_step

TOL = 1e-4


class TestConfigs:
    @pytest.mark.parametrize("arch", J_ARCH_IDS)
    def test_fields_match_the_reference(self, arch):
        assert ARCH_IDS == J_ARCH_IDS
        for j, t in [(jax_config(arch), get_config(arch)),
                     (jax_config(arch).reduced(), get_config(arch).reduced())]:
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert str(t.dtype) == f"torch.{j.param_dtype}"


def flat_shapes(tree):
    leaves, paths = pytree.flatten_with_paths(tree)
    return {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in zip(paths, leaves)}


class TestParams:
    @pytest.mark.parametrize("arch", ["qwen2_05b", "phi3_mini",
                                      "llama3_405b"])
    def test_param_specs_match_the_reference(self, arch):
        for jcfg, tcfg in [(jax_config(arch), get_config(arch)),
                           (jax_config(arch).reduced(),
                            get_config(arch).reduced())]:
            jflat, jpaths = jax.tree_util.tree_flatten_with_path(
                JT.param_specs(jcfg))
            want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                    for p, x in jflat}
            specs = T.param_specs(tcfg)
            assert all(x.device.type == "meta"
                       for x in pytree.tree_leaves(specs))
            assert flat_shapes(specs) == want

    def test_logical_axes_match_the_reference(self):
        jcfg, tcfg = jax_config("qwen2_05b"), get_config("qwen2_05b")
        want = jax.tree_util.tree_leaves(
            JT.param_logical_axes(jcfg, JT.param_specs(jcfg)),
            is_leaf=_is_names)
        got = list(_name_leaves(T.param_logical_axes(
            tcfg, T.param_specs(tcfg))))
        assert got == want

    def test_init_params_is_seeded_and_scaled(self):
        cfg = get_config("qwen2_05b").reduced()
        a = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        b = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
            assert torch.equal(x, y)
        wq = a["layers"][0]["mix"]["wq"]
        assert wq.shape == (cfg.num_layers, cfg.d_model, 64)
        assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1
        assert torch.equal(a["final_ln"], torch.ones(cfg.d_model))

    def test_entry_points_need_a_card_or_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        cfg = get_config("qwen2_05b").reduced()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.params_from_numpy({"w": np.zeros(3, np.float32)})

    def test_params_from_numpy_keeps_bfloat16_exactly(self):
        x = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(
            jnp.bfloat16)
        got = T.params_from_numpy({"w": (np.asarray(x),)}, "cpu")["w"][0]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(x, np.float32))

    def test_every_block_kind_builds_its_train_step(self):
        # every block kind is ported (xLSTM item 11a; whisper's encoder,
        # cross-attention and GELU MLP item 11b), trains on one device
        # (items 11d, 11f) and on meshes (items 11e, 11g): the train step
        # builds for each, and no refusal of two or more ranks is left
        from repro_torch.train import steps
        for arch in ("xlstm_350m", "whisper_small", "phi3_vision"):
            cfg = get_config(arch).reduced()
            T.param_specs(cfg)
            steps.make_train_step(cfg)
        assert not hasattr(steps, "check_train_supported")


def _is_names(x):
    return isinstance(x, tuple) and len(x) > 0 and \
        all(isinstance(e, (str, type(None))) for e in x)


def _name_leaves(tree):
    """Leaves of a logical-names tree (name tuples are leaves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _name_leaves(tree[k])
    elif isinstance(tree, tuple) and not _is_names(tree):
        for e in tree:
            yield from _name_leaves(e)
    else:
        yield tree


class TestPrefillLogits:
    @pytest.mark.parametrize("use_pallas", [False, True])
    @pytest.mark.parametrize("arch", ["qwen2_05b", "phi3_mini"])
    def test_matches_reference_prefill(self, arch, use_pallas):
        jcfg = jax_config(arch).reduced()
        tcfg = dataclasses.replace(get_config(arch).reduced(),
                                   use_pallas=use_pallas)
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        # nonzero biases so the bias path is exercised
        if jcfg.qkv_bias:
            rng = np.random.default_rng(5)
            mix = jparams["layers"][0]["mix"]
            for k in ("bq", "bk", "bv"):
                mix[k] = jnp.asarray(rng.standard_normal(mix[k].shape),
                                     jnp.float32) * 0.1
        tokens = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (2, 48)).astype(np.int32)
        want_last = jax_prefill(jcfg)(jparams, {"tokens": jnp.asarray(tokens)})
        want_all = JT.forward(jcfg, jparams, jnp.asarray(tokens))
        params = T.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        tok = torch.from_numpy(tokens)
        got_last = make_prefill_step(tcfg)(params, {"tokens": tok})
        got_all = T.forward(tcfg, params, tok)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all),
                                   rtol=TOL, atol=TOL)


class TestScanLayers:
    def test_every_layer_runs_under_the_body_site(self):
        """The eager layer loop reuses the traced body's site keys."""
        cfg = dataclasses.replace(get_config("qwen2_05b").reduced(),
                                  num_layers=4, use_pallas=True)
        seen = []

        class Recording(KernelDispatch):
            def next_site(self, kernel):
                site = super().next_site(kernel)
                seen.append(site)
                return site

        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tok = torch.randint(0, cfg.vocab_size, (1, 16), dtype=torch.int32)
        with kernel_dispatch(Recording(impls={"flash_attention:0": "ref"})):
            T.forward(cfg, params, tok)
        assert seen == ["flash_attention:0"] * 4

    def test_loop_equals_unrolled_layers(self):
        cfg = dataclasses.replace(get_config("qwen2_05b").reduced(),
                                  num_layers=3)
        params = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
        h = torch.randn(2, 8, cfg.d_model)
        pos = torch.arange(8, dtype=torch.int32)[None]

        def body(c, p):
            return T.apply_block(cfg, "attn", p[0], c, pos)

        got = T.scan_layers(body, h, params["layers"])
        want = h
        for i in range(3):
            want = body(want, pytree.tree_map(lambda a: a[i],
                                              params["layers"]))
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_embed_scale_rounds_like_the_reference(self):
        for x in (29.933259094191531, 8.0, 1.0 / 3.0, 1e-3, 123.456):
            for td, jd in ((torch.bfloat16, jnp.bfloat16),
                           (torch.float16, jnp.float16),
                           (torch.float32, jnp.float32)):
                assert L.round_to(td, x) == float(jnp.asarray(x, jd))
