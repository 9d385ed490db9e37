"""``plan.apply`` against the reference's ``AppliedPlan``, on the CPU.

The reference jits the step once per argument signature (the treedef
and each leaf's shape and dtype) and checks each signature's output
leaves against the plan's ``out_specs``.  The port keys its entries the
same way; on a CUDA card each entry is a captured CUDA graph, on the CPU
(these tests) the step runs eagerly, with no graph.  The reference's
three keying tests (``tests/test_api.py``, ``TestApplyCacheKeying``) run
here on both packages with the same inputs, made from a numpy seed; the
outputs agree within 1e-5 (f32 products summed in another order).
Capture on the card is tested in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro_torch import pytree
from repro_torch.api import Request, Session
from repro_torch.core.cost_model import MeshSpec
from repro_torch.jit import CapturedStep

TOL = 1e-5


def jax_mlp(d):
    return jax.nn.relu(d["x"] @ d["w1"]) @ d["w2"]


def torch_mlp(d):
    return torch.relu(d["x"] @ d["w1"]) @ d["w2"]


def jax_shapefn(x):
    y = x * 2.0
    if x.shape[0] >= 8:
        return {"a": y, "b": y.sum()}
    return {"a": y}


def torch_shapefn(x):
    y = x * 2.0
    if x.shape[0] >= 8:
        return {"a": y, "b": y.sum()}
    return {"a": y}


def plans(jfn, tfn, shapes):
    """The 1x1 greedy plan of both packages for one tuple of shapes."""
    jargs = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple) and
        all(isinstance(n, int) for n in s))
    targs = jax.tree_util.tree_map(
        lambda s: torch.empty(s, device="meta"), shapes,
        is_leaf=lambda s: isinstance(s, tuple) and
        all(isinstance(n, int) for n in s))
    jplan = JSession(jfn, jargs).partition(JRequest(
        mesh=JMeshSpec(("data", "model"), (1, 1)), min_dims=1,
        backend="greedy"))
    tplan = Session(tfn, targs).partition(Request(
        mesh=MeshSpec(("data", "model"), (1, 1)), min_dims=1,
        backend="greedy"))
    return jplan, tplan


@pytest.fixture(scope="module")
def mlp_plans():
    return plans(jax_mlp, torch_mlp,
                 ({"x": (8, 16), "w1": (16, 32), "w2": (32, 16)},))


def mlp_args(rows, seed=0):
    rng = np.random.default_rng(seed)
    d = {"x": rng.standard_normal((rows, 16), dtype=np.float32),
         "w1": rng.standard_normal((16, 32), dtype=np.float32),
         "w2": rng.standard_normal((32, 16), dtype=np.float32)}
    return ({k: jnp.asarray(v) for k, v in d.items()},), \
        ({k: torch.from_numpy(v) for k, v in d.items()},)


def assert_same(jout, tout):
    np.testing.assert_allclose(np.asarray(jout), tout.numpy(), rtol=TOL,
                               atol=TOL)


def test_distinct_shapes_get_distinct_entries(mlp_plans):
    jplan, tplan = mlp_plans
    japplied = jplan.apply(jax_mlp)
    tapplied = tplan.apply(torch_mlp, device="cpu")
    for rows in (8, 4):
        jargs, targs = mlp_args(rows)
        jout, tout = japplied(*jargs), tapplied(*targs)
        assert jout.shape == tout.shape == (rows, 16)
        assert_same(jout, tout)
    assert len(japplied._cache) == len(tapplied._cache) == 2


def test_same_shapes_hit_one_entry(mlp_plans):
    jplan, tplan = mlp_plans
    japplied = jplan.apply(jax_mlp)
    tapplied = tplan.apply(torch_mlp, device="cpu")
    for seed in (0, 1):
        jargs, targs = mlp_args(8, seed)
        assert_same(japplied(*jargs), tapplied(*targs))
    assert len(japplied._cache) == len(tapplied._cache) == 1
    assert tapplied.captures == tapplied.replays == 0


def test_shape_dependent_output_structure_raises_against_the_new_shape():
    """The first shape's two output leaves match the plan; the second
    shape's one leaf is reported against the plan's two output specs in
    both packages, and the failed signature leaves no entry."""
    jplan, tplan = plans(jax_shapefn, torch_shapefn, ((8, 4),))
    assert len(jplan.out_specs) == len(tplan.out_specs) == 2
    japplied = jplan.apply(jax_shapefn)
    tapplied = tplan.apply(torch_shapefn, device="cpu")
    x = np.random.default_rng(2).standard_normal((8, 4), dtype=np.float32)
    jout, tout = japplied(jnp.asarray(x)), tapplied(torch.from_numpy(x))
    for k in ("a", "b"):
        assert_same(jout[k], tout[k])
    small = x[:4]
    with pytest.raises(ValueError, match="2 output specs but fn returns 1"):
        japplied(jnp.asarray(small))
    with pytest.raises(ValueError, match="2 output specs but fn returns 1"):
        tapplied(torch.from_numpy(small))
    assert len(tapplied._cache) == 1


def test_leaf_count_and_keyword_arguments_raise_in_both(mlp_plans):
    jplan, tplan = mlp_plans
    japplied = jplan.apply(jax_mlp)
    tapplied = tplan.apply(torch_mlp, device="cpu")
    jargs, targs = mlp_args(8)
    for applied, args in ((japplied, jargs), (tapplied, targs)):
        short = ({k: v for k, v in args[0].items() if k != "w2"},)
        with pytest.raises(ValueError, match="3 input specs but the call "
                                             "provides 2 argument leaves"):
            applied(*short)
        with pytest.raises(ValueError, match="positional arguments only"):
            applied(*args, extra=1)
    assert not tapplied._cache


def test_capture_on_the_cpu_raises(mlp_plans):
    _, tplan = mlp_plans
    with pytest.raises(ValueError, match="capture=True needs a CUDA"):
        tplan.apply(torch_mlp, device="cpu", capture=True)


def test_default_on_the_cpu_runs_eagerly_with_no_graph(mlp_plans):
    _, tplan = mlp_plans
    default = tplan.apply(torch_mlp, device="cpu")
    eager = tplan.apply(torch_mlp, device="cpu", capture=False)
    assert not default.capture and not eager.capture
    _, targs = mlp_args(8, 3)
    want = torch_mlp(*targs)
    for applied in (default, eager):
        got = applied(*targs)
        assert torch.equal(got, want)
        assert applied.captures == applied.replays == 0
        assert applied.graphs == []
    default.release()
    assert not default._cache


def test_a_step_that_writes_into_its_input_raises(mlp_plans):
    _, tplan = mlp_plans

    def scaled_in_place(d):
        d["x"].mul_(2.0)
        return torch_mlp(d)

    applied = tplan.apply(scaled_in_place, device="cpu")
    _, targs = mlp_args(8)
    with pytest.raises(ValueError, match=r"wrote into its input "
                                         r"\[0\]\[0\]\['x'\]"):
        applied(*targs)


def test_treedef_tells_structures_apart():
    x = torch.zeros(2)
    assert pytree.treedef({"a": x, "b": (x, x)}) == \
        pytree.treedef({"b": (x, x), "a": torch.ones(3)})
    assert len({pytree.treedef(t) for t in (
        {"a": x, "b": (x, x)}, {"a": x, "c": (x, x)},
        {"a": x, "b": [x, x]}, {"a": x, "b": (x, None, x)}, (x, x, x))}) \
        == 5


def test_captured_leaves_are_held_only_while_the_same_tensor_comes():
    """The in-place rule of a captured step: a held leaf is read in place
    while the caller passes a tensor at the same address with the same
    strides; another tensor (or another view of it) is not held."""
    w = torch.arange(12.0).reshape(3, 4)
    c = torch.zeros(4)
    step = CapturedStep(graph=None, inputs=[w, c.clone()],
                        held=[True, False], outputs=[], template=None,
                        launches={}, warmup_launches={}, seconds=0.0,
                        pool_bytes=0)
    assert step.holds([w, c]) == [True, False]
    assert step.holds([w.view(3, 4), c]) == [True, False]
    assert step.holds([w.clone(), c]) == [False, False]
    assert step.holds([w.t().contiguous().t(), c]) == [False, False]
    assert step.holds([w.as_strided((3, 4), (1, 3)), c]) == [False, False]


def test_flattening_and_rebuilding_keep_no_leaf_alive():
    """The pytree helpers build no reference cycle: with the garbage
    collector off, a flattened leaf is freed as soon as its last holder
    lets go (a cycle kept whole gradient and state lists alive until a
    collection, which a captured step's memory pool could not spare)."""
    import gc
    import weakref
    gc.disable()
    try:
        x = torch.zeros(3)
        ref = weakref.ref(x)
        tree = {"a": x, "b": (torch.ones(2), [None, torch.ones(1)])}
        leaves, paths = pytree.flatten_with_paths(tree)
        rebuilt = pytree.unflatten(tree, leaves)
        mapped = pytree.tree_map_with_path(lambda keys, t: t, tree)
        assert paths == ["['a']", "['b'][0]", "['b'][1][1]"]
        assert rebuilt["a"] is x and mapped["b"][1][1] is tree["b"][1][1]
        del x, tree, leaves, rebuilt, mapped
        assert ref() is None
    finally:
        gc.enable()
