"""The training launcher with the MoE models on four gloo ranks (CPU), its
rules against the reference launcher's, and ``specs_from_rules``
against the reference's.

On four ranks the launcher's mesh is the reference's (data 2, model 2).
Reduced f32 ``mixtral_8x22b`` and ``arctic_480b`` at B 2 x S 32:

- ``--plan manual`` and ``--plan toast``, each resuming from one step-0
  checkpoint the reference's ``save`` wrote, end within 1e-4 of the
  reference launcher's ``run_once`` from the same checkpoint, the
  manifests equal, every state leaf placed by the rules;
- the rules ``--plan toast`` takes on two and four ranks equal those of
  the reference launcher's own search (``toast_rules``) for the same
  mesh: the MoE plans put the experts on ``model`` (two ranks) and on
  both axes (four);
- the port's ``specs_from_rules`` of the MoE train state equals the
  reference's, leaf by leaf (the expert stacks and their moments among
  them), under ``MANUAL_RULES`` and the searched rules.
"""

import jax
import numpy as np
import pytest

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.train import steps as JS
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.core.partitioner import flatten_logical_axes
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.launch import train as launcher
from repro_torch.models.sharding import MANUAL_RULES
from repro_torch.train.steps import train_state_specs
from test_torch_moe_mesh_train_launch import (ARCHS, STEPS,
                                              assert_close_checkpoints,
                                              launch_rank, reference_run)

RANKS_TIMEOUT = 300.0
PLANS = ("ref_manual", "ref_toast")


def reference_rules(arch, n):
    """The reference launcher's searched rules for ``n`` devices."""
    plan = jtrain.toast_rules(jax_config(arch).reduced(),
                              JShapeConfig("cli", 32, 2, "train"),
                              JMeshSpec(("data", "model"),
                                        (max(1, n // 2), min(2, n))))
    return plan.logical_rules or dict(MANUAL_RULES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_launch_rules")
    for arch in ARCHS:
        reference_run(arch, root)
    ranks = M.run_ranks(launch_rank, 4, root, list(PLANS),
                        timeout=RANKS_TIMEOUT)
    return root, ranks


@pytest.fixture(scope="module")
def rules():
    return {(arch, n): reference_rules(arch, n)
            for arch in ARCHS for n in (2, 4)}


@pytest.mark.parametrize("plan", ["manual", "toast"])
@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_match_the_reference_launcher(runs, arch, plan):
    root, ranks = runs
    for r in ranks:
        res = r[arch, f"ref_{plan}"]
        assert res["attempts"] == [(0, None, (2, 2), STEPS)]
        assert res["misplaced"] == []
    assert_close_checkpoints(root / arch / f"ref_{plan}", root / arch / "ref",
                             STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_searched_rules_equal_the_reference_launchers(runs, rules,
                                                          arch):
    _, ranks = runs
    got = ranks[0][arch, "ref_toast"]["rules"]
    assert got == rules[arch, 4]
    assert set(got["experts"]) == {"model", "data"}
    assert ranks[0][arch, "ref_manual"]["rules"] == dict(MANUAL_RULES)
    two = launcher.toast_plan(get_config(arch).reduced(),
                              launcher.ShapeConfig("cli", 32, 2, "train"),
                              launcher.mesh_for(2)).logical_rules
    assert two == rules[arch, 2] and two["experts"] == ("model",)


@pytest.mark.parametrize("sizes", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_from_rules_equal_the_references(rules, arch, sizes):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    axis_sizes = dict(zip(("data", "model"), sizes))
    state = train_state_specs(cfg)
    names = flatten_logical_axes(S.state_logical_axes(cfg, state))
    jstate = jax.eval_shape(lambda: JS.init_train_state(
        jcfg, jax.random.PRNGKey(0)))
    n = int(np.prod(sizes))
    for rule_map in (dict(MANUAL_RULES), rules[arch, n]):
        jspec = jax.tree_util.tree_leaves(
            jspecs.specs_from_rules(
                jstate, jspecs.state_logical_axes(jcfg, jstate), rule_map,
                axis_sizes),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        mine = [S.specs_from_rules(x, nm, rule_map, axis_sizes)
                for x, nm in zip(pytree.tree_leaves(state), names)]
        assert len(mine) == len(jspec)
        for a, b in zip(mine, jspec):
            assert tuple(a) == tuple(b)
        paths = pytree.flatten_with_paths(state)[1]
        experts = [tuple(a) for a, p in zip(mine, paths)
                   if p.endswith("['ffn']['wi']")]
        assert len(experts) == 3 and all(e[1] for e in experts) == \
            bool(rule_map.get("experts"))
