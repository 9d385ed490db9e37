"""Training the reduced frontend models, ``whisper_small`` and
``phi3_vision``, on gloo meshes (CPU), as
``tests/test_torch_xlstm_mesh_train.py`` trains the xLSTM (its helpers).

*plan.apply.*  Each model in f32 with its kernel sites (``use_pallas``:
the attention's plain version and its plain-vjp backward on CPU
tensors, under ``local_map`` on a mesh), its train step at B 4 x S 32
(whisper: 16 frames and 16 tokens; phi3_vision: 8 patches and 24
tokens), planned greedily under one explicit ``HardwareSpec`` for
(1, 2) and 2x2, each run with remat off and on, and on (1, 2) pinned
to shard the sequence (the tokens and targets, whisper's frames too),
remat off.  The loss, the metrics and every leaf of the new state
within 1e-4 of one process (relative to the largest, at least 1).

*The launcher.*  ``launch/train.py`` on two ranks (the rules route,
``--plan manual``: the batch's ``frames`` and ``patch_embeds`` placed by
``specs_from_rules`` as the reference's names give them), B 2 x S 32, 3
steps: a restart ending bit for bit as the uninterrupted run, the
ranks' losses within 1e-4 of one process's, and from the reference's
step-0 checkpoint within 1e-4 of the reference's launcher.
"""

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import batch_specs, specs_from_rules
from repro_torch.models.sharding import MANUAL_RULES
from test_torch_frontend_mesh import SEQ_PINS
from test_torch_xlstm_mesh import apply_rank, close, port_plan
from test_torch_xlstm_mesh_train import (RANKS_TIMEOUT, check_one_process,
                                         check_reference, check_restart,
                                         launcher_runs)

ARCHS = ("whisper_small", "phi3_vision")
B, S = 4, 32


def train_cases(mesh):
    """Each model's plan with remat off and on; on (1, 2) also the plan
    pinned to shard the sequence, remat off."""
    out = []
    for arch in ARCHS:
        plans = {"port": port_plan(arch, None, "train", B, S, mesh).to_json()}
        out.append((arch, None, "train", B, S, dict(plans), (), True))
        if mesh == (1, 2):
            pins = dict(SEQ_PINS[arch], **{"[0][1]['targets']": (None,
                                                                "model")})
            plans["seq"] = port_plan(arch, None, "train", B, S, mesh,
                                     pins).to_json()
        out.append((arch, None, "train", B, S, plans, (), False))
    return out


@pytest.fixture(scope="module")
def steps():
    return {"x".join(map(str, mesh)): M.run_ranks(
        apply_rank, mesh[0] * mesh[1], train_cases(mesh),
        timeout=RANKS_TIMEOUT) for mesh in ((1, 2), (2, 2))}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield launcher_runs({arch: None for arch in ARCHS},
                            tmp_path_factory.mktemp("frontend_launch_mesh"),
                            mp)
    finally:
        mp.undo()


CASES = [(m, a, "port", remat) for m in ("1x2", "2x2") for a in ARCHS
         for remat in (False, True)] + [("1x2", a, "seq", False)
                                         for a in ARCHS]


@pytest.mark.parametrize("mesh,arch,plan,remat", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_train_step_equals_one_process(steps, mesh, arch, plan, remat):
    for r in steps[mesh]:
        res = r["cases"][arch, None, "train", S, remat][plan]
        assert close(res), (mesh, arch, plan, remat, max(res["errors"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_batches_are_placed_as_the_reference_places_them(arch):
    """``specs_from_rules`` of the batch under ``MANUAL_RULES`` on the
    launcher's (1, 2) mesh equals the reference's."""
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.configs.base import get_config as jax_config
    from repro.launch.specs import batch_specs as jbatch_specs
    from repro.launch.specs import specs_from_rules as jspecs_from_rules
    from repro.models.sharding import MANUAL_RULES as JMANUAL_RULES
    sizes = {"data": 1, "model": 2}
    cfg = get_config(arch).reduced()
    got = specs_from_rules(*batch_specs(cfg, ShapeConfig("t", S, B,
                                                         "train")),
                           MANUAL_RULES, sizes)
    want = jspecs_from_rules(*jbatch_specs(
        jax_config(arch).reduced(), JShapeConfig("t", S, B, "train")),
        JMANUAL_RULES, sizes)
    assert set(got) == set(want) and len(got) == 3
    for k in got:
        assert tuple(got[k]) == tuple(want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_a_restart_on_two_ranks_ends_bit_for_bit(launched, arch):
    root, _, ranks = launched
    check_restart(root, ranks, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_ranks_agree_and_match_one_process(launched, arch):
    _, one, ranks = launched
    check_one_process(one, ranks, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_match_the_reference_launcher(launched, arch):
    root, _, ranks = launched
    check_reference(root, ranks, arch)
