"""The port's whole slice against the JAX package: Session → Request →
plan → ``plan.apply`` on the ``qwen2_05b`` prefill step.

*Plans.*  Both packages' Sessions analyze the einsum-path prefill step,
at reduced size and at full width on abstract / ``meta`` inputs, and
search a 2x2 mesh greedily under one explicit ``HardwareSpec``.  The
plans must have identical ``in_specs`` for every input path, identical
``out_specs`` and identical conflict counts; the costs agree within 2%
relative.  The small gap is expected: the reference's program carries a
few ops the port's does not (``jnp.take``'s negative-index fix-up of
the token ids, the softmax's ``max(-inf, ·)`` and ``stop_gradient``),
and the port's carries int64 position iotas where the reference's are
int32; each is a small elementwise op in the roofline sum.

*Fused sites.*  With ``use_pallas=True`` the port's program holds one
``kernel:flash_attention`` op for all layers, and the one-device plan
runs it with the ``"cuda"`` impl; on CPU tensors that is the kernel's
plain version, so the applied step equals the unapplied one.

*No JAX in the port.*  Importing every ``repro_torch`` module (and
``chip_smoke.py``) loads no ``jax`` and no ``repro`` module.
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Request as JRequest
from repro.api import Session as JSession
from repro.configs.base import get_config as jax_config
from repro.core.cost_model import HardwareSpec as JHardwareSpec
from repro.core.cost_model import MeshSpec as JMeshSpec
from repro.models import transformer as JT
from repro.train.steps import make_prefill_step as jax_prefill
from repro_torch.api import Request, Session
from repro_torch.configs import get_config
from repro_torch.core.cost_model import HardwareSpec, MeshSpec
from repro_torch.core.partitioner import PartitionSpec, ShardingPlan
from repro_torch.kernels import registry
from repro_torch.models import transformer as T
from repro_torch.train.steps import make_prefill_step

REPO = pathlib.Path(__file__).resolve().parent.parent
COST_REL_TOL = 0.02
HW = dict(flops_per_chip=197e12, hbm_bw=819e9, ici_bw=50e9,
          dcn_bw=6.25e9, hbm_per_chip=16e9)
AXES = ("data", "model")


def sessions(full: bool, use_pallas: bool = False):
    jcfg, tcfg = jax_config("qwen2_05b"), get_config("qwen2_05b")
    if not full:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    tcfg = dataclasses.replace(tcfg, use_pallas=use_pallas)
    B, S = (4, 2048) if full else (2, 64)
    js = JSession(jax_prefill(jcfg), (JT.param_specs(jcfg), {
        "tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}))
    ts = Session(make_prefill_step(tcfg), (T.param_specs(tcfg), {
        "tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}))
    return js, ts


@pytest.fixture(scope="module", params=["reduced", "full"])
def plans(request):
    js, ts = sessions(request.param == "full")
    jp = js.partition(JRequest(mesh=JMeshSpec(AXES, (2, 2)),
                               hw=JHardwareSpec(**HW), backend="greedy"))
    tp = ts.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                              hw=HardwareSpec(**HW), backend="greedy"))
    return js, ts, jp, tp


class TestPlanParity:
    def test_identical_in_and_out_specs(self, plans):
        _, _, jp, tp = plans
        assert tp.input_paths == jp.input_paths
        assert [tuple(s) for s in tp.in_specs] == \
            [tuple(s) for s in jp.in_specs]
        assert [tuple(s) for s in tp.out_specs] == \
            [tuple(s) for s in jp.out_specs]

    def test_identical_analysis_counts(self, plans):
        _, _, jp, tp = plans
        assert tp.num_conflicts == jp.num_conflicts
        assert tp.num_colors == jp.num_colors
        assert tp.num_compat_sets == jp.num_compat_sets
        assert tp.num_resolution_bits == jp.num_resolution_bits

    def test_cost_within_tolerance(self, plans):
        _, _, jp, tp = plans
        assert abs(tp.cost - jp.cost) <= COST_REL_TOL * jp.cost
        for key in ("peak_bytes", "comm_bytes"):
            assert tp.breakdown[key] == jp.breakdown[key]

    def test_reference_plan_json_loads_into_the_port(self, plans):
        _, _, jp, tp = plans
        loaded = ShardingPlan.from_json(jp.to_json())
        assert loaded.in_specs == tp.in_specs
        assert loaded.input_paths == tp.input_paths
        assert all(isinstance(s, PartitionSpec) for s in loaded.in_specs)

    def test_json_round_trip(self, plans):
        _, _, _, tp = plans
        again = ShardingPlan.from_json(tp.to_json())
        assert again.as_dict() == tp.as_dict()
        assert json.loads(tp.to_json())["schema"] == 2


@pytest.fixture(scope="module")
def fused():
    cfg = dataclasses.replace(get_config("qwen2_05b").reduced(),
                              use_pallas=True)
    step = make_prefill_step(cfg)
    sess = Session(step, (T.param_specs(cfg), {
        "tokens": torch.empty((2, 64), dtype=torch.int32, device="meta")}))
    return cfg, step, sess


class TestFusedSites:
    def test_one_kernel_op_for_all_layers(self, fused):
        cfg, _, sess = fused
        prog = sess.artifacts.prog
        idx = [i for i, op in enumerate(prog.ops)
               if op.prim.startswith("kernel:")]
        assert len(idx) == 1
        op = prog.ops[idx[0]]
        assert op.prim == "kernel:flash_attention"
        assert op.params == {"kernel": "flash_attention", "causal": True}
        assert prog.trip_counts[idx[0]] == cfg.num_layers // 1

    def test_roles_match_the_registry(self, fused):
        _, _, sess = fused
        prog, nda = sess.artifacts.prog, sess.artifacts.nda
        op = next(op for op in prog.ops if op.prim.startswith("kernel:"))
        spec = registry.spec_for_prim(op.prim)
        colors: dict = {}
        for roles, vid in list(zip(spec.operand_roles, op.operands)) + \
                list(zip(spec.result_roles, op.results)):
            assert len(prog.types[vid].shape) == len(roles)
            for role, c in zip(roles, nda.colors_of_value(vid)):
                colors.setdefault(role, set()).add(c)
        assert all(len(c) == 1 for c in colors.values())
        # self-attention: q and kv positions come from one sequence
        assert colors["q_seq"] == colors["kv_seq"]
        assert len({next(iter(colors[r])) for r in
                    ("batch", "q_seq", "heads", "head_dim")}) == 4

    def test_one_device_plan_picks_cuda_and_applies(self, fused):
        cfg, step, sess = fused
        plan = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1))))
        assert [(r["site"], r["impl"]) for r in plan.kernel_sites] == \
            [("flash_attention:0", "cuda")]
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))}
        got = plan.apply(step, device="cpu")(params, batch)
        torch.testing.assert_close(got, step(params, batch), rtol=0, atol=0)
        assert got.shape == (2, cfg.vocab_size)

    def test_sharded_plan_records_mappable_specs(self, fused):
        _, _, sess = fused
        plan = sess.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                                      backend="greedy"))
        (site,) = plan.kernel_sites
        spec = registry.KERNELS["flash_attention"]
        for roles, ps in zip(spec.operand_roles, site["in_specs"]):
            for role, entry in zip(roles, ps):
                assert entry is None or role in spec.mappable

    def test_pallas_decisions_read_as_cuda(self, fused):
        _, _, sess = fused
        d = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1)))).as_dict()
        d["kernel_sites"][0]["impl"] = "pallas"
        d["state"]["kernel_impls"] = [[d["kernel_sites"][0]["op"],
                                       "pallas"]]
        plan = ShardingPlan.from_dict(d)
        assert plan.kernel_sites[0]["impl"] == "cuda"
        assert plan.state.kernel_impls[0][1] == "cuda"

    def test_apply_refuses_what_it_cannot_run(self, fused):
        cfg, step, sess = fused
        plan4 = sess.partition(Request(mesh=MeshSpec(AXES, (2, 2)),
                                       backend="greedy"))
        # a 2x2 plan runs over a process group of 4 ranks, one per device
        # (tests/test_torch_mesh_models.py); this process has none
        with pytest.raises(RuntimeError, match="process group of 4 ranks"):
            plan4.apply(step, device="cpu")
        plan1 = sess.partition(Request(mesh=MeshSpec(AXES, (1, 1))))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                plan1.apply(step)
        applied = plan1.apply(step, device="cpu")
        with pytest.raises(ValueError, match="argument leaves"):
            applied({"embed": torch.zeros(1)}, {})


PORT = REPO / "src" / "repro_torch"


def port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


class TestNoJaxInThePort:
    def test_importing_the_port_loads_no_jax(self):
        code = (
            "import importlib, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            f"for m in {port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or "
            "m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO / "src")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr

    def test_no_source_imports_jax_or_the_reference(self):
        files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
        offenders = []
        for path in files:
            for node in ast.walk(ast.parse(path.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "repro"):
                        offenders.append(f"{path.name}: {n}")
        assert offenders == []
