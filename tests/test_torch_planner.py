"""Sharding propagation, the cost model and the planner
(``paddle_tpu_torch/analysis/{shard_prop,cost_model,planner}.py``)
against the JAX package's on the same programs (built with
``paddle_tpu``, loaded into the port through ``to_json``).

* **Propagation.** ``propagate_sharding``'s specs, PT041 reshard sites
  and PT042 blind spots equal the reference's on a 2 x 2 axis dict, for
  the dp and tensor-split seeds of the planner's candidates; each of
  PT040-PT042 fires from one seeded defect.
* **Cost model.** ``estimate_cost``'s per-op FLOPs, bytes and collective
  bytes, its totals and its peak memory equal the reference's exactly,
  unsharded and under every candidate's propagation.  The constants are
  the H100's (data sheet), and the time proxies follow from them.
* **Planner.** ``plan``'s chosen specs equal the reference's wherever
  the two rank the candidates alike; where the H100 constants change a
  ranking, a test names the plan (vgg_cifar on dp=2 x tp=2: the
  reference's 45 GB/s interconnect favours dp, the port's 450 GB/s
  NVLink the megatron split).  Plans round-trip through JSON, and
  ``plan(op_class_ratios=)`` reads a calibration table.

Tolerances: none — every comparison is exact (the time proxies to the
float the same arithmetic gives).
"""
import json

import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu.analysis import cost_model as jcm
from paddle_tpu.analysis import planner as jplanner
from paddle_tpu.analysis import propagate_sharding as jprop
from paddle_tpu_torch.analysis import ValidationReport
from paddle_tpu_torch.analysis import cost_model, planner
from paddle_tpu_torch.analysis import propagate_sharding
from paddle_tpu_torch.analysis.lints import run_sharding_lints
from paddle_tpu_torch.analysis.planner import Plan
from paddle_tpu_torch.observability import attribution
from test_torch_analysis import MODELS

MESH = {"dp": 2, "tp": 2}
MESHES = {"dp8": {"dp": 8}, "dp4tp2": {"dp": 4, "tp": 2}, "dp2tp2": MESH}


def _port(jprog):
    return ptt.Program.from_json(jprog.to_json())


def _mlp_train():
    """x[256] -> fc 512 relu -> fc 128 softmax -> CE, SGD: a chain the
    megatron candidate splits (``tests/test_planner.py``'s program)."""
    pt.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[256], dtype="float32")
        label = pt.layers.data("label", shape=[1], dtype="int64")
        h = pt.layers.fc(x, size=512, act="relu")
        pred = pt.layers.fc(h, size=128, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, loss


def _square_fc():
    pt.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4], dtype="float32")
        label = pt.layers.data("label", shape=[1], dtype="int64")
        pred = pt.layers.fc(x, size=4, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
    return main, loss


def _programs():
    """name -> JAX program: the training programs of the parity harness
    and the megatron chain."""
    out = {"mlp_train": _mlp_train()[0]}
    out["resnet_cifar_train"] = tp.build_train(pt, "resnet_cifar",
                                               [3, 16, 16], depth=8)[0]
    out["longctx_train"] = tp.build_longctx(pt, 256, 2, 16, block=64)[0]
    out["seq2seq_train"] = tp.build_seq2seq(pt, 30, 8)[0]
    pt.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        MODELS["wide_deep"](pt)
    out["wide_deep"] = main
    return out


PROGRAMS = sorted(["mlp_train", "resnet_cifar_train", "longctx_train",
                   "seq2seq_train", "wide_deep"])


@pytest.fixture(scope="module")
def programs():
    return _programs()


def _norm_prop(p):
    return (dict(p.specs), [(d.code, d.op) for d in p.report],
            sorted(p.resharded), sorted(p.blind_spots))


def _seeds(jprog, mesh):
    """The planner's candidates' seeds (param specs + feed specs)."""
    out = {}
    for name, ps, fs in jplanner.enumerate_candidates(jprog, mesh):
        seeds = dict(ps)
        seeds.update(fs)
        out[name] = seeds
    return out


# ---------------------------------------------------------------------------
# propagation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", PROGRAMS)
def test_propagation_equals_the_reference(programs, name):
    jprog = programs[name]
    tprog = _port(jprog)
    for cand, seeds in _seeds(jprog, MESH).items():
        assert _norm_prop(propagate_sharding(tprog, seeds)) == \
            _norm_prop(jprop(jprog, seeds)), cand


def test_pt040_double_booked_axis():
    main, loss = _square_fc()
    w = next(v.name for v in main.global_block().vars.values()
             if v.persistable and v.shape == (4, 4))
    kw = dict(fetch_list=[loss.name], mesh=MESH)
    rep = _port(main).validate(param_specs={w: ("dp", "dp")}, **kw)
    assert rep.codes() == ["PT040"]
    assert rep.codes() == main.validate(param_specs={w: ("dp", "dp")},
                                        **kw).codes()
    assert len(_port(main).validate(param_specs={w: ("dp", "tp")},
                                    **kw)) == 0


def test_pt041_conflicting_shardings_meet():
    main, _ = _square_fc()
    b = main.global_block()
    b.create_var(name="lhs", shape=(8, 4), dtype="float32", is_data=True)
    b.create_var(name="rhs", shape=(8, 4), dtype="float32", is_data=True)
    b.create_var(name="both", shape=(8, 4), dtype="float32")
    b.append_op(type="elementwise_add",
                inputs={"X": ["lhs"], "Y": ["rhs"]},
                outputs={"Out": ["both"]}, attrs={})
    seeds = {"lhs": ("dp", None), "rhs": ("tp", None)}
    got = propagate_sharding(_port(main), seeds)
    assert got.report.codes() == ["PT041"]
    assert [r[2] for r in got.resharded] == ["elementwise_add"]
    assert _norm_prop(got) == _norm_prop(jprop(main, seeds))


def test_pt042_blind_spot():
    """A sharded value into an op with no shard rule (``split``, one of
    the six, as in the reference) is a blind spot; outputs past it stay
    unclaimed."""
    main, _ = _square_fc()
    b = main.global_block()
    b.create_var(name="sig", shape=(8, 16), dtype="float32", is_data=True)
    for n in ("s0", "s1"):
        b.create_var(name=n, shape=(8, 8), dtype="float32")
    b.append_op(type="split", inputs={"X": ["sig"]},
                outputs={"Out": ["s0", "s1"]}, attrs={"axis": 1, "num": 2})
    seeds = {"sig": ("dp", None)}
    got = propagate_sharding(_port(main), seeds)
    assert got.report.codes() == ["PT042"]
    assert got.blind_spots == [(0, len(b.ops) - 1, "split")]
    assert "s0" not in got.specs
    assert _norm_prop(got) == _norm_prop(jprop(main, seeds))


def test_backward_sweep_reaches_producers():
    main = pt.Program()
    b = main.global_block()
    b.create_var(name="x", shape=(-1, 4), dtype="float32", is_data=True)
    b.create_var(name="y", shape=(-1, 4), dtype="float32")
    b.create_var(name="z", shape=(-1, 4), dtype="float32")
    b.append_op(type="scale", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                attrs={"scale": 2.0})
    b.append_op(type="relu", inputs={"X": ["y"]}, outputs={"Out": ["z"]},
                attrs={})
    got = propagate_sharding(_port(main), {"z": ("dp", None)})
    assert got.specs.get("x") == got.specs.get("y") == (("dp",), None)


def test_grads_follow_param_sharding():
    main, _ = _mlp_train()
    tprog = _port(main)
    p = planner.plan(tprog, {"dp": 4, "tp": 2})
    seeds = dict(p.param_specs)
    seeds.update(p.feed_specs)
    prop = propagate_sharding(tprog, seeds)
    assert p.param_specs
    for w, spec in p.param_specs.items():
        assert prop.specs.get(w + "@GRAD") == spec, w


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------
def test_constants_are_the_h100s():
    assert cost_model.PEAK_FLOPS == 989e12
    assert cost_model.HBM_GBPS == 3.35e12
    assert cost_model.ICI_GBPS == 450e9


def _cost_facts(rep):
    return ([(c.loc, c.flops, c.bytes, c.collective_bytes)
             for c in rep.op_costs],
            rep.flops_total, rep.flops_per_device, rep.hbm_bytes_per_device,
            rep.collective_bytes, rep.reshard_bytes,
            rep.peak_hbm_bytes_per_device, rep.mesh_axes)


def _proxy(rep, cm):
    return (rep.flops_per_device / cm.PEAK_FLOPS
            + rep.hbm_bytes_per_device / cm.HBM_GBPS
            + (rep.collective_bytes + rep.reshard_bytes) / cm.ICI_GBPS)


@pytest.mark.parametrize("name", PROGRAMS)
def test_estimate_cost_equals_the_reference(programs, name):
    jprog = programs[name]
    tprog = _port(jprog)
    cases = [({}, None, None)]
    for cand, seeds in _seeds(jprog, MESH).items():
        cases.append((MESH, seeds, cand))
    for mesh, seeds, cand in cases:
        jp_ = jprop(jprog, seeds) if seeds is not None else None
        tp_ = propagate_sharding(tprog, seeds) if seeds is not None \
            else None
        for batch in (64, 3):
            j = jcm.estimate_cost(jprog, mesh, jp_, assume_batch=batch)
            t = cost_model.estimate_cost(tprog, mesh, tp_,
                                         assume_batch=batch)
            assert _cost_facts(t) == _cost_facts(j), (cand, batch)
            assert t.flops_total > 0 and t.peak_hbm_bytes_per_device > 0
            assert t.step_time_proxy_s == _proxy(t, cost_model)
            assert j.step_time_proxy_s == _proxy(j, jcm)


def test_calibrated_proxy_scales_each_op_class(programs):
    jprog = programs["resnet_cifar_train"]
    tprog = _port(jprog)
    ratios = {"conv2d": 3.0, "batch_norm": 0.5}
    t = cost_model.estimate_cost(tprog, {}, op_class_ratios=ratios)
    j = jcm.estimate_cost(jprog, {}, op_class_ratios=ratios)
    want = sum(ratios.get(c.loc[2], 1.0)
               * (c.flops / cost_model.PEAK_FLOPS
                  + c.bytes / cost_model.HBM_GBPS)
               + c.collective_bytes / cost_model.ICI_GBPS
               for c in t.op_costs)
    assert t.calibrated_step_time_s == want
    assert t.step_time_proxy_s == want and j.calibrated_step_time_s > 0
    assert t.to_dict()["calibrated"] is True


def test_mul_flops_exact():
    main = pt.Program()
    b = main.global_block()
    b.create_var(name="x", shape=(32, 64), dtype="float32", is_data=True)
    b.create_var(name="w", shape=(64, 128), dtype="float32",
                 persistable=True)
    b.create_var(name="o", shape=(32, 128), dtype="float32")
    b.append_op(type="mul", inputs={"X": ["x"], "Y": ["w"]},
                outputs={"Out": ["o"]},
                attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
    rep = cost_model.estimate_cost(_port(main), {}, None)
    assert rep.flops_total == 2 * 32 * 64 * 128
    assert rep.peak_hbm_bytes_per_device >= 64 * 128 * 4


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
# (model, mesh) whose candidate ranking the H100 constants change
RANKING_CHANGES = {("vgg_cifar", "dp2tp2"): ("dp", "megatron")}


def _zoo(name):
    pt.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        MODELS[name](pt)
    return main


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_plan_equals_the_reference_where_the_rankings_agree(name,
                                                            mesh_name):
    jprog = _zoo(name)
    tprog = _port(jprog)
    mesh = MESHES[mesh_name]
    jrank = [n for n, _ in jplanner.rank_candidates(jprog, mesh)]
    trank = [n for n, _ in planner.rank_candidates(tprog, mesh)]
    jp_, tp_ = jplanner.plan(jprog, mesh), planner.plan(tprog, mesh)
    assert sorted(jrank) == sorted(trank)
    change = RANKING_CHANGES.get((name, mesh_name))
    if change is None:
        assert trank == jrank
        assert tp_.candidate == jp_.candidate
        assert tp_.param_specs == jp_.param_specs
    else:
        assert (jp_.candidate, tp_.candidate) == change, (jrank, trank)
    assert tp_.feed_specs == jp_.feed_specs
    rep = ValidationReport()
    run_sharding_lints(tprog, mesh, rep, param_specs=tp_.param_specs,
                       feed_specs=tp_.feed_specs)
    assert not rep.errors
    for spec in tp_.feed_specs.values():
        assert spec[0] == ("dp",)


def test_vgg_cifar_on_dp2_tp2_is_the_ranking_the_h100_changes():
    """The reference ranks dp first (its 45 GB/s interconnect charges the
    split's all-reduces heavily); at NVLink's 450 GB/s the megatron
    split's smaller per-device compute wins.  Both candidates' static
    quantities are equal in the two packages: only the constants
    differ."""
    jprog = _zoo("vgg_cifar")
    tprog = _port(jprog)
    for name, ps, fs in jplanner.enumerate_candidates(jprog, MESH):
        seeds = dict(ps)
        seeds.update(fs)
        j = jcm.estimate_cost(jprog, MESH, jprop(jprog, seeds))
        t = cost_model.estimate_cost(tprog, MESH,
                                     propagate_sharding(tprog, seeds))
        assert _cost_facts(t) == _cost_facts(j), name
    assert jplanner.plan(jprog, MESH).candidate == "dp"
    assert planner.plan(tprog, MESH).candidate == "megatron"


def test_plan_json_roundtrip():
    main, _ = _mlp_train()
    p = planner.plan(_port(main), {"dp": 4, "tp": 2})
    assert p.candidate == "megatron"
    clone = Plan.from_json(p.to_json())
    assert (clone.param_specs, clone.feed_specs, clone.mesh_axes,
            clone.candidate) == (p.param_specs, p.feed_specs, p.mesh_axes,
                                 p.candidate)
    # the same document the reference writes, but for the cost numbers
    jd = jplanner.plan(main, {"dp": 4, "tp": 2}).to_dict()
    td = p.to_dict()
    for k in ("version", "mesh", "batch_axis", "candidate", "param_specs",
              "feed_specs"):
        assert td[k] == jd[k], k
    with pytest.raises(TypeError):
        Plan.from_dict({"mesh": {"dp": 2}, "param_specs": {"w": None}})
    assert "megatron" in p.render()


def test_plan_reads_the_calibration_table(tmp_path):
    """A table written by attribution's savers and read back by
    ``load_op_class_ratios`` (per op type, the median ratio) ranks the
    candidates: the calibrated proxy replaces the uncalibrated one, and
    the same ratios rank alike in both packages."""
    main, _ = _mlp_train()
    tprog = _port(main)
    mesh = {"dp": 4, "tp": 2}
    path = str(tmp_path / "cal.json")
    rows = [{"program": "p", "op_type": "mul", "ratio": 40.0,
             "predicted_ms": 1.0, "measured_ms": 40.0},
            {"program": "q", "op_type": "mul", "ratio": 60.0,
             "predicted_ms": 1.0, "measured_ms": 60.0},
            {"program": "p", "op_type": "relu", "ratio": 2.0,
             "predicted_ms": 1.0, "measured_ms": 2.0}]
    attribution.save_op_class_calibration(rows, path)
    ratios = attribution.load_op_class_ratios(path)
    assert ratios == {"mul": 50.0, "relu": 2.0}
    p = planner.plan(tprog, mesh, op_class_ratios=ratios)
    assert p.cost.calibrated_step_time_s is not None
    assert p.cost.step_time_proxy_s > \
        planner.plan(tprog, mesh).cost.step_time_proxy_s
    assert any("op-class calibration" in n for n in p.diagnostics)
    assert [n for n, _ in planner.rank_candidates(
        tprog, mesh, op_class_ratios=ratios)] == \
        [n for n, _ in jplanner.rank_candidates(
            main, mesh, op_class_ratios=ratios)]
    with open(path) as f:
        assert attribution.load_op_class_ratios(json.load(f)) == ratios
