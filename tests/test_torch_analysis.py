"""The static analysis layer (``paddle_tpu_torch/analysis``) against the
JAX package's (``paddle_tpu/analysis``) on the same programs.

Every program is built with ``paddle_tpu``, serialized with ``to_json``
and loaded into the port, so both packages verify the same IR:

* **Codes.** ``CODES`` is equal, code for code and severity for severity.
* **Seeded defects.** One corruption of a known-clean program at a time
  (mirroring ``tests/test_analysis.py``): each yields exactly its
  ``PT0xx`` code in the port, and the same codes at the same op
  locations as the reference.
* **Clean programs.** For every model of ``paddle_tpu_torch/models`` the
  diagnostics (codes, op locations, vars) equal the reference's, and so
  does every variable's inferred (shape, dtype, lod_level).
* **Coverage.** Every port op has exactly one of a shape rule or an
  allowlist entry; the split equals the reference's for the port's 190
  names (186 rules + 4 allowlisted), with 158 shard rules; no name of
  the reference's ``tensor_ops``/``math_ops`` modules is missing.
* **The executor.** Validation is off by default, defers to the flag,
  runs once per (program version, fetches), rejects an invalid program
  before any step runs, survives ``id()`` reuse, and the trainer's
  ``validate=`` is a per-call override.  With validation off the
  executor never loads the verifier or the cost model.
* **The runtime shapes.** One interpreted step's every produced tensor
  equals its inferred shape (``-1`` bound to the batch) and dtype kind:
  ``chip_smoke.static_shape_walk``, run here on the CPU at a small size.

Tolerances: none — every comparison is exact.
"""
import dis
import builtins
import gc
import importlib.util
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu.analysis import CODES as JCODES
from paddle_tpu.analysis import ValidationReport as JReport
from paddle_tpu.analysis import shape_infer as jsi
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch import flags
from paddle_tpu_torch.analysis import (CODES, ProgramVerificationError,
                                       SHAPE_INFER_ALLOWLIST,
                                       ValidationReport, coverage)
from paddle_tpu_torch.analysis import diagnostics, shape_infer
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.core import registry

CPU = ptt.CPUPlace()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _jax_clean():
    """(main, startup, loss) of x[4] -> fc(3, softmax) -> CE -> mean, built
    by the JAX package (``tests/test_analysis.py``'s fixture)."""
    pt.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4], dtype="float32")
        label = pt.layers.data("label", shape=[1], dtype="int64")
        pred = pt.layers.fc(x, size=3, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
    return main, startup, loss


def _port(jprog):
    return ptt.Program.from_json(jprog.to_json())


def _diags(report):
    return [(d.code, d.severity, d.op, d.var) for d in report]


def _both(jprog, specs=None, **kw):
    """(reference diagnostics, port diagnostics) of one program, the port
    reading its JSON; ``specs`` sets Parameter.sharding in both."""
    tprog = _port(jprog)
    for name, spec in (specs or {}).items():
        jprog.global_block().var(name).sharding = spec
        tprog.global_block().var(name).sharding = spec
    return _diags(jprog.validate(**kw)), _diags(tprog.validate(**kw))


def _find_param(program, ndim):
    for v in program.global_block().vars.values():
        if v.persistable and v.shape is not None and len(v.shape) == ndim:
            return v
    raise AssertionError(f"no persistable rank-{ndim} param found")


def _out_of(program, op_type, slot="Out"):
    return next(op.outputs[slot][0] for op in program.global_block().ops
                if op.type == op_type)


def _info(v):
    return (v.shape, None if v.dtype is None else v.dtype.name, v.lod_level)


def _same_shapes(jprog):
    """Every var's inferred (shape, dtype, lod_level) equal in both."""
    tprog = _port(jprog)
    js = jsi.run_shape_inference(jprog, JReport())
    ts = shape_infer.run_shape_inference(tprog, ValidationReport())
    assert sorted(js) == sorted(ts)
    for b in js:
        assert sorted(js[b]) == sorted(ts[b]), b
        for name in js[b]:
            assert _info(js[b][name]) == _info(ts[b][name]), name
    return sum(len(v) for v in ts.values())


# ---------------------------------------------------------------------------
# codes
# ---------------------------------------------------------------------------
def test_codes_equal_the_reference():
    assert CODES == JCODES
    assert diagnostics.ERROR == "error" and diagnostics.WARNING == "warning"
    with pytest.raises(ValueError):
        diagnostics.Diagnostic("PT999", "error", "x")
    d = diagnostics.diag("PT020", "dead", op=(0, 3, "scale"), var="v")
    assert d.render() == \
        "PT020 warning at block 0 op #3 (scale) [var 'v']: dead"


# ---------------------------------------------------------------------------
# the seeded-defect matrix: one corruption -> exactly one code, as in the
# reference
# ---------------------------------------------------------------------------
def _dangling(main):
    op = main.global_block().ops[-1]
    op.inputs[next(iter(op.inputs))] = ["missing_var"]


def _declared_never_produced(main):
    b = main.global_block()
    b.create_var(name="phantom", shape=(-1, 4), dtype="float32")
    b.create_var(name="phantom_out", shape=(-1, 4), dtype="float32")
    b.append_op(type="scale", inputs={"X": ["phantom"]},
                outputs={"Out": ["phantom_out"]}, attrs={"scale": 2.0})


def _undeclared_output(main):
    main.global_block().append_op(
        type="scale", inputs={"X": ["x"]},
        outputs={"Out": ["never_declared"]}, attrs={"scale": 1.0})


def _duplicate_writer(main):
    b = main.global_block()
    b.create_var(name="t1", shape=(-1, 4), dtype="float32")
    for s in (1.0, 3.0):
        b.append_op(type="scale", inputs={"X": ["x"]},
                    outputs={"Out": ["t1"]}, attrs={"scale": s})


def _unregistered(main):
    b = main.global_block()
    b.create_var(name="bogus_out", shape=(-1, 4), dtype="float32")
    b.append_op(type="totally_bogus_op", inputs={"X": ["x"]},
                outputs={"Out": ["bogus_out"]})


def _orphan_len(main):
    main.global_block().create_var(name="seq@LEN", shape=(-1,),
                                   dtype="int64")


def _len_not_sequence(main):
    main.global_block().create_var(name="x@LEN", shape=(-1,),
                                   dtype="int64")


def _orphan_grad(main):
    b = main.global_block()
    b.create_var(name="g_out", shape=(-1, 4), dtype="float32")
    b.append_op(type="scale", inputs={"X": ["x@GRAD"]},
                outputs={"Out": ["g_out"]}, attrs={"scale": 1.0})


def _def_after_use(main):
    ops = main.global_block().ops
    ops.insert(0, ops.pop())


def _contraction(main):
    _find_param(main, 2).shape = (5, 3)


def _dtype_flip(main):
    main.global_block().var(_out_of(main, "softmax")).dtype = \
        np.dtype("int64")


def _shape_contradiction(main):
    main.global_block().var(_out_of(main, "softmax")).shape = (7, 9)


def _ragged_feed(main):
    main.global_block().create_var(
        name="ragged", shape=(-1, -1), dtype="float32", is_data=True)


def _persistable_rebound(main):
    # the reference's fixture writes with reduce_mean, which the port
    # does not register; scale writes the same hazard
    b = main.global_block()
    b.create_var(name="running", shape=(-1, 4), dtype="float32",
                 persistable=True)
    b.append_op(type="scale", inputs={"X": ["x"]},
                outputs={"Out": ["running"]}, attrs={"scale": 0.5})


def _rule_crash(main):
    # a rank-2 Input makes the lstm rule's ``b, t, h4 = x.shape`` unpack
    # fail: the crash must degrade to PT010, never escape validate()
    b = main.global_block()
    b.create_var(name="lw", shape=(2, 8), dtype="float32", persistable=True)
    for n in ("lh", "lc"):
        b.create_var(name=n, shape=(-1, -1, 2), dtype="float32")
    b.append_op(type="lstm", inputs={"Input": ["x"], "Weight": ["lw"]},
                outputs={"Hidden": ["lh"], "Cell": ["lc"]}, attrs={})


SEEDED = [
    ("PT001", _dangling), ("PT002", _declared_never_produced),
    ("PT003", _undeclared_output), ("PT004", _duplicate_writer),
    ("PT005", _unregistered), ("PT006", _orphan_len),
    ("PT006", _len_not_sequence), ("PT006", _orphan_grad),
    ("PT007", _def_after_use), ("PT010", _contraction),
    ("PT010", _rule_crash), ("PT011", _dtype_flip),
    ("PT012", _shape_contradiction), ("PT021", _ragged_feed),
    ("PT022", _persistable_rebound),
]


@pytest.mark.parametrize("code,corrupt", SEEDED,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in SEEDED])
def test_seeded_defect_fires_its_code_as_the_reference(code, corrupt):
    main, _, _ = _jax_clean()
    corrupt(main)
    ref, got = _both(main)
    assert {c for c, *_ in got} == {code}, got
    assert got == ref


def test_clean_program_reports_nothing_in_both():
    main, startup, loss = _jax_clean()
    for kw in ({"fetch_list": [loss.name]}, {},
               {"fetch_list": [loss.name], "mesh": {"dp": 2}}):
        assert _both(main, **kw) == ([], [])
    assert _both(startup) == ([], [])


def test_pt020_dead_tail_needs_fetch_targets():
    main, _, loss = _jax_clean()
    b = main.global_block()
    b.create_var(name="deadvar", shape=(-1, 4), dtype="float32")
    b.append_op(type="scale", inputs={"X": ["x"]},
                outputs={"Out": ["deadvar"]}, attrs={"scale": 1.0})
    ref, got = _both(main, fetch_list=[loss.name])
    assert {c for c, *_ in got} == {"PT020"} and got == ref
    assert _both(main) == ([], [])


def test_fetching_a_len_companion_alone_is_not_dead():
    pt.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        words = pt.layers.data("words", shape=[], dtype="int64",
                               lod_level=1)
        emb = pt.layers.embedding(words, size=[50, 8])
    assert _both(main, fetch_list=[emb.name + "@LEN"]) == ([], [])


@pytest.mark.parametrize("case", ["unknown_axis", "not_divisible",
                                  "override", "double_booked"])
def test_sharding_spec_lints_as_the_reference(case):
    main, _, loss = _jax_clean()
    w = _find_param(main, 2).name
    kw = {"fetch_list": [loss.name]}
    specs, want = {}, None
    if case == "unknown_axis":
        specs, kw["mesh"], want = {w: ("bogus_axis", None)}, {"dp": 2}, \
            "PT030"
    elif case == "not_divisible":
        specs, kw["mesh"], want = {w: ("dp", None)}, {"dp": 3}, "PT031"
    elif case == "override":
        kw.update(mesh={"dp": 2}, param_specs={w: ("nope",)})
        want = "PT030"
    else:
        kw.update(mesh={"dp": 1}, param_specs={w: ("dp", "dp")})
        want = "PT040"
    ref, got = _both(main, specs=specs, **kw)
    assert {c for c, *_ in got} == {want} and got == ref
    # no mesh context: the sharding lints are skipped
    kw.pop("mesh")
    kw.pop("param_specs", None)
    assert _both(main, specs=specs, **kw) == ([], [])


def test_raise_on_error_carries_the_report():
    main, _, _ = _jax_clean()
    _dangling(main)
    with pytest.raises(ProgramVerificationError) as ei:
        _port(main).validate(raise_on_error=True)
    assert "PT001" in ei.value.report.codes() and "PT001" in str(ei.value)


def test_dead_op_lint_sees_nested_sub_blocks():
    """A global-block producer read only two sub-blocks down (through the
    port's ``rnn`` op, which the reference's fixture spells ``while``)
    is live in both packages."""
    main = pt.Program()
    b0 = main.global_block()
    b0.create_var(name="x", shape=(-1, 4), dtype="float32", is_data=True)
    b0.create_var(name="emb", shape=(-1, 4), dtype="float32")
    b0.create_var(name="out", shape=(-1, 4), dtype="float32")
    b1 = main.create_block(parent_idx=0)
    b2 = main.create_block(parent_idx=b1.idx)
    main.current_block_idx = 0
    b0.append_op(type="scale", inputs={"X": ["x"]},
                 outputs={"Out": ["emb"]}, attrs={"scale": 1.0})
    b2.append_op(type="scale", inputs={"X": ["emb"]},
                 outputs={"Out": ["inner"]}, attrs={"scale": 1.0})
    b1.append_op(type="rnn", inputs={}, outputs={},
                 attrs={"sub_block": b2.idx})
    b0.append_op(type="rnn", inputs={"X": ["x"]},
                 outputs={"Out": ["out"]}, attrs={"sub_block": b1.idx})
    ref, got = _both(main, fetch_list=["out"])
    assert got == ref and "PT020" not in [c for c, *_ in got]


def test_backward_pseudo_op_counts_as_registered():
    """The executor runs ``backward`` itself: no PT005 for a training
    program, whose Grads bind from their declarations."""
    ref, got = _both(tp.build_train(pt, "mnist_mlp", [784])[0])
    assert ref == got == []


# ---------------------------------------------------------------------------
# clean programs: every model of the port
# ---------------------------------------------------------------------------
def _img(shape):
    return lambda pkg: pkg.layers.data("img", shape=shape, dtype="float32")


def _words(pkg, name="words"):
    return pkg.layers.data(name, shape=[], dtype="int64", lod_level=1)


MODELS = {
    "mnist_mlp": lambda p: [p.models.mnist_mlp(_img([784])(p))],
    "mnist_lenet": lambda p: [p.models.mnist_lenet(_img([1, 28, 28])(p))],
    "alexnet": lambda p: [p.models.alexnet(_img([3, 224, 224])(p))],
    "vgg16": lambda p: [p.models.vgg16(_img([3, 32, 32])(p))],
    "vgg19": lambda p: [p.models.vgg19(_img([3, 32, 32])(p))],
    "vgg_cifar": lambda p: [p.models.vgg_cifar(_img([3, 32, 32])(p))],
    "resnet_cifar": lambda p: [p.models.resnet_cifar(
        _img([3, 16, 16])(p), depth=8)],
    "resnet_imagenet": lambda p: [p.models.resnet_imagenet(
        _img([3, 64, 64])(p), depth=18)],
    "resnet50": lambda p: [p.models.resnet50(_img([3, 64, 64])(p),
                                             num_classes=10)],
    "googlenet": lambda p: [p.models.googlenet(_img([3, 64, 64])(p))],
    "lstm_text_classification": lambda p: [
        p.models.lstm_text_classification(_words(p), vocab_size=50,
                                          emb_dim=8, hidden_size=8)],
    "seq2seq_attention": lambda p: [p.models.seq2seq_attention(
        _words(p, "src"), _words(p, "tgt"), src_vocab_size=30,
        tgt_vocab_size=30, emb_dim=8, hidden_dim=8)],
    "seq2seq_infer": lambda p: list(p.models.seq2seq_infer(
        _words(p, "src"), src_vocab_size=30, tgt_vocab_size=30, emb_dim=8,
        hidden_dim=8, beam_size=2, max_len=4)),
    "wide_deep": lambda p: [p.models.wide_deep(
        [p.layers.data("f1", shape=[1], dtype="int64"),
         p.layers.data("f2", shape=[1], dtype="int64")],
        p.layers.data("dense", shape=[4], dtype="float32"),
        vocab_sizes=[20, 30], emb_dim=4, deep_hidden=(8,))],
}


def test_every_port_model_is_covered():
    assert set(MODELS) == set(ptt.models.__all__)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_validates_and_infers_as_the_reference(name):
    pt.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        fetch = [v.name for v in MODELS[name](pt)]
    ref, got = _both(main, fetch_list=fetch)
    assert got == ref, (ref, got)
    assert _both(startup) == ([], [])
    assert _same_shapes(main) > 0
    _same_shapes(startup)


@pytest.mark.parametrize("build", ["resnet_cifar", "longctx", "seq2seq",
                                   "lstm_adam"])
def test_training_program_validates_and_infers_as_the_reference(build):
    if build == "resnet_cifar":
        main, startup, _, loss = tp.build_train(pt, "resnet_cifar",
                                                [3, 16, 16], depth=8)
    elif build == "longctx":
        main, startup, loss = tp.build_longctx(pt, 256, 2, 16, block=64)
    elif build == "seq2seq":
        main, startup, loss = tp.build_seq2seq(pt, 30, 8)
    else:
        pt.unique_name.reset()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            pred = pt.models.lstm_text_classification(
                _words(pt), vocab_size=50, emb_dim=8, hidden_size=8)
            label = pt.layers.data("label", shape=[1], dtype="int64")
            loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
            pt.optimizer.Adam(1e-3).minimize(loss)
    ref, got = _both(main, fetch_list=[loss.name])
    assert got == ref == []
    assert _same_shapes(main) > 0 and _same_shapes(startup) > 0


# ---------------------------------------------------------------------------
# coverage and the rule tables
# ---------------------------------------------------------------------------
def test_every_op_has_exactly_one_of_a_rule_or_an_allowlist_entry():
    ops = set(registry.registered_ops())
    fns = set(registry.registered_shape_fns())
    allow = set(SHAPE_INFER_ALLOWLIST)
    assert len(ops) == 239
    assert not ops - fns - allow, sorted(ops - fns - allow)
    assert not fns & allow and not allow - ops and not fns - ops
    assert coverage() == (232, 239)
    assert allow == {"beam_search", "beam_search_decode", "recurrent",
                     "rnn", "while", "conditional_block", "write_to_array"}


def test_coverage_equals_the_references_for_the_port_names():
    ops = set(registry.registered_ops())
    assert ops <= set(jreg.registered_ops())
    assert set(registry.registered_shape_fns()) == \
        ops & set(jreg.registered_shape_fns())
    assert SHAPE_INFER_ALLOWLIST == ops & jsi.SHAPE_INFER_ALLOWLIST
    shard = set(registry.registered_shard_fns())
    assert shard == ops & set(jreg.registered_shard_fns())
    assert len(shard) == 181
    assert ops - shard == {
        "while", "conditional_block", "split_lod_tensor",
        "merge_lod_tensor", "write_to_array", "read_from_array",
        "lod_array_length", "lod_tensor_to_array", "array_to_lod_tensor",
        "lod_rank_table", "reorder_lod_tensor_by_rank",
        "bilinear_interp", "bilinear_tensor_product", "block_expand",
        "conv2d_transpose", "conv3d", "cross_entropy_over_beam",
        "fill_constant_batch_size_like", "gru_unit", "im2sequence",
        "lambda_rank", "maxout", "modified_huber_loss", "pad_constant_like",
        "recurrent", "rnn", "sequence_conv", "split", "spp", "unpool",
        "conv_shift", "crop", "expand", "factorization_machine",
        "multiplex", "outer_prod", "pad", "select", "slice", "stack",
        "tile", "unstack", "where", "chunk_eval", "conv2d_dynamic_filter",
        "edit_distance", "kmax_seq_score", "lstm_unit",
        "max_sequence_len", "row_conv", "sequence_concat",
        "sequence_context", "sequence_expand", "sequence_expand_as",
        "sequence_reshape", "sequence_slice", "sub_nested_seq", "warpctc"}


def test_no_name_of_the_tensor_and_math_modules_is_missing():
    """Every op the reference registers in ``ops/tensor_ops.py`` and
    ``ops/math_ops.py`` is registered by the port, with its rules."""
    import paddle_tpu.ops.math_ops as jmath
    import paddle_tpu.ops.tensor_ops as jtensor
    import inspect
    names = {n for n in jreg.registered_ops()
             if inspect.getmodule(jreg.get_op_impl(n)) in (jmath, jtensor)}
    assert len(names) == 88
    assert names <= set(registry.registered_ops())
    assert names <= set(registry.registered_shape_fns())
    assert names & set(registry.registered_shard_fns()) == \
        names & set(jreg.registered_shard_fns())


def test_no_name_of_the_sequence_crf_and_embedding_modules_is_missing():
    """Every op the reference registers in ``ops/sequence_ops.py``,
    ``ops/crf_ops.py`` and ``ops/embedding_ops.py`` is registered by the
    port, with its shape rule and, where the reference has one, its
    shard rule."""
    import paddle_tpu.ops.crf_ops as jcrf
    import paddle_tpu.ops.embedding_ops as jemb
    import paddle_tpu.ops.sequence_ops as jseq
    import inspect
    names = {n for n in jreg.registered_ops()
             if inspect.getmodule(jreg.get_op_impl(n)) in (jseq, jcrf, jemb)}
    assert len(names) == 33
    assert names <= set(registry.registered_ops())
    assert names <= set(registry.registered_shape_fns())
    assert names & set(registry.registered_shard_fns()) == \
        names & set(jreg.registered_shard_fns())


def test_a_name_registered_twice_raises():
    for reg in (registry.register_shape_fn, registry.register_shard_fn):
        with pytest.raises(ValueError, match="registered twice"):
            reg("mul")(lambda op, ins, attrs: {})


def _walk_code(code):
    yield code
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            yield from _walk_code(const)


@pytest.mark.parametrize("kind", ["shape", "shard"])
def test_rules_resolve_all_globals(kind):
    names = registry.registered_shape_fns() if kind == "shape" \
        else registry.registered_shard_fns()
    get = registry.get_shape_fn if kind == "shape" \
        else registry.get_shard_fn
    seen, bad = set(), []
    for name in names:
        fns = [get(name)]
        fns += [getattr(fns[0], "backward")] \
            if hasattr(fns[0], "backward") else []
        for fn in fns:
            if fn.__code__ in seen:
                continue
            seen.add(fn.__code__)
            for code in _walk_code(fn.__code__):
                for ins in dis.get_instructions(code):
                    if (ins.opname == "LOAD_GLOBAL"
                            and ins.argval not in fn.__globals__
                            and not hasattr(builtins, ins.argval)):
                        bad.append((name, fn.__qualname__, ins.argval))
    assert not bad


def test_dtype_facts_equal_numpys_through_the_reference():
    """The cost model reads an itemsize where the reference reads
    ``np.dtype(info.dtype).itemsize``: equal for every dtype, bfloat16
    included, and the kinds PT011 compares agree."""
    from paddle_tpu.analysis.cost_model import _itemsize as jitemsize
    from paddle_tpu_torch.analysis.cost_model import _itemsize
    for name in ("bool", "int8", "uint8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64"):
        j, t = jsi.VarInfo((2,), name), shape_infer.VarInfo((2,), name)
        assert _itemsize(t) == jitemsize(j), name
        assert t.dtype.kind == j.dtype.kind or \
            (name == "bfloat16" and jsi._kind(j.dtype) == "f"), name
        assert shape_infer._kind(t.dtype) == jsi._kind(j.dtype), name
        assert t.dtype == name and t.dtype == j.dtype.name
        assert t.dtype == getattr(torch, name)
    assert _itemsize(None) == jitemsize(None) == 4


def test_pt011_tolerates_a_change_of_width():
    """AMP computes a float32 program in bfloat16: a width change is no
    PT011, a kind change is."""
    b = ptt.Program().global_block()
    for dt, want in (("bfloat16", []), ("float64", []),
                     ("int32", ["PT011"])):
        rep = ValidationReport()
        shape_infer._check_against_declared(
            rep, b, 0, ptt.core.program.Operator(b, "scale", {}, {}, {}),
            "v", shape_infer.VarInfo((2,), dt),
            shape_infer.VarInfo((2,), "float32"))
        assert rep.codes() == want, dt


# ---------------------------------------------------------------------------
# the executor and the trainer
# ---------------------------------------------------------------------------
def _port_clean():
    main, startup, loss = _jax_clean()
    return _port(main), _port(startup), loss.name


def _feeds(rng):
    return {"x": rng.rand(8, 4).astype("float32"),
            "label": rng.randint(0, 3, (8, 1))}


def _validations():
    return compile_cache.stats().snapshot()["validations"]


def test_validation_runs_once_per_signature():
    rng = np.random.RandomState(0)
    main, startup, loss = _port_clean()
    v0 = _validations()
    exe = ptt.Executor(CPU, validate=True)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(4):
        exe.run(main, feed=_feeds(rng), fetch_list=[loss], scope=scope)
    # once for startup, once for (main, [loss]) — not once a step
    assert _validations() - v0 == 2
    exe.run_steps(3, main, feed=_feeds(rng), fetch_list=[loss],
                  scope=scope)
    list(exe.run_pipelined(iter([_feeds(rng)] * 5), main,
                           fetch_list=[loss], scope=scope,
                           steps_per_dispatch=2))
    assert _validations() - v0 == 2
    # a different fetch signature is a fresh validation
    exe.run(main, feed=_feeds(rng), fetch_list=[], scope=scope)
    assert _validations() - v0 == 3
    # stale versions are swept: a mutated program keeps one memo entry
    for _ in range(5):
        main._bump_version()
        exe.run(main, feed=_feeds(rng), fetch_list=[loss], scope=scope)
    assert len(exe._validated[main]) == 1


def test_validation_is_off_by_default_and_defers_to_the_flag():
    rng = np.random.RandomState(1)
    main, startup, loss = _port_clean()
    v0 = _validations()
    exe = ptt.Executor(CPU)
    assert exe.validate is None
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feeds(rng), fetch_list=[loss], scope=scope)
    assert _validations() == v0
    flags.set_flag("validate", True)
    try:
        exe = ptt.Executor(CPU)
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feeds(rng), fetch_list=[loss], scope=scope)
    finally:
        flags.set_flag("validate", False)
    assert _validations() - v0 == 2


def test_invalid_program_is_rejected_before_any_step():
    """Nothing runs and nothing enters the step cache; the rejection
    repeats (an error report is never memoized as validated)."""
    rng = np.random.RandomState(2)
    main, _, _ = _jax_clean()
    _dangling(main)
    main = _port(main)
    exe = ptt.Executor(CPU, validate=True)
    before = compile_cache.stats().snapshot()
    for run in (lambda: exe.run(main, feed=_feeds(rng)),
                lambda: exe.run_steps(2, main, feed=_feeds(rng)),
                lambda: next(exe.run_pipelined(iter([_feeds(rng)]), main))):
        with pytest.raises(ProgramVerificationError) as ei:
            run()
        assert "PT001" in ei.value.report.codes()
    after = compile_cache.stats().snapshot()
    assert len(exe._cache) == 0 and exe._step == 0
    assert after["uncaptured"] == before["uncaptured"]
    assert (after["captures"], after["warmups"]) == \
        (before["captures"], before["warmups"])


def test_warnings_are_emitted_once_per_signature():
    rng = np.random.RandomState(3)
    main, startup, loss = _jax_clean()
    b = main.global_block()
    b.create_var(name="deadvar", shape=(-1, 4), dtype="float32")
    b.append_op(type="scale", inputs={"X": ["x"]},
                outputs={"Out": ["deadvar"]}, attrs={"scale": 1.0})
    main, startup = _port(main), _port(startup)
    exe = ptt.Executor(CPU, validate=True)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            exe.run(main, feed=_feeds(rng), fetch_list=[loss.name],
                    scope=scope)
    msgs = [str(x.message) for x in w if "program verifier" in
            str(x.message)]
    assert len(msgs) == 1 and "PT020" in msgs[0]


def test_validation_memo_survives_id_reuse():
    rng = np.random.RandomState(4)
    exe = ptt.Executor(CPU, validate=True)
    scope = ptt.Scope()
    ok_main, ok_startup, ok_loss = _port_clean()
    exe.run(ok_startup, scope=scope)
    exe.run(ok_main, feed=_feeds(rng), fetch_list=[ok_loss], scope=scope)
    del ok_main, ok_startup
    gc.collect()
    for _ in range(20):
        bad, _, loss = _jax_clean()
        assert loss.name == ok_loss
        _dangling(bad)
        bad = _port(bad)
        with pytest.raises(ProgramVerificationError):
            exe.run(bad, feed=_feeds(rng), fetch_list=[ok_loss],
                    scope=scope)
        del bad


def test_trainer_validate_is_a_per_call_override():
    from paddle_tpu_torch.trainer import SGD
    rng = np.random.RandomState(5)
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()
    x = ptt.layers.data("x", shape=[4], dtype="float32")
    label = ptt.layers.data("label", shape=[1], dtype="int64")
    pred = ptt.layers.fc(x, size=3, act="softmax")
    loss = ptt.layers.mean(ptt.layers.cross_entropy(pred, label))
    tr = SGD(loss, place=CPU)
    assert tr.exe.validate is None
    v0 = _validations()
    batch = [[rng.rand(4).astype("float32"),
              rng.randint(0, 3, (1,)).astype("int64")] for _ in range(4)]
    tr.train(lambda: iter([batch, batch]), num_passes=1,
             feed_list=[x, label], validate=True)
    # startup + the training step, once each over two batches
    assert _validations() - v0 == 2
    assert tr.exe.validate is None
    tr.train(lambda: iter([batch]), num_passes=1, feed_list=[x, label])
    assert _validations() - v0 == 2
    tr.exe.validate = True
    tr.train(lambda: iter([batch]), num_passes=1, feed_list=[x, label],
             validate=False)
    assert tr.exe.validate is True and _validations() - v0 == 2


def test_validation_off_never_loads_the_verifier_or_the_cost_model():
    """``import paddle_tpu_torch`` loads only the rule helpers; an
    executor with validation off runs without loading the verifier, the
    lints, the cost model or the planner."""
    names = [f"paddle_tpu_torch.analysis.{m}" for m in
             ("verifier", "lints", "cost_model", "planner",
              "concurrency")]
    saved = {n: sys.modules.pop(n) for n in names if n in sys.modules}

    class Refuse:
        def find_spec(self, fullname, path=None, target=None):
            if fullname in names:
                raise AssertionError(f"{fullname} imported")

    finder = Refuse()
    sys.meta_path.insert(0, finder)
    try:
        rng = np.random.RandomState(6)
        main, startup, loss = _port_clean()
        exe = ptt.Executor(CPU)
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feeds(rng), fetch_list=[loss], scope=scope)
        exe.run_steps(2, main, feed=_feeds(rng), fetch_list=[loss],
                      scope=scope)
        assert not [n for n in names if n in sys.modules]
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)


# ---------------------------------------------------------------------------
# inferred shapes against one interpreted step's tensors
# ---------------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("what", ["resnet50_amp", "longctx_amp",
                                  "resnet_cifar_fp32"])
def test_static_shapes_equal_one_interpreted_steps_tensors(what):
    cs = _chip_smoke()
    tp.reset_both()
    rng = np.random.RandomState(7)
    if what == "longctx_amp":
        main, startup, _ = tp.build_longctx(ptt, 128, 2, 16, block=64)
        feed, batch, amp = {}, 1, True
    else:
        model, shape, kw = ("resnet50", [3, 32, 32],
                            {"num_classes": 10}) \
            if what == "resnet50_amp" else ("resnet_cifar", [3, 16, 16],
                                            {"depth": 8})
        main, startup, _, _ = tp.build_train(ptt, model, shape, **kw)
        batch, amp = 2, what.endswith("amp")
        feed = {"img": rng.rand(batch, *shape).astype("float32"),
                "label": rng.randint(0, 10, (batch, 1))}
    scope = ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=scope)
    exe = ptt.Executor(CPU, amp=amp)
    n = cs.static_shape_walk(exe, main, feed, scope, batch)
    produced = {n for op in main.global_block().ops
                for n in op.output_names}
    assert n >= len(produced) > 0
    if feed:
        # the walk fails where a shape disagrees: bind -1 to another batch
        with pytest.raises(RuntimeError, match="inferred"):
            cs.static_shape_walk(exe, main, feed, scope, batch + 1)
