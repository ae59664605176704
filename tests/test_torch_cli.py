"""The port's command line (``paddle_tpu_torch/cli.py``, ``python -m
paddle_tpu_torch``) against the JAX package's (``paddle_tpu/cli.py``) on
the same files, in-process on the CPU (``--device cpu`` on the port's
side), with two v1 configs written here: the MLP of tests/test_cli.py
and a narrow bottleneck ResNet with 1x1 convs
(``chip_smoke.resnet_v1_conf``'s layout, two blocks at 32 x 32).

* train: the JAX command line trains a pass and saves it; both resume
  it from the same npz feeds, their pass-1 losses within TRAIN_TOL
  (fp32) and AMP_TOL (``--use_amp``), and each package's ``--job test``
  loads the other's saved pass;
* the usage errors, ``_synth_feeds``' arrays, ``_parse_mesh``;
* checkgrad: PASS over the same parameters and indices in both (float64
  on both sides), and FAIL with exit 1 on a gradient broken on purpose;
* check and plan: the same PT0xx codes and exit codes on a JSON program,
  a ``__model__`` directory and ``--config``, with and without
  ``--mesh``/``--strict``; equal ``plan --json`` specs; ``--specs``
  round trips;
* stats, trace and doctor: equal ``--json`` documents on a log the port
  wrote;
* profile: the same op rows; ``--compiled-check`` refuses naming item 6;
* the device: without a card and without ``--device cpu`` the config
  runner raises; on a card (``cuda``) it trains there.

The subprocess round of ``python -m paddle_tpu_torch`` is ``@slow``.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# pass-1 losses of the two packages from the same saved pass and feeds:
# fp32 on both sides, 3 steps
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)
# under --use_amp both compute in bf16 (its ulp is 2^-8 relative), so the
# rounding points differ
AMP_TOL = dict(rtol=2e-2, atol=2e-2)
# test outputs on the same weights and feeds
TEST_TOL = dict(rtol=1e-5, atol=1e-6)

MLP_CONF = """
settings(batch_size=8, learning_rate=0.1)
x = data_layer('x', 4)
y = data_layer('label', 2)
h = fc_layer(input=x, size=8, act=ReluActivation())
out = fc_layer(input=h, size=2, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=y))
"""

# a conv net with smooth activations (tanh, average pooling): the float64
# central difference at eps 1e-4 meets no ReLU or max-pool kink, so
# checkgrad's 1e-3 holds the conv, batch-norm and fc gradients
SMOOTH_CONV_CONF = """
settings(batch_size=4, learning_rate=0.01,
         learning_method=MomentumOptimizer(momentum=0.9))
img = data_layer(name="image", size=3 * 8 * 8)
c = img_conv_layer(input=img, filter_size=3, num_channels=3, num_filters=8,
                   stride=1, padding=1, act=LinearActivation(),
                   bias_attr=False)
b = batch_norm_layer(input=c, act=TanhActivation())
c2 = img_conv_layer(input=b, filter_size=1, num_filters=16, stride=1,
                    padding=0, act=TanhActivation())
p = img_pool_layer(input=c2, pool_size=8, stride=1, pool_type=AvgPooling())
out = fc_layer(input=p, size=10, act=SoftmaxActivation())
lbl = data_layer(name="label", size=10)
outputs(classification_cost(input=out, label=lbl))
"""

LSTM_CONF = """
settings(batch_size=4, learning_rate=0.01, learning_method=AdamOptimizer())
word = data_layer('word', 50)
emb = embedding_layer(input=word, size=16)
lstm = simple_lstm(input=emb, size=8)
last = last_seq(input=lstm)
out = fc_layer(input=last, size=3, act=SoftmaxActivation())
label = data_layer('label', 3)
outputs(classification_cost(input=out, label=label))
"""


def _resnet_conf():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.resnet_v1_conf(blocks=(2,), widths=(16,), img=32,
                              classes=10, stem=16, batch=4)


@pytest.fixture(scope="module")
def confs(tmp_path_factory):
    d = tmp_path_factory.mktemp("confs")
    out = {}
    for name, text in (("mlp", MLP_CONF), ("resnet", _resnet_conf()),
                       ("smooth", SMOOTH_CONV_CONF), ("lstm", LSTM_CONF)):
        path = d / f"{name}.py"
        path.write_text(text)
        out[name] = str(path)
    rng = np.random.RandomState(3)
    feeds = {
        "mlp": {"x": rng.rand(8, 4).astype("float32"),
                "label": rng.randint(0, 2, (8, 1)).astype("int64")},
        "resnet": {"image": rng.rand(4, 3 * 32 * 32).astype("float32"),
                   "label": rng.randint(0, 10, (4, 1)).astype("int64")},
        "smooth": {"image": rng.rand(4, 3 * 8 * 8).astype("float32"),
                   "label": rng.randint(0, 10, (4, 1)).astype("int64")},
    }
    for name, f in feeds.items():
        np.savez(d / f"{name}.npz", **f)
        out[name + "_npz"] = str(d / f"{name}.npz")
    return out


def reset_both():
    """Fresh default programs, scopes and name counters in the port, and
    in the JAX package where a test has imported it (the card's tests
    import no JAX)."""
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()
    if "paddle_tpu" in sys.modules:
        from torch_parity import reset_both as both
        both()


def _jax():
    """The JAX package and its command line, imported by the CPU tests
    only."""
    import paddle_tpu
    import paddle_tpu.cli
    return paddle_tpu, paddle_tpu.cli


@pytest.fixture(autouse=True)
def fresh():
    reset_both()
    yield
    reset_both()


@pytest.fixture
def x64_restored():
    """The JAX command line turns x64 on for checkgrad; put it back."""
    import jax
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _run(pkg, argv, device="cpu"):
    """(exit code, JSON lines, text) of one in-process command line run,
    with fresh programs, scopes and name counters (what a new process
    has); the port's runs that take a device get ``--device``."""
    main = tcli.main if pkg == "torch" else _jax()[1].main
    reset_both()
    if pkg == "torch" and argv[0] not in ("check", "plan", "stats",
                                          "trace"):
        argv = list(argv) + ["--device", device]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    text = buf.getvalue()
    lines = []
    for ln in text.splitlines():
        try:
            lines.append(json.loads(ln))
        except json.JSONDecodeError:
            continue
    return rc, lines, text


def _train_argv(confs, name, *extra):
    return ["--config", confs[name], "--job", "train", "--steps_per_pass",
            "3", "--feed-npz", confs[name + "_npz"], *extra]


# ---------------------------------------------------------------------------
# train / test
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,amp", [("mlp", False), ("mlp", True),
                                      ("resnet", False), ("resnet", True)])
def test_both_resume_a_jax_pass_and_test_the_others(confs, tmp_path, name,
                                                    amp):
    amp_flag = ["--use_amp"] if amp else []
    tol = AMP_TOL if amp else TRAIN_TOL
    jsave = tmp_path / "jax"
    rc, first, _ = _run("jax", _train_argv(
        confs, name, "--num_passes", "1", "--save_dir", str(jsave),
        *amp_flag))
    assert rc == 0 and [r["pass"] for r in first] == [0]
    base = str(jsave / "pass-00000")
    resumed = {}
    for pkg in ("jax", "torch"):
        rc, lines, _ = _run(pkg, _train_argv(
            confs, name, "--start_pass", "1", "--num_passes", "2",
            "--init_model_path", base, "--save_dir",
            str(tmp_path / f"{pkg}-resumed"), *amp_flag))
        assert rc == 0 and [r["pass"] for r in lines] == [1]
        resumed[pkg] = lines[0]
        assert (tmp_path / f"{pkg}-resumed" / "pass-00001").is_dir()
    for key in ("loss", "mean_loss"):
        np.testing.assert_allclose(resumed["torch"][key],
                                   resumed["jax"][key], **tol)
    # each package's test job on the other's saved pass, against the
    # saving package's own
    for saver in ("jax", "torch"):
        d = str(tmp_path / f"{saver}-resumed" / "pass-00001")
        outs = {}
        for pkg in ("jax", "torch"):
            rc, lines, _ = _run(pkg, ["--config", confs[name], "--job",
                                      "test", "--init_model_path", d,
                                      "--feed-npz", confs[name + "_npz"]])
            assert rc == 0 and len(lines) == 1
            outs[pkg] = lines[0]
        assert outs["torch"]["output"] == outs["jax"]["output"]
        assert outs["torch"]["shape"] == outs["jax"]["shape"]
        np.testing.assert_allclose(outs["torch"]["mean"],
                                   outs["jax"]["mean"], **TEST_TOL)


def test_time_job_prints_the_same_line(confs):
    for pkg in ("jax", "torch"):
        rc, lines, _ = _run(pkg, ["--config", confs["mlp"], "--job", "time",
                                  "--iters", "3", "--feed-npz",
                                  confs["mlp_npz"]])
        assert rc == 0 and set(lines[-1]) == {"ms_per_batch",
                                              "batches_per_sec"}
        assert lines[-1]["ms_per_batch"] > 0


def test_start_pass_past_num_passes_is_the_same_usage_error(confs):
    msgs = {}
    for pkg in ("jax", "torch"):
        with pytest.raises(SystemExit) as e:
            _run(pkg, _train_argv(confs, "mlp", "--start_pass", "1"))
        msgs[pkg] = e.value.code
    assert msgs["torch"] == msgs["jax"] and "total" in msgs["torch"]


def test_unknown_subcommand_is_a_usage_error_in_both(capsys):
    for main in (tcli.main, _jax()[1].main):
        with pytest.raises(SystemExit) as e:
            main(["bogus"])
        assert e.value.code == 2
        assert "--config" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["mlp", "resnet", "lstm"])
def test_synth_feeds_and_used_names_are_the_jax_ones(confs, name):
    from paddle_tpu.trainer_config_helpers import load_v1_config as jload
    from paddle_tpu_torch.trainer_config_helpers import load_v1_config
    jcli = _jax()[1]
    reset_both()
    j = jload(confs[name])
    t = load_v1_config(confs[name])
    for batch, seed, seq_len in ((5, 0, 7), (3, 4, 12)):
        a = jcli._synth_feeds(j, batch, seed=seed, seq_len=seq_len)
        b = tcli._synth_feeds(t, batch, seed=seed, seq_len=seq_len)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    assert tcli._used_feed_names(t) == jcli._used_feed_names(j)


def test_small_parsers_are_the_jax_ones():
    jcli = _jax()[1]
    for s in (None, "", "a=1", "a=1, b = x ,c="):
        assert tcli._parse_config_args(s) == jcli._parse_config_args(s)
    for s in (None, "dp=8", "dp=4,tp=2"):
        assert tcli._parse_mesh(s) == jcli._parse_mesh(s)
    for bad in ("dp=x", "dp=0", "dp=8,dp=2"):
        with pytest.raises(SystemExit) as a:
            tcli._parse_mesh(bad)
        with pytest.raises(SystemExit) as b:
            jcli._parse_mesh(bad)
        assert a.value.code == b.value.code


def test_elastic_takes_the_command_lines_config_parser():
    from paddle_tpu_torch.distributed import elastic
    assert not hasattr(elastic, "_parse_config_args")
    src = open(elastic.__file__).read()
    assert src.count("from ..cli import _parse_config_args") == 2


# ---------------------------------------------------------------------------
# checkgrad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mlp", "smooth"])
def test_checkgrad_passes_over_the_same_probes(confs, name, x64_restored):
    reports = {}
    for pkg in ("jax", "torch"):
        rc, lines, _ = _run(pkg, ["--config", confs[name], "--job",
                                  "checkgrad", "--feed-npz",
                                  confs[name + "_npz"]])
        assert rc == 0 and lines[-1] == {"checkgrad": "PASS",
                                         "failures": 0}, lines
        reports[pkg] = lines[:-1]
    assert "warning" not in json.dumps(reports["jax"])
    assert [(r["param"], r["index"]) for r in reports["torch"]] == \
        [(r["param"], r["index"]) for r in reports["jax"]]
    assert len(reports["torch"]) == 9


def test_checkgrad_probes_the_same_resnet_parameters(confs, x64_restored):
    """The narrow ResNet's ReLUs and max pool put kinks within eps of
    its activations (the port's float64 central difference at
    ``_conv1_conv.w0``[666] reads -0.1963 at eps 1e-4, -0.1985 at 1e-5,
    -0.19907999516 at 1e-6 against autodiff's -0.19907999548), so the
    verdicts need not be PASS at this size; both packages probe the same
    parameters at the same indices and report each probe."""
    probes = {}
    for pkg in ("jax", "torch"):
        rc, lines, _ = _run(pkg, ["--config", confs["resnet"], "--job",
                                  "checkgrad", "--feed-npz",
                                  confs["resnet_npz"]])
        assert lines[-1]["checkgrad"] in ("PASS", "FAIL")
        assert rc == (lines[-1]["checkgrad"] == "FAIL")
        assert lines[-1]["failures"] == sum(not r["ok"]
                                            for r in lines[:-1])
        probes[pkg] = [(r["param"], r["index"]) for r in lines[:-1]]
    assert probes["torch"] == probes["jax"]
    assert [p for p, _ in probes["torch"]][::3] == [
        "_conv1_conv.w0", "_conv1_bn.w0", "_conv1_bn.wbias"]


def test_checkgrad_fails_on_a_broken_gradient(confs, monkeypatch):
    from paddle_tpu_torch.core.executor import Executor
    real = Executor.run

    def broken(self, program=None, feed=None, fetch_list=None, **kw):
        out = real(self, program, feed, fetch_list, **kw)
        names = [getattr(v, "name", v) for v in fetch_list or []]
        return [o * 2 + 1e-2 if n.endswith("@GRAD") else o
                for n, o in zip(names, out)]
    monkeypatch.setattr(Executor, "run", broken)
    rc, lines, _ = _run("torch", ["--config", confs["mlp"], "--job",
                                  "checkgrad", "--feed-npz",
                                  confs["mlp_npz"]])
    assert rc == 1
    assert lines[-1]["checkgrad"] == "FAIL" and lines[-1]["failures"] == 9
    assert not any(r["ok"] for r in lines[:-1])


# ---------------------------------------------------------------------------
# check / plan
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def programs(confs, tmp_path_factory):
    """The MLP's training program as JSON, and its inference program as a
    save_inference_model ``__model__`` directory, both written by the JAX
    package."""
    from paddle_tpu.trainer_config_helpers import load_v1_config as jload
    pt = _jax()[0]
    d = tmp_path_factory.mktemp("programs")
    reset_both()
    cfg = jload(confs["mlp"])
    out = cfg.outputs[0]
    model = d / "model"
    exe = pt.Executor()
    exe.run(cfg.startup_program)
    pt.save_inference_model(str(model), ["x", "label"], [out], exe,
                            main_program=cfg.main_program)
    cfg.minimize_outputs()
    prog = d / "train.json"
    prog.write_text(cfg.main_program.to_json())
    reset_both()
    return {"json": str(prog), "model": str(model)}


def _codes(text):
    return sorted(re.findall(r"\bPT0\d\d\b", text))


@pytest.mark.parametrize("target", ["json", "model", "config"])
@pytest.mark.parametrize("extra", [[], ["--mesh", "dp=8"], ["--strict"],
                                   ["--mesh", "dp=8,tp=3", "--strict"]])
def test_check_reports_the_same_codes(confs, programs, target, extra):
    argv = ["check"] + (["--config", confs["mlp"]] if target == "config"
                        else [programs[target]]) + extra
    got = {pkg: _run(pkg, argv) for pkg in ("jax", "torch")}
    (trc, tlines, ttext), (jrc, jlines, jtext) = got["torch"], got["jax"]
    assert trc == jrc
    assert tlines[-1] == jlines[-1]
    assert _codes(ttext) == _codes(jtext)


def test_plan_gives_the_same_specs_and_round_trips(programs, tmp_path):
    docs = {}
    for pkg in ("jax", "torch"):
        rc, lines, _ = _run(pkg, ["plan", programs["json"], "--mesh",
                                  "dp=8", "--json", "--out",
                                  str(tmp_path / f"{pkg}.json")])
        assert rc == 0 and len(lines) == 1
        docs[pkg] = lines[0]
    for key in ("param_specs", "feed_specs", "mesh", "batch_axis",
                "candidate", "diagnostics"):
        assert docs["torch"][key] == docs["jax"][key], key
    # a written plan validates against its program in both packages
    for pkg in ("jax", "torch"):
        for writer in ("jax", "torch"):
            rc, lines, _ = _run(pkg, ["check", programs["json"], "--specs",
                                      str(tmp_path / f"{writer}.json")])
            assert rc == 0 and lines[-1]["check"] == "PASS"
    # the human form ends on the summary line
    rc, lines, text = _run("torch", ["plan", programs["json"], "--mesh",
                                     "dp=8"])
    assert rc == 0 and lines[-1]["plan"] == "OK"
    assert lines[-1]["candidate"] == docs["jax"]["candidate"]


def test_check_concurrency_passes_over_the_port():
    rc, lines, text = _run("torch", ["check", "--concurrency"])
    assert rc == 0 and lines[-1]["check"] == "PASS", text[-2000:]
    with pytest.raises(SystemExit) as e:
        with contextlib.redirect_stderr(io.StringIO()):
            _run("torch", ["check", "--concurrency", "x.json"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# stats / trace / doctor / profile
# ---------------------------------------------------------------------------
@pytest.fixture
def port_log(confs, tmp_path):
    """A JSONL log the port's command line wrote (observe on)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import export
    log = tmp_path / "run.jsonl"
    prev = {n: flags.get_flag(n) for n in ("observe", "metrics_log")}
    flags.set_flag("observe", True)
    flags.set_flag("metrics_log", str(log))
    try:
        rc, _, _ = _run("torch", _train_argv(confs, "mlp", "--num_passes",
                                              "2"))
        assert rc == 0
        obs.periodic_report(6)
    finally:
        for n, v in prev.items():
            flags.set_flag(n, v)
        export._reset_writer()
    assert log.stat().st_size > 0
    return str(log)


@pytest.mark.parametrize("sub,extra", [("stats", []), ("trace", []),
                                       ("trace", ["--limit", "2"]),
                                       ("doctor", [])])
def test_log_readers_agree_on_a_port_log(port_log, sub, extra):
    docs = {}
    for pkg in ("jax", "torch"):
        rc, lines, _ = _run(pkg, [sub, port_log, "--json", *extra])
        assert rc == 0 and len(lines) == 1
        docs[pkg] = lines[0]
    if sub == "doctor":
        # the hints name each package's own tools (the port's say "card"
        # and name opprof; the JAX ones name its TPU tunables)
        for doc in docs.values():
            for part in doc.values():
                if isinstance(part, dict) and "hints" in part:
                    assert part.pop("hints")
    assert docs["torch"] == docs["jax"]
    if sub == "stats":
        assert docs["torch"]["events"] > 0
    if sub == "trace":
        assert docs["torch"]["traces"] > 0


def test_stats_prom_and_human_forms(port_log):
    outs = {pkg: _run(pkg, ["stats", port_log, "--prom"])[2]
            for pkg in ("jax", "torch")}
    assert outs["torch"] == outs["jax"] and "paddle_tpu_" in outs["torch"]
    rc, lines, text = _run("torch", ["trace", port_log])
    assert rc == 0 and "critical path of the longest trace" in text
    rc, lines, text = _run("torch", ["stats", port_log])
    assert rc == 0 and lines[-1]["events"] > 0


def test_doctor_with_program_and_per_op(port_log, programs, tmp_path):
    cal = tmp_path / "cal.json"
    rc, lines, _ = _run("torch", ["doctor", port_log, "--program",
                                  programs["json"], "--per-op", "--batch",
                                  "8", "--device", "cpu", "--json",
                                  "--calibration-out", str(cal)])
    assert rc == 0 and len(lines) == 1
    per_op = lines[0]["per_op"]
    assert per_op["ops"] == len(per_op["rows"]) > 0
    assert json.loads(cal.read_text())["op_classes"]
    rc, jlines, _ = _run("jax", ["doctor", port_log, "--program",
                                 programs["json"], "--batch", "8",
                                 "--json"])
    assert set(jlines[0]) <= set(lines[0])
    with pytest.raises(SystemExit) as e:
        with contextlib.redirect_stderr(io.StringIO()):
            _run("torch", ["doctor", port_log, "--per-op"])
    assert e.value.code == 2


@pytest.mark.parametrize("name", ["mlp", "resnet"])
def test_profile_gives_the_same_op_rows(confs, name, tmp_path):
    rows = {}
    for pkg in ("jax", "torch"):
        cal = tmp_path / f"{pkg}-cal.json"
        rc, lines, _ = _run(pkg, ["profile", "--config", confs[name],
                                  "--batch", "4", "--reps", "1",
                                  "--json", "--calibration-out", str(cal)])
        assert rc == 0 and len(lines) == 1
        rep = lines[0]
        rows[pkg] = [(r["index"], r["op_type"], r["phase"])
                     for r in rep["rows"]]
        assert rep["ops"] == len(rep["rows"])
        assert json.loads(cal.read_text())["op_classes"]
    assert rows["torch"] == rows["jax"]


def test_profile_of_a_program_file_and_the_compiled_check(programs):
    rc, lines, text = _run("torch", ["profile", programs["model"],
                                     "--batch", "8", "--reps", "1",
                                     "--is-test"])
    assert rc == 0 and "per-op profile" in text
    assert lines[-1]["ops"] > 0
    # --compiled-check builds the step ahead in a throwaway executor; on
    # the CPU nothing is captured, so the memory view's executable facts
    # are None beside the measured view
    rc, lines, text = _run("torch", ["profile", programs["model"],
                                     "--batch", "8", "--reps", "1",
                                     "--is-test", "--compiled-check"])
    assert rc == 0 and "per-op profile" in text
    mem = lines[-1]["memory"]
    assert "executable" in mem and mem["executable"] is None
    assert mem["peak_bytes"] > 0


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------
def test_config_runner_without_a_card_raises(confs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (_train_argv(confs, "mlp"),
                 ["profile", "--config", confs["mlp"], "--batch", "4"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_config_runner_trains_on_the_card(confs, cuda_device, tmp_path):
    from paddle_tpu_torch.ops import conv1x1
    rc, lines, _ = _run("torch", _train_argv(
        confs, "resnet", "--num_passes", "2", "--save_dir", str(tmp_path)),
        device="cuda")
    assert rc == 0 and [r["pass"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in lines)
    assert (tmp_path / "pass-00001").is_dir()
    # the narrow ResNet's convs are under 128 channels: no K1 launch
    assert not conv1x1.mm.by_form


@pytest.mark.slow
def test_module_entry_runs_a_config_and_reads_its_log(confs, tmp_path):
    """@slow: two ``python -m paddle_tpu_torch`` subprocesses."""
    env = dict(os.environ, PYTHONPATH=REPO,
               PADDLE_TPU_TORCH_OBSERVE="1",
               PADDLE_TPU_TORCH_METRICS_LOG=str(tmp_path / "log.jsonl"))
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch",
                        "--config", confs["mlp"], "--job", "train",
                        "--device", "cpu", "--num_passes", "2",
                        "--steps_per_pass", "3"], capture_output=True,
                       text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert [json.loads(ln)["pass"] for ln in r.stdout.splitlines()] == [0, 1]
    env.pop("PADDLE_TPU_TORCH_METRICS_LOG")
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", "stats",
                        str(tmp_path / "log.jsonl"), "--json"],
                       capture_output=True, text=True, timeout=300,
                       env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.splitlines()[-1])["events"] > 0
