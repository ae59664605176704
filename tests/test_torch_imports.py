"""The port stands alone: no module of paddle_tpu_torch, nor chip_smoke.py,
imports jax, jaxlib, the JAX package or its benchmark/ scripts (an AST scan,
no subprocess), and the executor never carries on quietly on the CPU when
asked for a card."""
import ast
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu", "benchmark"}


def _port_sources():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_top_names(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 20
    bad = [f"{os.path.relpath(p, ROOT)}:{line}: {name}"
           for p in sources for line, name in _imported_top_names(p)
           if name in FORBIDDEN]
    assert not bad, "port modules import the JAX side:\n" + "\n".join(bad)


def test_scan_covers_the_training_modules():
    """The scan walks the whole package: the training slice's modules are
    in it, and importing them pulls in no JAX module either."""
    import sys
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("backward.py", "optimizer.py", "regularizer.py", "clip.py",
                "ops/optimizer_ops.py", "layers/tensor.py",
                "layers/control_flow.py", "layers/ops.py"):
        assert os.path.join("paddle_tpu_torch", rel) in scanned, rel
    for mod in ("backward", "optimizer", "regularizer", "clip"):
        assert getattr(ptt, mod).__name__ == f"paddle_tpu_torch.{mod}"
    port_mods = [m for m in sys.modules if m.startswith("paddle_tpu_torch")]
    assert "paddle_tpu_torch.ops.optimizer_ops" in port_mods


def test_scan_covers_the_attention_modules():
    """The attention slice's modules are scanned too, and importing them
    builds nothing: the kernel library is loaded only at first launch."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("ops/flash_attention.py", "ops/cuda_build.py",
                "ops/loss_ops.py", "nets.py"):
        assert os.path.join("paddle_tpu_torch", rel) in scanned, rel
    from paddle_tpu_torch.ops import cuda_build, flash_attention
    assert flash_attention.SOURCE not in cuda_build._libs
    assert ptt.nets.scaled_dot_product_attention is not None


def test_scan_covers_the_bandwidth_probe():
    """The probe's modules are scanned, and importing the probe afresh
    builds nothing and imports no triton: the Triton kernels are defined
    and the CUDA library loaded only at first launch."""
    import importlib.util
    import sys
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("benchmark/__init__.py", "benchmark/bandwidth.py"):
        assert os.path.join("paddle_tpu_torch", rel) in scanned, rel
    from paddle_tpu_torch.benchmark import bandwidth
    from paddle_tpu_torch.ops import cuda_build
    path = os.path.join(ROOT, "paddle_tpu_torch", "benchmark", "bandwidth.py")
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu_torch.benchmark._fresh_bandwidth", path)
    fresh = importlib.util.module_from_spec(spec)
    before = set(sys.modules)
    spec.loader.exec_module(fresh)
    assert not [m for m in set(sys.modules) - before
                if m.split(".")[0] == "triton"]
    assert fresh._triton is None and fresh.triton is None
    assert fresh.SOURCE == bandwidth.SOURCE
    assert bandwidth.SOURCE not in cuda_build._libs


def test_scan_covers_the_seq2seq_modules():
    """The seq2seq slice's modules are scanned, registered and exported:
    the recurrence and sequence ops, the embedding, copy_len, the model
    and the feeder."""
    from paddle_tpu_torch.core.registry import get_op_impl
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("ops/sequence_ops.py", "ops/control_flow_ops.py",
                "ops/embedding_ops.py", "ops/crf_ops.py",
                "models/seq2seq.py", "data_feeder.py"):
        assert os.path.join("paddle_tpu_torch", rel) in scanned, rel
    for op in ("rnn", "rnn_memory_helper", "gru", "gru_unit",
               "sequence_pool", "lookup_table", "copy_len", "adam",
               "reshape", "squeeze", "unsqueeze", "tanh", "sigmoid",
               "fill_constant_batch_size_like"):
        assert get_op_impl(op).__module__.startswith("paddle_tpu_torch.")
    assert ptt.layers.StaticRNN and ptt.optimizer.Adam and ptt.DataFeeder
    assert ptt.models.seq2seq_attention.__module__ == \
        "paddle_tpu_torch.models.seq2seq"


def test_scan_sees_through_aliases(tmp_path):
    """The scanner itself: every import form of a forbidden name is
    caught, and the port's own name is not."""
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom paddle_tpu.core import x\n"
                   "import paddle_tpu_torch\nfrom . import jax\n"
                   "def f():\n    import jaxlib\n")
    names = [n for _, n in _imported_top_names(str(src))]
    assert [n for n in names if n in FORBIDDEN] == \
        ["jax", "paddle_tpu", "jaxlib"]


def test_executor_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        ptt.Executor()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        ptt.CUDAPlace(0).device()
    assert ptt.Executor(ptt.CPUPlace()).device == torch.device("cpu")


def test_scope_numpy_widens_bf16_and_weights_load_bf16():
    import ml_dtypes
    scope = ptt.Scope()
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    ptt.load_numpy_state(scope, {"w": arr,
                                 "h": arr.astype(ml_dtypes.bfloat16)}, "cpu")
    assert scope.get("w").dtype == torch.float32
    assert scope.get("h").dtype == torch.bfloat16
    out = scope.numpy("h")
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, arr)
    arr[0, 0] = 99.0                    # the scope holds its own copy
    assert scope.numpy("w")[0, 0] == 0.0


def _top_level_imports(path):
    """(lineno, module) of the imports in a module's own body (not inside
    a function), relative ones resolved against the package."""
    rel = os.path.relpath(path, ROOT)
    pkg = os.path.dirname(rel).replace(os.sep, ".")
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            base = pkg.split(".")
            if node.level:
                base = base[:len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module
                                       else []))
            else:
                mod = node.module or ""
            yield node.lineno, mod
            for a in node.names:
                yield node.lineno, f"{mod}.{a.name}"


def test_scan_covers_the_elastic_service():
    """The elastic slice's modules are scanned; chip_smoke.py's
    ``--elastic-child`` mode runs the port's worker; and only the elastic
    module itself imports the master or the elastic service at its top
    level, so importing the package (or ``distributed``) loads neither
    (the subprocess check of it is in tests/test_torch_elastic_chaos.py,
    ``@slow``)."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("distributed/master.py", "distributed/elastic.py",
                "distributed/__init__.py", "reader/creator.py",
                "trainer_config_helpers/__init__.py",
                "benchmark/elastic.py", "benchmark/checkpoint.py"):
        assert os.path.join("paddle_tpu_torch", rel) in scanned, rel
    lazy = ("paddle_tpu_torch.distributed.master",
            "paddle_tpu_torch.distributed.elastic")
    bad = []
    for p in _port_sources():
        rel = os.path.relpath(p, ROOT)
        if rel in ("chip_smoke.py",
                   os.path.join("paddle_tpu_torch", "distributed",
                                "elastic.py")):
            continue
        for line, mod in _top_level_imports(p):
            if mod.startswith(lazy):
                bad.append(f"{rel}:{line}: {mod}")
    assert not bad, "\n".join(bad)
    import paddle_tpu_torch.distributed as d
    assert d.Master.__module__ == "paddle_tpu_torch.distributed.master"
    assert set(d.__all__) >= {"Master", "Task", "TaskQueueClient"}
    # chip_smoke.py's worker mode: an argument of its parser, and a
    # function that imports the port's elastic_main
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "--elastic-child" in ast.dump(fns["main"])
    child = ast.dump(fns["elastic_child"])
    assert "paddle_tpu_torch.distributed.elastic" in child
    assert "elastic_main" in child


def test_scan_covers_the_fleet_modules():
    """The fleet slice's modules are scanned; chip_smoke.py's
    ``--fleet-child`` mode runs the port's serve_main; and no module of
    the port imports the HTTP front, the fleet, the serve command line
    or the collector at its top level, so importing the package (or
    ``paddle_tpu_torch.serving``) loads none of them (the subprocess check
    is in tests/test_torch_fleet_chaos.py, ``@slow``)."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("serving/cli.py", "serving/http.py", "serving/fleet.py",
                "observability/collector.py", "benchmark/fleet.py",
                "__main__.py"):
        assert os.path.join("paddle_tpu_torch", rel) in scanned, rel
    lazy = ("paddle_tpu_torch.serving.http", "paddle_tpu_torch.serving.fleet",
            "paddle_tpu_torch.serving.cli",
            "paddle_tpu_torch.observability.collector")
    bad = []
    for p in _port_sources():
        rel = os.path.relpath(p, ROOT)
        for line, mod in _top_level_imports(p):
            if mod.startswith(lazy):
                bad.append(f"{rel}:{line}: {mod}")
    assert not bad, "\n".join(bad)
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "--fleet-child" in ast.dump(fns["main"])
    child = ast.dump(fns["fleet_child"])
    assert "paddle_tpu_torch.serving.cli" in child and "serve_main" in child


# the entry points that may import the autotuner at their top level
_TUNING_ENTRY_POINTS = {os.path.join("paddle_tpu_torch", "benchmark", f)
                        for f in ("autotune.py", "conv_kernel.py",
                                  "longctx.py")}


def test_only_tuning_and_its_drivers_import_tuning_at_top_level():
    """Declaring a tunable (``core.registry.register_tunable``) costs
    nothing: outside ``tuning/`` itself and the three drivers that are
    entry points, every module reaches ``paddle_tpu_torch.tuning`` inside
    the function that opts in, so importing the package never loads
    it."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("tuning/__init__.py", "tuning/tunables.py",
                "tuning/search.py", "tuning/store.py", "tuning/targets.py",
                "tuning/cli.py") + tuple(
                    os.path.relpath(p, "paddle_tpu_torch")
                    for p in _TUNING_ENTRY_POINTS):
        assert os.path.join("paddle_tpu_torch", rel) in scanned, rel
    bad = []
    for p in _port_sources():
        rel = os.path.relpath(p, ROOT)
        if rel.startswith(os.path.join("paddle_tpu_torch", "tuning") +
                          os.sep) or rel in _TUNING_ENTRY_POINTS:
            continue
        for line, mod in _top_level_imports(p):
            if mod.startswith("paddle_tpu_torch.tuning"):
                bad.append(f"{rel}:{line}: {mod}")
    assert not bad, "\n".join(bad)
    # the replay helper names the package only inside its function
    with open(os.path.join(ROOT, "paddle_tpu_torch", "core",
                           "registry.py")) as fh:
        assert "from ..tuning.store import tuned" in fh.read()


def _literal_calls(call_name):
    """(first string-literal argument, file:line) of every call of
    ``call_name`` in the port."""
    out = []
    for p in _port_sources():
        with open(p) as fh:
            tree = ast.parse(fh.read(), filename=p)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name == call_name and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(
                        node.args[0].value, str):
                out.append((node.args[0].value,
                            f"{os.path.relpath(p, ROOT)}:{node.lineno}"))
    return out


def test_register_tunable_names_are_unique_literals():
    """Every ``register_tunable`` in the port names its knob with a
    string literal, once (a second registration would raise at import,
    or never load where its module is imported lazily), and the live
    registry holds exactly the scanned names."""
    import collections

    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.tuning import targets
    calls = _literal_calls("register_tunable")
    sites = collections.defaultdict(list)
    for name, where in calls:
        sites[name].append(where)
    dupes = {n: s for n, s in sites.items() if len(s) > 1}
    assert not dupes, dupes
    assert len(calls) == 12, calls
    for n in targets.target_names():
        targets.ensure_registered(n)
    assert set(registry.registered_tunables()) == set(sites)


@pytest.mark.slow
def test_import_paddle_tpu_torch_loads_no_tuning():
    """In a fresh interpreter: importing the package, building an
    executor and resolving an untuned knob load nothing of ``tuning``."""
    import subprocess
    import sys
    code = ("import sys, paddle_tpu_torch as p\n"
            "d = {'steps_per_dispatch': 4, 'prefetch_depth': 2}\n"
            "e = p.Executor(p.CPUPlace())\n"
            "assert e._tuned('executor/run_pipelined', d) is d\n"
            "import paddle_tpu_torch.serving.server, "
            "paddle_tpu_torch.sparse.session\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('paddle_tpu_torch.tuning')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.strip() == "[]"


def test_scan_covers_the_command_line():
    """The command line's modules are scanned, and no module of the port
    imports ``cli`` or ``__main__`` at its top level (``__main__``
    reaches ``cli`` inside its ``main``), so importing the package loads
    no command line; ``cli.py`` itself imports each subcommand's module
    inside the function that runs it."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("cli.py", "__main__.py"):
        assert os.path.join("paddle_tpu_torch", rel) in scanned, rel
    bad = []
    for p in _port_sources():
        rel = os.path.relpath(p, ROOT)
        for line, mod in _top_level_imports(p):
            if mod.split(".")[:2] in (["paddle_tpu_torch", "cli"],
                                      ["paddle_tpu_torch", "__main__"]):
                bad.append(f"{rel}:{line}: {mod}")
    assert not bad, "\n".join(bad)
    cli = os.path.join(ROOT, "paddle_tpu_torch", "cli.py")
    top = {mod for _, mod in _top_level_imports(cli)}
    assert top <= {"__future__", "__future__.annotations", "argparse",
                   "json", "os", "sys", "time", "typing", "typing.Dict",
                   "typing.Optional", "numpy"}, top
