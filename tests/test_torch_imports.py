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
