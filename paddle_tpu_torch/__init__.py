"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Program IR, layers, executor semantics and serving runtime as
the JAX package (``paddle_tpu``, the reference), on PyTorch with an
explicit device: ``Executor()`` runs on ``CUDAPlace(0)``, and CPU runs are
asked for with ``CPUPlace()``.  The JAX package's Pallas kernels become
hand-written CUDA kernels (``csrc/``), each beside its plain PyTorch
version.

Ported so far: the ResNet inference serving path (program IR, scope,
initializers, the layers and ops ResNet uses, the executor with bf16
inference AMP, ``serving.Model``/``serving.Server``), ResNet training
(``append_backward``, SGD and Momentum, regularizers, gradient clips,
batch-statistics batch norm, cross entropy, the executor's backward
under AMP and ``run_steps``), long-context attention training
(``layers.flash_attention``, ``nets.scaled_dot_product_attention``,
``matmul``, ``dropout``, ``square_error_cost``), seq2seq+attention
training (``models.seq2seq_attention``: sub-blocks and ``@LEN``
lengths in the executor, ``layers.StaticRNN``, the GRU and sequence
ops, ``embedding``, Adam, ``DataFeeder``), the HBM stream-bandwidth
probe (``benchmark/bandwidth.py``, with its Triton copy and axpy and its
bulk-copy DMA copy), each step dispatched as a captured CUDA graph
(``Executor(use_jit=True)``, ``core/compile_cache.py``), the input
pipeline (``reader``, ``trainer.SGD``, ``Executor.run_pipelined``,
``models.wide_deep``, ``benchmark/input_pipeline.py``), the deploy path
of ``benchmark/inference.py`` (``io``, ``export_compiled_model`` /
``load_compiled_model`` over ``torch.export``,
``serving.Model.from_artifact``, beam-search decoding with
``models.seq2seq_infer``), the observability layer (``observability``:
metrics, the JSONL log, spans, the NaN bisect, the per-op profiler, the
doctor's measured budgets; ``profiler``; ``testing.lockwatch``), the
dense op families (activation, nn, loss, metric, with ``top_k``,
``one_hot``, ``argmax``, ``transpose`` and the ``reduce_*`` ops), the
tensor and math op families (every op of the JAX package's
``tensor_ops.py`` and ``math_ops.py``), their layers, ``evaluator`` and
``metrics``, and two kernels of the
framework: the 1x1-convolution matrix product with its gradients and
epilogues (``ops/conv1x1.py``) and flash attention, forward and backward
(``ops/flash_attention.py``).
"""

from . import core
from .core import (
    CPUPlace, CUDAPlace, Executor, Program, Scope, default_main_program,
    default_startup_program, global_scope, program_guard, stack_feeds,
    pad_batch, unique_name,
)
from . import ops  # noqa: F401  (registers every op implementation)
from . import flags, initializer, layer_helper, layers, models, nets
from . import optimizer, regularizer, clip, backward, data_feeder
from . import lr_decay, framework
from . import reader, trainer
from . import io
from .io import (save_params, load_params, save_persistables,  # noqa: F401
                 load_persistables, save_inference_model,
                 load_inference_model)
from . import export_model
from .export_model import export_compiled_model, load_compiled_model
from .backward import append_backward
from .data_feeder import DataFeeder
from .param_attr import ParamAttr
from .weights import load_numpy_state
from . import faults
from . import observability, profiler
from . import evaluator
from . import metrics

# the JAX package's version, folded into the fingerprints of the port's
# persistent records (core/compile_cache.environment_key)
__version__ = "0.2.0"

__all__ = [
    "core", "CPUPlace", "CUDAPlace", "Executor", "Program", "Scope",
    "default_main_program", "default_startup_program", "global_scope",
    "program_guard", "stack_feeds", "pad_batch", "unique_name", "ops",
    "flags", "initializer", "layer_helper", "layers", "models", "nets",
    "optimizer",
    "regularizer", "clip", "backward", "data_feeder", "DataFeeder",
    "append_backward", "ParamAttr",
    "load_numpy_state", "faults", "reader", "trainer", "io",
    "save_params", "load_params", "save_persistables", "load_persistables",
    "save_inference_model", "load_inference_model", "export_model",
    "export_compiled_model", "load_compiled_model", "lr_decay",
    "framework", "observability", "profiler", "evaluator", "metrics",
]
