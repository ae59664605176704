"""Op implementations; importing this package registers all of them."""
from . import activation_ops, math_ops, nn_ops, tensor_ops  # noqa: F401
from . import loss_ops, metric_ops, optimizer_ops  # noqa: F401
from . import control_flow_ops, crf_ops, embedding_ops  # noqa: F401
from . import sequence_ops, generation_ops  # noqa: F401
from . import detection_ops, io_ops, moe_ops  # noqa: F401
from . import conv1x1, flash_attention  # noqa: F401
