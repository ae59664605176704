"""DistributeTranspiler API-parity shim (counterpart of
``paddle_tpu/distributed/transpiler.py``; reference:
fluid/distribute_transpiler.py:51-200, which rewrites a local program
into trainer programs and per-pserver optimizer programs).

The port has nothing to transpile: the gradient exchange is a
collective over the mesh, and every rank runs the same program.  This
class keeps the reference's call surface so training scripts port
unchanged: ``transpile`` records the configuration,
``get_trainer_program`` returns the program itself (to run under
``parallel.DataParallel``), and ``get_pserver_program`` raises.
"""
from __future__ import annotations

from ..core.program import Program, default_main_program


class DistributeTranspiler:
    def __init__(self):
        self.trainer_id = 0
        self.trainers = 1
        self.program = None

    def transpile(self, trainer_id=0, program=None, pservers="", trainers=1,
                  split_method=None):
        self.trainer_id = trainer_id
        self.trainers = trainers
        self.program = program or default_main_program()
        return self

    def get_trainer_program(self) -> Program:
        return self.program

    def get_pserver_program(self, endpoint=None, *a, **kw):
        raise RuntimeError(
            "paddle_tpu_torch has no dense parameter server: the gradient "
            "exchange is a collective over the mesh of ranks. Run the "
            "trainer program under paddle_tpu_torch.parallel.DataParallel "
            "(the dp mesh axis); join the processes with "
            "paddle_tpu_torch.distributed.init_distributed().")

    get_startup_program = get_pserver_program
