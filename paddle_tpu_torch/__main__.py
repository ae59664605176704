"""``python -m paddle_tpu_torch`` (counterpart of ``paddle_tpu/__main__.py``):
the command line of ``cli.py``.

* ``--config conf.py --job train|test|time|checkgrad [--device
  cuda|cpu] ...``: run a v1 config (the ``paddle train`` analog).
* ``check``, ``plan``, ``stats``, ``trace``, ``doctor``, ``profile``: the
  static verifier and planner, and the observability log readers and
  per-op profiler.
* ``pserver``, ``elastic``, ``serve``, ``fleet``, ``fleet-stats``,
  ``tune``: a sparse shard, the elastic service, the serving runtime and
  fleet, the fleet collector, the autotuner.

Anything else goes to the config runner's parser, whose required
``--config`` makes an unknown subcommand a usage error (exit 2).
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    # cli.py imports each subcommand's module only when it is named:
    # importing the package never loads the command line, and the
    # command line loads no socket stack, serving fleet, elastic service
    # or autotuner it does not run
    from .cli import main as cli_main
    return cli_main(argv)


if __name__ == "__main__":
    sys.exit(main())
