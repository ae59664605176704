"""``python -m paddle_tpu_torch <subcommand>`` (counterpart of
``paddle_tpu/cli.py``'s entry).  The port has two subcommands:

* ``pserver --shard k/N [--host H] [--port P] [--dir D] [--backup H:P]``:
  one sparse parameter-server shard (``sparse/pserver.py``), host only.
* ``elastic --config F --data GLOB --root DIR [--workers K]
  [--device cuda|cpu] ...``: an elastic training job
  (``distributed/elastic.py``); the coordinator stays on the host and
  starts its workers with ``elastic --worker ...`` on ``--device``.

Every other subcommand of the JAX command line (running a v1 config,
``check``, ``plan``, ``stats``, ``serve``, ``fleet``, ...) is refused
with the ROADMAP item that brings it.
"""
from __future__ import annotations

import sys

_NOT_PORTED = "ROADMAP.md Queue A item 9e (the command line)"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "pserver":
        from .sparse.pserver import pserver_main
        return pserver_main(argv[1:])
    if argv and argv[0] == "elastic":
        # lazy: importing the package never loads the elastic service
        from .distributed.elastic import elastic_main
        return elastic_main(argv[1:])
    what = argv[0] if argv else "(none)"
    print(f"paddle_tpu_torch: subcommand {what!r} is not ported yet "
          f"({_NOT_PORTED}); the port's command line has only "
          f"'pserver --shard k/N' and 'elastic'", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
