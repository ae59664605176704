"""``python -m paddle_tpu_torch <subcommand>`` (counterpart of
``paddle_tpu/cli.py``'s entry).  The port has six subcommands:

* ``pserver --shard k/N [--host H] [--port P] [--dir D] [--backup H:P]``:
  one sparse parameter-server shard (``sparse/pserver.py``), host only.
* ``elastic --config F --data GLOB --root DIR [--workers K]
  [--device cuda|cpu] ...``: an elastic training job
  (``distributed/elastic.py``); the coordinator stays on the host and
  starts its workers with ``elastic --worker ...`` on ``--device``.
* ``serve --model [NAME=]DIR [--device cuda|cpu] [--http PORT] ...``:
  the serving runtime over exported artifacts, speaking newline JSON on
  stdio or HTTP (``serving/cli.py``); SIGTERM drains and exits 0.
* ``fleet --model [NAME=]DIR --replicas N [--http PORT] [--device
  cuda|cpu] [--autoscale] ...``: N ``serve`` replica processes behind the
  queue-depth router and the HTTP front (``serving/fleet.py``); the
  router stays on the host.
* ``fleet-stats SOURCE... [--master H:P] [--json|--prom]``: merge the
  metrics snapshots of JSONL logs, pserver endpoints and a master into
  one labeled fleet view (``observability/collector.py``), host only.
* ``tune <tunable> | --list [--algo grid|halving] [--budget N] [--smoke]
  [--cache-dir DIR] [--no-save] [--out FILE] ...``: the persistent
  autotuner (``tuning/cli.py``); device tunables search on the card.

Every other subcommand of the JAX command line (running a v1 config,
``check``, ``plan``, ``stats``, ``trace``, ``doctor``, ``profile``, ...)
is refused with the ROADMAP item that brings it.
"""
from __future__ import annotations

import sys

_NOT_PORTED = "ROADMAP.md Queue A item 9e (the command line)"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # every subcommand is a lazy import: importing the package never
    # loads a socket stack, the elastic service, the serving fleet or
    # the autotuner
    if argv and argv[0] == "pserver":
        from .sparse.pserver import pserver_main
        return pserver_main(argv[1:])
    if argv and argv[0] == "elastic":
        from .distributed.elastic import elastic_main
        return elastic_main(argv[1:])
    if argv and argv[0] == "serve":
        from .serving.cli import serve_main
        return serve_main(argv[1:])
    if argv and argv[0] == "fleet":
        from .serving.fleet import fleet_main
        return fleet_main(argv[1:])
    if argv and argv[0] == "fleet-stats":
        from .observability.collector import fleet_stats_main
        return fleet_stats_main(argv[1:])
    if argv and argv[0] == "tune":
        from .tuning.cli import tune_main
        return tune_main(argv[1:])
    what = argv[0] if argv else "(none)"
    print(f"paddle_tpu_torch: subcommand {what!r} is not ported yet "
          f"({_NOT_PORTED}); the port's command line has 'pserver', "
          f"'elastic', 'serve', 'fleet', 'fleet-stats' and 'tune'",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
