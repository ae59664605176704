"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``):
``np_array``, ``text_file``, ``recordio`` (the pickle part files of
``dataset.common.split``) and ``cloud_reader``, which reads the part
files as tasks of the fault-tolerant master
(``distributed.master.MasterClient``): fetch a task's chunks, read
each, report it finished or failed."""
from __future__ import annotations

import glob
import pickle
from typing import List, Sequence, Union

__all__ = ["np_array", "text_file", "recordio", "cloud_reader"]


def np_array(x):
    """Yield the rows of an ndarray."""
    import numpy as np

    def reader():
        arr = np.asarray(x)
        for row in arr:
            yield row

    return reader


def text_file(path):
    """Yield the lines of a text file without their newline."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def _read_part(path):
    # a split part file is ONE pickled list of samples
    with open(path, "rb") as f:
        yield from pickle.load(f)


def _expand_paths(paths: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        hit = sorted(glob.glob(p))
        if hit:
            files.extend(hit)
        elif glob.has_magic(p):
            # a pattern that matches nothing is a setup error
            raise FileNotFoundError(f"no files match pattern {p!r}")
        else:
            files.append(p)      # a literal path: open() reports it
    return files


def recordio(paths: Union[str, Sequence[str]], buf_size: int = 100):
    """Yield records from chunked part files.  ``paths``: a glob pattern
    or a list of patterns or files; ``buf_size``: records read ahead by
    ``decorator.buffered``'s worker (0: none)."""
    files = _expand_paths(paths)

    def reader():
        for path in files:
            yield from _read_part(path)

    if buf_size and buf_size > 0:
        from .decorator import buffered
        return buffered(reader, buf_size)
    return reader


def cloud_reader(paths: Union[str, Sequence[str]], master_address: str,
                 timeout_s: float = 30.0):
    """Fault-tolerant distributed reading: every record of every chunk is
    consumed once across all trainers sharing the master.  A trainer
    pulls a task (one part file), streams its records and reports it
    finished; a crash mid-task requeues the chunk for a survivor
    (``distributed/master.py``).

    The first trainer primes the queue with the atomic
    ``set_dataset_if_empty`` RPC; concurrent joiners no-op.  A generator
    closed early (``GeneratorExit``: ``firstn``, a broken batch loop)
    returns its task without burning the chunk's failure budget; only
    real exceptions count as failures."""
    from ..distributed.master import MasterClient

    files = _expand_paths(paths)

    def reader():
        from ..distributed.master import task_loop_reader

        client = MasterClient(master_address, timeout_s=timeout_s)
        try:
            if files:
                client.set_dataset_if_empty(files)
            yield from task_loop_reader(client, _read_part)()
        finally:
            client.close()

    return reader
