"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``):
``np_array``, ``text_file`` and ``recordio`` (the pickle part files of
``dataset.common.split``).  ``cloud_reader`` needs the distributed
master and is not ported yet."""
from __future__ import annotations

import glob
import pickle
from typing import List, Sequence, Union

__all__ = ["np_array", "text_file", "recordio"]


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
