"""Reader composition toolkit (counterpart of ``paddle_tpu/reader``;
reference: python/paddle/v2/reader/).

A *reader* is a zero-arg callable returning an iterable of samples.
``decorator`` holds batch, shuffle, buffered, cache, chain, compose,
firstn, map_readers and xmap_readers; ``pipeline`` the bounded
multi-worker engine (``prefetch``, ``interleave``) that ``buffered`` and
``Executor.run_pipelined`` run on; ``creator`` the np_array, text_file
and recordio sources.

Not ported yet: ``native_buffered`` (the ``native/`` binding),
``creator.cloud_reader`` (the distributed master), and the pipeline's
autotuned defaults.
"""
from . import creator
from . import decorator
from . import pipeline
from .decorator import (batch, buffered, cache, chain, compose, firstn,
                        map_readers, shuffle, xmap_readers)
from .pipeline import interleave, prefetch

__all__ = ["batch", "buffered", "cache", "chain", "compose", "firstn",
           "interleave", "map_readers", "prefetch", "shuffle",
           "xmap_readers", "creator", "decorator", "pipeline"]
