"""The port's reader package against the JAX package's: the decorators
give the same items from the same sources, and the pipeline engine keeps
its lifecycle contract (order with one worker, every shard covered,
exceptions re-raised in the consumer, an abandoned reader's workers
joined).  Mirrors tests/test_input_pipeline.py's engine tests."""
import random
import threading

import numpy as np
import pytest

import paddle_tpu.reader as jr
import paddle_tpu_torch.reader as tr
from paddle_tpu_torch.reader.pipeline import THREAD_NAME_PREFIX


def _range_reader(n):
    return lambda: iter(range(n))


def _pairs(n):
    return lambda: iter([(i, float(i) / 2) for i in range(n)])


@pytest.mark.parametrize("case", [
    "batch", "batch_keep_last", "map_readers", "buffered", "chain",
    "compose", "firstn", "cache", "np_array"])
def test_decorators_match_jax(case):
    def make(pkg):
        r = {
            "batch": lambda: pkg.batch(_range_reader(23), 5),
            "batch_keep_last": lambda: pkg.batch(_range_reader(23), 5,
                                                 drop_last=False),
            "map_readers": lambda: pkg.map_readers(
                lambda a, b: a * 10 + b, _range_reader(9),
                _range_reader(12)),
            "buffered": lambda: pkg.buffered(_range_reader(50), 3),
            "chain": lambda: pkg.chain(_range_reader(4), _pairs(3),
                                       _range_reader(2)),
            "compose": lambda: pkg.compose(_range_reader(6), _pairs(6)),
            "firstn": lambda: pkg.firstn(_range_reader(100), 7),
            "cache": lambda: pkg.cache(_range_reader(8)),
            "np_array": lambda: pkg.creator.np_array(
                np.arange(12).reshape(4, 3)),
        }[case]()
        return [list(r()), list(r())]        # each reader is re-callable

    got, want = make(tr), make(jr)
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a, dtype=object),
                                          np.asarray(b, dtype=object))


def test_compose_rejects_misaligned_readers():
    with pytest.raises(ValueError, match="aligned"):
        list(tr.compose(_range_reader(3), _range_reader(4))())


@pytest.mark.parametrize("buf_size", [1, 4, 7, 100])
def test_shuffle_matches_jax_under_one_seed(buf_size):
    outs = []
    for pkg in (tr, jr):
        random.seed(1234)
        outs.append(list(pkg.shuffle(_range_reader(40), buf_size)()))
    assert outs[0] == outs[1]
    assert sorted(outs[0]) == list(range(40))


def test_text_file_and_recordio_match_jax(tmp_path):
    import pickle
    txt = tmp_path / "lines.txt"
    txt.write_text("a b\nc\n\nd e f\n")
    for i in range(3):
        with open(tmp_path / f"part-{i:05d}.pickle", "wb") as f:
            pickle.dump([(i, j) for j in range(4)], f)
    pattern = str(tmp_path / "part-*.pickle")
    assert list(tr.creator.text_file(str(txt))()) == \
        list(jr.creator.text_file(str(txt))())
    for buf in (0, 2):
        assert list(tr.creator.recordio(pattern, buf_size=buf)()) == \
            list(jr.creator.recordio(pattern, buf_size=buf)())
    with pytest.raises(FileNotFoundError):
        tr.creator.recordio(str(tmp_path / "none-*.pickle"))


def test_xmap_readers_maps_every_item():
    out = list(tr.xmap_readers(lambda x: x * 2, _range_reader(60), 3, 8)())
    assert sorted(out) == [2 * i for i in range(60)]


def test_prefetch_single_worker_preserves_order():
    assert list(tr.prefetch(_range_reader(200), buffer_size=4)()) == \
        list(range(200))


def test_prefetch_multi_worker_yields_every_item():
    out = list(tr.prefetch(_range_reader(500), buffer_size=8,
                           num_workers=4)())
    assert sorted(out) == list(range(500))


def test_prefetch_mapper_runs_on_pipeline_workers():
    seen = set()

    def mapper(x):
        seen.add(threading.current_thread().name)
        return x * 3

    out = list(tr.prefetch(_range_reader(300), buffer_size=8, num_workers=3,
                           mapper=mapper)())
    assert sorted(out) == [3 * i for i in range(300)]
    assert seen and all(n.startswith(THREAD_NAME_PREFIX) for n in seen)


@pytest.mark.parametrize("workers", [1, 2])
def test_prefetch_propagates_reader_exception(workers):
    def bad():
        yield from range(5)
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(tr.prefetch(lambda: bad(), buffer_size=2,
                         num_workers=workers)())


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_NAME_PREFIX) and t.is_alive()]


@pytest.mark.parametrize("make", [
    lambda: tr.prefetch(_range_reader(10 ** 9), buffer_size=4,
                        num_workers=3),
    lambda: tr.interleave([_range_reader(10 ** 9)] * 3, buffer_size=4),
    lambda: tr.buffered(_range_reader(10 ** 9), 2)])
def test_abandoned_reader_joins_its_workers(make):
    g = make()()
    assert next(g) is not None
    assert _pipeline_threads()
    g.close()               # the engine's finally stops and joins them
    assert not _pipeline_threads()


def test_prefetch_rejects_bad_worker_count():
    with pytest.raises(ValueError):
        tr.prefetch(_range_reader(3), num_workers=0)


@pytest.mark.parametrize("workers", [None, 2, 1])
def test_interleave_covers_every_shard(workers):
    shards = [lambda i=i: iter(range(i * 100, i * 100 + 10))
              for i in range(5)]
    expect = sorted(x for i in range(5) for x in range(i * 100, i * 100 + 10))
    assert sorted(tr.interleave(shards, buffer_size=8,
                                num_workers=workers)()) == expect


def test_interleave_one_worker_cycles_its_shards_as_jax_does():
    shards = [lambda i=i: iter([(i, j) for j in range(3)]) for i in range(3)]
    got = list(tr.interleave(shards, buffer_size=16, num_workers=1)())
    assert got == list(jr.interleave(shards, buffer_size=16,
                                     num_workers=1)())
    assert [s for s, _ in got[:3]] == [0, 1, 2]


def test_interleave_propagates_shard_exception():
    def bad():
        yield 1
        raise ValueError("shard 1 corrupt")

    with pytest.raises(ValueError, match="shard 1 corrupt"):
        list(tr.interleave([_range_reader(50), lambda: bad()],
                           buffer_size=4)())


def test_buffered_reraises_and_preserves_order():
    assert list(tr.buffered(_range_reader(100), 4)()) == list(range(100))

    def bad():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(tr.buffered(lambda: bad(), 4)())
