"""The port's HBM stream-bandwidth probe (paddle_tpu_torch/benchmark/
bandwidth.py) against the JAX probe's kernels (benchmark/bandwidth.py, K5),
run on the CPU: the Pallas grid copy, grid axpy and DMA copy in TPU
interpret mode, the jnp k-step forms plainly, on the same numpy inputs
(2 chunks, 2048 x 512 f32, from a seed).  Copies must be bit-equal.  An
axpy may round A*x before the add or contract A*x + y into one FMA, so
it is held to one fp32 ulp of |A*x| + |y| per pass.  The kernels
themselves are held against the plain versions by the ``cuda``-marked
tests, which skip without a card.  JAX is imported only through the
``jbw`` fixture, so on a machine with a card and no JAX those run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_bandwidth.py``."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.benchmark import bandwidth as bw
from paddle_tpu_torch.ops import cuda_build

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
A32 = np.float32(1.0000001)


@pytest.fixture(scope="module")
def jbw():
    """benchmark/bandwidth.py, loaded by path (it is not a package); its
    ``jnp`` and ``pltpu`` are the JAX modules the tests use."""
    spec = importlib.util.spec_from_file_location(
        "jax_bandwidth_probe", os.path.join(ROOT, "benchmark", "bandwidth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def xy():
    rng = np.random.RandomState(0)
    shape = (2 * bw.CHUNK_ROWS, bw.LANES)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ulp(a):
    """One fp32 ulp of each |a| (a float32 array)."""
    a = np.abs(a).astype(np.float32)
    return np.nextafter(a, np.float32(np.inf)) - a


def _assert_bit_equal(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _assert_axpy_close(got, want, x, y, passes=1):
    """|got - want| <= passes ulps of (passes |A x| + |y|): each pass may
    round once apart, and the carry grows by |A x| a pass."""
    scale = passes * np.abs(A32 * x) + np.abs(y)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= passes * _ulp(scale)).all(), err.max()


def test_constants_are_the_jax_probes(jbw):
    assert np.float32(bw.A) == A32 and float(A32) == bw.A
    assert (bw.LANES, bw.CHUNK_ROWS) == (jbw.LANES, jbw.CHUNK_ROWS)
    assert bw.SIZES_MB == (128, 512, 1024, 2048)


# ---------------------------------------------------------------------------
# the plain versions (the wrappers on CPU tensors) against K5 itself
# ---------------------------------------------------------------------------
def test_grid_copy_matches_pallas_interpret(jbw, xy):
    x, _ = xy
    with jbw.pltpu.force_tpu_interpret_mode():
        want = jbw._grid_copy(jbw.jnp.asarray(x))
    _assert_bit_equal(bw.grid_copy(_t(x)).numpy(), want)


def test_grid_axpy_matches_pallas_interpret(jbw, xy):
    x, y = xy
    with jbw.pltpu.force_tpu_interpret_mode():
        want = jbw._grid_axpy(jbw.jnp.asarray(x), jbw.jnp.asarray(y))
    _assert_axpy_close(bw.grid_axpy(_t(x), _t(y)).numpy(), want, x, y)


@pytest.mark.parametrize("k", [1, 2])
def test_dma_copy_matches_pallas_interpret(jbw, xy, k):
    x, _ = xy
    with jbw.pltpu.force_tpu_interpret_mode():
        want = jbw._dma_copy(jbw.jnp.asarray(x)) if k == 1 else \
            jbw._dma_copy_k(jbw.jnp.asarray(x), k=k)
    got = bw.dma_copy(_t(x)) if k == 1 else bw.copy_k(bw.dma_copy, _t(x), k)
    _assert_bit_equal(got.numpy(), want)


@pytest.mark.parametrize("form", ["jnp", "pallas_dma"])
def test_copy_k_matches_jax(jbw, xy, form):
    """Three passes, each reading the last one's output: the torch copy
    against the jnp scan, the DMA copy against the Pallas DMA scan."""
    x, _ = xy
    if form == "jnp":
        want = jbw._jnp_copy_k(jbw.jnp.asarray(x), k=3)
        got = bw.copy_k(bw.grid_copy, _t(x), 3)
    else:
        with jbw.pltpu.force_tpu_interpret_mode():
            want = jbw._dma_copy_k(jbw.jnp.asarray(x), k=3)
        got = bw.copy_k(bw.dma_copy, _t(x), 3)
    _assert_bit_equal(got.numpy(), want)


def test_axpy_k_matches_jax(jbw, xy):
    x, y = xy
    want = jbw._jnp_axpy_k(jbw.jnp.asarray(x), jbw.jnp.asarray(y), k=3)
    got = bw.axpy_k(bw.grid_axpy, _t(x), _t(y), 3)
    _assert_axpy_close(got.numpy(), want, x, y, passes=3)


def test_k_forms_use_two_buffers_in_turn(xy):
    """copy_k and axpy_k write only into the two buffers they are given,
    in turn, and return the last one written."""
    x, y = (_t(a) for a in xy)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    out = bw.copy_k(bw.grid_copy, x, 3, bufs)
    assert out is bufs[0]
    torch.testing.assert_close(bufs[1], x * bw.A * bw.A, rtol=0, atol=0)
    out = bw.axpy_k(bw.grid_axpy, x, y, 2, bufs)
    assert out is bufs[1]


def test_wrappers_write_into_out():
    x = torch.randn(3, 512)
    y = torch.randn(3, 512)
    for fn, args, want in ((bw.grid_copy, (x,), x * bw.A),
                           (bw.grid_axpy, (x, y), bw.A * x + y),
                           (bw.dma_copy, (x,), x)):
        out = torch.full_like(x, float("nan"))
        assert fn(*args, out=out) is out
        torch.testing.assert_close(out, want, rtol=2e-7, atol=2e-7)
    copy = bw.dma_copy(x)
    assert copy.data_ptr() != x.data_ptr() and torch.equal(copy, x)


def test_launch_counts_stay_zero_on_the_cpu(xy):
    x, y = (_t(a) for a in xy)
    bw.reset_counts()
    bw.grid_copy(x)
    bw.grid_axpy(x, y)
    bw.dma_copy(x)
    bw.copy_k(bw.dma_copy, x, 2)
    assert sum(bw.launches.values()) == 0


def test_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card raises; the
    plain versions are for CPU tensors only, and mixed devices raise."""
    m = torch.empty(4, 512, device="meta")
    for fn, args in ((bw.grid_copy, (m,)), (bw.grid_axpy, (m, m)),
                     (bw.dma_copy, (m,))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    with pytest.raises(ValueError, match="CUDA"):
        bw.dma_copy(torch.zeros(4, 512), out=m)


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------
def test_passes_set_a_50ms_window_at_3_tb_per_s():
    assert bw.passes(128 * 2 ** 20) == 559
    assert bw.passes(2048 * 2 ** 20) == 35
    assert bw.passes(2048 * 2 ** 20, "cpu") == 1


def test_run_on_the_cpu_times_only_the_torch_rows():
    res = bw.run(sizes_mb=(8,), device="cpu")
    assert res["device"] == "cpu" and res["chunk_mb"] == 2.0
    (row,) = res["rows"]
    assert row["size_mb"] == 8.0 and row["k"] == bw.passes(8 * 2 ** 20, "cpu")
    assert set(row) == {"size_mb", "k", "torch_copy", "torch_axpy"}
    for m in ("torch_copy", "torch_axpy"):
        assert set(row[m]) == {"gbps", "window_s", "spread_pct"}
        assert row[m]["gbps"] > 0 and row[m]["window_s"] > 0
    assert sum(bw.launches.values()) == 0


def test_run_rounds_sizes_to_whole_chunks_like_the_jax_probe():
    res = bw.run(sizes_mb=(5,), device="cpu")
    assert res["rows"][0]["size_mb"] == 4.0
    with pytest.raises(ValueError, match="chunk"):
        bw.run(sizes_mb=(1,), device="cpu")


def test_main_writes_json_and_the_jax_table(tmp_path, capsys, monkeypatch):
    """main on the CPU: ``run`` is redirected there, as the probe itself
    runs only on a card."""
    seen = []
    real_run = bw.run

    def run_on_cpu(sizes_mb, seed):
        seen.append((sizes_mb, seed))
        return real_run(sizes_mb, device="cpu", seed=seed)

    monkeypatch.setattr(bw, "run", run_on_cpu)
    out = tmp_path / "bw.json"
    res = bw.main(["--sizes", "4", "--out", str(out), "--seed", "3"])
    assert seen == [((4,), 3)]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    text = capsys.readouterr().out
    header = [ln for ln in text.splitlines() if ln.lstrip().startswith("MB")]
    assert header and header[0].split() == ["MB", *bw.METHODS]
    assert "card" not in res
    assert bw.DEFAULT_OUT == os.path.join(cuda_build.BUILD_DIR,
                                          "bandwidth_results.json")


def test_probe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bw.run(sizes_mb=(8,))


# ---------------------------------------------------------------------------
# building
# ---------------------------------------------------------------------------
def test_triton_cache_goes_to_build(monkeypatch):
    """The Triton kernels are defined at first use, with Triton's cache
    under build/ unless the caller set TRITON_CACHE_DIR; here, where
    triton is not installed, that first use raises ImportError."""
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    for name in ("_triton", "triton", "tl"):
        monkeypatch.setattr(bw, name, getattr(bw, name))
    try:
        kernels = bw._triton_kernels()
    except ImportError:
        kernels = None
    assert os.environ["TRITON_CACHE_DIR"] == os.path.join(
        cuda_build.BUILD_DIR, "triton")
    assert kernels is None or len(kernels) == 2
    monkeypatch.setenv("TRITON_CACHE_DIR", "/elsewhere")
    try:
        bw._triton_kernels()
    except ImportError:
        pass
    assert os.environ["TRITON_CACHE_DIR"] == "/elsewhere"


def test_dma_library_is_named_by_content(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nfor a in \"$@\"; do prev=$cur; cur=$a; "
                    "if [ \"$prev\" = \"-o\" ]; then out=$a; fi; done\n"
                    "echo built > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    assert bw.build().startswith(str(tmp_path / "build" / "libstream_copy-"))
    assert bw.SOURCE == os.path.join(cuda_build.CSRC_DIR, "stream_copy.cu")


# ---------------------------------------------------------------------------
# chip_smoke.py's rule, and each kernel on the card
# ---------------------------------------------------------------------------
def test_smoke_rule_fails_an_unwritten_last_chunk():
    """chip_smoke.py's check: copies bit-equal, axpy within one ulp of
    |A*x| + |y|; a NaN-filled output whose last chunk (the ragged tail of
    the last program) was never written fails both, and so does an axpy
    two ulps off."""
    from chip_smoke import stream_close, stream_self_check
    g = torch.Generator().manual_seed(0)
    x = torch.randn(bw.BLOCK + 4, generator=g)
    y = torch.randn(bw.BLOCK + 4, generator=g)
    stream_self_check("copy", x.clone())
    stream_close("copy", x.clone(), x)
    flipped = x.clone()
    flipped.view(torch.int32)[7] ^= 1
    with pytest.raises(RuntimeError, match="differ"):
        stream_close("copy", flipped, x)
    want = bw.grid_axpy_reference(x, y)
    rounded = (x * bw.A) + y                    # A*x rounded first
    assert stream_close("axpy", rounded, want, x, y)[1] <= 1.0
    stream_self_check("axpy", want, x, y)
    off = want.clone()
    i = int((want.abs() > 1).nonzero()[0])
    off[i] = torch.nextafter(torch.nextafter(off[i], off[i] * 4), off[i] * 4)
    with pytest.raises(RuntimeError, match="limit"):
        stream_close("axpy", off, want, x, y)
    unwritten = want.clone()
    unwritten[-4:] = float("nan")
    with pytest.raises(RuntimeError, match="element"):
        stream_close("axpy", unwritten, want, x, y)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 4100, 1000 * 512 + 4, 62 * 8192 + 4,
                               8192 * 40])
def test_kernels_match_plain_on_card(cuda_device, n):
    from chip_smoke import stream_close
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(n, device=cuda_device, generator=g)
    y = torch.randn(n, device=cuda_device, generator=g)
    bw.reset_counts()
    for name, run, want, args in (
            ("grid_copy", lambda o: bw.grid_copy(x, out=o),
             bw.grid_copy_reference(x), ()),
            ("grid_axpy", lambda o: bw.grid_axpy(x, y, out=o),
             bw.grid_axpy_reference(x, y), (x, y)),
            ("dma_copy", lambda o: bw.dma_copy(x, out=o),
             bw.dma_copy_reference(x), ())):
        got = run(torch.full_like(x, float("nan")))
        torch.cuda.synchronize()
        stream_close(f"{name} at {n}", got, want, *args)
    assert dict(bw.launches) == dict.fromkeys(bw.KERNELS, 1)


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda_device):
    x = torch.zeros(4, 512, device=cuda_device)
    with pytest.raises(ValueError, match="16"):
        bw.dma_copy(torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError, match="16"):
        bw.dma_copy(x.view(-1)[1:2049])
    for fn in (bw.grid_copy, bw.dma_copy):
        with pytest.raises(TypeError, match="float32"):
            fn(x.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.t())
        with pytest.raises(ValueError, match="empty"):
            fn(x[:0])
    with pytest.raises(ValueError, match="shapes"):
        bw.grid_axpy(x, x[:2])
