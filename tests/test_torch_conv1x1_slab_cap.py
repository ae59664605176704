"""K1's launch plan (``paddle_tpu_torch/ops/conv1x1.py`` ``plan()``) under
the bf16 slab cap, on the CPU (pure arithmetic, no card):

* at every product the port runs today (ResNet-50's eligible 1x1 convs
  at the served, trained and deployed batches, the v1 config's ResNet-50
  of ``[elastic]`` and ``[cli]``, GoogLeNet's two shapes, ``[tune]``'s
  wgrad shapes; each as forward, dgrad, wgrad, forward + ``out_stats``
  and wgrad + ``a_colsum``, in bf16 and fp32) ``plan()`` gives exactly
  the plan it gave before the cap: the table's digest is the one the
  rule without the cap gives, and no bf16 slab there is half the cap
  long (the longest is 88 K steps);
* the dw [2048, 2048] wgrad over K = 50176 (a 2048->2048 conv at 28x28,
  batch 64), one slab of 784 K steps without the cap, now has none over
  ``MAX_BF16_SLAB_STEPS`` (256: 4 slabs of 196 steps, whose largest
  error read 0.54 of ``deep_tol``'s limit on an H100 80GB HBM3 at 700 W,
  where 2 slabs of 392 read 1.12); an ``out_stats`` product past the cap
  raises.
"""
import hashlib
import importlib.util
import os

import pytest
import torch

from paddle_tpu_torch.ops import conv1x1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132                    # an H100 SXM's SMs
BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
# GoogLeNet's 1x1 convs on K1 at batch 128 (inception 3b's and 4c's c1
# and c3r), and [tune]'s three wgrad shapes, as (P, C, M)
GOOGLENET = ((93312, 256, 128), (21632, 512, 128))
TUNE = ((100352, 512, 128), (93312, 256, 128), (21632, 512, 128))
# sha256 of _table() as plan() gave it before the cap (the rule the
# port's chip runs measured, PRs 5-22)
DIGEST = "ddcba1d06450f541e76b9a85d7539add5dd526d1007fdcd7c9d1df3fad4eea6d"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_shapes():
    """Every (P, C, M) the port's paths put on K1 today."""
    from paddle_tpu_torch.trainer_config_helpers import load_v1_config
    cs = _chip_smoke()
    infer = cs.build_resnet50(0)[0]
    train = cs.build_resnet50_train(0)[0]
    shapes = set(GOOGLENET) | set(TUNE)
    for b in BATCHES:
        shapes.update(cs.eligible_1x1_shapes(infer, b))
        shapes.update(cs.eligible_1x1_shapes(train, b))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "resnet50_v1.py")
        with open(path, "w") as f:
            f.write(cs.resnet_v1_conf())
        cfg = load_v1_config(path)
    for b in (4, 32):
        shapes.update(cs.eligible_1x1_shapes(cfg.main_program, b))
    return sorted(shapes)


def _products(P, C, M):
    """The products of one 1x1 conv, as ops/conv1x1.py launches them:
    (M, N, K, ta, tb, out_stats, a_colsum)."""
    return ((P, M, C, False, True, False, False),      # forward
            (P, C, M, False, False, False, False),     # dgrad
            (M, C, P, True, False, False, False),      # wgrad
            (P, M, C, False, True, True, False),       # + out_stats
            (M, C, P, True, False, False, True))       # + a_colsum


def _table(shapes):
    lines = []
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for (M, N, K, ta, tb, st, cs) in _products(*shape):
                p = conv1x1.plan(M, N, K, ta, tb, dtype, SMS, st, cs, dtype)
                lines.append(f"{M} {N} {K} {ta:d}{tb:d}{st:d}{cs:d} "
                             f"{dtype} -> {p}")
    return lines


@pytest.fixture(scope="module")
def shapes():
    return _port_shapes()


def test_port_shapes_cover_the_main_paths(shapes):
    assert (100352, 512, 128) in shapes          # ResNet-50 stage 2, b128
    assert (6272, 1024, 2048) in shapes          # stage 4's projection
    assert (21632, 512, 128) in shapes           # GoogLeNet 4c
    assert len(shapes) == 44


def test_plan_is_unchanged_at_every_port_shape(shapes):
    table = _table(shapes)
    got = hashlib.sha256("\n".join(table).encode()).hexdigest()
    assert got == DIGEST, (len(table), got)
    for shape in shapes:
        for (M, N, K, ta, tb, st, cs) in _products(*shape):
            p = conv1x1.plan(M, N, K, ta, tb, torch.bfloat16, SMS, st, cs)
            assert -(-p.ksteps // p.splits) <= \
                conv1x1.MAX_BF16_SLAB_STEPS // 2, (shape, p)


def test_plan_without_the_cap_is_the_same_rule(shapes, monkeypatch):
    """The cap changes no plan at these shapes: plan() with the cap
    lifted gives the same table (the digest above is that rule's)."""
    capped = _table(shapes)
    monkeypatch.setattr(conv1x1, "MAX_BF16_SLAB_STEPS", 10 ** 9)
    conv1x1.plan.cache_clear()
    try:
        assert _table(shapes) == capped
    finally:
        monkeypatch.undo()
        conv1x1.plan.cache_clear()


def test_long_bf16_wgrad_slabs_are_capped(monkeypatch):
    M = N = 2048
    K = 64 * 28 * 28                              # 50176: 784 K steps
    p = conv1x1.plan(M, N, K, True, False, torch.bfloat16, SMS)
    assert p.ksteps == 784 and p.tiles == 256
    assert conv1x1.MAX_BF16_SLAB_STEPS == 256
    assert p.splits == 4 and p.cluster == 4 and p.partials == 0
    assert max(hi - lo for lo, hi in p.slabs()) <= \
        conv1x1.MAX_BF16_SLAB_STEPS * p.tile[2]
    conv1x1.check_launch(p)                       # launchable as planned
    with_colsum = conv1x1.plan(M, N, K, True, False, torch.bfloat16, SMS,
                               a_colsum=True)
    assert with_colsum.splits == 4
    # the same product without the cap: one slab of 784 steps, which
    # check_launch refuses
    monkeypatch.setattr(conv1x1, "MAX_BF16_SLAB_STEPS", 10 ** 9)
    conv1x1.plan.cache_clear()
    p32 = conv1x1.plan(M, N, K, True, False, torch.float32, SMS)
    try:
        old = conv1x1.plan(M, N, K, True, False, torch.bfloat16, SMS)
        old32 = conv1x1.plan(M, N, K, True, False, torch.float32, SMS)
    finally:
        monkeypatch.undo()
        conv1x1.plan.cache_clear()
    assert old.splits == 1
    with pytest.raises(ValueError, match="K steps > 256"):
        conv1x1.check_launch(old)
    # fp32 slabs keep their own rule
    assert p32 == old32


@pytest.mark.parametrize("ksteps,splits,cluster,partials", [
    (257, 2, 2, 0),
    (2048, 8, 8, 0),
    (2049, 16, 8, 2),            # above the cluster: whole clusters
    (4500, 24, 8, 3),
])
def test_cap_rounds_to_whole_clusters(ksteps, splits, cluster, partials):
    # 256 tiles fill the SMs, so the rule itself gives one slab
    p = conv1x1.plan(2048, 2048, ksteps * 64, True, False, torch.bfloat16,
                     SMS)
    assert (p.splits, p.cluster, p.partials) == (splits, cluster, partials)
    assert -(-p.ksteps // p.splits) <= conv1x1.MAX_BF16_SLAB_STEPS
    conv1x1.check_launch(p)


def test_out_stats_past_the_cap_raises():
    with pytest.raises(ValueError, match="MAX_BF16_SLAB_STEPS = 256"):
        conv1x1.plan(256, 256, 257 * 64, False, True, torch.bfloat16, SMS,
                     out_stats=True)
    ok = conv1x1.plan(256, 256, 256 * 64, False, True, torch.bfloat16, SMS,
                      out_stats=True)
    assert ok.splits == 1
    # fp32 out_stats products are not capped
    conv1x1.plan(256, 256, 257 * 32, False, True, torch.float32, SMS,
                 out_stats=True)
