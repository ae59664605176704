"""The backward launcher's ring depth (``csrc/flash_attn.cu``
``launch_bwd``): K3 fails with an unspecified launch failure on a ring of
one stage on the H100, so the launcher refuses fewer than
``kBwdMinStages`` = 2 stages with cudaErrorInvalidValue, as the Python
plans refuse depths below ``BWD_MIN_STAGES`` before launch.  The CPU tests
read the source and the plans; the ``cuda`` test launches K3 and K4
through the raw binding with a 1-stage plan built by hand (no JAX import:
it runs on the card)."""
import re

import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa


def _source():
    with open(fa.SOURCE) as f:
        return f.read()


def test_launcher_and_plans_share_the_least_depth():
    src = _source()
    m = re.search(r"constexpr int kBwdMinStages = (\d+);", src)
    assert m and int(m.group(1)) == fa.BWD_MIN_STAGES == 2
    body = src[src.index("cudaError_t launch_bwd("):]
    body = body[:body.index("\n}\n")]
    assert "p.stages < kBwdMinStages" in body
    assert "p.stages < 1" not in body


@pytest.mark.parametrize("stages", [0, 1])
def test_plans_refuse_a_ring_below_two_stages(stages):
    with pytest.raises(ValueError, match="2..4"):
        fa.bwd_plan(8, 1024, 1024, 64, 64, True, stages)


def test_default_backward_ring_is_at_least_two_stages():
    for D in (64, 128):
        p = fa.bwd_plan(8, 1024, 1024, D, D, True)
        assert p.dq.stages >= fa.BWD_MIN_STAGES
        assert p.dkv.stages >= fa.BWD_MIN_STAGES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_backward_launcher_refuses_one_stage_on_card(cuda_device):
    """csrc/flash_attn.cu refuses a 1-stage backward ring (K3 fails there
    with an unspecified launch failure): a plan built by hand with one
    stage, launched through the raw binding, returns
    cudaErrorInvalidValue for K3 and for K4 and launches nothing, and the
    next ordinary launch still runs and matches the plain version."""
    from chip_smoke import att_close
    BH, T, D = 2, 256, 64
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, gg = (torch.randn(BH, T, D, device=cuda_device, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(gg, out, None)
    lse32 = lse.float().contiguous()
    lib = fa._library()
    dims = fa._shapes(q, k, v)
    dtype = fa._DTYPE_CODES[torch.bfloat16]
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    scale = fa._scale(q, None)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for kernel, outs in (("bwd_dq", (dq,)), ("bwd_dkv", (dk, dv))):
        plan = (fa.BWD_ROWS, 1, fa._bwd_smem(kernel, 64, 1))
        rc = getattr(lib, f"flash_attn_{kernel}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gg.data_ptr(),
            lse32.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs), *dims, 1, scale, dtype, *plan,
            stream)
        assert rc == 1, (kernel, rc, lib.flash_attn_error_string(rc))
        with pytest.raises(RuntimeError, match="stages=1"):
            fa._check_rc(lib, rc, f"{kernel} stages=1")
    torch.cuda.synchronize()
    fa.reset_counts()
    grads = fa.flash_bwd(q, k, v, out, lse, gg, True)
    refs = fa.flash_bwd_reference(q, k, v, out, lse, gg, True)
    torch.cuda.synchronize()
    assert dict(fa.launches) == {"bwd_dq": 1, "bwd_dkv": 1}
    for a, b in zip(grads, refs):
        att_close("grad after the refusal", a, b, 2e-2)
