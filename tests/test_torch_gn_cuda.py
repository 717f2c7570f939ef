"""The GroupNorm CUDA kernels (csrc/gn.cu) against their plain PyTorch
versions, on the card. CUDA kernels have no CPU mode, so every test here
needs an NVIDIA GPU and skips without one; on a GPU machine (which need
not have JAX) run them without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_gn_cuda.py -q

Tolerances as in chip_smoke.py and tests/test_torch_gn.py: mean/rstd rtol
1e-5; y, measured at the largest of the terms ``x*a``, ``mean*a``,
``bias`` that sum to it, within one bf16 ulp (bf16) or 1e-5 of it (f32).
The normalize kernel alone, on the plain statistics, is bit-equal to the
plain version, with f32 and with bf16 scale/bias (bf16 local training); a
stats -> normalize pair (a programmatic dependent launch) replayed from a
CUDA graph is bitwise equal to the eager pair. ``gn_normalize`` alone is an
ordinary launch: it reads what the kernel just before it wrote.
"""

import pytest
import torch

from distributed_learning_simulator_tpu_torch.models.registry import get_model
from distributed_learning_simulator_tpu_torch.ops import gn_cuda

pytestmark = pytest.mark.cuda

G = 32
EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(b, hw, c, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(b, hw, c, device=device, generator=gen) * 2 + 1.5)
    scale = torch.randn(c, device=device, generator=gen)
    bias = torch.randn(c, device=device, generator=gen)
    return x.to(dtype), scale, bias


def _error_in_tolerances(x, y_k, y_p, mean, rstd, scale, bias):
    """Largest |y_k - y_p| as a multiple of its tolerance (module doc)."""
    cpg = x.shape[2] // mean.shape[1]
    a = (rstd.repeat_interleave(cpg, dim=1) * scale)[:, None, :]
    m = mean.repeat_interleave(cpg, dim=1)[:, None, :]
    mag = torch.maximum(
        torch.maximum(y_p.float().abs(), (x.float().abs() + m.abs()) * a.abs()),
        bias.abs(),
    ).clamp(min=2.0**-126)
    if y_p.dtype == torch.bfloat16:
        tol = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    else:
        tol = 1e-5 * mag
    return ((y_k.float() - y_p.float()).abs() / tol).max().item()


@pytest.mark.parametrize("b,hw,c", [
    (25, 1024, 64),  # S = 4 planned
    (25, 256, 128), (25, 64, 256), (25, 16, 512),
    (3, 7, 96),  # C/8 = 12 vectors: the general (not power-of-two) path
    (1000, 1024, 64),  # the eval batch: S = 1, one CTA per sample
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("params", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, b, hw, c, dtype, params):
    x, scale, bias = _inputs(b, hw, c, dtype, cuda)
    scale, bias = scale.to(params), bias.to(params)
    mean_k, rstd_k = gn_cuda.gn_stats(x, G, EPS)
    mean_p, rstd_p = gn_cuda.gn_stats_plain(x, G, EPS)
    torch.testing.assert_close(mean_k, mean_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(rstd_k, rstd_p, rtol=1e-5, atol=0)
    y_p = gn_cuda.gn_normalize_plain(x, mean_p, rstd_p, scale, bias, dtype)
    y_alone = gn_cuda.gn_normalize(x, mean_p, rstd_p, scale, bias, dtype)
    assert torch.equal(y_alone, y_p)
    y_k = gn_cuda.gn_normalize(x, mean_k, rstd_k, scale, bias, dtype)
    torch.cuda.synchronize()
    assert _error_in_tolerances(x, y_k, y_p, mean_p, rstd_p, scale.float(),
                                bias.float()) <= 1.0


@pytest.mark.parametrize("b,hw,c", [(25, 1024, 64), (1000, 1024, 64)])
def test_pair_graph_replay_is_bitwise_equal_to_eager(cuda, b, hw, c):
    x, scale, bias = _inputs(b, hw, c, torch.bfloat16, cuda, seed=3)
    x4 = x.view(b, 32, hw // 32, c)
    scale, bias = scale.to(torch.bfloat16), bias.to(torch.bfloat16)

    def pair():
        return gn_cuda.group_norm(x4, scale, bias, G, EPS, torch.bfloat16)

    eager = pair()
    assert all(torch.equal(p, q) for p, q in zip(eager, pair()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pair()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(eager, captured))


def test_one_group_norm_call_launches_two_kernels(cuda):
    """bf16 scale/bias reach the kernel as they are: one group_norm call is
    the stats and the normalize kernel, no conversion kernels."""
    from torch.profiler import ProfilerActivity, profile

    x, scale, bias = _inputs(25, 256, 128, torch.bfloat16, cuda)
    x4 = x.view(25, 16, 16, 128)
    scale, bias = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    gn_cuda.group_norm(x4, scale, bias, G, EPS, torch.bfloat16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gn_cuda.group_norm(x4, scale, bias, G, EPS, torch.bfloat16)
        torch.cuda.synchronize()
    kernels = [
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith(("Memcpy", "Memset"))
    ]
    assert len(kernels) == 2, kernels
    assert any("gn_stats_kernel" in k for k in kernels)
    assert any("gn_normalize_kernel" in k for k in kernels)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("b,hw,c,dtype", [
    (25, 1024, 64, torch.bfloat16),
    (25, 16, 512, torch.bfloat16),  # S = 8: two HW rows a CTA
    (3, 7, 96, torch.bfloat16),  # S = 4, 8 over 7 rows: ragged, empty slices
    (4, 100, 64, torch.float32),
])
def test_every_split_matches_plain(cuda, b, hw, c, dtype, split):
    x, _, _ = _inputs(b, hw, c, dtype, cuda, seed=2)
    mean_k, rstd_k = gn_cuda.gn_stats(x, G, EPS, split=split)
    mean_p, rstd_p = gn_cuda.gn_stats_plain(x, G, EPS)
    torch.testing.assert_close(mean_k, mean_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(rstd_k, rstd_p, rtol=1e-5, atol=0)


@pytest.mark.parametrize("slices", [1, 3, 7, 64])
@pytest.mark.parametrize("b,hw,c,dtype", [
    (25, 1024, 64, torch.bfloat16),  # 1 and 3: clipped to 4, 8 rows a thread
    (3, 7, 96, torch.bfloat16),  # idle threads, slices past the rows
    (4, 100, 64, torch.float32),
])
def test_every_normalize_slicing_matches_plain(cuda, b, hw, c, dtype, slices):
    """The slice counts chip_gn_sweep.py times, through the same private
    launch."""
    x, scale, bias = _inputs(b, hw, c, dtype, cuda, seed=4)
    scale, bias = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    mean, rstd = gn_cuda.gn_stats_plain(x, G, EPS)
    y = gn_cuda._normalize(x, mean, rstd, scale, bias, dtype,
                           after_stats=False, slices=slices)
    assert torch.equal(y, gn_cuda.gn_normalize_plain(x, mean, rstd, scale,
                                                     bias, dtype))


@pytest.mark.parametrize("b,hw,c", [(25, 1024, 64), (1000, 1024, 64)])
@pytest.mark.parametrize("params", [torch.float32, torch.bfloat16])
def test_normalize_reads_what_the_kernel_before_it_wrote(cuda, b, hw, c,
                                                         params):
    """gn_normalize straight after a PyTorch kernel that writes its x, or
    its scale and bias, reads the new values: it is no dependent launch of
    a kernel that does not write them. Each round changes every input."""
    x, scale, bias = _inputs(b, hw, c, torch.bfloat16, cuda, seed=5)
    scale, bias = scale.to(params), bias.to(params)
    xs = [x, -x, x * 2]
    stats = [gn_cuda.gn_stats_plain(v, G, EPS) for v in xs]
    pars = [(scale, bias), (-scale, bias * 2), (scale * 2, -bias)]
    x_now = xs[-1].clone()
    scale_now, bias_now = (t.clone() for t in pars[-1])
    for k, (v, (mean, rstd), (s, bi)) in enumerate(zip(xs, stats, pars)):
        want = gn_cuda.gn_normalize_plain(v, mean, rstd, s, bi, v.dtype)
        torch.cuda.synchronize()
        # x written by a kernel, then normalize at once.
        torch.mul(v, 1, out=x_now)
        got_x = gn_cuda.gn_normalize(x_now, mean, rstd, scale_now, bias_now,
                                     v.dtype)
        # scale and bias written by a kernel, then normalize at once.
        torch.mul(s, 1, out=scale_now)
        torch.mul(bi, 1, out=bias_now)
        got_p = gn_cuda.gn_normalize(x_now, mean, rstd, scale_now, bias_now,
                                     v.dtype)
        torch.cuda.synchronize()
        assert torch.equal(got_p, want), k
        prev = pars[k - 1]
        assert torch.equal(got_x, gn_cuda.gn_normalize_plain(
            v, mean, rstd, prev[0], prev[1], v.dtype)), k


@pytest.mark.parametrize("b,hw,c", [(25, 1024, 64), (1000, 1024, 64)])
def test_stats_are_bitwise_deterministic(cuda, b, hw, c):
    x, _, _ = _inputs(b, hw, c, torch.bfloat16, cuda, seed=1)
    for split in (None, 8):
        first = gn_cuda.gn_stats(x, G, EPS, split=split)
        again = gn_cuda.gn_stats(x, G, EPS, split=split)
        assert all(torch.equal(p, q) for p, q in zip(first, again))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, scale, bias = _inputs(4, 16, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gn_cuda.gn_stats(x.transpose(1, 2).contiguous().transpose(1, 2), G,
                         EPS)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gn_cuda.gn_stats(x.half(), G, EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        gn_cuda.gn_stats(torch.zeros(2, 4, 36, dtype=torch.bfloat16,
                                     device=cuda), 4, EPS)
    mean, rstd = gn_cuda.gn_stats(x, G, EPS)
    with pytest.raises(ValueError, match="dtype"):
        gn_cuda.gn_normalize(x, mean, rstd, scale, bias, torch.float32)
    for s, b in ((scale.half(), bias.half()), (scale, bias.bfloat16()),
                 (scale[:32], bias), (scale.cpu(), bias.cpu())):
        with pytest.raises(ValueError, match="scale/bias"):
            gn_cuda.gn_normalize(x, mean, rstd, s, b, torch.bfloat16)
    # The C side refuses a plan that gives a thread more than one batch of
    # 8 loads: at C = 64 bf16 (8 vectors a row) a CTA covers 32 rows a
    # step, so a slice may hold at most 256 rows.
    y = torch.empty_like(x)
    err = gn_cuda._lib().dls_gn_normalize_bf16_f32(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), y.data_ptr(), 4, 16, 64, G, 1, 32 * 8 + 1, 0,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.parametrize("params", [torch.float32, torch.bfloat16])
def test_model_forward_launches_each_kernel_once_per_group_norm(cuda, params):
    model = get_model("resnet18").to(cuda, params)
    gn_cuda.reset_launch_counts()
    with torch.no_grad():
        logits = model(torch.rand(2, 32, 32, 3, device=cuda))
    torch.cuda.synchronize()
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    assert gn_cuda.gn_stats.launches == gn_cuda.gn_normalize.launches == 20
