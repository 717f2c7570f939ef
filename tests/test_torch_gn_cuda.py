"""The GroupNorm CUDA kernels (csrc/gn.cu) against their plain PyTorch
versions, on the card. CUDA kernels have no CPU mode, so every test here
needs an NVIDIA GPU and skips without one; on a GPU machine (which need
not have JAX) run them without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_gn_cuda.py -q

The stats kernel is bitwise its order twin (``gn_stats_plain``, and
``gn_sums_plain`` for each group's sum x and sum x^2) at every split, and
the statistics of M models side by side on the channel axis are bitwise
each model's own call. y, measured at the largest of the terms ``x*a``,
``mean*a``, ``bias`` that sum to it, is within one bf16 ulp (bf16) or 1e-5
of it (f32) of the plain pair's.
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
    (25, 1024, 64),  # 32 lanes, one a thread row
    (25, 256, 128), (25, 64, 256), (25, 16, 512),
    (3, 7, 96),  # C/8 = 12 vectors: 8 thread rows of 12, idle threads
    (1000, 1024, 64),  # the eval batch: S = 1, one CTA per sample
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("params", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, b, hw, c, dtype, params):
    x, scale, bias = _inputs(b, hw, c, dtype, cuda)
    scale, bias = scale.to(params), bias.to(params)
    mean_k, rstd_k = gn_cuda.gn_stats(x, G, EPS)
    mean_p, rstd_p = gn_cuda.gn_stats_plain(x, G, EPS)
    assert torch.equal(mean_k, mean_p) and torch.equal(rstd_k, rstd_p)
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
    (25, 16, 512, torch.bfloat16),  # S = 8: two lanes a CTA
    (3, 7, 96, torch.bfloat16),  # 8 lanes over 7 rows: an empty lane
    (4, 100, 64, torch.float32),
])
def test_every_split_matches_plain(cuda, b, hw, c, dtype, split):
    x, _, _ = _inputs(b, hw, c, dtype, cuda, seed=2)
    mean_k, rstd_k, sums_k = gn_cuda.gn_stats(x, G, EPS, split=split,
                                              sums=True)
    mean_p, rstd_p = gn_cuda.gn_stats_plain(x, G, EPS)
    assert torch.equal(sums_k, torch.stack(gn_cuda.gn_sums_plain(x, G), -1))
    assert torch.equal(mean_k, mean_p) and torch.equal(rstd_k, rstd_p)


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
    # 4 rows make 4 lanes: a split of 8 would leave ranks without one.
    with pytest.raises(ValueError, match="at most 4"):
        gn_cuda.gn_stats(x[:, :4].contiguous(), G, EPS, split=8)
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
        bias.data_ptr(), y.data_ptr(), 4, 16, 64, G, 1, 32 * 8 + 1, 0, 0,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    # A per-model affine must have a row count that divides the batch.
    for s, b in ((scale.expand(3, 64).contiguous(),
                  bias.expand(3, 64).contiguous()),
                 (scale.expand(2, 64).contiguous(), bias)):
        with pytest.raises(ValueError, match="scale/bias"):
            gn_cuda.gn_normalize(x, mean, rstd, s, b, torch.bfloat16)


@pytest.mark.parametrize("hw,c", [(1024, 64), (16, 512)])
@pytest.mark.parametrize("params", [torch.float32, torch.bfloat16])
def test_model_affine_is_bitwise_per_model_calls(cuda, hw, c, params):
    """x of 8 models x 5 samples with an ``[8, C]`` affine: bitwise the 8
    ``[C]`` calls and the plain version, alone and inside group_norm."""
    m, b = 8, 5
    x, _, _ = _inputs(m * b, hw, c, torch.bfloat16, cuda, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    scale = torch.randn(m, c, device=cuda, generator=gen).to(params)
    bias = torch.randn(m, c, device=cuda, generator=gen).to(params)
    mean, rstd = gn_cuda.gn_stats_plain(x, G, EPS)
    got = gn_cuda.gn_normalize(x, mean, rstd, scale, bias, torch.bfloat16)
    assert torch.equal(got, gn_cuda.gn_normalize_plain(
        x, mean, rstd, scale, bias, torch.bfloat16))
    for k in range(m):
        rows = slice(k * b, (k + 1) * b)
        assert torch.equal(got[rows], gn_cuda.gn_normalize(
            x[rows], mean[rows], rstd[rows], scale[k], bias[k],
            torch.bfloat16))
    y, m_k, r_k = gn_cuda.group_norm(x.view(m * b, hw, 1, c), scale, bias,
                                     G, EPS, torch.bfloat16)
    assert torch.equal(y.view(m * b, hw, c), gn_cuda.gn_normalize(
        x, m_k, r_k, scale, bias, torch.bfloat16))


@pytest.mark.parametrize("params", [torch.float32, torch.bfloat16])
def test_model_forward_launches_each_kernel_once_per_group_norm(cuda, params):
    model = get_model("resnet18").to(cuda, params)
    gn_cuda.reset_launch_counts()
    with torch.no_grad():
        logits = model(torch.rand(2, 32, 32, 3, device=cuda))
    torch.cuda.synchronize()
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    assert gn_cuda.gn_stats.launches == gn_cuda.gn_normalize.launches == 20


# The models on the channel side (ops/gn_cuda.py ``channel_side``): x
# [B, HW, M*C] with M*G groups, each stage's (HW, C) for M in 1, 2, 4, 10,
# 16, 32 where M*C fits a kernel row (2048 bf16 / 1024 f32 channels), at the
# training batch and the eval batch. M*C = 640 or 1280 is no power of two;
# M*G > 256 groups loops over groups.
_CHANNEL_SIDE = [
    (b, hw, c, m, dtype)
    for dtype, width in ((torch.bfloat16, 2048), (torch.float32, 1024))
    for hw, c in ((1024, 64), (256, 128), (64, 256), (16, 512))
    for m in (1, 2, 4, 10, 16, 32) if m * c <= width
    for b in (25, 1000)
]


@pytest.mark.parametrize("b,hw,c,m,dtype", _CHANNEL_SIDE)
def test_channel_side_matches_plain_and_per_model_calls(cuda, b, hw, c, m,
                                                        dtype):
    """The statistics bitwise their order twin (mean, rstd and each
    group's sums) and each model's own call, at the planned split and at
    splits 1, 2, 4 and 8; normalize (bf16 affine) bitwise equal to its
    plain version and, on the same statistics, to M per-model calls with
    ``[C]`` affines; ``group_norm`` bitwise equal to its two kernels called
    alone."""
    x, _, _ = _inputs(b, hw, m * c, dtype, cuda, seed=6)
    gen = torch.Generator(device=cuda).manual_seed(7)
    scale = torch.randn(m, c, device=cuda, generator=gen).bfloat16()
    bias = torch.randn(m, c, device=cuda, generator=gen).bfloat16()
    flat_s, flat_b = scale.reshape(-1), bias.reshape(-1)
    mean_p, rstd_p = gn_cuda.gn_stats_plain(x, m * G, EPS)
    sums_p = torch.stack(gn_cuda.gn_sums_plain(x, m * G), -1)
    models = [gn_cuda.gn_stats(x[:, :, k * c:(k + 1) * c].contiguous(), G,
                               EPS) for k in range(m)]
    for split in (None, 1, 2, 4, 8):
        mean, rstd, sums = gn_cuda.gn_stats(x, m * G, EPS, split=split,
                                            sums=True)
        assert torch.equal(sums, sums_p), split
        assert torch.equal(mean, mean_p) and torch.equal(rstd, rstd_p), split
        for k, (mk, rk) in enumerate(models):
            grp = slice(k * G, (k + 1) * G)
            assert torch.equal(mean[:, grp], mk), (split, k)
            assert torch.equal(rstd[:, grp], rk), (split, k)
    mean, rstd = gn_cuda.gn_stats(x, m * G, EPS)
    y = gn_cuda.gn_normalize(x, mean, rstd, flat_s, flat_b, dtype)
    assert torch.equal(y, gn_cuda.gn_normalize_plain(
        x, mean, rstd, flat_s, flat_b, dtype))
    for k in range(m):
        cols, grp = slice(k * c, (k + 1) * c), slice(k * G, (k + 1) * G)
        xk = x[:, :, cols].contiguous()
        assert torch.equal(y[:, :, cols], gn_cuda.gn_normalize(
            xk, mean[:, grp].contiguous(), rstd[:, grp].contiguous(),
            scale[k], bias[k], dtype))
    y_pair, m_pair, r_pair = gn_cuda.group_norm(
        x.view(b, hw, 1, m * c), flat_s, flat_b, m * G, EPS, dtype)
    assert torch.equal(m_pair, mean) and torch.equal(r_pair, rstd)
    assert torch.equal(y_pair.view(b, hw, m * c), y)
