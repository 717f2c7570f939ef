"""The stage-1 weight-gradient kernel (csrc/wgrad.cu) against its plain
PyTorch version, on the card. CUDA kernels have no CPU mode, so every test
here needs an NVIDIA GPU and skips without one; on a GPU machine (which need
not have JAX) run them without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_wgrad_cuda.py -q

Tolerance as in chip_smoke.py: |kernel - plain| <= 1e-4 * max|plain| in
f32 (both sum the same f32 products over B*H*W rows, in other orders), and
once both are cast to bf16, within one bf16 ulp of the element's magnitude
``S = sum |x_pad * g|`` (where the terms cancel, |dW| is far below the
rounding of its terms, so the ulp is taken at S, as the GroupNorm checks
take it at the largest term).
"""

import pytest
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.models.registry import get_model
from distributed_learning_simulator_tpu_torch.ops import wgrad_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, device=device, generator=gen).to(dtype)
    g = torch.randn(shape, device=device, generator=gen).to(dtype)
    return x, g


def _bf16_ulps(k, p, x, g):
    """Largest |k - p| after a bf16 cast, in bf16 ulps of the element's
    magnitude ``sum |x_pad * g|``."""
    mag = wgrad_cuda.conv3x3_wgrad_plain(x.abs(), g.abs()).clamp(
        min=2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    kb, pb = k.bfloat16().float(), p.bfloat16().float()
    return ((kb - pb).abs() / ulp).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (25, 32, 32, 64),  # ResNet-18 stage 1 at the training batch
    (3, 8, 8, 8),      # odd shape: one ragged 64-wide tile, one chunk
    (2, 7, 5, 136),    # C > 64 and not a multiple of 64: 3x3 tiles
    (4, 28, 28, 64),   # W not a multiple of 16: ragged K slabs, zero fill
    (3, 20, 32, 64),   # H not a multiple of the 16-row chunk
])
def test_kernel_matches_plain(cuda, shape, dtype):
    x, g = _inputs(shape, dtype, cuda)
    k = wgrad_cuda.conv3x3_wgrad(x, g)
    p = wgrad_cuda.conv3x3_wgrad_plain(x, g)
    torch.cuda.synchronize()
    assert k.dtype == torch.float32 and k.shape == p.shape
    err = (k - p).abs().max().item()
    assert err <= 1e-4 * p.abs().max().item(), err
    assert _bf16_ulps(k, p, x, g) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_reruns_are_bitwise_equal(cuda, dtype):
    x, g = _inputs((25, 32, 32, 64), dtype, cuda, seed=1)
    first = wgrad_cuda.conv3x3_wgrad(x, g)
    for _ in range(3):
        assert torch.equal(wgrad_cuda.conv3x3_wgrad(x, g), first)


def test_launch_count_per_training_step_and_none_in_eval(cuda):
    model = get_model("resnet18").to(cuda)
    x = torch.rand(4, 32, 32, 3, device=cuda)
    y = torch.randint(0, 10, (4,), device=cuda)
    wgrad_cuda.reset_launch_counts()
    with torch.no_grad():
        model(x)
    assert wgrad_cuda.conv3x3_wgrad.launches == 0
    F.cross_entropy(model(x), y).backward()
    assert wgrad_cuda.conv3x3_wgrad.launches == 4  # 2 x stage_sizes[0]


def test_rejects_what_the_kernel_does_not_take(cuda):
    x, g = _inputs((2, 4, 4, 12), torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        wgrad_cuda.conv3x3_wgrad(x, g)
    x, g = _inputs((2, 4, 4, 16), torch.float16, cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        wgrad_cuda.conv3x3_wgrad(x, g)
    x, g = _inputs((2, 4, 4, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        wgrad_cuda.conv3x3_wgrad(x.transpose(1, 2), g.transpose(1, 2))
