"""The GroupNorm stats kernel's order on the CPU (ops/gn_cuda.py
``gn_sums_plain`` / ``gn_stats_plain``, the plain twin the kernel in
csrc/gn.cu is held to bitwise on the card).

A group's sum x and sum x^2 are formed in an order set by (HW, C/G) alone:
row lanes summed in row order, a balanced tree over the lanes, the
channels in order. So the twin's mean and rstd are bitwise equal

* across B (a sample's statistics in a batch of any size);
* across M models side by side on the channel axis (``[B, HW, M*C]`` with
  M*G groups, as a fleet's or a Shapley eval's grouped convolutions leave
  them) against each model's own ``[B, HW, C]``, at power-of-two rows and
  at 640 and 1280 channels;
* across the kernel's cluster splits 1, 2, 4 and 8;

and stay within rtol 1e-5 of the JAX package's ``pallas_group_norm`` in TPU
interpret mode, the tolerance tests/test_torch_gn.py holds the port to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_learning_simulator_tpu.ops.gn_pallas import pallas_group_norm
from distributed_learning_simulator_tpu_torch.ops import gn_cuda

G = 32
EPS = 1e-6


def _x(b, hw, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, hw, c)) * 2 + 1.5).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("hw,c,m", [
    (256, 64, 4),     # 4 x 64: a power-of-two row
    (64, 64, 10),     # 640 channels
    (16, 128, 10),    # 1280 channels
    (49, 96, 3),      # 49 rows in 32 lanes of 2 slots, 15 of them empty
    (7, 64, 2),       # 8 lanes over 7 rows
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_models_side_by_side_are_bitwise_their_own_statistics(hw, c, m,
                                                              dtype):
    x = _x(3, hw, m * c, dtype)
    mean, rstd = gn_cuda.gn_stats_plain(x, m * G, EPS)
    for k in range(m):
        mk, rk = gn_cuda.gn_stats_plain(x[:, :, k * c:(k + 1) * c], G, EPS)
        assert torch.equal(mean[:, k * G:(k + 1) * G], mk), k
        assert torch.equal(rstd[:, k * G:(k + 1) * G], rk), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_statistics_do_not_depend_on_the_batch(dtype):
    x = _x(5, 256, 128, dtype, seed=1)
    mean, rstd = gn_cuda.gn_stats_plain(x, G, EPS)
    for b in range(5):
        mb, rb = gn_cuda.gn_stats_plain(x[b:b + 1], G, EPS)
        assert torch.equal(mean[b:b + 1], mb) and torch.equal(rstd[b:b + 1],
                                                              rb)


@pytest.mark.parametrize("hw,c", [(1024, 64), (256, 128), (64, 256),
                                  (16, 512), (100, 640)])
@pytest.mark.parametrize("split", [2, 4, 8])
def test_every_split_is_bitwise_one_cta(hw, c, split):
    """The kernel's cut into cluster ranks (lanes [r L/S, (r+1) L/S) each,
    their subtree roots meeting in the same tree) moves no bit."""
    x = _x(2, hw, c, torch.bfloat16, seed=2)
    one = gn_cuda.gn_sums_plain(x, G)
    cut = gn_cuda.gn_sums_plain(x, G, split=split)
    assert all(torch.equal(a, b) for a, b in zip(one, cut))
    assert all(torch.equal(a, b) for a, b in zip(
        gn_cuda.gn_stats_plain(x, G, EPS),
        gn_cuda.gn_stats_plain(x, G, EPS, split=split)))


def test_the_order_is_lanes_then_tree_then_channels():
    """The twin's sums against the order written out in Python floats
    rounded to f32 one add at a time: 8 rows make 8 lanes of one row, the
    lanes meet pairwise, then each group's two channels (a pair: the
    channels' tree)."""
    x = _x(1, 8, 64, torch.float32, seed=3)
    s1, s2 = gn_cuda.gn_sums_plain(x, G)
    f32 = np.float32
    for gi in (0, 17):
        chans = []
        for ch in (2 * gi, 2 * gi + 1):
            lanes = [f32(0) + f32(x[0, r, ch].item()) for r in range(8)]
            while len(lanes) > 1:
                lanes = [f32(lanes[i] + lanes[i + 1])
                         for i in range(0, len(lanes), 2)]
            chans.append(lanes[0])
        assert s1[0, gi].item() == f32(chans[0] + chans[1])
    assert torch.isfinite(s2).all()


def test_cpu_stats_with_sums_are_the_twins():
    """``gn_stats(..., sums=True)`` on a CPU tensor: the twin's mean, rstd
    and each group's ``(sum x, sum x^2)`` as ``[B, G, 2]``."""
    x = _x(2, 16, 64, torch.float32, seed=5)
    mean, rstd, sums = gn_cuda.gn_stats(x, G, EPS, split=2, sums=True)
    assert torch.equal(sums, torch.stack(gn_cuda.gn_sums_plain(x, G), -1))
    m_p, r_p = gn_cuda.gn_stats_plain(x, G, EPS)
    assert torch.equal(mean, m_p) and torch.equal(rstd, r_p)


def test_a_split_past_the_lanes_is_refused():
    with pytest.raises(ValueError, match="at most 4"):
        gn_cuda.gn_sums_plain(_x(1, 4, 64, torch.float32), G, split=8)


@pytest.mark.parametrize("b,hw,c,g", [(2, 256, 640, 320), (3, 64, 256, G),
                                      (2, 16, 512, G)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_twin_matches_pallas_group_norm(b, hw, c, g, dtype):
    """The twin's statistics within rtol 1e-5 of ``pallas_group_norm``'s
    (interpret mode), 640 channels of 10 models side by side included."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = _x(b, hw, c, torch.float32, seed=4)
    xj = jnp.asarray(x.numpy()).astype(jdt)
    side = int(np.sqrt(hw))
    with pltpu.force_tpu_interpret_mode():
        _, m_p, r_p = pallas_group_norm(
            xj.reshape(b, side, side, c), jnp.ones(c), jnp.zeros(c), g, EPS,
            jdt, folds=1)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    mean, rstd = gn_cuda.gn_stats_plain(xt, g, EPS)
    np.testing.assert_allclose(mean.numpy(), np.asarray(m_p).reshape(b, g),
                               rtol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(r_p).reshape(b, g),
                               rtol=1e-5)
