"""The port's GroupNorm (ops/gn_cuda.py, models/resnet.py) against the JAX
package's: the real Pallas kernels run in TPU interpret mode on the CPU,
the jnp forward ``_gn_forward``, and the closed-form backward.

On the CPU the port's wrappers take their plain PyTorch versions (the CUDA
kernels themselves are held against those versions on the card by
chip_smoke.py). Tolerances:

* mean/rstd: rtol 1e-5 (f32 reductions in another order);
* y: ``y = (x - mean) * a + bias`` (``a = rstd * scale``) sums the terms
  ``x*a``, ``mean*a`` and ``bias``, so its error scales with the largest of
  them, not with ``y``: where they cancel, ``y`` is tiny and a 1e-7
  relative difference in mean is many ulps of it. bf16: within one bf16
  ulp of ``max(|y|, (|x| + |mean|) * |a|, |bias|)``; f32: within 1e-5 of
  that magnitude;
* the backward: rtol 1e-4 / atol 1e-6 (the tolerance
  tests/test_folded_resnet.py holds the closed form to against autodiff),
  with an output gradient of magnitude 1e-2 so the parameter-gradient sums,
  which cancel, stay inside the absolute tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_learning_simulator_tpu.models.resnet import (
    _gn_forward,
    _plain_group_norm,
)
from distributed_learning_simulator_tpu.ops.gn_pallas import pallas_group_norm
from distributed_learning_simulator_tpu_torch.models.resnet import (
    PlainGroupNorm,
)
from distributed_learning_simulator_tpu_torch.ops import gn_cuda

SHAPES = [(3, 16, 16, 64), (2, 8, 8, 128), (2, 4, 4, 512)]
G = 32
EPS = 1e-6


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 1.5).astype(np.float32)
    scale = rng.normal(size=shape[-1]).astype(np.float32)
    bias = rng.normal(size=shape[-1]).astype(np.float32)
    return x, scale, bias


def _bf16_ulp(mag):
    mag = np.maximum(mag, 2.0**-126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _term_magnitude(x, y, mean, rstd, scale, bias):
    """The largest of the terms that sum to ``y`` (module docstring);
    ``mean``/``rstd`` are ``[B, G]``."""
    b, h, w, c = x.shape
    cpg = c // G
    a = np.repeat(rstd, cpg, axis=1)[:, None, None, :] * scale
    m = np.repeat(mean, cpg, axis=1)[:, None, None, :]
    return np.maximum(
        np.maximum(np.abs(y), (np.abs(x) + np.abs(m)) * np.abs(a)),
        np.abs(bias),
    )


def _port(x_np, scale, bias, dtype):
    x = torch.tensor(x_np).to(dtype)
    y, mean, rstd = gn_cuda.group_norm(
        x, torch.from_numpy(scale), torch.from_numpy(bias), G, EPS, dtype
    )
    return y.float().numpy(), mean.numpy(), rstd.numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_group_norm_matches_pallas_and_jnp(shape, dtype):
    x, scale, bias = _inputs(shape, seed=sum(shape))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x).astype(jdt)
    gn_cuda.reset_launch_counts()
    y_t, m_t, r_t = _port(np.asarray(xj.astype(jnp.float32)), scale, bias, tdt)
    assert gn_cuda.gn_stats.launches == gn_cuda.gn_normalize.launches == 0
    with pltpu.force_tpu_interpret_mode():
        y_p, m_p, r_p = pallas_group_norm(
            xj, jnp.asarray(scale), jnp.asarray(bias), G, EPS, jdt, folds=1
        )
    y_j, m_j, r_j = _gn_forward(
        xj, jnp.asarray(scale), jnp.asarray(bias), G, EPS, jdt
    )
    b = shape[0]
    for y_ref, m_ref, r_ref in ((y_p, m_p, r_p), (y_j, m_j, r_j)):
        np.testing.assert_allclose(
            m_t, np.asarray(m_ref).reshape(b, G), rtol=1e-5
        )
        np.testing.assert_allclose(
            r_t, np.asarray(r_ref).reshape(b, G), rtol=1e-5
        )
        y_ref = np.asarray(y_ref.astype(jnp.float32))
        mag = _term_magnitude(
            np.asarray(xj.astype(jnp.float32)), y_ref, m_t, r_t, scale, bias
        )
        tol = _bf16_ulp(mag) if dtype == "bfloat16" else 1e-5 * mag
        err = np.abs(y_t - y_ref)
        assert np.all(err <= tol), np.max(err / tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_group_norm_backward_matches_jax_vjp(shape):
    x, scale, bias = _inputs(shape, seed=7 + sum(shape))
    dy = (1e-2 * np.random.default_rng(1).normal(size=shape)).astype(
        np.float32
    )
    _, vjp = jax.vjp(
        lambda a, s, b: _plain_group_norm(a, s, b, G, EPS, jnp.float32),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
    )
    dx_j, ds_j, db_j = vjp(jnp.asarray(dy))

    norm = PlainGroupNorm(shape[-1], G, dtype=torch.float32)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    norm(xt).backward(torch.from_numpy(dy))
    for got, want in ((xt.grad, dx_j), (norm.scale.grad, ds_j),
                      (norm.bias.grad, db_j)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6
        )


def test_cpu_tensors_take_the_plain_path_only():
    x, scale, bias = _inputs((2, 4, 4, 64), seed=3)
    gn_cuda.reset_launch_counts()
    y, mean, rstd = gn_cuda.group_norm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        G, EPS, torch.float32,
    )
    m_p, r_p = gn_cuda.gn_stats_plain(torch.from_numpy(x).reshape(2, 16, 64),
                                      G, EPS)
    assert torch.equal(mean, m_p) and torch.equal(rstd, r_p)
    assert gn_cuda.gn_stats.launches == 0
    assert gn_cuda.gn_normalize.launches == 0


def test_group_count_must_divide_channels():
    with pytest.raises(ValueError, match="must divide"):
        PlainGroupNorm(48, 32)


@pytest.mark.parametrize("b,hw,c,elem", [
    (1, 1, 64, 2), (2, 1024, 64, 2), (3, 7, 96, 2), (5, 5, 64, 4),
    (25, 1024, 64, 2), (25, 256, 128, 2), (25, 64, 256, 2), (25, 16, 512, 2),
    (25, 1024, 64, 4), (200, 1024, 64, 2), (263, 4096, 64, 2),
    (264, 1024, 64, 2), (1000, 1024, 64, 2), (1000, 16, 512, 2),
    (10**6, 3, 64, 4), (1, 10**6, 2048, 2),
])
def test_stats_split_plan(b, hw, c, elem):
    """S is a power of two in 1..8 (a portable cluster) and at most HW,
    B*S a legal grid, S = 1 once B fills two CTAs per SM, and the kernel's
    HW slices (rank r: rows [r*ceil(HW/S), ...)) cover every row once."""
    s = gn_cuda.stats_split(b, hw, c, elem)
    assert s in (1, 2, 4, 8)
    assert b * s < 2**31
    assert s <= max(1, hw)
    if b >= 264:
        assert s == 1
    per = -(-hw // s)
    rows = np.zeros(hw, dtype=int)
    for rank in range(s):
        r0 = min(hw, rank * per)
        rows[r0:min(hw, r0 + per)] += 1
    assert (rows == 1).all()


def test_stats_split_at_the_main_path_shapes():
    # Stage 1 at B=25: 4 batches of 8 loads a thread on one CTA, 1 on four.
    assert gn_cuda.stats_split(25, 1024, 64, 2) == 4
    # The other stages need at most 2 batches: a cluster does not pay.
    assert gn_cuda.stats_split(25, 256, 128, 2) == 1
    assert gn_cuda.stats_split(25, 64, 256, 2) == 1
    assert gn_cuda.stats_split(25, 16, 512, 2) == 1
    assert gn_cuda.stats_split(1000, 1024, 64, 2) == 1  # eval: fills the card
    assert gn_cuda.stats_split(1, 10**6, 64, 2) == 8


H100_SMS = 132  # the card the plans are tuned on (H100 SXM)


def _normalize_cover(b, hw, c, elem, slices=None):
    """How often the normalize kernel's CTAs and threads (a numpy mirror of
    csrc/gn.cu ``gn_normalize_kernel``'s index arithmetic: one batch of
    kInFlight predicated loads a thread) touch each 16-byte vector ``[b,
    row, v]`` of ``x``, and the sample each CTA reads."""
    plan = gn_cuda.normalize_plan(b, hw, c, elem, H100_SMS, slices)
    nvec = c // (16 // elem)
    rows = 256 // nvec
    cta = np.arange(plan.grid)[:, None]
    tid = np.arange(256)[None, :]
    sample = cta // plan.slices
    row0 = np.minimum(hw, (cta % plan.slices) * plan.rows_per_slice)
    row1 = np.minimum(hw, row0 + plan.rows_per_slice)
    r, v = tid // nvec, tid % nvec
    row = np.where(r < rows, row0 + r, row1)
    hits = []
    for u in range(8):  # kInFlight
        rr = row + u * rows
        live = rr < row1
        hits.append(((sample * hw + rr) * nvec + v)[live])
    cover = np.bincount(np.concatenate(hits), minlength=b * hw * nvec)
    return plan, cover, sample[:, 0]


@pytest.mark.parametrize("b,hw,c,elem,slices", [
    # the main path: four stage shapes at B=25 and the eval batch, bf16 x
    (25, 1024, 64, 2, None), (25, 256, 128, 2, None), (25, 64, 256, 2, None),
    (25, 16, 512, 2, None), (1000, 1024, 64, 2, None),
    (25, 1024, 64, 4, None), (3, 7, 96, 2, None),
    # ragged: idle threads (kThreads % nvec != 0), a short last slice, one
    # vector a row, one row
    (2, 1000, 40, 2, None), (300, 49, 192, 4, None), (7, 33, 2048, 2, None),
    (1, 1, 64, 2, None), (4, 100, 64, 4, None),
    # forced counts (the sweep, the card tests): too few for one batch a
    # thread or more than the steps (both clipped), counts that do not
    # divide the steps
    (3, 1024, 64, 2, 1), (25, 1024, 64, 2, 7), (3, 7, 96, 2, 5),
    (2, 100, 64, 4, 3),
])
def test_normalize_plan_covers_every_vector_once(b, hw, c, elem, slices):
    plan, cover, sample = _normalize_cover(b, hw, c, elem, slices)
    assert plan.grid == b * plan.slices < 2**31
    assert (cover == 1).all()
    # CTA i reads sample i // slices only, and every CTA has rows.
    assert (sample == np.repeat(np.arange(b), plan.slices)).all()
    assert (plan.slices - 1) * plan.rows_per_slice < hw


@pytest.mark.parametrize("b,hw,c,elem", [
    (10**6, 3, 64, 4), (1, 10**6, 2048, 2), (1, 1, 64, 2), (5000, 16, 512, 2),
])
def test_normalize_plan_limits(b, hw, c, elem):
    """The grid fits a launch and no thread has more than one batch of
    kInFlight loads, at extreme shapes."""
    plan = gn_cuda.normalize_plan(b, hw, c, elem, H100_SMS)
    rows = 256 // (c // (16 // elem))
    assert 1 <= plan.slices and plan.grid == b * plan.slices < 2**31
    assert plan.rows_per_slice % rows == 0
    assert plan.rows_per_slice // rows <= 8
    assert (plan.slices - 1) * plan.rows_per_slice < hw <= (
        plan.slices * plan.rows_per_slice)


def test_normalize_plan_at_the_main_path_shapes():
    def plan(*shape, sms=H100_SMS, slices=None):
        return gn_cuda.normalize_plan(*shape, sms, slices)

    # Training batch: at most one CTA per SM (132 // 25 = 5 slices), spread
    # evenly over the row steps.
    assert plan(25, 1024, 64, 2) == (5, 224, 125)
    assert plan(25, 256, 128, 2) == (4, 64, 100)
    assert plan(25, 64, 256, 2) == (4, 16, 100)
    assert plan(25, 16, 512, 2) == (4, 4, 100)
    # Eval batch: the card is full at one slice; 4 slices keep a thread's
    # loads to one batch of 8.
    assert plan(1000, 1024, 64, 2) == (4, 256, 4000)
    # The SM count is the card's: 114 SMs (H100 PCIe) give 4 slices at B=25.
    assert plan(25, 1024, 64, 2, sms=114) == (4, 256, 100)
    # A forced count is spread the same way and clipped to the range that
    # keeps one batch a thread and no CTA without rows.
    assert plan(25, 1024, 64, 2, slices=11) == (11, 96, 275)
    assert plan(25, 16, 512, 2, slices=64) == (4, 4, 100)
    assert plan(3, 1024, 64, 2, slices=1) == (4, 256, 12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_normalize_takes_bf16_params_exactly(dtype):
    """bf16 scale/bias (bf16 local training) give the same y as their exact
    f32 copies: the kernel widens them the same way."""
    x, scale, bias = _inputs((3, 8, 8, 64), seed=11)
    xt = torch.from_numpy(x).reshape(3, 64, 64).to(dtype)
    mean, rstd = gn_cuda.gn_stats_plain(xt, G, EPS)
    s16 = torch.from_numpy(scale).to(torch.bfloat16)
    b16 = torch.from_numpy(bias).to(torch.bfloat16)
    y16 = gn_cuda.gn_normalize(xt, mean, rstd, s16, b16, dtype)
    y32 = gn_cuda.gn_normalize(xt, mean, rstd, s16.float(), b16.float(), dtype)
    assert y16.dtype == dtype and torch.equal(y16, y32)
