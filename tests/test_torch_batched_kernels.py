"""The kernels' batched shapes on the CPU, where each wrapper takes its plain
version: the weight gradient's client axis and the GroupNorm normalize's
per-model affine, against the JAX package's Pallas kernels vmapped over the
same axis (TPU interpret mode), and the custom ops' vmap rules, which fold
the vmapped dim into one call.

Tolerances: the weight gradient against ``pallas_wgrad`` at max|diff| <=
2e-5 * max|dW| per client (tests/test_torch_wgrad.py's); GroupNorm at the
tests/test_torch_gn.py contract (mean/rstd rtol 1e-5, y within one bf16
ulp, or 1e-5 in f32, of the largest term that sums to it); the batched
plain versions against per-client/per-model calls bitwise (the same f32
ops per element) or, for the folded wgrad contraction, rtol 1e-5.

Every test here runs with functorch's per-example fallback disabled
(``engine.no_vmap_fallback``): an op without a batching rule raises.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from distributed_learning_simulator_tpu.ops.gn_pallas import pallas_group_norm
from distributed_learning_simulator_tpu_torch.models.resnet import ResNet18
from distributed_learning_simulator_tpu_torch.ops import gn_cuda, wgrad_cuda
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    no_vmap_fallback,
)
from test_torch_gn import EPS, G, _bf16_ulp, _term_magnitude
from test_torch_wgrad import _load_prototype


@pytest.fixture(autouse=True)
def _strict_vmap():
    with no_vmap_fallback():
        yield


def test_wgrad_plain_client_axis_matches_pallas():
    proto = _load_prototype()
    n, b, h, w, c = 2, proto.B, proto.H, 2 * proto.WF, proto.C
    assert (b, h, w, c) == (25, 32, 32, 64)
    rng = np.random.default_rng(10)
    x = jnp.asarray(rng.standard_normal((n, b, h, w, c)), jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((n, b, h, w, c)), jnp.bfloat16)
    want = np.asarray(proto.pallas_wgrad(
        x.reshape(n, b, h, w // 2, 2 * c), g.reshape(n, b, h, w // 2, 2 * c),
        interpret=True,
    ))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    gt = torch.from_numpy(np.array(g.astype(jnp.float32))).bfloat16()
    got = wgrad_cuda.conv3x3_wgrad(xt, gt)
    assert got.dtype == torch.float32 and got.shape == (n, 3, 3, c, c)
    for i in range(n):
        scale = np.abs(want[i]).max()
        assert np.abs(got[i].numpy() - want[i]).max() <= 2e-5 * scale


@pytest.mark.parametrize("n,layout", [(1, wgrad_cuda.FEW),
                                      (4, wgrad_cuda.FEW),
                                      (12, wgrad_cuda.WALK),
                                      (40, wgrad_cuda.WALK),
                                      (250, wgrad_cuda.WALK)])
def test_wgrad_plan_shares_the_card_between_clients(n, layout):
    """Every client keeps the one-client call's 44 runs; the clients share
    the card by the layout: one CTA per (client, run, dy) and a reduce for
    few clients, one CTA per (client, dy) walking its runs (no partials)
    from 12 clients on, in waves past 44. No run spans clients."""
    plan = wgrad_cuda.chunking(25, 32, 32, 64, n)
    assert plan.n_runs == 44 and plan.layout == layout
    walk = layout != wgrad_cuda.FEW
    assert plan.tc_grid(layout) == (n * (1 if walk else 44), 3, 1)
    assert plan.f32_grid == (n * 44, 3, 1)
    assert plan.partial_floats(layout) == (0 if walk else
                                           n * 44 * 9 * 64 * 64)
    covered = np.zeros(25 * 32, dtype=int)
    for i in range(plan.n_runs):
        r0, r1 = plan.run_rows(i)
        covered[r0:r1] += 1
    assert (covered == 1).all()


def test_wgrad_plan_must_fit_the_input():
    """A plan is the input's: its runs come from (B, H, W, C), whatever N;
    a tensor on neither the CPU nor a card is refused."""
    x = torch.zeros(3, 2, 4, 4, 8, device="meta")
    plan = wgrad_cuda.chunking(2, 4, 4, 8, 3)
    assert plan.n == 3 and plan.n_runs == 2  # 4 row pairs, 2 per run
    assert plan.run_units(1) == wgrad_cuda.chunking(2, 4, 4, 8).run_units(1)
    with pytest.raises(ValueError, match="CUDA"):
        wgrad_cuda.conv3x3_wgrad(x, x)


def _count(monkeypatch, module, name):
    calls = []
    original = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("batched", ["both", "x_only"])
def test_wgrad_op_vmap_folds_the_client_axis(monkeypatch, batched):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((3, 2, 5, 6, 8))).float()
    g = torch.from_numpy(rng.standard_normal((3, 2, 5, 6, 8))).float()
    calls = _count(monkeypatch, wgrad_cuda, "conv3x3_wgrad_plain")
    if batched == "both":
        got = torch.func.vmap(wgrad_cuda.conv3x3_wgrad_op)(x, g)
        want = [wgrad_cuda.conv3x3_wgrad(x[i], g[i]) for i in range(3)]
    else:
        got = torch.func.vmap(wgrad_cuda.conv3x3_wgrad_op,
                              in_dims=(0, None))(x, g[0])
        want = [wgrad_cuda.conv3x3_wgrad(x[i], g[0]) for i in range(3)]
    assert calls[0] == (3, 2, 5, 6, 8)  # one call for the three clients
    assert got.shape == (3, 3, 3, 8, 8)
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-5, atol=1e-5)


def _model_affine_inputs(m, b, hw, c, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m * b, hw, hw, c)) * 2 + 1.5).astype(np.float32)
    scale = rng.normal(size=(m, c)).astype(np.float32)
    bias = rng.normal(size=(m, c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32)), \
        scale, bias, jdt


@pytest.mark.parametrize("shape", [(3, 2, 8, 64), (2, 3, 4, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_group_norm_model_affine_matches_vmapped_pallas(shape, dtype):
    """``[M*B, ...]`` samples with an ``[M, C]`` affine against
    ``jax.vmap(pallas_group_norm)`` over M clients, each with its own
    scale and bias (the TPU kernels under the client vmap)."""
    m, b, hw, c = shape
    x, scale, bias, jdt = _model_affine_inputs(m, b, hw, c, dtype,
                                               seed=sum(shape))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    y_t, m_t, r_t = gn_cuda.group_norm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
        torch.from_numpy(bias), G, EPS, tdt)
    with pltpu.force_tpu_interpret_mode():
        y_p, m_p, r_p = jax.vmap(
            lambda xx, s, bb: pallas_group_norm(xx, s, bb, G, EPS, jdt,
                                                folds=1)
        )(jnp.asarray(x).astype(jdt).reshape(m, b, hw, hw, c),
          jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(m_t.numpy(),
                               np.asarray(m_p).reshape(m * b, G), rtol=1e-5)
    np.testing.assert_allclose(r_t.numpy(),
                               np.asarray(r_p).reshape(m * b, G), rtol=1e-5)
    y_ref = np.asarray(y_p.astype(jnp.float32)).reshape(m * b, hw, hw, c)
    y_got = y_t.float().numpy()
    for k in range(m):
        rows = slice(k * b, (k + 1) * b)
        mag = _term_magnitude(x[rows], y_ref[rows], m_t.numpy()[rows],
                              r_t.numpy()[rows], scale[k], bias[k])
        tol = _bf16_ulp(mag) if dtype == "bfloat16" else 1e-5 * mag
        err = np.abs(y_got[rows] - y_ref[rows])
        assert np.all(err <= tol), np.max(err / tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_normalize_model_affine_is_bitwise_per_model_calls(dtype):
    m, b, hw, c = 4, 3, 16, 64
    x, scale, bias, _ = _model_affine_inputs(m, b, 4, c, "bfloat16", seed=5)
    x = torch.from_numpy(x).reshape(m * b, hw, c).to(dtype)
    scale = torch.from_numpy(scale).to(dtype)
    bias = torch.from_numpy(bias).to(dtype)
    mean, rstd = gn_cuda.gn_stats(x, G, EPS)
    got = gn_cuda.gn_normalize(x, mean, rstd, scale, bias, dtype)
    for k in range(m):
        rows = slice(k * b, (k + 1) * b)
        want = gn_cuda.gn_normalize(x[rows], mean[rows], rstd[rows],
                                    scale[k], bias[k], dtype)
        assert torch.equal(got[rows], want)


@pytest.mark.parametrize("affine", ["per_model", "shared"])
def test_group_norm_op_vmap_folds_models(monkeypatch, affine):
    """vmap over M models' ``[B, H, W, C]`` inputs: one stats call and one
    normalize call at ``M*B`` samples, each model's rows equal to its own
    call; a shared (unbatched) affine stays ``[C]``."""
    m, b, c = 3, 2, 64
    x, scale, bias, _ = _model_affine_inputs(m, b, 4, c, "float32", seed=6)
    x = torch.from_numpy(x).reshape(m, b, 4, 4, c)
    scale, bias = torch.from_numpy(scale), torch.from_numpy(bias)
    stats = _count(monkeypatch, gn_cuda, "gn_stats_plain")
    norms = []
    original = gn_cuda.gn_normalize_plain

    def counted(x_, mean, rstd, s, bb, out_dtype):
        norms.append(tuple(s.shape))
        return original(x_, mean, rstd, s, bb, out_dtype)

    monkeypatch.setattr(gn_cuda, "gn_normalize_plain", counted)
    dims = (0, 0, 0) if affine == "per_model" else (0, None, None)
    s_in, b_in = (scale, bias) if affine == "per_model" else (scale[1],
                                                              bias[1])
    y, mean, rstd = torch.func.vmap(
        lambda xx, s, bb: gn_cuda.group_norm_op(xx, s, bb, G, EPS,
                                                torch.float32),
        in_dims=dims)(x, s_in, b_in)
    assert stats == [(m * b, 16, c)]
    assert norms == [(m, c) if affine == "per_model" else (c,)]
    for k in range(m):
        sk, bk = (scale[k], bias[k]) if affine == "per_model" else (s_in,
                                                                    b_in)
        want = gn_cuda.group_norm(x[k], sk, bk, G, EPS, torch.float32)
        for got_t, want_t in zip((y[k], mean[k], rstd[k]), want):
            assert torch.equal(got_t, want_t)


@pytest.mark.parametrize("m,c", [(3, 64), (10, 128)])
def test_training_group_norm_folds_models_at_any_width(monkeypatch, m, c):
    """The training forward's GroupNorm (``training=True``) on x as a grouped
    convolution leaves it, ``[B, H, W, M, C]`` vmapped at dim 3, in bf16:
    the models are folded into the batch (one stats call at ``[M*B, HW,
    C]``) even where ``M*C`` fits a kernel row and the eval reads them in
    place, so that a model's output takes one layout at any M; each model
    against ``jax.vmap(pallas_group_norm)`` in interpret mode at this
    file's GroupNorm tolerances."""
    b, hw = 2, 4
    x, scale, bias, jdt = _model_affine_inputs(m, b, hw, c, "bfloat16",
                                               seed=m + c)
    x5 = torch.from_numpy(x).reshape(m, b, hw, hw, c).permute(1, 2, 3, 0, 4)
    stats = _count(monkeypatch, gn_cuda, "gn_stats_plain")
    y, mean, rstd = torch.func.vmap(
        lambda xx, s, bb: gn_cuda.group_norm_op(xx, s, bb, G, EPS,
                                                torch.bfloat16,
                                                training=True),
        in_dims=(3, 0, 0))(x5.contiguous().bfloat16(),
                           torch.from_numpy(scale), torch.from_numpy(bias))
    assert stats == [(m * b, hw * hw, c)]
    with pltpu.force_tpu_interpret_mode():
        y_p, m_p, r_p = jax.vmap(
            lambda xx, s, bb: pallas_group_norm(xx, s, bb, G, EPS, jdt,
                                                folds=1)
        )(jnp.asarray(x).astype(jdt).reshape(m, b, hw, hw, c),
          jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(mean.numpy(),
                               np.asarray(m_p).reshape(m, b, G), rtol=1e-5)
    np.testing.assert_allclose(rstd.numpy(),
                               np.asarray(r_p).reshape(m, b, G), rtol=1e-5)
    y_ref = np.asarray(y_p.astype(jnp.float32))
    x_m = x.reshape(m, b, hw, hw, c)
    for k in range(m):
        mag = _term_magnitude(x_m[k], y_ref[k], mean[k].numpy(),
                              rstd[k].numpy(), scale[k], bias[k])
        err = np.abs(y[k].float().numpy() - y_ref[k])
        assert np.all(err <= _bf16_ulp(mag)), np.max(err / _bf16_ulp(mag))


def test_resnet18_chunk_forward_makes_20_stats_calls_not_80(monkeypatch):
    """At chunk 4, one vmapped ResNet-18 forward (20 GroupNorms) calls the
    plain stats 20 times, each on 4x a model's input, not 80; its training
    step calls the plain weight gradient 4 times (stage 0), each for 4
    clients."""
    model = ResNet18(width=8, dtype=torch.float32)
    params = {k: torch.stack([v.detach() + 0.01 * i for i in range(4)])
              for k, v in model.named_parameters()}
    x = torch.rand(4, 2, 8, 8, 3)
    y = torch.randint(0, 10, (4, 2))
    stats = _count(monkeypatch, gn_cuda, "gn_stats_plain")
    wgrads = _count(monkeypatch, wgrad_cuda, "conv3x3_wgrad_plain")

    def loss(p, xx, yy):
        logits = torch.func.functional_call(model, p, (xx,))
        return torch.nn.functional.cross_entropy(logits, yy)

    with torch.no_grad():
        torch.func.functional_call(
            model, {k: v[0] for k, v in params.items()}, (x[0],))
        one = [math.prod(s) for s in stats]
        stats.clear()
        torch.func.vmap(
            lambda p: torch.func.functional_call(model, p, (x[0],)))(params)
    # Each call holds the 4 models' samples (stacked on the batch, or side
    # by side on the channels where a row fits the kernels).
    assert [math.prod(s) for s in stats] == [4 * n for n in one]
    assert len(one) == 20 and wgrads == []
    stats.clear()
    torch.func.vmap(torch.func.grad(loss))(params, x, y)
    assert len(stats) == 20
    assert wgrads == [(4, 2, 8, 8, 8)] * 4


def test_the_vmap_fallback_raises():
    """Under ``no_vmap_fallback`` an op with no batching rule raises where
    functorch would otherwise loop over the batch with only a warning."""

    @torch.library.custom_op("dls_test::no_rule", mutates_args=())
    def no_rule(x: torch.Tensor) -> torch.Tensor:
        return x * 2

    with pytest.raises(RuntimeError, match="vmap fallback"):
        torch.func.vmap(no_rule)(torch.ones(3, 2))


@pytest.mark.parametrize("batched", ["both", "x_only", "w_only"])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_conv_nhwc_vmap_is_one_grouped_convolution(monkeypatch, batched,
                                                   stride, padding):
    """ops/conv.py under ``vmap(grad)`` over 3 models: one convolution for
    the forward (3 groups when the weights are stacked, the models folded
    into the batch when they are shared), per-model outputs and
    gradients at f32 rtol 1e-5 / atol 1e-6 of the largest."""
    from distributed_learning_simulator_tpu_torch.ops import conv

    gen = torch.Generator().manual_seed(12)
    m = 3
    x = torch.randn(m, 2, 7, 6, 8, generator=gen)
    w = torch.randn(m, 5, 8, 3, 3, generator=gen)
    dims = {"both": (0, 0), "x_only": (0, None), "w_only": (None, 0)}[batched]
    xs = x if dims[0] == 0 else x[0]
    ws = w if dims[1] == 0 else w[0]
    groups = []
    conv2d = torch.nn.functional.conv2d

    def counted(*args, **kwargs):
        groups.append(kwargs.get("groups", 1))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", counted)

    def loss(xx, ww):
        y = conv.conv_nhwc(xx, ww, stride, padding)
        return (y * y).sum(), y

    (gx, gw), (_, y) = torch.func.vmap(
        torch.func.grad_and_value(loss, argnums=(0, 1), has_aux=True),
        in_dims=dims)(xs, ws)
    assert groups == [m if batched == "both" else 1]
    for i in range(m):
        xi = x[i] if dims[0] == 0 else x[0]
        wi = w[i] if dims[1] == 0 else w[0]
        (gxi, gwi), (_, yi) = torch.func.grad_and_value(
            loss, argnums=(0, 1), has_aux=True)(xi, wi)
        for got, want in ((y[i], yi), (gx[i], gxi), (gw[i], gwi)):
            torch.testing.assert_close(
                got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("k,padding,groups", [(3, 1, 1), (3, 1, 4),
                                               (1, 0, 3), (3, 0, 2)])
def test_conv_dx_f32_at_stride_1_is_the_flipped_forward(monkeypatch, k,
                                                        padding, groups):
    """ops/conv.py's input gradient in f32 at stride 1 (symmetric padding)
    is a forward convolution of dy with each group's kernel flipped and
    transposed, never cuDNN's input gradient, at f32 rtol 1e-5 of
    ``convolution_backward``'s; bf16, and stride 2, keep
    ``convolution_backward``."""
    from distributed_learning_simulator_tpu_torch.ops import conv

    gen = torch.Generator().manual_seed(5)
    b, h, w, cin, cout = 2, 7, 6, 4 * groups, 3 * groups
    ho, wo = h + 2 * padding - k + 1, w + 2 * padding - k + 1
    dy = torch.randn(b, ho, wo, cout, generator=gen)
    wt = torch.randn(cout, cin // groups, k, k, generator=gen)
    backward = torch.ops.aten.convolution_backward
    calls = []

    def counted(*args):
        calls.append(args[0].dtype)
        return backward(*args)

    def want_of(dy, wt, stride, pad, in_h, in_w):
        inp = dy.new_empty((b, cin, in_h, in_w))
        return backward(dy.permute(0, 3, 1, 2), inp, wt, None, [stride] * 2,
                        [pad] * 2, [1, 1], False, [0, 0], groups,
                        [True, False, False])[0].permute(0, 2, 3, 1)

    monkeypatch.setattr(torch.ops.aten, "convolution_backward", counted)
    got = conv.conv_nhwc_dx_op(dy, wt, h, w, 1, [padding] * 4, groups)
    assert calls == []
    want = want_of(dy, wt, 1, padding, h, w)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    got16 = conv.conv_nhwc_dx_op(dy.bfloat16(), wt.bfloat16(), h, w, 1,
                                 [padding] * 4, groups)
    assert calls == [torch.bfloat16]
    assert torch.equal(got16, want_of(dy.bfloat16(), wt.bfloat16(), 1,
                                      padding, h, w))
    dy2 = dy[:, :(ho + 1) // 2, :(wo + 1) // 2].contiguous()
    conv.conv_nhwc_dx_op(dy2, wt, h, w, 2, [padding] * 4, groups)
    assert calls == [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("affine", ["per_model", "shared"])
def test_stats_and_normalize_ops_vmap_fold_models(monkeypatch, affine):
    """``dls::gn_stats`` and ``dls::gn_normalize`` on their own under vmap:
    one plain call each at ``M*B`` samples, each model's rows equal to its
    own call."""
    m, b, c = 3, 2, 64
    x, scale, bias, _ = _model_affine_inputs(m, b, 4, c, "float32", seed=7)
    x = torch.from_numpy(x).reshape(m, b, 16, c)
    scale, bias = torch.from_numpy(scale), torch.from_numpy(bias)
    stats = _count(monkeypatch, gn_cuda, "gn_stats_plain")
    norms = _count(monkeypatch, gn_cuda, "gn_normalize_plain")
    mean, rstd = torch.func.vmap(
        lambda xx: gn_cuda.gn_stats_op(xx, G, EPS))(x)
    dims = (0, 0, 0, 0, 0) if affine == "per_model" else (0, 0, 0, None,
                                                          None)
    s_in, b_in = (scale, bias) if affine == "per_model" else (scale[0],
                                                              bias[0])
    y = torch.func.vmap(
        lambda xx, mm, rr, ss, bb: gn_cuda.gn_normalize_op(
            xx, mm, rr, ss, bb, torch.float32), in_dims=dims)(
        x, mean, rstd, s_in, b_in)
    assert stats == [(m * b, 16, c)] and norms == [(m * b, 16, c)]
    for k in range(m):
        sk, bk = (scale[k], bias[k]) if affine == "per_model" else (s_in,
                                                                    b_in)
        mk, rk = gn_cuda.gn_stats(x[k], G, EPS)
        assert torch.equal(mean[k], mk) and torch.equal(rstd[k], rk)
        assert torch.equal(y[k], gn_cuda.gn_normalize(
            x[k], mk, rk, sk, bk, torch.float32))


@pytest.mark.parametrize("m,c,wide", [(3, 64, True), (40, 64, False)])
def test_group_norm_op_reads_models_on_the_channel_side(monkeypatch, m, c,
                                                        wide):
    """x as a grouped convolution leaves it, ``[B, H, W, M, C]`` vmapped at
    dim 3: while ``M*C`` fits a kernel row (2048 bf16 channels) the op
    reads it in place as ``[B, HW, M*C]`` with M*G groups and returns the
    same layout; wider, it folds the models into the batch. Either way each
    model's statistics match its own call at rtol 1e-5 (the sums run in
    another order) and its bf16 y within one bf16 ulp of max(|y|, 1)."""
    b = 2
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(b, 4, 4, m, c, generator=gen).bfloat16()
    scale = torch.randn(m, c, generator=gen)
    bias = torch.randn(m, c, generator=gen)
    stats = _count(monkeypatch, gn_cuda, "gn_stats_plain")
    y, mean, rstd = torch.func.vmap(
        lambda xx, s, bb: gn_cuda.group_norm_op(xx, s, bb, G, EPS,
                                                torch.bfloat16),
        in_dims=(3, 0, 0))(x, scale, bias)
    assert stats == ([(b, 16, m * c)] if wide else [(m * b, 16, c)])
    for k in range(m):
        want = gn_cuda.group_norm(x[:, :, :, k].contiguous(), scale[k],
                                  bias[k], G, EPS, torch.bfloat16)
        torch.testing.assert_close(mean[k], want[1], rtol=1e-5, atol=0)
        torch.testing.assert_close(rstd[k], want[2], rtol=1e-5, atol=0)
        diff = (y[k].float() - want[0].float()).abs()
        assert (diff <= 2.0**-7 * want[0].float().abs().clamp(min=1)).all()
