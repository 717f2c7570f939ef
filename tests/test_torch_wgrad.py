"""The stage-1 weight gradient (ops/wgrad_cuda.py) on the CPU, where the
wrapper takes its plain version, against the JAX package's Pallas prototype
(scripts/exp_pallas_wgrad.py ``pallas_wgrad`` in TPU interpret mode) and
against torch autograd's convolution weight gradient; and the ResNet's
``_Conv3x3Fn`` backward against autograd through a plain convolution.

Tolerances: vs the Pallas kernel, max|diff| <= 2e-5 * max|dW| (both sum
bf16 products in f32, in other orders over 25600 rows); vs autograd in f32,
rtol 1e-5 (same math, other summation order).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_learning_simulator_tpu_torch.models.resnet import (
    ResNet18,
    SameConv2d,
)
from distributed_learning_simulator_tpu_torch.ops import wgrad_cuda
from distributed_learning_simulator_tpu_torch.ops.wgrad_cuda import (
    conv3x3_wgrad,
    conv3x3_wgrad_plain,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_prototype():
    path = os.path.join(_REPO, "scripts", "exp_pallas_wgrad.py")
    spec = importlib.util.spec_from_file_location("exp_pallas_wgrad", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_matches_pallas_prototype():
    proto = _load_prototype()
    b, h, w, c = proto.B, proto.H, 2 * proto.WF, proto.C
    assert (b, h, w, c) == (25, 32, 32, 64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    gj = jnp.asarray(g, jnp.bfloat16)
    # The prototype's folded layout is a plain reshape of NHWC: folded
    # column J, block t holds unfolded column 2J + t.
    want = np.asarray(proto.pallas_wgrad(
        xj.reshape(1, b, h, w // 2, 2 * c), gj.reshape(1, b, h, w // 2, 2 * c),
        interpret=True,
    ))[0]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).bfloat16()
    got = conv3x3_wgrad(xt, gt)
    assert got.dtype == torch.float32 and got.shape == (3, 3, c, c)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2e-5 * scale


@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (3, 8, 8, 16)])
def test_plain_matches_autograd_weight_gradient(shape):
    b, h, w, c = shape
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    weight = torch.zeros(c, c, 3, 3, requires_grad=True)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1)
    (want,) = torch.autograd.grad(y, weight, g.permute(0, 3, 1, 2))
    got = conv3x3_wgrad_plain(x, g).permute(3, 2, 0, 1)  # HWIO -> OIHW
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def test_conv3x3_fn_backward_matches_plain_conv():
    """``SameConv2d(wgrad_kernel=True)`` has the same forward and the same
    input and weight gradients as the plain-autograd convolution."""
    torch.manual_seed(0)
    plain = SameConv2d(8, 8, 3, 1, torch.float32)
    fast = SameConv2d(8, 8, 3, 1, torch.float32, wgrad_kernel=True)
    fast.load_state_dict(plain.state_dict())
    x = torch.randn(3, 6, 5, 8)
    g = torch.randn(3, 6, 5, 8)
    outs = []
    for conv in (plain, fast):
        xi = x.clone().requires_grad_(True)
        y = conv(xi)
        (y * g).sum().backward()
        outs.append((y.detach(), xi.grad, conv.weight.grad))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


def test_wgrad_kernel_only_in_stage_zero():
    model = ResNet18(stage_sizes=(2, 1), width=8)
    on = [n for n, m in model.named_modules()
          if isinstance(m, SameConv2d) and m.wgrad_kernel]
    assert on == ["blocks.0.conv1", "blocks.0.conv2", "blocks.1.conv1",
                  "blocks.1.conv2"]
    with pytest.raises(ValueError, match="3x3 stride-1"):
        SameConv2d(8, 8, 3, 2, wgrad_kernel=True)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    wgrad_cuda.reset_launch_counts()
    model = ResNet18(stage_sizes=(1,), width=8, dtype=torch.float32)
    x = torch.rand(2, 8, 8, 3)
    F.cross_entropy(model(x), torch.tensor([1, 2])).backward()
    assert conv3x3_wgrad.launches == 0


LAYOUTS = (wgrad_cuda.FEW, wgrad_cuda.WALK)
PLAN_SHAPES = [
    (25, 32, 32, 64),  # ResNet-18 stage 1 at the training batch
    (4, 28, 28, 64),   # W not a multiple of the 32-position piece
    (3, 20, 32, 64),   # H not a multiple of the 16-row chunk
    (3, 8, 8, 8),
    (2, 7, 5, 136),
    (1, 1, 1, 8),
    (2, 40, 70, 16),   # three pieces per row
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_chunking_covers_every_row(shape):
    """Every K row (b, h, w) lies in exactly one run and one piece, runs
    differ by at most one row pair and never split a pair, and the grids of
    both bf16 layouts and the f32 kernel cover every client, run, tap and
    (ci, co) tile once."""
    b, h, w, c = shape
    plan = wgrad_cuda.chunking(b, h, w, c)
    covered = np.zeros(b * h, dtype=int)
    sizes = []
    for i in range(plan.n_runs):
        u0, u1 = plan.run_units(i)
        r0, r1 = plan.run_rows(i)
        covered[r0:r1] += 1
        sizes.append(u1 - u0)
        # a run starts at an even row of a sample: no pair is split
        assert r0 % h % 2 == 0
    assert (covered == 1).all()
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    cols = np.zeros(w, dtype=int)
    for p in range(plan.pieces_per_row):
        cols[p * wgrad_cuda._SEG:(p + 1) * wgrad_cuda._SEG] += 1
    assert (cols == 1).all()
    # tc and f32 grids: y = dy and each CTA computes dx = 0, 1, 2; x = run
    # (few clients, and f32 always) or the client alone (walk).
    for layout in LAYOUTS:
        grid = plan.tc_grid(layout)
        assert sorted((dy, dx) for dy in range(grid[1]) for dx in range(3)
                      ) == [(i, j) for i in range(3) for j in range(3)]
        assert grid[0] == (plan.n_runs if layout == wgrad_cuda.FEW else 1)
        assert grid[2] == plan.c_tiles**2
        assert plan.partial_floats(layout) == (
            plan.n_runs * 9 * c * c
            if layout == wgrad_cuda.FEW and plan.n_runs > 1 else 0)
    assert plan.f32_grid == (plan.n_runs, 3, plan.c_tiles**2)
    assert (plan.c_tiles - 1) * 64 < c <= plan.c_tiles * 64


def test_chunking_at_the_main_path_shape():
    plan = wgrad_cuda.chunking(25, 32, 32, 64)
    assert plan.layout == wgrad_cuda.FEW
    assert plan.tc_grid(plan.layout) == (44, 3, 1)  # 132 CTAs: one per SM
    sizes = {u1 - u0 for u0, u1 in map(plan.run_units, range(44))}
    assert sizes == {9, 10}  # row pairs: 18 or 20 rows
    assert plan.partial_floats(plan.layout) * 4 == 44 * 9 * 64 * 64 * 4
    chunk = wgrad_cuda.chunking(25, 32, 32, 64, 40)  # the flagship's chunk
    assert chunk.layout == wgrad_cuda.WALK
    assert chunk.tc_grid(chunk.layout) == (40, 3, 1)  # 120 CTAs
    assert chunk.partial_floats(chunk.layout) == 0
    assert wgrad_cuda.chunking(1, 5, 5, 8).n_runs == 2  # >= 2 pairs each
    with pytest.raises(ValueError, match="C <= 16320"):
        wgrad_cuda.chunking(1, 1, 1, 16384)


INVARIANCE_SHAPES = [(25, 32, 32, 64), (4, 28, 28, 64), (3, 7, 9, 8)]
CLIENT_COUNTS = (1, 3, 10, 20, 40, 80)


@pytest.mark.parametrize("shape", INVARIANCE_SHAPES)
def test_runs_do_not_depend_on_the_client_count(shape):
    """Every client of an N-client call is cut into the runs of a one-client
    call, whatever N is: the order its partials meet in is N's no more."""
    one = wgrad_cuda.chunking(*shape)
    for n in CLIENT_COUNTS:
        plan = wgrad_cuda.chunking(*shape, n)
        assert plan.n_runs == one.n_runs
        assert [plan.run_units(i) for i in range(plan.n_runs)] == [
            one.run_units(i) for i in range(one.n_runs)]


def _run_partial(x, g, plan, run):
    """Run ``run``'s f32 partial of one client, summed from zero (numpy
    f32: one fixed sequence of operations for the same rows)."""
    r0, r1 = plan.run_rows(run)
    _, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    taps = []
    for dy in range(3):
        for dx in range(3):
            rows = [(k // h, k % h) for k in range(r0, r1)]
            xv = np.stack([xp[s, r + dy, dx:dx + w] for s, r in rows])
            gv = np.stack([g[s, r] for s, r in rows])
            taps.append(xv.reshape(-1, c).T @ gv.reshape(-1, c))
    return np.stack(taps).astype(np.float32)


def _emulate_layouts(x, g, n):
    """dW of ``x, g [n, B, H, W, C]`` as each bf16 layout of
    ``chunking(B, H, W, C, n)`` assembles it from the same per-run partials
    (csrc/wgrad.cu): CTA by CTA over the layout's grid, ``FEW`` writing
    partials to scratch for a left-to-right reduce, the walking layouts
    adding each finished run to a running total."""
    plan = wgrad_cuda.chunking(*x.shape[1:], n)
    out = {}
    for layout in LAYOUTS:
        walk = layout != wgrad_cuda.FEW
        scratch, dw = {}, np.zeros((n, 9) + x.shape[-1:] * 2, np.float32)
        for bx in range(plan.tc_grid(layout)[0]):
            client = bx if walk else bx // plan.n_runs
            runs = range(plan.n_runs) if walk else [bx % plan.n_runs]
            for run in runs:
                p = _run_partial(x[client], g[client], plan, run)
                if not walk:
                    scratch[client, run] = p
                elif run == 0:
                    dw[client] = p
                else:
                    dw[client] = dw[client] + p
        if not walk:
            for client in range(n):
                s = scratch[client, 0]
                for run in range(1, plan.n_runs):
                    s = s + scratch[client, run]
                dw[client] = s
        out[layout] = dw
    return out


def test_left_to_right_sums_are_bitwise_the_same_for_every_n():
    """numpy float32: each client's dW, from the same per-run partials, is
    bitwise the same in both layouts and at every client count."""
    rng = np.random.default_rng(3)
    shape = (3, 7, 9, 8)  # 12 row pairs: 6 runs of 2
    n_max = max(CLIENT_COUNTS)
    x = rng.standard_normal((n_max,) + shape).astype(np.float32)
    g = rng.standard_normal((n_max,) + shape).astype(np.float32)
    want = _emulate_layouts(x, g, n_max)[wgrad_cuda.FEW]
    for n in CLIENT_COUNTS:
        for dw in _emulate_layouts(x[:n], g[:n], n).values():
            assert np.array_equal(dw, want[:n])
    plain = conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(want.reshape(plain.shape), plain.numpy(),
                               rtol=1e-5, atol=1e-5)


def _emulate_tc_kernel(x, g, plan):
    """numpy mirror of wgrad_tc_kernel's staging and tap views
    (csrc/wgrad.cu): per (run, dy), stage s holds piece s % pieces_per_row
    of row pair u0 + s // pieces_per_row, rows h0 and h0 + 1 of one sample:
    a g box of 2 x 32 positions and the x boxes of the 34 columns around
    them in rows h0 + dy - 1 and h0 + dy, zero outside the image; tap dx is
    the x view starting at column dx, 16 positions per product. Each run's
    partial is summed from zero, then the runs left to right."""
    seg, xseg = wgrad_cuda._SEG, wgrad_cuda._SEG + 2
    _, h, w, c = x.shape

    def box(t, sample, row, w0, width):
        out = np.zeros((width, c))
        if 0 <= row < h:
            for p in range(width):
                if 0 <= w0 + p < w:
                    out[p] = t[sample, row, w0 + p]
        return out

    partial = np.zeros((plan.n_runs, 3, 3, c, c), np.float64)
    for run in range(plan.n_runs):
        u0, u1 = plan.run_units(run)
        for dy in range(3):
            for step in range((u1 - u0) * plan.pieces_per_row):
                unit, piece = divmod(step, plan.pieces_per_row)
                sample, pair = divmod(u0 + unit, plan.pairs)
                h0, w0 = 2 * pair, piece * seg
                gs = np.concatenate([box(g, sample, h0 + q, w0, seg)
                                     for q in range(2)])
                xs = [box(x, sample, h0 + q + dy - 1, w0 - 1, xseg)
                      for q in range(2)]
                for q in range(2):
                    for t in range(seg // 16):
                        gv = gs[q * seg + 16 * t:q * seg + 16 * t + 16]
                        for dx in range(3):
                            xv = xs[q][16 * t + dx:16 * t + dx + 16]
                            partial[run, dy, dx] += xv.T @ gv
    total = partial[0]
    for run in range(1, plan.n_runs):
        total = total + partial[run]
    return total


@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 3, 40, 8),
                                   (2, 18, 4, 16), (3, 7, 9, 8)])
def test_tc_staging_arithmetic_matches_plain(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape)
    g = rng.standard_normal(shape)
    got = _emulate_tc_kernel(x, g, wgrad_cuda.chunking(*shape))
    want = conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got, want.double().numpy(), rtol=1e-5,
                               atol=1e-5)


def _f32_run_partial_ascending(x, g, plan, run):
    """Run ``run``'s partial of one client as the CTA-per-tap f32 kernel
    summed it: for each tap, ``acc += x_shift[k] * g[k]`` over the run's
    positions k in ascending order, in float32 from zero (numpy rounds
    the product and the sum apart, where the kernel fuses them: the same
    sequence of terms gives the same bits either way)."""
    r0, r1 = plan.run_rows(run)
    _, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((3, 3, c, c), np.float32)
    for k in range(r0, r1):
        s, r = divmod(k, h)
        for col in range(w):
            for dy in range(3):
                for dx in range(3):
                    acc[dy, dx] += np.outer(xp[s, r + dy, col + dx],
                                            g[s, r, col])
    return acc


def _emulate_f32_kernel(x, g, plan):
    """numpy mirror of wgrad_f32_kernel's staging (csrc/wgrad.cu): per
    (run, dy), step s stages piece s % pieces_per_row of row r0 + s //
    pieces_per_row: a g box of 32 positions of that row and an x box of
    the 34 columns w0 - 1 .. w0 + 32 of row hr + dy - 1, zero outside the
    image (the tensor maps' fill); tap dx at position p reads x box row
    p + dx. Each run's partial is summed from zero in float32, position by
    position, every box position included; returns the per-run partials
    and dW, the runs added left to right."""
    seg, xseg = wgrad_cuda._SEG, wgrad_cuda._SEG + 2
    _, h, w, c = x.shape

    def box(t, sample, row, w0, width):
        out = np.zeros((width, c), np.float32)
        if 0 <= row < h:
            for p in range(width):
                if 0 <= w0 + p < w:
                    out[p] = t[sample, row, w0 + p]
        return out

    partials = np.zeros((plan.n_runs, 3, 3, c, c), np.float32)
    for run in range(plan.n_runs):
        r0, r1 = plan.run_rows(run)
        for dy in range(3):
            acc = partials[run, dy]
            for step in range((r1 - r0) * plan.pieces_per_row):
                row, piece = divmod(step, plan.pieces_per_row)
                sample, hr = divmod(r0 + row, h)
                w0 = piece * seg
                gs = box(g, sample, hr, w0, seg)
                xs = box(x, sample, hr + dy - 1, w0 - 1, xseg)
                for p in range(seg):
                    for dx in range(3):
                        acc[dx] += np.outer(xs[p + dx], gs[p])
    total = partials[0]
    for run in range(1, plan.n_runs):
        total = total + partials[run]
    return partials, total


@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 3, 40, 8),
                                   (2, 18, 4, 16), (3, 7, 9, 8)])
def test_f32_staging_arithmetic_matches_plain(shape):
    """The f32 kernel's staging (the dx-shared x box, the zero fill of the
    SAME padding and the ragged row end, the run bounds) sums each run's
    positions in the order of the kernel it replaced, term for term: its
    float32 partials are bitwise those of the ascending per-tap sums, and
    dW is within float32 rounding of the plain version."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    plan = wgrad_cuda.chunking(*shape)
    partials, got = _emulate_f32_kernel(x, g, plan)
    for run in range(plan.n_runs):
        assert np.array_equal(partials[run],
                              _f32_run_partial_ascending(x, g, plan, run))
    want = conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
