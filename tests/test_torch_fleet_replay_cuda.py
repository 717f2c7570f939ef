"""A sweep fleet's training against its solo runs, op by op, on the card.

A fleet (sweep/engine.py) trains E experiments' chunks of M clients as
one program of E*M models, and the JAX package promises that each point's
history is its solo run's, bitwise. That holds only if no operation of a
training step rounds a model's values differently when more models share
its launch. CUDA libraries and kernels pick their reduction splits, tiles
and algorithms by shape, so the tests here hold a ResNet-18 training step
at a fleet's model count against the solo chunk's, on the card:

* ``test_step_rows_do_not_depend_on_the_model_count``: one step of
  ``make_chunk_train_fn`` at ``FLEET`` models, whose first rows are the
  solo chunk's models and data, gives those rows the solo chunk's bits
  (bf16: sweep_fleet (b)'s 10 against 40; f32: (a)'s 20 against 40);
* ``test_replay_names_no_op_that_moves``: the replayer. It records every
  aten and custom op of the solo chunk's forward and backward (a
  ``TorchDispatchMode``), then runs the fleet's and, as each op of the
  fleet runs, runs it again on the first experiment's slice of its inputs
  with the solo op's shapes, strides and arguments (a grouped convolution
  at the solo's group count, a view at the solo's size) and compares the
  two outputs bitwise. An op whose outputs differ rounds by the model
  count; an op whose inputs do not slice to the solo's shapes takes
  another layout at the two counts. Both are listed in the failure;
* one test per operation that rounded by the model count in bf16 before
  (the training forward's GroupNorm, read on the channel side or folded
  by the width ``M*C`` and split by the sample count ``M*B``; the GroupNorm
  backward's sums over (b, h, w)): bitwise at 10 and at 40 models.

The replayer itself is held on the CPU by tests/test_torch_fleet_replay.py.
CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one; on a GPU machine (which need not have JAX) run them
without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_fleet_replay_cuda.py -q -s
"""

from __future__ import annotations

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

pytestmark = pytest.mark.cuda

TRAIN_BATCH = 25
FLEET = 40
#: The solo chunk of each of chip_smoke.py's ``sweep_fleet`` fleets.
SOLO = {"bfloat16": 10, "float32": 20}

#: Ops that move or make data and compute nothing: bitwise at any count,
#: and their number differs where a layout does (a copy more or less).
_DATA_OPS = {
    "aten::clone", "aten::copy_", "aten::_to_copy", "aten::empty_like",
    "aten::empty.memory_format", "aten::empty_strided", "aten::new_empty",
    "aten::new_empty_strided", "aten::zeros", "aten::zeros_like",
    "aten::new_zeros", "aten::ones_like", "aten::full", "aten::fill_",
    "aten::zero_", "aten::lift_fresh", "aten::detach", "aten::alias",
    "aten::cat", "aten::stack", "aten::constant_pad_nd", "aten::flip",
    "aten::_unsafe_view", "aten::contiguous", "aten::_local_scalar_dense",
    "aten::scalar_tensor", "aten::arange",
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    # The simulator's settings on a card (simulator.py resolve_device).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


class _Step:
    """ResNet-18 at full width in ``dtype_name``, the replayed init of seed
    0, and per-row inputs made from the row's index: row r's starting
    model, batch and salt are the same in a stack of any size."""

    def __init__(self, dtype_name: str, device):
        from distributed_learning_simulator_tpu_torch.models.bridge import (
            jax_leaf_order,
        )
        from distributed_learning_simulator_tpu_torch.models.registry import (
            ParamLayout,
            get_model,
            init_params,
        )

        self.dtype = getattr(torch, dtype_name)
        self.device = device
        self.model = get_model("resnet18", dtype=self.dtype).to(device)
        params = init_params(self.model, (32, 32), seed=0)
        self.layout = ParamLayout.from_params(
            params, jax_leaf_order(self.model, (32, 32)))
        self.flat = self.layout.flatten(params).to(device)

    def apply(self, views, x):
        return torch.func.functional_call(self.model, views, (x,))

    def rows(self, m: int):
        """``(starts [m, P] f32, xs, ys, mask, perms, salts)``."""
        starts, xs, ys = [], [], []
        for r in range(m):
            gen = torch.Generator(device=self.device).manual_seed(1000 + r)
            starts.append(self.flat + 1e-3 * torch.randn(
                self.flat.shape, device=self.device, generator=gen))
            xs.append(torch.rand(TRAIN_BATCH, 32, 32, 3, device=self.device,
                                 generator=gen))
            ys.append(torch.randint(0, 10, (TRAIN_BATCH,),
                                    device=self.device, generator=gen))
        mask = torch.ones(m, TRAIN_BATCH, device=self.device)
        perms = torch.arange(TRAIN_BATCH).expand(m, 1, TRAIN_BATCH)
        return (torch.stack(starts), torch.stack(xs), torch.stack(ys), mask,
                perms, list(range(m)))

    def train(self, m: int):
        """One step of ``make_chunk_train_fn`` (SGD, momentum 0.9) for the
        first ``m`` rows: ``(params [m, P], loss [m])``."""
        from distributed_learning_simulator_tpu_torch.parallel import engine

        train = engine.make_chunk_train_fn(
            self.apply, engine.make_optimizer("sgd", 0.02, 0.9), self.layout,
            1, TRAIN_BATCH, compute_dtype=self.dtype, device=self.device)
        params, _, metrics = train(*self.rows(m))
        return params, metrics["loss"]

    def grad_fn(self):
        """The vmapped forward and backward of a training step (its
        ``grad_fn`` call), at any model count."""
        from distributed_learning_simulator_tpu_torch.parallel import engine

        loss_fn = engine.make_loss_fn(
            lambda flat, x: self.apply(self.layout.unflatten(flat), x))
        return torch.func.vmap(torch.func.grad_and_value(loss_fn,
                                                         has_aux=True))

    def grad_args(self, m: int):
        """:meth:`grad_fn`'s arguments for the first ``m`` rows."""
        starts, xs, ys, mask, _, _ = self.rows(m)
        return starts.to(self.dtype), xs, ys, mask


class _Meta:
    """A tensor of the solo's step, as its op saw it (a pytree leaf)."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.stride, self.dtype = (tuple(t.shape), t.stride(),
                                               t.dtype)

    def __repr__(self):
        return f"{list(self.shape)}"


def _meta(t):
    return _Meta(t) if isinstance(t, torch.Tensor) else t


class _Record(TorchDispatchMode):
    """Every op's name, arguments (tensors as shape, strides and dtype) and
    outputs, in order."""

    def __init__(self):
        super().__init__()
        self.calls = collections.defaultdict(list)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.calls[func].append((tree_map(_meta, args),
                                 tree_map(_meta, kwargs),
                                 tree_map(_meta, out)))
        return out


class _NoSlice(Exception):
    pass


def _slice(t: torch.Tensor, meta, ratio: int) -> torch.Tensor:
    """The first experiment's part of the fleet's ``t``, shaped as the solo
    op's tensor ``meta``: every dim the fleet holds ``ratio`` times the
    solo's is cut to its first solo-sized block (the models are the outer
    factor of a merged dim: experiment-major)."""
    shape = meta.shape
    if tuple(t.shape) == shape:
        return t
    if t.dim() != len(shape) or any(
            a != b and a != ratio * b for a, b in zip(t.shape, shape)):
        raise _NoSlice
    for d, size in enumerate(shape):
        if t.shape[d] != size:
            t = t.narrow(d, 0, size)
    return t


def _copy(part: torch.Tensor, meta: _Meta) -> torch.Tensor:
    """A copy of ``part`` with the solo tensor's strides (a broadcast dim,
    stride 0, stays one)."""
    one = [1 if st == 0 else n for n, st in zip(meta.shape, meta.stride)]
    for d, n in enumerate(one):
        part = part.narrow(d, 0, n)
    return torch.empty_strided(one, meta.stride, dtype=meta.dtype,
                               device=part.device).copy_(part).expand(
                                   meta.shape)


def _solo_like(fleet, solo, ratio: int):
    """``fleet``'s arguments for the solo op: tensors sliced and copied into
    the solo's strides, everything else the solo's (group counts, sizes)."""
    def one(f, s):
        if isinstance(f, torch.Tensor):
            if not isinstance(s, _Meta):
                raise _NoSlice
            return _copy(_slice(f, s, ratio), s)
        if isinstance(f, (list, tuple)) and isinstance(s, (list, tuple)) \
                and len(f) == len(s) and any(
                    isinstance(x, torch.Tensor) for x in f):
            return type(f)(one(a, b) for a, b in zip(f, s))
        return s

    if len(fleet) != len(solo):
        raise _NoSlice
    return [one(f, s) for f, s in zip(fleet, solo)]


class _Replay(TorchDispatchMode):
    """Runs each op of the fleet's step, then again on the first
    experiment's slice of its inputs at the solo op's shapes (the k-th call
    of an op against the solo's k-th), and keeps what differs."""

    def __init__(self, solo_calls, ratio: int):
        super().__init__()
        self.solo = solo_calls
        self.ratio = ratio
        self.seen = collections.Counter()
        self.moved, self.layouts = [], []
        self.replayed = 0

    def counts(self) -> dict:
        """``{op: (solo calls, fleet calls)}`` where the two differ."""
        return {f._schema.name: (len(self.solo.get(f, [])), n)
                for f, n in self.seen.items()
                if n != len(self.solo.get(f, []))}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        k = self.seen[func]
        self.seen[func] += 1
        solo = self.solo.get(func, [])
        if (name in _DATA_OPS or func.is_view or k >= len(solo)
                or not any(isinstance(t, torch.Tensor)
                           for t in tree_flatten((args, kwargs))[0])):
            return func(*args, **kwargs)
        s_args, s_kwargs, s_out = solo[k]
        try:
            r_args = _solo_like(list(args), list(s_args), self.ratio)
            r_kwargs = dict(zip(kwargs, _solo_like(
                list(kwargs.values()),
                [s_kwargs.get(key) for key in kwargs], self.ratio)))
        except _NoSlice:
            self.layouts.append(f"{name} #{k}: fleet "
                                f"{tree_map(_meta, args)} / solo {s_args}")
            return func(*args, **kwargs)
        writes = [i for i, a in enumerate(func._schema.arguments)
                  if a.alias_info is not None and a.alias_info.is_write]
        again = func(*r_args, **r_kwargs)
        out = func(*args, **kwargs)
        self.replayed += 1
        got = [r_args[i] for i in writes] or tree_flatten(again)[0]
        want = [args[i] for i in writes] or tree_flatten(out)[0]
        metas = [s_args[i] for i in writes] or tree_flatten(s_out)[0]
        for j, (g, w, m) in enumerate(zip(got, want, metas)):
            if not isinstance(g, torch.Tensor):
                continue
            try:
                w = _slice(w, m, self.ratio)
            except _NoSlice:
                self.layouts.append(f"{name} #{k} output {j}: fleet "
                                    f"{list(w.shape)} / solo {m}")
                continue
            if not torch.equal(g, w):
                gap = (g.double() - w.double()).abs().max().item()
                self.moved.append(
                    f"{name} #{k} output {j}: max abs diff {gap:.3e} "
                    f"(fleet {tree_map(_meta, args)}; solo {s_args})")
        return out


def replay(fn, solo_args, fleet_args, ratio: int) -> _Replay:
    """``fn`` (vmapped over the models) on the fleet's arguments, each op
    replayed against its call on the solo's (``ratio`` times fewer
    models, the fleet's first)."""
    record = _Record()
    with record:
        fn(*solo_args)
    replayer = _Replay(dict(record.calls), ratio)
    with replayer:
        fn(*fleet_args)
    return replayer


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_step_rows_do_not_depend_on_the_model_count(cuda, dtype_name):
    step = _Step(dtype_name, cuda)
    solo = SOLO[dtype_name]
    params, loss = step.train(solo)
    fleet_params, fleet_loss = step.train(FLEET)
    differ, off = [], 0
    for name, numel in zip(step.layout.names, step.layout.numels):
        if not torch.equal(params[:, off:off + numel],
                           fleet_params[:solo, off:off + numel]):
            differ.append(name)
        off += numel
    assert not differ, (f"{len(differ)} of {len(step.layout.names)} leaves "
                        f"differ, first {differ[:5]}")
    assert torch.equal(fleet_loss[:solo], loss)


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_replay_names_no_op_that_moves(cuda, dtype_name):
    solo, step = SOLO[dtype_name], _Step(dtype_name, cuda)
    found = replay(step.grad_fn(), step.grad_args(solo),
                   step.grad_args(FLEET), FLEET // solo)
    report = (f"{dtype_name} {solo} against {FLEET} models: "
              f"{found.replayed} ops replayed; "
              f"{len(found.moved)} moved: {found.moved}; "
              f"{len(found.layouts)} in another layout: {found.layouts}; "
              f"op counts (solo, fleet) that differ: {found.counts()}")
    print(report)
    assert found.replayed > 100
    assert not found.moved and not found.layouts, report


#: ResNet-18's GroupNorm shapes at the training batch: (H, W, C).
STAGES = [(32, 32, 64), (16, 16, 128), (8, 8, 256), (4, 4, 512)]


def _stage_inputs(device, hw_c, m: int, seed: int = 0):
    """``m`` models' bf16 activations as the grouped convolutions leave
    them (``[B, H, W, M, C]``), their bf16 affines and an output gradient;
    model k's values are the same for every ``m``."""
    h, w, c = hw_c
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(TRAIN_BATCH, h, w, FLEET, c, device=device,
                    generator=gen)
    x = (2 * x + 1.5).bfloat16()[:, :, :, :m].contiguous()
    scale = torch.randn(FLEET, c, device=device, generator=gen)
    bias = torch.randn(FLEET, c, device=device, generator=gen)
    dy = 1e-2 * torch.randn(TRAIN_BATCH, h, w, FLEET, c, device=device,
                            generator=gen)
    return (x, scale[:m].bfloat16(), bias[:m].bfloat16(),
            dy.bfloat16()[:, :, :, :m].contiguous())


@pytest.mark.parametrize("hw_c", STAGES)
def test_training_group_norm_is_bitwise_at_10_and_40_models(cuda, hw_c):
    """The training forward's GroupNorm (``training=True``): each of the
    first 10 models' y, mean and rstd have the same bits in a vmapped call
    of 10 models and of 40, at every stage of ResNet-18 in bf16."""
    from distributed_learning_simulator_tpu_torch.ops import gn_cuda

    def run(m):
        x, scale, bias, _ = _stage_inputs(cuda, hw_c, m)
        return torch.func.vmap(
            lambda xx, s, b: gn_cuda.group_norm_op(
                xx, s, b, 32, 1e-6, torch.bfloat16, training=True),
            in_dims=(3, 0, 0))(x, scale, bias)

    solo, fleet = run(SOLO["bfloat16"]), run(FLEET)
    for a, b in zip(solo, fleet):
        assert torch.equal(a, b[:SOLO["bfloat16"]])


@pytest.mark.parametrize("hw_c", STAGES)
def test_gn_backward_is_bitwise_at_10_and_40_models(cuda, hw_c):
    """The GroupNorm's closed-form backward (``pgn_backward``, its sums
    over (b, h, w) in ``_sum_bhw``): each of the first 10 models' dx,
    dscale and dbias have the same bits vmapped over 10 models and over
    40, at every stage of ResNet-18 in bf16."""
    from distributed_learning_simulator_tpu_torch.models.resnet import (
        pgn_backward,
    )
    from distributed_learning_simulator_tpu_torch.ops import gn_cuda

    def run(m):
        x, scale, bias, dy = _stage_inputs(cuda, hw_c, m, seed=1)

        def one(xx, s, b, d):
            _, mean, rstd = gn_cuda.group_norm_op(
                xx, s, b, 32, 1e-6, torch.bfloat16, training=True)
            return pgn_backward(xx, s, b, mean, rstd, d, 32)

        return torch.func.vmap(one, in_dims=(3, 0, 0, 3))(x, scale, bias,
                                                          dy)

    solo, fleet = run(SOLO["bfloat16"]), run(FLEET)
    for a, b in zip(solo, fleet):
        assert torch.equal(a, b[:SOLO["bfloat16"]])
