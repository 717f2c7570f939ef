"""A sweep fleet's training, aggregate and eval against its solo runs, op
by op, on the card.

A fleet (sweep/engine.py) trains E experiments' chunks of M clients as
one program of E*M models, and the JAX package promises that each point's
history is its solo run's, bitwise. That holds only if no operation of a
round rounds a model's values differently when more models share its
launch. CUDA libraries and kernels pick their reduction splits, tiles
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
  backward's sums over (b, h, w)): bitwise at 10 and at 40 models;
* ``test_eval_replay_names_no_op_that_moves``: the server eval, a fleet's
  of E models (each evaluated as its solo run evaluates it) against one
  model's, ResNet-18 at sweep_fleet's E (2 f32, 4 bf16; 1000 samples) and
  sweep_scheduled's MLP at 8, each model's loss and accuracy bitwise; one
  vmapped forward of the E models (client eval's and Shapley's form) is
  replayed beside it and printed, for the record;
* the MLP fleet of chip_smoke.py's ``sweep_scheduled`` (8 experiments of
  32 clients): its step moves in cuBLAS's batched products only (an open
  fault, ROADMAP queue 3), and each experiment's aggregate is its solo
  contraction's bits.

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
#: chip_smoke.py's ``sweep_scheduled`` fleet: bench.py's MLP sweep leg, 8
#: seeds of 32 clients (one chunk), batch 16, f32, 8x8x1 samples.
MLP = {"model": "mlp", "sample": (8, 8, 1), "batch": 16}
MLP_SOLO, MLP_EXPERIMENTS = 32, 8
#: A training step's fleets: (dtype, model keywords, solo rows, fleet rows).
STEP_FLEETS = {
    "bfloat16": ("bfloat16", {}, SOLO["bfloat16"], FLEET),
    "float32": ("float32", {}, SOLO["float32"], FLEET),
}
#: The server eval: sweep_fleet's one 1000-sample batch at its fleets' E
#: (2 f32 points, 4 bf16), and sweep_scheduled's 512 samples at E = 8.
EVAL_BATCH = 1000
EVAL_FLEETS = {
    "bfloat16": ("bfloat16", {}, EVAL_BATCH, 4),
    "float32": ("float32", {}, EVAL_BATCH, 2),
    "mlp": ("float32", MLP, 512, MLP_EXPERIMENTS),
}

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
    """A model at full width in ``dtype_name`` (ResNet-18 on 32x32x3
    inputs, or chip_smoke.py's ``sweep_scheduled`` MLP on 8x8x1), the
    replayed init of seed 0, and per-row inputs made from the row's index:
    row r's starting model, batch and salt are the same in a stack of any
    size."""

    def __init__(self, dtype_name: str, device, model: str = "resnet18",
                 sample=(32, 32, 3), batch: int = TRAIN_BATCH):
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
        self.sample, self.batch = tuple(sample), batch
        kwargs = {"dtype": self.dtype} if model.startswith("resnet") else {}
        self.model = get_model(model, input_shape=self.sample,
                               **kwargs).to(device)
        params = init_params(self.model, self.sample[:2], seed=0)
        self.layout = ParamLayout.from_params(
            params, jax_leaf_order(self.model, self.sample[:2]))
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
            xs.append(torch.rand((self.batch,) + self.sample,
                                 device=self.device, generator=gen))
            ys.append(torch.randint(0, 10, (self.batch,),
                                    device=self.device, generator=gen))
        mask = torch.ones(m, self.batch, device=self.device)
        perms = torch.arange(self.batch).expand(m, 1, self.batch)
        return (torch.stack(starts), torch.stack(xs), torch.stack(ys), mask,
                perms, list(range(m)))

    def train(self, m: int):
        """One step of ``make_chunk_train_fn`` (SGD, momentum 0.9) for the
        first ``m`` rows: ``(params [m, P], loss [m])``."""
        from distributed_learning_simulator_tpu_torch.parallel import engine

        train = engine.make_chunk_train_fn(
            self.apply, engine.make_optimizer("sgd", 0.02, 0.9), self.layout,
            1, self.batch, compute_dtype=self.dtype, device=self.device)
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

    def eval_fns(self):
        """``(solo, fleet, vmapped)``: a solo run's server eval of one flat
        ``[P]`` model (``make_eval_fn``, simulator.py), a fleet's of ``[E,
        P]`` (``make_experiment_eval_fn``, sweep/engine.py), and one
        vmapped forward of ``[E, P]`` (``make_models_eval_fn``, the form of
        client eval and the Shapley subset evals), all over the same padded
        batches."""
        from distributed_learning_simulator_tpu_torch.parallel import engine

        evaluate = engine.make_eval_fn(self.apply)

        def solo(flat, xb, yb, mb):
            return evaluate(self.layout.unflatten(flat), xb, yb, mb)

        return (solo, engine.make_experiment_eval_fn(evaluate, self.layout),
                engine.make_models_eval_fn(evaluate, self.layout))

    def eval_batches(self, n: int):
        """One padded eval batch of ``n`` samples ``(xb, yb, mb)``."""
        gen = torch.Generator(device=self.device).manual_seed(7)
        xb = torch.rand((1, n) + self.sample, device=self.device,
                        generator=gen)
        yb = torch.randint(0, 10, (1, n), device=self.device, generator=gen)
        return xb, yb, torch.ones(1, n, device=self.device)


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
    factor of a merged dim: experiment-major). Where the solo op has no
    model axis at all (a solo run's eval of its one model is not vmapped)
    and the fleet's has one of ``ratio`` models, the first model's entry
    of that axis (the first such dim that leaves a slice)."""
    shape = meta.shape
    if tuple(t.shape) == shape:
        return t
    if t.dim() == len(shape) + 1:
        for d in range(t.dim()):
            if t.shape[d] == ratio:
                try:
                    return _slice(t.select(d, 0), meta, ratio)
                except _NoSlice:
                    pass
        raise _NoSlice
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

    def __init__(self, solo_calls, ratio: int, per_model=()):
        super().__init__()
        self.solo = solo_calls
        self.ratio = ratio
        self.per_model = set(per_model)
        self.seen = collections.Counter()
        self.moved, self.layouts = [], []
        self.replayed = 0

    def other_forms(self, exact=()) -> list:
        """Ops whose call count differs from the solo's (so not replayed
        pair by pair), other than views, data ops and the ops in
        ``exact`` (whose outputs are exact at any launch)."""
        return sorted(f._schema.name for f in self.seen
                      if f._schema.name in self.counts()
                      and not f.is_view and f._schema.name not in _DATA_OPS
                      and f._schema.name not in exact)

    def counts(self) -> dict:
        """``{op: (solo calls, fleet calls)}`` where the two differ (an op
        called once per model counted once a solo call)."""
        return {f._schema.name: (len(self.solo.get(f, [])), n)
                for f, n in self.seen.items()
                if n != len(self.solo.get(f, [])) * (
                    self.ratio if f in self.per_model else 1)}

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


def replay(fn, solo_args, fleet_args, ratio: int, solo_fn=None) -> _Replay:
    """``fn`` (vmapped over the models) on the fleet's arguments, each op
    replayed against its call on the solo's (``ratio`` times fewer
    models, the fleet's first), run through ``solo_fn`` where the solo
    takes another function (a solo run's eval of one model)."""
    record, fleet = _Record(), _Record()
    with record:
        (solo_fn or fn)(*solo_args)
    with fleet:
        fn(*fleet_args)
    # Ops the fleet calls ``ratio`` times for each solo call: once a model,
    # the models one after another (the first model's calls, which pair
    # with the solo's, come first).
    per_model = [f for f, calls in fleet.calls.items()
                 if record.calls.get(f)
                 and len(calls) == ratio * len(record.calls[f])]
    replayer = _Replay(dict(record.calls), ratio, per_model)
    with replayer:
        fn(*fleet_args)
    return replayer


@pytest.mark.parametrize("dtype_name", list(STEP_FLEETS))
def test_step_rows_do_not_depend_on_the_model_count(cuda, dtype_name):
    dtype, model, solo, fleet = STEP_FLEETS[dtype_name]
    step = _Step(dtype, cuda, **model)
    params, loss = step.train(solo)
    fleet_params, fleet_loss = step.train(fleet)
    differ, off = [], 0
    for name, numel in zip(step.layout.names, step.layout.numels):
        if not torch.equal(params[:, off:off + numel],
                           fleet_params[:solo, off:off + numel]):
            differ.append(name)
        off += numel
    assert not differ, (f"{len(differ)} of {len(step.layout.names)} leaves "
                        f"differ, first {differ[:5]}")
    assert torch.equal(fleet_loss[:solo], loss)


def _report(what: str, found: _Replay) -> str:
    report = (f"{what}: {found.replayed} ops replayed; "
              f"{len(found.moved)} moved: {found.moved}; "
              f"{len(found.layouts)} in another layout: {found.layouts}; "
              f"op counts (solo, fleet) that differ: {found.counts()}")
    print(report)
    return report


@pytest.mark.parametrize("dtype_name", list(STEP_FLEETS))
def test_replay_names_no_op_that_moves(cuda, dtype_name):
    dtype, model, solo, fleet = STEP_FLEETS[dtype_name]
    step = _Step(dtype, cuda, **model)
    found = replay(step.grad_fn(), step.grad_args(solo),
                   step.grad_args(fleet), fleet // solo)
    report = _report(f"{dtype_name} step, {solo} against {fleet} models",
                     found)
    assert found.replayed > (100 if model == {} else 10)
    assert not found.moved and not found.layouts, report


@pytest.mark.parametrize("dtype_name", list(EVAL_FLEETS))
def test_eval_replay_names_no_op_that_moves(cuda, dtype_name):
    """The server eval: a fleet's of its E global models
    (``make_experiment_eval_fn``) against a solo run's eval of its one
    model (``make_eval_fn``). Each model's loss and accuracy must be its
    solo eval's bits, and no op may move, take another layout or another
    form. Printed beside it, for the record, the same for one vmapped
    forward of the E models (``make_models_eval_fn``), which the fleet
    does not take: in bf16 cuDNN's grouped convolutions at E groups round
    otherwise than at one."""
    dtype, model, n, experiments = EVAL_FLEETS[dtype_name]
    step = _Step(dtype, cuda, **model)
    solo_fn, fleet_fn, vmapped_fn = step.eval_fns()
    models = step.rows(experiments)[0]
    batches = step.eval_batches(n)
    reports = {}
    for form, fn in (("vmapped", vmapped_fn), ("fleet", fleet_fn)):
        found = replay(fn, (models[0].clone(),) + batches,
                       (models,) + batches, experiments, solo_fn=solo_fn)
        differ = eval_differences(solo_fn, fn, models, batches)
        reports[form] = (found, differ, _report(
            f"{dtype_name} eval ({form}), 1 against {experiments} models "
            f"of {n} samples; metrics that differ (fleet, solo) {differ}; "
            f"other forms {found.other_forms(EXACT_FORMS)}", found))
    found, differ, report = reports["fleet"]
    assert found.replayed > 10
    assert not differ and not found.moved and not found.layouts, report
    assert not found.other_forms(EXACT_FORMS), report


#: What a vmapped eval computes in another form than one model's, exactly:
#: cross_entropy's gather of the label's log-probability (negated) and the
#: sums of 0/1 values (correct answers, the mask). Its loss sum is not
#: exact, but pairs with nothing: the vmapped form's ``sum`` reduces ``[E,
#: n]`` where one model's reduces ``[n]``.
EXACT_FORMS = {"aten::ne", "aten::where", "aten::gather", "aten::neg",
               "aten::new_full", "aten::sum", "aten::nll_loss_forward"}


def eval_differences(solo_fn, fleet_fn, models, batches) -> dict:
    """The fleet's eval of ``models [E, P]`` against each model's solo
    eval: ``{metric of model e: (fleet, solo)}`` where they are not
    bitwise equal (each solo model a tensor of its own, as a solo run's)."""
    got = fleet_fn(models, *batches)
    differ = {}
    for e, row in enumerate(models):
        want = solo_fn(row.clone(), *batches)
        differ.update({f"{k} of model {e}": (got[k][e].item(), w.item())
                       for k, w in want.items()
                       if not torch.equal(got[k][e], w)})
    return differ


def test_mlp_fleet_step_moves_only_in_batched_products(cuda):
    """The MLP fleet's training step (32 solo rows against 256), an open
    fault (ROADMAP queue 3): the replayer names cuBLAS's batched products
    (``aten::bmm``, whose kernel follows the batch count) and nothing
    else, and no op takes another layout. Printed, the rows that move."""
    step = _Step("float32", cuda, **MLP)
    fleet = MLP_SOLO * MLP_EXPERIMENTS
    found = replay(step.grad_fn(), step.grad_args(MLP_SOLO),
                   step.grad_args(fleet), MLP_EXPERIMENTS)
    report = _report(f"mlp step, {MLP_SOLO} against {fleet} models", found)
    params, _ = step.train(MLP_SOLO)
    fleet_params, _ = step.train(fleet)
    print(f"mlp step rows bitwise the solo chunk's: "
          f"{torch.equal(params, fleet_params[:MLP_SOLO])}")
    assert found.replayed > 10 and not found.layouts, report
    assert {m.split()[0] for m in found.moved} <= {"aten::bmm"}, report


def test_mlp_fleet_aggregate_is_each_experiments_solo_contraction(cuda):
    """The round's aggregate of the MLP fleet: experiment e's weighted sum
    of its rows of the fleet's uploads (a slice of ``[E*M, P]``,
    FedAvg.make_fleet_round_fn) against the same sum of a tensor of its
    own, as a solo round contracts its chunk's uploads."""
    step = _Step("float32", cuda, **MLP)
    params, _ = step.train(MLP_SOLO * MLP_EXPERIMENTS)
    w = torch.full((MLP_SOLO,), 1.0 / MLP_SOLO, device=cuda)
    differ = {}
    for e in range(MLP_EXPERIMENTS):
        rows = params[e * MLP_SOLO:(e + 1) * MLP_SOLO]
        fleet = torch.tensordot(w, rows.float(), dims=1)
        solo = torch.tensordot(w, rows.clone().float(), dims=1)
        if not torch.equal(fleet, solo):
            differ[e] = (fleet.double() - solo.double()).abs().max().item()
    print(f"mlp aggregate, experiments whose contraction moves (max abs "
          f"diff): {differ}; row bytes {params.stride(0) * 4}")
    assert not differ


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
