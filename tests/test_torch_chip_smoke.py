"""chip_smoke.py on the CPU: its standard-library schema check gives
jsonschema's verdicts on the metrics records a port run writes (valid, and
each of several broken copies invalid), and the script refuses to run,
printing no result, without a GPU or outside the repository."""

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jsonschema
import pytest
import torch

import chip_smoke
from distributed_learning_simulator_tpu_torch.config import ExperimentConfig
from distributed_learning_simulator_tpu_torch.simulator import run_simulation

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def schema():
    with open(os.path.join(_REPO, chip_smoke.SCHEMA)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    cfg = ExperimentConfig(
        dataset_name="synthetic", model_name="mlp", worker_number=4,
        round=2, batch_size=32, n_train=256, n_test=64, device="cpu",
        participation_fraction=0.5, log_level="WARNING",
        log_root=str(tmp_path_factory.mktemp("log")))
    return run_simulation(cfg)["history"]


def _broken(rec):
    """Copies of ``rec`` that the schema must reject."""
    out = []
    for field, value in (("round", "zero"), ("test_loss", None),
                         ("round", -1), ("round_seconds", "fast")):
        bad = copy.deepcopy(rec)
        bad[field] = value
        out.append(bad)
    missing = copy.deepcopy(rec)
    del missing["test_accuracy"]
    out.append(missing)
    return out


def test_schema_errors_agree_with_jsonschema(schema, records):
    validator = jsonschema.Draft7Validator(schema)
    for rec in records:
        assert validator.is_valid(rec)
        assert chip_smoke.schema_errors(rec, schema) == []
        for bad in _broken(rec):
            assert not validator.is_valid(bad)
            assert chip_smoke.schema_errors(bad, schema), bad


def test_refuses_without_a_gpu_or_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), alone)
    for cwd, script in ((_REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run(
            [sys.executable, script, "--out", str(tmp_path / "out")],
            cwd=cwd, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_chunk_steps_bounds_the_batched_forwards():
    """The gate that a path trained a chunk at a time: at most rounds x
    epochs x steps x chunks training forwards (the flagship's paths: 2
    rounds x 4 steps x 2 chunks of 40 for 50 clients; the headline: 2 x 2
    steps x 4 chunks of 250), where one client at a time would run about
    chunk times more."""
    paths = chip_smoke.path_configs(50, 5000, 2000, "WARNING")
    assert {n: chip_smoke.chunk_steps(c, 5000) for n, c in paths.items()} \
        == {"fed": 16, "sign_SGD": 16, "fed_quant": 16}
    headline = chip_smoke.headline_config(1000, None, None, 10000)
    assert chip_smoke.chunk_steps(headline, 50000) == 2 * 2 * 4
    assert chip_smoke.FLAGSHIP_CHUNK == paths["fed"].client_chunk_size


@pytest.mark.parametrize("arm", chip_smoke.LAYOUT_ARMS)
def test_layout_arms_compute_the_same_function(monkeypatch, arm):
    """Each arm of chip_smoke's layout A/B swaps only vmap rules: through a
    stride-2 SAME convolution (padded inside the op) and a GroupNorm whose
    models fit the channel side, a vmapped grad (the training forward) and
    a vmapped eval forward give every model's own loss, gradients and
    output, at f32 rtol 1e-5 / atol 1e-6 of the largest; after the arm the
    port's rules are back (one grouped convolution, and the eval forward's
    GroupNorm read on the channel side)."""
    from distributed_learning_simulator_tpu_torch.models import resnet
    from distributed_learning_simulator_tpu_torch.ops import gn_cuda

    gen = torch.Generator().manual_seed(5)
    m = 3
    x = torch.randn(m, 2, 8, 8, 16, generator=gen)
    w = torch.randn(m, 64, 16, 3, 3, generator=gen) * 0.1
    scale = torch.randn(m, 64, generator=gen)

    def loss(ww, ss, xx):
        y = resnet.same_conv(xx, ww, 2)
        y = resnet._PlainGroupNormFn.apply(y, ss, torch.zeros_like(ss), 32,
                                           1e-6, torch.float32)[0]
        return (y * y.tanh()).sum()

    def forward(ww, ss, xx):
        return gn_cuda.group_norm_op(resnet.same_conv(xx, ww, 2), ss, ss, 32,
                                     1e-6, torch.float32)[0]

    step = torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1)))
    with chip_smoke.layout_arm(torch, arm):
        (gw, gs), value = step(w, scale, x)
        with torch.no_grad():
            y = torch.func.vmap(forward)(w, scale, x)
    for k in range(m):
        (gwk, gsk), vk = torch.func.grad_and_value(loss, argnums=(0, 1))(
            w[k], scale[k], x[k])
        with torch.no_grad():
            yk = forward(w[k], scale[k], x[k])
        for got, want in ((value[k], vk), (gw[k], gwk), (gs[k], gsk),
                          (y[k], yk)):
            torch.testing.assert_close(
                got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())
    groups, stats = [], []
    conv2d, plain = torch.nn.functional.conv2d, gn_cuda.gn_stats_plain
    monkeypatch.setattr(torch.nn.functional, "conv2d", lambda *a, **k: (
        groups.append(k.get("groups", 1)) or conv2d(*a, **k)))
    monkeypatch.setattr(gn_cuda, "gn_stats_plain", lambda xx, g, eps: (
        stats.append(tuple(xx.shape)) or plain(xx, g, eps)))
    with torch.no_grad():
        torch.func.vmap(forward)(w, scale, x)
    assert groups == [m] and stats == [(2, 16, m * 64)]


def test_robustness_phase_configs(tmp_path):
    """The robustness phases' configurations validate, and are cut as the
    chip run's gates assume: FedAdam + adamw + dropout + quorum with the
    last two checkpoints kept at 50 clients; FedAvgM + corrupt_nan under
    the plain mean at 20; the crash-resume run at 20 clients, chunk 10,
    with no checkpoint cadence of its own."""
    cfgs = chip_smoke.robustness_configs(str(tmp_path))
    for cfg in cfgs.values():
        cfg.validate()
        assert (cfg.model_name, cfg.round, cfg.max_shard_size) == (
            "resnet18", 3, 100)
    fedopt, reject, crash = (cfgs[k] for k in (
        "fedopt_dropout", "fedavgm_reject", "crash_resume"))
    assert (fedopt.worker_number, fedopt.client_chunk_size,
            fedopt.min_survivors, fedopt.checkpoint_keep_last) == (
        50, 40, 30, 2)
    assert (fedopt.optimizer_name, fedopt.server_optimizer_name,
            fedopt.failure_mode) == ("adamw", "adam", "dropout")
    assert (reject.server_momentum, reject.failure_mode,
            reject.aggregation) == (0.9, "corrupt_nan", "mean")
    assert (crash.worker_number, crash.client_chunk_size,
            crash.min_survivors, crash.checkpoint_dir) == (20, 10, 12, None)
    assert chip_smoke.chunk_steps(fedopt, 5000) == 3 * 4 * 2


def test_oom_phase_config_and_param_count():
    """``oom_hint``'s round trains its 1000 clients as one chunk (what the
    card cannot hold), and ``model_param_count`` (the module's parameters)
    is the flat layout's length, which the expected hint text is built
    from."""
    from distributed_learning_simulator_tpu_torch.models.bridge import (
        jax_leaf_order,
    )
    from distributed_learning_simulator_tpu_torch.models.registry import (
        ParamLayout,
        get_model,
        init_params,
    )

    cfg = chip_smoke.oom_config()
    cfg.validate()
    assert cfg.cohort_size() == cfg.client_chunk_size == 1000
    assert (cfg.model_name, cfg.local_compute_dtype, cfg.round) == (
        "resnet18", "bfloat16", 1)
    small = dict(stage_sizes=[1], width=8)
    model = get_model("resnet18", num_classes=10, input_shape=(32, 32, 3),
                      **small)
    layout = ParamLayout.from_params(init_params(model, (32, 32), seed=0),
                                     jax_leaf_order(model, (32, 32)))
    assert chip_smoke.model_param_count(
        dataclasses.replace(cfg, model_args=small)) == sum(layout.numels)


def test_stream_phase_configs():
    """The streamed phases' configurations validate as they run: the
    flagship's hashed cohort of 40 is exactly one chunk, sign_SGD's cohort
    is its whole population, the stream leg's cohort is 256 at every
    population, and the churn leg's join rate is the growth formula's."""
    flagship = chip_smoke.stream_flagship_configs()
    fed, sign = flagship["fed"], flagship["sign_SGD"]
    for cfg in (fed, sign):
        for residency in ("resident", "streamed"):
            dataclasses.replace(cfg, client_residency=residency).validate()
    assert fed.cohort_size() == fed.client_chunk_size == 40
    assert (fed.worker_number, fed.participation_sampler, fed.round) == (
        400, "hashed", 3)
    assert sign.cohort_size() == sign.worker_number == 50
    assert sign.momentum == 0.9 and sign.local_compute_dtype == "float32"
    for n, sampler in chip_smoke.STREAM_POPULATIONS:
        cfg = chip_smoke.stream_population_config(n, sampler).validate()
        assert cfg.cohort_size() == 256 and cfg.batch_size == 16
        assert cfg.client_residency == "streamed"
    churn = chip_smoke.churn_configs()
    for cfg in churn.values():
        cfg.validate()
        assert cfg.cohort_size() == cfg.client_chunk_size == 250
        assert cfg.round == 5
    assert churn["dynamic"].join_rate == round(9 * 1000 / 5) == 1800
    assert churn["static"].population == "static"


def test_multihost_stream_phase_config(tmp_path):
    """``multihost_stream``'s configuration validates with the ranks'
    flags: a hashed cohort of 20 of 40 clients, so each rank's block of 10
    is one chunk, persistent momentum (both exchange directions) on f32
    local state, ResNet-18 at the flagship's partition."""
    cfg = chip_smoke.multihost_stream_config(str(tmp_path))
    ranked = dataclasses.replace(
        cfg, multihost=True, mesh_devices=2, num_processes=2, process_id=0,
        coordinator_address="127.0.0.1:1", checkpoint_dir=str(tmp_path),
        checkpoint_every=1)
    ranked.validate()
    cfg.validate()
    assert cfg.cohort_size() == 20 and cfg.cohort_size() // 2 == (
        cfg.client_chunk_size)
    assert (cfg.momentum, cfg.reset_client_optimizer,
            cfg.local_compute_dtype, cfg.participation_sampler) == (
        0.9, False, "float32", "hashed")
    assert (cfg.model_name, cfg.max_shard_size, cfg.dirichlet_alpha,
            cfg.batch_size, cfg.round) == ("resnet18", 100, 0.1, 25, 2)
    flags = chip_smoke.cli_flags(cfg)
    assert "--client_residency" in flags and "--span_trace" in flags


def test_sweep_phase_configs():
    """The sweep phases' configurations validate as they run: both
    ``sweep_fleet`` fleets resolve to the ``vmapped`` strategy with 40
    models a chunk program (2 experiments x chunk 20, and 4 x 10 with the
    flagship's lr as the fleet's base), ``sweep_scheduled`` is bench.py's
    ``_sweep_leg`` shape, and ``round_batch``'s 20 clients are one chunk."""
    from distributed_learning_simulator_tpu_torch.sweep import SweepSpec

    fleets = chip_smoke.sweep_fleet_configs()
    for name, cfg in fleets.items():
        spec = SweepSpec.from_config(cfg)
        assert spec.resolve_strategy() == "vmapped", name
        assert cfg.worker_number == cfg.cohort_size() == 20
        assert len(spec.points) * cfg.client_chunk_size == 40
        assert (cfg.model_name, cfg.round, cfg.max_shard_size,
                cfg.dirichlet_alpha, cfg.batch_size, cfg.momentum) == (
            "resnet18", 2, 100, 0.1, 25, 0.9)
        assert -(-cfg.n_test // cfg.eval_batch_size) == 1
    f32, bf16 = fleets["f32"], fleets["bf16"]
    assert (f32.local_compute_dtype, f32.model_args) == (
        "float32", {"dtype": "float32"})
    assert bf16.local_compute_dtype == "bfloat16"
    points = SweepSpec.from_config(bf16).points
    assert [(p.seed, p.learning_rate) for p in points] == [
        (0, 0.02), (1, 0.02), (0, 0.01), (1, 0.01)]
    assert points[0].config.learning_rate == bf16.learning_rate
    mlp = chip_smoke.sweep_mlp_config().validate()
    assert (mlp.model_name, mlp.worker_number, mlp.round, mlp.n_train,
            mlp.batch_size) == ("mlp", 32, 6, 1024, 16)
    rb = chip_smoke.path_configs(chip_smoke.ROUND_BATCH_CLIENTS, 2000, 2000,
                                 "WARNING")
    for cfg in rb.values():
        assert cfg.cohort_size() == 20 <= cfg.client_chunk_size


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN5_anon15wgrad_tc_kernelILi4ELb0EEEv14CUtensorMap_stS1_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN5_anon15wgrad_tc_kernelILi4ELb0EEEv14CUtensorMap_stS1_Pfiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 217 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_ZN5_anon16wgrad_f32_kernelE14CUtensorMap_stS0_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN5_anon16wgrad_f32_kernelE14CUtensorMap_stS0_Pfiiiii
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 94 registers, used 1 barriers, 64 bytes smem
"""


def test_ptxas_usage_reads_one_kernels_registers_and_spills():
    """Phase 1c's reading of nvcc's ``-Xptxas -v`` lines: the named
    kernel's own registers and spill bytes, never a neighbour's, and None
    for a kernel this build did not compile (a cached library)."""
    assert chip_smoke.ptxas_usage(PTXAS_LOG, "wgrad_f32_kernel") == {
        "stack_bytes": 8, "spill_store_bytes": 16, "spill_load_bytes": 12,
        "registers": 94}
    assert chip_smoke.ptxas_usage(PTXAS_LOG, "wgrad_tc_kernel") == {
        "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
        "registers": 217}
    assert chip_smoke.ptxas_usage("", "wgrad_f32_kernel") is None


@pytest.mark.parametrize("shape", [(1, 1, 1, 8), (2, 2, 3, 8),
                                   (3, 7, 5, 16), (25, 32, 32, 64)])
def test_wgrad_ops_counts_each_taps_valid_positions(shape):
    """The wgrad bound's operations: two for each (tap, position) whose
    input lies inside the image, per channel pair; the SAME padding's
    zeros are no work of the function."""
    b, h, w, c = shape
    valid = sum(min(h, h - (dy - 1)) - max(0, -(dy - 1))
                for dy in range(3)) * sum(
                    min(w, w - (dx - 1)) - max(0, -(dx - 1))
                    for dx in range(3))
    assert chip_smoke.wgrad_ops(2, b, h, w, c) == 2 * 2 * b * valid * c * c
    assert chip_smoke.wgrad_ops(1, b, h, w, c) <= 2 * 9 * b * h * w * c * c


def _sass(f32_ops: str) -> str:
    return (
        "Function : _ZN5_anon15wgrad_tc_kernelILi4ELb0EEEv14CUtensorMap_st\n"
        "  HGMMA.64x192x16.F32.BF16 R24, gdesc[UR4], RZ ;\n"
        "Function : _ZN5_anon15wgrad_tc_kernelILi8ELb1EEEv14CUtensorMap_st\n"
        "  HGMMA.64x192x16.F32.BF16 R24, gdesc[UR4], RZ ;\n"
        "Function : _ZN5_anon16wgrad_f32_kernelE14CUtensorMap_stS0_Pfiiiii\n"
        f"  FFMA R0, R1, R2, R0 ;\n{f32_ops}")


@pytest.mark.parametrize("f32_ops, log, verdict", [
    ("", PTXAS_LOG.replace("8 bytes stack frame, 16 bytes spill stores, "
                           "12 bytes spill loads",
                           "0 bytes stack frame, 0 bytes spill stores, "
                           "0 bytes spill loads"), "pass"),
    ("", "(reused build/libwgrad.so)", "pass"),
    ("", PTXAS_LOG, "spills"),
    ("  HMMA.1684.F32.TF32 R0, R4, R8, R0 ;\n", "", "tensor-core"),
    ("  HGMMA.64x64x8.F32.TF32 R0, gdesc[UR4], RZ ;\n", "", "tensor-core"),
])
def test_wgrad_sass_phase_refuses_tf32_and_spills(monkeypatch, capsys,
                                                   f32_ops, log, verdict):
    """Phase 1c fails if the f32 kernel's SASS holds a tensor-core product
    (a TF32 HMMA or HGMMA) or the build log shows it spilling, and passes
    a clean kernel, built in this run or reused."""
    fake = type("Build", (), {
        "cuda_tool": staticmethod(lambda name: name),
        "LIB_PATHS": {"wgrad": "libwgrad.so"},
        "BUILD_LOGS": {"wgrad": log}})
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: (
        subprocess.CompletedProcess(a[0], 0, _sass(f32_ops), "")))
    if verdict == "pass":
        out = chip_smoke.check_wgrad_sass(fake)
        assert out["counts"]["wgrad_f32_kernel"] == {"HGMMA": 0, "HMMA": 0}
        return
    with pytest.raises(SystemExit):
        chip_smoke.check_wgrad_sass(fake)
    err = capsys.readouterr().err
    assert ("spills" in err) if verdict == "spills" else (
        "tensor-core" in err)
