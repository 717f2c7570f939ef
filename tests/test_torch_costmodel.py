"""The port's cost model (telemetry/costmodel.py, topologies.py) and its
torch.profiler trace reader (utils/tracing.py) against the JAX package's.

* ``ledger_totals``, ``predict_round`` and ``costmodel_record`` equal JAX's
  on the same ledger, with the same ``Topology`` values passed as objects
  (each package's own class) and the same efficiencies.
* The table: the H100 SXM rows (datasheet peaks), the CPU row, no TPU row.
* The Chrome-trace reader on a small synthetic torch.profiler trace that
  the test writes: kernels tied to their launching operators through the
  runtime calls' correlation ids, an operator's input bytes split over its
  kernels, FLOPs from the nearest operator the profiler gave them (the
  session's FLOPs file), categories by ``classify_op``.
* On the CPU: a ``profile_dir`` session writes a trace with no device op,
  so both packages degrade to ``costmodel: None`` with the JAX warning; a
  synthetic device trace gives the last record a valid v6 ``costmodel``.
"""

import dataclasses
import gzip
import json
import logging
import os

import jsonschema
import pytest

from distributed_learning_simulator_tpu.config import (
    ExperimentConfig as JaxConfig,
)
from distributed_learning_simulator_tpu.simulator import (
    run_simulation as jax_run,
)
from distributed_learning_simulator_tpu.telemetry import (
    costmodel as jcost,
)
from distributed_learning_simulator_tpu.telemetry import (
    topologies as jtopo,
)
from distributed_learning_simulator_tpu_torch.simulator import run_simulation
from distributed_learning_simulator_tpu_torch.telemetry import (
    costmodel,
    topologies,
)
from distributed_learning_simulator_tpu_torch.utils import tracing
from torch_runs import port_config

GIB = 2**30
SCHEMA = os.path.join(os.path.dirname(__file__), "data",
                      "metrics_record.schema.json")
LEDGER = {
    "matmul_conv": {"bytes_gb": 3.5, "flops_g": 900.0, "device_ms": 40.0,
                    "op_count": 120},
    "group_norm": {"bytes_gb": 1.25, "flops_g": 0.0, "device_ms": 2.0,
                   "op_count": 80},
    "elementwise": {"bytes_gb": 7.0, "flops_g": 1.0, "device_ms": 30.0,
                    "op_count": 900},
    "collective": {"bytes_gb": 0.5, "flops_g": 0.0, "device_ms": 1.0,
                   "op_count": 4},
}
SPECS = (("toy-1", 1, 2.0, 1.0 * GIB / 1e9, 0.0, 3.0),
         ("toy-4", 4, 2.0, 1.0 * GIB / 1e9, 1.0 * GIB / 1e9, 2.5),
         ("h100ish-8", 8, 989.0, 3350.0, 900.0, 0.0))


def _tables():
    return ({s[0]: topologies.Topology(*s) for s in SPECS},
            {s[0]: jtopo.Topology(*s) for s in SPECS})


@pytest.mark.parametrize("trace_rounds", [1, 3])
@pytest.mark.parametrize("eff", [{"mxu": 1.0, "hbm": 1.0, "ici": 1.0},
                                 {"mxu": 0.3, "hbm": 0.6, "ici": 0.5}])
def test_predictions_and_records_equal_jax(trace_rounds, eff):
    ptab, jtab = _tables()
    assert costmodel.ledger_totals(LEDGER) == jcost.ledger_totals(LEDGER)
    assert costmodel.ledger_totals({}) == jcost.ledger_totals({})
    for name in ptab:
        for pb in (None, 44_700_000):
            assert costmodel.predict_round(
                LEDGER, ptab[name], trace_rounds=trace_rounds,
                efficiency=eff, param_bytes=pb) == jcost.predict_round(
                LEDGER, jtab[name], trace_rounds=trace_rounds,
                efficiency=eff, param_bytes=pb)
    for measured in (None, 123.4):
        kw = dict(trace_rounds=trace_rounds, anchor="toy-4",
                  measured_ms=measured, efficiency=eff,
                  param_bytes=44_700_000, run_rounds=150)
        assert costmodel.costmodel_record(
            LEDGER, topologies=ptab, **kw) == jcost.costmodel_record(
            LEDGER, topologies=jtab, **kw)
    with pytest.raises(ValueError, match="trace_rounds"):
        costmodel.predict_round(LEDGER, ptab["toy-1"], trace_rounds=0)


def test_topology_table():
    table = topologies.TOPOLOGIES
    assert set(table) == {"cpu-host", "h100-sxm-1", "h100-sxm-4",
                          "h100-sxm-8"}
    for chips in (1, 4, 8):
        t = table[f"h100-sxm-{chips}"]
        assert (t.chips, t.peak_tflops, t.hbm_gbps) == (chips, 989.0, 3350.0)
        assert t.ici_gbps == (0.0 if chips == 1 else 900.0)
        assert t.usd_per_chip_hour == 0.0  # unpriced: no cited list price
    assert costmodel.DEFAULT_ANCHOR == "h100-sxm-1"
    for value in costmodel.DEFAULT_EFFICIENCY.values():
        assert 0.0 < value <= 1.0
    with pytest.raises(ValueError, match="h100-sxm-1") as err:
        topologies.get_topology("v5e-1")
    assert "(add entries in telemetry/topologies.py)" in str(err.value)
    record = costmodel.costmodel_record(LEDGER, measured_ms=50.0)
    assert record["anchor_topology"] == "h100-sxm-1"
    with open(SCHEMA) as f:
        schema = json.load(f)
    jsonschema.validate({"round": 0, "test_accuracy": 0.1, "test_loss": 2.0,
                         "mean_client_loss": 2.0, "round_seconds": 0.1,
                         "schema_version": 6, "costmodel": record}, schema)


# ---- the trace reader ----------------------------------------------------------


def _op(name, ts, dur, ext, dims, types, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur,
            "args": {"External id": ext, "Input Dims": dims,
                     "Input type": types}}


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 7,
            "tid": tid, "ts": ts, "dur": 1.0, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _write(tmp_path, events, flops=None):
    base = os.path.join(str(tmp_path), "20260101_000000_1")
    with gzip.open(base + ".pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    if flops is not None:
        with open(base + ".pt.flops.json", "w") as f:
            json.dump(flops, f)


def _synthetic(tmp_path):
    """A GroupNorm (two kernels, the second a PDL launch), a convolution
    whose FLOPs sit on the outer aten::conv2d and whose kernel the inner
    cudnn op launches, the wgrad custom op, an elementwise add, a copy and
    a uint8 decode, the backward's kernels on the autograd thread."""
    gn_in = [[25, 1024, 64], [64], [64]]
    events = [
        _op("dls::group_norm", 0, 20, 1, gn_in, ["c10::BFloat16"] * 3),
        _launch(2, 101), _kernel("gn_stats_kernel", 30, 5, 101),
        _launch(9, 102, name="cudaLaunchKernelExC"),
        _kernel("gn_normalize_kernel", 36, 4, 102),
        _op("aten::conv2d", 30, 40, 2, [[8, 3, 32, 32], [16, 3, 3, 3]],
            ["float", "float"]),
        _op("aten::convolution", 31, 38, 3, [[8, 3, 32, 32], [16, 3, 3, 3]],
            ["float", "float"]),
        _op("aten::cudnn_convolution", 32, 30, 4,
            [[8, 3, 32, 32], [16, 3, 3, 3]], ["float", "float"]),
        _launch(40, 103), _kernel("sm90_xmma_fprop_implicit_gemm", 50, 9,
                                  103),
        _op("aten::add", 80, 5, 5, [[8, 16], [8, 16], []],
            ["float", "float", "Scalar"]),
        _launch(81, 104), _kernel("vectorized_elementwise_kernel", 90, 1,
                                  104),
        _op("aten::copy_", 90, 5, 6, [[1000], [1000], []],
            ["float", "float", "bool"]),
        _launch(91, 105, name="cudaMemcpyAsync"),
        _kernel("Memcpy DtoD (Device -> Device)", 95, 2, 105,
                cat="gpu_memcpy"),
        _op("aten::to", 100, 5, 7, [[10, 3072], [], [], [], []],
            ["unsigned char", "Scalar", "", "", ""]),
        _launch(101, 106), _kernel("unrolled_elementwise_kernel", 104, 1,
                                   106),
        _op("dls::conv3x3_wgrad", 200, 20, 8,
            [[4, 25, 32, 32, 64], [4, 25, 32, 32, 64]],
            ["c10::BFloat16", "c10::BFloat16"], tid=2),
        _launch(205, 107, tid=2), _kernel("wgrad_tc_partial_kernel", 210, 7,
                                          107),
        _launch(208, 108, tid=2), _kernel("wgrad_reduce_kernel", 218, 1,
                                          108),
        # No launching operator: a kernel whose runtime call is outside
        # every operator (counted, unattributed).
        _launch(500, 109, tid=3), _kernel("stray_kernel", 501, 1, 109),
    ]
    _write(tmp_path, events, flops={"2": 2 * 8 * 16 * 30 * 30 * 27})


def test_trace_reader_on_a_synthetic_trace(tmp_path):
    _synthetic(tmp_path)
    ops = list(tracing.iter_device_ops(str(tmp_path)))
    by_name = {o["name"]: o for o in ops}
    assert len(ops) == 9
    gn_bytes = 2 * (25 * 1024 * 64 + 2 * 64)
    assert by_name["gn_stats_kernel"]["bytes"] == gn_bytes / 2
    assert by_name["gn_normalize_kernel"]["bytes"] == gn_bytes / 2
    assert by_name["gn_stats_kernel"]["ops"] == ["dls::group_norm"]
    conv = by_name["sm90_xmma_fprop_implicit_gemm"]
    assert conv["ops"] == ["aten::conv2d", "aten::convolution",
                           "aten::cudnn_convolution"]
    assert conv["op"] == "aten::cudnn_convolution"
    assert conv["bytes"] == 4 * (8 * 3 * 32 * 32 + 16 * 27)
    assert conv["flops"] == 2 * 8 * 16 * 30 * 30 * 27
    assert by_name["wgrad_tc_partial_kernel"]["bytes"] == (
        2 * 4 * 25 * 32 * 32 * 64 * 2) / 2
    assert by_name["stray_kernel"]["ops"] == []
    assert sum(o["flops"] for o in ops) == conv["flops"]
    classes = {o["name"]: tracing.classify_op(o["name"], o["ops"],
                                              o["input_types"])
               for o in ops}
    assert classes == {
        "gn_stats_kernel": "group_norm", "gn_normalize_kernel": "group_norm",
        "sm90_xmma_fprop_implicit_gemm": "matmul_conv",
        "vectorized_elementwise_kernel": "elementwise",
        "Memcpy DtoD (Device -> Device)": "copy_layout",
        "unrolled_elementwise_kernel": "decode",
        "wgrad_tc_partial_kernel": "matmul_conv",
        "wgrad_reduce_kernel": "matmul_conv",
        "stray_kernel": "other",
    }
    ledger = tracing.categorize_ops(str(tmp_path))
    totals = tracing.parse_device_trace(str(tmp_path))
    lt = costmodel.ledger_totals(ledger)
    assert lt["op_count"] == totals["op_count"] == 9
    assert abs(lt["bytes_gb"] - totals["bytes_gb"]) < 1e-12
    assert abs(lt["device_ms"] - totals["device_ms"]) < 1e-12
    assert ledger["matmul_conv"]["flops_g"] == conv["flops"] / 1e9
    assert ledger["group_norm"]["op_count"] == 2
    stages = tracing.categorize_ops(str(tmp_path), rules=tracing.STAGE_RULES)
    assert stages["wgrad"]["op_count"] == 2
    assert stages["group_norm"]["op_count"] == 2
    top = tracing.top_device_ops(str(tmp_path), k=2)
    assert [e["name"] for e in top] == ["wgrad_tc_partial_kernel",
                                        "wgrad_reduce_kernel"]
    report = tracing.device_op_report(str(tmp_path), k=3)
    assert report["totals"]["op_count"] == 9
    assert report["by_time"][0]["name"] == "sm90_xmma_fprop_implicit_gemm"
    with pytest.raises(ValueError, match="by must be"):
        tracing.top_device_ops(str(tmp_path), by="flops")


@pytest.mark.parametrize("name, ops, types, want", [
    ("ncclKernel_AllReduce_RING", [], [], "collective"),
    ("k", ["c10d::allreduce_"], [], "collective"),
    ("k", ["dls::gn_normalize"], [], "group_norm"),
    ("k", ["dls::conv_nhwc_dw"], [], "matmul_conv"),
    ("ampere_sgemm_128x64", ["aten::mm"], [], "matmul_conv"),
    ("Memset (Device)", [], [], "copy_layout"),
    ("k", ["aten::permute", "aten::clone"], [], "copy_layout"),
    ("k", ["aten::mul"], ["float", "float"], "elementwise"),
    ("k", [], [], "other"),
])
def test_classify_op(name, ops, types, want):
    assert tracing.classify_op(name, ops, types) == want


def test_missing_and_empty_directories_read_as_nothing(tmp_path):
    assert list(tracing.iter_device_ops(str(tmp_path / "nope"))) == []
    assert tracing.categorize_ops(str(tmp_path)) == {}
    assert tracing.parse_device_trace(str(tmp_path))["op_count"] == 0


def _jax_tiny(tiny_config, **kw):
    return dataclasses.replace(tiny_config, round=3, **kw)


class _Kept(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.name, record.getMessage()))


def test_cpu_profile_degrades_in_both_packages(tiny_config, tmp_path):
    """A CPU run's profile (``profile_dir`` from round 1, with basic
    telemetry: the profiler counts no compile) has no device op: both
    packages warn and keep ``costmodel`` None."""
    trace = str(tmp_path / "trace")
    profiled = run_simulation(port_config(
        _jax_tiny(tiny_config), profile_dir=trace, profile_from_round=1,
        telemetry_level="basic"), setup_logging=False)
    assert profiled["post_warmup_compiles"] == 0
    # One trace per profiler window: a window per training step of rounds
    # 1-2 (the 4 clients as one chunk, 128 samples at batch 32: 4 steps a
    # round) and one for what follows the last step.
    assert len(tracing.trace_files(trace)) == 2 * 4 + 1
    assert tracing.categorize_ops(trace) == {}
    kept = _Kept()
    loggers = [logging.getLogger(n) for n in ("dls_torch", "dls_tpu")]
    for lg in loggers:
        lg.addHandler(kept)
    try:
        port = run_simulation(port_config(
            _jax_tiny(tiny_config), cost_model_trace=trace),
            setup_logging=False)
        jres = jax_run(_jax_tiny(tiny_config, cost_model_trace=str(
            tmp_path / "no_trace")), setup_logging=False)
    finally:
        for lg in loggers:
            lg.removeHandler(kept)
    assert port["costmodel"] is None and jres["costmodel"] is None
    assert "costmodel" not in port["history"][-1]
    warned = [name for name, msg in kept.lines
              if "holds no byte-annotated device-op events" in msg]
    assert warned == ["dls_torch", "dls_tpu"]


def test_device_trace_gives_the_last_record_a_v6_costmodel(tiny_config,
                                                           tmp_path):
    _synthetic(tmp_path)
    res = run_simulation(port_config(
        _jax_tiny(tiny_config), cost_model_trace=str(tmp_path),
        cost_model_trace_rounds=1), setup_logging=False)
    hist = res["history"]
    assert all("costmodel" not in h for h in hist[:-1])
    cm = hist[-1]["costmodel"]
    assert cm == res["costmodel"] and hist[-1]["schema_version"] == 6
    assert cm["anchor_topology"] == "h100-sxm-1"
    assert cm["predicted_ms"] > 0 and cm["measured_ms"] > 0
    assert set(cm["per_topology"]) == set(topologies.TOPOLOGIES)
    with open(SCHEMA) as f:
        jsonschema.validate(hist[-1], json.load(f))


@pytest.mark.parametrize("changes", [
    dict(cost_model_trace_rounds=0),
    dict(profile_from_round=-1),
])
def test_config_refusals_match_jax(changes):
    with pytest.raises(ValueError) as port_err:
        port_config(JaxConfig(), **changes).validate()
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**changes).validate()
    assert str(port_err.value) == str(jax_err.value)
