"""The client-stats detector on chip_smoke's ``telemetry_fed`` workload,
through both packages on the CPU: does the JAX package flag the honest
Dirichlet(0.1) clients the port's detector flags?

The workload is that phase's: the cifar10 surrogate, 50 clients,
Dirichlet(0.1) with shard cap 100, batch 25, chunk 40, lr 0.02 with
momentum 0.9, bf16 local state, 3 rounds, client stats on, seed 0. The
ResNet-18 is cut to one stage of width 8 (the full width takes hours on the
CPU in the JAX package). The two packages must flag the same clients with
the same reasons every round (exact), and report the same
``clients_flagged``; the test losses agree at rtol 2e-3, the bf16 local
state's parity band (tests/test_torch_keychain.py)."""

import numpy as np

from torch_runs import run_both

TELEMETRY_FED = dict(
    dataset_name="cifar10", model_name="resnet18", worker_number=50,
    round=3, epoch=1, batch_size=25, partition="dirichlet",
    dirichlet_alpha=0.1, max_shard_size=100, client_chunk_size=40,
    n_train=5000, n_test=2000, eval_batch_size=1000, learning_rate=0.02,
    momentum=0.9, local_compute_dtype="bfloat16", telemetry_level="basic",
    client_stats="on", log_level="WARNING", dataset_args={},
    model_args={"stage_sizes": [1], "width": 8},
)


def test_telemetry_fed_detector_agrees_with_jax(tmp_path):
    jres, pres = run_both(log_root=tmp_path, **TELEMETRY_FED)
    print("clients_flagged: jax", jres["clients_flagged"], "port",
          pres["clients_flagged"], "flagged per round:",
          [h["client_stats"].get("flagged_clients")
           for h in pres["history"]])
    assert pres["clients_flagged"] == jres["clients_flagged"]
    for j, p in zip(jres["history"], pres["history"]):
        for key in ("flagged_clients", "flag_reason"):
            assert (p["client_stats"].get(key)
                    == j["client_stats"].get(key)), (j["round"], key)
    np.testing.assert_allclose(
        [h["test_loss"] for h in pres["history"]],
        [h["test_loss"] for h in jres["history"]], rtol=2e-3)
