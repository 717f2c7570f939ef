#!/usr/bin/env python3
"""The client-axis mesh of the PyTorch/CUDA port on four NVIDIA GPUs.

    python3 chip_multicard.py [--out DIR]

Needs four cards of one host: with fewer (or none) it exits non-zero and
names the count it saw. Builds the port's CUDA kernels from csrc/ (one
nvcc per source, started together), then:

(a) **The kernels on every card.** On each of ``cuda:0`` .. ``cuda:3``, at
    one client's shapes (ResNet-18's four stage shapes at batch 25 in
    bf16; the stage-1 weight gradient at (25, 32, 32, 64) in bf16 and
    f32), each kernel against its plain PyTorch version with
    chip_smoke.py phase 1's tolerances: the GroupNorm stats at rtol 1e-5,
    the normalize kernel on the plain statistics bitwise (f32 and bf16
    scale/bias), the stats -> normalize pair (``group_norm``, a
    programmatic dependent launch) bitwise the two kernels launched one
    after the other, the wgrad kernel within 1e-4 of the largest plain
    element. Each launch must be counted on that card and on no other.
(b) **ResNet-18 ``fed`` in four layouts**, resident, bf16 local state, 40
    clients on the flagship's partition (Dirichlet(0.1), shard cap 100),
    chunk 10, 3 rounds, no size-aware schedule (``multihost_fed``'s cut,
    widened to four blocks and a round longer), each run through the CLI's
    ``main`` in its
    own processes: one process with ``--mesh_devices 4`` over the four
    cards; four processes on their own cards (``--multihost true
    --num_processes 4 --mesh_devices 4``), whose device group is NCCL;
    the same four processes with the device gathers over gloo (a private
    override of parallel/multihost.py that only this script sets); one
    process on one card without a mesh. The first three must hold
    bitwise equal global params after every round. The run without a mesh
    sums the four blocks' partials in another order: round 0's params
    within rtol 1e-6 of the meshed ones and the test loss of every round
    within rtol 2e-3 (``multihost_fed``'s bands), its gap printed. Each
    card must launch 20 of each GroupNorm kernel per forward and 4 wgrad
    kernels per training step, the four blocks' training launches summing
    to the one-card run's, and every process's eval launches equal.
(c) **GTG-Shapley's subset mesh in one process over the four cards**:
    ``GTG_shapley_value`` at N = 8 (chip_smoke.py's GTG path cut to 8
    clients and 1 round, bf16) with ``--mesh_devices 4``: the clients'
    blocks and the subset models' waves spread over the cards; each card
    must launch both GroupNorm kernels, and the Shapley values and test
    loss must be finite; the values, the walk and the round seconds are
    printed beside the same run's on one card.
(d) **``multihost_stream``'s configuration on four NCCL ranks**
    (chip_smoke.py's phase with ``n_ranks=4``: 40 clients, a hashed cohort
    of 20, persistent momentum, f32, seed 1, a checkpoint a round; each
    rank trains its block of 5 cohort rows as one chunk, and the
    one-process runs, started after the ranks and one at a time, train
    chunks of 5 too): the ranks bitwise equal to
    each other and to the one-process witness handed the four ranks'
    owner-grouped rows, with the phase's other gates.

Prints each layout's round seconds, the gathers' calls, bytes and seconds
per round (NCCL against gloo), each card's peak memory, and
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
every card; writes everything to ``DIR/chip_multicard.json`` (default
``build/chip_multicard``, which .gitignore lists). The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 4}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys

N_CARDS = 4
LAYOUT_CLIENTS = 40
LAYOUT_ROUNDS = 3


def fail(msg: str) -> None:
    print(f"chip_multicard: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def kernels_on_every_card(torch, gn, wg, smoke) -> list[dict]:
    """(a): each kernel on each card against its plain version; returns a
    row per card."""
    bf16 = torch.bfloat16
    rows = []
    wrappers = (gn.gn_stats, gn.gn_normalize, wg.conv3x3_wgrad)
    for i in range(N_CARDS):
        dev = torch.device("cuda", i)
        gen = torch.Generator(device=dev).manual_seed(i)
        gn.reset_launch_counts()
        wg.reset_launch_counts()
        row = {"device": str(dev), "stats_max_rel_err": 0.0,
               "normalize_bitwise": True, "pair_bitwise": True}
        for hw, c, _ in smoke.STAGES:
            b = smoke.TRAIN_BATCH
            x = (torch.randn(b, hw, c, device=dev, generator=gen) * 2 + 1.5
                 ).to(bf16)
            scale = torch.randn(c, device=dev, generator=gen)
            bias = torch.randn(c, device=dev, generator=gen)
            scale16, bias16 = scale.to(bf16), bias.to(bf16)
            mean_k, rstd_k = gn.gn_stats(x, smoke.GROUPS, smoke.EPS)
            mean_p, rstd_p = gn.gn_stats_plain(x, smoke.GROUPS, smoke.EPS)
            same = [
                torch.equal(
                    gn.gn_normalize(x, mean_p, rstd_p, s, t, bf16),
                    gn.gn_normalize_plain(x, mean_p, rstd_p, s, t, bf16))
                for s, t in ((scale, bias), (scale16, bias16))]
            # The pair as the model launches it (the normalize kernel a
            # programmatic dependent launch of the stats kernel) against
            # the same two kernels launched one after the other.
            y_pair, m_pair, r_pair = gn.group_norm(
                x.view(b, math.isqrt(hw), -1, c), scale16, bias16,
                smoke.GROUPS, smoke.EPS, bf16)
            y_seq = gn.gn_normalize(x, mean_k, rstd_k, scale16, bias16, bf16)
            torch.cuda.synchronize(dev)
            rel = max(((k - p).abs() / p.abs().clamp(min=1e-30)).max().item()
                      for k, p in ((mean_k, mean_p), (rstd_k, rstd_p)))
            row["stats_max_rel_err"] = max(row["stats_max_rel_err"], rel)
            row["normalize_bitwise"] &= all(same)
            row["pair_bitwise"] &= bool(
                torch.equal(y_pair.reshape(b, hw, c), y_seq)
                and torch.equal(m_pair, mean_k)
                and torch.equal(r_pair, rstd_k))
        row["wgrad_rel_err"] = {}
        for name, dtype in (("bf16", bf16), ("f32", torch.float32)):
            x = torch.randn(smoke.WGRAD_SHAPE, device=dev,
                            generator=gen).to(dtype)
            g = torch.randn(smoke.WGRAD_SHAPE, device=dev,
                            generator=gen).to(dtype)
            k = wg.conv3x3_wgrad(x, g)
            p = wg.conv3x3_wgrad_plain(x, g)
            torch.cuda.synchronize(dev)
            row["wgrad_rel_err"][name] = (
                (k - p).abs().max().item() / p.abs().max().item())
        row["launches_by_device"] = {
            w.__name__: dict(w.launches_by_device) for w in wrappers}
        log(f"kernels on {dev} ({torch.cuda.get_device_name(dev)}): {row}")
        if not (math.isfinite(row["stats_max_rel_err"])
                and row["stats_max_rel_err"] <= 1e-5):
            fail(f"gn_stats on {dev}: max rel err "
                 f"{row['stats_max_rel_err']:.3e} > 1e-5")
        if not row["normalize_bitwise"]:
            fail(f"gn_normalize on {dev} is not bit-equal to its plain "
                 "version")
        if not row["pair_bitwise"]:
            fail(f"group_norm's launch pair on {dev} differs from its two "
                 "kernels launched in turn")
        for name, err in row["wgrad_rel_err"].items():
            if not (math.isfinite(err) and err <= 1e-4):
                fail(f"wgrad {name} on {dev}: max abs err {err:.3e} of the "
                     "largest plain element (> 1e-4)")
        for w, by_device in row["launches_by_device"].items():
            if set(by_device) != {str(dev)}:
                fail(f"{w} launched on {sorted(by_device)} for tensors on "
                     f"{dev}")
        rows.append(row)
    return rows


def layout_config(smoke, work: str):
    """(b)'s configuration (module docstring)."""
    return dataclasses.replace(
        smoke.path_configs(LAYOUT_CLIENTS, 100 * LAYOUT_CLIENTS, 1000,
                           "INFO")["fed"],
        client_chunk_size=10, round=LAYOUT_ROUNDS, bucket_client_work=False,
        log_root=os.path.join(work, "log"))


def _train_launches(run: dict, device: str, eval_device: str) -> dict:
    """A run's training launches on ``device`` (its eval launches come off
    the card that evaluates)."""
    got = {}
    for name, by_device in run["launches_by_device"].items():
        n = by_device.get(device, 0)
        if device == eval_device:
            n -= run["eval_launches"][name]
        got[name] = n
    return got


def _check_per_forward(label: str, launches: dict, smoke) -> int:
    """The training forwards behind ``launches`` (one card's), failing
    unless each GroupNorm kernel launched 20 times a forward and the wgrad
    kernel 4 times a step."""
    forwards, rest = divmod(launches["gn_stats"], smoke.GN_PER_FORWARD)
    if (forwards <= 0 or rest
            or launches["gn_normalize"] != launches["gn_stats"]
            or launches["conv3x3_wgrad"] != smoke.WGRAD_PER_STEP * forwards):
        fail(f"{label}: training launches {launches} are not "
             f"{smoke.GN_PER_FORWARD} of each GroupNorm kernel a forward and "
             f"{smoke.WGRAD_PER_STEP} wgrad a step")
    return forwards


def layouts(torch, smoke, work: str) -> dict:
    """(b): the four layouts (module docstring)."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    config = layout_config(smoke, work)
    flags = smoke.cli_flags(config)
    script = os.path.abspath(__file__)
    cards = [f"cuda:{i}" for i in range(N_CARDS)]

    def arm_dir(arm: str) -> str:
        """An arm's own directory: every arm names its processes alike."""
        path = os.path.join(work, arm)
        os.makedirs(path)
        return path

    def ranks(arm, worker_options=()):
        address = f"127.0.0.1:{smoke.free_port()}"
        return smoke.launch_ranks(arm_dir(arm), {
            f"rank{r}": flags + [
                "--multihost", "true", "--coordinator_address", address,
                "--num_processes", str(N_CARDS), "--process_id", str(r),
                "--mesh_devices", str(N_CARDS)]
            for r in range(N_CARDS)}, smoke.MULTIHOST_TIMEOUT_S,
            "layouts", worker_options=worker_options, script=script)

    runs = {
        "mesh_one_process": smoke.launch_ranks(
            arm_dir("mesh_one_process"), {"mesh_one_process": flags + [
                "--mesh_devices", str(N_CARDS)]},
            smoke.MULTIHOST_TIMEOUT_S, "layouts",
            script=script)["mesh_one_process"],
        "nccl": ranks("nccl"),
        "gloo": ranks("gloo", ("--gloo",)),
        "one_card": smoke.launch_ranks(
            arm_dir("one_card"), {"one_card": flags},
            smoke.MULTIHOST_TIMEOUT_S, "layouts",
            script=script)["one_card"],
    }
    rounds = config.round
    one = runs["mesh_one_process"]
    if one["mesh"] is None or one["mesh"]["devices"] != cards:
        fail(f"mesh_one_process: mesh {one['mesh']}, expected {cards}")
    if one["params_device"] != "cuda:0":
        fail(f"mesh_one_process: params on {one['params_device']}")
    for backend in ("nccl", "gloo"):
        for r, (name, run) in enumerate(runs[backend].items()):
            if (run["device"] != cards[r] or run["mesh"] is None
                    or run["mesh"]["backend"] != backend
                    or run["mesh"]["devices"] != cards):
                fail(f"{backend} {name}: device {run['device']}, mesh "
                     f"{run['mesh']}")
            used = {d for by in run["launches_by_device"].values()
                    for d in by}
            if used != {cards[r]}:
                fail(f"{backend} {name}: launched on {sorted(used)}, its card "
                     f"is {cards[r]}")
    # Bitwise across the three meshed layouts, every round.
    want = one["digests"]
    if len(want) != rounds:
        fail(f"mesh_one_process: {len(want)} digests for {rounds} rounds")
    for backend in ("nccl", "gloo"):
        for name, run in runs[backend].items():
            if run["digests"] != want:
                fail(f"{backend} {name}: global params differ from the "
                     "one-process mesh's after a round")
            if (run["test_loss"] != one["test_loss"]
                    or run["test_accuracy"] != one["test_accuracy"]):
                fail(f"{backend} {name}: test metrics differ from the "
                     "one-process mesh's")
    # Launches: every card's training launches per forward, the blocks of
    # the one process and the ranks alike; every process's eval launches
    # equal; the blocks summing to the one-card run's.
    solo = runs["one_card"]
    solo_train = _train_launches(solo, "cuda:0", "cuda:0")
    per_card = {}
    for card in cards:
        got = _train_launches(one, card, "cuda:0")
        per_card[card] = _check_per_forward(f"mesh_one_process {card}", got,
                                            smoke)
        for backend in ("nccl", "gloo"):
            run = runs[backend][f"rank{cards.index(card)}"]
            if _train_launches(run, card, card) != got:
                fail(f"{backend} rank{cards.index(card)}: training launches "
                     f"{_train_launches(run, card, card)}, the one-process "
                     f"mesh's block on {card} {got}")
    summed = {k: sum(_train_launches(one, c, "cuda:0")[k] for c in cards)
              for k in solo_train}
    if summed != solo_train:
        fail(f"the four blocks' training launches sum to {summed}, the "
             f"one-card run's are {solo_train}")
    evals = {name: run["eval_launches"] for name, run in
             [("mesh_one_process", one), ("one_card", solo)]
             + [(f"{b} {n}", r) for b in ("nccl", "gloo")
                for n, r in runs[b].items()]}
    if len({json.dumps(e, sort_keys=True) for e in evals.values()}) != 1:
        fail(f"eval launches differ between processes: {evals}")
    # The run without a mesh: another summation order of the partials.
    p_mesh = torch.load(one["round0_path"])
    p_solo = torch.load(solo["round0_path"])
    round0_rel = float((p_mesh - p_solo).abs().max() / p_solo.abs().max())
    for run in [one, solo] + [r for b in ("nccl", "gloo")
                              for r in runs[b].values()]:
        os.remove(run["round0_path"])  # 45 MB each
    loss_gap = [abs(a - b) / abs(b)
                for a, b in zip(one["test_loss"], solo["test_loss"])]
    log(f"layouts: the one-process mesh on {cards}, four NCCL ranks and "
        f"four gloo ranks bitwise equal every round; test loss "
        f"{one['test_loss']}, one card {solo['test_loss']} (relative gap "
        f"{loss_gap}, round 0 params {round0_rel:.3e} of the largest); "
        f"training forwards a card {per_card}")
    if round0_rel > 1e-6:
        fail(f"one_card: round 0 params {round0_rel:.3e} of the largest "
             "from the meshed runs' (beyond 1e-6)")
    for rnd, gap in enumerate(loss_gap):
        if gap > smoke.MULTIHOST_LOSS_RTOL:
            fail(f"one_card round {rnd}: test loss {gap:.3e} from the meshed "
                 f"runs' (beyond rtol {smoke.MULTIHOST_LOSS_RTOL})")
    summary = {"loss_gap": loss_gap, "round0_params_rel": round0_rel,
               "train_forwards_per_card": per_card, "arms": {}}
    arms = {"mesh_one_process": {"process": one},
            "one_card": {"process": solo},
            "nccl": runs["nccl"], "gloo": runs["gloo"]}
    for arm, procs in arms.items():
        summary["arms"][arm] = {
            name: {"round_seconds": run["round_seconds"],
                   # Pipelined rounds: a record's seconds run from the
                   # record before, so round 1's hold round 2's dispatch
                   # and round 1's finalize: a steady round.
                   "steady_round_seconds": run["round_seconds"][1],
                   "rounds_wall_seconds": sum(run["round_seconds"]),
                   "gathers": run["gathers"],
                   "gather_mib_per_round":
                       run["gathers"]["bytes"] / rounds / 2**20,
                   "gather_seconds_per_round":
                       run["gathers"]["seconds"] / rounds,
                   "peak_memory_gib": {
                       d: b / 2**30
                       for d, b in run["peak_memory_by_device"].items()}}
            for name, run in procs.items()}
        log(f"layouts {arm}: " + "; ".join(
            f"{name} round seconds {v['round_seconds']} (steady "
            f"{v['steady_round_seconds']:.4f}, wall "
            f"{v['rounds_wall_seconds']:.4f}), gathers "
            f"{v['gathers']['calls']} calls, "
            f"{v['gather_mib_per_round']:.1f} MiB and "
            f"{v['gather_seconds_per_round']:.4f} s a round (a call: "
            f"first {v['gathers']['first_call_seconds']}, then "
            f"{v['gathers']['min_call_seconds']}-"
            f"{v['gathers']['max_call_seconds']}), "
            f"peak GiB "
            f"{ {d: round(g, 2) for d, g in v['peak_memory_gib'].items()} }"
            for name, v in summary["arms"][arm].items()))
    shutil.rmtree(os.path.join(work, "log"), ignore_errors=True)
    return summary


GTG_CLIENTS = 8


def gtg_mesh(torch, smoke, work: str) -> dict:
    """(c): GTG-Shapley's subset mesh in one process over the four cards,
    beside the same run on one card."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    config = dataclasses.replace(
        smoke.extra_path_configs(os.path.join(work, "log"))[
            "GTG_shapley_value"],
        worker_number=GTG_CLIENTS, round=1, n_train=100 * GTG_CLIENTS)
    flags = smoke.cli_flags(config)
    script = os.path.abspath(__file__)
    runs = smoke.launch_ranks(work, {
        "gtg_mesh": flags + ["--mesh_devices", str(N_CARDS)],
        "gtg_one_card": flags}, smoke.MULTIHOST_TIMEOUT_S, "gtg_mesh",
        script=script)
    mesh, solo = runs["gtg_mesh"], runs["gtg_one_card"]
    cards = [f"cuda:{i}" for i in range(N_CARDS)]
    for card in cards:
        for kernel in ("gn_stats", "gn_normalize"):
            if not mesh["launches_by_device"][kernel].get(card):
                fail(f"gtg_mesh: {kernel} never launched on {card} "
                     f"({mesh['launches_by_device']})")
    for name, run in runs.items():
        if not all(math.isfinite(v) for v in run["test_loss"]):
            fail(f"{name}: test loss {run['test_loss']}")
        os.remove(run["round0_path"])
    gtg = {name: run["gtg"] for name, run in runs.items()}
    values = {name: run["shapley_values"] for name, run in runs.items()}
    for name, sv in values.items():
        if not sv or not all(math.isfinite(v) for r in sv for v in r):
            fail(f"{name}: Shapley values {sv}")
    log(f"gtg_mesh: launches by card {mesh['launches_by_device']}; GTG "
        f"{gtg}; Shapley values meshed {values['gtg_mesh']}, one card "
        f"{values['gtg_one_card']}; test loss meshed {mesh['test_loss']}, "
        f"one card {solo['test_loss']}; round seconds meshed "
        f"{mesh['round_seconds']}, one card {solo['round_seconds']}")
    shutil.rmtree(os.path.join(work, "log"), ignore_errors=True)
    return {"gtg": gtg, "shapley_values": values,
            "launches_by_device": mesh["launches_by_device"],
            "round_seconds": {n: r["round_seconds"] for n, r in runs.items()},
            "peak_memory_by_device": mesh["peak_memory_by_device"]}


def main() -> None:
    repo = os.path.dirname(os.path.abspath(__file__))
    if "--rank-worker" in sys.argv:
        # A process of (b) or (c): chip_multicard.py --rank-worker OUT
        # [--gloo] [--owner-order=N] -- FLAGS
        sys.path.insert(0, repo)
        import chip_smoke as smoke

        from distributed_learning_simulator_tpu_torch.parallel import (
            multihost,
        )

        options = sys.argv[sys.argv.index("--rank-worker"):
                            sys.argv.index("--")]
        if "--gloo" in options:
            multihost._backend_override = "gloo"
        smoke.rank_worker(*smoke.rank_worker_args(sys.argv))
        return
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join("build",
                                                      "chip_multicard"),
                        help="directory for chip_multicard.json")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs four "
             "GPUs")
    count = torch.cuda.device_count()
    if count < N_CARDS:
        fail(f"{count} GPU(s) visible: this script needs {N_CARDS}")
    sys.path.insert(0, repo)
    try:
        import chip_smoke as smoke
        from distributed_learning_simulator_tpu_torch.ops import _build
        from distributed_learning_simulator_tpu_torch.ops import gn_cuda as gn
        from distributed_learning_simulator_tpu_torch.ops import (
            wgrad_cuda as wg,
        )
    except ImportError as e:
        fail(f"chip_smoke.py and the port's package are not beside this "
             f"script: {e}")
    # The phases borrowed from chip_smoke.py report as this script.
    smoke.fail, smoke.log = fail, log
    os.environ["DLS_DATA_DIR"] = os.path.join(os.path.abspath(args.out),
                                              "data")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; cards:")
    for line in smi:
        log(line)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for fut in [pool.submit(m._lib) for m in (gn, wg)]:
            fut.result()
    log("built csrc/gn.cu and csrc/wgrad.cu:\n" + "\n".join(
        _build.BUILD_LOGS.get(n, "").strip() for n in ("gn", "wgrad")))
    out = {"cards": smi, "torch": torch.__version__}
    out["kernels"] = kernels_on_every_card(torch, gn, wg, smoke)
    work = os.path.join(os.path.abspath(args.out), "work")
    out["layouts"] = layouts(torch, smoke, os.path.join(work, "layouts"))
    out["gtg_mesh"] = gtg_mesh(torch, smoke, os.path.join(work, "gtg"))
    stream = smoke.multihost_stream(
        torch, os.path.join(work, "stream"), n_ranks=N_CARDS,
        phase="multihost_stream_nccl", script=os.path.abspath(__file__))
    if stream["backend"] != "nccl":
        fail(f"multihost_stream_nccl: the ranks' device group is "
             f"{stream['backend']} on {stream['devices']}")
    out["multihost_stream_nccl"] = {
        k: v for k, v in stream.items() if k not in ("solo", "witness")}
    out["multihost_stream_nccl"]["solo_round_seconds"] = stream["solo"][
        "round_seconds"]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_multicard.json"), "w") as f:
        json.dump(out, f, indent=1)
    if "jax" in sys.modules:
        fail("the port imported jax")
    print("\n".join(smi))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count,
    }}))


if __name__ == "__main__":
    main()
