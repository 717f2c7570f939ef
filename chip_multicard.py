#!/usr/bin/env python3
"""The client-axis mesh of the PyTorch/CUDA port on four NVIDIA GPUs.

    python3 chip_multicard.py [--out DIR] [--arms LETTERS]

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
    one-process runs, started after the ranks, at once, each alone on a
    card, train chunks of 5 too): the ranks bitwise equal to
    each other and to the one-process witness handed the four ranks'
    owner-grouped rows, with the phase's other gates.
(e) **``sign_SGD``, ``fed_quant`` (256 levels, QAT) and
    ``multiround_shapley_value`` over the client-axis mesh**, each at
    chip_smoke.py's main-path settings cut as (b) (40 clients, chunk 10)
    to 2 rounds; the Shapley run at N = 8 (its subsets grow as 2^N) with
    a chunk of 2, so that each card's block is one chunk as in (b). Each
    as four NCCL ranks, then as one process over the four cards beside
    the same flags on one card (its own card). The two meshed layouts
    must hold bitwise equal global params and test metrics every round;
    the one-card run (b)'s bands; (b)'s launch rule on every card (the
    Shapley algorithms' subset evaluations, post_round's launches, left
    out); the Shapley values finite and each within two evaluation
    samples (2 / ``shapley_eval_samples``) of the one-card run's and the
    one-process mesh's.
(f) **The streamed store under a one-process mesh of the four cards**:
    (d)'s configuration with ``--mesh_devices 4`` in one process (the
    cohort in four blocks of 5 draw-order rows, one chunk each), against
    (d)'s one-process run, its witness and its ranks: the cohorts equal,
    the test loss within rtol 1e-4 in round 0 and 1e-3 after, the
    accuracy within rtol 1e-4 in round 0 and two test samples after
    ((d)'s bands), whether it is bitwise each printed; every card's
    training launches those of a block of 5 rows.
(g) **The sweep's experiment-axis mesh over the four cards**:
    chip_smoke.py's ``sweep_fleet`` (a) (f32, chunk 20, 20 clients, 2
    rounds) at seeds 0-3 with ``--mesh_devices 4`` (one experiment a
    card), beside the same fleet on one card and each seed alone as a
    fleet of one on its own card (the program the mesh runs there). Each
    meshed experiment's records must be bitwise its fleet of one's;
    against the one-card fleet, whose program holds 80 models where each
    card's holds 20 (the training's bits do not move with the model
    count; the eval forward of the models side by side sums a group in
    another order), every cohort hash equal and the test accuracy, test
    loss and mean client loss within rel 1e-5 in every round
    (tests/test_torch_sweep.py ``test_fleet_mesh_packing``'s bound); each
    card launching the kernels as often as the one-card fleet does (its
    own experiment's forwards only).
(h) **SIGTERM on four NCCL ranks**: chip_smoke.py's ``multihost_preempt``
    at (d)'s configuration with a checkpoint every 2 of its 2 rounds, the
    hook on every rank and, at once, on rank 0 alone: every signalled
    rank exits 0 within 150 s and logs the JAX package's sharded text
    once, no ``round_0.manifest.json`` nor shard is written, and the
    peers of rank 0 alone are killed once it is out.

The arms run in the order (a), (d), then (f) and (g) at once, then (e)
and (h) at once, then (b) and (c): the command stays near 500 s.
``--arms`` runs only the arms it names, in that order (``--arms ag``:
(a) and (g); (f) runs (d) first, whose runs it reads).

Prints each layout's round seconds, the gathers' calls, bytes and seconds
per round (NCCL against gloo), each card's peak memory, each arm's wall
seconds, and
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
import time

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


#: (e)'s algorithms beside (b)'s ``fed``; each one-card run of (e) takes
#: its own card (CUDA_VISIBLE_DEVICES), beside the one-process mesh.
MESH_ALGORITHMS = ("sign_SGD", "fed_quant", "multiround_shapley_value")
ALGORITHM_ROUNDS = 2
SHAPLEY_CLIENTS = 8  # subsets grow as 2^N


def layout_config(smoke, work: str, algorithm: str = "fed"):
    """The layouts' configuration (module docstring): (b)'s for ``fed``,
    (e)'s for the others."""
    log_root = os.path.join(work, "log")
    if algorithm == "multiround_shapley_value":
        # A block of N / 4 clients a card, one chunk each, as (b)'s blocks
        # of 10.
        return dataclasses.replace(
            smoke.extra_path_configs(log_root)[algorithm],
            worker_number=SHAPLEY_CLIENTS, n_train=100 * SHAPLEY_CLIENTS,
            client_chunk_size=SHAPLEY_CLIENTS // N_CARDS,
            round=ALGORITHM_ROUNDS, bucket_client_work=False)
    return dataclasses.replace(
        smoke.path_configs(LAYOUT_CLIENTS, 100 * LAYOUT_CLIENTS, 1000,
                           "INFO")[algorithm],
        client_chunk_size=10,
        round=LAYOUT_ROUNDS if algorithm == "fed" else ALGORITHM_ROUNDS,
        bucket_client_work=False, log_root=log_root)


def _train_launches(run: dict, device: str, eval_device: str) -> dict:
    """A run's training launches on ``device`` (its server eval launches
    come off the card that evaluates, post_round's off every card)."""
    got = {}
    for name, by_device in run["launches_by_device"].items():
        n = by_device.get(device, 0)
        if device == eval_device:
            n -= run["eval_launches"][name]
        n -= run["post_round_launches_by_device"].get(name, {}).get(device,
                                                                    0)
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


def _summary(run: dict, rounds: int) -> dict:
    """One process's round seconds, gathers and peaks, as printed."""
    return {"round_seconds": run["round_seconds"],
            # Pipelined rounds: a record's seconds run from the record
            # before, so round 1's hold round 2's dispatch and round 1's
            # finalize: a steady round (3 rounds or more).
            "steady_round_seconds": (run["round_seconds"][1]
                                     if rounds >= 3 else None),
            "rounds_wall_seconds": sum(run["round_seconds"]),
            "gathers": run["gathers"],
            "gather_mib_per_round": run["gathers"]["bytes"] / rounds / 2**20,
            "gather_seconds_per_round": run["gathers"]["seconds"] / rounds,
            "peak_memory_gib": {
                d: b / 2**30
                for d, b in run["peak_memory_by_device"].items() if b}}


def layouts(torch, smoke, work: str, algorithm: str = "fed",
            solo_card: int | None = None) -> dict:
    """(b) for ``fed`` (four layouts, one after another), (e) for the
    others: four NCCL ranks, then the one-process mesh and the one-card
    run (on card ``solo_card``) together (module docstring)."""
    t0 = time.monotonic()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    config = layout_config(smoke, work, algorithm)
    flags = smoke.cli_flags(config)
    script = os.path.abspath(__file__)
    cards = [f"cuda:{i}" for i in range(N_CARDS)]
    tag = "layouts" if algorithm == "fed" else f"layouts {algorithm}"

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
            tag, worker_options=worker_options, script=script)

    mesh_flags = flags + ["--mesh_devices", str(N_CARDS)]
    if algorithm == "fed":
        runs = {
            "mesh_one_process": smoke.launch_ranks(
                arm_dir("mesh_one_process"),
                {"mesh_one_process": mesh_flags}, smoke.MULTIHOST_TIMEOUT_S,
                tag, script=script)["mesh_one_process"],
            "nccl": ranks("nccl"),
            "gloo": ranks("gloo", ("--gloo",)),
            "one_card": smoke.launch_ranks(
                arm_dir("one_card"), {"one_card": flags},
                smoke.MULTIHOST_TIMEOUT_S, tag,
                script=script)["one_card"],
        }
    else:
        runs = {"nccl": ranks("nccl")}
        runs.update(smoke.launch_ranks(
            arm_dir("one_process"),
            {"mesh_one_process": mesh_flags, "one_card": flags},
            smoke.MULTIHOST_TIMEOUT_S, tag, script=script,
            envs={"one_card": {"CUDA_VISIBLE_DEVICES": str(solo_card)}}))
    backends = [b for b in ("nccl", "gloo") if b in runs]
    rounds = config.round
    one = runs["mesh_one_process"]
    if one["mesh"] is None or one["mesh"]["devices"] != cards:
        fail(f"{tag} mesh_one_process: mesh {one['mesh']}, expected {cards}")
    if one["params_device"] != "cuda:0":
        fail(f"{tag} mesh_one_process: params on {one['params_device']}")
    for backend in backends:
        for r, (name, run) in enumerate(runs[backend].items()):
            if (run["device"] != cards[r] or run["mesh"] is None
                    or run["mesh"]["backend"] != backend
                    or run["mesh"]["devices"] != cards):
                fail(f"{tag} {backend} {name}: device {run['device']}, mesh "
                     f"{run['mesh']}")
            used = {d for by in run["launches_by_device"].values()
                    for d in by}
            if used != {cards[r]}:
                fail(f"{tag} {backend} {name}: launched on {sorted(used)}, "
                     f"its card is {cards[r]}")
    # Bitwise across the meshed layouts, every round.
    want = one["digests"]
    if len(want) != rounds:
        fail(f"{tag} mesh_one_process: {len(want)} digests for {rounds} "
             "rounds")
    for backend in backends:
        for name, run in runs[backend].items():
            if run["digests"] != want:
                fail(f"{tag} {backend} {name}: global params differ from "
                     "the one-process mesh's after a round")
            if (run["test_loss"] != one["test_loss"]
                    or run["test_accuracy"] != one["test_accuracy"]):
                fail(f"{tag} {backend} {name}: test metrics differ from the "
                     "one-process mesh's")
    # Launches: every card's training launches per forward, the blocks of
    # the one process and the ranks alike; every process's eval launches
    # equal; the blocks summing to the one-card run's.
    solo = runs["one_card"]
    solo_train = _train_launches(solo, "cuda:0", "cuda:0")
    per_card = {}
    for card in cards:
        got = _train_launches(one, card, "cuda:0")
        per_card[card] = _check_per_forward(
            f"{tag} mesh_one_process {card}", got, smoke)
        for backend in backends:
            run = runs[backend][f"rank{cards.index(card)}"]
            if _train_launches(run, card, card) != got:
                fail(f"{tag} {backend} rank{cards.index(card)}: training "
                     f"launches {_train_launches(run, card, card)}, the "
                     f"one-process mesh's block on {card} {got}")
    summed = {k: sum(_train_launches(one, c, "cuda:0")[k] for c in cards)
              for k in solo_train}
    if summed != solo_train:
        fail(f"{tag}: the four blocks' training launches sum to {summed}, "
             f"the one-card run's are {solo_train}")
    evals = {name: run["eval_launches"] for name, run in
             [("mesh_one_process", one), ("one_card", solo)]
             + [(f"{b} {n}", r) for b in backends
                for n, r in runs[b].items()]}
    if len({json.dumps(e, sort_keys=True) for e in evals.values()}) != 1:
        fail(f"{tag}: eval launches differ between processes: {evals}")
    # The run without a mesh: another summation order of the partials.
    p_mesh = torch.load(one["round0_path"])
    p_solo = torch.load(solo["round0_path"])
    round0_rel = float((p_mesh - p_solo).abs().max() / p_solo.abs().max())
    for run in [one, solo] + [r for b in backends
                              for r in runs[b].values()]:
        os.remove(run["round0_path"])  # 45 MB each
    loss_gap = [abs(a - b) / abs(b)
                for a, b in zip(one["test_loss"], solo["test_loss"])]
    log(f"{tag}: the one-process mesh on {cards} and "
        + " and ".join(f"four {b.upper()} ranks" for b in backends)
        + f" bitwise equal every round; test loss {one['test_loss']}, one "
        f"card {solo['test_loss']} (relative gap {loss_gap}, round 0 params "
        f"{round0_rel:.3e} of the largest); training forwards a card "
        f"{per_card}; post_round launches by card "
        f"{ {n: r['post_round_launches_by_device'] for n, r in [('mesh_one_process', one), ('one_card', solo)]} }")
    if round0_rel > 1e-6:
        fail(f"{tag} one_card: round 0 params {round0_rel:.3e} of the "
             "largest from the meshed runs' (beyond 1e-6)")
    for rnd, gap in enumerate(loss_gap):
        if gap > smoke.MULTIHOST_LOSS_RTOL:
            fail(f"{tag} one_card round {rnd}: test loss {gap:.3e} from the "
                 f"meshed runs' (beyond rtol {smoke.MULTIHOST_LOSS_RTOL})")
    summary = {"algorithm": algorithm, "loss_gap": loss_gap,
               "round0_params_rel": round0_rel,
               "train_forwards_per_card": per_card, "arms": {}}
    if algorithm == "multiround_shapley_value":
        summary["shapley"] = shapley_values(tag, config, runs)
    arms = {"mesh_one_process": {"process": one},
            "one_card": {"process": solo}}
    arms.update({b: runs[b] for b in backends})
    for arm, procs in arms.items():
        summary["arms"][arm] = {name: _summary(run, rounds)
                                for name, run in procs.items()}
        log(f"{tag} {arm}: " + "; ".join(
            f"{name} round seconds {v['round_seconds']} (steady "
            f"{v['steady_round_seconds']}, wall "
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
    summary["wall_seconds"] = time.monotonic() - t0
    return summary


def shapley_values(tag: str, config, runs: dict) -> dict:
    """(e)'s Shapley gate: every process's values finite, and each within
    two evaluation samples (2 / ``shapley_eval_samples``, the CPU tests'
    utility band) of the one-card run's and of the one-process mesh's."""
    values = {"mesh_one_process": runs["mesh_one_process"]["shapley_values"],
              "one_card": runs["one_card"]["shapley_values"]}
    values.update({f"nccl {n}": r["shapley_values"]
                   for n, r in runs["nccl"].items()})
    band = 2.0 / config.shapley_eval_samples
    for name, sv in values.items():
        if (len(sv) != config.round
                or any(len(r) != config.worker_number for r in sv)
                or not all(math.isfinite(v) for r in sv for v in r)):
            fail(f"{tag} {name}: Shapley values {sv}")
    gaps = {}
    for ref in ("one_card", "mesh_one_process"):
        for name, sv in values.items():
            if name != ref:
                gaps[f"{name} - {ref}"] = max(
                    abs(a - b) for ra, rb in zip(sv, values[ref])
                    for a, b in zip(ra, rb))
    log(f"{tag}: Shapley values {values}; largest gaps {gaps} (band "
        f"{band})")
    for pair, gap in gaps.items():
        if gap > band:
            fail(f"{tag}: Shapley values {pair} apart by {gap:.3e} (beyond "
                 f"{band})")
    return {"values": values, "gaps": gaps, "band": band}


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


def stream_mesh(torch, smoke, work: str, stream: dict) -> dict:
    """(f): ``multihost_stream``'s configuration as one streamed process
    over the four cards (``--mesh_devices 4``: the cohort in four blocks of
    5 rows in draw order, one chunk each), against (d)'s one-process run
    (bitwise predicted: the block partials meet in its chunks' order),
    its owner-order witness and its ranks (the summation order moves),
    each within (d)'s bands."""
    t0 = time.monotonic()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    config = smoke.multihost_stream_config(work)
    block = config.cohort_size() // N_CARDS
    flags = smoke.cli_flags(dataclasses.replace(
        config, client_chunk_size=min(config.client_chunk_size, block),
        span_trace="off", mesh_devices=N_CARDS))
    run = smoke.launch_ranks(work, {"stream_mesh": flags},
                             smoke.MULTIHOST_TIMEOUT_S, "stream_mesh",
                             script=os.path.abspath(__file__))["stream_mesh"]
    os.remove(run["round0_path"])
    cards = [f"cuda:{i}" for i in range(N_CARDS)]
    if run["mesh"] is None or run["mesh"]["devices"] != cards:
        fail(f"stream_mesh: mesh {run['mesh']}, expected {cards}")
    solo, witness = stream["solo"], stream["witness"]
    if run["cohort_hash"] != solo["cohort_hash"]:
        fail(f"stream_mesh: cohorts {run['cohort_hash']}, (d)'s "
             f"{solo['cohort_hash']}")
    want = stream["predicted_train_launches"]
    for card in cards:
        got = _train_launches(run, card, "cuda:0")
        if got != want:
            fail(f"stream_mesh {card}: training launches {got}, a block of "
                 f"{block} rows predicts {want}")
    refs = {"solo": solo, "witness": witness}
    refs.update({f"rank{r}": v for r, v in enumerate(
        stream["ranks"].values())})
    bitwise = {name: ref["digests"] == run["digests"]
               and ref["test_loss"] == run["test_loss"]
               for name, ref in refs.items()}
    rtol_loss = [smoke.MULTIHOST_STREAM_RTOL if rnd == 0
                 else smoke.MULTIHOST_STREAM_LATER_RTOL
                 for rnd in range(config.round)]
    gaps = {name: [abs(a - b) / abs(b) for a, b in zip(
        run["test_loss"], ref["test_loss"])] for name, ref in refs.items()}
    log(f"stream_mesh: one process over {cards}; bitwise {bitwise}; test "
        f"loss {run['test_loss']}, (d)'s solo {solo['test_loss']}, witness "
        f"{witness['test_loss']}; relative gaps {gaps} (bands {rtol_loss}); "
        f"round seconds {run['round_seconds']} (solo "
        f"{solo['round_seconds']}); peak GiB "
        f"{ {d: round(b / 2**30, 2) for d, b in run['peak_memory_by_device'].items()} }; "
        f"launches by card {run['launches_by_device']}")
    for name, ref in refs.items():
        for rnd, (gap, band) in enumerate(zip(gaps[name], rtol_loss)):
            if gap > band:
                fail(f"stream_mesh round {rnd}: test loss {gap:.3e} from "
                     f"(d)'s {name} (beyond rtol {band})")
        for rnd, (a, b) in enumerate(zip(run["test_accuracy"],
                                         ref["test_accuracy"])):
            band = (smoke.MULTIHOST_STREAM_RTOL * abs(b) if rnd == 0
                    else 2.0 / config.n_test)
            if abs(a - b) > band:
                fail(f"stream_mesh round {rnd}: test accuracy {a} against "
                     f"(d)'s {name} {b} (band {band:.3e})")
    shutil.rmtree(os.path.join(work, "log"), ignore_errors=True)
    return {"bitwise": bitwise, "test_loss_gaps": gaps,
            "round_seconds": run["round_seconds"],
            "launches_by_device": run["launches_by_device"],
            "peak_memory_by_device": run["peak_memory_by_device"],
            "wall_seconds": time.monotonic() - t0}


SWEEP_EXPERIMENTS = N_CARDS  # one a card
#: Every round against the one-card fleet: tests/test_torch_sweep.py
#: test_fleet_mesh_packing's bound. The training is bitwise at any model
#: count since the wgrad kernel's runs, the GroupNorm backward's sums and
#: the f32 input gradients stopped moving with it (ROADMAP queue 3 item
#: 7); the eval forward of E models side by side
#: still sums a group in another order (about 1e-7 of the test loss).
SWEEP_RTOL = 1e-5


def sweep_config(smoke):
    """(g)'s fleet: ``sweep_fleet`` (a) (f32, chunk 20, 20 clients, 2
    rounds) at seeds 0-3."""
    return dataclasses.replace(
        smoke.sweep_fleet_configs()["f32"],
        sweep_seeds=",".join(str(i) for i in range(SWEEP_EXPERIMENTS)),
        log_level="INFO")


def sweep_worker(out_path: str, argv: list[str]) -> None:
    """A process of (g): the CLI's ``main(argv)`` (a sweep), the fleet's
    records, launches by card and peaks; writes ``out_path``."""
    import torch

    from distributed_learning_simulator_tpu_torch import simulator
    from distributed_learning_simulator_tpu_torch.ops import gn_cuda as gn
    from distributed_learning_simulator_tpu_torch.ops import wgrad_cuda as wg

    gn.reset_launch_counts()
    wg.reset_launch_counts()
    t0 = time.perf_counter()
    result = simulator.main(argv)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    keys = ("round", "round_seconds", "cohort_hash", "test_accuracy",
            "test_loss", "mean_client_loss")
    with open(out_path, "w") as f:
        json.dump({
            "strategy": result["strategy"],
            "programs_compiled": result["programs_compiled"],
            "points": [{"seed": p["seed"],
                        "history": [{k: r.get(k) for k in keys}
                                    for r in p["history"]]}
                       for p in result["points"]],
            "launches_by_device": {
                w.__name__: dict(w.launches_by_device)
                for w in (gn.gn_stats, gn.gn_normalize, wg.conv3x3_wgrad)},
            "peak_memory_by_device": {
                f"cuda:{i}": torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count())},
            "wall_seconds": time.perf_counter() - t0}, f)


def _records(history) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "round_seconds"}
            for r in history]


def sweep_mesh(torch, smoke, work: str, solo_card: int) -> dict:
    """(g): the fleet with ``--mesh_devices 4`` (one experiment a card)
    beside, at once, the same fleet on card ``solo_card`` and each
    experiment alone as a fleet of one on its card (the program the mesh
    runs there)."""
    t0 = time.monotonic()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    config = dataclasses.replace(sweep_config(smoke),
                                 log_root=os.path.join(work, "log"))
    flags = smoke.cli_flags(config)
    alone = {f"sweep_seed{g}": flags + ["--sweep_seeds", str(g)]
             for g in range(SWEEP_EXPERIMENTS)}
    runs = smoke.launch_ranks(
        work, {"sweep_mesh": flags + ["--mesh_devices", str(N_CARDS)],
               "sweep_one_card": flags, **alone},
        smoke.MULTIHOST_TIMEOUT_S, "sweep_mesh",
        script=os.path.abspath(__file__), worker="--sweep-worker",
        envs={"sweep_one_card": {"CUDA_VISIBLE_DEVICES": str(solo_card)},
              **{f"sweep_seed{g}": {"CUDA_VISIBLE_DEVICES": str(g)}
                 for g in range(SWEEP_EXPERIMENTS)}})
    mesh, solo = runs["sweep_mesh"], runs["sweep_one_card"]
    cards = [f"cuda:{i}" for i in range(N_CARDS)]
    for name, run in runs.items():
        if run["strategy"] != "vmapped" or run["programs_compiled"] != 1:
            fail(f"{name}: strategy {run['strategy']}, "
                 f"{run['programs_compiled']} programs (expected vmapped, 1)")
    # Each card trains and evaluates its own experiment: as many forwards
    # as the one-card fleet, whose forwards hold all four.
    want = {w: by["cuda:0"] for w, by in solo["launches_by_device"].items()}
    for w, by in mesh["launches_by_device"].items():
        if by != {card: want[w] for card in cards}:
            fail(f"sweep_mesh: {w} launches by card {by}, each card's "
                 f"experiment predicts {want[w]} (the one-card fleet's)")
    gaps = []
    for g, (pm, ps) in enumerate(zip(mesh["points"], solo["points"],
                                     strict=True)):
        if not pm["seed"] == ps["seed"] == g:
            fail(f"sweep_mesh: point seeds {pm['seed']} / {ps['seed']}")
        # The card's program is the experiment's fleet of one: bitwise.
        if _records(pm["history"]) != _records(
                runs[f"sweep_seed{g}"]["points"][0]["history"]):
            fail(f"sweep_mesh seed {g}: records {_records(pm['history'])} "
                 f"differ from the seed alone on one card "
                 f"{_records(runs[f'sweep_seed{g}']['points'][0]['history'])}")
        for rm, rs in zip(pm["history"], ps["history"], strict=True):
            if rm["cohort_hash"] != rs["cohort_hash"]:
                fail(f"sweep_mesh seed {g} round {rm['round']}: cohort "
                     f"{rm['cohort_hash']} / {rs['cohort_hash']}")
            for k in ("test_accuracy", "test_loss", "mean_client_loss"):
                gap = abs(rm[k] - rs[k]) / max(abs(rs[k]), 1e-30)
                gaps.append((g, rm["round"], k, gap))
                if gap > SWEEP_RTOL:
                    fail(f"sweep_mesh seed {g} round {rm['round']}: {k} "
                         f"{rm[k]} against the one-card fleet's {rs[k]} (rel "
                         f"{gap:.3e}, beyond {SWEEP_RTOL})")
    by_round = {}
    for _, rnd, _, gap in gaps:
        by_round[rnd] = max(by_round.get(rnd, 0.0), gap)
    log(f"sweep_mesh: {SWEEP_EXPERIMENTS} experiments over {cards}, each "
        f"bitwise the seed alone on one card; launches by card "
        f"{mesh['launches_by_device']} (one card "
        f"{solo['launches_by_device']}); largest relative gap to the "
        f"one-card fleet by round {by_round} (bound {SWEEP_RTOL}); round "
        f"seconds meshed "
        f"{[r['round_seconds'] for r in mesh['points'][0]['history']]}, one "
        f"card {[r['round_seconds'] for r in solo['points'][0]['history']]}; "
        f"wall {mesh['wall_seconds']:.1f} / {solo['wall_seconds']:.1f} s; "
        f"peak GiB meshed "
        f"{ {d: round(b / 2**30, 2) for d, b in mesh['peak_memory_by_device'].items()} }, "
        f"one card {round(solo['peak_memory_by_device']['cuda:0'] / 2**30, 2)}")
    shutil.rmtree(os.path.join(work, "log"), ignore_errors=True)
    return {"largest_rel_gap_by_round": by_round, "gaps": gaps,
            "runs": runs, "wall_seconds": time.monotonic() - t0}


def preempt_nccl(torch, smoke, work: str) -> dict:
    """(h): chip_smoke.py's ``multihost_preempt`` on four NCCL ranks at
    (d)'s configuration, a checkpoint every 2 of its 2 rounds."""
    t0 = time.monotonic()
    config = dataclasses.replace(smoke.multihost_stream_config(work),
                                 checkpoint_every=2)
    out = smoke.multihost_preempt(torch, work, {"streamed": config},
                                  n_ranks=N_CARDS,
                                  phase="multihost_preempt_nccl",
                                  backend="nccl")
    out["wall_seconds"] = time.monotonic() - t0
    return out


def together(smoke, *calls) -> list:
    """Each ``(fn, *args)`` in a thread of its own (their work is in the
    processes they start), all started at once; their results in order.
    When one fails, every process the others started is killed first."""
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(*call) for call in calls]
        done, _ = concurrent.futures.wait(
            futures, return_when=concurrent.futures.FIRST_EXCEPTION)
        if any(f.exception() is not None for f in done):
            smoke.kill_children()
        return [f.result() for f in futures]


def main() -> None:
    repo = os.path.dirname(os.path.abspath(__file__))
    if "--sweep-worker" in sys.argv:
        # A process of (g): chip_multicard.py --sweep-worker OUT -- FLAGS
        sys.path.insert(0, repo)
        at, end = sys.argv.index("--sweep-worker"), sys.argv.index("--")
        sweep_worker(sys.argv[at + 1], sys.argv[end + 1:])
        return
    if "--rank-worker" in sys.argv:
        # A process of (b)-(f): chip_multicard.py --rank-worker OUT
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
    parser.add_argument("--arms", default="abcdefgh",
                        help="the arms to run, by letter (default: all)")
    args = parser.parse_args()
    arms = set(args.arms)
    if not arms or arms - set("abcdefgh"):
        fail(f"--arms takes letters of a-h, got {args.arms!r}")
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
    out = {"cards": smi, "torch": torch.__version__, "arm_seconds": {}}
    t_arm = time.monotonic()

    def timed(arm: str) -> None:
        nonlocal t_arm
        now = time.monotonic()
        out["arm_seconds"][arm] = now - t_arm
        log(f"arm {arm}: {now - t_arm:.1f}s")
        t_arm = now

    if "a" in arms:
        out["kernels"] = kernels_on_every_card(torch, gn, wg, smoke)
        timed("a")
    work = os.path.join(os.path.abspath(args.out), "work")
    if arms & set("df"):  # (f) reads (d)'s runs
        stream = smoke.multihost_stream(
            torch, os.path.join(work, "stream"), n_ranks=N_CARDS,
            phase="multihost_stream_nccl", script=os.path.abspath(__file__),
            solo_cards=(0, 1))
        if stream["backend"] != "nccl":
            fail(f"multihost_stream_nccl: the ranks' device group is "
                 f"{stream['backend']} on {stream['devices']}")
        out["multihost_stream_nccl"] = {
            k: v for k, v in stream.items() if k not in ("solo", "witness")}
        out["multihost_stream_nccl"]["solo_round_seconds"] = stream["solo"][
            "round_seconds"]
        timed("d")
    # (f) and (g) at once.
    calls = {}
    if "f" in arms:
        calls["stream_mesh"] = (stream_mesh, torch, smoke,
                                os.path.join(work, "stream_mesh"), stream)
    if "g" in arms:
        calls["sweep_mesh"] = (sweep_mesh, torch, smoke,
                               os.path.join(work, "sweep"), N_CARDS - 1)
    if calls:
        out.update(zip(calls, together(smoke, *calls.values())))
        timed("".join(a for a in "fg" if a in arms))
    # (e), the three algorithms, each one-card run on a card of its own,
    # and (h), at once.
    calls = {}
    if "e" in arms:
        calls.update({algo: (layouts, torch, smoke,
                             os.path.join(work, f"layouts_{algo}"), algo,
                             1 + i)
                      for i, algo in enumerate(MESH_ALGORITHMS)})
    if "h" in arms:
        calls["preempt_nccl"] = (preempt_nccl, torch, smoke,
                                 os.path.join(work, "preempt"))
    if calls:
        done = dict(zip(calls, together(smoke, *calls.values())))
        if "h" in arms:
            out["preempt_nccl"] = done.pop("preempt_nccl")
        if "e" in arms:
            out["algorithm_layouts"] = done
        timed("".join(a for a in "eh" if a in arms))
    if "b" in arms:
        out["layouts"] = layouts(torch, smoke, os.path.join(work, "layouts"))
        timed("b")
    if "c" in arms:
        out["gtg_mesh"] = gtg_mesh(torch, smoke, os.path.join(work, "gtg"))
        timed("c")
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
