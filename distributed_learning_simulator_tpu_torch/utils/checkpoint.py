"""Checkpoint and resume of (global params, client state, round, algo state)
(utils/checkpoint.py of the JAX package): single-file checkpoints, and
the per-rank shards and manifest of a multihost streamed run.

The format is the JAX package's, so each package reads the other's files:
``b"DLSC"`` magic, a little-endian ``(crc32: u32, payload_len: u64)``
header, and a pickle of host objects (numpy arrays, dicts, floats). The
CRC recorded at save time is verified at load (:class:`CheckpointCorruptError`
on a mismatch or truncation), and :func:`load_latest_valid_checkpoint`
walks back to the newest valid checkpoint, so a write torn by a crash or
disk corruption costs one checkpoint interval instead of the run.
Headerless files load as legacy (pre-CRC) raw pickles.

Writes are atomic (``.tmp`` + ``os.replace``): a crashed writer can leave a
stale ``*.ckpt.tmp`` behind, never a torn ``*.ckpt``.

The payload keys are the JAX package's: ``round_idx``, ``global_params``
(the JAX parameter tree of numpy arrays, models/bridge.py), ``client_state``
and ``algo_state`` (host copies of the port's per-client and server
optimizer state), and ``rng_key`` (the key chain's uint32 key data).
"""

from __future__ import annotations

import os
import pickle
import re
import struct
import zlib

import numpy as np
import torch

from distributed_learning_simulator_tpu_torch.utils.logging import get_logger

_MAGIC = b"DLSC"
_HEADER = struct.Struct("<IQ")  # crc32, payload byte length
# Round-numbered checkpoint files: anything else in checkpoint_dir (a stray
# `foo.ckpt`, editor droppings) is ignored by discovery.
_CKPT_RE = re.compile(r".*_(\d+)\.ckpt$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed integrity verification (truncated header,
    payload length mismatch, CRC mismatch, or an unreadable legacy pickle).
    """


def to_host(tree):
    """``tree`` with every tensor copied to a numpy array (dicts, lists and
    tuples kept; anything else as it is)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _write_framed(path: str, payload: dict) -> str:
    """CRC-framed atomic write of ``payload``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(_HEADER.pack(zlib.crc32(blob), len(blob)))
        f.write(blob)
    os.replace(tmp, path)  # atomic: never leaves a torn checkpoint
    return path


def save_checkpoint(path: str, round_idx: int, global_params, client_state,
                    algo_state: dict | None = None, rng_key=None) -> str:
    payload = {
        "round_idx": round_idx,
        "global_params": to_host(global_params),
        "client_state": to_host(client_state),
        "algo_state": to_host(algo_state or {}),
        "rng_key": None if rng_key is None else np.asarray(
            rng_key, dtype=np.uint32),
    }
    return _write_framed(path, payload)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[: len(_MAGIC)] == _MAGIC:
        header_end = len(_MAGIC) + _HEADER.size
        if len(raw) < header_end:
            raise CheckpointCorruptError(
                f"{path}: truncated before the end of the header "
                f"({len(raw)} bytes)"
            )
        crc, length = _HEADER.unpack(raw[len(_MAGIC):header_end])
        blob = raw[header_end:]
        if len(blob) != length:
            raise CheckpointCorruptError(
                f"{path}: payload truncated ({len(blob)} of {length} bytes)"
            )
        if zlib.crc32(blob) != crc:
            raise CheckpointCorruptError(
                f"{path}: CRC mismatch (recorded {crc:#010x}, computed "
                f"{zlib.crc32(blob):#010x})"
            )
        try:
            payload = pickle.loads(blob)
        except Exception as e:
            # CRC-valid but unpicklable (a library changed between save and
            # resume): corrupt as far as the fallback scan is concerned.
            raise CheckpointCorruptError(
                f"{path}: CRC-valid but unpicklable payload ({e})"
            ) from e
    else:
        # Legacy pre-CRC checkpoint: a raw pickle stream, unverifiable; an
        # unreadable one is corrupt so that the fallback scan walks on.
        try:
            payload = pickle.loads(raw)
        except Exception as e:
            raise CheckpointCorruptError(
                f"{path}: unreadable legacy checkpoint ({e})"
            ) from e
    if payload.get("rng_key") is not None:
        payload["rng_key"] = np.asarray(payload["rng_key"], dtype=np.uint32)
    return payload


def checkpoint_rounds(directory: str) -> list[tuple[int, str]]:
    """``(round, path)`` for every round-numbered checkpoint, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for f in os.listdir(directory):
        m = _CKPT_RE.match(f)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, f)))
    out.sort()
    return out


def sweep_stale_tmps(directory: str) -> list[str]:
    """Remove the ``*.ckpt.tmp`` files a crashed writer left behind.

    Called at resume time only: one writer saves at a time, so any tmp file
    present when a run starts is garbage from an earlier process.
    """
    removed = []
    if not os.path.isdir(directory):
        return removed
    for f in os.listdir(directory):
        if f.endswith(".ckpt.tmp"):
            try:
                os.remove(os.path.join(directory, f))
                removed.append(f)
            except OSError:
                pass
    if removed:
        get_logger().info(
            "removed %d stale checkpoint tmp file(s) left by a crashed "
            "writer: %s", len(removed), ", ".join(sorted(removed)),
        )
    return removed


def latest_checkpoint(directory: str) -> str | None:
    """Read-only discovery: does not sweep tmp files, since a writer may be
    mid-save."""
    rounds = checkpoint_rounds(directory)
    return rounds[-1][1] if rounds else None


def load_latest_valid_checkpoint(
        directory: str) -> tuple[str | None, dict | None]:
    """The newest checkpoint that passes verification, as ``(path,
    payload)``; ``(None, None)`` when none does. A corrupt, truncated or
    unreadable candidate is logged and skipped."""
    sweep_stale_tmps(directory)
    for _, path in reversed(checkpoint_rounds(directory)):
        try:
            return path, load_checkpoint(path)
        except (CheckpointCorruptError, OSError) as e:
            get_logger().warning(
                "checkpoint %s failed verification (%s); falling back to "
                "the previous checkpoint", path, e,
            )
    return None, None


# --- per-host checkpoint shards + manifest (multihost streamed) -------------
#
# Under ``client_residency='streamed'`` + multihost the store — the
# checkpoint's source of truth — is host-SHARDED (each process owns an
# N/num_hosts client slice, data/residency.DistributedShardStore), so a
# checkpoint becomes: one CRC-framed shard PER HOST (that host's owned
# per-client state slice plus the replicated global state, so every
# shard restores its own process without cross-host reads) and a
# manifest (written by process 0 AFTER every shard landed) recording
# the topology the shards were cut for. Resume validates the manifest
# against the live topology and refuses mismatches with the cause
# named; a round whose manifest never landed (a host died between its
# shard write and the barrier) is invisible to discovery, so resume
# falls back one checkpoint interval — the whole-checkpoint torn-write
# discipline, at shard granularity. Shard/manifest filenames
# deliberately do NOT match ``_CKPT_RE``: legacy single-file discovery
# never sees them, and a single-process resume pointed at a sharded
# directory is refused by the simulator (via :func:`manifest_rounds`)
# instead of silently starting from scratch.

_SHARD_RE = re.compile(r".*_(\d+)\.host(\d+)-of-(\d+)\.ckptshard$")
_MANIFEST_RE = re.compile(r".*_(\d+)\.manifest\.json$")


def shard_checkpoint_path(directory: str, round_idx: int, host_id: int,
                          n_hosts: int) -> str:
    return os.path.join(
        directory, f"round_{round_idx}.host{host_id}-of-{n_hosts}.ckptshard"
    )


def manifest_checkpoint_path(directory: str, round_idx: int) -> str:
    return os.path.join(directory, f"round_{round_idx}.manifest.json")


def save_shard_checkpoint(directory: str, round_idx: int, host_id: int,
                          n_hosts: int, payload: dict,
                          span_recorder=None) -> str:
    """Write this host's checkpoint shard (CRC-framed, atomic).

    ``span_recorder`` (telemetry/spans.SpanRecorder, span_trace='on'):
    the write lands as a per-host ``ckpt_shard_write`` io span — the
    per-host half of the checkpoint-barrier skew story (a slow disk here
    shows up as the OTHER hosts' ``ckpt_barrier_wait``)."""
    payload = to_host(dict(payload))
    payload["round_idx"] = round_idx
    payload["host_id"] = host_id
    payload["n_hosts"] = n_hosts
    path = shard_checkpoint_path(directory, round_idx, host_id, n_hosts)
    if span_recorder is None:
        return _write_framed(path, payload)
    with span_recorder.span(
        "ckpt_shard_write", "io", round_idx=round_idx
    ) as sp:
        out = _write_framed(path, payload)
        try:
            sp["bytes"] = os.path.getsize(out)
        except OSError:
            pass
    return out


def write_manifest(directory: str, round_idx: int, manifest: dict,
                   span_recorder=None) -> str:
    """Write the round's manifest (process 0, after the shard barrier).

    Atomic like the shards; its EXISTENCE is the round's commit record —
    discovery only offers rounds whose manifest landed. The optional
    ``span_recorder`` journals the commit as a ``ckpt_manifest`` io
    span."""
    import json

    manifest = dict(manifest)
    manifest["round"] = round_idx
    path = manifest_checkpoint_path(directory, round_idx)

    def _write() -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True)
        os.replace(tmp, path)
        return path

    if span_recorder is None:
        return _write()
    with span_recorder.span("ckpt_manifest", "io", round_idx=round_idx):
        return _write()


def manifest_rounds(directory: str) -> list[tuple[int, str]]:
    """``(round, manifest_path)`` for every sharded checkpoint round,
    ascending. Empty for non-sharded (or absent) directories."""
    if not os.path.isdir(directory):
        return []
    out = []
    for f in os.listdir(directory):
        m = _MANIFEST_RE.match(f)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, f)))
    out.sort()
    return out


def validate_manifest(manifest: dict, *, n_hosts: int, n_clients: int,
                      owner_bounds=None) -> None:
    """Refuse a manifest cut for a different topology, naming the cause.

    The shards slice client state by (host count, ownership bounds);
    restoring them into a differently-split run would silently hand
    clients to the wrong owners — exactly the class of quiet corruption
    the cause-named-refusal discipline exists to prevent.
    """
    if int(manifest.get("n_hosts", -1)) != n_hosts:
        raise RuntimeError(
            "multihost checkpoint topology mismatch: manifest was "
            f"written by {manifest.get('n_hosts')} host process(es) but "
            f"this run has {n_hosts}; resume with the host count the "
            "checkpoint was written with (per-host shards cannot be "
            "re-split)"
        )
    if int(manifest.get("n_clients", -1)) != n_clients:
        raise RuntimeError(
            "multihost checkpoint population mismatch: manifest covers "
            f"{manifest.get('n_clients')} clients but this run has "
            f"{n_clients}; resume with the configuration the checkpoint "
            "was written with"
        )
    if owner_bounds is not None:
        want = [int(b) for b in owner_bounds]
        got = [int(b) for b in manifest.get("owner_bounds", [])]
        if want != got:
            raise RuntimeError(
                "multihost checkpoint ownership mismatch: manifest "
                f"bounds {got} != this run's {want} (the mesh's "
                "per-host device split changed); resume on the "
                "topology the checkpoint was written with"
            )


def load_latest_valid_sharded_checkpoint(
    directory: str, host_id: int, n_hosts: int,
) -> tuple[dict | None, dict | None]:
    """Newest sharded checkpoint whose manifest landed, every shard file
    exists, and THIS host's shard passes CRC verification.

    Returns ``(manifest, shard_payload)`` or ``(None, None)``. A
    candidate failing an INTEGRITY check (unreadable manifest, missing
    shard file, CRC mismatch) is logged and skipped — the
    one-interval-degradation contract of
    :func:`load_latest_valid_checkpoint`, at shard granularity. A
    manifest whose host count differs from this run's is a TOPOLOGY
    refusal, raised immediately (never walked past — see the inline
    comment). Cross-host agreement on WHICH round every process
    restored is the simulator's job (its existing allgather check
    covers it).
    """
    import json

    sweep_stale_tmps(directory)
    for round_idx, mpath in reversed(manifest_rounds(directory)):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            get_logger().warning(
                "checkpoint manifest %s unreadable (%s); falling back",
                mpath, e,
            )
            continue
        if int(manifest.get("n_hosts", -1)) != n_hosts:
            # A host-count change is a topology REFUSAL, not corruption:
            # this host's shard path is derived from the CURRENT
            # (host_id, n_hosts), so without this check a resume under a
            # different host count would find no shard, skip every
            # round as "invalid", and silently restart from scratch —
            # exactly the quiet data loss the cause-named-refusal
            # discipline forbids. Raised here (not only in
            # validate_manifest, which the simulator calls after a
            # successful load) so the walk-back loop can never step
            # past it.
            raise RuntimeError(
                "multihost checkpoint topology mismatch: manifest "
                f"{os.path.basename(mpath)} was written by "
                f"{manifest.get('n_hosts')} host process(es) but this "
                f"run has {n_hosts}; resume with the host count the "
                "checkpoint was written with (per-host shards cannot "
                "be re-split)"
            )
        shard_files = manifest.get("shards") or [
            os.path.basename(
                shard_checkpoint_path(directory, round_idx, h,
                                      int(manifest.get("n_hosts", 0)))
            )
            for h in range(int(manifest.get("n_hosts", 0)))
        ]
        missing = [
            s for s in shard_files
            if not os.path.exists(os.path.join(directory, s))
        ]
        if missing:
            get_logger().warning(
                "sharded checkpoint round %d is missing shard(s) %s; "
                "falling back to the previous checkpoint",
                round_idx, ", ".join(missing),
            )
            continue
        my_path = shard_checkpoint_path(directory, round_idx, host_id,
                                        n_hosts)
        try:
            payload = load_checkpoint(my_path)
        except (CheckpointCorruptError, OSError) as e:
            get_logger().warning(
                "checkpoint shard %s failed verification (%s); falling "
                "back to the previous checkpoint", my_path, e,
            )
            continue
        return manifest, payload
    return None, None


def gc_sharded_checkpoints(directory: str,
                           keep_last: int | None) -> list[str]:
    """Retention for sharded checkpoints: keep the newest ``keep_last``
    MANIFEST rounds; older rounds lose their manifest and every shard."""
    if not keep_last or keep_last < 1:
        return []
    removed = []
    drop_rounds = [r for r, _ in manifest_rounds(directory)[:-keep_last]]
    if not drop_rounds:
        return removed
    drop = set(drop_rounds)
    for f in os.listdir(directory):
        m = _SHARD_RE.match(f) or _MANIFEST_RE.match(f)
        if m and int(m.group(1)) in drop:
            try:
                os.remove(os.path.join(directory, f))
                removed.append(os.path.join(directory, f))
            except OSError:
                pass
    return removed


def gc_checkpoints(directory: str, keep_last: int | None) -> list[str]:
    """Delete all but the newest ``keep_last`` round-numbered checkpoints
    (``config.checkpoint_keep_last``; None keeps every one). Runs after
    each save. Best-effort removals; returns the deleted paths."""
    if not keep_last or keep_last < 1:
        return []
    removed = []
    for _, path in checkpoint_rounds(directory)[:-keep_last]:
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed
