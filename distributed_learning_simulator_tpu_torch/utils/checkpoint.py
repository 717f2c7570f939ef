"""Checkpoint and resume of (global params, client state, round, algo state)
(utils/checkpoint.py of the JAX package, its single-file part).

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
