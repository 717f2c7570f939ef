"""Logging: global logger + per-run file sink (utils/logging.py of the JAX
package).

One framework-global logger, with an optional file sink at
``log/<algorithm>/<dataset>/<model>/<run-id>.log`` (run id =
seconds_microseconds_pid, unique per run even for same-second starts).
"""

from __future__ import annotations

import logging
import os
import sys
import time

_LOGGER_NAME = "dls_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def _claim_run_path(log_dir: str, stamp: str) -> str:
    """Atomically claim a unique ``<stamp>[_N].log`` in ``log_dir``.

    ``O_CREAT|O_EXCL`` makes the claim race-free across processes: two
    runs that resolve the same stamp (coarse clocks, forked pids) get
    distinct files instead of interleaving one — the collision that used
    to overwrite logs and interleave metrics.jsonl when two runs started
    within the same second.
    """
    path = os.path.join(log_dir, f"{stamp}.log")
    n = 0
    while True:
        try:
            os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return path
        except FileExistsError:
            n += 1
            path = os.path.join(log_dir, f"{stamp}_{n}.log")


def set_file_handler(
    log_root: str,
    algorithm: str,
    dataset: str,
    model: str,
    timestamp: float | None = None,
) -> str:
    """Attach a per-run file sink; returns the log file path.

    Layout parity with reference simulator.py:38-46:
    ``<log_root>/<algorithm>/<dataset>/<model>/<run-id>.log`` — but the
    run id is ``<unix-seconds>_<microseconds>_<pid>`` (plus a counter
    suffix on collision) rather than the reference's bare ``int(ts)``,
    which made two runs starting within the same second overwrite each
    other's log and interleave their ``metrics.jsonl``.
    """
    ts = timestamp if timestamp is not None else time.time()
    log_dir = os.path.join(log_root, algorithm, dataset, model)
    os.makedirs(log_dir, exist_ok=True)
    stamp = f"{int(ts)}_{int((ts % 1) * 1e6):06d}_{os.getpid()}"
    path = _claim_run_path(log_dir, stamp)
    logger = get_logger()
    # One file sink per run: detach the previous run's handler (else a
    # long-lived process fans every later run's lines into all earlier
    # runs' files and leaks descriptors).
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        logger.removeHandler(h)
        h.close()
    handler = logging.FileHandler(path)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    logger.addHandler(handler)
    return path


def set_run_artifacts(
    log_root: str, algorithm: str, dataset: str, model: str
) -> tuple[str, str]:
    """Attach the per-run file sink and create the per-run artifacts dir.

    Returns ``(log_path, artifacts_dir)``. Single source of the per-run
    layout (``<ts>.log`` + ``<ts>_artifacts/`` with ``metrics.jsonl``,
    Shapley pickles, ...) shared by the vmap and threaded execution paths.
    """
    path = set_file_handler(log_root, algorithm, dataset, model)
    artifacts_dir = path[: -len(".log")] + "_artifacts"
    os.makedirs(artifacts_dir, exist_ok=True)
    return path, artifacts_dir


def set_level(level: str) -> None:
    """Parity with the reference's ``--log_level`` CLI flag (simulator.sh:1)."""
    get_logger().setLevel(getattr(logging, level.upper()))
