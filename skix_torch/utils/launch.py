"""Multi-process launch utilities.

Port of ``skix/utils/launch.py`` (the reference's launch layer: PBS
scripts, SAM3's submitit/SLURM + mp.spawn launchers,
sam3/train/train.py:45-86). What remains of it is (a) the rendezvous,
(b) per-process work partitioning for the file-pipelined stages, and (c)
crash-resumable batch semantics (skip-if-exists lives inside each stage
CLI already).

The environment contract is skix's: ``SKIX_COORDINATOR`` (host:port of
process 0), ``SKIX_NUM_PROCESSES``, ``SKIX_PROCESS_ID``,
``SKIX_SHARD_ROOT`` and, for tests, ``SKIX_FAKE_RENDEZVOUS``. The
rendezvous is ``torch.distributed`` with the gloo backend over TCP at the
coordinator: the launcher needs the rendezvous, not collectives, and gloo
lets two processes share one card.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch

log = logging.getLogger(__name__)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> dict:
    """Multi-process rendezvous (idempotent; no-op for one process).

    Env-var driven like the reference's submitit runner: set
    ``SKIX_COORDINATOR``, ``SKIX_NUM_PROCESSES``, ``SKIX_PROCESS_ID`` (or
    pass explicitly). Returns {process_id, num_processes, n_devices,
    n_local_devices}: the card count of this machine, 1 without a card.
    """
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("SKIX_COORDINATOR")
    num_processes = int(num_processes
                        or os.environ.get("SKIX_NUM_PROCESSES", 1))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("SKIX_PROCESS_ID", 0))
    if num_processes > 1:
        if not coordinator:
            raise ValueError(
                "SKIX_NUM_PROCESSES > 1 requires SKIX_COORDINATOR "
                "(host:port of process 0)")
        if dist.is_initialized():
            log.info("torch.distributed already initialized — skipping")
        elif os.environ.get("SKIX_FAKE_RENDEZVOUS"):
            log.info("SKIX_FAKE_RENDEZVOUS set — skipping the real "
                     "rendezvous (tests/smoke only)")
        else:
            dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                    world_size=num_processes,
                                    rank=process_id)
            log.info("torch.distributed initialized: process %d/%d",
                     process_id, num_processes)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_id": process_id,
        "num_processes": num_processes,
        "n_devices": n,
        "n_local_devices": n,
    }


def shard_work(items: Sequence, process_id: int, num_processes: int) -> list:
    """Deterministic per-process slice of a work list (the analog of the
    reference's one-video-per-GPU pool)."""
    return [it for i, it in enumerate(sorted(items, key=str))
            if i % num_processes == process_id]


def main(argv: Optional[list] = None) -> None:
    """``python -m skix_torch.utils.launch <stage> --shard-root=<dir>
    [k=v ...]``

    Rendezvous (if SKIX_NUM_PROCESSES/SKIX_COORDINATOR configured), shard
    the person directories under ``--shard-root`` across processes, and
    run the stage CLI restricted to this process's share via the
    ``only_persons`` override (every person-iterating stage honors it
    through skix_torch.config.iter_person_dirs). Without ``--shard-root``
    the stage runs unsharded."""
    import importlib
    import sys
    from pathlib import Path

    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        raise SystemExit("usage: python -m skix_torch.utils.launch <stage> "
                         "[--shard-root=DIR] [overrides...]")
    stage = args[0]
    overrides = []
    shard_root = os.environ.get("SKIX_SHARD_ROOT")
    for a in args[1:]:
        if a.startswith("--shard-root="):
            shard_root = a.split("=", 1)[1]
        else:
            overrides.append(a)
    info = initialize_distributed()
    if shard_root and info["num_processes"] > 1:
        persons = [d.name for d in sorted(Path(shard_root).iterdir())
                   if d.is_dir()]
        mine = shard_work(persons, info["process_id"],
                          info["num_processes"])
        if not mine:
            log.info("process %d: no persons in its share — exiting",
                     info["process_id"])
            return
        overrides.append("only_persons=" + ",".join(mine))
        log.info("process %d/%d handles persons: %s", info["process_id"],
                 info["num_processes"], ",".join(mine))
    log.info("launching stage %s on process %d/%d (%d devices)", stage,
             info["process_id"], info["num_processes"], info["n_devices"])
    mod = importlib.import_module(f"skix_torch.pipelines.{stage}")
    mod.main(overrides)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
