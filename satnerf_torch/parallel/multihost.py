"""Process-group start-up for data-parallel training (port of
``satnerf_tpu/parallel/multihost.py``).

The JAX package runs one SPMD program over a device mesh, one process per
host. Here each rank is one process with one device: ``cuda:LOCAL_RANK``
(or the CPU). The ranks join a ``torch.distributed`` process group, from
explicit arguments or from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). The
training CLIs start ``data_parallel`` local ranks themselves when no group
is set up (``launch_local_ranks``).

The backend is explicit: ``nccl`` when each rank has its own card, ``gloo``
only when the caller asks for it, for example for two ranks on one card
(NCCL refuses two ranks on one device) or on the CPU. There is no silent
switch between the two.

All ranks share one run directory; rank 0 alone writes what lives there
(TensorBoard events, the config dump, the log file, the profiler report,
validation TIFs and DSMs, checkpoints), the others wait at a barrier.
"""

from __future__ import annotations

import contextlib
import os
import signal
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from satnerf_torch.logger import logger

BACKENDS = ("nccl", "gloo")


def launched() -> bool:
    """True when torchrun (or ``launch_local_ranks``) set up this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str = "nccl") -> tuple:
    """Join the process group (idempotent) -> (rank, world size).

    With no address, torchrun's environment names the rendezvous; otherwise
    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id``. Under ``nccl`` the rank's card becomes the current
    device.
    """
    if dist.is_initialized():
        logger.warning("Multihost", "process group already initialised")
        return dist.get_rank(), dist.get_world_size()
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if coordinator_address is None:
        if not launched():
            raise RuntimeError("no coordinator address and no RANK/WORLD_SIZE in "
                               "the environment (start the ranks with torchrun)")
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        init_method = f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda", backend))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    logger.info("Multihost", f"rank {rank} of {world} ({backend})")
    return rank, world


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def rank_device(device, backend: str) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK``; under gloo several ranks may
    share a card (LOCAL_RANK modulo the visible cards). A CPU device stays."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    i = local_rank()
    if backend == "nccl" and i >= n:
        raise RuntimeError(f"local rank {i} has no card of its own ({n} visible); "
                           "NCCL needs one card per rank (use gloo to share one)")
    return torch.device("cuda", i % n)


def local_batch_slice(global_batch: int) -> int:
    """Rays this rank renders per step of an evenly sharded global batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the pod's "
            f"{n} devices (realized batch would be {global_batch // n * n})"
        )
    return global_batch // n


@contextlib.contextmanager
def process_group(data_parallel: int, backend: str = "nccl"):
    """Run the body inside the training process group.

    An existing group is kept; under torchrun's environment the group is
    joined here and torn down at the end; ``data_parallel > 1`` with
    neither raises (the CLIs start the ranks: ``launch_local_ranks``).
    """
    if dist.is_initialized():
        yield
        return
    if not launched():
        if data_parallel > 1:
            raise RuntimeError(
                f"data_parallel = {data_parallel} needs {data_parallel} ranks: start "
                "them with torchrun, or through the training CLI, which starts them")
        yield
        return
    initialize_multihost(backend=backend)
    try:
        yield
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local_ranks(module: str, argv: list, n: int) -> int:
    """Run ``python -m module argv`` as ``n`` local ranks with torchrun's
    environment; SIGTERM and SIGINT are passed on to every rank, and a rank
    that fails stops the others (they would wait in a collective). -> the
    first non-zero exit code, else 0."""
    port = free_port()
    # as torchrun: the ranks share the host's cores rather than each taking all
    threads = os.environ.get("OMP_NUM_THREADS", str(max((os.cpu_count() or 1) // n, 1)))
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS=threads)
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=env))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {sig: signal.signal(sig, forward) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs):  # a rank failed
                break
            time.sleep(0.2)
    finally:
        for sig, old in previous.items():
            signal.signal(sig, old)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return next((p.returncode for p in procs if p.returncode), 0)
