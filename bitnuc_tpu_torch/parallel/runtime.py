"""Multi-process runtime helpers on ``torch.distributed``.

The counterpart of ``bitnuc_tpu/parallel/runtime.py``, where each host
process calls ``jax.distributed.initialize`` once before it builds meshes.
Here ``initialize`` joins a ``torch.distributed`` process group: ``gloo``
without CUDA, ``nccl`` with it. A mesh stays the devices of one process
(``parallel.mesh``); once the group holds more than one process, the
mesh collectives ``psum``, ``pmax`` and ``all_gather`` also cross it.

With no arguments and none of torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) ``initialize`` does nothing and
the process stays alone; a second call does nothing either.
"""

from __future__ import annotations

import datetime
import os

import torch


def is_initialized() -> bool:
    """True once a process group is up in this process."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    local_device_ids=None,
    timeout_s: float = None,
    **kwargs,
):
    """Join the process group: ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id``, or, where an argument is missing,
    torchrun's ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    The backend is ``nccl`` with CUDA and ``gloo`` without it;
    ``local_device_ids`` names the card this process uses (its first entry
    becomes the current CUDA device); ``timeout_s`` bounds the rendezvous
    and each collective. A no-op in one process and on a second call;
    extra keywords go to ``init_process_group``."""
    if is_initialized():
        return
    env = os.environ
    if (
        coordinator_address is None
        and num_processes is None
        and not ("MASTER_ADDR" in env and "WORLD_SIZE" in env)
    ):
        return  # one process: nothing to do
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if local_device_ids is not None and torch.cuda.is_available():
        ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
        torch.cuda.set_device(int(ids[0]))
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    torch.distributed.init_process_group(
        _backend(),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        **kwargs,
    )


def shutdown() -> None:
    """Leave the process group (a no-op when none is up)."""
    if is_initialized():
        torch.distributed.destroy_process_group()


def world_size() -> int:
    return torch.distributed.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return torch.distributed.get_rank() if is_initialized() else 0


def collective_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the device the group's backend reduces on: the current card
    for ``nccl``, the CPU for ``gloo``."""
    if is_initialized() and torch.distributed.get_backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device())).contiguous()
    return t.cpu().contiguous()


def process_info():
    """{"process_index", "process_count", "local_devices", "global_devices"}:
    the JAX package's keys; a process's devices are its visible cards, or
    the CPU without CUDA, and every process is taken to see as many."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    count = world_size()
    return {"process_index": process_index(), "process_count": count,
            "local_devices": local, "global_devices": local * count}
