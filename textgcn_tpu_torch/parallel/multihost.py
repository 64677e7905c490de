"""Process-group start-up for the mesh path: one process per GPU.

Counterpart of ``textgcn_tpu/parallel/multihost.py``.  The JAX package
runs one controller over every device of a host; the port runs one
process per GPU under ``torch.distributed``:

* under ``torchrun`` (its environment: ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) each process joins the
  group through ``env://`` and runs on ``cuda:LOCAL_RANK``;
* without that environment a one-rank group starts in-process, over an
  in-memory store: the counterpart of a single-host mesh;
* a group the caller started already is joined as it is.

``barrier`` waits for every rank (the cooperative checkpoint's saves).

NCCL runs the collectives on the card, gloo on the CPU, which is used only
when the caller asks for it.  Nothing falls back: where the JAX package
logs a failed initialisation and carries on in one process
(``multihost.py:75-77``), the port raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')


def launched() -> bool:
    """True under torchrun; raises on a part of its environment."""
    present = [k for k in TORCHRUN_ENV if k in os.environ]
    if present and len(present) != len(TORCHRUN_ENV):
        missing = sorted(set(TORCHRUN_ENV) - set(present))
        raise RuntimeError(f'incomplete torchrun environment: {present} set, '
                           f'{missing} missing')
    return bool(present)


def local_device(device_type: str) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (0 without torchrun), or
    the CPU.  Raises when the host has fewer cards than that."""
    if device_type == 'cpu':
        return torch.device('cpu')
    if device_type != 'cuda':
        raise ValueError(f'unsupported device type {device_type!r}')
    index = int(os.environ.get('LOCAL_RANK', '0'))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= n:
        raise RuntimeError(f'rank with LOCAL_RANK={index} needs cuda:{index}, '
                           f'but this host has {n} CUDA device(s)')
    return torch.device('cuda', index)


def maybe_initialize(device: torch.device) -> bool:
    """Join or start the process group for ``device``; returns True when
    this call started it (its caller then destroys it)."""
    if dist.is_initialized():
        return False
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if launched():
        dist.init_process_group(backend, init_method='env://')
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def is_primary() -> bool:
    """Rank 0, or the only process: the one that logs and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier():
    """Wait for every rank of the process group; a no-op without one."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == 'nccl':
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
