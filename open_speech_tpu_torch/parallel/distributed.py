"""Multi-process launch: ``torch.distributed`` init and the replica topology.

Counterpart of ``open_speech_tpu/parallel/distributed.py``. The serving
topology is the same:

  - within a host: tensor parallelism. ``OS_TPU_MESH="d,m"`` shards the
    model over ``m`` ranks of one host (``parallel/mesh.py``); its
    all-reduces stay on that host.
  - across hosts: data parallelism by REPLICATION. Each host runs its own
    ``python -m open_speech_tpu_torch.server`` and serves on its own; an
    HTTP/WS load balancer spreads sessions. Inference keeps no state across
    replicas, so no collective crosses hosts on a request path.
  - a process group is needed only where one program spans processes:
    tensor-parallel ranks, and data-parallel fine-tuning (``train.py``).
    ``maybe_init_distributed()`` wires it from the environment.

PyTorch runs one process per rank (the JAX package drives every device
from one process). Env (all optional; none set means one process and no
group):
  OS_DIST_COORDINATOR   host:port of rank 0 (e.g. "10.0.0.2:8476")
  OS_DIST_NUM_PROCESSES the world size
  OS_DIST_PROCESS_ID    this process's rank (0-based)
  OS_DIST_AUTO=1        join with none of the three: torchrun's
                        environment (``init_method="env://"``:
                        MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) says
                        all of it. Without a coordinator, a world size or
                        rank left unset is read from there too.

The backend is NCCL when the STT device is CUDA and gloo otherwise. Under
NCCL a process with torchrun's ``LOCAL_RANK`` takes that card as its
default; other launches give each process its card
(``CUDA_VISIBLE_DEVICES``).
"""

from __future__ import annotations

import logging
import os

import torch

logger = logging.getLogger(__name__)

_initialized = False


def maybe_init_distributed() -> bool:
    """Join the process group the environment describes; a no-op returning
    False when it describes none. Returns True once a group exists (also
    on a second call, which does nothing)."""
    global _initialized
    if _initialized:
        return True
    coordinator = os.environ.get("OS_DIST_COORDINATOR")
    n_str = os.environ.get("OS_DIST_NUM_PROCESSES")
    pid_str = os.environ.get("OS_DIST_PROCESS_ID")
    auto = os.environ.get("OS_DIST_AUTO", "").lower() in ("1", "true", "yes")
    if not coordinator and not n_str and not auto:
        return False  # one process: the common case
    import torch.distributed as dist

    from open_speech_tpu_torch.config import settings

    backend = "nccl" if torch.device(settings.stt_device).type == "cuda" else "gloo"
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        # torchrun's ranks on one host: one card each (NCCL refuses two
        # ranks on one card), before anything lands on the default card
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    # a variable left unset is read from torchrun's environment
    kwargs: dict = {"init_method": f"tcp://{coordinator}" if coordinator else "env://"}
    if n_str:
        kwargs["world_size"] = int(n_str)
    if pid_str is not None:
        kwargs["rank"] = int(pid_str)
    dist.init_process_group(backend, **kwargs)
    _initialized = True
    logger.info(
        "torch.distributed initialized (%s): rank %d of %d",
        backend, dist.get_rank(), dist.get_world_size(),
    )
    return True


def replica_info() -> dict:
    """This process's place among replicas (for ``/api/stats``), with the
    JAX package's keys: the rank and world size (0 and 1 without a group)
    and the cards this process sees.

    Never creates a CUDA context or a process group: callers sit on the
    server's event loop. ``torch.cuda.device_count`` counts the cards
    without initialising CUDA in this process.
    """
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            rank, world = 0, 1
        local = torch.cuda.device_count()
        return {"replica": rank, "replica_count": world,
                "local_devices": local, "global_devices": local * world}
    except Exception:  # noqa: BLE001 — never let health reporting throw
        return {"replica": 0, "replica_count": 1, "local_devices": 0, "global_devices": 0}
