"""One process of ``tests/test_torch_distributed_integration.py``.

Run as ``python tests/torch_dist_worker.py`` with ``OS_DIST_*`` set by the
parent. It joins the group through the production entry
(``parallel.distributed.maybe_init_distributed``, gloo on the CPU, no
mocks) and proves that a collective sees both processes: an all_gather of
(rank + 1) sums to 1 + 2 = 3, and an all_reduce of 2 * (rank + 1) (the
JAX worker's psum over two devices per process) to 2 + 4 = 6. Prints one
line the parent checks.
"""

import sys

import torch

from open_speech_tpu_torch.parallel.distributed import maybe_init_distributed


def main() -> None:
    assert maybe_init_distributed(), "OS_DIST_* env not picked up"
    import torch.distributed as dist

    assert dist.get_world_size() == 2, dist.get_world_size()
    rank = dist.get_rank()
    mine = torch.tensor([float(rank + 1)])
    parts = [torch.zeros(1) for _ in range(2)]
    dist.all_gather(parts, mine)
    total = float(torch.cat(parts).sum())
    both = torch.tensor([2.0 * (rank + 1)])
    dist.all_reduce(both)
    print(f"DIST_OK pid={rank} allgather={total} allreduce={float(both)}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
    sys.exit(0)
