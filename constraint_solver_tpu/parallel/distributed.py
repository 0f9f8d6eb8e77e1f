"""Multi-process initialization and global-mesh construction.

The reference has no inter-process communication at all (SURVEY.md §2.5).
One process drives every GPU of its host: on a single machine with four
cards no ``jax.distributed`` call is needed, ``jax.devices()`` already lists
all four, and ``Mesh(pop, nbr)`` is built over them directly.  Beyond one
host:

- ``jax.distributed.initialize`` wires N processes into one runtime; pass
  the coordinator address, process count and process id explicitly;
- every process then sees the GLOBAL device list, and the same
  ``Mesh(pop, nbr)`` + ``shard_map`` program from ``parallel.sharded`` runs
  SPMD across processes — elite-exchange all_gathers become NCCL
  collectives, with zero code changes in the engine;
- fault story (SURVEY.md §5): checkpoints (utils/checkpoint.py) are plain
  host-side .npz of the full pytree; after a restart, re-initialize and
  resume from the last checkpoint (exact), or re-seed lanes from the
  gathered elite archive (approximate but warm).

Typical multi-process usage:

    import constraint_solver_tpu.parallel.distributed as dist
    dist.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = dist.global_mesh(n_nbr=1)   # all devices on the 'pop' axis
    solver = PopulationSolver(problem, config, population=P, mesh=mesh)

Every process executes the same program; process 0 reads results.
"""

from __future__ import annotations

import jax

from constraint_solver_tpu.parallel.mesh import make_mesh


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
) -> None:
    """Initialize the multi-process runtime.  Nothing in a plain machine
    describes a cluster, so every argument is explicit.  Call once per
    process, before any device use; one process per host needs no call."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_nbr: int = 1):
    """A mesh over ALL devices of all processes: ('pop', 'nbr')."""
    n_dev = len(jax.devices())
    assert n_dev % n_nbr == 0, (n_dev, n_nbr)
    return make_mesh(n_pop=n_dev // n_nbr, n_nbr=n_nbr)


def is_coordinator() -> bool:
    return jax.process_index() == 0
