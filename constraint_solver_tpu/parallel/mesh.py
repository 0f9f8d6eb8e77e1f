"""Device mesh helpers.

The reference has zero parallelism (single thread, SURVEY.md §2.5); the
scale-out story here is a ``jax.sharding.Mesh`` with two logical axes:

- ``pop`` — data-parallel axis over independent ILS trajectories;
- ``nbr`` — tensor-parallel axis over a single trajectory's candidate
  neighborhood (used for very large instances).

On one device both axes are size 1.  The GPUs of one host are joined all
to all by NVLink, so the mesh's shape follows the algorithm alone; XLA
hands the collectives (psum/all_gather for elite exchange and neighborhood
argmin) to NCCL.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_pop: int | None = None, n_nbr: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_pop is None:
        n_pop = len(devices) // n_nbr
    assert n_pop * n_nbr <= len(devices), (
        f"mesh {n_pop}x{n_nbr} needs {n_pop * n_nbr} devices, have {len(devices)}"
    )
    # Auto axis types: classic GSPMD propagation (the Explicit default of
    # jax>=0.7 demands per-op sharding annotations through vmapped code).
    return jax.make_mesh(
        (n_pop, n_nbr),
        ("pop", "nbr"),
        devices=devices[: n_pop * n_nbr],
        axis_types=(jax.sharding.AxisType.Auto, jax.sharding.AxisType.Auto),
    )


def pop_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (population) axis of every pytree leaf over 'pop'."""
    return NamedSharding(mesh, P("pop"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _put_leaf_global(leaf, sharding: NamedSharding):
    """Place one host leaf onto a (possibly multi-process) sharding.

    ``jax.device_put`` rejects shardings with non-addressable devices; under
    ``jax.distributed`` every process holds the full host copy (checkpoints
    are gathered on save), so each process contributes its addressable
    shards via ``make_array_from_callback``.  PRNG-key leaves round-trip
    through key_data (callback arrays must be concrete dtypes)."""
    import jax.numpy as jnp  # noqa: F401  (kept local: mesh.py is import-light)

    if sharding.is_fully_addressable:
        return jax.device_put(leaf, sharding)
    if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
        data = jax.random.key_data(leaf)
        import numpy as np

        host = np.asarray(data)
        g = jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx]
        )
        return jax.random.wrap_key_data(g)
    import numpy as np

    host = np.asarray(leaf)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx]
    )


def device_put_global(tree, shardings):
    """``jax.device_put(tree, shardings)`` that also works when the mesh
    spans multiple processes.  ``shardings`` is one NamedSharding for every
    leaf, or a matching pytree of them."""
    if isinstance(shardings, NamedSharding):
        return jax.tree.map(lambda l: _put_leaf_global(l, shardings), tree)
    return jax.tree.map(_put_leaf_global, tree, shardings)
