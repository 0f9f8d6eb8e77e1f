"""Date-axis sharded schedule scoring — the solver's "context parallelism".

The reference's long axis is the schedule's date axis, scored with sliding
windows of width 2/7/9/14 (reference examples/employee-scheduling/src/
lib.rs:285-339).  SURVEY.md §5 names the device-native equivalent: for very
long schedules, shard the date axis over a mesh axis and exchange a
(max-window - 1)-day **halo** with the successor shard — the exact analog of
sequence/context parallelism's halo exchange in windowed attention.

Mechanics (one ``shard_map`` over axis ``seq``):

- every shard holds D/S contiguous days of the assignment plus sharded
  slices of the static tables (holiday mask, weekend mask, weekday one-hot);
- one ``ppermute`` sends each shard's first 13 days (and 1 weekend flag) to
  its predecessor, so every window that *starts* in a shard can be scored
  locally; window starts past the schedule end are masked by global index;
- day-local constraints (H1-H4, S1) reduce with ``psum``; employee-level
  aggregates (S2 weekday consistency, S3/S4 spreads) psum their count
  matrices and finish replicated, so every shard returns the identical
  global (hard, soft).

Proven equal to the dense one-pass scorer (models/scheduling.py) for random
assignments in tests/test_seq_shard.py.  The collectives ride ICI on a real
pod; here they are exercised on the virtual CPU mesh (SURVEY.md §4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from constraint_solver_tpu.models.scheduling import ScheduleSpec
from constraint_solver_tpu.ops.lex import make_score

HALO = 13  # max window (14) - 1


def make_sharded_schedule_score(spec: ScheduleSpec, mesh, axis: str = "seq"):
    """Returns ``score(assign: int32[D]) -> float32[2]`` computed with the
    date axis sharded over ``mesh.shape[axis]`` devices."""
    n_shards = mesh.shape[axis]
    d_days, n_emp = spec.num_days, spec.num_employees
    local = -(-d_days // n_shards)  # ceil
    d_pad = local * n_shards
    if local < HALO:
        raise ValueError(
            f"each shard needs >= {HALO} days; got {local} "
            f"({d_days} days over {n_shards} shards)"
        )

    holiday = np.zeros((d_pad, n_emp), np.float32)
    holiday[:d_days] = spec.holiday_array().T
    weekend = np.zeros((d_pad,), bool)
    weekend[:d_days] = spec.is_weekend()
    wd_onehot = np.zeros((d_pad, 5), np.float32)
    wd_onehot[:d_days] = spec.weekdays()[:, None] == np.arange(5)

    perm = [(s, (s - 1) % n_shards) for s in range(n_shards)]

    def shard_fn(a_loc, hol_loc, wkd_loc, wd_loc):
        f32 = jnp.float32
        i = jax.lax.axis_index(axis)
        g = i * local + jnp.arange(local)  # global day index of each slot

        halo_a = jax.lax.ppermute(a_loc[:HALO], axis, perm)
        halo_w = jax.lax.ppermute(wkd_loc[:1], axis, perm)
        ext = jnp.concatenate([a_loc, halo_a])        # [local + 13]
        wk_ext = jnp.concatenate([wkd_loc, halo_w])   # [local + 1]
        # Padded days hold -1: one_hot maps them to all-zero rows.
        oh = jax.nn.one_hot(a_loc, n_emp, dtype=f32)
        oh_ext = jax.nn.one_hot(ext, n_emp, dtype=f32)

        # H1 — holidays (ref :272-280).
        h1 = jnp.sum(oh * hol_loc)

        # H2 — consecutive days: pairs starting at g <= D-2 (ref :285-292).
        h2 = jnp.sum(
            jnp.where(g < d_days - 1, ext[:local] == ext[1 : local + 1], False)
        )

        # H3 — consecutive weekends, windows(9) starting at g <= D-9
        # (ref :294-315).
        cond = wk_ext[:local] & wk_ext[1 : local + 1] & (g <= d_days - 9)
        e17 = ext[:local] == ext[7 : local + 7]
        e18 = ext[:local] == ext[8 : local + 8]
        e27 = ext[1 : local + 1] == ext[7 : local + 7]
        e28 = ext[1 : local + 1] == ext[8 : local + 8]
        h3 = jnp.sum(jnp.where(cond, e17.astype(f32) + e18 + e27 + e28, 0.0))

        # Windowed counts over the halo-extended block (H4/S1).
        csum = jnp.concatenate(
            [jnp.zeros((1, n_emp), f32), jnp.cumsum(oh_ext, axis=0)], axis=0
        )
        win14 = csum[14 : local + 14] - csum[:local]
        h4 = jnp.sum(jnp.where((g <= d_days - 14)[:, None], win14 > 3, False))
        win7 = csum[7 : local + 7] - csum[:local]
        s1 = jnp.sum(jnp.where((g <= d_days - 7)[:, None], win7 > 2, False))

        hard = jax.lax.psum(h1 + h2 + h3 + h4, axis)
        s1_tot = jax.lax.psum(s1.astype(f32), axis)

        # Employee-level aggregates: psum the count matrices, finish
        # replicated (identical on every shard).
        wd_counts = jax.lax.psum(wd_loc.T @ oh, axis)  # [5, E]
        tot = jax.lax.psum(jnp.sum(oh, axis=0), axis)  # [E]
        wk_tot = jax.lax.psum(
            jnp.sum(oh * wkd_loc[:, None].astype(f32), axis=0), axis
        )

        wd_present = wd_counts > 0
        n_present = jnp.sum(wd_present, axis=1)
        min_present = jnp.min(jnp.where(wd_present, wd_counts, jnp.inf), axis=1)
        s2 = jnp.sum(jnp.where(n_present > 1, min_present, 0.0))

        present = tot > 0
        n_pres = jnp.sum(present)
        spread = lambda v: jnp.where(
            n_pres >= 2,
            jnp.max(jnp.where(present, v, -jnp.inf))
            - jnp.min(jnp.where(present, v, jnp.inf)),
            0.0,
        )
        soft = s1_tot + s2 + spread(tot) + spread(wk_tot)
        return make_score(hard.astype(f32), soft)

    fn = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=P(),
        )
    )
    def score(assign: jax.Array) -> jax.Array:
        """Host-callable entry: jitted internally, and runs under its own
        mesh context so it composes with solvers that jax.set_mesh a
        different (e.g. pop x nbr) mesh in the same process.  Do NOT wrap
        in an outer jit (set_mesh cannot run under tracing); compose the
        raw shard_fn instead if you need in-jit fusion."""
        with jax.set_mesh(mesh):
            # All device arrays (including the static tables) materialize
            # inside this context — eager outputs commit to the ambient
            # mesh's devices, which may differ from `mesh` in this process.
            # Host round-trip: `assign` may be committed to another mesh's
            # devices; np.asarray detaches it so the padded copy lands here.
            a_pad = jnp.full((d_pad,), -1, jnp.int32).at[:d_days].set(
                jnp.asarray(np.asarray(assign), jnp.int32)
            )
            return fn(
                a_pad,
                jnp.asarray(holiday),
                jnp.asarray(weekend),
                jnp.asarray(wd_onehot),
            )

    return score
