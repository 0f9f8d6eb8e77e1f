"""Dense tabu ring and elite archive.

The reference ``History`` (local-search/src/local_search.rs:105-250) combines
two roles that we split into fixed-shape tensor structures:

- **TabuRing** — the ``all_solutions`` VecDeque + ``all_solutions_lookup``
  HashSet (local_search.rs:113-115) become a ring buffer of fingerprints with
  iteration stamps.  Membership = vectorized equality against the ring with
  an age cutoff.

  NOTE on semantics: the reference's ``_pop_solution_for_age``
  (local_search.rs:182-195) has an inverted condition that drains the deque
  on every insert, so its effective tabu set is only the most recent
  solution (see SURVEY.md §3.4).  We implement the *intended* semantics —
  entries stay tabu until ``expiry`` engine iterations have passed or the
  ring wraps — which is strictly more tabu than the reference.  The quality
  contract is equal-or-better at equal wall-clock, not trajectory
  equivalence.

- **EliteArchive** — the ``best_solutions`` BTreeSet capped at capacity with
  evict-worst-if-new-is-leq insertion (local_search.rs:205-218) becomes a
  fixed-K arena of (score, fingerprint, state) with a validity mask.

Both are pytrees: they vmap over populations and shard over meshes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from constraint_solver_tpu.ops.lex import lex_argmax, lex_argmin, lex_leq


class TabuRing(NamedTuple):
    fps: jax.Array    # uint32[T, 2] fingerprints
    iters: jax.Array  # int32[T] engine iteration when each entry was added
    head: jax.Array   # int32[] next write slot
    count: jax.Array  # int32[] engine iteration counter (ref iteration_count,
    #                   local_search.rs:117)
    expiry: jax.Array  # int32[] age horizon (ref all_solution_iteration_expiry)

    @staticmethod
    def create(capacity: int, expiry: int) -> "TabuRing":
        return TabuRing(
            fps=jnp.zeros((capacity, 2), jnp.uint32),
            iters=jnp.full((capacity,), -(2**31 - 1), jnp.int32),
            head=jnp.int32(0),
            count=jnp.int32(0),
            expiry=jnp.int32(expiry),
        )

    def push(self, fp: jax.Array) -> "TabuRing":
        """Record a visited solution (ref History::seen_solution,
        local_search.rs:155-162).  Like the reference's contains-check, a
        fingerprint already in the ring refreshes its iteration stamp in
        place instead of consuming a new slot — a descent parked on a
        plateau must not flood the ring with duplicates and evict genuinely
        distinct tabu entries."""
        count = self.count + 1
        match = jnp.all(self.fps == fp[None, :], axis=-1)
        present = jnp.any(match)
        slot = jnp.where(present, jnp.argmax(match), self.head)
        # Masked vector updates, not .at[slot].set: the iota==slot select
        # streams the ring in one fused pass (the push sits on the
        # per-iteration hot path).  Not yet compared with a scatter on the
        # H100.
        sel = jnp.arange(self.fps.shape[0]) == slot
        fps = jnp.where(sel[:, None], fp[None, :], self.fps)
        iters = jnp.where(sel, count, self.iters)
        head = jnp.where(
            present, self.head, (self.head + 1) % self.fps.shape[0]
        )
        return self._replace(fps=fps, iters=iters, head=head, count=count)

    def is_tabu(self, fps: jax.Array) -> jax.Array:
        """Vectorized membership: fps uint32[W, 2] → bool[W]
        (ref History::is_solution_tabu, local_search.rs:197-199).

        Layout note: this 3-D broadcast + all(axis=-1) avoids slicing
        ``fps[:, 0]`` out of the interleaved [W, 2] layout (a strided
        relayout); per-lane-plane [W, T] compares are the alternative.  Not
        yet measured on the H100 (bench/sched_isolation.py V2x compares
        them).  The filter's cost scales with ring capacity T, so a small
        ring is the cheap lever."""
        match = jnp.all(fps[:, None, :] == self.fps[None, :, :], axis=-1)  # [W, T]
        alive = self.iters + self.expiry >= self.count  # [T]
        return jnp.any(match & alive[None, :], axis=-1)


class EliteArchive(NamedTuple):
    scores: jax.Array  # float32[K, 2]
    fps: jax.Array     # uint32[K, 2]
    states: Any        # pytree, [K, ...] leaves
    valid: jax.Array   # bool[K]

    @staticmethod
    def create(capacity: int, example_state: Any) -> "EliteArchive":
        states = jax.tree.map(
            lambda x: jnp.zeros((capacity,) + jnp.shape(x), jnp.asarray(x).dtype),
            example_state,
        )
        return EliteArchive(
            scores=jnp.full((capacity, 2), jnp.inf, jnp.float32),
            fps=jnp.zeros((capacity, 2), jnp.uint32),
            states=states,
            valid=jnp.zeros((capacity,), bool),
        )

    def insert(self, score: jax.Array, fp: jax.Array, state: Any) -> "EliteArchive":
        """Insert a local-search result (ref History::local_search_chose_solution,
        local_search.rs:205-218): if not full, insert; else replace the worst
        entry iff ``score <= worst``.  Duplicates (same fingerprint) are
        dropped, mirroring BTreeSet set-semantics."""
        k = self.valid.shape[0]
        dup = jnp.any(jnp.all(self.fps == fp[None, :], axis=-1) & self.valid)
        n_valid = jnp.sum(self.valid)
        full = n_valid >= k
        # Target slot: first invalid slot when not full, else the worst entry.
        first_free = jnp.argmax(~self.valid)
        worst = lex_argmax(self.scores, self.valid)
        slot = jnp.where(full, worst, first_free)
        worst_score = self.scores[worst]
        do_insert = (~dup) & ((~full) | lex_leq(score, worst_score))

        def write(arr, val):
            return jnp.where(do_insert, arr.at[slot].set(val), arr)

        return EliteArchive(
            scores=write(self.scores, score),
            fps=write(self.fps, fp),
            states=jax.tree.map(
                lambda a, v: jnp.where(
                    do_insert,
                    a.at[slot].set(v),
                    a,
                ),
                self.states,
                state,
            ),
            valid=write(self.valid, True),
        )

    def get_best(self):
        """(score[2], fp[2], state) of the best entry
        (ref History::get_best, local_search.rs:238-243)."""
        idx = lex_argmin(self.scores, self.valid)
        return (
            self.scores[idx],
            self.fps[idx],
            jax.tree.map(lambda a: a[idx], self.states),
        )

    def get_best_multiple(self, k: int):
        """Best ``min(k, #valid)`` entries, ascending (ref
        History::get_best_multiple, local_search.rs:230-236).  Returns
        (scores [k, 2], fps [k, 2], states [k, ...], valid [k]) — fixed
        shape, with ``valid`` marking real entries (the reference returns a
        shorter Vec when the archive holds fewer than k).  ``k`` is clamped
        to the archive capacity."""
        n = self.valid.shape[0]
        k = min(k, n)
        masked = jnp.where(self.valid[:, None], self.scores, jnp.inf)
        iota = jnp.arange(n, dtype=jnp.int32)
        hard, soft, perm = jax.lax.sort(
            [masked[:, 0], masked[:, 1], iota],
            num_keys=2, dimension=0, is_stable=True,
        )
        idx = perm[:k]
        return (
            jnp.stack([hard[:k], soft[:k]], axis=-1),
            jnp.take(self.fps, idx, axis=0),
            jax.tree.map(lambda a: jnp.take(a, idx, axis=0), self.states),
            jnp.take(self.valid, idx, axis=0),
        )

    def get_random(self, key: jax.Array):
        """Uniform random valid entry (ref History::get_random_best_solution,
        local_search.rs:220-228).  Caller guarantees >= 1 valid entry."""
        logits = jnp.where(self.valid, 0.0, -jnp.inf)
        idx = jax.random.categorical(key, logits)
        return (
            self.scores[idx],
            self.fps[idx],
            jax.tree.map(lambda a: a[idx], self.states),
        )

    def contains_fp(self, fp: jax.Array) -> jax.Array:
        """Membership by fingerprint (ref History::is_best_solution,
        local_search.rs:201-203, used by perturbation intensify/diversify)."""
        return jnp.any(jnp.all(self.fps == fp[None, :], axis=-1) & self.valid)
