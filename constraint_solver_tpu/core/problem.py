"""The problem-domain interface of the solver core.

The reference defines five traits — ``Solution``, ``Score``,
``SolutionScoreCalculator``, ``InitialSolutionGenerator``, ``MoveProposer``
(reference local-search/src/local_search.rs:16-90) plus ``Perturbation``
(iterated_local_search.rs:76-88).  A compiled device engine cannot call back into
per-move iterators, so the contract is re-shaped around dense tensors:

- a *solution* is a fixed-shape array pytree ("state"),
- a *score* is ``float32[2]`` = (hard, soft), minimized lexicographically,
- a *neighborhood* is a fixed-width batch of W candidate **moves** with their
  scores (computed by delta evaluation against counters, not by cloning) and
  incrementally-updated fingerprints, plus a validity mask,
- *apply_move* materializes only the single chosen move.

Everything is a jittable pure function on arrays; the engine ``vmap``s the
whole bundle over trajectory populations.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax


class Neighborhood(NamedTuple):
    """A scored batch of W candidate moves from one state.

    scores: float32[W, 2] — candidate (hard, soft) scores.
    moves:  pytree with [W, ...] leaves identifying each move.
    valid:  bool[W]       — padding/sampling validity mask; invalid
                            candidates are never selected.

    Candidate fingerprints are NOT materialized by default: the engine
    resolves tabu membership pick-then-check (argmin first, then fingerprint
    only the winner via ``Problem.move_fp``), so the O(W x T) membership
    matrix and O(W) hashing the reference's filter-then-score order would
    imply (ref local_search.rs:319) never exist on device.  A proposer that
    CAN hash its whole batch densely should set ``fp_deltas`` instead —
    then the engine runs the reference-exact filter for free (measured: the
    pick-then-check retry budget exhausts on >50% of iterations in the
    dense scheduling soft phase, stalling the descent, while vmapping
    ``move_fp`` over W candidates lowers to W serial gathers).

    ``fp_deltas`` (optional): uint32[W, 2] such that candidate ``i``'s
    fingerprint is ``current_fp ^ fp_deltas[i]`` (the XOR fingerprint's
    incremental form, ops/fingerprint.py).  When present, the engine uses
    the reference-exact tabu filter unconditionally — candidates' hashes
    are one [W, 2] XOR, and the [W, T] ring-membership compare is cheap
    relative to the candidate block that produced them.

    ``hint_idx`` (optional): the flat index of the lexicographic-minimum
    valid candidate, when the proposer can produce it more cheaply than a
    separate full-width argmin pass (e.g. the nqueens block emits per-row
    minima as a byproduct of scoring).  MUST be exactly
    ``lex_argmin(scores, valid)`` including first-index tie-breaking — the
    engine uses it verbatim as the first tabu pick and only falls back to
    full-width masked argmin on a (measured-rare) tabu hit.

    ``n_valid`` (optional): the exact count of True entries in ``valid``,
    when the proposer knows it algebraically (e.g. nqueens' mask is a
    [A] column mask broadcast over n rows, so the count is
    sum(col_valid) * n) — saves the engine a [W]-wide reduction per
    iteration.
    """

    scores: jax.Array
    moves: Any
    valid: jax.Array
    hint_idx: jax.Array | None = None
    n_valid: jax.Array | None = None
    fp_deltas: jax.Array | None = None


class Problem(NamedTuple):
    """A constraint problem, expressed as jittable pure functions.

    init:         (key) -> state                 random initial solution
                  (ref: InitialSolutionGenerator, local_search.rs:68-75)
    score:        (state) -> float32[2]          full (hard, soft) score
                  (ref: SolutionScoreCalculator, local_search.rs:58-66)
    is_best:      (score[2]) -> bool[]           early-exit predicate
                  (ref: Score::is_best, local_search.rs:23-27)
    fingerprint:  (state) -> uint32[2]           solution identity
    neighborhood: (state, score[2], key) -> Neighborhood
                  (ref: MoveProposer::iter_local_moves, local_search.rs:79-90)
    move_fp:      (state, cur_fp[2], moves, idx) -> uint32[2]
                  fingerprint of candidate ``idx`` (O(1) incremental)
    apply_move:   (state, moves, idx) -> state   apply candidate ``idx``
    perturb:      (state, is_elite, key) -> state
                  (ref: Perturbation, iterated_local_search.rs:76-88; the
                  is_elite flag mirrors history.is_best_solution intensify/
                  diversify branching, e.g. nqueens lib.rs:304-307)
    name:         domain name for logs/benchmarks.
    """

    name: str
    init: Callable[[jax.Array], Any]
    score: Callable[[Any], jax.Array]
    is_best: Callable[[jax.Array], jax.Array]
    fingerprint: Callable[[Any], jax.Array]
    neighborhood: Callable[[Any, jax.Array, jax.Array], Neighborhood]
    move_fp: Callable[[Any, jax.Array, Any, jax.Array], jax.Array]
    apply_move: Callable[[Any, Any, jax.Array], Any]
    perturb: Callable[[Any, jax.Array, jax.Array], Any]
    # Candidate moves scored per LS iteration (metrics: moves/sec).
    width: int = 0
