"""Inner local-search descent engine.

Accelerator re-design of the reference ``LocalSearch::execute`` loop
(reference local-search/src/local_search.rs:301-343).  Semantics preserved:

- the start solution is scored, and is the returned best if nothing improves;
- each iteration records the current solution in the tabu ring, then
  early-exits returning *current* if ``score.is_best()`` (ref :311-314);
- the candidate neighborhood is proposed and scored **densely in one tensor
  op** (replacing the per-move clone → filter-tabu → rescore → sort loop at
  ref :315-323); tabu candidates are masked out rather than filtered out;
- ``current`` moves to the neighborhood best **even when worse** (ref :335),
  the built-in drift/escape mechanism;
- ``best`` only advances on strict improvement (ref :326-328), and the loop
  bails after ``allow_no_improvement_for`` non-improving iterations
  (ref :329-334) or when no valid candidate exists (ref :336-338).

Divergence (documented per docs/DESIGN.md): tabu is resolved pick-then-check
with a bounded retry budget instead of the reference's filter-every-candidate
(ref :319).  If the budget is exhausted while non-tabu candidates remain, the
iteration counts as non-improving and the descent continues (ending via the
no-improvement bail), rather than scanning past the retry horizon.

The whole loop is a ``lax.while_loop`` — jittable, vmappable over trajectory
populations, shardable over device meshes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from constraint_solver_tpu.core.history import TabuRing
from constraint_solver_tpu.core.problem import Problem
from constraint_solver_tpu.ops.lex import lex_argmin, lex_less


class LsParams(NamedTuple):
    """Mirrors the reference LocalSearch constructor knobs
    (local_search.rs:277-299); window_size is owned by the problem's
    neighborhood function."""

    max_iterations: int  # static loop bound
    allow_no_improvement_for: int
    # Tabu is resolved pick-then-check: argmin, fingerprint the winner,
    # re-pick if tabu — at most this many times.  (The reference filters
    # every candidate before scoring, ref local_search.rs:319; hashing all
    # W candidates against the whole ring would dominate the device time
    # for WIDE neighborhoods.)
    tabu_retries: int = 8
    # The reference's EXACT filter-every-candidate (ref local_search.rs:319):
    # fingerprint all W candidates (O(1) incremental each), mask the whole
    # neighborhood against the ring in one [W, T] op, and pick the best
    # non-tabu candidate.  Affordable — and measured necessary — for
    # small-W domains: the dense scheduling proposer exhausted the retry
    # budget on 59.8% of iterations (bench/tabu_exhaustion.py at commit
    # 9d1252d, 31d x 7e), while nqueens-1000's 50k-wide block never retries at all
    # (0/12,800) and would pay 50k x T compares per iteration here.
    # SolverConfig auto-enables this when width * ring <= ~2M, and the
    # engine upgrades to it whenever the proposer supplies free dense
    # fingerprints (Neighborhood.fp_deltas) unless tabu_forced pins a mode.
    tabu_exact_filter: bool = False
    tabu_forced: bool = False
    # Noisy selection: when > 1, the applied move
    # is SAMPLED from the ``select_topk`` lexicographically-best valid
    # non-tabu candidates with Gumbel weight exp(-score/select_temp)
    # (ops/lex.noisy_lex_select) instead of taking the global argmin —
    # full-width dense evaluation with a noisy descent's diffusion.  Only
    # the exact-filter path honors it (the wide pick-then-check domains
    # already sample their candidate sets).  The selection key derives
    # from the neighborhood key by fold_in, so 0 leaves every existing
    # trajectory bit-identical.
    select_topk: int = 0
    select_temp: float = 1.0
    # Fixed-trip loops: run the descent (and the pick-then-check retry
    # loop) for their STATIC bounds with per-lane carry masking instead of
    # data-dependent while_loops.  Required whenever the problem's
    # functions contain collectives and lanes are sharded over another
    # mesh axis (pop x seq): a data-dependent trip count diverges across
    # shards, executing the in-loop collectives different numbers of times
    # per shard — a deadlock.  The masking select replicates vmap's
    # while-batching rule exactly, so trajectories are bit-identical to
    # the while form; only wall-clock differs (no early loop exit).
    fixed_trip: bool = False


class _LsCarry(NamedTuple):
    state: Any
    score: jax.Array
    fp: jax.Array
    best_state: Any
    best_score: jax.Array
    tabu: TabuRing
    key: jax.Array
    no_improve: jax.Array
    it: jax.Array
    done: jax.Array
    # Iterations where the pick-then-check retry budget ran out with valid
    # candidates remaining (the documented divergence from the reference's
    # exact filter, ref local_search.rs:319) — exposed so the divergence is
    # MEASURED, not just documented (docs/DESIGN.md).
    exhausted: jax.Array


def _select(pred: jax.Array, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def _pick_then_check(problem, params, nb, tabu, c, n_valid, iota_w, retries):
    """Pick-then-check tabu resolution for WIDE neighborhoods: take the
    lexicographic best candidate, fingerprint it in O(1), and re-pick
    (excluding already examined candidates) while it is tabu, examining at
    most ``tabu_retries`` candidates.  Mirrors the reference's "tabu
    candidates are never chosen" invariant without the O(W x T) membership
    matrix.  The first pick runs OUTSIDE the retry loop (it is the only one
    that ever executes in practice — measured first-pick tabu-hit rate
    0/12,800 on nqueens-1000, bench/ls_isolation.py at commit 9d1252d) and
    uses the
    proposer's ``hint_idx`` when available; retries track a tiny exclusion
    list instead of carrying/rewriting the full [W] validity mask through
    the loop.  Returns (idx, cand_fp, found, exhausted_event)."""
    idx0 = (
        nb.hint_idx
        if nb.hint_idx is not None
        else lex_argmin(nb.scores, nb.valid)
    )
    idx0 = idx0.astype(jnp.int32)
    fp0 = problem.move_fp(c.state, c.fp, nb.moves, idx0)
    found0 = (~tabu.is_tabu(fp0[None, :])[0]) & (n_valid > 0)
    excl0 = jnp.full((retries,), -1, jnp.int32).at[0].set(idx0)

    def pick_cond(p):
        _idx, _fp, found, tries, _excl = p
        # tries counts candidates examined so far; stop when found, at
        # the retry budget, or when every valid candidate was examined.
        return (~found) & (tries < retries) & (tries < n_valid)

    def pick_body(p):
        _idx, _fp, _found, tries, excl = p
        mask = nb.valid
        for k in range(retries):  # static unroll; -1 slots never match
            mask = mask & (iota_w != excl[k])
        idx = lex_argmin(nb.scores, mask).astype(jnp.int32)
        fp = problem.move_fp(c.state, c.fp, nb.moves, idx)
        hit = tabu.is_tabu(fp[None, :])[0]
        excl = jax.lax.dynamic_update_index_in_dim(excl, idx, tries, 0)
        return (idx, fp, ~hit, tries + 1, excl)

    pick_init = (idx0, fp0, found0, jnp.int32(1), excl0)
    if params.fixed_trip:
        # Shard-uniform trip count (see LsParams.fixed_trip): retries-1
        # masked steps instead of a data-dependent while.
        idx, cand_fp, found, tries, _ = jax.lax.fori_loop(
            0,
            retries - 1,
            lambda _, p: _select(pick_cond(p), pick_body(p), p),
            pick_init,
        )
    else:
        idx, cand_fp, found, tries, _ = jax.lax.while_loop(
            pick_cond, pick_body, pick_init
        )
    # Retry-budget exhaustion: stopped without a non-tabu winner while
    # unexamined valid candidates remained (measured divergence, see
    # _LsCarry).
    exhausted_event = (~found) & (n_valid > tries)
    return idx, cand_fp, found, exhausted_event


def ls_execute(
    problem: Problem,
    params: LsParams,
    start_state: Any,
    tabu: TabuRing,
    key: jax.Array,
    enabled: jax.Array | bool = True,
):
    """Run one local-search descent from ``start_state``.

    Returns ``(best_state, best_score, tabu, iterations_used)``.  The tabu
    ring persists across calls, as the reference ``LocalSearch`` keeps its
    private ``History`` alive across ILS rounds (local_search.rs:265, :310).

    ``enabled=False`` makes the whole descent a cheap no-op (used to gate
    converged trajectories inside vmapped populations, where Python-level
    branching is impossible).
    """
    start_score = problem.score(start_state)
    start_fp = problem.fingerprint(start_state)

    carry = _LsCarry(
        state=start_state,
        score=start_score,
        fp=start_fp,
        best_state=start_state,
        best_score=start_score,
        tabu=tabu,
        key=key,
        no_improve=jnp.int32(0),
        it=jnp.int32(0),
        done=~jnp.asarray(enabled),
        exhausted=jnp.int32(0),
    )

    def cond(c: _LsCarry):
        return (c.it < params.max_iterations) & ~c.done

    def body(c: _LsCarry) -> _LsCarry:
        tabu = c.tabu.push(c.fp)
        # Early exit: best possible score reached — the reference returns the
        # *current* solution here (local_search.rs:311-314).
        hit_best = problem.is_best(c.score)

        key, k_nb = jax.random.split(c.key)
        nb = problem.neighborhood(c.state, c.score, k_nb)

        retries = params.tabu_retries
        n_valid = nb.n_valid if nb.n_valid is not None else jnp.sum(nb.valid)
        iota_w = jnp.arange(nb.valid.shape[0])

        use_exact = (
            params.tabu_exact_filter
            if params.tabu_forced
            else params.tabu_exact_filter or nb.fp_deltas is not None
        )
        if use_exact:
            # Reference-exact filter-then-pick (ref local_search.rs:319):
            # all W candidate fingerprints (O(1) incremental each), one
            # [W, T] ring-membership op, best non-tabu candidate.  An
            # all-tabu neighborhood is EMPTY to the reference (its filter
            # runs before scoring), so found=False here flows into the
            # same no-candidate handling below; the retry-exhaustion
            # divergence does not exist on this path.  Proposers that hash
            # their batch densely supply ``fp_deltas`` (one [W, 2] XOR
            # here); only without them does the vmapped move_fp fallback —
            # W gathers — run, which is why the auto
            # threshold (SolverConfig) keeps that fallback off wide blocks.
            if nb.fp_deltas is not None:
                fps_all = c.fp[None, :] ^ nb.fp_deltas
            else:
                fps_all = jax.vmap(
                    lambda i: problem.move_fp(c.state, c.fp, nb.moves, i)
                )(iota_w)
            ok = nb.valid & ~tabu.is_tabu(fps_all)
            found = jnp.any(ok)
            if params.select_topk > 1:
                from constraint_solver_tpu.ops.lex import noisy_lex_select

                idx = noisy_lex_select(
                    nb.scores, ok, params.select_topk, params.select_temp,
                    jax.random.fold_in(k_nb, 0x6E6F6973),
                )
            else:
                idx = lex_argmin(nb.scores, ok).astype(jnp.int32)
            cand_fp = fps_all[idx]
            exhausted_event = jnp.asarray(False)
        else:
            idx, cand_fp, found, exhausted_event = _pick_then_check(
                problem, params, nb, tabu, c, n_valid, iota_w, retries
            )

        cand_score = nb.scores[idx]
        cand_state = problem.apply_move(c.state, nb.moves, idx)
        any_valid = found
        # Distinguish a genuinely empty neighborhood (reference breaks the
        # descent, local_search.rs:336-338) from tabu-retry exhaustion —
        # valid non-tabu candidates may remain beyond the retry budget, so
        # that case counts as a non-improving iteration and the descent
        # continues (it still ends via the no-improvement bail).  On the
        # exact-filter path the reference's tabu filter precedes scoring,
        # so an all-tabu neighborhood IS empty and breaks the descent.
        empty_nbr = ~found if use_exact else (n_valid == 0)

        improved = lex_less(cand_score, c.score) & any_valid
        step = any_valid & ~hit_best

        no_improve = jnp.where(improved, 0, c.no_improve + 1)
        bail = (~improved) & (no_improve >= params.allow_no_improvement_for)

        new_best = improved | hit_best
        best_state = _select(
            new_best, _select(hit_best, c.state, cand_state), c.best_state
        )
        best_score = jnp.where(
            new_best, jnp.where(hit_best, c.score, cand_score), c.best_score
        )

        return _LsCarry(
            state=_select(step, cand_state, c.state),
            score=jnp.where(step, cand_score, c.score),
            fp=jnp.where(step, cand_fp, c.fp),
            best_state=best_state,
            best_score=best_score,
            tabu=tabu,
            key=key,
            no_improve=jnp.where(step, no_improve, jnp.where(
                ~any_valid, no_improve, c.no_improve
            )),
            it=c.it + 1,
            done=hit_best | bail | empty_nbr,
            exhausted=c.exhausted + exhausted_event.astype(jnp.int32),
        )

    if params.fixed_trip:
        # Shard-uniform trip count (see LsParams.fixed_trip): the masking
        # select IS vmap's while-batching rule, so the final carry is
        # bit-identical to the while form.
        out = jax.lax.fori_loop(
            0,
            params.max_iterations,
            lambda _, c: _select(cond(c), body(c), c),
            carry,
        )
    else:
        out = jax.lax.while_loop(cond, body, carry)
    return out.best_state, out.best_score, out.tabu, out.it, out.exhausted
