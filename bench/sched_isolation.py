"""Per-component isolation bench of the scheduling dense-block LS iteration
(where do the 365d x 20e seconds go?).

Variants (vmapped fori_loop of K iterations per dispatch):

  RTT        — an (almost) empty dispatch + host read: the dispatch
               overhead every chunk pays regardless of compute
  V0 change  — the D x E ChangeDay delta block only (n_off=0, n_rand=0)
  V0d +diag  — + the n_off=4 swap diagonals (the default dense block)
  V1 +argmin — V0d + lex_argmin + apply_move (state evolves, no tabu)
  V2 +tabu1  — V1 + winner fingerprint + tabu push + one membership check
  V3 ptc     — full ls_execute, pick-then-check tabu, bail disabled
  V3x exact  — full ls_execute, exact [W, T] filter via dense fp_deltas

Env: ISO_D, ISO_E, ISO_P, ISO_K, ISO_REPS, ISO_CPU.
"""

import datetime
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("ISO_CPU"):
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from constraint_solver_tpu.core.history import TabuRing
from constraint_solver_tpu.core.local_search import LsParams, ls_execute
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec,
    make_scheduling_problem,
)
from constraint_solver_tpu.ops.lex import lex_argmin

D = int(os.environ.get("ISO_D", 365))
E = int(os.environ.get("ISO_E", 20))
P = int(os.environ.get("ISO_P", 64))
K = int(os.environ.get("ISO_K", 100))
REPS = int(os.environ.get("ISO_REPS", 3))


def _force(out):
    import numpy as np

    return jax.tree.map(np.asarray, out)


def timeit(fn, *args):
    out = _force(fn(*args))  # compile
    best = float("inf")
    for _ in range(REPS):
        t0 = time.time()
        out = _force(fn(*args))
        best = min(best, time.time() - t0)
    return best, out


def main():
    print(f"devices: {jax.devices()}", flush=True)
    d0 = datetime.date(2024, 1, 1)
    spec = ScheduleSpec.from_dates(
        d0, d0 + datetime.timedelta(days=D - 1), E,
        {e: [d0 + datetime.timedelta(days=(17 * e + 11 * k) % D)
             for k in range(10)] for e in range(E)},
    )
    prob = make_scheduling_problem(spec, proposer="dense", n_rand_swaps=0)
    prob_ch = make_scheduling_problem(
        spec, proposer="dense", n_swap_offsets=0, n_rand_swaps=0
    )
    width = prob.width

    key = jax.random.key(0)
    keys = jax.random.split(key, P)
    states = jax.vmap(prob.init)(keys)
    scores = jax.vmap(prob.score)(states)
    tabu0 = jax.vmap(lambda _: TabuRing.create(256, 1_000))(jnp.arange(P))

    def rtt(state, score, key):
        return jnp.sum(state) + score[0]

    def block_only(p):
        def f(state, score, key):
            def body(i, acc):
                nb = p.neighborhood(state, score, jax.random.fold_in(key, i))
                return acc + jnp.min(nb.scores[:, 0])
            return jax.lax.fori_loop(0, K, body, jnp.float32(0))
        return f

    def v1_argmin(state, score, key):
        def body(i, carry):
            st, sc = carry
            nb = prob.neighborhood(st, sc, jax.random.fold_in(key, i))
            idx = lex_argmin(nb.scores, nb.valid)
            return prob.apply_move(st, nb.moves, idx), nb.scores[idx]
        _, sc = jax.lax.fori_loop(0, K, body, (state, score))
        return sc

    def v2_tabu1(state, score, key):
        fp0 = prob.fingerprint(state)
        t0 = TabuRing.create(256, 1_000)

        def body(i, carry):
            st, sc, fp, tabu, hits = carry
            tabu = tabu.push(fp)
            nb = prob.neighborhood(st, sc, jax.random.fold_in(key, i))
            idx = lex_argmin(nb.scores, nb.valid)
            cand_fp = prob.move_fp(st, fp, nb.moves, idx)
            hit = tabu.is_tabu(cand_fp[None, :])[0]
            st = prob.apply_move(st, nb.moves, idx)
            return st, nb.scores[idx], cand_fp, tabu, hits + hit.astype(jnp.int32)

        _, sc, _, _, hits = jax.lax.fori_loop(
            0, K, body, (state, score, fp0, t0, jnp.int32(0))
        )
        return sc, hits

    def v2x_filter(state, score, key):
        """V2 with the full [W, T] exact filter in place of the single
        winner check — isolates the filter-matrix share of the V3x
        residual."""
        fp0 = prob.fingerprint(state)
        t0 = TabuRing.create(256, 1_000)

        def body(i, carry):
            st, sc, fp, tabu = carry
            tabu = tabu.push(fp)
            nb = prob.neighborhood(st, sc, jax.random.fold_in(key, i))
            fps_all = fp[None, :] ^ nb.fp_deltas
            ok = nb.valid & ~tabu.is_tabu(fps_all)
            idx = lex_argmin(nb.scores, ok)
            cand_fp = fps_all[idx]
            st = prob.apply_move(st, nb.moves, idx)
            return st, nb.scores[idx], cand_fp, tabu

        _, sc, _, _ = jax.lax.fori_loop(0, K, body, (state, score, fp0, t0))
        return sc

    def v2xb_best(state, score, key):
        """v2x + the engine's best/bail bookkeeping carries (best state
        tree-selects, no_improve counter) in the same fori loop — what
        remains to V3x is the while_loop structure + carry relayouts."""
        from constraint_solver_tpu.core.local_search import _select
        from constraint_solver_tpu.ops.lex import lex_less

        fp0 = prob.fingerprint(state)
        t0 = TabuRing.create(256, 1_000)

        def body(i, carry):
            st, sc, fp, tabu, b_st, b_sc, ni = carry
            tabu = tabu.push(fp)
            nb = prob.neighborhood(st, sc, jax.random.fold_in(key, i))
            fps_all = fp[None, :] ^ nb.fp_deltas
            ok = nb.valid & ~tabu.is_tabu(fps_all)
            idx = lex_argmin(nb.scores, ok)
            cand_fp = fps_all[idx]
            cand_sc = nb.scores[idx]
            st2 = prob.apply_move(st, nb.moves, idx)
            improved = lex_less(cand_sc, sc)
            b_st = _select(improved, st2, b_st)
            b_sc = jnp.where(improved, cand_sc, b_sc)
            ni = jnp.where(improved, 0, ni + 1)
            return st2, cand_sc, cand_fp, tabu, b_st, b_sc, ni

        out = jax.lax.fori_loop(
            0, K, body,
            (state, score, fp0, t0, state, score, jnp.int32(0)),
        )
        return out[5]

    def v3(exact, fixed_trip=False, ring=256):
        params = LsParams(
            max_iterations=K, allow_no_improvement_for=K + 1,
            tabu_exact_filter=exact, tabu_forced=True,
            fixed_trip=fixed_trip,
        )

        def f(state, score, key, tabu):
            _, best_score, tabu, iters, exhausted = ls_execute(
                prob, params, state, tabu, key
            )
            return best_score, iters, exhausted
        return f

    variants = [
        ("RTT empty-dispatch", jax.jit(jax.vmap(rtt)), (states, scores, keys), 1),
        ("V0 change-block", jax.jit(jax.vmap(block_only(prob_ch))),
         (states, scores, keys), K),
        ("V0d +diagonals", jax.jit(jax.vmap(block_only(prob))),
         (states, scores, keys), K),
        ("V1 +argmin+apply", jax.jit(jax.vmap(v1_argmin)),
         (states, scores, keys), K),
        ("V2 +tabu-single", jax.jit(jax.vmap(v2_tabu1)),
         (states, scores, keys), K),
        ("V2x +[W,T]-filter", jax.jit(jax.vmap(v2x_filter)),
         (states, scores, keys), K),
        ("V2xb +best/bail bk", jax.jit(jax.vmap(v2xb_best)),
         (states, scores, keys), K),
        ("V3 full (ptc)", jax.jit(jax.vmap(v3(False))),
         (states, scores, keys, tabu0), K),
        ("V3x full (exact)", jax.jit(jax.vmap(v3(True))),
         (states, scores, keys, tabu0), K),
        ("V3f exact fixed-trip", jax.jit(jax.vmap(v3(True, fixed_trip=True))),
         (states, scores, keys, tabu0), K),
    ]
    if os.environ.get("ISO_T64"):
        tabu64 = jax.vmap(lambda _: TabuRing.create(64, 1_000))(jnp.arange(P))
        variants.append(
            ("V3x exact T=64", jax.jit(jax.vmap(v3(True))),
             (states, scores, keys, tabu64), K))

    print(f"D={D} E={E} P={P} K={K} iters/dispatch, width={width}", flush=True)
    for name, fn, args, iters in variants:
        wall, out = timeit(fn, *args)
        ms_per_iter = 1000.0 * wall / iters
        rate = P * width * iters / wall
        extra = ""
        if name.startswith("V3"):
            extra = f" exhausted={int(jnp.sum(out[2]))}/{P * K}"
        print(
            f"{name:20s} {wall * 1000:8.1f} ms / {iters} iters = "
            f"{ms_per_iter:6.2f} ms/iter  ({rate:.3g} moves/s){extra}",
            flush=True,
        )


if __name__ == "__main__":
    main()
