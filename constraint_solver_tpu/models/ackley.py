"""Ackley test-function domain.

The reference uses the Ackley function as its in-tree engine-test domain:
the L0 math utility (reference math-util/src/ackley.rs:8-42, defaults a=20,
b=0.2, c=2pi) plus the L1 domain impls (reference local-search/src/ackley.rs).

Two scorer layers:

- ``ackley_np`` — float64 numpy host implementation, validated against the
  SFU/Octave golden constants at 1e-12 (ref math-util/src/ackley.rs:54-102).
- ``ackley`` — float32 jnp device implementation (the device compute path),
  validated against the numpy layer.

Domain semantics preserved from the reference:

- init: uniform in [-32.768, 32.768]^d (ref ackley.rs:95-103);
- neighborhood: one shared step size ~ U[min_move, max_move] per proposal,
  candidates = x_i +/- step for every dimension => exactly 2d moves
  (ref ackley.rs:137-195; the shuffled dimension schedule is irrelevant here
  because all candidates are scored at once);
- perturbation: w.p. 100/110 add N(0, 1) to a random subset of dims, clamped
  to the domain box; w.p. 10/110 do nothing (ref ackley.rs:232-261);
- is_best: |f(x)| <= 1e-2 (ref ackley.rs:36-39).
"""

from __future__ import annotations

from functools import lru_cache

import math

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.problem import Neighborhood, Problem
from constraint_solver_tpu.ops.fingerprint import fingerprint_f32, fp_update
from constraint_solver_tpu.ops.lex import make_score

X_MIN, X_MAX = -32.768, 32.768
_A, _B = 20.0, 0.2
_C = 2.0 * math.pi


def ackley_np(x: np.ndarray, a: float = _A, b: float = _B, c: float = _C) -> float:
    """float64 host Ackley (the math-util L0 layer, ref ackley.rs:19-32)."""
    x = np.asarray(x, np.float64)
    d = x.shape[-1]
    sq = np.sum(x * x, axis=-1) / d
    cs = np.sum(np.cos(c * x), axis=-1) / d
    return -a * np.exp(-b * np.sqrt(sq)) - np.exp(cs) + a + math.e


def ackley(x: jax.Array, a: float = _A, b: float = _B, c: float = _C) -> jax.Array:
    """float32 device Ackley over the last axis."""
    d = x.shape[-1]
    sq = jnp.sum(x * x, axis=-1) / d
    cs = jnp.sum(jnp.cos(c * x), axis=-1) / d
    return -a * jnp.exp(-b * jnp.sqrt(sq)) - jnp.exp(cs) + a + math.e


@lru_cache(maxsize=32)
def make_ackley_problem(
    dimensions: int,
    min_move_size: float = 1e-3,
    max_move_size: float = 0.5,
    epsilon_best: float = 1e-2,
) -> Problem:
    d = dimensions

    def init(key):
        return jax.random.uniform(key, (d,), jnp.float32, X_MIN, X_MAX)

    def score(x):
        return make_score(ackley(x))

    def is_best(s):
        return jnp.abs(s[0]) <= epsilon_best

    def fingerprint(x):
        return fingerprint_f32(x)

    def neighborhood(x, _cur_score, key):
        step = jax.random.uniform(
            key, (), jnp.float32, min_move_size, max_move_size
        )
        # Candidates: [2d, d] — +step and -step for each dimension.
        deltas = jnp.concatenate([jnp.eye(d), -jnp.eye(d)]) * step  # [2d, d]
        cands = x[None, :] + deltas
        scores = make_score(ackley(cands))
        dims = jnp.tile(jnp.arange(d, dtype=jnp.int32), 2)  # [2d]
        # Candidate j changes dimension (j mod d) to x +/- step — build the
        # changed values directly (gather-free; docs/DESIGN.md hot-path rule).
        new_vals = jnp.concatenate([x + step, x - step])  # [2d]
        moves = (dims, new_vals)
        valid = jnp.ones((2 * d,), bool)
        return Neighborhood(scores=scores, moves=moves, valid=valid)

    def move_fp(x, cur_fp, moves, idx):
        dims, new_vals = moves
        dim = dims[idx]
        return fp_update(
            cur_fp,
            dim,
            x[dim].view(jnp.int32).astype(jnp.uint32),
            new_vals[idx].view(jnp.int32).astype(jnp.uint32),
        )

    def apply_move(x, moves, idx):
        dims, new_vals = moves
        return x.at[dims[idx]].set(new_vals[idx])

    def perturb(x, _is_elite, key):
        # Weighted strategy {ChangeSubset: 100, DoNothing: 10}
        # (ref ackley.rs:215-224); subset size ~ U[0, d) (ref :246).
        k_strat, k_n, k_u, k_noise = jax.random.split(key, 4)
        do_change = jax.random.uniform(k_strat) < (100.0 / 110.0)
        n_alter = jax.random.randint(k_n, (), 0, d)
        u = jax.random.uniform(k_u, (d,))
        kth = jnp.where(
            n_alter > 0,
            jax.lax.dynamic_index_in_dim(
                jnp.sort(u), jnp.maximum(n_alter - 1, 0), keepdims=False
            ),
            -1.0,
        )
        alter = u <= kth
        noise = jax.random.normal(k_noise, (d,), jnp.float32)
        perturbed = jnp.clip(x + noise, X_MIN, X_MAX)
        return jnp.where(do_change & alter, perturbed, x)

    return Problem(
        name=f"ackley-{d}d",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint,
        neighborhood=neighborhood,
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=2 * d,
    )
