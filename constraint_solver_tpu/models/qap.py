"""Quadratic Assignment Problem domain — the matmul-heavy model family.

Not in the reference (which ships Ackley/N-Queens/scheduling); added because
QAP is the canonical hard assignment problem the framework's delta-evaluation
design targets — every technique paper retrieved for this build (PAPERS.md:
O(1) delta components, GPU SA/tabu for QAP) is about exactly this workload.

Problem: place n facilities on n locations (permutation ``p``) minimizing

    cost(p) = sum_{i,j} F[i, j] * D[p[i], p[j]]

with symmetric flow F and distance D (zero diagonals).

Dense scoring: let G = D[p][:, p] be the permuted distance matrix
(computed as onehot(p) @ D @ onehot(p)^T — two matmuls).
Then

    cost = sum(F * G)

and the swap delta for ALL n^2 facility pairs at once is ONE matmul:

    H = F @ G                                     # one [n, n] matmul
    delta[a, b] = 2 * (H[a,b] + H[b,a] - H[a,a] - H[b,b] + 2 * F[a,b] * G[a,b])

where the F[a,b]*G[a,b] term corrects the k in {a, b} contributions
(standard QAP swap algebra, cf. the O(1) delta-component paper in
PAPERS.md).  The whole
neighborhood (n(n-1)/2 swaps) is scored by one [n,n]x[n,n] matmul, unlike
the elementwise N-Queens/scheduling paths.

Property-tested against naive full rescores (tests/test_qap.py).
"""

from __future__ import annotations

from functools import lru_cache

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.problem import Neighborhood, Problem
from constraint_solver_tpu.ops.fingerprint import fingerprint_i32
from constraint_solver_tpu.ops.lex import make_score


class QAPSpec(NamedTuple):
    flow: tuple      # hashable [n][n]
    dist: tuple

    @staticmethod
    def random(n: int, seed: int = 0, max_val: int = 10) -> "QAPSpec":
        """A random symmetric instance with zero diagonals (the classic
        Taillard-style uniform generator)."""
        rng = np.random.default_rng(seed)

        def sym(m):
            m = np.triu(m, 1)
            return m + m.T

        flow = sym(rng.integers(0, max_val + 1, (n, n)))
        dist = sym(rng.integers(0, max_val + 1, (n, n)))
        return QAPSpec(
            flow=tuple(map(tuple, flow.tolist())),
            dist=tuple(map(tuple, dist.tolist())),
        )

    def arrays(self):
        return (
            np.asarray(self.flow, np.float32),
            np.asarray(self.dist, np.float32),
        )


def qap_cost_naive(flow: np.ndarray, dist: np.ndarray, p: np.ndarray) -> float:
    """Host oracle: direct double sum in float64 (exact for integer
    instances)."""
    return float(np.sum(np.float64(flow) * dist[np.ix_(p, p)]))


@jax.jit
def qap_cost_int32(flow: jax.Array, dist: jax.Array, p: jax.Array) -> jax.Array:
    """sum(F * D[p][:, p]) on the device, summed in int32 as
    ``make_qap_problem`` sums costs (exact under ``exactness_precision``)."""
    return jnp.sum((flow * dist[p][:, p]).astype(jnp.int32))


def exactness_precision(flow: np.ndarray, dist: np.ndarray):
    """Check that ``make_qap_problem`` scores this instance exactly, and
    return the matmul precision its products of instance values need.

    With ``M = max|F| max|D|`` and ``B = max row/column sum of |F| x max|D|``
    (a bound on every entry and partial sum of H = F G):

    - float32 holds every integer up to 2^24, and the largest float32
      intermediate is ``max(4B + 2M, 2B + 8M)`` (the swap deltas; the
      incremental H update), so that must stay within 2^24;
    - costs are summed in int32, and no permutation's cost exceeds the
      rearrangement bound ``sort(|F|) . sort(|D|)``, which must stay below
      2^31;
    - TF32 (a GPU's default for float32 products) holds integers up to
      2^11, so larger values get ``Precision.HIGHEST``.

    Raises ValueError when the instance breaks the first two bounds."""
    if not (np.array_equal(flow, np.round(flow))
            and np.array_equal(dist, np.round(dist))):
        raise ValueError("QAP instances must be integer-valued")
    f = np.abs(flow.astype(np.int64))
    d = np.abs(dist.astype(np.int64))
    max_f, max_d = int(f.max(initial=0)), int(d.max(initial=0))
    m = max_f * max_d
    b = max(int(f.sum(0).max(initial=0)), int(f.sum(1).max(initial=0))) * max_d
    if max(4 * b + 2 * m, 2 * b + 8 * m) > 2**24:
        raise ValueError(
            f"QAP values too large for exact float32 deltas: row sum x max "
            f"distance = {b}, max product = {m}")
    cost_bound = int(np.dot(np.sort(f, axis=None), np.sort(d, axis=None)))
    if cost_bound >= 2**31:
        raise ValueError(
            f"QAP costs may reach {cost_bound}, past the int32 range")
    return jax.lax.Precision.HIGHEST if max(max_f, max_d) > 2**11 else None


class QAPState(NamedTuple):
    """State for the ``incremental=True`` variant: the permutation plus the
    carried G = D[p][:, p] and H = F G matrices, so a swap costs rank-2
    O(n^2) fused updates instead of three O(n^3) matmuls (see
    make_qap_problem docstring)."""

    p: jax.Array     # int32[n]
    g: jax.Array     # float32[n, n], exactly D[p][:, p] (updates are exact)
    h: jax.Array     # float32[n, n], exactly F @ G (integers below 2^24)
    cost: jax.Array  # int32[], exactly sum(F * G)


@lru_cache(maxsize=32)
def make_qap_problem(
    spec: QAPSpec,
    nbr_axis: str | None = None,
    nbr_shards: int = 1,
    nbr_keep: int = 64,
    compact: bool = False,
    incremental: bool = False,
) -> Problem:
    """Build the QAP problem for an integer-valued ``spec``.

    Exactness: every score is the float32 rounding of the exact integer
    cost.  Costs are summed in int32, and each candidate's score is
    ``float32(cost + delta)`` with the delta itself an exact integer in
    float32.  float32 alone cannot hold costs above 2^24 exactly
    (QAPSpec.random reaches that near n = 1000), so the current cost is
    never carried as a float.  ``exactness_precision`` rejects instances
    whose values could break this (ValueError).

    Matmul precision: products of instance values run at the default
    precision, which may be TF32 on a GPU; TF32 is exact for integer
    operands up to 2^11, as in every instance QAPSpec.random draws, and
    instances with larger values get ``Precision.HIGHEST``.  The
    incremental update multiplies the carried H, whose entries exceed
    2^11, so that product always asks for ``Precision.HIGHEST``.

    ``compact``: row-min candidate compaction.  The proposer reduces the
    [n, n] delta block to ONE candidate per facility row -- a fused masked
    min+argmin over axis 1 -- and hands the engine an n-wide candidate list
    (best swap partner per row) instead of the n^2-wide block.  The
    lexicographic winner is IDENTICAL to the dense path's (flat row-major
    argmin == smallest-a-then-smallest-b == per-row argmin + first-index
    row pick; tested), so greedy descents take the same trajectory.
    Divergence (documented per docs/DESIGN.md): tabu retries beyond the
    first pick see the best-of-each-OTHER-row rather than the global
    2nd-best (which may share a row with the winner).  ``width`` stays n^2:
    every delta is still evaluated each iteration.

    ``incremental``: carry G = D[p][:, p], H = F G and the cost in the
    solver state (``QAPState``) and update them per applied swap with EXACT
    permutation identities (G' = P G P) and a rank-2 update
    (H' = H - fu gu^T - hu u^T + s fu u^T with fu = F[:, a] - F[:, b] etc.;
    F G u == H u, so no matvec through F G is needed).  The per-iteration
    cost drops from three [n, n] x [n, n] matmuls (2 rebuilding G from p,
    1 for H) to a handful of fused O(n^2) passes -- the classic
    Taillard-style incremental evaluation as dense tensor algebra.
    Selection uses the same row-min compaction as ``compact``.  G and H
    are rebuilt from scratch at every perturbation (round start).  Memory:
    the elite archive stores full QAPStates, so keep
    ``best_solutions_capacity`` small at large n (8 x 2 x n^2 x 4 B per
    lane -- ~4 GB at n = 4096, P = 4, capacity 8).

    ``nbr_axis``/``nbr_shards``: tensor-parallel neighborhood.  Inside a
    ``shard_map`` over that mesh axis each shard scores its n/shards ROW
    BLOCK of the [n, n] swap-delta matrix with two [n/S, n] x [n, n]
    matmuls (H and H^T rows; F and G are symmetric so H^T rows = G[rows] @ F),
    all_gathers the [n] diagonal, keeps its ``nbr_keep`` best candidates,
    and an all_gather over the axis rebuilds a small global candidate list --
    the same collective pattern as the nqueens ``nbr_axis`` neighborhood."""
    flow_np, dist_np = spec.arrays()
    prec = exactness_precision(flow_np, dist_np)
    n = flow_np.shape[0]
    flow = jnp.asarray(flow_np)
    dist = jnp.asarray(dist_np)
    if nbr_axis is not None and n % nbr_shards != 0:
        raise ValueError(f"n={n} must divide over {nbr_shards} nbr shards")
    rows_per = n // nbr_shards

    def permuted_dist(p: jax.Array) -> jax.Array:
        """G = D[p][:, p] via one-hot matmuls."""
        onehot = (p[:, None] == jnp.arange(n, dtype=p.dtype)).astype(
            jnp.float32
        )
        return jnp.matmul(jnp.matmul(onehot, dist, precision=prec), onehot.T,
                          precision=prec)

    def exact_cost(g: jax.Array) -> jax.Array:
        """sum(F * G) as an exact int32 (elementwise products are exact)."""
        return jnp.sum((flow * g).astype(jnp.int32))

    def cand_scores(cost: jax.Array, delta: jax.Array) -> jax.Array:
        return (cost + delta.astype(jnp.int32)).astype(jnp.float32)

    def init(key):
        return jax.random.permutation(key, jnp.arange(n, dtype=jnp.int32))

    def score(p):
        return make_score(exact_cost(permuted_dist(p)).astype(jnp.float32))

    def is_best(s):
        return jnp.asarray(False)  # optimum unknown in general

    def fingerprint(p):
        return fingerprint_i32(p)

    def swap_deltas(g, h):
        """[n, n] swap deltas from G and H = F G (module docstring)."""
        hd = jnp.diagonal(h)
        return 2.0 * (h + h.T - hd[:, None] - hd[None, :] + 2.0 * flow * g)

    def row_min_neighborhood(cost, delta):
        # Fused masked row-wise min+argmin compacts the [n, n] block to n
        # candidates (docstring above); nothing [n, n]-shaped survives to
        # the engine.
        ia = jnp.arange(n, dtype=jnp.int32)
        upper = ia[:, None] < ia[None, :]  # each unordered swap once
        w = jnp.where(upper, cand_scores(cost, delta), jnp.inf)
        rmin = jnp.min(w, axis=1)                      # [n]
        rarg = jnp.argmin(w, axis=1).astype(jnp.int32)  # smallest-b ties
        return Neighborhood(
            scores=make_score(rmin),
            moves=(ia, rarg),
            valid=jnp.isfinite(rmin),  # row n-1 has no a<b partner
            n_valid=jnp.int32(n - 1),
        )

    def neighborhood(p, cur_score, _key):
        # All-pairs swap deltas from one [n, n] matmul (module docstring).
        g = permuted_dist(p)
        h = jnp.dot(flow, g.T, precision=prec)
        cand = cand_scores(exact_cost(g), swap_deltas(g, h))  # diagonal: no-op
        ia = jnp.arange(n, dtype=jnp.int32)
        a_idx = jnp.broadcast_to(ia[:, None], (n, n)).reshape(-1)
        b_idx = jnp.broadcast_to(ia[None, :], (n, n)).reshape(-1)
        valid = (a_idx < b_idx)  # each unordered swap once, no no-ops
        return Neighborhood(
            scores=make_score(cand.reshape(-1)),
            moves=(a_idx, b_idx),
            valid=valid,
            n_valid=jnp.int32(n * (n - 1) // 2),
        )

    def neighborhood_compact(p, cur_score, _key):
        g = permuted_dist(p)
        h = jnp.dot(flow, g.T, precision=prec)
        return row_min_neighborhood(exact_cost(g), swap_deltas(g, h))

    def neighborhood_sharded(p, cur_score, _key):
        # Row-block of the swap-delta matrix per shard: 2/S of the matmul
        # flops each, then local-top-k + all_gather (docstring above).
        g = permuted_dist(p)  # replicated state => identical G everywhere
        shard = jax.lax.axis_index(nbr_axis)
        r0 = shard * rows_per
        f_rows = jax.lax.dynamic_slice(flow, (r0, 0), (rows_per, n))
        g_rows = jax.lax.dynamic_slice(g, (r0, 0), (rows_per, n))
        h_rows = jnp.dot(f_rows, g, precision=prec)
        # H^T[a, :] = (G F)[a, :] because F = F^T and G = G^T.
        ht_rows = jnp.dot(g_rows, flow, precision=prec)
        hd_local = jnp.sum(f_rows * g_rows, axis=1)  # H[a, a] for my rows
        hd = jax.lax.all_gather(hd_local, nbr_axis, axis=0, tiled=True)  # [n]
        delta = 2.0 * (
            h_rows + ht_rows - hd_local[:, None] - hd[None, :]
            + 2.0 * f_rows * g_rows
        )
        cand = cand_scores(exact_cost(g), delta).reshape(-1)  # [rows_per * n]
        ia = jnp.arange(n, dtype=jnp.int32)
        a_idx = jnp.broadcast_to(
            (r0 + jnp.arange(rows_per, dtype=jnp.int32))[:, None],
            (rows_per, n),
        ).reshape(-1)
        b_idx = jnp.broadcast_to(ia[None, :], (rows_per, n)).reshape(-1)
        valid = a_idx < b_idx

        k_keep = min(nbr_keep, rows_per * n)
        neg, idxs = jax.lax.top_k(jnp.where(valid, -cand, -jnp.inf), k_keep)
        cand = -neg
        a_idx, b_idx = a_idx[idxs], b_idx[idxs]
        valid = jnp.isfinite(cand)
        gather = lambda x: jax.lax.all_gather(x, nbr_axis, axis=0, tiled=True)
        return Neighborhood(
            scores=make_score(gather(cand)),
            moves=(gather(a_idx), gather(b_idx)),
            valid=gather(valid),
        )

    def move_fp(p, cur_fp, moves, idx):
        a_idx, b_idx = moves
        a, b = a_idx[idx], b_idx[idx]
        from constraint_solver_tpu.ops.fingerprint import fp_update

        pa = p[a].astype(jnp.uint32)
        pb = p[b].astype(jnp.uint32)
        return fp_update(fp_update(cur_fp, a, pa, pb), b, pb, pa)

    def apply_move(p, moves, idx):
        a_idx, b_idx = moves
        a, b = a_idx[idx], b_idx[idx]
        pa, pb = p[a], p[b]
        return p.at[a].set(pb).at[b].set(pa)

    def perturb(p, is_elite, key):
        """Random subset re-shuffle: k ~ U[1, n/20] near elites else
        U[1, n/2] positions get cyclically rotated (a permutation-preserving
        analog of the reference domains' ChangeSubset perturbations)."""
        k_strat, k_n, k_u, k_roll = jax.random.split(key, 4)
        do_change = jax.random.uniform(k_strat) < (100.0 / 110.0)
        hi = jnp.where(is_elite, max(1, n // 20), max(1, n // 2))
        n_alter = jax.random.randint(k_n, (), 1, hi + 1)
        u = jax.random.uniform(k_u, (n,))
        kth = jax.lax.dynamic_index_in_dim(
            jnp.sort(u), n_alter - 1, keepdims=False
        )
        sel = u <= kth  # k chosen positions
        # Cyclic rotation of the chosen positions' values: rank-order the
        # selected slots and give each the value of the previous one.
        order = jnp.argsort(jnp.where(sel, u, jnp.inf))  # selected first
        idx_sel = order  # first n_alter entries are the chosen slots
        vals = p[idx_sel]
        rotated = jnp.where(
            jnp.arange(n) < n_alter, jnp.roll(vals, 1), vals
        )
        # Fix the wrap: position 0 takes the value of slot n_alter-1.
        first_val = jax.lax.dynamic_index_in_dim(
            vals, jnp.maximum(n_alter - 1, 0), keepdims=False
        )
        rotated = rotated.at[0].set(
            jnp.where(n_alter > 0, first_val, rotated[0])
        )
        p_new = p.at[idx_sel].set(rotated)
        return jnp.where(do_change, p_new, p)

    def _state_from_p(p):
        g = permuted_dist(p)
        h = jnp.dot(flow, g, precision=prec)
        return QAPState(p, g, h, exact_cost(g))

    def init_inc(key):
        return _state_from_p(init(key))

    def score_inc(st):
        return make_score(st.cost.astype(jnp.float32))

    def fingerprint_inc(st):
        return fingerprint_i32(st.p)

    def neighborhood_inc(st, cur_score, _key):
        # The compact row-min neighborhood with G, H and the cost read from
        # state -- zero matmuls per iteration.
        return row_min_neighborhood(st.cost, swap_deltas(st.g, st.h))

    def move_fp_inc(st, cur_fp, moves, idx):
        a_idx, b_idx = moves
        a, b = a_idx[idx], b_idx[idx]
        from constraint_solver_tpu.ops.fingerprint import fp_update

        pa = st.p[a].astype(jnp.uint32)
        pb = st.p[b].astype(jnp.uint32)
        return fp_update(fp_update(cur_fp, a, pa, pb), b, pb, pa)

    def apply_move_inc(st, moves, idx):
        # G' = P G P and H' = F G' as rank-2 fused updates (docstring):
        # with u = e_a - e_b, gu = G u, fu = F u, hu = H u (== F G u, so
        # no matvec through F G is needed) and s = u^T G u:
        #   G' = G - u gu^T - gu u^T + s u u^T          (exact: small ints)
        #   H' = H - fu gu^T - hu u^T + s fu u^T        (rank-2 f32 adds)
        # The u-outer terms only touch columns a and b, expressed as fused
        # one-hot broadcasts.  H's entries exceed 2^11, so H u runs at
        # HIGHEST precision (a TF32 product would round them); so does
        # u^T gu, whose entries reach twice the largest distance.
        a_idx, b_idx = moves
        a, b = a_idx[idx], b_idx[idx]
        ia = jnp.arange(n, dtype=jnp.int32)
        oa = (ia == a).astype(jnp.float32)
        ob = (ia == b).astype(jnp.float32)
        d = oa - ob  # u as a dense vector
        gu = jnp.dot(st.g, d, precision=prec)
        hu = jnp.dot(st.h, d, precision=jax.lax.Precision.HIGHEST)
        fu = jnp.dot(flow, d, precision=prec)
        delta_ab = 2.0 * (
            st.h[a, b] + st.h[b, a] - st.h[a, a] - st.h[b, b]
            + 2.0 * flow[a, b] * st.g[a, b]
        )
        s = jnp.dot(d, gu, precision=jax.lax.Precision.HIGHEST)
        g2 = (
            st.g
            - d[:, None] * gu[None, :]
            - gu[:, None] * d[None, :]
            + s * d[:, None] * d[None, :]
        )
        h2 = (
            st.h
            - fu[:, None] * gu[None, :]
            + (s * fu - hu)[:, None] * oa[None, :]
            + (hu - s * fu)[:, None] * ob[None, :]
        )
        pa, pb = st.p[a], st.p[b]
        p2 = st.p.at[a].set(pb).at[b].set(pa)
        return QAPState(p2, g2, h2, st.cost + delta_ab.astype(jnp.int32))

    def perturb_inc(st, is_elite, key):
        # Perturb the permutation, then rebuild G, H and the cost -- once
        # per round.
        return _state_from_p(perturb(st.p, is_elite, key))

    if incremental:
        if nbr_axis is not None:
            raise ValueError("incremental excludes nbr_axis sharding")
        return Problem(
            name=f"qap-{n}-inc",
            init=init_inc,
            score=score_inc,
            is_best=is_best,
            fingerprint=fingerprint_inc,
            neighborhood=neighborhood_inc,
            move_fp=move_fp_inc,
            apply_move=apply_move_inc,
            perturb=perturb_inc,
            width=n * n,
        )

    if nbr_axis is not None:
        nbr_fn = neighborhood_sharded
    elif compact:
        nbr_fn = neighborhood_compact
    else:
        nbr_fn = neighborhood
    return Problem(
        name=f"qap-{n}" + ("-compact" if compact and nbr_axis is None else ""),
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint,
        neighborhood=nbr_fn,
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=n * n,
    )
