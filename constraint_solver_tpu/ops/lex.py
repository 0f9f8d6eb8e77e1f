"""Lexicographic (hard, soft) score operations.

The reference orders scores with derived ``Ord`` on a ``(hard, soft)`` pair
(reference examples/employee-scheduling/src/lib.rs:239-249; single-objective
problems use a plain scalar, e.g. nqueens lib.rs:63-71).  Here every score is
a dense ``float32[..., 2]`` tensor — ``score[..., 0]`` is the hard channel,
``score[..., 1]`` the soft channel — and comparisons are carried through XLA
reductions lexicographically:

- ``lex_argmin`` / ``lex_min`` — two-pass masked min (O(W), fusable,
  no sort needed, stable first-index tie-break like a stable sort).
- ``lex_top_k`` — XLA multi-key ``lax.sort`` (``num_keys=2``) carrying
  arbitrary payload operands.

Single-objective problems put their objective in the hard channel and 0 in
the soft channel, so one code path serves all domains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Sentinel "worse than anything" score used for masked-out candidates.
# (A plain float, NOT a jnp scalar: creating a device array at import time
# would initialize the JAX backend before callers can pick a platform.)
INF_SCORE = float("inf")


def make_score(hard, soft=0.0, dtype=jnp.float32) -> jax.Array:
    """Pack hard/soft scalars (or broadcastable arrays) into a [..., 2] score."""
    hard = jnp.asarray(hard, dtype)
    soft = jnp.broadcast_to(jnp.asarray(soft, dtype), hard.shape)
    return jnp.stack([hard, soft], axis=-1)


def lex_less(a: jax.Array, b: jax.Array) -> jax.Array:
    """a < b lexicographically; a, b are [..., 2] scores."""
    return (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0]) & (a[..., 1] < b[..., 1]))


def lex_leq(a: jax.Array, b: jax.Array) -> jax.Array:
    """a <= b lexicographically."""
    return (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0]) & (a[..., 1] <= b[..., 1]))


def lex_argmin(scores: jax.Array, valid: jax.Array | None = None) -> jax.Array:
    """Index of the lexicographic minimum of ``scores`` [W, 2].

    Invalid rows (``valid == False``) are never selected.  Ties resolve to the
    lowest index (matching the first element of a stable sort, which is how
    the reference picks the neighborhood best after ``neighborhood.sort()``
    at reference local_search.rs:323-325).
    """
    hard = scores[..., 0]
    soft = scores[..., 1]
    if valid is not None:
        hard = jnp.where(valid, hard, jnp.inf)
    m0 = jnp.min(hard, axis=-1, keepdims=True)
    tie = hard == m0
    soft_m = jnp.where(tie, soft, jnp.inf)
    m1 = jnp.min(soft_m, axis=-1, keepdims=True)
    return jnp.argmax(tie & (soft_m == m1), axis=-1)


def lex_min(scores: jax.Array, valid: jax.Array | None = None) -> jax.Array:
    """Lexicographic minimum score of [W, 2] (returns [2])."""
    idx = lex_argmin(scores, valid)
    return jnp.take_along_axis(scores, idx[..., None, None], axis=-2).squeeze(-2)


def lex_argmax(scores: jax.Array, valid: jax.Array | None = None) -> jax.Array:
    """Index of the lexicographic maximum (worst) of ``scores`` [W, 2]."""
    hard = scores[..., 0]
    soft = scores[..., 1]
    if valid is not None:
        hard = jnp.where(valid, hard, -jnp.inf)
    m0 = jnp.max(hard, axis=-1, keepdims=True)
    tie = hard == m0
    soft_m = jnp.where(tie, soft, -jnp.inf)
    m1 = jnp.max(soft_m, axis=-1, keepdims=True)
    return jnp.argmax(tie & (soft_m == m1), axis=-1)


def noisy_lex_select(
    scores: jax.Array,
    valid: jax.Array,
    k: int,
    temp: float,
    key: jax.Array,
    scale: float = 4096.0,
) -> jax.Array:
    """Sample a candidate index from the lexicographic top-``k`` of
    ``scores`` [W, 2] via the Gumbel-max trick: P(i) ∝ exp(-w_i / temp)
    restricted to the k best valid candidates, where
    ``w = hard * scale + soft`` is the scalarized lexicographic key.

    This is the dense-block diffusion knob: the
    global argmin is maximally exploitative but diffuses poorly along soft
    plateaus; sampling among the top-k keeps the full-width evaluation
    while restoring the random walk a noisy descent gets for free.
    ``temp -> 0`` recovers argmin (up to tie-breaking); large ``temp`` is
    uniform over the top-k.

    Exactness bound: the scalarization is exact while both channels are
    integers with ``hard < 2^24 / scale`` and ``soft < scale`` (float32
    integer exactness) — satisfied by every shipped domain (scheduling
    hard/soft are small counts; single-objective domains have soft = 0).
    Ties AT the k-th value are all eligible (one extra tied candidate
    beats dropping an equal-quality one)."""
    w = scores[..., 0] * scale + scores[..., 1]
    w = jnp.where(valid, w, jnp.inf)
    k = min(k, w.shape[-1])
    kth = -jax.lax.top_k(-w, k)[0][..., k - 1]
    in_topk = valid & (w <= kth)
    g = jax.random.gumbel(key, w.shape)
    logit = jnp.where(in_topk, -w / max(temp, 1e-9) + g, -jnp.inf)
    return jnp.argmax(logit, axis=-1).astype(jnp.int32)


def lex_top_k(scores: jax.Array, k: int, *payload: jax.Array):
    """Smallest-k scores with payload, via XLA multi-key sort.

    ``scores`` is [N, 2]; each payload leaf is [N, ...].  Returns
    ``(top_scores [k, 2], *top_payload)`` sorted ascending lexicographically.
    The sort produces an index permutation (``lax.sort`` requires all
    operands to share one shape), and payloads are gathered through it.
    """
    n = scores.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    hard, soft, perm = jax.lax.sort(
        [scores[:, 0], scores[:, 1], iota], num_keys=2, dimension=0, is_stable=True
    )
    perm_k = perm[:k]
    out_payload = [jnp.take(p, perm_k, axis=0) for p in payload]
    return jnp.stack([hard[:k], soft[:k]], axis=-1), *out_payload
