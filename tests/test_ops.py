"""Unit tests for lexicographic score ops and fingerprints."""

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.ops.fingerprint import (
    fingerprint_i32,
    fp_update,
    position_hash,
)
from constraint_solver_tpu.ops.lex import (
    lex_argmin,
    lex_less,
    lex_leq,
    lex_top_k,
    make_score,
)


def test_lex_less_ordering():
    a = make_score(1.0, 5.0)
    b = make_score(2.0, 0.0)
    c = make_score(1.0, 6.0)
    assert bool(lex_less(a, b))
    assert not bool(lex_less(b, a))
    assert bool(lex_less(a, c))
    assert bool(lex_leq(a, a))
    assert not bool(lex_less(a, a))


def test_lex_argmin_matches_python_sort():
    rng = np.random.default_rng(1)
    for _ in range(20):
        scores = rng.integers(0, 5, size=(17, 2)).astype(np.float32)
        idx = int(lex_argmin(jnp.asarray(scores)))
        expected = min(range(17), key=lambda i: (scores[i, 0], scores[i, 1], i))
        assert idx == expected


def test_lex_argmin_respects_valid_mask():
    scores = jnp.asarray([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]], jnp.float32)
    valid = jnp.asarray([False, False, True])
    assert int(lex_argmin(scores, valid)) == 2


def test_lex_top_k():
    rng = np.random.default_rng(2)
    scores = rng.integers(0, 10, size=(32, 2)).astype(np.float32)
    payload = np.arange(32, dtype=np.int32)
    top_scores, top_payload = lex_top_k(jnp.asarray(scores), 5, jnp.asarray(payload))
    order = sorted(range(32), key=lambda i: (scores[i, 0], scores[i, 1], i))[:5]
    np.testing.assert_array_equal(np.asarray(top_payload), payload[order])
    np.testing.assert_array_equal(np.asarray(top_scores), scores[order])


def test_fingerprint_incremental_matches_full():
    rng = np.random.default_rng(3)
    values = jnp.asarray(rng.integers(0, 100, size=64), jnp.int32)
    fp = fingerprint_i32(values)
    for idx in (0, 13, 63):
        new_val = jnp.int32(777 + idx)
        updated = values.at[idx].set(new_val)
        fp_full = fingerprint_i32(updated)
        fp_inc = fp_update(
            fp,
            jnp.int32(idx),
            values[idx].astype(jnp.uint32),
            new_val.astype(jnp.uint32),
        )
        np.testing.assert_array_equal(np.asarray(fp_full), np.asarray(fp_inc))


def test_fingerprint_position_sensitive():
    a = fingerprint_i32(jnp.asarray([1, 2], jnp.int32))
    b = fingerprint_i32(jnp.asarray([2, 1], jnp.int32))
    assert not np.array_equal(np.asarray(a), np.asarray(b))


def test_fingerprint_no_trivial_collisions():
    rng = np.random.default_rng(4)
    vals = jnp.asarray(rng.integers(0, 8, size=(512, 16)), jnp.int32)
    fps = np.asarray(jax.vmap(fingerprint_i32)(vals))
    fps64 = fps[:, 0].astype(np.uint64) << np.uint64(32) | fps[:, 1].astype(np.uint64)
    uniq_rows = np.unique(np.asarray(vals), axis=0).shape[0]
    assert len(np.unique(fps64)) == uniq_rows


def test_position_hash_shape():
    h = position_hash(jnp.arange(4, dtype=jnp.int32), jnp.arange(4, dtype=jnp.uint32))
    assert h.shape == (4, 2)


def test_noisy_lex_select_topk_membership_and_limits():
    """ops/lex.noisy_lex_select: every sample lies in the valid top-k; tiny
    temperature recovers the argmin on distinct scores; high temperature
    reaches every top-k member."""
    import jax

    from constraint_solver_tpu.ops.lex import lex_argmin, noisy_lex_select

    rng = np.random.default_rng(0)
    hard = rng.integers(0, 5, 64).astype(np.float32)
    soft = rng.permutation(64).astype(np.float32)  # distinct within ties
    scores = jnp.stack([jnp.asarray(hard), jnp.asarray(soft)], -1)
    valid = jnp.asarray(rng.random(64) < 0.8)
    w = np.where(np.asarray(valid), hard * 4096 + soft, np.inf)
    top8 = set(np.argsort(w)[:8].tolist())

    picks = [
        int(noisy_lex_select(scores, valid, 8, 5e5, jax.random.key(s)))
        for s in range(200)
    ]
    assert set(picks) <= top8
    # High temperature: every top-8 member is reachable.
    assert set(picks) == top8
    # Tiny temperature: the argmin wins (scores are distinct).
    cold = {
        int(noisy_lex_select(scores, valid, 8, 1e-6, jax.random.key(s)))
        for s in range(20)
    }
    assert cold == {int(lex_argmin(scores, valid))}
