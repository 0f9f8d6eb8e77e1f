"""Dense 64-bit solution fingerprints (two uint32 lanes).

The reference's tabu set and elite archive key solutions by ``Hash + Ord`` on
the full solution vector (reference local-search/src/local_search.rs:16-19,
HashSet membership at local_search.rs:197-199).  Hash sets don't exist in a
compiled device program, so solution identity becomes a 64-bit fingerprint:

    fp(x) = XOR_i  h(i, x_i)        (per 32-bit lane, two salted lanes)

where ``h`` is a murmur3-finalizer mix of the position and the value bits.
The XOR structure makes the fingerprint *incrementally updatable* in O(1) per
changed position — a candidate move's fingerprint is

    fp' = fp ^ h(i, old_i) ^ h(i, new_i)

so an entire [W]-wide candidate neighborhood gets fingerprints in one
vectorized op, without materializing candidate solutions.  Collision
probability per pair is ~2^-64; tabu filtering tolerates rare collisions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Two lane salts — arbitrary odd constants.
_SALTS = (0x9E3779B9, 0x85EBCA77)


def _mix32(h: jax.Array) -> jax.Array:
    """murmur3 fmix32 finalizer (uint32 in, uint32 out)."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def position_hash_planes(idx: jax.Array, value_bits: jax.Array) -> tuple:
    """h(i, v) as two separate uint32[...] planes.

    Wide batched hashing should stay in planes: a materialized [..., 2]
    array pads its trailing dim under a tiled layout."""
    idx = idx.astype(jnp.uint32)
    value_bits = value_bits.astype(jnp.uint32)
    lanes = []
    for salt in _SALTS:
        pos = _mix32(idx ^ jnp.uint32(salt))
        lanes.append(_mix32(value_bits ^ pos))
    return tuple(lanes)


def position_hash(idx: jax.Array, value_bits: jax.Array) -> jax.Array:
    """h(i, v) for both lanes: [..., 2] uint32.

    ``idx`` int32[...], ``value_bits`` uint32[...].
    """
    return jnp.stack(position_hash_planes(idx, value_bits), axis=-1)


def _xor_reduce(lane_hashes: jax.Array) -> jax.Array:
    """XOR-reduce [..., n, 2] position hashes over axis -2 → [..., 2]."""
    return jax.lax.reduce(
        lane_hashes,
        jnp.uint32(0),
        jax.lax.bitwise_xor,
        dimensions=(lane_hashes.ndim - 2,),
    )


def fingerprint_i32(values: jax.Array) -> jax.Array:
    """Fingerprint of an int32[..., n] solution vector → uint32[..., 2]."""
    n = values.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    idx = jnp.broadcast_to(idx, values.shape)
    return _xor_reduce(position_hash(idx, values.view(jnp.uint32)))


def fingerprint_f32(values: jax.Array) -> jax.Array:
    """Fingerprint of a float32[..., n] solution vector → uint32[..., 2].

    Bitcast-based: distinct bit patterns are distinct solutions (the reference
    hashes OrderedFloat bit patterns the same way, cf. ackley.rs:21-24).
    """
    return fingerprint_i32(values.view(jnp.int32))


def fp_update(fp: jax.Array, idx: jax.Array, old_bits: jax.Array, new_bits: jax.Array) -> jax.Array:
    """O(1) incremental fingerprint update for changed position(s).

    ``fp`` uint32[..., 2]; ``idx``/``old_bits``/``new_bits`` broadcastable
    [...]; returns the fingerprint with position ``idx`` changed old → new.
    """
    return fp ^ position_hash(idx, old_bits) ^ position_hash(idx, new_bits)
