"""Pallas kernel (Triton route) for the N-Queens neighborhood delta-scoring block.

Computes the [A, n] candidate-score matrix -- for each of A sampled columns,
the total-conflict score of moving that column's queen to every row -- plus
each row's min and first-index argmin.  Same delta algebra as the XLA slice
path in models/nqueens.py (the reference's x2-pair conflict convention,
reference examples/nqueens/src/lib.rs:74-87):

    score(j, r') = cur + 2 * [ (rc[r'] - [r'==r_j]) + (dc[d'] - [d'==d_j])
                              + (ac[a'] - [a'==a_j]) - removed_j ]

Route: Pallas through Triton (``backend="triton"``), for NVIDIA GPUs.  One
program per sampled column.  Each program reads its diagonal windows
``dc[n-1-c_j + r']`` and ``ac[c_j + r']`` straight from the counter tables
at a dynamic offset, loops over the rows in blocks of ``_BLOCK``, writes the
row and keeps a running min / first-index argmin, so the row reduction needs
no second pass over the block.  ``make_nqueens_problem`` selects it on a GPU
only; the XLA reference is ``models.nqueens.block_scores`` (bit-equal,
tests/test_pallas_kernels.py).  ``interpret=True`` runs it on the CPU for
tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BLOCK = 1024


def _kernel(n, n_chunks, c_ref, r_ref, removed_ref, cur_ref, rc_ref, dc_ref,
            ac_ref, out_ref, min_ref, arg_ref):
    j = pl.program_id(0)
    c_j = c_ref[j]
    r_j = r_ref[j]
    removed_j = removed_ref[j]
    cur = cur_ref[0]
    lane = jnp.arange(_BLOCK, dtype=jnp.int32)

    def body(k, carry):
        best, arg = carry
        base = k * _BLOCK
        rp = base + lane
        rc = plgpu.load(rc_ref.at[pl.ds(base, _BLOCK)])
        dc = plgpu.load(dc_ref.at[pl.ds(n - 1 - c_j + base, _BLOCK)])
        ac = plgpu.load(ac_ref.at[pl.ds(c_j + base, _BLOCK)])
        same = (rp == r_j).astype(jnp.float32)
        s = cur + 2.0 * ((rc - same) + (dc - same) + (ac - same) - removed_j)
        live = rp < n
        plgpu.store(out_ref.at[j, pl.ds(base, _BLOCK)], s, mask=live)
        s = jnp.where(live, s, jnp.inf)
        m = jnp.min(s)
        a = jnp.min(jnp.where(s == m, rp, jnp.iinfo(jnp.int32).max))
        better = m < best  # strict: an earlier block keeps its tie
        return jnp.where(better, m, best), jnp.where(better, a, arg)

    best, arg = jax.lax.fori_loop(
        0, n_chunks, body, (jnp.float32(jnp.inf), jnp.int32(0))
    )
    min_ref[j] = best
    arg_ref[j] = arg


@functools.partial(jax.jit, static_argnames=("interpret",))
def nqueens_block_kernel(
    rc: jax.Array,       # float32[n]
    dc: jax.Array,       # float32[2n-1]
    ac: jax.Array,       # float32[2n-1]
    c: jax.Array,        # int32[A] sampled columns
    r: jax.Array,        # int32[A] their current rows
    removed: jax.Array,  # float32[A] (rc[r]-1)+(dc[d]-1)+(ac[a]-1) per column
    cur_hard: jax.Array,  # float32[] current total conflicts
    interpret: bool = False,
):
    """Returns (scores float32[A, n], row_min float32[A], row_arg int32[A])."""
    n = rc.shape[0]
    a = c.shape[0]
    n_chunks = -(-n // _BLOCK)
    n_pad = n_chunks * _BLOCK
    # Zero-pad the tables so every block read stays in bounds.
    rc_p = jnp.pad(rc, (0, n_pad - n))
    dc_p = jnp.pad(dc, (0, n_pad - n))
    ac_p = jnp.pad(ac, (0, n_pad - n))
    return pl.pallas_call(
        functools.partial(_kernel, n, n_chunks),
        grid=(a,),
        out_shape=(
            jax.ShapeDtypeStruct((a, n), jnp.float32),
            jax.ShapeDtypeStruct((a,), jnp.float32),
            jax.ShapeDtypeStruct((a,), jnp.int32),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="nqueens_block",
    )(c, r, removed, cur_hard.reshape(1), rc_p, dc_p, ac_p)
