"""Time the nqueens [A, n] block alone: the Triton-route kernel against the
XLA ``block_scores`` path, vmapped over P lanes inside one jitted
``fori_loop`` whose carry is the full output, so both write the whole block
every iteration.  Checks the two bit-equal first, then times each twice in
the order xla, kernel, kernel, xla, and prints the score-block write rate
as a share of the H100's 3.35 TB/s HBM bandwidth.

    python bench/nqueens_block_time.py     # GPU: n=1000 A=50 P=256, n=16384 A=64 P=16

On a CPU it runs the kernel in interpret mode at a toy size, to check the
script only.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from constraint_solver_tpu.models.nqueens import block_scores, build_state  # noqa: E402
from constraint_solver_tpu.ops.nqueens_pallas import nqueens_block_kernel  # noqa: E402
from constraint_solver_tpu.utils.oracles import nqueens_conflicts  # noqa: E402

GPU = jax.devices()[0].platform == "gpu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
IMPLS = {
    "xla": block_scores,
    "kernel": (nqueens_block_kernel if GPU
               else functools.partial(nqueens_block_kernel, interpret=True)),
}
SHAPES = [(1000, 50, 256), (16384, 64, 16)] if GPU else [(64, 4, 2)]
REPS = 200 if GPU else 2


def inputs(n: int, a: int, p: int, seed: int = 0):
    """P lanes of random boards, A sampled columns each."""
    rng = np.random.default_rng(seed)
    lanes = []
    for _ in range(p):
        rows = rng.integers(0, n, size=n)
        st = build_state(jnp.asarray(rows, jnp.int32))
        c = jnp.asarray(rng.choice(n, size=a, replace=False), jnp.int32)
        r = st.rows[c]
        removed = (st.rc[r] - 1) + (st.dc[r - c + n - 1] - 1) + (st.ac[r + c] - 1)
        lanes.append((st.rc, st.dc, st.ac, c, r, removed,
                      jnp.float32(nqueens_conflicts(rows))))
    return tuple(jnp.stack(x) for x in zip(*lanes))


def timed(fn, args):
    """(min, median) seconds per block call over three timed loops."""
    vf = jax.vmap(fn)

    def loop(args):
        def body(_, out):
            # Make each call depend on the last one's output.
            rc = args[0] + 0.0 * out[1][:, :1]
            return vf(rc, *args[1:])
        return jax.lax.fori_loop(0, REPS, body, vf(*args))

    f = jax.jit(loop)
    jax.block_until_ready(f(args))
    times = []
    for _ in range(3):
        t = time.perf_counter()
        jax.block_until_ready(f(args))
        times.append((time.perf_counter() - t) / (REPS + 1))
    return min(times), sorted(times)[1]


def main() -> int:
    if GPU:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    for n, a, p in SHAPES:
        args = inputs(n, a, p)
        outs = {k: jax.jit(jax.vmap(fn))(*args) for k, fn in IMPLS.items()}
        for x, y in zip(outs["xla"], outs["kernel"]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        for impl in ("xla", "kernel", "kernel", "xla"):
            tmin, tmed = timed(IMPLS[impl], args)
            out_bytes = p * a * n * 4
            print(f"block n={n} A={a} P={p} {impl}: min {tmin * 1e6:.2f} us, "
                  f"median {tmed * 1e6:.2f} us; score-block write "
                  f"{out_bytes / tmin / 1e9:.1f} GB/s = "
                  f"{out_bytes / tmin / HBM_BYTES_PER_S:.1%} of 3.35 TB/s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
