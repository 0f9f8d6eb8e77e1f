"""Multi-process (2-host-emulation) smoke test over CPU.

Spawns two real processes, each with 4 virtual CPU devices, joined via
``jax.distributed.initialize`` into one 8-device runtime, and runs a
sharded population solve over the global mesh — the closest this
environment gets to a real multi-host pod (SURVEY.md §4/§5)."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.models.nqueens import make_nqueens_problem
from constraint_solver_tpu.parallel.distributed import global_mesh, is_coordinator
from constraint_solver_tpu.parallel.population import PopulationSolver

mesh = global_mesh(n_nbr=1)
config = SolverConfig(
    seed="42", local_search_max_iterations=50,
    best_solutions_capacity=4, all_solutions_capacity=32,
    all_solution_iteration_expiry=50,
    iterated_local_search_max_iterations=10,
    max_allow_no_improvement_for=3,
)
solver = PopulationSolver(
    make_nqueens_problem(8), config, population=8, mesh=mesh
)
solver.state = solver._chunk_jit(solver.state, 3)
jax.block_until_ready(solver.state)
(hard, soft), _ = solver.get_best_solution()
assert hard >= 0.0
print(f"proc {jax.process_index()}: global best hard={hard}", flush=True)

# Checkpoint round-trip across the process boundary: every process calls
# save (collective gather, one writer), every process loads, and the resumed
# global state must match bit-for-bit.
ckpt = sys.argv[3]
solver.save(ckpt)
import numpy as np
from jax.experimental import multihost_utils

resumed = PopulationSolver(
    make_nqueens_problem(8), config, population=8, mesh=mesh
)
resumed.load(ckpt)
assert resumed.get_best_score() == solver.get_best_score()
for a, b in zip(jax.tree.leaves(resumed.state), jax.tree.leaves(solver.state)):
    if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
        a, b = jax.random.key_data(a), jax.random.key_data(b)
    np.testing.assert_array_equal(
        multihost_utils.process_allgather(a, tiled=True),
        multihost_utils.process_allgather(b, tiled=True),
    )
resumed.state = resumed._chunk_jit(resumed.state, 2)
jax.block_until_ready(resumed.state)
(r_hard, _), _ = resumed.get_best_solution()
assert r_hard <= hard
if is_coordinator():
    print("MULTIHOST_OK", flush=True)
"""


@pytest.mark.slow
def test_two_process_global_mesh(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        **os.environ,
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu",
        # The worker script lives in tmp_path; make the package importable
        # regardless of the invoking process's cwd / install state.
        "PYTHONPATH": repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    ckpt = str(tmp_path / "dist_ckpt.npz")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), addr, str(i), ckpt],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process run timed out")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"
    assert "MULTIHOST_OK" in outs[0] + outs[1]


_WORKER_2D = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
assert jax.device_count() == 8, jax.device_count()

import datetime
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from constraint_solver_tpu.core.ils import SolverConfig
from constraint_solver_tpu.models.nqueens import make_nqueens_problem
from constraint_solver_tpu.models.scheduling import (
    ScheduleSpec, make_scheduling_problem,
)
from constraint_solver_tpu.parallel.distributed import (
    global_mesh, is_coordinator,
)
from constraint_solver_tpu.parallel.population import PopulationSolver
from constraint_solver_tpu.parallel.seq_solver import SeqShardedSolver
from constraint_solver_tpu.parallel.sharded import ShardedPopulationSolver

# --- pop x nbr: 2 processes x 4 devices = Mesh(pop=4, nbr=2) -------------
mesh = global_mesh(n_nbr=2)
cfg = SolverConfig(
    seed="42", local_search_max_iterations=50,
    best_solutions_capacity=4, all_solutions_capacity=32,
    all_solution_iteration_expiry=50,
    iterated_local_search_max_iterations=20,
    max_allow_no_improvement_for=3,
)
problem = make_nqueens_problem(
    16, sample_cols=4, nbr_axis="nbr", nbr_shards=2, nbr_keep=16
)
s = ShardedPopulationSolver(
    problem, cfg, population=8, mesh=mesh, exchange_every=4, k_exchange=2
)
s.state = s._chunk_jit(s.state, 4)  # round-gated exchange fires at round 4
jax.block_until_ready(s.state)
(hard, soft), best_state = s.get_best_solution()
# Score integrity across the process boundary: the recorded best must
# equal an independent full rescore of the returned state.
local_problem = make_nqueens_problem(16)
rescore = np.asarray(local_problem.score(best_state))
assert (hard, soft) == (float(rescore[0]), float(rescore[1])), (
    (hard, soft), rescore)
# The exchange broadcast the global best into EVERY lane's archive.
lane_bests = np.asarray(jax.jit(
    lambda st: jax.vmap(lambda e: e.get_best())(st.elite)[0],
    out_shardings=NamedSharding(mesh, P()),
)(s.state))
assert (lane_bests == lane_bests[0]).all(), lane_bests
print(f"proc {jax.process_index()}: popxnbr best={(hard, soft)}", flush=True)

# --- pop x seq: Mesh(pop=2, seq=4), bit-identical to the dense solver ----
mesh2 = jax.make_mesh(
    (2, 4), ("pop", "seq"),
    axis_types=(jax.sharding.AxisType.Auto,) * 2,
)
d0 = datetime.date(2022, 5, 9)
spec = ScheduleSpec.from_dates(
    d0, d0 + datetime.timedelta(days=63), 7,
    {1: [d0 + datetime.timedelta(days=9)]},
)
scfg = SolverConfig(
    seed="seqsolve", local_search_max_iterations=30,
    iterated_local_search_max_iterations=8,
    all_solutions_capacity=64, all_solution_iteration_expiry=200,
    best_solutions_capacity=8, max_allow_no_improvement_for=5,
)
sharded = SeqShardedSolver(
    spec, scfg, mesh2, window_size=32,
    population=4, exchange_every=4, k_exchange=2,
)
sharded.run(max_rounds=8, chunk=4)
(sh_hard, sh_soft), sh_assign = sharded.get_best_solution()

# Each process independently runs the DENSE population solver on its local
# device; the 2-process date-sharded solve must be trajectory-identical.
dense = PopulationSolver(
    make_scheduling_problem(spec, window_size=32, proposer="random"),
    scfg, population=4, exchange_every=4, k_exchange=2,
)
dense.run(max_rounds=8, chunk=4)
(dn_hard, dn_soft), dn_assign = dense.get_best_solution()
assert (sh_hard, sh_soft) == (dn_hard, dn_soft), (
    (sh_hard, sh_soft), (dn_hard, dn_soft))
np.testing.assert_array_equal(np.asarray(sh_assign), np.asarray(dn_assign))
print(f"proc {jax.process_index()}: popxseq best={(sh_hard, sh_soft)}",
      flush=True)
if is_coordinator():
    print("MULTIHOST_2D_OK", flush=True)
"""


@pytest.mark.slow
def test_two_process_2d_meshes(tmp_path):
    """The 2D program shapes a multi-process mesh would run —
    pop x nbr (ShardedPopulationSolver) and pop x seq (SeqShardedSolver) —
    executed across a REAL 2-process mesh, with the same score-integrity /
    bit-identity assertions the single-process tests make."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        **os.environ,
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }
    script = tmp_path / "worker2d.py"
    script.write_text(_WORKER_2D)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), addr, str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("2-process 2D run timed out")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert "MULTIHOST_2D_OK" in outs[0] + outs[1]
