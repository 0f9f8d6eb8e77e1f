"""constraint_solver_tpu — an accelerator-native local-search constraint solver.

A brand-new JAX/XLA/Pallas framework with the capabilities of the Rust
reference ``asimihsan/constraint-solver`` (iterated local search per
Lourenco/Martin/Stuetzle, cf. reference local-search/src/local_search.rs:8-13):

- ``core``     — problem-agnostic ILS engine: dense tabu ring, elite archive,
                 weighted acceptance, perturbation, round-based driver.
- ``models``   — problem domains: Ackley, N-Queens, employee scheduling.
- ``ops``      — device compute ops: lexicographic (hard, soft) score
                 reductions, XOR solution fingerprints.
- ``parallel`` — vmapped trajectory populations and sharded portfolios with
                 collective elite exchange over a device mesh.
- ``utils``    — string seeding (blake2), configs, printing, checkpointing.

Unlike the reference's single-threaded per-move clone-and-rescore loop
(reference local_search.rs:309-339), the hot path here scores entire candidate
neighborhoods in one dense tensor op via O(1) delta evaluation, and runs
thousands of independent trajectories as a vmapped, mesh-sharded population.
"""

__version__ = "0.1.0"

from constraint_solver_tpu.core.problem import Problem, Neighborhood  # noqa: F401
from constraint_solver_tpu.core.ils import Solver, SolverConfig  # noqa: F401
from constraint_solver_tpu.parallel.population import PopulationSolver  # noqa: F401
