"""Device memory per population lane of a served scheduling session.

Creates each session through ``SolverService`` (the HTTP service's back end,
at the service's default capacities), compiles its one-round program and
reads XLA's memory analysis of it: arguments + outputs - aliased + temps,
which is what a round needs on the device.  Divided by the population, that
is the per-lane cost the service's population bound is derived from
(``serve/server.py``).

    python bench/serve_memory.py
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from constraint_solver_tpu.serve.server import SolverService  # noqa: E402
from constraint_solver_tpu.utils import compile_cache  # noqa: E402

START = datetime.date(2024, 1, 1)
# (proposer, days, employees, population)
CASES = [
    ("random", 365, 20, 16), ("random", 365, 20, 64), ("random", 730, 40, 64),
    ("rescore", 365, 20, 64), ("systematic", 365, 20, 64),
    ("dense", 365, 20, 16), ("dense", 365, 20, 64), ("dense", 730, 40, 64),
]


def payload(proposer: str, days: int, emps: int, population: int) -> dict:
    return {
        "startDate": START.isoformat(),
        "endDate": (START + datetime.timedelta(days=days - 1)).isoformat(),
        "employees": [{"id": e} for e in range(emps)],
        "employeeHolidays": [[] for _ in range(emps)],
        "population": population, "proposer": proposer,
    }


def main() -> int:
    compile_cache.enable()
    if jax.devices()[0].platform == "gpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    service = SolverService()
    rows = []
    for proposer, days, emps, pop in CASES:
        sid = service.create(payload(proposer, days, emps, pop))
        solver = service._ctx(sid)["solver"]
        mem = solver._chunk_jit.lower(solver.state, 1).compile().memory_analysis()
        need = (mem.argument_size_in_bytes + mem.output_size_in_bytes
                - mem.alias_size_in_bytes + mem.temp_size_in_bytes)
        service.delete(sid)
        row = dict(proposer=proposer, days=days, employees=emps, population=pop,
                   width=solver.problem.width,
                   argument_bytes=mem.argument_size_in_bytes,
                   temp_bytes=mem.temp_size_in_bytes, round_bytes=need,
                   bytes_per_lane=need / pop,
                   bytes_per_lane_cell=need / pop / (days * emps))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
