"""Serve layer tests: the wasm-bridge-shaped HTTP contract
(ref web/employee-scheduling-wasm-bindgen/src/lib.rs + worker.ts protocol).

The server runs as a real subprocess (its production shape): jit-compiling
inside this process's HTTP handler threads segfaulted XLA's CPU compiler
intermittently once the full suite had accumulated enough compiled
programs, and a subprocess also exercises the actual
`python -m constraint_solver_tpu.serve.server` entry point end-to-end."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server_url():
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "constraint_solver_tpu.serve.server",
         "--port", "0", "--platform", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    url = None
    for line in proc.stdout:
        if line.startswith("serving on "):
            url = line.split("serving on ", 1)[1].strip()
            break
    assert url, "server did not report its address"
    yield url
    proc.terminate()
    proc.wait(timeout=30)


def _req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_full_worker_protocol(server_url):
    # create_solver (wasm lib.rs:19-53 input shape)
    status, res = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09",
        "endDate": "2022-05-22",
        "employees": [{"id": 0}, {"id": 1}, {"id": 2}, {"id": 3}],
        "employeeHolidays": [[], ["2022-05-10"], [], []],
        "iterated_local_search_max_iterations": 5,
        "local_search_max_iterations": 100,
    })
    assert status == 200
    sid = res["solverId"]

    # worker tick loop: one round per message until finished (worker.ts:7-27)
    ticks = 0
    while True:
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        assert set(r) == {"isFinished", "iterationInfo", "result"}
        ticks += 1
        if r["isFinished"]:
            break
        assert ticks < 20
    assert r["iterationInfo"]["current"] == 5
    assert r["result"]["score"]["hard_score"] >= 0
    # days_to_employees uses the '%a %Y-%m-%d' label format (wasm lib.rs:80)
    day0, emp0 = r["result"]["days_to_employees"][0]
    assert day0 == "Mon 2022-05-09"
    assert "id" in emp0
    assert len(r["result"]["days_to_employees"]) == 14

    # info + best endpoints
    status, info = _req(f"{server_url}/api/solvers/{sid}/info")
    assert (status, info["current"]) == (200, 5)
    status, best = _req(f"{server_url}/api/solvers/{sid}/best")
    assert status == 200 and "score" in best

    # cancel/free
    status, _ = _req(f"{server_url}/api/solvers/{sid}", "DELETE")
    assert status == 200
    status, _ = _req(f"{server_url}/api/solvers/{sid}/info")
    assert status == 404


def test_validation_errors(server_url):
    status, err = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09", "endDate": "2022-05-01",
        "employees": [{"id": 0}], "employeeHolidays": [[]],
    })
    assert status == 400 and "endDate" in err["error"]
    status, err = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09", "endDate": "2022-05-10",
        "employees": [], "employeeHolidays": [],
    })
    assert status == 400
    status, _ = _req(server_url + "/api/solvers/nope/round", "POST")
    assert status == 404


def test_index_page(server_url):
    with urllib.request.urlopen(server_url + "/") as resp:
        html = resp.read().decode()
    assert "Employee scheduling" in html
    assert "Start solving" in html


def test_best_before_first_round_is_valid_json(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09", "endDate": "2022-05-15",
        "employees": [{"id": 0}, {"id": 1}], "employeeHolidays": [[], []],
    })
    sid = res["solverId"]
    status, best = _req(f"{server_url}/api/solvers/{sid}/best")
    assert status == 200
    assert best["score"]["hard_score"] is None
    assert best["days_to_employees"] == []
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_missing_fields_return_400(server_url):
    status, err = _req(server_url + "/api/solvers", "POST", {"employees": []})
    assert status == 400
    assert "startDate" in err["error"]


def test_nqueens_solver_endpoint(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        "problem": "nqueens", "boardSize": 8, "seed": "42",
        "iterated_local_search_max_iterations": 30,
    })
    assert status == 200
    sid = res["solverId"]
    for _ in range(30):
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        if r["isFinished"]:
            break
    rows = r["result"]["rows"]
    assert sorted(rows) == list(range(8))  # a permutation
    assert r["result"]["score"]["hard_score"] == 0.0  # 8-queens solves fast
    # svg endpoint is diagram-only
    req = urllib.request.Request(f"{server_url}/api/solvers/{sid}/svg")
    try:
        urllib.request.urlopen(req)
        raise AssertionError("expected 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_diagram_solver_endpoint_with_svg(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        "problem": "diagram", "boxes": 5, "edges": 4, "grid": 8,
        "iterated_local_search_max_iterations": 15,
    })
    assert status == 200
    sid = res["solverId"]
    for _ in range(15):
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        if r["isFinished"]:
            break
    pos = r["result"]["positions"]
    assert len(pos) == 5 and all(len(p) == 2 for p in pos)
    with urllib.request.urlopen(f"{server_url}/api/solvers/{sid}/svg") as resp:
        assert resp.headers["Content-Type"] == "image/svg+xml"
        svg = resp.read().decode()
    assert svg.startswith("<svg")
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_unknown_problem_rejected(server_url):
    status, err = _req(server_url + "/api/solvers", "POST",
                       {"problem": "sudoku"})
    assert status == 400 and "sudoku" in err["error"]


def test_numeric_seed_and_stringy_ints_coerced(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09", "endDate": "2022-05-15",
        "employees": [{"id": 0}, {"id": 1}], "employeeHolidays": [[], []],
        "seed": 42,  # JSON number, not string
        "iterated_local_search_max_iterations": "3",  # stringy int
    })
    assert status == 200
    sid = res["solverId"]
    status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
    assert status == 200
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")
    # Uncoercible values are a 400, not a handler-thread crash.
    status, err = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09", "endDate": "2022-05-15",
        "employees": [{"id": 0}], "employeeHolidays": [[]],
        "local_search_max_iterations": "many",
    })
    assert status == 400


def test_mismatched_holiday_lists_rejected(server_url):
    status, err = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09", "endDate": "2022-05-15",
        "employees": [{"id": 0}, {"id": 1}, {"id": 2}],
        "employeeHolidays": [[], ["2022-05-10"]],  # one short
    })
    assert status == 400 and "employeeHolidays" in err["error"]


def test_ui_shaped_holiday_payload_drives_h1(server_url):
    """The served UI posts per-employee
    holiday lists (add/remove rows).  A UI-shaped payload where the ONLY
    employee is on holiday every single day forces H1 = num_days — the hard
    score must report exactly those violations."""
    days = ["2022-05-%02d" % d for d in range(9, 16)]  # 7 days
    status, res = _req(server_url + "/api/solvers", "POST", {
        "startDate": days[0],
        "endDate": days[-1],
        "employees": [{"id": 5}],          # sparse id, as after UI removals
        "employeeHolidays": [days],
        "iterated_local_search_max_iterations": 2,
        "local_search_max_iterations": 20,
    })
    assert status == 200
    sid = res["solverId"]
    status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
    assert status == 200
    # One employee, holidays on all 7 days: every day is an H1 violation,
    # and 6 consecutive-day pairs are H2 violations, S1 adds 1 per 7-window.
    assert r["result"]["score"]["hard_score"] >= 7.0
    # The employee id in the payload round-trips (not its dense index).
    assert r["result"]["days_to_employees"][0][1]["id"] == 5
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_ui_holidays_reduce_to_zero_when_avoidable(server_url):
    """Three employees over one week, one holiday each on different days:
    the solver must find a hard=0 schedule (H1 avoidable by assigning
    another employee; H4 inactive at 7 days — over 14+ days hard=0 needs
    >= 5 employees since each may work at most 3 shifts per 14-day window)."""
    status, res = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09",
        "endDate": "2022-05-15",
        "employees": [{"id": 0}, {"id": 1}, {"id": 2}],
        "employeeHolidays": [["2022-05-10"], ["2022-05-11"], []],
        "iterated_local_search_max_iterations": 30,
        "local_search_max_iterations": 200,
    })
    assert status == 200
    sid = res["solverId"]
    best_hard = None
    for _ in range(30):
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        best_hard = r["result"]["score"]["hard_score"]
        if r["isFinished"] or best_hard == 0.0:
            break
    assert best_hard == 0.0, best_hard
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_index_html_has_employee_rows_and_holiday_inputs(server_url):
    """The served UI exposes the reference form's add/remove-employee and
    per-employee holiday capability (ref index.html:13-61, index.ts:20-60)."""
    req = urllib.request.Request(server_url + "/")
    with urllib.request.urlopen(req) as resp:
        html = resp.read().decode()
    assert "addEmployee" in html
    assert "holidays" in html
    assert "employeeHolidays" in html
    assert 'class="rm"' in html  # per-row remove button


def test_population_quality_mode(server_url):
    """population > 1 + proposer=random: the quality-at-wall
    configuration, served through the same
    round-based protocol — the result must carry the full schedule and a
    feasible (hard=0-reachable) score after the round budget."""
    status, res = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09",
        "endDate": "2022-05-22",
        "employees": [{"id": 0}, {"id": 1}, {"id": 2}, {"id": 3}, {"id": 4}],
        "employeeHolidays": [[], [], [], [], []],
        "proposer": "random",
        "population": 4,
        "iterated_local_search_max_iterations": 25,
        "local_search_max_iterations": 200,
    })
    assert status == 200
    sid = res["solverId"]
    while True:
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        if r["isFinished"]:
            break
    assert r["result"]["score"]["hard_score"] == 0
    assert len(r["result"]["days_to_employees"]) == 14
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_population_bounds_rejected(server_url):
    """Non-positive or non-numeric populations, and populations just past
    the device-memory bound, are rejected with 400, never attempted."""
    from constraint_solver_tpu.serve.server import max_population

    base = {
        "startDate": "2022-05-09",
        "endDate": "2022-05-15",
        "employees": [{"id": 0}, {"id": 1}],
        "employeeHolidays": [[], []],
    }
    year = {
        "startDate": "2024-01-01",
        "endDate": "2024-12-30",
        "employees": [{"id": e} for e in range(20)],
        "employeeHolidays": [[] for _ in range(20)],
    }
    for payload, bad in (
        (base, {"population": 0}), (base, {"population": -5}),
        (base, {"population": "lots"}), (base, {"population": None}),
        (base, {"population": max_population("dense", 7, 2) + 1}),
        (year, {"population": max_population("random", 365, 20) + 1,
                "proposer": "random"}),
        (year, {"population": max_population("systematic", 365, 20) + 1,
                "proposer": "systematic"}),
    ):
        status, res = _req(server_url + "/api/solvers", "POST",
                           {**payload, **bad})
        assert status == 400, (bad, res)
        assert "error" in res


def test_population_bound_covers_measured_lanes():
    """The bound against the H100 measurements it comes from
    (bench/serve_memory.py): systematic 365x20 at P=64 took 17.2 GB, past
    the 16 GiB a session may use; dense 730x40 took 1.68 MB per lane."""
    from constraint_solver_tpu.serve.server import max_population

    assert 1 <= max_population("systematic", 365, 20) < 64
    assert max_population("dense", 730, 40) * 1_680_141 <= 16 * 2**30
    assert max_population("dense", 7, 2) == max_population("dense", 365, 20)


def test_noisy_dense_selection_served(server_url):
    """select_topk/select_temp ride the wasm-shaped payload: the
    noisy-dense quality configuration is servable end-to-end, and bad
    values 400."""
    base = {
        "startDate": "2022-05-09",
        "endDate": "2022-05-22",
        "employees": [{"id": 0}, {"id": 1}, {"id": 2}, {"id": 3}, {"id": 4}],
        "employeeHolidays": [[], [], [], [], []],
        "proposer": "dense",
        "select_topk": 64,
        "select_temp": 0.5,
        "iterated_local_search_max_iterations": 40,
        "local_search_max_iterations": 200,
    }
    status, res = _req(server_url + "/api/solvers", "POST", base)
    assert status == 200
    sid = res["solverId"]
    while True:
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        if r["isFinished"]:
            break
    assert r["result"]["score"]["hard_score"] == 0
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")

    status, res = _req(server_url + "/api/solvers", "POST",
                       {**base, "select_temp": 0})
    assert status == 400
