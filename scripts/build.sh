#!/usr/bin/env bash
# Build-and-check script — the analog of the reference's build_web.sh
# (runs the whole test suite, builds the native geometry library, and
# renders the diagram demo).
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== tests =="
python -m pytest tests/ -q

echo "== native diagram library =="
python - <<'PY'
from constraint_solver_tpu.diagram.geometry import _build_lib, demo, Diagram, GeomBox, Padding
from constraint_solver_tpu.diagram.png import render_png
from constraint_solver_tpu.diagram.route import route_connectors, route_crossings
print("built:", _build_lib())
out = demo("/tmp/out.svg")
print(f"demo render: {len(out)} bytes -> /tmp/out.svg")
boxes = [GeomBox(rect=(100.0 + 150 * i, 100.0 + 150 * j, 200.0 + 150 * i, 200.0 + 150 * j),
                 padding=Padding.uniform(10.0)) for i in range(3) for j in range(3)]
shape = render_png(Diagram(boxes), "/tmp/out.png")
routes = route_connectors(boxes, [(0, 1), (1, 2), (4, 5)])
assert all(r is not None for r in routes), "router returned fallbacks"
assert route_crossings(routes, boxes) == 0, "routes cross box interiors"
print(f"demo raster: {shape} -> /tmp/out.png; routed {len(routes)} connectors")
PY

echo "== timed geometry bench (ref geom_benchmark.rs analog) =="
python bench/geom_bench.py

echo "== baseline bench binaries =="
mkdir -p build
g++ -O3 -march=native -o build/baseline_nqueens bench/baseline_nqueens.cc
g++ -O3 -march=native -o build/baseline_scheduling bench/baseline_scheduling.cc
echo "built: build/baseline_nqueens build/baseline_scheduling"
echo "OK"
