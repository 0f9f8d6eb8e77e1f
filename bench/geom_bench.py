"""Timed geometry benchmark — the reference's criterion harness analog
(ref examples/diagram/benches/geom_benchmark.rs:6-27: 36 diagonal boxes,
benches OrthogonalVisibilityGraph::new; the reference never stored a
result).  Times the C++ sweep-line visibility-graph build end-to-end
(host-side native code, no accelerator involved) and prints ms per build.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from constraint_solver_tpu.diagram.geometry import (
    Diagram,
    GeomBox,
    OrthogonalVisibilityGraph,
    Padding,
    Ports,
)


def diagonal_boxes(n: int):
    return [
        GeomBox(
            rect=(i * 100.0, i * 100.0, (i + 1) * 100.0, (i + 1) * 100.0),
            padding=Padding.uniform(10.0),
            ports=Ports(1, 1, 1, 1),
        )
        for i in range(n)
    ]


def bench(n_boxes: int, reps: int = 20) -> dict:
    boxes = diagonal_boxes(n_boxes)
    OrthogonalVisibilityGraph(Diagram(boxes))  # warm-up (lib load/build)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        graph = OrthogonalVisibilityGraph(Diagram(boxes))
        times.append(time.perf_counter() - t0)
    return {
        "boxes": n_boxes,
        "vertices": len(graph.vertices),
        "edges": len(graph.edges),
        "ms_median": 1e3 * statistics.median(times),
        "ms_min": 1e3 * min(times),
    }


def main():
    for n in (36, 100, 200):
        r = bench(n)
        print(
            f"visibility-graph {r['boxes']} diagonal boxes: "
            f"{r['ms_median']:.2f} ms median ({r['ms_min']:.2f} min) — "
            f"{r['vertices']} vertices, {r['edges']} edges",
            flush=True,
        )


if __name__ == "__main__":
    main()
