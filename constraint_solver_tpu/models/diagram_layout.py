"""Diagram layout domain — the solver integration the reference never built.

The reference's diagram crate ships orthogonal connector-routing *geometry*
(sweep-line interesting segments, visibility graph) but its solver hookup is
two empty structs (reference examples/diagram/src/main.rs:7-9:
``DiagramSpecification`` / ``DiagramSolution``) — the domain was never wired
into the ILS engine.  This module completes that intent, accelerator-first:

Problem: place B axis-aligned boxes (integer sizes) on a G x G grid of cells,
minimizing lexicographically

    hard = number of overlapping box pairs        (must reach 0)
    soft = total Manhattan distance between the centers of connected boxes
           (the standard proxy for orthogonal connector length: every
           connector is at least the Manhattan distance between its
           endpoints, cf. the Wybrow/Marriott/Stuckey objective the
           reference's geometry implements)

State is ``pos: int32[B, 2]`` (top-left cell of each box).  The whole
``B x G x G`` move neighborhood ("relocate box b to cell (x, y)") is scored
by delta evaluation in one dense pass:

- pair overlaps of a relocated box against every other box factor into
  independent x/y interval tests, so ``new_overlaps[b, x, y] =
  sum_j ox[b, j, x] * oy[b, j, y]`` is one batched [G, B] @ [B, G] matmul
  per box — one matmul scores every candidate placement's hard delta;
- connector lengths separate per axis, so the soft delta is two
  ``[B, E] @ [E, G]``-shaped contractions plus a broadcast add.

No gathers, no scatters, no data-dependent shapes (docs/DESIGN.md rules).
After the solve, ``constraint_solver_tpu.diagram`` turns the grid layout
into real geometry: the C++ sweep builds the visibility graph and
``diagram/route.py`` routes each connector on it (reference lib.rs:620-705
builds the same graph but never routes).

Property-tested against a naive host oracle (tests/test_diagram_layout.py).
"""

from __future__ import annotations

from functools import lru_cache

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from constraint_solver_tpu.core.problem import Neighborhood, Problem
from constraint_solver_tpu.ops.fingerprint import fingerprint_i32, fp_update
from constraint_solver_tpu.ops.lex import make_score


class DiagramLayoutSpec(NamedTuple):
    """B boxes with integer cell sizes, E connectors, on a G x G grid.

    sizes: ((w, h), ...) per box, in grid cells (>= 1).
    edges: ((a, b), ...) connector endpoints (box indices).
    grid:  G — positions are top-left cells; box b occupies
           [x, x + w_b) x [y, y + h_b) and must satisfy x <= G - w_b.
    """

    sizes: tuple
    edges: tuple
    grid: int

    @staticmethod
    def random(
        n_boxes: int,
        n_edges: int,
        grid: int,
        seed: int = 0,
        max_size: int = 3,
    ) -> "DiagramLayoutSpec":
        """Random instance: uniform box sizes, distinct random connectors."""
        rng = np.random.default_rng(seed)
        sizes = rng.integers(1, max_size + 1, (n_boxes, 2))
        pairs = [(a, b) for a in range(n_boxes) for b in range(a + 1, n_boxes)]
        take = min(n_edges, len(pairs))
        chosen = rng.choice(len(pairs), size=take, replace=False)
        edges = tuple(pairs[i] for i in sorted(chosen))
        return DiagramLayoutSpec(
            sizes=tuple(map(tuple, sizes.tolist())), edges=edges, grid=grid
        )

    @staticmethod
    def chain(n_boxes: int, grid: int, size: int = 2) -> "DiagramLayoutSpec":
        """Uniform boxes connected in a path — the layout analog of the
        reference demo's 3x3 grid of uniform boxes (main.rs:158-179)."""
        return DiagramLayoutSpec(
            sizes=tuple((size, size) for _ in range(n_boxes)),
            edges=tuple((i, i + 1) for i in range(n_boxes - 1)),
            grid=grid,
        )

    def arrays(self):
        sizes = np.asarray(self.sizes, np.int32)  # [B, 2]
        edges = (
            np.asarray(self.edges, np.int32).reshape(-1, 2)
            if self.edges
            else np.zeros((0, 2), np.int32)
        )
        return sizes, edges


def layout_score_naive(spec: DiagramLayoutSpec, pos: np.ndarray):
    """Host oracle: direct O(B^2 + E) rescore. Returns (hard, soft)."""
    sizes, edges = spec.arrays()
    pos = np.asarray(pos)
    b = len(sizes)
    hard = 0
    for i in range(b):
        for j in range(i + 1, b):
            ox = (pos[i, 0] < pos[j, 0] + sizes[j, 0]) and (
                pos[j, 0] < pos[i, 0] + sizes[i, 0]
            )
            oy = (pos[i, 1] < pos[j, 1] + sizes[j, 1]) and (
                pos[j, 1] < pos[i, 1] + sizes[i, 1]
            )
            hard += int(ox and oy)
    centers = pos * 2 + sizes  # doubled centers, exact in ints
    soft = 0.0
    for a, c in edges:
        soft += abs(int(centers[a, 0]) - int(centers[c, 0])) + abs(
            int(centers[a, 1]) - int(centers[c, 1])
        )
    return float(hard), float(soft) / 2.0


@lru_cache(maxsize=32)
def make_diagram_layout_problem(spec: DiagramLayoutSpec) -> Problem:
    sizes_np, edges_np = spec.arrays()
    n_boxes = sizes_np.shape[0]
    grid = spec.grid
    if np.any(sizes_np > grid):
        raise ValueError("box larger than grid")
    sizes = jnp.asarray(sizes_np)  # int32[B, 2]
    # Symmetric connector-multiplicity matrix A[i, j].
    adj_np = np.zeros((n_boxes, n_boxes), np.float32)
    for a, c in edges_np:
        adj_np[a, c] += 1.0
        adj_np[c, a] += 1.0
    adj = jnp.asarray(adj_np)
    # Highest legal top-left cell per box and axis: int32[B, 2].
    max_pos = grid - sizes_np  # numpy, static
    max_pos_j = jnp.asarray(max_pos)
    cells = jnp.arange(grid, dtype=jnp.int32)

    def centers2(pos):
        """Doubled box centers (exact integers), float32[B, 2]."""
        return (pos * 2 + sizes).astype(jnp.float32)

    def overlap_pairs(pos):
        """bool[B, B] unordered-pair overlap matrix (diag False)."""
        lo = pos  # [B, 2]
        hi = pos + sizes
        ov = (lo[:, None, :] < hi[None, :, :]) & (lo[None, :, :] < hi[:, None, :])
        ov = ov[..., 0] & ov[..., 1]
        return ov & ~jnp.eye(n_boxes, dtype=bool)

    def score(pos):
        hard = jnp.sum(overlap_pairs(pos)) / 2
        c2 = centers2(pos)
        d = jnp.abs(c2[:, None, :] - c2[None, :, :]).sum(-1)  # [B, B]
        soft = jnp.sum(adj * d) / 4.0  # /2 pairs double-counted, /2 centers
        return make_score(hard.astype(jnp.float32), soft)

    def init(key):
        u = jax.random.uniform(key, (n_boxes, 2))
        return (u * (max_pos_j + 1)).astype(jnp.int32)

    def is_best(s):
        return jnp.asarray(False)  # soft optimum unknown in general

    def fingerprint(pos):
        return fingerprint_i32(pos.reshape(-1))

    def neighborhood(pos, cur_score, _key):
        lo = pos.astype(jnp.float32)
        hi = (pos + sizes).astype(jnp.float32)
        cf = cells.astype(jnp.float32)
        # x/y interval overlap of "box b placed at coordinate c" vs box j:
        # ox[b, j, c] = (c < hi_x[j]) & (lo_x[j] < c + w_b)
        w = sizes[:, 0].astype(jnp.float32)[:, None, None]
        h = sizes[:, 1].astype(jnp.float32)[:, None, None]
        c_ = cf[None, None, :]
        ox = (c_ < hi[None, :, 0, None]) & (lo[None, :, 0, None] < c_ + w)
        oy = (c_ < hi[None, :, 1, None]) & (lo[None, :, 1, None] < c_ + h)
        noself = (~jnp.eye(n_boxes, dtype=bool))[:, :, None]
        oxf = (ox & noself).astype(jnp.float32)
        oyf = (oy & noself).astype(jnp.float32)
        # new_ov[b, x, y] = sum_j ox[b,j,x] * oy[b,j,y]  — batched matmul.
        new_ov = jnp.einsum(
            "bjx,bjy->bxy", oxf, oyf, preferred_element_type=jnp.float32
        )
        cur_ov_b = jnp.sum(overlap_pairs(pos), axis=1).astype(jnp.float32)
        d_hard = new_ov - cur_ov_b[:, None, None]  # [B, G, G]

        # Soft: connector Manhattan length separates per axis.
        c2 = centers2(pos)  # [B, 2] doubled centers
        # Candidate doubled center of box b at cell c: 2c + size_b.
        candx = 2.0 * cf[None, :] + sizes[:, 0].astype(jnp.float32)[:, None]
        candy = 2.0 * cf[None, :] + sizes[:, 1].astype(jnp.float32)[:, None]
        # dx[b, j, x] = |candx[b, x] - c2x[j]|; contract with adj over j.
        newx = jnp.einsum(
            "bj,bjx->bx",
            adj,
            jnp.abs(candx[:, None, :] - c2[None, :, 0, None]),
            preferred_element_type=jnp.float32,
        )
        newy = jnp.einsum(
            "bj,bjx->bx",
            adj,
            jnp.abs(candy[:, None, :] - c2[None, :, 1, None]),
            preferred_element_type=jnp.float32,
        )
        dxy = jnp.abs(c2[:, None, :] - c2[None, :, :]).sum(-1)
        cur_edge_b = jnp.sum(adj * dxy, axis=1)  # [B]
        d_soft = (
            newx[:, :, None] + newy[:, None, :] - cur_edge_b[:, None, None]
        ) / 2.0  # halve doubled-center units

        cand = cur_score[None, None, None, :] + jnp.stack(
            [d_hard, d_soft], axis=-1
        )
        # Mask placements that stick out of the grid, and the no-op
        # "stay where you are" cell (same convention as qap.py's
        # no-no-ops mask: a zero-delta no-op would win every plateau
        # argmin and burn a tabu retry).
        vx = cells[None, :] <= max_pos_j[:, 0, None]  # [B, G]
        vy = cells[None, :] <= max_pos_j[:, 1, None]
        valid = vx[:, :, None] & vy[:, None, :]
        noop = (cells[None, :, None] == pos[:, 0, None, None]) & (
            cells[None, None, :] == pos[:, 1, None, None]
        )
        valid = valid & ~noop
        ib = jnp.arange(n_boxes, dtype=jnp.int32)
        b_idx = jnp.broadcast_to(
            ib[:, None, None], (n_boxes, grid, grid)
        ).reshape(-1)
        x_idx = jnp.broadcast_to(
            cells[None, :, None], (n_boxes, grid, grid)
        ).reshape(-1)
        y_idx = jnp.broadcast_to(
            cells[None, None, :], (n_boxes, grid, grid)
        ).reshape(-1)
        return Neighborhood(
            scores=cand.reshape(-1, 2),
            moves=(b_idx, x_idx, y_idx),
            valid=valid.reshape(-1),
        )

    def move_fp(pos, cur_fp, moves, idx):
        b_idx, x_idx, y_idx = moves
        b, x, y = b_idx[idx], x_idx[idx], y_idx[idx]
        old = pos[b]
        fp = fp_update(
            cur_fp, 2 * b, old[0].astype(jnp.uint32), x.astype(jnp.uint32)
        )
        return fp_update(
            fp, 2 * b + 1, old[1].astype(jnp.uint32), y.astype(jnp.uint32)
        )

    def apply_move(pos, moves, idx):
        b_idx, x_idx, y_idx = moves
        b = b_idx[idx]
        return pos.at[b].set(jnp.stack([x_idx[idx], y_idx[idx]]))

    def perturb(pos, is_elite, key):
        """ChangeSubset:100 / DoNothing:10 (the reference domains' shared
        perturbation shape, e.g. nqueens lib.rs:258-320): relocate
        k ~ U[1, B/20] boxes near elites else U[1, B/2] to random cells."""
        k_strat, k_n, k_sel, k_pos = jax.random.split(key, 4)
        do_change = jax.random.uniform(k_strat) < (100.0 / 110.0)
        hi = jnp.where(is_elite, max(1, n_boxes // 20), max(1, n_boxes // 2))
        n_alter = jax.random.randint(k_n, (), 1, hi + 1)
        u = jax.random.uniform(k_sel, (n_boxes,))
        kth = jax.lax.dynamic_index_in_dim(
            jnp.sort(u), n_alter - 1, keepdims=False
        )
        sel = (u <= kth)[:, None]
        fresh = (
            jax.random.uniform(k_pos, (n_boxes, 2)) * (max_pos_j + 1)
        ).astype(jnp.int32)
        return jnp.where(do_change & sel, fresh, pos)

    return Problem(
        name=f"diagram-{n_boxes}b-{grid}g",
        init=init,
        score=score,
        is_best=is_best,
        fingerprint=fingerprint,
        neighborhood=neighborhood,
        move_fp=move_fp,
        apply_move=apply_move,
        perturb=perturb,
        width=n_boxes * grid * grid,
    )


def layout_to_boxes(spec: DiagramLayoutSpec, pos, cell: float = 60.0,
                    pad: float = 10.0):
    """Grid layout → GeomBox list for the C++ visibility-graph pipeline."""
    from constraint_solver_tpu.diagram.geometry import GeomBox, Padding, Ports

    sizes, _ = spec.arrays()
    pos = np.asarray(pos)
    boxes = []
    for (x, y), (w, h) in zip(pos, sizes):
        boxes.append(
            GeomBox(
                rect=(
                    float(x) * cell + pad,
                    float(y) * cell + pad,
                    float(x + w) * cell - pad,
                    float(y + h) * cell - pad,
                ),
                padding=Padding.uniform(pad / 2.0),
                ports=Ports(1, 1, 1, 1),
            )
        )
    return boxes
