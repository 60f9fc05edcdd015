"""The virtual-rank world and its process groups.

Counterpart of ``mlsl_tpu.comm.mesh``. The JAX package drives one device per
rank through a single controller; this package keeps that single-controller
contract literally but puts every rank on ONE device: a world of
``world_size`` virtual ranks lives in one process, and a distributed buffer is
one tensor of shape (R, D, S, M, n) whose (r, d, s, m) row is that rank's
local buffer. Collectives are tensor work over the group's grid dims.

Rank layout is the reference grid math (src/mlsl_impl.hpp:224-266) with a
sequence axis, exactly as in the JAX package:
    global rank p  =  ((replicaIdx * D + dataIdx) * S + seqIdx) * M + modelIdx
so the model axis is minor, then sequence, then data, replicas outermost.

A group is axis-aligned (the ranks along some grid axes) or a color group
(``colors[p]`` assigns world rank p to a group, MPI_Comm_split style, as in
``mlsl_tpu.comm.mesh.ProcessGroup``). Color groups may be ragged: the group
size is then the largest group's, and collectives pad to it
(comm/collectives.py).

Tiers (``mesh.py:72-153`` of the JAX package): ``MLSL_MESH_TIERS=TxL``
splits the world's virtual ranks into T tiers of L contiguous ranks (tier =
world rank // L), the synthetic two-tier world the ``hier`` lowering
(comm/algos/hier.py) and the tuner's fingerprint read. The card sits alone,
so this split is the only source of tiers: the JAX package's second source,
TPU multislice's ``device.slice_index``, has no counterpart until a
multi-process transport exists (ROADMAP A.8), and a world without the
variable is flat. A world here is the virtual ranks of one Topology, so the
JAX package's topologies over a subset of the devices have no counterpart
either; the split must cover the topology's world exactly. The tier-aware
survivor shrink (``survivor_devices``) is elastic, ROADMAP A.7.
"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Optional, Tuple

from mlsl_tpu_torch.log import mlsl_assert

REPLICA_AXIS = "replica"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
GRID_AXES = (REPLICA_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
NUM_GRID_AXES = len(GRID_AXES)


def parse_mesh_tiers(spec: str) -> Optional[Tuple[int, int]]:
    """``MLSL_MESH_TIERS='TxL'`` -> (T tiers, L ranks a tier), or None for
    an empty spec. MLSLError on anything but two positive ints joined by
    'x' (``mlsl_tpu.comm.mesh.parse_mesh_tiers``)."""
    spec = (spec or "").strip().lower()
    if not spec:
        return None
    parts = spec.split("x")
    mlsl_assert(len(parts) == 2 and all(p.strip().isdigit() for p in parts),
                "MLSL_MESH_TIERS must be 'TxL' (slices x devices-per-slice), got %r", spec)
    t, l = int(parts[0]), int(parts[1])
    mlsl_assert(t >= 1 and l >= 1, "MLSL_MESH_TIERS slices/locals must be >= 1 (got %dx%d)",
                t, l)
    return t, l


def world_tier_ids(world_size: int) -> Optional[Tuple[int, ...]]:
    """Each virtual rank's tier id (rank // L) under ``MLSL_MESH_TIERS``,
    or None for a flat world (the variable unset). MLSLError when T*L is not
    the world's size."""
    spec = parse_mesh_tiers(os.environ.get("MLSL_MESH_TIERS", ""))
    if spec is None:
        return None
    t, l = spec
    mlsl_assert(t * l == world_size, "MLSL_MESH_TIERS=%dx%d does not cover the %d-rank world",
                t, l, world_size)
    return tuple(p // l for p in range(world_size))


def world_tiers(world_size: int) -> Optional[Tuple[int, int]]:
    """(T, L) of a tiered world, None for a flat one: the shape the
    fingerprint of a tuner profile carries."""
    ids = world_tier_ids(world_size)
    if ids is None:
        return None
    t = len(set(ids))
    return t, world_size // t


class Topology:
    """``world_size`` virtual ranks arranged as a (replica, data, seq, model) grid."""

    def __init__(self, data_parts: int, model_parts: int, world_size: int,
                 seq_parts: int = 1):
        mlsl_assert(
            data_parts > 0 and model_parts > 0 and seq_parts > 0,
            "numbers for data/model/seq groups must be positive",
        )
        l_size = data_parts * model_parts * seq_parts
        mlsl_assert(
            world_size % l_size == 0,
            "world size %d not divisible by dataParts*seqParts*modelParts %d",
            world_size,
            l_size,
        )
        self.data_parts = data_parts
        self.model_parts = model_parts
        self.seq_parts = seq_parts
        self.replica_count = world_size // l_size
        self.world_size = world_size

    # -- rank <-> coordinate math (reference src/mlsl_impl.hpp:224-240) --

    def coords(self, global_idx: int) -> Tuple[int, int, int, int]:
        """global rank -> (replicaIdx, dataIdx, seqIdx, modelIdx)."""
        l_size = self.data_parts * self.seq_parts * self.model_parts
        l_id = global_idx % l_size
        m = l_id % self.model_parts
        s = (l_id // self.model_parts) % self.seq_parts
        d = l_id // (self.model_parts * self.seq_parts)
        return (global_idx // l_size, d, s, m)

    def global_idx(self, replica: int, data: int, seq: int, model: int) -> int:
        return (
            (replica * self.data_parts + data) * self.seq_parts + seq
        ) * self.model_parts + model

    @property
    def grid_shape(self) -> Tuple[int, int, int, int]:
        return (self.replica_count, self.data_parts, self.seq_parts, self.model_parts)

    def axis_size(self, axis: str) -> int:
        return self.grid_shape[GRID_AXES.index(axis)]

    def adopt_buffer(self, buf):
        """Re-view a distributed buffer laid out for ANOTHER grid of the same
        world as this topology's (R, D, S, M, n) buffer
        (``mlsl_tpu.comm.mesh.Topology.adopt_buffer``). A cross-distribution
        graph edge hands one distribution's buffer to a collective over the
        other's groups; rank p's row is row p of both layouts (the rank
        formula is the row-major order of either grid), so this is a reshape
        and never reorders ranks. Anything but a grid buffer of this world is
        returned as it is, for the caller's shape check to refuse."""
        grid = self.grid_shape
        if buf.dim() != NUM_GRID_AXES + 1 or tuple(buf.shape[:NUM_GRID_AXES]) == grid:
            return buf
        rows = 1
        for d in buf.shape[:NUM_GRID_AXES]:
            rows *= d
        if rows != self.world_size:
            return buf
        return buf.reshape(*grid, buf.shape[-1])


@dataclasses.dataclass(frozen=True)
class ProcessGroup:
    """A subgroup of the world over which a collective runs.

    Axis-aligned (colors is None): the ranks along ``axes``; the member index
    is the flattened coordinate over ``axes`` in the given (major -> minor)
    order, as in the JAX package.

    Color-based (colors is not None): ``colors[p]`` assigns world rank p to a
    group; members are ordered by world rank within each color (MPI_Comm_split
    semantics, reference src/comm_ep.cpp:1821-1827)."""

    topology: Topology
    axes: Tuple[str, ...]  # subset of GRID_AXES; () = self
    colors: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        for a in self.axes:
            mlsl_assert(a in GRID_AXES, "unknown grid axis %r", a)
        mlsl_assert(len(set(self.axes)) == len(self.axes),
                    "repeated grid axis in %r", self.axes)
        if self.colors is not None:
            mlsl_assert(len(self.colors) == self.topology.world_size,
                        "colors must cover the world: %d != %d",
                        len(self.colors), self.topology.world_size)

    @property
    def is_self(self) -> bool:
        return self.colors is None and len(self.axes) == 0

    @property
    def group_sizes(self) -> Tuple[int, ...]:
        """Per-color group sizes, ordered by ascending color (colors mode only)."""
        mlsl_assert(self.colors is not None, "group_sizes requires colors mode")
        counts = Counter(self.colors)
        return tuple(counts[c] for c in sorted(counts))

    @property
    def is_uniform(self) -> bool:
        """Every group has the same member count (axis groups always do;
        color groups may be ragged, like MPI_Comm_split's)."""
        if self.colors is None:
            return True
        return len(set(self.group_sizes)) == 1

    @property
    def size(self) -> int:
        """Member count of the group; the largest group's when colors are
        ragged (collectives pad smaller groups to it)."""
        if self.colors is not None:
            return max(self.group_sizes)
        size = 1
        for a in self.axes:
            size *= self.topology.axis_size(a)
        return size

    def live_axes(self) -> Tuple[str, ...]:
        """The group's axes of size > 1, major -> minor."""
        return tuple(a for a in self.axes if self.topology.axis_size(a) > 1)

    def member_world_ranks(self, color: int) -> Tuple[int, ...]:
        """World ranks of a color group, in group-rank order (colors mode only)."""
        mlsl_assert(self.colors is not None, "member_world_ranks requires colors mode")
        return tuple(p for p, c in enumerate(self.colors) if c == color)

    def group_idx_of(self, global_idx: int) -> int:
        """Member index of world rank ``global_idx`` within its group."""
        if self.colors is not None:
            return self.member_world_ranks(self.colors[global_idx]).index(global_idx)
        coord = dict(zip(GRID_AXES, self.topology.coords(global_idx)))
        idx = 0
        for a in self.axes:
            idx = idx * self.topology.axis_size(a) + coord[a]
        return idx

    def member_table(self) -> Tuple[Tuple[int, ...], ...]:
        """One row of world ranks per group instance, members in group-rank
        order. Axis groups: rows ordered by the complementary axes (grid
        order), as ``collectives._axis_groups_tbl`` of the JAX package; color
        groups: one row per color, colors ascending (``_color_groups_tbl``).
        Ragged color groups give rows of different lengths."""
        if self.colors is not None:
            return tuple(self.member_world_ranks(c) for c in sorted(set(self.colors)))
        import itertools

        topo = self.topology
        shape = dict(zip(GRID_AXES, topo.grid_shape))
        comp = [a for a in GRID_AXES if a not in self.axes]
        rows = []
        for comp_coords in itertools.product(*(range(shape[a]) for a in comp)):
            fixed = dict(zip(comp, comp_coords))
            row = []
            for g_coords in itertools.product(*(range(shape[a]) for a in self.axes)):
                c = {**fixed, **dict(zip(self.axes, g_coords))}
                row.append(topo.global_idx(*(c[a] for a in GRID_AXES)))
            rows.append(tuple(row))
        return tuple(rows)
