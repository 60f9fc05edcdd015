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
(comm/algos/hier.py) and the tuner's fingerprint read. The JAX package's
second source, TPU multislice's ``device.slice_index``, is the host here: a
world whose processes (comm/transport.py) sit on more than one host is
tiered by host, each rank in the tier of its process's host; a one-host
world without the variable is flat. A world here is the virtual ranks of one
Topology, so the JAX package's topologies over a subset of the devices have
no counterpart either; the split must cover the full world exactly, and a
shrunk world's ranks keep their tiers by identity. ``survivor_devices`` is the elastic
mesh's tier-aware shrink: losing any member of a tier drops the whole tier.

Processes (``Environment.init(coordinator_address=..., num_processes=P,
process_id=i)``): process i owns the contiguous global ranks [i*L, (i+1)*L),
L = W / P, the JAX package's global-rank-major device order
(``dcn_aware_devices``). Its distributed buffers hold only those ranks' rows:
the box (R_l, D_l, S_l, M_l, n) of ``Topology.local_shape``. A contiguous
aligned block of a row-major grid is a box when it covers whole minor axes
and an aligned run of one axis; any other grid is refused with MLSLError
(standing difference "the local box"). A group whose every instance lies in
one process is *process-local* and runs on the box as on a world of its own
(``ProcessGroup.localize``); a group that spans processes crosses them
through comm/transport.py. With one process the box is the whole grid and
nothing changes.
"""

from __future__ import annotations

import dataclasses
import math
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


def _survivor_ranks(world_size: int) -> Optional[Tuple[int, ...]]:
    """The elastic registry's survivor ranks (full-world numbering) when the
    world of ``world_size`` ranks is that survivor world, else None."""
    from mlsl_tpu_torch import elastic

    active = elastic.active_devices()
    return active if active is not None and len(active) == world_size else None


def dcn_aware_devices(model_parts: int, seq_parts: int = 1, ranks=None) -> Tuple[int, ...]:
    """The ranks in process-major order, each process's ranks by id, after
    the JAX package's check (``mesh.py:39-69``): model_parts * seq_parts
    must divide every process's rank count, so that model and sequence
    groups stay inside one process (one host) and only the data axis
    crosses processes. ``ranks``: objects with ``process_index`` and ``id``
    (the JAX package's devices) or (process, id) pairs; default the world's
    virtual ranks under the process layout (``transport.world()``), which
    are already in that order. -> the ranks' ids."""
    if ranks is None:
        from mlsl_tpu_torch.comm import transport

        w = transport.world()
        ranks = [(transport.owner_of(p, w.world_size, w.count), p)
                 for p in range(w.world_size)]
    by_proc: dict = {}
    for r in ranks:
        proc, rid = (r.process_index, r.id) if hasattr(r, "process_index") else r
        by_proc.setdefault(int(proc), []).append(int(rid))
    block = model_parts * seq_parts
    for proc, ids in by_proc.items():
        mlsl_assert(len(ids) % block == 0,
                    "host %d has %d devices; model_parts*seq_parts=%d must divide the "
                    "per-host device count for model/seq groups to stay on ICI",
                    proc, len(ids), block)
    return tuple(rid for proc in sorted(by_proc) for rid in sorted(by_proc[proc]))


def world_tier_ids(world_size: int, ranks=None) -> Optional[Tuple[int, ...]]:
    """Each virtual rank's tier id, or None for a flat world. First
    ``MLSL_MESH_TIERS``; without it, the host of each rank's process when
    the processes sit on more than one host (the JAX package's
    ``slice_index``, ``mesh.py:94-136``). ``ranks``: the world's ranks in
    the full world's numbering (default: the elastic survivor ranks when the
    world is a shrunk one, else ``range(world_size)``). The split describes
    the full world and a rank keeps its tier by identity, as a device keeps
    its slice in the JAX package: a survivor world of one tier is one tier.
    MLSLError when T*L does not cover the full world."""
    spec = parse_mesh_tiers(os.environ.get("MLSL_MESH_TIERS", ""))
    if spec is None:
        return _host_tier_ids(world_size, ranks)
    t, l = spec
    if ranks is None:
        ranks = _survivor_ranks(world_size)
    if ranks is None:
        mlsl_assert(t * l == world_size,
                    "MLSL_MESH_TIERS=%dx%d does not cover the %d-rank world", t, l, world_size)
        ranks = range(world_size)
    ranks = [int(r) for r in ranks]
    mlsl_assert(all(0 <= r < t * l for r in ranks),
                "MLSL_MESH_TIERS=%dx%d does not cover ranks %s", t, l, ranks)
    raw = [r // l for r in ranks]
    order = {s: i for i, s in enumerate(sorted(set(raw)))}
    return tuple(order[s] for s in raw)


def _host_tier_ids(world_size: int, ranks) -> Optional[Tuple[int, ...]]:
    """Tiers by host: rank p's tier is the index, in sorted host names, of
    the host of the process that owns p. None on a one-host world."""
    from mlsl_tpu_torch.comm import transport

    w = transport.world()
    if w.count <= 1 or len(set(w.hosts)) <= 1 or w.world_size != world_size:
        return None
    order = {h: i for i, h in enumerate(sorted(set(w.hosts)))}
    ranks = range(world_size) if ranks is None else ranks
    return tuple(order[w.hosts[transport.owner_of(int(r), world_size, w.count)]]
                 for r in ranks)


def world_tiers(world_size: int) -> Optional[Tuple[int, int]]:
    """(T, L) of a tiered world, None for a flat one: the shape the
    fingerprint of a tuner profile carries."""
    ids = world_tier_ids(world_size)
    if ids is None:
        return None
    t = len(set(ids))
    return t, world_size // t


def survivor_devices(lost, devices) -> Tuple[int, ...]:
    """The post-loss world (``mlsl_tpu/comm/mesh.py:156-182``) over virtual
    ranks: ``devices`` (the active world's ranks, full-world numbering) less
    ``lost``, in world order -- the survivor set an elastic reshard
    (``mlsl_tpu_torch.elastic``) rebuilds its Topology over. Tier-aware: on
    an ``MLSL_MESH_TIERS`` world, losing any member of a tier drops the whole
    tier; a flat world sheds exactly the lost ranks. MLSLError when no rank
    survives."""
    from mlsl_tpu_torch.log import MLSLError

    devices = tuple(int(d) for d in devices)
    lost_set = {int(d) for d in lost}
    ids = world_tier_ids(len(devices), ranks=devices)
    if ids is not None:
        dead_tiers = {t for d, t in zip(devices, ids) if d in lost_set}
        out = tuple(d for d, t in zip(devices, ids) if t not in dead_tiers)
    else:
        out = tuple(d for d in devices if d not in lost_set)
    if not out:
        raise MLSLError(
            f"device loss of {len(lost_set)} device(s) leaves no survivors "
            f"in the {len(devices)}-device world (tiered={ids is not None})")
    return out


def process_box(grid: Tuple[int, ...], nproc: int, index: int):
    """-> (origin, shape): the box of the grid that process ``index`` of
    ``nproc`` owns, the ranks [index*L, (index+1)*L) of the row-major grid.
    MLSLError when the world does not split evenly or the block is not a
    box (standing difference "the local box")."""
    world = math.prod(grid)
    mlsl_assert(nproc >= 1 and world % nproc == 0,
                "a world of %d ranks does not split over %d processes", world, nproc)
    rem = world // nproc
    shape = [1] * len(grid)
    for i in range(len(grid) - 1, -1, -1):
        if rem >= grid[i]:
            mlsl_assert(rem % grid[i] == 0,
                        "process block of %d ranks is not a box of the grid %s: it "
                        "splits axis %d of %d (use a grid whose minor axes divide the "
                        "ranks a process holds)", world // nproc, tuple(grid), i, grid[i])
            shape[i] = grid[i]
            rem //= grid[i]
        else:
            mlsl_assert(grid[i] % rem == 0,
                        "process block of %d ranks is not a box of the grid %s: %d ranks "
                        "do not tile axis %d of %d", world // nproc, tuple(grid), rem, i,
                        grid[i])
            shape[i] = rem
            rem = 1
    lo = index * (world // nproc)
    origin = [(lo // math.prod(grid[i + 1:])) % grid[i] for i in range(len(grid))]
    return tuple(origin), tuple(shape)


class Topology:
    """``world_size`` virtual ranks arranged as a (replica, data, seq, model)
    grid; with ``procs=(P, i)``, process i of P holds the box of its ranks
    (``local_shape``)."""

    def __init__(self, data_parts: int, model_parts: int, world_size: int,
                 seq_parts: int = 1, procs: Tuple[int, int] = (1, 0)):
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
        self.num_procs, self.proc_index = int(procs[0]), int(procs[1])
        self.local_origin, self.local_shape = process_box(self.grid_shape, self.num_procs,
                                                          self.proc_index)
        self.local_size = world_size // self.num_procs
        self.local_lo = self.proc_index * self.local_size
        self._local_topo: Optional["Topology"] = None

    # -- the process layout ------------------------------------------------

    def owner(self, global_idx: int) -> int:
        """The process that holds rank ``global_idx``."""
        return int(global_idx) // self.local_size

    def is_local(self, global_idx: int) -> bool:
        return self.owner(global_idx) == self.proc_index

    def local_ranks(self) -> range:
        """This process's global ranks, in order (row-major in its box)."""
        return range(self.local_lo, self.local_lo + self.local_size)

    def local_coords(self, global_idx: int) -> Tuple[int, int, int, int]:
        """A local rank's index into this process's box."""
        mlsl_assert(self.is_local(global_idx), "rank %d is held by process %d, not %d",
                    global_idx, self.owner(global_idx), self.proc_index)
        return tuple(c - o for c, o in zip(self.coords(global_idx), self.local_origin))

    def local_topology(self) -> "Topology":
        """The box as a world of its own: itself with one process."""
        if self.num_procs == 1:
            return self
        if self._local_topo is None:
            r, d, s, m = self.local_shape
            self._local_topo = Topology(d, m, self.local_size, seq_parts=s)
        return self._local_topo

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
        grid = self.local_shape
        if buf.dim() != NUM_GRID_AXES + 1 or tuple(buf.shape[:NUM_GRID_AXES]) == grid:
            return buf
        rows = 1
        for d in buf.shape[:NUM_GRID_AXES]:
            rows *= d
        if rows != self.local_size:
            return buf
        return buf.reshape(*grid, buf.shape[-1])


#: ProcessGroup -> its localized group (or None for a spanning one)
_LOCALIZED: dict = {}


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

    # -- the process layout (comm/transport.py) ------------------------------

    @property
    def spans(self) -> bool:
        """Some instance of the group has members in more than one process."""
        return self.localize() is None

    def localize(self) -> Optional["ProcessGroup"]:
        """The group over this process's box (``Topology.local_topology``)
        when every instance lies inside one process, else None. Members keep
        their order: an axis group's axes are whole in the box, a color
        group's members keep world-rank order. Itself with one process."""
        topo = self.topology
        if topo.num_procs == 1:
            return self
        cached = _LOCALIZED.get(self, False)
        if cached is not False:
            return cached
        out = None
        if self.colors is not None:
            owner: dict = {}
            if all(owner.setdefault(c, topo.owner(p)) == topo.owner(p)
                   for p, c in enumerate(self.colors)):
                lo = topo.local_lo
                out = ProcessGroup(topo.local_topology(), (),
                                   colors=tuple(self.colors[lo:lo + topo.local_size]))
        elif all(topo.local_shape[GRID_AXES.index(a)] == topo.axis_size(a)
                 for a in self.axes):
            out = ProcessGroup(topo.local_topology(), self.axes)
        _LOCALIZED[self] = out
        return out

    def process_partition(self) -> Tuple[Tuple[int, ...], ...]:
        """The processes that hold the same instances, one tuple each, in
        process order: the subgroups a spanning group's hops ride. An axis
        group: processes whose boxes cover the same complementary
        coordinates. A color group: the whole world, one subgroup."""
        topo = self.topology
        if self.colors is not None:
            return (tuple(range(topo.num_procs)),)
        gdims = {GRID_AXES.index(a) for a in self.axes}
        parts: dict = {}
        for j in range(topo.num_procs):
            origin, shape = process_box(topo.grid_shape, topo.num_procs, j)
            key = tuple((origin[i], shape[i]) for i in range(NUM_GRID_AXES) if i not in gdims)
            parts.setdefault(key, []).append(j)
        return tuple(sorted(tuple(v) for v in parts.values()))

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
