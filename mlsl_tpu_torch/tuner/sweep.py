"""The autotuner's sweep: candidate algorithms and knobs measured on the live world.

Counterpart of ``mlsl_tpu.tuner.sweep`` (sweep.py:1-400). The world is the
Environment's virtual ranks on one device, and the programs are the port's:

- **algorithm cells**: for every engine kind x payload size x group shape,
  each eligible algorithm (``algos.candidates``) is built and timed, best of
  ``iters`` calls after ``WARMUP`` calls on zero buffers, each call ended by
  ``torch.cuda.synchronize()`` on the card. Nothing is skipped: on the card
  every ``pallas*`` candidate is its CUDA kernel (B3, B5, B6); on a CPU
  tensor it is the kernel's plain version, which only the tests time.
- **knob derivation**, the JAX package's rules: the dispatch floor (a tiny
  allreduce's time) and the peak algbw of ``lax`` give
  ``msg_priority_threshold`` (the bytes one floor moves, 4 KiB to 16 MiB)
  and ``grad_bucket_mb`` (16 floors' bytes, 1 to 64 MiB);
  ``large_msg_size_mb`` / ``large_msg_chunks`` are set only where four
  quarter-slice dispatches of the largest swept allreduce beat the single
  one by 10 %, and the probe's two times are kept under ``_measured``
  whichever way it goes;
- ``MLSL_TUNE_QUANT=1`` (``quant=True``) adds the int8 ring's block cell
  (``quant_block_elems``, kernels B1 on every hop) and the quantized
  lowering cells: the composed ring (``lax``), B1 + the fused int8 ring B4
  (``pallas_ring``) and, on a tiered world, the two-tier wire (``hier``);
- the compiled overlap engine's staging depth (``overlap_stages``), timed on
  the staged multi-tensor reduce.

The world's shapes are the 1D ring over every rank and, where the world
factors, the (W/2, 2) grid. ``MLSL_TUNE_SIZES`` (KiB, comma separated) and
``MLSL_TUNE_ITERS`` override the sizes and the iterations. The sweep times
its programs beneath the chaos instrumentation (``_mlsl_inner``, the bypass
a precompile warm takes; sweep.py:60-79 and :218 of the JAX package): an
armed ``MLSL_CHAOS`` budget fires at the step it targets, and is not spent
inside the sweep's measurement calls.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import torch

from mlsl_tpu_torch.comm import collectives
from mlsl_tpu_torch.log import log_debug, log_info

#: payload sizes swept by default (bytes)
DEFAULT_SIZES = (16 * 1024, 256 * 1024, 2 * 1024 * 1024)
DEFAULT_ITERS = 5
WARMUP = 2

#: the int8 ring's block palette (elements) swept for the quant knob
QUANT_BLOCKS = (128, 256, 512)

#: staging depths swept for the compiled overlap knob
OVERLAP_STAGE_CANDIDATES = (1, 2, 4)


def _env_sizes() -> Optional[Tuple[int, ...]]:
    v = os.environ.get("MLSL_TUNE_SIZES")
    if not v:
        return None
    return tuple(int(float(s) * 1024) for s in v.split(",") if s.strip())


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _time_fn(fn, args, iters: int) -> float:
    """Best-of-``iters`` wall seconds of ``fn(*args)`` after ``WARMUP``
    calls, each call ended by a synchronize on the card (the minimum: the
    least noisy estimate of a deterministic program's time). Times the
    function beneath the chaos instrumentation."""
    fn = collectives.unwrap_chaos(fn)
    for _ in range(WARMUP):
        fn(*args)
        _sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _zeros(topo, elems: int, device) -> torch.Tensor:
    return torch.zeros((*topo.grid_shape, elems), dtype=torch.float32, device=device)


def _sweep_topologies(world_size: int) -> List[tuple]:
    """(topology, group, shape): the 1D ring over the world and the (W/2, 2)
    grid where the world factors."""
    from mlsl_tpu_torch.comm import algos
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    n = world_size
    out = []
    if n > 1:
        t1 = Topology(n, 1, n)
        g1 = ProcessGroup(t1, ("data",))
        out.append((t1, g1, algos.group_shape(g1)))
    if n >= 4 and n % 2 == 0:
        t2 = Topology(n // 2, 2, n)
        g2 = ProcessGroup(t2, ("data", "model"))
        out.append((t2, g2, algos.group_shape(g2)))
    return out


def run_sweep(world_size: int = 8, device=None, sizes: Optional[Sequence[int]] = None,
              iters: Optional[int] = None, quant: bool = False, config=None):
    """Measure and return a TunedProfile for ``world_size`` virtual ranks on
    ``device`` (default: the Environment's, else the card). Not saved: the
    caller owns the file. ``config`` supplies the ``pallas_a2a`` codec knobs
    (block, int8 on or off); None takes their defaults."""
    from mlsl_tpu_torch import sysinfo
    from mlsl_tpu_torch.comm import algos
    from mlsl_tpu_torch.core.environment import default_device
    from mlsl_tpu_torch.tuner.profile import TunedProfile
    from mlsl_tpu_torch.types import ReductionType

    device = torch.device(device) if device is not None else default_device()
    sizes = tuple(sizes) if sizes is not None else (_env_sizes() or DEFAULT_SIZES)
    iters = int(iters if iters is not None else os.environ.get("MLSL_TUNE_ITERS", DEFAULT_ITERS))
    a2a_kw = dict(block=int(getattr(config, "quant_block_elems", 256)),
                  quantized=bool(getattr(config, "pallas_a2a_quant", True)))
    t_start = time.perf_counter()

    cells: List[dict] = []
    floor_s = None
    algbw = 0.0
    largest: dict = {}

    for topo, group, shape in _sweep_topologies(world_size):
        g = group.size
        if floor_s is None:
            # the dispatch floor: one tiny allreduce on the first (1D) shape
            fn = algos.build("allreduce", group, "lax", op=ReductionType.SUM)
            floor_s = _time_fn(fn, (_zeros(topo, 256, device),), iters)

        for kind in algos.ENGINE_KINDS:
            for size_b in sorted(sizes):
                # elements padded so that a reduce_scatter count divides the group
                elems = max(-(-(size_b // 4) // g) * g, g)
                if kind == "alltoall":
                    kw = dict(send_count=elems // g)
                    cand_op = None
                else:
                    kw = dict(op=ReductionType.SUM)
                    if kind == "reduce_scatter":
                        kw["recv_count"] = elems // g
                    cand_op = ReductionType.SUM
                args = (_zeros(topo, elems, device),)
                measured = {}
                for algo in algos.candidates(kind, group, cand_op):
                    extra = a2a_kw if algo == "pallas_a2a" else {}
                    fn = algos.build(kind, group, algo, **kw, **extra)
                    measured[algo] = _time_fn(fn, args, iters)
                best = min(measured, key=measured.get)
                payload = elems * 4
                cells.append({
                    "kind": kind,
                    "shape": list(shape),
                    "compression": "none",
                    "payload_bytes": payload,     # what was measured
                    "max_bytes": payload * 2,     # the band the cell covers
                    "algo": best,
                    "us": {a: round(s * 1e6, 2) for a, s in measured.items()},
                })
                log_debug("tune: %s shape=%s %dB -> %s (%s)", kind, shape, payload, best,
                          cells[-1]["us"])
                if kind == "allreduce":
                    algbw = max(algbw, payload / measured["lax"])
                    if payload > largest.get("bytes", 0):
                        largest = {"bytes": payload, "group": group, "topo": topo}
                del args

        # the top band is open: the largest size's winner covers larger
        # payloads (bandwidth-bound behaviour extrapolates)
        for kind in algos.ENGINE_KINDS:
            tops = [c for c in cells if c["kind"] == kind and c["shape"] == list(shape)]
            if tops:
                tops[-1]["max_bytes"] = None

    knobs: dict = {}
    if floor_s and algbw > 0:
        mib = 1024 * 1024
        knobs["msg_priority_threshold"] = int(min(max(floor_s * algbw, 4096), 16 * mib))
        knobs["grad_bucket_mb"] = int(min(max(round(16 * floor_s * algbw / mib), 1), 64))
        if largest:
            # the chunk probe: four quarter-slice dispatches against one
            grp, topo = largest["group"], largest["topo"]
            elems = largest["bytes"] // 4
            fn = collectives.unwrap_chaos(algos.build("allreduce", grp, "lax",
                                                      op=ReductionType.SUM))
            full = _zeros(topo, elems, device)
            single = _time_fn(fn, (full,), iters)
            q = elems // 4

            def chunked():
                return [fn(full[..., i * q:(i + 1) * q]) for i in range(4)]

            t_chunk = _time_fn(chunked, (), iters)
            if t_chunk < single * 0.9:
                knobs["large_msg_size_mb"] = max(largest["bytes"] // (2 * mib), 1)
                knobs["large_msg_chunks"] = 4
            knobs["_measured"] = {
                "dispatch_floor_us": round(floor_s * 1e6, 2),
                "algbw_gbps": round(algbw / 1e9, 4),
                "large_single_us": round(single * 1e6, 2),
                "large_chunked_us": round(t_chunk * 1e6, 2),
            }
            del full

    if quant:
        knobs.update(_sweep_quant_block(world_size, device, iters))
        # the lowering cells at the block this sweep just picked
        cells.extend(_sweep_quant_lowering(world_size, device, iters,
                                           block=int(knobs.get("quant_block_elems", 256))))
    knobs.update(_sweep_overlap_stages(world_size, device, iters))

    prof = TunedProfile(
        fingerprint=sysinfo.topology_fingerprint(world_size, device),
        cells=cells,
        knobs=knobs,
        created=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    )
    log_info("tuner sweep: %d cells, %d knobs in %.1fs", len(cells),
             len([k for k in knobs if not k.startswith("_")]), time.perf_counter() - t_start)
    return prof


def _sweep_overlap_stages(world_size: int, device, iters: int) -> dict:
    """The compiled overlap engine's staging depth: the staged multi-tensor
    reduce of a 12-tensor backward-shaped stream on the 1D ring, timed at
    each depth; the fastest wins."""
    from mlsl_tpu_torch.comm import overlap
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    n = world_size
    if n <= 1:
        return {}
    topo = Topology(n, 1, n)
    group = ProcessGroup(topo, ("data",))
    counts = [16 * 1024] * 12
    bufs = [_zeros(topo, c, device) for c in counts]
    measured = {}
    for stages in OVERLAP_STAGE_CANDIDATES:
        fn, _ = overlap.build_multi_reduce(group, counts, stages=stages)
        measured[stages] = _time_fn(lambda: fn(bufs), (), iters)
    best = min(measured, key=measured.get)
    return {"overlap_stages": int(best),
            "_overlap_measured": {str(s): round(t * 1e6, 2) for s, t in measured.items()}}


def _sweep_quant_lowering(world_size: int, device, iters: int, block: int = 256) -> list:
    """The quantized allreduce's lowering cells on the 1D ring, one a size:
    the composed int8 ring (``lax``), the fused int8 ring (``pallas_ring``,
    B1 + B4) where it serves the block, and the two-tier wire (``hier``) on
    a tiered world. One tier's timing on one card carries no DCN: the hier
    cell measures the two-tier schedule's own cost."""
    from mlsl_tpu_torch.comm import algos, quant_ring
    from mlsl_tpu_torch.comm.algos import hier
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
    from mlsl_tpu_torch.ops import ring_kernels as rk

    n = world_size
    if n <= 1:
        return []
    topo = Topology(n, 1, n)
    group = ProcessGroup(topo, ("data",))
    rings = [("lax", "lax")]
    if rk.eligible_quant(group, block):
        rings.append(("pallas", "pallas_ring"))
    if hier.eligible_quant(group, block):
        rings.append(("hier", "hier"))
    if len(rings) == 1:
        return []
    shape = list(algos.group_shape(group))
    cells = []
    for size_b in sorted(_env_sizes() or DEFAULT_SIZES):
        elems = max(-(-(size_b // 4) // n) * n, n)
        buf = _zeros(topo, elems, device)
        measured = {}
        for ring, name in rings:
            fn, err_len = quant_ring.build_quantized_collective("allreduce", group, elems,
                                                                block, ring=ring)
            measured[name] = _time_fn(fn, (buf, _zeros(topo, err_len, device)), iters)
        best = min(measured, key=measured.get)
        payload = elems * 4
        cells.append({
            "kind": "allreduce",
            "shape": shape,
            "compression": "quantization",
            "payload_bytes": payload,
            "max_bytes": payload * 2,
            "algo": best,
            "us": {a: round(s * 1e6, 2) for a, s in measured.items()},
        })
        log_debug("tune: quant allreduce %dB -> %s (%s)", payload, best, cells[-1]["us"])
        del buf
    if cells:
        cells[-1]["max_bytes"] = None
    return cells


def _sweep_quant_block(world_size: int, device, iters: int) -> dict:
    """The int8 ring's block: the fastest of the palette at a 256 KiB
    payload on the 1D ring (the composed ring, B1 on every hop)."""
    from mlsl_tpu_torch.comm import quant_ring
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    n = world_size
    if n <= 1:
        return {}
    topo = Topology(n, 1, n)
    group = ProcessGroup(topo, ("data",))
    elems = max(256 * 1024 // 4, n) // n * n
    measured = {}
    for block in QUANT_BLOCKS:
        fn, err_len = quant_ring.build_quantized_collective("allreduce", group, elems, block)
        measured[block] = _time_fn(fn, (_zeros(topo, elems, device),
                                        _zeros(topo, err_len, device)), iters)
    best = min(measured, key=measured.get)
    return {"quant_block_elems": int(best),
            "_quant_measured": {str(b): round(s * 1e6, 2) for b, s in measured.items()}}
