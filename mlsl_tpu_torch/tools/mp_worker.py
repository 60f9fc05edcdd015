"""One process of a multi-process world: the JAX package's two multi-process
worker scripts (``tests/test_multiprocess.py``, ``tests/test_multiprocess_e2e.py``)
on the port, with its own MLP.

    python3 -m mlsl_tpu_torch.tools.mp_worker --pid I --nproc P --port PORT \\
        --device cpu --out DIR [--params params.npz]

Start P of them, one a process id, with the same free port; each holds 8 / P
of the world's 8 virtual ranks (comm/mesh.py). Without ``--port`` (and with
``--pid 0 --nproc 1``) the worker is the one-process twin, with no
coordinator. Phases, in order:

- ``basic``: a data-group allreduce (36 on every rank), a (2, 4) grid's
  model-group allgather, a global barrier, ``dcn_aware_devices`` and its
  data-group allreduce;
- ``hierarchy``: on a (4, 2) grid each model group inside one process and
  each gradient group across min(P, its size) processes;
- ``gather``: ``gather_to_host`` over the model groups, every instance on
  every process;
- ``loop``: the reference loop's phases (mlsl_test.cpp:660-698) on the
  (4, 2) grid, two iterations: FPROP reduce_scatter, BPROP allgather and
  the gradient allreduce, each against its closed form on this process's
  ranks;
- ``matrix``: model parts 1, 2 and 8 x the distributed update off and on,
  two rounds of gradient requests in backward order;
- ``kinds``: every collective kind over a (2, 4) and a (4, 2) grid's groups
  and over color groups, for the caller to hold against one process;
- ``train``: a DataParallelTrainer step of the MLP on an (8, 1) world fed by
  ``shard_batch``, and a twin fed by ``shard_batch_local``;
- ``wires``: every compressed wire (``WIRE_CASES``: the int8 error-feedback
  ring and its entry-quantization-and-sum body, top-k in both formats, the
  registry codecs prune and vq, a user codec of callables) over the grids'
  groups, ``WIRE_ROUNDS`` rounds with the residual carried, each rank's
  result and residual kept;
- ``exchanges``: alltoall, bcast and sendrecv over every group of three
  grids, the direct form (the request's) against the assembled one on the
  same buffer, bit for bit, with the bytes each handed the backend;
- ``train_int8``: the MLP's DataParallelTrainer on the int8 ring, two steps;
- ``guard``: the sentinel's gate over a guarded codec request, with the
  loss outliers on rank 0 alone: the step of the demotion, which every
  process must take at the same round.

``graph``, ``resnet`` and ``resnet_int8`` (config 5 on config 4's int8 ring
in ``RESNET_BUCKET_MB`` buckets) are the card's run (ad). Each closed form is
checked on the ranks this process holds (within 1e-6 relative for float
sums, exactly otherwise). The results are written to
``DIR/proc<I>.npz`` (keys ``phase/name/rank``) for a caller to hold against a
single-process run, and the process prints ``proc I OK csum=<sum of the
trained parameters>`` at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

MB = 8
FM1, FM2 = 16, 8
FM_SIZE = 4
WORLD = 8
TRAIN_B = 16
#: config 3's gradient buckets (PyTorch DDP's default bucket_cap_mb)
RESNET_BUCKET_MB = 25

#: the compressed wires of phase ``wires``: (name, grid (data, model), the
#: group's axes, wire, kind, count a rank). Wires: ``int8`` (the request's
#: int8 ring, or its sum body on a multi-axis group), ``topk`` (the request's
#: sparse wire, the all-gather format below 16 members), ``topk_ring`` (the
#: sparse ring format, built directly), ``prune`` / ``vq`` (registry codecs
#: pinned by the descriptor), ``f16`` / ``f16_reduce`` (a user codec of
#: callables, without and with a compressed-domain reduce)
WIRE_CASES = (
    ("g8_int8_ar", (8, 1), ("data",), "int8", "allreduce", 1000),
    ("g8_int8_ar_multiblock", (8, 1), ("data",), "int8", "allreduce", 8 * 3 * 256 + 5),
    ("g8_int8_rs", (8, 1), ("data",), "int8", "reduce_scatter", 8 * 300),
    ("g4_int8_ar", (4, 2), ("data",), "int8", "allreduce", 777),
    ("m4_int8_ar", (2, 4), ("model",), "int8", "allreduce", 513),
    ("multi_int8_ar", (4, 2), ("data", "model"), "int8", "allreduce", 999),
    ("multi_int8_rs", (4, 2), ("data", "model"), "int8", "reduce_scatter", 8 * 100),
    ("g8_topk_ar", (8, 1), ("data",), "topk", "allreduce", 1024),
    ("g8_topk_rs", (8, 1), ("data",), "topk", "reduce_scatter", 1024),
    ("g8_topk_ring_ar", (8, 1), ("data",), "topk_ring", "allreduce", 1024),
    ("g4_topk_ring_rs", (4, 2), ("data",), "topk_ring", "reduce_scatter", 1024),
    ("g8_prune_ar", (8, 1), ("data",), "prune", "allreduce", 768),
    ("g8_vq_ar", (8, 1), ("data",), "vq", "allreduce", 768),
    ("g4_prune_rs", (4, 2), ("data",), "prune", "reduce_scatter", 768),
    ("g8_f16_ar", (8, 1), ("data",), "f16", "allreduce", 1024),
    ("g8_f16r_rs", (8, 1), ("data",), "f16_reduce", "reduce_scatter", 2048),
)
WIRE_ROUNDS = 3
TOPK_RATIO = 0.05
PRUNE_RATIO = 0.25
#: phase ``wires`` at a size: config 4's int8 allreduce and reduce_scatter
#: over the 8-rank data group, top-k at config 4's ratio in both formats, and
#: the prune codec; rows made on the device, kept as digests and samples
BIG_WIRE_CASES = (
    ("g8_int8_ar", (8, 1), ("data",), "int8", "allreduce"),
    ("g8_int8_rs", (8, 1), ("data",), "int8", "reduce_scatter"),
    ("g8_topk_ar", (8, 1), ("data",), "topk", "allreduce"),
    ("g8_topk_ring_ar", (8, 1), ("data",), "topk_ring", "allreduce"),
    ("g8_prune_ar", (8, 1), ("data",), "prune", "allreduce"),
)
BIG_TOPK_RATIO = 0.01
SAMPLE_STRIDE = 4099


def rank_fill(p: int, n: int) -> np.ndarray:
    return (p * 1000.0 + np.arange(n, dtype=np.float64)).astype(np.float32)


def kind_requests(dist, g: int, n: int, T):
    """(tag, start) of every collective kind over a group of ``g`` members,
    ``n`` elements a rank, through the Distribution API of either package
    (``T``: its types module). -> [(tag, fn(buf) -> request)]."""
    F, S = T.DataType.FLOAT, T.ReductionType
    out = []
    for gt_name in ("DATA", "MODEL"):
        gt = getattr(T.GroupType, gt_name)
        gsz = dist.get_process_count(gt)
        if gsz != g:
            continue
        rc = n // g
        out += [
            (f"{gt_name}/allreduce_sum", lambda b, gt=gt: dist.all_reduce(b, n, F, S.SUM, gt)),
            (f"{gt_name}/allreduce_min", lambda b, gt=gt: dist.all_reduce(b, n, F, S.MIN, gt)),
            (f"{gt_name}/allreduce_max", lambda b, gt=gt: dist.all_reduce(b, n, F, S.MAX, gt)),
            (f"{gt_name}/reduce", lambda b, gt=gt: dist.reduce(b, n, F, S.SUM, 1, gt)),
            (f"{gt_name}/bcast", lambda b, gt=gt: dist.bcast(b, n, F, 1, gt)),
            (f"{gt_name}/allgather", lambda b, gt=gt: dist.all_gather(b, n, F, gt)),
            (f"{gt_name}/gather", lambda b, gt=gt: dist.gather(b, n, F, 0, gt)),
            (f"{gt_name}/reduce_scatter",
             lambda b, gt=gt: dist.reduce_scatter(b, rc, F, S.SUM, gt)),
            (f"{gt_name}/scatter", lambda b, gt=gt: dist.scatter(b, rc, F, 1, gt)),
            (f"{gt_name}/alltoall", lambda b, gt=gt: dist.all_to_all(b, rc, F, gt)),
            (f"{gt_name}/allgatherv",
             lambda b, gt=gt: dist.all_gatherv(b, n, [1 + i for i in range(g)], F, gt)),
            (f"{gt_name}/sendrecv", lambda b, gt=gt: dist.send_recv_list(
                b, n, F, [(i, (i + 1) % g) for i in range(g)], gt)),
            (f"{gt_name}/alltoallv", lambda b, gt=gt: dist.all_to_allv(
                b, [[1 + (i + j) % 2 for j in range(g)] for i in range(g)], None, None,
                None, F, gt)),
        ]
    return out


def wire_vals(name: str, r: int, n: int) -> dict:
    """Round ``r``'s rows of a wire case, {rank: (n,) float32}: normal rows
    of ranks' own scales, shifted by the round, a signed zero every 37th
    element (a sign flip shows in the bits)."""
    rng = np.random.default_rng([sum(map(ord, name)), r])
    x = rng.normal(size=(WORLD, n)) * rng.uniform(0.1, 10.0, size=(WORLD, 1)) + r
    x = x.astype(np.float32)
    x[:, ::37] = -0.0
    return {p: x[p] for p in range(WORLD)}


def run_wires(kit, env, save, cases=WIRE_CASES, rounds=WIRE_ROUNDS, fill=None,
              topk_ratio=TOPK_RATIO) -> None:
    """The wire cases through either package's front doors (``kit``: its
    ``types``, ``CommDesc``, ``CommRequest``, ``ProcessGroup``, ``sparse``,
    ``QuantParams``, ``custom(wire)`` -> the user codec's QuantParams
    keywords, and ``err(req)`` -> a request's residual), each round's
    result and residual handed to ``save(key, dist, buf)``. ``fill(name,
    r, n, dist)`` makes round r's buffer (None: ``wire_vals``'s rows)."""
    T = kit.types
    if fill is None:
        def fill(name, r, n, dist):
            vals = wire_vals(name, r, n)
            return dist.make_buffer(lambda p: vals[p], n)
    for name, shape, axes, wire, kind, n in cases:
        dist = env.create_distribution(*shape)
        group = kit.ProcessGroup(dist.topology, axes)
        g = group.size
        rc = n // g if kind == "reduce_scatter" else None
        if wire == "topk_ring":
            fn, el = kit.sparse.build_sparse_collective(kind, group, n, topk_ratio,
                                                        use_ring=True)
            err = dist.make_buffer(lambda p: np.zeros(el, np.float32), el)
            for r in range(rounds):
                res, err = fn(fill(name, r, n, dist), err)
                save(f"wires/{name}/{r}/res", dist, res)
                save(f"wires/{name}/{r}/err", dist, err)
            continue
        if wire.startswith("f16"):
            env.set_quantization_params(kit.QuantParams(**kit.custom(wire)))
        env.config.topk_ratio, env.config.prune_ratio = topk_ratio, PRUNE_RATIO
        try:
            comp = (T.CompressionType.TOPK if wire == "topk"
                    else T.CompressionType.QUANTIZATION)
            req = kit.CommRequest(kit.CommDesc(
                kind, group, n, T.DataType.FLOAT, op=T.ReductionType.SUM, recv_count=rc,
                compression=comp, codec=wire if wire in ("prune", "vq") else ""),
                env.dispatcher, name=name)
            req.setup()
            for r in range(rounds):
                req.start(fill(name, r, n, dist))
                save(f"wires/{name}/{r}/res", dist, req.wait())
                save(f"wires/{name}/{r}/err", dist, kit.err(req))
        finally:
            if wire.startswith("f16"):
                env.set_quantization_params(kit.QuantParams())


def exchange_fill(p: int, n: int) -> np.ndarray:
    """Rank p's row for phase ``exchanges``: distinct values, a signed zero
    and a NaN (moves carry every bit)."""
    x = rank_fill(p, n) - 3500.5
    x[3] = -0.0
    x[5] = np.nan
    return x


def exchange_requests(dist, g: int, n: int, T):
    """(tag, kind, build keywords, start) of the direct exchanges over a
    group of ``g`` members through either package's Distribution API."""
    out = []
    F = T.DataType.FLOAT
    for gt_name in ("DATA", "MODEL"):
        gt = getattr(T.GroupType, gt_name)
        if dist.get_process_count(gt) != g:
            continue
        ring = tuple((i, (i + 1) % g) for i in range(g))
        few = ((g - 1, 0), (0, g // 2))
        out += [
            (f"{gt_name}/alltoall", "alltoall", {"send_count": n // g},
             lambda b, gt=gt: dist.all_to_all(b, n // g, F, gt)),
            (f"{gt_name}/bcast", "bcast", {"root": g - 1},
             lambda b, gt=gt: dist.bcast(b, n, F, g - 1, gt)),
            (f"{gt_name}/sendrecv_ring", "sendrecv", {"pairs": ring},
             lambda b, gt=gt: dist.send_recv_list(b, n, F, list(ring), gt)),
            (f"{gt_name}/sendrecv_few", "sendrecv", {"pairs": few},
             lambda b, gt=gt: dist.send_recv_list(b, n, F, list(few), gt)),
        ]
    return out


class Worker:
    def __init__(self, env, out: dict, log=print):
        self.env = env
        self.out = out
        self.log = log
        self.pid = env.process_index()
        self.nproc = env.process_count()
        self.own = WORLD // self.nproc
        self.report: dict = {}

    def save(self, key: str, dist, buf) -> None:
        for p in dist.topology.local_ranks():
            self.out[f"{key}/{p}"] = dist.local_part(buf, p)

    def check(self, dist, buf, p, want, rtol=1e-6) -> int:
        got = dist.local_part(buf, p)
        if got is None:
            return 0
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol)
        return 1

    # -- test_multiprocess.py's worker ------------------------------------------

    def basic(self) -> None:
        from mlsl_tpu_torch.comm.mesh import dcn_aware_devices
        from mlsl_tpu_torch.types import DataType, GroupType, ReductionType

        env = self.env
        dist = env.create_distribution(WORLD, 1)
        buf = dist.make_buffer(lambda p: np.full(16, float(p + 1), np.float32), 16)
        out = env.wait(dist.all_reduce(buf, 16, DataType.FLOAT, ReductionType.SUM,
                                       GroupType.DATA))
        n = sum(self.check(dist, out, p, np.full(16, 36.0)) for p in range(WORLD))
        assert n == self.own, n
        self.save("basic/allreduce", dist, out)
        grid = env.create_distribution(2, 4)
        gbuf = grid.make_buffer(lambda p: np.full(4, float(p), np.float32), 4)
        gout = env.wait(grid.all_gather(gbuf, 4, DataType.FLOAT, GroupType.MODEL))
        for p in range(WORLD):
            base = (p // 4) * 4
            self.check(grid, gout, p, np.repeat(np.arange(base, base + 4, dtype=np.float64), 4))
        self.save("basic/allgather", grid, gout)
        dist.barrier(GroupType.GLOBAL)
        ranks = dcn_aware_devices(4)
        dcn = env.create_distribution(2, 4)
        for p in range(WORLD):
            members = [q for q in ranks
                       if dcn.topology.coords(q)[:3] == dcn.topology.coords(p)[:3]]
            assert len({dcn.topology.owner(q) for q in members}) == 1, (p, members)
        dbuf = dcn.make_buffer(lambda p: np.full(4, float(p + 1), np.float32), 4)
        dout = env.wait(dcn.all_reduce(dbuf, 4, DataType.FLOAT, ReductionType.SUM,
                                       GroupType.DATA))
        for p in range(WORLD):
            m = p % 4
            self.check(dcn, dout, p, np.full(4, float(m + 1 + m + 5)))
        self.save("basic/dcn_allreduce", dcn, dout)
        self.log(f"proc {self.pid} basic OK")

    # -- test_multiprocess_e2e.py's worker ---------------------------------------

    def build_net(self, dist, distributed_update=False, fm1=FM1, fm2=FM2, fm_size=FM_SIZE,
                  mb=MB):
        from mlsl_tpu_torch.types import OpType

        s = self.env.create_session()
        s.set_global_minibatch_size(mb)
        r1 = s.create_operation_reg_info(OpType.CC)
        r1.add_input(fm1, fm_size)
        r1.add_output(fm2, fm_size)
        r1.add_parameter_set(fm1 * fm2, 1, distributed_update=distributed_update)
        op1 = s.get_operation(s.add_operation(r1, dist))
        r2 = s.create_operation_reg_info(OpType.CC)
        r2.add_input(fm2, fm_size)
        r2.add_output(fm1, fm_size)
        r2.add_parameter_set(fm2 * fm1, 1, distributed_update=distributed_update)
        op2 = s.get_operation(s.add_operation(r2, dist))
        op1.set_next(op2, 0, 0)
        s.commit()
        return s, op1, op2

    @staticmethod
    def model_members(dist, p):
        g = dist.model_group
        ms = [q for q in range(WORLD)
              if dist.topology.coords(q)[:3] == dist.topology.coords(p)[:3]]
        return g, sorted(ms, key=g.group_idx_of)

    @staticmethod
    def grad_members(dist, p):
        g = dist.grad_group
        c = dist.topology.coords(p)
        ms = [q for q in range(WORLD) if dist.topology.coords(q)[0] == c[0]
              and dist.topology.coords(q)[3] == c[3]]
        return g, sorted(ms, key=g.group_idx_of)

    def hierarchy(self, model_parts=2) -> None:
        dist = self.env.create_distribution(WORLD // model_parts, model_parts)
        topo = dist.topology
        for p in range(WORLD):
            _, members = self.model_members(dist, p)
            mprocs = {topo.owner(q) for q in members}
            if self.own >= model_parts:
                assert len(mprocs) == 1, f"model group of {p} crosses processes: {mprocs}"
            _, gmembers = self.grad_members(dist, p)
            gprocs = {topo.owner(q) for q in gmembers}
            want = min(self.nproc, len(gmembers))
            assert len(gprocs) == want, f"grad group of {p} spans {gprocs}, want {want}"
        self.log(f"proc {self.pid} hierarchy OK")

    def gather(self, model_parts=2) -> None:
        from mlsl_tpu_torch.types import DataType, GroupType

        dist = self.env.create_distribution(WORLD // model_parts, model_parts)
        buf = dist.make_buffer(lambda p: rank_fill(p, 8), 8)
        gh = dist.gather_to_host(buf, 8, DataType.FLOAT, 1, GroupType.MODEL)
        for p in range(0, WORLD, model_parts):
            _, ms = self.model_members(dist, p)
            want = np.concatenate([rank_fill(q, 8) for q in ms])
            np.testing.assert_array_equal(gh[ms[1]], want)
            self.out[f"gather/{ms[1]}"] = gh[ms[1]]
        assert len(gh) == WORLD // model_parts
        self.log(f"proc {self.pid} gather_to_host OK")

    def loop(self, model_parts=2) -> None:
        from mlsl_tpu_torch.core.activation import pack_local

        dist = self.env.create_distribution(WORLD // model_parts, model_parts)
        s, op1, op2 = self.build_net(dist)
        out_act, in_act = op1.get_output(0), op2.get_input(0)
        ps1 = op1.get_parameter_set(0)
        local_mb = op1.get_local_minibatch_size()
        n_wire = local_mb * out_act.local_fm_count * FM_SIZE
        checked = [0, 0, 0]
        for it in range(2):
            acts = {p: (it + 1.0) * rank_fill(p, n_wire) for p in range(WORLD)}
            wires = {p: np.asarray(pack_local(
                acts[p].reshape(local_mb, out_act.local_fm_count, FM_SIZE),
                out_act.pack_blocks, local_mb, out_act.local_fm_count, FM_SIZE))
                for p in range(WORLD)}
            out_act.start_comm(dist.make_buffer(lambda p: wires[p], n_wire))
            received = in_act.wait_comm()
            rc = n_wire // model_parts
            for p in range(WORLD):
                g, members = self.model_members(dist, p)
                summed = sum(np.asarray(wires[q], np.float64) for q in members)
                my = g.group_idx_of(p)
                checked[0] += self.check(dist, received, p, summed[my * rc:(my + 1) * rc])
            self.save(f"loop{it}/fprop", dist, received)
            n_bwd = local_mb * in_act.local_fm_count * in_act.fm_size
            grads_a = {p: (it + 2.0) * rank_fill(p, n_bwd) for p in range(WORLD)}
            in_act.start_comm(dist.make_buffer(lambda p: grads_a[p], n_bwd))
            bwd = out_act.wait_comm()
            for p in range(WORLD):
                _, members = self.model_members(dist, p)
                want = np.concatenate([grads_a[q] for q in members]).astype(np.float64)
                checked[1] += self.check(dist, bwd, p, want, rtol=0)
            self.save(f"loop{it}/bprop", dist, bwd)
            n_k = ps1.get_local_kernel_count() * ps1.get_kernel_size()
            grads_w = {p: (it + 3.0) * rank_fill(p, n_k) for p in range(WORLD)}
            ps1.start_gradient_comm(dist.make_buffer(lambda p: grads_w[p], n_k))
            reduced = ps1.wait_gradient_comm()
            for p in range(WORLD):
                _, members = self.grad_members(dist, p)
                want = sum(np.asarray(grads_w[q], np.float64) for q in members)
                checked[2] += self.check(dist, reduced, p, want)
            self.save(f"loop{it}/grad", dist, reduced)
        assert checked == [2 * self.own] * 3, checked
        self.log(f"proc {self.pid} phase loop OK")

    def matrix(self) -> None:
        for mp in (1, 2, 8):
            for du in (False, True):
                dmx = self.env.create_distribution(WORLD // mp, mp)
                _, o1, o2 = self.build_net(dmx, distributed_update=du)
                for mb in range(2):
                    for name, op in (("o2", o2), ("o1", o1)):   # backward order
                        ps = op.get_parameter_set(0)
                        n = ps.get_local_kernel_count() * ps.get_kernel_size()
                        scale = 1.0 + 0.1 * mb
                        grads = {p: scale * rank_fill(p, n) for p in range(WORLD)}
                        ps.start_gradient_comm(dmx.make_buffer(lambda p: grads[p], n))
                        out = ps.wait_gradient_comm()
                        if WORLD // mp == 1:
                            assert out is None
                            continue
                        nchecked = 0
                        for p in range(WORLD):
                            g, members = self.grad_members(dmx, p)
                            full = sum(np.asarray(grads[q], np.float64) for q in members)
                            if du:
                                my = g.group_idx_of(p)
                                owned = ps.get_owned_kernel_count() * ps.get_kernel_size()
                                full = full[my * owned:(my + 1) * owned]
                            nchecked += self.check(dmx, out, p, full)
                        assert nchecked == self.own, nchecked
                        self.save(f"matrix/mp{mp}_du{int(du)}_mb{mb}_{name}", dmx, out)
                self.log(f"proc {self.pid} matrix mp={mp} du={du} OK")

    def kinds(self) -> None:
        """Every collective kind over the model and data groups of a (2, 4)
        grid (model groups span processes with more than 2 of them) and over
        the color groups p % 2 (which span every process), checked against
        the single-process run by the caller."""
        from mlsl_tpu_torch import types as T

        n = 16
        for shape in ((2, 4), (4, 2)):
            dist = self.env.create_distribution(*shape)
            for g in sorted(set(shape)):
                for tag, start in kind_requests(dist, g, n, T):
                    buf = dist.make_buffer(lambda p: rank_fill(p, n) - 3500.0, n)
                    self.save(f"kinds/{shape[0]}x{shape[1]}/{tag}", dist,
                              self.env.wait(start(buf)))
        colors = self.env.create_distribution_with_colors(
            [p % 2 for p in range(WORLD)], [p // 2 for p in range(WORLD)])
        for tag, start in kind_requests(colors, 4, n, T):
            buf = colors.make_buffer(lambda p: rank_fill(p, n) - 3500.0, n)
            self.save(f"kinds/colors/{tag}", colors, self.env.wait(start(buf)))
        self.log(f"proc {self.pid} kinds OK")

    def sample(self, key: str, dist, buf, stride: int) -> None:
        """Every ``stride``-th element of each local rank's row."""
        for p in dist.topology.local_ranks():
            self.out[f"{key}/{p}"] = dist.local_part(buf, p)[::stride].copy()

    def graph(self, fm1: int, fm2: int, tokens: int, iters: int = 2, stride: int = 97) -> None:
        """Run (m)'s model-parallel graph on a (4, 2) grid: two CC ops FM1 ->
        FM2 -> FM1 (fm_size 1) over ``tokens`` tokens, ``iters`` rounds of
        FPROP (the model group's reduce_scatter), BPROP (its allgather), the
        gradient allreduce over the data group, and an alltoall over the
        model group. Integer-valued float payloads, so every sum is exact in
        any order: each round equals its closed form on this process's
        ranks bit for bit. Rows are kept every ``stride``-th element."""
        import torch

        from mlsl_tpu_torch.types import DataType, GroupType

        env = self.env
        dist = env.create_distribution(4, 2)
        _, op1, op2 = self.build_net(dist, fm1=fm1, fm2=fm2, fm_size=1, mb=tokens)
        out_act, in_act = op1.get_output(0), op2.get_input(0)
        ps1 = op1.get_parameter_set(0)
        n_wire = op1.get_local_minibatch_size() * out_act.local_fm_count
        n_bwd = op1.get_local_minibatch_size() * in_act.local_fm_count
        n_k = ps1.get_local_kernel_count() * ps1.get_kernel_size()
        topo, dev = dist.topology, env.device

        def pattern(n, salt):
            # rank p's row: ((p * 7 + i + salt) % 61) - 30, built on the device
            ranks = torch.tensor(list(topo.local_ranks()), device=dev).view(-1, 1)
            i = torch.arange(n, device=dev).view(1, -1)
            return (((ranks * 7 + i + salt) % 61) - 30).float().reshape(*dist.world_shape, n)

        for it in range(iters):
            wire = pattern(n_wire, it)
            out_act.start_comm(wire)
            fprop = in_act.wait_comm()
            grads_a = pattern(n_bwd, 100 + it)
            in_act.start_comm(grads_a)
            bprop = out_act.wait_comm()
            gw = pattern(n_k, 200 + it)
            ps1.start_gradient_comm(gw)
            grad = ps1.wait_gradient_comm()
            a2a = env.wait(dist.all_to_all(pattern(n_wire, 300 + it), n_wire // 2,
                                           DataType.FLOAT, GroupType.MODEL))
            for p in topo.local_ranks():
                self._graph_closed_forms(dist, p, it, n_wire, n_bwd, n_k,
                                         (fprop, bprop, grad, a2a))
            for tag, buf in (("fprop", fprop), ("bprop", bprop), ("grad", grad),
                             ("a2a", a2a)):
                self.sample(f"graph{it}/{tag}", dist, buf, stride)
        self.log(f"proc {self.pid} graph OK")

    @staticmethod
    def _graph_closed_forms(dist, p, it, n_wire, n_bwd, n_k, outs) -> None:
        """Each output row of rank ``p`` against its closed form, on the
        device, bit for bit."""
        import torch

        dev = outs[0].device

        def row(q, n, salt):
            i = torch.arange(n, device=dev)
            return (((q * 7 + i + salt) % 61) - 30).float()

        c = dist.topology.local_coords(p)
        fprop, bprop, grad, a2a = (o[c] for o in outs)
        _, ms = Worker.model_members(dist, p)
        my = dist.model_group.group_idx_of(p)
        rc = n_wire // 2
        want = sum(row(q, n_wire, it) for q in ms)[my * rc:(my + 1) * rc]
        assert torch.equal(fprop, want), f"graph FPROP of rank {p}"
        assert torch.equal(bprop, torch.cat([row(q, n_bwd, 100 + it) for q in ms])), \
            f"graph BPROP of rank {p}"
        _, gs = Worker.grad_members(dist, p)
        assert torch.equal(grad, sum(row(q, n_k, 200 + it) for q in gs)), \
            f"graph gradient of rank {p}"
        want = torch.cat([row(q, n_wire, 300 + it)[my * rc:(my + 1) * rc] for q in ms])
        assert torch.equal(a2a, want), f"graph alltoall of rank {p}"

    def resnet(self, image: int, classes: int, batch: int, steps: int = 2,
               stride: int = 101, int8: bool = False) -> dict:
        """Config 5: ResNet-50 data-parallel on an (8, 1) world (SGD, lr
        0.05), replicated and ZeRO-1, ``steps`` steps each from the same
        weights (seed 0); ``int8``: on config 4's int8 ring with the layer
        requests in ``RESNET_BUCKET_MB`` buckets. Kept: the first step's
        losses, its local gradients (the reduction's input) and every
        reduced gradient (each layer's, or each bucket's, rank rows, every
        ``stride``-th element), and the sum of the parameters after the last
        step. -> {mode: csum}."""
        import torch

        from mlsl_tpu_torch.comm import transport
        from mlsl_tpu_torch.models import resnet
        from mlsl_tpu_torch.models.train import DataParallelTrainer
        from mlsl_tpu_torch.types import CompressionType

        env = self.env
        rng = np.random.default_rng(0)
        x = rng.normal(size=(batch, image, image, 3)).astype(np.float32)
        y = rng.integers(0, classes, size=(batch,)).astype(np.int32)
        csums = {}
        kw = {"compression": CompressionType.QUANTIZATION} if int8 else {}
        for du in (False, True):
            gen = torch.Generator().manual_seed(0)
            model = resnet.ResNet50(num_classes=classes, generator=gen, device=env.device)
            dist = env.create_distribution(WORLD, 1)
            sess = env.create_session()
            sess.set_global_minibatch_size(batch)
            env.config.grad_bucket_mb = RESNET_BUCKET_MB if int8 else 0
            try:
                tr = DataParallelTrainer(env, dist, sess, model, resnet.loss_fn,
                                         resnet.layer_names(model), resnet.layer_subtree,
                                         lr=0.05, distributed_update=du, **kw)
            finally:
                env.config.grad_bucket_mb = 0
            b = tr.shard_batch(x, y)
            tag = f"resnet{'_int8' if int8 else ''}/du{int(du)}"
            before = transport.hop_totals()
            t0 = time.perf_counter()
            for step in range(steps):
                if step == 0:
                    tr._step_no += 1
                    loss, grads = tr._local_grads(b)
                    for name in tr.layers:
                        self.sample(f"{tag}/in/{name}", dist, grads[name], stride)
                    loss = tr._sync_and_update(grads, loss)
                    self.sample(f"{tag}/loss", dist, loss.reshape(*dist.world_shape, 1), 1)
                    for key, req in reduced_requests(tr):
                        self.sample(f"{tag}/{key}", dist, req._result, stride)
                else:
                    loss = tr.step(b)
                assert bool(torch.isfinite(loss).all()), f"{tag} step {step}: {loss}"
            if env.device.type == "cuda":
                torch.cuda.synchronize(env.device)
            after = transport.hop_totals()
            self.report[tag] = {"steps": steps, "s": time.perf_counter() - t0,
                                "algos": sorted({req.algo for _, req in reduced_requests(tr)}),
                                "hops": hop_delta(before, after)}
            leaves = [prm.detach().double().sum() for prm in tr._all_params()]
            csums[tag] = float(torch.stack(leaves).sum())
            del tr, model, sess
        self.log(f"proc {self.pid} resnet OK " + " ".join(f"{k}={v!r}" for k, v in csums.items()))
        return csums

    def train(self, params) -> float:
        from mlsl_tpu_torch.models import mlp
        from mlsl_tpu_torch.models.train import DataParallelTrainer

        env = self.env
        rng = np.random.default_rng(0)
        x = rng.normal(size=(TRAIN_B, 8)).astype(np.float32)
        y = rng.integers(0, 4, size=(TRAIN_B,)).astype(np.int64)
        trained = []
        for local in (False, True):
            dist = env.create_distribution(WORLD, 1)
            sess = env.create_session()
            sess.set_global_minibatch_size(TRAIN_B)
            model = mlp.MLP(params=params, device=env.device)
            tr = DataParallelTrainer(env, dist, sess, model, mlp.loss_fn, mlp.LAYERS,
                                     mlp.get_layer, lr=0.1)
            if local:
                half = TRAIN_B // self.nproc
                lo = self.pid * half
                batch = tr.shard_batch_local(x[lo:lo + half], y[lo:lo + half])
            else:
                batch = tr.shard_batch(x, y)
            loss = tr.step(batch)
            for p in dist.topology.local_ranks():
                lv = float(dist.local_part(loss.reshape(*dist.world_shape, 1), p)[0])
                assert np.isfinite(lv), lv
                self.out[f"train/loss{int(local)}/{p}"] = np.float32(lv)
            trained.append({k: {n: v.detach().cpu().numpy() for n, v in leaf.items()}
                            for k, leaf in model.jax_tree().items()})
        for k in trained[0]:
            for n in trained[0][k]:
                np.testing.assert_allclose(trained[0][k][n], trained[1][k][n], atol=1e-6)
                self.out[f"train/params/{k}/{n}"] = trained[0][k][n]
        leaves = [trained[0][k][n] for k in sorted(trained[0]) for n in sorted(trained[0][k])]
        csum = float(sum(leaf.astype(np.float64).sum() for leaf in leaves))
        self.log(f"proc {self.pid} train OK")
        return csum

    # -- the compressed wires and the direct exchanges ----------------------------

    def wires(self, n: int = 0) -> None:
        """Every wire case (``WIRE_CASES``) through the port's front doors;
        ``n``: ``BIG_WIRE_CASES`` at ``n`` elements a rank instead, each
        rank's rows made on the device from its own seed and kept as a
        digest and a sample (``save_digest``)."""
        from types import SimpleNamespace

        import torch

        from mlsl_tpu_torch import types as T
        from mlsl_tpu_torch.comm import sparse
        from mlsl_tpu_torch.comm.mesh import ProcessGroup
        from mlsl_tpu_torch.comm.request import CommDesc, CommRequest

        def custom(wire):
            kw = dict(compress_fn=lambda x: x.to(torch.float16),
                      decompress_fn=lambda p, n: p.to(torch.float32))
            if wire == "f16_reduce":
                kw["reduce_sum_fn"] = lambda a, b: a + b
            return kw

        kit = SimpleNamespace(types=T, CommDesc=CommDesc, CommRequest=CommRequest,
                              ProcessGroup=ProcessGroup, sparse=sparse,
                              QuantParams=T.QuantParams, custom=custom,
                              err=lambda req: req._errs[0])
        if not n:
            run_wires(kit, self.env, self.save)
        else:
            dev = self.env.device

            def fill(name, r, count, dist):
                rows = []
                for p in dist.topology.local_ranks():
                    gen = torch.Generator(device=dev).manual_seed(
                        sum(map(ord, name)) * 1000 + r * 10 + p)
                    rows.append(torch.randn(count, device=dev, generator=gen) * (1 + p) + r)
                return torch.stack(rows).reshape(*dist.world_shape, count)

            run_wires(kit, self.env, self.save_digest, fill=fill, topk_ratio=BIG_TOPK_RATIO,
                      cases=[(*c, n) for c in BIG_WIRE_CASES])
        self.log(f"proc {self.pid} wires OK")

    def save_digest(self, key: str, dist, buf) -> None:
        """Each local rank's row as two exact integer digests of its bits
        (their sum, and their sum weighted by the position mod 65521, both
        wrapping in int64) and every ``SAMPLE_STRIDE``-th element."""
        import torch

        for p in dist.topology.local_ranks():
            row = buf[dist.topology.local_coords(p)].reshape(-1).contiguous()
            bits = row.view(torch.int32).to(torch.int64)
            w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            self.out[f"{key}/{p}/digest"] = torch.stack(
                [bits.sum(), (bits * w).sum()]).cpu().numpy()
            self.out[f"{key}/{p}/sample"] = row[::SAMPLE_STRIDE].cpu().numpy()

    def exchanges(self, n_per_member: int = 6) -> None:
        """alltoall, bcast and sendrecv over every group of the (8, 1), (4, 2)
        and (2, 4) grids: the request's form (direct where the group spans
        processes) against the assembled one on the same buffer, bit for
        bit; each one's bytes handed to the backend go to the report."""
        import torch

        from mlsl_tpu_torch import types as T
        from mlsl_tpu_torch.comm import transport

        def bits(t):
            return t.contiguous().view(torch.int32)

        rec = {}
        for shape in ((8, 1), (4, 2), (2, 4)):
            dist = self.env.create_distribution(*shape)
            for g in sorted({s for s in shape if s > 1}):
                n = n_per_member * g
                for tag, kind, kw, start in exchange_requests(dist, g, n, T):
                    buf = dist.make_buffer(lambda p: exchange_fill(p, n), n)
                    key = f"exch/{shape[0]}x{shape[1]}/{tag}"
                    transport.reset_stats()
                    out = self.env.wait(start(buf))
                    direct = transport.hop_totals()
                    self.save(key, dist, out)
                    group = dist._group(getattr(T.GroupType, tag.split("/")[0]))
                    if not transport.spans(group):
                        continue
                    transport.reset_stats()
                    asm = transport.build_spanning(kind, group, None, direct=False, **kw)(buf)
                    assembled = transport.hop_totals()
                    assert torch.equal(bits(out), bits(asm)), f"{key}: direct != assembled"
                    rec[key] = {f: sum(h["bytes"] for h in hops.values())
                                for f, hops in (("direct", direct), ("assembled", assembled))}
                    # a process hands over no more; summed over the processes, less
                    assert rec[key]["direct"] <= rec[key]["assembled"], (key, rec[key])
        self.report["exchange_bytes"] = rec
        self.log(f"proc {self.pid} exchanges OK")

    def guard(self, steps: int = 12, outlier_from: int = 7) -> None:
        """The codec guardrail across processes: a sentinel gate (warmup 5,
        z 3, three breaches) screens ``steps`` steps of losses that wiggle
        around 1, rank 0's jumping to 50 from ``outlier_from`` on, over a
        stand-in for a guarded request that notes the step it is demoted
        at. The gate screens the world's rows on every process
        (``Sentinel.screen``), so every process demotes at the same step."""
        import torch

        from mlsl_tpu_torch import codecs, sentinel

        class Guarded:
            name, step, demoted_at = "guarded", -1, -1

            def demote_codec(self, reason=""):
                self.demoted_at = self.step

        req = Guarded()
        codecs.guard_reset()
        codecs.guard_register(req)
        dist = self.env.create_distribution(WORLD, 1)
        grid = dist.topology.local_shape
        gate = sentinel.Sentinel(grid, gate="warn", warmup=5, zmax=3.0, codec_guard_window=3)
        for step in range(steps):
            req.step = step
            loss = [50.0 if p == 0 and step >= outlier_from else 1.0 + 0.01 * ((p + step) % 3)
                    for p in dist.topology.local_ranks()]
            gate.gate(torch.tensor(loss).reshape(*grid, 1),
                      {"w": torch.ones((*grid, 4))}, None, step)
        codecs.guard_reset()
        assert req.demoted_at >= outlier_from, req.demoted_at
        self.out["guard/demoted_at"] = np.int64(req.demoted_at)
        self.log(f"proc {self.pid} guard OK demoted_at={req.demoted_at}")

    def train_int8(self, params, steps: int = 2) -> float:
        """The MLP's DataParallelTrainer on the int8 ring, ``steps`` steps on
        an (8, 1) world. -> the sum of the trained parameters."""
        from mlsl_tpu_torch.models import mlp
        from mlsl_tpu_torch.models.train import DataParallelTrainer
        from mlsl_tpu_torch.types import CompressionType

        env = self.env
        rng = np.random.default_rng(0)
        x = rng.normal(size=(TRAIN_B, 8)).astype(np.float32)
        y = rng.integers(0, 4, size=(TRAIN_B,)).astype(np.int64)
        dist = env.create_distribution(WORLD, 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(TRAIN_B)
        model = mlp.MLP(params=params, device=env.device)
        tr = DataParallelTrainer(env, dist, sess, model, mlp.loss_fn, mlp.LAYERS, mlp.get_layer,
                                 lr=0.1, compression=CompressionType.QUANTIZATION)
        assert all(tr._pset(n).grad_req.algo == "quant_ring" for n in mlp.LAYERS)
        batch = tr.shard_batch(x, y)
        for step in range(steps):
            loss = tr.step(batch)
            self.save(f"train8/loss{step}", dist, loss.reshape(*dist.world_shape, 1))
        leaves = {k: {n: v.detach().cpu().numpy() for n, v in leaf.items()}
                  for k, leaf in model.jax_tree().items()}
        for k in leaves:
            for n in leaves[k]:
                self.out[f"train8/params/{k}/{n}"] = leaves[k][n]
        self.log(f"proc {self.pid} train_int8 OK")
        return float(sum(leaves[k][n].astype(np.float64).sum() for k in sorted(leaves)
                         for n in sorted(leaves[k])))


PHASES = ("basic", "hierarchy", "gather", "loop", "matrix", "kinds", "train")


def reduced_requests(trainer):
    """(key, request) of every request that reduced a gradient in the last
    round: a bucket's (``bucket<i>``), or a layer's own."""
    out, seen = [], set()
    for name in trainer.layers:
        ps = trainer._pset(name)
        if not ps.need_comm:
            continue
        bucket = ps.bucket if ps._bucket_round else None
        req = bucket.req if bucket is not None else ps.grad_req
        if id(req) not in seen:
            seen.add(id(req))
            out.append((f"bucket{len(out)}" if bucket is not None else name, req))
    return out


def hop_delta(before: dict, after: dict) -> dict:
    """``transport.hop_totals()`` of what ran between two readings."""
    out = {}
    for k, v in after.items():
        b = before.get(k, {})
        if v["calls"] <= b.get("calls", 0):
            continue
        d = {f: v[f] - b.get(f, 0) for f in v if f != "dtypes"}
        d["dtypes"] = {t: nb - b.get("dtypes", {}).get(t, 0) for t, nb in v["dtypes"].items()}
        out[k] = d
    return out


def kernel_launches() -> dict:
    """The kernels' launch counts in this process (each wrapper's count)."""
    from mlsl_tpu_torch.ops import a2a_kernels, quant_kernels, rhd_kernels, ring_kernels

    return {k: v for m in (quant_kernels, ring_kernels, rhd_kernels, a2a_kernels)
            for k, v in m.LAUNCHES.items() if v}


def run(pid: int, nproc: int, port, device, out_dir: str, params_path=None,
        phases=PHASES, backend=None, log=print, graph=(1024, 4096, 16384),
        resnet=(224, 1000, 64), wires=0) -> dict:
    """Bring this process into the world (``port`` None: a world of one
    process and no coordinator, the twin a caller holds a world against),
    run ``phases``, write its results. ``graph``: (FM1, FM2, tokens) of the
    ``graph`` phase; ``resnet``: (image, classes, global batch) of
    ``resnet`` and ``resnet_int8``; ``wires``: the elements a rank of the
    ``wires`` phase's cases at a size (0: the small cases). -> the results
    (also in ``out_dir/proc<pid>.npz``)."""
    from mlsl_tpu_torch import get_env

    if port is None:
        env = get_env().init(device=device, world_size=WORLD)
    else:
        env = get_env().init(device=device, world_size=WORLD,
                             coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
                             process_id=pid, backend=backend)
    assert env.process_count() == nproc and env.process_index() == pid
    out: dict = {}
    w = Worker(env, out, log)
    params = None
    if params_path:
        with np.load(params_path) as z:
            params = {}
            for k in z.files:
                layer, leaf = k.split("/")
                params.setdefault(layer, {})[leaf] = z[k]
    csum = None
    import torch

    from mlsl_tpu_torch.comm import transport

    if env.device.type == "cuda":
        # the twin in one process takes the same convolutions
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    try:
        for ph in phases:
            transport.reset_stats()
            launched = kernel_launches()
            t0 = time.perf_counter()
            if ph == "train":
                csum = w.train(params)
            elif ph == "train_int8":
                out["csum/train8"] = np.float64(w.train_int8(params))
            elif ph == "graph":
                w.graph(*graph)
            elif ph == "wires":
                w.wires(wires)
            elif ph in ("resnet", "resnet_int8"):
                for k, v in w.resnet(*resnet, int8=ph == "resnet_int8").items():
                    out[f"csum/{k}"] = np.float64(v)
            else:
                getattr(w, ph)()
            if env.device.type == "cuda":
                torch.cuda.synchronize(env.device)
            now = kernel_launches()
            w.report.setdefault(ph, {}).update(
                s=time.perf_counter() - t0, hops=transport.hop_totals(),
                launches={k: v - launched.get(k, 0) for k, v in now.items()
                          if v > launched.get(k, 0)})
    finally:
        env.finalize()
    w.report["launches"] = kernel_launches()
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"proc{pid}.npz"), **out)
    log(f"proc {pid} E2E OK")
    if csum is not None:
        log(f"proc {pid} OK csum={csum:.10f}")
    log("REPORT " + json.dumps(w.report))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, default=None,
                    help="the coordinator's port (none: a one-process world, no coordinator)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--params", default=None)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--graph", default="1024,4096,16384", help="FM1,FM2,tokens")
    ap.add_argument("--resnet", default="224,1000,64", help="image,classes,batch")
    ap.add_argument("--wires", type=int, default=0,
                    help="elements a rank of phase wires's cases at a size (0: the small cases)")
    a = ap.parse_args(argv)
    ints = lambda v: tuple(int(x) for x in v.split(","))   # noqa: E731
    run(a.pid, a.nproc, a.port, a.device, a.out, a.params, tuple(a.phases.split(",")),
        a.backend, log=lambda m: print(m, flush=True), graph=ints(a.graph),
        resnet=ints(a.resnet), wires=a.wires)
    print(json.dumps({"proc": a.pid, "ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
