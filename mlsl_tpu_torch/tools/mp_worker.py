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

The trainers across processes (ROADMAP A.8b.4):

- ``hybrid``: HybridTrainer over the boxes, every case of ``HYBRID_TINY``
  (``--size full``: ``HYBRID_FULL``, gpt-medium-2k at its widths), each
  rank's CE and gradient rows before the sync, the first step's reduced
  gradients, two steps' world losses and the parameters after them, and
  the case's attention on its own, forward and backward (B9 on the card);
- ``moe``: the same for gpt-medium-2k-moe8 (or the tiny MoE) at tp 8;
- ``pipeline``: GPipe, 1F1B and (tiny) interleaved 1F1B over the (1, 8)
  grid's model axis, each rank's loss and stage gradients;
- ``feed``: ``trainer.feed`` on the int8 wire (``--feed mlp|resnet``), each
  decoded box held to ``shard_batch``'s local part and each loss to a twin
  fed by ``shard_batch``, both bit for bit.

The serving engine and the restricted world across processes (ROADMAP
A.8b.4's last piece, A.8b.5):

- ``serve``: InferenceEngine over the boxes, every case of ``SERVE_TINY``
  (``--size full``: ``SERVE_FULL``, gpt-medium-2k at its widths): the
  leader's tokens and logits, every rank's KV pools, every process's
  programs and the tokens each decode step fed, with each program's hops;
- ``restrict``: ``configure("color=...")`` with each of RESTRICT_COLORS in
  an Environment of its own, every kind over a (2, 2) grid of the 4 kept
  ranks; across processes RESTRICT_UNEVEN must raise.

``graph``, ``resnet`` and ``resnet_int8`` (config 5 on config 4's int8 ring
in ``RESNET_BUCKET_MB`` buckets) are the card's run (ad), with the six above
at ``--size full --feed resnet``. Each closed form is
checked on the ranks this process holds (within 1e-6 relative for float
sums, exactly otherwise). The results are written to
``DIR/proc<I>.npz`` (keys ``phase/name/rank``) for a caller to hold against a
single-process run, and the process prints ``proc I OK csum=<sum of the
trained parameters>`` at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
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

#: phases ``hybrid`` and ``moe`` (HybridTrainer over the world's boxes): the
#: tiny float32 config of tests/test_torch_transformer.py, heads widened to 8
#: where tp = 8 needs them. A case: (tag, config fields, (dp, sp, tp), ZeRO-1,
#: global batch). Between the 2 x 4 and 4 x 2 worlds every axis spans
#: processes: the data axis (ZeRO-1 too), the seq axis under ring, zigzag,
#: Ulysses and remat, the model axis with its sums, the sharded vocabulary
#: and the MoE exchanges
TFM_TINY = dict(vocab=32, d_model=16, n_heads=4, head_dim=4, n_blocks=2, seq_len=16,
                dtype="float32")
HYBRID_TINY = (
    ("zigzag_222", dict(attention="zigzag"), (2, 2, 2), False, 4),
    ("zigzag_222_zero1", dict(attention="zigzag"), (2, 2, 2), True, 4),
    ("ring_124", dict(attention="ring"), (1, 2, 4), False, 2),
    ("ulysses_241", dict(attention="ulysses"), (2, 4, 1), False, 4),
    ("ring_142_remat", dict(attention="ring", remat=True), (1, 4, 2), False, 2),
    ("vocab_118", dict(n_heads=8, head_dim=2, sharded_vocab=True), (1, 1, 8), False, 2),
)
MOE_TINY = (("moe_118", dict(n_heads=8, head_dim=2, n_experts=8), (1, 1, 8), False, 2),)
#: the card's: gpt-medium-2k at its full widths, two blocks, bf16; run (b)'s
#: grid with zigzag (the data axis spans two processes), then dp 1 x sp 2 x
#: tp 4 on the ring with the head sharded (the seq axis spans); and
#: gpt-medium-2k-moe8 at tp 8 (the model axis spans), batch 2 (dp = 1: every
#: rank holds the batch's 4,096 tokens)
HYBRID_FULL = (
    ("zigzag_222", dict(attention="zigzag"), (2, 2, 2), False, 8),
    ("zigzag_222_zero1", dict(attention="zigzag"), (2, 2, 2), True, 8),
    ("ring_124_vocab", dict(attention="ring", sharded_vocab=True), (1, 2, 4), False, 8),
)
MOE_FULL = (("moe_118", dict(n_experts=8), (1, 1, 8), False, 2),)
TFM_STEPS = 2
TFM_LR = {"tiny": 0.5, "full": 0.1}
#: phase ``pipeline``: stages over the (1, 8) grid's model axis, one a rank.
#: Tiny: tests/test_torch_pipeline.py's tanh stage (d 8, 6 microbatches of 2
#: rows). Full: run (x)'s residual MLP blocks at gpt-medium-2k's widths (d_model
#: 1,024, d_ff 4,096, float32), one block a stage, 8 microbatches of 1,024
#: tokens
PIPE_TINY = dict(d=8, micro=6, rows=2, v_chunks=2)
PIPE_FULL = dict(d=1024, d_ff=4096, micro=8, rows=1024)
PIPE_STAGES = WORLD
#: phase ``feed``: batches through ``trainer.feed`` on the int8 wire
FEED_BATCHES = 2

#: phase ``serve`` (the serving engine across processes): a case is (tag, tp,
#: int8 KV, mode, Config fields). Modes: ``evict`` (two long prompts, two
#: slots, a pool of one sequence plus one page: the younger is evicted and
#: resumed), ``shed`` (the leader slowed before every step, so that the
#: processes' clocks part, and forced to the precision rung after
#: SERVE_SHED_AT steps), ``transient`` (two TRANSIENT faults at serve.decode,
#: retried), ``fatal`` (a FATAL one: the leader raises, the followers end
#: with MLSLError), ``twin`` (checks.decode_twin after two steps, where the
#: model group lies inside the process). Tiny: tests/test_torch_serve.py's
#: config (vocab 64, d_model 32, 4 * tp heads of 8, 2 blocks, seq_len 64,
#: float32); tp = 8 spans both worlds, tp = 4 lies inside a process on 2 x 4,
#: tp = 2 in both
SERVE_TINY_CFG = dict(vocab=64, d_model=32, head_dim=8, n_blocks=2, seq_len=64,
                      dtype="float32")
SERVE_TINY = (
    ("tp8_f32", 8, False, "", {}),
    ("tp8_int8", 8, True, "", {}),
    ("tp4_f32", 4, False, "", {}),
    ("tp4_int8", 4, True, "", {}),
    ("tp2_f32_twin", 2, False, "twin", {}),
    ("tp2_int8_rhd", 2, True, "", {"pallas_rhd": True}),
    ("tp8_evict", 8, False, "evict", {}),
    ("tp8_shed", 8, False, "shed", {}),
    ("tp8_transient", 8, False, "transient", {"comm_retry_backoff_s": 0.0}),
    ("tp8_fatal", 8, False, "fatal", {}),
)
SERVE_TINY_PROMPTS, SERVE_TINY_NEW, SERVE_TINY_KV_MB = 5, 6, 1
#: the card's: gpt-medium-2k at its full widths, two blocks, bf16 compute, run
#: (y)'s first 8 prompts (64-1,024 tokens, seed SERVE_SEED), 16 new tokens, 4
#: slots: tp = 8 with float32 KV (the model axis spans the two processes) and
#: the forced shed; tp = 4 with int8 KV on B5 (each process a replica) and
#: the decode graph's twin. Both name their route, whatever MLSL_ALGO says:
#: a one-process twin at tp = 8 then sums as the transport does (one
#: reduction over the members), not on a kernel route
SERVE_FULL = (
    ("tp8_f32kv_shed", 8, False, "shed", {"collective_algo": ""}),
    ("tp4_int8kv_rhd_twin", 4, True, "twin", {"collective_algo": "", "pallas_rhd": True}),
)
SERVE_SEED, SERVE_LOAD, SERVE_PROMPT = 0, 240, (64, 1024)   # run (y)'s prompt stream
SERVE_FULL_PROMPTS, SERVE_FULL_NEW, SERVE_FULL_BATCH = 8, 16, 4
#: 512 float32 pages of 256 KiB (2 blocks), against 4 slots x 66 pages in flight
SERVE_FULL_KV_MB = 128
SERVE_SHED_AT, SERVE_SLOW_S = 3, 0.02
SERVE_EVICT_NEW = 8
#: the kinds of a program in ``rep/serve/<case>/programs`` rows
SERVE_PROGRAMS = {"prefill": 1, "decode": 2, "twin": 3}

#: phase ``restrict``: configure("color=...") restricting the world of 8 to
#: 4 ranks, each list in an Environment of its own, then every collective
#: kind over a (2, 2) grid of the restricted world; RESTRICT_UNEVEN keeps 3
#: ranks, which split over no world of 2 or 4 processes
RESTRICT_COLORS = ((0, 1, 0, 1, 0, 1, 0, 1), (0, 0, 0, 0, 1, 1, 1, 1))
RESTRICT_UNEVEN = (0, 0, 0, 1, 1, 1, 1, 1)


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
        #: Environment.init's keywords: the restrict phase builds
        #: Environments of its own over the same world
        self.init_kw: dict = {}
        #: phase serve's oracle rule on the leader, (float32 KV bound, int8
        #: KV bound); None: not run (serve/checks.oracle_rule)
        self.serve_oracle = None

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


    # -- the trainers across processes (HybridTrainer, the pipelines, the feed) --

    def keep(self, key: str, dist, buf, size: str) -> None:
        """Each local rank's row of a (R_l, D_l, S_l, M_l, ...) tensor: whole
        at the tiny size, as two digests and a sample at the full one."""
        buf = buf.detach().reshape(*buf.shape[:4], -1).float()
        if size == "tiny":
            self.save(key, dist, buf)
        else:
            self.save_digest(key, dist, buf)

    def tfm_case(self, case, size: str, tparams) -> None:
        """One HybridTrainer case over this process's box: the per-rank CE
        and gradient rows before the sync, the reduced gradients of the
        first step, TFM_STEPS steps' world losses (every process's), the
        parameters after them; a standalone attention call of the case's
        schedule (B9 on the card) where the seq axis has ranks."""
        import torch

        from mlsl_tpu_torch.comm import transport
        from mlsl_tpu_torch.models import transformer as tfm

        tag, fields, (dp, sp, tp), zero1, batch = case
        env = self.env
        base = tfm.TransformerConfig(**TFM_TINY) if size == "tiny" else dataclasses.replace(
            tfm.GPT_MEDIUM_2K, n_blocks=2)
        cfg = dataclasses.replace(base, **fields)
        params = None
        if tparams is not None:
            params = {}
            for k, v in tparams.items():
                c, layer, leaf = k.split("/")
                if c == tag:
                    params.setdefault(layer, {})[leaf] = v
        tr = tfm.HybridTrainer(env, cfg, dp, sp, tp, batch=batch, lr=TFM_LR[size],
                               distributed_update=zero1, params=params)
        dist = tr.dist
        st, sl = tr.shard_tokens(*tfm_tokens(cfg.vocab, cfg.seq_len, batch))
        key = f"hybrid/{tag}"
        if sp > 1:
            self.attention_call(tr, cfg, key, size)
        before = transport.hop_totals()
        secs, losses = [], []
        sync = lambda: torch.cuda.synchronize(env.device) if env.device.type == "cuda" else None
        for step in range(TFM_STEPS):
            sync()
            t0 = time.perf_counter()
            if step == 0:
                # the step as ``step`` runs it, its gradient rows kept first
                if tr.fused:
                    ce, grads = tr._backward(st, sl)
                    loss, rows = ce[..., None], tr._rows(list(grads))
                else:
                    loss, rows = tr._grad_fn(st, sl)
                self.save(f"{key}/ce", dist, loss.reshape(*tr.grid, 1))
                for name in tr.layers:
                    self.keep(f"{key}/in/{name}", dist, rows[name], size)
                if tr.fused:
                    del rows
                    tr._fused_update(grads)
                    lv = tr._mean_ce(ce)
                    del grads
                else:
                    lv = tr._sync_and_update(rows, loss)
                    for name in tr.layers:
                        ps = tr.ops[name].get_parameter_set(0)
                        if ps.need_comm:
                            self.keep(f"{key}/red/{name}", dist, ps.grad_req._result, size)
                    del rows
            else:
                lv = tr.step(st, sl)
            sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(lv))
            assert np.isfinite(losses[-1]), (tag, step, losses)
        hops = hop_delta(before, transport.hop_totals())
        self.out[f"rep/{key}/losses"] = np.asarray(losses, np.float64)
        for name in tr.layers:
            flat = torch.cat([p.detach().reshape(*tr.grid, -1) for p in tr._leaves[name]], -1)
            self.keep(f"{key}/params/{name}", dist, flat, size)
        self.report[key] = {"steps": TFM_STEPS, "step_s": secs, "losses": losses,
                            "fused": tr.fused, "graphs": len(tr._graphs), "hops": hops,
                            "spans": {a: g.spans for a, g in (
                                ("data", dist.data_group), ("seq", dist.seq_group),
                                ("model", dist.model_group))}}
        del tr, st, sl
        if env.device.type == "cuda":
            torch.cuda.empty_cache()

    def attention_call(self, tr, cfg, key: str, size: str) -> None:
        """The case's sequence-parallel attention on its own, forward and
        backward, over the box: q, k, v and the cotangent of every rank from
        a seed of its global rank, so that a fold of a block that arrived from
        another process shows against the twin (B9 on the card)."""
        import torch

        from mlsl_tpu_torch.models import transformer as tfm
        from mlsl_tpu_torch.parallel import sequence

        dist, env = tr.dist, self.env
        topo = dist.topology
        dt = tfm._dtype(cfg.dtype)
        shape = (1 if size == "full" else 2, cfg.n_heads // tr.tp, cfg.seq_len // tr.sp,
                 cfg.head_dim)
        ts = [torch.empty((*tr.grid, *shape), dtype=dt, device=env.device) for _ in range(4)]
        for p in topo.local_ranks():
            c = topo.local_coords(p)
            gen = torch.Generator(device=env.device).manual_seed(1000 + p)
            for t in ts:
                t[c] = torch.randn(shape, generator=gen, device=env.device).to(dt)
        q, k, v = (t.requires_grad_() for t in ts[:3])
        if cfg.attention == "zigzag":
            out = sequence.zigzag_ring_attention(q, k, v, tfm.SEQ_DIM, tr.sp,
                                                 group=dist.seq_group)
        elif cfg.attention == "ring":
            out = sequence.ring_attention(q, k, v, tfm.SEQ_DIM, tr.sp, causal=True,
                                          group=dist.seq_group)
        else:
            out = sequence.ulysses_attention(q, k, v, tfm.SEQ_DIM, tr.sp, causal=True,
                                             group=dist.seq_group)
        grads = torch.autograd.grad((out.float() * ts[3].float()).sum(), (q, k, v))
        for name, t in zip(("out", "dq", "dk", "dv"), (out, *grads)):
            self.keep(f"{key}/attn/{name}", dist, t, size)

    def hybrid(self, size: str = "tiny", tparams=None, cases=None) -> None:
        """HybridTrainer across processes: every case of HYBRID_TINY (or
        HYBRID_FULL on the card, ``size="full"``). ``tparams``: the starting
        weights, ``case/layer/leaf`` arrays (the JAX package's init_params),
        else the port's from seed 0."""
        for case in cases or (HYBRID_TINY if size == "tiny" else HYBRID_FULL):
            self.tfm_case(case, size, tparams)
        self.log(f"proc {self.pid} hybrid OK")

    def moe(self, size: str = "tiny", tparams=None) -> None:
        """gpt-medium-2k-moe8 (or the tiny MoE) at tp 8: the model axis spans
        processes, the exchanges and the model sums cross them."""
        self.hybrid(size, tparams, MOE_TINY if size == "tiny" else MOE_FULL)

    def pipeline(self, size: str = "tiny") -> None:
        """GPipe, 1F1B (and interleaved 1F1B at the tiny size) over the (1, 8)
        grid's model axis, one stage a rank: the stage boundary and the loss
        sum cross processes. Kept: each rank's loss and stage gradients;
        reported: each schedule's seconds, hops and gaps to the dense oracle
        (every stage in sequence) on this process's stages."""
        import torch

        from mlsl_tpu_torch.comm import transport
        from mlsl_tpu_torch.parallel import pipeline as pp

        env, S = self.env, PIPE_STAGES
        dist = env.create_distribution(1, S)
        topo = dist.topology
        m0, ml = topo.local_origin[3], topo.local_shape[3]
        data = pipe_data(size)
        dev = env.device
        w = {k: torch.from_numpy(v).to(dev) for k, v in data["weights"].items()}
        x, t = (torch.from_numpy(data[k]).to(dev) for k in ("x", "t"))
        grid = topo.local_shape
        xs = x.expand(*grid, *x.shape)
        ys = t.expand(*grid, *t.shape)
        group = dist.model_group
        box = {k: v[m0:m0 + ml].reshape(1, 1, 1, ml, *v.shape[1:]) for k, v in w.items()}
        scheds = ("gpipe", "1f1b") + (("interleaved",) if size == "tiny" else ())
        sync = lambda: torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        oracles = {}

        def rel(a, b):
            a, b = a.detach().double(), b.detach().double()
            return float((a - b).norm() / b.norm())

        for sched in scheds:
            before = transport.hop_totals()
            sync()
            t0 = time.perf_counter()
            if sched == "gpipe":
                p = {k: v.clone().requires_grad_() for k, v in box.items()}
                loss = pp.pipeline_loss(pipe_stage, pipe_loss, p, xs, ys, 3, S, group=group)
                grads = dict(zip(p, torch.autograd.grad(loss.sum() / S, list(p.values()))))
            elif sched == "1f1b":
                loss, grads = pp.one_f1b_step(pipe_stage, pipe_loss, box, xs, ys, 3, S,
                                              group=group)
            else:
                v_chunks = PIPE_TINY["v_chunks"]
                chunks = {k: torch.stack([v[c * S + m0:c * S + m0 + ml] for c in
                                          range(v_chunks)]).reshape(v_chunks, 1, 1, 1, ml,
                                                                    *v.shape[1:])
                          for k, v in w.items()}
                loss, grads = pp.interleaved_1f1b_step(pipe_stage, pipe_loss, chunks, xs, ys,
                                                       3, S, v_chunks, group=group)
            sync()
            secs = time.perf_counter() - t0
            hops = hop_delta(before, transport.hop_totals())
            key = f"pipeline/{sched}"
            self.save(f"{key}/loss", dist, loss.detach().reshape(*grid, 1))
            # the dense oracle (every stage in sequence), this process's stages
            k_stages = S * (PIPE_TINY["v_chunks"] if sched == "interleaved" else 1)
            if k_stages not in oracles:
                oracles[k_stages] = pipe_dense(torch, {k: v[:k_stages] for k, v in w.items()},
                                               x, t, k_stages)
            o_loss, o_grads = oracles[k_stages]
            first = float(loss.detach().reshape(-1)[0])
            gaps = {"loss": abs(first - o_loss) / abs(o_loss), "grad": 0.0}
            for k, g in grads.items():
                g = g.detach()
                if sched == "interleaved":
                    g = g.movedim(0, 4)                    # (1, 1, 1, M_l, V, ...)
                    want = o_grads[k].reshape(-1, S, *o_grads[k].shape[1:])[:, m0:m0 + ml]
                    want = want.movedim(0, 1)
                else:
                    want = o_grads[k][m0:m0 + ml]
                gaps["grad"] = max(gaps["grad"], rel(g.reshape(want.shape), want))
                self.keep(f"{key}/grad/{k}", dist, g.reshape(*grid, -1), size)
            self.report[key] = {"s": secs, "hops": hops, "oracle_gaps": gaps}
            del loss, grads
        self.log(f"proc {self.pid} pipeline OK")

    def feed(self, model: str = "mlp", resnet=(224, 1000, 64)) -> None:
        """The fed path across processes: ``trainer.feed`` on the int8 wire,
        FEED_BATCHES batches, replicated and ZeRO-1, the MLP or config 5
        (``model="resnet"`` at ``resnet``'s image, classes and batch). Each
        decoded box is held bit for bit to ``shard_batch``'s local part of
        the host-decoded batch, and each loss to a twin trainer's fed by
        ``shard_batch``; kept: the decoded rows and both steps' per-rank
        losses (``feed/du<0|1>/...``), this process's FEED counters."""
        import torch

        from mlsl_tpu_torch.core import stats
        from mlsl_tpu_torch.data.wire import _encode_int8
        from mlsl_tpu_torch.models import mlp, resnet as rn
        from mlsl_tpu_torch.models.train import DataParallelTrainer
        from mlsl_tpu_torch.ops import quant_kernels as qk

        env = self.env
        host = feed_batches(model, resnet)
        batch = host[0][0].shape[0]
        classes = 4 if model == "mlp" else resnet[1]
        block = env.config.quant_block_elems
        shards = WORLD
        local = batch // shards

        def decoded(x):
            """The host's decode of the int8 wire, shard by shard."""
            out = []
            for i in range(shards):
                part = x[i * local:(i + 1) * local]
                q, sc = _encode_int8(part, block)
                d = qk.dequantize_blocks_ref(torch.from_numpy(q).reshape(-1, block),
                                             torch.from_numpy(sc))
                out.append(d.reshape(-1)[:part.size].reshape(part.shape).numpy())
            return np.concatenate(out)

        def build(du):
            dist = env.create_distribution(WORLD, 1)
            sess = env.create_session()
            sess.set_global_minibatch_size(batch)
            if model == "mlp":
                net = mlp.MLP(device=env.device)
                return DataParallelTrainer(env, dist, sess, net, mlp.loss_fn, mlp.LAYERS,
                                           mlp.get_layer, lr=0.1, distributed_update=du), dist
            net = rn.ResNet50(num_classes=classes, generator=torch.Generator().manual_seed(0),
                              device=env.device)
            return DataParallelTrainer(env, dist, sess, net, rn.loss_fn, rn.layer_names(net),
                                       rn.layer_subtree, lr=0.05, distributed_update=du), dist

        self.report["feed"] = {"model": model}
        for du in (False, True):
            tag = f"feed/du{int(du)}"
            tr, dist = build(du)
            stats.reset_feed_counters()
            loader = tr.feed(host, wire="int8", cache_mb=0, epochs=1, depth=2)
            fed, secs = [], []
            try:
                for b in range(FEED_BATCHES):
                    t0 = time.perf_counter()
                    xb, yb = next(loader)
                    loss = tr.step((xb, yb))
                    if env.device.type == "cuda":
                        torch.cuda.synchronize(env.device)
                    secs.append(time.perf_counter() - t0)
                    self.keep(f"{tag}/decoded/{b}", dist, xb[:, :, :1, :1].contiguous(),
                              "tiny" if model == "mlp" else "full")
                    self.save(f"{tag}/labels/{b}", dist, yb[:, :, :1, :1].reshape(
                        *dist.topology.local_shape[:2], 1, 1, -1))
                    self.save(f"{tag}/loss{b}", dist,
                              loss.detach().reshape(*dist.world_shape, 1))
                    fed.append((xb, loss.detach().clone()))
            finally:
                loader.close()
            counters = dict(stats.FEED_COUNTERS)
            twin, _ = build(du)
            for b, (x, y) in enumerate(host):
                want = twin.shard_batch(decoded(x), y)
                assert torch.equal(fed[b][0], want[0]), \
                    f"{tag}: batch {b}'s decoded box differs from shard_batch's local part"
                loss = twin.step(want)
                assert torch.equal(loss.detach(), fed[b][1]), \
                    f"{tag}: batch {b}'s losses differ from the trainer fed by shard_batch"
            self.report["feed"][f"du{int(du)}"] = {"counters": counters, "step_s": secs}
            del tr, twin, fed
        self.log(f"proc {self.pid} feed OK")

    # -- the serving engine and the restricted world across processes ------------

    def serve(self, size: str = "tiny", tparams=None, cases=None) -> None:
        """The serving engine across processes: every case of SERVE_TINY (or
        SERVE_FULL, ``size="full"``). The leader (global rank 0's process)
        submits and decides, every other process replays its records. Kept:
        the leader's tokens and the logits each was picked from, every
        rank's KV pools, every process's programs (``rep/``). ``tparams``:
        the weights by tp, ``serve_tp<tp>/layer/leaf`` arrays (the JAX
        package's init_params), else the port's from SERVE_SEED."""
        for case in cases or (SERVE_TINY if size == "tiny" else SERVE_FULL):
            self.serve_case(case, size, tparams)
        self.log(f"proc {self.pid} serve OK")

    def serve_case(self, case, size: str, tparams) -> None:
        import torch

        from mlsl_tpu_torch import chaos
        from mlsl_tpu_torch.comm import transport
        from mlsl_tpu_torch.core import stats
        from mlsl_tpu_torch.log import MLSLError
        from mlsl_tpu_torch.models import transformer as tfm
        from mlsl_tpu_torch.serve import checks
        from mlsl_tpu_torch.serve.engine import InferenceEngine

        tag, tp, quant, mode, fields = case
        env = self.env
        cfg = (tfm.TransformerConfig(**serve_config(size, tp)) if size == "tiny"
               else dataclasses.replace(tfm.GPT_MEDIUM_2K, n_blocks=2))
        params = None
        if tparams is not None:
            params = {}
            for k, v in tparams.items():
                c, layer, leaf = k.split("/")
                if c == f"serve_tp{tp}":
                    params.setdefault(layer, {})[leaf] = v
        if not params:
            params = tfm.init_params(torch.Generator().manual_seed(SERVE_SEED), cfg)
        tiny = size == "tiny"
        conf = dataclasses.replace(
            env.config, serve_kv_quant=quant,
            serve_kv_cache_mb=SERVE_TINY_KV_MB if tiny else SERVE_FULL_KV_MB, **fields)
        conf.validate()
        new = SERVE_TINY_NEW if tiny else SERVE_FULL_NEW
        prompts = serve_prompts(size, cfg.vocab)
        batch = 2 if mode == "evict" else (None if tiny else SERVE_FULL_BATCH)
        if mode == "evict":
            prompts, new = serve_evict_prompts(), SERVE_EVICT_NEW
        stats.reset_serve_counters()
        launched = kernel_launches()
        eng = InferenceEngine(env, cfg, tp=tp, params=params, config=conf, max_batch=batch)
        key = f"serve/{tag}"
        rec = {"spanning": eng.spanning, "graphed": eng.graphed, "leader": eng.is_leader,
               "grid": list(eng.grid)}
        # each program's hops, by program kind: what crossed a prefill, a decode step
        hops = {"prefill": [0, {}], "decode": [0, {}]}

        def timed(fn, kind):
            def run(*a, **kw):
                before = transport.hop_totals()
                try:
                    return fn(*a, **kw)
                finally:
                    acc = hops[kind]
                    acc[0] += 1
                    for k, h in hop_delta(before, transport.hop_totals()).items():
                        mine = acc[1].setdefault(k, {f: 0 for f in h if f != "dtypes"})
                        for f in mine:
                            mine[f] += h[f]
            return run

        # the tokens every decode step fed, on every process (a follower's
        # from its records)
        fed = []
        run_decode = eng._run_decode

        def feeding(dtype, tokens, positions, pt, rung=0):
            fed.append(np.array(tokens, np.int64))
            return run_decode(dtype, tokens, positions, pt, rung)

        eng._run_decode = feeding
        # the leader's programs with their records, a follower's as it replays
        if eng.is_leader:
            eng._prefill_program = timed(eng._prefill_program, "prefill")
            eng._decode = timed(eng._decode, "decode")
        else:
            eng._run_prefill = timed(eng._run_prefill, "prefill")
            eng._run_decode = timed(eng._run_decode, "decode")
        sync = (lambda: torch.cuda.synchronize(env.device)) if env.device.type == "cuda" \
            else (lambda: None)
        t0 = time.perf_counter()
        try:
            if eng.is_leader:
                probe = self.serve_lead(eng, rec, prompts, new, mode, key)
            else:
                try:
                    eng.submit(prompts[0], new)
                except MLSLError as e:
                    rec["submit_refused"] = str(e)
                try:
                    eng.run()
                except MLSLError as e:
                    rec["stopped_on_error"] = str(e)
                    if mode != "fatal":
                        raise
                rec["twins"] = [{"bit_for_bit": bool(np.array_equal(g, e_)),
                                 "pools_equal": bool(same)} for g, e_, same in eng.twins]
                if tiny:
                    for i, (g, _, _) in enumerate(eng.twins):
                        self.out[f"{key}/twin_rows/proc{self.pid}/{i}"] = g
            sync()
        finally:
            chaos.clear()
        rec["s"] = time.perf_counter() - t0
        if mode == "fatal":
            assert ("stopped_on_error" in rec) or ("fatal" in rec), (tag, rec)
        self.out[f"rep/{key}/programs"] = serve_programs(eng)
        self.out[f"rep/{key}/fed"] = np.asarray(fed, np.int64).reshape(len(fed), -1)
        rec["program_hops"] = {k: {"programs": v[0], "hops": v[1]} for k, v in hops.items()
                               if v[0]}
        reqs = rec.pop("requests", [])
        if eng.is_leader and self.serve_oracle is not None and mode != "fatal":
            # after the programs were kept: the oracle's prefills are its own
            delta = self.serve_oracle[1 if quant else 0]
            recs = [checks.oracle_rule(eng, r, probe.logits[r.id], delta) for r in reqs]
            assert all(o["ok"] for o in recs), (key, recs)
            rec["oracle"] = [{k: v for k, v in o.items() if k != "ok"} for o in recs]
        for name, t in zip(("kpool", "vpool", "kscale", "vscale"), eng._pools()):
            self.keep(f"{key}/{name}", eng.dist, t, size)
        rec["counters"] = {k: v for k, v in stats.SERVE_COUNTERS.items() if v}
        rec["graphs"] = sorted(eng._decode_cache)
        now = kernel_launches()
        rec["launches"] = {k: v - launched.get(k, 0) for k, v in now.items()
                           if v > launched.get(k, 0)}
        eng.close()
        self.report[key] = rec
        del eng, params
        if env.device.type == "cuda":
            torch.cuda.empty_cache()

    def serve_lead(self, eng, rec, prompts, new, mode, key):
        """The leader's side of a serving case: submit, drive, keep. -> the
        probe (the logits each token was picked from)."""
        from mlsl_tpu_torch import chaos
        from mlsl_tpu_torch.core import stats
        from mlsl_tpu_torch.serve import checks, kv_cache

        if mode == "evict":
            # one sequence plus one page: the two collide on their third page
            page = kv_cache.PagedKVCache(eng.cfg, page_elems=16, budget_mb=1, max_len=64)
            mb = (page.max_pages_per_seq + 1) * page.page_bytes / 2 ** 20
            eng.cache = kv_cache.PagedKVCache(eng.cfg, page_elems=16, budget_mb=mb,
                                              max_len=64)
        elif mode == "transient":
            chaos.plan("serve.decode", "error", exc=OSError, after=2, times=2)
        elif mode == "fatal":
            chaos.plan("serve.decode", "error", exc=ValueError, after=3, times=1)
        probe = checks.Probe(eng)
        reqs = [eng.submit(p, new) for p in prompts]
        try:
            if mode == "shed":
                steps = 0
                while True:
                    time.sleep(SERVE_SLOW_S)        # the leader's clock parts
                    n = eng.step()
                    steps += 1
                    if steps == SERVE_SHED_AT:
                        eng.governor.force_shed("forced (serve phase)")
                        eng.governor.force_shed("forced (serve phase)")
                    if n == 0 and not eng._pending:
                        break
            elif mode == "twin":
                eng.run(max_steps=2)
                if not eng.spanning:
                    g, e, same, n_live = checks.decode_twin(eng)
                    rec["twins"] = [{"bit_for_bit": bool(np.array_equal(g, e)),
                                     "pools_equal": bool(same), "live": n_live}]
                    self.out[f"{key}/twin_rows/proc{self.pid}/0"] = g
                eng.run()
            else:
                eng.run()
        except ValueError as e:
            if mode != "fatal":
                raise
            rec["fatal"] = f"{type(e).__name__}: {e}"
        for r in reqs:
            self.out[f"{key}/tokens/{r.id}"] = np.asarray(r.tokens, np.int64)
            if probe.logits.get(r.id):
                self.out[f"{key}/logits/{r.id}"] = np.stack(probe.logits[r.id])
        rec["states"] = [r.state for r in reqs]
        rec["ttft_ms"] = [r.ttft_ms for r in reqs]
        rec["step_ms"] = probe.step_ms
        rec["rung_at_end"] = eng.governor.rung
        rec["sheds"] = eng.governor.sheds
        if mode not in ("fatal",):
            assert all(r.state == "done" for r in reqs), (key, rec["states"])
            eng.cache.check()
        if mode == "evict":
            assert stats.SERVE_COUNTERS["kv_evictions"] >= 1, key
        if mode == "transient":
            assert stats.SERVE_COUNTERS["retries"] == 2, key
        rec["requests"] = reqs
        return probe

    def restrict(self) -> None:
        """configure("color=...") restricting the world, each list of
        RESTRICT_COLORS in an Environment of its own: every collective kind
        over a (2, 2) grid of the 4-rank world, each local rank's result
        kept. Across processes RESTRICT_UNEVEN must raise, naming the split."""
        from mlsl_tpu_torch import get_env, types as T
        from mlsl_tpu_torch.log import MLSLError

        n = 16
        rec = {}
        for colors in RESTRICT_COLORS:
            tag = "".join(map(str, colors))
            self.env.finalize()
            env = self.env = get_env().init(**self.init_kw)
            if self.nproc > 1:
                try:
                    env.configure("color=" + ",".join(map(str, RESTRICT_UNEVEN)))
                    rec["uneven"] = None
                except MLSLError as e:
                    rec["uneven"] = str(e)
                assert env.get_process_count() == WORLD
            env.configure("color=" + ",".join(map(str, colors)))
            kept = sum(1 for c in colors if c == colors[0])
            assert env.get_process_count() == kept
            dist = env.create_distribution(2, 2)
            rec[tag] = {"local_shape": list(dist.topology.local_shape),
                        "local_ranks": list(dist.topology.local_ranks())}
            for ktag, start in kind_requests(dist, 2, n, T):
                buf = dist.make_buffer(lambda p: rank_fill(p, n) - 3500.0, n)
                self.save(f"restrict/{tag}/{ktag}", dist, env.wait(start(buf)))
        self.env.finalize()
        self.env = get_env().init(**self.init_kw)
        self.report["restrict"] = rec
        self.log(f"proc {self.pid} restrict OK")


PHASES = ("basic", "hierarchy", "gather", "loop", "matrix", "kinds", "train")


def serve_config(size: str, tp: int) -> dict:
    """Phase ``serve``'s model config fields at ``size`` for ``tp``."""
    if size == "tiny":
        return dict(SERVE_TINY_CFG, n_heads=4 * tp)
    return {}


def serve_prompts(size: str, vocab: int) -> list:
    """Phase ``serve``'s prompts: tests/test_torch_serve.py's five (seed 0,
    3-19 tokens) or run (y)'s first SERVE_FULL_PROMPTS (its stream of
    SERVE_LOAD lengths in SERVE_PROMPT, from SERVE_SEED)."""
    if size == "tiny":
        rng = np.random.default_rng(0)
        return [rng.integers(1, 64, size=int(rng.integers(3, 20))).astype(np.int32)
                for _ in range(SERVE_TINY_PROMPTS)]
    rng = np.random.default_rng(SERVE_SEED)
    sizes = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, size=SERVE_LOAD)
    return [rng.integers(1, vocab, size=int(k)).astype(np.int32)
            for k in sizes[:SERVE_FULL_PROMPTS]]


def serve_evict_prompts() -> list:
    """Mode ``evict``'s two prompts (tests/test_torch_serve.py's)."""
    return [np.arange(1, 31, dtype=np.int32), np.arange(2, 32, dtype=np.int32)]


def serve_programs(eng) -> np.ndarray:
    """The programs an engine ran, (n, 3) int64: kind (SERVE_PROGRAMS),
    then the prefill's length and whether it wrote, or the decode's dtype
    index and the ladder's rung."""
    from mlsl_tpu_torch.serve.engine import _DTYPES

    rows = [(SERVE_PROGRAMS[p[0]], p[1], int(p[2])) if p[0] == "prefill"
            else (SERVE_PROGRAMS[p[0]], _DTYPES.index(p[1]), p[2]) for p in eng.programs]
    return np.asarray(rows, np.int64).reshape(-1, 3)


def tfm_tokens(vocab: int, seq_len: int, batch: int):
    """A HybridTrainer case's global (tokens, labels), int32, from seed 1."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, size=(batch, seq_len)).astype(np.int32)
    return toks, rng.integers(0, vocab, size=(batch, seq_len)).astype(np.int32)


def feed_batches(model: str = "mlp", resnet=(224, 1000, 64)) -> list:
    """Phase ``feed``'s host batches: FEED_BATCHES (x float32, y int32) of
    the MLP's (TRAIN_B, 8) or config 5's images, from seed 7."""
    rng = np.random.default_rng(7)
    if model == "mlp":
        shape, classes, batch = (8,), 4, TRAIN_B
    else:
        image, classes, batch = resnet
        shape = (image, image, 3)
    return [(rng.standard_normal((batch, *shape), np.float32),
             rng.integers(0, classes, size=(batch,)).astype(np.int32))
            for _ in range(FEED_BATCHES)]


def pipe_stage(params, x):
    """A pipeline stage: the tanh layer (``w``, ``b``) or run (x)'s residual
    MLP blocks (``w1``, ``b1``, ``w2``, ``b2``, a leading block dim)."""
    import torch

    if "w" in params:
        return torch.tanh(x @ params["w"] + params["b"])
    for j in range(params["w1"].shape[0]):
        h = torch.nn.functional.gelu(x @ params["w1"][j] + params["b1"][j])
        x = x + h @ params["w2"][j] + params["b2"][j]
    return x


def pipe_loss(y, t):
    return ((y - t) ** 2).mean()


def pipe_data(size: str, n_stages: int = PIPE_STAGES, seed: int = 40) -> dict:
    """The pipeline phase's stage weights (n_stages, ...), microbatches and
    targets (micro, rows, d), float32 numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    if size == "tiny":
        c = PIPE_TINY
        d, k = c["d"], n_stages * c["v_chunks"]
        w = {"w": rng.normal(size=(k, d, d)).astype(np.float32) * 0.5,
             "b": rng.normal(size=(k, d)).astype(np.float32) * 0.1}
    else:
        c = PIPE_FULL
        d, f = c["d"], c["d_ff"]
        w = {"w1": (rng.standard_normal((n_stages, 1, d, f), np.float32) / d ** 0.5),
             "b1": rng.standard_normal((n_stages, 1, f), np.float32) * 0.02,
             "w2": rng.standard_normal((n_stages, 1, f, d), np.float32) * (0.5 / f ** 0.5),
             "b2": rng.standard_normal((n_stages, 1, d), np.float32) * 0.02}
    x = rng.standard_normal((c["micro"], c["rows"], d), np.float32)
    t = rng.standard_normal((c["micro"], c["rows"], d), np.float32)
    return {"weights": w, "x": x, "t": t}


def pipe_dense(torch, weights: dict, x, t, n_stages: int = PIPE_STAGES):
    """The dense oracle: every stage in sequence on each microbatch. ->
    (loss summed over the microbatches, {leaf: (n_stages, ...) gradient})."""
    p = {k: v.clone().requires_grad_() for k, v in weights.items()}
    h = x.reshape(-1, x.shape[-1])
    for s in range(n_stages):
        h = pipe_stage({k: v[s] for k, v in p.items()}, h)
    loss = ((h.reshape(t.shape) - t) ** 2).mean(dim=(1, 2)).sum()
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), dict(zip(p, grads))


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
    from mlsl_tpu_torch.ops import (
        a2a_kernels,
        attention_kernels,
        quant_kernels,
        rhd_kernels,
        ring_kernels,
    )

    return {k: v for m in (quant_kernels, ring_kernels, rhd_kernels, a2a_kernels,
                           attention_kernels)
            for k, v in m.LAUNCHES.items() if v}


def run(pid: int, nproc: int, port, device, out_dir: str, params_path=None,
        phases=PHASES, backend=None, log=print, graph=(1024, 4096, 16384),
        resnet=(224, 1000, 64), wires=0, size="tiny", tparams_path=None,
        feed_model="mlp", serve_oracle=None) -> dict:
    """Bring this process into the world (``port`` None: a world of one
    process and no coordinator, the twin a caller holds a world against),
    run ``phases``, write its results. ``graph``: (FM1, FM2, tokens) of the
    ``graph`` phase; ``resnet``: (image, classes, global batch) of
    ``resnet``, ``resnet_int8`` and ``feed`` on config 5; ``wires``: the
    elements a rank of the ``wires`` phase's cases at a size (0: the small
    cases); ``size``: the ``hybrid``, ``moe`` and ``pipeline`` phases' cases
    (``tiny`` or ``full``); ``tparams_path``: their starting weights (an npz
    of ``case/layer/leaf``); ``feed_model``: ``mlp`` or ``resnet``;
    ``serve_oracle``: the ``serve`` phase's oracle rule bounds on the
    leader, (float32 KV, int8 KV), or None. -> the results (also in
    ``out_dir/proc<pid>.npz``)."""
    from mlsl_tpu_torch import get_env

    init_kw = dict(device=device, world_size=WORLD)
    if port is not None:
        init_kw.update(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
                       process_id=pid, backend=backend)
    env = get_env().init(**init_kw)
    assert env.process_count() == nproc and env.process_index() == pid
    out: dict = {}
    w = Worker(env, out, log)
    w.init_kw = init_kw
    w.serve_oracle = serve_oracle
    params = None
    if params_path:
        with np.load(params_path) as z:
            params = {}
            for k in z.files:
                layer, leaf = k.split("/")
                params.setdefault(layer, {})[leaf] = z[k]
    tparams = None
    if tparams_path:
        with np.load(tparams_path) as z:
            tparams = {k: z[k] for k in z.files}
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
            elif ph in ("hybrid", "moe", "serve"):
                getattr(w, ph)(size, tparams)
            elif ph == "pipeline":
                w.pipeline(size)
            elif ph == "feed":
                w.feed(feed_model, resnet)
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
        w.env.finalize()
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
    ap.add_argument("--size", default="tiny", choices=("tiny", "full"),
                    help="the hybrid, moe and pipeline phases' cases")
    ap.add_argument("--tparams", default=None,
                    help="npz of the hybrid and moe cases' starting weights (case/layer/leaf)")
    ap.add_argument("--feed", default="mlp", choices=("mlp", "resnet"),
                    help="phase feed's model (resnet: config 5 at --resnet)")
    a = ap.parse_args(argv)
    ints = lambda v: tuple(int(x) for x in v.split(","))   # noqa: E731
    run(a.pid, a.nproc, a.port, a.device, a.out, a.params, tuple(a.phases.split(",")),
        a.backend, log=lambda m: print(m, flush=True), graph=ints(a.graph),
        resnet=ints(a.resnet), wires=a.wires, size=a.size, tparams_path=a.tparams,
        feed_model=a.feed)
    print(json.dumps({"proc": a.pid, "ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
