"""Pipeline parallelism over virtual ranks: GPipe, 1F1B and interleaved 1F1B.

Counterpart of ``mlsl_tpu.parallel.pipeline``. The JAX functions are SPMD
bodies run inside ``shard_map``, one device a stage. Here every rank's shard
lives in one tensor, as in ``parallel/sequence.py``: the leading dims of
``x_micro`` (*ranks, M, mb, d) are the virtual-rank grid (or any part of it),
and ``axis`` is the index of the rank dim that holds the stages, the model
dim of the (R, D, S, M) grid. Stage s is the coordinate along that dim. So

- ``lax.ppermute(+1)`` / ``(-1)`` between stages is ``torch.roll(±1)`` along
  ``axis``;
- ``lax.axis_index`` is the rank's coordinate along ``axis``;
- the user's ``stage_fn(params, x)`` stays a function of one stage and is
  applied to every selected rank at once with ``torch.func.vmap`` over the
  stacked stage parameters (leaves (*ranks, ...); a rank dim of size 1
  broadcasts, so weights shared over the data dim need no copy).

The schedules are static, so each tick's row selections are computed on the
host. GPipe runs every stage every tick, as JAX does (inactive stages on
what they hold, masked), and is differentiated by autograd: the roll
transposes to the opposite roll, the drain-fill backward. 1F1B runs F on the
rows whose op this tick is a forward and B on the rows whose op is a
backward, by index selection, where JAX runs one ``lax.cond`` branch a device
(ROADMAP, standing differences); the B leg recomputes the stage from its
saved input and takes ``torch.autograd.grad(y, (params, x), dy)`` over the
selected rows, each stage's own vjp since the stages are independent.

The microbatch loss sums go through ``algos.inline_allreduce`` along the
stage dim, and ``reduce_microbatch_grads`` builds the data-parallel gradient
reduction on the compiled overlap engine (kernels B3 / B5 dense, B4 + B1
int8, as the selection table routes them).

Across processes (comm/transport.py) every schedule takes ``group``, the
stage axis's ProcessGroup, and the leading dims are this process's box. A
group that spans processes leaves this process the S_l = n_stages / P
stages [off, off + S_l): the coordinates start at ``off``, the stage
boundary is the transport's ``shift`` (differentiable in GPipe, plain in
1F1B's legs), and the loss sum crosses through ``inline_allreduce`` over
the group. Every tick issues its hops on every process, whatever rows it
selects there. In a world of several processes a call without ``group``
raises: the stage dim of a box is not the pipeline's.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from mlsl_tpu_torch.comm import algos
from mlsl_tpu_torch.log import MLSLError, mlsl_assert


def _ranks(x_micro: torch.Tensor, axis: int, n_stages: int, group=None):
    """-> (rank dims, rank count, the stage group's Span or None) of a
    (*ranks, M, mb, d) microbatch tensor."""
    from mlsl_tpu_torch.comm import transport

    if group is None and transport.world().count > 1:
        raise MLSLError("the pipeline schedules in a world of several processes need "
                        "group=, the stage axis's ProcessGroup")
    span = transport.span_or_none(group)
    nr = x_micro.dim() - 3
    ranks = tuple(x_micro.shape[:nr])
    local = n_stages if span is None else span.gl
    mlsl_assert(span is None or (span.g == n_stages and nr == 4),
                "the stage group has %d members, not %d, or %s is not a box's (R, D, S, M, "
                "M, mb, d) microbatches", 0 if span is None else span.g, n_stages,
                tuple(x_micro.shape))
    mlsl_assert(0 <= axis < nr and ranks[axis] == local,
                "axis %d of %s is not a stage dim of %d ranks", axis,
                tuple(x_micro.shape), local)
    return ranks, math.prod(ranks), span


def _coords(ranks, axis: int, span=None) -> np.ndarray:
    """Each flattened rank's stage coordinate (numpy, (P,)); this process's
    stages start at ``span.off`` where the stage group spans processes."""
    shape = [1] * len(ranks)
    shape[axis] = ranks[axis]
    off = 0 if span is None else span.off
    return np.broadcast_to(np.arange(off, off + ranks[axis]).reshape(shape),
                           ranks).reshape(-1)


def _flat(tree, ranks, lead=()):
    """Leaves (*lead, *ranks, ...) (rank dims of size 1 broadcast) ->
    (*lead, P, ...)."""
    nl, nr = len(lead), len(ranks)
    return pytree.tree_map(
        lambda t: t.expand(*t.shape[:nl], *ranks, *t.shape[nl + nr:]).reshape(
            *t.shape[:nl], -1, *t.shape[nl + nr:]), tree)


def _roll(x: torch.Tensor, ranks, axis: int, shift: int, span=None) -> torch.Tensor:
    """The stage boundary: (P, ...) rolled by ``shift`` along the stage dim
    (across processes, the transport's differentiable shift)."""
    y = x.reshape(*ranks, *x.shape[1:])
    if span is None:
        return torch.roll(y, shift, axis).reshape(x.shape)
    from mlsl_tpu_torch.comm import transport

    return transport.shift(span, y, step=shift, dim=axis)[0].reshape(x.shape)


def _loss_sum(loss: torch.Tensor, axis: int, span, group) -> torch.Tensor:
    """The loss summed over the stage dim, every stage holding it."""
    return algos.inline_allreduce(loss, axis, group=group if span is not None else None)


def _device_indices(arrays: List[np.ndarray], device) -> List[torch.Tensor]:
    """Host index arrays -> device tensors, in one copy."""
    sizes = [len(a) for a in arrays]
    flat = torch.from_numpy(np.concatenate(arrays).astype(np.int64) if arrays
                            else np.zeros(0, np.int64)).to(device)
    return list(torch.split(flat, sizes))


def _check_width(y: torch.Tensor, d: int) -> None:
    mlsl_assert(y.shape[-1] == d,
                "pipeline boundary width mismatch: stage_fn maps wire width %d -> %d; pad "
                "heterogeneous stages to a common wire width (see pad_stage_weights)",
                d, y.shape[-1])


def gpipe_forward(stage_fn: Callable, stage_params, x_micro: torch.Tensor, axis: int,
                  n_stages: int, remat: bool = False, group=None) -> torch.Tensor:
    """The fill-drain forward (pipeline.py:38-105).

    stage_params: every rank's stage weights, leaves (*ranks, ...).
    x_micro: (*ranks, M, mb, d), the stage-0 input (other stages' copies are
    not read). remat: wrap the stage in ``torch.utils.checkpoint``
    (non-reentrant), so the backward recomputes stage internals instead of
    keeping every tick's activations. -> (*ranks, M, mb, d): the last stage's
    outputs, zeros elsewhere. Differentiable by autograd. ``group``: the
    stage axis's ProcessGroup (module docstring)."""
    ranks, n, span = _ranks(x_micro, axis, n_stages, group)
    m_count, mb, d = x_micro.shape[len(ranks):]
    me = _coords(ranks, axis, span)
    params = _flat(stage_params, ranks)
    xm = x_micro.reshape(n, m_count, mb, d)
    fn = vmap(stage_fn)
    if remat:
        plain_fn = fn

        def fn(p, x):
            return torch.utils.checkpoint.checkpoint(plain_fn, p, x, use_reentrant=False)

    ticks = m_count + n_stages - 1
    mb_idx = np.arange(ticks)[:, None] - me[None, :]                 # (ticks, P)
    dev = x_micro.device
    active = torch.from_numpy((mb_idx >= 0) & (mb_idx < m_count)).to(dev)
    safe = torch.from_numpy(np.clip(mb_idx, 0, m_count - 1).astype(np.int64)).to(dev)
    rows = torch.arange(n, device=dev)
    first = torch.from_numpy(me == 0).to(dev)[:, None, None]
    recv = torch.zeros((n, mb, d), dtype=x_micro.dtype, device=dev)
    ys = []
    for t in range(ticks):
        inp = torch.where(first, xm[rows, safe[t]], recv)
        y = fn(params, inp)
        _check_width(y, d)
        y = torch.where(active[t][:, None, None], y, torch.zeros_like(y))
        ys.append(y)
        recv = _roll(y, ranks, axis, 1, span)
    # the last stage banks microbatch i at tick i + S - 1
    last = torch.from_numpy(me == n_stages - 1).to(dev)[:, None, None, None]
    outs = torch.stack([ys[i + n_stages - 1] for i in range(m_count)], dim=1)
    outs = torch.where(last, outs, torch.zeros_like(outs))
    return outs.reshape(*ranks, m_count, mb, d)


def pad_stage_weights(weights, biases, boundary_dims):
    """Make heterogeneous-width stages wire-uniform by zero-padding
    (pipeline.py:108-135): each (d_in, d_out) weight into (d_wire, d_wire),
    d_wire = max(boundary_dims), so the padded lanes stay zero for an
    activation that maps 0 to 0. weights[s]: (boundary_dims[s],
    boundary_dims[s+1]); biases[s]: (boundary_dims[s+1],). -> (stacked (S,
    d_wire, d_wire), stacked (S, d_wire), d_wire), numpy, in the weights'
    dtype."""
    d_wire = max(boundary_dims)
    s_count = len(weights)
    dtype = np.asarray(weights[0]).dtype
    w_pad = np.zeros((s_count, d_wire, d_wire), dtype)
    b_pad = np.zeros((s_count, d_wire), dtype)
    for s in range(s_count):
        d_in, d_out = boundary_dims[s], boundary_dims[s + 1]
        assert weights[s].shape == (d_in, d_out), (
            f"stage {s}: weight {weights[s].shape} != ({d_in}, {d_out})"
        )
        w_pad[s, :d_in, :d_out] = weights[s]
        b_pad[s, :d_out] = biases[s]
    return w_pad, b_pad, d_wire


def f1b_schedule(n_stages: int, m_count: int) -> dict:
    """Static 1F1B schedule facts (pipeline.py:138-156): stage s runs the
    forward of microbatch i at tick 2i+s and its backward at 2i+2S-1-s."""
    S, M = n_stages, m_count
    ticks = 2 * M + 2 * S - 2
    busy = 2 * M * S  # one F + one B per (stage, microbatch)
    return {
        "ticks": ticks,
        "utilization": busy / (ticks * S),
        "bubble_fraction": 1.0 - busy / (ticks * S),
        # microbatches resident between their F and B at stage s: S - s,
        # against GPipe's M at every stage
        "peak_in_flight": [S - s for s in range(S)],
        "gpipe_peak_in_flight": [M] * S,
    }


def _backward_leg(fn, loss_head, p_sel, x_in, dy, last_rows, targets):
    """Recompute the selected stages from their saved inputs and take their
    vjp: -> (loss of the last-stage rows, parameter gradients, input
    gradient). ``last_rows`` index the rows whose dy is the loss head's
    gradient (``targets`` theirs)."""
    with torch.enable_grad():
        p = pytree.tree_map(lambda t: t.detach().requires_grad_(), p_sel)
        x = x_in.detach().requires_grad_()
        y = fn(p, x)
        lv = None
        if len(last_rows):
            yl = y[last_rows].detach().requires_grad_()
            lv = vmap(loss_head)(yl, targets)
            (gl,) = torch.autograd.grad(lv.sum(), yl)
            dy = dy.index_copy(0, last_rows, gl)
        leaves, spec = pytree.tree_flatten(p)
        grads = torch.autograd.grad(y, leaves + [x], dy)
    return lv, pytree.tree_unflatten(list(grads[:-1]), spec), grads[-1]


def one_f1b_step(stage_fn: Callable, loss_head: Callable, stage_params,
                 x_micro: torch.Tensor, y_micro: torch.Tensor, axis: int,
                 n_stages: int, group=None):
    """The 1F1B schedule (pipeline.py:159-273): (loss, stage grads) without
    O(M) activation memory. A stage keeps at most S - s boundary inputs; the
    backward leg recomputes the stage from its saved input. loss_head(y,
    target) -> scalar. -> (loss summed over the microbatches and the stage
    dim, every rank holding it (*ranks,); grads, leaves (*ranks, ...): each
    rank's own stage gradient, summed over its microbatches). ``group``: the
    stage axis's ProcessGroup (module docstring)."""
    ranks, n, span = _ranks(x_micro, axis, n_stages, group)
    m_count, mb, d = x_micro.shape[len(ranks):]
    S = n_stages
    me = _coords(ranks, axis, span)
    dev = x_micro.device
    params = pytree.tree_map(lambda t: t.detach(), _flat(stage_params, ranks))
    xm = x_micro.reshape(n, m_count, mb, d)
    ym = y_micro.reshape(n, m_count, *y_micro.shape[len(ranks) + 1:])
    fn = vmap(stage_fn)
    ticks = 2 * m_count + 2 * S - 2

    # the static schedule, on the host: F and B rows a tick
    plan, host = [], []
    for t in range(ticks):
        rel = t - me
        f_idx = rel // 2
        f_rows = np.nonzero((rel % 2 == 0) & (f_idx >= 0) & (f_idx < m_count))[0]
        b_idx = (t + me - (2 * S - 1)) // 2
        b_rows = np.nonzero((rel % 2 != 0) & (b_idx >= 0) & (b_idx < m_count))[0]
        b_last = np.nonzero(me[b_rows] == S - 1)[0]
        plan.append((len(f_rows), len(b_rows), len(b_last)))
        host += [f_rows, f_idx[f_rows], (me[f_rows] == 0).astype(np.int64),
                 b_rows, b_idx[b_rows], b_last]
    idx = _device_indices(host, dev)

    x_buf = torch.zeros((n, S, mb, d), dtype=x_micro.dtype, device=dev)
    recv_f = torch.zeros((n, mb, d), dtype=x_micro.dtype, device=dev)
    recv_b = torch.zeros_like(recv_f)
    grads = pytree.tree_map(torch.zeros_like, params)
    loss_acc = torch.zeros(n, dtype=torch.float32, device=dev)
    for t in range(ticks):
        nf, nb, nl = plan[t]
        f_rows, f_i, f_first, b_rows, b_i, b_last = idx[6 * t:6 * t + 6]
        send_f = torch.zeros_like(recv_f)
        send_b = torch.zeros_like(recv_b)
        if nf:
            inp = torch.where(f_first.bool()[:, None, None], xm[f_rows, f_i], recv_f[f_rows])
            with torch.no_grad():
                y = fn(pytree.tree_map(lambda t_: t_[f_rows], params), inp)
            _check_width(y, d)
            x_buf[f_rows, f_i % S] = inp
            send_f[f_rows] = y
        if nb:
            lv, gp, dx = _backward_leg(
                fn, loss_head, pytree.tree_map(lambda t_: t_[b_rows], params),
                x_buf[b_rows, b_i % S], recv_b[b_rows], b_last,
                ym[b_rows[b_last], b_i[b_last]] if nl else None)
            for g, dg in zip(pytree.tree_leaves(grads), pytree.tree_leaves(gp)):
                g[b_rows] += dg
            if lv is not None:
                loss_acc[b_rows[b_last]] += lv.detach().float()
            send_b[b_rows] = dx
        recv_f = _roll(send_f, ranks, axis, 1, span)
        recv_b = _roll(send_b, ranks, axis, -1, span)
    loss = _loss_sum(loss_acc.reshape(ranks), axis, span, group)
    return loss, pytree.tree_map(lambda g: g.reshape(*ranks, *g.shape[1:]), grads)


def interleaved_schedule(n_stages: int, v_chunks: int, m_count: int) -> dict:
    """Static interleaved-1F1B schedule (Megatron-style virtual stages),
    host-side (pipeline.py:276-470), copied as it is.

    The model is split into v*S stages; device d holds chunks c=0..v-1 as
    global stages k = c*S + d, so every stage->stage+1 boundary is a +1 ring
    hop and the backward boundary a -1 hop. Greedy list-scheduling of the
    dependency DAG, one op per device per tick: backward ops first, then
    forwards deepest-chunk-first. -> numpy tables (ticks, S) of each device's
    op a tick, the receiver-side staging tables, and slot counts sized so
    that no staged buffer is overwritten before it is read."""
    S, V, M = int(n_stages), int(v_chunks), int(m_count)
    assert S >= 1 and V >= 1 and M >= 1
    K_tot = V * S

    t_f = np.full((K_tot, M), -1, dtype=np.int64)
    t_b = np.full((K_tot, M), -1, dtype=np.int64)
    done_f = np.zeros((K_tot, M), dtype=bool)
    done_b = np.zeros((K_tot, M), dtype=bool)

    # Each device follows a fixed op sequence: W warm-up forwards, then strict
    # F/B alternation, then cool-down backwards; forwards walk microbatch
    # groups of S with chunks ascending, backwards the same groups with chunks
    # descending. A device whose next op is not ready idles that tick.
    def _group_order(desc):
        order = []
        for g in range(0, M, S):
            span = range(g, min(g + S, M))
            chunks = range(V - 1, -1, -1) if desc else range(V)
            for c in chunks:
                order.extend((c, i) for i in span)
        return order

    n_ops = V * M
    seqs = []
    for d in range(S):
        if V == 1:
            warm = min(S - d - 1, n_ops)
        else:
            warm = min((S - d - 1) * 2 + (V - 1) * S, n_ops)
        f_seq = _group_order(desc=False)
        b_seq = _group_order(desc=True)
        kinds = ["F"] * warm
        for _ in range(n_ops - warm):
            kinds += ["F", "B"]
        kinds += ["B"] * warm
        fi = bi = 0
        seq = []
        for kind in kinds:
            if kind == "F":
                c, i = f_seq[fi]
                fi += 1
            else:
                c, i = b_seq[bi]
                bi += 1
            seq.append((kind, c * S + d, i))
        seqs.append(seq)

    def _f_ready(k, i, t):
        # the upstream forward must have completed on an EARLIER tick (the
        # boundary rides a one-tick hop)
        return not done_f[k, i] and (
            k == 0 or (done_f[k - 1, i] and t_f[k - 1, i] < t)
        )

    def _b_ready(k, i, t):
        return (
            not done_b[k, i]
            and done_f[k, i]
            and t_f[k, i] < t
            and (k == K_tot - 1 or (done_b[k + 1, i] and t_b[k + 1, i] < t))
        )

    def _do(kind, k, i, t):
        if kind == "F":
            t_f[k, i] = t
            done_f[k, i] = True
        else:
            t_b[k, i] = t
            done_b[k, i] = True

    pos = [0] * S
    remaining = 2 * K_tot * M
    t = 0
    no_progress = 0
    while remaining > 0:
        progressed = False
        for d in range(S):
            if pos[d] >= len(seqs[d]):
                continue
            kind, k, i = seqs[d][pos[d]]
            ready = _f_ready(k, i, t) if kind == "F" else _b_ready(k, i, t)
            if ready:
                _do(kind, k, i, t)
                pos[d] += 1
                remaining -= 1
                progressed = True
        t += 1
        # relief valve: two all-idle sweeps mean the fixed sequences
        # deadlocked (irregular M vs S); schedule ANY ready op once
        no_progress = 0 if progressed else no_progress + 1
        if no_progress >= 2:
            for d in range(S):
                pick = None
                for kk in range(d, K_tot, S):
                    for i in range(M):
                        if _f_ready(kk, i, t):
                            pick = ("F", kk, i)
                            break
                        if _b_ready(kk, i, t):
                            pick = ("B", kk, i)
                            break
                    if pick:
                        break
                if pick:
                    _do(*pick, t)
                    remaining -= 1
                    seqs[d].remove(pick)
            t += 1
            no_progress = 0
    ticks = t

    # minimal slot counts so that slot reuse never clobbers live data
    def _min_slots(write_t, read_t):
        # writing slot i%K at write_t[i+K] must not precede the read at read_t[i]
        for K in range(1, M + 1):
            ok = True
            for k in range(write_t.shape[0]):
                for i in range(M - K):
                    if write_t[k, i + K] < read_t[k, i]:
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                return K
        return M

    # forward staging at stage k (k>0): stored at the end of t_f[k-1, i], read at t_f[k, i]
    k_f = _min_slots(t_f[:-1], t_f[1:]) if K_tot > 1 else 1
    # backward staging at stage k (k<last): stored at the end of t_b[k+1, i], read at t_b[k, i]
    k_b = _min_slots(t_b[1:], t_b[:-1]) if K_tot > 1 else 1
    # saved inputs at stage k: written during t_f[k, i], read at t_b[k, i]
    k_s = _min_slots(t_f, t_b)

    kind_t = np.zeros((ticks, S), np.int32)          # 0 idle, 1 F, 2 B
    chunk_t = np.zeros((ticks, S), np.int32)
    micro_t = np.zeros((ticks, S), np.int32)
    first_t = np.zeros((ticks, S), np.int32)         # F reads x_micro (k == 0)
    last_t = np.zeros((ticks, S), np.int32)          # B computes the loss grad (k == last)
    fstore_valid = np.zeros((ticks, S), np.int32)
    fstore_idx = np.zeros((ticks, S), np.int32)      # chunk*k_f + slot at the receiver
    bstore_valid = np.zeros((ticks, S), np.int32)
    bstore_idx = np.zeros((ticks, S), np.int32)
    for k in range(K_tot):
        d, c = k % S, k // S
        for i in range(M):
            tf = t_f[k, i]
            kind_t[tf, d], chunk_t[tf, d], micro_t[tf, d] = 1, c, i
            first_t[tf, d] = int(k == 0)
            if k + 1 < K_tot:
                d2, c2 = (k + 1) % S, (k + 1) // S
                fstore_valid[tf, d2] = 1
                fstore_idx[tf, d2] = c2 * k_f + i % k_f
            tb = t_b[k, i]
            kind_t[tb, d], chunk_t[tb, d], micro_t[tb, d] = 2, c, i
            last_t[tb, d] = int(k == K_tot - 1)
            if k > 0:
                d2, c2 = (k - 1) % S, (k - 1) // S
                bstore_valid[tb, d2] = 1
                bstore_idx[tb, d2] = c2 * k_b + i % k_b
    busy = 2 * K_tot * M
    return {
        "tables": {
            "kind": kind_t, "chunk": chunk_t, "micro": micro_t,
            "first": first_t, "last": last_t,
            "fstore_valid": fstore_valid, "fstore_idx": fstore_idx,
            "bstore_valid": bstore_valid, "bstore_idx": bstore_idx,
        },
        "k_f": k_f, "k_b": k_b, "k_s": k_s,
        "ticks": ticks,
        "utilization": busy / (ticks * S),
        "bubble_fraction": 1.0 - busy / (ticks * S),
        "t_f": t_f, "t_b": t_b,
    }


def interleaved_1f1b_step(stage_fn: Callable, loss_head: Callable, chunk_params,
                          x_micro: torch.Tensor, y_micro: torch.Tensor, axis: int,
                          n_stages: int, v_chunks: int, group=None):
    """Interleaved (virtual-stage) 1F1B (pipeline.py:473-608): (loss, chunk
    grads). chunk_params: leaves (V, *ranks, ...); chunk c of the rank at
    stage coordinate d is global stage c*S + d (reshape a (V*S, ...)-stacked
    model to (V, S, ...)). The schedule's tables (``interleaved_schedule``)
    give each rank its op a tick: a forward of one chunk (F rows) or an
    explicit-remat vjp (B rows), with the bubble cut about V-fold. -> (loss
    (*ranks,), grads with the leaves' layout (V, *ranks, ...)). ``group``: the
    stage axis's ProcessGroup (module docstring)."""
    ranks, n, span = _ranks(x_micro, axis, n_stages, group)
    m_count, mb, d = x_micro.shape[len(ranks):]
    S, V = int(n_stages), int(v_chunks)
    sched = interleaved_schedule(S, V, m_count)
    tb = sched["tables"]
    k_f, k_b, k_s = sched["k_f"], sched["k_b"], sched["k_s"]
    me = _coords(ranks, axis, span)
    dev = x_micro.device
    params = pytree.tree_map(lambda t: t.detach(), _flat(chunk_params, ranks, lead=(V,)))
    xm = x_micro.reshape(n, m_count, mb, d)
    ym = y_micro.reshape(n, m_count, *y_micro.shape[len(ranks) + 1:])
    fn = vmap(stage_fn)

    plan, host = [], []
    for t in range(sched["ticks"]):
        kind, c, i = tb["kind"][t, me], tb["chunk"][t, me], tb["micro"][t, me]
        f_rows = np.nonzero(kind == 1)[0]
        b_rows = np.nonzero(kind == 2)[0]
        b_last = np.nonzero(tb["last"][t, me[b_rows]] == 1)[0]
        fs_rows = np.nonzero(tb["fstore_valid"][t, me] == 1)[0]
        bs_rows = np.nonzero(tb["bstore_valid"][t, me] == 1)[0]
        plan.append((len(f_rows), len(b_rows), len(b_last), len(fs_rows), len(bs_rows)))
        host += [f_rows, c[f_rows], i[f_rows], tb["first"][t, me[f_rows]],
                 b_rows, c[b_rows], i[b_rows], b_last,
                 fs_rows, tb["fstore_idx"][t, me[fs_rows]],
                 bs_rows, tb["bstore_idx"][t, me[bs_rows]]]
    idx = _device_indices(host, dev)

    dt = x_micro.dtype
    fwd_in = torch.zeros((n, V * k_f, mb, d), dtype=dt, device=dev)
    bwd_in = torch.zeros((n, V * k_b, mb, d), dtype=dt, device=dev)
    x_saved = torch.zeros((n, V * k_s, mb, d), dtype=dt, device=dev)
    grads = pytree.tree_map(torch.zeros_like, params)
    loss_acc = torch.zeros(n, dtype=torch.float32, device=dev)
    for t in range(sched["ticks"]):
        nf, nb, nl, nfs, nbs = plan[t]
        (f_rows, f_c, f_i, f_first, b_rows, b_c, b_i, b_last,
         fs_rows, fs_idx, bs_rows, bs_idx) = idx[12 * t:12 * t + 12]
        send_f = torch.zeros((n, mb, d), dtype=dt, device=dev)
        send_b = torch.zeros_like(send_f)
        if nf:
            inp = torch.where(f_first.bool()[:, None, None], xm[f_rows, f_i],
                              fwd_in[f_rows, f_c * k_f + f_i % k_f])
            with torch.no_grad():
                y = fn(pytree.tree_map(lambda t_: t_[f_c, f_rows], params), inp)
            _check_width(y, d)
            x_saved[f_rows, f_c * k_s + f_i % k_s] = inp
            send_f[f_rows] = y
        if nb:
            lv, gp, dx = _backward_leg(
                fn, loss_head, pytree.tree_map(lambda t_: t_[b_c, b_rows], params),
                x_saved[b_rows, b_c * k_s + b_i % k_s],
                bwd_in[b_rows, b_c * k_b + b_i % k_b], b_last,
                ym[b_rows[b_last], b_i[b_last]] if nl else None)
            for g, dg in zip(pytree.tree_leaves(grads), pytree.tree_leaves(gp)):
                g[b_c, b_rows] += dg
            if lv is not None:
                loss_acc[b_rows[b_last]] += lv.detach().float()
            send_b[b_rows] = dx
        recv_f = _roll(send_f, ranks, axis, 1, span)
        recv_b = _roll(send_b, ranks, axis, -1, span)
        if nfs:
            fwd_in[fs_rows, fs_idx] = recv_f[fs_rows]
        if nbs:
            bwd_in[bs_rows, bs_idx] = recv_b[bs_rows]
    loss = _loss_sum(loss_acc.reshape(ranks), axis, span, group)
    return loss, pytree.tree_map(lambda g: g.reshape(V, *ranks, *g.shape[2:]), grads)


def pipeline_loss(stage_fn: Callable, loss_head: Callable, stage_params,
                  x_micro: torch.Tensor, y_micro: torch.Tensor, axis: int,
                  n_stages: int, remat: bool = False, group=None) -> torch.Tensor:
    """The GPipe forward and the loss on the last stage, summed over the
    stage dim so that every stage holds it (pipeline.py:611-627): -> (*ranks,),
    ready for ``torch.autograd`` (the backward replays the schedule in
    reverse). ``group``: the stage axis's ProcessGroup (module docstring)."""
    ranks, n, span = _ranks(x_micro, axis, n_stages, group)
    outs = gpipe_forward(stage_fn, stage_params, x_micro, axis, n_stages, remat=remat,
                         group=group)
    m_count = outs.shape[len(ranks)]
    per_micro = vmap(vmap(loss_head))(
        outs.reshape(n, m_count, *outs.shape[len(ranks) + 1:]),
        y_micro.reshape(n, m_count, *y_micro.shape[len(ranks) + 1:]))      # (P, M)
    last = torch.from_numpy(_coords(ranks, axis, span) == n_stages - 1).to(outs.device)
    local = torch.where(last, per_micro.sum(dim=1), torch.zeros_like(per_micro[:, 0]))
    return _loss_sum(local.reshape(ranks), axis, span, group)


def reduce_microbatch_grads(group, counts: Sequence[int], *, config=None, compression=None,
                            algo=None, stages=None, block=None):
    """The data-parallel reduction of the stage gradients on the compiled
    overlap engine (pipeline.py:630-666): -> (fn, plan) from
    ``comm.overlap.build_multi_reduce``. The selection table applies per
    tensor (B3 / B5 dense as ``MLSL_ALGO`` routes them, the int8 ring B4 + B1
    with ``compression=QUANTIZATION``), emission is staged newest-first and
    error-feedback residuals ride the returned state. ``fn`` takes the
    flattened per-stage gradients as (R, D, S, M, count) buffers."""
    from mlsl_tpu_torch.comm import overlap
    from mlsl_tpu_torch.types import CompressionType

    kw = {}
    if stages is not None:
        kw["stages"] = stages
    if block is not None:
        kw["block"] = block
    return overlap.build_multi_reduce(
        group, list(counts),
        compression=compression if compression is not None else CompressionType.NONE,
        algo=algo, config=config, **kw,
    )
