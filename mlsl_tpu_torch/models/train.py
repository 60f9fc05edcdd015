"""MLSL-driven data-parallel training: the Session/Operation graph in the loop.

Counterpart of the per-layer Start/Wait path of ``mlsl_tpu.models.train``
(BASELINE config 5, reference loop tests/examples/mlsl_test/mlsl_test.cpp:660-698):

- every virtual data rank computes its OWN gradient on its own local batch
  (``_local_grads``, the one local-gradient core of every path) --
  one forward/backward per rank, batch norm taking statistics on the rank's
  shard. The ranks' losses are never summed into one autograd graph: that
  would compute the allreduce inside autograd and bypass the collective and
  its codec;
- each layer is an Operation whose ParameterSet carries the gradient
  collective; StartGradientComm is issued per layer in reverse (backprop)
  order, then every layer is waited and updated: with the built-in SGD
  (p -= lr * sum_grad / data_ranks) or an elementwise optimizer
  (``mlsl_tpu_torch.optim``), optionally after clipping the mean gradient
  to a global L2 norm;
- with ``distributed_update`` (ZeRO-1) the gradient is reduce-scattered,
  each rank updates only its owned shard -- the optimizer state lives only
  there, (R, D, S, M, owned) -- and StartIncrementComm all-gathers the
  increments (train.py:1181-1232). The global norm for clipping is then
  assembled from the owned shards' partial sums over the gradient group;
- with ``overlap_updates`` the layers are polled with TestGradientComm and
  each is updated the moment its collective lands (train.py:1140-1168, the
  reference's canonical loop);
- ``ShardedAdafactor`` runs on both update paths: replicated, as a tree
  transform that sees each layer's leaves and parameters (the JAX trainer
  hands optax the whole tree); under ZeRO-1 as the cross-shard form of
  ``optim`` whose factored statistics are assembled from the owned shards
  (train.py:495-515, 1210-1225);
- with ``overlap_compiled`` (or ``MLSL_OVERLAP_COMPILED=1``) the compiled
  overlap engine (comm/overlap.py) runs the whole step -- local backward,
  every layer's gradient collective staged newest-first, the per-layer
  update -- captured as one CUDA graph on the card and replayed each step.

Gradients cross into the framework as distributed buffers (R, D, S, M, count)
whose rows are the per-rank flat layer gradients, in the JAX package's
element order (see convert.py), zero-padded to the parameter set's local
count. When Commit shows that no parameter set communicates (one data rank),
the step is fused: one forward/backward and the update, no requests --
unless ``force_graph_path`` asks for the graph. ``step_accum`` sums the
gradients of several micro-batches before one sync.

The trainer's hooks (train.py:345-395, 908-1035, 1107-1127): the integrity
sentinel (``self.sentinel``, armed by ``MLSL_SENTINEL_GATE`` /
``MLSL_SENTINEL_EVERY``) screens each step's per-rank loss and gradients
between the gradient computation and any comm (``_screen``); ``skip_step``
returns the loss with no comm started, so error-feedback residuals and the
data order stay as if the step never ran. An armed gate turns the fused
step off, and the compiled engine takes its split program (the gradients on
the host path, the comm and update as the engine's own graph). At step entry
the ``train.params`` / ``train.opt_state`` chaos sites apply ``silent``
plans (``sentinel.corrupt_silent``), and ``train.grads`` before the gate.
The straggler sentinel (``self.straggler``, ``MLSL_STRAGGLER_SKEW``) and the
metrics registry (``MLSL_METRICS``) take the step's wall time, and on the
registry's cadence the loss, the gradient norm, the input stall and every
counter family; with neither armed ``step`` adds nothing and no sync.
``sentinel.maybe_audit(trainer, step)`` audits ``_audit_state()``; the
fault-tolerant loop (``resilience.FaultTolerantLoop``) calls it each step.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mlsl_tpu_torch import chaos, optim
from mlsl_tpu_torch import sentinel as sentinel_mod
from mlsl_tpu_torch.comm import collectives
from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.obs import metrics as obs_metrics
from mlsl_tpu_torch.obs import straggler as obs_straggler
from mlsl_tpu_torch.models.convert import tree_leaves
from mlsl_tpu_torch.types import CompressionType, DataType, OpType


def clip_scale(sq_norm: torch.Tensor, clip: float) -> torch.Tensor:
    """The factor of an L2 clip, min(1, clip / norm) (train.py:110)."""
    return torch.clamp(clip / torch.clamp(torch.sqrt(sq_norm), min=1e-12), max=1.0)


def member_sum(parts: torch.Tensor) -> torch.Tensor:
    """(..., G) -> (...): the G entries added one by one in member order, the
    same bits on every device (a collective's SUM orders its terms as the
    device's reduction does)."""
    total = parts[..., 0]
    for j in range(1, parts.shape[-1]):
        total = total + parts[..., j]
    return total


def sharded_sq_norm(grads: Dict[str, torch.Tensor], data: int) -> torch.Tensor:
    """The squared global L2 norm of {layer: (count,) mean gradient}, summed
    in the order the distributed update sums it: each layer's partial sums
    over its ``data`` owned shards (ceil(count / data) elements, the last
    zero-padded), layers in sorted order, then the shards in member order
    (``member_sum``). Replicated and ZeRO-1 training then clip by the same
    bits, where sums in two orders would differ by an ulp that three steps
    of a deep net grow."""
    parts = 0
    for name in sorted(grads):
        g = grads[name]
        owned = -(-g.numel() // data)
        g = torch.nn.functional.pad(g, (0, owned * data - g.numel()))
        parts = parts + (g.reshape(data, owned) ** 2).sum(dim=-1)
    return member_sum(parts)


def owned_increment(g: torch.Tensor, lr: float, norm: float, scale=1.0) -> torch.Tensor:
    """Owned-shard SGD increment -lr * s * g / norm (train.py:52)."""
    return -lr * scale * g / norm


def owned_opt_increment(g: torch.Tensor, state, optimizer, norm: float, scale=1.0):
    """Owned-shard optimizer increment: the transform on s * g / norm, every
    rank's shard at once (train.py:132). -> (increment, new state)."""
    return optimizer.update(scale * g / norm, state)



class DataParallelTrainer:
    """Trains ``model`` with per-layer MLSL gradient sync.

    model contract: an ``nn.Module``; ``loss_fn(model, (x, y)) -> scalar``;
    ``layers``: ordered layer names; ``get_layer(model, name)`` -> the layer's
    parameter subtree (its leaves, in JAX order, are the Operation's kernels).
    The trainer updates the model's parameters in place."""

    def __init__(
        self,
        env,
        dist,
        session,
        model: torch.nn.Module,
        loss_fn: Callable,
        layers: List[str],
        get_layer: Callable,
        distributed_update: bool = False,
        compression: CompressionType = CompressionType.NONE,
        lr: float = 0.05,
        force_graph_path: bool = False,
        optimizer=None,
        clip_global_norm: Optional[float] = None,
        overlap_updates: bool = False,
        overlap_compiled: Optional[bool] = None,
    ):
        """optimizer: a transform of ``mlsl_tpu_torch.optim`` (``adam``,
        ``sgd``, a ``chain``, a ``TreeTransform`` such as ``adamw`` or
        ``adafactor``) or a ``ShardedAdafactor``; None keeps the built-in SGD
        (p - lr * mean_grad). A tree transform runs once a layer on its
        leaves (state ``opt_state[layer]``), a whole-tree one
        (``clip_by_global_norm``) once a step over every layer's leaves
        (state ``tree_state``); leaves outside ``layers`` are never touched. With ``distributed_update`` the optimizer state lives only
        on each rank's owned gradient shard (ZeRO-1), so only elementwise
        transforms are correct there, as in the JAX package, and
        ``ShardedAdafactor``, whose factored statistics are assembled across
        the shards (a tree transform raises there). ``clip_global_norm`` clips the
        mean gradient to this global L2 norm before the optimizer, on every
        path (``overlap_updates`` aside, which updates each layer with the
        built-in SGD as in the JAX package).

        overlap_updates: poll every layer's request with TestGradientComm and
        update it as soon as it lands, not after every wait. Built-in SGD
        only; not with ``distributed_update``.

        overlap_compiled: arm the compiled overlap engine (comm/overlap.py;
        None = ``MLSL_OVERLAP_COMPILED``). Built-in SGD only, and not with
        ``distributed_update`` or ``overlap_updates``: each raises when
        asked for explicitly, and the environment's knob skips such trainers
        quietly. A grid without communication keeps the fused step; a TOPK,
        custom-codec or color-group graph rides the host path."""
        self.env = env
        self.dist = dist
        self.session = session
        self.model = model
        self.loss_fn = loss_fn
        self.layers = list(layers)
        self.get_layer = get_layer
        self.lr = lr
        self.optimizer = optimizer
        # ShardedAdafactor is a config: the replicated path runs its tree
        # transform, ZeRO-1 the cross-shard form (train.py:273-290)
        self._af_cfg = optimizer if isinstance(optimizer, optim.ShardedAdafactor) else None
        self._tree_opt = (optimizer.as_transform() if self._af_cfg is not None
                          else optimizer if isinstance(optimizer, optim.TreeTransform) else None)
        self.clip_global_norm = clip_global_norm
        mlsl_assert(optimizer is None or not overlap_updates,
                    "overlap_updates is not supported with an optimizer (per-layer state "
                    "slicing would impose its own schedule)")
        mlsl_assert(
            dist.get_process_count_model() == 1
            and dist.replica_count == 1
            and dist.get_seq_parts() == 1,
            "DataParallelTrainer requires model=seq=1 and replica_count == 1 "
            "(got model=%d, seq=%d, replicas=%d)",
            dist.get_process_count_model(), dist.get_seq_parts(), dist.replica_count,
        )
        self.data_size = dist.get_process_count_data()
        self.device = env.device
        # the layers' parameters, each list in JAX leaf order
        self.layer_params: Dict[str, List[torch.nn.Parameter]] = {
            name: tree_leaves(get_layer(model, name)) for name in self.layers
        }
        for name, ps in self.layer_params.items():
            for p in ps:
                mlsl_assert(p.device == self.device,
                            "layer %s has a parameter on %s, the environment runs on %s",
                            name, p.device, self.device)

        # one Operation per layer (reference per-layer Caffe graph)
        self.ops = {}
        self.layer_counts = {}
        for name in self.layers:
            count = sum(p.numel() for p in self.layer_params[name])
            self.layer_counts[name] = count
            reg = session.create_operation_reg_info(OpType.CC)
            reg.set_name(name)
            reg.add_input(1, 1)
            reg.add_output(1, 1)
            reg.add_parameter_set(count, 1, DataType.FLOAT,
                                  distributed_update=distributed_update,
                                  compression_type=compression)
            self.ops[name] = session.get_operation(session.add_operation(reg, dist))
        session.commit()
        # the distributed update pads the local count so that every data rank
        # owns an equal shard (reference src/mlsl_impl.cpp:403-405)
        self.padded_counts = {name: self._pset(name).get_local_kernel_count()
                              for name in self.layers}
        needs_comm = any(self._pset(n).need_comm for n in self.layers)
        self._needs_comm = needs_comm
        self.distributed_update = distributed_update
        cfg = env.config
        # the integrity sentinel and the straggler sentinel, armed from the
        # Config (MLSL_SENTINEL_*, MLSL_STRAGGLER_*; train.py:345-376)
        self.sentinel = None
        self.straggler = None
        if cfg is not None:
            if sentinel_mod.armed(cfg):
                self.sentinel = sentinel_mod.Sentinel.from_config(
                    cfg, dist.topology.local_shape)
            if obs_straggler.armed(cfg):
                self.straggler = obs_straggler.StragglerSentinel(
                    skew=cfg.straggler_skew, every=cfg.straggler_every,
                    sustain=cfg.straggler_sustain, shed=cfg.straggler_shed)
        # the pod rank with a control plane armed, else this process's index
        # (the JAX package's jax.process_index(), train.py:380)
        from mlsl_tpu_torch import control
        from mlsl_tpu_torch.comm import transport

        self._replica_id = control.replica_id(transport.world().index)
        self._stall_ms_seen = 0.0   # the FEED stall total at the last sample
        # fuse the whole step when no parameter set communicates
        # (train.py:388-391); an armed gate screens at the gradient boundary,
        # which the fused step does not expose
        self.fused = (not needs_comm and not force_graph_path
                      and not (self.sentinel is not None and self.sentinel.gate_armed))
        # optimizer state: per layer over each rank's owned shard under ZeRO-1,
        # else one replicated state per layer's flat parameter vector
        self.opt_state: Dict[str, object] = {}
        # a whole-tree transform (clip_by_global_norm, a chain holding it)
        # keeps one state over every layer's leaves, in layer order
        self.tree_state = None
        self._af_inc: Dict[str, Callable] = {}
        if optimizer is not None:
            grid = dist.topology.local_shape
            zero1 = distributed_update and needs_comm
            mlsl_assert(not (zero1 and self._tree_opt is not None and self._af_cfg is None),
                        "a tree transform needs whole leaves (and adamw the parameters); "
                        "under distributed_update each rank holds a flat owned shard (use "
                        "ShardedAdafactor, an elementwise transform or a chain of them, and "
                        "clip_global_norm= for a global-norm clip)")
            if self._tree_opt is not None and self._tree_opt.whole_tree:
                self.tree_state = self._tree_opt.init(
                    [p for n in self.layers for p in self.layer_params[n]], device=self.device)
            for name in self.layers if self.tree_state is None else ():
                if zero1 and self._af_cfg is not None:
                    # the layer's index layout and its owned-shard state
                    # (train.py:495-515)
                    layout = optim.build_adafactor_layout(
                        [tuple(p.shape) for p in self.layer_params[name]],
                        self.padded_counts[name], self.data_size,
                        self._af_cfg.min_dim_size_to_factor)
                    self.opt_state[name] = optim.init_adafactor_state(
                        dist.topology, layout, self._af_cfg, self.data_size, self.device)
                    self._af_inc[name] = optim.build_adafactor_inc_fn(
                        dist.topology, self._af_cfg, layout, self.data_size, self.device)
                elif zero1:
                    # one state over every rank's owned shard (train.py:115)
                    self.opt_state[name] = optimizer.init(
                        (*grid, self._pset(name).get_owned_kernel_count()), device=self.device)
                elif self._tree_opt is not None:
                    self.opt_state[name] = self._tree_opt.init(self.layer_params[name],
                                                               device=self.device)
                else:
                    self.opt_state[name] = optimizer.init(self.layer_counts[name],
                                                          device=self.device)
        mlsl_assert(not (overlap_updates and distributed_update),
                    "overlap_updates is not supported together with distributed_update "
                    "(the increment all-gather imposes its own schedule)")
        self.overlap_updates = overlap_updates
        # the compiled overlap engine (train.py:455-488): asked for explicitly
        # alongside a mode with its own schedule it raises; armed by the
        # environment it skips such trainers
        if overlap_compiled:
            mlsl_assert(optimizer is None,
                        "overlap_compiled is not supported with an optimizer (per-layer "
                        "fused updates would impose their own state slicing)")
            mlsl_assert(not distributed_update,
                        "overlap_compiled is not supported with distributed_update (the "
                        "increment all-gather imposes its own schedule)")
            mlsl_assert(not overlap_updates,
                        "overlap_compiled replaces overlap_updates (the schedule lives in "
                        "the compiled step, not the host poll loop)")
        want = (overlap_compiled if overlap_compiled is not None
                else bool(cfg is not None and cfg.overlap_compiled))
        self._overlap = None
        if (want and optimizer is None and not distributed_update and not overlap_updates
                and not self.fused):
            from mlsl_tpu_torch.comm import overlap

            # None where the graph rides the host path (TOPK, codec, colors)
            self._overlap = overlap.engine_for_trainer(self, cfg)
        self._step_no = 0

    def _pset(self, name: str):
        return self.ops[name].get_parameter_set(0)

    # -- data placement ----------------------------------------------------

    def shard_batch(self, x: np.ndarray, y: np.ndarray):
        """Global batch (B, ...) -> distributed buffers (R, D, S, M, localB, ...):
        this process's box of them, the rows of its data ranks."""
        topo = self.dist.topology
        r, d = topo.grid_shape[:2]
        local_b = x.shape[0] // (r * d)
        r0, d0 = topo.local_origin[:2]
        rl, dl = topo.local_shape[:2]
        lo = (r0 * d + d0) * local_b
        return self._place(x[lo:lo + rl * dl * local_b], y[lo:lo + rl * dl * local_b])

    def _place(self, x: np.ndarray, y: np.ndarray):
        """This process's contiguous rows of the global batch -> its box."""
        rl, dl, sl, ml = self.dist.topology.local_shape
        local_b = x.shape[0] // (rl * dl)

        def place(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            return t.reshape(rl, dl, 1, 1, local_b, *a.shape[1:]).expand(
                rl, dl, sl, ml, local_b, *a.shape[1:]
            )

        return place(x), place(y)

    def shard_batch_local(self, x: np.ndarray, y: np.ndarray):
        """Multi-process batch placement (train.py:854-882): x/y are THIS
        process's contiguous rows of the global batch (global batch /
        process count rows); no process holds the whole batch. The data-rank
        count must split over the processes with replica-major contiguity,
        the JAX package's check."""
        topo = self.dist.topology
        r, d = topo.grid_shape[:2]
        nproc = topo.num_procs
        mlsl_assert((r * d) % nproc == 0 and (r == 1 or r % nproc == 0),
                    "data ranks (r=%d x d=%d) must split contiguously over %d processes",
                    r, d, nproc)
        return self._place(x, y)

    def feed(self, source, *, depth: Optional[int] = None, **kw):
        """The wire-compressed prefetching device feed for this trainer's
        topology (train.py:884-908): an :class:`mlsl_tpu_torch.data.AsyncLoader`
        over a :class:`mlsl_tpu_torch.data.DeviceFeed` whose decoded batches
        are the distributed buffers :meth:`shard_batch` gives, so ``step``
        takes them unchanged. Defaults come from the environment's Config
        (``MLSL_FEED_*``, the int8 block from ``MLSL_QUANT_BLOCK_ELEMS``) and
        the trainer's device; any DeviceFeed keyword (wire, cache_mb, epochs,
        shuffle_seed, normalize, augment, ...) overrides them. ``close()`` the
        returned loader."""
        from mlsl_tpu_torch.data import AsyncLoader, DeviceFeed

        cfg = self.env.config
        kw.setdefault("wire", cfg.feed_wire_dtype if cfg else None)
        kw.setdefault("cache_mb", cfg.feed_cache_mb if cfg else None)
        kw.setdefault("retries", cfg.feed_retries if cfg else None)
        kw.setdefault("quant_block", cfg.quant_block_elems if cfg else None)
        kw.setdefault("device", self.device)
        if depth is None:
            depth = cfg.feed_depth if cfg else None
        return AsyncLoader(DeviceFeed(source, self.dist.topology, **kw), depth=depth)

    # -- the training step -------------------------------------------------

    def _all_params(self) -> List[torch.nn.Parameter]:
        return [p for name in self.layers for p in self.layer_params[name]]

    def _local_grads(self, batch):
        """Per-rank loss and flat per-layer gradients as distributed buffers:
        -> (loss (R, D, S, M, 1), {layer: (R, D, S, M, padded count)})."""
        x, y = batch
        topo = self.dist.topology
        grid = topo.local_shape
        params = self._all_params()
        losses = torch.empty((*grid, 1), dtype=torch.float32, device=self.device)
        grads = {}
        for name in self.layers:
            count, padded = self.layer_counts[name], self.padded_counts[name]
            alloc = torch.zeros if padded > count else torch.empty
            grads[name] = alloc((*grid, padded), dtype=torch.float32, device=self.device)
        for p in topo.local_ranks():
            c = topo.local_coords(p)
            loss = self.loss_fn(self.model, (x[c], y[c]))
            gs = iter(torch.autograd.grad(loss, params))
            losses[c] = loss.detach()
            for name in self.layers:
                row, off = grads[name][c], 0
                for prm in self.layer_params[name]:
                    row[off:off + prm.numel()] = next(gs).reshape(-1)
                    off += prm.numel()
        return losses, grads

    @torch.no_grad()
    def _add_flat(self, name: str, flat: torch.Tensor) -> None:
        """p += flat over one layer's flat (count,) vector."""
        off = 0
        for p in self.layer_params[name]:
            n = p.numel()
            p.add_(flat[off:off + n].view_as(p))
            off += n

    @torch.no_grad()
    def _sgd_layer(self, name: str, reduced: torch.Tensor) -> None:
        """The built-in SGD of one layer from its reduced (padded count,)
        gradient sum: p -= lr * sum / data ranks (train.py:694-712), the
        per-layer update of ``overlap_updates`` and the compiled engine."""
        self._add_flat(name, -self.lr * (reduced[:self.layer_counts[name]] / self.data_size))

    @torch.no_grad()
    def _replicated_update(self, flat: Dict[str, torch.Tensor], norm: float) -> None:
        """The update from every layer's reduced (count,) gradient, divided by
        ``norm``: clip, then SGD or the optimizer (train.py:543-638, and the
        fused step's :713-755 with norm 1)."""
        grads = {n: flat[n][:self.layer_counts[n]] / norm for n in self.layers}
        if self.clip_global_norm is not None:
            sq = sharded_sq_norm(grads, self.data_size)
            cscale = clip_scale(torch.sqrt(sq) ** 2, self.clip_global_norm)
            grads = {n: g * cscale for n, g in grads.items()}
        if self.tree_state is not None:
            # one call over every layer's leaves (train.py:600-616 hands optax
            # the whole tree), then each layer's share of the updates
            leaves = [p for n in self.layers for p in self.layer_params[n]]
            parts = [g.view_as(p) for n in self.layers for g, p in zip(
                torch.split(grads[n], [p.numel() for p in self.layer_params[n]]),
                self.layer_params[n])]
            upd, self.tree_state = self._tree_opt.update(parts, self.tree_state,
                                                         [p.detach() for p in leaves])
            i = 0
            for name in self.layers:
                k = len(self.layer_params[name])
                self._add_flat(name, torch.cat([u.reshape(-1) for u in upd[i:i + k]]))
                i += k
            return
        for name in self.layers:
            if self.optimizer is None:
                self._add_flat(name, -self.lr * grads[name])
            elif self._tree_opt is not None:
                # the transform sees the layer's leaves and its parameters
                # (train.py:600-616 hands optax the tree)
                leaves = self.layer_params[name]
                parts = torch.split(grads[name], [p.numel() for p in leaves])
                upd, self.opt_state[name] = self._tree_opt.update(
                    [g.view_as(p) for g, p in zip(parts, leaves)], self.opt_state[name],
                    [p.detach() for p in leaves])
                self._add_flat(name, torch.cat([u.reshape(-1) for u in upd]))
            else:
                upd, self.opt_state[name] = self.optimizer.update(grads[name],
                                                                  self.opt_state[name])
                self._add_flat(name, upd)

    # -- the silent-corruption sites and the quality gate ------------------

    def _gate_armed(self) -> bool:
        return self.sentinel is not None and self.sentinel.gate_armed

    def _chaos_state_sites(self) -> None:
        """The ``train.params`` / ``train.opt_state`` sites at step entry
        (train.py:910-935): a fired ``silent`` plan corrupts one element of
        the live state without raising. The parameters are the one copy every
        virtual rank reads; ZeRO-1's owned state is per rank, so one rank's
        shard of one layer is hit."""
        p = chaos.inject("train.params", step=self._step_no)
        if p is not None and p.kind == "silent":
            sentinel_mod.corrupt_silent(self._all_params(), p)
        if self.opt_state or self.tree_state is not None:
            # consulted only with state to corrupt: a plan's budget is never
            # spent on a stateless SGD trainer
            p = chaos.inject("train.opt_state", step=self._step_no)
            if p is not None and p.kind == "silent":
                if self.distributed_update and self._needs_comm:
                    name = sorted(self.opt_state)[chaos._rng.randrange(len(self.opt_state))]
                    sentinel_mod.corrupt_silent(self.opt_state[name], p,
                                                self.dist.topology.local_shape)
                else:
                    sentinel_mod.corrupt_silent((self.opt_state, self.tree_state), p)

    def _screen(self, loss, grads):
        """The ``train.grads`` site and the quality gate, between the
        gradients and any comm (train.py:937-962). -> (grads, proceed);
        proceed False is ``skip_step``: the caller returns the loss with no
        comm started."""
        if chaos._plans:
            p = chaos.inject("train.grads", step=self._step_no)
            if p is not None and p.kind == "silent":
                sentinel_mod.corrupt_silent(grads, p, self.dist.topology.local_shape)
        if self._gate_armed() and not self.sentinel.gate(loss, grads, None, self._step_no):
            return grads, False
        m = obs_metrics._registry
        if m is not None and self._step_no % m.every == 0:
            # the gradient norm at the cadence tick: only the host paths
            # expose a gradient boundary
            self._record_grad_norm(m, grads)
        return grads, True

    def _audit_state(self):
        """The state the consistency audit covers (train.py's
        ``Sentinel._audit_state``): (replicated, sharded) trees. Replicated:
        the parameters by layer and the replicated optimizer state, one copy
        each; sharded: ZeRO-1's owned optimizer state, one shard a rank, whose
        rank-less leaves (Adam's step count) join the replicated tree."""
        rep = {"params": {n: list(self.layer_params[n]) for n in self.layers}}
        sh = {}
        if self.distributed_update and self._needs_comm:
            grid = tuple(self.dist.topology.local_shape)
            leaves = sentinel_mod.tree_leaves(self.opt_state)
            sh["du_opt_state"] = [l for l in leaves if tuple(l.shape[:4]) == grid]
            rest = [l for l in leaves if tuple(l.shape[:4]) != grid]
            if rest:
                rep["opt_state"] = rest
        elif self.opt_state or self.tree_state is not None:
            rep["opt_state"] = (self.opt_state, self.tree_state)
        return rep, sh

    # -- telemetry (train.py:964-1035) ---------------------------------------

    def _post_step_telemetry(self, m, loss, t0: float) -> None:
        """The armed epilogue: the step's wall time into ``mlsl_step_ms`` and
        the straggler sentinel, and the cadence tick every ``m.every``
        steps."""
        step_ms = (time.perf_counter() - t0) * 1e3
        if m is not None:
            m.observe("mlsl_step_ms", step_ms)
            if self._step_no % m.every == 0:
                self._sample_telemetry(m, loss)
        if self.straggler is not None:
            self.straggler.observe(self._replica_id, step_ms)
            self.straggler.maybe_audit(self._step_no)

    def _sample_telemetry(self, m, loss) -> None:
        """One cadence tick: the mean loss over the ranks (one host read), the
        input stall since the last tick, every counter family, one sample a
        series, and the JSONL append."""
        from mlsl_tpu_torch.core import stats as stats_mod

        m.set("mlsl_loss", float(loss.detach().float().mean()))
        stall = float(stats_mod.FEED_COUNTERS["stall_ms"])
        m.set("mlsl_input_stall_ms", max(0.0, stall - self._stall_ms_seen))
        self._stall_ms_seen = stall
        m.sample_families()
        m.write_jsonl(records=m.sample())

    def _record_grad_norm(self, m, grads) -> None:
        """The gradient norm over every rank's local gradients at the cadence
        tick (one host read)."""
        sq = sum(g.float().square().sum() for g in grads.values())
        m.set("mlsl_grad_norm", float(torch.sqrt(sq)))

    # -- the step ----------------------------------------------------------

    def step(self, batch) -> torch.Tensor:
        """One training step. -> the loss: per rank (R, D, S, M, 1) on the graph
        path, a scalar on the fused path. With neither the metrics registry
        nor the straggler sentinel armed this is a pass-through; armed, the
        step's wall time and the cadence tick follow it."""
        m = obs_metrics._registry
        if m is None and self.straggler is None:
            return self._step_impl(batch)
        t0 = time.perf_counter()
        loss = self._step_impl(batch)
        self._post_step_telemetry(m, loss, t0)
        return loss

    def step_accum(self, batches: Sequence) -> torch.Tensor:
        """Gradient accumulation (train.py:1038-1077): k local
        forward/backward passes, ONE gradient sync and update. Each entry of
        ``batches`` is a ``shard_batch`` result with the same local batch
        size; the gradients and losses are summed in order and divided by k.
        -> the mean loss per rank (R, D, S, M, 1)."""
        m = obs_metrics._registry
        if m is None and self.straggler is None:
            return self._step_accum_impl(batches)
        t0 = time.perf_counter()
        loss = self._step_accum_impl(batches)
        self._post_step_telemetry(m, loss, t0)
        return loss

    def _step_impl(self, batch) -> torch.Tensor:
        self._step_no += 1
        if chaos._plans:
            self._chaos_state_sites()
        if self.fused:
            x, y = batch
            c = (0, 0, 0, 0)
            loss = self.loss_fn(self.model, (x[c], y[c]))
            gs = iter(torch.autograd.grad(loss, self._all_params()))
            flat = {n: torch.cat([next(gs).reshape(-1) for _ in self.layer_params[n]])
                    for n in self.layers}
            self._replicated_update(flat, 1.0)
            return loss.detach()
        if self._overlap is not None and not self._gate_armed():
            return self._overlap.step(batch)
        loss, grads = self._local_grads(batch)
        grads, proceed = self._screen(loss, grads)
        if not proceed:
            return loss
        if self._overlap is not None:
            # the gated engine: the screened gradients ride its split program
            self._overlap.step(None, grads=grads)
            return loss
        return self._sync_and_update(grads, loss)

    def _step_accum_impl(self, batches: Sequence) -> torch.Tensor:
        mlsl_assert(len(batches) >= 1, "step_accum needs at least one batch")
        mlsl_assert(not self.fused, "step_accum takes the graph path (use "
                    "force_graph_path=True on a grid without communication)")
        self._step_no += 1
        if chaos._plans:
            self._chaos_state_sites()
        total = loss_sum = None
        for b in batches:
            loss, grads = self._local_grads(b)
            total = grads if total is None else {n: total[n] + grads[n] for n in self.layers}
            loss_sum = loss if loss_sum is None else loss_sum + loss
        k = len(batches)
        loss = loss_sum / k
        grads, proceed = self._screen(loss, {n: g / k for n, g in total.items()})
        if not proceed:
            return loss
        if self._overlap is not None:
            # the accumulated gradients ride the engine's split program
            self._overlap.step(None, grads=grads)
            return loss
        return self._sync_and_update(grads, loss)

    def precompile(self, batch) -> None:
        """Ahead of the first step (train.py:757-785): the compiled overlap
        engine captures its step's CUDA graph on the card (on the CPU it runs
        the step once). ``batch`` is a ``shard_batch`` result; it is read,
        not trained on: parameters, residuals and the step count are
        unchanged afterwards. The eager paths have nothing to prepare."""
        if self._overlap is not None:
            self._overlap.precompile(batch)

    def _sync_and_update(self, grads, loss) -> torch.Tensor:
        # Start gradient comms newest-gradient-first (reverse layer order), the
        # stream shape eplib's priority allreduce was built for.
        for name in reversed(self.layers):
            self._pset(name).start_gradient_comm(grads[name])
        if self.overlap_updates:
            self._poll_and_update(grads)
            return loss
        if not (self.distributed_update and self._needs_comm):
            reduced = {}
            for name in self.layers:
                out = self._pset(name).wait_gradient_comm()
                # every rank holds the same reduced gradient; rank 0's updates
                # the (replicated) parameters
                reduced[name] = (out if out is not None else grads[name])[0, 0, 0, 0]
            self._replicated_update(reduced, self.data_size)
            return loss
        self._zero1_update()
        return loss

    def _poll_and_update(self, grads) -> None:
        """Poll every layer's request with TestGradientComm and update each
        as it lands (train.py:1140-1168); when a pass lands nothing, wait on
        the last pending layer (the first one started) rather than spin."""
        def apply(name, out):
            self._sgd_layer(name, (out if out is not None else grads[name])[0, 0, 0, 0])

        pending = list(self.layers)
        while pending:
            still = []
            for name in pending:
                done, out = self._pset(name).test_gradient_comm()
                if done:
                    apply(name, out)
                else:
                    still.append(name)
            if still and len(still) == len(pending):
                name = still.pop()
                apply(name, self._pset(name).wait_gradient_comm())
            pending = still

    @torch.no_grad()
    def _zero1_update(self) -> None:
        """ZeRO-1 (train.py:1181-1232): each rank turns its owned gradient
        shard into an increment, the increments are all-gathered, and every
        rank adds the gathered increment to its replica."""
        norm = self.data_size
        owned_all, scale = {}, 1.0
        if self.clip_global_norm is not None:
            # the clip needs every owned shard before any increment: wait all,
            # gather the shards' partial squares over the gradient group and
            # add them in member order (sharded_sq_norm's order), scale
            for name in self.layers:
                owned_all[name] = self._pset(name).wait_gradient_comm()
                mlsl_assert(owned_all[name] is not None,
                            "distributed update requires dataParts>1")
            local = sum(((owned_all[n] / norm) ** 2).sum(dim=-1, keepdim=True)
                        for n in sorted(owned_all))
            parts = collectives.build_collective("allgather", self.dist.grad_group)(local)
            total = member_sum(parts)[..., None]
            scale = clip_scale(torch.sqrt(total) ** 2, self.clip_global_norm)
        for name in self.layers:
            ps = self._pset(name)
            owned = owned_all.get(name)
            if owned is None:
                owned = ps.wait_gradient_comm()
                mlsl_assert(owned is not None, "distributed update requires dataParts>1")
            if self.optimizer is None:
                inc = owned_increment(owned, self.lr, norm, scale)
            elif self._af_cfg is not None:
                # the factored statistics need the layer's replicated leaves
                # (train.py:1210-1225)
                inc, self.opt_state[name] = self._af_inc[name](
                    owned, self.opt_state[name], [p.detach() for p in self.layer_params[name]],
                    scale)
            else:
                inc, self.opt_state[name] = owned_opt_increment(
                    owned, self.opt_state[name], self.optimizer, norm, scale)
            ps.start_increment_comm(inc)
        for name in self.layers:
            inc = self._pset(name).wait_increment_comm()
            # every rank receives the same gathered increment; rank 0's updates
            # the (replicated) parameters
            self._add_flat(name, inc[0, 0, 0, 0, :self.layer_counts[name]])
