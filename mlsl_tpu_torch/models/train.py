"""MLSL-driven data-parallel training: the Session/Operation graph in the loop.

Counterpart of the per-layer Start/Wait path of ``mlsl_tpu.models.train``
(BASELINE config 5, reference loop tests/examples/mlsl_test/mlsl_test.cpp:660-698):

- every virtual data rank computes its OWN gradient on its own local batch --
  one forward/backward per rank, batch norm taking statistics on the rank's
  shard. The ranks' losses are never summed into one autograd graph: that
  would compute the allreduce inside autograd and bypass the collective and
  its codec;
- each layer is an Operation whose ParameterSet carries the gradient
  collective; StartGradientComm is issued per layer in reverse (backprop)
  order, then every layer is waited and updated with the built-in SGD
  (p -= lr * sum_grad / data_ranks).

Gradients cross into the framework as distributed buffers (R, D, S, M, count)
whose rows are the per-rank flat layer gradients, in the JAX package's
element order (see convert.py). When Commit shows that no parameter set
communicates (one data rank), the step is fused: one forward/backward and
the update, no requests -- unless ``force_graph_path`` asks for the graph.
Optimizers other than SGD, ZeRO-1, the overlap engines, the sentinel,
straggler detection and telemetry come later.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from mlsl_tpu_torch.log import mlsl_assert
from mlsl_tpu_torch.models.convert import tree_leaves
from mlsl_tpu_torch.types import CompressionType, DataType, OpType


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
        compression: CompressionType = CompressionType.NONE,
        lr: float = 0.05,
        force_graph_path: bool = False,
    ):
        self.env = env
        self.dist = dist
        self.session = session
        self.model = model
        self.loss_fn = loss_fn
        self.layers = list(layers)
        self.get_layer = get_layer
        self.lr = lr
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
            reg.add_parameter_set(count, 1, DataType.FLOAT, compression_type=compression)
            self.ops[name] = session.get_operation(session.add_operation(reg, dist))
        session.commit()
        needs_comm = any(self.ops[n].get_parameter_set(0).need_comm for n in self.layers)
        # fuse the whole step when no parameter set communicates (train.py:388-391)
        self.fused = not needs_comm and not force_graph_path
        self._step_no = 0

    # -- data placement ----------------------------------------------------

    def shard_batch(self, x: np.ndarray, y: np.ndarray):
        """Global batch (B, ...) -> distributed buffers (R, D, S, M, localB, ...)."""
        r, d, s, m = self.dist.topology.grid_shape
        local_b = x.shape[0] // (r * d)

        def place(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            return t.reshape(r, d, 1, 1, local_b, *a.shape[1:]).expand(
                r, d, s, m, local_b, *a.shape[1:]
            )

        return place(x), place(y)

    # -- the training step -------------------------------------------------

    def _all_params(self) -> List[torch.nn.Parameter]:
        return [p for name in self.layers for p in self.layer_params[name]]

    def _local_grads(self, batch):
        """Per-rank loss and flat per-layer gradients as distributed buffers:
        -> (loss (R, D, S, M, 1), {layer: (R, D, S, M, count)})."""
        x, y = batch
        grid = self.dist.topology.grid_shape
        params = self._all_params()
        losses = torch.empty((*grid, 1), dtype=torch.float32, device=self.device)
        grads = {
            name: torch.empty((*grid, self.layer_counts[name]), dtype=torch.float32,
                              device=self.device)
            for name in self.layers
        }
        for p in range(self.dist.topology.world_size):
            c = self.dist.topology.coords(p)
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
    def _apply(self, name: str, flat_grad: torch.Tensor, scale: float) -> None:
        """p -= lr * g / scale over one layer's flat (count,) gradient."""
        g = flat_grad / scale
        off = 0
        for p in self.layer_params[name]:
            n = p.numel()
            p.sub_(self.lr * g[off:off + n].view_as(p))
            off += n

    def step(self, batch) -> torch.Tensor:
        """One training step. -> the loss: per rank (R, D, S, M, 1) on the graph
        path, a scalar on the fused path."""
        self._step_no += 1
        if self.fused:
            x, y = batch
            c = (0, 0, 0, 0)
            loss = self.loss_fn(self.model, (x[c], y[c]))
            gs = iter(torch.autograd.grad(loss, self._all_params()))
            with torch.no_grad():
                for p in self._all_params():
                    p.sub_(self.lr * next(gs))
            return loss.detach()
        loss, grads = self._local_grads(batch)
        return self._sync_and_update(grads, loss)

    def _sync_and_update(self, grads, loss) -> torch.Tensor:
        # Start gradient comms newest-gradient-first (reverse layer order), the
        # stream shape eplib's priority allreduce was built for.
        for name in reversed(self.layers):
            self.ops[name].get_parameter_set(0).start_gradient_comm(grads[name])
        for name in self.layers:
            out = self.ops[name].get_parameter_set(0).wait_gradient_comm()
            reduced = out if out is not None else grads[name]
            # every rank holds the same reduced gradient; rank 0's updates the
            # (replicated) parameters
            self._apply(name, reduced[0, 0, 0, 0], self.data_size)
        return loss
