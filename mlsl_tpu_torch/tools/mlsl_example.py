"""A walkthrough of a model-parallel graph on the port: the calls of the JAX
package's ``examples/mlsl_example.py`` (the reference's mlsl_example.cpp),
unchanged in form, on a data x model grid of virtual ranks.

    python3 -m mlsl_tpu_torch.tools.mlsl_example            # on the card
    python3 -m mlsl_tpu_torch.tools.mlsl_example --cpu      # on the CPU

It creates the environment, lays out a data 4 x model 2 grid over 8 virtual
ranks, runs a raw allreduce through the Distribution, registers a two-op
graph (its edge crosses the model group: peer-connection case 1, a
reduce_scatter forward and an allgather backward), runs one activation
exchange and three iterations of newest-first gradient requests (the second
set with the distributed update), and prints the statistics table.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from mlsl_tpu_torch import DataType, Environment, GroupType, OpType, ReductionType
from mlsl_tpu_torch.core.activation import pack_local


def main(device=None, world_size: int = 8, log=print) -> dict:
    """Run the walkthrough; -> what it read back, for a caller's checks."""
    # 1. Bootstrap (reference: Environment::GetEnv().Init(&argc, &argv)):
    #    the card unless device="cpu" is asked for
    env = Environment.get_env().init(device=device, world_size=world_size)
    world = env.get_process_count()
    log(f"process count: {world} on {env.device}")
    try:
        # 2. Parallelism layout: a data x model grid over the virtual ranks
        model_parts = 2 if world % 2 == 0 else 1
        data_parts = world // model_parts
        dist = env.create_distribution(data_parts, model_parts)
        log(f"grid: data={data_parts} x model={model_parts}")

        # 3. A raw collective through the Distribution (an async request that
        #    Environment.wait completes)
        buf = dist.make_buffer(lambda p: np.full(4, float(p + 1)), 4)
        req = dist.AllReduce(buf, 4, DataType.FLOAT, ReductionType.SUM, GroupType.GLOBAL)
        out = env.wait(req)
        allreduce = dist.local_part(out, 0)
        log(f"global allreduce: {allreduce}")

        # 4. A two-layer operation graph: SetNext wires the edge, Commit picks
        #    its peer-connection case and builds every request
        session = env.create_session()
        session.SetGlobalMinibatchSize(4 * data_parts)
        reg1 = session.CreateOperationRegInfo(OpType.CC)
        reg1.AddInput(8, 16, DataType.FLOAT)
        reg1.AddOutput(16, 16, DataType.FLOAT)
        reg1.AddParameterSet(8 * 16, 1, DataType.FLOAT)
        op1 = session.GetOperation(session.AddOperation(reg1, dist))

        reg2 = session.CreateOperationRegInfo(OpType.CC)
        reg2.AddInput(16, 16, DataType.FLOAT)
        reg2.AddOutput(4, 16, DataType.FLOAT)
        reg2.AddParameterSet(16 * 4, 1, DataType.FLOAT, distributed_update=True)
        op2 = session.GetOperation(session.AddOperation(reg2, dist))

        op1.SetNext(op2, 0, 0)
        session.Commit()
        session.GetStats().Start()

        # 5. The edge's exchange: op1 packs its partial sums and starts FPROP,
        #    op2 waits for its slice of the model-group sum
        out_act, in_act = op1.GetOutput(0), op2.GetInput(0)
        mb = op1.GetLocalMinibatchSize()
        n = mb * out_act.GetLocalFmCount() * out_act.GetFmSize()
        acts = dist.make_buffer(lambda p: np.full(n, float(p)), n)
        out_act.StartComm(pack_local(acts, out_act.pack_blocks, mb, out_act.GetLocalFmCount(),
                                     out_act.GetFmSize()))
        fprop = in_act.WaitComm()
        log(f"case-1 FPROP: {out_act.comm_req.desc.kind} over the model group, "
            f"rank 0 receives {dist.local_part(fprop, 0)[0]}")

        # 6. Training-loop phases: start the gradient requests newest first,
        #    then wait and update
        reduced_first = {}
        for it in range(3):
            for op in (op2, op1):  # backward order
                ps = op.GetParameterSet(0)
                k = ps.GetLocalKernelCount() * ps.GetKernelSize()
                grads = dist.make_buffer(lambda p, v=float(it + 1): np.full(k, v), k)
                ps.StartGradientComm(grads)
            for op in (op1, op2):
                ps = op.GetParameterSet(0)
                reduced = ps.WaitGradientComm()
                kind = "owned shard" if ps.IsDistributedUpdate() else "full"
                if reduced is not None:
                    v = float(dist.local_part(reduced, 0)[0])
                    reduced_first[(it, op.GetName())] = v
                    log(f"iter {it} {op.GetName()}: {kind} reduced[0] = {v}")

        # 7. Statistics (reference Statistics::Print -> mlsl_stats.log)
        path = os.path.join(tempfile.gettempdir(), "mlsl_stats_example.log")
        table = session.GetStats().Print(path)
        log(table[:400])
        return {"allreduce": allreduce, "fprop": dist.local_part(fprop, 0),
                "reduced": reduced_first, "table": table, "data_parts": data_parts,
                "case": out_act.comm_req.desc.kind}
    finally:
        env.finalize()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args()
    main(device="cpu" if args.cpu else None)
    print("example OK")
