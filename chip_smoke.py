#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mlsl_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. build     nvcc builds every kernel of the path from mlsl_tpu_torch/csrc,
             one process per source, all started together.
2. parity    each kernel's wrapper against its plain PyTorch version on the
             card, at the shapes the training path gives it and at edge
             shapes: int8 values, scales and dequantized values bit-exact.
3. config 1  a flat Distribution(8, 1) fp32 SUM AllReduce against the
             closed-form mlsl_test oracle.
4. config 2  AllReduce, AllGather, Bcast and ReduceScatter over both groups
             of a (4, 2) grid against closed-form oracles.
5. config 3  overlapped Start/Wait/Test requests on the comm stream.
6. config 4  the int8 error-feedback allreduce of 64 MiB per rank on 8
             virtual ranks, two rounds (the residual is carried), with the
             kernels and again with the plain quantize, bit-exact; and the
             public quantize -> reduce -> dequantize round trip.
7. config 5  ResNet-50 at full width (1000 classes, 224x224, global batch 64
             on 8 virtual data ranks) with int8-compressed gradients: three
             per-layer Start/Wait training steps. Losses must be finite, the
             last step's reduced gradients bit-exact against the plain ring
             and close to the exact rank sums, and the quantize kernel
             launched 9 times per layer and step.

Launch counts are set to 0 just before configs 4 and 5 are driven and read
just after; launches made to compare a kernel with its plain version do not
count. Then it times each kernel at the path's shapes with CUDA events
against its memory-traffic bound and prints, on lines of their own, the
card's name and power limit, one JSON object with the kernels, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORLD = 8
BLOCK = 256
SEED = 0

# device memory rate (bytes/s) and float32 rate outside the tensor cores
# (operations/s), from NVIDIA's data sheets; the first name that matches wins
CARDS = (
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),      # SXM5, HBM3
    ("H200", 4.8e12, 67e12),
)


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str):
    for key, bw, f32 in CARDS:
        if key in name:
            return bw, f32
    raise SmokeFailure(f"no data-sheet rates for card {name!r}: add it to CARDS")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


# -- shapes of the training path ------------------------------------------


def resnet_ring_rows(counts, g=WORLD, block=BLOCK):
    """{layer: (entry rows, hop rows)} of the quantize launches the int8 ring
    makes for each layer's gradient on a g-rank data group."""
    from mlsl_tpu_torch.ops.quant_kernels import block_align

    out = {}
    for name, count in counts.items():
        chunk = block_align(-(-count // g), block)
        out[name] = (g * g * chunk // block, g * chunk // block)
    return out


def _rows(torch, n, block, dev, gen, zero_every=0):
    x = torch.randn((n, block), generator=gen, device="cpu")
    x *= torch.rand((n, 1), generator=gen) * 50
    if zero_every:
        x[::zero_every] = 0.0
    return x.to(dev)


# -- phases ---------------------------------------------------------------


def phase_parity(torch, qk, dev, shapes):
    """Every (rows, block) in ``shapes`` through both wrappers against the
    plain versions on the card: -> number of comparisons."""
    gen = torch.Generator().manual_seed(SEED)
    for rows, block in shapes:
        x = _rows(torch, rows, block, dev, gen, zero_every=7)
        q, s = qk.quantize_blocks(x)
        torch.cuda.synchronize()
        rq, rs = qk.quantize_blocks_ref(x)
        bad_q = int((q != rq).sum())
        bad_s = int((s != rs).sum())
        check(bad_q == 0 and bad_s == 0,
              f"quantize ({rows}, {block}): {bad_q} int8 and {bad_s} scale mismatches")
        d = qk.dequantize_blocks(q, s)
        torch.cuda.synchronize()
        bad_d = int((d != qk.dequantize_blocks_ref(rq, rs)).sum())
        check(bad_d == 0, f"dequantize ({rows}, {block}): {bad_d} mismatches")
    return len(shapes)


def phase_config1(torch, env, np, n=1 << 20):
    from mlsl_tpu_torch import DataType, GroupType, ReductionType

    dist = env.create_distribution(WORLD, 1)
    buf = dist.make_buffer(lambda p: p * 1000.0 + np.arange(n), n)
    out = env.wait(dist.all_reduce(buf, n, DataType.FLOAT, ReductionType.SUM,
                                   GroupType.DATA))
    want = torch.as_tensor(sum(p * 1000.0 for p in range(WORLD)) + WORLD * np.arange(n),
                           dtype=torch.float32, device=buf.device)
    check(bool((out == want).all()), "config 1: AllReduce differs from the closed form")


def phase_config2(torch, env, np, n=4096):
    from mlsl_tpu_torch import DataType, GroupType, ReductionType

    dist = env.create_distribution(4, 2)
    topo = dist.topology
    buf = dist.make_buffer(lambda p: p * 1000.0 + np.arange(n), n)
    host = {p: p * 1000.0 + np.arange(n) for p in range(WORLD)}

    def members(p, axis):
        r, d, s, m = topo.coords(p)
        if axis == "data":
            return [topo.global_idx(r, j, s, m) for j in range(4)]
        return [topo.global_idx(r, d, s, j) for j in range(2)]

    for gt, axis in ((GroupType.DATA, "data"), (GroupType.MODEL, "model")):
        g = 4 if axis == "data" else 2
        outs = {
            "allreduce": env.wait(dist.all_reduce(buf, n, DataType.FLOAT,
                                                  ReductionType.SUM, gt)),
            "allgather": env.wait(dist.all_gather(buf, n, DataType.FLOAT, gt)),
            "bcast": env.wait(dist.bcast(buf, n, DataType.FLOAT, g - 1, gt)),
            "reduce_scatter": env.wait(dist.reduce_scatter(
                buf, n // g, DataType.FLOAT, ReductionType.SUM, gt)),
        }
        for p in range(WORLD):
            mem = members(p, axis)
            me = mem.index(p)
            full = sum(host[q] for q in mem)
            want = {
                "allreduce": full,
                "allgather": np.concatenate([host[q] for q in mem]),
                "bcast": host[mem[g - 1]],
                "reduce_scatter": full[me * (n // g):(me + 1) * (n // g)],
            }
            for kind, out in outs.items():
                check(np.array_equal(dist.local_part(out, p), want[kind]),
                      f"config 2: {kind} over {axis} differs at rank {p}")


def phase_config3(torch, env, np, n=1 << 22, k=4):
    """k requests started back to back on the comm stream, completed out of
    order through Test and Wait."""
    from mlsl_tpu_torch import DataType, GroupType, ReductionType

    dist = env.create_distribution(WORLD, 1)
    bufs = [dist.make_buffer(lambda p, i=i: np.full(n, p + i, np.float32), n)
            for i in range(k)]
    reqs = [dist.all_reduce(b, n, DataType.FLOAT, ReductionType.SUM, GroupType.DATA)
            for b in bufs]
    check(all(r._event is not None for r in reqs), "config 3: a request ran synchronously")
    done = {}
    for i in reversed(range(k)):
        ok, out = env.test(reqs[i])
        done[i] = out if ok else env.wait(reqs[i])
    for i, out in done.items():
        want = float(sum(p + i for p in range(WORLD)))
        check(bool((out == want).all()), f"config 3: request {i} result is wrong")


def phase_config4(torch, env, np, qk, n=(64 << 20) // 4, rounds=2):
    """-> (results and residuals per round with the kernels, the round trip's
    dequantized sum) for the comparison that follows."""
    from mlsl_tpu_torch import CompressionType, DataType, GroupType, ReductionType

    dist = env.create_distribution(WORLD, 1)
    gen = torch.Generator().manual_seed(SEED + 4)
    xs = [torch.randn((*dist.world_shape, n), generator=gen).to(env.device)
          for _ in range(rounds)]
    req = dist.all_reduce(xs[0], n, DataType.FLOAT, ReductionType.SUM, GroupType.DATA,
                          compression=CompressionType.QUANTIZATION)
    outs = [env.wait(req)]
    errs = [req._errs[0].clone()]
    for x in xs[1:]:
        outs.append(req.start(x).wait())     # restart: the residual carries over
        errs.append(req._errs[0].clone())
    # config 4's wire as the public codec: every rank compresses, the int8
    # payload and scales reduce, every rank decompresses
    q, s, orig = qk.quantize(xs[0].reshape(-1), block=BLOCK)
    deq = qk.dequantize(q, s, block=BLOCK, orig_len=orig).reshape(xs[0].shape)
    roundtrip = deq.sum(dim=1, keepdim=True)
    return xs, outs, errs, roundtrip


def check_config4(torch, env, qk, xs, outs, errs, roundtrip):
    from mlsl_tpu_torch.comm import quant_ring

    dist = env.create_distribution(WORLD, 1)
    n = xs[0].shape[-1]
    fn, el = quant_ring.build_quantized_collective(
        "allreduce", dist.data_group, n, BLOCK, quantize=qk.quantize_blocks_ref)
    err = torch.zeros((*dist.world_shape, el), device=env.device)
    for r, x in enumerate(xs):
        out, err = fn(x, err)
        torch.cuda.synchronize()
        bad = int((out != outs[r]).sum())
        bad_e = int((err != errs[r]).sum())
        check(bad == 0 and bad_e == 0,
              f"config 4 round {r}: kernel ring differs from the plain ring "
              f"({bad} results, {bad_e} residuals)")
        exact = x.sum(dim=1, keepdim=True)
        rel = float((out[:, :1] - exact).norm() / exact.norm())
        check(rel < 0.02, f"config 4 round {r}: relative error {rel} >= 2%")
    flat = xs[0].reshape(-1)
    pad = qk.block_align(flat.numel(), BLOCK) - flat.numel()
    q, s = qk.quantize_blocks_ref(torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK))
    deq = qk.dequantize_blocks_ref(q, s).reshape(-1)[:flat.numel()]
    want = deq.reshape(xs[0].shape).sum(dim=1, keepdim=True)
    check(bool(torch.equal(roundtrip, want)), "config 4: codec round trip differs from plain")


def build_resnet_trainer(torch, env, np, image=224, classes=1000, batch=64):
    from mlsl_tpu_torch import CompressionType
    from mlsl_tpu_torch.models import resnet
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    gen = torch.Generator().manual_seed(SEED)
    model = resnet.ResNet50(num_classes=classes, generator=gen, device=env.device)
    dist = env.create_distribution(WORLD, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(batch)
    trainer = DataParallelTrainer(
        env, dist, sess, model, resnet.loss_fn, resnet.layer_names(model),
        resnet.layer_subtree, compression=CompressionType.QUANTIZATION, lr=0.05,
    )
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(batch, image, image, 3)).astype(np.float32)
    y = rng.integers(0, classes, size=(batch,)).astype(np.int32)
    return trainer, trainer.shard_batch(x, y)


def phase_config5(torch, trainer, batch, steps=3):
    """-> (losses per step, step seconds, the last step's seconds in its two
    halves, last step's local grads, each
    layer's error-feedback residuals as the last step found them). The last
    step runs as its two halves (``step`` is exactly these two calls) so its
    inputs stay at hand for the check that follows."""
    losses, secs = [], []
    grads = errs = None
    for i in range(steps):
        t0 = time.perf_counter()
        if i < steps - 1:
            loss = trainer.step(batch)
        else:
            trainer._step_no += 1
            loss, grads = trainer._local_grads(batch)
            torch.cuda.synchronize()
            split = {"local_grads_s": time.perf_counter() - t0}
            errs = {name: [e.clone() for e in _grad_req(trainer, name)._errs]
                    for name in trainer.layers}
            t1 = time.perf_counter()
            loss = trainer._sync_and_update(grads, loss)
            torch.cuda.synchronize()
            split["sync_and_update_s"] = time.perf_counter() - t1
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.detach().reshape(-1).cpu())
    return losses, secs, split, grads, errs


def _grad_req(trainer, name):
    return trainer.ops[name].get_parameter_set(0).grad_req


def check_config5(torch, trainer, losses, grads, errs, qk):
    """The last step's reduced gradients, layer by layer: bit-exact against
    the plain ring (plain quantize) on the same gradients and residuals, and
    close to the exact sum of what entered the round (gradient plus carried
    residual). -> the worst layer's relative error.

    Bound: the ring rounds each element up to G + 1 = 9 times (entry, seven
    hops, all-gather), each time by at most half a step of amax/127. A block
    whose norm one element dominates -- the fc gradient at 1000 classes, where
    softmax puts most of a 256-wide block ~1000x below its labelled entry --
    loses about sqrt(9 * 256 / 12) / 127 = 0.11 of its norm; 0.25 leaves room."""
    from mlsl_tpu_torch.comm import quant_ring

    for i, loss in enumerate(losses):
        check(loss.shape == (WORLD,) and bool(torch.isfinite(loss).all()),
              f"config 5 step {i}: losses {loss.tolist()}")
    block = trainer.env.config.quant_block_elems
    worst = 0.0
    for name in trainer.layers:
        req = _grad_req(trainer, name)
        reduced = req._result
        check(bool((reduced == reduced[:, :1]).all()),
              f"config 5: ranks disagree on layer {name}'s reduced gradient")
        plain, entered = [], []
        for sl, err in zip(req._chunk_slices, errs[name]):
            part = grads[name][..., sl]
            n = part.shape[-1]
            fn, _ = quant_ring.build_quantized_collective(
                req.desc.kind, req.desc.group, n, block, quantize=qk.quantize_blocks_ref)
            plain.append(fn(part, err)[0])
            g, rc, chunk, _ = quant_ring.ring_geometry(req.desc.kind, req.desc.group, n, block)
            entered.append(part + quant_ring.logical_residual(err, g, chunk, rc, n))
        torch.cuda.synchronize()
        bad = int((torch.cat(plain, dim=-1) != reduced).sum())
        check(bad == 0, f"config 5: layer {name}: {bad} elements of the kernel ring's "
                        f"reduced gradient differ from the plain ring's")
        exact = torch.cat(entered, dim=-1).sum(dim=1, keepdim=True)
        rel = float((reduced[:, :1] - exact).norm() / exact.norm())
        worst = max(worst, rel)
        check(rel < 0.25, f"config 5: layer {name} reduced gradient off by {rel:.3g}")
    for p in trainer._all_params():
        check(bool(torch.isfinite(p).all()), "config 5: a parameter is not finite")
    return worst


# -- timing ---------------------------------------------------------------


def time_ms(torch, fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_entry(torch, qk, kind, rows, block, bw, f32, launches, per_path, dev):
    gen = torch.Generator().manual_seed(SEED + 9)
    x = _rows(torch, rows, block, dev, gen)
    elems = rows * block
    before = dict(qk.LAUNCHES)
    if kind == "quantize":
        fn, plain = (lambda: qk.quantize_blocks(x)), (lambda: qk.quantize_blocks_ref(x))
        (q, s), (rq, rs) = fn(), plain()
        err = max(float((q.float() - rq.float()).abs().max()), float((s - rs).abs().max()))
        # |x|, max, divide, round, clip per element (float32, no tensor cores)
        nbytes, ops = elems * 4 + elems + rows * 4, 5 * elems
        name, replaces = "quantize_blocks", "mlsl_tpu/ops/quant_kernels.py:99"
    else:
        q, s = qk.quantize_blocks_ref(x)
        fn, plain = (lambda: qk.dequantize_blocks(q, s)), (
            lambda: qk.dequantize_blocks_ref(q, s))
        err = float((fn() - plain()).abs().max())
        nbytes, ops = elems + rows * 4 + elems * 4, 2 * elems   # convert, multiply
        name, replaces = "dequantize_blocks", "mlsl_tpu/ops/quant_kernels.py:140"
    ms = time_ms(torch, fn)
    qk.LAUNCHES.update(before)      # timing launches are not the path's
    plain_ms = time_ms(torch, plain)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / f32 * 1e3
    return {
        "name": name, "route": "cuda", "source": "mlsl_tpu_torch/csrc/quant_kernels.cu",
        "replaces": replaces, "launches": launches, "launches_by_path": per_path,
        "shape": [rows, block], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes blockwise int8 quantization",
    }


# -- main -----------------------------------------------------------------


def main() -> int:
    if not (ROOT / "mlsl_tpu_torch" / "__init__.py").is_file():
        raise SmokeFailure(f"{ROOT} holds no mlsl_tpu_torch package: run from a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, str(ROOT))
    from mlsl_tpu_torch import get_env
    from mlsl_tpu_torch.models import resnet
    from mlsl_tpu_torch.ops import cuda_build
    from mlsl_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    bw, f32 = card_rates(name)
    log(f"# card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    took = cuda_build.build_all()
    log(f"# phase build: ok in {time.perf_counter() - t0:.1f} s {took}")
    for src, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {src}: {line.strip()}")

    env = get_env().init(world_size=WORLD)        # the card; raises without one
    try:
        counts = resnet.layer_param_counts(resnet.ResNet50(device="meta"))
        ring_rows = resnet_ring_rows(counts)
        shapes = sorted({r for pair in ring_rows.values() for r in pair})
        shapes = [(r, BLOCK) for r in shapes] + [
            (37, 256), (1, 256), (4096, 128), (4096, 512), (1000, 32), (333, 96)]
        n_shapes = phase_parity(torch, qk, dev, shapes)
        log(f"# phase parity: ok, {n_shapes} shapes bit-exact (quantize, dequantize)")

        phase_config1(torch, env, np)
        log("# phase config1: ok")
        phase_config2(torch, env, np)
        log("# phase config2: ok")
        phase_config3(torch, env, np)
        log("# phase config3: ok")

        qk.reset_counts()
        xs, outs, errs, roundtrip = phase_config4(torch, env, np, qk)
        torch.cuda.synchronize()
        c4 = dict(qk.LAUNCHES)
        check_config4(torch, env, qk, xs, outs, errs, roundtrip)
        check(c4["quantize_blocks"] == 2 * (WORLD + 1) + 1 and c4["dequantize_blocks"] == 1,
              f"config 4: kernel launches {c4}, expected 19 quantize and 1 dequantize")
        del xs, outs, errs, roundtrip
        log(f"# phase config4: ok, launches {c4}")

        trainer, batch = build_resnet_trainer(torch, env, np)
        qk.reset_counts()
        losses, secs, split, grads, errs = phase_config5(torch, trainer, batch)
        c5 = dict(qk.LAUNCHES)
        steps = len(losses)
        want = (WORLD + 1) * len(trainer.layers) * steps
        check(c5["quantize_blocks"] == want,
              f"config 5: {c5['quantize_blocks']} quantize launches, expected {want}")
        worst = check_config5(torch, trainer, losses, grads, errs, qk)
        log(f"# phase config5: ok, losses {[round(float(v.mean()), 4) for v in losses]}, "
            f"step seconds {[round(s, 4) for s in secs]}, launches {c5}, "
            f"worst layer gradient rel. error {worst:.4g}")
        del grads, errs, trainer, batch
        torch.cuda.empty_cache()

        fc_entry = ring_rows["fc"][0]
        # B1 at its largest shape on the path (the fc layer's entry quantize)
        # and B2 at its shape on the path (config 4's round trip)
        entries = [
            kernel_entry(torch, qk, "quantize", fc_entry, BLOCK, bw, f32,
                         c4["quantize_blocks"] + c5["quantize_blocks"],
                         {"config4": c4["quantize_blocks"], "config5": c5["quantize_blocks"]},
                         dev),
            kernel_entry(torch, qk, "dequantize", WORLD * ((64 << 20) // 4) // BLOCK, BLOCK,
                         bw, f32, c4["dequantize_blocks"] + c5["dequantize_blocks"],
                         {"config4": c4["dequantize_blocks"],
                          "config5": c5["dequantize_blocks"]}, dev),
        ]
        log(f"# config5 train step (host clock, synchronized): "
            f"{json.dumps({'step_s': secs, 'last_step_split_s': split})}")
    finally:
        env.finalize()

    log(smi)
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
