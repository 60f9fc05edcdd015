"""Where one training step spends its time on the card.

Run from the root of a checkout, on a machine with a card:

    python3 -m mlsl_tpu_torch.tools.profile_step [--model resnet] [--steps 3] [--warmup 2]
        [--blocks N] [--remat full|dots] [--zero1] [--sharded-vocab] [--overlap-compiled]

``--model`` picks the step:

- ``resnet`` (the default): chip_smoke.py's config 5, ResNet-50 at 224x224,
  1000 classes, global batch 64 on 8 virtual data ranks, int8 error-feedback
  gradient ring (with MLSL_ALGO=pallas_ring exported, the fused int8 ring);
- ``transformer-1``: gpt-medium-2k (models/transformer.GPT_MEDIUM_2K, bf16,
  batch 8) on 1 rank, the fused step as one CUDA graph (captured in the
  warm-up, replayed in the timed and traced steps), flash attention kernels
  B7 and B8;
- ``transformer-8``: the same model and batch on 8 virtual ranks, dp=2 x
  sp=2 x tp=2, zigzag attention (kernel B9 and its backward), per-layer
  gradient requests;
- ``moe-8``: gpt-medium-2k-moe8 (models/transformer.GPT_MEDIUM_2K_MOE8, 8
  experts, top-1) at 6 of its 12 blocks on transformer-8's grid (ep = 2),
  with ``MLSL_ALGO=alltoall=pallas_a2a`` unless MLSL_ALGO is exported: the
  float32 combine exchange on the fused all-to-all B6 (int8 codec unless
  MLSL_PALLAS_A2A_QUANT=0), chip_smoke.py's MoE run.

- ``serve``: gpt-medium-2k served by ``serve.InferenceEngine`` (bf16,
  ``MLSL_SERVE_MAX_BATCH=4`` and ``MLSL_SERVE_KV_CACHE_MB=4096`` unless
  exported), chip_smoke.py's run (y1): every slot filled, then the decode
  step -- one CUDA graph replay a step, each step a ``decode_step`` range --
  and one prefill with its write into the pools (a ``prefill`` range);
  ``--tp 2`` serves over two model ranks (export ``MLSL_PALLAS_RHD=1`` for
  B5 in the decode graph, as run (y2), or ``MLSL_ALGO=allreduce=pallas_ring``
  for B3, as (y3)); ``--kv-quant`` keeps the KV pages int8 (B1, B2; run
  (y4)). Its output has, per range, the wall and kernel seconds and the idle
  share, kernel seconds by class (the KV codec, the TP reductions, gathers
  and scatters, softmax, the products), the capture's seconds and recorded
  launches, and the peak memory.

``--blocks`` sets a transformer step's depth in place of the one above;
``--remat full|dots`` trains it with ``remat`` and that ``remat_policy``
(each block replayed in the backward; ``dots`` keeps the matrix products'
outputs), so ``--model moe-8 --blocks 12 --remat full`` is chip_smoke.py's
MoE run at its full depth.
``--sharded-vocab`` shards a transformer's LM head over the model axis
(``sharded_vocab=True``: the CE from per-shard logits), so ``--model
transformer-8 --sharded-vocab`` is chip_smoke.py's run (q).
``--zero1`` trains a transformer step with Adam (lr 1e-4) and the
distributed update (ZeRO-1), its requests coalesced into gradient buckets:
``MLSL_GRAD_BUCKET_MB=25`` and ``MLSL_ALGO=reduce_scatter=pallas_ring2d``
(kernel B3 over the snake cycle of the data x seq group) unless exported --
chip_smoke.py's run (f). ``--overlap-compiled`` trains the resnet step on the
compiled overlap engine (comm/overlap.py), chip_smoke.py's run (h): the step
is captured as one CUDA graph (``precompile``) and replayed; its traced
steps are single host ranges (``engine_step``), and its halves are split on
the device timeline at each step's first codec kernel (the first unit's
entry quantization: every rank's forward and backward run before it, the
staged schedule and the updates from it). The output adds the capture's
seconds and the launches recorded into the graph
(``launches_one_captured_step``).

It warms up, times ``--steps`` steps with the host clock, then traces as
many steps again with ``torch.profiler`` (the Chrome trace goes to
``--trace``) and prints one JSON object:

- ``step_s``: host seconds per step, untraced, each ending in a synchronize;
- ``peak_gib``: the most device memory the allocator held for tensors up to
  the end of the untraced steps (``torch.cuda.max_memory_allocated``), beside
  the card's ``device_gib``;
- per half of the step (every rank's forward/backward, then the gradient
  requests and the update, with a synchronize between them): traced
  wall seconds, device kernel seconds (the union of kernel intervals, so
  overlapping streams are not counted twice), and the device idle share
  ``1 - kernel / wall``; the fused transformer step is one graph replay, one
  range (``graph_step``), with its capture's seconds, its recorded
  launches and its FLOPs (``compiled_step``) beside;
- device kernel seconds by class (codec kernels; B9's wgmma backward
  passes, B9's forward in either form, the other attention kernels; the
  all-to-all; every other kernel launched inside a ``block_update_bwd`` host
  range, the range B9's backward opens, which holds its PyTorch row terms;
  convolution; matrix products split by kernel name into float32 ones on
  the CUDA cores, bf16 ones on the tensor cores and any other; the rest) and
  the ``--top`` kernel names by device time.

Traced wall times include the profiler's own host cost; ``step_s`` does not.
It fails, printing no result, when there is no card or the trace holds no
device kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

import numpy as np
import torch

from mlsl_tpu_torch import CompressionType, get_env, optim
from mlsl_tpu_torch.core import stats
from mlsl_tpu_torch.models import resnet
from mlsl_tpu_torch.models import transformer as tfm
from mlsl_tpu_torch.models.train import DataParallelTrainer
from mlsl_tpu_torch.ops.cuda_build import DEFAULT_BUILD_DIR
from mlsl_tpu_torch.ops import a2a_kernels as a2a
from mlsl_tpu_torch.ops import attention_kernels as ak
from mlsl_tpu_torch.ops import quant_kernels as qk
from mlsl_tpu_torch.ops import ring_kernels as rk

HALVES = ("local_grads", "sync_and_update")
ENGINE_STEP = "engine_step"
GRAPH_STEP = "graph_step"
CLASSES = (
    ("codec", re.compile(r"quantize_rows|quant_ring_kernel")),
    # B9's wgmma backward passes; B9's forward in both forms (bu_sm90, the
    # CUDA-core fwd_kernel<T, NJ, true>); then both forms of B7/B8
    ("attention_b9_backward", re.compile(r"bu_dq_sm90|bu_dkv_sm90")),
    ("attention_b9_forward", re.compile(r"bu_sm90|fwd_kernel<[^>]*true>")),
    ("attention", re.compile(r"fwd_kernel|dq_kernel|dkv_kernel|fwd_sm90|dq_sm90|dkv_sm90")),
    ("alltoall", re.compile(r"a2a_kernel")),
)
# the library's kernels, after the port's own and after B9's backward range
LIBRARY_CLASSES = (
    # cuDNN's convolutions name their pass (fprop/dgrad/wgrad, implicit gemm)
    ("convolution", re.compile(r"conv|cudnn|implicit|wgrad|dgrad|fprop", re.I)),
    # cuBLAS's products by kernel name, as an H100 with torch 2.11 shows them:
    # float32 on the CUDA cores (cutlass_80_simt_sgemm_*, sm80_xmma_gemm_
    # f32f32_f32f32_f32_*_ffma_*), bf16 operands on the tensor cores
    # (nvjet_tss_* with a float32 result, nvjet_tst_* with a bf16 one), then
    # any other product
    ("matmul_f32_simt", re.compile(r"sgemm|simt|ffma|f32f32_f32f32", re.I)),
    ("matmul_bf16_tensor", re.compile(r"nvjet_t|bf16|gmma|hmma|tensorop", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|cublas|nvjet", re.I)),
)


def build_trainer(world=8, image=224, classes=1000, batch=64, seed=0, overlap_compiled=False):
    gen = torch.Generator().manual_seed(seed)
    env = get_env().init(world_size=world)
    model = resnet.ResNet50(num_classes=classes, generator=gen, device=env.device)
    dist = env.create_distribution(world, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(batch)
    trainer = DataParallelTrainer(
        env, dist, sess, model, resnet.loss_fn, resnet.layer_names(model),
        resnet.layer_subtree, compression=CompressionType.QUANTIZATION, lr=0.05,
        overlap_compiled=overlap_compiled,
    )
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, image, image, 3)).astype(np.float32)
    y = rng.integers(0, classes, size=(batch,)).astype(np.int32)
    return env, trainer, trainer.shard_batch(x, y)


# (dp, sp, tp, attention, configuration, blocks) of each transformer step
TRANSFORMERS = {"transformer-1": (1, 1, 1, "ring", tfm.GPT_MEDIUM_2K, 12),
                "transformer-8": (2, 2, 2, "zigzag", tfm.GPT_MEDIUM_2K, 12),
                "moe-8": (2, 2, 2, "zigzag", tfm.GPT_MEDIUM_2K_MOE8, 6)}


def build_transformer(dp, sp, tp, attention, base, n_blocks, batch=8, seed=0, zero1=False,
                      remat=None, sharded_vocab=False):
    if base.n_experts:
        os.environ.setdefault("MLSL_ALGO", "alltoall=pallas_a2a")
    kw = {}
    if zero1:
        os.environ.setdefault("MLSL_GRAD_BUCKET_MB", "25")
        os.environ.setdefault("MLSL_ALGO", "reduce_scatter=pallas_ring2d")
        kw = dict(distributed_update=True, optimizer=optim.adam(1e-4))
    cfg = dataclasses.replace(base, attention=attention, dtype="bfloat16", n_blocks=n_blocks,
                              remat=remat is not None, remat_policy=remat or "full",
                              sharded_vocab=sharded_vocab)
    env = get_env().init(world_size=dp * sp * tp)
    trainer = tfm.HybridTrainer(env, cfg, dp, sp, tp, batch=batch, lr=0.1, seed=seed, **kw)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, cfg.seq_len)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(batch, cfg.seq_len)).astype(np.int32)
    return env, trainer, trainer.shard_tokens(toks, labels)


def traced_step(trainer, batch) -> None:
    """One step as its two halves, each a named range ending in a
    synchronize, so the device work of each half lies inside its range; the
    compiled engine's step and the fused transformer's graph replay are one
    range each."""
    if getattr(trainer, "_overlap", None) is not None:
        with torch.profiler.record_function(ENGINE_STEP):
            trainer.step(batch)
            torch.cuda.synchronize()
        return
    if isinstance(trainer, tfm.HybridTrainer) and trainer.fused:
        with torch.profiler.record_function(GRAPH_STEP):
            trainer.step(*batch)
            torch.cuda.synchronize()
        return
    with torch.profiler.record_function(HALVES[0]):
        if isinstance(trainer, DataParallelTrainer):
            trainer._step_no += 1
            loss, grads = trainer._local_grads(batch)
        else:
            loss, grads = trainer._grad_fn(*batch)
        torch.cuda.synchronize()
    with torch.profiler.record_function(HALVES[1]):
        trainer._sync_and_update(grads, loss)
        torch.cuda.synchronize()


def _union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


# the range B9's wgmma backward opens around its passes and the PyTorch row
# terms beside them (ops/attention_kernels.block_update_bwd)
B9_BWD_RANGE = "block_update_bwd"


def _launched_in(events, name):
    """-> a predicate on kernel events: launched (its runtime call, matched
    by correlation id) inside a host range called ``name``."""
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "user_annotation" and e.get("name") == name and "dur" in e]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}

    def inside(kernel) -> bool:
        ts = launch.get(kernel.get("args", {}).get("correlation"))
        return ts is not None and any(a <= ts <= b for a, b in windows)
    return inside


def _span(kernels, lo, hi) -> float:
    """Kernel time inside [lo, hi): the union of the kernels' intervals."""
    return _union([(max(s, lo), min(t, hi)) for s, t, *_ in kernels if s < hi and t > lo])


def summarize(trace: dict, top: int, steps: int, engine: bool = False,
              graph: bool = False) -> dict:
    """Chrome trace of ``steps`` traced steps -> the per-step summary: the
    host path's two halves, the engine's step split at its first codec
    kernel, or the fused transformer's graph replay whole."""
    events = trace["traceEvents"]
    in_b9_bwd = _launched_in(events, B9_BWD_RANGE)
    kernels = [(e["ts"], e["ts"] + e["dur"], e["name"], in_b9_bwd(e)) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise SystemExit("profile_step: the trace holds no device kernel")
    names = (ENGINE_STEP,) if engine else (GRAPH_STEP,) if graph else HALVES
    windows = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "user_annotation" and e.get("name") in names]
    spans = []
    for name, a, b in windows:
        spans.append((name, a, b))
        if engine:
            codec = CLASSES[0][1]
            cut = min((s for s, t, n, _ in kernels if a <= s < b and codec.search(n)),
                      default=None)
            if cut is None:
                raise SystemExit("profile_step: an engine step launched no codec kernel")
            spans += [(HALVES[0], a, cut), (HALVES[1], cut, b)]
    halves = {h: {"wall_s": 0.0, "kernel_s": 0.0}
              for h in (names if graph else (*names, *HALVES))}
    for name, a, b in spans:
        halves[name]["wall_s"] += (b - a) * 1e-6 / steps
        halves[name]["kernel_s"] += _span(kernels, a, b) * 1e-6 / steps
    for h in halves.values():
        h["idle_share"] = 1.0 - h["kernel_s"] / h["wall_s"] if h["wall_s"] else None
    by_name = {}
    by_class = {c: 0.0 for c, _ in CLASSES}
    by_class["b9_backward_other"] = 0.0
    by_class.update({c: 0.0 for c, _ in LIBRARY_CLASSES})
    by_class["other"] = 0.0
    for s, t, name, b9_bwd in kernels:
        sec = (t - s) * 1e-6 / steps
        by_name[name] = by_name.get(name, 0.0) + sec
        cls = next((c for c, rx in CLASSES if rx.search(name)), None)
        if cls is None and b9_bwd:
            cls = "b9_backward_other"
        if cls is None:
            cls = next((c for c, rx in LIBRARY_CLASSES if rx.search(name)), "other")
        by_class[cls] += sec
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "halves": halves,
        "kernel_s_by_class": by_class,
        "kernels_per_step": len(kernels) / steps,
        "top_kernels": [{"name": n[:120], "s": v} for n, v in ranked],
    }


# the serving profile's classes: the port's kernels, then the library's
SERVE_RANGES = ("decode_step", "prefill")
SERVE_CLASSES = (
    ("kv_codec", re.compile(r"quantize_rows")),
    ("tp_reduction", re.compile(r"rhd_kernel|dense_ring_kernel")),
    ("gather_scatter", re.compile(r"index|gather|scatter", re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    *LIBRARY_CLASSES[1:],
)


def serve_summary(trace: dict, top: int) -> dict:
    """Chrome trace of the serving profile -> per range (``decode_step``
    averaged over its steps, ``prefill`` once): wall and kernel seconds, the
    idle share, kernels and kernel seconds by class."""
    events = trace["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise SystemExit("profile_step: the trace holds no device kernel")
    out = {}
    for rng in SERVE_RANGES:
        windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == rng and "dur" in e]
        if not windows:
            continue
        n = len(windows)
        inside = [k for k in kernels if any(a <= k[0] < b for a, b in windows)]
        wall = sum(b - a for a, b in windows) * 1e-6 / n
        busy = sum(_span(kernels, a, b) for a, b in windows) * 1e-6 / n
        by_class = {c: 0.0 for c, _ in SERVE_CLASSES}
        by_class["other"] = 0.0
        by_name = {}
        for s, t, name in inside:
            sec = (t - s) * 1e-6 / n
            by_name[name] = by_name.get(name, 0.0) + sec
            by_class[next((c for c, rx in SERVE_CLASSES if rx.search(name)), "other")] += sec
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        out[rng] = {"ranges": n, "wall_s": wall, "kernel_s": busy,
                    "idle_share": 1.0 - busy / wall if wall else None,
                    "kernels": len(inside) / n, "kernel_s_by_class": by_class,
                    "top_kernels": [{"name": k[:120], "s": v} for k, v in ranked]}
    return out


def profile_serve(args) -> dict:
    """The serving profile (``--model serve``): run (y1)'s engine with every
    slot filled, ``--steps`` decode steps timed untraced and as many traced,
    then one prefill and its write traced."""
    from mlsl_tpu_torch.serve import InferenceEngine

    os.environ.setdefault("MLSL_SERVE_MAX_BATCH", "4")
    os.environ.setdefault("MLSL_SERVE_KV_CACHE_MB", "4096")
    if args.kv_quant:
        os.environ["MLSL_SERVE_KV_QUANT"] = "1"
    cfg = tfm.GPT_MEDIUM_2K
    env = get_env().init(world_size=args.tp)
    try:
        eng = InferenceEngine(env, cfg, tp=args.tp, seed=0)
        rng = np.random.default_rng(0)
        new = 2 + args.warmup + 2 * args.steps + 1
        prompts = [rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)
                   for n in rng.integers(64, 1025, size=eng.max_batch)]
        for p in prompts:
            eng.submit(p, new)
        eng.step()                                # the prefills and the capture
        torch.cuda.reset_peak_memory_stats()
        for _ in range(args.warmup):
            eng.step()
        step_s = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            eng.step()                            # ends in the logits' readback
            step_s.append(time.perf_counter() - t0)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        dtype = cfg.dtype
        captured = eng._decode_cache[dtype]
        for m in (qk, rk, ak, a2a):
            m.reset_counts()
        padded = torch.zeros((eng.ctx_len,), dtype=torch.long, device=eng.device)
        padded[:prompts[0].size] = torch.from_numpy(prompts[0].astype(np.int64))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.steps):
                with torch.profiler.record_function(SERVE_RANGES[0]):
                    eng.step()
            with torch.profiler.record_function(SERVE_RANGES[1]):
                assert eng.cache.admit(-1, prompts[0].size + 1)
                _, k, v = eng._prefill(padded, prompts[0].size)
                eng._write(k, v, torch.as_tensor(eng.cache.table_padded(-1),
                                                 dtype=torch.long, device=eng.device))
                torch.cuda.synchronize()
                eng.cache.release(-1)
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
        with open(args.trace) as f:
            trace = json.load(f)
        out = {"device": torch.cuda.get_device_name(0), "model": "serve", "tp": args.tp,
               "kv_quant": eng.quant, "batch": eng.max_batch, "kv_pages": eng.cache.num_pages,
               "mlsl_algo": os.environ.get("MLSL_ALGO", ""),
               "pallas_rhd": env.config.pallas_rhd, "steps": args.steps,
               "decode_step_s": step_s, "peak_gib": peak_gib,
               "device_gib": torch.cuda.get_device_properties(0).total_memory / 2**30,
               "capture_s": captured.seconds,
               "launches_recorded": {k: v for k, v in captured.launches.items() if v},
               "traced_prefill_launches": {k: v for m in (qk, rk) for k, v in m.LAUNCHES.items()
                                           if v},
               **serve_summary(trace, args.top)}
        eng.close()
    finally:
        env.finalize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("resnet", *TRANSFORMERS, "serve"), default="resnet")
    ap.add_argument("--tp", type=int, default=1, help="the serving engine's model ranks")
    ap.add_argument("--kv-quant", action="store_true",
                    help="the serving engine with int8 KV pages (MLSL_SERVE_KV_QUANT=1)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--blocks", type=int, default=None,
                    help="a transformer step's depth (default: its own, see above)")
    ap.add_argument("--remat", choices=("full", "dots"), default=None,
                    help="a transformer step with remat and this remat_policy")
    ap.add_argument("--zero1", action="store_true",
                    help="a transformer step with Adam, ZeRO-1 and 25 MiB gradient buckets")
    ap.add_argument("--sharded-vocab", action="store_true",
                    help="a transformer step with the LM head sharded over the model axis")
    ap.add_argument("--overlap-compiled", action="store_true",
                    help="the resnet step on the compiled overlap engine, one CUDA graph")
    ap.add_argument("--trace", default=str(DEFAULT_BUILD_DIR / "profile_step.trace.json"),
                    help="where the Chrome trace is written (default: the git-ignored "
                         "build directory of the checkout)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: torch.cuda.is_available() is false: this needs a card",
              file=sys.stderr)
        return 1
    if (args.zero1 or args.remat or args.sharded_vocab) and args.model == "resnet":
        ap.error("--zero1, --remat and --sharded-vocab take a transformer model")
    if args.overlap_compiled and args.model != "resnet":
        ap.error("--overlap-compiled takes the resnet model")
    if (args.tp != 1 or args.kv_quant) and args.model != "serve":
        ap.error("--tp and --kv-quant take the serve model")
    if args.model == "serve":
        print(json.dumps(profile_serve(args)))
        return 0
    engine = {}
    if args.model == "resnet":
        env, trainer, batch = build_trainer(overlap_compiled=args.overlap_compiled)
        blocks = None
        if args.overlap_compiled:
            t0 = time.perf_counter()
            trainer.precompile(batch)
            torch.cuda.synchronize()
            engine = {"precompile_s": time.perf_counter() - t0,
                      "capture_s": trainer._overlap.capture_s["step"],
                      "launches_one_captured_step": trainer._overlap.capture_launches["step"],
                      "units": len(trainer._overlap.plan.units),
                      "plan_algos": trainer._overlap.plan.algos_summary()}
        step = lambda: trainer.step(batch)          # noqa: E731
    else:
        *shape, blocks = TRANSFORMERS[args.model]
        blocks = args.blocks or blocks
        env, trainer, batch = build_transformer(*shape, blocks, zero1=args.zero1,
                                                remat=args.remat,
                                                sharded_vocab=args.sharded_vocab)
        step = lambda: trainer.step(*batch)         # noqa: E731
    graph = isinstance(trainer, tfm.HybridTrainer) and trainer.fused
    bucket_mb = env.config.grad_bucket_mb
    try:
        for _ in range(args.warmup):
            step()
        torch.cuda.synchronize()
        step_s = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if graph:
            compiled = trainer.compiled_step(*batch)
            engine = {"capture_s": compiled.capture_s,
                      "launches_recorded": {k: v for k, v in compiled.launches.items() if v},
                      "flops": compiled.cost_analysis()["flops"],
                      **compiled.memory_analysis()}
        for m in (qk, rk, ak, a2a):
            m.reset_counts()
        stats.reset_bucket_counters()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.steps):
                traced_step(trainer, batch)
        launches = {**qk.LAUNCHES, **rk.LAUNCHES, **ak.LAUNCHES, **a2a.LAUNCHES}
        buckets = dict(stats.BUCKET_COUNTERS)
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
        with open(args.trace) as f:
            trace = json.load(f)
    finally:
        env.finalize()
    req = trainer.ops[trainer.layers[0]].get_parameter_set(0).grad_req
    out = {"device": torch.cuda.get_device_name(0), "model": args.model, "steps": args.steps,
           "ring": req.algo if req is not None else None,
           "mlsl_algo": os.environ.get("MLSL_ALGO", ""),
           "blocks": blocks, "remat": args.remat, "zero1": args.zero1,
           "sharded_vocab": args.sharded_vocab, "graph_step": graph,
           "grad_bucket_mb": bucket_mb, "traced_bucket_rounds": buckets,
           "step_s": step_s, "peak_gib": peak_gib,
           "device_gib": torch.cuda.get_device_properties(0).total_memory / 2**30,
           "traced_launches": launches, "overlap_compiled": args.overlap_compiled, **engine,
           **summarize(trace, args.top, args.steps, engine=args.overlap_compiled,
                       graph=graph)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
