#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mlsl_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. build     nvcc builds every kernel of the path from mlsl_tpu_torch/csrc,
             one process per source, all started together, and g++ the
             port's C library (mlsl_tpu_torch/capi/c_api.cpp) and the four
             unchanged C/C++ programs linked to it (capi/build.py), while
             the rest of the program starts up.
2. parity    each kernel's wrapper against its plain PyTorch version on the
             card, at the shapes the training, feed and serving paths give
             it and at edge shapes (odd blocks, blocks above 512 and 2,048,
             views off a 16-byte boundary on the codec's scalar path): int8
             values, scales and dequantized values bit-exact;
             the ring (B3, B4), its all-gather mode (B3-AG) and
             halving/doubling (B5) kernels bit-exact on small groups of 2 to 8
             members, every dtype, both directions, the snake order, ragged
             counts and shards, strided rows and -0.0. Beside it and configs
             1-4 (which time nothing), the card's own tests,
             mlsl_tpu_torch/cuda_tests (each kernel against its plain
             version, no JAX), in a subprocess, joined before config 5: every
             test must pass.
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
8. algos     the collective algorithm engine, each algorithm forced through
             MLSL_ALGO and driven through Distribution.all_reduce /
             reduce_scatter on 8 virtual ranks at 256 MiB of float32 per rank:
             lax, rhd, pallas_ring (kernel B3) and pallas_rhd (kernel B5);
             pallas_ring in bfloat16 and int32 and with the bidirectional
             split at 64 MiB per rank; on the (4, 2) grid pallas_ring on both
             axis groups and ring2d and pallas_ring2d (B3 over the snake
             cycle) on the global group. Each kernel result is bit-exact
             against its plain version on the same inputs, int32 results
             equal the closed form, float32 results lie within 1e-6 relative
             L2 error of a float64 sum, and req.algo names the forced
             algorithm. One line per algorithm gives its time and algbw.
9. small     with MLSL_PALLAS_RHD=1 and nothing forced, 4 KiB and 40,000 B
             allreduces select pallas_rhd and 40,004 B does not; a 6-rank
             group (the pre/post fold) bit-exact against the plain version.
10. config 4 again with MLSL_ALGO=pallas_ring: the int8 allreduce on the
             fused ring (kernel B4), outputs and residuals bit-exact against
             the plain B4 + B1 run, err_len that of quant_geometry.
11. config 5 again with MLSL_ALGO=pallas_ring: three ResNet-50 steps on the
             fused ring, B4 and B1 launched once per layer request and step,
             the last step's gradients bit-exact against the plain fused ring.
12. attention the flash kernels against their plain versions on the card:
             B7 and B8 (both passes) at the transformer's (128, 2048, 64),
             causal, bf16, in the wgmma form (csrc/attention_sm90.cu, which
             ptxas must compile without spills) and, by request, in the
             CUDA-core form; the wgmma form also at head_dim 128, non-causal,
             Sq != Sk, per-row offsets that mask whole rows and offsets that
             skip whole tiles, held within 2e-3 relative L2 of the plain
             versions that round P and dS to bf16 as it does and within 1e-2
             of the float32 ones; B9 at the zigzag chunk (256, 512, 64), diagonal
             and full, and at the ring's (256, 1024, 64) with per-row
             offsets that mask every row of half the ranks, in its wgmma
             form with the winners (within 2e-3 of the plain version that
             rounds P in 64-key tiles as it does, m and l 1e-5; m' equal to
             m bit for bit where no key beat it; the winners the first
             argmax but at near-ties) with its backward at random
             cotangents (dq, dk, dv within 2e-3 of the closed form that
             rounds P, dS and ga to bf16 as the passes do, dacc, dm, dl
             1e-5), also at head_dim 128, and by request in its CUDA-core
             form; edge shapes (Sq/Sk 128 and 256, head_dim 8, 16, 24, 128,
             float32 and bf16, causal and not, offsets that mask whole
             rows). Relative L2 error under 1e-5 in float32 and for the lse
             and the carried state, 1e-2 for bf16 outputs against the
             float32 plain versions; fully masked rows, and keys no query
             sees, exactly 0 (B9: their state unchanged). The card tests of
             phase 2 include the tile layer's own product test
             (cuda_tests/test_sm90_tiles.py).
13. gpt-medium-2k on 1 rank (vocab 32,768, d_model 1,024, 16 heads of 64,
             12 blocks, seq 2,048, batch 8, bf16): three fused steps on one
             batch at lr 0.1. The first loss within 1.0 of ln 32,768, the
             third below the first; B7, B8 dq and B8 dk/dv launched 12 times
             a step in the wgmma form and never in the CUDA-core form, B9
             and its backward never.
14. gpt-medium-2k on 8 ranks, dp=2 x sp=2 x tp=2, zigzag attention,
             per-layer Start/Wait over the data x seq group, three steps:
             losses as above, B9 launched 60 times a step (5 a block) in
             its wgmma form and never in its CUDA-core form, each of its
             backward passes 60 times, B7 and B8 never, and every layer's
             reduced gradient within 1e-6 relative L2 error of the float64
             sum of its rank rows. Then ring attention at 2 blocks: B9 with
             per-row offsets and its two backward passes, 2 launches each a
             block and step. Each run prints its step seconds,
             tokens/s and the last step's split.
15. a2a parity the fused all-to-all B6 against its plain version, bit for
             bit, dense and int8: the data group of an 8 x 1 world, both
             single-axis groups of a (4, 2) world, two-axis groups, counts
             that need chunk padding, strided rows, blocks 128 to 1,024,
             all-zero blocks and -0.0, and the stateful error-feedback form
             over 2 rounds (outputs and residuals); then the MoE combine
             exchange at the path's own shape (4,194,304 floats a rank over
             the model axis of a (4, 2) world, block 256): both variants, the
             error-feedback form with B1 at the path's 131,072 x 256 rows
             (which phase 2 also checks alone), and the differentiable route
             the MoE layer takes, its forward and its gradient.
16. alltoall Distribution.all_to_all on 8 ranks at 64 MiB a rank through a
             CommRequest: lax, then MLSL_ALGO=alltoall=pallas_a2a dense
             (MLSL_PALLAS_A2A_QUANT=0) on random floats and int8 on the
             exact-scale payload, each bit-exact to lax; one line a route
             with its time and algbw.
17. gpt-medium-2k-moe8 (gpt-medium-2k's widths, 8 experts, top-1, capacity
             factor 2.0, aux weight 0.01) at its 12 blocks under remat
             "full" (run (d)) on 8 ranks, dp=2 x sp=2 x tp=2 (ep = 2),
             zigzag, batch 8, MLSL_ALGO=alltoall=pallas_a2a, three steps:
             losses and reduced gradients as in 14, the peak under the
             card's memory; per step B6 int8 twice a block (the float32
             combine exchange, in the forward and in its replay), B6 dense
             once a block (its backward), the entry quantize (B1) twice a
             block, B9 (wgmma) 10 times a block and each of its backward
             passes 5 times; then one no-grad forward of the loss on the
             same weights with the exchange on pallas_a2a and on lax, within
             0.005 of each other.
18. zero1    ResNet-50 at full width (224x224, 1000 classes, seed 0) on 8
             virtual data ranks with distributed_update=True, optim.adam(1e-3),
             clip_global_norm=1.0 and MLSL_ALGO=reduce_scatter=pallas_ring:
             three step_accum steps of two micro-batches of 64. Losses finite;
             after every step every rank's gathered increment bitwise the
             same; B3 (reduce_scatter) 18 times a step, B3-AG never (the
             increment all-gather is lax, as in JAX); each layer's Adam state
             a rank owned_kernel_count wide. Then the same steps with
             replicated Adam (distributed_update=False, B3 allreduce): every
             layer's parameters within 1e-5 relative L2 of the ZeRO-1 run.
             Step seconds and images/s of both.
19. staged   comm.overlap.build_zero1_update over ResNet-50's 18 layer counts:
             pallas_ring on the data group of an (8, 1) world at stages 1 and
             3, pallas_ring2d on the global group of a (4, 2) world. Integer
             inputs (lr 0.5, denom 8) bit-exact against p - lr * sum(g) /
             denom on every rank, random float32 inputs bit-exact against the
             same build_zero1_update on the plain versions; 18 B3 and 18 B3-AG launches
             a call.

20. config 3 buckets (run (g), right after 11): config 5 on the fused int8
             ring with MLSL_GRAD_BUCKET_MB=25 (PyTorch DDP's default
             bucket_cap_mb), three steps: every bucket and every layer left
             alone takes pallas_ring; B4 and B1 launched once per request and
             step; every round dispatched, none fallen back; the last step's
             bucket results and residuals bit-exact against the plain B1 + B4
             on the same packed gradients and residuals, the same on every
             rank; mean losses within 2 % of the unbucketed run 11's.
21. zero1 transformer (run (f), right after 14): gpt-medium-2k at 12 blocks
             on (b)'s grid with optim.adam(1e-4), distributed_update=True,
             MLSL_GRAD_BUCKET_MB=25 and MLSL_ALGO=reduce_scatter=pallas_ring2d,
             three steps: losses as in 13; B3 once per reduce_scatter request
             a step (buckets plus the layers left alone), B3-AG never (the
             increment all-gather is lax), B9 and its passes as in 14; every
             bucket round dispatched; the last step's reduce_scatters (each
             bucket on its packed gradients, each layer left alone on its
             own) bit-exact against B3's plain version; each data x seq
             group's ranks hold the same parameter bits; each layer's Adam
             state owned_kernel_count wide. Then the same weights and data
             with replicated Adam, unbucketed: each layer's change from the
             shared initial weights within TFM_ZERO1_TOL_STEP1 (after step 1)
             and TFM_ZERO1_TOL_STEP3 (after step 3) relative L2 of the ZeRO-1
             run's, with two planted faults read beside them and required
             outside those tolerances; its Adam state about 4x as large. Both
             runs' step seconds, tokens/s and peak memory.
22. lax buckets (right after 9): MLSL_ALGO=lax, one gradient bucket of five
             sets (77 to 1,048,600 floats) against the same sets unbucketed,
             random floats, allreduce and ZeRO-1's reduce_scatter on groups of
             8 and 4: every member's result bit-exact with its own request's.
             Then lax's one-pass SUM timed against the member loop the CPU
             runs, at 256 MiB a rank.

23. engine int8 (run (h), right after 20): config 5 on the compiled overlap
             engine (overlap_compiled=True, int8 on the composed ring, B1): the
             step captured as one CUDA graph by precompile, then 3 replayed
             steps, held to run 7 (the host Start/Wait path from the same
             initial state; runs 7 to 26 take cuDNN's deterministic
             convolutions): losses within rtol 1e-6 and parameters within 1e-6
             (the JAX package's twin tolerances), the largest gaps printed; B1
             recorded 162 times into the graph (9 a layer). Step seconds and
             images/s of both, the capture's seconds.
24. engine fused ring (run (i)): 23 under MLSL_ALGO=pallas_ring, every unit
             on B1 + B4, 18 of each a graph, held to run 11.
25. engine buckets (run (j)): 23 uncompressed under MLSL_ALGO=pallas_ring
             with MLSL_GRAD_BUCKET_MB=25: fewer units than layers, one B3 a
             unit, held to the bucketed host path run here; the plan's units
             and algorithms printed.
26. overlap_updates (run (k)): config 5 int8 with overlap_updates=True (each
             layer polled with TestGradientComm and updated as it lands)
             held to run 7, the barrier path, with the same tolerances; B1 162
             a step.
27. multi reduce (run (l)): comm.overlap.build_multi_reduce over ResNet-50's
             18 layer counts on 8 ranks for pallas_ring (B3), pallas_rhd (B5),
             lax and rhd on integer-valued payloads, and int8 on the composed
             ring (B1) and the fused ring (B1 + B4) over 3 rounds: each
             captured as one CUDA graph, replayed, bit-exact against the same
             plan on the plain versions run eagerly (results and residuals);
             ms a call eager and replayed.

28. activation graph (run (m), after 18-19): first the port's walkthrough
             (mlsl_tpu_torch/tools/mlsl_example.py: examples/mlsl_example.py's
             calls on a data 4 x model 2 grid), then tests/test_e2e_graph.py's
             two CC ops (FM1 -> FM2 -> FM1) at gpt-medium-2k's MLP widths (FM1 =
             d_model 1,024, FM2 = d_ff 4,096, fm_size 1, 8 x 2,048 = 16,384
             tokens, float32, 8 ranks) through the reference loop
             (mlsl_test.cpp:660-698): pack and start FPROP, wait, start BPROP and
             wait, then each parameter set's gradient request; two checked
             iterations, then three timed. (m1) case 1 at model 2 and 4; (m2)
             cases 2 and 3 from (data 4, model 2); (m3) cases 4 and 5 between
             (8, 1) and (2, 4); (m4) (m1) at model 2 with int8 sets; (m5) (m1) at
             model 2 with the distributed update. (m1)-(m4) under SPEC_RING (B3
             for every allreduce and reduce_scatter) and SPEC_RHD (B5 for the
             allreduces), B6 dense for every alltoall, MLSL_STATS=1 (the
             isolation replay at commit, the statistics table). Every round
             against its closed form (float64 sums within 1e-6, int8 sums within
             2 %, concatenations and alltoall moves bit for bit) and against the
             plain version of the same plan bit for bit (residuals too); each
             variant's launches equal PREDICTED_M. One line a variant: launches,
             worst errors, commit and isolation seconds, loop iteration seconds,
             peak GiB, the overlap fraction; one with each request's ms and
             algbw; the first lines of the statistics table of (m1) at model 4.
29. collectives (run (n)): every kind (allreduce with each op, reduce,
             bcast, allgather, allgatherv, gather, scatter, reduce_scatter,
             alltoall, alltoallv in matrix and per-rank form from SEED,
             sendrecv on ring pairs) and the barrier through Distribution on a
             (4, 2) grid's data and model groups, equal color groups (p % 2,
             p // 4) and ragged ones (3 + 5; allgatherv and alltoallv are
             refused there), 16 MiB a rank, float32 and int32, against closed
             forms computed on the card (float64 sums within 1e-6, the rest bit
             for bit); gather_to_host; configure("color=...") restricting the
             world; no kernel launches. ms a call.
30. mxu (right after 12): ops/mxu.mxu_einsum on bf16 operands at
             gpt-medium-2k's attention output projection and MLP second
             product (run (a)'s shapes) and the MoE's first expert product
             (run (d)'s, with the experts' broadcast ep dim), forward and both
             gradients on the tensor cores (torch.bmm with a float32
             out_dtype), held to the plain float32 version on the same
             inputs: forward within MXU_FWD_TOL, gradients within
             MXU_GRAD_TOL relative L2; times of both routes beside the bf16
             tensor-core bound. Every transformer run (13, 14, 17, 21) checks
             that each block's mxu_einsum products ran on the tensor cores
             (forward and both backward products: 2 a block, 3 with experts).

31. capi programs (run (o1), beside parity and configs 1-4 with the card
             tests, joined before config 5): the four unchanged programs
             (native/test_c_api.c, native/test_cpp_api.cpp,
             examples/compat_example.cpp, native/compat_test.cpp over the
             reference matrix group_count 1, 2, 4 x dist_update 0, 1 and the
             use_test run) against the port's library on the card with
             MLSL_ALGO=pallas_ring, then test_c_api under pallas_rhd and
             alltoall=pallas_a2a: each exits 0 with the lines
             tests/test_c_api.py and tests/test_compat.py assert, and prints
             its launches when it finalizes (a sitecustomize on its
             PYTHONPATH); the pallas_ring runs launched B3, the pallas_rhd run
             B5.
32. remat (run (p), right after 17): gpt-medium-2k-moe8 at 6 blocks, one
             batch's gradient rows before sync twice without remat, then
             under "full" and "dots" on the same weights: losses bit for bit;
             every layer bit for bit where the two plain runs agree bit for
             bit, else within REMAT_TWIN_TOL. Then run (a) under "full" and
             "dots": three steps each, the first loss bit for bit the plain
             run's, B7 launched twice a block and step, B8's passes once;
             step seconds and peak memory beside plain (a)'s.
33. capi in process (run (o2), after 29): the port's library loaded with
             ctypes, its entry reusing this interpreter (and so these launch
             counters), MLSL_ALGO=SPEC_RING: an 8 x 256 MiB float32 allreduce
             SUM on B3, config 4 (64 MiB a rank int8 set through
             mlsl_environment_set_quantization_params(NULL, ..., 256, 256),
             two rounds, B1 + B4), config 5's per-layer graph (ResNet-50's 18
             layer counts int8 through the session / reg info / parameter set
             calls, 3 iterations) and a 64 MiB a rank all-to-all on B6 int8,
             each from numpy host buffers and held bit for bit, and launch
             for launch, to the same calls through the Python API on the same
             buffers; one line a case with the host -> card copy, the
             collective, the card -> host copy and the algbw.

34. codecs (run (t), after 33): config 5 on the host path with the
             compressed wires beyond int8, each sub-run's step seconds beside
             an uncompressed config 5 run of the same call: (t1) TOPK at
             MLSL_TOPK_RATIO=0.01 on all 18 gradient requests, the first
             round equal to the float64 sum of the ranks' top-k contributions
             within the float32 sum bound, the error feedback telescoping
             over the 3 rounds, the ring merge forced on fc against the
             all-gather format; (t2) MLSL_CODEC=f32 (its first round's
             gradients against the uncompressed run's within the float32 sum
             bound), then prune and vq (each chunk's new residual is (x +
             e_old) - decode(encode(x + e_old)) bit for bit), each codec's
             wire bytes in the statistics equal to wire_len x the rounds;
             (t3) MLSL_TUNE_CODEC=1 at commit on the 18 sets (every int8
             candidate on B1 + B2, launches counted), the profile written
             under build/, a fresh Environment routing each set to its
             assigned codec, one guardrail demotion through codecs.guard_note
             whose residual is flushed exactly once, then rounds bit for bit
             a fresh int8 request's; (t4) native/sample_codec.c compiled
             with gcc into build/mlsl_tpu_torch/ and registered through
             set_quantization_params: a 16 MiB-a-rank allreduce (config
             4's request cut to a quarter for the smoke's wall, ROADMAP
             C.14) for 2 rounds bit for bit against the same collective on
             the CPU,
             with the time split between host copies and codec calls, then
             one C-entry registration through c_shim.

35. hier (run (u), after 34): the two-tier lowering on the 8 virtual ranks
             split by MLSL_MESH_TIERS. (u1) BASELINE's 8 x 256 MiB float32
             allreduce and a reduce_scatter under MLSL_ALGO=hier on the 2x4,
             4x2 and 1x8 splits: random floats within SUM_RTOL of the float64
             sum, one ``# algos hier ...`` line each (time, algbw, launches:
             none, hier has no kernel), integers bit for bit against lax.
             (u2) config 4's 64 MiB-a-rank int8 allreduce on the ring="hier"
             wire: the sentinel payload (tests/test_hier.py:226-233) on the
             three splits gives the exact integer sum, bit for bit the flat
             ring's, zero residuals; on 2x4 each DCN codec (int8, f32, topk,
             prune, vq), random payloads, 2 rounds bit for bit (outputs and
             residuals) against an independently built hier.quant_body; f32
             bit for bit the dense hier on integers; each codec's encoded
             shard, ring-modelled, equal to hier.dcn_wire_bytes. (u3) config 5
             on 2x4 with int8 forced onto hier (cuDNN's deterministic
             convolutions): a flat int8 step from run 7's state (its loss run
             7's first, bit for bit), then 3 host hier steps, losses finite and
             falling, each layer's first-step reduced gradient no farther from
             the exact rank sum than the flat step's plus amax/127; fc demoted
             through demote_codec, its shard residual flushed once at each
             member's logical offset, then rounds bit for bit the twin wire's;
             the compiled overlap engine with 18 staged hier units as one CUDA
             graph, 3 steps bit for bit against the host run.
36. tuner sweep (run (v), after 35): MLSL_TUNE=1 MLSL_TUNE_QUANT=1 at
             Environment.init on the 2x4 world with MLSL_TUNE_SIZES=TUNE_SIZES,
             the profile written to TUNE_PROFILE under build/: every cell's
             winner its fastest candidate, B1, B3, B4, B5 and B6 launched,
             quantized cells timing hier; each cell, the knobs (with the chunk
             probe's large_single_us / large_chunked_us) and the sweep's
             seconds and launches printed. A fresh Environment on the profile
             takes 2 config 5 steps, every gradient request (or its bucket's)
             on the lowering its quantized cell names; a flat world rejects the
             profile with a warning.

37. feed (run (w), after 36): config 5 (ResNet-50, 224 x 224 x 3, global
             batch 64 on 8 data ranks, cuDNN deterministic, lr FEED_LR) fed
             through trainer.feed, 2 epochs of 4 batches from SEED: (w1) raw
             uint8 images normalized by ImageNet's mean and std on the card,
             the epoch cached: the first decoded batch bit for bit the host's
             float32 math, the first 3 losses bit for bit the same trainer's
             fed by shard_batch on the host-decoded batches, epoch 2 staging
             nothing (every read a cache hit); (w2) float32 images on the int8
             wire: B2 launched once a decoded batch (8), the decoded batch bit
             for bit dequantize_blocks_ref of the numpy encode, wire and full
             bytes those of the layout; (w3) (w1)'s feed at depth 2 into the
             compiled overlap engine (MLSL_OVERLAP_COMPILED=1), its step
             captured while the loader's worker runs (held off the card for
             the capture by graph_capture.CAPTURE_LOCK), the first 3 losses
             within the twin tolerances of (w1)'s. One line a batch: wire and full
             bytes, the copy's and the decode's ms on the card, the loader's
             stall and producer wait, the step seconds (and shard_batch's).
38. pipeline (run (x), after 37): 12 residual MLP blocks at gpt-medium-2k's
             widths (d_model 1,024, d_ff 4,096, float32) on a (2 data x 4
             model) grid, 8 microbatches of 1,024 tokens a data shard: GPipe
             (pipeline_loss and autograd, remat off and on), 1F1B and
             interleaved 1F1B (3 chunks of 1 block), each against a dense
             oracle (the 12 blocks in sequence on each data shard) within
             PIPE_LOSS_RTOL and PIPE_GRAD_TOL; 1F1B's peak memory below
             GPipe's; then reduce_microbatch_grads of 1F1B's stage gradients
             over the data group on B3 (MLSL_ALGO=pallas_ring), B5
             (pallas_rhd) and int8 (B1 + B4), launches as the plan predicts,
             each bit for bit its plain version; inline_allreduce forced to
             B3 and to B5. One line a schedule (step seconds, peak GiB, bubble
             share) and one a reduction route (ms a call).
39. serve (run (y), after 38): gpt-medium-2k (bf16, weights from
             init_params with torch.Generator seed 0) served through
             InferenceEngine -> submit -> run, 32 new tokens a request, 4
             slots, 4,096 MiB of KV pages of 16 tokens, prompts of 64-1,024
             tokens (from SEED). (y1) tp = 1, float32 KV: 240 requests
             arriving as a Poisson stream of 12 a second after one warm-up
             request; TTFT from each
             arrival, the gaps between a request's tokens (all, and those a
             joining prefill stalled), TPOT and the decode step's own time,
             each with the percentiles its sample supports; two planted
             faults (positions off by one, block 0's K/V write lost) must
             fail the oracle rule. (y2)-(y5b) take the first 8
             requests at once. (y2) tp = 2 with MLSL_PALLAS_RHD=1: B5 twice a
             block in the decode graph, never in a prefill; (y3) tp = 2 with
             MLSL_ALGO=allreduce=pallas_ring: B3 twice a block in each prefill
             and in the graph; (y4) tp = 1 with MLSL_SERVE_KV_QUANT=1: B1 twice
             a prefill write and twice a block in the graph, B2 twice a block
             in the graph, the pools bit for bit the plain kv_block_quant of
             the same K and V, the first tokens (y1)'s; (y5a) two 1,000-token
             prompts, 48 new tokens, 2 slots and 129 pages: the younger
             evicted and resumed; (y5b) the float32 model with two forced
             sheds mid-run: the bf16 graph captured mid-run, finite logits, the
             SERVE lines of the sheds and the recoveries, then, the ladder
             recovered, two requests held to the float32 rule
             (SERVE_F32_DELTA), which all three planted faults (block 11's
             K/V write lost too) must fail. Each sub-run's graph
             records its kernels once and its capture's warm-up launches them
             once more; SERVE_ORACLE's requests a sub-run against the unpaged
             oracle under the card's rule (every step's logits within
             SERVE_DELTA of the oracle's on the engine's own stream); the
             decode graph bit for bit against the same step run eagerly
             ((y1), (y2), (y4)). One line a sub-run.

40. integrity (run (aa), after config 4, beside the card tests): config 5
             (ResNet-50 at full width, int8 on the composed ring, 8 ranks).
             (aa1) MLSL_SENTINEL_GATE=skip_step on the host path and on the
             compiled engine's split graph: a train.grads plan of 1e8 and a
             NaN plan each skipped, the parameters and residuals bit for bit
             as before, a twin that never saw them bit for bit equal after
             the next step, 'rollback' raising MLSLIntegrityError with the
             state untouched; the gated step against the ungated twin's and
             the screen alone. (aa2) MLSL_SENTINEL_EVERY=1, one step each
             from the same weights: one digest for the plain and bucketed
             trainers on lax (uncompressed, bit-exact), the int8 trainer's
             step through B1 and B4 moving it, that state loaded into the
             plain trainer giving the int8 trainer's digest, a sampled leaf's
             block sums against numpy's, a flipped bit changing the digest,
             ZeRO-1's owned shards (Adam, one step); the audit's ms a call. (aa3) MLSL_CHKP: a short bucket member refused at the
             pack; a NaN in one of three allreduces named at the round's first
             wait with one host read; a bitrot plan on the int8 wire decoding
             finite but different values, the cache replaying the clean copy
             next epoch. (aa4) MLSL_AUTO_CONFIG_TYPE=1: the card's class and
             row applied, an exported knob winning. (aa5), two processes
             beside the card tests: one builds the smallest kernel source
             into a fresh MLSL_COMPILE_CACHE_DIR, the next loads it with nvcc
             refused.

41. recovery (run (ab), after run (aa), beside the card tests): config 5
             at full width (ResNet-50, 1,000 classes, 224², global batch 64,
             seed 0), ZeRO-1 Adam, MLSL_ALGO=pallas_ring, cuDNN's
             deterministic convolutions. (ab1) FaultTolerantLoop, save_every
             2, 6 steps on 8 ranks, MLSL_SENTINEL_EVERY=1: an OSError at the
             first save retried, a bitrot plan on step 4, a fault at step 5
             from the fault hook; the restore skips step 4, takes step 2 and
             replays 3-5; the final parameters and Adam state bit for bit
             the uninterrupted twin's, one recovery, on_step once a step, the
             re-audit passing, every manifest with the audit's fingerprint;
             the write of step 2 held until step 3 has updated in place, the
             checkpoint still step 2's state bit for bit. (ab2)
             MLSL_MESH_TIERS=2x4, MLSL_ELASTIC=1: a device.lost plan at step
             3 (rank 7 shed) drops tier 1 (8 -> 4), the drain 36 B3-AG
             launches, verify_reshard green, the placed Adam state the
             gathered vector re-partitioned, no restore; step 3 a 4-rank
             twin's and, after announce_return(), step 4 an 8-rank twin's
             bit for bit; a second loss at 5 and a grow at 6 under a silent
             plan: refused, re-synced, admitted; the ELASTIC counters
             exactly the transitions. (ab3) SIGTERM after step 2: one final
             save, the loop returns preempted, a new loop resumes and ends on
             (ab1)'s twin bit for bit. (ab4) a 3-member pod on 127.0.0.1: a
             member's death committed as one epoch drives (ab2)'s shrink
             with zero restores. Save, restore, sha256, drain, plan-verify,
             placement and rebuild times in the ``# recovery`` lines.
42. analysis (run (ac), after run (ab), beside the card tests): the static
             analysis on the card. (ac1) config 5 (ResNet-50 at full width, 8
             virtual ranks) committed under MLSL_VERIFY=1 in three forms, each
             beside its MLSL_VERIFY=0 twin: int8 gradients in 25 MiB buckets
             on pallas_ring (B1 + B4); ZeRO-1 Adam on pallas_ring (B3 reduce-
             scatters), then the staged ZeRO-1 update over its layer counts
             (B3 + B3-AG; not a committed plan, so no verifier covers it in
             either package); the compiled engine's int8 plan on the fused
             ring (verify_overlap_plan where the engine is built, then one
             replayed step on B4). Each commit green, one step of each bit
             for bit its twin's, verify ms against commit ms. (ac2) run (m)'s
             graph at gpt-medium-2k's MLP widths on B3, B5 and B6 committed
             under MLSL_VERIFY=1, green, one checked round. (ac3) the
             misordered-groups fixture: MLSLError naming MLSL-A101 under
             ``error``; under ``warn`` it commits with the verdict in
             supervisor.status()["analysis"] and on the ANALYSIS line. (ac4)
             ``python -m mlsl_tpu_torch.analysis``, ``--concurrency`` and
             ``--graph`` (on the card) exit 0, in subprocesses started with
             the run.

43. multiprocess (run (ad), after run (ac), beside the card tests): the
             multi-process transport (comm/transport.py). (ad1) two processes
             on cuda:0 over gloo (every cross-process hop staged through host
             memory), started with the card tests so that they run beside
             parity, configs 1-4 and runs (aa)-(ac), 4 virtual ranks each,
             each the worker of
             mlsl_tpu_torch/tools/mp_worker.py under MLSL_ALGO=SPEC_RING with
             B6 dense: the JAX package's multi-process matrix (the hierarchy
             contract, gather_to_host, the reference loop on the 4 x 2 grid,
             model parts 1, 2, 8 x ZeRO-1 off and on), every collective kind
             on the two grids' groups and on color groups, an MLP trained by
             shard_batch and by shard_batch_local, run (m)'s graph at
             gpt-medium-2k's MLP widths (the model groups inside each process on
             B3 and B6, the data group's gradient across processes), and two
             config 5 steps (ResNet-50, 224 x 224, 1000 classes, global batch
             64) replicated and ZeRO-1; then the direct alltoall, bcast and
             sendrecv against their assembled form (phase exchanges), the
             compressed wires at config 4's size, 64 MiB a rank over the
             8-rank data group, three rounds with the residual carried: the
             int8 allreduce and reduce_scatter (B1 on every hop, the int8
             rows and scales crossing by the ring shift), top-k at 0.01 in
             both formats and the prune codec (phase wires), and two config 5
             steps on config 4's int8 ring in 25 MiB buckets, replicated and
             ZeRO-1 (phase resnet_int8; the forced pallas_ring keeps the
             composed ring on the spanning data group). Each child checks
             the closed forms on its own ranks; this process runs the same
             worker as one process of 8 ranks beside them (the int8 phases
             without AD_VARS, so that it takes the same composed ring) and
             holds every row to it: moves, integer-valued sums, the wires'
             digests and samples, config 5's ring inputs and its int8
             gradients and parameters bit for bit, float sums within 1e-6,
             config 5's float first-step reduced gradients within 1e-6
             relative L2 a layer (its twin is never free-running), both
             processes' parameters bit for bit. A child that fails, exits
             non-zero or outlives AD_TIMEOUT fails the run. (ad2) NCCL in a one-process world: each
             hop (all_reduce, reduce_scatter, all_gather, broadcast) on a 64
             MiB CUDA tensor and the spanning forms on a (4, 2) grid's groups
             bit for bit their plain versions; config 5's step on it bit for
             bit the transport-less step. Printed: the backend, the process
             count, the bytes that crossed processes a config 5 step (float
             and int8, by dtype), the ring shifts a step, each hop kind's
             staging and wire seconds, the int8 step's time over the float
             step's, the direct exchanges' bytes against the assembled
             form's, the phase's wall time, the card and its limit.
             (ad1) then runs the trainers across the two processes
             (AD_TRAINER_PHASES, ROADMAP A.8b.4; the twin beside them with
             AD_VARS too): HybridTrainer at gpt-medium-2k's full widths, two
             blocks, two steps, on run (b)'s grid with zigzag (the data axis
             spans the processes; ZeRO-1 off, then on) and on dp 1 x sp 2 x
             tp 4 on the ring with the head sharded (the seq axis spans: the
             K/V shifts and their cotangents cross, B9 folds what arrived);
             gpt-medium-2k-moe8 at two blocks, tp 8, batch 2 (the model axis
             spans: the model sums and the expert exchanges cross on the
             transport, never B6, and the fused step runs eagerly); GPipe
             and 1F1B of run (x)'s MLP blocks at gpt-medium-2k's widths over
             the 8 stages of the (1, 8) grid, each against the dense oracle
             within (x)'s bounds; config 5 fed through trainer.feed on the
             int8 wire (B2), two batches, replicated and ZeRO-1, each
             decoded box and loss bit for bit those of the same trainer fed
             by shard_batch. Held to the twin: the attention's outputs and
             gradients on their own (B9 forward and backward), the decoded
             feed batches and the first fed losses bit for bit; each rank's
             CE and gradient rows before the sync (their digests counted:
             a 4-rank box's reductions may differ from the 8-rank twin's in
             the last bits, ROADMAP C.19), the first step's reduced
             gradients and the pipelines within AD_RTOL relative L2 a
             layer; the parameters after two steps and the second losses,
             a free-running twin (C.11), reported; every rank of a model
             shard holds the same parameter bits in either process, and
             both return the same world losses, the first within AD_RTOL
             of the twin's.
             Printed (``# multiprocess ad1 trainers``): each case's bytes a
             step by hop kind (shift, axis sum, all-to-all, the gradient
             requests' all_reduce / reduce_scatter / all_gather), their
             staging and wire seconds, and its step time against the twin's.
             (ad1) then serves across the two processes and restricts the
             world (AD_SERVE_PHASES, ROADMAP A.8b.4's last piece and A.8b.5;
             the twin beside them with AD_VARS too): gpt-medium-2k at its
             full widths, two blocks, bf16 compute, (y)'s first 8 prompts, 16
             new tokens each, 4 slots, submitted at once on the leader (the
             process of global rank 0; the other replays its records):
             tp = 8 with float32 KV (the model axis spans the processes, the
             sums cross on the transport, the decode step runs eagerly) with
             the leader slowed and forced to the precision rung after 3
             steps; tp = 4 with int8 KV on B5 (each process a replica, only
             the records cross, each captures its decode graph, held bit for
             bit to its eager twin on both processes; B1, B2 and B5 in both).
             Then configure("color=0,1,0,1,0,1,0,1") and
             configure("color=0,0,0,0,1,1,1,1"), each in an Environment of its
             own, every collective kind over a (2, 2) grid of the 4 kept
             ranks, 2 a process. Held to the twin: every process's programs
             (prefills, decode steps with their dtype and rung: the shed at
             one step on both) equal, and the tokens each decode step fed the
             same on both processes; the leader's logits within the case's
             oracle bound (SERVE_DELTA, SERVE_INT8_DELTA) of the twin's on
             their common prefix, a stream parting from the twin's only where
             the twin's margin is within twice that bound (bf16 compute: a box
             of 4 ranks and the 8-rank twin differ in float32's last bits,
             C.19, and where such a value straddles a bf16 rounding step the
             logits move by ~1e-3 relative), each step's relative L2 reported;
             the leader's streams within run (y)'s oracle rule, the unpaged
             oracle run here on them; the restricted collectives bit for bit;
             the twin's own engines within run (y)'s oracle rule.
             Printed (``# multiprocess ad1 serve``): the bytes a prefill and
             a decode step handed the transport by hop kind (the model sums
             and the records) with their staging and wire seconds, TTFT and
             the decode step's host time beside the twin's, the children's
             launches, the card and its limit.

Every ``# phase`` line gives its seconds: its own where it states them, else
the wall time since the previous ``# phase`` line.

A captured graph counts its launches once, when it is recorded: the engine
runs' launches are those of precompile's eager warm-up step and its capture,
and each prints the launches of one captured step.

B5's kernels-line rows at 40,000 B and 1 MiB a rank also give B5 and the
library call timed as CUDA graphs of 20 calls (``graph_ms``,
``library_graph_ms``), beside the times as the path pays them; every B1 and
B2 row gives its ``graph_ms`` too (``codec_rows``: the shapes of the training,
feed and serving paths).

Launch counts are set to 0 just before each path is driven and read just
after; launches made to compare a kernel with its plain version, or to time
it, do not count. Then it times each kernel at the path's shapes with CUDA
events against its bound (memory traffic, or operations at the card's rate
for them, whichever takes longer) and prints, on lines of their own,
the card's name and power limit, one JSON object with the kernels, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORLD = 8
BLOCK = 256
SEED = 0

# device memory rate (bytes/s), float32 rate outside the tensor cores and dense
# bf16 tensor-core rate (operations/s), from NVIDIA's data sheets; the first
# name that matches wins
CARDS = (
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100", 3.35e12, 67e12, 989e12),      # SXM5, HBM3
    ("H200", 4.8e12, 67e12, 989e12),
)


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_PHASE_CLOCK = [time.perf_counter()]


def log(msg: str) -> None:
    """Print a line. A ``# phase ...: ok`` line that states no time of its own
    gets the wall seconds since the previous ``# phase`` line (the phases run
    one after the other, so these add up to the wall time)."""
    if msg.startswith("# phase "):
        now = time.perf_counter()
        if ": ok" in msg and ": ok in " not in msg:
            msg = msg.replace(": ok", f": ok in {now - _PHASE_CLOCK[0]:.1f} s", 1)
        _PHASE_CLOCK[0] = now
    print(msg, flush=True)


def card_rates(name: str):
    """-> (memory bytes/s, float32 operations/s, bf16 tensor-core operations/s)."""
    for key, bw, f32, bf16 in CARDS:
        if key in name:
            return bw, f32, bf16
    raise SmokeFailure(f"no data-sheet rates for card {name!r}: add it to CARDS")


def ptxas_summary(text: str) -> str:
    """nvcc's ``-Xptxas -v`` report in one line: the functions compiled, their
    registers a thread and the bytes any of them spill."""
    import re

    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} functions, {min(regs)}-{max(regs)} registers a thread, "
            f"{sum(1 for x in spills if x)} spilling ({max(spills, default=0)} bytes at most)")


def ptxas_functions(text: str) -> str:
    """Each function of a ptxas report with its registers a thread and its spill
    bytes, templates shortened (``bu_sm90ILi64ELi2ELb1EE...`` -> ``bu_sm90<64,2,1>``)."""
    import re

    out = []
    for chunk in text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        # _ZN<anonymous namespace ...>_cu_<8 hex digits><length><name>[I<args>E]
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
        short = name
        if m:
            rest = name[m.end():]
            short = rest[:int(m.group(1))]
            args = re.match(r"I((?:L[ib]\d+E)+)E", rest[int(m.group(1)):])
            if args:
                short += f"<{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        out.append(f"{short} {regs.group(1) if regs else '?'}"
                   + (f" (spills {int(spill.group(1)) + int(spill.group(2))} B)"
                      if spill and spill.group(1) + spill.group(2) != "00" else ""))
    return ", ".join(out)


def spill_bytes(text: str) -> int:
    """The spill bytes (stores and loads) of every function in a ptxas report."""
    import re

    return sum(int(a) + int(b) for a, b in
               re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text))


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


def phase_parity(torch, qk, dev, shapes, misaligned=()):
    """Every (rows, block) in ``shapes`` through both wrappers against the
    plain versions on the card, and every one in ``misaligned`` again on views
    whose storage starts off a 16-byte boundary (the float32 input 1 element
    in, the int8 input 3), which take the scalar path: -> number of
    comparisons."""
    gen = torch.Generator().manual_seed(SEED)
    cases = [(r, b, False) for r, b in shapes] + [(r, b, True) for r, b in misaligned]
    for rows, block, off in cases:
        x = _rows(torch, rows, block, dev, gen, zero_every=7)
        if off:
            x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(rows, block)
        tag = f"({rows}, {block}{', misaligned' if off else ''})"
        q, s = qk.quantize_blocks(x)
        torch.cuda.synchronize()
        rq, rs = qk.quantize_blocks_ref(x)
        bad_q = int((q != rq).sum())
        bad_s = int((s != rs).sum())
        check(bad_q == 0 and bad_s == 0,
              f"quantize {tag}: {bad_q} int8 and {bad_s} scale mismatches")
        if off:
            q = torch.cat([q.new_zeros(3), q.reshape(-1)])[3:].view(rows, block)
        d = qk.dequantize_blocks(q, s)
        torch.cuda.synchronize()
        bad_d = int((d != qk.dequantize_blocks_ref(rq, rs)).sum())
        check(bad_d == 0, f"dequantize {tag}: {bad_d} mismatches")
    return len(cases)


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




def counts_are(counts: dict, **want) -> bool:
    return all(counts.get(k, 0) == v for k, v in want.items())


def same_bits(torch, a, b) -> bool:
    """Bit-for-bit equality (so -0.0 differs from +0.0), for float32, bfloat16
    and int32 tensors."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(a.dtype)
    return bool(torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b))


def phase_ring_parity(torch, rk, rhd, dev):
    """B3, B3-AG, B4 and B5 against their plain versions at small edge shapes:
    groups of 2 to 8 members (one instance and several), the snake order,
    every dtype, both directions, ragged counts and shards, strided rows,
    all-zero int8 rows and -0.0. -> number of comparisons."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = 0

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).mul_(30).to(dtype)

    one_axis = [(8, 1, ("data",)), (4, 2, ("data",)), (4, 2, ("model",)), (2, 1, ("data",)),
                (3, 1, ("data",))]
    snake = [(4, 2, ("data", "model")), (2, 4, ("data", "model"))]
    for (d, m, axes), is_snake in [(g, False) for g in one_axis] + [(g, True) for g in snake]:
        group = ProcessGroup(Topology(d, m, d * m), axes)
        w, g = d * m, group.size
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for kind, count in (("allreduce", 3000 * g + 7), ("reduce_scatter", 3000 * g)):
                for bidir in (False, True):
                    plan = rk.dense_plan(kind, group, count, snake=is_snake, bidir=bidir)
                    x = (torch.randint(-2 ** 30, 2 ** 30, (w, count), generator=gen, device=dev,
                                       dtype=torch.int32) if dtype == torch.int32
                         else randn((w, count), dtype))
                    got = rk.dense_ring(x, plan)
                    torch.cuda.synchronize()
                    check(same_bits(torch, got, rk.dense_ring_ref(x, plan)),
                          f"parity: dense ring {kind} {dtype} on {d}x{m} {axes} "
                          f"bidir={bidir} differs from its plain version")
                    cases += 1
    for d, m, axes in one_axis:
        group = ProcessGroup(Topology(d, m, d * m), axes)
        w, g = d * m, group.size
        for block in (128, 256, 512):
            for kind, count in (("allreduce", (block * 32 + 100) * g + 3),
                                ("reduce_scatter", (block * 32 + 100) * g)):
                for bidir in (False, True):
                    plan = rk.quant_plan(kind, group, count, block, bidir=bidir)
                    x = randn((w, g * plan.chunk))
                    x.view(w, -1, block)[:, ::5] = 0.0          # all-zero blocks: scale 1
                    got = rk.quant_ring(x, plan)
                    torch.cuda.synchronize()
                    check(same_bits(torch, got, rk.quant_ring_ref(x, plan)),
                          f"parity: int8 ring {kind} block {block} on {d}x{m} {axes} "
                          f"bidir={bidir} differs from its plain version")
                    cases += 1
    # B3-AG, the gather-only mode: G from 2 to 8, both axis groups of a (4, 2)
    # world and the snake cycles, ragged shards, strided rows and -0.0
    ag_groups = [((g, 1, ("data",)), False) for g in range(2, 9)] + [
        (g, False) for g in one_axis[1:3]] + [(g, True) for g in snake]
    for (d, m, axes), is_snake in ag_groups:
        group = ProcessGroup(Topology(d, m, d * m), axes)
        w = d * m
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for shard in (130, 640, 3 * 4096 + 5):
                plan = rk.dense_plan("all_gather", group, shard, snake=is_snake, bidir=False)
                wide = (torch.randint(-2 ** 30, 2 ** 30, (w, shard + 7), generator=gen,
                                      device=dev, dtype=torch.int32) if dtype == torch.int32
                        else randn((w, shard + 7), dtype))
                x = wide[:, 3:3 + shard]                 # strided rows
                if dtype != torch.int32:
                    x[:, ::5] = -0.0
                got = rk.dense_ring(x, plan)
                torch.cuda.synchronize()
                check(same_bits(torch, got, rk.dense_ring_ref(x, plan)),
                      f"parity: dense ring all_gather {dtype} shard {shard} on {d}x{m} {axes} "
                      f"differs from its plain version")
                cases += 1
    for d, m, axes in [(g, 1, ("data",)) for g in (2, 3, 4, 5, 6, 7, 8)] + [
            (4, 2, ("replica", "data", "seq", "model")), (4, 2, ("data",))]:
        group = ProcessGroup(Topology(d, m, d * m), axes)
        plan = rhd.RhdPlan(group)
        for dtype in (torch.float32, torch.int32):
            x = randn((d * m, 5001)).to(dtype)
            if dtype == torch.float32:
                x[:, ::7] = -0.0
            got = rhd.rhd_allreduce(x, plan)
            torch.cuda.synchronize()
            check(same_bits(torch, got, rhd.rhd_allreduce_ref(x, plan)),
                  f"parity: rhd allreduce {dtype} on {d}x{m} {axes} differs from its plain "
                  f"version")
            cases += 1
    return cases


def phase_config4(torch, env, np, qk, n=(64 << 20) // 4, rounds=2, roundtrip=True):
    """-> (inputs, results and residuals per round with the kernels, the
    request, the round trip's dequantized sum or None) for the comparison
    that follows."""
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
    if not roundtrip:
        return xs, outs, errs, req, None
    # config 4's wire as the public codec: every rank compresses, the int8
    # payload and scales reduce, every rank decompresses
    q, s, orig = qk.quantize(xs[0].reshape(-1), block=BLOCK)
    deq = qk.dequantize(q, s, block=BLOCK, orig_len=orig).reshape(xs[0].shape)
    return xs, outs, errs, req, deq.sum(dim=1, keepdim=True)


def _wire(req) -> str:
    return "pallas" if req.algo == "pallas_ring" else "lax"


def check_config4(torch, env, qk, xs, outs, errs, req, roundtrip):
    """The request's rounds against the plain version of its wire (plain B1,
    and plain B4 on the fused ring) on the same inputs, bit for bit."""
    from mlsl_tpu_torch.comm import quant_ring
    from mlsl_tpu_torch.ops import ring_kernels as rk

    group = req.desc.group
    n = xs[0].shape[-1]
    fn, el = quant_ring.build_quantized_collective("allreduce", group, n, BLOCK,
                                                   ring=_wire(req), plain=True)
    check(req._err_lens == [el], f"config 4: err_len {req._err_lens} != {el}")
    if _wire(req) == "pallas":
        check(el == rk.quant_geometry("allreduce", group, n, BLOCK)[3],
              "config 4: the fused ring's err_len is not quant_geometry's")
    err = torch.zeros((*group.topology.grid_shape, el), device=env.device)
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
    if roundtrip is None:
        return
    flat = xs[0].reshape(-1)
    pad = qk.block_align(flat.numel(), BLOCK) - flat.numel()
    q, s = qk.quantize_blocks_ref(torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK))
    deq = qk.dequantize_blocks_ref(q, s).reshape(-1)[:flat.numel()]
    want = deq.reshape(xs[0].shape).sum(dim=1, keepdim=True)
    check(bool(torch.equal(roundtrip, want)), "config 4: codec round trip differs from plain")


def build_resnet_trainer(torch, env, np, image=224, classes=1000, batch=64, compression=None,
                         **kw):
    """Config 5's trainer, int8 unless ``compression`` says otherwise; ``kw``
    goes to DataParallelTrainer (the overlap schedules)."""
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
        resnet.layer_subtree, lr=0.05,
        compression=CompressionType.QUANTIZATION if compression is None else compression, **kw,
    )
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(batch, image, image, 3)).astype(np.float32)
    y = rng.integers(0, classes, size=(batch,)).astype(np.int32)
    return trainer, trainer.shard_batch(x, y)


def phase_config5(torch, trainer, batch, steps=3):
    """-> (losses per step, step seconds, the last step's seconds in its two
    halves, last step's local grads, each layer's error-feedback residuals as
    the last step found them). The last step runs as its two halves
    (``step`` is exactly these two calls) so its inputs stay at hand for the
    check that follows."""
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


def check_config5(torch, trainer, losses, grads, errs):
    """The last step's reduced gradients, layer by layer: bit-exact against
    the plain version of the request's wire (plain B1, and plain B4 on the
    fused ring) on the same gradients and residuals, and close to the exact
    sum of what entered the round (gradient plus carried residual). -> the
    worst layer's relative error.

    Bound: the ring rounds each element up to G + 1 = 9 times (entry, seven
    hops, all-gather), each time by at most half a step of amax/127. A block
    whose norm one element dominates -- the fc gradient at 1000 classes, where
    softmax puts most of a 256-wide block ~1000x below its labelled entry --
    loses about sqrt(9 * 256 / 12) / 127 = 0.11 of its norm; 0.25 leaves room."""
    from mlsl_tpu_torch.comm import quant_ring
    from mlsl_tpu_torch.ops import ring_kernels as rk

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
            d = req.desc
            fn, _ = quant_ring.build_quantized_collective(d.kind, d.group, n, block,
                                                          ring=_wire(req), plain=True)
            plain.append(fn(part, err)[0])
            geometry = (rk.quant_geometry if _wire(req) == "pallas"
                        else quant_ring.ring_geometry)
            g, rc, chunk, _ = geometry(d.kind, d.group, n, block)
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


# -- the algorithm engine ---------------------------------------------------

ALGO_VARS = ("MLSL_ALGO", "MLSL_PALLAS_RHD", "MLSL_PALLAS_RING_BIDIR",
             "MLSL_PALLAS_A2A_QUANT", "MLSL_GRAD_BUCKET_MB", "MLSL_STATS", "MLSL_STATS_DIR",
             "MLSL_TOPK_RATIO", "MLSL_CODEC", "MLSL_TUNE_CODEC", "MLSL_TUNE_PROFILE",
             "MLSL_MESH_TIERS", "MLSL_HIER_DCN_CODEC", "MLSL_TUNE", "MLSL_TUNE_QUANT",
             "MLSL_TUNE_SIZES", "MLSL_TUNE_ITERS", "MLSL_SERVE_MAX_BATCH",
             "MLSL_SERVE_KV_CACHE_MB", "MLSL_SERVE_KV_QUANT", "MLSL_SERVE_KV_PAGE_ELEMS",
             "MLSL_SERVE_QUEUE_DEPTH", "MLSL_MSG_PRIORITY", "MLSL_MSG_PRIORITY_THRESHOLD",
             "MLSL_MSG_PRIORITY_FLUSH_MS", "MLSL_WATCHDOG_TIMEOUT", "MLSL_TRACE_DIR",
             "MLSL_LOCK_WITNESS", "MLSL_COMM_RETRY_BACKOFF_S")


def reinit(get_env, world=WORLD, **env_vars):
    """Finalize the Environment and initialise it again on the card with
    ``world`` virtual ranks, ``env_vars`` exported and the other engine
    variables unset, as a user picks an algorithm."""
    device = get_env().device
    get_env().finalize()
    for k in ALGO_VARS:
        os.environ.pop(k, None)
    os.environ.update(env_vars)
    return get_env().init(device=device, world_size=world)


def settle(torch) -> tuple:
    """Free the finished runs' device memory and start a new peak: a
    parameter set and its operation refer to each other, so a dropped
    trainer's buffers (its requests' and buckets' last results) go only with
    the collector. -> (GiB allocated before the collector, after it)."""
    held = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return held, torch.cuda.memory_allocated() / 2**30


def plain_result(torch, algos, req, x):
    """The request's algorithm as its plain version on the same input, chunk
    by chunk as the request ran it."""
    d = req.desc
    kw = {"op": d.op}
    if d.recv_count is not None:
        kw["recv_count"] = d.recv_count
    if req.algo in ("pallas_ring", "pallas_ring2d"):
        kw["bidir"] = req.dispatcher.config.pallas_ring_bidir
    fn = algos.build(d.kind, d.group, req.algo, plain=True, **kw)
    return torch.cat([fn(x[..., sl]) for sl in req._chunk_slices], dim=-1)


def check_sums(torch, out, x, group, tag, tol):
    """Every member holds the same sum (allreduce) or its slice of it
    (reduce_scatter), within relative L2 error ``tol`` of the float64 sum.
    -> the relative error."""
    from mlsl_tpu_torch.comm.collectives import group_view

    exact = group_view(x, group).double().sum(dim=1, keepdim=True)
    got = group_view(out, group)
    c, g, n = got.shape
    if n == exact.shape[-1]:
        check(bool((got == got[:, :1]).all()), f"algos {tag}: members disagree")
        got = got[:, :1]
    else:
        exact = exact.reshape(c, g, n)
    rel = float((got.double() - exact).norm() / exact.norm())
    check(rel < tol, f"algos {tag}: relative error {rel:.3g} >= {tol}")
    return rel


class PathRun:
    """Runs one collective through Distribution, checks what it selected
    and, for a kernel algorithm, that it is bit-exact against its plain
    version; times it; keeps the kernels' launch counts of the driven calls
    (not of the timing or the comparison)."""

    def __init__(self, torch, algos, launches, reset_launches):
        self.torch, self.algos = torch, algos
        self.launches, self.reset_launches = launches, reset_launches
        self.used = {}
        self.lines = []

    def __call__(self, env, dist, gt, kind, x, count, dtype, want, tag, time_it=True):
        from mlsl_tpu_torch import ReductionType

        torch = self.torch
        group = dist._group(gt)
        if kind == "allreduce":
            def start():
                return dist.all_reduce(x, count, dtype, ReductionType.SUM, gt)
        else:
            def start():
                return dist.reduce_scatter(x, count // group.size, dtype, ReductionType.SUM,
                                           gt)
        self.reset_launches()
        req = start()
        out = env.wait(req)
        torch.cuda.synchronize()
        n_launch = {k: v for k, v in self.launches().items() if v}
        check(req.algo == want, f"algos {tag}: request selected {req.algo!r}, not {want!r}")
        if want.startswith("pallas"):
            check(n_launch, f"algos {tag}: no kernel launched")
            check(same_bits(torch, out, plain_result(torch, self.algos, req, x)),
                  f"algos {tag}: the kernel's result differs from its plain version")
        for k, v in n_launch.items():
            self.used[k] = self.used.get(k, 0) + v
        if time_it:
            ms = time_ms(torch, lambda: env.wait(start()), reps=5, warmup=1)
            nbytes = count * x.element_size()
            self.lines.append(
                f"# algos {tag}: {req.algo} {kind}, {nbytes} B per rank, {x.dtype}: "
                f"{ms:.4f} ms, algbw {nbytes / ms / 1e6:.2f} GB/s, launches {n_launch}")
        return out


def phase_algos_dense(torch, get_env, drive, n=(256 << 20) // 4, n_small=(64 << 20) // 4):
    """The engine's dense algorithms at the BASELINE size, other dtypes and the
    bidirectional split at 64 MiB per rank, and the (4, 2) grid's groups."""
    from mlsl_tpu_torch import DataType, GroupType

    dev = get_env().device
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    f32 = DataType.FLOAT
    rels = {}

    x = torch.randn((1, WORLD, 1, 1, n), generator=gen, device=dev)
    for algo in ("lax", "rhd", "pallas_ring", "pallas_rhd"):
        env = reinit(get_env, MLSL_ALGO=algo)
        dist = env.create_distribution(WORLD, 1)
        out = drive(env, dist, GroupType.DATA, "allreduce", x, n, f32, algo,
                    f"{algo} allreduce")
        rels[f"{algo} allreduce"] = check_sums(torch, out, x, dist.data_group, algo, 1e-6)
        if algo != "pallas_rhd":
            out = drive(env, dist, GroupType.DATA, "reduce_scatter", x, n, f32, algo,
                        f"{algo} reduce_scatter")
            rels[f"{algo} reduce_scatter"] = check_sums(torch, out, x, dist.data_group,
                                                        algo, 1e-6)
        del out
    del x

    env = reinit(get_env, MLSL_ALGO="pallas_ring")
    dist = env.create_distribution(WORLD, 1)
    n_b = n_small * 2
    xb = torch.randn((1, WORLD, 1, 1, n_b), generator=gen, device=dev).to(torch.bfloat16)
    out = drive(env, dist, GroupType.DATA, "allreduce", xb, n_b, DataType.BFLOAT16,
                "pallas_ring", "pallas_ring bfloat16")
    rels["pallas_ring bfloat16"] = check_sums(torch, out.float(), xb.float(),
                                              dist.data_group, "bfloat16", 1e-2)
    del xb, out
    p = torch.arange(WORLD, device=dev).view(1, WORLD, 1, 1, 1)
    i = torch.arange(n_small, device=dev) % 1009
    xi = ((p + 1) * i - 500 * p).to(torch.int32)
    out = drive(env, dist, GroupType.DATA, "allreduce", xi, n_small, DataType.INT32,
                "pallas_ring", "pallas_ring int32")
    want = (36 * i - 500 * 28).to(torch.int32)
    check(bool((out == want).all()), "algos pallas_ring int32: differs from the closed form")
    del xi, out

    env = reinit(get_env, MLSL_ALGO="pallas_ring", MLSL_PALLAS_RING_BIDIR="1")
    dist = env.create_distribution(WORLD, 1)
    x = torch.randn((1, WORLD, 1, 1, n_small), generator=gen, device=dev)
    out = drive(env, dist, GroupType.DATA, "allreduce", x, n_small, f32, "pallas_ring",
                "pallas_ring bidirectional")
    rels["pallas_ring bidirectional"] = check_sums(torch, out, x, dist.data_group, "bidir",
                                                   1e-6)
    del x, out

    for algo, cases in (("pallas_ring", ((GroupType.DATA, "allreduce"),
                                         (GroupType.MODEL, "allreduce"),
                                         (GroupType.DATA, "reduce_scatter"))),
                        ("ring2d", ((GroupType.GLOBAL, "allreduce"),
                                    (GroupType.GLOBAL, "reduce_scatter"))),
                        ("pallas_ring2d", ((GroupType.GLOBAL, "allreduce"),
                                           (GroupType.GLOBAL, "reduce_scatter")))):
        env = reinit(get_env, MLSL_ALGO=algo)
        dist = env.create_distribution(4, 2)
        x = torch.randn((*dist.world_shape, n_small), generator=gen, device=dev)
        for gt, kind in cases:
            tag = f"{algo} {kind} (4, 2) {GroupType(gt).name.lower()}"
            out = drive(env, dist, gt, kind, x, n_small, f32, algo, tag)
            rels[tag] = check_sums(torch, out, x, dist._group(gt), tag, 1e-6)
            del out
        del x
    return rels


def phase_algos_small(torch, get_env, drive):
    """The heuristic rung: with MLSL_PALLAS_RHD=1 and nothing forced, an
    allreduce up to 4 x msg_priority_threshold = 40,000 B selects pallas_rhd;
    then a 6-rank group, whose pre/post fold only a group that is not a
    power of two takes."""
    from mlsl_tpu_torch import DataType, GroupType, ReductionType
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
    from mlsl_tpu_torch.comm.request import CommDesc, CommRequest

    dev = get_env().device
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    env = reinit(get_env, MLSL_PALLAS_RHD="1")
    dist = env.create_distribution(WORLD, 1)
    for nbytes, want in ((4096, "pallas_rhd"), (40_000, "pallas_rhd"), (40_004, "lax")):
        count = nbytes // 4
        x = torch.randn((1, WORLD, 1, 1, count), generator=gen, device=dev)
        x[..., ::7] = -0.0
        out = drive(env, dist, GroupType.DATA, "allreduce", x, count, DataType.FLOAT, want,
                    f"{nbytes} B heuristic")
        check_sums(torch, out, x, dist.data_group, f"{nbytes} B", 1e-6)
    g6 = ProcessGroup(Topology(6, 1, 6), ("data",))
    req = CommRequest(CommDesc("allreduce", g6, 1024, DataType.FLOAT, op=ReductionType.SUM),
                      env.dispatcher)
    req.setup()
    check(req.algo == "pallas_rhd", f"6 ranks: selected {req.algo!r}")
    x = torch.randn((1, 6, 1, 1, 1024), generator=gen, device=dev)
    x[..., ::7] = -0.0
    drive.reset_launches()
    out = req.start(x).wait()
    torch.cuda.synchronize()
    check(drive.launches()["rhd_allreduce"] == 1, "6 ranks: B5 did not launch")
    drive.used["rhd_allreduce"] = (drive.used.get("rhd_allreduce", 0)
                                   + drive.launches()["rhd_allreduce"])
    check(same_bits(torch, out, plain_result(torch, drive.algos, req, x)),
          "6 ranks: the kernel's result differs from its plain version")
    check(not bool(torch.signbit(out[..., ::7]).any()),
          "6 ranks: the masked pre-fold must turn -0.0 into +0.0")
    check_sums(torch, out, x, g6, "6 ranks", 1e-6)


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


def time_graph_ms(torch, fn, reps=20):
    """Device time of one ``fn()``: ``reps`` calls captured into one CUDA
    graph, replayed. A wrapper whose host work (checks, allocations, the
    launch) takes longer than its kernel leaves the card idle between calls
    in ``time_ms``; a graph replay issues them with no host work between."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    ms = time_ms(torch, graph.replay, reps=5, warmup=2) / reps
    del graph
    return ms


def entry(*, name, source, replaces, launches, per_path, shape, err, ms, plain_ms,
          library_ms, nbytes, ops, bw, peak, **extra):
    """One kernel's record for the kernels line; the bound is the larger of
    the bytes over the memory rate and the operations over ``peak``, the
    card's rate for the kernel's operations (float32 for the codec and the
    rings, bf16 tensor cores for attention)."""
    t_bytes, t_ops = nbytes / bw * 1e3, ops / peak * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "launches_by_path": per_path, "shape": shape,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, **extra,
    }


def codec_rows(feed_block=BLOCK):
    """B1's and B2's rows of the kernels line, at the shapes their paths give
    them: [(kind, rows, block, tag)]."""
    from mlsl_tpu_torch.models import resnet
    from mlsl_tpu_torch.models import transformer as tfm

    fc_entry = resnet_ring_rows(
        resnet.layer_param_counts(resnet.ResNet50(device="meta")))["fc"][0]
    srv = tfm.GPT_MEDIUM_2K
    return [
        # the training path's largest (the fc layer's entry quantize) and config
        # 4's round trip
        ("quantize", fc_entry, BLOCK, None),
        ("dequantize", WORLD * ((64 << 20) // 4) // BLOCK, BLOCK, None),
        # the feed's int8 wire (run (w2)): every shard's rows of a batch
        ("dequantize", feed_b2_rows(feed_block), feed_block, "feed int8 wire"),
        # the serving path's int8 KV (run (y4)): a prefill's K over every block,
        # a decode step's K rows of one block, the gather of one block's K
        ("quantize", srv.n_blocks * srv.seq_len * srv.n_heads, srv.head_dim,
         "serve: a prefill's K"),
        ("quantize", SERVE_BATCH * srv.n_heads, srv.head_dim,
         "serve: a decode step's K, one block"),
        ("dequantize", SERVE_BATCH * srv.seq_len * srv.n_heads, srv.head_dim,
         "serve: the gathered K of one block"),
    ]


def codec_entry(torch, qk, kind, rows, block, bw, f32, per_path, dev, tag=None):
    """B1's or B2's record at (rows, block): ``ms`` as the path pays it, the
    wrapper's host work included, and ``graph_ms``, device time alone."""
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
    ms, graph_ms = time_ms(torch, fn), time_graph_ms(torch, fn)
    qk.LAUNCHES.update(before)      # timing launches are not the path's
    if tag:
        name += f" ({tag})"
    return entry(name=name, source="mlsl_tpu_torch/csrc/quant_kernels.cu", replaces=replaces,
                 launches=sum(per_path.values()), per_path=per_path, shape=[rows, block],
                 err=err, ms=ms, plain_ms=time_ms(torch, plain), library_ms=None,
                 nbytes=nbytes, ops=ops, bw=bw, peak=f32, graph_ms=graph_ms,
                 library_note="no single PyTorch call computes blockwise int8 quantization")


def _sum_broadcast(x):
    """The yardstick for B3 and B5: one reduction over the members plus the
    broadcast write the kernels also do. The port never calls it."""
    y = x.unsqueeze(0)          # (1, w, n); strided rows stay strided
    return lambda: y.sum(dim=1, keepdim=True).expand_as(y).contiguous()


def _sum_broadcast_ms(torch, x, w):
    return time_ms(torch, _sum_broadcast(x), reps=20)


def _rows_of(torch, gen, dev, n, ld):
    """(WORLD, n) float32 rows; with ``ld`` the first n columns of a
    (WORLD, ld) buffer, as one chunk of a chunked request reads them."""
    x = torch.randn((WORLD, ld or n), generator=gen, device=dev)
    return x[:, :n] if ld else x


def _path_note(n, ld):
    return ({} if not ld else
            {"row_stride": ld, "note": f"one of the {ld // n} chunk launches the "
                                       f"{ld * 4 >> 20} MiB-per-rank request makes "
                                       f"(MLSL_LARGE_MSG_SIZE_MB=128)"})


def dense_ring_entry(torch, rk, bw, f32, per_path, dev, n=(256 << 20) // 4, ld=None):
    """B3 on 8 ranks: x (8, n) float32 allreduce, one launch; with ``ld`` the
    rows are strided, one chunk of a wider request."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    group = ProcessGroup(Topology(WORLD, 1, WORLD), ("data",))
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = _rows_of(torch, gen, dev, n, ld)
    plan = rk.dense_plan("allreduce", group, n, bidir=False)
    before = dict(rk.LAUNCHES)
    err = float((rk.dense_ring(x, plan) - rk.dense_ring_ref(x, plan)).abs().max())
    ms = time_ms(torch, lambda: rk.dense_ring(x, plan), reps=20)
    rk.LAUNCHES.update(before)
    plain_ms = time_ms(torch, lambda: rk.dense_ring_ref(x, plan), reps=3, warmup=1)
    return entry(name=f"dense_ring ({n * 4} B{', strided' if ld else ''})",
                 source="mlsl_tpu_torch/csrc/ring_kernels.cu",
                 replaces="mlsl_tpu/ops/ring_kernels.py:698", launches=sum(per_path.values()),
                 per_path=per_path, shape=[WORLD, n], err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=_sum_broadcast_ms(torch, x, WORLD),
                 nbytes=2 * WORLD * n * 4, ops=(WORLD - 1) * n, bw=bw, peak=f32,
                 library_note="x.unsqueeze(0).sum(dim=1, keepdim=True).expand_as(.)"
                              ".contiguous()", **_path_note(n, ld))


def quant_ring_entry(torch, rk, count, tag, bw, f32, per_path, dev):
    """B4 at one request's shape on 8 ranks (block 256)."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    group = ProcessGroup(Topology(WORLD, 1, WORLD), ("data",))
    plan = rk.quant_plan("allreduce", group, count, BLOCK, bidir=False)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    x = torch.randn((WORLD, WORLD * plan.chunk), generator=gen, device=dev)
    before = dict(rk.LAUNCHES)
    err = float((rk.quant_ring(x, plan) - rk.quant_ring_ref(x, plan)).abs().max())
    ms = time_ms(torch, lambda: rk.quant_ring(x, plan), reps=20)
    rk.LAUNCHES.update(before)
    plain_ms = time_ms(torch, lambda: rk.quant_ring_ref(x, plan), reps=3, warmup=1)
    # the codec per element and hop: |x|, max, divide, round, clamp, multiply, add
    return entry(name=f"quant_ring ({tag})", source="mlsl_tpu_torch/csrc/ring_kernels.cu",
                 replaces="mlsl_tpu/ops/ring_kernels.py:698 (quantized; :885, :463)",
                 launches=sum(per_path.values()), per_path=per_path,
                 shape=[WORLD, count, plan.chunk], err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=None, nbytes=WORLD * WORLD * plan.chunk * 4 + WORLD * count * 4,
                 ops=7 * WORLD * WORLD * plan.chunk, bw=bw, peak=f32,
                 library_note="no PyTorch call computes a ring that requantizes to int8 "
                              "on every hop")


def rhd_entry(torch, rhd, count, bw, f32, per_path, dev, note=None, ld=None, graph=False):
    """B5 on 8 ranks at ``count`` float32 per rank; with ``ld`` the rows are
    strided, one chunk of a wider request. ``graph`` also times B5 and the
    library call as CUDA graphs of 20 calls (device time, no host work
    between calls), beside the times as the path pays them."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    plan = rhd.RhdPlan(ProcessGroup(Topology(WORLD, 1, WORLD), ("data",)))
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = _rows_of(torch, gen, dev, count, ld)
    reps = 20 if count >= 1 << 20 else 50
    before = dict(rhd.LAUNCHES)
    err = float((rhd.rhd_allreduce(x, plan) - rhd.rhd_allreduce_ref(x, plan)).abs().max())
    ms = time_ms(torch, lambda: rhd.rhd_allreduce(x, plan), reps=reps)
    extra = {"note": note} if note else _path_note(count, ld)
    if graph:
        extra["graph_ms"] = time_graph_ms(torch, lambda: rhd.rhd_allreduce(x, plan))
        extra["library_graph_ms"] = time_graph_ms(torch, _sum_broadcast(x))
    rhd.LAUNCHES.update(before)
    return entry(name=f"rhd_allreduce ({count * 4} B{', strided' if ld else ''})",
                 source="mlsl_tpu_torch/csrc/rhd_kernels.cu",
                 replaces="mlsl_tpu/ops/rhd_kernels.py:256", launches=sum(per_path.values()),
                 per_path=per_path, shape=[WORLD, count], err=err, ms=ms,
                 plain_ms=time_ms(torch, lambda: rhd.rhd_allreduce_ref(x, plan), reps=reps),
                 library_ms=_sum_broadcast_ms(torch, x, WORLD),
                 nbytes=2 * WORLD * count * 4, ops=WORLD * count, bw=bw, peak=f32,
                 library_note="x.unsqueeze(0).sum(dim=1, keepdim=True).expand_as(.)"
                              ".contiguous()", **extra)


# -- the transformer and its attention kernels (B7, B8, B9) ----------------

# the transformer runs train models/transformer.GPT_MEDIUM_2K (gpt-medium-2k, the
# JAX package's realistic transformer row, benchmarks/transformer_bench.py:106-108)
# at its published widths and depth, batch 8 as there
TFM_BATCH = 8
ATTN_SRC = "mlsl_tpu_torch/csrc/attention_kernels.cu"
SM90_SRC = "mlsl_tpu_torch/csrc/attention_sm90.cu"
ATTN_PY = "mlsl_tpu/ops/attention_kernels.py"
# relative L2 error of a kernel against its plain version on the same inputs:
# the kernel folds 64-wide tiles, the plain version whole rows, so float32 sums
# differ in order (1e-5); a bf16 output rounds once in both, and a sum that
# lands near a rounding boundary moves an element by one bf16 step (1e-2).
# The lse and the float32 carried state: 1e-5 whatever the input type.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# runs that must not launch the wgmma form of B7/B8
NO_SM90 = dict(flash_fwd_sm90=0, flash_bwd_dq_sm90=0, flash_bwd_dkv_sm90=0)


def b9_counts(n: int, forward=None) -> dict:
    """B9's launches on a training path that folds ``n`` blocks: each in the
    wgmma form with its two backward passes, none in the CUDA-core form;
    ``forward`` launches of the fold itself where remat replays it."""
    return dict(block_update_sm90=n if forward is None else forward,
                block_update_bwd_dq_sm90=n, block_update_bwd_dkv_sm90=n, block_update=0)


def replays(cfg) -> int:
    """How often a training step runs each block's forward: twice under
    remat (the forward, and its replay in the backward; both policies
    replay the kernels and the mxu_einsum Functions, "dots" taking their
    products' outputs from what the forward kept), else once."""
    return 2 if cfg.remat else 1


# runs that launch no B9 at all
NO_B9 = b9_counts(0)
# the wgmma form against the plain versions that round P and dS to bf16 where it
# does: only summation order and exp differ, so a wrong fragment layout, which
# the 1e-2 above could pass, cannot
SM90_TOL = 2e-3


def rel_err(torch, got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def _dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


def _masked(torch, ak, bh, sq, qo, ko, dev):
    """(BH, Sq) bool: rows whose every key lies in their future."""
    q_pos = ak.offsets(qo, bh, dev)[:, None] + torch.arange(sq, device=dev)
    return q_pos < ak.offsets(ko, bh, dev)[:, None]


def visible_pairs(torch, ak, bh, sq, sk, qo, ko, causal, dev) -> int:
    """The (q, k) pairs the causal mask leaves visible for these offsets."""
    if not causal:
        return bh * sq * sk
    q_pos = ak.offsets(qo, bh, dev)[:, None] + torch.arange(sq, device=dev)
    seen = (q_pos - ak.offsets(ko, bh, dev)[:, None] + 1).clamp(0, sk)
    return int(seen.sum())


def seen_rows(torch, ak, bh, sq, sk, qo, ko, causal, dev) -> tuple[int, int]:
    """-> (query rows that see at least one key, key rows that at least one
    query sees) for these offsets: the rows whose q, or k and v, the
    function must read."""
    if not causal:
        return bh * sq, bh * sk
    q_pos = ak.offsets(qo, bh, dev)[:, None] + torch.arange(sq, device=dev)
    seen = (q_pos - ak.offsets(ko, bh, dev)[:, None] + 1).clamp(0, sk)
    return int((seen > 0).sum()), int(seen[:, -1].sum())


def check_flash(torch, ak, q, k, v, g, qo, ko, causal, tag, form=None) -> dict:
    """B7 and B8's two passes against their plain versions on the same inputs
    (the backward's from the kernel's own lse), in ``form`` (``kernel_form``'s
    unless given): within ATTN_TOL of the float32 plain versions and, for the
    wgmma form, within SM90_TOL of those that round P and dS to bf16 as it
    does. Fully masked rows, and keys no query sees, exactly 0.
    -> {kernel: max abs error against the float32 plain version}."""
    bh, sq, _ = q.shape
    form = form or ak.kernel_form(q.dtype, q.shape[-1])
    suffix = "_sm90" if form == "sm90" else ""
    before = dict(ak.LAUNCHES)
    o, lse = ak.flash_fwd(q, k, v, qo, ko, causal, form=form)
    dd = (g.float() * o.float()).sum(-1)
    dq = ak.flash_bwd_dq(q, k, v, g, lse, dd, qo, ko, causal, form=form)
    dk, dv = ak.flash_bwd_dkv(q, k, v, g, lse, dd, qo, ko, causal, form=form)
    torch.cuda.synchronize()
    ran = {key: ak.LAUNCHES[key] - before[key] for key in ak.LAUNCHES}
    check(all(ran[f"{key}{suffix}"] == 1 for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"attention parity {tag}: the {form} form did not run: {ran}")
    qt, kt = ak.offsets(qo, bh, q.device), ak.offsets(ko, bh, q.device)
    oracles = [(torch.float32, ATTN_TOL[_dtype_name(q)], "")]
    if form == "sm90":
        oracles.append((torch.bfloat16, SM90_TOL, " (P, dS rounded)"))
    errs = {}
    for p_dtype, tol, note in oracles:
        ro, rl = ak.flash_fwd_ref(q, k, v, qt, kt, causal, p_dtype=p_dtype)
        rdq = ak.flash_bwd_dq_ref(q, k, v, g, lse, dd, qt, kt, causal, p_dtype=p_dtype)
        rdk, rdv = ak.flash_bwd_dkv_ref(q, k, v, g, lse, dd, qt, kt, causal, p_dtype=p_dtype)
        live = rl > ak.NEG / 2
        check(bool(live.any()) == bool((dq != 0).any()) == bool((dv != 0).any()),
              f"attention parity {tag}: the gradients are all zero where rows see keys")
        for name, got, want, t in (("flash_fwd", o, ro, tol),
                                   ("flash_fwd lse", lse[live], rl[live], 1e-5),
                                   ("flash_bwd_dq", dq, rdq, tol), ("flash_bwd_dk", dk, rdk, tol),
                                   ("flash_bwd_dv", dv, rdv, tol)):
            if want.numel() == 0:
                continue
            rel = rel_err(torch, got, want)
            check(rel < t, f"attention parity {tag}: {name}{note} relative error {rel:.3g} >= {t}")
            if not note:
                errs[name] = float((got.float() - want.float()).abs().max())
        check(bool((lse[~live] == rl[~live]).all()),
              f"attention parity {tag}: the lse of fully masked rows differs")
        del ro, rl, rdq, rdk, rdv
    if causal:
        rows = _masked(torch, ak, bh, sq, qo, ko, q.device)
        check(bool((o[rows] == 0).all() and (dq[rows] == 0).all()),
              f"attention parity {tag}: fully masked rows are not exactly 0")
        k_pos = kt[:, None] + torch.arange(k.shape[1], device=q.device)
        unseen = k_pos > (qt + sq - 1)[:, None]
        check(bool((dk[unseen] == 0).all() and (dv[unseen] == 0).all()),
              f"attention parity {tag}: keys no query sees have gradients")
    return errs


def _near_tie(torch, s, m, a, b):
    """Rows where winners ``a`` and ``b`` (key index, -1 for the carried m)
    name candidates whose float32 scores lie within 1e-5 of each other."""
    def pick(w):
        return torch.where(w >= 0, s.gather(-1, w.clamp_min(0).long()[..., None])[..., 0], m)

    x, y = pick(a), pick(b)
    return (x - y).abs() <= 1e-5 * torch.maximum(x.abs(), y.abs()).clamp_min(1.0)


def check_block_update(torch, ak, q, k, v, state, qo, ko, causal, tag, form=None,
                       ties=False):
    """B9 in ``form`` (``kernel_form``'s unless given) against its plain
    versions on the same inputs: the CUDA-core form within 1e-5 of the float32
    one; the wgmma form, asked for its winners as the training path asks,
    within SM90_TOL of the one that rounds P in 64-key tiles as it does and
    ATTN_TOL of the float32 one (m and l 1e-5 in both), m' equal to m bit for
    bit where no key beat it, its winners the plain scores' first argmax but
    at near-ties, in at most one row in 10,000 (with ``ties``, where m ties
    the block's maximum by design, in any number of rows). Rows that see no
    key keep their state exactly.
    -> ((acc, m, l), the winners or None, max abs error of acc against the
    float32 plain version)."""
    bh, sq, _ = q.shape
    form = form or ak.kernel_form(q.dtype, q.shape[-1])
    key = "block_update_sm90" if form == "sm90" else "block_update"
    before = dict(ak.LAUNCHES)
    got = ak.block_update(q, k, v, *state, qo, ko, causal, want_winner=form == "sm90",
                          form=form)
    torch.cuda.synchronize()
    check(ak.LAUNCHES[key] == before[key] + 1,
          f"attention parity {tag}: B9's {form} form did not run")
    win, got = (got[3], got[:3]) if form == "sm90" else (None, got)
    qt, kt = ak.offsets(qo, bh, q.device), ak.offsets(ko, bh, q.device)
    oracles = [(torch.float32, 1e-5 if form == "simt" else ATTN_TOL["bfloat16"], "")]
    if form == "sm90":
        oracles.append((torch.bfloat16, SM90_TOL, " (P rounded in 64-key tiles)"))
    err = None
    for p_dtype, tol, note in oracles:
        want = ak.block_update_tiled_ref(q, k, v, *state, qt, kt, causal, p_dtype=p_dtype)
        live = want[1] > ak.NEG / 2
        for name, a, b, t in (("acc", got[0], want[0], tol),
                              ("m", got[1][live], want[1][live], 1e-5), ("l", got[2], want[2], 1e-5)):
            if b.numel():
                rel = rel_err(torch, a, b)
                check(rel < t, f"attention parity {tag}: B9 {name}{note} relative error {rel:.3g}")
        check(bool((got[1][~live] == want[1][~live]).all()),
              f"attention parity {tag}: B9 m of rows that never saw a key differs")
        if not note:
            err = float((got[0] - want[0]).abs().max())
        del want
    if causal:
        rows = _masked(torch, ak, bh, sq, qo, ko, q.device)
        check(all(bool((o[rows] == i[rows]).all()) for o, i in zip(got, state)),
              f"attention parity {tag}: B9 changed the state of rows that see no key")
    if win is not None:
        kept = win < 0
        check(bool((got[1][kept] == state[1][kept]).all()),
              f"attention parity {tag}: B9 moved m where no key beat it")
        w_ref = ak.block_update_winner_ref(q, k, state[1], qt, kt, causal)
        off = win != w_ref
        s = ak._scores_ref(q, k, qt, kt, causal)
        check((ties or int(off.sum()) <= max(1, win.numel() // 10000))
              and bool(_near_tie(torch, s, state[1], win, w_ref)[off].all()),
              f"attention parity {tag}: B9's winners differ from the first argmax in "
              f"{int(off.sum())} rows")
        del s
    return got, win, err


def check_block_update_bwd(torch, ak, q, k, v, state, outs, win, qo, ko, causal, tag, gen):
    """B9's backward (wgmma form) at random cotangents (ga, gm, gl) against the
    closed form given the kernel's winners: dq, dk, dv within SM90_TOL of the
    one that rounds P, dS and ga to bf16 as the passes do and ATTN_TOL of the
    float32 one; dacc, dm, dl (PyTorch ops around the passes) within 1e-5.
    Rows that see no key, and keys no query sees, exactly 0.
    -> {name: max abs error against the float32 closed form}."""
    bh, sq, d = q.shape
    acc_n, m_n, l_n = outs
    ga = torch.randn((bh, sq, d), generator=gen, device=q.device)
    gm, gl = (torch.randn((bh, sq), generator=gen, device=q.device) for _ in range(2))
    before = dict(ak.LAUNCHES)
    grads = ak.block_update_bwd(q, k, v, *state, m_n, l_n, acc_n, win, ga, gm, gl, qo, ko,
                                causal)
    torch.cuda.synchronize()
    check(all(ak.LAUNCHES[key] == before[key] + 1
              for key in ("block_update_bwd_dq_sm90", "block_update_bwd_dkv_sm90")),
          f"attention parity {tag}: B9's backward passes did not run")
    qt, kt = ak.offsets(qo, bh, q.device), ak.offsets(ko, bh, q.device)
    errs = {}
    names = ("dq", "dk", "dv", "dacc", "dm", "dl")
    for p_dtype, tol, note in ((torch.bfloat16, SM90_TOL, " (P, dS, ga rounded)"),
                               (torch.float32, ATTN_TOL["bfloat16"], "")):
        want = ak.block_update_bwd_ref(q, k, v, *state, m_n, l_n, acc_n, ga, gm, gl, qt, kt,
                                       causal, p_dtype=p_dtype, g_dtype=p_dtype, win=win)
        for i, (name, a, b) in enumerate(zip(names, grads, want)):
            rel = rel_err(torch, a, b)
            t = tol if i < 3 else 1e-5
            check(rel < t, f"attention parity {tag}: B9 backward {name}{note} relative error "
                           f"{rel:.3g} >= {t}")
            if not note:
                errs[f"block_update_bwd {name}"] = float((a.float() - b.float()).abs().max())
        del want
    if causal:
        rows = _masked(torch, ak, bh, sq, qo, ko, q.device)
        k_pos = kt[:, None] + torch.arange(k.shape[1], device=q.device)
        unseen = k_pos > (qt + sq - 1)[:, None]
        check(bool((grads[0][rows] == 0).all() and (grads[1][unseen] == 0).all()
                   and (grads[2][unseen] == 0).all()),
              f"attention parity {tag}: B9 backward: gradients where no key or query is seen")
    return errs


def ring_offsets(torch, dev, sl, hop, rows_per_rank, grid=(1, 2, 2, 2)):
    """Per-row (q_off, k_off) of the sequence ring's hop ``hop`` on the
    8-rank (1, 2, 2, 2) grid: rank p's seq coordinate s = (p // M) % S sees
    the block of rank (s - hop) % S; each rank has rows_per_rank (local batch
    x local heads) rows."""
    _, _, n_s, n_m = grid
    s = (torch.arange(WORLD, device=dev) // n_m) % n_s
    src = (s - hop) % n_s
    rep = lambda x: (x * sl).repeat_interleave(rows_per_rank).to(torch.int32)
    return rep(s), rep(src)


def phase_attention_parity(torch, ak, dev) -> dict:
    """B7, B8 and B9 against their plain versions: at the transformer's shapes
    and at edge shapes. -> {case: max abs error per kernel}."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def rnd(rows, n, dh, dtype):
        return torch.randn((rows, n, dh), generator=gen, device=dev).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = gpt_medium()
    s, d = cfg.seq_len, cfg.head_dim
    bh = TFM_BATCH * cfg.n_heads                              # 1 rank: 8 x 16
    bh9 = WORLD * (TFM_BATCH // 2) * (cfg.n_heads // 2)       # 8 ranks x 4 x 8
    out = {}

    def rows_of(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    # (tag, bh, sq, sk, d, dtype, causal, q_off, k_off[, form]): the wgmma form
    # (bf16, d 64 or 128) at the path's shape and at awkward ones, the CUDA-core
    # form at the path's shape by request and at the shapes it serves
    flash_cases = [
        (f"path B7/B8 ({bh}, {s}, {d}) causal bf16", bh, s, s, d, bf16, True, 0, 0),
        (f"simt form, path ({bh}, {s}, {d}) causal bf16", bh, s, s, d, bf16, True, 0, 0,
         "simt"),
        ("sm90 d=128 causal (16, 2048)", 16, s, s, 128, bf16, True, 0, 0),
        ("sm90 d=64 noncausal sq=1024 sk=2048", 16, 1024, s, d, bf16, False, 0, 0),
        ("sm90 d=128 causal sq=512 sk=1024 q_off 512", 8, 512, 1024, 128, bf16, True, 512, 0),
        ("sm90 d=64 per-row offsets, rows fully masked", 8, 512, 512, d, bf16, True,
         rows_of(0, 0, 512, 100, 0, 256, 0, 0), rows_of(0, 37, 0, 612, 512, 0, 200, 1000)),
        ("sm90 d=128 offsets skip whole tiles", 4, 512, 512, 128, bf16, True,
         rows_of(0, 64, 0, 128), rows_of(192, 320, 384, 0)),
        ("sq=sk=128 d=8 f32 causal", 4, 128, 128, 8, f32, True, 0, 0),
        ("sq=sk=128 d=8 bf16 noncausal", 4, 128, 128, 8, bf16, False, 0, 0),
        ("d=16 f32 rows masked (k_off 64)", 4, 256, 128, 16, f32, True, 0, 64),
        ("d=16 bf16 shifted (q_off 100, k_off 37)", 4, 128, 256, 16, bf16, True, 100, 37),
        ("d=128 f32 noncausal sk=256", 2, 128, 256, 128, f32, False, 0, 0),
        ("d=128 bf16 causal all rows masked", 2, 128, 128, 128, bf16, True, 0, 256),
        ("d=24 f32 causal", 2, 256, 256, 24, f32, True, 0, 0),
    ]
    for tag, rows, sq, sk, dh, dt, causal, qo, ko, *form in flash_cases:
        q, g = rnd(rows, sq, dh, dt), rnd(rows, sq, dh, dt)
        k, v = rnd(rows, sk, dh, dt), rnd(rows, sk, dh, dt)
        out[tag] = check_flash(torch, ak, q, k, v, g, qo, ko, causal, tag, *form)
        del q, k, v, g
        torch.cuda.empty_cache()
    # B9: the zigzag chunk (c = seq / 4 at sp = 2), its diagonal (causal,
    # empty state) then a full fold carrying the result, in the wgmma form
    # with its backward, and by request in the CUDA-core form
    c = s // 4
    ggen = torch.Generator(device=dev).manual_seed(SEED + 15)
    q, k, v = (rnd(bh9, c, d, bf16) for _ in range(3))
    k2, v2 = rnd(bh9, c, d, bf16), rnd(bh9, c, d, bf16)
    fresh = ak.empty_state(bh9, c, d, dev)
    errs = {}
    for form in ("sm90", "simt"):
        st, win, e1 = check_block_update(torch, ak, q, k, v, fresh, 0, 0, True,
                                         f"zigzag diag ({bh9}, {c}, {d}) bf16 {form}", form)
        if form == "sm90":
            errs.update(check_block_update_bwd(torch, ak, q, k, v, fresh, st, win, 0, 0, True,
                                               "zigzag diag", ggen))
        st2, win, e2 = check_block_update(torch, ak, q, k2, v2, st, 0, 0, False,
                                          f"zigzag full ({bh9}, {c}, {d}) bf16 {form}", form)
        if form == "sm90":
            errs.update(check_block_update_bwd(torch, ak, q, k2, v2, st, st2, win, 0, 0, False,
                                               "zigzag full", ggen))
        errs["block_update" + ("_sm90" if form == "sm90" else "")] = max(e1, e2)
        del st, st2, win
    out[f"B9 zigzag ({bh9}, {c}, {d})"] = errs
    # B9 folding the same block twice: the second fold's maximal scores tie
    # the carried m, where the kernel gives the whole term through the max to
    # m and torch or JAX would split it; the backward held to the closed form
    # under the kernel's rule
    sub = slice(0, 16)
    st = ak.empty_state(16, c, d, dev)
    for fold in range(2):
        new, win, _ = check_block_update(torch, ak, q[sub], k2[sub], v2[sub], st, 0, 0, False,
                                         f"B9 same block, fold {fold}", ties=fold == 1)
        if fold == 1:
            check(bool((win < 0).all()),
                  "attention parity: B9 folding a block twice: a score beat the m it gave")
            out["B9 same block twice (16, 512, 64)"] = check_block_update_bwd(
                torch, ak, q[sub], k2[sub], v2[sub], st, new, win, 0, 0, False,
                "B9 same block twice", ggen)
        st = new
    del q, k, v, k2, v2, fresh, st, new, win
    # B9: the ring's two hops at the local sequence (seq / 2), per-row offsets,
    # each hop folding another rank's k/v block, as on the path; hop 1 leaves
    # every row of the seq-rank-0 ranks fully masked
    sl = s // 2
    q = rnd(bh9, sl, d, bf16)
    kv = [(rnd(bh9, sl, d, bf16), rnd(bh9, sl, d, bf16)) for _ in range(2)]
    errs = {}
    for form in ("sm90", "simt"):
        state = ak.empty_state(bh9, sl, d, dev)
        worst = 0.0
        for hop, (k, v) in enumerate(kv):
            qo, ko = ring_offsets(torch, dev, sl, hop, rows_per_rank=bh9 // WORLD)
            new, win, e = check_block_update(torch, ak, q, k, v, state, qo, ko, True,
                                             f"ring hop {hop} ({bh9}, {sl}, {d}) bf16 {form}",
                                             form)
            if form == "sm90" and hop == 1:
                errs.update(check_block_update_bwd(torch, ak, q, k, v, state, new, win, qo, ko,
                                                   True, "ring hop 1", ggen))
            state, worst = new, max(worst, e)
            torch.cuda.empty_cache()
        errs["block_update" + ("_sm90" if form == "sm90" else "")] = worst
        del state
    out[f"B9 ring ({bh9}, {sl}, {d}) offsets"] = errs
    del q, k, v, kv
    # B9 at head_dim 128 in the wgmma form, with its backward
    qo, ko = rows_of(0, 64, 0, 256), rows_of(128, 0, 200, 0)
    q, k, v = rnd(4, 256, 128, bf16), rnd(4, 384, 128, bf16), rnd(4, 384, 128, bf16)
    st = (torch.randn((4, 256, 128), generator=gen, device=dev),
          torch.randn((4, 256), generator=gen, device=dev),
          torch.rand((4, 256), generator=gen, device=dev) + 0.5)
    new, win, e = check_block_update(torch, ak, q, k, v, st, qo, ko, True, "B9 d=128 offsets")
    out["B9 d=128 bf16 row offsets"] = {
        "block_update_sm90": e,
        **check_block_update_bwd(torch, ak, q, k, v, st, new, win, qo, ko, True, "B9 d=128", ggen)}
    # B9 edge shapes in the CUDA-core form: f32, head_dim 8/16/128, rows masked
    for tag, rows, sq, sk, dh, dt, causal, qo, ko in (
            ("B9 d=8 f32 causal", 4, 128, 128, 8, f32, True, 0, 0),
            ("B9 d=16 bf16 rows masked", 4, 256, 128, 16, bf16, True, 0, 64),
            ("B9 d=128 f32 noncausal", 2, 128, 256, 128, f32, False, 0, 0)):
        st = (torch.randn((rows, sq, dh), generator=gen, device=dev),
              torch.randn((rows, sq), generator=gen, device=dev),
              torch.rand((rows, sq), generator=gen, device=dev) + 0.5)
        _, _, e = check_block_update(torch, ak, rnd(rows, sq, dh, dt), rnd(rows, sk, dh, dt),
                                     rnd(rows, sk, dh, dt), st, qo, ko, causal, tag)
        out[tag] = {"block_update": e}
    return out


def gpt_medium():
    from mlsl_tpu_torch.models import transformer as tfm

    return tfm.GPT_MEDIUM_2K


def build_transformer(torch, env, np, dp, sp, tp, attention, n_blocks=None, base=None, **kw):
    """``kw``: HybridTrainer's options (distributed_update, optimizer)."""
    import dataclasses

    from mlsl_tpu_torch.models import transformer as tfm

    base = base or gpt_medium()
    cfg = dataclasses.replace(base, attention=attention, dtype="bfloat16",
                              n_blocks=n_blocks or base.n_blocks)
    trainer = tfm.HybridTrainer(env, cfg, dp, sp, tp, batch=TFM_BATCH, lr=0.1, seed=SEED, **kw)
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, size=(TFM_BATCH, cfg.seq_len)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(TFM_BATCH, cfg.seq_len)).astype(np.int32)
    return trainer, trainer.shard_tokens(toks, labels)


# the tensor-core product (ops/mxu.py) against its plain float32 version:
# relative L2 bounds derived before the switch (cuda_tests/test_mxu.py): a
# bf16 x bf16 product is exact in float32, so the forward differs only in the
# order of the float32 sum; each gradient is one rounding to bf16 of the
# same cotangent products, so the two routes differ where differently
# ordered sums round to neighbouring bf16 values (1e-3: up to 3 % of them)
MXU_FWD_TOL = 1e-5
MXU_GRAD_TOL = 1e-3


def mxu_products_a_block(cfg) -> int:
    """mxu_einsum calls a block's forward makes: the attention output
    projection and the MLP's second product, or the two expert products."""
    return 3 if cfg.n_experts else 2


def phase_mxu(torch, mxu, dev, bf16) -> list:
    """mxu_einsum on bf16 operands at gpt-medium-2k's ``wo`` and ``w2`` shapes
    (run (a): batch 8, 1 rank) and the MoE's first expert product (run (d):
    dp = sp = tp = 2, 4 local experts, capacity 512), forward and backward,
    held to the plain float32 version on the same inputs; times of both
    routes (CUDA events) beside the tensor-core bound. -> one dict a shape."""
    from mlsl_tpu_torch.models import transformer as tfm

    cfg, moe = tfm.GPT_MEDIUM_2K, tfm.GPT_MEDIUM_2K_MOE8
    b, s, h, dh, dm = TFM_BATCH, cfg.seq_len, cfg.n_heads, cfg.head_dim, cfg.d_model
    ff = cfg.mlp_ratio * dm
    one, grid8 = (1, 1, 1, 1), (1, 2, 2, 2)
    el = moe.n_experts // 2
    cap = int((TFM_BATCH // 2) * (cfg.seq_len // 2) // 2 * moe.capacity_factor / moe.n_experts)
    # (tag, spec, a shape, w shape, output elements, contracted length)
    cases = [("wo, run (a)", "...bhsx,...hxd->...bsd", (*one, b, h, s, dh), (*one, h, dh, dm),
              b * s * dm, h * dh),
             ("w2, run (a)", "...bsf,...fd->...bsd", (*one, b, s, ff), (*one, ff, dm),
              b * s * dm, ff),
             ("expert w1, run (d)", "...ecd,...edf->...ecf", (*grid8, 2, el, cap, dm),
              (*grid8, 1, el, dm, ff), 8 * 2 * el * cap * ff, dm)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    out = []
    for tag, spec, sa, sw, n_out, k in cases:
        a = torch.randn(sa, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(sw, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        res = {}
        for plain in (False, True):
            x, y = a.clone().requires_grad_(), w.clone().requires_grad_()
            before = dict(mxu.CALLS)
            o = mxu.mxu_einsum(spec, x, y, plain=plain)
            g = torch.randn(o.shape, generator=gen.manual_seed(SEED + 31), device=dev)
            o.backward(g)
            torch.cuda.synchronize()
            calls = {key: mxu.CALLS[key] - before[key] for key in mxu.CALLS}
            check(calls == ({"mxu_bf16_fwd": 0, "mxu_bf16_bwd": 0} if plain else
                            {"mxu_bf16_fwd": 1, "mxu_bf16_bwd": 2}),
                  f"mxu {tag}: calls {calls} (plain={plain})")
            check(o.dtype == torch.float32 and x.grad.dtype == torch.bfloat16,
                  f"mxu {tag}: dtypes {o.dtype}, {x.grad.dtype}")
            res[plain] = (o.detach(), x.grad, y.grad)
            del x, y, o
        (o, ga, gw), (po, pga, pgw) = res[False], res[True]
        errs = {"fwd": rel_err(torch, o, po), "grad_a": rel_err(torch, ga, pga),
                "grad_w": rel_err(torch, gw, pgw)}
        check(bool(torch.isfinite(o).all()), f"mxu {tag}: non-finite product")
        check(errs["fwd"] <= MXU_FWD_TOL, f"mxu {tag}: forward off by {errs['fwd']:.3g}")
        check(max(errs["grad_a"], errs["grad_w"]) <= MXU_GRAD_TOL,
              f"mxu {tag}: gradients off by {errs}")
        gy = torch.randn(o.shape, device=dev)
        del res, o, ga, gw, po, pga, pgw
        x, y = a.clone().requires_grad_(), w.clone().requires_grad_()

        def fwd(plain):
            return lambda: mxu.mxu_einsum(spec, a, w, plain=plain)

        def fwd_bwd(plain):
            def run():
                x.grad = y.grad = None
                mxu.mxu_einsum(spec, x, y, plain=plain).backward(gy)
            return run

        before = dict(mxu.CALLS)
        ms = {"ms": time_ms(torch, fwd(False), reps=10, warmup=2),
              "plain_ms": time_ms(torch, fwd(True), reps=3, warmup=1),
              "fwd_bwd_ms": time_ms(torch, fwd_bwd(False), reps=10, warmup=2),
              "plain_fwd_bwd_ms": time_ms(torch, fwd_bwd(True), reps=3, warmup=1)}
        mxu.CALLS.update(before)
        flops = 2 * n_out * k      # a forward product; its backward is two more
        out.append({"shape": tag, "spec": spec, "a": list(sa), "w": list(sw), **errs, **ms,
                    "bound_ms": flops / bf16 * 1e3, "bound_fwd_bwd_ms": 3 * flops / bf16 * 1e3})
        del a, w, x, y, gy
        torch.cuda.empty_cache()
    return out


def phase_transformer(torch, trainer, batch, steps=3, first=None):
    """``steps`` training steps on one fixed batch. On the fused path every
    step is ``step``: the first captures the step's CUDA graph (one eager
    warm-up, then the recording), the others replay it. Otherwise the last
    runs as its halves (what ``step`` runs) so that its gradients stay at
    hand, and with ``first`` (a dict) the first too, whose loss and gradient
    rows before sync go to the host into ``first``. Checks that every
    block's ``mxu_einsum`` products ran on the tensor cores, forward and
    backward (on the fused path in the warm-up and the recording). -> (mean
    losses, step seconds, the last step's split, its gradient rows or None on
    the fused path)."""
    from mlsl_tpu_torch.ops import mxu

    mxu.reset_counts()
    losses, secs, grads = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if trainer.fused:
            loss = trainer.step(*batch)
            split = {"graph_replay_s": None}
        elif i == 0 and first is not None:
            loss, g0 = trainer._grad_fn(*batch)
            first["loss"] = loss.cpu()
            first["rows"] = {name: row.cpu() for name, row in g0.items()}
            loss = trainer._sync_and_update(g0, loss)
            del g0
        elif i < steps - 1:
            loss = trainer.step(*batch)
        else:
            loss, grads = trainer._grad_fn(*batch)
            torch.cuda.synchronize()
            split = {"forward_backward_s": time.perf_counter() - t0}
            t1 = time.perf_counter()
            loss = trainer._sync_and_update(grads, loss)
            torch.cuda.synchronize()
            split["sync_and_update_s"] = time.perf_counter() - t1
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    if trainer.fused:
        split["graph_replay_s"] = secs[-1]
        split["capture_s"] = [c.capture_s for _, c in trainer._graphs.values()]
    # the graph's products ran in the warm-up and the recording only
    ran = 2 if trainer.fused and trainer._graphs else steps
    want = mxu_products_a_block(trainer.cfg) * trainer.cfg.n_blocks * ran
    fwd = want * replays(trainer.cfg)
    check(mxu.CALLS == {"mxu_bf16_fwd": fwd, "mxu_bf16_bwd": 2 * want},
          f"transformer: mxu_einsum tensor-core calls {mxu.CALLS}, expected {fwd} forward "
          f"and {2 * want} backward products")
    return losses, secs, split, grads


def check_losses(losses, vocab, tag):
    import math

    first = math.log(vocab)
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(abs(losses[0] - first) < 1.0,
          f"{tag}: first loss {losses[0]} is not within 1.0 of ln {vocab} = {first:.4f}")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")


def check_transformer_grads(torch, trainer, grads, tag="transformer 8 ranks") -> float:
    """Each layer's reduced gradient on the last step against the float64
    sum of its rank rows over the data x seq group: every member holds the
    same sum, within 1e-6 relative L2 error. -> the worst layer's error."""
    from mlsl_tpu_torch.comm.collectives import group_view

    group = trainer.dist.grad_group
    worst = 0.0
    for name in trainer.layers:
        reduced = group_view(trainer.ops[name].get_parameter_set(0).grad_req._result, group)
        check(bool((reduced == reduced[:, :1]).all()),
              f"{tag}: members disagree on layer {name}'s reduced gradient")
        exact = group_view(grads[name], group).double().sum(dim=1, keepdim=True)
        rel = rel_err(torch, reduced[:, :1], exact)
        worst = max(worst, rel)
        check(rel < 1e-6, f"{tag}: layer {name} reduced gradient off by {rel:.3g}")
    return worst


def step_line(tag, trainer, losses, secs, split, launches):
    tokens = trainer.batch * trainer.cfg.seq_len
    return (f"# {tag} train step (host clock, synchronized): "
            + json.dumps({"losses": losses, "step_s": secs, "tokens_per_s":
                          [tokens / x for x in secs], "last_step_split_s": split,
                          "launches": launches}))


def model_flops(cfg, batch):
    """The analytic model FLOPs of a train step, the reference bench's MFU
    denominator (benchmarks/_common.py:107): 3x the forward's, per token and
    block 8 d ad (q, k, v, o) + 4 mlp_ratio d^2 (MLP) + 2 S ad (causal
    attention), plus 2 d V for the head; no remat replay counted."""
    t = batch * cfg.seq_len
    d, ad = cfg.d_model, cfg.n_heads * cfg.head_dim
    per_tok_blk = 8 * d * ad + 4 * cfg.mlp_ratio * d * d + 2 * cfg.seq_len * ad
    return 3.0 * t * (cfg.n_blocks * per_tok_blk + 2 * d * cfg.vocab)


def check_fused_launches(ta, trainer, compiled, tag):
    """A fused run's B7/B8 launches: the graph records one step's (B7 once a
    block, twice under remat; each B8 pass once), and the launches that ran
    are the warm-up's and the recording's, twice as many; no B9 and no
    CUDA-core form. -> the recorded launches."""
    from mlsl_tpu_torch.ops import attention_kernels as ak

    n = trainer.cfg.n_blocks
    want = dict(flash_fwd_sm90=n * replays(trainer.cfg), flash_bwd_dq_sm90=n,
                flash_bwd_dkv_sm90=n)
    rec = {k: compiled.launches.get(k, 0) for k in ak.LAUNCHES}
    check(counts_are(rec, **want, flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0, **NO_B9),
          f"{tag}: launches recorded in the graph {rec}, expected {want} and no other")
    check(counts_are(ta, **{k: 2 * v for k, v in want.items()}, flash_fwd=0, flash_bwd_dq=0,
                     flash_bwd_dkv=0, **NO_B9),
          f"{tag}: launches {ta}, expected twice {want} (the warm-up and the recording)")
    return rec


def phase_graph_twin(torch, np, env, trainer, batch, losses, secs):
    """Run (r): run (a), its step one CUDA graph (the first step captures,
    the others replay), against an eager twin from the same seed that takes
    the same steps through ``_eager_step``: the losses and every parameter
    bit for bit. Where two eager twins already differ from each other, the
    bound is what they show (the largest difference of a parameter, and of a
    loss), and it is printed. With the step's FLOPs (``compiled_step``)
    against the reference bench's model FLOPs. -> (the report, the eager
    twins' attention launches)."""
    from mlsl_tpu_torch.ops import attention_kernels as ak

    compiled = trainer.compiled_step(*batch)
    graph_params = [p.detach().clone() for p in trainer._all_leaves()]

    def eager():
        twin, b = build_transformer(torch, env, np, 1, 1, 1, "ring")
        ls, ss = [], []
        for _ in losses:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ls.append(float(twin._eager_step(*b)))
            torch.cuda.synchronize()
            ss.append(time.perf_counter() - t0)
        ps = [p.detach().clone() for p in twin._all_leaves()]
        check(not twin._graphs, "graph twin: the eager twin captured a graph")
        return ls, ps, ss

    def gap(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    before = {k: v for k, v in ak.LAUNCHES.items()}
    e_losses, e_params, e_secs = eager()
    same = losses == e_losses and all(torch.equal(a, b) for a, b in zip(graph_params, e_params))
    report = {"bit_for_bit": same, "graph_losses": losses, "eager_losses": e_losses,
              "graph_step_s": secs, "eager_step_s": e_secs, "capture_s": compiled.capture_s,
              "launches_recorded": {k: v for k, v in compiled.launches.items() if v},
              "memory": compiled.memory_analysis()}
    if not same:
        e2_losses, e2_params, _ = eager()
        bound, loss_bound = gap(e_params, e2_params), max(
            abs(a - b) for a, b in zip(e_losses, e2_losses))
        got, loss_got = gap(graph_params, e_params), max(
            abs(a - b) for a, b in zip(losses, e_losses))
        report.update(eager_twins_param_gap=bound, eager_twins_loss_gap=loss_bound,
                      graph_param_gap=got, graph_loss_gap=loss_got)
        check(bound > 0 and got <= bound and loss_got <= loss_bound,
              f"graph twin: the graph run differs from its eager twin by {got:.3g} "
              f"(losses {loss_got:.3g}), two eager twins by {bound:.3g} ({loss_bound:.3g})")
    twins = {k: v - before[k] for k, v in ak.LAUNCHES.items()}
    flops = compiled.cost_analysis()["flops"]
    mf = model_flops(trainer.cfg, trainer.batch)
    report.update(flops=flops, kernel_flops=compiled.kernel_flops, model_flops=mf,
                  flops_over_model_flops=flops / mf)
    del graph_params, e_params
    return report, twins


# the sharded-vocabulary run (q) against run (b): its first step's loss
SV_LOSS_RTOL = 1e-5
# the final layer's gradient rows, of their largest magnitude: the head's
# shards and the final norm see the same float32 cotangents in both runs
SV_HEAD_TOL = 1e-5
# every other layer's rows, of their largest magnitude. The two heads split
# the cotangent of the final hidden states differently between the model
# ranks (each rank its vocabulary shard's share, against half of the whole),
# and each rank's share is rounded to bf16 where it enters the blocks
# (2^-8 relative a rounding); on the CPU at d_model 128 the rows differ by
# 0.44-0.77 % at 2 blocks and up to 1.3 % at 8
SV_BLOCK_TOL = 2 ** -5


def sharded_rows_like(torch, trainer, rows, name):
    """Run (b)'s gradient row of ``name`` in run (q)'s layout: the final
    layer's replicated head gradient cut to each model rank's vocabulary
    shard."""
    if name != "final":
        return rows
    cfg, tp = trainer.cfg, trainer.tp
    dm, v = cfg.d_model, cfg.vocab
    grid = rows.shape[:4]
    head = rows[..., :dm * v].reshape(*grid, dm, tp, v // tp)
    shard = torch.stack([head[:, :, :, m, :, m] for m in range(tp)], dim=3)
    tail = rows[..., dm * v:dm * v + 2 * dm]
    return torch.cat([shard.reshape(*grid, -1), tail], dim=-1)


def head_ms(torch, tfm, trainer, batch, sharded: bool, dev) -> float:
    """The LM head and its CE, forward and backward (``head_ce``), at run
    (b)'s shapes on random inputs: the replicated head, or each rank's
    vocabulary shard. CUDA events."""
    import dataclasses

    cfg = dataclasses.replace(trainer.cfg, sharded_vocab=sharded)
    grid, (bl, sl) = trainer.grid, batch[0].shape[-2:]
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    v = cfg.vocab // trainer.tp if sharded else cfg.vocab
    h = torch.randn((*grid, bl, sl, cfg.d_model), generator=gen, device=dev).requires_grad_()
    head = (torch.randn((*grid, cfg.d_model, v), generator=gen, device=dev) * 0.02
            ).requires_grad_()

    def run():
        ce = tfm.head_ce(h, head, batch[1], cfg, trainer.tp)
        torch.autograd.grad(ce.sum(), (h, head))

    ms = time_ms(torch, run, reps=5, warmup=1)
    del h, head
    torch.cuda.empty_cache()
    return ms


def phase_sharded_vocab(torch, np, get_env, launches, reset_launches, b_run, dev):
    """Run (q): run (b) (gpt-medium-2k, dp=2 x sp=2 x tp=2, zigzag, B9) with
    the LM head sharded over the model axis, on (b)'s weights and batch: the
    first step's loss and gradient rows before sync against (b)'s first step
    (``b_run["first"]``; the final layer's head rows compared shard by
    shard), then three steps whose losses fall; step time, peak memory and
    the head's seconds beside (b)'s. -> (the report, the launches of the
    three steps)."""
    import dataclasses

    from mlsl_tpu_torch.models import transformer as tfm
    from mlsl_tpu_torch.ops import attention_kernels as ak

    env = reinit(get_env)
    settle(torch)
    base = dataclasses.replace(gpt_medium(), sharded_vocab=True)
    trainer, batch = build_transformer(torch, env, np, 2, 2, 2, "zigzag", base=base)
    check(not trainer.fused, "transformer sharded vocab: the step did not take the graph path")
    first = b_run["first"]
    loss, rows = trainer._grad_fn(*batch)
    torch.cuda.synchronize()
    ref_loss = first["loss"].to(dev)
    loss_err = float(((loss - ref_loss).abs() / ref_loss.abs()).max())
    check(loss_err <= SV_LOSS_RTOL, f"transformer sharded vocab: first loss {loss_err:.3g} "
                                    f"from run (b)'s")
    errs = {}
    for name in trainer.layers:
        got = rows[name]
        ref = sharded_rows_like(torch, trainer, first["rows"][name].to(dev), name)
        n = min(got.shape[-1], ref.shape[-1])
        errs[name] = float((got[..., :n] - ref[..., :n]).abs().max() / ref.abs().max())
        tol = SV_HEAD_TOL if name == "final" else SV_BLOCK_TOL
        check(errs[name] <= tol, f"transformer sharded vocab: layer {name} rows "
                                 f"{errs[name]:.3g} of their largest magnitude from run (b)'s "
                                 f"(bound {tol:g})")
        del ref
    del rows, loss, first, b_run["first"]
    settle(torch)
    reset_launches()
    losses, secs, split, _ = phase_transformer(torch, trainer, batch)
    tq = {k: launches()[k] for k in ak.LAUNCHES}
    check_losses(losses, trainer.cfg.vocab, "transformer sharded vocab")
    n, steps = trainer.cfg.n_blocks, len(losses)
    check(counts_are(tq, **b9_counts(5 * n * steps), flash_fwd=0, flash_bwd_dq=0,
                     flash_bwd_dkv=0, **NO_SM90),
          f"transformer sharded vocab: launches {tq}, expected {5 * n} B9 (wgmma) and {5 * n} "
          f"of each of its backward passes per step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    report = {"first_loss_rel_err": loss_err, "final_rows_err": errs["final"],
              "worst_other_rows_err": max(v for k, v in errs.items() if k != "final"),
              "rows_err": errs, "losses": losses, "b_losses": b_run["losses"],
              "step_s": secs, "b_step_s": b_run["secs"], "peak_gib": peak,
              "b_peak_gib": b_run["peak"], "split": split}
    reset_launches()
    report["head_ce_fwd_bwd_ms"] = head_ms(torch, tfm, trainer, batch, True, dev)
    report["b_head_ce_fwd_bwd_ms"] = head_ms(torch, tfm, trainer, batch, False, dev)
    reset_launches()
    del trainer, batch
    settle(torch)
    return report, tq


def attention_entries(torch, F, ak, bw, bf16, runs, dev):
    """B7, B8 (both passes), B9 (each in both forms) and B9's backward passes
    at the transformer's shapes:
    time against the bound (bytes over the memory rate or operations over the
    bf16 tensor-core rate, whichever is larger), the plain version's time and,
    for B7 and B8, scaled_dot_product_attention's as the library yardstick
    (timed here; the port never calls it)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    cfg = gpt_medium()
    b, h, s, d = TFM_BATCH, cfg.n_heads, cfg.seq_len, cfg.head_dim
    bh = b * h

    def rnd(rows, n):
        return torch.randn((rows, n, d), generator=gen, device=dev).to(torch.bfloat16)

    def path(key):
        return {k: v.get(key, 0) for k, v in runs.items()}

    def counted(fn):
        """Run ``fn`` with its launches left out of the path's count."""
        before = dict(ak.LAUNCHES)
        try:
            return fn()
        finally:
            ak.LAUNCHES.update(before)

    q, k, v, g = rnd(bh, s), rnd(bh, s), rnd(bh, s), rnd(bh, s)
    zero = ak.offsets(0, bh, dev)       # on the card already: the timings hold no fill
    pairs = visible_pairs(torch, ak, bh, s, s, 0, 0, True, dev)
    t_el = bh * s * d * 2                       # bytes of one bf16 (BH, S, D) tensor
    row = bh * s * 4                            # bytes of one f32 (BH, S) row vector
    q4, k4, v4, g4 = (t.view(b, h, s, d) for t in (q, k, v, g))
    sdpa = F.scaled_dot_product_attention
    lib_fwd = time_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), reps=20)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
    lib_fb = time_ms(torch, lambda: torch.autograd.grad(sdpa(qs, ks, vs, is_causal=True),
                                                        (qs, ks, vs), g4), reps=20)
    entries = []
    for form, key, src, p_dtype in (("sm90", "_sm90", SM90_SRC, torch.bfloat16),
                                    ("simt", "", ATTN_SRC, torch.float32)):
        common = dict(source=src, bw=bw, peak=bf16, shape=[bh, s, s, d], form=form,
                      form_note="the wgmma form, which the path launches" if form == "sm90"
                      else "the CUDA-core form, launched here by request: bf16 with head_dim "
                           "64 takes the wgmma form on the path")
        label = " wgmma" if form == "sm90" else ""
        o, lse = counted(lambda: ak.flash_fwd(q, k, v, zero, zero, True, form=form))
        ro, _ = ak.flash_fwd_ref(q, k, v, zero, zero, True, p_dtype=p_dtype)
        entries.append(entry(
            name=f"flash_fwd{key} (B7{label})", replaces=f"{ATTN_PY}:154",
            launches=sum(path(f"flash_fwd{key}").values()), per_path=path(f"flash_fwd{key}"),
            err=float((o.float() - ro.float()).abs().max()),
            ms=counted(lambda: time_ms(torch, lambda: ak.flash_fwd(q, k, v, zero, zero, True,
                                                                   form=form), reps=20)),
            plain_ms=time_ms(torch, lambda: ak.flash_fwd_ref(q, k, v, zero, zero, True,
                                                             p_dtype=p_dtype),
                             reps=3, warmup=1),
            library_ms=lib_fwd, nbytes=4 * t_el + row, ops=4 * d * pairs, **common,
            note="causal, bf16, with the lse (the training path's call); plain version with "
                 f"p_dtype={str(p_dtype).split('.')[-1]}",
            library_note=f"scaled_dot_product_attention(q, k, v, is_causal=True), bf16 "
                         f"{tuple(q4.shape)}"))
        del ro
        dd = (g.float() * o.float()).sum(-1)
        for name, fn, plain, ops, nbytes, line in (
                ("flash_bwd_dq",
                 lambda: ak.flash_bwd_dq(q, k, v, g, lse, dd, zero, zero, True, form=form),
                 lambda: ak.flash_bwd_dq_ref(q, k, v, g, lse, dd, zero, zero, True,
                                             p_dtype=p_dtype),
                 6 * d * pairs, 5 * t_el + 2 * row, 311),
                ("flash_bwd_dkv",
                 lambda: ak.flash_bwd_dkv(q, k, v, g, lse, dd, zero, zero, True, form=form),
                 lambda: ak.flash_bwd_dkv_ref(q, k, v, g, lse, dd, zero, zero, True,
                                              p_dtype=p_dtype),
                 8 * d * pairs, 6 * t_el + 2 * row, 335)):
            got, want = counted(fn), plain()
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
            entries.append(entry(
                name=f"{name}{key} (B8{label})", replaces=f"{ATTN_PY}:297 (:{line})",
                launches=sum(path(name + key).values()), per_path=path(name + key), err=err,
                ms=counted(lambda: time_ms(torch, fn, reps=20)),
                plain_ms=time_ms(torch, plain, reps=3, warmup=1),
                library_ms=lib_fb - lib_fwd, nbytes=nbytes, ops=ops, **common,
                library_note="scaled_dot_product_attention forward + backward less its "
                             "forward, for both passes together"))
            del got, want
        del o, lse, dd
    del q, k, v, g, qs, ks, vs

    # B9 at the zigzag chunk (the 3 full folds of its 5 calls a block) and at
    # the ring's second hop, with per-row offsets: the wgmma form as the
    # training path calls it (with its winners), its backward's two passes,
    # and by request the CUDA-core form. ``ms`` is the call as the path pays
    # for it, the wrapper's host work included (about as long as the wgmma
    # kernel); ``graph_ms`` the device's time alone, 20 calls captured in one
    # CUDA graph. Bytes: q, k, v and ga in bf16 for the rows and keys that
    # some pair sees (``seen_rows``: at the ring hop the offsets hide every
    # key from half the rows, whose state is only copied through); acc read
    # and written, m and l read and written, the winners written and the
    # offsets read for every row; the passes read m', -gl, the winners and g
    # of the rows that see a key, and write dq or dk and dv whole.
    bh9, c = WORLD * (TFM_BATCH // 2) * (h // 2), s // 4
    gen9 = torch.Generator(device=dev).manual_seed(SEED + 16)

    def graph_too(fn, reps=20):
        """-> (``time_ms`` of ``fn``, its time in a CUDA graph), both counted out."""
        return (counted(lambda: time_ms(torch, fn, reps=reps)),
                counted(lambda: time_graph_ms(torch, fn)))

    for tag, sq, causal, offs in (("zigzag chunk, full fold", c, False, (0, 0)),
                                  ("zigzag chunk, diagonal", c, True, (0, 0)),
                                  ("ring hop 1, offsets", s // 2, True,
                                   ring_offsets(torch, dev, s // 2, 1, bh9 // WORLD))):
        q, k, v = rnd(bh9, sq), rnd(bh9, sq), rnd(bh9, sq)
        st = (torch.randn((bh9, sq, d), generator=gen, device=dev),
              torch.zeros((bh9, sq), device=dev), torch.ones((bh9, sq), device=dev))
        qo, ko = (ak.offsets(x, bh9, dev) for x in offs)
        n_pairs = visible_pairs(torch, ak, bh9, sq, sq, qo, ko, causal, dev)
        q_rows, k_rows = seen_rows(torch, ak, bh9, sq, sq, qo, ko, causal, dev)
        el, rows9 = bh9 * sq * d, bh9 * sq * 4
        qb, kb, row_b = q_rows * d * 2, k_rows * d * 2, q_rows * 4
        common = dict(bw=bw, peak=bf16, shape=[bh9, sq, sq, d], library_ms=None,
                      library_note="no single PyTorch call folds a block into a carried "
                                   "online-softmax state, or takes its vjp",
                      seen_query_rows=q_rows, seen_key_rows=k_rows)
        fwd = lambda form, win=True: ak.block_update(  # noqa: E731
            q, k, v, *st, qo, ko, causal, want_winner=win and form == "sm90", form=form)
        for form, key, src, p_dtype in (("sm90", "_sm90", SM90_SRC, torch.bfloat16),
                                        ("simt", "", ATTN_SRC, torch.float32)):
            got = counted(lambda: fwd(form))
            want = ak.block_update_tiled_ref(q, k, v, *st, qo, ko, causal, p_dtype=p_dtype)
            ms, graph_ms = graph_too(lambda: fwd(form))
            extra = {}
            if form == "sm90":
                extra["no_winner_ms"], extra["no_winner_graph_ms"] = graph_too(
                    lambda: fwd(form, win=False))
            entries.append(entry(
                name=f"block_update{key} (B9{' wgmma' if form == 'sm90' else ''}, {tag})",
                replaces=f"{ATTN_PY}:442", source=src, form=form,
                launches=sum(path(f"block_update{key}").values()),
                per_path=path(f"block_update{key}"),
                err=float((got[0] - want[0]).abs().max()), ms=ms, graph_ms=graph_ms, **extra,
                plain_ms=time_ms(torch, lambda: ak.block_update_tiled_ref(
                    q, k, v, *st, qo, ko, causal, p_dtype=p_dtype), reps=3, warmup=1),
                nbytes=qb + 2 * kb + 2 * el * 4 + 4 * rows9
                + (rows9 if form == "sm90" else 0) + 2 * bh9 * 4,
                ops=4 * d * n_pairs, **common,
                note=("with the winners (the training path's call; no_winner_*: the "
                      "no-grad call); " if form == "sm90" else
                      "by request: bf16 with head_dim 64 takes the wgmma form on the path; ")
                + f"graph_ms: a CUDA graph of 20 calls; plain version block_update_tiled_ref, "
                  f"p_dtype={str(p_dtype).split('.')[-1]}"))
            del want
        acc_n, m_n, l_n, win = counted(lambda: fwd("sm90"))
        ga = torch.randn((bh9, sq, d), generator=gen9, device=dev)
        gm, gl = torch.zeros((bh9, sq), device=dev), torch.randn((bh9, sq), generator=gen9,
                                                                  device=dev)
        bwd = lambda: ak.block_update_bwd(q, k, v, *st, m_n, l_n, acc_n, win,  # noqa: E731
                                          ga, gm, gl, qo, ko, causal)
        plain = lambda: ak.block_update_bwd_ref(  # noqa: E731
            q, k, v, *st, m_n, l_n, acc_n, ga, gm, gl, qo, ko, causal,
            p_dtype=torch.bfloat16, g_dtype=torch.bfloat16, win=win)
        got_b, want_b = counted(bwd), plain()
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        call_ms, call_graph_ms = graph_too(bwd)
        # each pass alone on the inputs the call prepares (g = 0 here)
        prep = (q, k, v, ga.to(q.dtype), m_n, (-gl).contiguous(), win, torch.zeros_like(gm),
                qo, ko, causal)
        for name, which, pick, ops, nbytes in (
                ("block_update_bwd_dq_sm90", "dq", slice(0, 1), 6 * d * n_pairs,
                 2 * qb + 2 * kb + el * 2 + 4 * row_b + 2 * bh9 * 4),
                ("block_update_bwd_dkv_sm90", "dkv", slice(1, 3), 8 * d * n_pairs,
                 2 * qb + 2 * kb + 2 * el * 2 + 4 * row_b + 2 * bh9 * 4)):
            err = max(float((a.float() - w.float()).abs().max())
                      for a, w in zip(got_b[pick], want_b[pick]))
            ms, graph_ms = graph_too(lambda: ak.bu_bwd_pass(which, *prep))
            entries.append(entry(
                name=f"{name} (B9 backward, {tag})",
                replaces=f"{ATTN_PY}:530 (_bu_bwd, jax.vjp of _block_update_ref; no Pallas)",
                source=SM90_SRC, form="sm90", launches=sum(path(name).values()),
                per_path=path(name), err=err, ms=ms, graph_ms=graph_ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=ops, **common,
                note="the pass alone; call_ms: block_update_bwd, both passes and the PyTorch "
                     "row terms around them; graph_ms and call_graph_ms: as a CUDA graph of "
                     "20 calls; plain version: block_update_bwd_ref with P, dS and ga rounded "
                     "to bf16, all of that in one call",
                call_ms=call_ms, call_graph_ms=call_graph_ms))
        del q, k, v, st, got, got_b, want_b, acc_n, m_n, l_n, win, ga, gm, gl, prep
        torch.cuda.empty_cache()
    return entries


# -- the fused all-to-all (B6) and the MoE transformer ---------------------

A2A_SRC = "mlsl_tpu_torch/csrc/a2a_kernels.cu"
A2A_PY = "mlsl_tpu/ops/a2a_kernels.py"
# gpt-medium-2k-moe8 runs at its full 12 blocks under remat="full": without
# remat the step alone grows 7.3 GiB a block (62.5 GiB at 6 blocks, 77.1 at 8
# of an 80 GB H100's 79.2, profile_step --model moe-8 --blocks N); with it a
# block keeps only its input residual stream. The twin check of the two
# policies against the plain step runs at 6 blocks, where the plain step fits.
MOE_REMAT = "full"
REMAT_TWIN_BLOCKS = 6
# remat against the plain step, gradient rows before sync: a layer whose rows
# two plain runs give bit for bit (every kernel's order fixed) must match bit
# for bit; a layer whose plain runs differ (an order not fixed: atomic adds,
# as the embedding gather's backward) within this relative L2 error, a few
# float32 ulps of rows summed over 16,384 tokens in another order
REMAT_TWIN_TOL = 1e-5


def exact_scale(torch, gen, shape, block, dev):
    """Small integers with a +-127 sentinel at every block start: every
    blockwise amax is 127 and every scale exactly 1.0, so the int8 round
    trip is the identity (tests/test_pallas_a2a.py:58-65)."""
    v = torch.randint(-10, 10, shape, generator=gen, device=dev).float()
    v[..., ::block] = 127.0
    v[..., block::4 * block] = -127.0
    return v


def moe_combine_count(cfg, dp, sp, tp, batch=TFM_BATCH) -> int:
    """Floats a rank in one block's MoE combine exchange: every rank's (ep,
    E/ep, capacity, d_model) expert outputs, capacity = tokens per slice x
    factor x top_k / E."""
    per_slice = (batch // dp) * (cfg.seq_len // sp) // tp
    capacity = int(per_slice * cfg.capacity_factor * cfg.moe_top_k / cfg.n_experts)
    return cfg.n_experts * capacity * cfg.d_model


def phase_a2a_parity(torch, a2a, algos, dev, moe_count):
    """B6 against its plain version, bit for bit: dense and int8 on the
    data group of an 8 x 1 world, both single-axis groups of a (4, 2) world
    and two two-axis groups; chunks with and without padding, strided rows,
    blocks 128 to 1,024, all-zero blocks and -0.0; then the stateful
    error-feedback form over 2 rounds; then the MoE combine exchange at its
    own shape (``moe_count`` floats a rank over the model axis of a (4, 2)
    world, block BLOCK): both variants, the error-feedback form (B1 at the
    path's rows) and the differentiable route, forward and backward.
    -> number of comparisons."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    cases = 0

    def randn(w, n):
        x = torch.randn((w, n), generator=gen, device=dev).mul_(30)
        x *= torch.rand((w, 1), generator=gen, device=dev) * 10
        x[:, 1::11] = -0.0
        return x

    groups = [(8, 1, ("data",)), (4, 2, ("data",)), (4, 2, ("model",)),
              (4, 2, ("data", "model")), (2, 4, ("model", "data"))]
    for d, m, axes in groups:
        group = ProcessGroup(Topology(d, m, d * m), axes)
        w, g = d * m, group.size
        # dense: 16-byte vectors (rc % 4 == 0) and one float a thread
        for rc in (4096, 1001, 3):
            p = a2a.plan(group, g * rc, BLOCK, False)
            for ld in (0, g * rc + 5):
                x = randn(w, ld or g * rc)[:, :g * rc]
                got = a2a.alltoall(x, p)
                torch.cuda.synchronize()
                check(same_bits(torch, got, a2a.alltoall_ref(x, p)),
                      f"a2a parity: dense rc={rc} ld={ld} on {d}x{m} {axes} differs from its "
                      f"plain version")
                cases += 1
        # int8: one chunk unit exactly, a ragged tail (two units), far below one
        for block in (128, 256, 512, 1024):
            for rc in (block * 32, block * 32 + 100, 37):
                p = a2a.plan(group, g * rc, block, True)
                x = randn(w, g * p.chunk)
                x.view(w, -1, block)[:, ::5] = 0.0          # all-zero blocks: scale 1
                got = a2a.alltoall(x, p)
                torch.cuda.synchronize()
                check(same_bits(torch, got, a2a.alltoall_ref(x, p)),
                      f"a2a parity: int8 block {block} rc={rc} on {d}x{m} {axes} differs "
                      f"from its plain version")
                cases += 1
    for d, m, axes, count, block in ((8, 1, ("data",), 8 * (256 * 32 + 77), 256),
                                     (4, 2, ("model",), 2 * 3000, 128),
                                     (4, 2, ("data", "model"), 8 * 1000, 512),
                                     (4, 2, ("data",), 4 * 1024 * 32, 1024),
                                     (4, 2, ("model",), moe_count, BLOCK)):
        group = ProcessGroup(Topology(d, m, d * m), axes)
        grid = group.topology.grid_shape
        kern = algos.build("alltoall", group, "pallas_a2a", block=block, quantized=True,
                           ef=True)
        plain = algos.build("alltoall", group, "pallas_a2a", block=block, quantized=True,
                            ef=True, plain=True)
        _, el = a2a.alltoall_body_ef(group, count, block=block)
        ek = ep = torch.zeros((*grid, el), device=dev)
        for r in range(2):
            x = randn(d * m, count).reshape(*grid, count) * (1.0 + 0.5 * r)
            x[..., :3 * block] = 0.0
            ok, ek = kern(x, ek)
            op, ep = plain(x, ep)
            torch.cuda.synchronize()
            check(same_bits(torch, ok, op) and same_bits(torch, ek, ep),
                  f"a2a parity: error feedback round {r} block {block} on {d}x{m} {axes}: "
                  f"output or residual differs from the plain version")
            check(not bool(torch.signbit(ok[ok == 0]).any()),
                  "a2a parity: -0.0 survived the int8 round trip")
            cases += 1
        del x, ek, ep, ok, op
    moe = ProcessGroup(Topology(4, 2, 8), ("model",))
    for quantized in (False, True):
        p = a2a.plan(moe, moe_count, BLOCK, quantized)
        x = randn(8, 2 * p.in_chunk)
        got = a2a.alltoall(x, p)
        torch.cuda.synchronize()
        check(same_bits(torch, got, a2a.alltoall_ref(x, p)),
              f"a2a parity: {'int8' if quantized else 'dense'} MoE combine exchange "
              f"({moe_count} a rank) differs from its plain version")
        cases += 1
    # the route the MoE layer takes: int8 forward, dense exchange of the
    # cotangent backward
    x = randn(8, moe_count).requires_grad_()
    ct = randn(8, moe_count)
    out = a2a.exchange(x, moe, block=BLOCK, quantized=True)
    out.backward(ct)
    torch.cuda.synchronize()
    fwd, _ = a2a.alltoall_body_ef(moe, moe_count, block=BLOCK, plain=True)
    back, _ = a2a.alltoall_body_ef(moe, moe_count, quantized=False, plain=True)
    check(same_bits(torch, out.detach(), fwd(x.detach(), None)[0]),
          "a2a parity: the MoE exchange's forward differs from the plain version")
    check(same_bits(torch, x.grad, back(ct, None)[0]),
          "a2a parity: the MoE exchange's gradient is not the dense exchange of the "
          "cotangent")
    return cases + 2


def phase_alltoall(torch, get_env, launches, reset_launches, n=(64 << 20) // 4):
    """Distribution.all_to_all on 8 ranks at 64 MiB a rank through a
    CommRequest: lax on both payloads (equal to the closed form), then
    pallas_a2a dense on random floats and int8 on the exact-scale payload,
    each bit-exact to lax's result. -> (launches by kernel over the driven
    requests, one '# algos' line a route)."""
    from mlsl_tpu_torch import DataType, GroupType

    dev = get_env().device
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    sc = n // WORLD
    payloads = {"random": torch.randn((1, WORLD, 1, 1, n), generator=gen, device=dev),
                "exact-scale": exact_scale(torch, gen, (1, WORLD, 1, 1, n), BLOCK, dev)}
    want_launch = {"lax": {}, "pallas_a2a dense": {"a2a_dense": 1},
                   "pallas_a2a int8": {"a2a_quant": 1, "quantize_blocks": 1}}
    lax_out, used, lines = {}, {}, []
    for tag, algo, quant, payload in (("lax", "lax", "1", "random"),
                                      ("lax", "lax", "1", "exact-scale"),
                                      ("pallas_a2a dense", "pallas_a2a", "0", "random"),
                                      ("pallas_a2a int8", "pallas_a2a", "1", "exact-scale")):
        env = reinit(get_env, MLSL_ALGO=f"alltoall={algo}", MLSL_PALLAS_A2A_QUANT=quant)
        dist = env.create_distribution(WORLD, 1)
        x = payloads[payload]

        def start():
            return dist.all_to_all(x, sc, DataType.FLOAT, GroupType.DATA)

        reset_launches()
        req = start()
        out = env.wait(req)
        torch.cuda.synchronize()
        n_launch = {k: v for k, v in launches().items() if v}
        check(req.algo == algo, f"alltoall {tag}: request selected {req.algo!r}, not {algo!r}")
        check(n_launch == want_launch[tag],
              f"alltoall {tag}: launches {n_launch}, expected {want_launch[tag]}")
        if algo == "lax":
            # member j holds chunk j of every member, in member order
            check(bool(torch.equal(out.view(WORLD, WORLD, sc),
                                   x.view(WORLD, WORLD, sc).transpose(0, 1))),
                  f"alltoall lax ({payload}): differs from the closed form")
            lax_out[payload] = out
        else:
            check(same_bits(torch, out, lax_out[payload]),
                  f"alltoall {tag} ({payload}): not bit-exact to lax")
        for k, v in n_launch.items():
            used[k] = used.get(k, 0) + v
        ms = time_ms(torch, lambda: env.wait(start()), reps=5, warmup=1)
        nbytes = n * 4
        lines.append(f"# algos alltoall {tag} ({payload} payload): {req.algo} alltoall, "
                     f"{nbytes} B per rank, float32: {ms:.4f} ms, algbw "
                     f"{nbytes / ms / 1e6:.2f} GB/s, launches {n_launch}")
        del out
    return used, lines


def moe_route_gap(torch, tfm, trainer, batch, a2a) -> dict:
    """One no-grad forward of the loss on the trainer's weights with the
    exchange forced to pallas_a2a (B6 int8 must launch once a block) and to
    lax, the config re-validated between them (tests/test_pallas_a2a.py:338-
    340). -> {spec: mean CE}; the two within 0.005 (the int8 round trip
    moves each combine output by at most amax/254 of its block; 0.00043
    measured on an H100)."""
    cfg = trainer.env.config
    losses = {}
    try:
        with torch.no_grad():
            for spec in ("alltoall=pallas_a2a", "alltoall=lax"):
                cfg.collective_algo = spec
                cfg.validate()
                before = dict(a2a.LAUNCHES)
                ce, _ = tfm.local_loss(trainer.params, *batch, trainer.cfg, trainer.sp,
                                       trainer.tp, comm=trainer._comm)
                torch.cuda.synchronize()
                ran = a2a.LAUNCHES["a2a_quant"] - before["a2a_quant"]
                a2a.LAUNCHES.update(before)     # a comparison, not the path's
                want = trainer.cfg.n_blocks if spec.endswith("pallas_a2a") else 0
                check(ran == want, f"transformer moe: {spec} forward launched B6 int8 {ran} "
                                   f"times, expected {want}")
                losses[spec] = float(ce[:, :, :, 0].sum() / trainer._norm)
    finally:
        cfg.collective_algo = "alltoall=pallas_a2a"
        cfg.validate()
    gap = abs(losses["alltoall=pallas_a2a"] - losses["alltoall=lax"])
    check(gap < 0.005, f"transformer moe: losses on the two routes differ by {gap:.4g}: {losses}")
    return losses


def a2a_entry(torch, a2a, *, tag, grid, axes, count, quantized, bw, f32, per_path, dev):
    """B6 at one exchange's shape: the world rows of ``grid`` = (D, M) over
    the group of ``axes``, ``count`` float32 a rank, int8 block 256 when
    ``quantized``. Bound: 4 bytes read and 4 written per element. Dense: one
    PyTorch call computes the same function on these member-ordered rows,
    the (C, G, G, chunk) transpose, timed as the library yardstick. The
    wrapper's result on random floats must equal the plain version's, bit
    for bit."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    d, m = grid
    group = ProcessGroup(Topology(d, m, d * m), axes)
    w, g = d * m, group.size
    p = a2a.plan(group, count, BLOCK, quantized)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = torch.randn((w, g * p.in_chunk), generator=gen, device=dev)
    before = dict(a2a.LAUNCHES)
    got, want = a2a.alltoall(x, p), a2a.alltoall_ref(x, p)
    torch.cuda.synchronize()
    check(same_bits(torch, got, want),
          f"a2a entry ({tag}, {'int8' if quantized else 'dense'}): differs from the plain "
          f"version")
    err = float((got - want).abs().max())
    del got, want
    ms = time_ms(torch, lambda: a2a.alltoall(x, p), reps=20)
    a2a.LAUNCHES.update(before)
    plain_ms = time_ms(torch, lambda: a2a.alltoall_ref(x, p), reps=5, warmup=1)
    elems = w * count
    if quantized:
        library_ms, note = None, "no single PyTorch call exchanges chunks through an int8 codec"
    else:
        rows = p.table(dev)
        check(bool(torch.equal(rows.flatten().cpu(), torch.arange(w, dtype=torch.int32))),
              "a2a entry: the yardstick needs member-ordered rows")
        c = w // g
        view = x.view(c, g, g, p.rc)
        check(bool(torch.equal(view.transpose(1, 2).reshape(w, count), a2a.alltoall_ref(x, p))),
              "a2a entry: the yardstick does not compute the exchange")
        library_ms = time_ms(torch, lambda: view.transpose(1, 2).contiguous(), reps=20)
        note = "x.view(C, G, G, chunk).transpose(1, 2).contiguous()"
    # the int8 codec per element: |x|, max, divide, round, clamp, multiply
    return entry(name=f"{'a2a_quant' if quantized else 'a2a_dense'} (B6, {tag})",
                 source=A2A_SRC, replaces=f"{A2A_PY}:250", launches=sum(per_path.values()),
                 per_path=per_path, shape=[w, count, g], err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, nbytes=8 * elems, ops=(6 if quantized else 0) * elems,
                 bw=bw, peak=f32, library_note=note)


def phase_transformer_moe(torch, np, tfm, a2a, get_env, launches, reset_launches):
    """gpt-medium-2k-moe8 at its 12 blocks under remat="full" on 8 ranks,
    dp=2 x sp=2 x tp=2 (ep = 2), zigzag, MLSL_ALGO=alltoall=pallas_a2a: three
    steps with their checks (a replayed block launches its forward kernels
    again), the peak under the card's memory, then the no-grad loss on both
    routes. -> (launches over the steps, the combine exchange's float32 count
    a rank)."""
    import dataclasses

    env = reinit(get_env, MLSL_ALGO="alltoall=pallas_a2a")
    held, kept = settle(torch)
    base = dataclasses.replace(tfm.GPT_MEDIUM_2K_MOE8, remat=True, remat_policy=MOE_REMAT)
    trainer, batch = build_transformer(torch, env, np, 2, 2, 2, "zigzag", base=base)
    check(not trainer.fused, "transformer moe: the step did not take the graph path")
    cfg_m = trainer.cfg
    moe_count = moe_combine_count(cfg_m, trainer.dp, trainer.sp, trainer.tp, trainer.batch)
    reset_launches()
    losses, secs, split, grads = phase_transformer(torch, trainer, batch)
    tm = launches()
    check_losses(losses, cfg_m.vocab, "transformer moe")
    n, steps, r = cfg_m.n_blocks, len(losses), replays(cfg_m)
    check(counts_are(tm, a2a_quant=r * n * steps, a2a_dense=n * steps,
                     quantize_blocks=r * n * steps,
                     **b9_counts(5 * n * steps, forward=r * 5 * n * steps), flash_fwd=0,
                     flash_bwd_dq=0, flash_bwd_dkv=0, **NO_SM90, dequantize_blocks=0,
                     dense_ring=0, quant_ring=0, rhd_allreduce=0),
          f"transformer moe: launches {tm}, expected per step {r * n} B6 int8, {n} B6 dense, "
          f"{r * n} B1, {r * 5 * n} B9 (wgmma) and {5 * n} of each of its backward passes, "
          f"and nothing else")
    worst_m = check_transformer_grads(torch, trainer, grads, "transformer moe")
    peak_m = torch.cuda.max_memory_allocated() / 2**30
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    check(peak_m < card_gib, f"transformer moe: peak {peak_m:.2f} GiB of {card_gib:.2f}")
    del grads
    route_losses = moe_route_gap(torch, tfm, trainer, batch, a2a)
    log(f"# phase transformer moe: ok, losses {losses}, launches {tm}, worst layer gradient "
        f"rel. error {worst_m:.4g}, peak memory {peak_m:.2f} GiB of {card_gib:.2f} (at the "
        f"start {kept:.2f} GiB, {held:.2f} GiB before the collector), combine exchange "
        f"{moe_count} float32 a rank, no-grad mean CE by route {json.dumps(route_losses)}")
    log(step_line(f"transformer moe 8 ranks (gpt-medium-2k-moe8, {n} blocks, remat "
                  f"{MOE_REMAT!r}, dp=2 x sp=2 x tp=2 = ep 2, zigzag, alltoall=pallas_a2a)",
                  trainer, losses, secs, split, tm))
    del trainer, batch
    return tm, moe_count


def phase_remat_twins(torch, np, tfm, get_env):
    """gpt-medium-2k-moe8 at REMAT_TWIN_BLOCKS blocks, run (d)'s grid and
    route: the gradient rows before sync of one batch, twice without remat,
    then under remat "full" and "dots", on the same weights. The losses bit
    for bit; each layer bit for bit where the two plain runs agree bit for
    bit, else within REMAT_TWIN_TOL. Comparisons: no launch counts. -> the
    report."""
    import dataclasses

    env = reinit(get_env, MLSL_ALGO="alltoall=pallas_a2a")
    settle(torch)
    base = dataclasses.replace(tfm.GPT_MEDIUM_2K_MOE8, n_blocks=REMAT_TWIN_BLOCKS)
    trainer, batch = build_transformer(torch, env, np, 2, 2, 2, "zigzag", base=base)
    plain_cfg = trainer.cfg

    def rows(**remat):
        trainer.cfg = dataclasses.replace(plain_cfg, **remat)
        torch.cuda.reset_peak_memory_stats()
        loss, flat = trainer._grad_fn(*batch)
        torch.cuda.synchronize()
        return loss, flat, torch.cuda.max_memory_allocated() / 2**30

    loss0, ref, peak0 = rows()
    loss1, again, _ = rows()
    check(bool(torch.equal(loss0, loss1)), "remat twins: two plain runs give other losses")
    fixed = {name: bool(torch.equal(ref[name], again[name])) for name in ref}
    del again
    report = {"blocks": REMAT_TWIN_BLOCKS, "plain_peak_gib": peak0,
              "layers_not_fixed": sorted(n for n, f in fixed.items() if not f)}
    for policy in ("full", "dots"):
        loss, got, peak = rows(remat=True, remat_policy=policy)
        check(bool(torch.equal(loss, loss0)), f"remat twins {policy}: the losses differ")
        worst, equal = 0.0, 0
        for name, row in got.items():
            if fixed[name]:
                check(bool(torch.equal(row, ref[name])),
                      f"remat twins {policy}: layer {name} differs from the plain run")
                equal += 1
            else:
                e = rel_err(torch, row, ref[name])
                check(e <= REMAT_TWIN_TOL, f"remat twins {policy}: layer {name} off by {e:.3g}")
                worst = max(worst, e)
        report[policy] = {"layers_bit_equal": equal, "layers": len(got),
                          "worst_rel_err_not_fixed": worst, "peak_gib": peak}
        del got
    trainer.cfg = plain_cfg
    del trainer, batch, ref
    return report


def phase_remat_a(torch, np, get_env, launches, reset_launches, plain):
    """Run (a) under remat "full" and "dots": gpt-medium-2k on 1 rank, batch
    8, three fused steps each as one CUDA graph, B7 recorded twice a block
    (the forward and its replay), B8's passes once; the first loss bit for
    bit the plain run's (the same forward on the same weights). ``plain``:
    run (a)'s losses, step seconds, peak GiB and step FLOPs, printed beside
    (the FLOP ratio is run (r)'s). -> {policy: launches}."""
    import dataclasses

    from mlsl_tpu_torch.ops import attention_kernels as ak

    out = {}
    for policy in ("full", "dots"):
        env = reinit(get_env, world=1)
        settle(torch)
        base = dataclasses.replace(gpt_medium(), remat=True, remat_policy=policy)
        trainer, batch = build_transformer(torch, env, np, 1, 1, 1, "ring", base=base)
        check(trainer.fused, f"transformer 1 rank remat {policy}: not the fused step")
        reset_launches()
        losses, secs, split, _ = phase_transformer(torch, trainer, batch)
        ta = {k: launches()[k] for k in ak.LAUNCHES}
        check_losses(losses, trainer.cfg.vocab, f"transformer 1 rank remat {policy}")
        check(losses[0] == plain["losses"][0],
              f"transformer 1 rank remat {policy}: first loss {losses[0]}, plain "
              f"{plain['losses'][0]}")
        compiled = trainer.compiled_step(*batch)
        rec = check_fused_launches(ta, trainer, compiled, f"transformer 1 rank remat {policy}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops = compiled.cost_analysis()["flops"]
        log(f"# phase transformer 1 rank remat {policy}: ok, losses {losses} (plain "
            f"{plain['losses']}), step seconds {secs} (plain {plain['secs']}), peak memory "
            f"{peak:.2f} GiB (plain {plain['peak']:.2f}), launches {ta} (recorded {rec}), "
            f"step FLOPs {flops:.6g}, {flops / plain['flops']:.4f} of the plain step's "
            f"(run (r))")
        log(step_line(f"transformer 1 rank remat {policy} (gpt-medium-2k, batch 8, fused "
                      f"step as one CUDA graph)", trainer, losses, secs, split, rec))
        out[policy] = ta
        del trainer, batch
    return out


# -- the C and C++ entry (run (o)) ----------------------------------------------

# the lines tests/test_c_api.py:32-41 asserts of test_c_api's output
TEST_C_API_LINES = ("C API TEST PASSED", "world = 8", "allreduce OK (36)",
                    "allgatherv/alltoallv OK", "alltoallv_full per-rank OK",
                    "activation fwd ReduceScatter OK", "activation bwd AllGather OK",
                    "distributed-update increment AllGather OK", "statistics queries OK")
# (program, arguments, MLSL_ALGO, lines its output must hold): the four
# unchanged programs against the port's library, compat_test over the
# reference matrix (group_count x dist_update, then use_test), and
# test_c_api again on halving/doubling and on the all-to-all kernel
CAPI_RUNS = (
    [("test_c_api", (), "pallas_ring", TEST_C_API_LINES),
     ("test_cpp_api", (), "pallas_ring", ("CPP API TEST PASSED",)),
     ("compat_example", (), "pallas_ring", ("compat example OK (world=8)",))]
    + [("compat_test", (str(g), str(du), "1", "0"), "pallas_ring",
        ("compat_test: PASSED", f"dist={WORLD // g}x{g}"))
       for g in (1, 2, 4) for du in (0, 1)]
    + [("compat_test", ("2", "1", "0", "1"), "pallas_ring", ("compat_test: PASSED",)),
       ("test_c_api", (), "pallas_rhd", TEST_C_API_LINES),
       ("test_c_api", (), "alltoall=pallas_a2a", TEST_C_API_LINES)])
CAPI_TIMEOUT = 240
# a program prints the port's kernel launches when it finalizes its
# Environment (the embedded interpreter imports this from the PYTHONPATH)
LAUNCH_REPORT = '''\
import json
from mlsl_tpu_torch import c_shim
from mlsl_tpu_torch.ops import a2a_kernels, quant_kernels, rhd_kernels, ring_kernels

_finalize = c_shim.env_finalize


def env_finalize():
    counts = {k: v for m in (quant_kernels, ring_kernels, rhd_kernels, a2a_kernels)
              for k, v in m.LAUNCHES.items() if v}
    print("# launches " + json.dumps(counts, sort_keys=True), flush=True)
    return _finalize()


c_shim.env_finalize = env_finalize
'''


class CapiPrograms:
    """Run (o1): every entry of CAPI_RUNS as a subprocess on the card, four
    at a time, started beside the phases that time nothing. ``kill`` stops
    the ones still running."""

    def __init__(self, paths, capi_build):
        site = capi_build.build_dir() / "launch_report"
        site.mkdir(exist_ok=True)
        (site / "sitecustomize.py").write_text(LAUNCH_REPORT)
        self.procs, self.stopped = [], False
        self._lock = threading.Lock()

        def run(prog, args, algo):
            env = capi_build.program_env(MLSL_ALGO=algo, MLSL_STATS="1")
            env["PYTHONPATH"] = os.pathsep.join([str(site), env["PYTHONPATH"]])
            for k in ("MLSL_TPU_PLATFORM", "MLSL_STATS_DIR"):
                env.pop(k, None)
            with self._lock:
                if self.stopped:
                    raise SmokeFailure("capi: stopped")
                proc = subprocess.Popen([paths[prog], *args], stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True, env=env, cwd=site)
                self.procs.append(proc)
            t0 = time.perf_counter()
            try:
                stdout, stderr = proc.communicate(timeout=CAPI_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            return proc.returncode, stdout, stderr, time.perf_counter() - t0

        pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
        self.futures = [pool.submit(run, prog, args, algo) for prog, args, algo, _ in CAPI_RUNS]
        pool.shutdown(wait=False)

    def kill(self):
        with self._lock:
            self.stopped = True
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()


def phase_capi_programs(runs: CapiPrograms) -> list:
    """Join run (o1): each program exits 0 and prints its lines; the
    halving/doubling and ring runs launched their kernels. -> one dict a
    run (program, arguments, MLSL_ALGO, seconds, launches)."""
    out = []
    for (prog, args, algo, lines), fut in zip(CAPI_RUNS, runs.futures):
        rc, stdout, stderr, secs = fut.result()
        tag = f"{prog} {' '.join(args)} (MLSL_ALGO={algo})".replace("  ", " ")
        check(rc == 0, f"capi {tag}: exit {rc}\nstdout:\n{stdout[-3000:]}\nstderr:\n"
                       f"{stderr[-3000:]}")
        missing = [ln for ln in lines if ln not in stdout]
        check(not missing, f"capi {tag}: output lacks {missing}:\n{stdout[-3000:]}")
        reports = [ln for ln in stdout.splitlines() if ln.startswith("# launches ")]
        check(len(reports) == 1, f"capi {tag}: {len(reports)} launch reports")
        used = json.loads(reports[0][len("# launches "):])
        want = {"pallas_ring": "dense_ring", "pallas_rhd": "rhd_allreduce"}.get(algo)
        check(want is None or used.get(want, 0) > 0,
              f"capi {tag}: {want} never launched ({used})")
        out.append({"program": prog, "args": list(args), "MLSL_ALGO": algo, "s": secs,
                    "launches": used})
    return out


def bind_capi(path):
    """The port's C library, loaded into this process with its prototypes
    (include/mlsl_tpu.h): its embedded-Python entry reuses this interpreter,
    so this process's launch counters see the C path."""
    import ctypes as C

    lib = C.CDLL(path)
    h, i64, vp, cp = C.c_uint64, C.c_int64, C.c_void_p, C.c_char_p
    protos = {
        "mlsl_environment_init": (C.c_int, []),
        "mlsl_environment_finalize": (C.c_int, []),
        "mlsl_environment_get_process_count": (i64, []),
        "mlsl_environment_create_distribution": (h, [i64, i64, i64]),
        "mlsl_environment_create_session": (h, []),
        "mlsl_environment_set_quantization_params": (C.c_int, [cp, cp, cp, cp, i64, i64]),
        "mlsl_distribution_all_reduce": (h, [h, vp, i64, C.c_int, C.c_int, C.c_int]),
        "mlsl_distribution_all_to_all": (h, [h, vp, i64, C.c_int, C.c_int]),
        "mlsl_request_wait": (C.c_int, [h, vp, i64, C.c_int]),
        "mlsl_session_set_global_minibatch_size": (C.c_int, [h, i64]),
        "mlsl_session_create_operation_reg_info": (h, [h, C.c_int]),
        "mlsl_operation_reg_info_add_input": (i64, [h, i64, i64, C.c_int]),
        "mlsl_operation_reg_info_add_output": (i64, [h, i64, i64, C.c_int]),
        "mlsl_operation_reg_info_add_parameter_set": (i64, [h, i64, i64, C.c_int, C.c_int,
                                                            C.c_int]),
        "mlsl_session_add_operation": (h, [h, h, h]),
        "mlsl_session_commit": (C.c_int, [h]),
        "mlsl_parameter_set_start_gradient_comm": (C.c_int, [h, i64, vp, C.c_int]),
        "mlsl_parameter_set_wait_gradient_comm": (i64, [h, i64, vp, C.c_int]),
        "mlsl_handle_release": (C.c_int, [h]),
        "mlsl_get_last_error": (cp, []),
    }
    for name, (res, args) in protos.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def c_status(lib, rc, what):
    """A C call's status must be MLSL_TPU_SUCCESS; else the MLSLError text."""
    if rc != 0:
        raise SmokeFailure(f"capi {what}: returned {rc}: {lib.mlsl_get_last_error().decode()}")


def c_handle(lib, hid, what):
    """A C call's handle must be non-zero; else the MLSLError text."""
    if not hid:
        raise SmokeFailure(f"capi {what}: no handle: {lib.mlsl_get_last_error().decode()}")
    return hid


# C enums (include/mlsl_tpu.h)
C_FLOAT, C_SUM, C_DATA, C_CC = 0, 0, 0, 0


def c_grad_ops(lib, dist_h, counts, compression):
    """A session of one CC operation a layer through the C calls, each with
    one parameter set of the layer's count. -> the operation handles."""
    sess = c_handle(lib, lib.mlsl_environment_create_session(), "create session")
    c_status(lib, lib.mlsl_session_set_global_minibatch_size(sess, 64), "minibatch")
    ops = []
    for n in counts:
        reg = c_handle(lib, lib.mlsl_session_create_operation_reg_info(sess, C_CC), "reg info")
        lib.mlsl_operation_reg_info_add_input(reg, 1, 1, C_FLOAT)
        lib.mlsl_operation_reg_info_add_output(reg, 1, 1, C_FLOAT)
        idx = lib.mlsl_operation_reg_info_add_parameter_set(reg, n, 1, C_FLOAT, 0,
                                                            int(compression))
        check(idx == 0, f"capi: add_parameter_set returned {idx}")
        ops.append(c_handle(lib, lib.mlsl_session_add_operation(sess, reg, dist_h),
                            "add operation"))
    c_status(lib, lib.mlsl_session_commit(sess), "commit")
    return ops


def py_grad_ops(env, dist, counts, compression):
    """The same session through the Python API. -> the parameter sets."""
    from mlsl_tpu_torch import DataType, OpType

    sess = env.create_session()
    sess.set_global_minibatch_size(64)
    sets = []
    for n in counts:
        reg = sess.create_operation_reg_info(OpType.CC)
        reg.add_input(1, 1)
        reg.add_output(1, 1)
        reg.add_parameter_set(n, 1, DataType.FLOAT, compression_type=compression)
        sets.append(sess.get_operation(sess.add_operation(reg, dist)))
    sess.commit()
    return [op.get_parameter_set(0) for op in sets]


def same_host_bits(np, a, b) -> bool:
    return a.shape == b.shape and bool(np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def capi_line(tag, nbytes_a_rank, rounds, secs, timings, py_secs, used):
    """One case's split: the C path's wall less its two copies is the
    collective as the C caller pays it; algbw is the payload a rank over it."""
    coll = secs - timings["h2d_s"] - timings["d2h_s"]
    return {"case": tag, "bytes_a_rank_a_round": nbytes_a_rank, "rounds": rounds,
            "c_wall_s": secs, "h2d_s": timings["h2d_s"], "d2h_s": timings["d2h_s"],
            "collective_s": coll, "algbw_GBps": nbytes_a_rank * rounds / coll / 1e9,
            "python_path_s": py_secs, "launches": used}


def run_capi_in_process(torch, np, get_env, launches, reset_launches, lib_path, counts, dev,
                        n=(256 << 20) // 4, n4=(64 << 20) // 4):
    """Run (o2): the port's C library loaded into this process; three cases
    driven from numpy host buffers through the C calls and again through the
    Python API on the same buffers, held bit for bit, with the same launches:
    (1) BASELINE's message, an 8 x 256 MiB float32 allreduce SUM on B3; (2)
    config 4, 64 MiB a rank int8 (set through
    mlsl_environment_set_quantization_params(NULL, ..., 256, 256)) over 2
    rounds on B1 + B4; (3) config 5's per-layer graph, ResNet-50's 18 layer
    counts int8, 3 iterations of gradient Start/Wait; and (4) an all-to-all
    of 64 MiB a rank on B6 (int8). MLSL_ALGO=SPEC_RING. -> (one dict a case,
    the launches of the C path)."""
    from mlsl_tpu_torch import CompressionType, DataType, GroupType, ReductionType, c_shim

    get_env().finalize()
    for k in ALGO_VARS:
        os.environ.pop(k, None)
    os.environ["MLSL_ALGO"] = SPEC_RING
    lib = bind_capi(lib_path)
    c_status(lib, lib.mlsl_environment_init(), "init")
    env = get_env()
    check(env.device.type == dev.type and lib.mlsl_environment_get_process_count() == WORLD,
          f"capi: the C entry's Environment is on {env.device} with "
          f"{env.get_process_count()} ranks")
    dist_h = c_handle(lib, lib.mlsl_environment_create_distribution(WORLD, 1, 1), "dist")
    dist = env.create_distribution(WORLD, 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    lines, c_used = [], {}

    def host(c):
        return torch.randn((WORLD, c), generator=gen, device=dev).cpu().numpy()

    def tally(used):
        for k, v in used.items():
            c_used[k] = c_used.get(k, 0) + v

    def collective(tag, kind, c, x, start_c, start_py, want_algo, want_kernel):
        """One Distribution collective through the C calls and through the
        Python API on the same host buffer."""
        out = np.empty_like(x)
        reset_launches()
        c_shim.reset_timings()
        t0 = time.perf_counter()
        req = c_handle(lib, start_c(x), kind)
        c_status(lib, lib.mlsl_request_wait(req, out.ctypes.data, c, C_FLOAT), f"{kind} wait")
        secs, timings, used = time.perf_counter() - t0, dict(c_shim.TIMINGS), launches()
        tally(used)
        buf = torch.from_numpy(x).reshape(*dist.world_shape, c).to(dev)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        py_req = start_py(buf)
        res = env.wait(py_req)
        torch.cuda.synchronize()
        py_secs, py_used = time.perf_counter() - t0, launches()
        check(py_req.algo == want_algo, f"capi {kind}: selected {py_req.algo!r}")
        check(same_host_bits(np, out, res.reshape(WORLD, c).cpu().numpy()),
              f"capi {kind}: the C path's result differs from the Python path's")
        check(used == py_used and used[want_kernel] > 0,
              f"capi {kind}: launches {used}, the Python path's {py_used}")
        lines.append(capi_line(tag, c * 4, 1, secs, timings, py_secs,
                               {k: v for k, v in used.items() if v}))

    # (1) the allreduce
    collective(f"allreduce 8 x {n * 4 / 2**20:g} MiB float32 (B3)", "allreduce", n, host(n),
               lambda x: lib.mlsl_distribution_all_reduce(dist_h, x.ctypes.data, n, C_FLOAT,
                                                          C_SUM, C_DATA),
               lambda b: dist.all_reduce(b, n, DataType.FLOAT, ReductionType.SUM,
                                         GroupType.DATA),
               "pallas_ring", "dense_ring")

    # (2) and (3): int8 gradient requests through sessions
    c_status(lib, lib.mlsl_environment_set_quantization_params(None, None, None, None, 256,
                                                               256), "quantization params")
    check(env.config.quant_block_elems == 256, "capi: the codec block is not 256")
    for tag, layer_counts, rounds in (
            (f"config 4: {n4 * 4 / 2**20:g} MiB a rank int8 (B1 + B4)", [n4], 2),
            (f"config 5: ResNet-50's {len(counts)} layers int8 (B1 + B4)", list(counts), 3)):
        xs = [host(c) for c in layer_counts]
        c_ops = c_grad_ops(lib, dist_h, layer_counts, CompressionType.QUANTIZATION)
        outs = [[np.empty_like(x) for x in xs] for _ in range(rounds)]
        reset_launches()
        c_shim.reset_timings()
        t0 = time.perf_counter()
        for r in range(rounds):
            for op, x in reversed(list(zip(c_ops, xs))):
                c_status(lib, lib.mlsl_parameter_set_start_gradient_comm(
                    op, 0, x.ctypes.data, C_FLOAT), "start gradient comm")
            for op, o, c in zip(c_ops, outs[r], layer_counts):
                got = lib.mlsl_parameter_set_wait_gradient_comm(op, 0, o.ctypes.data, C_FLOAT)
                check(got == c, f"capi {tag}: wait wrote {got} of {c} a rank: "
                                f"{lib.mlsl_get_last_error().decode()}")
        secs, timings, used = time.perf_counter() - t0, dict(c_shim.TIMINGS), launches()
        tally(used)
        sets = py_grad_ops(env, dist, layer_counts, CompressionType.QUANTIZATION)
        bufs = [torch.from_numpy(x).reshape(*dist.world_shape, x.shape[1]).to(dev)
                for x in xs]
        reset_launches()
        torch.cuda.synchronize()
        py_secs, worst = 0.0, 0
        for r in range(rounds):
            t0 = time.perf_counter()
            for ps, b in reversed(list(zip(sets, bufs))):
                ps.start_gradient_comm(b)
            res = [ps.wait_gradient_comm() for ps in sets]
            torch.cuda.synchronize()
            py_secs += time.perf_counter() - t0
            for ps, rr, o, c in zip(sets, res, outs[r], layer_counts):
                check(ps.grad_req.algo == "pallas_ring",
                      f"capi {tag}: selected {ps.grad_req.algo!r}")
                check(same_host_bits(np, o, rr.reshape(WORLD, -1)[:, :c].cpu().numpy()),
                      f"capi {tag} round {r}: the C path's result differs from the Python "
                      f"path's")
        py_used = launches()
        want = len(layer_counts) * rounds
        check(used == py_used and used["quant_ring"] == want
              and used["quantize_blocks"] == want,
              f"capi {tag}: launches {used}, the Python path's {py_used}, expected {want} "
              f"B4 and {want} B1")
        lines.append(capi_line(tag, 4 * sum(layer_counts), rounds, secs, timings, py_secs,
                               {k: v for k, v in used.items() if v}))
        del xs, outs, bufs, res, sets

    # (4) the all-to-all: member j receives chunk j of every member
    collective(f"alltoall 8 x {n4 * 4 / 2**20:g} MiB float32 (B6 int8)", "alltoall", n4,
               host(n4),
               lambda x: lib.mlsl_distribution_all_to_all(dist_h, x.ctypes.data, n4, C_FLOAT,
                                                          C_DATA),
               lambda b: dist.all_to_all(b, n4 // WORLD, DataType.FLOAT, GroupType.DATA),
               "pallas_a2a", "a2a_quant")
    c_status(lib, lib.mlsl_environment_finalize(), "finalize")
    os.environ.pop("MLSL_ALGO", None)
    return lines, c_used


# -- main -----------------------------------------------------------------


# -- the card's own tests -----------------------------------------------------


CARD_TESTS = "mlsl_tpu_torch/cuda_tests"


def start_card_tests() -> subprocess.Popen:
    """Start the jax-free kernel-against-plain tests in a subprocess; they
    run beside the phases that time nothing (parity, configs 1-4)."""
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--tb=short",
           CARD_TESTS]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def phase_card_tests(proc: subprocess.Popen, timeout=600) -> str:
    """Wait for the card tests; every test must pass and none skip. A failed
    test is run once more on its own and its outcome added to the report, to
    tell a fault that repeats from one that does not; the phase fails either
    way. -> pytest's summary line."""
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--tb=short"]
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"card tests: not done in {timeout} s")
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    summary = lines[-1] if lines else ""
    if proc.returncode != 0:
        failed = [ln.split()[1] for ln in lines if ln.startswith("FAILED ")]
        again = []
        for node in failed[:4]:
            rerun = subprocess.run(cmd + [node], cwd=ROOT, capture_output=True, text=True,
                                   timeout=timeout)
            tail = [ln for ln in rerun.stdout.strip().splitlines() if ln.strip()][-1:]
            again.append(f"  {node} alone: rc {rerun.returncode}, {' '.join(tail)}")
        raise SmokeFailure(f"card tests: rc {proc.returncode}:\n" + "\n".join(lines[-40:]) +
                           stderr[-4000:] + "\nrun again:\n" + "\n".join(again))
    check(" passed" in summary and "skipped" not in summary and "failed" not in summary,
          f"card tests: {summary!r}")
    return summary


# -- ZeRO-1: the distributed update on ResNet-50, and the staged update ----------

ZERO1_LR = 1e-3
ZERO1_CLIP = 1.0
ZERO1_MICRO = 2
ZERO1_BATCH = 64


def build_zero1_resnet(torch, env, np, *, distributed_update, image=224, classes=1000,
                       batch=ZERO1_BATCH, micro=ZERO1_MICRO, optimizer=None):
    """ResNet-50 (seed 0) on WORLD data ranks with Adam (or ``optimizer``)
    and global-norm clipping; ``micro`` batches of ``batch`` images each
    (seed 0 + 20) for step_accum. -> (trainer, batches)."""
    from mlsl_tpu_torch import optim
    from mlsl_tpu_torch.models import resnet
    from mlsl_tpu_torch.models.train import DataParallelTrainer

    gen = torch.Generator().manual_seed(SEED)
    model = resnet.ResNet50(num_classes=classes, generator=gen, device=env.device)
    dist = env.create_distribution(WORLD, 1)
    sess = env.create_session()
    sess.set_global_minibatch_size(batch)
    trainer = DataParallelTrainer(
        env, dist, sess, model, resnet.loss_fn, resnet.layer_names(model),
        resnet.layer_subtree, distributed_update=distributed_update,
        optimizer=optimizer if optimizer is not None else optim.adam(ZERO1_LR),
        clip_global_norm=ZERO1_CLIP,
    )
    rng = np.random.default_rng(SEED + 20)
    batches = []
    for _ in range(micro):
        x = rng.normal(size=(batch, image, image, 3)).astype(np.float32)
        y = rng.integers(0, classes, size=(batch,)).astype(np.int32)
        batches.append(trainer.shard_batch(x, y))
    return trainer, batches


def rows_identical(torch, buf) -> bool:
    """Every rank row of a distributed buffer holds the same bits."""
    rows = buf.reshape(-1, buf.shape[-1]).contiguous().view(torch.int32)
    return bool((rows == rows[:1]).all())


def phase_zero1_resnet(torch, trainer, batches, launches, reset_launches, steps=3):
    """``steps`` step_accum steps over the micro-batches. Under ZeRO-1, after
    every step every rank's gathered increment (what each replica adds to its
    parameters) must be bitwise the same. -> (mean losses, step seconds,
    launches of the run)."""
    losses, secs = [], []
    reset_launches()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step_accum(batches)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(loss).all()), f"zero1 resnet step {i}: losses {loss}")
        losses.append(float(loss.mean()))
        if trainer.distributed_update:
            for name in trainer.layers:
                inc = trainer.ops[name].get_parameter_set(0).inc_req._result
                check(rows_identical(torch, inc),
                      f"zero1 resnet step {i}: ranks disagree on layer {name}")
    used = launches()
    return losses, secs, used


def layer_vectors(torch, trainer):
    """-> {layer: its parameters as one flat float32 copy}."""
    return {n: torch.cat([p.detach().reshape(-1) for p in trainer.layer_params[n]]).clone()
            for n in trainer.layers}


def zero1_state_bytes(trainer) -> dict:
    """Adam state bytes a rank holds: its owned shards' moments under ZeRO-1
    against a replicated state of every layer's full count. Checks the owned
    state's width per layer."""
    owned = full = 0
    for name in trainer.layers:
        ps = trainer.ops[name].get_parameter_set(0)
        st = trainer.opt_state[name]
        check(tuple(st.mu.shape) == (*trainer.dist.topology.grid_shape,
                                     ps.get_owned_kernel_count()),
              f"zero1 resnet: layer {name} Adam state {tuple(st.mu.shape)}, owned "
              f"{ps.get_owned_kernel_count()}")
        owned += 2 * 4 * ps.get_owned_kernel_count() + 4
        full += 2 * 4 * trainer.layer_counts[name] + 4
    return {"zero1_per_rank_bytes": owned, "replicated_per_rank_bytes": full}


def phase_zero1_staged(torch, counts, dev, launches, reset_launches):
    """``build_zero1_update`` over ResNet-50's layer counts: pallas_ring on
    the data group of an (8, 1) world at stages 1 and 3, pallas_ring2d on the
    global group of a (4, 2) world. Integer inputs (lr 0.5, denom 8) are
    bit-exact against p - lr * sum(g) / denom on every rank, random float32
    inputs against the same build_zero1_update on the plain versions. Each call
    launches B3 (reduce_scatter) and B3-AG once a layer. -> (lines, launches
    summed over the counted calls)."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
    from mlsl_tpu_torch.comm.overlap import build_zero1_update

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    n = len(counts)
    lines, used = [], {}
    for (d, m, axes, algo, stages_list) in ((WORLD, 1, ("data",), "pallas_ring", (1, 3)),
                                            (4, 2, ("data", "model"), "pallas_ring2d", (2,))):
        topo = Topology(d, m, WORLD)
        group = ProcessGroup(topo, axes)
        grid = topo.grid_shape
        for stages in stages_list:
            tag = f"{algo} on {axes} of {grid}, stages {stages}"
            fn, units = build_zero1_update(group, counts, lr=0.5, denom=8.0, algo=algo,
                                           stages=stages)
            check([u.algo for u in units] == [algo] * n, f"zero1 staged {tag}: units "
                                                          f"{[u.algo for u in units]}")
            p = [torch.randint(-40, 40, (c,), generator=gen, device=dev).float()
                 .expand(*grid, c).contiguous() for c in counts]
            g = [torch.randint(-8, 8, (*grid, c), generator=gen, device=dev).float()
                 for c in counts]
            torch.cuda.synchronize()
            reset_launches()
            outs = fn(p, g)
            torch.cuda.synchronize()
            c = launches()
            check(counts_are(c, dense_ring=n, dense_ring_gather=n),
                  f"zero1 staged {tag}: launches {c}, expected {n} B3 and {n} B3-AG")
            for k, v in c.items():
                used[k] = used.get(k, 0) + v
            for name, pi, gi, o in zip(counts, p, g, outs):
                want = pi - 0.5 * (gi.reshape(WORLD, -1).sum(0) / 8.0)
                check(bool((o == want).all()), f"zero1 staged {tag}: a layer of {name} "
                                                f"elements differs from the closed form")
            del p, g, outs
            pf = [torch.randn((*grid, c), generator=gen, device=dev) for c in counts]
            gf = [torch.randn((*grid, c), generator=gen, device=dev) for c in counts]
            plain_fn, _ = build_zero1_update(group, counts, lr=0.5, denom=8.0, algo=algo,
                                             stages=stages, plain=True)
            ko, po = fn(pf, gf), plain_fn(pf, gf)
            torch.cuda.synchronize()
            for a, b in zip(ko, po):
                check(same_bits(torch, a, b),
                      f"zero1 staged {tag}: the kernels' result differs from the plain one")
            ms = time_ms(torch, lambda: fn(pf, gf), reps=5, warmup=1)
            plain_ms = time_ms(torch, lambda: plain_fn(pf, gf), reps=2, warmup=1)
            lines.append(f"# zero1 staged {tag}: {n} layers, {sum(counts)} parameters, "
                         f"{ms:.4f} ms a call, plain {plain_ms:.4f} ms, launches {c}")
            del pf, gf, ko, po
    return lines, used


def ring_gather_entry(torch, rk, shard, tag, bw, f32, per_path, dev):
    """B3-AG on WORLD ranks: every rank's (shard,) row to every rank."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    group = ProcessGroup(Topology(WORLD, 1, WORLD), ("data",))
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    x = torch.randn((WORLD, shard), generator=gen, device=dev)
    plan = rk.dense_plan("all_gather", group, shard, bidir=False)
    before = dict(rk.LAUNCHES)
    got, want = rk.dense_ring(x, plan), rk.dense_ring_ref(x, plan)
    check(same_bits(torch, got, want), f"dense_ring_gather ({tag}) differs from its plain "
                                       f"version")
    err = float((got - want).abs().max())
    ms = time_ms(torch, lambda: rk.dense_ring(x, plan), reps=20)
    rk.LAUNCHES.update(before)
    plain_ms = time_ms(torch, lambda: rk.dense_ring_ref(x, plan), reps=5, warmup=1)
    library_ms = time_ms(torch, lambda: x.reshape(1, 1, WORLD * shard).expand(
        1, WORLD, WORLD * shard).contiguous(), reps=20)
    return entry(name=f"dense_ring_gather ({tag})", source="mlsl_tpu_torch/csrc/ring_kernels.cu",
                 replaces="mlsl_tpu/ops/ring_kernels.py:698", launches=sum(per_path.values()),
                 per_path=per_path, shape=[WORLD, shard], err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, nbytes=(WORLD + WORLD * WORLD) * shard * 4, ops=0,
                 bw=bw, peak=f32,
                 library_note="rows.reshape(C, 1, G*rc).expand(C, G, G*rc).contiguous()")


def run_zero1(torch, np, get_env, launches, reset_launches, dev, layer_counts, image=224,
              classes=1000):
    """Phases 18 and 19: ResNet-50 with ZeRO-1 Adam (B3 reduce_scatter), the
    same steps with replicated Adam (B3 allreduce), then the staged update
    (B3 and B3-AG) over ``layer_counts``. -> the three runs' launches."""
    # cuDNN's deterministic convolutions: both training runs see the same
    # gradients, so they differ only in the update
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    env = reinit(get_env, MLSL_ALGO="reduce_scatter=pallas_ring")
    trainer, batches = build_zero1_resnet(torch, env, np, distributed_update=True, image=image,
                                          classes=classes)
    check(all(_grad_req(trainer, n).algo == "pallas_ring" for n in trainer.layers),
          "zero1 resnet: a layer's reduce_scatter did not select pallas_ring")
    state_bytes = zero1_state_bytes(trainer)
    z_losses, z_secs, zr = phase_zero1_resnet(torch, trainer, batches, launches,
                                              reset_launches)
    n_layers, steps = len(trainer.layers), len(z_losses)
    check(counts_are(zr, dense_ring=n_layers * steps, dense_ring_gather=0),
          f"zero1 resnet: launches {zr}, expected {n_layers} B3 a step and no B3-AG "
          f"(the increment all-gather is lax)")
    z_params = layer_vectors(torch, trainer)
    del trainer, batches
    torch.cuda.empty_cache()
    env = reinit(get_env, MLSL_ALGO="allreduce=pallas_ring")
    trainer, batches = build_zero1_resnet(torch, env, np, distributed_update=False,
                                          image=image, classes=classes)
    r_losses, r_secs, rr = phase_zero1_resnet(torch, trainer, batches, launches,
                                              reset_launches)
    check(counts_are(rr, dense_ring=n_layers * steps),
          f"replicated adam resnet: launches {rr}, expected {n_layers} B3 a step")
    r_params = layer_vectors(torch, trainer)
    worst = 0.0
    for name in trainer.layers:
        rel = rel_err(torch, z_params[name], r_params[name])
        worst = max(worst, rel)
        check(rel < 1e-5, f"zero1 resnet: layer {name} parameters {rel:.3g} from the "
                          f"replicated Adam run")
    del trainer, batches, z_params, r_params
    torch.backends.cudnn.deterministic = False
    log(f"# phase zero1 resnet: ok, losses {z_losses}, replicated {r_losses}, launches "
        f"{zr} / {rr}, worst layer parameter rel. error against replicated Adam "
        f"{worst:.4g}, Adam state {json.dumps(state_bytes)}")
    images = ZERO1_MICRO * ZERO1_BATCH
    log(f"# zero1 resnet train step (host clock, synchronized, step_accum of {ZERO1_MICRO} "
        f"micro-batches of {ZERO1_BATCH}): " + json.dumps({
            "zero1": {"step_s": z_secs, "images_per_s": [images / x for x in z_secs]},
            "replicated": {"step_s": r_secs, "images_per_s": [images / x for x in r_secs]}}))
    reinit(get_env)
    torch.cuda.empty_cache()
    lines, zs = phase_zero1_staged(torch, layer_counts, dev, launches, reset_launches)
    for line in lines:
        log(line)
    log(f"# phase zero1 staged: ok, launches {zs}")
    torch.cuda.empty_cache()
    return zr, rr, zs


# -- ShardedAdafactor under ZeRO-1 and the owned-state reshard (run s) ---------

#: the reference's defaults (mlsl_tpu/optim.py:103-127) at learning rate 1e-3
AF_LR = 1e-3
#: parameters after 3 steps against the replicated twin: the reference
#: test's bound (tests/test_optimizers.py:423)
AF_ATOL, AF_RTOL = 2e-5, 2e-4


def tensor_bytes(state, ranks: int) -> int:
    """Bytes a rank holds of an optimizer state: a ZeRO-1 dict of (R, D, S,
    M, n) buffers counts one rank's row of each, a replicated state every
    tensor."""
    import torch

    if isinstance(state, dict):
        return sum(t.numel() * t.element_size() for t in state.values()) // ranks
    leaves = [t for part in state for t in (part if isinstance(part, list) else [part])
              if torch.is_tensor(t)]
    return sum(t.numel() * t.element_size() for t in leaves)


def run_adafactor(torch, np, get_env, launches, reset_launches, dev, steps=3, image=224,
                  classes=1000):
    """Run (s): config 5's ResNet-50 (224^2, batch 64 on WORLD ranks) with
    ShardedAdafactor (the reference's defaults, lr 1e-3) and global-norm
    clipping, under the distributed update with the gradient reduce_scatter
    on pallas_ring (B3), beside its replicated Adafactor twin (allreduce on
    B3), cuDNN's deterministic convolutions in both: after each of ``steps``
    steps the parameters within AF_ATOL / AF_RTOL of the twin's. Free-running
    twins cannot be held to that bound: this model at this learning rate
    turns a 1e-8 parameter difference into 2.6e-3 in one step (ROADMAP C.11),
    and the two forms sum their statistics in different orders. So the twin
    takes the ZeRO-1 run's parameters after each comparison, and each step
    starts both from the same weights (so the same gradient bits) with the
    optimizer states they built on their own. Then the fc layer's owned
    elementwise moment drains to the host (``gather_owned_full``, B3-AG) and
    lands on a 4-rank world (``place_owned_vector``), bit for bit against
    the host arrays, and drains back from there. -> (the report, the ZeRO-1
    run's launches with the reshard's, the twin's launches)."""
    from mlsl_tpu_torch import optim
    from mlsl_tpu_torch.comm.mesh import Topology

    cfg = optim.ShardedAdafactor(learning_rate=AF_LR)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    env = reinit(get_env, MLSL_ALGO="allreduce=pallas_ring,reduce_scatter=pallas_ring")
    settle(torch)
    tags = {True: "adafactor zero1", False: "adafactor replicated"}
    trainers, runs = {}, {}
    for du, tag in tags.items():
        trainer, batches = build_zero1_resnet(torch, env, np, distributed_update=du,
                                              image=image, classes=classes, micro=1,
                                              optimizer=cfg)
        check(all(_grad_req(trainer, n).algo == "pallas_ring" for n in trainer.layers),
              f"{tag}: a layer's gradient request did not select pallas_ring")
        trainers[du] = (trainer, batches[0])
        runs[tag] = {"losses": [], "step_s": [], "launches": {}}
    z, r = trainers[True][0], trainers[False][0]
    gaps = []
    for i in range(steps):
        for du, tag in tags.items():
            trainer, batch = trainers[du]
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.step(batch)
            torch.cuda.synchronize()
            runs[tag]["step_s"].append(time.perf_counter() - t0)
            check(bool(torch.isfinite(loss).all()), f"{tag} step {i}: losses {loss}")
            runs[tag]["losses"].append(float(loss.mean()))
            for k, v in launches().items():
                runs[tag]["launches"][k] = runs[tag]["launches"].get(k, 0) + v
        worst = 0.0
        with torch.no_grad():
            for name in r.layers:
                for got, want in zip(z.layer_params[name], r.layer_params[name]):
                    excess = float(((got - want).abs() - AF_RTOL * want.abs()).max())
                    check(excess <= AF_ATOL,
                          f"adafactor zero1 step {i}: layer {name} parameters beyond atol "
                          f"{AF_ATOL:g} + rtol {AF_RTOL:g} of the replicated twin's "
                          f"({excess:.3g})")
                    worst = max(worst, float((got - want).abs().max()))
                    want.copy_(got)
        gaps.append(worst)
    n_layers = len(r.layers)
    for tag, run in runs.items():
        check(counts_are(run["launches"], dense_ring=n_layers * steps, dense_ring_gather=0),
              f"{tag}: launches {run['launches']}, expected {n_layers} B3 a step")
        run["images_per_s"] = [ZERO1_BATCH / x for x in run["step_s"]]
    for du, tag in tags.items():
        trainer = trainers[du][0]
        runs[tag]["state_bytes_a_rank"] = sum(tensor_bytes(trainer.opt_state[n], WORLD)
                                              for n in trainer.layers)
    v = z.opt_state["fc"]["v"]
    ps = z.ops["fc"].get_parameter_set(0)
    check(tuple(v.shape) == (1, WORLD, 1, 1, ps.get_owned_kernel_count()),
          f"adafactor zero1: fc's elementwise moment {tuple(v.shape)} is not its owned shard")
    host = v.cpu().numpy().reshape(-1)
    reset_launches()
    full = optim.gather_owned_full(z.dist.topology, v)
    count = z.layer_counts["fc"]
    padded = -(-count // 4) * 4
    new_topo = Topology(4, 1, 4)
    placed = optim.place_owned_vector(new_topo, full, count, padded, 4, device=dev)
    want = np.pad(host[:count], (0, padded - count))
    back = optim.gather_owned_full(new_topo, placed)
    torch.cuda.synchronize()
    reshard = launches()
    check(np.array_equal(full.view(np.int32), host.view(np.int32)),
          "adafactor reshard: the drained vector differs from the owned shards")
    check(np.array_equal(placed.cpu().numpy().reshape(-1).view(np.int32), want.view(np.int32)),
          "adafactor reshard: the 4-rank placement differs from the host arrays")
    check(np.array_equal(back.view(np.int32), want.view(np.int32)),
          "adafactor reshard: the 4-rank world drains to another vector")
    check(counts_are(reshard, dense_ring_gather=2, dense_ring=0),
          f"adafactor reshard: launches {reshard}, expected 2 B3-AG")
    report = {"step_param_abs_gaps": gaps, **runs,
              "reshard": {"layer": "fc", "count": count, "owned_8": int(v.shape[-1]),
                          "owned_4": int(placed.shape[-1]), "launches": {
                              k: c for k, c in reshard.items() if c}},
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.backends.cudnn.deterministic = False
    zl = runs[tags[True]]["launches"]
    zl = {k: c + reshard.get(k, 0) for k, c in zl.items()}
    rl = runs[tags[False]]["launches"]
    del trainers, z, r, v, placed
    reinit(get_env)
    settle(torch)
    return report, zl, rl


# -- ZeRO-1 and Adam on the transformer; gradient buckets (runs f and g) ------

#: MLSL_GRAD_BUCKET_MB of both runs: PyTorch DDP's documented default bucket_cap_mb
BUCKET_MB = 25
#: Adam's first steps move every weight by ~lr whatever its gradient's size
#: (bias correction, no warmup here): at 1e-3 gpt-medium-2k's third loss rose
#: above its first (10.60, 10.29, 10.70 on the card), at 1e-4 the three fall
TFM_ADAM_LR = 1e-4
#: run (f): each layer's change from the shared initial weights against the
#: replicated Adam run's change, relative L2, after the first step and after
#: the third. The first step starts both runs from the same weights and data,
#: so the two differ only in each gradient element's summation order (B3's
#: snake ring, whose chunk index for an element moves with its offset in the
#: bucket, against lax's one-pass sum), ~1e-7 relative, except where that
#: order flips the sign of a sum that nearly cancels: Adam's first step moves
#: such an element by +lr instead of -lr. The next steps run the bf16 forward
#: on weights that differ in their last bits, which turns into bf16-step
#: differences of the gradients. On the H100 (two runs, the same readings)
#: the worst layer read 9.327e-06 after step 1 and 7.256e-03 after step 3;
#: the planted faults printed beside them (a layer that skipped its updates
#: after the first step, a first-step update that lost one owner's shard)
#: read 0.6016 and 0.4997 at their smallest over the layers. The tolerances
#: sit 100x and 7x above the readings and 500x and 12x below the faults.
TFM_ZERO1_TOL_STEP1 = 1e-3
TFM_ZERO1_TOL_STEP3 = 5e-2
#: run (g)'s mean loss a step against the unbucketed fused ring's, relative:
#: the first step's loss comes before any update; the next ones see weights
#: whose int8 rounding moved with the bucket's block boundaries, each
#: gradient element off by up to 9 half-steps of its block's amax/127 on
#: either side, times lr 0.05.
BUCKET_LOSS_TOL = 0.02


def bucket_plan(trainer, attr):
    """-> (the buckets of one phase, the communicating sets left out of
    them) of a trainer's parameter sets; ``attr`` is 'bucket' (gradient) or
    'inc_bucket' (ZeRO-1 increment)."""
    pss = [trainer.ops[n].get_parameter_set(0) for n in trainer.layers]
    pss = [ps for ps in pss if ps.need_comm]
    buckets = {id(getattr(ps, attr)): getattr(ps, attr) for ps in pss
               if getattr(ps, attr) is not None}
    return list(buckets.values()), [ps for ps in pss if getattr(ps, attr) is None]


def layer_rows(torch, trainer, name):
    """A transformer layer's leaves as one (R, D, S, M, local) tensor."""
    return torch.cat([p.detach().reshape(*trainer.grid, -1) for p in trainer._leaves[name]],
                     dim=-1)


def grad_group_identical(torch, trainer) -> bool:
    """Every member of each data x seq group holds the same parameter bits."""
    from mlsl_tpu_torch.comm.collectives import group_view

    for name in trainer.layers:
        rows = group_view(layer_rows(torch, trainer, name), trainer.dist.grad_group)
        rows = rows.contiguous().view(torch.int32)
        if not bool((rows == rows[:, :1]).all()):
            return False
    return True


def model_rows(torch, trainer) -> dict:
    """{layer: its (model ranks, local) parameters of data x seq position 0},
    on the host: the other members of a gradient group hold the same bits."""
    return {name: layer_rows(torch, trainer, name)[0, 0, 0].cpu() for name in trainer.layers}


def tfm_state_bytes(trainer) -> int:
    """Adam state bytes one rank holds: its row of every layer's two moments
    and the layer's step count."""
    world = trainer.dist.topology.world_size
    return sum((st.mu.numel() + st.nu.numel()) * 4 // world + 4
               for st in trainer.opt_state.values())


def check_bucket_plain(torch, algos, trainer, grads, buckets, alone, tag):
    """The last step's reduce_scatters against B3's plain version on the same
    plan: each gradient bucket's result on its packed input, and each layer
    left out of a bucket on its own gradient, bit for bit. -> the count."""
    by_layer = {id(trainer.ops[x].get_parameter_set(0)): x for x in trainer.layers}
    for b in buckets:
        packed = b._pack([grads[by_layer[id(ps)]] for ps in b.members])
        check(same_bits(torch, b.req._result, plain_result(torch, algos, b.req, packed)),
              f"{tag}: bucket {b.req.name} differs from B3's plain version")
    for ps in alone:
        check(same_bits(torch, ps.grad_req._result,
                        plain_result(torch, algos, ps.grad_req, grads[by_layer[id(ps)]])),
              f"{tag}: layer {by_layer[id(ps)]} differs from B3's plain version")
    return len(buckets) + len(alone)


def change_errors(torch, dev, p0, z, r, step1=None):
    """Each layer's change z - p0 against r - p0, relative L2, computed on
    ``dev``. With ``step1`` = (z1, r1), the first step's parameters, also the
    readings of two planted faults: the layer skipped its updates after the
    first step (z1 against r), and the first step's update lost its first
    owner's shard (z1 with the first quarter of each row's change zeroed,
    against r1). -> ({layer: error}, {fault: smallest reading over the
    layers})."""
    errs, faults = {}, {"skipped later updates": 1.0, "lost first shard": 1.0}
    for name in p0:
        base = p0[name].to(dev)
        want = r[name].to(dev) - base
        errs[name] = rel_err(torch, z[name].to(dev) - base, want)
        if step1 is not None:
            z1, r1 = step1[0][name].to(dev) - base, step1[1][name].to(dev) - base
            faults["skipped later updates"] = min(faults["skipped later updates"],
                                                  rel_err(torch, z1, want))
            lost = z1.clone()
            lost[..., :-(-lost.shape[-1] // 4)] = 0
            faults["lost first shard"] = min(faults["lost first shard"],
                                             rel_err(torch, lost, r1))
    return errs, faults


def run_transformer_zero1(torch, np, get_env, launches, reset_launches):
    """Run (f): gpt-medium-2k on (b)'s grid with Adam under ZeRO-1, its
    requests in 25 MiB buckets and the reduce_scatters on B3 over the snake
    cycle of the data x seq group; then the same weights and data with
    replicated Adam, unbucketed. The last step's reduce_scatters are held to
    B3's plain version bit for bit, and each layer's change after the first
    and the third step to the replicated run's. -> (launches of both runs)."""
    from mlsl_tpu_torch import optim
    from mlsl_tpu_torch.comm import algos
    from mlsl_tpu_torch.core import stats

    env = reinit(get_env, MLSL_ALGO="reduce_scatter=pallas_ring2d",
                 MLSL_GRAD_BUCKET_MB=str(BUCKET_MB))
    settle(torch)
    trainer, batch = build_transformer(torch, env, np, 2, 2, 2, "zigzag",
                                       distributed_update=True,
                                       optimizer=optim.adam(TFM_ADAM_LR))
    tag = "zero1 transformer"
    n_layers = len(trainer.layers)
    check(not trainer.fused and n_layers == 3 * trainer.cfg.n_blocks + 2,
          f"{tag}: {n_layers} layers, fused {trainer.fused}")
    grad_b, grad_alone = bucket_plan(trainer, "bucket")
    inc_b, inc_alone = bucket_plan(trainer, "inc_bucket")
    n_rs, n_ag = len(grad_b) + len(grad_alone), len(inc_b) + len(inc_alone)
    check(grad_b and inc_b, f"{tag}: no bucket formed")
    check(all(b.kind == "reduce_scatter" and b.req.algo == "pallas_ring2d" for b in grad_b)
          and all(ps.grad_req.algo == "pallas_ring2d" for ps in grad_alone),
          f"{tag}: a reduce_scatter did not select pallas_ring2d")
    for name in trainer.layers:
        ps = trainer.ops[name].get_parameter_set(0)
        check(tuple(trainer.opt_state[name].mu.shape) == (*trainer.grid,
                                                          ps.get_owned_kernel_count()),
              f"{tag}: layer {name} Adam state {tuple(trainer.opt_state[name].mu.shape)}")
    z_bytes = tfm_state_bytes(trainer)
    p0 = model_rows(torch, trainer)
    stats.reset_bucket_counters()
    reset_launches()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    z_losses, z_secs, _, grads = phase_transformer(torch, trainer, batch, steps=1)
    del grads
    z1 = model_rows(torch, trainer)
    losses, secs, z_split, grads = phase_transformer(torch, trainer, batch, steps=2)
    z_losses, z_secs = z_losses + losses, z_secs + secs
    zl = launches()
    n_plain = check_bucket_plain(torch, algos, trainer, grads, grad_b, grad_alone, tag)
    del grads
    z_peak = torch.cuda.max_memory_allocated() / 2**30
    # the allocator's cudaFree-and-retry rounds, each a device synchronize
    z_retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    rounds = dict(stats.BUCKET_COUNTERS)
    n, steps = trainer.cfg.n_blocks, len(z_losses)
    check_losses(z_losses, trainer.cfg.vocab, tag)
    check(counts_are(zl, dense_ring=n_rs * steps, dense_ring_gather=0,
                     **b9_counts(5 * n * steps), flash_fwd=0, **NO_SM90),
          f"{tag}: launches {zl}, expected {n_rs} B3 (one a reduce_scatter request), no "
          f"B3-AG and {5 * n} B9 and of each of its backward passes a step")
    check(rounds["rounds_dispatched"] == (len(grad_b) + len(inc_b)) * steps
          and rounds["rounds_fallback"] == 0 and rounds["member_abandons"] == 0,
          f"{tag}: bucket rounds {rounds}, expected {len(grad_b) + len(inc_b)} "
          f"dispatched a step and no fallback")
    check(grad_group_identical(torch, trainer),
          f"{tag}: the ranks of a data x seq group disagree on a parameter")
    z3 = model_rows(torch, trainer)
    z_line = step_line(f"{tag} (gpt-medium-2k, dp=2 x sp=2 x tp=2, zigzag, Adam, ZeRO-1, "
                       f"{BUCKET_MB} MiB buckets)", trainer, z_losses, z_secs, z_split, zl)
    del trainer, batch
    env = reinit(get_env)
    settle(torch)
    trainer, batch = build_transformer(torch, env, np, 2, 2, 2, "zigzag",
                                       optimizer=optim.adam(TFM_ADAM_LR))
    check(all(ps.bucket is None for ps in (trainer.ops[x].get_parameter_set(0)
                                           for x in trainer.layers)),
          "replicated adam transformer: a bucket formed")
    check(all(same_bits(torch, a, p0[k]) for k, a in model_rows(torch, trainer).items()),
          "replicated adam transformer: the initial weights differ from the ZeRO-1 run's")
    r_bytes = tfm_state_bytes(trainer)
    reset_launches()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    r_losses, r_secs, _, grads = phase_transformer(torch, trainer, batch, steps=1)
    del grads
    r1 = model_rows(torch, trainer)
    losses, secs, r_split, grads = phase_transformer(torch, trainer, batch, steps=2)
    r_losses, r_secs = r_losses + losses, r_secs + secs
    del grads
    rl = launches()
    r_peak = torch.cuda.max_memory_allocated() / 2**30
    r_retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    check_losses(r_losses, trainer.cfg.vocab, "replicated adam transformer")
    check(counts_are(rl, dense_ring=0, **b9_counts(5 * n * steps)),
          f"replicated adam transformer: launches {rl}")
    r3 = model_rows(torch, trainer)
    check(z_bytes * 3.5 < r_bytes < z_bytes * 4.5,
          f"{tag}: Adam state {z_bytes} B a rank against {r_bytes} B replicated")
    r_line = step_line("replicated adam transformer (gpt-medium-2k, dp=2 x sp=2 x tp=2, "
                       "zigzag, Adam, unbucketed)", trainer, r_losses, r_secs, r_split, rl)
    dev = env.device
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    e1, _ = change_errors(torch, dev, p0, z1, r1)
    e3, faults = change_errors(torch, dev, p0, z3, r3, step1=(z1, r1))
    del p0, z1, z3, r1, r3
    worst1, worst3 = max(e1, key=e1.get), max(e3, key=e3.get)
    check(faults["skipped later updates"] > TFM_ZERO1_TOL_STEP3
          and faults["lost first shard"] > TFM_ZERO1_TOL_STEP1,
          f"{tag}: a planted fault reads {faults}, inside its tolerance")
    for name in e1:
        check(e1[name] < TFM_ZERO1_TOL_STEP1 and e3[name] < TFM_ZERO1_TOL_STEP3,
              f"{tag}: layer {name}'s change {e1[name]:.3g} (step 1), {e3[name]:.3g} "
              f"(step 3) from the replicated Adam run's")
    log(f"# phase zero1 transformer: ok, losses {z_losses}, replicated {r_losses}, "
        f"{n_plain} reduce_scatters of the last step bit-exact against B3's plain version, "
        f"each layer's change against replicated Adam's: worst {e1[worst1]:.4g} after step "
        f"1 ({worst1}, tolerance {TFM_ZERO1_TOL_STEP1}), {e3[worst3]:.4g} after step 3 "
        f"({worst3}, tolerance {TFM_ZERO1_TOL_STEP3}), planted faults "
        f"{json.dumps({k: float(f'{v:.4g}') for k, v in faults.items()})}, Adam state a "
        f"rank {z_bytes} B (ZeRO-1) / {r_bytes} B (replicated) = {z_bytes / r_bytes:.4f}, "
        f"buckets {len(grad_b)} gradient + {len(inc_b)} increment, requests a step {n_rs} "
        f"reduce_scatter + {n_ag} all_gather (unbucketed: {n_layers} + {n_layers}), bucket "
        f"rounds {json.dumps(rounds)}, launches {zl} / {rl}, peak memory {z_peak:.2f} / "
        f"{r_peak:.2f} GiB, allocator retries {z_retries} / {r_retries}")
    log(f"# zero1 transformer change errors a layer (step 1, step 3): "
        + json.dumps({k: [float(f"{e1[k]:.4g}"), float(f"{e3[k]:.4g}")] for k in e1}))
    log(z_line)
    log(r_line)
    return zl, rl


def phase_lax_buckets(torch, get_env, n=(256 << 20) // 4) -> str:
    """``lax``'s SUM on the card: a gradient bucket's results equal its
    members' own requests bit for bit on random floats (each element summed
    in one order wherever it sits in the payload), for both gradient kinds
    (allreduce, ZeRO-1's reduce_scatter) on groups of 8 and 4. Also times
    the one-pass sum the card runs against the member loop the CPU runs, on
    the algos phase's 256 MiB a rank, and says whether the two agree bit for
    bit. -> a note for the phase line."""
    from mlsl_tpu_torch import DataType, OpType, ReductionType
    from mlsl_tpu_torch.comm import collectives

    counts = [64 * 8, 301 * 8, 1000, 77, (1 << 20) + 24]
    env = reinit(get_env, MLSL_ALGO="lax")
    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    cases = 0
    for dp, tp in ((WORLD, 1), (4, 2)):
        for du in (False, True):
            tag = f"lax buckets dp={dp} tp={tp} {'zero1' if du else 'allreduce'}"
            sides = []
            for mb in (64, 0):
                env.config.grad_bucket_mb = mb
                try:
                    dist = env.create_distribution(dp, tp)
                    session = env.create_session()
                    session.set_global_minibatch_size(WORLD)
                    pss = []
                    for c in counts:
                        reg = session.create_operation_reg_info(OpType.CC)
                        reg.add_input(WORLD, 4)
                        reg.add_output(WORLD, 4)
                        reg.add_parameter_set(c * tp, 1, DataType.FLOAT, distributed_update=du)
                        op = session.get_operation(session.add_operation(reg, dist))
                        pss.append(op.get_parameter_set(0))
                    session.commit()
                finally:
                    env.config.grad_bucket_mb = 0
                sides.append(pss)
            bucketed, alone = sides
            check(bucketed[0].bucket is not None
                  and len({id(ps.bucket) for ps in bucketed}) == 1
                  and all(ps.bucket is None for ps in alone), f"{tag}: not one bucket")
            bufs = [torch.randn((*dist.world_shape, ps.get_local_kernel_count()),
                                generator=gen, device=dev) for ps in bucketed]
            outs = []
            for pss in sides:
                for ps, b in zip(reversed(pss), reversed(bufs)):
                    ps.start_gradient_comm(b.clone())
                outs.append([ps.wait_gradient_comm() for ps in pss])
            check(all(ps._bucket_round for ps in bucketed), f"{tag}: a round fell back")
            check(all(same_bits(torch, a, b) for a, b in zip(*outs)),
                  f"{tag}: a member's bucket result differs from its own request")
            cases += 1
            del bufs, outs, sides, bucketed, alone
    y = torch.randn((1, WORLD, n), generator=gen, device=dev)
    member_order = {}
    for g in (2, 4, WORLD):
        v = y.view(WORLD // g, g, n)
        member_order[g] = same_bits(torch, collectives._reduce(v, ReductionType.SUM),
                                    collectives._ordered_sum(v))
    one_ms = time_ms(torch, lambda: collectives._reduce(y, ReductionType.SUM), reps=10)
    loop_ms = time_ms(torch, lambda: collectives._ordered_sum(y), reps=10)
    del y
    return (f"{cases} cases of buckets bit-exact against their members' own requests; the "
            f"SUM over (1, 8, {n}) float32: one pass {one_ms:.4f} ms, member loop "
            f"{loop_ms:.4f} ms; one pass bit-exact with the member loop at G=2, 4, 8: "
            f"{[member_order[g] for g in (2, 4, WORLD)]}")


def run_config5_buckets(torch, np, get_env, launches, reset_launches, fused):
    """Run (g): config 5 on the fused int8 ring (MLSL_ALGO=pallas_ring) with
    the layer requests in 25 MiB buckets, three steps. The last step's
    bucket results and residuals bit-exact against the plain B1 + B4 on the
    same packed gradients and residuals; losses beside the unbucketed fused
    run's (``fused``: its mean losses, step seconds and launches). -> the
    run's launches."""
    from mlsl_tpu_torch import CompressionType
    from mlsl_tpu_torch.comm import quant_ring
    from mlsl_tpu_torch.core import stats

    env = reinit(get_env, MLSL_ALGO="pallas_ring", MLSL_GRAD_BUCKET_MB=str(BUCKET_MB))
    trainer, batch = build_resnet_trainer(torch, env, np)
    tag = "config5 buckets"
    n_layers = len(trainer.layers)
    buckets, alone = bucket_plan(trainer, "bucket")
    n_req = len(buckets) + len(alone)
    check(buckets and all(b.compression == CompressionType.QUANTIZATION
                          and b.req.algo == "pallas_ring" for b in buckets)
          and all(ps.grad_req.algo == "pallas_ring" for ps in alone),
          f"{tag}: a request did not take the fused int8 ring")
    stats.reset_bucket_counters()
    reset_launches()
    losses, secs = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < 2:
            loss = trainer.step(batch)
        else:
            # the last step as its halves, so that each bucket's packed input
            # and residual stay at hand
            trainer._step_no += 1
            loss, grads = trainer._local_grads(batch)
            errs = [b.req._errs[0].clone() for b in buckets]
            loss = trainer._sync_and_update(grads, loss)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(loss).all()), f"{tag} step {i}: losses {loss}")
        losses.append(float(loss.mean()))
    used = launches()
    rounds = dict(stats.BUCKET_COUNTERS)
    steps = len(losses)
    check(counts_are(used, quant_ring=n_req * steps, quantize_blocks=n_req * steps),
          f"{tag}: launches {used}, expected {n_req} B4 and {n_req} B1 a step")
    check(rounds["rounds_dispatched"] == len(buckets) * steps
          and rounds["rounds_fallback"] == 0 and rounds["member_abandons"] == 0,
          f"{tag}: bucket rounds {rounds}")
    block = env.config.quant_block_elems
    by_layer = {id(trainer.ops[x].get_parameter_set(0)): x for x in trainer.layers}
    for b, err in zip(buckets, errs):
        packed = b._pack([grads[by_layer[id(ps)]] for ps in b.members])
        fn, _ = quant_ring.build_quantized_collective("allreduce", b.req.desc.group, b.total,
                                                      block, ring="pallas", plain=True)
        res, new_err = fn(packed, err)
        check(same_bits(torch, res, b.req._result) and same_bits(torch, new_err, b.req._errs[0]),
              f"{tag}: bucket {b.req.name} differs from the plain B1 + B4")
        rows = b.req._result.reshape(WORLD, -1)
        check(bool((rows == rows[:1]).all()), f"{tag}: ranks disagree on {b.req.name}")
    for p in trainer._all_params():
        check(bool(torch.isfinite(p).all()), f"{tag}: a parameter is not finite")
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, fused["losses"])]
    check(max(gaps) < BUCKET_LOSS_TOL, f"{tag}: mean losses {losses} against the "
                                       f"unbucketed fused ring's {fused['losses']}")
    del trainer, batch, grads, errs
    gc.collect()     # the trainers' sessions hold their buffers in reference cycles
    torch.cuda.empty_cache()
    log(f"# phase config3 buckets: ok, {len(buckets)} buckets of "
        f"{[len(b.members) for b in buckets]} layers + {len(alone)} layers alone, requests "
        f"a step {n_req} (unbucketed: {n_layers}), launches {used} (unbucketed fused run: quant_ring {fused['launches']['quant_ring']}, "
        f"quantize_blocks {fused['launches']['quantize_blocks']}), bucket rounds "
        f"{json.dumps(rounds)}, mean losses {losses} against {fused['losses']} (relative "
        f"gaps {[float(f'{g:.3g}') for g in gaps]}, tolerance {BUCKET_LOSS_TOL}), results "
        f"bit-exact against the plain B1 + B4")
    log(f"# config5 bucketed fused-ring train step (host clock, synchronized): "
        + json.dumps({"step_s": secs, "unbucketed_step_s": fused["secs"]}))
    return used


# -- the compiled overlap engine and overlap_updates (runs h-l) -------------------

#: the twins' tolerances, the JAX package's (tests/test_overlap_compiled.py:77-81):
#: losses relative, parameters absolute
TWIN_LOSS_RTOL = 1e-6
TWIN_PARAM_ATOL = 1e-6


def drive_steps(torch, trainer, batch, steps=3):
    """-> (each step's per-rank losses, each step's seconds, synchronized)."""
    losses, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.detach().reshape(-1).cpu())
    return losses, secs


def twin_gaps(torch, losses, ref_losses, params, ref_params, tag) -> tuple:
    """The largest relative loss gap and absolute parameter gap between two
    runs from the same initial state, held to the twin tolerances."""
    for loss in losses + ref_losses:
        check(loss.shape == (WORLD,) and bool(torch.isfinite(loss).all()),
              f"{tag}: losses {loss.tolist()}")
    loss_gap = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(losses, ref_losses))
    param_gap = max(float((params[n] - ref_params[n]).abs().max()) for n in params)
    check(loss_gap <= TWIN_LOSS_RTOL and param_gap <= TWIN_PARAM_ATOL,
          f"{tag}: loss gap {loss_gap:.3g} (rtol {TWIN_LOSS_RTOL}), parameter gap "
          f"{param_gap:.3g} (atol {TWIN_PARAM_ATOL}) against the host path")
    return loss_gap, param_gap


def host_reference(torch, trainer, losses, secs) -> dict:
    """A host-path run's results kept for the overlap twins (runs h-k):
    its per-step losses, step seconds and final parameters."""
    return {"losses": losses, "secs": secs, "params": layer_vectors(torch, trainer)}


def twin_run(torch, np, get_env, launches, reset_launches, tag, env_vars, compression, kw,
             ref, expect):
    """Config 5 with trainer options ``kw``, three steps, against ``ref``: the
    host path's run from the same initial state (``host_reference``), or,
    where ``ref`` is a dict of trainer options, that run made here; both
    with cuDNN's deterministic convolutions, so that they see the same
    gradients. With the compiled engine the step is captured first
    (``precompile``) and ``expect(launches of one captured step, plan)``
    must hold; otherwise ``expect(launches, None)``. -> (the run's launches,
    its summary, its own results as a host reference)."""
    t0 = time.perf_counter()
    env = reinit(get_env, **env_vars)
    settle(torch)
    trainer, batch = build_resnet_trainer(torch, env, np, compression=compression, **kw)
    engine = trainer._overlap
    out = {"tag": tag}
    reset_launches()
    if kw.get("overlap_compiled"):
        check(engine is not None, f"{tag}: the compiled overlap engine did not engage")
        t1 = time.perf_counter()
        trainer.precompile(batch)
        torch.cuda.synchronize()
        out["precompile_s"] = time.perf_counter() - t1
        out["capture_s"] = engine.capture_s["step"]
        one = engine.capture_launches["step"]
        out["launches_one_captured_step"] = one
        check(expect(one, engine.plan), f"{tag}: launches of one captured step {one}")
    losses, secs = drive_steps(torch, trainer, batch)
    used = launches()
    if engine is not None:
        check(list(engine.graphs) == ["step"], f"{tag}: graphs {list(engine.graphs)}")
        out["units"] = len(engine.plan.units)
        out["plan_algos"] = engine.plan.algos_summary()
        out["describe"] = engine.plan.describe()
    else:
        check(expect(used, None), f"{tag}: launches {used}")
    mine = host_reference(torch, trainer, losses, secs)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del trainer, batch, engine
    if "params" not in ref:
        settle(torch)
        host, batch = build_resnet_trainer(torch, env, np, compression=compression, **ref)
        ref = host_reference(torch, host, *drive_steps(torch, host, batch))
        del host, batch
    out["loss_gap"], out["param_gap"] = twin_gaps(torch, losses, ref["losses"],
                                                  mine["params"], ref["params"], tag)
    out["losses"] = [float(v.mean()) for v in losses]
    out["ref_losses"] = [float(v.mean()) for v in ref["losses"]]
    out["step_s"], out["ref_step_s"] = secs, ref["secs"]
    out["images_per_s"] = [64 / x for x in secs]
    out["ref_images_per_s"] = [64 / x for x in ref["secs"]]
    out["launches"] = used
    settle(torch)
    out["run_s"] = time.perf_counter() - t0
    return used, out, mine


def run_engines(torch, np, get_env, launches, reset_launches, composed, fused):
    """Runs (h) to (k), with cuDNN's deterministic convolutions: config 5 on
    the compiled overlap engine -- int8 on the composed ring (B1) against
    the host path's run ``composed`` (run 7), int8 on the fused ring (B1 +
    B4) against ``fused`` (run 11), uncompressed 25 MiB buckets on B3
    against a bucketed host run made here -- and overlap_updates against
    ``composed``, the barrier path. -> {run: its launches}."""
    from mlsl_tpu_torch import CompressionType

    n = 18                                       # ResNet-50's layers
    eng = dict(overlap_compiled=True)
    runs = [
        ("engine int8", {}, None, eng, composed,
         lambda c, p: counts_are(c, quantize_blocks=(WORLD + 1) * n, quant_ring=0,
                                 dense_ring=0) and p.quant_units == n),
        ("engine fused ring", {"MLSL_ALGO": "pallas_ring"}, None, eng, fused,
         lambda c, p: counts_are(c, quantize_blocks=n, quant_ring=n, dense_ring=0)
         and {u.algo for u in p.units} == {"pallas_ring"}),
        ("engine buckets", {"MLSL_ALGO": "pallas_ring", "MLSL_GRAD_BUCKET_MB": str(BUCKET_MB)},
         CompressionType.NONE, eng, {},
         lambda c, p: counts_are(c, dense_ring=len(p.units), quantize_blocks=0, quant_ring=0)
         and len(p.units) < n and {u.algo for u in p.units} == {"pallas_ring"}),
        ("overlap_updates", {}, None, dict(overlap_updates=True), composed,
         lambda c, _: counts_are(c, quantize_blocks=(WORLD + 1) * n * 3, quant_ring=0)),
    ]
    used = {}
    for tag, env_vars, comp, kw, ref, expect in runs:
        used[tag], out, _ = twin_run(torch, np, get_env, launches, reset_launches, tag,
                                     env_vars, comp, kw, ref, expect)
        describe = out.pop("describe", None)
        log(f"# phase {tag}: ok, {json.dumps(out)}")
        if describe and tag == "engine buckets":
            for line in describe:
                log(f"#   unit: {line}")
    return used


def capture_call(torch, fn, *args):
    """-> (graph, outputs) of ``fn(*args)`` captured after one eager call."""
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    return graph, out


def run_multi_reduce(torch, launches, reset_launches, counts, dev):
    """Run (l): build_multi_reduce over ``counts`` (ResNet-50's 18 layer
    counts) on 8 ranks for pallas_ring, pallas_rhd, lax and rhd on
    integer-valued payloads, and int8 on the composed ring (B1) and on the
    fused ring (B1 + B4) over 3 rounds: each captured as one CUDA graph,
    replayed, and bit-exact against the same plan on the plain versions run
    eagerly, results and residuals. -> (lines, launches of the captured
    calls)."""
    from mlsl_tpu_torch.comm import overlap
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
    from mlsl_tpu_torch.config import Config
    from mlsl_tpu_torch.types import CompressionType

    group = ProcessGroup(Topology(WORLD, 1, WORLD), ("data",))
    grid = group.topology.grid_shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)   # the payloads, made on the card

    def payload(shape, quant, scale=1.0):
        if quant:
            return torch.randn(shape, generator=gen, device=dev) * scale
        return torch.randint(-40, 40, shape, generator=gen, device=dev).float()

    lines, used = [], {}
    cases = [(a, CompressionType.NONE, "") for a in ("pallas_ring", "pallas_rhd", "lax", "rhd")]
    cases += [("quant_ring", CompressionType.QUANTIZATION, ""),
              ("pallas_ring", CompressionType.QUANTIZATION, "pallas_ring")]
    for algo, comp, forced in cases:
        cfg = Config()
        cfg.collective_algo = forced
        cfg.validate()
        quant = comp == CompressionType.QUANTIZATION
        kw = dict(compression=comp, config=cfg, algo=None if quant else algo)
        fn, plan = overlap.build_multi_reduce(group, counts, **kw)
        ref, _ = overlap.build_multi_reduce(group, counts, plain=True, **kw)
        check({u.algo for u in plan.units} == {algo},
              f"multi reduce {algo}: units took {plan.algos_summary()}")
        bufs = [payload((*grid, c), quant) for c in counts]
        res = overlap.zero_residuals(plan, group.topology, dev)
        args = (bufs, res) if quant else (bufs,)
        reset_launches()
        graph, got = capture_call(torch, fn, *args)
        n_launch = {k: v for k, v in launches().items() if v}
        outs, new_res = got if quant else (got, {})
        ref_res = {k: v.clone() for k, v in res.items()}
        for r in range(3 if quant else 1):
            for b in bufs:
                b.copy_(payload(b.shape, quant, r + 1))
            graph.replay()
            want = ref(bufs, ref_res) if quant else ref(bufs)
            want, ref_res = want if quant else (want, {})
            torch.cuda.synchronize()
            bad = sum(int((o != w).sum()) for o, w in zip(outs, want))
            bad += sum(int((new_res[k] != ref_res[k]).sum()) for k in new_res)
            check(bad == 0, f"multi reduce {algo} round {r}: {bad} elements of the replayed "
                            f"graph differ from the plain versions")
            for k in res:
                res[k].copy_(new_res[k])
        for k, v in n_launch.items():
            used[k] = used.get(k, 0) + v
        eager_ms = time_ms(torch, lambda: fn(*args), reps=10, warmup=2)
        graph_ms = time_ms(torch, graph.replay, reps=10, warmup=2)
        del graph, got, outs, new_res, bufs, res, ref_res, want
        lines.append(f"# multi reduce {algo}{' int8' if quant else ''}: {len(plan.units)} "
                     f"units, {plan.rounds} phases, launches of the warm-up and the capture "
                     f"{n_launch}, eager {eager_ms:.4f} ms, replayed {graph_ms:.4f} ms a call, "
                     f"bit-exact over {3 if quant else 1} rounds")
        torch.cuda.empty_cache()
    return lines, used


# -- the model-parallel graph (run (m)) and the eleven collectives (run (n)) ---------

# run (m): tests/test_e2e_graph.py's graph (two CC ops, FM1 -> FM2 -> FM1) at
# gpt-medium-2k's MLP widths, d_model 1,024 and d_ff 4,096
# (benchmarks/transformer_bench.py:106-108), fm_size 1, one token a minibatch
# sample: batch 8 x seq 2,048 = 16,384 tokens, float32, on 8 virtual ranks
MLP_FM1, MLP_FM2 = 1024, 4096
MLP_TOKENS = 8 * 2048
# the engine's kernels for the graph's requests: B3 for every reduce_scatter,
# B3 or B5 for the allreduces, B6 (dense) for the alltoalls
SPEC_RING = "allreduce=pallas_ring,reduce_scatter=pallas_ring,alltoall=pallas_a2a"
SPEC_RHD = "allreduce=pallas_rhd,reduce_scatter=pallas_ring,alltoall=pallas_a2a"
SUM_RTOL = 1e-6          # float32 sums against the float64 sum of the members
INT8_REL = 0.02          # int8 gradient sums, relative L2 (tests/test_e2e_graph.py)
MLP_ITERS = 2            # the reference loop's iterations (test_full_reference_loop)
# run (n): 16 MiB a rank on a (4, 2) grid
COLL_N = (16 << 20) // 4


def fill(torch, topo, n, scale, dev, dtype=None):
    """The closed-form fills of the JAX tests: rank p holds scale * (p * 1000
    + i), as a (R, D, S, M, n) buffer."""
    p = torch.arange(topo.world_size, device=dev, dtype=torch.float32).view(-1, 1)
    x = (p * 1000.0 + torch.arange(n, device=dev, dtype=torch.float32)) * scale
    if dtype is not None:
        x = x.to(dtype)
    return x.reshape(*topo.grid_shape, n)


def members_of(topo, p, axes):
    """World ranks of p's group over ``axes``, in member order, from the rank
    formula alone (the oracle does not use the port's group tables)."""
    from mlsl_tpu_torch.comm.mesh import GRID_AXES

    keep = [i for i, a in enumerate(GRID_AXES) if a not in axes]
    idx = [GRID_AXES.index(a) for a in axes]
    cp = topo.coords(p)
    qs = [q for q in range(topo.world_size) if all(topo.coords(q)[i] == cp[i] for i in keep)]
    return sorted(qs, key=lambda q: [topo.coords(q)[i] for i in idx])


def group_members(group, p):
    """p's members for an axis or color group (colors: world-rank order)."""
    if group.colors is not None:
        return [q for q in range(len(group.colors)) if group.colors[q] == group.colors[p]]
    return members_of(group.topology, p, group.axes)


def check_request(torch, req, x, out, tag, quant=False, errs=None):
    """One round of a graph request held to its closed form (float64 sums
    within SUM_RTOL, int8 sums within INT8_REL, concatenations and alltoall
    moves bit for bit) and to the plain version of the same plan, bit for
    bit (with the residuals ``errs`` it started from, for int8). -> the
    round's new residuals of the plain twin (int8) or None."""
    d = req.desc
    group = d.group
    topo = group.topology
    xw = x.reshape(topo.world_size, -1)
    ow = out.reshape(topo.world_size, -1)
    worst = 0.0
    for p in range(topo.world_size):
        mem = group_members(group, p)
        my = mem.index(p)
        if d.kind in ("allreduce", "reduce_scatter"):
            exact = sum(xw[q].double() for q in mem)
            if d.kind == "reduce_scatter":
                exact = exact[my * d.recv_count:(my + 1) * d.recv_count]
            if quant:
                rel = float((ow[p].double() - exact).norm() / exact.norm())
                check(rel < INT8_REL, f"{tag}: rank {p} int8 sum {rel:.3g} off")
            else:
                rel = float(((ow[p].double() - exact).abs()
                             / exact.abs().clamp_min(1e-30)).max())
                check(rel <= SUM_RTOL, f"{tag}: rank {p} sum {rel:.3g} off the float64 sum")
            worst = max(worst, rel)
        elif d.kind == "allgather":
            check(same_bits(torch, ow[p], torch.cat([xw[q] for q in mem])),
                  f"{tag}: rank {p} is not its members' concatenation")
        elif d.kind == "alltoall":
            blk = d.count
            check(same_bits(torch, ow[p], torch.cat([xw[q, my * blk:(my + 1) * blk]
                                                     for q in mem])),
                  f"{tag}: rank {p} did not receive its block of every member")
    twin, new_errs = req.plain_result(x, errs)
    check(same_bits(torch, out, twin), f"{tag}: the {req.algo} round differs from the plain "
                                       f"version of the same plan")
    if quant:
        for mine, want in zip(req._errs, new_errs):
            check(same_bits(torch, mine, want), f"{tag}: residuals differ from the plain "
                                                f"version's")
    return worst


def time_request(torch, req, buf, launches_mods):
    """ms of one Start + Wait round of ``req`` on ``buf``, CUDA events over
    5 rounds; the timing's launches are not the path's."""
    before = [dict(m.LAUNCHES) for m in launches_mods]

    def round_():
        req.start(buf)
        req.wait()

    ms = time_ms(torch, round_, reps=5, warmup=1)
    for m, b in zip(launches_mods, before):
        m.LAUNCHES.update(b)
    return ms


def mlp_net(env, dist_a, dist_b=None, edge_fm=None, out_type=None, du=False, quant=False):
    """(session, op1, op2): with ``dist_b`` None tests/test_e2e_graph.py's
    _build_net (two CC ops with parameter sets), else its _build_edge: op1
    on ``dist_a`` with an ``edge_fm`` output of ``out_type`` into an ACT op
    on ``dist_b``."""
    from mlsl_tpu_torch import CompressionType, OpType

    comp = CompressionType.QUANTIZATION if quant else CompressionType.NONE
    s = env.create_session()
    s.set_global_minibatch_size(MLP_TOKENS)
    r1 = s.create_operation_reg_info(out_type if dist_b is not None else OpType.CC)
    r1.add_input(MLP_FM1, 1)
    r1.add_output(edge_fm or MLP_FM2, 1)
    if dist_b is None:
        r1.add_parameter_set(MLP_FM1 * MLP_FM2, 1, distributed_update=du,
                             compression_type=comp)
    op1 = s.get_operation(s.add_operation(r1, dist_a))
    r2 = s.create_operation_reg_info(OpType.CC if dist_b is None else OpType.ACT)
    r2.add_input(edge_fm or MLP_FM2, 1)
    r2.add_output(MLP_FM1 if dist_b is None else edge_fm, 1)
    if dist_b is None:
        r2.add_parameter_set(MLP_FM2 * MLP_FM1, 1, distributed_update=du,
                             compression_type=comp)
    op2 = s.get_operation(s.add_operation(r2, dist_b or dist_a))
    op1.set_next(op2, 0, 0)
    s.commit()
    return s, op1, op2


def mlp_round(torch, act, peer, buf, tag, worst, quant=False):
    """Start ``act``'s request on ``buf``, wait through its peer, check."""
    errs = ([e.clone() for e in act.comm_req._errs] if quant and act.comm_req._errs
            else None)
    act.start_comm(buf)
    out = peer.wait_comm()
    torch.cuda.synchronize()
    worst[tag] = max(worst.get(tag, 0.0), check_request(torch, act.comm_req, buf, out, tag,
                                                        quant, errs))
    return out


def grad_round(torch, ps, buf, tag, worst, quant=False, inc=False):
    req = ps.inc_req if inc else ps.grad_req
    errs = [e.clone() for e in req._errs] if quant and req._errs else None
    if inc:
        ps.start_increment_comm(buf)
        out = ps.wait_increment_comm()
    else:
        ps.start_gradient_comm(buf)
        out = ps.wait_gradient_comm()
    torch.cuda.synchronize()
    worst[tag] = max(worst.get(tag, 0.0), check_request(torch, req, buf, out, tag, quant,
                                                        errs))
    return out


def mlp_loop(torch, env, ops, dev, checked=True, iters=MLP_ITERS):
    """The reference loop of test_full_reference_loop (mlsl_test.cpp:660-698)
    on the case-1 graph: Forward (pack, start FPROP), Wait, Backward1 (start
    BPROP, wait), Backward2 + Update (each parameter set's gradient request,
    newest first, and the increment under the distributed update). With
    ``checked`` every round is held to its closed form and its plain twin.
    -> (worst relative sum errors, wall seconds of each iteration)."""
    from mlsl_tpu_torch.core.activation import pack_local

    _, op1, op2 = ops
    out_act, in_act = op1.get_output(0), op2.get_input(0)
    topo = op1.get_distribution().topology
    mb = op1.get_local_minibatch_size()
    worst, secs = {}, []
    for it in range(iters):
        acts = fill(torch, topo, mb * out_act.local_fm_count, it + 1.0, dev)
        wire = pack_local(acts, out_act.pack_blocks, mb, out_act.local_fm_count, 1)
        del acts
        grads_a = fill(torch, topo, mb * in_act.local_fm_count, it + 2.0, dev)
        grads = [(op.get_parameter_set(0),
                  fill(torch, topo, op.get_parameter_set(0).get_local_kernel_count(),
                       it + 3.0, dev)) for op in (op2, op1)]
        incs = [fill(torch, topo, ps.get_owned_kernel_count(), it + 4.0, dev)
                for ps, _ in grads]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if checked:
            mlp_round(torch, out_act, in_act, wire, "FPROP", worst)
            mlp_round(torch, in_act, out_act, grads_a, "BPROP", worst)
            for (ps, g), inc in zip(grads, incs):
                quant = ps.compression != 0
                grad_round(torch, ps, g, f"grad {ps.op.name}", worst, quant)
                if ps.distributed_update:
                    grad_round(torch, ps, inc, f"inc {ps.op.name}", worst, inc=True)
        else:
            out_act.start_comm(wire)
            in_act.wait_comm()
            in_act.start_comm(grads_a)
            out_act.wait_comm()
            for ps, g in grads:
                ps.start_gradient_comm(g)
            for (ps, _), inc in zip(grads, incs):
                ps.wait_gradient_comm()
                if ps.distributed_update:
                    ps.start_increment_comm(inc)
                    ps.wait_increment_comm()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        del wire, grads_a, grads, incs
    return worst, secs


def mlp_request_lines(torch, ops, mods, dev):
    """ms a request and algbw for each of the graph's requests, on its own."""
    s, op1, op2 = ops
    out = {}
    reqs = [("FPROP", op1.get_output(0).comm_req), ("BPROP", op2.get_input(0).comm_req)]
    for op in (op1, op2):
        for ps in op.parameter_sets:
            reqs.append((f"grad {op.name}", ps.grad_req))
            if ps.inc_req is not None:
                reqs.append((f"inc {op.name}", ps.inc_req))
    for name, req in reqs:
        if req is None:
            continue
        topo = req.desc.group.topology
        buf = fill(torch, topo, req.desc.send_len(), 1.0, dev)
        ms = time_request(torch, req, buf, mods)
        nbytes = req.desc.send_len() * 4
        out[name] = {"kind": req.desc.kind, "algo": req.algo, "bytes_a_rank": nbytes,
                     "ms": round(ms, 5), "algbw_GBps": round(nbytes / ms / 1e6, 2)}
        del buf
    return out


def run_activation_graph(torch, np, get_env, launches, reset_launches, mods, dev):
    """Run (m): (m1) the case-1 loop at model 2 and 4, (m2) cases 2 and 3,
    (m3) cases 4 and 5, (m4) int8 parameter sets at model 2, (m5) the
    distributed update at model 2; (m1)-(m4) under SPEC_RING and SPEC_RHD,
    (m5) under SPEC_RING. Launches of each variant's checked loop are held
    to PREDICTED_M. -> (lines, launches by variant)."""
    import tempfile

    from mlsl_tpu_torch import OpType
    from mlsl_tpu_torch.core.activation import pack_local
    from mlsl_tpu_torch.tools import mlsl_example

    lines, used = [], {}
    # the JAX package's examples/mlsl_example.py, its calls unchanged in form
    t0 = time.perf_counter()
    reinit(get_env)
    ex = mlsl_example.main(device=dev, log=lambda s: None)    # finalizes its Environment
    get_env().init(device=dev, world_size=WORLD)
    check(ex["data_parts"] == 4 and float(ex["allreduce"][0]) == 36.0
          and all(v == 4.0 * (it + 1) for (it, _), v in ex["reduced"].items())
          and ex["case"] == "reduce_scatter" and "GRAD0" in ex["table"],
          f"walkthrough: {ex}")
    lines.append(f"# phase activation walkthrough: ok in {time.perf_counter() - t0:.1f} s, "
                 f"examples/mlsl_example.py's calls on a "
                 f"data 4 x model 2 grid: allreduce {float(ex['allreduce'][0])}, case-1 "
                 f"{ex['case']}, gradient sums {sorted(set(ex['reduced'].values()))}")
    stats_dir = tempfile.mkdtemp(prefix="mlsl_stats_")
    variants = [(f"m1 model {m} {tag}", spec, m, "case1", {})
                for tag, spec in (("ring", SPEC_RING), ("rhd", SPEC_RHD)) for m in (2, 4)]
    variants += [(f"m2 {case} {tag}", spec, 2, case, {})
                 for tag, spec in (("ring", SPEC_RING), ("rhd", SPEC_RHD))
                 for case in ("case2", "case3")]
    variants += [(f"m3 {case} {tag}", spec, 4, case, {})
                 for tag, spec in (("ring", SPEC_RING), ("rhd", SPEC_RHD))
                 for case in ("case4", "case5")]
    variants += [(f"m4 int8 model 2 {tag}", spec, 2, "case1", {"quant": True})
                 for tag, spec in (("ring", SPEC_RING), ("rhd", SPEC_RHD))]
    variants += [("m5 zero1 model 2 ring", SPEC_RING, 2, "case1", {"du": True})]
    try:
        for tag, spec, m, case, kw in variants:
            env = reinit(get_env, MLSL_ALGO=spec, MLSL_PALLAS_A2A_QUANT="0", MLSL_STATS="1",
                         MLSL_STATS_DIR=stats_dir)
            held = settle(torch)
            t0 = time.perf_counter()
            d = WORLD // m
            if case == "case1":
                dist = env.create_distribution(d, m)
                ops = mlp_net(env, dist, **kw)
            else:
                a, b = {"case2": ((d, m), (d, 1)), "case3": ((d, m), (WORLD, 1)),
                        "case4": ((WORLD, 1), (d, m)), "case5": ((d, m), (WORLD, 1))}[case]
                cc = case in ("case2", "case3")
                ops = mlp_net(env, env.create_distribution(*a), env.create_distribution(*b),
                              edge_fm=MLP_FM2, out_type=OpType.CC if cc else OpType.ACT)
            commit_s = time.perf_counter() - t0
            stats = ops[0].get_stats()
            iso_s = stats.isolation_s
            reset_launches()
            if case == "case1":
                worst, _ = mlp_loop(torch, env, ops, dev)
            else:
                worst = {}
                _, op1, op2 = ops
                out_act, in_act = op1.get_output(0), op2.get_input(0)
                mb = op1.get_local_minibatch_size()
                topo_a = op1.get_distribution().topology
                topo_b = op2.get_distribution().topology
                for it in range(MLP_ITERS):
                    acts = fill(torch, topo_a, mb * out_act.local_fm_count, it + 1.0, dev)
                    wire = pack_local(acts, out_act.pack_blocks, mb, out_act.local_fm_count, 1)
                    del acts
                    mlp_round(torch, out_act, in_act, wire, "FPROP", worst)
                    if in_act.comm_req is not None:
                        n_b = in_act.comm_req.desc.send_len()
                        mlp_round(torch, in_act, out_act, fill(torch, topo_b, n_b, it + 2.0, dev),
                                  "BPROP", worst)
                    del wire
            torch.cuda.synchronize()
            c = {k: v for k, v in launches().items() if v}
            want = PREDICTED_M[tag]
            check(c == want, f"activation {tag}: launches {c}, predicted {want}")
            used[tag] = c
            if case == "case1":
                _, secs = mlp_loop(torch, env, ops, dev, checked=False, iters=3)
            else:
                secs = []
            req_ms = mlp_request_lines(torch, ops, mods, dev)
            peak = torch.cuda.max_memory_allocated() / 2**30
            rep = stats.overlap_report()
            lines.append(
                f"# activation {tag}: ok, launches {json.dumps(c, sort_keys=True)}, worst "
                f"sum errors "
                f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}, "
                f"commit {commit_s:.3f} s (isolation replay {iso_s:.3f} s), "
                f"loop iteration {[round(s, 5) for s in secs]} s, peak {peak:.2f} GiB "
                f"(held before {held[0]:.2f} GiB), overlap {rep['total']['overlap_fraction']}")
            lines.append(f"# activation {tag} requests: {json.dumps(req_ms)}")
            if tag == "m1 model 4 ring":
                table = stats.print_()
                lines += [f"#   stats: {ln}" for ln in table.splitlines()[:12]]
            del ops, stats
    finally:
        import shutil

        shutil.rmtree(stats_dir, ignore_errors=True)
    return lines, used


# launches of each run (m) variant's two checked loop iterations, predicted
# from the plan before the first chip run (PERF.md §6): B3 = dense_ring,
# B5 = rhd_allreduce, B6 = a2a_dense, B1 = quantize_blocks, B4 = quant_ring
PREDICTED_M = {
    "m1 model 2 ring": {"dense_ring": 6},          # FPROP RS + 2 gradient allreduces
    "m1 model 4 ring": {"dense_ring": 6},
    "m1 model 2 rhd": {"dense_ring": 2, "rhd_allreduce": 4},
    "m1 model 4 rhd": {"dense_ring": 2, "rhd_allreduce": 4},
    "m2 case2 ring": {"dense_ring": 2},            # FPROP allreduce, no BPROP
    "m2 case3 ring": {"dense_ring": 2},            # FPROP RS; BPROP allgather on lax
    "m2 case2 rhd": {"rhd_allreduce": 2},
    "m2 case3 rhd": {"dense_ring": 2},
    "m3 case4 ring": {"a2a_dense": 4},             # FPROP and BPROP alltoall
    "m3 case5 ring": {"a2a_dense": 4},
    "m3 case4 rhd": {"a2a_dense": 4},
    "m3 case5 rhd": {"a2a_dense": 4},
    # FPROP RS on B3; each int8 set: B1 + B4 on the fused ring, 5 B1 (G + 1)
    # on the composed ring (the int8 request keeps it where pallas_rhd is asked)
    "m4 int8 model 2 ring": {"dense_ring": 2, "quantize_blocks": 4, "quant_ring": 4},
    "m4 int8 model 2 rhd": {"dense_ring": 2, "quantize_blocks": 20},
    # FPROP RS + 2 gradient reduce_scatters on B3; the increments on lax
    "m5 zero1 model 2 ring": {"dense_ring": 6},
}


def coll_expected(torch, kind, group, x, kw):
    """The closed form of one collective on world rows x (W, n): float64
    member sums, moves assembled rank by rank from the members' rows. Ragged
    color groups pad to the largest group (absent members zeros)."""
    w = x.shape[0]
    gmax = group.size
    rows = []
    for p in range(w):
        mem = group_members(group, p)
        my = mem.index(p)
        op = kw.get("op")
        if kind in ("allreduce", "reduce", "reduce_scatter"):
            vals = torch.stack([x[q] for q in mem]).double()
            r = (vals.sum(0) if op in (None, 0) else vals.amin(0) if op == 1 else vals.amax(0))
            if kind == "reduce_scatter":
                rc = kw["recv_count"]
                r = r[my * rc:(my + 1) * rc]
        elif kind == "bcast":
            r = x[mem[kw["root"]]]
        elif kind in ("allgather", "gather"):
            r = torch.cat([x[q] for q in mem] + [torch.zeros_like(x[p])] * (gmax - len(mem)))
        elif kind == "allgatherv":
            r = torch.cat([x[q, :kw["recv_counts"][j]] for j, q in enumerate(mem)])
        elif kind == "scatter":
            rc = kw["recv_count"]
            r = x[mem[kw["root"]], my * rc:(my + 1) * rc]
        elif kind == "alltoall":
            sc = kw["send_count"]
            r = torch.cat([x[q, my * sc:(my + 1) * sc] for q in mem]
                          + [torch.zeros_like(x[p, :sc])] * (gmax - len(mem)))
        elif kind == "sendrecv":
            src = [s for s, t in kw["pairs"] if t == my]
            r = x[mem[src[0]]] if src else torch.zeros_like(x[p])
        else:   # alltoallv: the per-rank (Sw) or the instance (S) matrices
            r = torch.zeros(kw["recv_len"], dtype=x.dtype, device=x.device)
            for j, q in enumerate(mem):
                if "Sw" in kw:
                    cnt, soff, roff = kw["Sw"][q][my], kw["Swoff"][q][my], kw["Rwoff"][p][j]
                else:
                    cnt, soff, roff = kw["S"][j][my], kw["Soff"][j][my], kw["Roff"][my][j]
                r[roff:roff + cnt] = x[q, soff:soff + cnt]
        rows.append(r)
    return rows


def run_collectives(torch, np, get_env, dev):
    """Run (n): the eleven collectives and the barrier on a (4, 2) grid's
    data and model groups, equal color groups (p % 2, p // 4) and ragged ones
    (sizes 3 and 5), at COLL_N float32 a rank and in int32, through
    Distribution; each against its closed form (sums in float64 within
    SUM_RTOL, int32 and moves bit for bit); alltoallv with count matrices
    from SEED in matrix and per-rank form; gather_to_host on axis and ragged
    groups; configure("color=...") restricting the world. -> lines."""
    from mlsl_tpu_torch import DataType, GroupType, ReductionType
    from mlsl_tpu_torch.comm.request import CommDesc, normalize_alltoallv

    env = reinit(get_env)
    rng = np.random.default_rng(SEED)
    n = COLL_N
    lines = []
    layouts = [("data (4, 2)", "grid", GroupType.DATA), ("model (4, 2)", "grid", GroupType.MODEL),
               ("colors p % 2", tuple(p % 2 for p in range(WORLD)), GroupType.DATA),
               ("colors p // 4", tuple(p // 4 for p in range(WORLD)), GroupType.DATA),
               ("colors 3 + 5", (0, 0, 0, 1, 1, 1, 1, 1), GroupType.DATA)]
    for name, layout, gt in layouts:
        dist = (env.create_distribution(4, 2) if layout == "grid" else
                env.create_distribution_with_colors(layout, (0,) * WORLD))
        group = dist._group(gt)
        g, gmin = group.size, (min(group.group_sizes) if group.colors is not None
                               else group.size)
        ms_by_kind = {}
        for dt, dtype in ((DataType.FLOAT, torch.float32), (DataType.INT32, torch.int32)):
            x = fill(torch, dist.topology, n, 1.0, dev).to(dtype)
            if dtype == torch.float32:
                x = x / 7.0          # not integers: sums round
            xw = x.reshape(WORLD, n)
            rc = n // g
            calls = [("allreduce", {"op": op}, lambda op=op: dist.all_reduce(
                          x, n, dt, op, gt)) for op in ReductionType]
            calls += [
                ("reduce", {"op": ReductionType.SUM, "root": 0},
                 lambda: dist.reduce(x, n, dt, ReductionType.SUM, 0, gt)),
                ("bcast", {"root": gmin - 1}, lambda: dist.bcast(x, n, dt, gmin - 1, gt)),
                ("allgather", {}, lambda: dist.all_gather(x, n, dt, gt)),
                ("gather", {"root": 0}, lambda: dist.gather(x, n, dt, 0, gt)),
                ("scatter", {"root": gmin - 1, "recv_count": rc},
                 lambda: dist.scatter(x[..., :g * rc], rc, dt, gmin - 1, gt)),
                ("reduce_scatter", {"op": ReductionType.SUM, "recv_count": rc},
                 lambda: dist.reduce_scatter(x[..., :g * rc], rc, dt, ReductionType.SUM, gt)),
                ("alltoall", {"send_count": rc},
                 lambda: dist.all_to_all(x[..., :g * rc], rc, dt, gt)),
                ("sendrecv", {"pairs": tuple((i, (i + 1) % gmin) for i in range(gmin))},
                 lambda: dist.send_recv_list(x, n, dt, [(i, (i + 1) % gmin)
                                                        for i in range(gmin)], gt)),
            ]
            if group.is_uniform:
                counts = tuple(int(v) for v in rng.integers(n // 2, n + 1, size=g))
                calls.append(("allgatherv", {"recv_counts": counts},
                              lambda c=counts: dist.all_gatherv(x, n, c, dt, gt)))
                s = rng.integers(rc // 2, rc + 1, size=(g, g))
                sw = rng.integers(0, rc + 1, size=(WORLD, g))
                for sm in (s, sw):
                    kw = normalize_alltoallv(CommDesc("alltoallv", group, 0, dt,
                                                      send_counts=tuple(map(tuple, sm.tolist()))))
                    calls.append(("alltoallv", kw, lambda sm=sm: dist.all_to_allv(
                        x, sm, None, None, None, dt, gt)))
            for kind, kw, start in calls:
                req = start()
                out = env.wait(req).reshape(WORLD, -1)
                torch.cuda.synchronize()
                src = xw[:, :g * kw["recv_count"]] if kind in ("scatter", "reduce_scatter") \
                    else xw[:, :g * kw["send_count"]] if kind == "alltoall" else xw
                want = coll_expected(torch, kind, group, src, kw)
                for p in range(WORLD):
                    if kind in ("allreduce", "reduce", "reduce_scatter") and \
                            dtype == torch.float32 and kw["op"] == ReductionType.SUM:
                        rel = float(((out[p].double() - want[p]).abs()
                                     / want[p].abs().clamp_min(1e-30)).max())
                        check(rel <= SUM_RTOL, f"collectives {name} {kind}: rank {p} sum "
                                               f"{rel:.3g} off the float64 sum")
                    else:
                        check(same_bits(torch, out[p], want[p].to(dtype)),
                              f"collectives {name} {kind} {dtype}: rank {p} differs from "
                              f"the closed form")
                if dtype == torch.float32:
                    key = kind if kind != "alltoallv" else (
                        "alltoallv per-rank" if "Sw" in kw else "alltoallv")
                    if key == "allreduce" and kw["op"] != ReductionType.SUM:
                        continue
                    ms_by_kind[key] = round(time_ms(torch, lambda: env.wait(start()),
                                                    reps=3, warmup=1), 4)
                del out, want
            del x, xw
        dist.barrier(gt)
        ms_by_kind["barrier"] = round(time_ms(torch, lambda: dist.barrier(gt), reps=3,
                                              warmup=1), 4)
        lines.append(f"# collectives {name} (G={g}, {n * 4} B a rank): ok, ms a call "
                     f"{json.dumps(ms_by_kind)}")
        if gt == GroupType.DATA and layout != (tuple(p // 4 for p in range(WORLD))):
            buf = fill(torch, dist.topology, 1024, 1.0, dev)
            host = dist.gather_to_host(buf, 1024, DataType.FLOAT, 0, gt)
            hb = buf.reshape(WORLD, -1).cpu().numpy()
            for root, got in host.items():
                mem = group_members(group, root)
                check(mem[0] == root and np.array_equal(got, np.concatenate([hb[q] for q in mem])),
                      f"collectives {name}: gather_to_host at root {root}")
    env.configure("color=0,0,0,0,1,1,1,1")
    d4 = env.create_distribution(4, 1)
    out = env.wait(d4.all_reduce(fill(torch, d4.topology, 4, 1.0, dev), 4, DataType.FLOAT,
                                 ReductionType.SUM, GroupType.DATA))
    check(d4.get_process_count(GroupType.GLOBAL) == 4
          and float(out.reshape(4, -1)[0, 0]) == 6000.0,
          "configure('color=0,0,0,0,1,1,1,1') did not restrict the world to 4 ranks")
    lines.append("# collectives configure: ok, color=0,0,0,0,1,1,1,1 leaves 4 ranks")
    from mlsl_tpu_torch.comm import collectives

    collectives.clear_cache()
    return lines


def group_ring_entry(torch, rk, kind, grid, axes, count, tag, bw, f32, per_path, dev):
    """B3 at a graph request's shape: the world rows of ``grid`` over the
    group of ``axes``, ``count`` float32 a rank, allreduce or reduce_scatter.
    Library yardstick: the member sum of the (C, G, n) view in one call (the
    scatter is a view of it), which the port never calls."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    d, m = grid
    group = ProcessGroup(Topology(d, m, d * m), axes)
    w, g = d * m, group.size
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    x = torch.randn((w, count), generator=gen, device=dev)
    plan = rk.dense_plan(kind, group, count, bidir=False)
    before = dict(rk.LAUNCHES)
    got, want = rk.dense_ring(x, plan), rk.dense_ring_ref(x, plan)
    torch.cuda.synchronize()
    check(same_bits(torch, got, want), f"B3 entry ({tag}): differs from the plain version")
    del got, want
    ms = time_ms(torch, lambda: rk.dense_ring(x, plan), reps=20)
    rk.LAUNCHES.update(before)
    plain_ms = time_ms(torch, lambda: rk.dense_ring_ref(x, plan), reps=3, warmup=1)
    rows = torch.as_tensor(plan.ring, device=dev).long().flatten()
    view = x.index_select(0, rows).view(w // g, g, count)
    if kind == "reduce_scatter":
        library = lambda: view.sum(dim=1)      # noqa: E731  (member i's slice is a view)
        note = "x.view(C, G, n).sum(dim=1) on member-ordered rows"
    else:
        library = lambda: view.sum(dim=1, keepdim=True).expand_as(view).contiguous()  # noqa: E731
        note = ("x.view(C, G, n).sum(dim=1, keepdim=True).expand_as(.).contiguous() on "
                "member-ordered rows")
    library_ms = time_ms(torch, library, reps=20)
    out_elems = w * (count // g if kind == "reduce_scatter" else count)
    return entry(name=f"dense_ring (B3 {kind}, {tag})", source="mlsl_tpu_torch/csrc/ring_kernels.cu",
                 replaces="mlsl_tpu/ops/ring_kernels.py:698", launches=sum(per_path.values()),
                 per_path=per_path, shape=[w, count, g], err=0.0, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, nbytes=(w * count + out_elems) * 4,
                 ops=(g - 1) * (w // g) * count, bw=bw, peak=f32, library_note=note)


def group_rhd_entry(torch, rhd, grid, axes, count, tag, bw, f32, per_path, dev):
    """B5 at a gradient allreduce's shape over the group of ``axes``."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology

    d, m = grid
    group = ProcessGroup(Topology(d, m, d * m), axes)
    w, g = d * m, group.size
    plan = rhd.RhdPlan(group)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    x = torch.randn((w, count), generator=gen, device=dev)
    before = dict(rhd.LAUNCHES)
    got, want = rhd.rhd_allreduce(x, plan), rhd.rhd_allreduce_ref(x, plan)
    torch.cuda.synchronize()
    check(same_bits(torch, got, want), f"B5 entry ({tag}): differs from the plain version")
    del got, want
    ms = time_ms(torch, lambda: rhd.rhd_allreduce(x, plan), reps=20)
    rhd.LAUNCHES.update(before)
    rows = torch.as_tensor(plan.rows, device=dev).long().flatten()
    view = x.index_select(0, rows).view(w // g, g, count)
    return entry(name=f"rhd_allreduce (B5, {tag})", source="mlsl_tpu_torch/csrc/rhd_kernels.cu",
                 replaces="mlsl_tpu/ops/rhd_kernels.py:256", launches=sum(per_path.values()),
                 per_path=per_path, shape=[w, count, g], err=0.0, ms=ms,
                 plain_ms=time_ms(torch, lambda: rhd.rhd_allreduce_ref(x, plan), reps=5),
                 library_ms=time_ms(torch, lambda: view.sum(dim=1, keepdim=True)
                                    .expand_as(view).contiguous(), reps=20),
                 nbytes=2 * w * count * 4, ops=(g - 1) * (w // g) * count, bw=bw, peak=f32,
                 library_note="x.view(C, G, n).sum(dim=1, keepdim=True).expand_as(.)"
                              ".contiguous() on member-ordered rows")


# -- run (t): the compressed wires beyond int8 ---------------------------------

TOPK_RATIO = 0.01
CODEC_STEPS = 3
# relative L2 bound of the error feedback's telescoping over CODEC_STEPS
# rounds: each round's entry adds x + e in float32 (one rounding an element)
TELESCOPE_TOL = 1e-5
CODEC_PROFILE = ROOT / "build" / "mlsl_tpu_torch" / "codec_profile.json"
# (t4)'s request: config 4's allreduce cut to 16 MiB of float32 a rank (from 64 in
# PR 26, for the smoke's wall: ROADMAP C.14); the library codec's host round
# trip and its CPU twin scale with it
CODEC_LIB_N = (16 << 20) // 4


def sum_bound(torch, terms):
    """Elementwise bound on a float32 sum of the G terms against its float64
    value: G x 2**-24 x the sum of their magnitudes."""
    return terms.abs().sum(dim=0) * (terms.shape[0] * 2.0 ** -24)


def codec_steps(torch, trainer, batch, steps=CODEC_STEPS, keep=()):
    """``steps`` host-path steps, each as its two halves (``step`` is exactly
    them). -> (per-rank losses, step seconds, {step: {layer: (local grads,
    residuals before the round, reduced result)}} for the steps in
    ``keep``)."""
    losses, secs, kept = [], [], {}
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._step_no += 1
        loss, grads = trainer._local_grads(batch)
        if i in keep:
            before = {n: ([e.clone() for e in _grad_req(trainer, n)._errs]
                          if _grad_req(trainer, n)._errs is not None else None)
                      for n in trainer.layers}
            snap = {n: grads[n].clone() for n in trainer.layers}
        loss = trainer._sync_and_update(grads, loss)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.detach().reshape(-1).cpu())
        if i in keep:
            kept[i] = {n: (snap[n], before[n], _grad_req(trainer, n)._result.clone())
                       for n in trainer.layers}
    for i, loss in enumerate(losses):
        check(loss.shape == (WORLD,) and bool(torch.isfinite(loss).all()),
              f"codec run step {i}: losses {loss.tolist()}")
    return losses, secs, kept


def codec_trainer(torch, np, get_env, compression, **env_vars):
    from mlsl_tpu_torch.core import stats as stats_mod

    env = reinit(get_env, **env_vars)
    settle(torch)
    stats_mod.reset_codec_counters()
    trainer, batch = build_resnet_trainer(torch, env, np, compression=compression)
    return env, trainer, batch


def check_topk(torch, trainer, kept, tag):
    """(t1): the first round against the float64 sum of the ranks' top-k
    contributions; the feedback's telescoping over the rounds; -> the worst
    first-round error over its bound and the worst telescoping error."""
    from mlsl_tpu_torch.codecs import _stable_topk

    worst_first, worst_tel = 0.0, 0.0
    for name in trainer.layers:
        req = _grad_req(trainer, name)
        check(req.algo == "topk", f"{tag}: layer {name} took {req.algo!r}")
        g0, _, r0 = kept[0][name]
        n = g0.shape[-1]
        k = max(1, int(n * TOPK_RATIO))
        rows = g0.reshape(WORLD, n).double()
        idx = _stable_topk(rows.abs(), k)
        sparse = torch.zeros_like(rows).scatter_(1, idx, rows.gather(1, idx))
        exact = sparse.sum(dim=0)
        bound = sum_bound(torch, sparse) + 1e-30
        got = r0.reshape(WORLD, -1)
        check(bool((got == got[:1]).all()), f"{tag}: ranks disagree on layer {name}")
        ratio = float(((got[0].double() - exact).abs() / bound).max())
        worst_first = max(worst_first, ratio)
        check(ratio <= 1.0, f"{tag}: layer {name} first round off by {ratio:.3g} of its bound")
        # the telescoping: results + final residuals == the inputs, summed
        total_in = sum(kept[i][name][0].reshape(WORLD, n).double().sum(dim=0) for i in kept)
        total_out = sum(kept[i][name][2].reshape(WORLD, -1)[0].double() for i in kept)
        resid = req._errs[0].reshape(WORLD, n).double().sum(dim=0)
        rel = float((total_out + resid - total_in).norm() / total_in.norm())
        worst_tel = max(worst_tel, rel)
        check(rel < TELESCOPE_TOL, f"{tag}: layer {name} feedback telescopes to {rel:.3g}")
    return worst_first, worst_tel


def check_ring_merge(torch, trainer, kept):
    """(t1): the ring format forced on the fc request (G = 8) against the
    all-gather format on the same inputs: within the float32 sum bound of
    the other order. -> the worst error over the bound."""
    from mlsl_tpu_torch.comm import sparse

    req = _grad_req(trainer, "fc")
    g0 = kept[0]["fc"][0]
    n = g0.shape[-1]
    zero = torch.zeros_like(g0)
    ring, _ = sparse.build_sparse_collective("allreduce", req.desc.group, n, TOPK_RATIO,
                                             use_ring=True)
    gather, _ = sparse.build_sparse_collective("allreduce", req.desc.group, n, TOPK_RATIO,
                                               use_ring=False)
    (a, ea), (b, eb) = ring(g0, zero), gather(g0, zero)
    check(same_bits(torch, ea, eb), "ring merge: the residuals differ")
    check(same_bits(torch, b, kept[0]["fc"][2]), "ring merge: the all-gather format is not the "
                                            "request's first round")
    bound = 2 * sum_bound(torch, g0.reshape(WORLD, n).double()) + 1e-30
    ratio = float(((a - b).reshape(WORLD, n).double().abs() / bound).max())
    check(ratio <= 1.0, f"ring merge: off the all-gather format by {ratio:.3g} of its bound")
    return ratio


def check_registry_residuals(torch, trainer, kept, name, step):
    """(t2): every chunk's new residual is (x + e_old) - decode(encode(x +
    e_old)), recomputed here with the registry codec, bit for bit."""
    from mlsl_tpu_torch import codecs
    from mlsl_tpu_torch.comm.collectives import group_view
    from mlsl_tpu_torch.comm.quant_ring import _to_chunks

    codec = codecs.configure(name, trainer.env.config)
    for layer in trainer.layers:
        req = _grad_req(trainer, layer)
        check(req.algo == f"codec:{name}", f"{name}: layer {layer} took {req.algo!r}")
        g, before, _ = kept[step][layer]
        group = req.desc.group
        gsz = group.size
        n = g.shape[-1]
        rc = -(-n // gsz)
        x = group_view(g, group)
        e_old = group_view(before[0], group)
        c = x.shape[0]
        xq = _to_chunks(x, gsz, rc, rc) + e_old.reshape(c, gsz, gsz, rc)
        rows = xq.reshape(-1, rc)
        want = (rows - codec.decode(codec.encode(rows), rc)).reshape(c, gsz, gsz * rc)
        check(same_bits(torch, group_view(req._errs[0], group).contiguous(), want.contiguous()),
              f"{name}: layer {layer}'s residual is not x + e - decode(encode(x + e))")


def check_wire_bytes(trainer, name, rounds):
    from mlsl_tpu_torch import codecs
    from mlsl_tpu_torch.core import stats as stats_mod

    codec = codecs.configure(name, trainer.env.config)
    want = rounds * sum(codec.wire_len(_grad_req(trainer, n).desc.count)
                        for n in trainer.layers)
    got = stats_mod.CODEC_WIRE_BYTES.get(name, 0)
    check(got == want, f"{name}: wire bytes {got} in the statistics, expected {want}")
    return got


def guard_demotion(torch, env, trainer, batch, tag):
    """(t3): one guardrail demotion through codecs.guard_note on a request
    running a calibrated codec other than int8: the residual it held goes
    out once with the next round, which equals a fresh int8 request fed the
    gradient plus that residual bit for bit; the round after equals the
    fresh request on the plain gradient. -> the demoted request's name."""
    from mlsl_tpu_torch import codecs
    from mlsl_tpu_torch.comm.quant_ring import logical_residual
    from mlsl_tpu_torch.comm.request import CommDesc, CommRequest

    guarded = codecs.guard_status()["guarded"]
    check(guarded, f"{tag}: no request runs a calibrated codec other than int8")
    layer = next(n for n in reversed(trainer.layers)
                 if _grad_req(trainer, n).name in guarded)
    req = _grad_req(trainer, layer)
    old = req.algo
    held = [e.clone() for e in req._errs]
    lens = list(req._err_lens)
    window = env.config.codec_guard_breaches
    fired = [codecs.guard_note(True, window=window, step=s) for s in range(window)]
    check(fired == [False] * (window - 1) + [True], f"{tag}: guard_note fired {fired}")
    check(req._codec_demoted and req.algo == "quant_ring" and req.codec_source == "demoted",
          f"{tag}: {req.name} after the demotion: {req.algo} {req.codec_source}")
    d = req.desc
    oracle = CommRequest(CommDesc(d.kind, d.group, d.count, d.data_type, op=d.op,
                                  compression=d.compression), env.dispatcher,
                         name="oracle-int8")
    oracle.setup()
    check(oracle.algo == "quant_ring", f"{tag}: the int8 oracle took {oracle.algo}")
    n = d.count
    g = d.group.size
    rc = -(-n // g)
    res = logical_residual(held[0], g, lens[0] // g, rc, n) if old != "topk" else held[0]
    _, grads = trainer._local_grads(batch)
    x = grads[layer]
    a = req.start(x).wait()
    check(req._pending_flush is None, f"{tag}: the flush is still pending after a round")
    b = oracle.start(x + res).wait()
    check(same_bits(torch, a, b), f"{tag}: the flush round differs from int8 on the flushed payload")
    a, b = req.start(x).wait(), oracle.start(x).wait()
    check(same_bits(torch, a, b) and same_bits(torch, req._errs[0], oracle._errs[0]),
          f"{tag}: the round after the flush is not the plain int8 request's")
    return {"layer": layer, "from": old, "to": req.algo}


def run_codecs(torch, np, get_env, launches, reset_launches, lib_path, dev):
    """Run (t). -> ({sub-run: launches}, log lines)."""
    from mlsl_tpu_torch import CompressionType, c_shim
    from mlsl_tpu_torch.comm import codec as codec_mod
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
    from mlsl_tpu_torch.core import stats as stats_mod
    from mlsl_tpu_torch.types import QuantParams

    lines, used = [], {}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # the uncompressed host path: the step time every sub-run stands beside
        t0 = time.perf_counter()
        env, tr, batch = codec_trainer(torch, np, get_env, CompressionType.NONE)
        _, secs_none, kept_none = codec_steps(torch, tr, batch, keep=(0,))
        first_none = {n: kept_none[0][n][2][0, 0, 0, 0] for n in tr.layers}
        grads_none = {n: kept_none[0][n][0] for n in tr.layers}
        del tr, kept_none
        base = {"step_s": secs_none}
        lines.append(f"# codecs uncompressed config 5 (host path): "
                     f"{json.dumps({'step_s': secs_none, 'run_s': time.perf_counter() - t0})}")

        # (t1) TOPK on all 18 gradient requests
        t0 = time.perf_counter()
        env, tr, batch = codec_trainer(torch, np, get_env, CompressionType.TOPK,
                                       MLSL_TOPK_RATIO=str(TOPK_RATIO))
        reset_launches()
        losses, secs, kept = codec_steps(torch, tr, batch, keep=tuple(range(CODEC_STEPS)))
        used["topk"] = launches()
        first, tel = check_topk(torch, tr, kept, "topk")
        ring = check_ring_merge(torch, tr, kept)
        k_fc = max(1, int(_grad_req(tr, "fc").desc.count * TOPK_RATIO))
        out = {"losses": [float(v.mean()) for v in losses], "step_s": secs,
               "uncompressed_step_s": base["step_s"], "k_fc": k_fc,
               "first_round_worst_over_bound": first, "telescope_worst_rel": tel,
               "ring_vs_allgather_worst_over_bound": ring,
               "wire_bytes": dict(stats_mod.CODEC_WIRE_BYTES),
               "run_s": time.perf_counter() - t0}
        lines.append(f"# codecs (t1) topk: {json.dumps(out)}")
        del tr, kept

        # (t2) the registry codecs on the compressed ring
        for name in ("f32", "prune", "vq"):
            t0 = time.perf_counter()
            env, tr, batch = codec_trainer(torch, np, get_env, None, MLSL_CODEC=name)
            reset_launches()
            losses, secs, kept = codec_steps(torch, tr, batch, keep=(0, CODEC_STEPS - 1))
            used[name] = launches()
            check_registry_residuals(torch, tr, kept, name, CODEC_STEPS - 1)
            wire = check_wire_bytes(tr, name, CODEC_STEPS)
            out = {"losses": [float(v.mean()) for v in losses], "step_s": secs,
                   "uncompressed_step_s": base["step_s"], "wire_bytes": wire}
            if name == "f32":
                worst = 0.0
                for n in tr.layers:
                    check(same_bits(torch, kept[0][n][0], grads_none[n]),
                          f"f32: layer {n}'s local gradients differ from the uncompressed run")
                    bound = 2 * sum_bound(torch, grads_none[n].reshape(WORLD, -1).double())
                    diff = (kept[0][n][2][0, 0, 0, 0].double() - first_none[n].double()).abs()
                    worst = max(worst, float((diff / (bound + 1e-30)).max()))
                check(worst <= 1.0, f"f32: first-round gradients off the uncompressed run by "
                                    f"{worst:.3g} of the float32 sum bound")
                out["first_round_vs_uncompressed_worst_over_bound"] = worst
            out["run_s"] = time.perf_counter() - t0
            lines.append(f"# codecs (t2) {name}: {json.dumps(out)}")
            del tr, kept
        del first_none, grads_none

        # (t3) the calibration at commit, its profile and the guardrail
        t0 = time.perf_counter()
        if CODEC_PROFILE.exists():
            CODEC_PROFILE.unlink()
        CODEC_PROFILE.parent.mkdir(parents=True, exist_ok=True)
        reset_launches()
        env, tr, _ = codec_trainer(torch, np, get_env, None, MLSL_TUNE_CODEC="1",
                                   MLSL_TUNE_PROFILE=str(CODEC_PROFILE))
        used["calibration"] = launches()
        n_sets = len(tr.layers)
        want = 3 * n_sets
        check(counts_are(used["calibration"], quantize_blocks=want, dequantize_blocks=want),
              f"calibration: launches {used['calibration']}, expected {want} of B1 and B2 "
              f"(3 int8 blocks on each of {n_sets} sets)")
        table = {k: v["codec"] for k, v in env.config.codec_assignment.items()}
        check(CODEC_PROFILE.is_file() and set(json.loads(CODEC_PROFILE.read_text())["codecs"])
              == set(table), "calibration: the profile does not hold the table")
        check(stats_mod.CODEC_COUNTERS["assignments"] == n_sets,
              f"calibration: {stats_mod.CODEC_COUNTERS}")
        calib_s = time.perf_counter() - t0
        del tr
        env, tr, batch = codec_trainer(torch, np, get_env, None,
                                       MLSL_TUNE_PROFILE=str(CODEC_PROFILE))
        for n in tr.layers:
            req = _grad_req(tr, n)
            check(req.codec_source == "calibrated" and req.codec_name == table[req.name],
                  f"fresh environment: {req.name} runs {req.codec_name} ({req.codec_source}), "
                  f"the profile says {table[req.name]}")
        reset_launches()
        losses, secs, _ = codec_steps(torch, tr, batch, steps=2)
        used["calibrated"] = launches()
        demoted = guard_demotion(torch, env, tr, batch, "guardrail")
        mix = {}
        for c in table.values():
            mix[c] = mix.get(c, 0) + 1
        out = {"codecs": mix, "losses": [float(v.mean()) for v in losses], "step_s": secs,
               "uncompressed_step_s": base["step_s"], "calibration_s": calib_s,
               "launches_calibration": used["calibration"], "demotion": demoted,
               "wire_bytes": dict(stats_mod.CODEC_WIRE_BYTES),
               "run_s": time.perf_counter() - t0}
        lines.append(f"# codecs (t3) calibration: {json.dumps(out)}")
        del tr

        # (t4) the library codec on config 4's request cut to CODEC_LIB_N, and
        # the C entry
        t0 = time.perf_counter()
        env = reinit(get_env)
        settle(torch)
        params = QuantParams(lib_path=lib_path, quant_buffer_func_name="sample_compress",
                             dequant_buffer_func_name="sample_decompress",
                             reduce_sum_func_name="sample_reduce_sum", elem_in_block=128,
                             block_size=256)
        env.set_quantization_params(params)
        from mlsl_tpu_torch import DataType, GroupType, ReductionType

        n = CODEC_LIB_N
        dist = env.create_distribution(WORLD, 1)
        gen = torch.Generator().manual_seed(SEED + 4)
        xs = [torch.randn((*dist.world_shape, n), generator=gen) for _ in range(2)]
        codec_mod.reset_timings()
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        req = dist.all_reduce(xs[0].to(dev), n, DataType.FLOAT, ReductionType.SUM,
                              GroupType.DATA, compression=CompressionType.QUANTIZATION)
        outs = [env.wait(req).cpu()]
        errs = [req._errs[0].cpu()]
        outs.append(req.start(xs[1].to(dev)).wait().cpu())
        errs.append(req._errs[0].cpu())
        card_s = time.perf_counter() - t1
        used["library_codec"] = launches()
        timings = dict(codec_mod.TIMINGS)
        check(req.algo == "custom_codec", f"library codec: the request took {req.algo}")
        topo = Topology(WORLD, 1, WORLD)
        fn, el = codec_mod.build_custom_collective("allreduce", ProcessGroup(topo, ("data",)),
                                                   n, env.config.custom_codec)
        err = torch.zeros((*topo.grid_shape, el))
        t1 = time.perf_counter()
        for r, x in enumerate(xs):
            out, err = fn(x, err)
            check(same_bits(torch, out, outs[r]) and same_bits(torch, err, errs[r]),
                  f"library codec round {r}: the card's result or residual differs from the "
                  f"CPU's")
            exact = x.sum(dim=1, keepdim=True)
            rel = float((out[:, :1] - exact).norm() / exact.norm())
            check(rel < 0.01, f"library codec round {r}: relative error {rel}")
        cpu_s = time.perf_counter() - t1
        check(c_shim.env_set_quantization_params(lib_path, "sample_compress",
                                                 "sample_decompress", "sample_reduce_sum",
                                                 256, 128) == 0
              and env.config.custom_codec is not None, "c_shim: the library did not register")
        out = {"bytes_a_rank": n * 4, "rounds": 2, "card_s": card_s, "cpu_twin_s": cpu_s,
               "d2h_s": timings["d2h_s"], "codec_s": timings["codec_s"],
               "h2d_s": timings["h2d_s"], "codec_calls": timings["calls"],
               "rest_s": card_s - timings["d2h_s"] - timings["codec_s"] - timings["h2d_s"],
               "launches": {k: v for k, v in used["library_codec"].items() if v},
               "run_s": time.perf_counter() - t0}
        lines.append(f"# codecs (t4) library codec: {json.dumps(out)}")
        del xs, outs, errs, req
    finally:
        torch.backends.cudnn.deterministic = False
    env = reinit(get_env)
    settle(torch)
    return used, lines


# -- the two-tier lowering (run (u)) and the sweep (run (v)) ---------------------------

# the synthetic tier splits of the 8 virtual ranks (MLSL_MESH_TIERS): T tiers
# of L ranks, tier = rank // L
HIER_SPLITS = ("2x4", "4x2", "1x8")
HIER_CODECS = ("int8", "f32", "topk", "prune", "vq")
# (v): the reference's default sizes and one bandwidth-bound size, KiB a rank
TUNE_SIZES = "16,256,2048,65536"
TUNE_PROFILE = ROOT / "build" / "mlsl_tpu_torch" / "tune_profile.json"


def phase_hier_dense(torch, get_env, drive, n=(256 << 20) // 4):
    """(u1): BASELINE's 8 x 256 MiB float32 allreduce and a reduce_scatter
    under MLSL_ALGO=hier on each split: random floats within SUM_RTOL of the
    float64 sum (one ``# algos hier ...`` line each with time, algbw and
    launches), integers bit for bit against ``lax``. -> relative errors."""
    from mlsl_tpu_torch import DataType, GroupType, ReductionType

    dev = get_env().device
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = torch.randn((1, WORLD, 1, 1, n), generator=gen, device=dev)
    xi = torch.randint(-8, 8, (1, WORLD, 1, 1, n), generator=gen, device=dev).float()
    rels = {}
    for spec in HIER_SPLITS:
        env = reinit(get_env, MLSL_ALGO="hier", MLSL_MESH_TIERS=spec)
        dist = env.create_distribution(WORLD, 1)
        group = dist.data_group
        for kind in ("allreduce", "reduce_scatter"):
            tag = f"hier {kind} {spec}"
            out = drive(env, dist, GroupType.DATA, kind, x, n, DataType.FLOAT, "hier", tag)
            rels[tag] = check_sums(torch, out, x, group, tag, SUM_RTOL)
            del out
            got = drive(env, dist, GroupType.DATA, kind, xi, n, DataType.FLOAT, "hier",
                        f"{tag} integers", time_it=False)
            kw = {"recv_count": n // WORLD} if kind == "reduce_scatter" else {}
            lax = drive.algos.build(kind, group, "lax", op=ReductionType.SUM, **kw)(xi)
            torch.cuda.synchronize()
            check(same_bits(torch, got, lax), f"algos {tag}: integers differ from lax")
            del got, lax
    del x, xi
    return rels


def hier_sentinel(torch, n, dev, gen):
    """The same integers on every rank with 127 at each block start
    (tests/test_hier.py:226-233): every scale of both int8 wires is an exact
    integer, so both deliver the exact integer sum."""
    v = torch.randint(-8, 8, (n,), generator=gen, device=dev).float()
    v[::BLOCK] = 127.0
    return v.expand(1, WORLD, 1, 1, n).contiguous(), v


def dcn_member_bytes(torch, codec, slen, dev):
    """The bytes of one member's encoded DCN shard: the int8 codec's wire
    (payload and shared scales), the float32 shard for f32 and topk (a dense
    sum on the DCN), a registry codec's encoded wire."""
    from mlsl_tpu_torch import codecs

    if codec in ("f32", "topk"):
        return 4 * slen
    c = codecs.get("int8", block=BLOCK) if codec == "int8" else codecs.configure(codec)
    return int(c.encode(torch.randn((1, slen), device=dev)).shape[-1])


def phase_hier_quant(torch, np, get_env, qk, n=(64 << 20) // 4):
    """(u2): config 4's 64 MiB-a-rank int8 allreduce on the ring="hier" wire.
    The sentinel payload on each split: the exact integer sum bit for bit,
    equal to the flat ring's, a zero residual. Then on 2x4 each DCN codec,
    random payloads, 2 rounds: outputs and residuals bit for bit against an
    independently built twin (``hier.quant_body``); f32 against the dense
    hier on integers; the encoded shard against ``dcn_wire_bytes``. -> log
    lines."""
    from mlsl_tpu_torch import CompressionType, DataType, GroupType, ReductionType
    from mlsl_tpu_torch.comm import algos, quant_ring
    from mlsl_tpu_torch.comm.algos import hier

    dev = get_env().device
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    lines = []
    for spec in HIER_SPLITS:
        env = reinit(get_env, MLSL_ALGO="hier", MLSL_MESH_TIERS=spec)
        dist = env.create_distribution(WORLD, 1)
        x, v = hier_sentinel(torch, n, dev, gen)
        req = dist.all_reduce(x, n, DataType.FLOAT, ReductionType.SUM, GroupType.DATA,
                              compression=CompressionType.QUANTIZATION)
        out = env.wait(req)
        flat, el = quant_ring.build_quantized_collective("allreduce", dist.data_group, n, BLOCK)
        want = flat(x, torch.zeros((*dist.world_shape, el), device=dev))[0]
        torch.cuda.synchronize()
        check(req.algo == "hier", f"hier sentinel {spec}: selected {req.algo!r}")
        check(bool((out == v * WORLD).all()), f"hier sentinel {spec}: not the exact sum")
        check(same_bits(torch, out, want), f"hier sentinel {spec}: differs from the flat ring")
        check(float(req._errs[0].abs().max()) == 0.0, f"hier sentinel {spec}: residual not 0")
        del x, v, out, want, req
    lines.append(f"# hier sentinel: the int8 wire's exact integer sum on {', '.join(HIER_SPLITS)}"
                 f", bit for bit the flat ring's, zero residuals")
    for codec in HIER_CODECS:
        env = reinit(get_env, MLSL_ALGO="hier", MLSL_MESH_TIERS="2x4",
                     MLSL_HIER_DCN_CODEC=codec)
        group = env.create_distribution(WORLD, 1).data_group
        t0 = time.perf_counter()
        xs, outs, errs, req, _ = phase_config4(torch, env, np, qk, n=n, roundtrip=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(req.algo == "hier" and req._err_layout == "hier",
              f"hier {codec}: selected {req.algo!r} ({req._err_layout})")
        twin, el = hier.quant_body("allreduce", group, n, BLOCK, codec=codec,
                                   topk_ratio=env.config.topk_ratio)
        check(req._err_lens == [el], f"hier {codec}: err_len {req._err_lens} != {el}")
        err = torch.zeros((*group.topology.grid_shape, el), device=dev)
        rels = []
        for r, x in enumerate(xs):
            entered = x.sum(dim=1, keepdim=True)
            o, err = twin(x, err)
            torch.cuda.synchronize()
            check(same_bits(torch, o, outs[r]) and same_bits(torch, err, errs[r]),
                  f"hier {codec} round {r}: differs from its independently built twin")
            rels.append(float((o[:, :1] - entered).norm() / entered.norm()))
        if codec == "int8":
            check(max(rels) < 0.02, f"hier int8: relative errors {rels}")
        if codec == "f32":
            check(max(float(e.abs().max()) for e in errs) == 0.0, "hier f32: residual not 0")
            xi = torch.randint(-8, 8, xs[0].shape, generator=gen, device=dev).float()
            fn, fel = quant_ring.build_quantized_collective("allreduce", group, n, BLOCK,
                                                            ring="hier", dcn_codec="f32")
            o, _ = fn(xi, torch.zeros((*group.topology.grid_shape, fel), device=dev))
            dense = algos.build("allreduce", group, "hier", op=ReductionType.SUM)(xi)
            torch.cuda.synchronize()
            check(same_bits(torch, o, dense), "hier f32: differs from the dense hier")
            del xi, o, dense
        t, l = hier.tier_structure(group)
        per = dcn_member_bytes(torch, codec, el, dev)
        wire = int(2 * (t - 1) / t * per)
        check(wire == hier.dcn_wire_bytes(n, (t, l), codec, BLOCK),
              f"hier {codec}: {wire} B on the DCN a member, dcn_wire_bytes says "
              f"{hier.dcn_wire_bytes(n, (t, l), codec, BLOCK)}")
        ms = time_ms(torch, lambda: req.start(xs[0]).wait(), reps=3, warmup=1)
        lines.append(f"# hier {codec} 2x4: 64 MiB a rank, 2 rounds bit-exact with the twin "
                     f"(outputs and residuals), relative errors {[round(v, 6) for v in rels]}, "
                     f"{ms:.4f} ms a round (first 2 rounds {secs:.2f} s), algbw "
                     f"{n * 4 / ms / 1e6:.2f} GB/s, DCN bytes a member {wire} "
                     f"(= dcn_wire_bytes), {hier.dcn_phases((t, l), codec)} DCN phases")
        del xs, outs, errs, req, err
        torch.cuda.empty_cache()
    return lines


def run_hier_config5(torch, np, get_env, launches, reset_launches, composed):
    """(u3): config 5 with int8 forced onto hier on the 2x4 world, cuDNN's
    deterministic convolutions. A flat int8 step from the same state (its
    loss run 7's first, bit for bit), then 3 host-path hier steps: losses
    finite and falling; each layer's first-step reduced gradient no farther
    from the exact rank sum than the flat run's plus one quantization step
    of the layer (amax/127). The compiled overlap engine with hier units,
    captured as one CUDA graph, against the host run bit for bit. One
    hier-routed set demoted through ``demote_codec``: its residual (each
    member's 1/L shard) added once at the member's logical offset, in
    float32, to the next round, which equals the twin wire on that payload;
    the round after carries no flush. -> (launches by sub-run, log lines)."""
    from mlsl_tpu_torch.comm.algos import hier

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    lines, used = [], {}
    env = reinit(get_env)
    settle(torch)
    trainer, batch = build_resnet_trainer(torch, env, np)
    loss = trainer.step(batch).detach().reshape(-1).cpu()
    check(torch.equal(loss, composed["losses"][0]),
          f"hier config 5: the flat step's losses {loss.tolist()} are not run 7's first")
    flat = {nm: _grad_req(trainer, nm)._result[:, :1].clone() for nm in trainer.layers}
    del trainer, batch

    env = reinit(get_env, MLSL_ALGO="hier", MLSL_MESH_TIERS="2x4")
    settle(torch)
    trainer, batch = build_resnet_trainer(torch, env, np)
    algos_seen = {_grad_req(trainer, nm).algo for nm in trainer.layers}
    check(algos_seen == {"hier"}, f"hier config 5: requests took {algos_seen}")
    reset_launches()
    losses, secs, kept = codec_steps(torch, trainer, batch, steps=3, keep=(0,))
    used["hier_config5"] = {k: v for k, v in launches().items() if v}
    means = [float(v.mean()) for v in losses]
    check(means[2] < means[0], f"hier config 5: losses {means} do not fall")
    worst = {}
    for nm in trainer.layers:
        g0, _, r0 = kept[0][nm]
        exact = g0.double().sum(dim=1, keepdim=True)
        err_h = float((r0[:, :1].double() - exact).abs().max())
        err_f = float((flat[nm].double() - exact).abs().max())
        step = float(exact.abs().max()) / 127.0
        check(err_h <= err_f + step, f"hier config 5: layer {nm} off the exact sum by {err_h:.3g}"
                                     f", the flat run by {err_f:.3g}, one step {step:.3g}")
        worst[nm] = round(err_h / step, 4), round(err_f / step, 4)
    ref = host_reference(torch, trainer, losses, secs)
    lines.append(f"# hier config5 (2x4, int8 on the DCN hop): losses {means}, step seconds "
                 f"{[round(v, 4) for v in secs]}, launches {used['hier_config5']}; each "
                 f"layer's first-step error against the exact sum in steps of amax/127 "
                 f"(hier, flat): {json.dumps(worst)}")

    # demote the fc set: its residual goes out once, at each member's offset
    req = _grad_req(trainer, "fc")
    group = req.desc.group
    held, slen = req._errs[0].clone(), req._err_lens[0]
    t, l = hier.tier_structure(group)
    req.demote_codec("smoke run (u3)")
    check(req.algo == "hier" and req._pending_flush is not None,
          f"hier demotion: {req.algo}, pending flush {req._pending_flush is not None}")
    _, grads = trainer._local_grads(batch)
    x = grads["fc"]
    n = x.shape[-1]
    a = req.start(x).wait()
    check(req._pending_flush is None, "hier demotion: the flush is still pending")
    # each member's shard at its intra-tier offset l * slen, the other
    # offsets 0 * residual (the one-hot product's signed zeros)
    placed = torch.zeros((*x.shape[:-1], l * slen), device=x.device)
    for p in range(WORLD):
        li = group.group_idx_of(p) % l
        at = group.topology.coords(p)
        for j in range(l):
            placed[at][j * slen:(j + 1) * slen] = held[at] * (1.0 if j == li else 0.0)
    twin, _ = hier.quant_body("allreduce", group, n, env.config.quant_block_elems)
    b, eb = twin(x + placed[..., :n], torch.zeros_like(held))
    check(same_bits(torch, a, b) and same_bits(torch, req._errs[0], eb),
          "hier demotion: the flush round differs from the twin on the flushed payload")
    a2 = req.start(x).wait()
    b2, _ = twin(x, eb)
    check(same_bits(torch, a2, b2), "hier demotion: the round after the flush flushed again")
    lines.append(f"# hier demotion: fc demoted, its {slen}-float shard residuals flushed once "
                 f"at their logical offsets (L = {l}), then rounds bit for bit the twin's")
    del trainer, batch, grads, x, a, b, a2, b2, placed, held, kept, flat
    settle(torch)

    eng = dict(overlap_compiled=True)
    used["engine_hier"], out, _ = twin_run(
        torch, np, get_env, launches, reset_launches, "engine hier",
        {"MLSL_ALGO": "hier", "MLSL_MESH_TIERS": "2x4"}, None, eng, ref,
        lambda c, p: not any(c.values()) and p.quant_units == 18
        and {u.algo for u in p.units} == {"hier"} and all(u.nphases == 3 for u in p.units))
    check(out["loss_gap"] == 0.0 and out["param_gap"] == 0.0,
          f"engine hier: not bit for bit the host run ({out['loss_gap']}, {out['param_gap']})")
    out.pop("describe", None)
    lines.append(f"# engine hier: {json.dumps(out)}")
    torch.backends.cudnn.deterministic = False
    return used, lines


def run_tuned(torch, np, get_env, launches, reset_launches):
    """(v): MLSL_TUNE=1 MLSL_TUNE_QUANT=1 at Environment.init over the 2x4
    world at TUNE_SIZES, the profile written to TUNE_PROFILE; then a fresh
    Environment on it takes 2 config 5 steps, each gradient request (or its
    bucket's) on the lowering the profile's quantized cell names; a flat
    world rejects the profile with a warning. -> (launches of the sweep and
    of the steps, log lines)."""
    import logging

    from mlsl_tpu_torch.comm import algos
    from mlsl_tpu_torch.types import CompressionType

    TUNE_PROFILE.parent.mkdir(parents=True, exist_ok=True)
    if TUNE_PROFILE.exists():
        TUNE_PROFILE.unlink()
    lines, used = [], {}
    settle(torch)
    reset_launches()
    t0 = time.perf_counter()
    env = reinit(get_env, MLSL_TUNE="1", MLSL_TUNE_QUANT="1", MLSL_TUNE_SIZES=TUNE_SIZES,
                 MLSL_TUNE_PROFILE=str(TUNE_PROFILE), MLSL_MESH_TIERS="2x4")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    used["sweep"] = {k: v for k, v in launches().items() if v}
    prof = env.config.tuned_profile
    check(prof is not None and TUNE_PROFILE.exists(), "sweep: no profile written")
    check(prof.fingerprint["tiers"] == [2, 4], f"sweep: fingerprint {prof.fingerprint}")
    for key in ("dense_ring", "quant_ring", "quantize_blocks", "rhd_allreduce", "a2a_quant"):
        check(used["sweep"].get(key, 0) > 0, f"sweep: {key} never launched ({used['sweep']})")
    for c in prof.cells:
        check("lax" in c["us"] and c["algo"] == min(c["us"], key=c["us"].get),
              f"sweep: cell {c}")
        lines.append(f"# tune cell {c['kind']} {c['shape']} {c['compression']} "
                     f"{c['payload_bytes']} B -> {c['algo']} {json.dumps(c['us'])}")
    check(any("hier" in c["us"] for c in prof.cells if c["compression"] == "quantization"),
          "sweep: no quantized hier cell")
    lines.append(f"# tune knobs {json.dumps(prof.knobs, sort_keys=True)}")
    lines.append(f"# tune sweep: {len(prof.cells)} cells in {sweep_s:.1f} s (Environment.init "
                 f"included), launches {used['sweep']}, profile {TUNE_PROFILE.name}")

    env = reinit(get_env, MLSL_TUNE_PROFILE=str(TUNE_PROFILE), MLSL_MESH_TIERS="2x4")
    check(env.config.tuned_profile is not None, "tuned: the fresh Environment rejected it")
    settle(torch)
    trainer, batch = build_resnet_trainer(torch, env, np)
    reset_launches()
    losses, secs = drive_steps(torch, trainer, batch, steps=2)
    used["tuned_config5"] = {k: v for k, v in launches().items() if v}
    for loss in losses:
        check(bool(torch.isfinite(loss).all()), f"tuned config 5: losses {loss.tolist()}")
    picked = {}
    for nm in trainer.layers:
        ps = trainer.ops[nm].get_parameter_set(0)
        req = ps.bucket.req if ps.bucket is not None else ps.grad_req
        cell = env.config.tuned_profile.select("allreduce", algos.group_shape(req.desc.group),
                                               CompressionType.QUANTIZATION, req._payload)
        want = {"hier": "hier", "pallas_ring": "pallas_ring"}.get(cell, "quant_ring")
        check(req.algo == want, f"tuned config 5: layer {nm} took {req.algo!r}, the profile's "
                                f"cell {cell!r} for {req._payload} B")
        picked[req.algo] = picked.get(req.algo, 0) + 1
    lines.append(f"# tuned config5 (fresh Environment on the profile): losses "
                 f"{[float(v.mean()) for v in losses]}, step seconds "
                 f"{[round(v, 4) for v in secs]}, layers by lowering {picked}, knobs applied: "
                 f"quant_block_elems {env.config.quant_block_elems}, grad_bucket_mb "
                 f"{env.config.grad_bucket_mb}, overlap_stages {env.config.overlap_stages}, "
                 f"launches {used['tuned_config5']}")
    del trainer, batch

    class Catch(logging.Handler):
        def __init__(self):
            super().__init__()
            self.seen = []

        def emit(self, record):
            self.seen.append(record.getMessage())

    catch = Catch()
    logging.getLogger("mlsl_tpu_torch").addHandler(catch)
    try:
        env = reinit(get_env, MLSL_TUNE_PROFILE=str(TUNE_PROFILE))
    finally:
        logging.getLogger("mlsl_tpu_torch").removeHandler(catch)
    check(env.config.tuned_profile is None
          and any("different topology" in m for m in catch.seen),
          "tuned: a flat world did not reject the 2x4 profile with a warning")
    lines.append("# tuned flat world: the 2x4 profile rejected with a warning")
    settle(torch)
    return used, lines


# -- the device feed (run (w)) and the pipeline schedules (run (x)) ------------------

# run (w): config 5 (ResNet-50, 224 x 224 x 3 NHWC, 1000 classes, global batch 64 on
# 8 data ranks) fed through trainer.feed: 2 epochs of FEED_BATCHES batches
FEED_BATCHES = 4
FEED_EPOCHS = 2
FEED_IMAGE, FEED_CLASSES, FEED_BATCH = 224, 1000, 64
FEED_LR = 0.01                # 8 steps on 4 random-label batches: below config 5's 0.05
FEED_CACHE_MB = 64            # holds an epoch of uint8 (4 x 9.6 MB) or int8 wire
# ImageNet's channel mean and std, in 0-255 pixel units
FEED_MEAN = (123.675, 116.28, 103.53)
FEED_STD = (58.395, 57.12, 57.375)


class FeedProbe:
    """Records, while it is installed, every batch FeedCodec stages (its wire
    batch with its copy events, wire and full bytes) and the CUDA events
    around every decode. Installed on the class, so that the codec
    ``trainer.feed`` builds is the one probed."""

    def __init__(self, torch):
        from mlsl_tpu_torch.data.wire import FeedCodec

        self.staged, self.decodes = [], []
        self._cls = FeedCodec
        self._stage, self._decode = FeedCodec.stage, FeedCodec.decode
        probe = self

        def stage(codec, host_batch, corrupt=False):
            out = probe._stage(codec, host_batch, corrupt)
            probe.staged.append(out)
            return out

        def decode(codec, wire_batch, donate=False):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = probe._decode(codec, wire_batch, donate)
            e.record()
            probe.decodes.append((s, e))
            return out

        FeedCodec.stage, FeedCodec.decode = stage, decode

    def remove(self):
        self._cls.stage, self._cls.decode = self._stage, self._decode

    def copy_ms(self):
        return [w.copy_ms() for w, _, _ in self.staged]

    def decode_ms(self):
        return [s.elapsed_time(e) for s, e in self.decodes]


def feed_batches(np, kind, seed):
    """FEED_BATCHES host batches of config 5's shape from ``seed``: raw uint8
    pixels or float32 normal images, int32 labels."""
    rng = np.random.default_rng(seed)
    shape = (FEED_BATCH, FEED_IMAGE, FEED_IMAGE, 3)
    out = []
    for _ in range(FEED_BATCHES):
        if kind == "uint8":
            x = rng.integers(0, 256, size=shape, dtype=np.uint8)
        else:
            x = rng.normal(size=shape).astype(np.float32)
        out.append((x, rng.integers(0, FEED_CLASSES, size=(FEED_BATCH,)).astype(np.int32)))
    return out


def feed_b2_rows(block):
    """B2's rows for one decoded config 5 batch on the int8 wire: each of the 8
    shards padded to whole block x ROW_TILE units (data/wire.py)."""
    from mlsl_tpu_torch.data.wire import ROW_TILE

    n = FEED_BATCH // WORLD * FEED_IMAGE * FEED_IMAGE * 3
    unit = block * ROW_TILE
    return WORLD * (-(-n // unit) * unit) // block


def feed_trainer(torch, env, np):
    """Config 5's int8 trainer at run (w)'s sizes and FEED_LR (its own batch
    dropped)."""
    trainer, _ = build_resnet_trainer(torch, env, np, image=FEED_IMAGE,
                                      classes=FEED_CLASSES, batch=FEED_BATCH)
    trainer.lr = FEED_LR
    return trainer


def fed_steps(torch, trainer, loader):
    """Step ``trainer`` on every batch ``loader`` yields. -> (per-rank losses,
    step seconds, the loader's stall and producer-wait ms after each batch,
    the decoded batches' first leaf of batch 0 on the host)."""
    losses, secs, waits, first = [], [], [], None
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            batch = next(loader)
        except StopIteration:
            break
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        st = loader.stats()
        waits.append((st["stall_ms"], st["producer_wait_ms"]))
        losses.append(loss.detach().reshape(-1).cpu())
        if first is None:
            first = batch[0][:, :, 0, 0].cpu()
    return losses, secs, waits, first


def feed_lines(tag, probe, secs, waits, twin_secs=None):
    """One line a fed batch: staged wire and full bytes, the copy and the
    decode on the card, the loader's stall and producer wait (cumulative),
    the step seconds (fed, and shard_batch's where there is a twin)."""
    copies, decodes = probe.copy_ms(), probe.decode_ms()
    lines = []
    for i, s in enumerate(secs):
        row = {"batch": i, "step_s": s, "stall_ms": waits[i][0],
               "producer_wait_ms": waits[i][1], "decode_ms": decodes[i]}
        if i < len(probe.staged):
            _, wb, fb = probe.staged[i]
            row.update(wire_bytes=wb, full_bytes=fb, h2d_ms=copies[i])
        else:
            row["cache_hit"] = True
        if twin_secs and i < len(twin_secs):
            row["shard_batch_step_s"] = twin_secs[i]
        lines.append(f"# feed {tag} {json.dumps(row)}")
    return lines


def run_feed(torch, np, get_env, launches, reset_launches):
    """Run (w): config 5 fed through trainer.feed, 2 epochs of 4 batches.

    (w1) raw uint8 images normalized by ImageNet's mean and std on the
    card, cache for the epoch: the first decoded batch bit for bit the host's
    float32 math; the first 3 losses bit for bit those of the same trainer fed
    by shard_batch on the host-decoded batches (cuDNN deterministic, as
    (h)-(k)); epoch 2 stages nothing, every read a cache hit.
    (w2) float32 images on the int8 wire: B2 once a decoded batch; the
    decoded batch bit for bit dequantize_blocks_ref of the numpy encode;
    wire bytes as the layout gives them.
    (w3) (w1)'s feed at depth 2 into the compiled overlap engine
    (MLSL_OVERLAP_COMPILED=1), the step captured while the loader's worker,
    slowed to one batch a quarter second, stages the next batches (it holds
    off the card for the capture): its first 3 losses within the twin
    tolerances of (w1)'s.
    -> ({run: launches}, lines)."""
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.data.wire import ROW_TILE, _encode_int8
    from mlsl_tpu_torch.ops import quant_kernels as qk

    lines, used = [], {}
    n_dec = FEED_BATCHES * FEED_EPOCHS
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    probe = FeedProbe(torch)
    try:
        # (w1)
        t0 = time.perf_counter()
        env = reinit(get_env)
        settle(torch)
        raw = feed_batches(np, "uint8", SEED + 30)
        mean, std = np.array(FEED_MEAN, np.float32), np.array(FEED_STD, np.float32)
        trainer = feed_trainer(torch, env, np)
        stats.reset_feed_counters()
        reset_launches()
        loader = trainer.feed(lambda: iter(raw), wire="uint8", normalize=(mean, std),
                              cache_mb=FEED_CACHE_MB, epochs=FEED_EPOCHS, depth=2)
        losses, secs, waits, first = fed_steps(torch, trainer, loader)
        loader.close()
        used["feed_uint8"] = launches()
        fc = dict(stats.FEED_COUNTERS)
        check(len(losses) == n_dec, f"feed uint8: {len(losses)} steps, not {n_dec}")
        host = [((x.astype(np.float32) - mean) * (np.float32(1.0) / std), y) for x, y in raw]
        check(np.array_equal(first.numpy().reshape(host[0][0].shape).view(np.uint32),
                             host[0][0].view(np.uint32)),
              "feed uint8: the first decoded batch differs from the host float32 math")
        per_batch = probe.staged[0][1]
        check(fc["batches_staged"] == FEED_BATCHES and fc["cache_hits"] == FEED_BATCHES
              and fc["cache_misses"] == FEED_BATCHES
              and fc["wire_bytes"] == FEED_BATCHES * per_batch,
              f"feed uint8: epoch 2 staged or missed: {fc}")
        del trainer
        settle(torch)
        twin = feed_trainer(torch, env, np)
        twin_losses, twin_secs = [], []
        for x, y in host[:3]:
            batch = twin.shard_batch(x, y)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = twin.step(batch)
            torch.cuda.synchronize()
            twin_secs.append(time.perf_counter() - t1)
            twin_losses.append(loss.detach().reshape(-1).cpu())
        check(all(same_bits(torch, a, b) for a, b in zip(losses[:3], twin_losses)),
              f"feed uint8: losses {[float(v.mean()) for v in losses[:3]]} differ from "
              f"shard_batch's {[float(v.mean()) for v in twin_losses]}")
        del twin
        lines += feed_lines("uint8", probe, secs, waits, twin_secs)
        w1 = {"losses": [float(v.mean()) for v in losses], "feed": fc,
              "wire_bytes_a_batch": per_batch, "full_bytes_a_batch": probe.staged[0][2],
              "step_s": secs, "shard_batch_step_s": twin_secs, "launches": used["feed_uint8"],
              "run_s": time.perf_counter() - t0}
        lines.append(f"# phase feed uint8 (run (w1)): ok, {json.dumps(w1)}")
        w1_losses = losses

        # (w2)
        probe.staged.clear()
        probe.decodes.clear()
        t0 = time.perf_counter()
        settle(torch)
        floats = feed_batches(np, "float32", SEED + 31)
        trainer = feed_trainer(torch, env, np)
        block = env.config.quant_block_elems
        stats.reset_feed_counters()
        reset_launches()
        loader = trainer.feed(floats, wire="int8", cache_mb=FEED_CACHE_MB,
                              epochs=FEED_EPOCHS, depth=2)
        losses, secs, waits, first = fed_steps(torch, trainer, loader)
        loader.close()
        used["feed"] = launches()
        check(used["feed"]["dequantize_blocks"] == n_dec,
              f"feed int8: B2 launched {used['feed']['dequantize_blocks']} times for "
              f"{n_dec} decoded batches (predicted one a batch)")
        check(all(bool(torch.isfinite(v).all()) for v in losses),
              f"feed int8: losses {[v.tolist() for v in losses]}")
        x0 = floats[0][0]
        local = FEED_BATCH // WORLD
        n = local * FEED_IMAGE * FEED_IMAGE * 3
        want = []
        for d in range(WORLD):
            q, s = _encode_int8(x0[d * local:(d + 1) * local], block)
            want.append(qk.dequantize_blocks_ref(torch.from_numpy(q).reshape(-1, block),
                                                 torch.from_numpy(s)).reshape(-1)[:n])
        check(same_bits(torch, first.reshape(WORLD, n), torch.stack(want)),
              "feed int8: the decoded batch differs from dequantize_blocks_ref")
        unit = block * ROW_TILE
        npad = -(-n // unit) * unit
        wire_want = WORLD * (npad + npad // block * 4) + FEED_BATCH * 4
        full_want = FEED_BATCH * (FEED_IMAGE * FEED_IMAGE * 3 * 4 + 4)
        _, wb, fb = probe.staged[0]
        check((wb, fb) == (wire_want, full_want),
              f"feed int8: wire {wb} and full {fb} bytes, the layout gives {wire_want} and "
              f"{full_want}")
        lines += feed_lines("int8", probe, secs, waits)
        w2 = {"losses": [float(v.mean()) for v in losses], "feed": dict(stats.FEED_COUNTERS),
              "wire_bytes_a_batch": wb, "full_bytes_a_batch": fb, "wire_share": wb / fb,
              "b2_launches": used["feed"]["dequantize_blocks"], "step_s": secs,
              "launches": used["feed"], "run_s": time.perf_counter() - t0}
        lines.append(f"# phase feed int8 (run (w2)): ok, {json.dumps(w2)}")
        del trainer

        # (w3)
        probe.staged.clear()
        probe.decodes.clear()
        t0 = time.perf_counter()
        os.environ["MLSL_OVERLAP_COMPILED"] = "1"
        env = reinit(get_env)
        settle(torch)
        trainer = feed_trainer(torch, env, np)
        engine = trainer._overlap
        check(engine is not None, "feed engine: the compiled overlap engine did not engage")

        def slow():
            for i, b in enumerate(raw):
                if i:
                    time.sleep(0.25)   # the worker is busy while the step is captured
                yield b

        stats.reset_feed_counters()
        reset_launches()
        loader = trainer.feed(slow, wire="uint8", normalize=(mean, std),
                              cache_mb=FEED_CACHE_MB, epochs=FEED_EPOCHS, depth=2)
        batch = next(loader)
        t1 = time.perf_counter()
        trainer.precompile(batch)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t1
        staged_in_capture = len(probe.staged)
        losses = [trainer.step(batch).detach().reshape(-1).cpu()]
        more, secs, waits, _ = fed_steps(torch, trainer, loader)
        loader.close()
        losses += more
        used["feed_engine"] = launches()
        check(list(engine.graphs) == ["step"] and len(losses) == n_dec,
              f"feed engine: graphs {list(engine.graphs)}, {len(losses)} steps")
        gap = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(losses[:3],
                                                                          w1_losses[:3]))
        check(gap <= TWIN_LOSS_RTOL, f"feed engine: loss gap {gap:.3g} to run (w1)")
        w3 = {"losses": [float(v.mean()) for v in losses], "loss_gap_to_w1": gap,
              "capture_s": capture_s, "batches_staged_by_capture_end": staged_in_capture,
              "launches_one_captured_step": engine.capture_launches["step"],
              "step_s": secs, "launches": used["feed_engine"],
              "run_s": time.perf_counter() - t0}
        lines += feed_lines("engine", probe, [None] + secs, [(0.0, 0.0)] + waits)
        lines.append(f"# phase feed engine (run (w3)): ok, {json.dumps(w3)}")
        del trainer, engine, batch
    finally:
        probe.remove()
        os.environ.pop("MLSL_OVERLAP_COMPILED", None)
        torch.backends.cudnn.deterministic = False
    settle(torch)
    return used, lines


# run (x): the pipeline schedules at gpt-medium-2k's FFN widths (d_model 1,024,
# d_ff 4,096, models/transformer.py:121-122) and its 12 blocks, each the residual
# MLP x + gelu(x W1 + b1) W2 + b2 in float32, on a (2 data x 4 model) grid of 8
# virtual ranks: 4 stages of 3 blocks; a data shard holds 8 microbatches of 1,024
# tokens (batch 8 x seq 2,048 = 16,384 tokens over the 2 data shards); the loss
# head is the mean squared error against a seeded target
PIPE_BLOCKS, PIPE_DMODEL, PIPE_DFF = 12, 1024, 4096
PIPE_STAGES, PIPE_DATA, PIPE_MICRO, PIPE_TOKENS = 4, 2, 8, 1024
PIPE_CHUNKS = 3
# Float32 sums over 1,024 tokens and 16 microbatches taken in another order (a
# microbatch's product, the microbatches accumulated tick by tick, against one
# product over 8,192 tokens) differ by about sqrt(16,384) x 2^-24 = 7.6e-6 of a
# sum's magnitude; 12 chained blocks can grow that about tenfold: losses within
# 1e-5 relative, gradients within 1e-4 relative L2 of each other and the oracle
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD_TOL = 1e-4
PIPE_LEAVES = ("w1", "b1", "w2", "b2")


def pipe_stage(torch):
    gelu = torch.nn.functional.gelu

    def stage(p, x):
        for j in range(p["w1"].shape[0]):
            x = x + gelu(x @ p["w1"][j] + p["b1"][j]) @ p["w2"][j] + p["b2"][j]
        return x

    return stage


def pipe_loss_head(y, t):
    return ((y - t) ** 2).mean()


def pipe_rel(torch, a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def run_pipeline(torch, np, launches, reset_launches, dev):
    """Run (x): GPipe (remat off and on), 1F1B and interleaved 1F1B (3 chunks
    of 1 block) on the same 12 blocks against a dense oracle (the 12 blocks in
    sequence on each data shard); then reduce_microbatch_grads over the data
    group on B3, B5 and int8 (B1 + B4), each bit for bit its plain version,
    and inline_allreduce forced to B3 and B5. -> (launches of the reduction
    phase, lines)."""
    from mlsl_tpu_torch.comm import algos, overlap
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
    from mlsl_tpu_torch.config import Config
    from mlsl_tpu_torch.parallel import pipeline as pp
    from mlsl_tpu_torch.types import CompressionType

    S, V, M, T = PIPE_STAGES, PIPE_CHUNKS, PIPE_MICRO, PIPE_TOKENS
    nb, dm, df = PIPE_BLOCKS, PIPE_DMODEL, PIPE_DFF
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    blocks = {"w1": torch.randn((nb, dm, df), generator=gen, device=dev) / dm ** 0.5,
              "b1": torch.randn((nb, df), generator=gen, device=dev) * 0.02,
              "w2": torch.randn((nb, df, dm), generator=gen, device=dev) * 0.5 / df ** 0.5,
              "b2": torch.randn((nb, dm), generator=gen, device=dev) * 0.02}
    x = torch.randn((PIPE_DATA, M, T, dm), generator=gen, device=dev)
    tgt = torch.randn((PIPE_DATA, M, T, dm), generator=gen, device=dev)
    stage = pipe_stage(torch)
    lines, out = [], {}
    # the first torch.utils.checkpoint call of a process imports torch._dynamo
    # (6.3 s for GPipe with remat on the card in a process that had not run
    # it): pay that before anything is timed
    torch.utils.checkpoint.checkpoint(torch.sin, torch.ones(1, device=dev, requires_grad=True),
                                      use_reentrant=False).sum().backward()

    def timed(fn):
        settle(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 2**30

    # the dense oracle: the 12 blocks in sequence on each data shard
    def oracle():
        p = {k: v.clone().requires_grad_() for k, v in blocks.items()}
        total, grads = 0.0, None
        for d in range(PIPE_DATA):
            y = stage(p, x[d].reshape(M * T, dm)).reshape(M, T, dm)
            loss = ((y - tgt[d]) ** 2).mean(dim=(1, 2)).sum()
            g = torch.autograd.grad(loss, list(p.values()))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            total = total + float(loss.detach())
        return total, dict(zip(p, grads))

    (o_loss, o_grads), o_s, o_peak = timed(oracle)
    grid = (1, PIPE_DATA, 1, S)
    xs = x.reshape(1, PIPE_DATA, 1, 1, M, T, dm).expand(*grid, M, T, dm)
    ts = tgt.reshape(1, PIPE_DATA, 1, 1, M, T, dm).expand(*grid, M, T, dm)
    # stage s holds blocks 3s..3s+2, the same weights on both data ranks
    stage_params = {k: v.reshape(1, 1, 1, S, nb // S, *v.shape[1:]) for k, v in blocks.items()}

    def stage_grads(g):
        """(data, 4, 3, ...) rank gradients -> (12, ...) block gradients."""
        return g.sum(dim=0).reshape(nb, *g.shape[3:])

    def check_run(tag, loss, grads):
        rel_loss = abs(loss - o_loss) / abs(o_loss)
        rel = {k: pipe_rel(torch, grads[k], o_grads[k]) for k in PIPE_LEAVES}
        check(rel_loss <= PIPE_LOSS_RTOL and max(rel.values()) <= PIPE_GRAD_TOL,
              f"pipeline {tag}: loss {loss} against the oracle's {o_loss} "
              f"(rel {rel_loss:.3g}), gradient rel. L2 {rel}")
        return rel_loss, max(rel.values())

    for remat in (False, True):
        def gpipe():
            p = {k: v.clone().requires_grad_() for k, v in stage_params.items()}
            loss = pp.pipeline_loss(stage, pipe_loss_head, p, xs, ts, 3, S, remat=remat)
            objective = loss[0, :, 0, 0].sum()
            g = torch.autograd.grad(objective, list(p.values()))
            return float(objective.detach()), {k: gk.reshape(nb, *gk.shape[5:]) for k, gk in zip(p, g)}

        (loss, grads), secs, peak = timed(gpipe)
        tag = f"gpipe{' remat' if remat else ''}"
        out[tag] = {"loss": loss, "step_s": secs, "peak_gib": peak,
                    "bubble": (S - 1) / (M + S - 1),
                    "gaps": check_run(tag, loss, grads)}
        del grads
    gpipe_peak = out["gpipe"]["peak_gib"]

    def f1b():
        return pp.one_f1b_step(stage, pipe_loss_head, stage_params, xs, ts, 3, S)

    (loss, f1b_grads), secs, peak = timed(f1b)
    total = float(loss[0, :, 0, 0].sum())
    grads = {k: stage_grads(g[0, :, 0]) for k, g in f1b_grads.items()}
    out["1f1b"] = {"loss": total, "step_s": secs, "peak_gib": peak,
                   "bubble": pp.f1b_schedule(S, M)["bubble_fraction"],
                   "gaps": check_run("1f1b", total, grads)}
    check(peak < gpipe_peak, f"pipeline: 1F1B's peak {peak:.3f} GiB is not below GPipe's "
                             f"{gpipe_peak:.3f} GiB without remat")
    del grads

    # interleaved: global stage k = c * S + d holds block k
    chunk_params = {k: v.reshape(V, 1, 1, 1, S, 1, *v.shape[1:]) for k, v in blocks.items()}

    def inter():
        return pp.interleaved_1f1b_step(stage, pipe_loss_head, chunk_params, xs, ts, 3, S, V)

    (loss, ig), secs, peak = timed(inter)
    total = float(loss[0, :, 0, 0].sum())
    grads = {k: g[:, 0, :, 0].sum(dim=1).reshape(nb, *g.shape[6:]) for k, g in ig.items()}
    out["interleaved"] = {"loss": total, "step_s": secs, "peak_gib": peak,
                          "bubble": pp.interleaved_schedule(S, V, M)["bubble_fraction"],
                          "gaps": check_run("interleaved", total, grads)}
    del ig, grads
    out["oracle"] = {"loss": o_loss, "step_s": o_s, "peak_gib": o_peak}
    for tag, row in out.items():
        lines.append(f"# pipeline {tag} {json.dumps(row)}")

    # (x4) the data-parallel reduction of 1F1B's stage gradients
    group = ProcessGroup(Topology(PIPE_DATA, S, WORLD), ("data",))
    bufs = [f1b_grads[k].reshape(*grid, -1).contiguous() for k in PIPE_LEAVES]
    counts = [b.shape[-1] for b in bufs]
    used = {}
    for route, forced, comp in (("B3", "pallas_ring", CompressionType.NONE),
                                ("B5", "pallas_rhd", CompressionType.NONE),
                                ("B1 + B4", "pallas_ring", CompressionType.QUANTIZATION)):
        cfg = Config()
        cfg.collective_algo = forced
        cfg.validate()
        quant = comp == CompressionType.QUANTIZATION
        fn, plan = pp.reduce_microbatch_grads(group, counts, config=cfg, compression=comp)
        ref, _ = overlap.build_multi_reduce(group, counts, compression=comp, config=cfg,
                                            plain=True)
        want_launch = ({"quantize_blocks": len(plan.units), "quant_ring": len(plan.units)}
                       if quant else
                       {"dense_ring" if forced == "pallas_ring" else "rhd_allreduce":
                        len(plan.units)})
        check({u.algo for u in plan.units} == {forced},
              f"pipeline reduce {route}: units took {plan.algos_summary()}")
        reset_launches()
        got = fn(bufs)
        torch.cuda.synchronize()
        n_launch = {k: v for k, v in launches().items() if v}
        check(n_launch == want_launch, f"pipeline reduce {route}: launches {n_launch}, the "
                                       f"plan predicts {want_launch}")
        want = ref(bufs)
        outs = got[0] if quant else got
        wants = want[0] if quant else want
        check(all(same_bits(torch, a, b) for a, b in zip(outs, wants)),
              f"pipeline reduce {route}: differs from its plain version")
        if quant:
            check(all(same_bits(torch, got[1][k], want[1][k]) for k in got[1]),
                  f"pipeline reduce {route}: residuals differ from the plain ring's")
        for i, k in enumerate(PIPE_LEAVES):
            r = outs[i]
            check(same_bits(torch, r[0, 0], r[0, 1]), f"pipeline reduce {route}: the data "
                                                      f"ranks disagree on {k}")
            rel = pipe_rel(torch, r[0, 0, 0].reshape(nb, *o_grads[k].shape[1:]), o_grads[k])
            check(rel <= (PIPE_GRAD_TOL if not quant else 0.02),
                  f"pipeline reduce {route}: {k} rel. L2 {rel:.3g} from the oracle")
        for k, v in n_launch.items():
            used[k] = used.get(k, 0) + v
        ms = time_ms(torch, lambda: fn(bufs), reps=5, warmup=1)
        lines.append(f"# pipeline reduce {route} ({forced}{', int8' if quant else ''}): "
                     f"{len(plan.units)} units, launches {n_launch} (predicted "
                     f"{want_launch}), {ms:.4f} ms a call, bit for bit the plain version")
        del got, want, outs, wants
    # inline_allreduce with a group and a config forced to each kernel
    per_rank = torch.randn((*grid, 1), generator=gen, device=dev)
    for forced, key in (("pallas_ring", "dense_ring"), ("pallas_rhd", "rhd_allreduce")):
        cfg = Config()
        cfg.collective_algo = forced
        cfg.validate()
        reset_launches()
        r = algos.inline_allreduce(per_rank, 1, group=group, config=cfg)
        torch.cuda.synchronize()
        n_launch = {k: v for k, v in launches().items() if v}
        check(n_launch == {key: 1}, f"inline_allreduce {forced}: launches {n_launch}")
        check(pipe_rel(torch, r, per_rank.sum(dim=1, keepdim=True).expand_as(per_rank)) < 1e-6,
              f"inline_allreduce {forced}: wrong sum")
        used[key] = used.get(key, 0) + 1
    lines.append(f"# phase pipeline (run (x)): ok, launches {json.dumps(used)}")
    del bufs, f1b_grads, blocks, x, tgt
    settle(torch)
    return used, lines


# -- run (y): decode mode and the serving engine ------------------------------------

# gpt-medium-2k served at its full width and depth (models/transformer.GPT_MEDIUM_2K,
# bf16 compute), weights from init_params with torch.Generator seed SEED
SERVE_BATCH = 4             # MLSL_SERVE_MAX_BATCH of (y1)-(y5b)
SERVE_KV_MB = 4096          # MLSL_SERVE_KV_CACHE_MB: 2,730 float32 pages of 1.5 MiB
SERVE_LOAD = 240            # (y1)'s requests, arriving as a Poisson stream ...
SERVE_RATE = 12.0           # ... of this many a second (SEED): about 60 % of 4 slots
SERVE_REQUESTS = 8          # (y2)-(y5b): the first 8 of them, submitted at once
SERVE_NEW = 32
SERVE_PROMPT = (64, 1024)   # prompt lengths, uniform, from SEED; ids in 1..vocab-1
SERVE_ORACLE = {"y1": 8, "y2": 4, "y3": 2, "y4": 8, "y5a": 2, "y5b": 2}   # held to the oracle
SERVE_JAX_RULE = 4          # (y4) requests counted against the oracle's own stream
# The card's oracle rule (serve/checks.oracle_rule): the unpaged oracle runs on
# the engine's own token stream, and at every step each logit the engine
# picked from lies within SERVE_DELTA of the oracle's (SERVE_INT8_DELTA with
# int8 KV, whose dequantized K and V are up to amax/254 off). cuBLAS sums the
# prefill's 2,048-row products in another order than the decode step's few-row
# ones (and rounds the bf16 QKV and MLP products after them), so paged and
# unpaged logits differ in their last bits; where the engine's token is not
# the oracle's top one, the oracle's margin is at most twice the bound. The
# float32-compute model of (y5b) is held to SERVE_F32_DELTA, over its own
# float32 noise; every planted fault of SERVE_FAULTS must fail that rule at
# this width, and the first two the bf16 rule of (y1) as well (a lost write of
# the last block moves the logits less than bf16's own noise). Measured on an
# H100 (PERF.md).
SERVE_DELTA = 0.05          # largest seen on an H100: 0.0346 (y1-y3, 14 requests)
SERVE_INT8_DELTA = 0.07     # largest seen on an H100: 0.0350 (y4, 8 requests)
SERVE_F32_DELTA = 1e-4      # largest seen on an H100: 6.4e-6; the faults 1.8e-3 and up
SERVE_FAULTS = ("position+1", "drop_kv:0", "drop_kv:11")
SERVE_EVICT_MB = 194        # (y5a): 129 float32 pages, one full sequence plus one
SERVE_EVICT_PROMPT = 1000
SERVE_EVICT_NEW = 48
SERVE_STATS_DIR = ROOT / "build" / "mlsl_tpu_torch" / "serve_stats"


def serve_prompts(np, vocab, n=SERVE_LOAD, seed=SEED):
    """``n`` prompts, lengths uniform in SERVE_PROMPT, from ``seed``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, size=n)
    return [rng.integers(1, vocab, size=int(k)).astype(np.int32) for k in sizes]


def serve_kernel_mods():
    from mlsl_tpu_torch.ops import (a2a_kernels, attention_kernels, quant_kernels,
                                    rhd_kernels, ring_kernels)

    return (quant_kernels, ring_kernels, rhd_kernels, a2a_kernels, attention_kernels)


def serve_oracle(eng, reqs, probe, delta, tag):
    """The card's oracle rule (SERVE_DELTA above) on each of ``reqs``. ->
    their records."""
    from mlsl_tpu_torch.serve import checks

    recs = []
    for r in reqs:
        rec = checks.oracle_rule(eng, r, probe.logits[r.id], delta)
        check(rec["ok"], f"serve {tag}: request {r.id} is {rec['max_abs_delta']:.4g} from the "
                         f"oracle's logits (bound {delta}): {rec}")
        recs.append({k: v for k, v in rec.items() if k not in ("ok", "request")})
    return recs


def serve_twin(torch, np, eng):
    """The decode graph's replay against the same step run eagerly on the
    card from the same pools (serve/checks.decode_twin): the live slots'
    logits and every pool page but the garbage page 0 bit for bit. Launches
    here are comparison launches: the counts are put back."""
    from mlsl_tpu_torch.serve import checks

    before = [(m, dict(m.LAUNCHES)) for m in serve_kernel_mods()]
    g, e, same_pools, n_live = checks.decode_twin(eng)
    torch.cuda.synchronize()
    for m, counts in before:
        m.LAUNCHES.update(counts)
    check(n_live > 0 and np.array_equal(g, e) and same_pools,
          f"serve twin: graph replay against the eager step: logits max |delta| "
          f"{float(np.abs(g - e).max()) if g.shape == e.shape else 'shape'}, pools equal "
          f"{same_pools}")
    return n_live


def serve_faults(torch, np, eng, prompts, delta, faults):
    """Each planted fault of ``faults`` (serve/checks.planted) on two
    requests of 8 new tokens, run eagerly: the oracle rule must fail it.
    Launches here are comparison launches: the counts are put back. -> the
    largest |logit delta| of each."""
    from mlsl_tpu_torch.serve import checks

    before = [(m, dict(m.LAUNCHES)) for m in serve_kernel_mods()]
    out = {}
    for fault in faults:
        probe = checks.Probe(eng)
        with checks.planted(eng, fault):
            reqs = [eng.submit(p, 8) for p in prompts[:2]]
            eng.run()
        recs = [checks.oracle_rule(eng, r, probe.logits[r.id], delta) for r in reqs]
        out[fault] = [rec["max_abs_delta"] for rec in recs]
        check(not all(rec["ok"] for rec in recs),
              f"serve faults: the oracle rule passed the planted fault {fault}: {recs}")
    torch.cuda.synchronize()
    for m, counts in before:
        m.LAUNCHES.update(counts)
    return out


def tail(np, xs):
    """A sample's count, p50, each of p90 and p99 that it supports (ten
    values or more above it) and its largest value."""
    xs = np.asarray(xs, np.float64)
    out = {"n": int(xs.size)}
    if xs.size:
        out["p50"] = float(np.percentile(xs, 50))
        for q in (90, 99):
            if xs.size * (100 - q) / 100 >= 10:
                out[f"p{q}"] = float(np.percentile(xs, q))
        out["max"] = float(xs.max())
    return out


def serve_run(torch, np, get_env, launches, reset_launches, tag, cfg, params, tp, prompts,
              new, env_vars, shed_after=None, rate=None, oracle=0):
    """One sub-run of (y): a fresh Environment of ``tp`` ranks with
    ``env_vars``, an InferenceEngine on ``params`` and every prompt submitted
    at once, then ``run()`` to idle (with ``shed_after``: ``run(max_steps=...)``,
    two force_shed calls, then ``run()``). With ``rate``, the prompts arrive
    instead as a Poisson stream of ``rate`` a second (from SEED), each
    submitted at the first scheduler step after its arrival, after one
    warm-up request has captured the decode graph (as a server warms up
    before it takes traffic). The launch counts are set to 0 just before the
    engine is built and read just after the run.
    The record: TTFT from each request's arrival; the gaps between a
    request's consecutive tokens (the inter-token latency), all of them, and
    apart those inside which a joining request's prefill ran; each request's
    time a token over its whole stream (TPOT); the decode step's own host
    time (the warm-up's steps and the capturing step left out); tokens/s
    over the run. -> (engine, requests, probe, launches, the record)."""
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.serve import InferenceEngine, checks

    env = reinit(get_env, world=tp, **env_vars)
    settle(torch)
    stats.reset_serve_counters()
    reset_launches()
    eng = InferenceEngine(env, cfg, tp=tp, params=params)
    probe = checks.Probe(eng, keep=None if shed_after else set(range(oracle)))
    if rate:
        warm = eng.submit(prompts[0], 2)
        eng.run()
        check(warm.state == "done", f"serve {tag}: the warm-up request {warm.state}")
        probe.keep = {i + warm.id + 1 for i in range(oracle)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = time.monotonic()
    first_step = len(probe.step_ms)
    if rate:
        due = start + np.cumsum(np.random.default_rng(SEED + 7).exponential(1.0 / rate,
                                                                            len(prompts)))
        reqs = []
        while True:
            now = time.monotonic()
            while len(reqs) < len(prompts) and due[len(reqs)] <= now:
                reqs.append(eng.submit(prompts[len(reqs)], new))
            if eng.step() == 0 and not eng._pending:
                if len(reqs) == len(prompts):
                    break
                time.sleep(max(0.0, min(due[len(reqs)] - time.monotonic(), 0.001)))
    else:
        due = np.full(len(prompts), start)
        reqs = [eng.submit(p, new) for p in prompts]
        if shed_after:
            eng.run(max_steps=shed_after)
            eng.governor.force_shed("chip_smoke (y5b)")
            eng.governor.force_shed("chip_smoke (y5b)")
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    used = {k: v for k, v in launches().items() if v}
    check(all(r.state == "done" and len(r.tokens) == new for r in reqs),
          f"serve {tag}: states {[r.state for r in reqs]}, tokens "
          f"{[len(r.tokens) for r in reqs]}")
    eng.cache.check()
    check(len(eng.cache) == 0, f"serve {tag}: {len(eng.cache)} sequences hold pages after the run")
    counters = dict(stats.SERVE_COUNTERS)
    ids = [r.id for r in reqs]
    gaps, stalled = probe.gaps(ids)
    gaps, stalled = np.asarray(gaps), np.asarray(stalled, bool)
    graphs = {dt: {"capture_s": c.seconds, "launches_recorded": c.launches}
              for dt, c in eng._decode_cache.items()}
    rec = {"tp": tp, "requests": len(reqs),
           "succeeded": sum(r.state == "done" for r in reqs), "new_tokens": new,
           "arrivals_per_s": rate, "prompt_tokens": int(sum(p.size for p in prompts)),
           "ttft_ms": tail(np, [(probe.stamps[i][0] - d) * 1e3 for i, d in zip(ids, due)]),
           "itl_ms": tail(np, gaps), "itl_ms_over_a_prefill": tail(np, gaps[stalled]),
           "itl_ms_no_prefill": tail(np, gaps[~stalled]),
           "tpot_ms": tail(np, [(probe.stamps[i][-1] - probe.stamps[i][0]) * 1e3
                                / (len(probe.stamps[i]) - 1) for i in ids]),
           "step_ms": tail(np, probe.step_ms[max(first_step, 1):]),
           "first_step_ms": probe.step_ms[0],
           "decode_steps": int(counters["decode_steps"]), "prefills": int(counters["prefills"]),
           "tokens_per_s": sum(len(r.tokens) for r in reqs) / wall, "wall_s": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "kv_pages": eng.cache.num_pages, "graphs": graphs, "launches": used,
           "evictions": int(counters["kv_evictions"])}
    return eng, reqs, probe, used, rec


def serve_check_launches(tag, eng, used, rec, want_graph, per_prefill):
    """The path's launches: each kernel ``want_graph`` times in the one
    decode graph (recorded once; the capture's warm-up launches as many),
    ``per_prefill`` times in each prefill and write, and nothing else."""
    dtype = eng.cfg.dtype
    check(list(eng._decode_cache) == [dtype], f"serve {tag}: graphs {list(eng._decode_cache)}")
    recorded = {k: v for k, v in eng._decode_cache[dtype].launches.items() if v}
    check(recorded == want_graph, f"serve {tag}: the decode graph recorded {recorded}, "
                                  f"expected {want_graph}")
    want = {k: 2 * want_graph.get(k, 0) + per_prefill.get(k, 0) * rec["prefills"]
            for k in set(want_graph) | set(per_prefill)}
    check(used == want, f"serve {tag}: launches {used}, expected {want} "
                        f"({rec['prefills']} prefills)")


def run_serve(torch, np, get_env, launches, reset_launches):
    """Run (y): gpt-medium-2k served through InferenceEngine -> submit -> run
    at its full width and depth. (y1) tp = 1, float32 KV; (y2) tp = 2 with
    MLSL_PALLAS_RHD=1 (B5 in the decode graph); (y3) tp = 2 with
    MLSL_ALGO=allreduce=pallas_ring (B3 in the prefill and the graph); (y4)
    tp = 1 with int8 KV (B1 at the write and in the graph, B2 in the graph);
    (y5a) eviction at a budget of one full sequence plus one page; (y5b) the
    float32-compute model with two forced sheds mid-run (the bf16 graph, a
    second capture) and the recoveries. -> (launches by sub-run, lines)."""
    import dataclasses

    from mlsl_tpu_torch.models import transformer as tfm
    from mlsl_tpu_torch.ops import quant_kernels as qk
    from mlsl_tpu_torch.ops import rhd_kernels as rhd
    from mlsl_tpu_torch.serve import oracle_generate

    cfg = tfm.GPT_MEDIUM_2K
    t_all = time.perf_counter()
    params = tfm.init_params(torch.Generator().manual_seed(SEED), cfg)
    load = serve_prompts(np, cfg.vocab, SERVE_LOAD)
    prompts = load[:SERVE_REQUESTS]
    base = {"MLSL_SERVE_MAX_BATCH": str(SERVE_BATCH), "MLSL_SERVE_KV_CACHE_MB": str(SERVE_KV_MB)}
    lines, used_by = [], {}
    blocks = cfg.n_blocks

    def finish(tag, eng, reqs, probe, rec, delta=SERVE_DELTA, twin=True, faults=()):
        t0 = time.perf_counter()
        rec["oracle"] = serve_oracle(eng, reqs[:SERVE_ORACLE[tag]], probe, delta, tag)
        if faults:
            rec["planted_faults_max_abs_delta"] = serve_faults(torch, np, eng, prompts, delta,
                                                               faults)
        if twin:
            # two more requests, two steps, then the twin on the live batch
            for p in prompts[:2]:
                eng.submit(p, 4)
            eng.run(max_steps=2)
            rec["twin_slots"] = serve_twin(torch, np, eng)
            eng.run()
        rec["checks_s"] = time.perf_counter() - t0
        lines.append(f"# serve {tag} {json.dumps(rec)}")

    # (y1) tp = 1, float32 KV
    eng, reqs, probe, used, rec = serve_run(torch, np, get_env, launches, reset_launches,
                                            "y1", cfg, params, 1, load, SERVE_NEW,
                                            {**base, "MLSL_SERVE_QUEUE_DEPTH": str(SERVE_LOAD)},
                                            rate=SERVE_RATE, oracle=SERVE_ORACLE["y1"])
    serve_check_launches("y1", eng, used, rec, {}, {})
    first_tokens = [r.tokens[0] for r in reqs[:SERVE_REQUESTS]]
    finish("y1", eng, reqs, probe, rec, faults=SERVE_FAULTS[:2])
    used_by["serve_y1"] = used
    eng.close()
    del eng, reqs, probe

    # (y2) tp = 2, the decode step's reductions on B5 (B x 1,024 float32 <=
    # 40,000 B); the prefill's 8 MiB stay on lax
    eng, reqs, probe, used, rec = serve_run(torch, np, get_env, launches, reset_launches,
                                            "y2", cfg, params, 2, prompts, SERVE_NEW,
                                            {**base, "MLSL_PALLAS_RHD": "1"},
                                            oracle=SERVE_ORACLE["y2"])
    serve_check_launches("y2", eng, used, rec, {"rhd_allreduce": 2 * blocks}, {})
    plan = rhd.RhdPlan(eng.dist.model_group)
    x = torch.randn((2, SERVE_BATCH * cfg.d_model), device=eng.device)
    before = dict(rhd.LAUNCHES)
    rec["b5_ms_a_call"] = time_ms(torch, lambda: rhd.rhd_allreduce(x, plan), reps=50)
    rhd.LAUNCHES.update(before)
    finish("y2", eng, reqs, probe, rec)
    used_by["serve_y2"] = used
    eng.close()
    del eng, reqs, probe

    # (y3) tp = 2, every reduction on B3
    eng, reqs, probe, used, rec = serve_run(torch, np, get_env, launches, reset_launches,
                                            "y3", cfg, params, 2, prompts, SERVE_NEW,
                                            {**base, "MLSL_ALGO": "allreduce=pallas_ring"},
                                            oracle=SERVE_ORACLE["y3"])
    serve_check_launches("y3", eng, used, rec, {"dense_ring": 2 * blocks},
                         {"dense_ring": 2 * blocks})
    finish("y3", eng, reqs, probe, rec, twin=False)
    used_by["serve_y3"] = used
    eng.close()
    del eng, reqs, probe

    # (y4) tp = 1, int8 KV: B1 twice a prefill write (K, V over every block) and
    # twice a block in the graph, B2 twice a block in the graph
    eng, reqs, probe, used, rec = serve_run(torch, np, get_env, launches, reset_launches,
                                            "y4", cfg, params, 1, prompts, SERVE_NEW,
                                            {**base, "MLSL_SERVE_KV_QUANT": "1"},
                                            oracle=SERVE_ORACLE["y4"])
    serve_check_launches("y4", eng, used, rec,
                         {"quantize_blocks": 2 * blocks, "dequantize_blocks": 2 * blocks},
                         {"quantize_blocks": 2})
    check([r.tokens[0] for r in reqs] == first_tokens,
          f"serve y4: first tokens {[r.tokens[0] for r in reqs]} differ from (y1)'s "
          f"{first_tokens}")
    # the pools hold what the plain kv_block_quant gives for the same K and V
    before = dict(qk.LAUNCHES)
    p = prompts[0]
    padded = torch.zeros((eng.ctx_len,), dtype=torch.long, device=eng.device)
    padded[:p.size] = torch.from_numpy(p.astype(np.int64)).to(eng.device)
    _, k, v = eng._prefill(padded, p.size)
    sid = -1
    check(eng.cache.admit(sid, eng.ctx_len), "serve y4: no pages for the write check")
    table = eng.cache.table_padded(sid)
    eng._write(k, v, torch.as_tensor(table, dtype=torch.long, device=eng.device))
    live = torch.as_tensor(table, dtype=torch.long, device=eng.device)
    for x, pool, spool in ((k, eng.kpool, eng.kscale), (v, eng.vpool, eng.vscale)):
        rq, rs = qk.quantize_blocks_ref(x.reshape(-1, cfg.head_dim))
        got_q = pool[:, :, :, :, :, live].reshape(-1, cfg.head_dim)
        got_s = spool[:, :, :, :, :, live].reshape(-1)
        check(torch.equal(got_q, rq) and torch.equal(got_s, rs),
              "serve y4: the int8 pools differ from the plain kv_block_quant of the same K, V")
    eng.cache.release(sid)
    qk.LAUNCHES.update(before)
    del k, v
    finish("y4", eng, reqs, probe, rec, delta=SERVE_INT8_DELTA)
    # the JAX package's rule (tests/test_serve.py:96-114): the first token
    # exact and at most one token apart from the oracle's own greedy stream
    agree = [sum(a == b for a, b in zip(r.tokens, oracle_generate(eng, r.prompt, SERVE_NEW)))
             for r in reqs[:SERVE_JAX_RULE]]
    held = all(n >= SERVE_NEW - 1 for n in agree)
    lines.append(f"# serve y4 against the float32 oracle's own stream: JAX's rule (first token "
                 f"exact, at most one differing token) {'held' if held else 'did not hold'} on "
                 f"{SERVE_JAX_RULE} requests: tokens that agree {agree} of {SERVE_NEW}")
    used_by["serve_y4"] = used
    eng.close()
    del eng, reqs, probe

    # (y5a) eviction: two 1,000-token prompts, 48 new tokens each, 2 slots, 129
    # pages; both reach their 65th page and the younger is evicted and resumed
    rng = np.random.default_rng(SEED + 50)
    long = [rng.integers(1, cfg.vocab, size=SERVE_EVICT_PROMPT).astype(np.int32)
            for _ in range(2)]
    eng, reqs, probe, used, rec = serve_run(
        torch, np, get_env, launches, reset_launches, "y5a", cfg, params, 1, long,
        SERVE_EVICT_NEW, {"MLSL_SERVE_MAX_BATCH": "2", "MLSL_SERVE_KV_CACHE_MB": str(SERVE_EVICT_MB)},
        oracle=SERVE_ORACLE["y5a"])
    check(eng.cache.num_pages == eng.cache.max_pages_per_seq + 1,
          f"serve y5a: {eng.cache.num_pages} pages, expected one sequence plus one")
    check(rec["evictions"] >= 1 and rec["prefills"] >= 3,
          f"serve y5a: evictions {rec['evictions']}, prefills {rec['prefills']}")
    serve_check_launches("y5a", eng, used, rec, {}, {})
    finish("y5a", eng, reqs, probe, rec, twin=False)
    used_by["serve_y5a"] = used
    eng.close()
    del eng, reqs, probe

    # (y5b) the float32-compute model, two forced sheds after 5 steps: batch
    # (2 slots), then precision (the bf16 graph, captured mid-run); the ladder
    # recovers after 16 clear ticks a rung
    SERVE_STATS_DIR.mkdir(parents=True, exist_ok=True)
    log_path = SERVE_STATS_DIR / "mlsl_stats.log"
    if log_path.exists():
        log_path.unlink()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    eng, reqs, probe, used, rec = serve_run(
        torch, np, get_env, launches, reset_launches, "y5b", cfg32, params, 1, prompts,
        SERVE_NEW, {**base, "MLSL_STATS_DIR": str(SERVE_STATS_DIR)}, shed_after=5)
    check(sorted(eng._decode_cache) == ["bfloat16", "float32"],
          f"serve y5b: graphs {sorted(eng._decode_cache)}")
    check(all(np.isfinite(a).all() for ls in probe.logits.values() for a in ls),
          "serve y5b: non-finite logits")
    serve_lines = [ln for ln in log_path.read_text().splitlines() if ln.startswith("SERVE")]
    kinds = [ln.split()[1] for ln in serve_lines]
    check(kinds[:2] == ["BATCH", "PRECISION"] and kinds.count("RECOVERY") >= 1,
          f"serve y5b: SERVE lines {serve_lines}")
    rec["serve_lines"] = serve_lines
    rec["rung_at_end"] = eng.governor.rung
    # the ladder back at its first rung, the float32 graph serves again: the
    # float32 model's rule (SERVE_F32_DELTA) on two more requests, and every
    # planted fault must fail it
    check(eng.governor.rung == 0, f"serve y5b: rung {eng.governor.rung} after the run")
    from mlsl_tpu_torch.serve import checks
    probe = checks.Probe(eng)
    reqs = [eng.submit(p, SERVE_NEW // 2) for p in prompts[:SERVE_ORACLE["y5b"]]]
    eng.run()
    finish("y5b", eng, reqs, probe, rec, delta=SERVE_F32_DELTA, twin=False,
           faults=SERVE_FAULTS)
    used_by["serve_y5b"] = used
    eng.close()
    del eng, reqs, probe, params
    settle(torch)
    lines.append(f"# phase serve (run (y)): ok in {time.perf_counter() - t_all:.1f} s, "
                 f"launches {json.dumps(used_by)}")
    return used_by, lines


# -- the fault plane and telemetry (run (z)) ---------------------------------------

FAULT_DIR = ROOT / "build" / "mlsl_tpu_torch" / "fault_plane"
FAULT_N = 16 << 20          # (z1): 16 Mi float32 a rank, 8 ranks
FAULT_QN = 4 << 20          # (z2): 4 Mi float32 a rank on the fused int8 ring
FAULT_RING_TOL = 1e-6       # a ring's float sum against torch's one-pass sum (~1e-7 seen)
FAULT_FLUSH_TOL = 1e-6      # the degraded round against the float64 sum of payload + residual
FAULT_SERVE_NEW = 16
FAULT_IDLE_STEPS = 8


def fault_request(env, dist, n, name, quant=False):
    """A SUM allreduce over the data group, set up, as a user builds one."""
    from mlsl_tpu_torch import CompressionType
    from mlsl_tpu_torch.comm.request import CommDesc, CommRequest
    from mlsl_tpu_torch.types import DataType, ReductionType

    req = CommRequest(CommDesc("allreduce", dist.data_group, n, DataType.FLOAT,
                               op=ReductionType.SUM,
                               compression=(CompressionType.QUANTIZATION if quant
                                            else CompressionType.NONE)),
                      env.dispatcher, name=name)
    req.setup()
    return req


def fault_round(torch, req, buf):
    """One Start/Wait -> (a copy of the result, its exception's type name or
    None)."""
    try:
        out = req.start(buf).wait().clone()
        torch.cuda.synchronize()
        return out, None
    except Exception as e:   # the schedule's raise, checked by the caller
        torch.cuda.synchronize()
        return None, type(e).__name__


def phase_fault_dense(torch, np, get_env, launches, reset_launches):
    """(z1): a pallas_ring (B3) allreduce of 8 x 16 Mi float32 -- a TRANSIENT
    dispatch fault retried in place (bit for bit the unfaulted round), then
    ``breaker_threshold`` PERSISTENT faults trip the algo breaker: the
    tripping round and the next run degraded on ``lax`` (no B3 launch) within
    the ring's bound of B3's result, and after the cooldown the HALF_OPEN
    probe launches B3 again and re-closes the breaker. -> (launches, record)."""
    from mlsl_tpu_torch import chaos, supervisor
    from mlsl_tpu_torch.core import stats

    env = reinit(get_env, MLSL_ALGO="allreduce=pallas_ring", MLSL_STATS_DIR=str(FAULT_DIR))
    settle(torch)
    supervisor.reset_all()
    dist = env.create_distribution(WORLD, 1)
    req = fault_request(env, dist, FAULT_N, "z1")
    check(req.algo == "pallas_ring", f"fault z1: selected {req.algo!r}")
    gen = torch.Generator(device=env.device).manual_seed(SEED + 90)
    buf = torch.randn((*dist.topology.grid_shape, FAULT_N), generator=gen, device=env.device)
    reset_launches()
    base, err = fault_round(torch, req, buf)
    check(err is None and launches()["dense_ring"] == 1, f"fault z1: unfaulted round {err}")
    rec = {}
    # rung 2: an OSError (TRANSIENT in the taxonomy) retried in place
    chaos.plan("collective.dispatch", "error", exc=OSError)
    out, err = fault_round(torch, req, buf)
    check(err is None and torch.equal(out, base),
          f"fault z1: the retried round ({err}) is not the unfaulted one bit for bit")
    rec["retries"] = stats.DEGRADE_COUNTERS["comm_retries"]
    check(rec["retries"] == 1, f"fault z1: {rec['retries']} retries counted")
    # rung 3: threshold one-shot RuntimeErrors (PERSISTENT)
    br = supervisor.breaker("algo")
    raised = []
    for _ in range(br.threshold):
        chaos.plan("collective.dispatch", "error", exc=RuntimeError)
        before = launches()["dense_ring"]
        out, err = fault_round(torch, req, buf)
        raised.append(err)
    chaos.clear()
    check(raised[:-1] == ["RuntimeError"] * (br.threshold - 1) and raised[-1] is None
          and br.state == supervisor.OPEN,
          f"fault z1: rounds {raised}, breaker {br.state}")
    check(launches()["dense_ring"] == before, "fault z1: the tripping round launched B3")
    before = launches()["dense_ring"]
    degraded, err = fault_round(torch, req, buf)
    check(err is None and launches()["dense_ring"] == before,
          f"fault z1: the degraded round ({err}) launched B3")
    rel = float((degraded.double() - base.double()).norm() / base.double().norm())
    check(rel <= FAULT_RING_TOL and torch.equal(out, degraded),
          f"fault z1: lax against B3 {rel:.3g} (bound {FAULT_RING_TOL})")
    rec["degraded_vs_b3_rel"] = rel
    rec["fallbacks"] = dict(stats.DEGRADE_FALLBACKS)
    check(rec["fallbacks"] == {"algo": 2}, f"fault z1: fallbacks {rec['fallbacks']}")
    # the cooldown, then the probe: B3 again, bit for bit, breaker CLOSED
    supervisor.configure(cooldown_s=0.05)
    time.sleep(0.1)
    probe, err = fault_round(torch, req, buf)
    check(err is None and launches()["dense_ring"] == before + 1 and torch.equal(probe, base)
          and br.state == supervisor.CLOSED,
          f"fault z1: probe {err}, breaker {br.state}")
    rec["ladder"] = {k: v for k, v in stats.DEGRADE_COUNTERS.items() if v}
    check(rec["ladder"] == {"comm_retries": 1, "breaker_trips": 1, "breaker_probes": 1,
                            "breaker_resets": 1}, f"fault z1: ladder {rec['ladder']}")
    used = {k: v for k, v in launches().items() if v}
    del buf, base, out, degraded, probe, req
    supervisor.reset_all()
    return used, rec


def phase_fault_quant(torch, np, get_env, launches, reset_launches):
    """(z2): the same ladder on the quant breaker, a fused int8 request (B1 +
    B4) of 8 x 4 Mi float32 under codec.roundtrip faults: the tripping round
    is the plain float32 SUM of payload plus residual (flushed once), within
    FAULT_FLUSH_TOL relative of the float64 sum; the next degraded round is
    bit for bit the plain request's; DEGRADE lines in mlsl_stats.log; the
    probe re-closes and launches B4 again. -> (launches, record)."""
    from mlsl_tpu_torch import chaos, supervisor
    from mlsl_tpu_torch.comm import collectives
    from mlsl_tpu_torch.comm.quant_ring import logical_residual
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.ops import ring_kernels as rk
    from mlsl_tpu_torch.types import ReductionType

    FAULT_DIR.mkdir(parents=True, exist_ok=True)
    log_path = FAULT_DIR / "mlsl_stats.log"
    if log_path.exists():
        log_path.unlink()
    env = reinit(get_env, MLSL_ALGO="pallas_ring", MLSL_STATS_DIR=str(FAULT_DIR))
    settle(torch)
    supervisor.reset_all()
    dist = env.create_distribution(WORLD, 1)
    req = fault_request(env, dist, FAULT_QN, "z2", quant=True)
    check(req.algo == "pallas_ring", f"fault z2: selected {req.algo!r}")
    # the uncompressed request's program, the degraded path's
    plain = collectives.unwrap_chaos(collectives.build_collective(
        "allreduce", dist.data_group, op=ReductionType.SUM))
    gen = torch.Generator(device=env.device).manual_seed(SEED + 91)
    buf = torch.randn((*dist.topology.grid_shape, FAULT_QN), generator=gen, device=env.device)
    reset_launches()
    first, err = fault_round(torch, req, buf)
    check(err is None and launches()["quant_ring"] == 1, f"fault z2: healthy round {err}")
    errs = [e.clone() for e in req._errs]
    br = supervisor.breaker("quant")
    raised = []
    for _ in range(br.threshold):
        chaos.plan("codec.roundtrip", "error", exc=RuntimeError)
    for i in range(br.threshold):
        if i == br.threshold - 1:
            # the residual the tripping round flushes: the Start snapshot
            errs = [e.clone() for e in req._errs]
            b4 = launches()["quant_ring"]
        out, err = fault_round(torch, req, buf)
        raised.append(err)
    chaos.clear()
    check(raised[:-1] == ["RuntimeError"] * (br.threshold - 1) and raised[-1] is None
          and br.state == supervisor.OPEN, f"fault z2: rounds {raised}, breaker {br.state}")
    check(launches()["quant_ring"] == b4, "fault z2: the tripping round launched B4")
    g, rc, chunk, _ = rk.quant_geometry("allreduce", dist.data_group, FAULT_QN,
                                        env.config.quant_block_elems)
    entered = buf.double() + logical_residual(errs[0], g, chunk, rc, FAULT_QN).double()
    exact = entered.reshape(WORLD, FAULT_QN).sum(dim=0)
    rows = out.reshape(WORLD, FAULT_QN)
    rel = float((rows[0].double() - exact).norm() / exact.norm())
    check(rel <= FAULT_FLUSH_TOL and bool((rows == rows[:1]).all()),
          f"fault z2: the flushed round {rel:.3g} (bound {FAULT_FLUSH_TOL})")
    check(req._errs is None, "fault z2: the degraded round left a residual")
    degraded, err = fault_round(torch, req, buf)
    want = plain(buf)
    torch.cuda.synchronize()
    check(err is None and torch.equal(degraded, want),
          "fault z2: the degraded round is not the plain request's bit for bit")
    lines = [ln for ln in log_path.read_text().splitlines() if ln.startswith("DEGRADE")]
    check([ln.split()[1:3] for ln in lines] == [["TRIP", "quant"]],
          f"fault z2: DEGRADE lines {lines}")
    supervisor.configure(cooldown_s=0.05)
    time.sleep(0.1)
    b4 = launches()["quant_ring"]
    probe, err = fault_round(torch, req, buf)
    lines = [ln for ln in log_path.read_text().splitlines() if ln.startswith("DEGRADE")]
    check(err is None and launches()["quant_ring"] == b4 + 1 and br.state == supervisor.CLOSED
          and [ln.split()[1] for ln in lines] == ["TRIP", "PROBE", "RESET"],
          f"fault z2: probe {err}, breaker {br.state}, DEGRADE lines {lines}")
    rec = {"flushed_vs_f64_rel": rel, "fallbacks": dict(stats.DEGRADE_FALLBACKS),
           "degrade_lines": [" ".join(ln.split()[:3]) for ln in lines]}
    check(rec["fallbacks"] == {"quant": 2}, f"fault z2: fallbacks {rec['fallbacks']}")
    used = {k: v for k, v in launches().items() if v}
    del buf, first, out, degraded, want, probe, req, plain
    supervisor.reset_all()
    return used, rec


def phase_fault_watchdog(torch, np, get_env):
    """(z3): a deferred allreduce whose dispatch hangs at the
    collective.dispatch site on the progress thread; a 0.5 s watchdog trips
    MLSLTimeoutError, and with the tracer on the trip writes a
    trace-crash-*.json that loads and holds the request's spans and the
    watchdog.trip instant. The hang released, the same request completes
    with the right sum. -> record."""
    from mlsl_tpu_torch import chaos, obs, supervisor
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.log import MLSLTimeoutError

    env = reinit(get_env, MLSL_MSG_PRIORITY="1", MLSL_MSG_PRIORITY_THRESHOLD="0",
                 MLSL_MSG_PRIORITY_FLUSH_MS="1", MLSL_WATCHDOG_TIMEOUT="0.5",
                 MLSL_TRACE_DIR=str(FAULT_DIR), MLSL_STATS_DIR=str(FAULT_DIR))
    supervisor.reset_all()
    for old in FAULT_DIR.glob("trace-crash-*.json"):
        old.unlink()
    obs.enable(capacity=1 << 16)
    dist = env.create_distribution(WORLD, 1)
    req = fault_request(env, dist, 1 << 20, "z3")
    buf = torch.ones((*dist.topology.grid_shape, 1 << 20), device=env.device)
    plan = chaos.plan("collective.dispatch", "hang", seconds=30)
    t0 = time.monotonic()
    req.start(buf)
    time.sleep(0.2)
    tripped = None
    try:
        req.wait()
    except MLSLTimeoutError as e:
        tripped = str(e)
    waited = time.monotonic() - t0
    chaos.remove(plan)        # wakes the hang; the dispatch goes on
    check(tripped is not None and "z3" in tripped and waited < 5,
          f"fault z3: the watchdog did not trip ({tripped!r} after {waited:.2f} s)")
    evt = stats.WATCHDOG_EVENTS[-1]
    doc = json.loads(Path(evt["flight_record"]).read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    check({"submit", "defer", "watchdog.trip", "chaos.fired"} <= names
          and doc["otherData"]["kind"] == "flight_record",
          f"fault z3: the flight record holds {sorted(names)}")
    out = req.wait(timeout=0)     # no deadline: the dispatch may still be finishing
    torch.cuda.synchronize()
    check(bool((out == WORLD).all()), "fault z3: the request's result after the hang")
    rec = {"watchdog_s": 0.5, "tripped_after_s": waited, "phase": evt["phase"],
           "flight_record": evt["flight_record"],
           "flight_record_events": len(doc["traceEvents"])}
    del buf, out, req
    obs.disable()
    env.config.msg_priority = False
    supervisor.reset_all()
    return rec


def phase_fault_engine(torch, np, get_env, launches, reset_launches):
    """(z4): config 5 on the compiled overlap engine (ResNet-50 at 224²,
    int8 on the composed ring), ``collective.dispatch:error x*`` armed before
    its capture: the capture passes no site (0 hits) and succeeds, and the
    next step raises at its host site before the replay, the state
    untouched; disarmed, two replayed steps with the tracer on give one
    step.overlap span each, and their losses equal, bit for bit, an untraced
    twin's from the same state; a plan armed after the capture raises at the
    next step. Then the step's time with the tracer and metrics off and on.
    -> (launches, record)."""
    from mlsl_tpu_torch import chaos, obs, supervisor
    from mlsl_tpu_torch.core import graph_capture

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    env = reinit(get_env)
    settle(torch)
    supervisor.reset_all()
    trainer, batch = build_resnet_trainer(torch, env, np, overlap_compiled=True)
    engine = trainer._overlap
    check(engine is not None, "fault z4: the compiled overlap engine did not engage")
    reset_launches()
    plan = chaos.plan("collective.dispatch", "error", times=None)
    trainer.precompile(batch)
    torch.cuda.synchronize()
    check(plan.hits == 0 and list(engine.graphs) == ["step"],
          f"fault z4: the capture passed the site {plan.hits} times, graphs "
          f"{list(engine.graphs)}")
    state = [t.detach().clone() for t in engine._state()]
    raised = None
    try:
        trainer.step(batch)
    except chaos.ChaosError:
        raised = "ChaosError"
    torch.cuda.synchronize()
    check(raised and plan.fires == 1
          and all(torch.equal(a, b) for a, b in zip(engine._state(), state)),
          f"fault z4: the armed step raised {raised}, fires {plan.fires}, or moved the state")
    chaos.clear()
    step0 = trainer._step_no
    tr = obs.enable(capacity=4096)
    traced = [trainer.step(batch).detach().reshape(-1).cpu() for _ in range(2)]
    spans = [e for e in tr.snapshot() if e[1] == "step.overlap"]
    obs.disable()
    check(len(spans) == 2, f"fault z4: {len(spans)} step.overlap spans in two steps")
    graph_capture.put_back(engine._state(), state)
    trainer._step_no = step0
    twin = [trainer.step(batch).detach().reshape(-1).cpu() for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(traced, twin)),
          f"fault z4: traced losses {traced} differ from the untraced twin's {twin}")
    used = {k: v for k, v in launches().items() if v}
    chaos.plan("collective.dispatch", "error")
    raised = None
    try:
        trainer.step(batch)
    except chaos.ChaosError:
        raised = "ChaosError"
    check(raised == "ChaosError", "fault z4: a plan armed after the capture did not fire")
    # (z6)'s half: the replayed step with the plane off and on
    idle = {}
    for key, on in (("off", False), ("on", True), ("off_again", False)):
        if on:
            obs.enable(capacity=4096)
            obs.enable_metrics()
        secs = drive_steps(torch, trainer, batch, steps=FAULT_IDLE_STEPS)[1]
        idle[key] = float(np.median(secs)) * 1e3
        supervisor.reset_all()
    rec = {"capture_s": engine.capture_s["step"], "losses": [float(v.mean()) for v in traced],
           "step_overlap_spans_ms": [e[4] / 1e6 for e in spans], "step_ms_median": idle}
    del trainer, batch, engine, state
    torch.backends.cudnn.deterministic = False
    settle(torch)
    return used, rec


def phase_fault_serve(torch, np, get_env, launches, reset_launches):
    """(z5): run (y)'s engine (gpt-medium-2k, tp 1, weights from SEED) with
    the tracer, the metrics registry and the lock witness on and the scrape
    server on 127.0.0.1, port 0: a TRANSIENT serve.decode fault retried in
    place gives the unfaulted tokens; a serve.admit fault fails one request
    closed; /metrics holds the mlsl_serve_* families and /healthz is JSON
    with the serve, codecs and breaker keys; the trace holds serve.prefill,
    serve.decode and kv.evict (a preemption of the youngest sequence); the
    witness reports no cycle. Then (z6)'s half: the decode step's host time
    with the plane off and on. -> (launches, record)."""
    import urllib.request

    from mlsl_tpu_torch import chaos, obs, supervisor
    from mlsl_tpu_torch.analysis import witness
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.models import transformer as tfm
    from mlsl_tpu_torch.serve import InferenceEngine, checks

    cfg = tfm.GPT_MEDIUM_2K
    env = reinit(get_env, world=1, MLSL_SERVE_MAX_BATCH=str(SERVE_BATCH),
                 MLSL_SERVE_KV_CACHE_MB=str(SERVE_KV_MB), MLSL_LOCK_WITNESS="1",
                 MLSL_COMM_RETRY_BACKOFF_S="0.001", MLSL_STATS_DIR=str(FAULT_DIR),
                 MLSL_TRACE_DIR=str(FAULT_DIR))
    settle(torch)
    supervisor.reset_all()
    stats.reset_serve_counters()
    params = tfm.init_params(torch.Generator().manual_seed(SEED), cfg)
    prompts = serve_prompts(np, cfg.vocab, 6, seed=SEED + 5)
    reset_launches()
    eng = InferenceEngine(env, cfg, tp=1, params=params)
    check(isinstance(eng._lock, witness.WitnessLock), "fault z5: the engine lock is not witnessed")
    tr = obs.enable(capacity=1 << 16)
    reg = obs.enable_metrics(every=1)
    srv = obs.start_server(port=0, addr="127.0.0.1")
    check(srv is not None, "fault z5: the scrape server did not start")
    base = [eng.submit(p, FAULT_SERVE_NEW) for p in prompts[:3]]
    eng.run()
    check(all(r.state == "done" for r in base), f"fault z5: {[r.state for r in base]}")
    plan = chaos.plan("serve.decode", "error", exc=OSError, times=2)
    again = [eng.submit(p, FAULT_SERVE_NEW) for p in prompts[:3]]
    eng.run()
    check(plan.fires == 2 and [r.tokens for r in again] == [r.tokens for r in base],
          f"fault z5: the retried decode gave other tokens ({plan.fires} fires)")
    chaos.plan("serve.admit", "error", times=1)
    admit = [eng.submit(p, 4) for p in prompts[3:6]]
    eng.run()
    states = [r.state for r in admit]
    check(sorted(states) == ["done", "done", "failed"], f"fault z5: admit states {states}")
    chaos.clear()
    # a preemption: the youngest of two live sequences evicted and resumed
    ev = [eng.submit(p, 8) for p in prompts[:2]]
    eng.run(max_steps=2)
    check(len(eng._active) == 2, f"fault z5: {len(eng._active)} sequences in flight")
    eng._evict_youngest()
    eng.run()
    check(all(r.state == "done" for r in ev), f"fault z5: after the eviction {ev}")
    url = f"http://127.0.0.1:{srv.port}"
    prom = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
    health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=10).read().decode())
    families = sorted({ln.split()[2] for ln in prom.splitlines()
                       if ln.startswith("# TYPE mlsl_serve_")})
    check({"mlsl_serve_ttft_ms", "mlsl_serve_tpot_ms", "mlsl_serve_requests_total",
           "mlsl_serve_queue_depth", "mlsl_serve_kv_free_pages"} <= set(families),
          f"fault z5: /metrics families {families}")
    check({"serve", "codecs", "quant", "bucket", "algo", "tracer"} <= set(health)
          and health["serve"]["state"] != "off", f"fault z5: /healthz keys {sorted(health)}")
    names = {e[1] for e in tr.snapshot()}
    check({"serve.prefill", "serve.decode", "kv.evict", "chaos.fired"} <= names,
          f"fault z5: the trace holds {sorted(names)}")
    path = obs.write_trace(str(FAULT_DIR / "trace-z5.json"))
    rep = witness.report()
    check(not rep["cycles"], f"fault z5: the witness saw cycles {rep['cycles']}")
    used = {k: v for k, v in launches().items() if v}
    rec = {"families": families, "healthz_keys": sorted(health), "trace": path,
           "trace_events": len(tr.snapshot()), "witness_edges": sorted(rep["edges"]),
           "admit_states": states, "retries": int(stats.SERVE_COUNTERS["retries"])}
    check(rec["retries"] == 2, f"fault z5: {rec['retries']} decode retries counted")
    # (z6)'s half: the decode step's host time, plane off and on
    idle = {}
    for key, on in (("on", True), ("off", False), ("on_again", True)):
        if on:
            obs.enable(capacity=1 << 16)
            obs.enable_metrics(every=1)
        else:
            obs.disable()
            obs.disable_metrics()
        probe = checks.Probe(eng, keep=set())
        for p in prompts[:SERVE_BATCH]:
            eng.submit(p, FAULT_SERVE_NEW * 2)
        eng.run()
        idle[key] = float(np.median(probe.step_ms[1:]))
    rec["decode_step_ms_median"] = idle
    eng.close()
    del eng, params
    supervisor.reset_all()
    os.environ.pop("MLSL_LOCK_WITNESS", None)
    settle(torch)
    return used, rec


def run_fault_plane(torch, np, get_env, launches, reset_launches):
    """Run (z): the fault plane and the telemetry on the card, parts (z1) to
    (z6); every part starts from ``supervisor.reset_all()``.
    -> (launches by part, lines)."""
    lines, used = [], {}
    t0 = time.perf_counter()
    used["fault_z1"], rec = phase_fault_dense(torch, np, get_env, launches, reset_launches)
    lines.append(f"# fault z1 {json.dumps(rec)}")
    lines.append(f"# phase fault dense ladder (run (z1)): ok in {time.perf_counter() - t0:.1f} "
                 f"s, launches {json.dumps(used['fault_z1'])}")
    t0 = time.perf_counter()
    used["fault_z2"], rec = phase_fault_quant(torch, np, get_env, launches, reset_launches)
    lines.append(f"# fault z2 {json.dumps(rec)}")
    lines.append(f"# phase fault quant ladder (run (z2)): ok in {time.perf_counter() - t0:.1f} "
                 f"s, launches {json.dumps(used['fault_z2'])}")
    t0 = time.perf_counter()
    rec = phase_fault_watchdog(torch, np, get_env)
    lines.append(f"# fault z3 {json.dumps(rec)}")
    lines.append(f"# phase fault watchdog (run (z3)): ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    used["fault_z4"], rec4 = phase_fault_engine(torch, np, get_env, launches, reset_launches)
    lines.append(f"# fault z4 {json.dumps(rec4)}")
    lines.append(f"# phase fault compiled engine (run (z4)): ok in "
                 f"{time.perf_counter() - t0:.1f} s, launches {json.dumps(used['fault_z4'])}")
    t0 = time.perf_counter()
    used["fault_z5"], rec5 = phase_fault_serve(torch, np, get_env, launches, reset_launches)
    lines.append(f"# fault z5 {json.dumps(rec5)}")
    lines.append(f"# phase fault serving (run (z5)): ok in {time.perf_counter() - t0:.1f} s, "
                 f"launches {json.dumps(used['fault_z5'])}")
    idle = {"decode_step_host_ms_median": rec5["decode_step_ms_median"],
            "config5_compiled_step_ms_median": rec4["step_ms_median"]}
    lines.append(f"# fault z6 idle cost (not gated): {json.dumps(idle)}")
    lines.append("# phase fault idle cost (run (z6)): ok in 0.0 s")
    return used, lines


# -- the integrity layer and the core tier (run (aa)) -------------------------------

# the integrity and core-tier knobs run (aa) sets; every sub-run starts with
# none of them exported, and the run ends with none
AA_VARS = ("MLSL_SENTINEL_GATE", "MLSL_SENTINEL_EVERY", "MLSL_SENTINEL_WARMUP",
           "MLSL_SENTINEL_SPIKE", "MLSL_SENTINEL_ZMAX", "MLSL_SENTINEL_BLOCK", "MLSL_CHKP",
           "MLSL_AUTO_CONFIG_TYPE", "MLSL_LARGE_MSG_CHUNKS", "MLSL_GATHER_DEVICE_LIMIT_MB",
           "MLSL_OVERLAP_COMPILED")
AA_SPIKE = 1e8              # (aa1): the finite train.grads plan the spike screen must skip
# (aa1)'s MLSL_SENTINEL_SPIKE: far above a healthy step's gradient norm against
# its EMA (config 5 at lr 0.05 may double it from one step to the next) and far
# below the AA_SPIKE plan's (~1e7 x)
AA_SPIKE_FACTOR = "1000"
AA_CHKP_N = 1 << 20         # (aa3): floats a rank of the three checked allreduces
# (aa5): the smallest kernel source, built cold into a fresh cache directory by
# one process and loaded warm by a second that may not run nvcc
AA_CACHE_SOURCE = "rhd_kernels"
AA_CACHE_PROG = """
import json, sys, time
sys.path.insert(0, {root!r})
from mlsl_tpu_torch.ops import cuda_build
if {warm}:
    def no_nvcc():
        raise SystemExit("the warm process asked for nvcc")
    cuda_build.nvcc_path = no_nvcc
t0 = time.perf_counter()
cuda_build.load({name!r})
print(json.dumps({{"dir": str(cuda_build.build_dir()), "lib": cuda_build.lib_path({name!r}).name,
                  "load_s": time.perf_counter() - t0, "built": sorted(cuda_build.build_logs)}}))
"""


def aa_env(get_env, **env_vars):
    """``reinit`` with ``env_vars`` exported and run (aa)'s other knobs unset."""
    for k in AA_VARS:
        os.environ.pop(k, None)
    return reinit(get_env, **env_vars)


def aa_batch(np, trainer, seed, image=224, classes=1000, batch=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, image, image, 3)).astype(np.float32)
    return trainer.shard_batch(x, rng.integers(0, classes, size=(batch,)).astype(np.int32))


def aa_state(trainer) -> list:
    """Copies of the parameters and of every error-feedback residual (the
    host requests' and the compiled engine's)."""
    out = [p.detach().clone() for p in trainer._all_params()]
    for n in trainer.layers:
        out += [e.clone() for e in (_grad_req(trainer, n)._errs or [])]
    if trainer._overlap is not None:
        out += [v.clone() for v in trainer._overlap.residuals.values()]
    return out


def same_state(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_integrity_gate(torch, np, get_env, launches, reset_launches, engine: bool):
    """(aa1): MLSL_SENTINEL_GATE=skip_step on config 5 (int8, composed ring),
    on the host path or (``engine``) the compiled engine's split graph. A
    train.grads plan of 1e8 (the spike screen) and a NaN plan (the non-finite
    screen) are each skipped, the parameters and residuals bit for bit as
    before; a twin that never saw the poisoned steps agrees bit for bit after
    the next step; under 'rollback' the gate raises MLSLIntegrityError and
    the state is untouched. On the host path the twin runs ungated (its gate
    disarmed: the same arithmetic), which times the gated step against the
    ungated one, and the screen is timed alone on the step's gradients.
    -> (launches, record)."""
    from mlsl_tpu_torch import chaos
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.log import MLSLIntegrityError

    tag = "compiled engine" if engine else "host path"
    env = aa_env(get_env, MLSL_SENTINEL_GATE="skip_step", MLSL_SENTINEL_WARMUP="1",
                 MLSL_SENTINEL_SPIKE=AA_SPIKE_FACTOR,
                 **({"MLSL_OVERLAP_COMPILED": "1"} if engine else {}))
    settle(torch)
    a, b0 = build_resnet_trainer(torch, env, np)
    twin, _ = build_resnet_trainer(torch, env, np)
    b1 = aa_batch(np, a, SEED + 41)
    check(a.sentinel is not None and a.sentinel.gate_armed and not a.fused,
          f"(aa1) {tag}: the gate is not armed on the graph path")
    if engine:
        check(a._overlap is not None, "(aa1) compiled engine: the engine did not engage")
    else:
        twin.sentinel.gate_response = ""
    stats.reset_sentinel_counters()
    stats.reset_overlap_counters()
    reset_launches()
    secs = {"gated": [], "twin": []}

    def timed(tr, batch, key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr.step(batch)
        torch.cuda.synchronize()
        secs[key].append(time.perf_counter() - t0)
        check(bool(torch.isfinite(loss).all()), f"(aa1) {tag}: losses {loss.reshape(-1)}")

    timed(a, b0, "gated")
    timed(twin, b0, "twin")
    before = aa_state(a)
    for mag in (AA_SPIKE, float("nan")):
        plan = chaos.plan("train.grads", "silent", mag=mag)
        a.step(b1)
        check(plan.fires == 1, f"(aa1) {tag}: the {mag} plan did not fire")
    torch.cuda.synchronize()
    sc = dict(stats.SENTINEL_COUNTERS)
    check(sc["gate_skip"] == 2, f"(aa1) {tag}: counters {sc}, expected 2 skips")
    check(same_state(torch, before, aa_state(a)),
          f"(aa1) {tag}: a skipped step moved the parameters or residuals")
    timed(a, b1, "gated")
    timed(twin, b1, "twin")
    check(stats.SENTINEL_COUNTERS["gate_skip"] == 2,
          f"(aa1) {tag}: the gate fired on the healthy step after the skips")
    check(same_state(torch, aa_state(a), aa_state(twin)),
          f"(aa1) {tag}: the skipping trainer and its twin differ after the next step")
    used = launches()
    rec = {"tag": tag, "counters": sc, "grad_norm_ema": a.sentinel._ema_norm,
           "gated_step_s": secs["gated"], "twin_step_s": secs["twin"]}
    if engine:
        oc = stats.OVERLAP_COUNTERS
        check(list(a._overlap.graphs) == ["sync"] and oc["split_steps"] == oc["steps"] > 0,
              f"(aa1) compiled engine: graphs {list(a._overlap.graphs)}, counters {oc}")
        rec["split_steps"], rec["capture_s"] = oc["split_steps"], a._overlap.capture_s["sync"]
    else:
        # the gate's own cost: one screen (its one host read included) on the
        # step's real gradients
        loss, grads = a._local_grads(b1)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.sentinel.screen(loss, grads)
            ms.append((time.perf_counter() - t0) * 1e3)
        rec["gate_screen_ms"] = ms
        del loss, grads
    a.sentinel.gate_response = "rollback"
    before = aa_state(a)
    chaos.plan("train.grads", "silent", mag=float("nan"))
    try:
        a.step(b0)
        raised = False
    except MLSLIntegrityError:
        raised = True
    check(raised and stats.SENTINEL_COUNTERS["gate_rollback"] == 1,
          f"(aa1) {tag}: rollback did not raise MLSLIntegrityError")
    check(same_state(torch, before, aa_state(a)), f"(aa1) {tag}: rollback moved the state")
    chaos.clear()
    del a, twin, b0, b1, before
    settle(torch)
    return used, rec


def host_blocks(np, a, block):
    """The audit's block sums of one float32 leaf on the host: its bits as
    int32, zero-padded, summed exactly and wrapped to int32."""
    v = np.ascontiguousarray(a, dtype=np.float32).reshape(-1).view(np.int32).astype(np.int64)
    v = np.concatenate([v, np.zeros((-v.size) % block, np.int64)])
    s = v.reshape(-1, block).sum(axis=1)
    return ((s + 2**31) % 2**32 - 2**31).astype(np.int32)


def timed_audit(torch, trainer, step):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.sentinel.maybe_audit(trainer, step)
    return res, (time.perf_counter() - t0) * 1e3


def phase_integrity_audit(torch, np, get_env, launches, reset_launches):
    """(aa2): MLSL_SENTINEL_EVERY=1 on config 5, one step on the same batch
    (cuDNN deterministic) from the same initial weights. The plain trainer
    and the bucketed one, both uncompressed on ``lax`` (an element is summed
    in one order wherever it sits in the payload: the lax buckets phase, 22),
    hold the same state bit for bit after it, so their audits give one
    digest. The int8 trainer's step runs B1 and B4 (its launches counted):
    its audit holds, its digest moved off the plain step's, the fc weight's
    block sums on the card equal the host's numpy sums, and the plain trainer
    loaded with that state gives the int8 trainer's digest (the audit reads
    the state, not the path that made it). One flipped bit changes the
    digest. ZeRO-1 (Adam, one step_accum step): the owned moments enter
    summed over the ranks, and a bit flipped in one rank's shard changes the
    digest. The bucketed trainer is kept for (aa3). -> (launches by part,
    record, the bucketed trainer)."""
    from mlsl_tpu_torch import CompressionType, chaos, sentinel

    rec = {"digest": {}, "audit_ms": {}}
    used = {}

    def audited(tr, tag, step):
        res, ms = timed_audit(torch, tr, step)
        check(res.equal, f"(aa2) {tag}: the audit of one copy disagrees with itself")
        rec["digest"][tag] = res.digest[:16]
        rec["audit_ms"][tag] = [ms] + [timed_audit(torch, tr, step)[1] for _ in range(2)]
        return res

    def stepped(tag, env_vars, comp):
        env = aa_env(get_env, MLSL_SENTINEL_EVERY="1", **env_vars)
        settle(torch)
        tr, b0 = build_resnet_trainer(torch, env, np, compression=comp)
        initial = audited(tr, f"{tag}, initial", 0)
        reset_launches()
        loss = tr.step(b0)
        torch.cuda.synchronize()
        used[tag] = launches()
        check(bool(torch.isfinite(loss).all()), f"(aa2) {tag}: losses {loss.reshape(-1)}")
        res = audited(tr, f"{tag}, after a step", 1)
        check(res.digest != initial.digest, f"(aa2) {tag}: the step left the digest as it was")
        return tr, initial, res

    plain, initial, res = stepped("plain", {"MLSL_ALGO": "lax"}, CompressionType.NONE)
    rec["blocks"] = res.blocks
    bucketed, _, bres = stepped("bucketed", {"MLSL_ALGO": "lax",
                                             "MLSL_GRAD_BUCKET_MB": str(BUCKET_MB)},
                                CompressionType.NONE)
    check(any(bucketed._pset(n).bucket is not None for n in bucketed.layers),
          "(aa2) bucketed: no bucket formed")
    check(bres.digest == res.digest and bres.blocks == res.blocks,
          f"(aa2) one step plain and bucketed gave digests {rec['digest']}")
    int8, i_initial, ires = stepped("int8 B4", {"MLSL_ALGO": "pallas_ring"}, None)
    check(used["int8 B4"]["quant_ring"] > 0 and used["int8 B4"]["quantize_blocks"] > 0,
          f"(aa2) int8 B4: the step launched {used['int8 B4']}")
    check(i_initial.digest == initial.digest,
          "(aa2) the same initial weights gave another digest on the int8 trainer")
    check(ires.digest != res.digest, "(aa2) the int8 step left the plain step's state")
    fc = int8.layer_params["fc"][-1].detach()
    got = int8.sentinel._leaf_blocks(fc).cpu().numpy()
    check(np.array_equal(got, host_blocks(np, fc.cpu().numpy(), int8.sentinel.block)),
          "(aa2) the fc weight's block sums on the card differ from numpy's")
    rec["sampled_leaf"] = {"shape": list(fc.shape), "blocks": int(got.size)}
    with torch.no_grad():
        for p, q in zip(plain._all_params(), int8._all_params()):
            p.copy_(q)
    loaded = audited(plain, "plain loaded with the int8 state", 1)
    check(loaded.digest == ires.digest,
          "(aa2) the plain trainer holding the int8 trainer's state gave another digest")
    chaos.seed(SEED)
    sentinel.corrupt_silent(plain._all_params(), chaos.Plan(site="train.params", kind="silent"))
    flipped = plain.sentinel.audit_now(plain, 1)
    check(flipped.equal and flipped.digest != loaded.digest,
          "(aa2) a flipped parameter bit did not change the digest")
    del plain, int8, fc
    # ZeRO-1
    env = aa_env(get_env, MLSL_SENTINEL_EVERY="1")
    settle(torch)
    tr, batches = build_zero1_resnet(torch, env, np, distributed_update=True)
    reset_launches()
    loss = tr.step_accum(batches)
    torch.cuda.synchronize()
    used["zero1"] = launches()
    check(bool(torch.isfinite(loss).all()), f"(aa2) ZeRO-1: losses {loss.reshape(-1)}")
    res, ms = timed_audit(torch, tr, 1)
    _, sh = tr._audit_state()
    check(res.equal and len(sh["du_opt_state"]) == 2 * len(tr.layers),
          f"(aa2) ZeRO-1: {len(sh['du_opt_state'])} owned leaves")
    chaos.seed(SEED)
    sentinel.corrupt_silent(tr.opt_state["fc"], chaos.Plan(site="train.opt_state",
                                                           kind="silent"),
                            tr.dist.topology.grid_shape)
    flipped = tr.sentinel.audit_now(tr, 1)
    check(flipped.equal and flipped.digest != res.digest,
          "(aa2) ZeRO-1: a flipped bit of one rank's shard did not change the digest")
    rec["zero1"] = {"digest": res.digest[:16], "blocks": res.blocks, "audit_ms": ms,
                    "owned_leaves": len(sh["du_opt_state"])}
    del tr, batches, sh
    rec["launches"] = used
    return used, rec, bucketed


def phase_integrity_chkp(torch, np, get_env, launches, reset_launches, bucketed, dev):
    """(aa3): MLSL_CHKP=1 refuses a bucket member of the wrong count at the
    pack; MLSL_CHKP=2: of three allreduces started together, the one holding
    a NaN raises at the round's first wait, named by its count, with one host
    read; a data.prefetch bitrot plan on (w2)'s int8 wire decodes finite but
    different values, and the next epoch replays the clean copy the cache
    kept. -> (launches, record)."""
    from mlsl_tpu_torch import chaos
    from mlsl_tpu_torch.core import stats
    from mlsl_tpu_torch.data import DeviceFeed
    from mlsl_tpu_torch.data.wire import ROW_TILE
    from mlsl_tpu_torch.log import MLSLError

    rec = {}
    ps = bucketed._pset(bucketed.layers[-1])
    os.environ["MLSL_CHKP"] = "1"
    short = torch.zeros((*bucketed.dist.topology.grid_shape, 7), device=dev)
    try:
        ps.start_gradient_comm(short)
        refused = ""
    except MLSLError as e:
        refused = str(e)
    check("OUT_OF_RANGE" in refused, f"(aa3) the short bucket member was not refused: "
                                     f"{refused!r}")
    rec["bucket_refusal"] = refused
    del ps, short, bucketed
    env = aa_env(get_env, MLSL_CHKP="2")
    settle(torch)
    stats.reset_chkp_counters()
    dist = env.create_distribution(WORLD, 1)
    counts = (AA_CHKP_N, AA_CHKP_N + 256, AA_CHKP_N + 512)
    bufs = []
    for i, n in enumerate(counts):
        b = torch.ones((*dist.topology.grid_shape, n), device=dev)
        if i == 1:
            b[0, 3, 0, 0, 12345] = float("nan")
        bufs.append(b)
    from mlsl_tpu_torch import DataType, GroupType, ReductionType

    reqs = [dist.all_reduce(b, n, DataType.FLOAT, ReductionType.SUM, GroupType.DATA)
            for b, n in zip(bufs, counts)]
    try:
        env.wait(reqs[0])
        msg = ""
    except MLSLError as e:
        msg = str(e)
    check(f"allreduce[{counts[1]}]" in msg and f"allreduce[{counts[0]}]" not in msg,
          f"(aa3) the first wait did not name the NaN buffer: {msg!r}")
    out = env.wait(reqs[2])
    check(bool((out == WORLD).all()), "(aa3) a clean round's sum is wrong")
    kc = dict(stats.CHKP_COUNTERS)
    check(kc["value_checks"] == 3 and kc["value_syncs"] == 1 and kc["violations"] == 1,
          f"(aa3) CHKP counters {kc}")
    rec["nan_raised_at_first_wait"], rec["chkp_requests"] = msg, kc
    del reqs, bufs, out
    # the feed: two config-5 float batches on the int8 wire, a cache that
    # holds one of them, three streamed epochs
    rng = np.random.default_rng(SEED + 42)
    floats = [(rng.normal(size=(FEED_BATCH, FEED_IMAGE, FEED_IMAGE, 3)).astype(np.float32),
               rng.integers(0, FEED_CLASSES, size=(FEED_BATCH,)).astype(np.int32))
              for _ in range(2)]
    n = FEED_BATCH // WORLD * FEED_IMAGE * FEED_IMAGE * 3
    unit = BLOCK * ROW_TILE
    npad = -(-n // unit) * unit
    wire = WORLD * (npad + npad // BLOCK * 4) + FEED_BATCH * 4
    stats.reset_chkp_counters()
    reset_launches()
    feed = DeviceFeed(lambda: iter(floats), dist.topology, wire="int8",
                      cache_mb=1.5 * wire / 2**20, epochs=3, quant_block=BLOCK, device=dev)
    it = iter(feed)
    clean = next(it)[0].clone()
    next(it)
    check(len(feed.cache) == 1, f"(aa3) the feed cache holds {len(feed.cache)} batches")
    plan = chaos.plan("data.prefetch", "bitrot", after=1)
    rotted = next(it)[0].clone()
    check(plan.fires == 1, "(aa3) the bitrot plan did not fire on epoch 1's first read")
    check(bool(torch.isfinite(rotted).all()) and not torch.equal(rotted, clean),
          "(aa3) the rotted batch is not finite, or equals the clean one")
    next(it)
    check(torch.equal(next(it)[0], clean), "(aa3) epoch 2 did not replay the clean copy")
    torch.cuda.synchronize()
    used = launches()
    kc = dict(stats.CHKP_COUNTERS)
    check(kc["value_syncs"] == 5 and kc["violations"] == 0,
          f"(aa3) the decoded batches' checks: {kc}")
    chaos.clear()
    rec["feed"] = {"rotted_elements": int((rotted != clean).sum()), "chkp": kc,
                   "cache_batches": len(feed.cache)}
    del feed, it, clean, rotted, floats
    os.environ.pop("MLSL_CHKP", None)
    return used, rec


def phase_autoconfig(get_env, dev):
    """(aa4): MLSL_AUTO_CONFIG_TYPE=1 applies the probed card's class and row
    (the HBM-keyed entries by the JAX package's formulas); an exported knob
    wins. -> record."""
    from mlsl_tpu_torch import sysinfo
    from mlsl_tpu_torch.config import Config

    si = sysinfo.probe(dev.index)
    cls = sysinfo.device_class(si)
    check(cls == "gpu-hopper", f"(aa4) the card {si.device_kind} {si.capability} is class "
                               f"{cls!r}")
    want = dict(sysinfo._CLASS_DEFAULTS[cls])
    want["large_msg_size_mb"] = min(want["large_msg_size_mb"],
                                    max(8, si.memory_per_device // (64 << 20)))
    want["gather_device_limit_mb"] = max(256, si.memory_per_device // (4 << 20))
    env = aa_env(get_env, MLSL_AUTO_CONFIG_TYPE="1")
    got = {k: getattr(env.config, k) for k in want}
    check(got == want, f"(aa4) applied {got}, the row is {want}")
    default = Config()
    changed = {k: (getattr(default, k), v) for k, v in want.items() if getattr(default, k) != v}
    env = aa_env(get_env, MLSL_AUTO_CONFIG_TYPE="1", MLSL_LARGE_MSG_CHUNKS="3",
                 MLSL_GATHER_DEVICE_LIMIT_MB="1024")
    check(env.config.large_msg_chunks == 3 and env.config.gather_device_limit_mb == 1024
          and env.config.large_msg_size_mb == want["large_msg_size_mb"],
          "(aa4) an exported knob did not win over the row")
    return {"class": cls, "memory_gib": round(si.memory_per_device / 2**30, 2), "row": got,
            "changed_from_default": changed}


def start_compile_cache_runs():
    """(aa5), beside the card tests: one process builds AA_CACHE_SOURCE cold
    into a fresh MLSL_COMPILE_CACHE_DIR, then a second loads it with nvcc
    refused. -> (thread, results, the directory)."""
    import tempfile

    cache = tempfile.mkdtemp(prefix="mlsl_compile_cache_")
    results = {}

    def run():
        env = dict(os.environ, MLSL_COMPILE_CACHE_DIR=cache)
        for warm in (False, True):
            prog = AA_CACHE_PROG.format(root=str(ROOT), warm=warm, name=AA_CACHE_SOURCE)
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True,
                               text=True, timeout=300)
            results["warm" if warm else "cold"] = (r.returncode, r.stdout, r.stderr[-2000:],
                                                   time.perf_counter() - t0)

    thread = threading.Thread(target=run, name="compile-cache-runs")
    thread.start()
    return thread, results, cache


def phase_compile_cache(thread, results, cache) -> dict:
    import shutil

    thread.join(timeout=600)
    check(not thread.is_alive() and set(results) == {"cold", "warm"},
          "(aa5) the compile-cache processes did not finish")
    rec = {}
    for key, built in (("cold", [AA_CACHE_SOURCE]), ("warm", [])):
        rc, out, err, secs = results[key]
        check(rc == 0, f"(aa5) the {key} process failed: rc {rc}\n{err}")
        got = json.loads(out.strip().splitlines()[-1])
        check(got["dir"] == str(Path(cache).resolve()) and got["built"] == built,
              f"(aa5) {key}: {got}")
        check((Path(cache) / got["lib"]).is_file(), f"(aa5) {key}: no library in the cache")
        rec[key] = {"process_s": secs, "load_s": got["load_s"], "built": got["built"]}
    shutil.rmtree(cache, ignore_errors=True)
    return rec


def run_integrity(torch, np, get_env, launches, reset_launches, dev):
    """Run (aa), (aa1)-(aa4), beside the card tests: the gate, the audit, the
    checker and the device class's defaults, a ``# phase`` line each, with
    cuDNN's deterministic convolutions for the twins; none of its knobs is
    left exported. -> (launches by part, lines)."""
    lines, used = [], {}
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for engine, key in ((False, "integrity_gate_host"), (True, "integrity_gate_engine")):
            t0 = time.perf_counter()
            used[key], rec = phase_integrity_gate(torch, np, get_env, launches, reset_launches,
                                                  engine)
            lines.append(f"# integrity aa1 {json.dumps(rec)}")
            lines.append(f"# phase integrity gate, {rec['tag']} (run (aa1)): ok in "
                         f"{time.perf_counter() - t0:.1f} s, launches {json.dumps(used[key])}")
        t0 = time.perf_counter()
        aa2, rec, bucketed = phase_integrity_audit(torch, np, get_env, launches,
                                                   reset_launches)
        used.update({f"integrity_audit_{k}": v for k, v in aa2.items()})
        lines.append(f"# integrity aa2 {json.dumps(rec)}")
        lines.append(f"# phase integrity audit (run (aa2)): ok in "
                     f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        used["integrity_feed"], rec = phase_integrity_chkp(torch, np, get_env, launches,
                                                           reset_launches, bucketed, dev)
        del bucketed
        lines.append(f"# integrity aa3 {json.dumps(rec)}")
        lines.append(f"# phase integrity checker (run (aa3)): ok in "
                     f"{time.perf_counter() - t0:.1f} s, launches "
                     f"{json.dumps(used['integrity_feed'])}")
        t0 = time.perf_counter()
        rec = phase_autoconfig(get_env, dev)
        lines.append(f"# integrity aa4 {json.dumps(rec)}")
        lines.append(f"# phase autoconfig (run (aa4)): ok in {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        for k in AA_VARS:
            os.environ.pop(k, None)
    return used, lines


# -- recovery (run (ab)) --------------------------------------------------------------

# the knobs run (ab) sets; every sub-run starts with none of them exported,
# and the run ends with none
AB_VARS = ("MLSL_ALGO", "MLSL_MESH_TIERS", "MLSL_ELASTIC", "MLSL_ELASTIC_ADMIT_RETRIES",
           "MLSL_SENTINEL_EVERY", "MLSL_CKPT_RETRY_BACKOFF_S", "MLSL_CAPACITY_BUDGET")
AB_STEPS = 6                # (ab1), (ab3): steps of config 5 ZeRO-1 Adam
AB_ELASTIC_STEPS = 8        # (ab2): shrink at 3, grow at 4, shrink at 5, grow at 6
AB_POD_STEPS = 8            # (ab4): the member dies before step 1
AB_POD_INTERVAL = 0.1       # (ab4): heartbeat interval (s), 3 misses


def ab_env(get_env, **env_vars):
    """Finalize the Environment with run (ab)'s knobs reset and ``env_vars``
    exported: the loop's factory initializes it again, on the card, over the
    active world."""
    get_env().finalize()
    for k in AB_VARS:
        os.environ.pop(k, None)
    os.environ.update(env_vars)


class ABRun:
    """Config 5 at full width (ResNet-50, 1,000 classes, 224², global batch
    64, seed 0) with ZeRO-1 Adam and the clip as run (e) has them, built by
    an elastic factory over the active world; each step's batch from a seed
    of its own, cached on the host."""

    def __init__(self, torch, np, get_env, image=224, classes=1000, batch=ZERO1_BATCH):
        self.torch, self.np, self.get_env = torch, np, get_env
        self.image, self.classes, self.batch = image, classes, batch
        self._host = {}
        self.built = 0
        self.last = None      # the trainer the loop last handed the batch function
        self.calls = []       # the steps the loop asked batches for

    def make(self):
        from mlsl_tpu_torch import optim
        from mlsl_tpu_torch.models import resnet
        from mlsl_tpu_torch.models.train import DataParallelTrainer

        env = self.get_env().init()          # the card; the active world
        gen = self.torch.Generator().manual_seed(SEED)
        model = resnet.ResNet50(num_classes=self.classes, generator=gen, device=env.device)
        dist = env.create_distribution(env.get_process_count(), 1)
        sess = env.create_session()
        sess.set_global_minibatch_size(self.batch)
        self.built += 1
        return DataParallelTrainer(env, dist, sess, model, resnet.loss_fn,
                                   resnet.layer_names(model), resnet.layer_subtree,
                                   distributed_update=True, optimizer=optim.adam(ZERO1_LR),
                                   clip_global_norm=ZERO1_CLIP)

    def batch_fn(self, trainer, step):
        if step not in self._host:
            rng = self.np.random.default_rng(SEED + 100 + step)
            self._host[step] = (
                rng.normal(size=(self.batch, self.image, self.image, 3)).astype(self.np.float32),
                rng.integers(0, self.classes, size=(self.batch,)).astype(self.np.int32))
        self.last = trainer
        self.calls.append(step)
        return trainer.shard_batch(*self._host[step])


def _ab_leaves(trainer) -> list:
    """The parameters and every ZeRO-1 Adam leaf, in a checkpoint's order."""
    from mlsl_tpu_torch.checkpoint import _trainer_state
    from mlsl_tpu_torch.sentinel import tree_leaves

    st = _trainer_state(trainer, 0)
    return tree_leaves(st["params"]) + tree_leaves(st["du_opt_state"])


def ab_state(trainer) -> list:
    return [t.detach().clone() for t in _ab_leaves(trainer)]


def ab_load(torch, trainer, state) -> None:
    dst = _ab_leaves(trainer)
    check(len(dst) == len(state), "run (ab): state layouts differ")
    with torch.no_grad():
        for d, s in zip(dst, state):
            d.copy_(s)


def ab_twin_step(torch, run, state, step, ranks):
    """A trainer built directly on ``ranks`` (None: the full world), loaded
    with ``state``, one step at ``step``'s batch. -> its state after."""
    from mlsl_tpu_torch import elastic

    run.get_env().finalize()
    elastic._set_active(ranks)
    try:
        twin = run.make()
        ab_load(torch, twin, state)
        twin.step(run.batch_fn(twin, step))
        torch.cuda.synchronize()
        return ab_state(twin)
    finally:
        elastic._set_active(None)
        run.get_env().finalize()


def phase_recovery_ckpt(torch, np, get_env, launches, reset_launches, run, tmp):
    """(ab1): FaultTolerantLoop, save_every 2, 6 steps: an OSError at the
    first save retried, a bitrot plan on the newest step (4), a fault at step
    5 from the loop's fault hook. The restore skips the rotted step, takes
    step 2 and replays; the final state is the uninterrupted twin's bit for
    bit. The write of step 2 is held until step 3 has updated Adam's state
    in place: the checkpoint still holds step 2's. -> (launches, record,
    the twin's final state)."""
    from mlsl_tpu_torch import chaos
    from mlsl_tpu_torch.checkpoint import CheckpointManager
    from mlsl_tpu_torch.core import stats as stats_mod
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    ab_env(get_env, MLSL_ALGO="pallas_ring", MLSL_SENTINEL_EVERY="1",
           MLSL_CKPT_RETRY_BACKOFF_S="0.01")
    twin = run.make()
    at2 = None
    for s in range(AB_STEPS):
        twin.step(run.batch_fn(twin, s))
        if s == 2:
            at2 = ab_state(twin)
    torch.cuda.synchronize()
    want = ab_state(twin)
    del twin
    get_env().finalize()
    settle(torch)

    gate = threading.Event()
    seen, rec = [], {}

    def hook(step, attempt):
        if step == 4 and attempt == 0 and not rec.get("bitrot"):
            rec["bitrot"] = chaos.plan("checkpoint.save", "bitrot", times=1)
        if step == 5 and attempt == 0 and not rec.get("faulted"):
            rec["faulted"] = True
            raise RuntimeError("run (ab1): fault at step 5")

    def on_step(step, loss):
        seen.append(step)
        if step == 3:
            gate.set()

    loop = FaultTolerantLoop(run.make, str(tmp / "ab1"), save_every=2, fault_hook=hook)
    write = loop.ckpt._write

    def held_write(step, path, snap):
        if step == 2:
            check(gate.wait(600), "run (ab1): step 3 never ran")
        t0 = time.perf_counter()
        write(step, path, snap)
        rec.setdefault("write_ms", []).append((time.perf_counter() - t0) * 1e3)

    loop.ckpt._write = held_write
    oserr = chaos.plan("checkpoint.save", "error", exc=OSError, times=1)
    stats_mod.reset_sentinel_counters()
    run.calls = []
    reset_launches()
    dispatch = []
    save = loop.ckpt.save

    def timed_save(*a, **k):
        save(*a, **k)
        dispatch.append(loop.ckpt.timings["dispatch_ms"])

    loop.ckpt.save = timed_save
    t0 = time.perf_counter()
    final = loop.run(run.batch_fn, steps=AB_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    used = launches()
    got = ab_state(final)
    check(oserr.fires == 1 and rec["bitrot"].fires == 1,
          f"run (ab1): plans fired {oserr.fires}, {rec['bitrot'].fires}")
    check(loop.recoveries == 1, f"run (ab1): {loop.recoveries} recoveries, expected 1")
    check(seen == list(range(AB_STEPS)), f"run (ab1): on_step fired at {seen}")
    # the fault at 5 restored step 2 (the bitrotted 4 skipped) and replayed 3, 4
    check(run.calls == [0, 1, 2, 3, 4, 3, 4, 5], f"run (ab1): batches at {run.calls}")
    check(len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)),
          "run (ab1): the recovered state differs from the uninterrupted twin's")
    sc = dict(stats_mod.SENTINEL_COUNTERS)
    check(sc["reaudits"] == 1 and sc["audit_mismatch"] == 0 and sc["verified_saves"] >= 3,
          f"run (ab1): sentinel counters {sc}")
    check(all(loop.ckpt.recorded_fingerprint(s) for s in loop.ckpt.all_steps()),
          "run (ab1): a checkpoint without the audit's fingerprint")
    ck = CheckpointManager(loop.ckpt.directory)
    h0 = time.perf_counter()
    verified = ck.verify(2)
    sha_ms = (time.perf_counter() - h0) * 1e3
    check(verified is True, "run (ab1): step 2 fails its checksum")
    state = ck.restore(2, template={"t": got[0]})
    from mlsl_tpu_torch.sentinel import tree_leaves

    held = [t for k in ("params", "du_opt_state") for t in tree_leaves(state[k])]
    check(len(held) == len(at2) and all(torch.equal(a, b) for a, b in zip(held, at2)),
          "run (ab1): the async save of step 2 does not hold step 2's state")
    nbytes = loop.ckpt.timings["bytes"]
    del held, state, got, final
    loop.ckpt.close()
    get_env().finalize()
    out = {"steps": AB_STEPS, "recoveries": loop.recoveries, "on_step": seen,
           "resumed_from": 2, "skipped_bitrot_step": 4, "secs": secs,
           "save_dispatch_ms": dispatch, "write_ms": rec.get("write_ms"),
           "restore_ms": loop.ckpt.timings.get("restore_ms"),
           "sha256_ms_a_checkpoint": sha_ms, "bytes_a_checkpoint": nbytes,
           "sentinel": sc, "launches": used}
    return used, out, want


def ab_coordinator(launches, **kw):
    """An ElasticCoordinator that keeps what (ab2) checks: the launches and
    timings of each reshard, the state right after it and the harvested
    ZeRO-1 vectors."""
    from mlsl_tpu_torch import elastic

    class Coordinator(elastic.ElasticCoordinator):
        def _harvest(self, trainer):
            before = dict(launches())
            out = super()._harvest(trainer)
            after = launches()
            self.drains.append({k: after[k] - before.get(k, 0) for k in after
                                if after[k] != before.get(k, 0)})
            self.harvests.append(out)
            return out

        def shrink(self, trainer, make_trainer, error=None, step=0):
            new = super().shrink(trainer, make_trainer, error=error, step=step)
            self.events.append(("shrink", step, ab_state(new), dict(self.timings)))
            return new

        def grow(self, trainer, make_trainer, step):
            new = super().grow(trainer, make_trainer, step)
            self.events.append(("grow", step, ab_state(new), dict(self.timings)))
            return new

    c = Coordinator(**kw)
    c.drains, c.harvests, c.events = [], [], []
    return c


def ab_owned_oracle(np, trainer, harvest) -> bool:
    """Every owned Adam leaf on the rebuilt world equals the gathered vector
    re-partitioned: the real elements, zero-padded to the new world's chunks."""
    from mlsl_tpu_torch.sentinel import tree_leaves

    for name in trainer.layers:
        count, padded = trainer.layer_counts[name], trainer.padded_counts[name]
        for old, new in zip(harvest["du"][name], tree_leaves(trainer.opt_state[name])):
            if not isinstance(old, np.ndarray):
                continue      # the one step count, carried
            want = np.pad(np.asarray(old).reshape(-1)[:count], (0, padded - count))
            if not np.array_equal(new.detach().reshape(-1).cpu().numpy(), want):
                return False
    return True


def phase_recovery_elastic(torch, np, get_env, launches, reset_launches, run, tmp):
    """(ab2): MLSL_MESH_TIERS=2x4, MLSL_ELASTIC=1. A device.lost plan at step
    3 (the default attribution names rank 7, of tier 1) drops the whole tier
    (8 -> 4): the ZeRO-1 drain on B3-AG, verify_reshard green, the owned
    Adam state re-partitioned exactly, the loop on at step 3 with no restore;
    step 3 a 4-rank twin's bit for bit. announce_return() before step 4:
    the grow through a passing audit, step 4 an 8-rank twin's bit for bit.
    A second loss at step 5 and a grow at step 6 under a silent device.lost
    plan: refused, re-synced, admitted (MLSL_ELASTIC_ADMIT_RETRIES=1).
    -> (launches, record)."""
    from mlsl_tpu_torch import chaos, elastic
    from mlsl_tpu_torch.analysis import diagnostics
    from mlsl_tpu_torch.core import stats as stats_mod
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    ab_env(get_env, MLSL_ALGO="pallas_ring", MLSL_MESH_TIERS="2x4", MLSL_ELASTIC="1",
           MLSL_ELASTIC_ADMIT_RETRIES="1")
    get_env().init()
    coord = ab_coordinator(launches, capacity_budget=8, admit_retries=1)
    get_env().finalize()
    plans, after_step, seen = {}, {}, []

    def hook(step, attempt):
        if step in (3, 5) and step not in plans:
            plans[step] = chaos.plan("device.lost", "error", times=1)

    def on_step(step, loss):
        seen.append(step)
        if step in (3, 4):
            after_step[step] = ab_state(run.last)
        if step in (3, 5):
            # capacity is back: the loop's next between-steps poll grows; the
            # second time a silent plan corrupts the rejoining copy
            if step == 5:
                plans[6] = chaos.plan("device.lost", "silent", times=1)
            coord.announce_return()

    stats_mod.reset_elastic_counters()
    diagnostics.reset()
    reset_launches()
    t0 = time.perf_counter()
    loop = FaultTolerantLoop(run.make, str(tmp / "ab2"), save_every=100, fault_hook=hook,
                             elastic=coord)
    final = loop.run(run.batch_fn, steps=AB_ELASTIC_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    used = launches()
    ec = dict(stats_mod.ELASTIC_COUNTERS)
    check(plans[3].fires == 1 and plans[5].fires == 1 and plans[6].fires == 1,
          "run (ab2): a device.lost plan did not fire")
    check(loop.recoveries == 0 and seen == list(range(AB_ELASTIC_STEPS)),
          f"run (ab2): {loop.recoveries} recoveries, on_step {seen}")
    check(final.dist.topology.world_size == WORLD and elastic.active_devices() is None,
          "run (ab2): the world did not grow back to 8")
    kinds = [(k, s) for k, s, _, _ in coord.events]
    check(kinds == [("shrink", 3), ("grow", 4), ("shrink", 5), ("grow", 6)],
          f"run (ab2): transitions {kinds}")
    n_owned = 2 * len(final.layers)
    check(all(d.get("dense_ring_gather", 0) == n_owned and set(d) == {"dense_ring_gather"}
              for d in coord.drains),
          f"run (ab2): drain launches {coord.drains}, expected {n_owned} B3-AG each")
    check(diagnostics.status()["plan"]["verdict"] == "pass", "run (ab2): a reshard plan failed")
    # the shrink's placement against the numpy re-partition, and the twins
    shrink_state = coord.events[0][2]
    harvest = coord.harvests[0]
    twin3 = ab_twin_step(torch, run, shrink_state, 3, (0, 1, 2, 3))
    check(all(torch.equal(a, b) for a, b in zip(twin3, after_step[3])),
          "run (ab2): step 3 on the survivors differs from a 4-rank twin's")
    del twin3
    twin4 = ab_twin_step(torch, run, coord.events[1][2], 4, None)
    check(all(torch.equal(a, b) for a, b in zip(twin4, after_step[4])),
          "run (ab2): step 4 after the grow differs from an 8-rank twin's")
    del twin4
    # the placement oracle on a 4-rank trainer loaded with the shrink's state
    elastic._set_active((0, 1, 2, 3))
    probe = run.make()
    ab_load(torch, probe, shrink_state)
    placed_ok = ab_owned_oracle(np, probe, harvest)
    del probe
    elastic._set_active(None)
    get_env().finalize()
    check(placed_ok, "run (ab2): the owned Adam state is not the gathered vector re-partitioned")
    layers = len(final.layers)
    want_ec = {"device_losses": 2, "shrinks": 2, "grows": 2, "grow_abandons": 0, "admits": 2,
               "admit_rejects": 1, "resyncs": 1, "reshard_buffers": 4 * 3 * layers,
               "restart_fallbacks": 0}
    check(ec == want_ec, f"run (ab2): ELASTIC counters {ec}, expected {want_ec}")
    out = {"steps": AB_ELASTIC_STEPS, "secs": secs, "transitions": kinds,
           "worlds": [8, 4, 8, 4, 8], "survivors": [0, 1, 2, 3],
           "drain_launches": coord.drains,
           "reshards": [{"kind": k, "step": s, **{t: round(v, 4) for t, v in tm.items()}}
                        for k, s, _, tm in coord.events],
           "elastic": ec, "launches": used}
    del coord, final, after_step, shrink_state, harvest
    loop.ckpt.close()
    get_env().finalize()
    return used, out


def phase_recovery_preempt(torch, np, get_env, launches, reset_launches, run, tmp, want):
    """(ab3): SIGTERM to this process after step 2: exactly one final save,
    the loop returns ``preempted``; a new loop resumes from it and ends bit
    for bit on (ab1)'s uninterrupted twin. -> (launches, record)."""
    import signal

    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    ab_env(get_env, MLSL_ALGO="pallas_ring", MLSL_SENTINEL_EVERY="1")

    def on_step(step, loss):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    reset_launches()
    t0 = time.perf_counter()
    loop = FaultTolerantLoop(run.make, str(tmp / "ab3"), save_every=10)
    loop.run(run.batch_fn, steps=AB_STEPS, on_step=on_step)
    check(loop.preempted, "run (ab3): the loop did not return preempted")
    check(loop.ckpt.all_steps() == [0, 2] and loop.ckpt.verify(2) is True,
          f"run (ab3): checkpoints {loop.ckpt.all_steps()}, expected the cadence's 0 and one "
          "final save at 2")
    loop.ckpt.close()
    get_env().finalize()
    seen = []
    loop2 = FaultTolerantLoop(run.make, str(tmp / "ab3"), save_every=10)
    final = loop2.run(run.batch_fn, steps=AB_STEPS, on_step=lambda s, l: seen.append(s))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    used = launches()
    check(not loop2.preempted and seen == list(range(3, AB_STEPS)),
          f"run (ab3): the resumed loop stepped {seen}")
    got = ab_state(final)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "run (ab3): the resumed run differs from the uninterrupted twin")
    del got, final
    loop2.ckpt.close()
    get_env().finalize()
    return used, {"preempted_at": 2, "checkpoints": [0, 2], "resumed": seen, "secs": secs,
                  "restore_ms": loop2.ckpt.timings.get("restore_ms"), "launches": used}


def phase_recovery_pod(torch, np, get_env, launches, reset_launches, run, tmp):
    """(ab4): an in-process 3-member pod on 127.0.0.1 (this process is rank 0;
    members 1 and 2 contribute ranks 4-5 and 6-7). Member 1 dies before step
    1; the pod commits one epoch and the committed loss drives (ab2)'s shrink
    on the card trainer (tier 1 drops: 8 -> 4) with zero restores.
    -> (launches, record)."""
    from mlsl_tpu_torch import control, elastic
    from mlsl_tpu_torch.control.plane import ControlPlane
    from mlsl_tpu_torch.resilience import FaultTolerantLoop

    ab_env(get_env, MLSL_ALGO="pallas_ring", MLSL_MESH_TIERS="2x4", MLSL_ELASTIC="1")
    dmap = {0: (0, 1, 2, 3), 1: (4, 5), 2: (6, 7)}
    planes = [ControlPlane(r, [("127.0.0.1", 0)] * 3, device_map=dmap if r == 0 else None,
                           interval_s=AB_POD_INTERVAL, misses=3, grace_s=5.0)
              for r in range(3)]
    try:
        for p in planes:
            p.start()
        addrs = [("127.0.0.1", p.listen_port) for p in planes]
        for p in planes:
            p.addrs = addrs
        control.set_active(planes[0])
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(
                len(p.status()["hb_age_s"]) == 2 for p in planes):
            time.sleep(0.02)
        check(all(len(p.status()["hb_age_s"]) == 2 for p in planes),
              "run (ab4): the pod never formed")
        killed = {}

        def hook(step, attempt):
            if step == 1 and "t" not in killed:
                killed["t"] = time.monotonic()
                planes[1].kill()

        def batch_fn(trainer, step):
            if trainer.dist.topology.world_size == WORLD and "t" in killed:
                # hold the full world until the commit lands, as a pod whose
                # collectives stall on a dead member would
                end = killed["t"] + 10 * AB_POD_INTERVAL * 3
                while time.monotonic() < end and planes[0].status()["epoch"] == 0:
                    time.sleep(0.01)
            return run.batch_fn(trainer, step)

        reset_launches()
        t0 = time.perf_counter()
        loop = FaultTolerantLoop(run.make, str(tmp / "ab4"), save_every=100, fault_hook=hook,
                                 elastic=elastic.ElasticCoordinator(capacity_budget=4))
        final = loop.run(batch_fn, steps=AB_POD_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        used = launches()
        commits = [e for e in planes[0].events if e["kind"] == "commit"]
        check(loop.recoveries == 0 and final.dist.topology.world_size == 4,
              f"run (ab4): {loop.recoveries} restores, world {final.dist.topology.world_size}")
        check(len(commits) == 1 and commits[0]["dead"] == [1] and
              planes[0].status()["alive"] == [0, 2],
              f"run (ab4): commits {commits}")
        detect_s = commits[0].get("detect_s")
        loop.ckpt.close()
        del final
        return used, {"steps": AB_POD_STEPS, "restores": loop.recoveries, "epochs": len(commits),
                      "survivor_ranks": list(elastic.active_devices() or ()),
                      "detect_s": detect_s, "secs": secs, "launches": used}
    finally:
        for p in planes:
            p.stop()
        control.reset()
        get_env().finalize()


def run_recovery(torch, np, get_env, launches, reset_launches, dev):
    """Run (ab), (ab1)-(ab4), beside the card tests, with cuDNN's
    deterministic convolutions for the twins; each part ends with
    ``supervisor.reset_all()`` and none of its knobs is left exported.
    -> (launches by part, lines)."""
    import tempfile

    from mlsl_tpu_torch import supervisor

    lines, used = [], {}
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    run = ABRun(torch, np, get_env)
    try:
        with tempfile.TemporaryDirectory(prefix="mlsl-ab-") as d:
            tmp = Path(d)
            t0 = time.perf_counter()
            used["recovery_ckpt"], rec, want = phase_recovery_ckpt(
                torch, np, get_env, launches, reset_launches, run, tmp)
            supervisor.reset_all()
            lines.append(f"# recovery ab1 {json.dumps(rec)}")
            lines.append(f"# phase recovery checkpoint and restart (run (ab1)): ok in "
                         f"{time.perf_counter() - t0:.1f} s")
            settle(torch)
            t0 = time.perf_counter()
            used["recovery_elastic"], rec = phase_recovery_elastic(
                torch, np, get_env, launches, reset_launches, run, tmp)
            supervisor.reset_all()
            lines.append(f"# recovery ab2 {json.dumps(rec)}")
            lines.append(f"# phase recovery elastic shrink and grow (run (ab2)): ok in "
                         f"{time.perf_counter() - t0:.1f} s")
            settle(torch)
            t0 = time.perf_counter()
            used["recovery_preempt"], rec = phase_recovery_preempt(
                torch, np, get_env, launches, reset_launches, run, tmp, want)
            del want
            supervisor.reset_all()
            lines.append(f"# recovery ab3 {json.dumps(rec)}")
            lines.append(f"# phase recovery preemption (run (ab3)): ok in "
                         f"{time.perf_counter() - t0:.1f} s")
            settle(torch)
            t0 = time.perf_counter()
            used["recovery_pod"], rec = phase_recovery_pod(
                torch, np, get_env, launches, reset_launches, run, tmp)
            supervisor.reset_all()
            lines.append(f"# recovery ab4 {json.dumps(rec)}")
            lines.append(f"# phase recovery control plane (run (ab4)): ok in "
                         f"{time.perf_counter() - t0:.1f} s, trainers built {run.built}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        for k in AB_VARS:
            os.environ.pop(k, None)
        supervisor.reset_all()
        settle(torch)
    return used, lines


# -- static analysis (run (ac)) ---------------------------------------------------------

# the knobs run (ac) sets besides ALGO_VARS; every part starts with none of
# them exported
AC_VARS = ("MLSL_VERIFY", "MLSL_VERIFY_SEVERITY")
AC_BUCKET_MB = "25"         # (ac1): int8 gradients in 25 MiB buckets


def ac_env(get_env, dev, **env_vars):
    """Initialise the Environment again on the card with run (ac)'s knobs
    reset and ``env_vars`` exported."""
    get_env().finalize()
    for k in AC_VARS + ALGO_VARS:
        if k != "MLSL_STATS_DIR":     # run (ac)'s own, for its ANALYSIS lines
            os.environ.pop(k, None)
    os.environ.update(env_vars)
    return get_env().init(device=dev, world_size=WORLD)


class CommitClock:
    """Times every ``Session.commit`` while it is entered and keeps what the
    commit recorded: its milliseconds and the plan verifier's and the
    protocol checker's verdicts (``supervisor.status()["analysis"]``) just
    after it."""

    def __init__(self):
        self.commits = []

    def __enter__(self):
        from mlsl_tpu_torch.analysis import diagnostics
        from mlsl_tpu_torch.core.session import Session

        self._real = real = Session.commit
        commits = self.commits

        def commit(sess):
            t0 = time.perf_counter()
            real(sess)
            st = diagnostics.status()
            commits.append({"commit_ms": (time.perf_counter() - t0) * 1e3,
                            "plan": dict(st["plan"]), "protocol": dict(st["protocol"])})

        Session.commit = commit
        return self

    def __exit__(self, *exc):
        from mlsl_tpu_torch.core.session import Session

        Session.commit = self._real
        return False


def ac_state(trainer) -> list:
    """The trainer's parameters, its optimizer state and every error-feedback
    residual (requests, buckets, the compiled engine's), cloned."""
    from mlsl_tpu_torch.sentinel import tree_leaves

    out = [p.detach().clone() for p in trainer._all_params()]
    for name in sorted(trainer.opt_state):
        out += [t.detach().clone() for t in tree_leaves(trainer.opt_state[name])
                if hasattr(t, "detach")]
    seen = set()
    for name in trainer.layers:
        ps = trainer.ops[name].get_parameter_set(0)
        for req in (ps.grad_req, ps.bucket.req if ps.bucket is not None else None):
            if req is None or id(req) in seen or not req._errs:
                continue
            seen.add(id(req))
            out += [e.detach().clone() for e in req._errs]
    if trainer._overlap is not None:
        out += [v.detach().clone() for _, v in sorted(trainer._overlap.residuals.items())]
    return out


def ac_twins(torch, np, get_env, launches, reset_launches, dev, tag, build, drive,
             **env_vars):
    """One (ac1) form: the trainer ``build(env)`` makes, committed with
    MLSL_VERIFY=0 and then 1, each driven once by ``drive(trainer, batch)``.
    -> (record, launches of the verified drive, the verified trainer's
    reduced-gradient request algorithms)."""
    from mlsl_tpu_torch.analysis import diagnostics

    runs = {}
    for verify in ("0", "1"):
        env = ac_env(get_env, dev, MLSL_VERIFY=verify, **env_vars)
        settle(torch)
        diagnostics.reset()
        with CommitClock() as clock:
            t0 = time.perf_counter()
            trainer, batch = build(env)
            build_s = time.perf_counter() - t0
        after = diagnostics.status()
        reset_launches()
        t0 = time.perf_counter()
        drive(trainer, batch)
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        used = {k: v for k, v in launches().items() if v}
        (commit,) = clock.commits
        runs[verify] = dict(state=ac_state(trainer), commit=commit, after=after, used=used,
                            build_s=build_s, drive_s=drive_s,
                            algos=sorted({trainer.ops[n].get_parameter_set(0).grad_req.algo
                                          for n in trainer.layers}),
                            buckets=len({id(trainer.ops[n].get_parameter_set(0).bucket)
                                         for n in trainer.layers
                                         if trainer.ops[n].get_parameter_set(0).bucket}),
                            engine=trainer._overlap is not None)
        del trainer, batch
    off, on = runs["0"], runs["1"]
    plan, proto = on["commit"]["plan"], on["commit"]["protocol"]
    check(off["commit"]["plan"]["verdict"] == "never_ran",
          f"ac1 {tag}: the verifier ran with MLSL_VERIFY=0")
    check(plan["verdict"] == "pass" and proto["verdict"] == "pass",
          f"ac1 {tag}: commit verdicts {plan}, {proto}")
    check(len(off["state"]) == len(on["state"]) and all(
        same_bits(torch, a, b) for a, b in zip(off["state"], on["state"])),
          f"ac1 {tag}: the verified step differs from its MLSL_VERIFY=0 twin's")
    check(off["used"] == on["used"] and off["algos"] == on["algos"],
          f"ac1 {tag}: launches {off['used']} / {on['used']}, algos {off['algos']} / "
          f"{on['algos']}")
    rec = {"tag": tag, "algos": on["algos"], "buckets": on["buckets"], "launches": on["used"],
           "state_tensors": len(on["state"]), "bit_for_bit": True,
           "commit_ms": on["commit"]["commit_ms"], "twin_commit_ms": off["commit"]["commit_ms"],
           "verify_ms": plan["duration_s"] * 1e3, "protocol_ms": proto["duration_s"] * 1e3,
           "build_s": on["build_s"], "drive_s": on["drive_s"],
           "twin_drive_s": off["drive_s"]}
    if on["engine"]:
        eng = on["after"]["plan"]
        check(eng["verdict"] == "pass" and eng["at"] != plan["at"],
              f"ac1 {tag}: the engine's plan was not verified where it was built: {eng}")
        rec["engine_verify_ms"] = eng["duration_s"] * 1e3
    return rec, on["used"], on["algos"]


def ac_staged_update(torch, trainer_counts, dev, launches, reset_launches):
    """The staged ZeRO-1 update over config 5's layer counts on pallas_ring:
    one call (B3 reduce-scatter + B3-AG all-gather a layer) held bit for
    bit to the same update on the plain versions. -> (launches, ms)."""
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
    from mlsl_tpu_torch.comm.overlap import build_zero1_update

    topo = Topology(WORLD, 1, WORLD)
    group = ProcessGroup(topo, ("data",))
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    params = [torch.randn((*topo.grid_shape, c), generator=gen, device=dev)
              for c in trainer_counts]
    grads = [torch.randn((*topo.grid_shape, c), generator=gen, device=dev)
             for c in trainer_counts]
    fn, units = build_zero1_update(group, trainer_counts, lr=ZERO1_LR, denom=float(WORLD),
                                   algo="pallas_ring")
    ref, _ = build_zero1_update(group, trainer_counts, lr=ZERO1_LR, denom=float(WORLD),
                                algo="pallas_ring", plain=True)
    check(all(u.algo == "pallas_ring" for u in units), "ac1 staged: a unit left pallas_ring")
    reset_launches()
    t0 = time.perf_counter()
    out = fn(params, grads)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    used = {k: v for k, v in launches().items() if v}
    want = ref(params, grads)
    check(all(same_bits(torch, a, b) for a, b in zip(out, want)),
          "ac1 staged: the kernels' update differs from the plain versions'")
    n = len(trainer_counts)
    check(used == {"dense_ring": n, "dense_ring_gather": n},
          f"ac1 staged: launches {used}, expected {n} B3 and {n} B3-AG")
    return used, ms


def tempfile_dir(prefix: str) -> str:
    import tempfile

    return tempfile.mkdtemp(prefix=prefix)


def start_analysis_cli(dev) -> list:
    """(ac4): the analysis CLI from the checkout, in three subprocesses
    started together: the lint gate, --concurrency, --graph on the run's
    device (the card). -> [(args, Popen, start time)]."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MLSL_")}
    env["MLSL_STATS_DIR"] = tempfile_dir("mlsl_ac4_")
    graph = ["--graph"] + ([] if dev.type == "cuda" else ["--device", dev.type])
    procs = []
    for args in ([], ["--concurrency"], graph):
        procs.append((args, subprocess.Popen(
            [sys.executable, "-m", "mlsl_tpu_torch.analysis", *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), time.perf_counter()))
    return procs


def join_analysis_cli(procs, timeout=300) -> list:
    """-> one record a CLI call; every call must exit 0 with no finding."""
    out = []
    for args, proc, t0 in procs:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SmokeFailure(f"ac4: analysis {args} not done in {timeout} s")
        summaries = [ln for ln in stderr.splitlines() if "error(s)" in ln]
        check(proc.returncode == 0 and summaries and all(
            "0 error(s), 0 warning(s)" in ln for ln in summaries),
              f"ac4: python -m mlsl_tpu_torch.analysis {' '.join(args)}: rc "
              f"{proc.returncode}, {stdout[-2000:]} {stderr[-2000:]}")
        out.append({"args": " ".join(args) or "(default: lint + locks)", "rc": proc.returncode,
                    "summaries": summaries, "s": time.perf_counter() - t0})
    return out


def ac_misordered(env):
    """tests/fixtures/analysis/misordered_groups.py on the card: the world
    group's 16 KiB gradient defers under MLSL_MSG_PRIORITY while a 4-rank
    color group's 1 KiB one dispatches at once (MLSL-A101)."""
    from mlsl_tpu_torch import OpType

    env.config.msg_priority = True
    env.config.msg_priority_threshold = 4096
    n = env.get_process_count()
    colors = env.create_distribution_with_colors([p // max(n // 2, 1) for p in range(n)],
                                                 [0] * n)
    world = env.create_distribution(n, 1)
    s = env.create_session()
    s.set_global_minibatch_size(max(8, n))
    for name, count, dist in (("sub_small", 256, colors), ("world_big", 4096, world)):
        r = s.create_operation_reg_info(OpType.CC)
        r.set_name(name)
        r.add_output(4, 4)
        r.add_parameter_set(count, 1)
        s.add_operation(r, dist)
    s.commit()
    return s


def run_analysis(torch, np, get_env, launches, reset_launches, dev, smi):
    """Run (ac), (ac1)-(ac4), beside the card tests, with cuDNN's
    deterministic convolutions for the twins; none of its knobs is left
    exported. -> (launches by part, lines)."""
    from mlsl_tpu_torch import OpType, supervisor
    from mlsl_tpu_torch.analysis import diagnostics
    from mlsl_tpu_torch.core import stats as stats_mod
    from mlsl_tpu_torch.log import MLSLError
    from mlsl_tpu_torch.models import resnet

    lines, used = [], {}
    stats_dir = tempfile_dir("mlsl_ac_")
    os.environ["MLSL_STATS_DIR"] = stats_dir
    cli = start_analysis_cli(dev)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        # (ac1) config 5 in three forms, each beside its MLSL_VERIFY=0 twin
        t0 = time.perf_counter()
        forms = []

        def step(trainer, batch):
            trainer.step(batch)

        rec, used["analysis_buckets"], algos = ac_twins(
            torch, np, get_env, launches, reset_launches, dev, "int8 buckets pallas_ring",
            lambda env: build_resnet_trainer(torch, env, np), step,
            MLSL_ALGO="pallas_ring", MLSL_GRAD_BUCKET_MB=AC_BUCKET_MB)
        check(algos == ["pallas_ring"] and rec["buckets"] > 0
              and used["analysis_buckets"].get("quant_ring", 0) > 0
              and used["analysis_buckets"].get("quantize_blocks", 0) > 0,
              f"ac1 buckets: algos {algos}, {rec['buckets']} buckets, launches "
              f"{used['analysis_buckets']}")
        forms.append(rec)

        def zero1(env):
            trainer, batches = build_zero1_resnet(torch, env, np, distributed_update=True,
                                                  micro=1)
            return trainer, batches[0]

        rec, used["analysis_zero1"], algos = ac_twins(
            torch, np, get_env, launches, reset_launches, dev, "zero1 adam pallas_ring",
            zero1, step, MLSL_ALGO="pallas_ring")
        check(algos == ["pallas_ring"] and used["analysis_zero1"].get("dense_ring", 0) > 0,
              f"ac1 zero1: algos {algos}, launches {used['analysis_zero1']}")
        counts = resnet.layer_param_counts(resnet.ResNet50(device="meta"))
        settle(torch)
        used["analysis_staged"], rec["staged_update_ms"] = ac_staged_update(
            torch, list(counts.values()), dev, launches, reset_launches)
        rec["staged_launches"] = used["analysis_staged"]
        forms.append(rec)

        def engine(env):
            return build_resnet_trainer(torch, env, np, overlap_compiled=True)

        def replay(trainer, batch):
            trainer.precompile(batch)
            check("step" in trainer._overlap.graphs, "ac1 engine: no captured step")
            trainer.step(batch)

        rec, used["analysis_engine"], _ = ac_twins(
            torch, np, get_env, launches, reset_launches, dev, "engine int8 fused ring",
            engine, replay, MLSL_ALGO="pallas_ring")
        check(used["analysis_engine"].get("quant_ring", 0) > 0,
              f"ac1 engine: launches {used['analysis_engine']}")
        forms.append(rec)
        for rec in forms:
            lines.append(f"# analysis ac1 {json.dumps(rec)} on {smi}")
        lines.append(f"# phase analysis config 5 verified (run (ac1)): ok in "
                     f"{time.perf_counter() - t0:.1f} s")
        settle(torch)

        # (ac2) run (m)'s graph on B3, B5 and B6, verified at commit
        t0 = time.perf_counter()
        recs = []
        for tag, spec, case in (("m1 model 2 ring", SPEC_RING, "case1"),
                                ("m1 model 2 rhd", SPEC_RHD, "case1"),
                                ("m3 case4 ring", SPEC_RING, "case4")):
            env = ac_env(get_env, dev, MLSL_VERIFY="1", MLSL_ALGO=spec,
                         MLSL_PALLAS_A2A_QUANT="0")
            diagnostics.reset()
            with CommitClock() as clock:
                if case == "case1":
                    ops = mlp_net(env, env.create_distribution(WORLD // 2, 2))
                else:
                    ops = mlp_net(env, env.create_distribution(WORLD, 1),
                                  env.create_distribution(WORLD // 4, 4), edge_fm=MLP_FM2,
                                  out_type=OpType.ACT)
            (commit,) = clock.commits
            check(commit["plan"]["verdict"] == "pass" and commit["protocol"]["verdict"] == "pass",
                  f"ac2 {tag}: commit verdicts {commit['plan']}, {commit['protocol']}")
            reset_launches()
            if case == "case1":
                worst, _ = mlp_loop(torch, env, ops, dev, iters=1)
            else:
                from mlsl_tpu_torch.core.activation import pack_local

                worst = {}
                _, op1, op2 = ops
                out_act, in_act = op1.get_output(0), op2.get_input(0)
                mb = op1.get_local_minibatch_size()
                acts = fill(torch, op1.get_distribution().topology,
                            mb * out_act.local_fm_count, 1.0, dev)
                wire = pack_local(acts, out_act.pack_blocks, mb, out_act.local_fm_count, 1)
                mlp_round(torch, out_act, in_act, wire, "FPROP", worst)
                del acts, wire
            torch.cuda.synchronize()
            c = {k: v for k, v in launches().items() if v}
            key = {"m1 model 2 ring": "dense_ring", "m1 model 2 rhd": "rhd_allreduce",
                   "m3 case4 ring": "a2a_dense"}[tag]
            check(c.get(key, 0) > 0, f"ac2 {tag}: launches {c}, no {key}")
            used[f"analysis_{tag.replace(' ', '_')}"] = c
            algos = sorted({r.algo for op in ops[0].operations for r in
                            [a.comm_req for a in op.inputs + op.outputs]
                            + [ps.grad_req for ps in op.parameter_sets] if r is not None})
            recs.append({"tag": tag, "algos": algos, "launches": c,
                         "commit_ms": commit["commit_ms"],
                         "verify_ms": commit["plan"]["duration_s"] * 1e3,
                         "worst": {k: float(f"{v:.3g}") for k, v in worst.items()}})
            del ops
        for rec in recs:
            lines.append(f"# analysis ac2 {json.dumps(rec)} on {smi}")
        lines.append(f"# phase analysis model-parallel graph verified (run (ac2)): ok in "
                     f"{time.perf_counter() - t0:.1f} s")

        # (ac3) the planted fault: the misordered groups under both severities
        t0 = time.perf_counter()
        env = ac_env(get_env, dev, MLSL_VERIFY="1", MLSL_VERIFY_SEVERITY="error")
        diagnostics.reset()
        try:
            ac_misordered(env)
            raise SmokeFailure("ac3: the misordered graph committed under severity error")
        except MLSLError as e:
            check("MLSL-A101" in str(e), f"ac3: refused without MLSL-A101: {e}")
            refused = str(e)[:160]
        env = ac_env(get_env, dev, MLSL_VERIFY="1", MLSL_VERIFY_SEVERITY="warn")
        diagnostics.reset()
        s = ac_misordered(env)
        st = supervisor.status()["analysis"]["plan"]
        check(s._committed and st["verdict"] == "fail" and "MLSL-A101" in st["codes"],
              f"ac3: warn commit {s._committed}, status {st}")
        with open(stats_mod.stats_path()) as f:
            analysis_lines = [ln.strip() for ln in f if ln.startswith("ANALYSIS")]
        check(any("FAIL" in ln and "MLSL-A101" in ln for ln in analysis_lines),
              f"ac3: no failing ANALYSIS line with MLSL-A101: {analysis_lines[-3:]}")
        del s
        lines.append(f"# analysis ac3 " + json.dumps({
            "error": refused, "warn_status": st,
            "analysis_line": next(ln for ln in reversed(analysis_lines) if "MLSL-A101" in ln)}))
        lines.append(f"# phase analysis planted fault (run (ac3)): ok in "
                     f"{time.perf_counter() - t0:.1f} s")

        # (ac4) the CLI, started with the run
        t0 = time.perf_counter()
        for rec in join_analysis_cli(cli):
            lines.append(f"# analysis ac4 {json.dumps(rec)}")
        cli = None
        lines.append(f"# phase analysis CLI (run (ac4), started with run (ac)): ok, waited "
                     f"{time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        if cli is not None:
            for _, proc, _ in cli:
                if proc.poll() is None:
                    proc.kill()
                proc.communicate()
        get_env().finalize()
        for k in AC_VARS + ("MLSL_STATS_DIR",):
            os.environ.pop(k, None)
        supervisor.reset_all()
        import shutil

        shutil.rmtree(stats_dir, ignore_errors=True)
        settle(torch)
    return used, lines


# -- run (ad): the multi-process transport -----------------------------------------

AD_PROCS = 2                # (ad1): processes on the one card, over gloo
AD_TIMEOUT = 420            # (ad1): the children's limit, start to exit
AD_PHASES = ("hierarchy", "gather", "loop", "matrix", "kinds", "train", "graph", "resnet")
#: (ad1)'s compressed wires and direct exchanges, after AD_PHASES; the twin
#: runs them without AD_VARS, so that its one process takes the composed int8
#: ring the children's spanning data group takes (a forced pallas_ring would
#: give it B4, another wire)
AD_INT8_PHASES = ("exchanges", "wires", "resnet_int8")
#: (ad1)'s trainers across processes (ROADMAP A.8b.4), after AD_INT8_PHASES,
#: at the worker's full size; the twin runs them with AD_VARS, as the children
AD_TRAINER_PHASES = ("hybrid", "moe", "pipeline", "feed")
#: (ad1)'s serving engine and restricted world across processes (ROADMAP
#: A.8b.4's last piece, A.8b.5), after AD_TRAINER_PHASES at the worker's full
#: size (mp_worker.SERVE_FULL); the twin runs them with AD_VARS, as the
#: children, and holds its engines to run (y)'s oracle rule
AD_SERVE_PHASES = ("serve", "restrict")
#: the serve and restrict phases' rows (ad_serve_hold)
AD_SERVE_KEYS = ("serve/", "restrict/", "rep/serve/")
AD_SIZE, AD_FEED = "full", "resnet"           # the worker's cases: gpt-medium-2k, config 5
#: the trainer phases' rows held bit for bit: the attention on its own (B9
#: forward and backward), the decoded feed batches and labels, the first fed
#: losses, replicated and ZeRO-1 (config 5's per-rank loop)
AD_TRAINER_EXACT = ("/attn/", "/decoded/", "/labels/", "/loss0/")
#: each rank's CE and gradient rows before the sync: bit for bit on the CPU;
#: on the card within AD_RTOL by their samples, their digests counted (a
#: CUDA reduction over a batch of ranks splits by the batch's size, so a
#: 4-rank box's rows may differ from the 8-rank twin's in the last bits)
AD_TRAINER_BOX = ("/ce/", "/in/")
AD_GRAPH = (MLP_FM1, MLP_FM2, MLP_TOKENS)     # run (m)'s graph at gpt-medium-2k's widths
AD_RESNET = (224, 1000, 64)                   # config 5
AD_WIRES_N = (64 << 20) // 4                  # config 4: 64 MiB a rank
AD_VARS = {"MLSL_ALGO": SPEC_RING, "MLSL_PALLAS_A2A_QUANT": "0"}
AD_RTOL = 1e-6              # float sums that cross processes, and config 5's gradients
AD_HOP_N = (16 << 20) // 4  # (ad2): floats a hop
AD_DEVICE = "cuda:0"
#: (ad1)'s rows held to the twin bit for bit: moves, integer-valued sums, the
#: compressed wires' digests and samples, config 5's ring inputs, and config
#: 5 on the int8 ring (the same arithmetic on the same inputs)
AD_EXACT = ("gather/", "kinds/", "graph", "exch/", "wires/", "resnet_int8/")


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def start_ad_children(out_dir: str) -> list:
    """(ad1): two processes of one world of 8 virtual ranks on cuda:0 over
    gloo, each the worker of mlsl_tpu_torch/tools/mp_worker.py. -> [(Popen,
    log path)]."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MLSL_")}
    env.update(AD_VARS)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    procs = []
    for i in range(AD_PROCS):
        path = os.path.join(out_dir, f"child{i}.log")
        with open(path, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "mlsl_tpu_torch.tools.mp_worker", "--pid", str(i),
                 "--nproc", str(AD_PROCS), "--port", str(port), "--device", AD_DEVICE,
                 "--backend", "gloo", "--out", out_dir,
                 "--phases", ",".join(AD_PHASES + AD_INT8_PHASES + AD_TRAINER_PHASES
                                      + AD_SERVE_PHASES),
                 "--graph", ",".join(map(str, AD_GRAPH)),
                 "--resnet", ",".join(map(str, AD_RESNET)), "--wires", str(AD_WIRES_N),
                 "--size", AD_SIZE, "--feed", AD_FEED],
                cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT), path))
    return procs


def join_ad_children(procs, t_start: float) -> list:
    """Wait for every child; one that fails, exits non-zero or outlives
    AD_TIMEOUT fails the phase (all are killed). -> each child's REPORT."""
    reports = []
    try:
        for i, (proc, path) in enumerate(procs):
            left = max(1.0, AD_TIMEOUT - (time.perf_counter() - t_start))
            try:
                rc = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"ad1: child {i} not done in {AD_TIMEOUT} s: "
                                   f"{Path(path).read_text()[-3000:]}")
            text = Path(path).read_text()
            check(rc == 0 and f"proc {i} E2E OK" in text,
                  f"ad1: child {i} exited {rc}: {text[-3000:]}")
            rep = [ln for ln in text.splitlines() if ln.startswith("REPORT ")]
            check(len(rep) == 1, f"ad1: child {i} printed no report")
            reports.append(json.loads(rep[0][len("REPORT "):]))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return reports


def ad_hold(np, twin: dict, rows: dict) -> dict:
    """Every row of the two processes against the one-process twin:
    AD_EXACT's rows and config 5's ring inputs bit for bit, float sums
    within AD_RTOL, config 5's float gradients within AD_RTOL relative L2 a
    layer and rank; replicated rows (gather_to_host, the MLP's parameters)
    bit for bit between the processes. -> the worst error of each kind."""
    worst = {"float_rel": 0.0, "resnet_grad_rel_l2": 0.0}
    for k, want in twin.items():
        if k.startswith(("csum/",) + AD_TRAINER_KEYS + AD_SERVE_KEYS):
            continue
        got = rows.get(k)
        check(got is not None, f"ad1: no process wrote {k}")
        if isinstance(got, list):
            check(all(np.array_equal(g, got[0]) for g in got[1:]),
                  f"ad1: the processes disagree on {k}")
            got = got[0]
        if k.startswith(AD_EXACT) or "bprop" in k or "/in/" in k:
            same = np.array_equal(np.ascontiguousarray(np.atleast_1d(got)).view(np.uint8),
                                  np.ascontiguousarray(np.atleast_1d(want)).view(np.uint8))
            check(same, f"ad1: {k} differs from the one-process twin")
            continue
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if k.startswith("resnet/") and not k.endswith("/loss") and "/loss/" not in k:
            rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
            worst["resnet_grad_rel_l2"] = max(worst["resnet_grad_rel_l2"], rel)
            check(rel <= AD_RTOL, f"ad1: {k} off the one-process twin by {rel:.3g}")
        else:
            rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
            worst["float_rel"] = max(worst["float_rel"], rel)
            check(rel <= AD_RTOL, f"ad1: {k} off the one-process twin by {rel:.3g}")
    return worst


#: the trainer phases' rows (ad_trainer_hold)
AD_TRAINER_KEYS = ("hybrid/", "pipeline/", "feed/", "rep/")


def ad_trainer_hold(np, twin: dict, rows: dict) -> dict:
    """The trainer phases' rows of the two processes against the twin:
    AD_TRAINER_EXACT's rows (digests and samples) bit for bit; the rest a
    layer at a time, every rank's samples together, within AD_RTOL relative
    L2 (AD_TRAINER_BOX's digests counted as bit for bit or not), except what
    follows a first update, which is a free-running twin (C.11) and only
    reported: the parameters after two steps, the second world loss, the
    second fed loss. Every rank of one model shard holds the same parameter
    bits, in either process, and both processes return the same world
    losses. -> the worst gap of each kind, and the box rows' digest counts."""
    worst, box, layers = {}, {"bit_for_bit": 0, "last_bits_differ": 0}, {}
    for k, want in twin.items():
        if not k.startswith(AD_TRAINER_KEYS) or k.startswith(AD_SERVE_KEYS):
            continue
        got = rows.get(k)
        check(got is not None, f"ad1: no process wrote {k}")
        if k.startswith("rep/"):
            check(all(np.array_equal(g, got[0]) for g in got[1:]),
                  f"ad1: the processes return different {k}: {[list(g) for g in got]}")
            rel = abs(float(got[0][0]) - float(want[0])) / abs(float(want[0]))
            check(rel <= AD_RTOL, f"ad1: {k}: first loss {float(got[0][0])!r} against the "
                                  f"twin's {float(want[0])!r}")
            worst[k] = {"first_rel": rel, "then": [float(v) for v in got[0][1:]],
                        "twin_then": [float(v) for v in want[1:]]}
        elif any(p in k for p in AD_TRAINER_EXACT):
            same = np.array_equal(np.ascontiguousarray(np.atleast_1d(got)).view(np.uint8),
                                  np.ascontiguousarray(np.atleast_1d(want)).view(np.uint8))
            check(same, f"ad1: {k} differs from the one-process twin")
        elif k.endswith("/digest"):
            if any(p in k for p in AD_TRAINER_BOX):
                box["bit_for_bit" if np.array_equal(got, want) else "last_bits_differ"] += 1
        else:
            # a layer: the key without its rank (and its /sample)
            parts = k.split("/")
            layer = "/".join(parts[:-2] if parts[-1] == "sample" else parts[:-1])
            pair = layers.setdefault(layer, ([], []))
            pair[0].append(np.asarray(got, np.float64).reshape(-1))
            pair[1].append(np.asarray(want, np.float64).reshape(-1))
    for layer, (got, want) in layers.items():
        got, want = np.concatenate(got), np.concatenate(want)
        rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        parts = layer.split("/")
        kind = "/".join(parts[:3])
        worst[kind] = max(worst.get(kind, 0.0), rel)
        if parts[2:3] == ["params"] or (parts[0] == "feed" and parts[-1] == "loss1"):
            continue                       # after an update: a free-running twin
        check(rel <= AD_RTOL, f"ad1: {layer} off the one-process twin by {rel:.3g} relative L2")
    from mlsl_tpu_torch.tools import mp_worker

    tps = {case[0]: case[2][2] for case in mp_worker.HYBRID_FULL + mp_worker.MOE_FULL
           + mp_worker.HYBRID_TINY + mp_worker.MOE_TINY}
    for k in rows:
        # the data and seq replicas of a model shard hold its bits, in either process
        parts = k.split("/")
        if parts[0] == "hybrid" and parts[2] == "params" and parts[-1] != "sample":
            rank = int(parts[-2] if parts[-1] == "digest" else parts[-1])
            first = "/".join(parts[:4] + [str(rank % tps[parts[1]])] + parts[5:])
            check(np.array_equal(rows[k], rows[first]),
                  f"ad1: {k}: rank {rank} holds other parameter bits than {first}")
    worst["box_rows"] = box
    return worst


def ad_trainer_record(reports, twin_report) -> dict:
    """(ad1)'s trainer phases: per case the bytes a step by hop kind, their
    staging and wire seconds, each step's time against the twin's; the
    pipelines' gaps to the dense oracle; the feed's per-process counters;
    the children's launches by phase. Checks that the spanning groups took
    no kernel route and no CUDA graph, and that each phase ran its kernels
    (B9 in hybrid, B7/B8 in moe, B2 in feed)."""
    rec = {"cases": {}, "pipeline": {}, "feed": [r["feed"] for r in reports],
           "launches": {ph: [r[ph]["launches"] for r in reports]
                        for ph in AD_TRAINER_PHASES}}
    routes = ("dense_ring", "dense_ring_gather", "quant_ring", "rhd_allreduce", "a2a_dense",
              "a2a_quant")
    for ph in ("hybrid", "moe"):
        for i, r in enumerate(reports):
            lc = r[ph]["launches"]
            check(not any(lc.get(k) for k in routes),
                  f"ad1: child {i}'s {ph} launched {lc}: a spanning group took a kernel route")
    for i, r in enumerate(reports):
        check(r["hybrid"]["launches"].get("block_update_sm90", 0) > 0
              and r["hybrid"]["launches"].get("block_update_bwd_dkv_sm90", 0) > 0,
              f"ad1: child {i}'s hybrid launched {r['hybrid']['launches']}: B9 expected")
        check(r["moe"]["launches"].get("flash_fwd_sm90", 0) > 0,
              f"ad1: child {i}'s moe launched {r['moe']['launches']}: B7 expected")
        check(r["feed"]["launches"].get("dequantize_blocks", 0) > 0,
              f"ad1: child {i}'s feed launched {r['feed']['launches']}: B2 expected")
    for key, row in reports[0].items():
        if key.startswith(("hybrid/", "pipeline/")):
            for i, r in enumerate(reports):
                calls = {k: h["calls"] for k, h in r[key]["hops"].items()}
                want = {k: h["calls"] for k, h in row["hops"].items()}
                check(calls == want, f"ad1: {key}: child {i} made hops {calls}, child 0 {want}")
        if key.startswith("hybrid/"):
            check(all(r[key]["graphs"] == 0 for r in reports),
                  f"ad1: {key}: a CUDA graph was captured over a spanning group")
            steps = row["steps"]
            rec["cases"][key] = {
                "spans": row["spans"], "fused": row["fused"],
                "step_s": [r[key]["step_s"] for r in reports],
                "twin_step_s": twin_report[key]["step_s"],
                "losses": row["losses"], "twin_losses": twin_report[key]["losses"],
                "bytes_a_step": {k: h["bytes"] // steps for k, h in row["hops"].items()},
                "stage_s_a_step": {k: h["stage_s"] / steps for k, h in row["hops"].items()},
                "wire_s_a_step": {k: h["wire_s"] / steps for k, h in row["hops"].items()},
                "calls_a_step": {k: h["calls"] / steps for k, h in row["hops"].items()}}
        elif key.startswith("pipeline/"):
            for i, r in enumerate(reports):
                gaps = r[key]["oracle_gaps"]
                check(gaps["loss"] <= PIPE_LOSS_RTOL and gaps["grad"] <= PIPE_GRAD_TOL,
                      f"ad1: child {i}'s {key} off the dense oracle: {gaps}")
            rec["pipeline"][key] = {
                "s": [r[key]["s"] for r in reports], "twin_s": twin_report[key]["s"],
                "oracle_gaps": [r[key]["oracle_gaps"] for r in reports],
                "bytes": {k: h["bytes"] for k, h in row["hops"].items()},
                "calls": {k: h["calls"] for k, h in row["hops"].items()}}
    return rec


def ad_serve_hold(np, twin: dict, rows: dict, reports, twin_report) -> dict:
    """(ad1)'s serve and restrict phases against the twin: per case of
    mp_worker.SERVE_FULL every process's programs equal the twin's, and the
    tokens each decode step fed are the same on both processes. The
    leader's tokens and logits against the twin's (AD_SERVE_TWIN below):
    on their common prefix every logit within the case's oracle bound of
    the twin's, and where the streams part the twin's margin between its
    token and the leader's within twice that bound; each step's relative L2
    reported. The pools' digests counted (bit for bit or not). A spanning model group ran no graph and no kernel route; over a
    process-local one each child captured its graph, held bit for bit to
    its eager twin, and launched B1, B2 and B5. The restricted collectives
    bit for bit. -> per case the bytes a prefill and a decode step handed
    the transport by hop kind with their staging and wire seconds, TTFT and
    the decode step's host time beside the twin's, the launches; and the
    restricted world's record."""
    from mlsl_tpu_torch.tools import mp_worker

    out = {"cases": {}}
    n_restrict = 0
    for k, want in twin.items():
        if k.startswith("restrict/"):
            got = rows.get(k)
            check(got is not None and np.array_equal(got, want),
                  f"ad1: {k} differs from the one-process twin")
            n_restrict += 1
    check(n_restrict == 2 * 4 * 26, f"ad1: {n_restrict} restricted rows, expected 208")
    for i, r in enumerate(reports):
        check("do not split over 2 processes" in (r["restrict"].get("uneven") or ""),
              f"ad1: child {i}: an uneven restriction did not raise: {r['restrict']}")
    out["restrict"] = {"rows_bit_for_bit": n_restrict,
                       "boxes": [{k: v for k, v in r["restrict"].items()
                                  if k.isdigit() or k == "s"} for r in reports]}
    for tag, tp, quant, mode, _ in mp_worker.SERVE_FULL:
        key = f"serve/{tag}"
        ids = sorted(int(k.rsplit("/", 1)[1]) for k in twin if k.startswith(f"{key}/tokens/"))
        check(len(ids) == mp_worker.SERVE_FULL_PROMPTS, f"ad1: {key}: the twin served {ids}")
        delta = SERVE_INT8_DELTA if quant else SERVE_DELTA
        worst, worst_abs, partings, equal_steps, last_bits, steps = 0.0, 0.0, [], 0, 0, 0
        for i in ids:
            a, b = rows[f"{key}/tokens/{i}"], twin[f"{key}/tokens/{i}"]
            got = np.asarray(rows[f"{key}/logits/{i}"], np.float64)
            want = np.asarray(twin[f"{key}/logits/{i}"], np.float64)
            check(got.shape == want.shape and len(a) == len(b),
                  f"ad1: {key}: request {i}'s logits {got.shape}, twin's {want.shape}")
            part = next((j for j in range(len(a)) if a[j] != b[j]), None)
            upto = len(a) if part is None else part + 1       # the common prefix's steps
            gap = np.abs(got[:upto] - want[:upto]).max(axis=1)
            rel = np.linalg.norm(got[:upto] - want[:upto], axis=1) / np.maximum(
                np.linalg.norm(want[:upto], axis=1), 1e-30)
            worst, worst_abs = max(worst, float(rel.max())), max(worst_abs, float(gap.max()))
            equal_steps += int((gap == 0).sum())
            last_bits += int(((gap > 0) & (rel <= AD_RTOL)).sum())
            steps += upto
            check(gap.max() <= delta, f"ad1: {key}: request {i}'s logits {gap.max():.4g} from "
                                      f"the twin's (bound {delta})")
            if part is not None:
                margin = float(want[part][b[part]] - want[part][a[part]])
                partings.append({"request": i, "step": part, "twin_margin": margin})
                check(margin <= 2 * delta,
                      f"ad1: {key}: request {i} parts from the twin at step {part} where the "
                      f"twin's margin is {margin:.4g} (bound {2 * delta})")
        got, want = rows[f"rep/{key}/programs"], twin[f"rep/{key}/programs"]
        check(len(got) == AD_PROCS and all(np.array_equal(g, want) for g in got),
              f"ad1: {key}: the processes' programs are not the twin's")
        fed = rows[f"rep/{key}/fed"]
        check(len(fed) == AD_PROCS and all(np.array_equal(g, fed[0]) for g in fed),
              f"ad1: {key}: the processes' decode steps fed other tokens")
        progs = twin[f"rep/{key}/programs"]
        dec = progs[progs[:, 0] == mp_worker.SERVE_PROGRAMS["decode"]]
        recs = [r[key] for r in reports]
        lead, tw = recs[0], twin_report[key]
        check(lead["leader"] and not any(r["leader"] for r in recs[1:]),
              f"ad1: {key}: process 0 does not lead")
        check(all(r["spanning"] == (tp == 8) for r in recs),
              f"ad1: {key}: spanning {[r['spanning'] for r in recs]}")
        routes = ("dense_ring", "dense_ring_gather", "quant_ring", "rhd_allreduce")
        for i, r in enumerate(recs):
            if r["spanning"]:
                check(not r["graphed"] and not r["graphs"]
                      and not any(r["launches"].get(k) for k in routes),
                      f"ad1: child {i}'s {key}: graphs {r['graphs']}, launches "
                      f"{r['launches']} over a spanning model group")
            else:
                check(r["graphs"] == ["bfloat16"], f"ad1: child {i}'s {key}: graphs "
                                                   f"{r['graphs']}")
                check(all(r["launches"].get(k, 0) > 0 for k in
                          ("quantize_blocks", "dequantize_blocks", "rhd_allreduce")),
                      f"ad1: child {i}'s {key} launched {r['launches']}: B1, B2 and B5 "
                      f"expected")
                check(len(r["twins"]) == 1 and r["twins"][0]["bit_for_bit"]
                      and r["twins"][0]["pools_equal"],
                      f"ad1: child {i}'s {key}: the decode graph against its eager twin "
                      f"{r['twins']}")
        if mode == "shed":
            check(lead["sheds"] == 2 and int(dec[:, 2].max()) == 2,
                  f"ad1: {key}: sheds {lead['sheds']}, rungs {sorted(set(dec[:, 2]))}")
        digests = {"bit_for_bit": 0, "last_bits_differ": 0}
        for k, want in twin.items():
            if k.startswith(f"{key}/") and k.endswith("/digest"):
                digests["bit_for_bit" if np.array_equal(rows[k], want)
                        else "last_bits_differ"] += 1

        def per_program(r, kind):
            ph = r["program_hops"].get(kind)
            if not ph:
                return {}
            n = ph["programs"]
            return {"programs": n, **{h: {"bytes": v["bytes"] / n, "calls": v["calls"] / n,
                                          "s": v["s"] / n, "stage_s": v["stage_s"] / n,
                                          "wire_s": v["wire_s"] / n}
                                      for h, v in ph["hops"].items()}}

        out["cases"][key] = {
            "tp": tp, "int8_kv": quant, "spanning": lead["spanning"],
            "graphs": [r["graphs"] for r in recs],
            "logits_rel_l2_worst": worst, "logits_abs_worst": worst_abs,
            "steps_bit_for_bit": equal_steps, "steps_within_1e-6": last_bits,
            "steps_held": steps, "partings": partings,
            "fed_as_twin": bool(np.array_equal(fed[0], twin[f"rep/{key}/fed"])),
            "pool_digests": digests,
            "a_prefill": [per_program(r, "prefill") for r in recs],
            "a_decode_step": [per_program(r, "decode") for r in recs],
            "ttft_ms": lead["ttft_ms"], "twin_ttft_ms": tw["ttft_ms"],
            "decode_step_ms": lead["step_ms"], "twin_decode_step_ms": tw["step_ms"],
            "decode_step_ms_median": float(np.median(lead["step_ms"])),
            "twin_decode_step_ms_median": float(np.median(tw["step_ms"])),
            "programs": int(len(progs)), "decode_steps": int(len(dec)),
            "shed_at_program": (int(np.argmax(progs[:, 2] == 2)) if mode == "shed" else None),
            "twins": [r.get("twins") for r in recs],
            "launches": [r["launches"] for r in recs], "s": [r["s"] for r in recs],
            "twin_s": tw["s"],
            "twin_oracle_worst": max(o["max_abs_delta"] for o in tw["oracle"]),
            "twin_oracle_differing_steps": sum(o["differing_steps"] for o in tw["oracle"])}
    return out


def ad_serve_oracle(torch, np, get_env, rows: dict) -> dict:
    """Run (y)'s oracle rule on the leader's own streams: for each case of
    mp_worker.SERVE_FULL a one-process engine of the same weights and
    config runs the unpaged oracle on every request's token stream from the
    children, and every step's logits the leader picked from must lie
    within SERVE_DELTA (SERVE_INT8_DELTA with int8 KV) of the oracle's. ->
    per case the worst gap and the steps where the leader's token is not
    the oracle's top one."""
    import dataclasses
    from types import SimpleNamespace

    from mlsl_tpu_torch.models import transformer as tfm
    from mlsl_tpu_torch.serve import checks
    from mlsl_tpu_torch.serve.engine import InferenceEngine
    from mlsl_tpu_torch.tools import mp_worker

    get_env().finalize()
    settle(torch)
    for k in ALGO_VARS:
        os.environ.pop(k, None)
    env = get_env().init(world_size=WORLD)
    cfg = dataclasses.replace(tfm.GPT_MEDIUM_2K, n_blocks=2)
    params = tfm.init_params(torch.Generator().manual_seed(mp_worker.SERVE_SEED), cfg)
    prompts = mp_worker.serve_prompts("full", cfg.vocab)
    out = {}
    try:
        for tag, tp, quant, _, fields in mp_worker.SERVE_FULL:
            delta = SERVE_INT8_DELTA if quant else SERVE_DELTA
            conf = dataclasses.replace(env.config, serve_kv_quant=quant,
                                       serve_kv_cache_mb=mp_worker.SERVE_FULL_KV_MB, **fields)
            eng = InferenceEngine(env, cfg, tp=tp, params=params, config=conf,
                                  max_batch=mp_worker.SERVE_FULL_BATCH)
            recs = []
            for i, p in enumerate(prompts):
                req = SimpleNamespace(id=i, prompt=p,
                                      tokens=[int(t) for t in rows[f"serve/{tag}/tokens/{i}"]])
                rec = checks.oracle_rule(eng, req, list(rows[f"serve/{tag}/logits/{i}"]), delta)
                check(rec["ok"], f"ad1: serve/{tag}: the leader's request {i} is "
                                 f"{rec['max_abs_delta']:.4g} from the oracle on its own stream "
                                 f"(bound {delta}): {rec}")
                recs.append(rec)
            eng.close()
            out[tag] = {"bound": delta, "worst": max(r["max_abs_delta"] for r in recs),
                        "differing_steps": sum(r["differing_steps"] for r in recs),
                        "margins": [r["margin"] for r in recs if r["margin"] is not None]}
            del eng
    finally:
        get_env().finalize()
        settle(torch)
    return out


def ad_hops(rep: dict, steps: int = 1) -> dict:
    """A phase's hops a step: calls, bytes and their dtypes, staging and
    wire seconds, by hop kind."""
    return {k: {"calls": h["calls"] / steps, "bytes": h["bytes"] // steps,
                "dtypes": {t: b // steps for t, b in h.get("dtypes", {}).items()},
                "stage_s": h.get("stage_s", 0.0) / steps, "wire_s": h.get("wire_s", 0.0) / steps}
            for k, h in rep["hops"].items()}


def ad_rows(np, out_dir: str, n: int) -> dict:
    """The children's npz rows merged; rows more than one process holds as
    lists."""
    rows = {}
    for i in range(n):
        with np.load(os.path.join(out_dir, f"proc{i}.npz")) as z:
            for k in z.files:
                if k.startswith(("gather/", "train/params/", "csum/", "train8/params/",
                                 "guard/", "rep/")):
                    rows.setdefault(k, []).append(z[k])
                else:
                    check(k not in rows, f"ad1: two processes wrote rank row {k}")
                    rows[k] = z[k]
    return rows


def start_ad1() -> tuple:
    """(ad1)'s two children, started with the card tests: they run beside
    parity, configs 1-4 and runs (aa)-(ac), which their twin in this process
    does not wait for. -> (children, their output directory, start time)."""
    out_dir = tempfile_dir("mlsl_ad1_")
    return start_ad_children(out_dir), out_dir, time.perf_counter()


def stop_ad1(started) -> None:
    """Kill (ad1)'s children if a phase failed before they were joined."""
    if started is not None:
        for proc, _ in started[0]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_ad1(torch, np, get_env, launches, reset_launches, started):
    """(ad1): the two children over gloo (``start_ad1``'s), their
    one-process twin run here, then every row held to the twin's. ->
    (record, the children's launches summed)."""
    from mlsl_tpu_torch.tools import mp_worker

    procs, out_dir, t0 = started
    t_twin = time.perf_counter()
    twin_dirs = (tempfile_dir("mlsl_ad1_twin_"), tempfile_dir("mlsl_ad1_twin8_"),
                 tempfile_dir("mlsl_ad1_twin_trainers_"), tempfile_dir("mlsl_ad1_twin_serve_"))
    twin, twin_s, twin_used, twin_reports = {}, [], [], []
    try:
        for phases, env_vars, twin_dir in ((AD_PHASES, AD_VARS, twin_dirs[0]),
                                           (AD_INT8_PHASES, {}, twin_dirs[1]),
                                           (AD_TRAINER_PHASES, AD_VARS, twin_dirs[2]),
                                           (AD_SERVE_PHASES, AD_VARS, twin_dirs[3])):
            get_env().finalize()
            settle(torch)
            for k in ALGO_VARS:
                os.environ.pop(k, None)
            os.environ.update(env_vars)
            reset_launches()
            t1 = time.perf_counter()
            try:
                twin.update(mp_worker.run(
                    0, 1, None, AD_DEVICE, twin_dir, phases=phases, graph=AD_GRAPH,
                    resnet=AD_RESNET, wires=AD_WIRES_N, size=AD_SIZE, feed_model=AD_FEED,
                    serve_oracle=(SERVE_DELTA, SERVE_INT8_DELTA),
                    log=lambda m: twin_reports.append(json.loads(m[len("REPORT "):]))
                    if m.startswith("REPORT ") else None))
            finally:
                for k in env_vars:
                    os.environ.pop(k, None)
            twin_s.append(time.perf_counter() - t1)
            twin_used.append({k: v for k, v in launches().items() if v})
    finally:
        t_join = time.perf_counter()
        reports = join_ad_children(procs, t0)
    wall = time.perf_counter() - t0
    rows = ad_rows(np, out_dir, AD_PROCS)
    worst = ad_hold(np, twin, rows)
    worst["trainers"] = ad_trainer_hold(np, twin, rows)
    trainers = ad_trainer_record(reports, twin_reports[2])
    serve = ad_serve_hold(np, twin, rows, reports, twin_reports[3])
    serve["leader_against_the_oracle"] = ad_serve_oracle(torch, np, get_env, rows)
    for tag in ("resnet/du0", "resnet/du1", "resnet_int8/du0", "resnet_int8/du1"):
        cs = rows[f"csum/{tag}"]
        check(all(c == cs[0] for c in cs), f"ad1: {tag}: the processes' parameters differ "
                                           f"({[float(c) for c in cs]})")
    for tag in ("resnet_int8/du0", "resnet_int8/du1"):
        # the same arithmetic on the same ring inputs: the twin's parameters
        check(float(rows[f"csum/{tag}"][0]) == float(twin[f"csum/{tag}"]),
              f"ad1: {tag}: the parameters differ from the one-process twin's")
        check(all(r[tag]["algos"] == ["quant_ring"] for r in reports),
              f"ad1: {tag} took {[r[tag]['algos'] for r in reports]}, not the composed ring")
    used, serve_used = {}, {}
    for rep in reports:
        for k, v in rep["launches"].items():
            used[k] = used.get(k, 0) + v
        for k, v in rep["serve"]["launches"].items():
            serve_used[k] = serve_used.get(k, 0) + v
            used[k] -= v
    check(used.get("dense_ring", 0) > 0 and used.get("a2a_dense", 0) > 0,
          f"ad1: the children launched {used}: B3 and B6 on the process-local model groups "
          f"expected")
    for ph in ("wires", "resnet_int8"):
        for i, rep in enumerate(reports):
            lc = rep[ph]["launches"]
            check(lc.get("quantize_blocks", 0) > 0 and not lc.get("quant_ring", 0),
                  f"ad1: child {i}'s {ph} launched {lc}: B1 and no B4 on the spanning "
                  f"data group expected")
    per_step = {}
    for tag in ("resnet/du0", "resnet/du1", "resnet_int8/du0", "resnet_int8/du1"):
        r = reports[0][tag]
        hops = ad_hops(r, r["steps"])
        per_step[tag] = {"bytes_a_step": sum(h["bytes"] for h in hops.values()),
                         "step_s": r["s"] / r["steps"],
                         "hop_s_a_step": sum(h["s"] for h in r["hops"].values()) / r["steps"],
                         "shifts_a_step": hops.get("ring_shift", {}).get("calls", 0),
                         "hops": hops}
    wires = {f"child{i}": ad_hops(rep["wires"]) for i, rep in enumerate(reports)}
    # the direct exchanges (each child held them to the assembled form bit
    # for bit): bytes handed the backend, summed over the children, by kind
    exch = {}
    for key in reports[0]["exchange_bytes"]:
        kind = key.rsplit("/", 1)[1].split("_")[0]
        e = exch.setdefault(kind, {"direct": 0, "assembled": 0})
        for rep in reports:
            e["direct"] += rep["exchange_bytes"][key]["direct"]
            e["assembled"] += rep["exchange_bytes"][key]["assembled"]
    check(set(exch) == {"alltoall", "bcast", "sendrecv"}
          and all(e["direct"] < e["assembled"] for e in exch.values()),
          f"ad1: the direct exchanges' bytes {exch}: fewer than the assembled form expected")
    rec = {"backend": "gloo", "processes": AD_PROCS, "ranks_a_process": WORLD // AD_PROCS,
           "device": AD_DEVICE, "wall_s": wall, "children_before_twin_s": t_twin - t0,
           "waited_for_children_s": time.perf_counter() - t_join, "twin_s": twin_s,
           "twin_launches": twin_used,
           "launches": used, "worst": worst, "config5": per_step,
           "int8_step_over_float_step": {
               du: per_step[f"resnet_int8/{du}"]["step_s"] / per_step[f"resnet/{du}"]["step_s"]
               for du in ("du0", "du1")},
           "wires": wires, "wires_launches": [rep["wires"]["launches"] for rep in reports],
           "exchange_bytes": exch,
           "phases": [{k: {"s": v["s"], "hops": v.get("hops", {})} for k, v in rep.items()
                       if isinstance(v, dict) and "s" in v
                       and not k.startswith(("resnet", "hybrid/", "pipeline/", "serve/"))}
                      for rep in reports],
           "trainers": trainers, "serve": serve}
    return rec, used, serve_used


def phase_ad2(torch, np, get_env, dev):
    """(ad2): NCCL in a one-process world: each hop on a CUDA tensor and
    the spanning forms against their plain versions, bit for bit, and
    config 5's step bit for bit the transport-less run's. -> record."""
    from mlsl_tpu_torch.comm import collectives, transport
    from mlsl_tpu_torch.comm.mesh import ProcessGroup, Topology
    from mlsl_tpu_torch.types import ReductionType

    t0 = time.perf_counter()
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    rec = {"backend": "nccl", "processes": 1}
    try:
        steps = {}
        for mode in ("transportless", "nccl"):
            get_env().finalize()
            settle(torch)
            for k in ALGO_VARS:
                os.environ.pop(k, None)
            if mode == "nccl":
                env = get_env().init(world_size=WORLD,
                                     coordinator_address=f"127.0.0.1:{free_port()}",
                                     num_processes=1, process_id=0)
                check(transport.world().backend == "nccl", "ad2: the world is not on NCCL")
            else:
                env = get_env().init(world_size=WORLD)
            trainer, batch = build_resnet_trainer(torch, env, np)
            t1 = time.perf_counter()
            loss = trainer.step(batch)
            torch.cuda.synchronize()
            steps[mode] = {"s": time.perf_counter() - t1, "loss": loss.detach().clone(),
                           "params": [p.detach().clone() for p in trainer._all_params()]}
            del trainer, batch
        a, b = steps["transportless"], steps["nccl"]
        check(torch.equal(a["loss"], b["loss"]) and all(
            torch.equal(x, y) for x, y in zip(a["params"], b["params"])),
              "ad2: config 5's step on the NCCL world differs from the transport-less one")
        rec["config5_step_s"] = {k: v["s"] for k, v in steps.items()}
        del steps, a, b
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(AD_HOP_N, device=dev, generator=gen)
        hops = {}
        for name, fn, want in (
                ("all_reduce", lambda: transport.all_reduce(x), x),
                ("reduce_scatter", lambda: transport.reduce_scatter(x.view(1, -1)), x),
                ("all_gather", lambda: transport.all_gather(x), x.view(1, -1)),
                ("broadcast", lambda: transport.broadcast(x, 0), x)):
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            hops[name] = {"s": time.perf_counter() - t1, "bytes": AD_HOP_N * 4}
            check(got.is_cuda and torch.equal(got, want), f"ad2: {name} on NCCL differs")
        rec["hops"] = hops
        topo = Topology(4, 2, WORLD)
        buf = torch.randn(*topo.grid_shape, 4096, device=dev, generator=gen)
        forms = []
        for axes in (("data",), ("model",)):
            group = ProcessGroup(topo, axes)
            g = group.size
            for kind, kw in (("allreduce", {"op": ReductionType.SUM}),
                             ("reduce_scatter", {"op": ReductionType.SUM,
                                                 "recv_count": 4096 // g}),
                             ("allgather", {}), ("bcast", {"root": g - 1}),
                             ("alltoall", {"send_count": 4096 // g})):
                plain = collectives.build_raw(kind, group, **kw)(buf)
                span = transport.build_spanning(
                    kind, group, collectives._build_raw(kind, group, dict(kw)), **kw)(buf)
                check(torch.equal(span, plain), f"ad2: the spanning {kind} on {axes} differs")
                forms.append(f"{kind}/{axes[0]}")
        rec["spanning_forms"] = forms
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        get_env().finalize()
        transport.shutdown()
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def run_multiprocess(torch, np, get_env, launches, reset_launches, dev, smi, started):
    """Run (ad): (ad1), whose children ``started``, and (ad2). -> (launches by
    part, lines)."""
    t0 = time.perf_counter()
    ad1, used, serve_used = phase_ad1(torch, np, get_env, launches, reset_launches, started)
    ad2 = phase_ad2(torch, np, get_env, dev)
    c5 = ad1["config5"]
    summary = {
        tag: {"bytes_a_step": c5[tag]["bytes_a_step"],
              "dtypes_a_step": {k: h["dtypes"] for k, h in c5[tag]["hops"].items()},
              "shifts_a_step": c5[tag]["shifts_a_step"], "step_s": c5[tag]["step_s"],
              "stage_s_a_step": sum(h["stage_s"] for h in c5[tag]["hops"].values()),
              "wire_s_a_step": sum(h["wire_s"] for h in c5[tag]["hops"].values())}
        for tag in c5}
    summary["int8_step_over_float_step"] = ad1["int8_step_over_float_step"]
    summary["exchange_bytes"] = ad1["exchange_bytes"]
    trainers = ad1.pop("trainers")
    serve = ad1.pop("serve")
    lines = [f"# multiprocess ad1 {json.dumps(ad1)}",
             f"# multiprocess ad1 wires {json.dumps(summary)} {smi}",
             f"# multiprocess ad1 trainers {json.dumps(trainers)} {smi}",
             f"# multiprocess ad1 serve {json.dumps(serve)} {smi}",
             f"# multiprocess ad2 {json.dumps(ad2)}",
             f"# phase multiprocess (run (ad)): ok in {time.perf_counter() - t0:.1f} s; "
             f"two processes over gloo on one card (host-staged hops) and NCCL in a "
             f"one-process world; {smi}"]
    return {"multiprocess": used, "multiprocess_serve": serve_used}, lines


def main() -> int:
    started = time.perf_counter()
    if not (ROOT / "mlsl_tpu_torch" / "__init__.py").is_file():
        raise SmokeFailure(f"{ROOT} holds no mlsl_tpu_torch package: run from a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, str(ROOT))
    from mlsl_tpu_torch.capi import build as capi_build
    from mlsl_tpu_torch.ops import cuda_build

    # nvcc builds every source, and g++ the C library and the four programs,
    # while the rest starts up (imports, the card's context and name); the
    # builds' results are read in phase 1
    t_build = time.perf_counter()
    def build_capi():
        t0 = time.perf_counter()
        return capi_build.build(), time.perf_counter() - t0

    compiles = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    building = compiles.submit(cuda_build.build_all)
    building_capi = compiles.submit(build_capi)
    building_codec = compiles.submit(capi_build.build_sample_codec)
    compiles.shutdown(wait=False)
    from mlsl_tpu_torch import get_env
    from mlsl_tpu_torch.comm import algos
    from mlsl_tpu_torch.models import resnet
    from mlsl_tpu_torch.models import transformer as tfm
    from mlsl_tpu_torch.ops import a2a_kernels as a2a
    from mlsl_tpu_torch.ops import attention_kernels as ak
    from mlsl_tpu_torch.ops import mxu
    from mlsl_tpu_torch.ops import quant_kernels as qk
    from mlsl_tpu_torch.ops import rhd_kernels as rhd
    from mlsl_tpu_torch.ops import ring_kernels as rk

    kernel_mods = (qk, rk, rhd, ak, a2a)

    def reset_launches():
        for m in kernel_mods:
            m.reset_counts()

    def launches():
        return {k: v for m in kernel_mods for k, v in m.LAUNCHES.items()}

    for k in ALGO_VARS:
        os.environ.pop(k, None)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    bw, f32, bf16 = card_rates(name)
    log(f"# card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    took = building.result()
    capi_paths, capi_s = building_capi.result()
    log(f"# phase build: ok in {time.perf_counter() - t_build:.1f} s {took}; the C library "
        f"and its four programs in {capi_s:.1f} s ({capi_build.build_dir().name})")
    for src, text in cuda_build.build_logs.items():
        log(f"#   {src}: {ptxas_summary(text)}")
    if "attention_sm90" in cuda_build.build_logs:
        log(f"#   attention_sm90 registers a thread: "
            f"{ptxas_functions(cuda_build.build_logs['attention_sm90'])}")
    check(spill_bytes(cuda_build.build_logs.get("attention_sm90", "")) == 0,
          "attention_sm90: ptxas reports spills: " +
          ptxas_summary(cuda_build.build_logs.get("attention_sm90", "")))

    env = get_env().init(world_size=WORLD)        # the card; raises without one
    card_tests = capi_runs = cache_runs = ad1_started = None
    try:
        counts = resnet.layer_param_counts(resnet.ResNet50(device="meta"))
        ring_rows = resnet_ring_rows(counts)
        shapes = sorted({r for pair in ring_rows.values() for r in pair})
        # the MoE path's entry codec: every rank's padded combine payload
        moe_rows = WORLD * moe_combine_count(tfm.GPT_MEDIUM_2K_MOE8, 2, 2, 2) // BLOCK
        # with the kernels line's codec rows (the serving KV's block 64 among
        # them), odd blocks (groups of 6, 10 and 34 segments) and rows above
        # 512 and 2,048 elements
        shapes = [(r, BLOCK) for r in shapes] + [
            (37, 256), (1, 256), (4096, 128), (4096, 512), (1000, 32), (333, 96),
            (8003, 160), (7, 544), (8003, 1024), (515, 2048), (67, 4096), (moe_rows, BLOCK)]
        shapes += [(r, b) for _, r, b, _ in codec_rows() if (r, b) not in shapes]
        misaligned = [(37, 256), (8003, 64), (7, 96), (67, 2048)]
        t_card, card_tests = time.perf_counter(), start_card_tests()
        ad1_started = start_ad1()
        cache_runs = start_compile_cache_runs()
        capi_runs = CapiPrograms(capi_paths, capi_build)
        n_shapes = phase_parity(torch, qk, dev, shapes, misaligned)
        n_ring = phase_ring_parity(torch, rk, rhd, dev)
        log(f"# phase parity: ok, {n_shapes} shapes bit-exact (quantize, dequantize), "
            f"{n_ring} ring, all-gather and halving/doubling cases bit-exact")

        phase_config1(torch, env, np)
        log("# phase config1: ok")
        phase_config2(torch, env, np)
        log("# phase config2: ok")
        phase_config3(torch, env, np)
        log("# phase config3: ok")

        reset_launches()
        xs, outs, errs, req, roundtrip = phase_config4(torch, env, np, qk)
        torch.cuda.synchronize()
        c4 = launches()
        check(req.algo == "quant_ring", f"config 4: selected {req.algo!r}")
        check_config4(torch, env, qk, xs, outs, errs, req, roundtrip)
        check(counts_are(c4, quantize_blocks=2 * (WORLD + 1) + 1, dequantize_blocks=1,
                         quant_ring=0),
              f"config 4: kernel launches {c4}, expected 19 quantize and 1 dequantize")
        del xs, outs, errs, req, roundtrip
        log(f"# phase config4: ok, launches {c4}")
        # the integrity layer and the core tier (run (aa)), beside the card tests
        integrity_used, integrity_lines = run_integrity(torch, np, get_env, launches,
                                                        reset_launches, dev)
        for line in integrity_lines:
            log(line)
        # the recovery layer (run (ab)), beside the card tests
        recovery_used, recovery_lines = run_recovery(torch, np, get_env, launches,
                                                     reset_launches, dev)
        for line in recovery_lines:
            log(line)
        # the static analysis on the card (run (ac)), beside the card tests
        analysis_used, analysis_lines = run_analysis(torch, np, get_env, launches,
                                                     reset_launches, dev, smi)
        for line in analysis_lines:
            log(line)
        # the multi-process transport (run (ad)), beside the card tests
        mp_used, mp_lines = run_multiprocess(torch, np, get_env, launches, reset_launches,
                                             dev, smi, ad1_started)
        for line in mp_lines:
            log(line)
        env = reinit(get_env)
        settle(torch)
        summary = phase_card_tests(card_tests)
        log(f"# phase card tests ({CARD_TESTS}, beside parity, configs 1-4 and runs (aa), "
            f"(ab), (ac), (ad)): ok "
            f"in {time.perf_counter() - t_card:.1f} s, {summary}")
        t0 = time.perf_counter()
        rec = phase_compile_cache(*cache_runs)
        log(f"# integrity aa5 {json.dumps(rec)}")
        log(f"# phase compile cache (run (aa5), beside the card tests): ok, waited "
            f"{time.perf_counter() - t0:.1f} s")
        o1 = phase_capi_programs(capi_runs)
        for run in o1:
            log(f"# capi program {json.dumps(run)}")
        log(f"# phase capi programs (run (o1), beside parity and configs 1-4): ok in "
            f"{time.perf_counter() - t_card:.1f} s, {len(o1)} runs of the four unchanged "
            f"programs against {Path(capi_paths['lib']).name}")

        # cuDNN's deterministic convolutions from here to the overlap runs
        # (h-k), which are held to these host runs
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        trainer, batch = build_resnet_trainer(torch, env, np)
        reset_launches()
        losses, secs, split, grads, errs = phase_config5(torch, trainer, batch)
        c5 = launches()
        steps = len(losses)
        want = (WORLD + 1) * len(trainer.layers) * steps
        check(c5["quantize_blocks"] == want and c5["quant_ring"] == 0,
              f"config 5: launches {c5}, expected {want} quantize and no fused ring")
        worst = check_config5(torch, trainer, losses, grads, errs)
        log(f"# phase config5: ok, losses {[round(float(v.mean()), 4) for v in losses]}, "
            f"step seconds {[round(s, 4) for s in secs]}, launches {c5}, "
            f"worst layer gradient rel. error {worst:.4g}")
        log(f"# config5 train step (host clock, synchronized): "
            f"{json.dumps({'step_s': secs, 'last_step_split_s': split})}")
        composed5 = host_reference(torch, trainer, losses, secs)
        run7_first = {"losses": composed5["losses"][:1]}
        del grads, errs, trainer, batch
        torch.cuda.empty_cache()

        drive = PathRun(torch, algos, launches, reset_launches)
        rels = phase_algos_dense(torch, get_env, drive)
        dense_used = dict(drive.used)
        for line in drive.lines:
            log(line)
        log(f"# phase algos: ok, launches {dense_used}, relative errors {json.dumps(rels)}")
        drive.used, drive.lines = {}, []
        phase_algos_small(torch, get_env, drive)
        small_used = dict(drive.used)
        for line in drive.lines:
            log(line)
        log(f"# phase small: ok, launches {small_used}")
        torch.cuda.empty_cache()

        lax_note = phase_lax_buckets(torch, get_env)
        log(f"# phase lax buckets: ok, {lax_note}")
        torch.cuda.empty_cache()

        env = reinit(get_env, MLSL_ALGO="pallas_ring")
        reset_launches()
        xs, outs, errs, req, _ = phase_config4(torch, env, np, qk, roundtrip=False)
        torch.cuda.synchronize()
        c4f = launches()
        check(req.algo == "pallas_ring", f"config 4 fused: selected {req.algo!r}")
        check_config4(torch, env, qk, xs, outs, errs, req, None)
        check(counts_are(c4f, quantize_blocks=2, quant_ring=2, dequantize_blocks=0),
              f"config 4 fused: kernel launches {c4f}, expected 2 quantize and 2 fused rings")
        del xs, outs, errs, req
        log(f"# phase config4 fused ring: ok, launches {c4f}")

        trainer, batch = build_resnet_trainer(torch, env, np)
        check(all(_grad_req(trainer, n).algo == "pallas_ring" for n in trainer.layers),
              "config 5 fused: a layer request did not select pallas_ring")
        reset_launches()
        losses, secs_f, split_f, grads, errs = phase_config5(torch, trainer, batch)
        c5f = launches()
        want = len(trainer.layers) * len(losses)
        check(c5f["quant_ring"] == want and c5f["quantize_blocks"] == want,
              f"config 5 fused: launches {c5f}, expected {want} fused rings and "
              f"{want} quantize")
        worst_f = check_config5(torch, trainer, losses, grads, errs)
        log(f"# phase config5 fused ring: ok, losses "
            f"{[round(float(v.mean()), 4) for v in losses]}, launches {c5f}, "
            f"worst layer gradient rel. error {worst_f:.4g}")
        log(f"# config5 fused-ring train step (host clock, synchronized): "
            f"{json.dumps({'step_s': secs_f, 'last_step_split_s': split_f})}")
        fused5 = {"losses": [float(v.mean()) for v in losses], "secs": secs_f,
                  "launches": c5f}
        fused_ref = host_reference(torch, trainer, losses, secs_f)
        del grads, errs, trainer, batch
        torch.cuda.empty_cache()
        c5b = run_config5_buckets(torch, np, get_env, launches, reset_launches, fused5)

        # the compiled overlap engine, overlap_updates and the staged
        # multi-tensor reduce (runs h-l)
        engine_used = run_engines(torch, np, get_env, launches, reset_launches, composed5,
                                  fused_ref)
        torch.backends.cudnn.deterministic = False
        del composed5, fused_ref
        env = reinit(get_env)
        t0 = time.perf_counter()
        mr_lines, mr_used = run_multi_reduce(torch, launches, reset_launches,
                                             list(counts.values()), dev)
        for line in mr_lines:
            log(line)
        log(f"# phase multi reduce: ok in {time.perf_counter() - t0:.1f} s, launches {mr_used}")

        # the transformer: attention parity, then gpt-medium-2k on 1 rank (B7,
        # B8) and on 8 ranks (zigzag and ring attention: B9)
        env = reinit(get_env, world=1)
        t0 = time.perf_counter()
        parity = phase_attention_parity(torch, ak, dev)
        log(f"# phase attention parity: ok in {time.perf_counter() - t0:.1f} s, max abs errors "
            f"{json.dumps(parity)}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for line in phase_mxu(torch, mxu, dev, bf16):
            log(f"# mxu {json.dumps(line)}")
        log(f"# phase mxu: ok in {time.perf_counter() - t0:.1f} s (forward within "
            f"{MXU_FWD_TOL:g}, gradients within {MXU_GRAD_TOL:g} relative L2 of the plain "
            f"float32 version)")

        # run (a): the fused step, one CUDA graph (captured at the first step,
        # replayed after), and run (r): against its eager twin; the peak
        # counts from here
        settle(torch)
        trainer, batch = build_transformer(torch, env, np, 1, 1, 1, "ring")
        check(trainer.fused, "transformer 1 rank: the step is not the fused one")
        reset_launches()
        losses, secs, split, _ = phase_transformer(torch, trainer, batch)
        ta = {k: launches()[k] for k in ak.LAUNCHES}
        check_losses(losses, trainer.cfg.vocab, "transformer 1 rank")
        check(len(trainer._graphs) == 1, "transformer 1 rank: the step did not replay a graph")
        rec_a = check_fused_launches(ta, trainer, trainer.compiled_step(*batch),
                                     "transformer 1 rank")
        plain_a = {"losses": losses, "secs": secs,
                   "peak": torch.cuda.max_memory_allocated() / 2**30}
        log(f"# phase transformer 1 rank: ok, losses {losses}, launches {ta} (recorded "
            f"{rec_a}), peak memory {plain_a['peak']:.2f} GiB")
        log(step_line("transformer 1 rank (gpt-medium-2k, batch 8, fused step as one CUDA "
                      "graph)", trainer, losses, secs, split, rec_a))
        t0 = time.perf_counter()
        twin_r, ta_eager = phase_graph_twin(torch, np, env, trainer, batch, losses, secs)
        plain_a["flops"] = twin_r["flops"]
        log(f"# phase graph twin (run (r)): ok in {time.perf_counter() - t0:.1f} s, "
            f"{json.dumps(twin_r)}")
        del trainer, batch
        settle(torch)

        env = reinit(get_env)
        settle(torch)
        trainer, batch = build_transformer(torch, env, np, 2, 2, 2, "zigzag")
        check(not trainer.fused, "transformer 8 ranks: the step did not take the graph path")
        reset_launches()
        first_b = {}
        losses, secs, split, grads = phase_transformer(torch, trainer, batch, first=first_b)
        tb = {k: launches()[k] for k in ak.LAUNCHES}
        check_losses(losses, trainer.cfg.vocab, "transformer 8 ranks")
        n, steps = trainer.cfg.n_blocks, len(losses)
        check(counts_are(tb, **b9_counts(5 * n * steps), flash_fwd=0, flash_bwd_dq=0,
                         flash_bwd_dkv=0, **NO_SM90),
              f"transformer 8 ranks: launches {tb}, expected {5 * n} B9 (wgmma) and {5 * n} "
              f"of each of its backward passes per step, and no B7/B8")
        worst_t = check_transformer_grads(torch, trainer, grads)
        log(f"# phase transformer 8 ranks zigzag: ok, losses {losses}, launches {tb}, worst "
            f"layer gradient rel. error {worst_t:.4g}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(step_line("transformer 8 ranks (gpt-medium-2k, dp=2 x sp=2 x tp=2, zigzag)",
                      trainer, losses, secs, split, tb))
        b_run = {"first": first_b, "losses": losses, "secs": secs,
                 "peak": torch.cuda.max_memory_allocated() / 2**30}
        del trainer, batch, grads, first_b
        t0 = time.perf_counter()
        sv, tq = phase_sharded_vocab(torch, np, get_env, launches, reset_launches, b_run, dev)
        log(f"# phase transformer sharded vocab (run (q)): ok in "
            f"{time.perf_counter() - t0:.1f} s, {json.dumps(sv)}")
        del b_run

        env = reinit(get_env)
        trainer, batch = build_transformer(torch, env, np, 2, 2, 2, "ring", n_blocks=2)
        reset_launches()
        losses, secs, split, grads = phase_transformer(torch, trainer, batch)
        tr = {k: launches()[k] for k in ak.LAUNCHES}
        n, steps = trainer.cfg.n_blocks, len(losses)
        check(all(np.isfinite(losses)), f"transformer ring: losses {losses}")
        check(counts_are(tr, **b9_counts(2 * n * steps), flash_fwd=0, **NO_SM90),
              f"transformer ring: launches {tr}, expected {2 * n} B9 (wgmma) and {2 * n} of "
              f"each of its backward passes per step")
        worst_r = check_transformer_grads(torch, trainer, grads)
        log(f"# phase transformer 8 ranks ring: ok, losses {losses}, launches {tr}, worst "
            f"layer gradient rel. error {worst_r:.4g}")
        log(step_line("transformer 8 ranks (gpt-medium-2k widths, 2 blocks, dp=2 x sp=2 x "
                      "tp=2, ring)", trainer, losses, secs, split, tr))
        del trainer, batch, grads
        torch.cuda.empty_cache()
        tz, tra = run_transformer_zero1(torch, np, get_env, launches, reset_launches)

        # the fused all-to-all (B6): parity, Distribution.all_to_all, then the
        # MoE transformer whose float32 combine exchange runs on it
        env = reinit(get_env)
        t0 = time.perf_counter()
        moe_count = moe_combine_count(tfm.GPT_MEDIUM_2K_MOE8, 2, 2, 2)
        n_a2a = phase_a2a_parity(torch, a2a, algos, dev, moe_count)
        log(f"# phase a2a parity: ok in {time.perf_counter() - t0:.1f} s, {n_a2a} cases "
            f"bit-exact (dense, int8, error feedback over 2 rounds)")
        a2a_used, a2a_lines = phase_alltoall(torch, get_env, launches, reset_launches)
        for line in a2a_lines:
            log(line)
        log(f"# phase alltoall: ok, launches {a2a_used}")
        torch.cuda.empty_cache()

        tm, moe_path_count = phase_transformer_moe(torch, np, tfm, a2a, get_env, launches,
                                              reset_launches)
        check(moe_path_count == moe_count,
              f"transformer moe: the combine exchange is {moe_path_count} a rank, the parity "
              f"phase checked {moe_count}")
        # remat (run (p)): the policies against the plain step, then run (a)
        # under both
        t0 = time.perf_counter()
        twins = phase_remat_twins(torch, np, tfm, get_env)
        log(f"# phase remat twins: ok in {time.perf_counter() - t0:.1f} s, "
            f"{json.dumps(twins)}")
        remat_a = phase_remat_a(torch, np, get_env, launches, reset_launches, plain_a)
        env = reinit(get_env)
        zr, rr, zs = run_zero1(torch, np, get_env, launches, reset_launches, dev,
                               list(counts.values()))
        t0 = time.perf_counter()
        af, afz, afr = run_adafactor(torch, np, get_env, launches, reset_launches, dev)
        log(f"# phase adafactor (run (s)): ok in {time.perf_counter() - t0:.1f} s, "
            f"{json.dumps(af)}")
        env = reinit(get_env)

        # the model-parallel graph (run (m)) and the eleven collectives (run (n))
        t0 = time.perf_counter()
        m_lines, m_used = run_activation_graph(torch, np, get_env, launches, reset_launches,
                                               kernel_mods, dev)
        for line in m_lines:
            log(line)
        activation = {}
        for c in m_used.values():
            for k, v in c.items():
                activation[k] = activation.get(k, 0) + v
        log(f"# phase activation graph: ok in {time.perf_counter() - t0:.1f} s, launches "
            f"{json.dumps(activation, sort_keys=True)}")
        t0 = time.perf_counter()
        reset_launches()
        for line in run_collectives(torch, np, get_env, dev):
            log(line)
        coll_used = {k: v for k, v in launches().items() if v}
        check(not coll_used, f"collectives: launched {coll_used}; run (n) takes no kernel")
        log(f"# phase collectives: ok in {time.perf_counter() - t0:.1f} s")
        settle(torch)

        # the C entry in this process (run (o2)): the port's library loaded
        # with ctypes reuses this interpreter and its launch counters
        t0 = time.perf_counter()
        o2_lines, capi_used = run_capi_in_process(torch, np, get_env, launches, reset_launches,
                                                  capi_paths["lib"], list(counts.values()), dev)
        for line in o2_lines:
            log(f"# capi {json.dumps(line)}")
        log(f"# phase capi in process (run (o2)): ok in {time.perf_counter() - t0:.1f} s, "
            f"bit for bit and launch for launch against the Python path, launches "
            f"{json.dumps({k: v for k, v in capi_used.items() if v}, sort_keys=True)}")
        settle(torch)

        # the compressed wires beyond int8 (run (t))
        t0 = time.perf_counter()
        codec_used, codec_lines = run_codecs(torch, np, get_env, launches, reset_launches,
                                             building_codec.result(), dev)
        for line in codec_lines:
            log(line)
        log(f"# phase codecs (run (t)): ok in {time.perf_counter() - t0:.1f} s, launches "
            f"{json.dumps({k: {n: c for n, c in v.items() if c} for k, v in codec_used.items()})}")
        settle(torch)

        # the two-tier lowering on the 2 x 4 world of virtual ranks (run (u))
        # and the tuner's sweep over it (run (v))
        drive = PathRun(torch, algos, launches, reset_launches)
        hier_rels = phase_hier_dense(torch, get_env, drive)
        for line in drive.lines:
            log(line)
        log(f"# phase hier dense (run (u1)): ok, launches {drive.used}, relative errors "
            f"{json.dumps(hier_rels)}")
        torch.cuda.empty_cache()
        for line in phase_hier_quant(torch, np, get_env, qk):
            log(line)
        log("# phase hier quantized (run (u2)): ok")
        hier_used, hier_lines = run_hier_config5(torch, np, get_env, launches, reset_launches,
                                                 run7_first)
        for line in hier_lines:
            log(line)
        log(f"# phase hier config5 (run (u3)): ok, launches {json.dumps(hier_used)}")
        tune_used, tune_lines = run_tuned(torch, np, get_env, launches, reset_launches)
        for line in tune_lines:
            log(line)
        log(f"# phase tuner sweep (run (v)): ok, launches {json.dumps(tune_used)}")

        # the device feed (run (w)) and the pipeline schedules (run (x)), one
        # after the other with nothing beside them
        feed_used, feed_out = run_feed(torch, np, get_env, launches, reset_launches)
        for line in feed_out:
            log(line)
        env = reinit(get_env)
        pipe_used, pipe_out = run_pipeline(torch, np, launches, reset_launches, dev)
        for line in pipe_out:
            log(line)
        # decode mode and the serving engine (run (y))
        serve_used, serve_out = run_serve(torch, np, get_env, launches, reset_launches)
        for line in serve_out:
            log(line)
        # the fault plane and the telemetry (run (z))
        fault_used, fault_out = run_fault_plane(torch, np, get_env, launches, reset_launches)
        for line in fault_out:
            log(line)
        env = reinit(get_env)

        def path(key, **runs):
            return {k: v.get(key, 0) for k, v in runs.items()}

        runs = dict(config4=c4, config5=c5, algos=dense_used, small=small_used,
                    config4_fused=c4f, config5_fused=c5f, config5_buckets=c5b,
                    alltoall=a2a_used, transformer_moe=tm, transformer_zero1=tz,
                    zero1_resnet=zr, replicated_adam_resnet=rr, zero1_staged=zs,
                    adafactor_zero1=afz, adafactor_replicated=afr,
                    engine_int8=engine_used["engine int8"],
                    engine_fused_ring=engine_used["engine fused ring"],
                    engine_buckets=engine_used["engine buckets"],
                    overlap_updates=engine_used["overlap_updates"], multi_reduce=mr_used,
                    activation_graph=activation, collectives=coll_used, capi=capi_used,
                    **{f"codec_{k}": v for k, v in codec_used.items()},
                    hier_dense=drive.used, **hier_used, **tune_used, **feed_used,
                    pipeline=pipe_used, **serve_used, **fault_used, **integrity_used,
                    **recovery_used, **analysis_used, **mp_used)
        entries = [
            codec_entry(torch, qk, kind, rows, block, bw, f32,
                        path(f"{kind}_blocks", **runs), dev, tag=tag)
            for kind, rows, block, tag in codec_rows(env.config.quant_block_elems)]
        entries += [
            dense_ring_entry(torch, rk, bw, f32, path("dense_ring", **runs), dev),
            # B3 and B5 at the 256 MiB path's own launch shape: four strided chunks
            dense_ring_entry(torch, rk, bw, f32, path("dense_ring", **runs), dev,
                             n=(64 << 20) // 4, ld=(256 << 20) // 4),
            # B3-AG at the fc layer's ZeRO-1 shard and at 2 Mi floats a rank
            ring_gather_entry(torch, rk, -(-counts["fc"] // WORLD), "fc ZeRO-1 shard", bw,
                              f32, path("dense_ring_gather", **runs), dev),
            ring_gather_entry(torch, rk, 2 << 20, "2 Mi floats a rank", bw, f32,
                              path("dense_ring_gather", **runs), dev),
            quant_ring_entry(torch, rk, counts["fc"], "fc request", bw, f32,
                             path("quant_ring", **runs), dev),
            quant_ring_entry(torch, rk, (64 << 20) // 4, "config 4", bw, f32,
                             path("quant_ring", **runs), dev),
            rhd_entry(torch, rhd, 10_000, bw, f32, path("rhd_allreduce", **runs), dev,
                      note="launch-latency bound: the byte bound is far below one launch",
                      graph=True),
            rhd_entry(torch, rhd, (1 << 20) // 4, bw, f32, path("rhd_allreduce", **runs), dev,
                      graph=True),
            rhd_entry(torch, rhd, (64 << 20) // 4, bw, f32, path("rhd_allreduce", **runs), dev,
                      ld=(256 << 20) // 4),
        ]
        # B3, B5 and B6 at the shapes run (m) gives them: case 1's FPROP
        # reduce_scatter (op1's packed wire over the model group), the
        # gradient allreduce of 4 Mi / M floats over the data group, and the
        # alltoall of cases 4 and 5
        tokens_a_rank = MLP_TOKENS * MLP_FM2
        for m in (4, 2):
            d = WORLD // m
            entries.append(group_ring_entry(
                torch, rk, "reduce_scatter", (d, m), ("model",), tokens_a_rank // d,
                f"case-1 FPROP at model {m}, G={m}", bw, f32, path("dense_ring", **runs), dev))
            grad = MLP_FM1 * MLP_FM2 // m
            entries.append(group_ring_entry(
                torch, rk, "allreduce", (d, m), ("data",), grad,
                f"gradient allreduce at model {m}, G={d}", bw, f32, path("dense_ring", **runs),
                dev))
            entries.append(group_rhd_entry(
                torch, rhd, (d, m), ("data",), grad, f"gradient allreduce at model {m}, G={d}",
                bw, f32, path("rhd_allreduce", **runs), dev))
        entries.append(a2a_entry(
            torch, a2a, tag="activation cases 4 and 5, G=4", grid=(2, 4), axes=("model",),
            count=4 * (MLP_TOKENS // WORLD) * (MLP_FM2 // 4), quantized=False, bw=bw, f32=f32,
            per_path=path("a2a_dense", alltoall=a2a_used, transformer_moe=tm,
                          activation_graph=activation, capi=capi_used, **tune_used,
                          **analysis_used, **mp_used),
            dev=dev))
        entries += attention_entries(
            torch, torch.nn.functional, ak, bw, bf16,
            dict(transformer_1rank=ta, transformer_1rank_eager_twin=ta_eager,
                 transformer_8rank_zigzag=tb, transformer_8rank_sharded_vocab=tq,
                 transformer_8rank_ring=tr,
                 transformer_moe=tm, transformer_zero1=tz, transformer_replicated_adam=tra,
                 transformer_1rank_remat_full=remat_a["full"],
                 transformer_1rank_remat_dots=remat_a["dots"], **mp_used),
            dev)
        for tag, grid, axes, count, quantized in (
                ("MoE combine exchange, ep=2", (4, 2), ("model",), moe_count, True),
                ("MoE combine backward, ep=2", (4, 2), ("model",), moe_count, False),
                ("64 MiB a rank, G=8", (WORLD, 1), ("data",), (64 << 20) // 4, False),
                ("64 MiB a rank, G=8", (WORLD, 1), ("data",), (64 << 20) // 4, True)):
            key = "a2a_quant" if quantized else "a2a_dense"
            entries.append(a2a_entry(torch, a2a, tag=tag, grid=grid, axes=axes, count=count,
                                     quantized=quantized, bw=bw, f32=f32,
                                     per_path=path(key, alltoall=a2a_used, transformer_moe=tm,
                                                   activation_graph=activation,
                                                   capi=capi_used, **tune_used,
                                                   **analysis_used, **mp_used),
                                     dev=dev))
        # B5 and B3 at the serving path's tp = 2 reductions ((y2), (y3))
        srv = tfm.GPT_MEDIUM_2K
        entries.append(group_rhd_entry(
            torch, rhd, (1, 2), ("model",), SERVE_BATCH * srv.d_model,
            "serve decode reduction, tp 2", bw, f32, path("rhd_allreduce", **runs), dev))
        for count, tag in ((srv.seq_len * srv.d_model, "serve prefill reduction, tp 2"),
                           (SERVE_BATCH * srv.d_model, "serve decode reduction, tp 2")):
            entries.append(group_ring_entry(
                torch, rk, "allreduce", (1, 2), ("model",), count, tag, bw, f32,
                path("dense_ring", **runs), dev))
    finally:
        if card_tests is not None and card_tests.poll() is None:   # a phase failed first
            card_tests.kill()
            card_tests.communicate()
        stop_ad1(ad1_started)
        if capi_runs is not None:
            capi_runs.kill()
        if cache_runs is not None:
            cache_runs[0].join(timeout=300)
        get_env().finalize()

    log(f"# smoke wall time: {time.perf_counter() - started:.1f} s")
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
