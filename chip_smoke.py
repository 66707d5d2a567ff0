#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:

1. device   — the card's name and power limit (nvidia-smi). TF32 is
               switched off for matmuls and cuDNN, so the f32 phases run
               in full f32.
2. build    — compile every CUDA kernel of the port from
               ``paddle_tpu_torch/kernels/csrc`` for sm_90a (one nvcc per
               source, started together) and print ptxas's resource report.
3. kernels  — each kernel against its plain PyTorch version on the card,
               in the working dtype, at the serving and training shapes
               and the ones listed below; kernel, plain and library times
               from CUDA events, and the bound for the same work. Where a
               wrapper chooses among device kernels (the flash forward
               and backward: wgmma or mma.sync; the grouped GEMM, float
               and int8 rhs: wgmma or mma.sync; paged decode: the
               one-launch cluster kernel or the split-K kernel), every
               one that takes the inputs is held to the gate and timed
               side by side through the same host path (mean and median
               of 20 launches each, 50 for paged decode); ``ms`` is the
               wrapper's own call (a mean, as every ``ms``), ``prev_ms``
               the kernel that served these shapes before (mma.sync or
               FMA before the wgmma kernels, split-K before the cluster
               kernel). The gate (``GATE``) must also reject two planted
               faults of the backward at the training shape (a wrong
               ``out``, from which the wgmma dq kernel computes delta).
               The int8 paged kernel also stays within 0.05 of the float
               kernel on the unquantized pages; the grouped GEMM runs at
               the MoE layer's shapes, the JAX sweeps of empty and
               one-row groups, f32 and int8 rhs. Its backward at the same
               shapes and edge groups: the weight gradient (the wgmma and
               the mma.sync design, empty groups exactly 0, beside
               ``torch._grouped_mm``) and ``dlhs`` on the transposed
               instance (wgmma and mma.sync, ``prev_ms`` the transposing
               copy plus the forward it replaced). float16: paged decode
               over float16 and int8 pools, the grouped GEMM with
               float16 lhs and float16 or int8 rhs, and the flash forward
               and backward (PR 15: the training shape, b 1 s 2048, GQA
               hq 32 hkv 4 d 64; the backward held to its plain version
               evaluated in float64). The DiT cell's attention:
               non-causal, b 32, h 8, d 64, s 256, forward and backward
               in bf16 (wgmma) and f32 (3xTF32 beside FMA), beside SDPA
               and its autograd. The f32 forward's and backward's two
               designs at s 100 d 128, the DiT shape, the training shape,
               GQA d 64 (the backward also at a ragged s 100) and off the
               16-byte grid, each also against the plain version in
               float64 (3xTF32 within 2x FMA's error, every gradient;
               two runs of the 3xTF32 backward bit-identical), and two
               planted copies each of the 3xTF32 forward (one-pass TF32;
               the last key tile's scores x 1.01) and backward (one-pass
               TF32; dS x 1.01 in dq's last key tile and dk/dv's last
               query tile), built beside the library, that the gate must
               reject at the DiT shape (the backward's in dq, dk and dv,
               and dq and dk). The fused KV write
               (``kv_write``) at the serving decode shape (8 rows) and a
               512-row prefill, bf16, float16, f32 and int8 pools:
               pages and scales equal to its plain version bit for bit.
               The rotating write the serving programs launch
               (``rope_kv_write``: RoPE of q and k, then the page write)
               at each program's shape (decode 8 rows, a verify window of
               8 x 5 rows crossing capacity, a 128-row chunk after 192
               cached, a 512-row prefill with 500 valid returning k) and
               GQA hq 32, hkv 4, d 64, over bf16, int8, float16 and f32
               pools: q, k, pages and scales equal to its plain version
               bit for bit; ``prev_ms`` the ``rope_qk`` + ``kv_write``
               chain it replaced, at the same shape.
               The continuation kernel (``paged_prefill``) at the serving
               shape, (cache_len, chunk) of (192, 128), (0, 128), (37, 61)
               and (496, 16); GQA hq 32, hkv 4, d 64; f32 and float16 q;
               int8 pages with bf16, float16 and f32 q: the chunk's rows
               within the gate, every row finite, on both designs (the
               split design the wrapper takes, and ``design="ring"``, the
               earlier kernel; f32 q: the FMA kernel), each timed through
               the wrapper and alone; beside them the library's time
               (the page gather and SDPA with the mask) and, at cache_len
               0, the flash kernel's on the same tokens. Its batched form
               (one launch for every slot: the verify window) at the
               serving_spec cell's verify shape, 8 slots of 5 rows at
               positions over 0-507, two slots inactive, one window
               reaching the table's capacity: bf16, int8 pages, GQA hq 32,
               hkv 4, d 64, f32 and float16 q; the active slots' valid
               rows within the gate, every row finite, both designs; its
               times beside the library's (the batched page gather and
               one SDPA call with the [slots, 1, S, C] mask). The split
               design's median against the ring's is reported per case.
4. parity   — tiny f32 Llama (MHA and GQA), the engine's programs
               captured as CUDA graphs: greedy outputs token-identical to
               the port's ``generate``, with ``decode_kernel`` "auto" and
               "xla" (the plain paged attention, counted); one decode
               program; a seeded sampled request's first token does not
               follow the engine's history. The JAX package's prefix-cache
               workload (32 requests, prompt + new = 16, staggered) twice
               through an engine with the prefix cache and 8-token chunks:
               token-identical to ``generate``, cache hits and at least one
               copy-on-write, every chunk one replay launching the
               continuation kernel once per layer. The JAX package's
               speculative-decoding workload (its ``spec_engine``: 4 slots,
               K = 3; the 32-request mix, every fourth sampled): greedy
               outputs token-identical to ``generate`` and to the
               spec-disabled engine, one verify program, drafts proposed,
               every verify step one replay launching the batched
               continuation kernel and rope_kv_write once per layer
               (kv_write never), no launch outside a graph.
5. serving  — full-width bf16 Llama (the repo's serving configuration,
               12 layers, random seeded weights) serving 32 mixed
               requests through ``Engine.generate``, every step a graph
               replay: all finish, no KV block leaks; counted from the
               replays, each decode step runs the paged kernel (cluster)
               once per layer, each prefill the flash kernel once per
               layer, every step the rotating page write
               (``rope_kv_write``, the pool's variant) once per layer and
               ``kv_write`` never; no kernel launched outside a graph, one
               replay per step; two
               decode programs (greedy and mixed), at most one prefill
               program per bucket. The warm-up engine's first decode
               step's logits (the replay's output) agree with the same
               step run eagerly with the plain attention function on
               copies of the pool, and its greedy tokens equal those of
               the same engine with its program functions run eagerly.
5b. serving_int8 — the same with ``EngineConfig(kv_cache_dtype="int8")``:
               every decode step runs the int8 paged kernel once per
               layer and the float one never; it also reports the first
               step's logit gap to the bf16 pool and the bytes per token.
               In both, every paged launch is the cluster kernel's.
5c. serving_f16 — the serving model in float16, 8 requests over the
               float16 and the int8 pool: all finish, the paged kernel
               (float16 q) runs once per layer per decode step, every
               prefill the float16 flash forward once per layer (PR 15),
               and the first decode logits are within 5e-2 of plain
               attention.
5d. serving_prefix — the bf16 serving model behind the prefix cache and
               chunked prefill (128-token chunks, one a step), over the
               bf16 and the int8 pool: 32 requests sharing a 192-token
               system prompt (tails of 8-127 tokens, at least 4 prompts of
               whole pages; 32-96 new tokens, every fourth sampled),
               served twice. Pass 2 hits the cache for at least 32 x 192
               prompt tokens and computes at most the rest; at least 4
               copy-on-writes; at most one continuation program per
               bucket and one copy program; counted from the replays, every
               chunk runs the continuation kernel once per layer, every
               one-shot prefill the flash kernel, every step
               rope_kv_write and every decode step the paged kernel, no
               launch outside a graph. The first continuation after
               cached tokens (the replay's logits) agrees with the same
               program run eagerly with the plain continuation attention
               on copies of the pool within 5e-2. Tokens/s, mean TTFT and computed prefill
               tokens per pass and pool.
5e. serving_spec — ``bench.py``'s speculative workload (:706-760) at its
               TPU geometry on the bf16 serving model: 8 slots,
               max_model_len 512, page 16, ``speculate_tokens=4``, over the
               bf16 and the int8 pool, each beside a spec-disabled engine
               of the same config; 8 prompts of 12 copies of one token,
               496 greedy new tokens each, after a 32-token warm-up pass,
               served three times (the fastest kept, as the bench does).
               All finish, no block leaks, one verify program; counted
               from the replays, every verify step runs the batched
               continuation kernel once per layer (and rope_kv_write), no
               launch outside a graph. The first verify replay's logits
               (the active slots' valid rows) agree with the same program
               function run eagerly with the plain window attention on
               copies of the pool within 5e-2. Recorded, not gated:
               tokens/s with and without speculation, the accept rate,
               tokens per verify launch, verify and decode steps, a verify
               replay's host wall ms against a decode replay's, and per
               request the first token where spec and base diverge.
5e2. analysis — the static analyzer on the serving cell with the prefix
               cache, chunked prefill (128) and speculation (K = 4) on:
               the gated engine (``analysis_check="error"``, the card's
               memory as ``device_memory_budget``) built beside an
               ungated twin, ``check_programs``' seconds, launch counts,
               capture counters and ``memory_allocated()`` equal around
               it; every program's predicted transient bytes against
               ``max_memory_allocated`` over its warm-up and capture
               (``ANALYSIS_MEM_TOL``); the decode program's peak minus
               one byte refused before anything is allocated, and
               warned through under ``"warn"``; three planted decode
               programs (a host sync, a frozen Python scalar, a float64
               upcast) found under ``"error"``; the gated engine serving
               the 32 requests (greedy tokens equal the twin's, the
               serving launch gates); a two-replica fleet under the
               default gate. Its summary is one ``[analysis] summary``
               JSON line.
5e3. jit    — the jit surface and the compile cache on the serving
               cell's model (12 layers, bf16): ``to_static`` in eval at
               [4, 512] (depth cut to 4 layers) in a cold process and
               then a warm one over one ``cache=`` directory, each with
               local Inductor and Triton caches of its own (4 flash
               launches a compiled call, logits within 5e-2 of eager,
               no compile on a second call, the warm process's FX-graph
               cache hitting with no miss and its outputs bit-identical
               in Inductor's deterministic mode); ``jit.save`` over sequence buckets
               {256, 512}, ``jit.load`` in another process (12 flash
               launches a call, a 300-token input padded and sliced
               back); the 2-layer training model through ``to_static``
               (AOTAutograd, ``aot_eager``) with a backward (2 launches
               each of the flash forward, dq and dk/dv a step, gradients
               within 5e-2 of eager, one more compile at a new length)
               and the ragged MoE layer (3 grouped GEMM launches a
               forward); the analysis cell's gated engine built cold
               with a compile cache and warm in another process (no
               analysis trace, one aot-hit a program, every program
               captured at build and none while serving, greedy tokens
               equal), and a flipped bit and a planted torch version
               each degrading to a counted, warned fallback. Its summary
               is one ``[jit] summary`` JSON line; the workers are this
               script with ``--jit-worker``.
5f. server  — the serving cell behind the HTTP front door: the bf16
               serving model over an engine with a journal, an access log
               and an SLO, behind ``serve(port=0)`` with two API keys for
               two tenants of weights 2:1. A client process (this script
               with ``--http-client``, threads over ``http.client``, no
               torch) sends the serving cell's 32 requests at t = 0 (every
               fourth sampled with a per-request seed; half SSE, half
               blocking; tenants alternating) and one more SSE request
               that hangs up after its third chunk. The first pass is
               cold: the server's driver thread captures every program.
               Gated: every greedy request's tokens (SSE chunks joined)
               equal in-process ``generate`` on the same engine; every
               request answers once with its usage and tenant; the
               disconnect is aborted (an ``aborted`` log line, no stream
               left, no KV block used); ``/metrics`` has the engine's
               ttft quantiles and both tenants' series, ``/healthz`` is
               ok; the access log has one line per request with its
               tenant; counted from the replays, the launches of
               ``serving``; nothing launched outside a graph; no step
               error and no stream fault; the drain leaves nothing.
               Recorded, in turns (HTTP at poll 0.002 and 0, in process,
               in process, HTTP at 0 and 0.002): tokens/s, client (first
               SSE chunk) and engine TTFT p50/p99, and the driver loop's
               wall per step against the step's and the decode launch's.
5g. journal — the durable request journal on the serving model: a worker
               process (this script with ``--journal-worker``) serves the
               first 8 serving-cell prompts (128 greedy new tokens each)
               over a journaled engine and SIGKILLs itself once 200
               tokens have decoded; a fresh engine on its directory
               replays and drains it. Gated: the worker died by SIGKILL,
               the replay found exactly the unfinished requests, each
               one's journaled tokens are a prefix of its output, the
               deliveries before and after the kill hold each request
               once at full length, and the recovered engine passes the
               serving launch gates. Recorded: the first token where each
               request differs from an uninterrupted run (bf16 re-prefill
               and decode round apart), engine build to the first
               recovered token, journal bytes per generated token and
               fsyncs per run, and in-process tokens/s of the serving
               cell's workload with the journal on and off (best of 3).
5h. poison  — poison isolation on the serving model and geometry (bf16
               pool, 8 slots): 8 greedy requests served clean, then again
               with a ``serving.step`` fault on one of them after 6 steps.
               Unattributed decode fault: the launches holding it fail at
               sizes 8, 4, 2, 1 and the step makes exactly 3 successful
               replays of the captured decode program, building none; an
               attributed one fails one launch of 8 and replays the other
               7 once; a prefill fault poisons only its request; a verify
               fault on the serving_spec engine (K = 4) bisects the same
               way. Gated: the other 7 token-identical to the clean run
               on the same engine, the poisoned one ``"error"``, no block
               left, ``requests_errored`` and ``health()`` "degraded";
               the decode run's launches as serving's, none outside a
               graph. A ``torch.AcceleratorError`` from the site
               re-raises from ``Engine.step`` after one attempt, no replay.
5i. fleet   — the self-healing fleet: 2 replicas of the serving model (8
               slots each, bf16 pool, one model's weights). The serving
               cell's 32 requests at t = 0 through the fleet, one 16-slot
               engine and one 8-slot engine, twice each: tokens/s, mean
               TTFT and requests per replica recorded (best run); gated:
               the fleet's greedy tokens equal the 8-slot engine's, every
               request at full length, no block left, launches as in
               serving and none outside a graph. Failover: r0 killed
               (``serving.replica``) after 200 decoded tokens; its restart
               is held until the survivor captures a prefill bucket it
               has not used (a 300-token prompt sent at the death), inside
               that capture, so the restart's device setup waits at the
               capture lock; gated: one failover, every request delivered
               once at full length, the restart adopted and serving later
               requests; recorded: the restart's build and first captures,
               ``failover_recovery_s``, the first token where each
               failed-over greedy request differs from the 8-slot engine
               (bf16 re-prefill). A device fault from a replica step
               re-raises from ``Fleet.step`` with no failover and no
               restart. Warm routing (serving_prefix geometry): one of 16
               requests sharing a 192-token system prompt warms a
               replica, then the 16 hit its prefix cache there
               (``paged_prefill`` launches on the split design). 8 requests
               over HTTP through ``serving.server``, two tenants: each
               answered once with its tenant, ``/healthz`` lists both
               replicas.
5j. spill   — the host KV spill tier on the serving model: the serving
               cell's 32 requests over 8 slots and 96 blocks (144 MiB of
               bf16 pages against the default 256 blocks), so the running
               requests outgrow the pool and preemption occurs, with a
               2 GiB host tier (``host_spill_bytes``), beside its
               recompute twin (no tier) and the unconstrained engine (256
               blocks); bf16 and int8 pools. Gated: every request once at
               full length; preemptions; restores and no recomputed token
               in the spill engine; every greedy request's tokens equal
               the unconstrained engine's; no block leaked; the ledger
               identities; the serving launch gates, nothing launched
               outside a graph, no program built inside a restore; blocks
               read and written back on the card equal bit for bit (pages
               and scales). The three engines then serve the same
               requests 3 more times each, warm and in turns (no
               program built, greedy tokens equal the first pass's, the
               ledger identities). Recorded: tokens/s of the three
               engines, best of the warm passes (the first pass's,
               captures included, beside it), the
               twin's first divergent token per greedy request and its
               recomputed tokens, spilled and restored bytes, spill and
               restore ms per handle and their GB/s against the host link
               (PCIe Gen5 x16, 64 GB/s a direction). Cases: a pool of
               60000 blocks (more than the card) refused as
               ``EngineOverloadedError`` with ``memory_allocated()`` back
               at its level, then the same process serves; injected
               ``kv.spill`` and ``kv.restore`` faults (every call)
               degrade to recompute, warned once, no block leaked; the
               disk tier (a one-byte host budget, ``spill_dir``) serves 8
               requests over 48 blocks back from disk, greedy tokens
               equal the unconstrained engine's; prefix chains (the
               serving_prefix workload, 512 blocks, a cache of 16
               entries) evicted to the host tier and restored: greedy
               tokens in both passes equal an engine that never evicts.
5k. stepstats — the step observatory on the serving cell: tokens/s with it
               on and off (best of 3, in turns), the replayed decode
               step's kernels and host launch calls equal on and off
               (torch.profiler), per-program p50 launch walls, host
               overhead, goodput fraction and MFU against the H100's
               989e12 bf16 peak; both ledger identities on the
               serving_spec cell's traffic (rejected drafts counted); a
               flight dump with the step samples and a compile log
               holding every capture, no retrace after warm-up.
6. train_parity — tiny f32 Llama (MHA and GQA, d 16: the FMA forward
               and backward; and MHA at d 64: the 3xTF32 forward and
               backward):
               10 ``TrainStep`` steps of AdamW through the flash kernels
               give the losses of the same 10 steps with the plain
               attention functions, every launch on the design the
               wrappers name.
7. train    — the repo's pretraining configuration (``bench.py``'s
               ``bench_llama``: 12 layers, hidden 2048, bf16 weights from a
               seed, fused chunked loss, AdamW with fp32 master weights),
               batch 12 x 1024 tokens: the first step's loss and every
               parameter's gradient against the same step with plain
               attention, then 14 ``TrainStep`` steps (1 + 3 warm-up + 10
               timed) with 12 forward, 12 dq and 12 dk/dv flash launches
               per step, all on the wgmma kernels (``attention_delta``
               never runs: the dq kernel computes delta), one profiled
               step, 2 steps with ``recompute`` and 1 step without the
               fused loss.
7b. train_amp — the same cell through ``amp`` (PR 15), three modes: O1
               bf16 on an f32 model, O2 bf16 via ``decorate`` with AdamW
               masters, O2 float16 with ``GradScaler(2**16)``. Each: the
               first step's loss and gradients against plain attention
               in the same mode, 8 steps (1 + 2 + 5 timed) with steps x
               12 launches of each flash kernel on the AMP dtype's
               instance (the float16 kernels in the third mode), losses
               finite and falling; step ms, tokens/s, MFU, peak memory,
               max |dO|, the float16 scale trajectory and skipped steps.
7c. train_resume — ``TrainLoop`` over ``TrainState`` in worker processes
               (this script with ``--train-worker``): full width, 1
               layer (a 183M-parameter checkpoint is ~2.9 GB), O2 bf16,
               AdamW with masters, LinearWarmup over
               CosineAnnealingDecay, ClipGradByGlobalNorm, a seeded
               DataLoader, 6 steps. Two uninterrupted runs bit-identical;
               SIGTERM (exit 76, emergency checkpoint), a ``train.step``
               fault, a stalled step under the watchdog (exit 68) and a
               torn newest checkpoint each resumed bit-identical; the
               same for float16 with its scaler state. Emergency
               checkpoint ms and GB/s, restore ms, restore + first step,
               SIGTERM to the first resumed step.
7d. dit     — BASELINE config #5, ``bench.py``'s ``bench_dit``:
               DiT hidden 512, depth 8, 8 heads of d 64, 2x2 patches of a
               4x32x32 latent (256 tokens), batch 32, 38.4M parameters
               from seed 0, AdamW(1e-4), MSE to a noise target, through
               ``jit.TrainStep`` in f32 (the bench's dtype, TF32 off) and
               amp O2 bf16, 14 steps each (1 + 3 + 10 timed): every flash
               kernel launched steps x 8 times, f32 on the 3xTF32 forward
               and backward (no FMA launch), bf16 on wgmma; the f32 step
               also with its forward, then its backward, on FMA, in turns
               (step ms, the profiled forward's or backward's share of
               device time); the first step's loss
               and gradients
               against plain attention, and again after the steps (the
               first step's adaLN-Zero gates are 0); losses finite and
               falling; step ms, samples/s, MFU (f32 against 67e12, bf16
               against 989e12), peak memory, a profiled step's device ms
               by family and busy share, and the q/k/v copies of the
               strided qkv views. Then one update of each of the twelve
               new optimizers (Adam and AdamW as controls) on the DiT's
               parameters and gradients, against the same update on CPU
               copies within 1e-5 relative L2 (LBFGS: a closure step over
               a quadratic of the same size, 1e-4), each timed; and one
               dropout call at p 0.1 (no flash launch, the keep rate
               within 5 binomial sigma, one seed one output).
7e. resnet  — BASELINE config #1, ``bench.py``'s ``bench_resnet``:
               ResNet-50 (10 classes, 23.5M parameters from seed 0) on
               the bench's batch of 128 32x32 images, Momentum(0.1, 0.9,
               weight_decay 5e-4), cross entropy, through
               ``jit.TrainStep`` in f32 (TF32 off) and amp O2 bf16, 40
               steps each (1 + 3 + 10 timed). Gates: the first f32 step
               on the card against the same step on the CPU (loss 1e-4,
               running statistics 1e-4) and against the f64 step on the
               CPU that takes the card's ReLU and max-pool decisions
               (every gradient 1e-3); the running statistics against the
               JAX formula over the batch (m 0.9, biased variance); O2's
               first step unit by unit (stem, 16 blocks, head) against
               each unit redone in f64 on the CPU from the card's bf16
               weights, input, decisions and output gradient (outputs
               2e-2, every gradient 5e-2, the loss 1e-2), and its whole
               forward against f32 after the stem (1e-2) and layer1
               (5e-2); each gradient gate first shown to catch a planted
               fault; losses finite and falling by step 40; the eval
               forward on the running statistics; no hand kernel
               launched. Recorded: step ms, images/s, MFU (64.1 GFLOP a
               step), peak memory, a profiled step's device ms by
               family, kernels and busy share. Then the data path: the
               f32 step fed by 4 forked DataLoader workers over shared
               memory (synthetic CIFAR-10, RandomCrop, flip, ToTensor,
               Normalize): images/s and the wait in ``next()``; with a
               fixed transform the first 4 batches equal the in-process
               loader's bit for bit, the workers are other processes
               (collating the CPU tensors the dataset returns), an early
               ``break`` leaves no shared-memory segment, and a dataset
               that calls CUDA in a worker makes the loader raise with
               the worker's traceback.
8. moe      — ``bench.py``'s MoE layer (``bench_kernels``: d_model 1024,
               8 experts, d_ff 2816, top-2, 8 x 1024 tokens, bf16):
               ``impl="ragged"`` runs 3 grouped GEMM launches and agrees
               with the plain grouped GEMM and with ``impl="dense"`` when
               nothing drops; its gradients agree with the plain version;
               ``quantize_moe_experts`` gives 3 int8 launches (on the
               int8 wgmma kernel, timed against the mma.sync one) within
               5 % of the float layer and refuses gradients; ragged and
               dense tokens/s; the same layer in float16, float and int8
               experts, 3 wgmma launches each, against the plain grouped
               GEMM; then one forward of ``bench_moe``'s level-0 Llama
               MoE (8 layers) against plain attention.
9. signal_dist — an ASR front end at Whisper's log-mel settings
               (openai/whisper, ``whisper/audio.py``: 16 kHz, n_fft 400,
               hop 160, 80 mels, 30 s clips): 64 seeded clips (a chirp
               plus noise) through ``Spectrogram``, ``MelSpectrogram``
               (f_min 0, f_max 8000, slaney), ``LogMelSpectrogram`` (top_db
               80) and ``MFCC`` (40); the first 8 clips against the same
               layers in float64 on the CPU (power and MFCC within 1e-5
               relative L2, log-mel within 1e-2 dB); istft(stft(x)) within
               1e-5 of the peak and bit-identical twice; 16-bit FFT input
               refused; forward ms, audio s per wall s, stft, overlap_add
               and istft ms. The distributions: 10^6 draws each of 12
               continuous ones (KS statistic below 2.69 / sqrt(n) against
               scipy's CDF) and of 8 discrete and multivariate ones (mean
               and covariance within 6 standard errors); one seed, one
               output; ``log_prob``, ``entropy`` and every registered
               ``kl_divergence`` against the CPU (1e-5); each ``sample``'s
               host syncs counted. A VAE-sized step (``Normal`` over [4096,
               512]: ``rsample``, ``log_prob``, the KL to N(0, 1),
               backward): gradients against the CPU on the same noise
               (1e-5), its ms. The feature forwards and every ``rsample``,
               ``log_prob``, ``entropy`` and KL run under
               ``set_sync_debug_mode("error")``; no hand kernel launched.

``--phases`` picks a subset; ``profile`` (a profiled decode step over the
bf16 and the int8 pool, replayed and with the program function run
eagerly, the speculative cell's verify step, and the decode step with the
observatory on and off: device busy ms and kernels per step, the port's
kernels among them) runs only when named.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result. ``--out PATH`` also writes the full report (every case, the
serving, training and MoE counters) as JSON to PATH.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM dense TF32 tensor cores
# Kernel output vs its plain version on the same inputs, for each output
# tensor (out; dq, dk, dv), scaled to the data: with randn inputs at
# scale 1/sqrt(d) the outputs of late causal rows are an order of
# magnitude smaller than those of the first rows, so no fixed absolute
# bound fits both.
#  - relative L2 error ||out - ref|| / ||ref|| <= l2. bf16: both sides
#    round the output to bf16 (~2^-10 RMS relative), and the tensor-core
#    kernels also round P (and dS) to bf16 as mma operands, ~2^-10 RMS
#    per term with random signs; f32: summation order only.
#  - every element: |out - ref| <= atol + rtol * |ref| + row_ulps * ulp
#    * rowmax|ref| + floor * rms(ref), rowmax over the head dim of its own
#    row, ulp the type's unit roundoff (bf16 2^-8). bf16: two ulps of its
#    own (rtol 2^-7: both sides round to bf16), 4 of the row's largest
#    element (an element that cancels to near 0 keeps its row's rounding
#    error), and a floor of 2^-12 of the tensor's RMS for a row that
#    cancels whole (dq's first causal row is 0, its one key giving dP =
#    delta; the kernels leave ~3e-7 there); f32: the fixed bound, as the
#    L2 term is the tight one there.
#  - float16 is bf16's gate scaled by the ratio of the unit roundoffs,
#    2^-11 / 2^-8 = 2^-3: l2 1.25e-3, rtol 2^-10, 4 ulps (2^-11) of the
#    row's largest element, a floor of 2^-15 of the RMS; and, as float16
#    (unlike bf16) has a narrow exponent, 4 steps of its subnormal
#    spacing 2^-24 as atol: below 2^-14 its values keep that fixed
#    absolute spacing (the MoE layer's outputs, ~1e-5, lie there). Its
#    kernels (paged decode, grouped GEMM) keep f32 scores and accumulators
#    and round only the output, as the plain versions do.
# gate_faults() shows that a backward with delta left out, or 10 % off in
# the late rows only, fails this gate at the training shape, and
# tf32_plant_faults() and bwd_tf32_plant_faults() that the f32 3xTF32
# designs with their cross terms left out (one-pass TF32), or with the
# forward's last key tile's scores or the backward's last tile's dS 1 %
# off, fail it at the DiT shape.
GATE = {
    "bfloat16": {"l2": 1e-2, "rtol": 2.0 ** -7, "row_ulps": 4,
                 "ulp": 2.0 ** -8, "floor": 2.0 ** -12, "atol": 0.0},
    "float16": {"l2": 1.25e-3, "rtol": 2.0 ** -10, "row_ulps": 4,
                "ulp": 2.0 ** -11, "floor": 2.0 ** -15,
                "atol": 4 * 2.0 ** -24},
    "float32": {"l2": 1e-5, "rtol": 1e-4, "row_ulps": 0, "ulp": 0.0,
                "floor": 0.0, "atol": 1e-4},
}
# the f32 flash 3xTF32 designs (the forward's output, each of the
# backward's gradients) against the plain version in float64: at most
# this many times the FMA design's relative L2 error
F32_DESIGN_F64_RATIO = 2.0
# a fixed bound of the kind bf16 flash checks often use, reported beside
# each planted fault to show what it would let through
FIXED_BOUND = (3e-2, 2e-2)
# first decode step of the full-width bf16 model, paged kernel vs plain
# attention: both round the attention output to bf16, and the 1-ulp
# differences this leaves pass through 12 layers of bf16 matmuls
LOGITS_TOL = 5e-2
# first training step of the full-width bf16 model, flash kernels vs plain
# attention: the loss within 1e-2 (bf16 activations through 12 layers,
# the loss near ln(32000) ~ 10), and every parameter's gradient within a
# relative L2 error of 5e-2 (the kernels round P and dS to bf16; every
# gradient is a bf16 sum through up to 12 layers of bf16 matmuls)
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_RTOL = 5e-2
# tiny f32 training, kernels vs plain attention over 10 AdamW steps
PARITY_LOSS_RTOL = 1e-4
# int8 paged kernel against the float kernel on the unquantized pages:
# the JAX contract of test_int8_pool_tolerance (rtol, atol)
INT8_POOL_TOL = (0.05, 0.05)
# full-width ragged MoE layer (relative L2 error): against the dense impl
# with nothing dropped (bf16 expert products rounded at other places), its
# gradients against the plain grouped GEMM (bf16 sums through the
# backward), and int8 experts against the float layer (docs/kernels.md's
# ~5 % bound on a SwiGLU layer)
MOE_DENSE_L2 = 1e-2
MOE_GRAD_L2 = 5e-2
MOE_INT8_L2 = 5e-2
# bench.py's bench_kernels MoE layer and bench_moe level-0 model (bf16)
MOE_LAYER = dict(d_model=1024, num_experts=8, d_ff=2816, k=2)
MOE_BATCH, MOE_SEQ = 8, 1024
MOE_LLAMA_CFG = dict(
    vocab_size=32000, hidden_size=1024, intermediate_size=2816,
    num_hidden_layers=8, num_attention_heads=16,
    max_position_embeddings=2048, num_experts=8, num_experts_per_tok=2,
    fused_loss_chunk=2048, dtype="bfloat16",
)
# the JAX grouped-GEMM sweeps: empty leading, trailing and interior
# groups, single-row segments, all rows on one expert
GMM_SWEEP = [[5, 0, 11, 16], [0, 0, 32, 0], [1, 1, 1, 29], [32, 0, 0, 0],
             [0, 7, 1, 24]]
# bench.py's bench_llama configuration (its TPU branch), bf16 weights
TRAIN_CFG = dict(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=12, num_attention_heads=16,
    max_position_embeddings=2048, fused_loss_chunk=2048, dtype="bfloat16",
)
TRAIN_BATCH, TRAIN_SEQ = 12, 1024
# bench.py's bench_dit (BASELINE config #5, its TPU branch): hidden 512,
# depth 8, 8 heads of d 64, 2x2 patches of a 4x32x32 latent (256
# tokens), 10 classes, batch 32, AdamW at 1e-4, MSE to a noise target
DIT_CFG = dict(input_size=32, patch_size=2, in_channels=4, hidden_size=512,
               depth=8, num_heads=8, num_classes=10)
DIT_BATCH = 32
DIT_SEQ = (DIT_CFG["input_size"] // DIT_CFG["patch_size"]) ** 2
DIT_HEAD_DIM = DIT_CFG["hidden_size"] // DIT_CFG["num_heads"]
# flash_case's name of the DiT attention in f32 (the 3xTF32 forward's
# main path)
DIT_F32_CASE = f"s{DIT_SEQ}_b{DIT_BATCH}_d{DIT_HEAD_DIM}_full_f32"

REPO = os.path.dirname(os.path.abspath(__file__))


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_times(torch, fn, iters, flush):
    """(mean, median) device ms of ``fn`` over ``iters`` launches, each
    timed with CUDA events after a write of ``flush`` (bigger than the 50
    MB L2, so every launch starts from a cold cache and the host's launch
    overhead hides behind the flush). The mean is every kernel's ``ms``;
    the median, reported beside it where a wrapper has several kernels,
    is less moved by a launch the shared host delays past the flush."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times)), float(np.median(times))


def cuda_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` (``cuda_times``)."""
    return cuda_times(torch, fn, iters, flush)[0]


# --------------------------------------------------------------- kernels
def compare(out, ref):
    """(within ``GATE``, what the gate read) for a kernel output against
    its plain version. ``limit_frac`` is the largest element's error as a
    fraction of its bound, ``binds_at`` that element; ``ref_rms`` and
    ``ref_absmax`` give the scale."""
    gate = GATE[str(out.dtype).split(".")[-1]]
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    rms = r.square().mean().sqrt()
    bound_ = (gate["atol"] + gate["rtol"] * r.abs() + gate["floor"] * rms
              + gate["row_ulps"] * gate["ulp"]
              * r.abs().amax(dim=-1, keepdim=True))
    frac = diff / bound_.clamp_min(1e-30)
    worst = int(frac.argmax())
    stats = {
        "max_abs_err": diff.max().item(),
        "rel_l2": (diff.norm() / r.norm().clamp_min(1e-30)).item(),
        "limit_frac": frac.flatten()[worst].item(),
        # where the gate binds: the element nearest its bound (its index
        # in the output's shape, reference, error and bound)
        "binds_at": {"index": [int(i) for i in np.unravel_index(
                               worst, r.shape)],
                     "ref": r.flatten()[worst].item(),
                     "err": diff.flatten()[worst].item(),
                     "bound": bound_.expand_as(r).flatten()[worst].item()},
        "ref_rms": rms.item(),
        "ref_absmax": r.abs().max().item(),
        "fixed_bound_ok": bool(
            (diff <= FIXED_BOUND[0] + FIXED_BOUND[1] * r.abs()).all()),
    }
    ok = (bool(o.isfinite().all()) and bool((diff <= bound_).all())
          and stats["rel_l2"] <= gate["l2"])
    return ok, stats


def bound(nbytes, flops, dtype, torch):
    """(bound ms, bound_by) for moving ``nbytes`` and doing ``flops``
    (16-bit types at the tensor cores' bf16/f16 rate)."""
    peak = (BF16_FLOPS if dtype in (torch.bfloat16, torch.float16)
            else F32_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tf32x3_bound(nbytes, flops):
    """(bound ms, bound_by) of an f32 function whose products run as three
    TF32 tensor-core products each (3xTF32, the f32 flash forward's
    "tf32x3" design): 3 ``flops`` at the dense TF32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


PAGED_VARIANTS = ("cluster", "split")


def paged_case(torch, pa, flush, name, dtype, hq, hkv, d, lengths,
               page=16, pages_per_seq=32, quant=False):
    """The paged kernels against ``paged_attention_ref`` on the same pages.
    ``ms`` is the wrapper's call (on the kernel ``_paged_variant`` picks);
    both device kernels (the cluster kernel and the split-K kernel,
    ``prev_ms``) are held to the gate and to exact zeros at length 0 and
    timed side by side through the wrapper (``variants``), the cluster
    kernel also alone (``_launch``: ``kernel_ms``, ``kernel_median_ms``).
    ``quant``: the int8 kernels on pages built by ``quantize_tokens``,
    also held to the float kernel on the unquantized pages
    (``INT8_POOL_TOL``)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    b = len(lengths)
    n_pages = b * pages_per_seq
    q = torch.randn(b, hq, d, generator=g, device=dev).to(dtype)
    kp = torch.randn(hkv, n_pages, page, d, generator=g,
                     device=dev).to(dtype)
    vp = torch.randn(hkv, n_pages, page, d, generator=g,
                     device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=g, device=dev)
    tables = perm.reshape(b, pages_per_seq).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    k, v = ((pa.quantize_tokens(kp), pa.quantize_tokens(vp)) if quant
            else (kp, vp))
    variant = pa._paged_variant(dtype, torch.int8 if quant else dtype)
    out = pa.paged_attention(q, k, v, tables, lens)
    ref = pa.paged_attention_ref(q, k, v, tables, lens)
    torch.cuda.synchronize()
    ok, stats = compare(out, ref)

    def zeros_exact(got):
        return all(bool((got[i] == 0).all())
                   for i, n in enumerate(lengths) if n == 0)

    zero_ok = zeros_exact(out)
    extra = {}
    if quant:
        flt = pa.paged_attention(q, kp, vp, tables, lens)
        rtol, atol = INT8_POOL_TOL
        gap = (out.float() - flt.float()).abs()
        ok = ok and bool((gap <= atol + rtol * flt.float().abs()).all())
        extra = {"float_pool_max_abs_gap": gap.max().item(),
                 "float_kernel_ms": cuda_ms(torch, lambda: pa.paged_attention(
                     q, kp, vp, tables, lens), 50, flush)}
    check(ok and zero_ok,
          f"paged_attention {name} (int8 {quant}, {variant}): {stats} "
          f"{extra} outside the gate or length-0 rows not exact zeros")

    def held(vname, got):
        ok_v, st = compare(got, ref)
        check(ok_v and zeros_exact(got),
              f"paged_attention {name} (int8 {quant}, {vname}): {st} "
              f"outside the gate or length-0 rows not exact zeros")
        return st

    ms = cuda_ms(torch, lambda: pa.paged_attention(q, k, v, tables, lens),
                 50, flush)
    variants = _timed_variants(
        torch, held, PAGED_VARIANTS,
        lambda vn: pa.paged_attention(q, k, v, tables, lens, variant=vn),
        flush, 50)
    # the cluster kernel alone: the inputs as the wrapper hands them over
    kq, ks = pa.split_pages(k)
    vq, vs = pa.split_pages(v)
    scale = 1.0 / d ** 0.5
    kernel_ms, kernel_median_ms = cuda_times(
        torch, lambda: pa._launch(q, kq, vq, ks, vs, tables, lens, scale,
                                  variant), 50, flush)
    plain_ms = cuda_ms(
        torch, lambda: pa.paged_attention_ref(q, k, v, tables, lens), 10,
        flush)
    tokens = sum(lengths)
    # q in, out; each cached K/V row once (int8: 1 byte an element and a
    # 4-byte scale a row); the tables
    row_bytes = d + 4 if quant else d * q.element_size()
    nbytes = (2 * q.numel() * q.element_size() + 2 * tokens * hkv * row_bytes
              + tables.numel() * 4 + b * 4)
    flops = 4 * tokens * hq * d
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    return {
        "case": name, "dtype": str(dtype).split(".")[-1], "int8": quant,
        "batch": b, "hq": hq, "hkv": hkv, "d": d, "page_size": page,
        "pages_per_seq": pages_per_seq, "lengths": list(lengths),
        "variant": variant, "prev": "split",
        **stats, **extra, "ms": ms, "prev_ms": variants["split"]["ms"],
        "kernel_ms": kernel_ms, "kernel_median_ms": kernel_median_ms,
        "variants": variants,
        "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }


def _routed_group_sizes(torch, n_tokens, d, e, k, seed):
    """Group sizes of ``n_tokens`` random bf16 tokens routed top-k over
    ``e`` experts by a random gate (the ragged dispatch's own count)."""
    from paddle_tpu_torch.ops import moe_ragged_dispatch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n_tokens, d, generator=g, device="cuda")
    w = torch.randn(d, e, generator=g, device="cuda") / d ** 0.5
    return moe_ragged_dispatch(x, x @ w, k=k)[1]


def _timed_variants(torch, compare_to, variants, run, flush, iters):
    """Each device kernel in ``variants`` on the same inputs, through the
    same host path ``run(variant)``: its output held to
    ``compare_to(variant, out)`` (which checks and returns the gate's
    stats), then its times. Returns {variant: {stats..., "ms": mean,
    "median_ms": median}}."""
    result = {}
    for v in variants:
        out = run(v)
        torch.cuda.synchronize()
        stats = compare_to(v, out)
        mean, median = cuda_times(torch, lambda: run(v), iters, flush)
        result[v] = dict(stats, ms=mean, median_ms=median)
    return result


def gmm_case(torch, gk, flush, name, dtype, k, m, group_sizes, quant=False):
    """The grouped GEMM kernels against ``grouped_matmul_ref`` on the same
    inputs (``GATE``); ``quant`` gives them int8 rhs with per-channel
    scales. ``ms`` is the wrapper's call (``grouped_matmul``, on the
    kernel ``_gmm_variant`` picks). Every device kernel that can take the
    inputs (bf16 lhs and rhs: the wgmma kernel and the mma.sync kernel)
    is held to the gate and timed side by side through ``_launch``
    (``variants``); ``prev_ms`` is the kernel the dtypes had before the
    wgmma kernel. Also times the plain version and, for bf16
    float rhs, ``torch._grouped_mm`` (never called by the port) where
    this PyTorch has it."""
    dev = "cuda"
    gs = torch.as_tensor(group_sizes, dtype=torch.int32, device=dev)
    n, e = int(gs.sum()), gs.numel()
    g = torch.Generator(device=dev).manual_seed(n + k + m)
    lhs = torch.randn(n, k, generator=g, device=dev).to(dtype)
    rhs = (torch.randn(e, k, m, generator=g, device=dev)
           / k ** 0.5).to(dtype)
    scales = None
    if quant:
        from paddle_tpu_torch.quantization import weight_quantize_grouped

        rhs, scales = weight_quantize_grouped(rhs.float())
    variant = gk._gmm_variant(lhs.dtype, rhs.dtype, n, k, m, e)
    prev = "fma" if dtype == torch.float32 else "mma"
    # the wgmma kernels take 16-bit lhs with k > 0 (int8 rhs: m % 16 == 0)
    wgmma_ok = (dtype != torch.float32 and k > 0
                and (not quant or m % 16 == 0))
    kinds = ([variant, prev] if variant != prev else [variant]) + (
        ["wgmma"] if variant != "wgmma" and wgmma_ok else [])
    with torch.no_grad():
        out = gk.grouped_matmul(lhs, rhs, gs, scales)
        ref = gk.grouped_matmul_ref(lhs, rhs, gs, scales)
        torch.cuda.synchronize()
        ok, stats = compare(out, ref)
        check(ok, f"grouped_matmul {name} ({variant}): {stats} outside the "
                  f"gate")

        def held(v, got):
            ok_v, st = compare(got, ref)
            check(ok_v, f"grouped_matmul {name} ({v}): {st} outside the "
                        f"gate")
            return st

        ms = cuda_ms(torch, lambda: gk.grouped_matmul(lhs, rhs, gs, scales),
                     20, flush)
        variants = _timed_variants(
            torch, held, kinds,
            lambda v: gk._launch(lhs, rhs, gs, scales, variant=v), flush, 20)
        plain_ms = cuda_ms(
            torch, lambda: gk.grouped_matmul_ref(lhs, rhs, gs, scales), 5,
            flush)
        library_ms, library_note = None, "none: int8 or f32 rhs"
        if not quant and dtype != torch.float32:
            library_note = "torch._grouped_mm absent"
            if hasattr(torch, "_grouped_mm"):
                offs = torch.cumsum(gs, 0, dtype=torch.int32)
                rhs_cm = rhs.transpose(1, 2).contiguous().transpose(1, 2)
                try:
                    lib = torch._grouped_mm(lhs, rhs_cm, offs=offs)
                    torch.cuda.synchronize()
                    lib_ok, lib_stats = compare(lib, ref)
                    library_ms = cuda_ms(torch, lambda: torch._grouped_mm(
                        lhs, rhs_cm, offs=offs), 20, flush)
                    library_note = ("torch._grouped_mm" if lib_ok else
                                    f"torch._grouped_mm, off the gate: "
                                    f"{lib_stats}")
                except (RuntimeError, TypeError) as err:
                    library_note = f"torch._grouped_mm refused: {err}"[:200]
    nbytes = (lhs.numel() * lhs.element_size()
              + rhs.numel() * rhs.element_size()
              + (scales.numel() * 4 if quant else 0)
              + out.numel() * out.element_size())
    flops = 2 * n * k * m
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    case = {
        "case": name, "dtype": str(dtype).split(".")[-1],
        "rhs": "int8" if quant else str(dtype).split(".")[-1], "n": n,
        "k": k, "m": m, "experts": e,
        "group_sizes": [int(x) for x in gs.tolist()], "variant": variant,
        "prev": prev, **stats, "ms": ms, "prev_ms": variants[prev]["ms"],
        "variants": variants,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": library_note, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }
    log(f"[kernels] gmm {json.dumps(case)}")
    return case


def _grouped_mm_wgrad(torch, lhs, g, gs):
    """(``torch._grouped_mm`` computing drhs, note) where this PyTorch
    takes the ragged contraction (2-D x 2-D with ``offs`` along the
    rows), else (None, why not)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm absent"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    a = lhs.t()            # [k, n], the rows contracted

    def fn():
        return torch._grouped_mm(a, g, offs=offs)

    try:
        fn()
        torch.cuda.synchronize()
        return fn, "torch._grouped_mm (2-D x 2-D, offs)"
    except (RuntimeError, TypeError) as err:
        return None, f"torch._grouped_mm refused: {err}"[:200]


def wgrad_case(torch, gk, flush, name, dtype, k, m, group_sizes):
    """The grouped GEMM weight-gradient kernels (``grouped_matmul_wgrad``)
    against ``_segment_outer`` on the same inputs (``GATE``), with every
    group's matrix, empty ones included, written as exact zeros. Every
    device kernel of the dtype (16-bit: the wgmma kernel and the mma.sync
    kernel, forced through ``_launch_wgrad``; f32: the FMA kernel) is held
    and timed side by side (``variants``); ``ms`` is the wrapper's call
    (on the kernel ``_wgrad_variant`` picks), ``prev_ms`` the mma.sync
    kernel. ``library_ms`` ``torch._grouped_mm``'s ragged contraction
    where this PyTorch takes it, else the per-expert cuBLAS loop (the
    plain version) and a note saying so."""
    dev = "cuda"
    gs = torch.as_tensor(group_sizes, dtype=torch.int32, device=dev)
    n, e = int(gs.sum()), gs.numel()
    gen = torch.Generator(device=dev).manual_seed(n + 7 * k + m)
    lhs = torch.randn(n, k, generator=gen, device=dev).to(dtype)
    g = torch.randn(n, m, generator=gen, device=dev).to(dtype)
    variant = gk._wgrad_variant(dtype, n, k, m, e)
    kinds = ["fma"] if dtype == torch.float32 else ["wgmma", "mma"]
    out = gk.grouped_matmul_wgrad(lhs, g, gs, e)
    ref = gk._segment_outer(lhs, g, gs, e)
    torch.cuda.synchronize()
    empty = [i for i, s in enumerate(group_sizes) if s == 0]

    def held(v, got):
        ok, st = compare(got, ref)
        check(ok, f"grouped_matmul_wgrad {name} ({v}): {st} outside the "
                  f"gate")
        check(all(bool((got[i] == 0).all()) for i in empty),
              f"grouped_matmul_wgrad {name} ({v}): an empty group's "
              f"matrix is not 0")
        return st

    stats = held(variant, out)
    ms, median = cuda_times(
        torch, lambda: gk.grouped_matmul_wgrad(lhs, g, gs, e), 20, flush)
    variants = _timed_variants(
        torch, held, kinds,
        lambda v: gk._launch_wgrad(lhs, g, gs, e, variant=v), flush, 20)
    plain_ms = cuda_ms(torch, lambda: gk._segment_outer(lhs, g, gs, e), 5,
                       flush)
    library_ms, library_note = None, "none: f32"
    if dtype != torch.float32:
        lib, library_note = _grouped_mm_wgrad(torch, lhs, g, gs)
        if lib is not None:
            got = lib()
            if got.shape == ref.shape:
                lib_ok, lib_stats = compare(got.to(dtype), ref)
                if not lib_ok:
                    library_note += f", off the gate: {lib_stats}"
            else:
                library_note += f", shape {tuple(got.shape)}"
            library_ms = cuda_ms(torch, lib, 20, flush)
        else:
            library_ms = plain_ms
            library_note += "; library_ms is the per-expert cuBLAS loop"
    nbytes = (lhs.numel() + g.numel() + out.numel()) * lhs.element_size()
    flops = 2 * n * k * m
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    prev = "fma" if dtype == torch.float32 else "mma"
    case = {
        "case": name, "dtype": str(dtype).split(".")[-1], "n": n, "k": k,
        "m": m, "experts": e,
        "group_sizes": [int(x) for x in gs.tolist()],
        "variant": variant, "prev": prev, **stats,
        "ms": ms, "median_ms": median, "prev_ms": variants[prev]["ms"],
        "variants": variants, "plain_ms": plain_ms,
        "library_ms": library_ms, "library": library_note,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "flops": flops,
    }
    log(f"[kernels] wgrad {json.dumps(case)}")
    return case


def dlhs_case(torch, gk, flush, name, dtype, k, m, group_sizes):
    """The backward's ``dlhs = g @ rhs[g(i)]^T`` (rhs [e, k, m] as the
    forward stores it, g [n, m]) on the transposed instance of the grouped
    GEMM kernels (``_forward(..., trans_rhs=True)``, no copy) against
    ``grouped_matmul_ref(g, rhs.transpose(1, 2), gs)`` (``GATE``). Every
    device kernel that takes the inputs (16-bit: wgmma and mma.sync; f32:
    FMA) is held and timed side by side through ``_launch``; ``ms`` is
    the wrapper's call; ``prev_ms`` what the backward ran before: the
    transposing copy of rhs and the forward on it. ``library_ms`` is
    ``torch._grouped_mm(g, rhs.transpose(1, 2), offs=offs)`` where this
    PyTorch has it."""
    dev = "cuda"
    gs = torch.as_tensor(group_sizes, dtype=torch.int32, device=dev)
    n, e = int(gs.sum()), gs.numel()
    gen = torch.Generator(device=dev).manual_seed(n + 5 * k + m)
    g = torch.randn(n, m, generator=gen, device=dev).to(dtype)
    rhs = (torch.randn(e, k, m, generator=gen, device=dev)
           / m ** 0.5).to(dtype)
    variant = gk._gmm_variant(dtype, dtype, n, m, k, e)
    kinds = ["fma"] if dtype == torch.float32 else ["wgmma", "mma"]
    with torch.no_grad():
        out = gk._forward(g, rhs, gs, trans_rhs=True)
        ref = gk.grouped_matmul_ref(g, rhs.transpose(1, 2), gs)
        torch.cuda.synchronize()

        def held(v, got):
            ok, st = compare(got, ref)
            check(ok, f"grouped_matmul dlhs {name} ({v}_t): {st} outside "
                      f"the gate")
            return st

        stats = held(variant, out)
        ms, median = cuda_times(
            torch, lambda: gk._forward(g, rhs, gs, trans_rhs=True), 20,
            flush)
        variants = _timed_variants(
            torch, held, kinds,
            lambda v: gk._launch(g, rhs, gs, None, variant=v,
                                 trans_rhs=True), flush, 20)
        prev_ms, prev_median = cuda_times(
            torch, lambda: gk._forward(g, rhs.transpose(1, 2).contiguous(),
                                       gs), 20, flush)
        plain_ms = cuda_ms(torch, lambda: gk.grouped_matmul_ref(
            g, rhs.transpose(1, 2), gs), 5, flush)
        library_ms, library_note = None, "none: f32"
        if dtype != torch.float32:
            library_note = "torch._grouped_mm absent"
            if hasattr(torch, "_grouped_mm"):
                offs = torch.cumsum(gs, 0, dtype=torch.int32)
                rhs_t = rhs.transpose(1, 2)
                try:
                    lib = torch._grouped_mm(g, rhs_t, offs=offs)
                    torch.cuda.synchronize()
                    lib_ok, lib_stats = compare(lib, ref)
                    library_ms = cuda_ms(torch, lambda: torch._grouped_mm(
                        g, rhs_t, offs=offs), 20, flush)
                    library_note = ("torch._grouped_mm" if lib_ok else
                                    f"torch._grouped_mm, off the gate: "
                                    f"{lib_stats}")
                except (RuntimeError, TypeError) as err:
                    library_note = f"torch._grouped_mm refused: {err}"[:200]
    nbytes = (g.numel() + rhs.numel() + out.numel()) * g.element_size()
    flops = 2 * n * k * m
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    case = {
        "case": name, "dtype": str(dtype).split(".")[-1], "n": n,
        "k": k, "m": m, "experts": e,
        "group_sizes": [int(x) for x in gs.tolist()],
        "variant": variant + "_t", **stats, "ms": ms, "median_ms": median,
        "prev_ms": prev_ms, "prev_median_ms": prev_median,
        "prev": "rhs.transpose(1, 2).contiguous() + the forward",
        "variants": {f"{v}_t": st for v, st in variants.items()},
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library": library_note, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }
    log(f"[kernels] dlhs {json.dumps(case)}")
    return case


def wgrad_cases(torch, gk, flush, routed):
    """``wgrad_case`` at the bench shape (routed rows, up and down, bf16
    and float16) and the edge cases: an empty expert, a 1-row expert,
    segment starts off every tile boundary, n below one tile, f32."""
    d, f = MOE_LAYER["d_model"], MOE_LAYER["d_ff"]
    bf16, f16 = torch.bfloat16, torch.float16
    return [
        wgrad_case(torch, gk, flush, "up", bf16, d, f, routed),
        wgrad_case(torch, gk, flush, "down", bf16, f, d, routed),
        wgrad_case(torch, gk, flush, "up_f16", f16, d, f, routed),
        wgrad_case(torch, gk, flush, "down_f16", f16, f, d, routed),
        # empty leading, trailing and interior groups, 1-row segments,
        # starts at 5, 16, 29, ... (off the 32-row chunk and 128 tiles)
        wgrad_case(torch, gk, flush, "edges", bf16, 136, 200,
                   [0, 5, 1, 0, 11, 1, 143, 0, 37, 1]),
        wgrad_case(torch, gk, flush, "tiny_n", bf16, 24, 40, [1, 0, 3, 2]),
        wgrad_case(torch, gk, flush, "all_empty", bf16, 24, 40, [0, 0, 0]),
        wgrad_case(torch, gk, flush, "edges_f16", f16, 136, 200,
                   [0, 5, 1, 0, 11, 1, 143, 0, 37, 1]),
        wgrad_case(torch, gk, flush, "f32", torch.float32, 136, 200,
                   [0, 5, 1, 0, 11, 1, 143, 0, 37, 1]),
        wgrad_case(torch, gk, flush, "f32_odd", torch.float32, 12, 10,
                   [3, 0, 5, 1]),
        # 64 rows exactly (a segment that ends on a box edge), and segments
        # ending 1 row before and after one
        wgrad_case(torch, gk, flush, "box_edges", bf16, 136, 200,
                   [64, 63, 65, 128, 0, 1]),
    ]


def dlhs_cases(torch, gk, flush, routed):
    """``dlhs_case`` at the bench shape (the up and down projections'
    dlhs, bf16 and float16), the edge groups, the JAX sweeps' groups
    (k 24, m 40), segments on and off the 64-row box, and f32."""
    d, f = MOE_LAYER["d_model"], MOE_LAYER["d_ff"]
    bf16, f16 = torch.bfloat16, torch.float16
    edges = [0, 5, 1, 0, 11, 1, 143, 0, 37, 1]
    cases = [
        dlhs_case(torch, gk, flush, "up", bf16, d, f, routed),
        dlhs_case(torch, gk, flush, "down", bf16, f, d, routed),
        dlhs_case(torch, gk, flush, "up_f16", f16, d, f, routed),
        dlhs_case(torch, gk, flush, "down_f16", f16, f, d, routed),
        dlhs_case(torch, gk, flush, "edges", bf16, 136, 200, edges),
        dlhs_case(torch, gk, flush, "edges_f16", f16, 136, 200, edges),
        dlhs_case(torch, gk, flush, "box_edges", bf16, 136, 200,
                  [64, 63, 65, 128, 0, 1]),
    ]
    cases += [dlhs_case(torch, gk, flush, f"sweep{gs}", bf16, 24, 40, gs)
              for gs in GMM_SWEEP]
    cases += [
        dlhs_case(torch, gk, flush, "f32", torch.float32, 136, 200, edges),
        dlhs_case(torch, gk, flush, "f32_odd", torch.float32, 12, 10,
                  [3, 0, 5, 1]),
    ]
    return cases


def flash_case(torch, fa, flush, s, dtype=None, h=16, d=128, b=1,
               offset=0, hkv=None, causal=True):
    """The forward kernels against ``flash_attention_ref``: out within
    ``GATE``, lse within 1e-3. ``offset`` > 0 starts q, k and v that many
    elements into their buffers, off the 16-byte grid the bf16 kernels
    load on; ``hkv`` < ``h`` is GQA. ``ms`` is the wrapper's call
    (``flash_attention_fwd``, its aligning copies included, on the kernel
    ``_fwd_variant`` picks). Every device kernel that takes the inputs
    (bf16 at d 64 or 128: the wgmma kernel and the mma.sync kernel) is
    held to both bounds and timed side by side through the wrapper's own
    steps (the copies, then ``_launch_fwd``: ``variants``), and with
    ``offset`` also alone on aligned copies (``kernel_ms``,
    ``kernel_median_ms``); ``prev_ms`` is the dtype's kernel before the
    wgmma one. f32 at d 64 or 128 has two designs, "tf32x3" (the
    wrapper's) and "fma" (``prev_ms``): each is also held to the plain
    version evaluated in float64 (``f64_rel_l2``), and the 3xTF32 one may
    be at most ``F32_DESIGN_F64_RATIO`` times further from it than FMA's;
    its ``bound_ms`` counts three TF32 products (``tf32x3_bound``), the
    FMA bound kept beside it (``fma_bound_ms``)."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    hkv = hkv or h
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(s)

    def make(heads):
        n = b * s * heads * d
        return (torch.randn(n + offset, generator=g, device=dev)
                .to(dtype)[offset:].view(b, s, heads, d))

    q, k, v = make(h), make(hkv), make(hkv)
    scale = d ** -0.5
    name = f"s{s}" + (f"_b{b}" if b > 1 else "") + (
        f"_gqa{h}x{hkv}" if hkv != h else "") + (f"_d{d}" if d != 128
                                                 else "") + (
        "_full" if not causal else "") + ("_unaligned" if offset else "") + (
        "_f16" if dtype == torch.float16 else "") + (
        "_f32" if dtype == torch.float32 else "")
    variant = fa._fwd_variant(dtype, d, s, s)
    prev = "fma" if dtype == torch.float32 else "mma"
    kinds = [variant, prev] if variant != prev else [variant]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()

    def held(vname, got):
        o, l = got
        ok, st = compare(o, ref)
        lse_err = (l - ref_lse).abs().max().item()
        check(ok and lse_err <= 1e-3,
              f"flash_attention {name} ({vname}): {st} outside the gate or "
              f"lse err {lse_err} > 1e-3")
        return dict(st, lse_max_abs_err=lse_err)

    stats = held(variant, (out, lse))

    ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                       causal=causal),
                 20, flush)
    variants = _timed_variants(
        torch, held, kinds,
        lambda vn: fa._launch_fwd(*(fa._aligned(t) for t in (q, k, v)),
                                  causal, scale, vn), flush, 20)
    if offset:
        # the kernels alone, on aligned copies made once (aligned inputs
        # have no copies to leave out: there the times above are these)
        qa, ka, va = (fa._aligned(t) for t in (q, k, v))
        for vn in kinds:
            variants[vn]["kernel_ms"], variants[vn]["kernel_median_ms"] = \
                cuda_times(torch, lambda: fa._launch_fwd(qa, ka, va, causal,
                                                         scale, vn),
                           20, flush)
    if dtype == torch.float32:
        # the f32 designs against the plain version in float64 (the gate's
        # reference, the f32 plain version, is itself ~4e-7 from it)
        ref64 = fa.flash_attention_ref(*(t.double() for t in (q, k, v)),
                                       causal=causal)[0]
        for vn in kinds:
            o = fa._launch_fwd(*(fa._aligned(t) for t in (q, k, v)), causal,
                               scale, vn)[0]
            variants[vn]["f64_rel_l2"] = (
                (o.double() - ref64).norm() / ref64.norm()).item()
        del ref64, o
        if variant != prev:
            ratio = (variants[variant]["f64_rel_l2"]
                     / variants[prev]["f64_rel_l2"])
            variants[variant]["f64_rel_l2_vs_fma"] = ratio
            check(ratio <= F32_DESIGN_F64_RATIO,
                  f"flash_attention {name}: {variant} is {ratio:.3g}x "
                  f"further from the float64 plain version than {prev} "
                  f"(> {F32_DESIGN_F64_RATIO})")
    plain_ms = cuda_ms(
        torch, lambda: fa.flash_attention_ref(q, k, v, causal=causal), 5,
        flush)
    # yardstick: PyTorch's own attention (never called by the port); in
    # f32 on aligned copies (its f32 kernel faults on inputs off the
    # 16-byte grid)
    qt, kt, vt = (x.transpose(1, 2) for x in (
        (fa._aligned(t) for t in (q, k, v)) if dtype == torch.float32
        else (q, k, v)))
    gqa = {"enable_gqa": True} if hkv != h else {}
    library_ms = cuda_ms(
        torch,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               **gqa),
        20, flush)
    item = q.element_size()
    # q, k, v, out, lse
    nbytes = (2 * q.numel() + 2 * k.numel()) * item + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    extra = {}
    if variant == "tf32x3":
        extra = {"fma_bound_ms": bound_ms, "fma_bound_by": bound_by}
        bound_ms, bound_by = tf32x3_bound(nbytes, flops)
    return {
        "case": name, "dtype": str(dtype).split(".")[-1], "batch": b,
        "heads": h, "kv_heads": hkv, "d": d, "seq": s, "causal": causal,
        "variant": variant, **stats, "ms": ms,
        "prev_ms": variants[prev]["ms"], "variants": variants,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, **extra,
        "bytes": nbytes, "flops": flops,
    }


def flash_bwd_case(torch, fa, flush, name, s, dtype=None, h=16, hkv=None,
                   d=128, b=1, causal=True, offset=0):
    """The backward kernels against ``flash_attention_bwd_ref`` on the
    forward kernel's out and lse; ``offset`` > 0 starts every input that
    many elements into its buffer (off the 16-byte grid). ``ms`` is the
    wrapper's call (``flash_attention_bwd``: its aligning copies, delta
    and both kernels of the design ``_bwd_variant`` picks), the mean of
    20, as every ``ms``; ``median_ms`` its median. Every design that takes
    the inputs (bf16 at d 64 or 128: the wgmma kernels and the mma.sync
    kernels) is held to the gate and timed side by side through the
    wrapper's own steps (``fa._bwd``: ``variants``), and each kernel alone
    on aligned inputs (``dq_ms``, ``dkv_ms`` and their medians: the wgmma
    dq kernel computes delta, the mma.sync one reads it); ``prev_ms`` is
    the dtype's design before the wgmma kernels. f32 at d 64 or 128 has
    two designs, "tf32x3" (the wrapper's) and "fma" (``prev_ms``): each
    gradient of each is also held to the plain version evaluated in
    float64 (``f64_rel_l2``), the 3xTF32 one at most
    ``F32_DESIGN_F64_RATIO`` times further from it than FMA's, two of its
    runs must be bit-identical, and its bounds count three TF32 products
    (``tf32x3_bound``), the FMA bounds kept beside them (``fma_*``)."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    hkv = hkv or h
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1000 + s)

    def make(heads):
        n = b * s * heads * d
        return (torch.randn(n + offset, generator=g, device=dev)
                .to(dtype)[offset:].view(b, s, heads, d))

    q, k, v, do = make(h), make(hkv), make(hkv), make(h)
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    variant = fa._bwd_variant(dtype, d, s, s)
    prev = "fma" if dtype == torch.float32 else "mma"
    kinds = [variant, prev] if variant != prev else [variant]
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    refs = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    plain_f32 = None
    if dtype == torch.float16:
        # float16: the plain version evaluated in float64 on the same
        # float16 inputs, rounded to float16. The gate's float16 floor
        # (2^-15 of the RMS, ~3.3e-6 at the training shape) binds at dq's
        # first causal row, whose exact value is 0 (one visible key: P =
        # 1, O = V there, so dP = delta); the f32 plain version leaves
        # ~2.5e-6 of rounding there itself, most of the bound. What the
        # f32 plain version gives is kept beside it (``plain_f32``).
        plain_f32 = refs
        refs = tuple(r.to(dtype) for r in fa.flash_attention_bwd_ref(
            *(t.double() for t in (q, k, v, out, lse, do)), causal=causal))
    torch.cuda.synchronize()

    def held(vname, got):
        gate = {}
        for gname, x, ref in zip(("dq", "dk", "dv"), got, refs):
            ok, gate[gname] = compare(x, ref)
            check(ok, f"flash_attention_bwd {name} ({vname}): {gname} "
                      f"{gate[gname]} outside the gate")
        return {"gate": gate, "max_abs_err": {
            gn: st["max_abs_err"] for gn, st in gate.items()}}

    stats = held(variant, grads)
    if plain_f32 is not None:
        stats["plain_f32"] = {gn: compare(x, r)[1] for gn, x, r in zip(
            ("dq", "dk", "dv"), grads, plain_f32)}
        del plain_f32
    ms, median_ms = cuda_times(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal=causal), 20, flush)
    qa, ka, va, oa, da = (fa._aligned(t) for t in (q, k, v, out, do))
    variants = _timed_variants(
        torch, held, kinds,
        lambda vn: fa._bwd(qa, ka, va, oa, lse, da, causal, scale, vn),
        flush, 20)
    for vn in kinds:
        # each kernel alone; the dk/dv kernel on the delta of a dq launch
        delta = fa._delta(oa, da, vn)
        fa._launch_bwd_dq(qa, ka, va, da, oa, lse, delta, causal, scale, vn)
        t = variants[vn]
        t["dq_ms"], t["dq_median_ms"] = cuda_times(
            torch, lambda: fa._launch_bwd_dq(qa, ka, va, da, oa, lse, delta,
                                             causal, scale, vn), 20, flush)
        t["dkv_ms"], t["dkv_median_ms"] = cuda_times(
            torch, lambda: fa._launch_bwd_dkv(qa, ka, va, da, lse, delta,
                                              causal, scale, vn), 20, flush)
        t["kernel_median_ms"] = t["dq_median_ms"] + t["dkv_median_ms"]
    if variant == "tf32x3":
        # both f32 designs against the plain version in float64 (the
        # gate's reference, the f32 plain version, is itself ~4e-7 from
        # it), gradient by gradient; the 3xTF32 kernels run twice
        ref64 = fa.flash_attention_bwd_ref(
            *(t.double() for t in (q, k, v, out, lse, do)), causal=causal)
        for vn in kinds:
            got = fa._bwd(qa, ka, va, oa, lse, da, causal, scale, vn)
            variants[vn]["f64_rel_l2"] = {
                gn: ((x.double() - r).norm() / r.norm()).item()
                for gn, x, r in zip(("dq", "dk", "dv"), got, ref64)}
            if vn == variant:
                again = fa._bwd(qa, ka, va, oa, lse, da, causal, scale, vn)
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"flash_attention_bwd {name} ({vn}): two runs differ")
        del ref64, got, again
        ratio = {gn: variants[variant]["f64_rel_l2"][gn]
                 / variants[prev]["f64_rel_l2"][gn]
                 for gn in ("dq", "dk", "dv")}
        variants[variant]["f64_rel_l2_vs_fma"] = ratio
        check(max(ratio.values()) <= F32_DESIGN_F64_RATIO,
              f"flash_attention_bwd {name}: {variant} is {ratio} times "
              f"further from the float64 plain version than {prev} "
              f"(> {F32_DESIGN_F64_RATIO})")
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=causal), 5, flush)
    # yardstick: PyTorch's own attention backward (never called by the
    # port), on aligned copies: it faults on inputs off the 16-byte grid
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (qa, ka, va))
    gqa = {"enable_gqa": True} if hkv != h else {}
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa)
    dot = da.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), 20, flush)
    item = q.element_size()
    nq, nkv = q.numel() * item, k.numel() * item
    rows = b * h * s * 4                       # one f32 per query row
    pairs = s * (s + 1) // 2 if causal else s * s
    prod = 2 * b * h * d * pairs               # one s x s x d product
    # the function: q, k, v, out, dO read, dq, dk, dv written, lse and
    # delta; five products. Each kernel alone: its own reads and writes;
    # dq runs S, dP, dS K (3), dk/dv S^T, dP^T, P^T dO, dS^T Q (4)
    work = {"": (3 * nq + 2 * nkv + 2 * nkv + nq + 2 * rows, 5 * prod),
            "dq_": (3 * nq + 2 * nkv + 2 * rows, 3 * prod),
            "dkv_": (2 * nq + 4 * nkv + 2 * rows, 4 * prod)}
    bounds = {}
    for part, (nbytes, flops) in work.items():
        b_ms, b_by = bound(nbytes, flops, dtype, torch)
        if variant == "tf32x3":
            bounds[f"fma_{part}bound_ms"] = b_ms
            bounds[f"fma_{part}bound_by"] = b_by
            b_ms, b_by = tf32x3_bound(nbytes, flops)
        bounds[f"{part}bound_ms"], bounds[f"{part}bound_by"] = b_ms, b_by
    case = {
        "case": name, "dtype": str(dtype).split(".")[-1], "batch": b,
        "heads": h, "kv_heads": hkv, "d": d, "seq": s, "causal": causal,
        "offset": offset, "variant": variant, **stats,
        "ms": ms, "median_ms": median_ms,
        "dq_ms": variants[variant]["dq_ms"],
        "dkv_ms": variants[variant]["dkv_ms"],
        "prev_ms": variants[prev]["ms"], "variants": variants,
        "plain_ms": plain_ms,
        "library_ms": library_ms, **bounds, "flops": 5 * prod,
    }
    log(f"[kernels] {json.dumps(case)}")
    return case


def gate_faults(torch, fa, s=TRAIN_SEQ, b=TRAIN_BATCH, h=16, d=128):
    """``GATE`` must reject a bf16 backward with a planted fault, at the
    training shape. The wrapper runs on a wrong ``out``, from which the
    dq kernel computes delta: "no_delta" on out = 0 (delta = 0, dS = P dP
    scale), "late_delta" on out x 0.9 in the second half of the rows only
    (delta 10 % off there), a fault that changes each late gradient by a
    few ulps of its own (``FIXED_BOUND`` lets its dk through). dq and dk
    must fail; dv, which does not read delta, and the correct run must
    pass. Returns what the gate read on each."""
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    refs = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    late = out.clone()
    late[:, s // 2:] *= 0.9
    changed = {"none": (), "no_delta": ("dq", "dk"),
               "late_delta": ("dq", "dk")}
    result = {}
    for fault, o in (("none", out), ("no_delta", torch.zeros_like(out)),
                     ("late_delta", late)):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        for gname, x, ref in zip(("dq", "dk", "dv"), got, refs):
            ok, stats = compare(x, ref)
            result[f"{fault}.{gname}"] = dict(stats, gate_ok=ok)
            check(ok != (gname in changed[fault]),
                  f"gate: {fault} {gname} {'passed' if ok else 'failed'} "
                  f"({stats})")
    log(f"[kernels] gate faults {json.dumps(result)}")
    return result


# planted copies of the f32 flash forward (FLASH_TF32_PLANT in
# csrc/flash_attention.cu) and backward (FLASH_BWD_TF32_PLANT in
# csrc/flash_attention_bwd.cu), built beside the library
TF32_PLANTS = {1: "one_pass_tf32", 2: "late_tile_x1.01"}
BWD_TF32_PLANTS = {1: "one_pass_tf32", 2: "late_tile_ds_x1.01"}
# the gradients each backward plant must push out of the gate (dv does not
# read dS)
BWD_PLANT_CHANGES = {0: (), 1: ("dq", "dk", "dv"), 2: ("dq", "dk")}


def start_plant_builds():
    """One nvcc per planted copy of ``csrc/flash_attention.cu`` and of
    ``csrc/flash_attention_bwd.cu``, all started at once (they build
    while the kernels phase runs): {(source, plant): (library path,
    process)}."""
    from paddle_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, macro, plants in (
            ("flash_attention", "FLASH_TF32_PLANT", TF32_PLANTS),
            ("flash_attention_bwd", "FLASH_BWD_TF32_PLANT",
             BWD_TF32_PLANTS)):
        src = _build.CSRC_DIR / f"{name}.cu"
        for plant in plants:
            out = _build.BUILD_DIR / f"{name}-plant{plant}.so"
            procs[name, plant] = (out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, f"-D{macro}={plant}",
                 "-o", str(out), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    return procs


def _planted(fa, name, procs, plant, entries):
    """The planted copy ``plant`` of library ``name`` (its nvcc waited
    for), its ``entries`` typed as the library's."""
    path, proc = procs[name, plant]
    text, _ = proc.communicate()
    check(proc.returncode == 0,
          f"planted {name} {plant}: nvcc failed\n{text}")
    real = fa._kernel(name)
    lib = ctypes.CDLL(str(path))
    for entry in entries:
        fn, want = getattr(lib, entry), getattr(real, entry)
        fn.argtypes, fn.restype = want.argtypes, want.restype
    return lib


def tf32_plant_faults(torch, fa, procs):
    """``GATE`` must reject both planted copies of the 3xTF32 forward
    (``TF32_PLANTS``: the cross terms left out, one-pass TF32; the last
    key tile's scores x 1.01) at the DiT shape in f32 (non-causal, b 32,
    h 8, d 64, s 256), and pass the library's kernel on the same inputs.
    Each copy is loaded in place of the library for one launch. Returns
    what the gate read on each."""
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(DIT_BATCH, DIT_SEQ, DIT_CFG["num_heads"],
                           DIT_HEAD_DIM, generator=g, device="cuda")
               for _ in range(3))
    ref = fa.flash_attention_ref(q, k, v, causal=False)[0]
    real = fa._kernel("flash_attention")
    result = {}
    for plant in (0, *TF32_PLANTS):
        name = TF32_PLANTS.get(plant, "none")
        if plant:
            fa._libs["flash_attention"] = _planted(
                fa, "flash_attention", procs, plant,
                ("flash_attention_fwd_launch",))
        try:
            o = fa._launch_fwd(q, k, v, False, DIT_HEAD_DIM ** -0.5,
                               "tf32x3")[0]
            torch.cuda.synchronize()
        finally:
            fa._libs["flash_attention"] = real
        ok, stats = compare(o, ref)
        result[name] = dict(stats, gate_ok=ok)
        check(ok == (plant == 0),
              f"gate: f32 flash forward, plant {name} "
              f"{'passed' if ok else 'failed'} ({stats})")
    log(f"[kernels] f32 forward plants {json.dumps(result)}")
    return result


def bwd_tf32_plant_faults(torch, fa, procs):
    """``GATE`` must reject both planted copies of the 3xTF32 backward
    (``BWD_TF32_PLANTS``: one-pass TF32 in every product; dS x 1.01 in
    dq's last key tile and dk/dv's last query tile) at the DiT shape in
    f32, in every gradient the plant touches (``BWD_PLANT_CHANGES``:
    dv does not read dS), and pass the library's kernels and the
    gradients a plant leaves alone. Each copy is loaded in place of the
    library for one backward. Returns what the gate read on each."""
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, do = (torch.randn(DIT_BATCH, DIT_SEQ, DIT_CFG["num_heads"],
                               DIT_HEAD_DIM, generator=g, device="cuda")
                   for _ in range(4))
    scale = DIT_HEAD_DIM ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    refs = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=False)
    real = fa._kernel("flash_attention_bwd")
    result = {}
    for plant in (0, *BWD_TF32_PLANTS):
        name = BWD_TF32_PLANTS.get(plant, "none")
        if plant:
            fa._libs["flash_attention_bwd"] = _planted(
                fa, "flash_attention_bwd", procs, plant,
                ("flash_attention_bwd_dq_launch",
                 "flash_attention_bwd_dkv_launch"))
        try:
            got = fa._bwd(q, k, v, out, lse, do, False, scale, "tf32x3")
            torch.cuda.synchronize()
        finally:
            fa._libs["flash_attention_bwd"] = real
        for gname, x, ref in zip(("dq", "dk", "dv"), got, refs):
            ok, stats = compare(x, ref)
            result[f"{name}.{gname}"] = dict(stats, gate_ok=ok)
            check(ok != (gname in BWD_PLANT_CHANGES[plant]),
                  f"gate: f32 flash backward, plant {name} {gname} "
                  f"{'passed' if ok else 'failed'} ({stats})")
    log(f"[kernels] f32 backward plants {json.dumps(result)}")
    return result


SERVING_GEOMETRY = dict(hkv=16, d=128, page=16, pages_per_seq=32,
                        num_blocks=256)


def kv_write_case(torch, kw, flush, name, dtype, n, prefill, quant):
    """The fused KV-write kernel against ``kv_write_ref`` on the same pool
    and rows, at the serving pool's geometry (16 kv heads, d 128, page
    16, 32 pages a table, 256 blocks and the sink): the live pages and
    scales equal bit for bit (the sink, which the plain version writes
    and the kernel does not, left out). Decode: ``n`` rows, one per slot,
    with one at capacity and one inactive; prefill: row 0, positions
    0..n-1, the last 12 past the prompt's length. Times the wrapper's
    call, the plain version and, for a float pool, the library call: two
    ``index_put_`` (K and V) over the rows to write, their indices
    precomputed."""
    dev = "cuda"
    geo = SERVING_GEOMETRY
    hkv, d, page, pps, nb = (geo["hkv"], geo["d"], geo["page"],
                             geo["pages_per_seq"], geo["num_blocks"])
    g = torch.Generator(device=dev).manual_seed(n + 7 * quant)
    shape = (hkv, nb + 1, page, d)

    def pool():
        if quant:
            return (torch.randint(-127, 128, shape, generator=g, device=dev,
                                  dtype=torch.int8),
                    torch.rand(shape[:3], generator=g, device=dev))
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    kp, vp = pool(), pool()
    kn = (torch.randn(n, hkv, d, generator=g, device=dev) * 3).to(dtype)
    vn = torch.randn(n, hkv, d, generator=g, device=dev).to(dtype)
    kn[0, 0] = 0                                 # an all-zero row
    if prefill:
        tables = torch.randperm(nb, generator=g, device=dev)[:pps]
        tables = tables.view(1, pps).to(torch.int32)
        rows = torch.zeros(n, dtype=torch.int32, device=dev)
        positions = torch.arange(n, dtype=torch.int32, device=dev)
        valid = positions < n - 12
    else:
        tables = torch.randperm(nb, generator=g, device=dev)[:n * pps]
        tables = tables.view(n, pps).to(torch.int32)
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        positions = torch.randint(0, pps * page, (n,), generator=g,
                                  device=dev, dtype=torch.int32)
        positions[1] = pps * page                # at capacity
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[2] = False                         # an inactive slot
    args = (kn, vn, tables, rows, positions, valid)
    copy = _pool_copy([kp, vp])
    kw.kv_write(kp, vp, *args)
    kw.kv_write_ref(*copy, *args)
    torch.cuda.synchronize()
    live = [t[:, :-1] for e in (kp, vp)
            for t in (e if quant else (e,))]
    want = [t[:, :-1] for e in copy for t in (e if quant else (e,))]
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(live, want))
    exact = all(torch.equal(a, b) for a, b in zip(live, want))
    check(exact, f"kv_write {name}: kernel and plain version differ (max "
                 f"abs {diff})")
    ms = cuda_ms(torch, lambda: kw.kv_write(kp, vp, *args), 50, flush)
    plain_ms = cuda_ms(torch, lambda: kw.kv_write_ref(*copy, *args), 20,
                       flush)
    write = valid & (positions < pps * page)
    w = int(write.sum())
    library_ms = None
    if not quant:
        pos = positions[write].long()
        phys = tables[rows[write].long(), pos // page].long()
        slot = pos % page
        ks, vs = kn[write].transpose(0, 1), vn[write].transpose(0, 1)

        def library():
            kp[:, phys, slot] = ks
            vp[:, phys, slot] = vs

        library_ms = cuda_ms(torch, library, 50, flush)
    elem = kn.element_size()
    page_elem = 1 if quant else elem
    # the rows it writes, read once and stored once (int8: their f32
    # scales too); rows, positions and valid read once, one table entry
    # per written row
    nbytes = (2 * w * hkv * d * (elem + page_elem) + (2 * w * hkv * 4
              if quant else 0) + n * 9 + w * 4)
    # int8: absmax, division and rounding per element, in f32
    flops = 3 * 2 * w * hkv * d if quant else 0
    bound_ms, bound_by = bound(nbytes, flops, torch.float32, torch)
    case = {"case": name, "dtype": str(dtype).split(".")[-1],
            "pool": "int8" if quant else str(dtype).split(".")[-1],
            "rows": n, "rows_written": w, "prefill": prefill, "hkv": hkv,
            "d": d, "page_size": page, "exact": exact, "max_abs_err": diff,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": ("index_put_ of K and V" if not quant else
                        "none: no PyTorch call quantizes and scatters"),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops}
    log(f"[kernels] kv_write {json.dumps(case)}")
    return case


# the rotating page write's cases: (name, rows, hq, hkv, d, routing);
# routing as the serving programs write: decode (one row a slot), verify
# (8 slots x 5-row windows), chunk (a 128-token continuation after 192
# cached), prefill (a 512-token bucket, 500 valid, k returned for flash)
ROPE_KV_SHAPES = (("decode", 8, 16, 16, 128, "decode"),
                  ("verify", 40, 16, 16, 128, "verify"),
                  ("chunk", 128, 16, 16, 128, "chunk"),
                  ("prefill", 512, 16, 16, 128, "prefill"),
                  ("gqa", 8, 32, 4, 64, "decode"))
ROPE_KV_POOLS = (("bf16", "bfloat16", False),
                 ("int8", "bfloat16", True),
                 ("f16", "float16", False),
                 ("f32", "float32", False))


def _bit_equal(torch, a, b):
    """Bit for bit (so -0.0 differs from 0.0), any dtype."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def rope_kv_write_case(torch, kw, flush, name, dtype, n, hq, hkv, d,
                       routing, quant):
    """The rotating page write (``rope_kv_write``) against
    ``rope_kv_write_ref`` on a copy of the same pool, at the serving
    pool's page geometry (page 16, 32 pages a table, 256 blocks and the
    sink) with ``hkv`` heads of ``d``: the rotated q (and k, in the
    prefill routing), the live pages and scales equal bit for bit (the
    sink, which the plain version writes and the kernel does not, left
    out). Angles from ``rope_table`` at the rows' positions. Times the
    wrapper's call, the plain version, and (``prev_ms``) what the serving
    programs ran before it at the same shape: ``rope_qk`` then the
    ``kv_write`` kernel. No one PyTorch call rotates and pages, so no
    library time."""
    from paddle_tpu_torch.ops.fused_ops import rope_qk, rope_table

    dev = "cuda"
    geo = SERVING_GEOMETRY
    page, pps, nb = geo["page"], geo["pages_per_seq"], geo["num_blocks"]
    capacity = pps * page
    g = torch.Generator(device=dev).manual_seed(n + 7 * quant + hq)
    shape = (hkv, nb + 1, page, d)

    def pool():
        if quant:
            return (torch.randint(-127, 128, shape, generator=g, device=dev,
                                  dtype=torch.int8),
                    torch.rand(shape[:3], generator=g, device=dev))
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    kp, vp = pool(), pool()
    q = (torch.randn(n, hq, d, generator=g, device=dev) * 2).to(dtype)
    k = (torch.randn(n, hkv, d, generator=g, device=dev) * 3).to(dtype)
    v = torch.randn(n, hkv, d, generator=g, device=dev).to(dtype)
    k[0, 0] = 0                                  # an all-zero row
    want_k = routing == "prefill"
    if routing in ("chunk", "prefill"):
        tables = torch.randperm(nb, generator=g, device=dev)[:pps]
        tables = tables.view(1, pps).to(torch.int32)
        rows = torch.zeros(n, dtype=torch.int32, device=dev)
        t = torch.arange(n, dtype=torch.int32, device=dev)
        positions = t + (192 if routing == "chunk" else 0)
        valid = t < (n if routing == "chunk" else n - 12)
    else:
        slots = n if routing == "decode" else n // 5
        tables = torch.randperm(nb, generator=g, device=dev)[:slots * pps]
        tables = tables.view(slots, pps).to(torch.int32)
        base = torch.randint(0, capacity - 4, (slots,), generator=g,
                             device=dev, dtype=torch.int32)
        active = torch.ones(slots, dtype=torch.bool, device=dev)
        if routing == "decode":
            rows = torch.arange(slots, dtype=torch.int32, device=dev)
            positions = base.clone()
            positions[1] = capacity                  # at capacity
            active[2] = False                        # an inactive slot
            valid = active
        else:
            # 8 slots x 5 rows: slot 1's window crosses capacity, slots 2
            # and 5 inactive, draft lengths 0-4
            w = n // slots
            base[1] = capacity - 2
            active[2] = active[5] = False
            drafts = torch.arange(slots, device=dev, dtype=torch.int32) % w
            drafts[1] = w - 1
            j = torch.arange(w, device=dev, dtype=torch.int32)
            pos = base[:, None] + j[None]
            rows = torch.arange(slots, dtype=torch.int32,
                                device=dev).repeat_interleave(w)
            positions = pos.reshape(-1)
            valid = (active[:, None] & (j[None] <= drafts[:, None])
                     & (pos < capacity)).reshape(-1)
    cos, sin = rope_table(positions, d)
    args = (tables, rows, positions, valid)
    copy = _pool_copy([kp, vp])
    got = kw.rope_kv_write(q, k, v, cos, sin, kp, vp, *args, want_k=want_k)
    want = kw.rope_kv_write_ref(q, k, v, cos, sin, *copy, *args,
                                want_k=want_k)
    torch.cuda.synchronize()
    got = got if want_k else (got,)
    want = want if want_k else (want,)
    live = [t[:, :-1] for e in (kp, vp) for t in (e if quant else (e,))]
    ref = [t[:, :-1] for e in copy for t in (e if quant else (e,))]
    pairs = list(zip(got, want)) + list(zip(live, ref))
    diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    exact = all(_bit_equal(torch, a, b) for a, b in pairs)
    check(exact, f"rope_kv_write {name}: kernel and plain version differ "
                 f"(max abs {diff})")
    ms, median_ms = cuda_times(torch, lambda: kw.rope_kv_write(
        q, k, v, cos, sin, kp, vp, *args, want_k=want_k), 50, flush)
    plain_ms = cuda_ms(torch, lambda: kw.rope_kv_write_ref(
        q, k, v, cos, sin, *copy, *args, want_k=want_k), 20, flush)

    def prev():   # the parent's chain: rope_qk, then the kv_write kernel
        qr, kr = rope_qk(q[None], k[None], positions[None])
        kw.kv_write(*copy, kr[0], v, *args)

    prev_ms, prev_median_ms = cuda_times(torch, prev, 50, flush)
    capacity_ok = valid & (positions < capacity)
    written = int(capacity_ok.sum())
    elem = q.element_size()
    page_elem = 1 if quant else elem
    k_read = n if want_k else written
    # q read and q_out written; the k rows it needs (all with k_out);
    # k_out; the written rows' v; the page rows (int8: and scales); the
    # angles; rows, positions and valid, one table entry per written row
    nbytes = (2 * n * hq * d * elem + k_read * hkv * d * elem
              + (n * hkv * d * elem if want_k else 0)
              + written * hkv * d * elem
              + 2 * written * hkv * d * page_elem
              + (2 * written * hkv * 4 if quant else 0)
              + 2 * n * (d // 2) * 4 + n * 9 + written * 4)
    # 3 f32 operations an element of a rotated row (2 products, a sum);
    # int8: absmax, division and rounding per written element
    flops = (3 * d * (n * hq + k_read * hkv)
             + (3 * 2 * written * hkv * d if quant else 0))
    bound_ms, bound_by = bound(nbytes, flops, torch.float32, torch)
    case = {"case": name, "dtype": str(dtype).split(".")[-1],
            "pool": "int8" if quant else str(dtype).split(".")[-1],
            "routing": routing, "rows": n, "rows_written": written,
            "hq": hq, "hkv": hkv, "d": d, "page_size": page,
            "want_k": want_k, "exact": exact, "max_abs_err": diff,
            "ms": ms, "median_ms": median_ms, "plain_ms": plain_ms,
            "prev_ms": prev_ms, "prev_median_ms": prev_median_ms,
            "prev": "rope_qk + kv_write kernel", "library_ms": None,
            "library": "none: no PyTorch call rotates and pages",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops}
    log(f"[kernels] rope_kv_write {json.dumps(case)}")
    return case


def _prefill_designs(torch, pp, flush, name, run, launch, rows, dtype, d,
                     page):
    """Both designs of the continuation kernel on one case: the wrapper's
    default (``split``; ``fma`` for f32 q) and ``design="ring"`` (the
    earlier kernel; f32: the same FMA kernel, run once). Each is held to
    ``GATE`` against the plain version (``run("plain")``) on the rows
    ``rows`` picks, every row finite, and timed (mean and median of 20)
    through the
    wrapper (``run(design)``) and alone (``launch(design)``). Returns
    {design: stats}, the default first."""
    ref = run("plain")
    variants = {}
    for req in (None, "ring"):
        design = pp.design_for(dtype, d, page, req)
        if design in variants:
            continue
        out = run(req)
        torch.cuda.synchronize()
        ok, stats = compare(rows(out), rows(ref))
        check(ok and bool(out.isfinite().all()),
              f"paged_prefill {name} ({design}): {stats} outside the gate, "
              f"or a row not finite")
        ms, median_ms = cuda_times(torch, lambda: run(req), 20, flush)
        kernel_ms, kernel_median_ms = cuda_times(
            torch, lambda: launch(req), 20, flush)
        variants[design] = {**stats, "ms": ms, "median_ms": median_ms,
                            "kernel_ms": kernel_ms,
                            "kernel_median_ms": kernel_median_ms}
    return variants


def _prefill_case_times(variants):
    """The case's headline numbers: the default design's, and the ring
    design's beside them (``ring_*``; f32: the FMA kernel's own)."""
    design = next(iter(variants))
    head, ring = variants[design], variants.get("ring", variants[design])
    return {"design": design, **head,
            "ring_ms": ring["ms"], "ring_median_ms": ring["median_ms"],
            "ring_kernel_ms": ring["kernel_ms"],
            "ring_kernel_median_ms": ring["kernel_median_ms"],
            "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
            "variants": variants}


def paged_prefill_case(torch, pp, fa, flush, name, dtype, hq, hkv, d,
                       cache_len, n, quant=False):
    """The continuation kernel against ``paged_prefill_ref`` on the same
    pages (the serving pool's geometry: page 16, 32 pages a table, 256
    blocks and the sink), ``n`` chunk tokens after ``cache_len`` cached
    ones, q padded to the engine's bucket (the next power of two from 16):
    rows below ``n`` within ``GATE``, every row finite, on both designs
    (``_prefill_designs``). Times (mean and median of 20) the wrapper's
    call and the kernel alone on each design, the plain version, and the
    library: the same function in PyTorch calls (the gather of the
    table's pages and ``F.scaled_dot_product_attention`` with the boolean
    mask, which is precomputed); at ``cache_len`` 0 also the flash kernel
    on the same n tokens' contiguous K/V (what one-shot prefill runs)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.paged_attention import quantize_tokens

    dev = "cuda"
    geo = SERVING_GEOMETRY
    page, pps, nb = geo["page"], geo["pages_per_seq"], geo["num_blocks"]
    g = torch.Generator(device=dev).manual_seed(cache_len * 1000 + n)
    s = 16
    while s < n:
        s *= 2
    q = torch.randn(s, hq, d, generator=g, device=dev).to(dtype)
    kp = torch.randn(hkv, nb + 1, page, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(hkv, nb + 1, page, d, generator=g, device=dev).to(dtype)
    table = torch.randperm(nb, generator=g, device=dev)[:pps].to(torch.int32)
    k, v = ((quantize_tokens(kp), quantize_tokens(vp)) if quant
            else (kp, vp))
    cl = torch.tensor(cache_len, dtype=torch.int32, device=dev)
    ln = torch.tensor(n, dtype=torch.int32, device=dev)
    kq, ks = pp.split_pages(k)
    vq, vs = pp.split_pages(v)

    def run(design):
        if design == "plain":
            return pp.paged_prefill_ref(q, k, v, table, cl, ln)
        return pp.paged_prefill(q, k, v, table, cl, ln, design=design)

    def launch(design):   # the inputs as the wrapper hands them over
        return pp._launch(q[None], kq, vq, ks, vs, table[None],
                          cl.reshape(1), ln.reshape(1), d ** -0.5, design)

    variants = _prefill_designs(torch, pp, flush, name, run, launch,
                                lambda x: x[:n], dtype, d, page)
    plain_ms = cuda_ms(torch, lambda: run("plain"), 10, flush)
    cap = pps * page
    keep = (torch.arange(cap, device=dev)[None, :]
            <= cache_len + torch.arange(s, device=dev)[:, None])
    keep = keep[None, None]
    qt = q.transpose(0, 1)[None]
    tl = table.long()

    def gathered(pages):
        pq, sc = pages if quant else (pages, None)
        x = pq[:, tl]
        if quant:
            x = (x.float() * sc[:, tl][..., None]).to(dtype)
        return x.reshape(hkv, cap, d)[None]

    gqa = {"enable_gqa": True} if hkv != hq else {}
    library_ms = cuda_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qt, gathered(k), gathered(v), attn_mask=keep, **gqa), 20, flush)
    extra = {}
    if cache_len == 0 and not quant and dtype != torch.float16:
        # one-shot prefill's kernel over the same tokens' K/V, contiguous
        kc, vc = (gathered(x)[0, :, :n].transpose(0, 1)[None].contiguous()
                  for x in (kp, vp))
        qc = q[None, :n].contiguous()
        extra["flash_ms"], extra["flash_median_ms"] = cuda_times(
            torch, lambda: fa.flash_attention(qc, kc, vc, causal=True), 20,
            flush)
    keys = cache_len + n
    row_bytes = d + 4 if quant else d * q.element_size()
    # q in, out; each K/V row the chunk sees once (int8: its bytes and
    # its scale); the table and the two scalars
    nbytes = (2 * q.numel() * q.element_size() + 2 * keys * hkv * row_bytes
              + table.numel() * 4 + 8)
    # causal over the timeline: chunk token t sees cache_len + t + 1 keys
    pairs = n * cache_len + n * (n + 1) // 2
    flops = 4 * hq * d * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    case = {"case": name, "dtype": str(dtype).split(".")[-1], "int8": quant,
            "hq": hq, "hkv": hkv, "d": d, "cache_len": cache_len,
            "chunk": n, "q_rows": s, **_prefill_case_times(variants),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "page gather + F.scaled_dot_product_attention "
                       "(bool mask)",
            **extra, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops}
    log(f"[kernels] paged_prefill {json.dumps(case)}")
    return case


# the verify window of the serving_spec cell (8 slots, K = 4): each slot's
# position (its cache length), draft length and whether it is active.
# Positions spread over 0-507, two slots inactive, the last window
# reaching the table's capacity (508 + 4 = 512 of 512)
VERIFY_POSITIONS = [0, 37, 130, 255, 300, 411, 480, 508]
VERIFY_DRAFTS = [4, 2, 4, 0, 3, 4, 1, 4]
VERIFY_ACTIVE = [1, 1, 0, 1, 1, 0, 1, 1]


def paged_prefill_batched_case(torch, pp, flush, name, dtype, hq, hkv, d,
                               quant=False):
    """The continuation kernel's batched form (the verify window: one
    launch for every slot) against the batched ``paged_prefill_ref`` on
    the same pages (the serving pool's geometry: page 16, 32 pages a
    table, 256 blocks and the sink), 8 slots of S = 5 rows at
    ``VERIFY_POSITIONS`` with ``VERIFY_DRAFTS`` + 1 valid rows and
    ``VERIFY_ACTIVE``: the active slots' valid rows within ``GATE``,
    every row finite, on both designs (``_prefill_designs``, each timed
    through the wrapper and alone). Times the plain version and the
    library: the batched page gather and one
    ``F.scaled_dot_product_attention`` with the [slots, 1, S, C] boolean
    mask (precomputed)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.paged_attention import quantize_tokens

    dev = "cuda"
    geo = SERVING_GEOMETRY
    page, pps, nb = geo["page"], geo["pages_per_seq"], geo["num_blocks"]
    n, s = len(VERIFY_POSITIONS), 5
    g = torch.Generator(device=dev).manual_seed(hq * 100 + d + quant)
    q = torch.randn(n, s, hq, d, generator=g, device=dev).to(dtype)
    kp = torch.randn(hkv, nb + 1, page, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(hkv, nb + 1, page, d, generator=g, device=dev).to(dtype)
    tables = torch.stack([torch.randperm(nb, generator=g, device=dev)[:pps]
                          for _ in range(n)]).to(torch.int32)
    k, v = ((quantize_tokens(kp), quantize_tokens(vp)) if quant
            else (kp, vp))
    active = torch.tensor(VERIFY_ACTIVE, device=dev).bool()
    cl = torch.tensor(VERIFY_POSITIONS, dtype=torch.int32, device=dev)
    ln = torch.where(active, torch.tensor(VERIFY_DRAFTS, device=dev) + 1,
                     0).to(torch.int32)
    rows = torch.arange(s, device=dev)[None] < ln[:, None]     # [n, S]
    kq, ks = pp.split_pages(k)
    vq, vs = pp.split_pages(v)

    def run(design):
        if design == "plain":
            return pp.paged_prefill_ref(q, k, v, tables, cl, ln)
        return pp.paged_prefill(q, k, v, tables, cl, ln, design=design)

    def launch(design):
        return pp._launch(q, kq, vq, ks, vs, tables, cl, ln, d ** -0.5,
                          design)

    variants = _prefill_designs(torch, pp, flush, name, run, launch,
                                lambda x: x[rows], dtype, d, page)
    plain_ms = cuda_ms(torch, lambda: run("plain"), 10, flush)
    cap = pps * page
    keep = (torch.arange(cap, device=dev)[None, None, :]
            <= (cl[:, None] + torch.arange(s, device=dev)[None])[:, :, None])
    keep = keep[:, None]                                      # [n, 1, S, C]
    qt = q.transpose(1, 2)
    tl = tables.long()

    def gathered(pages):
        pq, sc = pages if quant else (pages, None)
        x = pq[:, tl]                                 # [hkv, n, P, page, d]
        if quant:
            x = (x.float() * sc[:, tl][..., None]).to(dtype)
        return x.reshape(hkv, n, cap, d).transpose(0, 1)

    gqa = {"enable_gqa": True} if hkv != hq else {}
    library_ms = cuda_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qt, gathered(k), gathered(v), attn_mask=keep, **gqa), 20, flush)
    lens = [int(x) for x in ln.tolist()]
    keys = sum(min(c + n_, cap) for c, n_ in zip(VERIFY_POSITIONS, lens)
               if n_)
    row_bytes = d + 4 if quant else d * q.element_size()
    # q in, out; each K/V row an active window sees once (int8: its bytes
    # and its scale); the tables and the two [slots] vectors
    nbytes = (2 * q.numel() * q.element_size() + 2 * keys * hkv * row_bytes
              + tables.numel() * 4 + 8 * n)
    # window row t of slot s sees min(position + t + 1, capacity) keys
    pairs = sum(min(c + t + 1, cap) for c, n_ in zip(VERIFY_POSITIONS, lens)
                for t in range(n_))
    flops = 4 * hq * d * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype, torch)
    case = {"case": name, "dtype": str(dtype).split(".")[-1], "int8": quant,
            "hq": hq, "hkv": hkv, "d": d, "slots": n, "window": s,
            "positions": VERIFY_POSITIONS, "lengths": lens,
            **_prefill_case_times(variants), "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "batched page gather + F.scaled_dot_product_"
                       "attention ([slots, 1, S, C] bool mask)",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops}
    log(f"[kernels] paged_prefill batched {json.dumps(case)}")
    return case


def phase_kernels(torch):
    plants = start_plant_builds()
    try:
        return _kernel_cases(torch, plants)
    finally:
        for _, proc in plants.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _kernel_cases(torch, plants):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import grouped_matmul as gk
    from paddle_tpu_torch.kernels import kv_write as kw
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import paged_prefill as pp

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lengths = [0, 1, 15, 16, 17, 200, 511, 512]   # 0, partial, full pages
    cases = [
        ("serving", torch.bfloat16, 16, 16, 128, lengths, {}),
        ("gqa", torch.bfloat16, 32, 4, 64, lengths, {}),
        ("serving_f32", torch.float32, 16, 16, 128, lengths, {}),
        # 16 chunks per sequence, most of them empty for the short ones
        ("long", torch.bfloat16, 16, 16, 128, [2048, 1000, 129, 3],
         {"pages_per_seq": 128}),
        # head dim and page size that take the scalar-load path
        ("odd", torch.bfloat16, 6, 2, 20, [37, 0, 5],
         {"page": 5, "pages_per_seq": 8}),
        ("serving_f16", torch.float16, 16, 16, 128, lengths, {}),
    ]
    paged = [paged_case(torch, pa, flush, *c[:6], **c[6]) for c in cases]
    quant = [paged_case(torch, pa, flush, *c[:6], **c[6], quant=True)
             for c in cases]
    flash = [flash_case(torch, fa, flush, s)
             for s in (16, 32, 64, 100, 128, 512, 2048)]
    flash += [
        flash_case(torch, fa, flush, 100, dtype=torch.float32),
        flash_case(torch, fa, flush, 100, offset=1),
        flash_case(torch, fa, flush, 512, h=32, hkv=4, d=64),   # GQA d 64
        flash_case(torch, fa, flush, 100, h=32, hkv=4, d=64),   # ragged
        flash_case(torch, fa, flush, 128, causal=False),
        flash_case(torch, fa, flush, 100, causal=False),
        flash_case(torch, fa, flush, 128, d=32),                # mma.sync
        flash_case(torch, fa, flush, TRAIN_SEQ, b=TRAIN_BATCH),
    ]
    # the float16 instances (PR 15): the training shape, one long
    # sequence, GQA at d 64
    f16 = torch.float16
    flash += [
        flash_case(torch, fa, flush, TRAIN_SEQ, b=TRAIN_BATCH, dtype=f16),
        flash_case(torch, fa, flush, 2048, dtype=f16),
        flash_case(torch, fa, flush, 512, h=32, hkv=4, d=64, dtype=f16),
    ]
    # the DiT cell's attention: non-causal, b 32, h 8, d 64, s 256,
    # bf16 (the wgmma kernel, amp O2) and f32 (the 3xTF32 kernel beside
    # the FMA one, the bench's dtype)
    flash += [flash_case(torch, fa, flush, DIT_SEQ, h=DIT_CFG["num_heads"],
                         d=DIT_HEAD_DIM, b=DIT_BATCH, causal=False,
                         dtype=dt)
              for dt in (torch.bfloat16, torch.float32)]
    # f32 at the training shape, GQA d 64 and off the 16-byte grid: both
    # f32 designs (with s 100 d 128 and the DiT shape above)
    f32 = torch.float32
    flash += [
        flash_case(torch, fa, flush, TRAIN_SEQ, b=TRAIN_BATCH, dtype=f32),
        flash_case(torch, fa, flush, 512, h=32, hkv=4, d=64, dtype=f32),
        flash_case(torch, fa, flush, 100, offset=1, dtype=f32),
    ]
    bwd = [flash_bwd_case(torch, fa, flush, f"s{s}", s)
           for s in (128, 512, 1024, 2048)]
    bwd += [
        flash_bwd_case(torch, fa, flush, "train", TRAIN_SEQ, b=TRAIN_BATCH),
        flash_bwd_case(torch, fa, flush, "gqa", 512, h=32, hkv=4, d=64),
        flash_bwd_case(torch, fa, flush, "d64", 512, d=64),
        flash_bwd_case(torch, fa, flush, "full", 128, causal=False),
        flash_bwd_case(torch, fa, flush, "ragged", 100),
        flash_bwd_case(torch, fa, flush, "ragged_gqa_d64", 100, h=32, hkv=4,
                       d=64),
        flash_bwd_case(torch, fa, flush, "ragged_full", 100, causal=False),
        flash_bwd_case(torch, fa, flush, "unaligned", 100, offset=1),
        flash_bwd_case(torch, fa, flush, "d32", 128, d=32),   # mma.sync
        flash_bwd_case(torch, fa, flush, "f32", 100, dtype=torch.float32),
        # f32 at the training shape, GQA d 64 (also ragged) and off the
        # 16-byte grid: both f32 designs (with s 100 d 128 above and the
        # DiT shape below)
        flash_bwd_case(torch, fa, flush, "train_f32", TRAIN_SEQ,
                       b=TRAIN_BATCH, dtype=torch.float32),
        flash_bwd_case(torch, fa, flush, "gqa_f32", 512, h=32, hkv=4, d=64,
                       dtype=torch.float32),
        flash_bwd_case(torch, fa, flush, "ragged_gqa_d64_f32", 100, h=32,
                       hkv=4, d=64, dtype=torch.float32),
        flash_bwd_case(torch, fa, flush, "unaligned_f32", 100, offset=1,
                       dtype=torch.float32),
        flash_bwd_case(torch, fa, flush, "train_f16", TRAIN_SEQ,
                       b=TRAIN_BATCH, dtype=f16),
        flash_bwd_case(torch, fa, flush, "s2048_f16", 2048, dtype=f16),
        flash_bwd_case(torch, fa, flush, "gqa_f16", 512, h=32, hkv=4, d=64,
                       dtype=f16),
    ]
    bwd += [flash_bwd_case(torch, fa, flush, name, DIT_SEQ,
                           h=DIT_CFG["num_heads"], d=DIT_HEAD_DIM,
                           b=DIT_BATCH, causal=False, dtype=dt)
            for name, dt in (("dit", torch.bfloat16),
                             ("dit_f32", torch.float32))]
    for c in paged + flash:
        log(f"[kernels] {json.dumps(c)}")
    for c in quant:
        log(f"[kernels] int8 paged {json.dumps(c)}")
    # bench_kernels' MoE layer: 8 x 1024 tokens, top-2 of 8 experts
    d, f, e = MOE_LAYER["d_model"], MOE_LAYER["d_ff"], MOE_LAYER["num_experts"]
    routed = _routed_group_sizes(torch, MOE_BATCH * MOE_SEQ, d, e,
                                 MOE_LAYER["k"], seed=3)
    bf16 = torch.bfloat16
    gmm = [
        gmm_case(torch, gk, flush, "up", bf16, d, f, routed),
        gmm_case(torch, gk, flush, "down", bf16, f, d, routed),
    ]
    gmm += [gmm_case(torch, gk, flush, f"sweep{gs}", bf16, 24, 40, gs)
            for gs in GMM_SWEEP]
    f16 = torch.float16
    gmm += [
        gmm_case(torch, gk, flush, "up_f16", f16, d, f, routed),
        gmm_case(torch, gk, flush, "down_f16", f16, f, d, routed),
        gmm_case(torch, gk, flush, "sweep_f16", f16, 24, 40, GMM_SWEEP[0]),
        # n = 100 rows: off the 64-row tile
        gmm_case(torch, gk, flush, "ragged_n", bf16, 24, 40, [37, 0, 50, 13]),
        gmm_case(torch, gk, flush, "f32", torch.float32, 24, 40,
                 [5, 0, 11, 16]),
        # f32 takes any k and m
        gmm_case(torch, gk, flush, "f32_odd", torch.float32, 12, 10,
                 [3, 2, 5, 1]),
    ]
    gmm_quant = [
        gmm_case(torch, gk, flush, "up_int8", bf16, d, f, routed, quant=True),
        gmm_case(torch, gk, flush, "down_int8", bf16, f, d, routed,
                 quant=True),
        gmm_case(torch, gk, flush, "up_int8_f16", f16, d, f, routed,
                 quant=True),
        gmm_case(torch, gk, flush, "down_int8_f16", f16, f, d, routed,
                 quant=True),
        gmm_case(torch, gk, flush, "sweep_int8", bf16, 24, 40,
                 [0, 7, 1, 24], quant=True),
        gmm_case(torch, gk, flush, "f32_int8", torch.float32, 24, 40,
                 [5, 0, 11, 16], quant=True),
    ]
    # the JAX sweeps' groups at m 48, the nearest width the int8 wgmma
    # kernel's tensor map takes (m % 16 == 0): both int8 kernels held
    gmm_quant += [gmm_case(torch, gk, flush, f"sweep_int8_m48{gs}", bf16,
                           24, 48, gs, quant=True) for gs in GMM_SWEEP]
    # the fused KV write at the serving decode shape (8 slots) and a
    # 512-token prefill, float (bf16, f16, f32) and int8 pools
    kvw = [kv_write_case(torch, kw, flush, f"{mode}_{pool}", dtype, n,
                         mode == "prefill", pool == "int8")
           for mode, n in (("decode", 8), ("prefill", 512))
           for pool, dtype in (("bf16", torch.bfloat16),
                               ("int8", torch.bfloat16),
                               ("f16", torch.float16),
                               ("f32", torch.float32))]
    kvw.append(kv_write_case(torch, kw, flush, "decode_int8_f16",
                             torch.float16, 8, False, True))
    # the rotating write every serving program makes, at each program's
    # shape and GQA, over bf16, int8, float16 and f32 pools
    rkv = [rope_kv_write_case(torch, kw, flush, f"{shape}_{pool}",
                              getattr(torch, dtype), n, hq, hkv, d, routing,
                              quant)
           for shape, n, hq, hkv, d, routing in ROPE_KV_SHAPES
           for pool, dtype, quant in ROPE_KV_POOLS]
    # the continuation kernel at the serving shape: a 128-token chunk after
    # the 192-token system prefix, from 0, off every page and tile (37,
    # 61), at the end of max_model_len 512 (496, 16); GQA d 64; f32 and
    # float16 q; int8 pages with bf16, float16 and f32 q
    bf16 = torch.bfloat16
    pfx = [paged_prefill_case(torch, pp, fa, flush,
                              f"serving_{c}_{n}", bf16, 16, 16, 128, c, n)
           for c, n in ((192, 128), (0, 128), (37, 61), (496, 16))]
    pfx += [
        paged_prefill_case(torch, pp, fa, flush, "gqa_192_128", bf16, 32, 4,
                           64, 192, 128),
        paged_prefill_case(torch, pp, fa, flush, "f32_37_61",
                           torch.float32, 16, 16, 128, 37, 61),
        paged_prefill_case(torch, pp, fa, flush, "f16_192_128", f16, 16, 16,
                           128, 192, 128),
        paged_prefill_case(torch, pp, fa, flush, "int8_192_128", bf16, 16,
                           16, 128, 192, 128, quant=True),
        paged_prefill_case(torch, pp, fa, flush, "int8_37_61", bf16, 16, 16,
                           128, 37, 61, quant=True),
        paged_prefill_case(torch, pp, fa, flush, "int8_f16_192_128", f16,
                           16, 16, 128, 192, 128, quant=True),
        paged_prefill_case(torch, pp, fa, flush, "int8_f32_37_61",
                           torch.float32, 16, 16, 128, 37, 61, quant=True),
    ]
    # its batched form at the serving cell's verify shape (8 slots, a
    # 5-token window each), the int8 pool, GQA d 64, f32 and float16 q
    pfx_batched = [
        paged_prefill_batched_case(torch, pp, flush, "verify_serving", bf16,
                                   16, 16, 128),
        paged_prefill_batched_case(torch, pp, flush, "verify_int8", bf16,
                                   16, 16, 128, quant=True),
        paged_prefill_batched_case(torch, pp, flush, "verify_gqa", bf16, 32,
                                   4, 64),
        paged_prefill_batched_case(torch, pp, flush, "verify_f32",
                                   torch.float32, 16, 16, 128),
        paged_prefill_batched_case(torch, pp, flush, "verify_f16", f16, 16,
                                   16, 128),
    ]
    # the grouped GEMM's backward at the MoE shapes and its edge cases
    # (routed is the up / down projections' group sizes above): the weight
    # gradient, and dlhs on the transposed instance
    wgrad = wgrad_cases(torch, gk, flush, routed)
    dlhs = dlhs_cases(torch, gk, flush, routed)
    return (paged, flash, bwd, gate_faults(torch, fa), quant, gmm,
            gmm_quant, kvw, rkv, pfx, pfx_batched, wgrad, dlhs,
            tf32_plant_faults(torch, fa, plants),
            bwd_tf32_plant_faults(torch, fa, plants))


# ---------------------------------------------------------------- parity
def phase_parity(torch):
    """Tiny f32 Llama (MHA and GQA), captured engine: greedy outputs equal
    ``generate``'s, with one decode program and at most one prefill
    program per bucket; the same with ``decode_kernel="xla"`` (the plain
    paged attention captured, counted once per layer per decode step).
    Then a seeded sampled request's first token does not depend on the
    engine's history (``SamplingParams(seed=)``: a busy engine and a fresh
    one under another engine seed agree)."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    rng = np.random.default_rng(42)
    lens = [int(n) for n in rng.choice([4, 7, 10, 13], 12)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [20 - n for n in lens]
    geo = dict(max_batch_slots=4, max_model_len=32, page_size=4,
               num_blocks=12, prefill_buckets=[16, 32])
    result = {}
    for kv in (None, 2):
        model = LlamaForCausalLM(
            LlamaConfig.tiny(num_key_value_heads=kv), seed=0
        )
        cfg = model.config
        fwd_design = fa._fwd_variant(
            torch.float32, cfg.hidden_size // cfg.num_attention_heads, 1, 1)
        refs = [model.generate(torch.tensor([p], device="cuda"),
                               max_new_tokens=k)[0, len(p):].tolist()
                for p, k in zip(prompts, max_new)]
        for kernel in ("auto", "xla"):
            engine = Engine(model, EngineConfig(**geo, decode_kernel=kernel))
            _build.reset_launch_counts()
            outs = engine.generate(
                prompts, [SamplingParams(max_new_tokens=k) for k in max_new]
            )
            counts = _build.launch_counts()
            fwd = _build.variant_counts().get(
                f"flash_attention/{fwd_design}", 0)
            m = engine.metrics
            tag = f"parity kv_heads={kv or 4} decode_kernel={kernel}"
            for o, ref in zip(outs, refs):
                check(o.token_ids == ref,
                      f"{tag}: engine {o.token_ids} != generate {ref}")
            check(engine.block_manager.num_used == 0, f"{tag}: block leak")
            L = model.config.num_hidden_layers
            # the f32 prefill's flash forwards, on the design the wrapper
            # names for the tiny model's head dim
            check(fwd == counts["flash_attention"] > 0,
                  f"{tag}: {counts['flash_attention']} flash forwards, "
                  f"{fwd} on {fwd_design}")
            plain = counts["paged_attention_ref"]
            check(m.decode_compiles == 1 and m.prefill_compiles <= 2
                  and (plain, counts["paged_attention"]) == (
                      (m.decode_steps * L, 0) if kernel == "xla"
                      else (0, m.decode_steps * L)),
                  f"{tag}: programs {m.decode_compiles} / "
                  f"{m.prefill_compiles}, launches {counts}")
            log(f"[parity] {tag}: {len(prompts)} requests token-identical "
                f"to generate (preemptions={m.preemptions}, programs "
                f"{m.decode_compiles} decode + {m.prefill_compiles} "
                f"prefill, plain paged launches {plain})")
        result[f"prefix_kv_heads={kv or 4}"] = _prefix_parity(
            torch, model, kv)
        result[f"spec_kv_heads={kv or 4}"] = _spec_parity(torch, model, kv)
    sp = SamplingParams(max_new_tokens=4, do_sample=True, temperature=0.8,
                        seed=123)
    busy = Engine(model, EngineConfig(**geo, seed=0))
    busy.generate(prompts, [SamplingParams(max_new_tokens=5, do_sample=True)
                            for _ in prompts])
    first = [busy.generate([[1, 2, 3]], sp)[0].token_ids[0]]
    fresh = Engine(model, EngineConfig(**geo, seed=9))
    fresh.generate([[7, 8]], SamplingParams(max_new_tokens=2))
    first.append(fresh.generate([[1, 2, 3]], sp)[0].token_ids[0])
    check(first[0] == first[1],
          f"parity: a seeded request's first token follows engine history "
          f"({first})")
    log(f"[parity] seeded sampled first token {first[0]} on a busy and a "
        f"fresh engine")
    result["seeded_first_tokens"] = first
    return result


# the JAX package's prefix_engine fixture (tests/test_serving.py:581)
PREFIX_PARITY_CFG = dict(max_batch_slots=4, max_model_len=32, page_size=4,
                         num_blocks=96, prefill_buckets=[8, 16, 32],
                         enable_prefix_cache=True, prefill_chunk_tokens=8,
                         max_prefill_chunks_per_step=1, seed=3)


def _prefix_parity(torch, model, kv):
    """The JAX prefix-cache acceptance workload on the tiny f32 model,
    captured: 32 requests (prompt + new = 16, 8 up front, the rest
    joining mid-flight) served twice by an engine with the prefix cache
    and 8-token chunks; every greedy output equals ``generate``'s, pass 2
    hits the cache and copies on write, every chunk is one replay
    launching the continuation kernel once per layer."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    rng = np.random.default_rng(42)
    lens = [int(n) for n in rng.choice([4, 7, 10, 13], 32)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [16 - n for n in lens]
    arrivals = sorted([0] * 8 + rng.integers(1, 20, 24).tolist())
    refs = [model.generate(torch.tensor([p], device="cuda"),
                           max_new_tokens=k)[0, len(p):].tolist()
            for p, k in zip(prompts, max_new)]
    engine = Engine(model, EngineConfig(**PREFIX_PARITY_CFG))
    tag = f"parity prefix kv_heads={kv or 4}"
    _build.reset_launch_counts()
    with host_dispatch_probe() as probe:
        for _pass in (1, 2):
            pending = list(zip(prompts, max_new, arrivals))
            submitted, done, step = [], {}, 0
            while pending or engine.has_unfinished():
                while pending and pending[0][2] <= step:
                    p, k, _ = pending.pop(0)
                    submitted.append(engine.add_request(
                        p, SamplingParams(max_new_tokens=k)))
                for o in engine.step():
                    done[o.request_id] = o
                step += 1
                check(step < 500, f"{tag}: engine failed to drain")
            for r, ref in zip(submitted, refs):
                check(done[r.request_id].token_ids == ref,
                      f"{tag} pass {_pass}: engine "
                      f"{done[r.request_id].token_ids} != generate {ref}")
        torch.cuda.synchronize()
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    m = engine.metrics
    L = model.config.num_hidden_layers
    check(m.prefix_hit_tokens > 0 and m.cow_copies >= 1,
          f"{tag}: prefix_hit_tokens {m.prefix_hit_tokens}, cow_copies "
          f"{m.cow_copies}")
    check(m.decode_compiles == 1 and m.prefill_compiles <= 3
          and m.prefill_ext_compiles <= 3 and m.cow_compiles <= 1,
          f"{tag}: programs {m.decode_compiles} decode, "
          f"{m.prefill_compiles} prefill, {m.prefill_ext_compiles} "
          f"prefill_ext, {m.cow_compiles} cow")
    check(counts["paged_prefill"] == m.prefill_chunks * L
          and counts["paged_prefill_ref"] == 0
          and probe["direct"] == 0
          and probe["replays"] == (m.decode_steps + m.prefill_steps
                                   + m.cow_copies),
          f"{tag}: launches {counts}, probe {probe}, chunks "
          f"{m.prefill_chunks}")
    check(engine.block_manager.num_used
          == engine.prefix_cache.reclaimable_blocks(),
          f"{tag}: blocks held after the drain beyond the cache's")
    out = {"requests": 2 * len(prompts),
           "prefix_hit_tokens": m.prefix_hit_tokens,
           "cow_copies": m.cow_copies, "prefill_chunks": m.prefill_chunks,
           "prefill_ext_compiles": m.prefill_ext_compiles,
           "paged_prefill_launches": counts["paged_prefill"]}
    log(f"[parity] {tag}: 2 x {len(prompts)} requests token-identical to "
        f"generate {out}")
    return out


# the JAX package's spec_engine fixture (tests/test_serving.py:834)
SPEC_PARITY_CFG = dict(max_batch_slots=4, max_model_len=32, page_size=4,
                       num_blocks=48, prefill_buckets=[16, 32],
                       speculate_tokens=3, seed=3)


def _spec_parity(torch, model, kv):
    """The JAX speculative-decoding acceptance workload on the tiny f32
    model, captured: the 32-request mix (prompt + new = 16), every fourth
    request sampled, through an engine with ``speculate_tokens=3``; every
    greedy output equals ``generate``'s and the spec-disabled engine's;
    one verify program, drafts proposed; counted from the replays, every
    verify step launches the batched continuation kernel once per layer,
    every step the rotating page write once per layer (``kv_write``
    never); no launch outside a graph."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    rng = np.random.default_rng(42)
    lens = [int(n) for n in rng.choice([4, 7, 10, 13], 32)]
    prompts = [rng.integers(1, 128, n).tolist() for n in lens]
    max_new = [16 - n for n in lens]
    params = [SamplingParams(max_new_tokens=k, do_sample=(i % 4 == 3),
                             temperature=0.8, top_k=20)
              for i, k in enumerate(max_new)]
    tag = f"parity spec kv_heads={kv or 4}"
    plain = Engine(model, EngineConfig(**dict(SPEC_PARITY_CFG,
                                              speculate_tokens=None)))
    plain_out = plain.generate(prompts, params)
    engine = Engine(model, EngineConfig(**SPEC_PARITY_CFG))
    _build.reset_launch_counts()
    with host_dispatch_probe() as probe:
        outs = engine.generate(prompts, params)
        torch.cuda.synchronize()
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    m = engine.metrics
    L = model.config.num_hidden_layers
    greedy = 0
    for o, p, k, sp, po in zip(outs, prompts, max_new, params, plain_out):
        check(len(o.token_ids) == k, f"{tag}: {len(o.token_ids)} of {k} "
                                     f"tokens")
        if sp.do_sample:
            continue
        greedy += 1
        ref = model.generate(torch.tensor([p], device="cuda"),
                             max_new_tokens=k)[0, len(p):].tolist()
        check(o.token_ids == ref == po.token_ids,
              f"{tag}: engine {o.token_ids}, generate {ref}, spec-disabled "
              f"engine {po.token_ids}")
    check(m.verify_compiles == 1 and m.spec_proposed > 0
          and m.verify_steps > 0,
          f"{tag}: {m.verify_compiles} verify programs, {m.spec_proposed} "
          f"drafts, {m.verify_steps} verify steps")
    steps = m.decode_steps + m.prefill_steps + m.verify_steps
    check(counts["paged_prefill"] == m.verify_steps * L
          and counts["rope_kv_write"] == steps * L
          and counts["kv_write"] == 0
          and counts["paged_prefill_ref"] == 0
          and probe["direct"] == 0 and probe["replays"] == steps,
          f"{tag}: launches {counts}, probe {probe}, verify steps "
          f"{m.verify_steps}")
    check(engine.block_manager.num_used == 0, f"{tag}: block leak")
    out = {"greedy_requests": greedy, "verify_steps": m.verify_steps,
           "decode_steps": m.decode_steps,
           "spec_proposed": m.spec_proposed,
           "spec_accepted": m.spec_accepted,
           "paged_prefill_launches": counts["paged_prefill"]}
    log(f"[parity] {tag}: {greedy} greedy requests token-identical to "
        f"generate and the spec-disabled engine {out}")
    return out


# --------------------------------------------------------------- serving
SERVING_CFG = dict(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=12, num_attention_heads=16,
    max_position_embeddings=2048, dtype="bfloat16",
)


def _pool_copy(entries):
    """Clones of a pool's per-layer entries (tensors or int8 pairs)."""
    return [tuple(t.clone() for t in e) if isinstance(e, tuple)
            else e.clone() for e in entries]


def _eager_programs(engine):
    """Make every program ``engine`` builds run its function eagerly over
    the same static buffers instead of replaying its graph (still built
    and captured): private to this script, the measure of what capture
    changes."""
    build = engine._program

    def eager(fn, generator):
        prog = build(fn, generator)
        prog._run = prog.fn
        return prog

    engine._program = eager
    return engine


@contextlib.contextmanager
def host_dispatch_probe():
    """Counts, while inside, the kernel launches made by a wrapper outside
    any program's build (its warm-up and capture: ``record_launches``),
    and the graph replays. In a captured engine every launch comes from a
    replay, so ``direct`` stays 0."""
    from paddle_tpu_torch.kernels import _build

    state = {"depth": 0, "direct": 0, "replays": 0}
    count, record, replay = (_build.count_launch, _build.record_launches,
                             _build.count_replay)

    def counted(name, *variants):
        if state["depth"] == 0:
            state["direct"] += 1
        count(name, *variants)

    def recorded(fn):
        state["depth"] += 1
        try:
            return record(fn)
        finally:
            state["depth"] -= 1

    def replayed(launches):
        # every replay counts its capture's launches, programs built
        # before the probe too
        state["replays"] += 1
        return replay(launches)

    _build.count_launch, _build.record_launches = counted, recorded
    _build.count_replay = replayed
    try:
        yield state
    finally:
        _build.count_launch, _build.record_launches = count, record
        _build.count_replay = replay


def _first_decode(torch, model, ecfg, prompts, compare_plain):
    """Run a warm-up engine over the first 8 ``prompts`` (4 greedy tokens
    each) and return its first decode step's logits (f32, active slots),
    read from the captured decode program's output after its first
    replay. With ``compare_plain`` the same step is also run eagerly with
    the plain attention function (the adapter's ``decode_kernel="xla"``)
    on copies of the pool taken just before the replay, over the
    program's own staged inputs, and the two are compared. The engine
    must build one decode program, and its greedy tokens must equal those
    of a twin engine whose programs run their functions eagerly."""
    from paddle_tpu_torch.serving import Engine, SamplingParams

    warm = Engine(model, ecfg)
    got = {}
    real_launch = warm._launch_decode

    def launch_and_compare(idxs):
        if got:
            return real_launch(idxs)
        kp, vp = _pool_copy(warm.pool.k), _pool_copy(warm.pool.v)
        nxt = real_launch(idxs)
        f = warm._decode_buffers.dev
        active = f["active"] != 0
        out = warm._decode_programs[False].out[1].float()
        got["logits"] = out[active]
        got["finite"] = bool(torch.isfinite(out[active]).all())
        if compare_plain:
            warm.adapter.decode_kernel = "xla"
            try:
                plain = warm.adapter.decode(
                    kp, vp, f["tokens"], f["positions"],
                    f["tables"].view(ecfg.max_batch_slots, -1),
                    active).float()
            finally:
                warm.adapter.decode_kernel = ecfg.decode_kernel
            got["max_abs_err"] = (out - plain)[active].abs().max().item()
            got["logit_absmax"] = plain[active].abs().max().item()
        return nxt

    warm._launch_decode = launch_and_compare
    sp = SamplingParams(max_new_tokens=4)
    captured = [o.token_ids for o in warm.generate(prompts[:8], sp)]
    eager = [o.token_ids for o in _eager_programs(
        Engine(model, ecfg)).generate(prompts[:8], sp)]
    torch.cuda.synchronize()
    check(warm.metrics.decode_compiles == 1,
          f"warm-up: {warm.metrics.decode_compiles} decode programs for an "
          f"all-greedy run")
    check(captured == eager,
          f"warm-up: captured greedy tokens {captured} differ from the "
          f"eager program functions' {eager}")
    bytes_per_token = warm.pool.bytes_per_token()
    del warm
    check(got.get("finite"), "serving: non-finite decode logits")
    return got, bytes_per_token


def _serving_gates(tag, counts, m, probe, L, paged, kv_variant, flash,
                   buckets, decode_programs):
    """The serving phases' launch and program gates, the counts
    replay-accounted: every decode step L paged launches on the cluster
    kernel, every one-shot prefill L flash launches (``flash``), every
    continuation chunk and every verify step L ``paged_prefill``
    launches, all on its split design, and every step L rope_kv_write
    launches on the pool's variant (``kv_write`` none: the programs
    rotate and write in one launch); no wrapper launched
    outside a program's capture, one replay per step and per
    copy-on-write; ``decode_programs`` decode programs and at most one
    prefill program (and one continuation program) per bucket, at most
    one copy-on-write program and one verify program."""
    other = ("paged_attention" if paged == "paged_attention_quant"
             else "paged_attention_quant")
    check(counts[paged] == m.decode_steps * L and counts[other] == 0,
          f"{tag}: {paged} launches {counts[paged]} != decode_steps "
          f"{m.decode_steps} x {L}, or {other} launched {counts[other]}")
    check(counts.get(f"{paged}/cluster", 0) == counts[paged]
          and counts.get(f"{paged}/split", 0) == 0,
          f"{tag}: paged launches by kernel {counts}")
    one_shot = m.prefill_steps - m.prefill_chunks
    want_flash = one_shot * L if flash else 0
    check(counts["flash_attention"] == want_flash,
          f"{tag}: flash launches {counts['flash_attention']} != "
          f"{want_flash} ({one_shot} one-shot prefills)")
    ext = "int8" if kv_variant == "int8" else "float"
    check(counts["paged_prefill"] == (m.prefill_chunks + m.verify_steps) * L
          and counts.get(f"paged_prefill/{ext}", 0) == counts["paged_prefill"]
          and counts.get("paged_prefill/split", 0) == counts["paged_prefill"]
          and counts["paged_prefill_ref"] == 0,
          f"{tag}: paged_prefill launches {counts['paged_prefill']} != "
          f"(chunks {m.prefill_chunks} + verify steps {m.verify_steps}) x "
          f"{L} on the {ext} kernel's split design ({counts})")
    steps = m.decode_steps + m.prefill_steps + m.verify_steps
    check(counts["rope_kv_write"] == steps * L
          and counts.get(f"rope_kv_write/{kv_variant}", 0) == steps * L
          and counts["kv_write"] == 0,
          f"{tag}: rope_kv_write launches {counts['rope_kv_write']} != "
          f"(decode {m.decode_steps} + prefill {m.prefill_steps} + verify "
          f"{m.verify_steps}) x {L} on the {kv_variant} kernel, or "
          f"kv_write launched {counts['kv_write']}")
    check(counts["paged_attention_ref"] == 0,
          f"{tag}: the plain paged attention ran {counts}")
    check(probe["direct"] == 0
          and probe["replays"] == steps + m.cow_copies,
          f"{tag}: {probe['direct']} launches outside a graph, "
          f"{probe['replays']} replays for {steps} steps and "
          f"{m.cow_copies} copies")
    check(m.decode_compiles == decode_programs
          and m.prefill_compiles <= len(buckets)
          and m.prefill_ext_compiles <= len(buckets)
          and (m.prefill_compiles or m.prefill_ext_compiles)
          and m.cow_compiles <= 1 and m.verify_compiles <= 1,
          f"{tag}: {m.decode_compiles} decode programs (want "
          f"{decode_programs}), {m.prefill_compiles} prefill and "
          f"{m.prefill_ext_compiles} continuation programs for "
          f"{len(buckets)} buckets, {m.cow_compiles} copy programs, "
          f"{m.verify_compiles} verify programs")


def _serve(torch, tag, kv_cache_dtype=None):
    """The full-width bf16 Llama serving 32 requests through
    ``Engine.generate`` with ``kv_cache_dtype``; checks and returns the
    run's counters. The int8 run also measures its first decode step's
    logit gap to the float pool and its bytes per token against it."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    cfg = LlamaConfig(**SERVING_CFG)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"[{tag}] model: {model.num_params() / 1e6:.1f}M params bf16, "
        f"built in {time.perf_counter() - t0:.1f}s")
    n_req, slots, mml = 32, 8, 512
    ecfg = EngineConfig(max_batch_slots=slots, max_model_len=mml,
                        page_size=16, kv_cache_dtype=kv_cache_dtype)
    rng = np.random.RandomState(0)
    prompts = [
        rng.randint(1, cfg.vocab_size, rng.randint(8, mml // 4)).tolist()
        for _ in range(n_req)
    ]
    max_new = [int(rng.randint(mml // 8, mml // 2)) for _ in range(n_req)]
    params = [
        SamplingParams(max_new_tokens=k, do_sample=True, temperature=0.8,
                       top_k=50, top_p=0.95) if i % 4 == 3
        else SamplingParams(max_new_tokens=k)
        for i, k in enumerate(max_new)
    ]

    # warm-up engine: the first 8 prompts, 4 tokens each; its first
    # decode step against the same step with the plain attention function
    compared, bytes_per_token = _first_decode(torch, model, ecfg, prompts,
                                              True)
    check(compared["max_abs_err"] <= LOGITS_TOL,
          f"{tag}: first decode logits differ from the plain attention "
          f"path by {compared['max_abs_err']} > {LOGITS_TOL}")
    log(f"[{tag}] first decode step, kernel vs plain attention: "
        f"max_abs_err {compared['max_abs_err']:.5f} (tolerance "
        f"{LOGITS_TOL}, |logits| max {compared['logit_absmax']:.3f})")
    extra = {}
    if kv_cache_dtype is not None:
        # the same first step over a float (bf16) pool: the prefill
        # attends over the in-flight float K/V either way, so the step's
        # tokens and positions are the same
        flt, flt_bytes = _first_decode(
            torch, model, EngineConfig(max_batch_slots=slots,
                                       max_model_len=mml, page_size=16),
            prompts, False)
        gap = (compared["logits"] - flt["logits"]).abs().max().item()
        extra = {"float_pool_logit_gap": gap,
                 "bytes_per_token": bytes_per_token,
                 "float_pool_bytes_per_token": flt_bytes,
                 "bytes_ratio": bytes_per_token / flt_bytes}
        log(f"[{tag}] first decode step, {kv_cache_dtype} pool vs bf16 "
            f"pool: max abs logit gap {gap:.5f}; bytes per token "
            f"{bytes_per_token:.0f} vs {flt_bytes:.0f} "
            f"({bytes_per_token / flt_bytes:.4f})")
    compared = {k: v for k, v in compared.items() if k != "logits"}

    engine = Engine(model, ecfg)
    # the decode program each step asks for: greedy-only or mixed
    kinds, program = set(), engine._decode_program
    engine._decode_program = lambda any_sample: (
        kinds.add(any_sample), program(any_sample))[1]
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    with host_dispatch_probe() as probe:
        t0 = time.perf_counter()
        outs = engine.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    m = engine.metrics
    check(len(outs) == n_req and all(
        o.finish_reason in ("length", "stop") for o in outs),
        f"{tag}: not every request finished")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o.token_ids),
          f"{tag}: token id out of range")
    check(engine.block_manager.num_used == 0,
          f"{tag}: {engine.block_manager.num_used} KV blocks leaked")
    L = cfg.num_hidden_layers
    paged = "paged_attention_quant" if kv_cache_dtype else "paged_attention"
    # one decode program per kind the steps asked for (a step with a
    # sampled request running takes the mixed one), never more than two
    check(kinds and kinds <= {False, True}, f"{tag}: decode kinds {kinds}")
    _serving_gates(tag, counts, m, probe, L, paged,
                   "int8" if kv_cache_dtype else "float", True,
                   ecfg.prefill_buckets, len(kinds))
    n_tokens = sum(len(o.token_ids) for o in outs)
    ttft = float(np.mean([o.time_to_first_token for o in outs]))
    result = {
        "requests": n_req, "generated_tokens": n_tokens, "seconds": dt,
        "tokens_per_s": n_tokens / dt, "mean_ttft_s": ttft,
        "decode_steps": m.decode_steps, "prefill_steps": m.prefill_steps,
        "decode_compiles": m.decode_compiles,
        "prefill_compiles": m.prefill_compiles,
        "graph_replays": probe["replays"], "preemptions": m.preemptions,
        "decode_kinds": sorted("mixed" if k else "greedy" for k in kinds),
        "pool_high_water": engine.block_manager.high_water,
        "sampled_requests": sum(p.do_sample for p in params),
        "launches": counts, "first_decode_compare": compared, **extra,
    }
    log(f"[{tag}] {n_req} requests x {slots} slots mml={mml}: "
        f"{n_tokens} tokens in {dt:.3f}s -> {n_tokens / dt:.1f} tokens/s, "
        f"mean TTFT {ttft * 1e3:.1f} ms, decode steps {m.decode_steps}, "
        f"prefill steps {m.prefill_steps}, preemptions {m.preemptions}, "
        f"programs {m.decode_compiles} decode ("
        f"{'/'.join(sorted('mixed' if k else 'greedy' for k in kinds))}) + "
        f"{m.prefill_compiles} prefill, {probe['replays']} graph replays, "
        f"no launch outside them")
    log(f"[{tag}] launches {counts}")
    return result


def phase_serving(torch):
    return _serve(torch, "serving")


def phase_serving_int8(torch):
    return _serve(torch, "serving_int8", kv_cache_dtype="int8")


def phase_serving_f16(torch):
    """The serving model in float16, with the float16 pool and the int8
    pool: a few requests through ``Engine.generate``. All finish, no block
    leaks, every decode step runs the (float16-q) paged kernel once per
    layer on the cluster kernel, and the first decode step's logits are
    within ``LOGITS_TOL`` of plain attention. Every one-shot prefill
    runs the float16 flash forward once per layer (PR 15: before it,
    float16 prefill took the math attention)."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**dict(SERVING_CFG, dtype="float16"))
    model = LlamaForCausalLM(cfg, seed=0)
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab_size, rng.randint(8, 100)).tolist()
               for _ in range(8)]
    result = {"launches": {}}
    for pool in (None, "int8"):
        tag = f"serving_f16{'_int8' if pool else ''}"
        ecfg = EngineConfig(max_batch_slots=8, max_model_len=512,
                            page_size=16, kv_cache_dtype=pool)
        compared, _ = _first_decode(torch, model, ecfg, prompts, True)
        check(compared["max_abs_err"] <= LOGITS_TOL,
              f"{tag}: first decode logits differ from the plain attention "
              f"path by {compared['max_abs_err']} > {LOGITS_TOL}")
        engine = Engine(model, ecfg)
        _build.reset_launch_counts()
        with host_dispatch_probe() as probe:
            outs = engine.generate(prompts,
                                   SamplingParams(max_new_tokens=24))
            torch.cuda.synchronize()
        counts = dict(_build.launch_counts(), **_build.variant_counts())
        m = engine.metrics
        name = "paged_attention_quant" if pool else "paged_attention"
        check(len(outs) == len(prompts) and all(
            o.finish_reason in ("length", "stop") for o in outs)
            and engine.block_manager.num_used == 0,
            f"{tag}: not every request finished, or blocks leaked")
        _serving_gates(tag, counts, m, probe, L, name,
                       "int8" if pool else "float", True,
                       ecfg.prefill_buckets, 1)
        check(counts.get("flash_attention/float16", 0)
              == counts["flash_attention"] > 0,
              f"{tag}: flash launches by dtype {counts}: want every one "
              f"on the float16 instance")
        for key, n in counts.items():
            result["launches"][key] = result["launches"].get(key, 0) + n
        compared = {k: v for k, v in compared.items() if k != "logits"}
        result[tag] = {"decode_steps": m.decode_steps,
                       "prefill_steps": m.prefill_steps,
                       "decode_compiles": m.decode_compiles,
                       "prefill_compiles": m.prefill_compiles,
                       "graph_replays": probe["replays"],
                       "generated_tokens": sum(len(o.token_ids)
                                               for o in outs),
                       "first_decode_compare": compared}
        log(f"[{tag}] {len(prompts)} requests: {m.decode_steps} decode "
            f"steps, {counts[name]} {name} launches (cluster); first decode "
            f"step vs plain attention max_abs_err "
            f"{compared['max_abs_err']:.5f}")
        del engine
    del model
    torch.cuda.empty_cache()
    return result


# the serving_prefix cell: a shared system prompt, chunked prefill
PREFIX_SYSTEM_TOKENS = 192
PREFIX_CHUNK = 128


def _first_continuation(torch, model, ecfg, prompts):
    """A warm-up engine over the first 8 ``prompts`` (4 tokens each): its
    first continuation launch after cached tokens (cache_len > 0), the
    replay's logits against the same program function run eagerly with
    the plain continuation attention (the adapter's ``decode_kernel=
    "xla"``: ``paged_prefill_ref``) on copies of the pool taken just
    before the replay, over the program's own staged inputs."""
    from paddle_tpu_torch.serving import Engine, SamplingParams
    from paddle_tpu_torch.jit.bucketing import next_bucket

    warm = Engine(model, ecfg)
    got = {}
    real = warm._prefill_chunk

    def chunk_and_compare(req, chunk, final):
        if got or req.num_cached == 0:
            return real(req, chunk, final)
        cache_len = req.num_cached
        kp, vp = _pool_copy(warm.pool.k), _pool_copy(warm.pool.v)
        real(req, chunk, final)
        bucket = next_bucket(len(chunk), ecfg.prefill_buckets)
        f = warm._prefill_ext_buffers.dev
        out = warm._prefill_ext_programs[bucket].out[1].float()
        warm.adapter.decode_kernel = "xla"
        try:
            plain = warm.adapter.prefill_ext(
                kp, vp, f["ids"][:bucket], f["length"][0],
                f["cache_len"][0], f["table"]).float()
        finally:
            warm.adapter.decode_kernel = ecfg.decode_kernel
        got.update(cache_len=cache_len, chunk=len(chunk),
                   finite=bool(torch.isfinite(out).all()),
                   max_abs_err=(out - plain).abs().max().item(),
                   logit_absmax=plain.abs().max().item())

    warm._prefill_chunk = chunk_and_compare
    warm.generate(prompts[:8], SamplingParams(max_new_tokens=4))
    torch.cuda.synchronize()
    check(got.get("finite"), "serving_prefix: no continuation compared, or "
                             "non-finite continuation logits")
    del warm
    return got


def _serve_prefix(torch, model, kv_cache_dtype):
    """The full-width model behind the prefix cache and 128-token chunks:
    32 requests sharing a 192-token system prompt, served twice."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    tag = "serving_prefix" + ("_int8" if kv_cache_dtype else "")
    cfg = model.config
    n_req = 32
    ecfg = EngineConfig(max_batch_slots=8, max_model_len=512, page_size=16,
                        kv_cache_dtype=kv_cache_dtype,
                        enable_prefix_cache=True,
                        prefill_chunk_tokens=PREFIX_CHUNK,
                        max_prefill_chunks_per_step=1)
    rng = np.random.RandomState(0)
    system = rng.randint(1, cfg.vocab_size, PREFIX_SYSTEM_TOKENS).tolist()
    tails = [int(rng.randint(8, 128)) for _ in range(n_req)]
    for i in range(0, n_req, 8):
        # a prompt of whole pages: pass 2 matches all of it but the last
        # token, which cuts into the last cached page (copy-on-write)
        tails[i] = 16 * int(rng.randint(1, 8))
    prompts = [system + rng.randint(1, cfg.vocab_size, n).tolist()
               for n in tails]
    max_new = [int(rng.randint(32, 97)) for _ in range(n_req)]
    params = [
        SamplingParams(max_new_tokens=k, do_sample=True, temperature=0.8,
                       top_k=50, top_p=0.95) if i % 4 == 3
        else SamplingParams(max_new_tokens=k)
        for i, k in enumerate(max_new)
    ]
    whole_pages = sum(len(p) % 16 == 0 for p in prompts)
    check(whole_pages >= 4, f"{tag}: {whole_pages} prompts of whole pages")
    compared = _first_continuation(torch, model, ecfg, prompts)
    check(compared["max_abs_err"] <= LOGITS_TOL,
          f"{tag}: first continuation's logits differ from the plain "
          f"attention path by {compared['max_abs_err']} > {LOGITS_TOL}")
    log(f"[{tag}] first continuation (cache_len {compared['cache_len']}, "
        f"{compared['chunk']} tokens), replay vs plain attention: "
        f"max_abs_err {compared['max_abs_err']:.5f} (tolerance "
        f"{LOGITS_TOL}, |logits| max {compared['logit_absmax']:.3f})")

    engine = Engine(model, ecfg)
    kinds, program = set(), engine._decode_program
    engine._decode_program = lambda any_sample: (
        kinds.add(any_sample), program(any_sample))[1]
    m = engine.metrics
    fields = ("prefill_tokens", "prefix_hit_tokens", "prefix_hits",
              "cow_copies", "prefill_chunks", "prefill_steps",
              "decode_steps", "preemptions", "prefix_evictions")
    total_prompt = sum(len(p) for p in prompts)
    passes, tokens = [], []
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    with host_dispatch_probe() as probe:
        for n_pass in (1, 2):
            before = {f: getattr(m, f) for f in fields}
            t0 = time.perf_counter()
            outs = engine.generate(prompts, params)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(len(outs) == n_req and all(
                o.finish_reason in ("length", "stop") for o in outs),
                f"{tag} pass {n_pass}: not every request finished")
            check(all(0 <= t < cfg.vocab_size for o in outs
                      for t in o.token_ids),
                  f"{tag} pass {n_pass}: token id out of range")
            n_tokens = sum(len(o.token_ids) for o in outs)
            tokens.append([o.token_ids for o in outs])
            passes.append(dict(
                {f: getattr(m, f) - before[f] for f in fields},
                seconds=dt, generated_tokens=n_tokens,
                tokens_per_s=n_tokens / dt,
                mean_ttft_s=float(np.mean([o.time_to_first_token
                                           for o in outs]))))
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    p2 = passes[1]
    shared = n_req * PREFIX_SYSTEM_TOKENS
    check(p2["prefix_hit_tokens"] >= shared
          and p2["prefill_tokens"] <= total_prompt - shared,
          f"{tag}: pass 2 hit {p2['prefix_hit_tokens']} tokens (want >= "
          f"{shared}) and computed {p2['prefill_tokens']} of "
          f"{total_prompt} prompt tokens")
    check(m.cow_copies >= 4, f"{tag}: {m.cow_copies} copy-on-writes")
    check(engine.block_manager.num_used
          == engine.prefix_cache.reclaimable_blocks(),
          f"{tag}: blocks held after the drain beyond the cache's")
    L = cfg.num_hidden_layers
    paged = "paged_attention_quant" if kv_cache_dtype else "paged_attention"
    check(kinds and kinds <= {False, True}, f"{tag}: decode kinds {kinds}")
    _serving_gates(tag, counts, m, probe, L, paged,
                   "int8" if kv_cache_dtype else "float", True,
                   ecfg.prefill_buckets, len(kinds))
    same = sum(a == b for a, b, sp in zip(tokens[0], tokens[1], params)
               if not sp.do_sample)
    result = {
        "requests_per_pass": n_req, "system_tokens": PREFIX_SYSTEM_TOKENS,
        "prompt_tokens_per_pass": total_prompt, "passes": passes,
        "greedy_same_both_passes": same,
        "greedy_requests": sum(not sp.do_sample for sp in params),
        "prefill_compiles": m.prefill_compiles,
        "prefill_ext_compiles": m.prefill_ext_compiles,
        "cow_compiles": m.cow_compiles, "decode_compiles": m.decode_compiles,
        "graph_replays": probe["replays"], "launches": counts,
        "first_continuation_compare": compared,
        "pool_high_water": engine.block_manager.high_water,
        "prefix_cache_blocks": len(engine.prefix_cache),
    }
    for i, p in enumerate(passes, 1):
        log(f"[{tag}] pass {i}: {p['generated_tokens']} tokens in "
            f"{p['seconds']:.3f}s -> {p['tokens_per_s']:.1f} tokens/s, mean "
            f"TTFT {p['mean_ttft_s'] * 1e3:.1f} ms, computed prefill tokens "
            f"{p['prefill_tokens']} of {total_prompt}, prefix hits "
            f"{p['prefix_hits']} ({p['prefix_hit_tokens']} tokens), "
            f"{p['prefill_chunks']} chunks, {p['cow_copies']} copy-on-writes, "
            f"{p['preemptions']} preemptions")
    log(f"[{tag}] programs {m.decode_compiles} decode + "
        f"{m.prefill_compiles} prefill + {m.prefill_ext_compiles} "
        f"continuation + {m.cow_compiles} copy; {probe['replays']} graph "
        f"replays, no launch outside them; greedy outputs equal in both "
        f"passes: {same} of {result['greedy_requests']}")
    log(f"[{tag}] launches {counts}")
    del engine
    return result


def phase_serving_prefix(torch):
    """``serving_prefix``: the full-width bf16 serving model behind the
    prefix cache and chunked prefill (8 slots, max_model_len 512, page
    16, 128-token chunks, one chunk a step), over the bf16 and the int8
    pool. 32 requests share a 192-token system prompt and add 8-127
    tokens of their own (at least 4 prompts of whole pages), 32-96 new
    tokens, every fourth sampled; the mix is served twice."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    gc.collect()
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(LlamaConfig(**SERVING_CFG), seed=0)
    result = {"launches": {}}
    for pool in (None, "int8"):
        r = _serve_prefix(torch, model, pool)
        for key, n in r["launches"].items():
            result["launches"][key] = result["launches"].get(key, 0) + n
        result["int8" if pool else "bf16"] = r
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return result


# the serving_spec cell: bench.py's speculative workload (:706-760) at its
# TPU geometry, K = 4
SPEC_K = 4
SPEC_PROMPT_COPIES = 12
SPEC_WARM_TOKENS = 32
SPEC_RUNS = 3


def _first_verify(torch, model, ecfg, prompts):
    """A warm-up engine over ``prompts`` (``SPEC_WARM_TOKENS`` greedy
    tokens each): its first verify launch, the replay's logits against
    the same program function run eagerly with the plain window attention
    (the adapter's ``decode_kernel="xla"``: the batched
    ``paged_prefill_ref``) on copies of the pool taken just before the
    replay, over the program's own staged inputs; compared on the active
    slots' valid rows (the pending token and its draft)."""
    from paddle_tpu_torch.serving import Engine, SamplingParams

    warm = Engine(model, ecfg)
    got = {}
    real = warm._launch_verify

    def verify_and_compare(idxs, drafts):
        if got:
            return real(idxs, drafts)
        kp, vp = _pool_copy(warm.pool.k), _pool_copy(warm.pool.v)
        tgt = real(idxs, drafts)
        f = warm._verify_buffers.dev
        n = ecfg.max_batch_slots
        out = warm._verify_prog.out[1].float()
        warm.adapter.decode_kernel = "xla"
        try:
            plain = warm.adapter.verify(
                kp, vp, f["tokens"].view(n, -1), f["positions"],
                f["draft_lens"], f["tables"].view(n, -1),
                f["active"] != 0).float()
        finally:
            warm.adapter.decode_kernel = ecfg.decode_kernel
        rows = ((torch.arange(out.shape[1], device=out.device)[None]
                 <= f["draft_lens"][:, None]) & (f["active"] != 0)[:, None])
        got.update(active=len(idxs),
                   drafted=sum(bool(d) for d in drafts.values()),
                   rows=int(rows.sum()),
                   finite=bool(torch.isfinite(out[rows]).all()),
                   max_abs_err=(out - plain)[rows].abs().max().item(),
                   logit_absmax=plain[rows].abs().max().item())
        return tgt

    warm._launch_verify = verify_and_compare
    warm.generate(prompts, SamplingParams(max_new_tokens=SPEC_WARM_TOKENS))
    torch.cuda.synchronize()
    check(got.get("finite"), "serving_spec: no verify launch compared, or "
                             "non-finite verify logits")
    del warm
    return got


def _timed_launches(engine, name, times):
    """Wrap ``engine.<name>`` to append each call's host wall seconds (the
    call ends in its read-back, so the replay has finished)."""
    real = getattr(engine, name)

    def timed(*args):
        t0 = time.perf_counter()
        out = real(*args)
        times.append(time.perf_counter() - t0)
        return out

    setattr(engine, name, timed)


def _serve_spec(torch, model, kv_cache_dtype):
    """bench.py's speculative workload on the full-width model with
    ``kv_cache_dtype``: a speculative engine and a spec-disabled one of
    the same config, each warmed with the same prompts and then timed
    over the whole workload ``SPEC_RUNS`` times, the fastest run kept."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    tag = "serving_spec" + ("_int8" if kv_cache_dtype else "")
    cfg = model.config
    slots, mml = 8, 512
    rng = np.random.RandomState(3)
    prompts = [[int(t)] * SPEC_PROMPT_COPIES
               for t in rng.randint(1, cfg.vocab_size, slots)]
    params = SamplingParams(max_new_tokens=mml - 16)
    base_kw = dict(max_batch_slots=slots, max_model_len=mml, page_size=16,
                   kv_cache_dtype=kv_cache_dtype)
    spec_cfg = EngineConfig(**base_kw, speculate_tokens=SPEC_K)
    compared = _first_verify(torch, model, spec_cfg, prompts)
    check(compared["max_abs_err"] <= LOGITS_TOL,
          f"{tag}: first verify logits differ from the plain window "
          f"attention by {compared['max_abs_err']} > {LOGITS_TOL}")
    log(f"[{tag}] first verify launch ({compared['active']} slots, "
        f"{compared['drafted']} with drafts, {compared['rows']} rows), "
        f"replay vs plain attention: max_abs_err "
        f"{compared['max_abs_err']:.5f} (tolerance {LOGITS_TOL}, |logits| "
        f"max {compared['logit_absmax']:.3f})")
    L = cfg.num_hidden_layers
    paged = "paged_attention_quant" if kv_cache_dtype else "paged_attention"
    runs, tokens = {}, {}
    for kind, ecfg in (("base", EngineConfig(**base_kw)), ("spec", spec_cfg)):
        engine = Engine(model, ecfg)
        kinds, program = set(), engine._decode_program
        engine._decode_program = lambda any_sample: (
            kinds.add(any_sample), program(any_sample))[1]
        verify_s, decode_s = [], []
        _timed_launches(engine, "_launch_decode", decode_s)
        if kind == "spec":
            _timed_launches(engine, "_launch_verify", verify_s)
        m = engine.metrics
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        fields = ("verify_steps", "decode_steps", "spec_proposed",
                  "spec_accepted")
        timed = []
        with host_dispatch_probe() as probe:
            # warm-up: builds every program the timed runs replay
            engine.generate(prompts, SamplingParams(
                max_new_tokens=SPEC_WARM_TOKENS))
            # the workload SPEC_RUNS times, the fastest kept (bench.py's
            # best of 3): the host's share of a step varies from run to run
            for _ in range(SPEC_RUNS):
                before = {f: getattr(m, f) for f in fields}
                del verify_s[:], decode_s[:]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = engine.generate(prompts, params)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                timed.append((dt, outs, list(verify_s), list(decode_s),
                              {f: getattr(m, f) - before[f] for f in fields}))
        counts = dict(_build.launch_counts(), **_build.variant_counts())
        check(all([o.token_ids for o in t[1]] == [o.token_ids for o in outs]
                  for t in timed),
              f"{tag} {kind}: the timed runs' greedy tokens differ")
        dt, outs, verify_s, decode_s, d = min(timed, key=lambda t: t[0])
        check(len(outs) == slots and all(
            o.finish_reason in ("length", "stop") for o in outs),
            f"{tag} {kind}: not every request finished")
        check(all(0 <= t < cfg.vocab_size for o in outs for t in o.token_ids),
              f"{tag} {kind}: token id out of range")
        check(engine.block_manager.num_used == 0,
              f"{tag} {kind}: {engine.block_manager.num_used} KV blocks "
              f"leaked")
        check(kinds <= {False}, f"{tag} {kind}: decode kinds {kinds}")
        _serving_gates(f"{tag} {kind}", counts, m, probe, L, paged,
                       "int8" if kv_cache_dtype else "float", True,
                       ecfg.prefill_buckets, 1 if m.decode_steps else 0)
        if kind == "spec":
            check(m.verify_compiles == 1 and m.verify_steps > 0,
                  f"{tag}: {m.verify_compiles} verify programs, "
                  f"{m.verify_steps} verify steps")
        n_tokens = sum(len(o.token_ids) for o in outs)
        tokens[kind] = [o.token_ids for o in outs]
        runs[kind] = dict(
            d, seconds=dt, generated_tokens=n_tokens,
            tokens_per_s=n_tokens / dt,
            tokens_per_s_runs=[n_tokens / t[0] for t in timed],
            accept_rate=(d["spec_accepted"] / d["spec_proposed"]
                         if d["spec_proposed"] else None),
            tokens_per_verify_launch=(n_tokens / d["verify_steps"]
                                      if d["verify_steps"] else None),
            verify_replay_ms=(float(np.mean(verify_s)) * 1e3
                              if verify_s else None),
            decode_replay_ms=(float(np.mean(decode_s)) * 1e3
                              if decode_s else None),
            # the run's host wall outside its verify and decode launches:
            # drafting, the accept loop, scheduling and the 8 prefills
            outside_launches_s=dt - sum(verify_s) - sum(decode_s),
            verify_compiles=m.verify_compiles,
            decode_compiles=m.decode_compiles,
            graph_replays=probe["replays"], launches=counts)
        log(f"[{tag}] {kind}: {n_tokens} tokens in {dt:.3f}s -> "
            f"{n_tokens / dt:.1f} tokens/s (best of "
            f"{[round(x, 1) for x in runs[kind]['tokens_per_s_runs']]}); "
            f"verify steps "
            f"{d['verify_steps']}, decode steps {d['decode_steps']}, "
            f"proposed {d['spec_proposed']}, accepted {d['spec_accepted']}; "
            f"verify replay {runs[kind]['verify_replay_ms']} ms, decode "
            f"replay {runs[kind]['decode_replay_ms']} ms (host wall, "
            f"read-back included); {runs[kind]['outside_launches_s']:.3f}s "
            f"outside those launches")
        log(f"[{tag}] {kind} launches {counts}")
        del engine
    # greedy bf16 agrees to a tolerance, not to the bit: where each
    # request's spec and base tokens first differ (None: nowhere)
    diverge = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                    None) for x, y in zip(tokens["spec"], tokens["base"])]
    spec, base = runs["spec"], runs["base"]
    result = {"slots": slots, "max_model_len": mml, "k": SPEC_K,
              "new_tokens_per_request": params.max_new_tokens,
              "spec": spec, "base": base,
              "speedup": spec["tokens_per_s"] / base["tokens_per_s"],
              "first_divergence": diverge,
              "first_verify_compare": compared,
              "launches": {k: spec["launches"].get(k, 0)
                           + base["launches"].get(k, 0)
                           for k in set(spec["launches"])
                           | set(base["launches"])}}
    log(f"[{tag}] spec {spec['tokens_per_s']:.1f} tokens/s against base "
        f"{base['tokens_per_s']:.1f} ({result['speedup']:.3f}x), accept "
        f"rate {spec['accept_rate']}, tokens per verify launch (all "
        f"slots) {spec['tokens_per_verify_launch']}; first divergence per "
        f"request "
        f"{diverge}")
    return result


def phase_serving_spec(torch):
    """``serving_spec``: bench.py's speculative workload (:706-760) at the
    TPU geometry on the full-width bf16 serving model: 8 slots,
    max_model_len 512, page 16, ``speculate_tokens=4``, over the bf16 and
    the int8 pool, each beside a spec-disabled engine of the same config;
    8 prompts of 12 copies of one token (``np.random.RandomState(3)``),
    496 greedy new tokens each."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    gc.collect()
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(LlamaConfig(**SERVING_CFG), seed=0)
    result = {"launches": {}}
    for pool in (None, "int8"):
        r = _serve_spec(torch, model, pool)
        for key, n in r["launches"].items():
            result["launches"][key] = result["launches"].get(key, 0) + n
        result["int8" if pool else "bf16"] = r
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------ the analyzer
# the analysis cell: the serving model and geometry with every program
# family on (prefix cache, chunked prefill, speculation), so decode (both
# kinds), every prefill bucket, every continuation bucket, copy-on-write
# and verify exist
ANALYSIS_ENGINE = dict(max_batch_slots=8, max_model_len=512, page_size=16,
                       enable_prefix_cache=True, prefill_chunk_tokens=128,
                       speculate_tokens=4)
# predicted (fake-tensor trace) against measured (max_memory_allocated
# over a program's eager warm-up and capture, above the same baseline)
# transient bytes of each program: within this many bytes plus this
# fraction of the prediction (the card's kernels keep internal scratch
# the trace cannot see: sort and reduction workspaces, cuBLAS's)
ANALYSIS_MEM_TOL = (16 << 20, 0.25)


def _analysis_state(torch, engine):
    """What an analysis must not move: launch counts, the engine's
    capture counters, the capture log, the device's allocated bytes."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.observability import jit_events

    torch.cuda.synchronize()
    m = engine.metrics
    return {
        "launches": dict(_build.launch_counts(), **_build.variant_counts()),
        "compiles": (m.decode_compiles, m.prefill_compiles,
                     m.prefill_ext_compiles, m.cow_compiles,
                     m.verify_compiles),
        "capture_log": len(jit_events.compile_log()),
        "memory_allocated": torch.cuda.memory_allocated(),
    }


def _planted_decode(engine, rule):
    """A copy of ``engine``'s decode program function with one planted
    fault of ``rule``'s: a host sync (``.item()``), a Python scalar of
    its closure frozen into the capture, a float64 upcast."""
    real = engine._decode_fn
    shift = 1

    def build(f, pool, any_sample, gen):
        fn = real(f, pool, any_sample, gen)

        def decode_fn():
            nxt, logits = fn()
            if rule == "host-sync":
                nxt = nxt + int(logits[0, 0].item() > 0)
            elif rule == "retrace-hazard":
                nxt = nxt + shift
            else:
                logits = logits.double()
            return nxt, logits

        return decode_fn

    return build


def _measured_programs(torch, engine):
    """Build every program of ``engine``'s family (``_program_tags``) one
    at a time; each one's predicted transient bytes (the analyzer's peak
    above its entry tensors) against ``max_memory_allocated`` over its
    eager warm-up and capture above the bytes allocated just before. The
    capture stream's cuBLAS workspace is allocated first, apart."""
    builders = {
        "decode": lambda b, s: engine._decode_program(s),
        "prefill": lambda b, s: engine._prefill_program(b),
        "prefill_ext": lambda b, s: engine._prefill_ext_program(b),
        "cow": lambda b, s: engine._cow_program(),
        "verify": lambda b, s: engine._verify_program(),
    }
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.cuda.stream(engine._capture_stream):
        x = torch.ones(64, 64, device="cuda", dtype=torch.bfloat16)
        y = x @ x
        del x, y
    torch.cuda.synchronize()
    workspace = torch.cuda.memory_allocated() - base
    rows = []
    slack, frac = ANALYSIS_MEM_TOL
    for kind, bucket, sample in engine._program_tags():
        label = engine._program_label(kind, bucket, sample)
        mem = engine._program_analysis[(kind, bucket, sample)]["memory"]
        predicted = mem["peak"] - mem["argument"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        builders[kind](bucket, sample)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        measured = torch.cuda.max_memory_allocated() - base
        kept = torch.cuda.memory_allocated() - base
        ok = abs(measured - predicted) <= slack + frac * predicted
        rows.append({"program": label, "predicted_peak": mem["peak"],
                     "predicted_argument": mem["argument"],
                     "predicted_transient": predicted,
                     "measured_transient": measured,
                     "kept_after_capture": kept,
                     "ratio": measured / predicted if predicted else None,
                     "within_tolerance": ok, "build_s": seconds})
        log(f"[analysis] {label}: predicted transient {predicted} B (peak "
            f"{mem['peak']}), measured {measured} B "
            f"({measured / max(predicted, 1):.3f}x), {kept} B kept by the "
            f"graph, built in {seconds:.2f}s")
    return workspace, rows


def phase_analysis(torch):
    """``analysis``: the static analyzer (``paddle_tpu_torch.analysis``) on
    the serving cell (the full-width bf16 Llama, 8 slots,
    ``max_model_len`` 512, page 16) with the prefix cache, chunked
    prefill (128) and speculation (K = 4) on: (a) ``Engine(...,
    analysis_check="error", device_memory_budget=<the card's memory>)``
    builds with no blocking finding, its build time beside an ungated
    twin's, ``check_programs``' seconds; (b) launch counts, capture
    counters, the capture log and ``memory_allocated()`` equal around
    ``check_programs``; (c) each program's predicted transient bytes
    against the measured peak of its warm-up and capture, within
    ``ANALYSIS_MEM_TOL``; (d) the decode program's predicted peak minus
    one byte as the budget: refused with ``AnalysisError`` before
    anything is allocated, its ``memory-budget`` findings naming
    ``serving.decode`` and the budget; (e) ``"warn"`` builds with a
    ``UserWarning`` and serves; (f) planted decode programs (a host
    sync, a frozen Python scalar, a float64 upcast) each raise under
    ``"error"``; (g) the gated engine serves the serving cell's 32
    requests: greedy tokens equal the ungated twin's, the launch gates
    ``_serving_gates``'; (h) a two-replica fleet under the default
    ``analysis_check="error"`` builds and serves."""
    import warnings

    from paddle_tpu_torch.analysis import AnalysisError
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (
        Engine,
        EngineConfig,
        Fleet,
        FleetConfig,
        SamplingParams,
    )

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**SERVING_CFG)
    before_model = torch.cuda.memory_allocated()
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before_model
    total = torch.cuda.get_device_properties(0).total_memory
    result = {"card_memory_bytes": total, "weights_bytes": weights}

    # (a) the gate at build, and an ungated twin
    t0 = time.perf_counter()
    plain = Engine(model, EngineConfig(**ANALYSIS_ENGINE))
    torch.cuda.synchronize()
    result["build_s_ungated"] = time.perf_counter() - t0
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gated = Engine(model, EngineConfig(**ANALYSIS_ENGINE,
                                       analysis_check="error",
                                       device_memory_budget=total))
    torch.cuda.synchronize()
    result["build_s_gated"] = time.perf_counter() - t0
    result["engine_bytes"] = torch.cuda.memory_allocated() - mem0
    result["pool_bytes"] = gated.pool.per_chip_nbytes()
    pb = dict(gated.metrics.program_bytes)
    result["program_bytes"] = pb
    check(len(pb) == len(gated._program_tags()),
          f"analysis: {len(pb)} programs summarized of "
          f"{len(gated._program_tags())}")
    check(gated.health()["predicted_peak_bytes_per_chip"] == max(pb.values())
          and gated.health()["device_memory_budget"] == total,
          f"analysis: health() {gated.health()}")
    log(f"[analysis] engine build: {result['build_s_gated']:.2f}s gated "
        f"against {result['build_s_ungated']:.2f}s ungated; family peak "
        f"{max(pb.values())} B of {total} B (weights {weights} B, pool "
        f"{result['pool_bytes']} B)")

    # (b) a check_programs call moves nothing
    state = _analysis_state(torch, gated)
    t0 = time.perf_counter()
    report = gated.check_programs("error")
    result["check_programs_s"] = time.perf_counter() - t0
    after = _analysis_state(torch, gated)
    check(state == after,
          f"analysis: check_programs moved {state} -> {after}")
    check(not report.errors, f"analysis: {report.render()}")
    result["findings"] = {f.rule: len(report.by_rule(f.rule))
                          for f in report.findings}
    log(f"[analysis] check_programs: {result['check_programs_s']:.2f}s, "
        f"{len(report)} findings ({result['findings']}), none blocking; "
        f"launches, capture counters, capture log and "
        f"memory_allocated() unchanged")

    # (c) predicted against measured, program by program
    workspace, rows = _measured_programs(torch, gated)
    result["cublas_workspace_bytes"] = workspace
    result["programs"] = rows
    bad = [r["program"] for r in rows if not r["within_tolerance"]]
    check(not bad, f"analysis: measured transient outside "
                   f"{ANALYSIS_MEM_TOL} of the prediction for {bad}")
    state = _analysis_state(torch, gated)
    report = gated.check_programs("error")
    check(state == _analysis_state(torch, gated),
          "analysis: check_programs moved something once the programs "
          "existed")

    # (d) a budget below the decode program's predicted peak
    budget = pb["decode"] - 1
    gc.collect()
    mem = torch.cuda.memory_allocated()
    try:
        Engine(model, EngineConfig(**ANALYSIS_ENGINE,
                                   device_memory_budget=budget))
        refused = None
    except AnalysisError as e:
        refused = e.report.by_rule("memory-budget")
    gc.collect()
    torch.cuda.synchronize()
    check(refused and any("serving.decode" in f.message for f in refused)
          and all(f"device_memory_budget={budget}" in f.message
                  for f in refused),
          f"analysis: budget {budget} not refused as it should be: "
          f"{refused}")
    check(torch.cuda.memory_allocated() == mem,
          f"analysis: the refused build left "
          f"{torch.cuda.memory_allocated() - mem} B allocated")
    result["refused"] = {"budget": budget, "findings": len(refused),
                         "programs": sorted(f.root for f in refused)}
    log(f"[analysis] budget {budget} B refused before any allocation: "
        f"{len(refused)} memory-budget findings "
        f"({result['refused']['programs']})")

    # (e) the same budget under "warn": built, serving
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warned = Engine(model, EngineConfig(**ANALYSIS_ENGINE,
                                            analysis_check="warn",
                                            device_memory_budget=budget))
    check(any(issubclass(w.category, UserWarning)
              and "memory-budget" in str(w.message) for w in caught),
          "analysis: warn mode gave no memory-budget warning")
    outs = warned.generate([[1, 2, 3, 4]] * 4,
                           SamplingParams(max_new_tokens=8))
    check(all(len(o.token_ids) == 8 for o in outs),
          "analysis: the warned engine did not serve")
    del warned, outs
    gc.collect()

    # (f) planted faults, found before any capture
    planted = {}
    for rule in ("host-sync", "retrace-hazard", "dtype-drift"):
        gated._decode_fn = _planted_decode(gated, rule)
        try:
            gated.check_decode("error")
            planted[rule] = None
        except AnalysisError as e:
            planted[rule] = [f.render() for f in e.report.by_rule(rule)]
        finally:
            del gated._decode_fn   # the class's builder again
        check(planted[rule], f"analysis: planted {rule} not found")
        log(f"[analysis] planted {rule}: {planted[rule][0]}")
    result["planted"] = planted

    # (g) the gated engine serves the cell's traffic
    prompts, params = _serving_workload(cfg)
    kinds, program = set(), gated._decode_program
    gated._decode_program = lambda any_sample: (
        kinds.add(any_sample), program(any_sample))[1]
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    with host_dispatch_probe() as probe:
        t0 = time.perf_counter()
        outs = gated.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    m = gated.metrics
    check(all(o.finish_reason in ("length", "stop") for o in outs),
          "analysis: not every request finished")
    check(gated.block_manager.num_used
          == gated.prefix_cache.reclaimable_blocks(),
          f"analysis: {gated.block_manager.num_used} KV blocks in use, "
          f"{gated.prefix_cache.reclaimable_blocks()} of them cached")
    _serving_gates("analysis", counts, m, probe, cfg.num_hidden_layers,
                   "paged_attention", "float", True,
                   gated.config.prefill_buckets, m.decode_compiles)
    twin = plain.generate(prompts, params)
    greedy = [i for i, p in enumerate(params) if not p.do_sample]
    check(all(outs[i].token_ids == twin[i].token_ids for i in greedy),
          "analysis: the gated engine's greedy tokens differ from the "
          "ungated twin's")
    n_tokens = sum(len(o.token_ids) for o in outs)
    result.update({
        "launches": counts, "seconds": dt, "tokens_per_s": n_tokens / dt,
        "generated_tokens": n_tokens, "decode_steps": m.decode_steps,
        "verify_steps": m.verify_steps, "prefill_steps": m.prefill_steps,
        "sampled_equal_twin": all(
            outs[i].token_ids == twin[i].token_ids
            for i in range(len(outs)) if i not in greedy),
    })
    log(f"[analysis] gated engine: {len(outs)} requests, {n_tokens} tokens "
        f"in {dt:.3f}s ({n_tokens / dt:.1f} tokens/s), greedy tokens equal "
        f"the ungated twin's; launch gates held")
    del plain, gated, twin, outs
    gc.collect()
    torch.cuda.empty_cache()

    # (h) a fleet under the JAX default gate
    t0 = time.perf_counter()
    fleet = Fleet(model, EngineConfig(**ANALYSIS_ENGINE), FleetConfig(
        num_replicas=2))
    check(fleet.config.analysis_check == "error",
          "analysis: the fleet's default gate is not 'error'")
    build_s = time.perf_counter() - t0
    outs = fleet.generate(prompts[:8], SamplingParams(max_new_tokens=32))
    check(len(outs) == 8 and all(len(o.token_ids) == 32 for o in outs),
          "analysis: the gated fleet did not serve")
    result["fleet_build_s"] = build_s
    log(f"[analysis] 2-replica fleet under analysis_check='error': built "
        f"in {build_s:.2f}s, served 8 requests")
    # the phase's summary, on a line of its own
    log("[analysis] summary " + json.dumps({
        "build_s_gated": result["build_s_gated"],
        "build_s_ungated": result["build_s_ungated"],
        "check_programs_s": result["check_programs_s"],
        "family_peak_bytes": max(pb.values()),
        "card_memory_bytes": total,
        "cublas_workspace_bytes": workspace,
        "programs": {r["program"]: [r["predicted_transient"],
                                    r["measured_transient"]]
                     for r in rows},
        "refused_budget": budget, "planted": sorted(planted),
        "tokens_per_s": result["tokens_per_s"],
        "fleet_build_s": build_s}))
    del fleet, model
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------------- jit
# the jit cell: the serving cell's model (SERVING_CFG, bf16) staged with
# to_static (eval, [JIT_BATCH, JIT_SEQ] prompts) and its compile cache
# across processes; jit.save over JIT_BUCKETS of the sequence dim, loaded
# in another process; training through to_static on the 2-layer training
# model (then JIT_TRAIN_SHORT tokens, a new shape) and the ragged MoE
# layer, both on JIT_TRAIN_BACKEND (AOTAutograd without Inductor's code
# generation: two more cold Inductor compiles would take ~55 s of the
# script's 1200 s; Inductor's own run of the same steps is in PERF.md);
# the analysis cell's engine warm-restarted from the compile cache
JIT_BATCH, JIT_SEQ = 4, 512
# (a) and (b) compile the serving model with Inductor cut to 4 layers:
# its 12-layer cold compile took 53.5 s and 110.5 s in two runs of the
# whole script (NVIDIA H100 80GB HBM3, 700 W), past what the script's
# 1200 s limit leaves
JIT_STATIC_CFG = dict(SERVING_CFG, num_hidden_layers=4)
JIT_BUCKETS = [256, 512]
JIT_RAGGED = 300
JIT_TRAIN_CFG = dict(TRAIN_CFG, num_hidden_layers=2)
JIT_TRAIN_BATCH, JIT_TRAIN_SEQ, JIT_TRAIN_SHORT = 2, 1024, 512
JIT_TRAIN_BACKEND = "aot_eager"
JIT_MOE_BATCH, JIT_MOE_SEQ = 4, 1024
JIT_REQUESTS, JIT_NEW_TOKENS = 8, 32
# the gated engine build of the analysis cell before the compile cache
# (the analysis phase's, PERF.md; NVIDIA H100 80GB HBM3, 700 W)
JIT_GATED_BUILD_BEFORE_S = 13.36
JIT_WORKER_TIMEOUT_S = 600


def _jit_ids(torch, vocab, b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, vocab, (b, s), generator=g).cuda()


def _logit_stats(torch, out, ref):
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    return {"max_abs_err": d.max().item(),
            "rel_l2": (d.norm() / r.norm().clamp_min(1e-30)).item(),
            "logit_absmax": r.abs().max().item(),
            "finite": bool(o.isfinite().all())}


def _counts():
    from paddle_tpu_torch.kernels import _build

    return dict(_build.launch_counts(), **_build.variant_counts())


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _digest(torch, t):
    import hashlib

    return hashlib.sha256(
        t.detach().float().cpu().numpy().tobytes()).hexdigest()[:16]


def _jit_requests(cfg):
    from paddle_tpu_torch.serving import SamplingParams

    prompts, _ = _serving_workload(cfg, n_req=JIT_REQUESTS)
    return prompts, SamplingParams(max_new_tokens=JIT_NEW_TOKENS)


def _jit_engine_config(cache, **kw):
    import torch

    from paddle_tpu_torch.serving import EngineConfig

    return EngineConfig(**dict(
        ANALYSIS_ENGINE, analysis_check="error",
        device_memory_budget=torch.cuda.get_device_properties(0)
        .total_memory, compile_cache=cache), **kw)


def _jit_to_static_task(torch, spec):
    """(a) and (b), in a process of its own: ``to_static(cache=)`` of the
    serving model cut to ``JIT_STATIC_CFG``'s depth, in eval; the first
    call's seconds, the flash launches of
    one compiled call, the logits against the eager model's, no compile
    on a second call at the same shape, Inductor's cache counters and the
    compile cache's. The compiled calls run in
    Inductor's deterministic mode (no choice by on-device benchmarking
    where it changes numerics): two compiles of one program then agree to
    the bit, and the cold and warm processes can be held to that. The
    mode is patched around each call, as Dynamo resets it to
    ``torch.are_deterministic_algorithms_enabled()`` after every
    compile."""
    from torch._dynamo.utils import counters
    from torch._inductor import config as inductor_config

    from paddle_tpu_torch import compilecache, jit
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**JIT_STATIC_CFG)
    model = LlamaForCausalLM(cfg, seed=0).eval()
    ids = _jit_ids(torch, cfg.vocab_size, JIT_BATCH, JIT_SEQ)
    with torch.no_grad():
        ref = model(ids)
    torch.cuda.synchronize()
    jit.to_static(model, cache=spec["cache"])
    staged = model.forward
    counters.clear()
    _build.reset_launch_counts()
    det = inductor_config.patch(deterministic=True)
    t0 = time.perf_counter()
    with torch.no_grad(), det:
        out = model(ids)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = _nonzero(_counts())
    _build.reset_launch_counts()
    with torch.no_grad(), det:
        again = model(ids)
    torch.cuda.synchronize()
    per_call = _nonzero(_counts())
    return {
        "first_call_s": first_s,
        "compiles_after_second_call": staged.compiles,
        "launches_first_call": first, "launches_per_call": per_call,
        "logits": _logit_stats(torch, out, ref),
        "second_call_equal": bool(torch.equal(out, again)),
        "digest": _digest(torch, out),
        "inductor": dict(counters["inductor"]),
        "aot_autograd": dict(counters["aot_autograd"]),
        "cache": compilecache.resolve(spec["cache"]).metrics.snapshot(),
        "launches": first,
    }


def _jit_load_task(torch, spec, model):
    """(c), in the warm process: ``jit.load`` of the saved serving model;
    the flash launches of one call of the loaded program, its logits
    against the eager ``model``'s at JIT_SEQ and at JIT_RAGGED tokens
    (padded to the bucket and sliced back)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.kernels import _build

    cfg = model.config
    t0 = time.perf_counter()
    loaded = jit.load(spec["path"])
    load_s = time.perf_counter() - t0
    ids = _jit_ids(torch, cfg.vocab_size, JIT_BATCH, JIT_SEQ)
    ragged = ids[:, :JIT_RAGGED].contiguous()
    with torch.no_grad():
        ref, ref_ragged = model(ids), model(ragged)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = loaded(ids)
    torch.cuda.synchronize()
    per_call = _nonzero(_counts())
    _build.reset_launch_counts()
    out_ragged = loaded(ragged)
    torch.cuda.synchronize()
    ragged_launches = _nonzero(_counts())
    return {
        "load_s": load_s, "launches_per_call": per_call,
        "launches_ragged_call": ragged_launches,
        "logits": _logit_stats(torch, out, ref),
        "ragged_shape": list(out_ragged.shape),
        "logits_ragged": _logit_stats(torch, out_ragged, ref_ragged),
        "launches": {k: per_call.get(k, 0) + ragged_launches.get(k, 0)
                     for k in set(per_call) | set(ragged_launches)},
    }


def _jit_engine_task(torch, spec, model):
    """(e), in the warm process: the analysis cell's gated engine over
    ``model`` built warm from the compile cache: the analyzer's traces
    (counted), the aot-hits, the programs captured at build and while
    serving, the build's seconds, the greedy tokens of the cell's
    requests."""
    from paddle_tpu_torch.analysis import trace as analysis_trace
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.observability import jit_events
    from paddle_tpu_torch.serving import Engine

    prompts, params = _jit_requests(model.config)
    torch.cuda.synchronize()
    traces0, hits0 = analysis_trace.trace_count(), jit_events.aot_hits()
    t0 = time.perf_counter()
    engine = Engine(model, _jit_engine_config(spec["cache"]))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = engine.metrics
    built = _program_counts(m)
    _build.reset_launch_counts()
    outs = engine.generate(prompts, params)
    torch.cuda.synchronize()
    return {
        "build_s": build_s,
        "analysis_traces": analysis_trace.trace_count() - traces0,
        "aot_hits": int(jit_events.aot_hits() - hits0),
        "programs": len(engine._program_tags()),
        "compiles_at_build": built, "compiles_after_serving":
            _program_counts(m),
        "tokens": [o.token_ids for o in outs],
        "cache": engine._cc.metrics.snapshot(),
        "launches": _nonzero(_counts()),
    }


def _program_counts(m):
    return [getattr(m, f) for f in _PROGRAM_FIELDS]


def _jit_warm_task(torch, spec):
    """(b)'s warm process, then (c)'s load and (e)'s warm engine in the
    same fresh process, over one serving model (one process start and
    two model builds less)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    rec = {"to_static": _jit_to_static_task(torch, spec)}
    gc.collect()
    model = LlamaForCausalLM(LlamaConfig(**SERVING_CFG), seed=0).eval()
    rec["load"] = _jit_load_task(torch, spec, model)
    gc.collect()
    rec["engine"] = _jit_engine_task(
        torch, dict(spec, cache=spec["engine_cache"]), model)
    return rec


_JIT_TASKS = {"to_static": _jit_to_static_task, "warm": _jit_warm_task}


def jit_worker_main(spec_path, out_path):
    """One process of the ``jit`` phase (``chip_smoke.py --jit-worker SPEC
    OUT``): the spec's task (``_JIT_TASKS``); writes its record to OUT on
    any exit."""
    import traceback

    import torch

    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"task": spec["task"]}
    try:
        rec.update(_JIT_TASKS[spec["task"]](torch, spec))
    except Exception as e:
        traceback.print_exc()
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        with open(out_path, "w") as f:
            json.dump(rec, f)
    return 1 if "error" in rec else 0


def _jit_worker(tmp, name, **spec):
    """Run one ``--jit-worker`` process to its end, with local Inductor
    and Triton caches of its own (a fresh process on a fresh machine);
    -> its record."""
    spec_path = os.path.join(tmp, f"{name}.spec.json")
    out_path = os.path.join(tmp, f"{name}.out.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ,
               TORCHINDUCTOR_CACHE_DIR=os.path.join(tmp, name, "inductor"),
               TRITON_CACHE_DIR=os.path.join(tmp, name, "triton"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--jit-worker",
         spec_path, out_path], env=env, capture_output=True, text=True,
        timeout=JIT_WORKER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    rec = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            rec = json.load(f)
    check(proc.returncode == 0 and "error" not in rec,
          f"jit: worker {name} exit {proc.returncode}: {rec.get('error')}"
          f"\n{proc.stderr[-3000:]}")
    rec["process_s"] = wall
    return rec


def _merge(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def _jit_static_gates(tag, rec, layers):
    """(a)'s gates on one to_static process's record."""
    per = rec["launches_per_call"]
    check(per.get("flash_attention") == layers
          and per.get("flash_attention/wgmma") == layers,
          f"jit {tag}: {per} flash launches in one compiled call, want "
          f"{layers} on wgmma")
    st = rec["logits"]
    check(st["finite"] and st["max_abs_err"] <= LOGITS_TOL,
          f"jit {tag}: compiled logits differ from eager by "
          f"{st['max_abs_err']} > {LOGITS_TOL} ({st})")
    check(rec["second_call_equal"]
          and rec["compiles_after_second_call"] == 1,
          f"jit {tag}: {rec['compiles_after_second_call']} compiles after "
          f"a second call at the same shape (want 1)")


def _jit_train(torch):
    """(d): the 2-layer training model through ``to_static`` in train
    mode, then a backward; the flash forward, dq and dk/dv launches of a
    compiled step, its gradients against the eager step's; a step at a new
    sequence length compiles once more (and a second call at a shape
    never); the ragged MoE layer under ``to_static`` (fullgraph), its
    grouped GEMM launches of a forward and its output against the eager
    layer's. Both on ``JIT_TRAIN_BACKEND``."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**JIT_TRAIN_CFG)
    layers = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, seed=0)
    ref = LlamaForCausalLM(cfg, seed=0)
    ids = _jit_ids(torch, cfg.vocab_size, JIT_TRAIN_BATCH, JIT_TRAIN_SEQ, 1)
    _, ref_loss = ref(ids, labels=ids)
    ref_loss.backward()
    jit.to_static(model, backend=JIT_TRAIN_BACKEND)
    steps = []
    for x in (ids, ids, ids[:, :JIT_TRAIN_SHORT].contiguous()):
        model.zero_grad(set_to_none=True)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        _, loss = model(x, labels=x)
        loss.backward()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, _nonzero(_counts()),
                      model.forward.compiles))
        if len(steps) == 2:
            rel = {n: ((p.grad.float() - q.grad.float()).norm()
                       / q.grad.float().norm().clamp_min(1e-30)).item()
                   for (n, p), q in zip(model.named_parameters(),
                                        ref.parameters())}
            step_loss = loss.item()
    per_step = steps[1][1]
    worst = max(rel, key=rel.get)
    check(all(per_step.get(k) == layers for k in FLASH),
          f"jit train: {per_step} flash launches in a compiled step, want "
          f"{layers} of each of {FLASH}")
    check([c for _, _, c in steps] == [1, 1, 2],
          f"jit train: compiles after each step {[c for *_, c in steps]}, "
          f"want 1, 1 (the same shape), 2 (a new one)")
    check(abs(step_loss - ref_loss.item()) <= TRAIN_LOSS_TOL,
          f"jit train: compiled loss {step_loss} against eager "
          f"{ref_loss.item()}")
    check(np.isfinite(rel[worst]) and rel[worst] <= TRAIN_GRAD_RTOL,
          f"jit train: gradient of {worst} differs from the eager step's "
          f"by {rel[worst]} (relative L2) > {TRAIN_GRAD_RTOL}")
    result = {"backend": JIT_TRAIN_BACKEND, "first_step_s": steps[0][0],
              "second_step_s": steps[1][0], "new_shape_step_s": steps[2][0],
              "launches_per_step": per_step, "loss": step_loss,
              "eager_loss": ref_loss.item(), "worst_grad_rel_l2":
              [worst, rel[worst]], "compiles": [c for *_, c in steps]}
    log(f"[jit] (d) train ({JIT_TRAIN_BACKEND}): 2-layer step through "
        f"to_static, first {steps[0][0]:.1f}s (compile), then "
        f"{steps[1][0] * 1e3:.1f} ms; launches {per_step}; loss "
        f"{step_loss:.5f} (eager {ref_loss.item():.5f}); worst gradient "
        f"{worst} at rel L2 {rel[worst]:.3g}; a {JIT_TRAIN_SHORT}-token "
        f"step compiled once more ({steps[2][0]:.1f}s)")
    launches = dict(per_step)
    del model, ref
    gc.collect()

    layer = MoELayer(**MOE_LAYER, impl="ragged", device="cuda",
                     dtype=torch.bfloat16, seed=0).eval()
    x = torch.randn(JIT_MOE_BATCH, JIT_MOE_SEQ, MOE_LAYER["d_model"],
                    device="cuda", generator=torch.Generator(
                        device="cuda").manual_seed(2)).to(torch.bfloat16)
    with torch.no_grad():
        want, _ = layer(x)
        jit.to_static(layer, backend=JIT_TRAIN_BACKEND)
        t0 = time.perf_counter()
        layer(x)
        torch.cuda.synchronize()
        moe_first_s = time.perf_counter() - t0
        _build.reset_launch_counts()
        got, _ = layer(x)
        torch.cuda.synchronize()
    moe = _nonzero(_counts())
    moe_l2 = _rel_l2(got, want)
    check(moe.get("grouped_matmul") == 3
          and moe.get("grouped_matmul/wgmma") == 3,
          f"jit moe: {moe} grouped GEMM launches in a compiled forward, "
          f"want 3 on wgmma")
    check(layer.forward.compiles == 1 and moe_l2 <= MOE_DENSE_L2,
          f"jit moe: {layer.forward.compiles} compiles, output rel L2 "
          f"{moe_l2} against eager (limit {MOE_DENSE_L2})")
    log(f"[jit] (d) ragged MoE layer under to_static(fullgraph, "
        f"{JIT_TRAIN_BACKEND}): first call {moe_first_s:.1f}s, launches "
        f"{moe}, rel L2 {moe_l2:.3g} against eager")
    result.update({"moe_first_call_s": moe_first_s,
                   "moe_launches_per_forward": moe, "moe_rel_l2": moe_l2})
    _merge(launches, moe)
    result["launches"] = launches
    del layer
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _jit_fallback(torch, model, src, tmp, prompts, params, cold_tokens):
    """(f): a copy of the compile cache with the greedy decode program's
    artifact bit-flipped (``_flip_bit``) and the sampling decode
    program's stamped with another torch version (``_stale_torch``): the
    engine builds, each damage is a counted, warned fallback that costs
    its program one trace, and the greedy tokens equal the cold
    engine's."""
    import contextlib
    import io
    import shutil

    from paddle_tpu_torch import compilecache
    from paddle_tpu_torch.analysis import trace as analysis_trace
    from paddle_tpu_torch.serving import Engine

    dst = os.path.join(tmp, "damaged")
    shutil.copytree(src, dst)
    mdir = os.path.join(dst, "manifests")
    (mname,) = os.listdir(mdir)
    with open(os.path.join(mdir, mname)) as f:
        entries = json.load(f)["entries"]
    for sample, mutate in ((False, _flip_bit), (True, _stale_torch)):
        entry = next(e for e in entries if e["kind"] == "decode"
                     and e["any_sample"] == sample)
        mutate(os.path.join(dst, "objects", entry["store_key"]))
    cc = compilecache.resolve(dst)
    traces0 = analysis_trace.trace_count()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        engine = Engine(model, _jit_engine_config(dst))
    traces = analysis_trace.trace_count() - traces0
    tokens = [o.token_ids for o in engine.generate(prompts, params)]
    snap = cc.metrics.snapshot()
    warned = [line for line in err.getvalue().splitlines()
              if "falling back" in line]
    check(snap["fallbacks"] == 2 and traces == 2 and tokens == cold_tokens
          and any("checksum mismatch" in w for w in warned)
          and any("environment mismatch" in w for w in warned),
          f"jit (f): fallbacks {snap['fallbacks']}, traces {traces}, "
          f"tokens equal {tokens == cold_tokens}, warnings {warned!r}")
    del engine
    gc.collect()
    return {"fallbacks": snap["fallbacks"], "analysis_traces": traces,
            "warnings": warned}


def _flip_bit(artifact):
    p = os.path.join(artifact, "analysis.bin")
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(p, "wb").write(bytes(raw))


def _stale_torch(artifact):
    p = os.path.join(artifact, "meta.json")
    meta = json.load(open(p))
    meta["env"]["torch"] = "0.0.1"
    json.dump(meta, open(p, "w"))


def phase_jit(torch):
    """``jit``: the jit surface and the compile cache on the serving
    cell's model (``SERVING_CFG``: 12 layers, hidden 2048, bf16): (a)
    ``to_static`` in eval at [4, 512], depth cut to ``JIT_STATIC_CFG``'s
    4 layers (the compiled calls in Inductor's deterministic mode,
    ``_jit_to_static_task``): 4 flash launches (wgmma) a compiled call,
    logits within ``LOGITS_TOL`` of eager, no compile on a second call;
    (b) ``to_static(cache=)`` in a cold process, then a warm one, each
    with fresh local Inductor and Triton caches: first-call seconds,
    artifact bytes, Inductor's FX-graph cache hits and misses (the warm
    one: hits, no miss), the outputs bit-identical ((a)'s gates run in
    both); (c) ``jit.save`` with buckets {seq: [256, 512]}, loaded in the
    warm process: 12 flash launches a call, logits within ``LOGITS_TOL``
    of eager, a 300-token input padded to 512 and sliced back; (d) the
    2-layer training model through ``to_static`` (``JIT_TRAIN_BACKEND``)
    in train mode and a backward: 2 launches each of the flash forward,
    dq and dk/dv a step, gradients within ``TRAIN_GRAD_RTOL`` of the eager
    step, exactly one more compile at a new sequence length; the ragged
    MoE layer under ``to_static``: 3 grouped GEMM launches a forward;
    (e) the analysis cell's gated engine (``analysis_check="error"``,
    the card's memory as budget, prefix cache and speculation on) built
    cold with a compile cache, then warm in the warm process: no
    analysis trace, one aot-hit a program, every program captured at
    build and none while serving, greedy tokens equal the cold engine's;
    both builds' seconds; (f) one artifact with a flipped bit, another
    with a planted torch version, in one build: each a counted, warned
    fallback, tokens unchanged."""
    import shutil
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jit_")
    try:
        return _jit_phase(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _jit_phase(torch, tmp):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.analysis import trace as analysis_trace
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine

    cfg = LlamaConfig(**SERVING_CFG)
    layers = cfg.num_hidden_layers
    result, launches = {}, {}
    cache = os.path.join(tmp, "ts_cache")
    ecache = os.path.join(tmp, "engine_cache")
    path = os.path.join(tmp, "saved", "llama")

    # (a) + (b): the cold to_static process
    cold = _jit_worker(tmp, "cold", task="to_static", cache=cache)

    # (c) jit.save here (loaded in the warm process below)
    model = LlamaForCausalLM(cfg, seed=0).eval()
    os.makedirs(os.path.dirname(path))
    t0 = time.perf_counter()
    jit.save(model, path,
             input_spec=[jit.InputSpec([JIT_BATCH, None], "int64")],
             bucket_sizes={1: JIT_BUCKETS})
    save_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the engine cold here (warm in the warm process below)
    model = LlamaForCausalLM(cfg, seed=0)
    prompts, params = _jit_requests(cfg)
    traces0 = analysis_trace.trace_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = Engine(model, _jit_engine_config(ecache))
    torch.cuda.synchronize()
    cold_build_s = time.perf_counter() - t0
    cold_traces = analysis_trace.trace_count() - traces0
    programs = len(engine._program_tags())
    built = _program_counts(engine.metrics)
    _build.reset_launch_counts()
    cold_tokens = [o.token_ids for o in engine.generate(prompts, params)]
    torch.cuda.synchronize()
    _merge(launches, _nonzero(_counts()))
    check(_program_counts(engine.metrics) == built,
          f"jit (e) cold: programs captured while serving {built} -> "
          f"{_program_counts(engine.metrics)}")
    del engine
    gc.collect()

    # (f) damaged artifacts degrade to a counted, warned fallback
    result["fallbacks"] = _jit_fallback(torch, model, ecache, tmp, prompts,
                                        params, cold_tokens)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) warm, (c) load and (e) warm, in one fresh process
    rec = _jit_worker(tmp, "warm", task="warm", cache=cache, path=path,
                      engine_cache=ecache)
    warm, loaded, warm_e = rec["to_static"], rec["load"], rec["engine"]

    for tag, r in (("cold", cold), ("warm", warm)):
        _jit_static_gates(tag, r, JIT_STATIC_CFG["num_hidden_layers"])
        _merge(launches, r["launches"])
    check(cold["cache"]["misses"] == 1 and cold["cache"]["bytes_written"] > 0
          and cold["inductor"].get("fxgraph_cache_miss", 0) > 0,
          f"jit (b) cold: cache {cold['cache']}, inductor "
          f"{cold['inductor']}")
    check(warm["cache"]["hits"] == 1
          and warm["inductor"].get("fxgraph_cache_hit", 0) > 0
          and warm["inductor"].get("fxgraph_cache_miss", 0) == 0,
          f"jit (b) warm: cache {warm['cache']}, inductor "
          f"{warm['inductor']}")
    check(warm["digest"] == cold["digest"],
          "jit (b): the warm process's outputs are not bit-identical to "
          "the cold one's")
    result["to_static"] = {"cold": cold, "warm": warm,
                           "warm_process_s": rec["process_s"]}
    log(f"[jit] (a) to_static [{JIT_BATCH}, {JIT_SEQ}], "
        f"{JIT_STATIC_CFG['num_hidden_layers']} layers: "
        f"{cold['launches_per_call']} a compiled call; logits max abs err "
        f"{cold['logits']['max_abs_err']:.4g} against eager; 1 compile "
        f"after the second call")
    log(f"[jit] (b) first call cold {cold['first_call_s']:.1f}s, warm "
        f"{warm['first_call_s']:.1f}s; artifacts "
        f"{cold['cache']['bytes_written']} B written, "
        f"{warm['cache']['bytes_read']} B read; inductor cold "
        f"{cold['inductor']}, warm {warm['inductor']}; processes "
        f"{cold['process_s']:.1f}s (cold) and {rec['process_s']:.1f}s "
        f"(warm, with (c) and (e)); outputs bit-identical")

    for key in ("launches_per_call", "launches_ragged_call"):
        per = loaded[key]
        check(per.get("flash_attention") == layers
              and per.get("flash_attention/wgmma") == layers,
              f"jit (c): {per} flash launches in one call of the loaded "
              f"program, want {layers} on wgmma")
    for key in ("logits", "logits_ragged"):
        st = loaded[key]
        check(st["finite"] and st["max_abs_err"] <= LOGITS_TOL,
              f"jit (c): loaded {key} differ from eager by "
              f"{st['max_abs_err']} > {LOGITS_TOL}")
    check(loaded["ragged_shape"] == [JIT_BATCH, JIT_RAGGED, cfg.vocab_size],
          f"jit (c): a {JIT_RAGGED}-token input came back "
          f"{loaded['ragged_shape']}")
    _merge(launches, loaded["launches"])
    result["save_load"] = dict(loaded, save_s=save_s)
    log(f"[jit] (c) jit.save over {JIT_BUCKETS} in {save_s:.1f}s; loaded "
        f"in another process ({loaded['load_s']:.1f}s): "
        f"{loaded['launches_per_call']} a call, logits max abs err "
        f"{loaded['logits']['max_abs_err']:.4g}; {JIT_RAGGED} tokens padded "
        f"and sliced back to {loaded['ragged_shape']}, max abs err "
        f"{loaded['logits_ragged']['max_abs_err']:.4g}")

    _merge(launches, warm_e["launches"])
    check(warm_e["analysis_traces"] == 0 and warm_e["aot_hits"] == programs
          and warm_e["compiles_at_build"] == built
          and warm_e["compiles_after_serving"] == built,
          f"jit (e) warm: {warm_e['analysis_traces']} analysis traces, "
          f"{warm_e['aot_hits']} aot-hits of {programs} programs, captured "
          f"{warm_e['compiles_at_build']} at build and "
          f"{warm_e['compiles_after_serving']} after serving (cold "
          f"{built})")
    check(warm_e["tokens"] == cold_tokens,
          "jit (e): the warm engine's greedy tokens differ from the cold "
          "engine's")
    result["engine"] = {
        "cold_build_s": cold_build_s, "cold_analysis_traces": cold_traces,
        "programs": programs, "captured_at_build": built,
        "warm": {k: v for k, v in warm_e.items() if k != "tokens"},
        "gated_build_before_s": JIT_GATED_BUILD_BEFORE_S}
    log(f"[jit] (e) gated engine with a compile cache: cold build "
        f"{cold_build_s:.2f}s ({cold_traces} analysis traces, {programs} "
        f"programs captured); warm build in another process "
        f"{warm_e['build_s']:.2f}s (0 traces, {warm_e['aot_hits']} "
        f"aot-hits, {programs} programs captured at build, none while "
        f"serving); the gated build before the cache: "
        f"{JIT_GATED_BUILD_BEFORE_S}s; greedy tokens equal")
    log(f"[jit] (f) {result['fallbacks']['fallbacks']} fallbacks, "
        f"{result['fallbacks']['analysis_traces']} traces, tokens equal: "
        + "; ".join(w[:160] for w in result["fallbacks"]["warnings"]))

    # (d) training, and the ragged MoE layer
    result["train"] = _jit_train(torch)
    _merge(launches, result["train"]["launches"])
    result["launches"] = launches
    log("[jit] summary " + json.dumps({
        "to_static_first_call_s": [cold["first_call_s"],
                                   warm["first_call_s"]],
        "cache_bytes": cold["cache"]["bytes_written"],
        "fxgraph_warm": warm["inductor"],
        "logits_max_abs_err": cold["logits"]["max_abs_err"],
        "load_max_abs_err": loaded["logits"]["max_abs_err"],
        "train_step_s": result["train"]["second_step_s"],
        "engine_build_s": [cold_build_s, warm_e["build_s"]],
        "launches": launches}))
    return result


# ------------------------------------------------------- the front door
# the server cell: the serving cell's model, geometry and 32 requests,
# through the HTTP front door from a client process; two tenants (API
# keys) of weights 2:1
SERVER_TENANTS = {"key-a": "a", "key-b": "b"}
SERVER_WEIGHTS = {"a": 2.0, "b": 1.0}
# the cell's TTFT is queueing (32 requests at t = 0 on 8 slots, the cold
# pass also captures every program), its TPOT the decode step: an SLO
# the cell meets, so /healthz must answer ok
SERVER_SLO = dict(ttft_p99_ms=30000.0, tpot_p99_ms=50.0)
# JAX's poll interval, and none: the driver's pause after a step that
# finished no request
SERVER_POLLS = (0.002, 0.0)
SERVER_TIMEOUT_S = 300
# the extra streaming request that hangs up after this many chunks
DISCONNECT_AFTER_CHUNKS = 3


def _serving_workload(cfg, n_req=32, mml=512, seeded=False):
    """The serving cell's requests (``_serve``'s): prompts of 8-127
    tokens, 64-255 new tokens, every fourth sampled (with a per-request
    seed when ``seeded``)."""
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.RandomState(0)
    prompts = [
        rng.randint(1, cfg.vocab_size, rng.randint(8, mml // 4)).tolist()
        for _ in range(n_req)
    ]
    max_new = [int(rng.randint(mml // 8, mml // 2)) for _ in range(n_req)]
    params = [
        SamplingParams(max_new_tokens=k, do_sample=True, temperature=0.8,
                       top_k=50, top_p=0.95, seed=i if seeded else None)
        if i % 4 == 3 else SamplingParams(max_new_tokens=k)
        for i, k in enumerate(max_new)
    ]
    return prompts, params


def http_client_main(spec_path, out_path):
    """The load generator of the ``server`` phase, run as its own process
    (``chip_smoke.py --http-client SPEC OUT``, no torch imported) so it
    never takes the server's GIL: one thread per request of SPEC, all
    released together; SSE requests record the time of their first chunk.
    The ``disconnect`` request reads its first chunks over a raw socket
    and hangs up with a reset. Writes one JSON object to OUT."""
    import http.client
    import socket
    import struct
    import threading

    with open(spec_path) as f:
        spec = json.load(f)
    port, reqs = spec["port"], spec["requests"]
    results = [None] * len(reqs)
    start = threading.Barrier(len(reqs) + (1 if spec.get("disconnect")
                                           else 0))

    def one(i, r):
        body = dict(r["body"])
        headers = {"Content-Type": "application/json",
                   "Authorization": f"Bearer {r['key']}"}
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=SERVER_TIMEOUT_S)
        rec = {"index": i}
        try:
            start.wait()
            rec["t_send"] = time.perf_counter()
            conn.request("POST", "/v1/completions",
                         body=json.dumps(body).encode(), headers=headers)
            resp = conn.getresponse()
            rec["status"] = resp.status
            if not body.get("stream"):
                payload = json.loads(resp.read())
                rec["t_done"] = time.perf_counter()
                rec["id"] = payload.get("id")
                if resp.status == 200:
                    ch = payload["choices"][0]
                    rec.update(tokens=ch["token_ids"],
                               finish_reason=ch["finish_reason"],
                               usage=payload["usage"],
                               tenant=payload["tenant"])
                else:
                    rec["error"] = payload
            else:
                streamed, events = [], []
                while True:
                    line = resp.fp.readline()
                    if not line:
                        rec["error"] = "stream ended before [DONE]"
                        break
                    line = line.strip()
                    if not line:
                        continue
                    data = line[len(b"data: "):]
                    if data == b"[DONE]":
                        break
                    ev = json.loads(data)
                    if "t_first" not in rec:
                        rec["t_first"] = time.perf_counter()
                    events.append(ev)
                rec["t_done"] = time.perf_counter()
                if events:
                    final = events[-1]
                    streamed = [t for ev in events[:-1]
                                for t in ev["choices"][0]["token_ids"]]
                    rec.update(
                        id=final["id"], tokens=streamed,
                        final_tokens=final["choices"][0]["token_ids"],
                        finish_reason=final["choices"][0]["finish_reason"],
                        usage=final.get("usage"), tenant=final.get("tenant"),
                        chunks=len(events) - 1)
        except Exception as e:  # recorded: the phase fails on it
            rec["error"] = f"{type(e).__name__}: {e}"
        finally:
            conn.close()
        results[i] = rec

    def disconnect(r):
        payload = json.dumps(r["body"]).encode()
        rec = {"chunks": 0}
        sock = socket.create_connection(("127.0.0.1", port),
                                        timeout=SERVER_TIMEOUT_S)
        try:
            start.wait()
            sock.sendall(
                b"POST /v1/completions HTTP/1.1\r\nHost: localhost\r\n"
                b"Content-Type: application/json\r\nAuthorization: Bearer "
                + r["key"].encode() + b"\r\nContent-Length: "
                + str(len(payload)).encode() + b"\r\n\r\n" + payload)
            buf = b""
            while buf.count(b"\ndata: ") < DISCONNECT_AFTER_CHUNKS:
                chunk = sock.recv(65536)
                if not chunk:
                    rec["error"] = "closed before the chunks"
                    break
                buf += chunk
            rec["chunks"] = buf.count(b"\ndata: ")
            for line in buf.split(b"\r\n"):
                if line.lower().startswith(b"x-request-id:"):
                    rec["id"] = line.split(b":", 1)[1].strip().decode()
        finally:
            # RST on close: the server's next chunk write fails
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
            sock.close()
        results.append(dict(rec, disconnect=True))

    threads = [threading.Thread(target=one, args=(i, r))
               for i, r in enumerate(reqs)]
    if spec.get("disconnect"):
        threads.append(threading.Thread(target=disconnect,
                                        args=(spec["disconnect"],)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVER_TIMEOUT_S)
    with open(out_path, "w") as f:
        json.dump({"results": results,
                   "alive": sum(t.is_alive() for t in threads)}, f)
    return 0


def _http_pass(tmp, port, prompts, params, keys, disconnect=None):
    """One client process over the workload: request i streams when
    (i // 2) is even and uses ``keys[i % 2]``. Returns its records (the
    disconnect one last) and the wall from the first send to the last
    answer."""
    reqs = []
    for i, (p, sp) in enumerate(zip(prompts, params)):
        body = {"prompt": p, "max_tokens": sp.max_new_tokens,
                "stream": (i // 2) % 2 == 0}
        if sp.do_sample:
            body.update(do_sample=True, temperature=sp.temperature,
                        top_k=sp.top_k, top_p=sp.top_p, seed=sp.seed)
        reqs.append({"body": body, "key": keys[i % 2]})
    spec_path = os.path.join(tmp, "client_spec.json")
    out_path = os.path.join(tmp, "client_out.json")
    with open(spec_path, "w") as f:
        json.dump({"port": port, "requests": reqs,
                   "disconnect": disconnect}, f)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--http-client",
         spec_path, out_path], capture_output=True, text=True,
        timeout=SERVER_TIMEOUT_S + 60)
    check(proc.returncode == 0,
          f"server: the client process failed: {proc.stderr[-2000:]}")
    with open(out_path) as f:
        out = json.load(f)
    check(out["alive"] == 0, "server: client threads still waiting")
    recs = out["results"]
    bad = [r for r in recs if r.get("error") or (
        not r.get("disconnect") and r.get("status") != 200)]
    check(not bad, f"server: requests failed: {bad[:3]}")
    main = [r for r in recs if not r.get("disconnect")]
    wall = max(r["t_done"] for r in main) - min(r["t_send"] for r in main)
    return recs, wall


def _quantiles(xs):
    return ({"p50": float(np.quantile(xs, 0.5)),
             "p99": float(np.quantile(xs, 0.99))} if len(xs) else None)


def _check_http_results(tag, recs, prompts, params, ref):
    """Every request answered once with its usage; greedy token ids (SSE
    chunks concatenated, and the final chunk's list) equal the in-process
    ``generate`` tokens of ``ref``."""
    main = [r for r in recs if not r.get("disconnect")]
    check(sorted(r["index"] for r in main) == list(range(len(prompts)))
          and len({r["id"] for r in main}) == len(prompts),
          f"{tag}: not every request answered exactly once")
    mismatched = []
    for r in main:
        i = r["index"]
        p, sp, toks = prompts[i], params[i], r["tokens"]
        check(r["usage"] == {"prompt_tokens": len(p),
                             "completion_tokens": len(toks),
                             "total_tokens": len(p) + len(toks)},
              f"{tag}: request {i} usage {r['usage']}")
        check(r["finish_reason"] in ("length", "stop")
              and (r["finish_reason"] == "stop"
                   or len(toks) == sp.max_new_tokens),
              f"{tag}: request {i} finished {r['finish_reason']} with "
              f"{len(toks)} of {sp.max_new_tokens} tokens")
        if "final_tokens" in r:
            check(r["final_tokens"] == toks,
                  f"{tag}: request {i}'s SSE chunks differ from its final "
                  f"chunk")
        check(r["tenant"] == SERVER_TENANTS[("key-a", "key-b")[i % 2]],
              f"{tag}: request {i} answered for tenant {r['tenant']}")
        if not sp.do_sample and toks != ref[i]:
            mismatched.append(i)
    check(not mismatched,
          f"{tag}: greedy HTTP tokens differ from in-process generate for "
          f"requests {mismatched}")


def phase_server(torch):
    """``server``: the serving cell behind ``serve()`` (the front door's
    driver thread steps the engine and captures its programs), loaded by
    a client process over HTTP. Gates: greedy token parity with
    in-process ``generate`` on the same engine, usage and tenants, one
    disconnect aborted cleanly, ``/metrics`` and ``/healthz``, the access
    log, the launches from the replays, nothing launched outside a graph,
    no step error. Records HTTP against in-process tokens/s, client and
    engine TTFT, and the driver's wall per step against the replay's, at
    both poll intervals."""
    import http.client
    import shutil
    import signal
    import tempfile

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import LatencyDigest, SLOConfig
    from paddle_tpu_torch.serving import (
        Engine, EngineConfig, QoSConfig, TenantPolicy, serve,
    )
    from paddle_tpu_torch.serving.access_log import iter_records

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**SERVING_CFG)
    model = LlamaForCausalLM(cfg, seed=0)
    L = cfg.num_hidden_layers
    prompts, params = _serving_workload(cfg, seeded=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_server_")
    ecfg = EngineConfig(
        max_batch_slots=8, max_model_len=512, page_size=16,
        journal=os.path.join(tmp, "journal"),
        access_log=os.path.join(tmp, "access"), slo=SLOConfig(**SERVER_SLO))
    engine = Engine(model, ecfg)
    kinds, program = set(), engine._decode_program
    engine._decode_program = lambda any_sample: (
        kinds.add(any_sample), program(any_sample))[1]
    # per step: its wall inside Engine.step, and the decode launch's
    # (staging, replay, read-back)
    steps, decodes = [], []
    real_step = engine.step

    def timed_step():
        t0 = time.perf_counter()
        out = real_step()
        steps.append((t0, time.perf_counter()))
        return out

    engine.step = timed_step
    _timed_launches(engine, "_launch_decode", decodes)
    qos = QoSConfig(tenants={t: TenantPolicy(weight=w)
                             for t, w in SERVER_WEIGHTS.items()},
                    api_keys=SERVER_TENANTS, default_tenant=None)
    sigterm = signal.getsignal(signal.SIGTERM)
    srv = serve(engine, port=0, qos=qos)
    keys = list(SERVER_TENANTS)
    result = {"requests": len(prompts), "tenants": SERVER_WEIGHTS,
              "passes": []}
    try:
        srv.poll_interval_s = SERVER_POLLS[0]
        _build.reset_launch_counts()
        with host_dispatch_probe() as probe:
            # pass 1, cold: the driver thread captures every program; one
            # more streaming request hangs up after its third chunk
            recs, wall = _http_pass(
                tmp, srv.port, prompts, params, keys,
                disconnect={"body": {"prompt": prompts[0],
                                     "max_tokens": 255, "stream": True},
                            "key": keys[0]})
            deadline = time.monotonic() + 60
            while srv._streams and time.monotonic() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
        counts = dict(_build.launch_counts(), **_build.variant_counts())
        m = engine.metrics
        check(kinds and kinds <= {False, True}, f"server: decode kinds "
              f"{kinds}")
        _serving_gates("server", counts, m, probe, L, "paged_attention",
                       "float", True, ecfg.prefill_buckets, len(kinds))
        # programs bound their replay while the probe counted: read now
        replays = probe["replays"]
        gone = next(r for r in recs if r.get("disconnect"))
        check(gone.get("chunks", 0) >= DISCONNECT_AFTER_CHUNKS
              and "id" in gone, f"server: the disconnect client {gone}")
        check(not srv._streams and srv.metrics.disconnects >= 1
              and engine.block_manager.num_used == 0,
              f"server: after the disconnect {len(srv._streams)} streams, "
              f"{srv.metrics.disconnects} disconnects, "
              f"{engine.block_manager.num_used} KV blocks in use")
        # the side channels: /metrics (engine latency, both tenants) and
        # /healthz, then the access log (one line per request, its tenant)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        try:
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            conn.request("GET", "/healthz")
            hz = conn.getresponse()
            health = json.loads(hz.read())
        finally:
            conn.close()
        check(f'paddle_tpu_serving_latency_seconds{{engine="'
              f'{engine.engine_id}",phase="ttft",quantile="0.5"}}' in text,
              "server: /metrics has no engine ttft quantiles")
        for t in SERVER_WEIGHTS:
            for series in ("paddle_tpu_serving_tenant_requests_total",
                           "paddle_tpu_serving_tenant_finished_total"):
                check(f'{series}{{tenant="{t}"}}' in text,
                      f"server: /metrics has no {series} for tenant {t}")
        check(hz.status == 200 and health["status"] == "ok",
              f"server: /healthz {hz.status} {health}")
        lines = {str(r["rid"]): r for r in iter_records(
            os.path.join(tmp, "access"))}
        for r in recs:
            line = lines.get(str(r["id"]))
            if r.get("disconnect"):
                check(line is not None and line["finish_reason"] == "aborted",
                      f"server: the disconnected request's log line {line}")
            else:
                check(line is not None and line["tenant"] == r["tenant"]
                      and line["output_tokens"] == len(r["tokens"]),
                      f"server: request {r['index']}'s log line {line}")
        check(len(lines) == len(prompts) + 1,
              f"server: {len(lines)} access-log lines for "
              f"{len(prompts)} requests and one disconnect")

        # the in-process reference on the same engine (its programs are
        # built); the driver holds no request, the lock keeps it off
        def in_process():
            with srv._backend_lock:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = engine.generate(prompts, params)
                torch.cuda.synchronize()
                return outs, time.perf_counter() - t0

        outs, _ = in_process()
        ref = [o.token_ids for o in outs]
        _check_http_results("server pass 1", recs, prompts, params, ref)
        n_tokens = sum(len(o.token_ids) for o in outs)

        # timed passes, in turns: HTTP at each poll interval, in process
        order = [SERVER_POLLS[0], SERVER_POLLS[1], None, None,
                 SERVER_POLLS[1], SERVER_POLLS[0]]
        for poll in order:
            engine.metrics.latency = {p: LatencyDigest() for p in
                                      ("queue", "ttft", "tpot", "e2e")}
            del steps[:], decodes[:]
            if poll is None:
                outs, wall = in_process()
                check(all(o.token_ids == ref[i]
                          for i, o in enumerate(outs)
                          if not params[i].do_sample),
                      "server: in-process greedy tokens changed between runs")
                entry = {"mode": "in_process", "seconds": wall,
                         "tokens_per_s": n_tokens / wall}
                # generate's loop beside the driver's: its wall per step,
                # the step's own and the decode launch's
                busy = steps[-1][1] - steps[0][0]
                entry.update(
                    steps=len(steps),
                    loop_ms_per_step=busy / len(steps) * 1e3,
                    step_ms=float(np.mean([b - a for a, b in steps])) * 1e3,
                    decode_launch_ms=float(np.mean(decodes)) * 1e3)
            else:
                srv.poll_interval_s = poll
                recs, wall = _http_pass(tmp, srv.port, prompts, params, keys)
                _check_http_results(f"server poll {poll}", recs, prompts,
                                    params, ref)
                got = sum(len(r["tokens"]) for r in recs)
                sse = [r["t_first"] - r["t_send"] for r in recs
                       if "t_first" in r]
                d = engine.metrics.latency["ttft"]
                busy = steps[-1][1] - steps[0][0]
                entry = {
                    "mode": "http", "poll_interval_s": poll,
                    "seconds": wall, "generated_tokens": got,
                    "tokens_per_s": got / wall,
                    "client_ttft_s": _quantiles(sse),
                    "engine_ttft_s": {"p50": d.quantile(0.5),
                                      "p99": d.quantile(0.99)},
                    "steps": len(steps),
                    "loop_ms_per_step": busy / len(steps) * 1e3,
                    "step_ms": float(np.mean([b - a for a, b in steps]))
                    * 1e3,
                    "decode_launch_ms": float(np.mean(decodes)) * 1e3,
                }
            result["passes"].append(entry)
            log(f"[server] {entry}")
        check(srv.metrics.step_errors == 0
              and srv.metrics.stream_faults == 0
              and srv.metrics.accept_faults == 0,
              f"server: step errors {srv.metrics.step_errors}, stream "
              f"faults {srv.metrics.stream_faults}, accept faults "
              f"{srv.metrics.accept_faults}")
        check(srv.drain(timeout=60) and not srv._streams
              and engine.block_manager.num_used == 0,
              "server: the drain left streams or KV blocks")
    finally:
        srv.close()
        signal.signal(signal.SIGTERM, sigterm)

    def best(mode, poll=None):
        runs = [p["tokens_per_s"] for p in result["passes"]
                if p["mode"] == mode and p.get("poll_interval_s") == poll]
        return max(runs)

    inproc = best("in_process")
    for poll in SERVER_POLLS:
        result[f"http_tokens_per_s_poll_{poll}"] = best("http", poll)
        result[f"http_vs_in_process_poll_{poll}"] = best("http",
                                                         poll) / inproc
    result.update(in_process_tokens_per_s=inproc, launches=counts,
                  decode_kinds=sorted("mixed" if k else "greedy"
                                      for k in kinds),
                  graph_replays=replays,
                  disconnects=srv.metrics.disconnects,
                  step_errors=srv.metrics.step_errors)
    log(f"[server] in-process {inproc:.1f} tokens/s; HTTP "
        + ", ".join(f"poll {p}: {result[f'http_tokens_per_s_poll_{p}']:.1f}"
                    f" ({result[f'http_vs_in_process_poll_{p}']:.3f}x)"
                    for p in SERVER_POLLS))
    del engine, model
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return result


# the journal cell: the first 8 serving-cell prompts, 128 greedy new
# tokens each; the worker kills itself once this many tokens decoded
JOURNAL_REQUESTS = 8
JOURNAL_NEW_TOKENS = 128
JOURNAL_KILL_AT = 200
JOURNAL_RUNS = 3


def _journal_engine_config(journal_dir=None):
    from paddle_tpu_torch.serving import EngineConfig

    return EngineConfig(max_batch_slots=8, max_model_len=512, page_size=16,
                        journal=journal_dir)


def _journal_prompts(cfg):
    prompts, _ = _serving_workload(cfg)
    return prompts[:JOURNAL_REQUESTS]


def _weights_digest(model):
    import torch

    with torch.no_grad():
        return float(sum(p.double().sum().item()
                         for p in model.parameters()))


def journal_worker_main(journal_dir, out_path, kill_at):
    """The killed life of the ``journal`` phase, run as its own process
    (``chip_smoke.py --journal-worker DIR OUT KILL_AT``): the serving
    model over a journaled engine, the journal cell's requests submitted,
    every finished output appended to OUT (fsync'd), and SIGKILL to
    itself between two steps once ``kill_at`` tokens have decoded."""
    import signal

    import torch

    sys.path.insert(0, REPO)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(**SERVING_CFG)
    model = LlamaForCausalLM(cfg, seed=0)
    engine = Engine(model, _journal_engine_config(journal_dir))
    params = SamplingParams(max_new_tokens=JOURNAL_NEW_TOKENS)
    for i, p in enumerate(_journal_prompts(cfg)):
        engine.add_request(p, params, request_id=f"req-{i}")
    with open(out_path, "a") as out:
        out.write(json.dumps({"weights": _weights_digest(model)}) + "\n")
        out.flush()
        while engine.has_unfinished():
            if engine.metrics.decode_tokens >= kill_at:
                # a hard kill between steps, mid-decode: no cleanup runs
                os.kill(os.getpid(), signal.SIGKILL)
            for o in engine.step():
                out.write(json.dumps({"rid": o.request_id,
                                      "tokens": o.token_ids,
                                      "reason": o.finish_reason}) + "\n")
                out.flush()
                os.fsync(out.fileno())
    return 0


def phase_journal(torch):
    """``journal``: the durable request journal on the serving model. A
    worker process is SIGKILLed mid-decode; a fresh engine on its
    directory replays exactly the unfinished requests (their journaled
    tokens a prefix of the final output), and the union of the pre-kill
    and recovered deliveries holds each request once at full length. The
    recovered engine passes the serving launch gates. Recorded: where
    each recovered request first differs from an uninterrupted run (bf16
    re-prefill and decode round apart on the card), the replay's wall
    from engine build to the first recovered token, the journal's bytes
    per generated token and fsyncs, and in-process tokens/s with the
    journal on and off (best of 3)."""
    import shutil
    import signal
    import tempfile

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**SERVING_CFG)
    L = cfg.num_hidden_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    jdir = os.path.join(tmp, "killed")
    out_path = os.path.join(tmp, "killed.jsonl")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--journal-worker",
         jdir, out_path, str(JOURNAL_KILL_AT)],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == -signal.SIGKILL,
          f"journal: the worker exited {proc.returncode}, not by SIGKILL: "
          f"{proc.stderr[-2000:]}")
    with open(out_path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    killed = {}
    for rec in lines[1:]:
        check(rec["rid"] not in killed, f"journal: {rec['rid']} delivered "
              f"twice before the kill")
        killed[rec["rid"]] = rec

    model = LlamaForCausalLM(cfg, seed=0)
    check(_weights_digest(model) == lines[0]["weights"],
          "journal: the worker's weights differ from this process's")
    prompts = _journal_prompts(cfg)
    params = SamplingParams(max_new_tokens=JOURNAL_NEW_TOKENS)
    rids = [f"req-{i}" for i in range(len(prompts))]

    # the uninterrupted reference, on a fresh journal directory
    ref_engine = Engine(model, _journal_engine_config(
        os.path.join(tmp, "reference")))
    for rid, p in zip(rids, prompts):
        ref_engine.add_request(p, params, request_id=rid)
    ref = {}
    while ref_engine.has_unfinished():
        for o in ref_engine.step():
            ref[o.request_id] = o.token_ids
    del ref_engine

    # recovery: a fresh engine on the killed worker's directory
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    with host_dispatch_probe() as probe:
        t0 = time.perf_counter()
        engine = Engine(model, _journal_engine_config(jdir))
        report = dict(engine.journal.replay_report)
        journaled = {r.request_id: list(r.output_token_ids)
                     for r in engine.waiting}
        recovered, first_token_s = {}, None
        while engine.has_unfinished():
            for o in engine.step():
                check(o.request_id not in recovered,
                      f"journal: {o.request_id} recovered twice")
                recovered[o.request_id] = o
            if first_token_s is None and any(
                    r is not None and len(r.output_token_ids)
                    > len(journaled[r.request_id]) for r in engine.slots):
                torch.cuda.synchronize()
                first_token_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    unfinished = set(rids) - set(killed)
    check(set(journaled) == unfinished
          and report["unfinished"] == len(unfinished),
          f"journal: replay found {sorted(journaled)} for the unfinished "
          f"{sorted(unfinished)} ({report})")
    check(not set(killed) & set(recovered)
          and set(killed) | set(recovered) == set(rids),
          f"journal: delivered before the kill {sorted(killed)}, after "
          f"{sorted(recovered)}")
    for rid, o in recovered.items():
        check(o.token_ids[:len(journaled[rid])] == journaled[rid],
              f"journal: {rid}'s journaled tokens are not a prefix of its "
              f"output")
    final = {rid: (killed[rid]["tokens"] if rid in killed
                   else recovered[rid].token_ids) for rid in rids}
    check(all(len(t) == JOURNAL_NEW_TOKENS for t in final.values()),
          f"journal: lengths {[len(t) for t in final.values()]}")
    check(engine.block_manager.num_used == 0,
          "journal: the recovered engine leaked KV blocks")
    m = engine.metrics
    _serving_gates("journal recovery", counts, m, probe, L,
                   "paged_attention", "float", True,
                   engine.config.prefill_buckets, 1)
    check(engine.journal.open_requests() == set(),
          "journal: requests left open after the recovered drain")
    diverge = {rid: next((i for i, (a, b) in enumerate(zip(final[rid],
                                                          ref[rid]))
                          if a != b), None) for rid in rids}
    result = {
        "killed_at_decode_tokens": JOURNAL_KILL_AT,
        "delivered_before_kill": sorted(killed),
        "replay_report": report,
        "journaled_tokens": {rid: len(t) for rid, t in journaled.items()},
        "replay_to_first_token_ms": first_token_s * 1e3,
        "first_divergence": diverge,
        "launches": counts, "graph_replays": probe["replays"],
    }
    log(f"[journal] worker SIGKILLed after {JOURNAL_KILL_AT} decoded "
        f"tokens; replay found {report['unfinished']} unfinished "
        f"(journaled tokens {result['journaled_tokens']}), recovered "
        f"exactly once; engine build to first recovered token "
        f"{first_token_s * 1e3:.1f} ms; first divergence from the "
        f"uninterrupted run {diverge}")
    del engine

    # in-process serving with the journal on and off, best of 3 in turns
    wl_prompts, wl_params = _serving_workload(cfg)
    engines = {"off": Engine(model, _journal_engine_config()),
               "on": Engine(model, _journal_engine_config(
                   os.path.join(tmp, "serving")))}
    warm = [SamplingParams(**dict(p.to_dict(), max_new_tokens=2))
            for p in wl_params]
    for e in engines.values():
        # builds every program the timed runs replay
        e.generate(wl_prompts, warm)
    j = engines["on"].journal
    rates = {"off": [], "on": []}
    for kind in ("on", "off", "off", "on", "on", "off"):
        before = (j.bytes_written, j.fsyncs, j.writes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engines[kind].generate(wl_prompts, wl_params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = sum(len(o.token_ids) for o in outs)
        rates[kind].append(n / dt)
        if kind == "on":
            result["journal_bytes_per_token"] = (j.bytes_written
                                                 - before[0]) / n
            result["journal_fsyncs_per_run"] = j.fsyncs - before[1]
            result["journal_writes_per_run"] = j.writes - before[2]
            result["generated_tokens_per_run"] = n
    result.update(
        tokens_per_s_journal_on=max(rates["on"]),
        tokens_per_s_journal_off=max(rates["off"]),
        tokens_per_s_runs=rates,
        journal_overhead=1 - max(rates["on"]) / max(rates["off"]))
    log(f"[journal] in-process serving, best of {JOURNAL_RUNS}: journal on "
        f"{result['tokens_per_s_journal_on']:.1f} tokens/s, off "
        f"{result['tokens_per_s_journal_off']:.1f} (overhead "
        f"{result['journal_overhead'] * 100:.2f} %); "
        f"{result['journal_bytes_per_token']:.1f} journal bytes per token, "
        f"{result['journal_fsyncs_per_run']} fsyncs and "
        f"{result['journal_writes_per_run']} writes per run")
    del engines, model
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------- poison isolation, fleet
# the poison phase: the serving cell's first 8 prompts, greedy, this many
# new tokens; the fault is armed after POISON_AT_STEP steps
POISON_NEW_TOKENS = 48
POISON_AT_STEP = 6
POISON_VICTIM = 3
# the fleet phase: replica r0 dies once it has decoded this many tokens
FLEET_KILL_AFTER = 200
FLEET_RUNS = 2
# a prompt of a prefill bucket no replica has used (the serving cell's
# prompts take buckets up to 128): the survivor captures its program
FLEET_LONG_PROMPT = 300
FLEET_HTTP_REQUESTS = 8


def _serving_model(torch, tag):
    """The serving cell's model (``SERVING_CFG``, seeded bf16 weights)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(LlamaConfig(**SERVING_CFG), seed=0)
    torch.cuda.synchronize()
    log(f"[{tag}] model: {model.num_params() / 1e6:.1f}M params bf16, "
        f"built in {time.perf_counter() - t0:.1f}s")
    return model


def _serving_geometry(**kw):
    from paddle_tpu_torch.serving import EngineConfig

    return EngineConfig(**dict(dict(max_batch_slots=8, max_model_len=512,
                                    page_size=16), **kw))


def _poisoned_run(torch, engine, prompts, params, phase, attributed=False,
                  victim=POISON_VICTIM):
    """Serve ``prompts`` on ``engine`` with a ``serving.step`` fault at
    ``phase`` on request ``victim``, armed after ``POISON_AT_STEP`` steps
    (a prefill fault from the start) and held until it fires: every
    launch of that phase holding the victim fails (unattributed: the
    bisection must find it) or one does, naming it (``attributed``).
    Returns the outputs in order, the launch sizes the fault saw, and the
    poisoned step's successful launches (metric deltas) and replays."""
    from paddle_tpu_torch.resilience import FaultSpec, faults

    reqs = [engine.add_request(p, sp) for p, sp in zip(prompts, params)]
    rid = reqs[victim].request_id
    armed, sizes, out = [phase == "prefill"], [], {}

    def when(c):
        if not armed[0] or c.get("phase") != phase:
            return False
        if phase == "prefill":
            return c.get("request_id") == rid
        if rid not in c.get("request_ids", ()):
            return False
        sizes.append(len(c["request_ids"]))
        return True

    def name_the_victim(_ctx):
        e = RuntimeError("adapter swap failed")
        e.request_id = rid
        raise e

    spec = FaultSpec(RuntimeError("poisoned logits"), when=when,
                     action=name_the_victim if attributed else None)
    m = engine.metrics
    step = {}
    steps = 0
    with faults.inject({"serving.step": spec}) as inj:
        while engine.has_unfinished():
            if steps == POISON_AT_STEP:
                armed[0] = True
            before = (m.decode_steps, m.verify_steps, m.prefill_steps,
                      m.decode_compiles, m.verify_compiles)
            fired = inj.fired.get("serving.step", 0)
            with host_dispatch_probe() as probe:
                for o in engine.step():
                    check(o.request_id not in out,
                          f"poison: {o.request_id} delivered twice")
                    out[o.request_id] = o
            steps += 1
            check(steps < 2000, "poison: the engine did not drain")
            if inj.fired.get("serving.step", 0) > fired and not step:
                after = (m.decode_steps, m.verify_steps, m.prefill_steps,
                         m.decode_compiles, m.verify_compiles)
                step = dict(zip(("decode", "verify", "prefill",
                                 "decode_programs", "verify_programs"),
                                (a - b for a, b in zip(after, before))),
                            replays=probe["replays"],
                            direct=probe["direct"])
                armed[0] = phase == "prefill"
    torch.cuda.synchronize()
    return [out[r.request_id] for r in reqs], sizes, step


_STEP_FIELDS = ("decode_steps", "prefill_steps", "prefill_chunks",
                "verify_steps", "cow_copies")
_PROGRAM_FIELDS = ("decode_compiles", "prefill_compiles",
                   "prefill_ext_compiles", "cow_compiles", "verify_compiles")


def _check_survivors(tag, outs, ref, victim=POISON_VICTIM):
    for i, (o, r) in enumerate(zip(outs, ref)):
        if i == victim:
            check(o.finish_reason == "error",
                  f"{tag}: the poison request finished "
                  f"{o.finish_reason!r}, not 'error'")
            continue
        check(o.finish_reason == "length" and o.token_ids == r.token_ids,
              f"{tag}: request {i} differs from the uninjected run on the "
              f"same engine ({o.finish_reason}, first tokens "
              f"{o.token_ids[:4]} vs {r.token_ids[:4]})")


def phase_poison(torch):
    """Poison isolation on the serving cell's model and geometry (bf16
    pool): an unattributed decode fault bisected out in 3 replays of the
    captured decode program (8 -> 4 -> 2 -> 1, no new capture), an
    attributed one in one launch, a prefill fault, a verify fault on the
    serving_spec engine, and a device fault that re-raises with no
    launch; the survivors token-identical to an uninjected run on the
    same engine."""
    import shutil
    import tempfile

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.resilience import FaultSpec, faults
    from paddle_tpu_torch.serving import Engine, SamplingParams

    model = _serving_model(torch, "poison")
    cfg = model.config
    L = cfg.num_hidden_layers
    # the postmortems the faults dump
    flight_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    os.environ["PADDLE_TPU_FLIGHT_DIR"] = flight_dir
    prompts = _serving_workload(cfg)[0][:8]
    params = [SamplingParams(max_new_tokens=POISON_NEW_TOKENS)] * 8
    engine = Engine(model, _serving_geometry())
    ref = engine.generate(prompts, params)
    result = {}

    # 1. unattributed decode fault: bisected over the same program
    m = engine.metrics
    steps0 = {f: getattr(m, f) for f in _STEP_FIELDS}
    _build.reset_launch_counts()
    with host_dispatch_probe() as run_probe:
        outs, sizes, step = _poisoned_run(torch, engine, prompts, params,
                                          "decode")
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    _check_survivors("poison decode", outs, ref)
    # the run's launches as in serving: steps counted over this run,
    # programs over the engine's life
    _serving_gates("poison", counts, type("Run", (), dict(
        {f: getattr(m, f) for f in _PROGRAM_FIELDS},
        **{f: getattr(m, f) - steps0[f] for f in _STEP_FIELDS})),
        run_probe, L, "paged_attention", "float", True,
        engine.config.prefill_buckets, m.decode_compiles)
    check(sizes == [8, 4, 2, 1] and step["decode"] == 3
          and step["replays"] == 3 and step["direct"] == 0
          and step["decode_programs"] == 0,
          f"poison decode: failing launch sizes {sizes}, the step's "
          f"successful launches / replays {step} (want [8, 4, 2, 1], 3 "
          f"replays, no new program)")
    h = engine.health()
    check(engine.block_manager.num_used == 0 and m.requests_errored == 1
          and h["status"] == "degraded" and h["requests_errored"] == 1
          and "poisoned logits" in h["last_error"],
          f"poison decode: {engine.block_manager.num_used} blocks left, "
          f"health {h['status']}, errored {m.requests_errored}, "
          f"{h['last_error']}")
    result["decode"] = {"fault_launch_sizes": sizes, "poisoned_step": step,
                        "errored_tokens": len(outs[POISON_VICTIM].token_ids),
                        "launches": counts}
    log(f"[poison] decode: launches of sizes {sizes} failed, the poisoned "
        f"step made {step['replays']} replays of the captured program and "
        f"built none; 7 survivors token-identical, request 3 'error' after "
        f"{len(outs[POISON_VICTIM].token_ids)} tokens; health "
        f"{h['status']}")

    # 2. attributed: one launch, no bisection
    outs, sizes, step = _poisoned_run(torch, engine, prompts, params,
                                      "decode", attributed=True)
    _check_survivors("poison attributed", outs, ref)
    check(sizes == [8] and step["decode"] == 1 and step["replays"] == 1,
          f"poison attributed: launch sizes {sizes}, step {step} (want one "
          f"failed launch of 8 and one replay of the other 7)")
    result["attributed"] = {"fault_launch_sizes": sizes,
                            "poisoned_step": step}

    # 3. prefill: only its own request
    outs, _, step = _poisoned_run(torch, engine, prompts, params, "prefill")
    _check_survivors("poison prefill", outs, ref)
    check(outs[POISON_VICTIM].token_ids == [] and step["prefill"] == 7,
          f"poison prefill: the victim has {outs[POISON_VICTIM].token_ids}, "
          f"{step['prefill']} prefills ran in its step")
    result["prefill"] = {"poisoned_step": step}
    check(engine.block_manager.num_used == 0
          and m.requests_errored == 3,
          f"poison: {engine.block_manager.num_used} blocks left, "
          f"{m.requests_errored} errored after three faults")

    # 4. the verify launch of the serving_spec engine
    rng = np.random.RandomState(3)
    spec_prompts = [[int(t)] * SPEC_PROMPT_COPIES
                    for t in rng.randint(1, cfg.vocab_size, 8)]
    spec_engine = Engine(model, _serving_geometry(speculate_tokens=SPEC_K))
    spec_ref = spec_engine.generate(spec_prompts, params)
    outs, sizes, step = _poisoned_run(torch, spec_engine, spec_prompts,
                                      params, "verify")
    _check_survivors("poison verify", outs, spec_ref)
    check(sizes == [8, 4, 2, 1] and step["verify"] == 3
          and step["replays"] == 3 and step["verify_programs"] == 0
          and spec_engine.block_manager.num_used == 0
          and spec_engine.metrics.requests_errored == 1,
          f"poison verify: launch sizes {sizes}, step {step}, "
          f"{spec_engine.block_manager.num_used} blocks left")
    result["verify"] = {"fault_launch_sizes": sizes, "poisoned_step": step}
    log(f"[poison] verify: sizes {sizes}, {step['replays']} replays of the "
        f"verify program; attributed decode: one failed launch, "
        f"{result['attributed']['poisoned_step']['replays']} replay; "
        f"prefill: the victim alone")

    # 5. a device fault re-raises at once: no launch, no bisection
    reqs = [engine.add_request(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(2):
        engine.step()
    tried = []

    def device_fault(ctx):
        tried.append(len(ctx["request_ids"]))
        raise torch.AcceleratorError("CUDA error: injected device fault")

    spec = FaultSpec(action=device_fault,
                     when=lambda c: c.get("phase") == "decode")
    before = (m.decode_steps, m.requests_errored)
    raised = None
    with faults.inject({"serving.step": spec}), \
            host_dispatch_probe() as probe:
        try:
            engine.step()
        except torch.AcceleratorError as e:
            raised = e
    check(raised is not None and tried == [8] and probe["replays"] == 0
          and (m.decode_steps, m.requests_errored) == before,
          f"poison device fault: raised {raised!r}, launches tried "
          f"{tried}, {probe['replays']} replays, errored "
          f"{m.requests_errored - before[1]}")
    for r in reqs:
        engine.abort(r.request_id)
    while engine.has_unfinished():
        engine.step()
    check(engine.block_manager.num_used == 0,
          "poison: blocks left after the device-fault case")
    result["device_fault"] = {"launches_tried": tried,
                              "replays": probe["replays"]}
    log("[poison] device fault: re-raised after one attempt, no replay, "
        "nothing poisoned")
    result["launches"] = counts
    del engine, spec_engine, model
    shutil.rmtree(flight_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _fleet_rate(torch, model, prompts, params):
    """The serving cell's requests at t = 0 through a 2-replica fleet, one
    16-slot engine and one 8-slot engine, ``FLEET_RUNS`` times each: the
    fleet's launch gates, its greedy tokens against the 8-slot engine's,
    tokens/s and mean TTFT (best run) per backend."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import Engine, Fleet, FleetConfig

    L = model.config.num_hidden_layers
    out, tokens, fleet_counts = {}, {}, None
    for kind in ("fleet", "engine16", "engine8"):
        if kind == "fleet":
            backend = Fleet(model, _serving_geometry(),
                            FleetConfig(num_replicas=2))
            engines = [s.engine for s in backend.replicas]
        else:
            backend = Engine(model, _serving_geometry(
                max_batch_slots=16 if kind == "engine16" else 8))
            engines = [backend]
        runs = []
        _build.reset_launch_counts()
        with host_dispatch_probe() as probe:
            for _ in range(FLEET_RUNS):
                served = [e.metrics.requests_finished for e in engines]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = backend.generate(prompts, params)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                n = sum(len(o.token_ids) for o in outs)
                runs.append({
                    "seconds": dt, "generated_tokens": n,
                    "tokens_per_s": n / dt,
                    "mean_ttft_s": float(np.mean(
                        [o.time_to_first_token for o in outs])),
                    "requests_per_replica": [
                        e.metrics.requests_finished - s
                        for e, s in zip(engines, served)]})
                check(all(o.finish_reason == "length"
                          and len(o.token_ids) == sp.max_new_tokens
                          for o, sp in zip(outs, params)),
                      f"fleet rate ({kind}): a request did not finish at "
                      f"full length")
                greedy = [o.token_ids for o, sp in zip(outs, params)
                          if not sp.do_sample]
                check(tokens.setdefault(kind, greedy) == greedy,
                      f"fleet rate ({kind}): greedy tokens differ between "
                      f"runs")
        check(all(e.block_manager.num_used == 0 for e in engines),
              f"fleet rate ({kind}): KV blocks left")
        if kind == "fleet":
            counts = dict(_build.launch_counts(), **_build.variant_counts())
            summed = type("Summed", (), {
                f: sum(getattr(e.metrics, f) for e in engines)
                for f in _STEP_FIELDS + _PROGRAM_FIELDS})
            check(all(e.metrics.decode_compiles <= 2 for e in engines),
                  "fleet: more than two decode programs on a replica")
            _serving_gates("fleet", counts, summed, probe, L,
                           "paged_attention", "float", True,
                           _serving_geometry().prefill_buckets * 2,
                           summed.decode_compiles)
            fleet_counts = counts
        best = max(runs, key=lambda r: r["tokens_per_s"])
        out[kind] = dict(best, runs=runs)
        log(f"[fleet] {kind}: best of {FLEET_RUNS} "
            f"{best['tokens_per_s']:.1f} tokens/s, mean TTFT "
            f"{best['mean_ttft_s'] * 1e3:.1f} ms, requests per replica "
            f"{best['requests_per_replica']} (runs: "
            + ", ".join(f"{r['tokens_per_s']:.1f}" for r in runs) + ")")
        del backend, engines
        gc.collect()
    check(tokens["fleet"] == tokens["engine8"],
          "fleet: greedy tokens differ from the 8-slot engine's")
    out["greedy_equal_to_engine8"] = True
    out["greedy_equal_engine16_to_engine8"] = (
        tokens["engine16"] == tokens["engine8"])
    out["fleet_vs_engine16"] = (out["fleet"]["tokens_per_s"]
                                / out["engine16"]["tokens_per_s"])
    out["fleet_vs_engine8"] = (out["fleet"]["tokens_per_s"]
                               / out["engine8"]["tokens_per_s"])
    return out, fleet_counts, tokens["engine8"]


def _first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _fleet_failover(torch, model, prompts, params, ref_greedy):
    """Kill r0 once it has decoded ``FLEET_KILL_AFTER`` tokens; its
    restart's engine build is held until the survivor captures a prefill
    bucket it has not used (a long prompt sent at the death), inside that
    capture, so the two meet at the capture lock. Every request delivered
    once at full length, the restart adopted and serving a later
    request."""
    import threading

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.resilience import FaultSpec, faults
    from paddle_tpu_torch.serving import Fleet, FleetConfig, SamplingParams

    fleet = Fleet(model, _serving_geometry(), FleetConfig(num_replicas=2))
    r0, r1 = fleet.replicas
    survivor = r1.engine
    state = {"armed": False, "bucket": None, "failed_over": []}
    times, capturing = {}, threading.Event()

    real_prefill_program = survivor._prefill_program

    def prefill_program(bucket):
        if (state["armed"] and state["bucket"] is None
                and bucket not in survivor._prefill_programs):
            state["bucket"] = bucket
        return real_prefill_program(bucket)

    survivor._prefill_program = prefill_program
    record = _build.record_launches

    def recorded(fn):
        if (state["bucket"] is None or capturing.is_set()
                or fn.__name__ != "capture"):
            return record(fn)
        times["capture_start"] = time.perf_counter()
        capturing.set()
        # hold the capture open: the restart thread runs into the lock
        time.sleep(0.2)
        try:
            return record(fn)
        finally:
            times["capture_end"] = time.perf_counter()

    real_factory = r0._factory

    def factory():
        t0 = time.perf_counter()
        eng = real_factory()
        times["built"] = time.perf_counter()
        times["build_s"] = times["built"] - t0
        build = eng._program

        def timed(fn, generator):
            t1 = time.perf_counter()
            prog = build(fn, generator)
            times["capture_s"] = (times.get("capture_s", 0.0)
                                  + time.perf_counter() - t1)
            return prog

        eng._program = timed
        return eng

    r0._factory = factory

    def kill_when(c):
        if (c.get("phase") != "step" or c.get("replica") != "r0"
                or r0.engine is None
                or r0.engine.metrics.decode_tokens < FLEET_KILL_AFTER):
            return False
        eng = r0.engine
        state["failed_over"] = [r.request_id for r in list(eng.slots)
                                + list(eng.waiting) if r is not None]
        state["armed"] = True
        return True

    def restart_action(_ctx):
        times["restart_waits"] = time.perf_counter()
        times["overlap"] = capturing.wait(120)
        times["restart_go"] = time.perf_counter()

    specs = {"serving.replica": [
        FaultSpec(RuntimeError("replica r0 killed"), when=kill_when,
                  max_fires=1),
        FaultSpec(action=restart_action, max_fires=1,
                  when=lambda c: c.get("phase") == "restart")]}
    reqs = [fleet.add_request(p, sp) for p, sp in zip(prompts, params)]
    rng = np.random.RandomState(7)
    long_req, later, out = None, [], {}
    _build.record_launches = recorded
    try:
        with faults.inject(specs):
            t0 = time.perf_counter()
            while True:
                for o in fleet.step():
                    check(o.request_id not in out,
                          f"fleet failover: {o.request_id} delivered twice")
                    out[o.request_id] = o
                if fleet.metrics.failovers and long_req is None:
                    long_req = fleet.add_request(
                        rng.randint(1, model.config.vocab_size,
                                    FLEET_LONG_PROMPT).tolist(),
                        SamplingParams(max_new_tokens=16))
                if (r0.status == "healthy" and fleet.metrics.restarts
                        and not later):
                    later = [fleet.add_request(p, SamplingParams(
                        max_new_tokens=16)) for p in prompts[:4]]
                everything = reqs + ([long_req] if long_req else []) + later
                if (later and all(r.done for r in everything)
                        and not fleet.has_unfinished()):
                    break
                check(time.perf_counter() - t0 < 300,
                      f"fleet failover: not drained in 300 s (r0 "
                      f"{r0.status}, failovers {fleet.metrics.failovers})")
            torch.cuda.synchronize()
    finally:
        _build.record_launches = record
    m = fleet.metrics
    check(m.failovers == 1 and m.failover_requests == len(
        state["failed_over"]) > 0,
        f"fleet failover: {m.failovers} failovers, "
        f"{m.failover_requests} requests failed over")
    for r in everything:
        o = out.get(r.request_id)
        check(o is not None and o.finish_reason == "length"
              and len(o.token_ids) == r.sampling_params.max_new_tokens,
              f"fleet failover: {r.request_id} not delivered at full length "
              f"({o!r})")
    check(times.get("overlap") and times["restart_go"]
          < times["capture_end"] < times["built"],
          f"fleet failover: the restart did not meet the survivor's capture "
          f"of bucket {state['bucket']} ({times})")
    check(m.restarts == 1 and r0.status == "healthy"
          and r0.engine.metrics.requests_finished >= 1,
          f"fleet failover: restart adopted {m.restarts}, r0 {r0.status}, "
          f"served {r0.engine and r0.engine.metrics.requests_finished}")
    check(all(s.engine.block_manager.num_used == 0 for s in fleet.replicas),
          "fleet failover: KV blocks left")
    greedy = [(r, o) for r, sp in zip(reqs, params) if not sp.do_sample
              for o in (out[r.request_id],)]
    diverged = {r.request_id: _first_divergence(o.token_ids, want)
                for (r, o), want in zip(greedy, ref_greedy)}
    moved = [rid for rid in state["failed_over"] if rid in diverged]
    result = {
        "failovers": m.failovers, "failover_requests": m.failover_requests,
        "failover_recovery_s": m.failover_recovery_s,
        "restart_build_s": times["build_s"],
        "restart_lock_wait_s": times["capture_end"] - times["restart_go"],
        "restart_first_captures_s": times.get("capture_s", 0.0),
        "survivor_new_bucket": state["bucket"],
        "restarted_replica_served": r0.engine.metrics.requests_finished,
        "first_divergence_failed_over": {rid: diverged[rid]
                                         for rid in moved},
        "greedy_equal_not_failed_over": sum(
            diverged[rid] is None for rid in diverged if rid not in moved),
        "greedy_not_failed_over": sum(rid not in moved for rid in diverged),
    }
    log(f"[fleet] failover: r0 killed after {FLEET_KILL_AFTER} decoded "
        f"tokens, {m.failover_requests} requests failed over, every request "
        f"delivered once at full length; failover_recovery_s "
        f"{m.failover_recovery_s:.4f}; the restart waited "
        f"{result['restart_lock_wait_s']:.3f} s at the capture lock while "
        f"r1 captured bucket {state['bucket']}, built in "
        f"{times['build_s']:.3f} s with the wait, first captures "
        f"{result['restart_first_captures_s']:.3f} s; adopted, served "
        f"{result['restarted_replica_served']} later requests; first "
        f"divergence of the failed-over greedy requests "
        f"{result['first_divergence_failed_over']}")
    return fleet, result


def _fleet_device_fault(torch, fleet, prompts):
    """A device fault from a replica step re-raises from ``Fleet.step``:
    no failover, no restart."""
    from paddle_tpu_torch.resilience import FaultSpec, faults
    from paddle_tpu_torch.serving import SamplingParams

    reqs = [fleet.add_request(p, SamplingParams(max_new_tokens=8))
            for p in prompts[:4]]
    fleet.step()
    before = (fleet.metrics.failovers, [s.restarts for s in fleet.replicas],
              [s._restart_thread for s in fleet.replicas])

    def device_fault(_ctx):
        raise torch.AcceleratorError("CUDA error: injected device fault")

    spec = FaultSpec(action=device_fault, max_fires=1,
                     when=lambda c: (c.get("phase") == "step"
                                     and c.get("replica") == "r1"))
    raised = None
    with faults.inject({"serving.replica": spec}):
        try:
            fleet.step()
        except torch.AcceleratorError as e:
            raised = e
    after = (fleet.metrics.failovers, [s.restarts for s in fleet.replicas],
             [s._restart_thread for s in fleet.replicas])
    check(raised is not None and after == before
          and all(s.status == "healthy" for s in fleet.replicas),
          f"fleet device fault: raised {raised!r}, failovers/restarts "
          f"{before} -> {after}")
    for r in reqs:
        fleet.abort(r.request_id)
    while fleet.has_unfinished():
        fleet.step()
    check(all(s.engine.block_manager.num_used == 0 for s in fleet.replicas),
          "fleet device fault: KV blocks left")
    log("[fleet] device fault: Fleet.step re-raised it, no failover, no "
        "restart")
    return {"reraised": True}


def _fleet_warm_routing(torch, model):
    """The serving_prefix geometry behind a 2-replica fleet: one request
    of 16 sharing a 192-token system prompt warms a replica, then all 16:
    the warm replica's prefix cache serves them (hit tokens), its chunks
    launching the continuation kernel."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import Fleet, FleetConfig, SamplingParams

    cfg = model.config
    ecfg = _serving_geometry(enable_prefix_cache=True,
                             prefill_chunk_tokens=PREFIX_CHUNK)
    rng = np.random.RandomState(5)
    system = rng.randint(1, cfg.vocab_size, PREFIX_SYSTEM_TOKENS).tolist()
    prompts = [system + rng.randint(1, cfg.vocab_size,
                                    int(rng.randint(8, 128))).tolist()
               for _ in range(16)]
    params = SamplingParams(max_new_tokens=32)
    fleet = Fleet(model, ecfg, FleetConfig(num_replicas=2))
    fleet.generate(prompts[:1], params)
    warm = next(s for s in fleet.replicas
                if s.engine.metrics.prefill_tokens > 0)
    hits0 = {s.name: s.engine.metrics.prefix_hit_tokens
             for s in fleet.replicas}
    served0 = {s.name: s.engine.metrics.requests_finished
               for s in fleet.replicas}
    _build.reset_launch_counts()
    with host_dispatch_probe() as probe:
        outs = fleet.generate(prompts, params)
        torch.cuda.synchronize()
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    hits = {s.name: s.engine.metrics.prefix_hit_tokens - hits0[s.name]
            for s in fleet.replicas}
    served = {s.name: s.engine.metrics.requests_finished - served0[s.name]
              for s in fleet.replicas}
    check(all(o.finish_reason == "length" for o in outs)
          and hits[warm.name] > 0 and fleet.metrics.route_prefix_hits >= 1
          and counts["paged_prefill"] > 0 and probe["direct"] == 0
          and counts.get("paged_prefill/split", 0) == counts["paged_prefill"],
          f"fleet warm routing: hit tokens {hits} (warm {warm.name}), "
          f"prefix routes {fleet.metrics.route_prefix_hits}, launches "
          f"{counts}, {probe['direct']} outside a graph")
    check(all(s.engine.block_manager.num_used == len(s.engine.prefix_cache)
              for s in fleet.replicas), "fleet warm routing: blocks leaked")
    log(f"[fleet] warm routing: {warm.name} served pass 1; pass 2 hit "
        f"tokens {hits}, requests {served}, prefix-affinity routes "
        f"{fleet.metrics.route_prefix_hits}, paged_prefill launches "
        f"{counts['paged_prefill']}")
    result = {"warm_replica": warm.name, "hit_tokens": hits,
              "requests": served,
              "route_prefix_hits": fleet.metrics.route_prefix_hits}
    del fleet
    gc.collect()
    return result, counts


def _fleet_http(torch, model, prompts):
    """``FLEET_HTTP_REQUESTS`` requests over HTTP to a 2-replica fleet,
    two tenants, half SSE: each answered once with its tenant; /healthz
    lists both replicas."""
    import http.client
    import threading

    from paddle_tpu_torch.serving import Fleet, FleetConfig, Server
    from paddle_tpu_torch.serving.qos import QoSConfig, TenantPolicy

    fleet = Fleet(model, _serving_geometry(), FleetConfig(num_replicas=2))
    srv = Server(fleet, port=0, qos=QoSConfig(
        api_keys=SERVER_TENANTS,
        tenants={t: TenantPolicy(weight=w)
                 for t, w in SERVER_WEIGHTS.items()}))
    keys = sorted(SERVER_TENANTS)
    results = [None] * FLEET_HTTP_REQUESTS

    def go(i):
        key = keys[i % 2]
        stream = i % 4 >= 2
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=SERVER_TIMEOUT_S)
        try:
            conn.request("POST", "/v1/completions", body=json.dumps({
                "prompt": prompts[i], "max_tokens": 32,
                "stream": stream}).encode(), headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {key}"})
            resp = conn.getresponse()
            body = None
            if not stream:
                body = json.loads(resp.read())
            while stream:
                raw = resp.fp.readline()
                line = raw.strip()
                if not raw or line == b"data: [DONE]":
                    break
                if line.startswith(b"data: "):
                    body = json.loads(line[len(b"data: "):])
            results[i] = (resp.status, SERVER_TENANTS[key], body)
        finally:
            conn.close()

    try:
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(FLEET_HTTP_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SERVER_TIMEOUT_S)
        check(not any(t.is_alive() for t in threads),
              "fleet http: client threads still waiting")
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.close()
    for status, tenant, body in results:
        check(status == 200 and body["tenant"] == tenant
              and len(body["choices"][0]["token_ids"]) == 32,
              f"fleet http: answer {status} {body}")
    probe = health["providers"][f"serving.fleet.{fleet.fleet_id}"]
    check(probe["replicas"] == {"r0": "healthy", "r1": "healthy"}
          and fleet.metrics.requests_finished == FLEET_HTTP_REQUESTS
          and fleet.qos is srv.qos,
          f"fleet http: /healthz {probe}, "
          f"{fleet.metrics.requests_finished} finished")
    per = [s.engine.metrics.requests_finished for s in fleet.replicas]
    log(f"[fleet] http: {FLEET_HTTP_REQUESTS} requests, two tenants, each "
        f"answered once; per replica {per}; /healthz {probe['replicas']}")
    return {"requests": FLEET_HTTP_REQUESTS, "per_replica": per,
            "healthz_replicas": probe["replicas"]}


def phase_fleet(torch):
    """The self-healing fleet on the card: 2 replicas of the serving
    cell's model (8 slots each, bf16 pool) against one 16-slot and one
    8-slot engine; failover with a restart that meets a capture; a
    device fault; warm routing; the fleet behind the HTTP server."""
    import shutil
    import tempfile

    model = _serving_model(torch, "fleet")
    flight_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    os.environ["PADDLE_TPU_FLIGHT_DIR"] = flight_dir
    prompts, params = _serving_workload(model.config)
    result, counts, ref_greedy = _fleet_rate(torch, model, prompts, params)
    fleet, result["failover"] = _fleet_failover(torch, model, prompts,
                                                params, ref_greedy)
    result["device_fault"] = _fleet_device_fault(torch, fleet, prompts)
    del fleet
    gc.collect()
    result["warm_routing"], warm_counts = _fleet_warm_routing(torch, model)
    result["http"] = _fleet_http(torch, model, prompts)
    result["launches"] = {k: counts.get(k, 0) + warm_counts.get(k, 0)
                          for k in set(counts) | set(warm_counts)}
    r = result
    log(f"[fleet] 32 requests: fleet of 2 {r['fleet']['tokens_per_s']:.1f} "
        f"tokens/s ({r['fleet_vs_engine16']:.3f}x the 16-slot engine's "
        f"{r['engine16']['tokens_per_s']:.1f}, {r['fleet_vs_engine8']:.3f}x "
        f"the 8-slot engine's {r['engine8']['tokens_per_s']:.1f}); mean "
        f"TTFT {r['fleet']['mean_ttft_s'] * 1e3:.1f} / "
        f"{r['engine16']['mean_ttft_s'] * 1e3:.1f} / "
        f"{r['engine8']['mean_ttft_s'] * 1e3:.1f} ms")
    del model
    shutil.rmtree(flight_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------ spill tier, observatory
SPILL_BLOCKS = 96              # 144 MiB of bf16 pages at 1.5 MiB a page
SPILL_HOST_BYTES = 2 << 30
SPILL_FAULT_REQUESTS = 16
SPILL_DISK_REQUESTS = 8
SPILL_DISK_BLOCKS = 48
SPILL_OOM_BLOCKS = 60000       # ~94 GB of bf16 pages: more than the card
PREFIX_SPILL_CACHE_BLOCKS = 16
PREFIX_SPILL_POOL_BLOCKS = 512
HOST_LINK_BYTES_PER_S = 64e9   # PCIe Gen5 x16, per direction
STEPSTATS_RUNS = 3


def _ledger_holds(tag, engine):
    """The goodput ledger's two identities (exact)."""
    st, m = engine.stepstats, engine.metrics
    check(st.useful_tokens + st.wasted_preempt_tokens
          + st.wasted_migration_tokens + st.wasted_aborted_tokens
          == m.prefill_tokens + m.decode_tokens,
          f"{tag}: ledger {st.ledger()} does not add up to prefill "
          f"{m.prefill_tokens} + decode {m.decode_tokens}")
    check(st.wasted_spec_tokens == m.spec_proposed - m.spec_accepted,
          f"{tag}: spec_reject {st.wasted_spec_tokens} != proposed "
          f"{m.spec_proposed} - accepted {m.spec_accepted}")


def _timed_block_moves(engine):
    """Wrap the engine pool's ``read_blocks``/``write_blocks`` (each ends
    in its own sync) to record, per handle, the host wall ms and bytes.
    The queue is drained first (a sync the engine does not make), so the
    wall is the handle's own, not the launches queued before it."""
    import torch

    moves = {"read": [], "write": []}
    pool = engine.pool

    def timed(name, fn):
        def run(block_ids, payload_or_slab):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(block_ids, payload_or_slab)
            moves[name].append(((time.perf_counter() - t0) * 1e3,
                                len(block_ids) * pool.layout.nbytes))
            return out
        return run

    pool.read_blocks = timed("read", pool.read_blocks)
    pool.write_blocks = timed("write", pool.write_blocks)
    return moves


def _move_rates(moves):
    out = {}
    for name, rows in moves.items():
        if not rows:
            out[name] = None
            continue
        ms = [r[0] for r in rows]
        nbytes = sum(r[1] for r in rows)
        out[name] = {"handles": len(rows), "bytes": nbytes,
                     "ms": ms, "ms_mean": float(np.mean(ms)),
                     "ms_median": float(np.median(ms)),
                     "gb_per_s": nbytes / (sum(ms) / 1e3) / 1e9,
                     "link_share": nbytes / (sum(ms) / 1e3)
                     / HOST_LINK_BYTES_PER_S}
    return out


def _spill_serve(torch, tag, model, prompts, params, **kw):
    """One engine of the spill phase over the serving geometry + ``kw``:
    serves ``prompts``; returns (engine, outputs, seconds, counts, probe,
    decode kinds, block moves, programs built inside a restore)."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.serving import Engine

    gc.collect()
    engine = Engine(model, _serving_geometry(**kw))
    kinds, program = set(), engine._decode_program
    engine._decode_program = lambda any_sample: (
        kinds.add(any_sample), program(any_sample))[1]
    moves = _timed_block_moves(engine)
    in_restore, built = [False], [0]
    restore, build = engine._spill_restore, engine._program

    def restore_flagged(req, n):
        in_restore[0] = True
        try:
            return restore(req, n)
        finally:
            in_restore[0] = False

    def build_counted(fn, generator):
        built[0] += in_restore[0]
        return build(fn, generator)

    engine._spill_restore, engine._program = restore_flagged, build_counted
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    with host_dispatch_probe() as probe:
        t0 = time.perf_counter()
        outs = engine.generate(prompts, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    check(len(outs) == len(prompts) and all(
        o.finish_reason == "length"
        and len(o.token_ids) == p.max_new_tokens
        for o, p in zip(outs, params)),
        f"{tag}: not every request finished once at full length")
    check(engine.block_manager.num_used == 0,
          f"{tag}: {engine.block_manager.num_used} KV blocks leaked")
    _ledger_holds(tag, engine)
    return engine, outs, dt, counts, probe, kinds, moves, built[0]


def _compile_total(m):
    """Programs an engine has captured, all kinds."""
    return (m.prefill_compiles + m.prefill_ext_compiles + m.decode_compiles
            + m.verify_compiles + m.cow_compiles)


def _handle_bandwidth(torch, engine, n_blocks=24, reps=10):
    """A max-length handle (``n_blocks`` pages, what one request of the
    cell grows to) read off the pool into the slab and written back,
    ``reps`` times each after one warm-up: median host wall ms per handle
    (each call ends in its own sync) and GB/s."""
    pool, slab = engine.pool, engine.spill.slab
    ids = list(range(n_blocks))
    out = {}
    for name in ("read", "write"):
        times = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            payload = pool.read_blocks(ids, slab) if name == "write" else None
            t0 = time.perf_counter()
            if name == "read":
                payload = pool.read_blocks(ids, slab)
            else:
                pool.write_blocks(ids, payload)
            dt = time.perf_counter() - t0
            payload.release()
            if i:
                times.append(dt)
        ms = float(np.median(times)) * 1e3
        nbytes = n_blocks * pool.layout.nbytes
        out[name] = {"blocks": n_blocks, "bytes": nbytes, "ms_median": ms,
                     "gb_per_s": nbytes / ms / 1e6,
                     "link_share": nbytes / (ms / 1e3)
                     / HOST_LINK_BYTES_PER_S}
    return out


def _restore_bytes_equal(torch, engine):
    """Read four used-then-freed blocks of the engine's pool and write them
    into four others: pages (and the int8 pool's scales) equal bit for
    bit, on the card."""
    pool = engine.pool
    src, dst = [0, 5, 17, 40], [60, 61, 70, 90]
    payload = pool.read_blocks(src, engine.spill.slab)
    pool.write_blocks(dst, payload)
    payload.release()
    ok = True
    for entry in pool.k + pool.v:
        for t in (entry if isinstance(entry, tuple) else (entry,)):
            ok &= torch.equal(t[:, src], t[:, dst])
    torch.cuda.synchronize()
    return bool(ok)


def _spill_pool(torch, model, kv, prompts, params):
    """The spill cell over one pool type: the unconstrained engine (256
    blocks), the spill engine (96 blocks, a 2 GiB host tier) and its
    recompute twin (96 blocks, no tier). The gates read each engine's
    first pass; its tokens/s is the best of 3 warm passes of the same
    requests, the three engines in turns."""
    pool = "int8" if kv else "bf16"
    tag = f"spill_{pool}"
    greedy = [i for i, p in enumerate(params) if not p.do_sample]
    L = SERVING_CFG["num_hidden_layers"]
    paged = "paged_attention_quant" if kv else "paged_attention"
    runs, engines = {}, {}
    for name, kw in (("unconstrained", {}),
                     ("spill", dict(num_blocks=SPILL_BLOCKS,
                                    host_spill_bytes=SPILL_HOST_BYTES)),
                     ("recompute", dict(num_blocks=SPILL_BLOCKS))):
        engine, outs, dt, counts, probe, kinds, moves, built = _spill_serve(
            torch, f"{tag}/{name}", model, prompts, params,
            kv_cache_dtype=kv, **kw)
        m, st = engine.metrics, engine.stepstats
        _serving_gates(f"{tag}/{name}", counts, m, probe, L, paged,
                       "int8" if kv else "float", True,
                       engine.config.prefill_buckets, len(kinds))
        n_tokens = sum(len(o.token_ids) for o in outs)
        r = {"seconds": dt, "generated_tokens": n_tokens,
             "tokens_per_s": n_tokens / dt,
             "preemptions": m.preemptions, "ledger": st.ledger(),
             "prefill_tokens": m.prefill_tokens,
             "decode_steps": m.decode_steps,
             "prefill_steps": m.prefill_steps,
             "programs_built_in_restores": built,
             "tokens": [o.token_ids for o in outs], "launches": counts}
        if engine.spill is not None:
            s = engine.spill.stats()
            r["tier"] = {k: s[k] for k in (
                "spilled_blocks", "spilled_bytes", "restored_blocks",
                "restored_bytes", "restore_hits", "restore_misses",
                "restores", "spill_errors", "restore_errors",
                "host_evictions")}
            r["moves"] = _move_rates(moves)
            r["handle_bandwidth"] = _handle_bandwidth(torch, engine)
            r["restore_bytes_equal"] = _restore_bytes_equal(torch, engine)
        del engine.pool.read_blocks, engine.pool.write_blocks
        r["compiles"] = _compile_total(m)
        runs[name], engines[name] = r, engine
        del engine
    # the rates: the same requests again on each warm engine (the first
    # pass captured every program, and its gates stand), without the
    # move timers' syncs; best of 3, in turns
    warm = {name: [] for name in engines}
    for _ in range(3):
        for name, engine in engines.items():
            m = engine.metrics
            preempted = m.preemptions
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = engine.generate(prompts, params)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            bad = [i for i in greedy
                   if again[i].token_ids != runs[name]["tokens"][i]]
            check(not bad, f"{tag}/{name}: greedy requests {bad} differ "
                           f"between the first and a warm pass")
            warm[name].append(
                (sum(len(o.token_ids) for o in again) / dt,
                 m.preemptions - preempted))
    for name, engine in engines.items():
        r, m = runs[name], engine.metrics
        built = _compile_total(m) - r.pop("compiles")
        check(built == 0, f"{tag}/{name}: the warm passes built {built} "
                          f"programs")
        _ledger_holds(f"{tag}/{name}", engine)
        r.update(first_pass_seconds=r.pop("seconds"),
                 first_pass_tokens_per_s=r.pop("tokens_per_s"),
                 tokens_per_s=max(w[0] for w in warm[name]),
                 warm_tokens_per_s=[w[0] for w in warm[name]],
                 warm_pass_preemptions=[w[1] for w in warm[name]])
    engines.clear()
    ref, sp, twin = runs["unconstrained"], runs["spill"], runs["recompute"]
    check(sp["preemptions"] > 0 and twin["preemptions"] > 0,
          f"{tag}: no preemption ({sp['preemptions']}, "
          f"{twin['preemptions']}) in {SPILL_BLOCKS} blocks")
    check(sp["tier"]["restores"] > 0
          and sp["ledger"]["preempt_recompute"] == 0,
          f"{tag}: {sp['tier']['restores']} restores, "
          f"{sp['ledger']['preempt_recompute']} tokens recomputed")
    check(sp["programs_built_in_restores"] == 0,
          f"{tag}: a restore built {sp['programs_built_in_restores']} "
          f"programs")
    check(sp["restore_bytes_equal"],
          f"{tag}: a restored block differs from the block read")
    bad = [i for i in greedy if sp["tokens"][i] != ref["tokens"][i]]
    check(not bad, f"{tag}: spilled-and-restored greedy requests {bad} "
                   f"differ from the unconstrained engine's tokens")
    diverged = {i: _first_divergence(twin["tokens"][i], ref["tokens"][i])
                for i in greedy}
    result = {
        "blocks": SPILL_BLOCKS, "host_spill_bytes": SPILL_HOST_BYTES,
        "greedy_requests": len(greedy),
        "recompute_first_divergence": {
            str(i): d for i, d in diverged.items() if d is not None},
        "recompute_tokens": twin["ledger"]["preempt_recompute"],
        "launches": {},
    }
    ref_tokens = ref["tokens"]
    for name, r in runs.items():
        for key, n in r.pop("launches").items():
            result["launches"][key] = result["launches"].get(key, 0) + n
        r.pop("tokens")
        result[name] = r
    mv, bw = sp["moves"], sp["handle_bandwidth"]
    log(f"[{tag}] tokens/s, warm, best of 3: unconstrained "
        f"{ref['tokens_per_s']:.1f}, spill {sp['tokens_per_s']:.1f}, "
        f"recompute {twin['tokens_per_s']:.1f} (first pass, captures "
        f"included: {ref['first_pass_tokens_per_s']:.1f} / "
        f"{sp['first_pass_tokens_per_s']:.1f} / "
        f"{twin['first_pass_tokens_per_s']:.1f}; warm passes "
        f"{[round(x, 1) for x in ref['warm_tokens_per_s']]} / "
        f"{[round(x, 1) for x in sp['warm_tokens_per_s']]} / "
        f"{[round(x, 1) for x in twin['warm_tokens_per_s']]}; "
        f"warm-pass preemptions "
        f"{sp['warm_pass_preemptions']} / "
        f"{twin['warm_pass_preemptions']}); preemptions "
        f"{sp['preemptions']} / "
        f"{twin['preemptions']}; restores {sp['tier']['restores']}, spilled "
        f"{sp['tier']['spilled_bytes']['request']} B, restored "
        f"{sp['tier']['restored_bytes']['request']} B; recompute twin "
        f"recomputed {result['recompute_tokens']} tokens, "
        f"{len(result['recompute_first_divergence'])} of {len(greedy)} "
        f"greedy requests diverged (first tokens "
        f"{sorted(result['recompute_first_divergence'].values())})")
    log(f"[{tag}] per handle: spill {mv['read']['ms_mean']:.3f} ms "
        f"({mv['read']['gb_per_s']:.2f} GB/s), restore "
        f"{mv['write']['ms_mean']:.3f} ms ({mv['write']['gb_per_s']:.2f} "
        f"GB/s) against the host link's {HOST_LINK_BYTES_PER_S / 1e9:.0f} "
        f"GB/s a direction; a {bw['read']['blocks']}-page handle: spill "
        f"{bw['read']['ms_median']:.3f} ms ({bw['read']['gb_per_s']:.2f} "
        f"GB/s), restore {bw['write']['ms_median']:.3f} ms "
        f"({bw['write']['gb_per_s']:.2f} GB/s); every greedy request equal "
        f"to the unconstrained engine's")
    return result, ref_tokens


def _spill_faults(torch, model, prompts, params):
    """Injected ``kv.spill`` and ``kv.restore`` faults on every call:
    preemption degrades to recompute, warned once, no block leaked."""
    import warnings

    from paddle_tpu_torch.resilience import FaultSpec, faults

    out = {}
    for site in ("kv.spill", "kv.restore"):
        with faults.inject({site: FaultSpec(OSError("injected"), every=1)}), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            engine, outs, dt, _, _, _, _, _ = _spill_serve(
                torch, f"spill_faults/{site}", model, prompts, params,
                num_blocks=SPILL_BLOCKS, host_spill_bytes=256 << 20)
        s, m = engine.spill.stats(), engine.metrics
        errors = s["spill_errors" if site == "kv.spill" else "restore_errors"]
        warned = sum(site in str(w.message) for w in caught)
        check(m.preemptions > 0 and errors > 0 and warned == 1
              and engine.stepstats.wasted_preempt_tokens > 0,
              f"spill_faults/{site}: {m.preemptions} preemptions, {errors} "
              f"errors, warned {warned} times")
        out[site] = {"preemptions": m.preemptions, "errors": errors,
                     "recomputed_tokens":
                         engine.stepstats.wasted_preempt_tokens}
        del engine
    log(f"[spill] faults: {out}")
    return out


def _spill_disk(torch, model, prompts, params, ref_tokens):
    """The disk tier: a host budget of one byte sends every handle to
    ``spill_dir``; the preempted requests are served back from disk."""
    import shutil
    import tempfile

    sdir = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    try:
        engine, outs, dt, _, _, _, moves, _ = _spill_serve(
            torch, "spill_disk", model, prompts, params,
            num_blocks=SPILL_DISK_BLOCKS, host_spill_bytes=1,
            spill_dir=sdir)
        s = engine.spill.stats()
        check(s["disk_writes"] > 0 and s["disk_reads"] > 0
              and s["restored_blocks"]["request"] > 0,
              f"spill_disk: disk writes {s['disk_writes']}, reads "
              f"{s['disk_reads']}, restored {s['restored_blocks']}")
        bad = [i for i, (o, p) in enumerate(zip(outs, params))
               if not p.do_sample and o.token_ids != ref_tokens[i]]
        check(not bad, f"spill_disk: greedy requests {bad} differ from the "
                       f"unconstrained engine's tokens")
        r = {"preemptions": engine.metrics.preemptions,
             "disk_writes": s["disk_writes"], "disk_reads": s["disk_reads"],
             "restored_blocks": s["restored_blocks"]["request"],
             "seconds": dt, "moves": _move_rates(moves)}
        del engine
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    log(f"[spill] disk tier: {r}")
    return r


def _spill_oom(torch, model, prompts, params):
    """A pool larger than the card: ``EngineOverloadedError``, the device
    memory back at its level before the build, then the same process
    serves."""
    from paddle_tpu_torch.serving import Engine, EngineOverloadedError

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        Engine(model, _serving_geometry(num_blocks=SPILL_OOM_BLOCKS))
        raised = None
    except EngineOverloadedError as e:
        raised = str(e)
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    check(raised is not None and "num_blocks" in raised,
          f"spill_oom: a {SPILL_OOM_BLOCKS}-block pool was not refused")
    check(after == before, f"spill_oom: {after - before} bytes still "
                           f"allocated after the refused build")
    engine, outs, dt, _, _, _, _, _ = _spill_serve(
        torch, "spill_oom/after", model, prompts, params)
    del engine
    log(f"[spill] a {SPILL_OOM_BLOCKS}-block pool: EngineOverloadedError, "
        f"device memory back to {before} B allocated; the same process "
        f"then served {len(prompts)} requests")
    return {"num_blocks": SPILL_OOM_BLOCKS, "allocated_before": before,
            "allocated_after": after, "error": raised[:200]}


def _prefix_spill(torch, model):
    """Prefix-chain spill on the serving_prefix workload: an engine whose
    cache keeps 16 entries (chains evicted and demoted to a 2 GiB host
    tier) against one that never evicts; both 512 blocks. Restored chains
    hit, and the greedy tokens equal the never-evicted engine's."""
    from paddle_tpu_torch.serving import Engine, SamplingParams

    cfg = model.config
    rng = np.random.RandomState(0)
    system = rng.randint(1, cfg.vocab_size, PREFIX_SYSTEM_TOKENS).tolist()
    tails = [int(rng.randint(8, 128)) for _ in range(32)]
    prompts = [system + rng.randint(1, cfg.vocab_size, n).tolist()
               for n in tails]
    max_new = [int(rng.randint(32, 97)) for _ in range(32)]
    params = [SamplingParams(max_new_tokens=k, do_sample=True,
                             temperature=0.8, top_k=50, top_p=0.95)
              if i % 4 == 3 else SamplingParams(max_new_tokens=k)
              for i, k in enumerate(max_new)]
    greedy = [i for i, p in enumerate(params) if not p.do_sample]
    out = {}
    for name, kw in (("never_evicted", {}),
                     ("spill", dict(
                         prefix_cache_blocks=PREFIX_SPILL_CACHE_BLOCKS,
                         host_spill_bytes=SPILL_HOST_BYTES))):
        gc.collect()
        engine = Engine(model, _serving_geometry(
            num_blocks=PREFIX_SPILL_POOL_BLOCKS, enable_prefix_cache=True,
            prefill_chunk_tokens=PREFIX_CHUNK, **kw))
        passes = []
        for _ in range(2):
            t0 = time.perf_counter()
            outs = engine.generate(prompts, params)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            passes.append(([o.token_ids for o in outs], dt))
        m = engine.metrics
        r = {"prefix_evictions": m.prefix_evictions,
             "prefix_restores": m.prefix_restores,
             "prefix_hit_tokens": m.prefix_hit_tokens,
             "prefill_tokens": m.prefill_tokens,
             "tokens_per_s": [sum(len(t) for t in toks) / dt
                              for toks, dt in passes],
             "tokens": [toks for toks, _ in passes]}
        if engine.spill is not None:
            s = engine.spill.stats()
            r.update(spilled_blocks=s["spilled_blocks"]["prefix"],
                     restored_blocks=s["restored_blocks"]["prefix"])
        check(engine.block_manager.num_used
              == engine.prefix_cache.reclaimable_blocks(),
              f"prefix_spill/{name}: blocks held beyond the cache's")
        _ledger_holds(f"prefix_spill/{name}", engine)
        out[name] = r
        del engine
    ref, sp = out["never_evicted"], out["spill"]
    check(ref["prefix_evictions"] == 0,
          f"prefix_spill: the reference engine evicted "
          f"{ref['prefix_evictions']} entries")
    check(sp["prefix_restores"] > 0 and sp["restored_blocks"] > 0,
          f"prefix_spill: {sp['prefix_restores']} chain restores")
    for p in (0, 1):
        bad = [i for i in greedy
               if sp["tokens"][p][i] != ref["tokens"][p][i]]
        check(not bad, f"prefix_spill pass {p + 1}: greedy requests {bad} "
                       f"differ from the never-evicted engine's")
    for r in out.values():
        r.pop("tokens")
    log(f"[spill] prefix chains: {sp['prefix_evictions']} evictions, "
        f"{sp['spilled_blocks']} blocks spilled, {sp['prefix_restores']} "
        f"restored; hit tokens {sp['prefix_hit_tokens']} against the "
        f"never-evicted engine's {ref['prefix_hit_tokens']}; greedy tokens "
        f"equal in both passes")
    return out


def phase_spill(torch):
    """The host KV spill tier on the serving cell (see the docstring's
    5j): preemption under memory pressure over the bf16 and the int8
    pool, injected faults, the disk tier, prefix-chain spill and a
    pool-build OOM."""
    model = _serving_model(torch, "spill")
    prompts, params = _serving_workload(model.config)
    result = {"launches": {}}
    ref_tokens = None
    for kv in (None, "int8"):
        r, tokens = _spill_pool(torch, model, kv, prompts, params)
        for key, n in r["launches"].items():
            result["launches"][key] = result["launches"].get(key, 0) + n
        result["int8" if kv else "bf16"] = r
        ref_tokens = ref_tokens or tokens
    n = SPILL_FAULT_REQUESTS
    result["faults"] = _spill_faults(torch, model, prompts[:n], params[:n])
    n = SPILL_DISK_REQUESTS
    result["disk"] = _spill_disk(torch, model, prompts[:n], params[:n],
                                 ref_tokens)
    result["prefix"] = _prefix_spill(torch, model)
    # last: the refused pool empties the allocator's cache, and the next
    # allocations would pay cudaMalloc again inside the timed runs
    result["oom"] = _spill_oom(torch, model, prompts[:4], params[:4])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _observatory_profile(torch, model, n=10):
    """The replayed decode step (bf16 pool, 8 slots) with the observatory
    on and off under torch.profiler (``_profiled_steps``): kernels per
    step and the host's launch calls per step must be equal."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    out = {}
    for name, on in (("on", True), ("off", False)):
        engine = Engine(model, EngineConfig(
            max_batch_slots=8, max_model_len=512, page_size=16,
            stepstats=on))
        rng = np.random.RandomState(0)
        for _ in range(8):
            engine.add_request(rng.randint(1, 32000, 100).tolist(),
                               SamplingParams(max_new_tokens=200))
        for _ in range(30):
            engine.step()
        out[name] = _profiled_steps(
            torch, engine, n, f"observatory {name}, decode step (8 slots)",
            ("rope_kv_write", "paged_decode"))
        del engine
    on, off = out["on"], out["off"]
    check(on["kernels_per_step"] == off["kernels_per_step"]
          and on["host_launch_calls_per_step"]
          == off["host_launch_calls_per_step"],
          f"observatory: {on['kernels_per_step']} kernels and "
          f"{on['host_launch_calls_per_step']} launch calls a step on, "
          f"{off['kernels_per_step']} and "
          f"{off['host_launch_calls_per_step']} off")
    return out


def phase_stepstats(torch):
    """The step observatory on the serving cell: tokens/s with it on and
    off (best of 3, in turns), the replayed decode step's kernels and
    host launch calls on and off, the per-program walls, host overhead,
    goodput and MFU, the ledger identities on the serving_spec cell's
    traffic, and the flight dump's step samples and compile log."""
    import tempfile

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.observability import flight, jit_events
    from paddle_tpu_torch.serving import Engine, SamplingParams

    model = _serving_model(torch, "stepstats")
    prompts, params = _serving_workload(model.config)
    engines = {name: Engine(model, _serving_geometry(stepstats=on))
               for name, on in (("on", True), ("off", False))}
    for e in engines.values():        # capture every program first
        e.generate(prompts, params)
    rates = {name: [] for name in engines}
    on = engines["on"]
    _build.reset_launch_counts()
    for _ in range(STEPSTATS_RUNS):
        for name in ("on", "off"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = engines[name].generate(prompts, params)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rates[name].append(sum(len(o.token_ids) for o in outs) / dt)
            if name == "on":
                # MFU's window ends here: the off engine's run is idle
                # time for this one
                summary = on.stepstats.summary()
    launches = dict(_build.launch_counts(), **_build.variant_counts())
    check(engines["off"].stepstats is None
          and engines["off"].health()["stepstats"] is None,
          "stepstats: the engine built with stepstats=False samples")
    _ledger_holds("stepstats", on)
    check(summary["tokens"]["useful"] > 0 and summary["mfu"] is not None,
          f"stepstats: summary {summary}")
    result = {
        "tokens_per_s_on": max(rates["on"]),
        "tokens_per_s_off": max(rates["off"]),
        "runs_on": rates["on"], "runs_off": rates["off"],
        "on_vs_off": max(rates["on"]) / max(rates["off"]),
        "step_ms": summary["step_ms"],
        "goodput_fraction": summary["goodput_fraction"],
        "mfu": summary["mfu"], "peak": summary["peak_flops_per_chip"],
        "peak_source": summary["peak_source"],
        "flops_per_token": summary["flops_per_token"],
        "launches": launches,
    }
    del on
    engines.clear()
    # the speculative cell's traffic (K = 4): both identities
    spec = Engine(model, _serving_geometry(speculate_tokens=SPEC_K))
    rng = np.random.RandomState(3)
    spec.generate([[int(t)] * SPEC_PROMPT_COPIES
                   for t in rng.randint(1, 32000, 8)],
                  SamplingParams(max_new_tokens=496))
    _ledger_holds("stepstats/spec", spec)
    st = spec.stepstats
    check(spec.metrics.spec_proposed > 0,
          "stepstats/spec: no draft proposed")
    result["spec_ledger"] = st.ledger()
    result["spec_goodput_fraction"] = st.goodput_fraction()
    # the flight dump: step samples and every capture, no retrace
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flight_") as d:
        path = flight.dump("chip_smoke-stepstats",
                           path=os.path.join(d, "dump.json"))
        with open(path) as f:
            dump = json.load(f)
    mine = [s for s in dump["step_samples"]
            if s.get("engine") == spec.engine_id]
    captures = [ev for ev in dump["compile_log"]
                if ev["signature"].startswith(f"{spec.engine_id}:")]
    m = spec.metrics
    built = (m.prefill_compiles + m.prefill_ext_compiles + m.decode_compiles
             + m.verify_compiles + m.cow_compiles)
    retraces = jit_events.retraces_after_warmup()
    check(mine and len(captures) == built and retraces == 0
          and not any(ev["retrace"] for ev in dump["compile_log"]),
          f"stepstats: {len(mine)} step samples, {len(captures)} captures "
          f"logged for {built} programs, {retraces} retraces after warm-up")
    result["flight"] = {"step_samples": len(dump["step_samples"]),
                        "compile_events": len(dump["compile_log"]),
                        "spec_engine_captures": len(captures),
                        "retraces_after_warmup": retraces}
    del spec
    result["profile"] = _observatory_profile(torch, model)
    p = result["profile"]
    log(f"[stepstats] tokens/s on {result['tokens_per_s_on']:.1f}, off "
        f"{result['tokens_per_s_off']:.1f} (best of {STEPSTATS_RUNS}, "
        f"{result['on_vs_off']:.4f}x); decode step kernels "
        f"{p['on']['kernels_per_step']:.0f} / "
        f"{p['off']['kernels_per_step']:.0f}, launch calls "
        f"{p['on']['host_launch_calls_per_step']} / "
        f"{p['off']['host_launch_calls_per_step']} (on / off)")
    log(f"[stepstats] step ms by program: "
        + ", ".join(f"{k} p50 {v['p50']:.3f} (n {v['count']})"
                    for k, v in result["step_ms"].items())
        + f"; goodput {result['goodput_fraction']:.4f}, MFU "
        f"{result['mfu']:.4f} against {result['peak']:.3g} FLOP/s "
        f"({result['peak_source']}); spec cell ledger "
        f"{result['spec_ledger']}; flight {result['flight']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------- training
def _lm_loss(model, ids):
    return model(ids, labels=ids)[1]


@contextlib.contextmanager
def plain_attention(fa):
    """Inside: the flash ops run the plain forward and backward instead
    of the kernels (the comparison runs only): their bodies are
    swapped, so autograd still takes the backward op."""
    saved = fa._fwd_impl, fa._bwd_impl

    def fwd(q, k, v, causal, scale):
        return fa.flash_attention_ref(q, k, v, causal=causal, scale=scale)

    def bwd(q, k, v, out, lse, do, causal, scale):
        return fa.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                          causal=causal, scale=scale)

    fa._fwd_impl, fa._bwd_impl = fwd, bwd
    try:
        yield
    finally:
        fa._fwd_impl, fa._bwd_impl = saved


FLASH = ("flash_attention", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv")


@contextlib.contextmanager
def counted(module, name):
    """Inside: calls of ``module.<name>`` are counted into the yielded
    one-element list."""
    calls = [0]
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _flash_counts(counts):
    return {n: counts[n] for n in FLASH}


def phase_train_parity(torch):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    from paddle_tpu_torch.ops import scaled_dot_product_attention

    # attention that needs gradients returns a grad_fn on the card, and
    # its backward runs both backward kernels
    q, k, v = (torch.randn(2, 40, 4, 16, device="cuda", requires_grad=True)
               for _ in range(3))
    _build.reset_launch_counts()
    out = scaled_dot_product_attention(q, k, v, is_causal=True)
    check(out.grad_fn is not None, "sdpa on CUDA returned no grad_fn")
    out.sum().backward()
    counts = _flash_counts(_build.launch_counts())
    check(counts == {n: 1 for n in FLASH} and all(
        t.grad is not None and bool(t.grad.abs().sum() > 0)
        for t in (q, k, v)),
        f"sdpa backward on CUDA: launches {counts}, q/k/v gradients "
        f"{[t.grad is not None for t in (q, k, v)]}")

    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, 128, (4, 100))).to("cuda")
    result = {}
    # the tiny model (d 16: the f32 forward and backward on FMA) and one
    # of d 64 heads (both on 3xTF32)
    for kv, width in ((None, 64), (2, 64), (None, 256)):
        cfg = LlamaConfig.tiny(num_key_value_heads=kv, hidden_size=width,
                               intermediate_size=2 * width)
        d = width // cfg.num_attention_heads
        designs = {n: fa._fwd_variant(torch.float32, d, 100, 100)
                   if n == "flash_attention"
                   else fa._bwd_variant(torch.float32, d, 100, 100)
                   for n in FLASH}

        def run():
            model = LlamaForCausalLM(cfg, seed=0)
            opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                        parameters=model.parameters())
            step = TrainStep(model, _lm_loss, opt)
            return [step(ids).item() for _ in range(10)]

        _build.reset_launch_counts()
        kern = run()
        counts = _flash_counts(_build.launch_counts())
        variants = _build.variant_counts()
        with plain_attention(fa):
            plain = run()
        L = cfg.num_hidden_layers
        on_design = all(variants.get(f"{n}/{v}", 0) == 10 * L
                        for n, v in designs.items())
        check(counts == {n: 10 * L for n in FLASH} and on_design,
              f"train_parity: flash launches {counts} ({variants}), want "
              f"{10 * L} each on {designs}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(kern, plain))
        check(rel <= PARITY_LOSS_RTOL,
              f"train_parity kv_heads={kv}: losses {kern} vs plain {plain}"
              f" differ by {rel} > {PARITY_LOSS_RTOL} relative")
        key = f"d{d}_kv_heads={kv or cfg.num_attention_heads}"
        result[key] = {"losses": kern, "plain_losses": plain,
                       "max_rel_diff": rel, "designs": designs}
        log(f"[train_parity] {key}: 10 f32 steps, losses {kern[0]:.6f} -> "
            f"{kern[-1]:.6f}, max relative difference to plain attention "
            f"{rel:.3g}")
    return result


def _profiled_step(torch, step, ids, family=None):
    """Device time of one training step, all kernels, the flash ones by
    name and each family (``family``: a kernel's name -> its family),
    from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3

    def named(tag):
        return sum(e.self_device_time_total for e in kernels
                   if tag in e.key) / 1e3

    # kernel families by name (``family``; by default cuBLAS GEMMs, the
    # port's flash kernels, the optimizer's multi-tensor (foreach)
    # kernels, and everything else: casts, norms, RoPE, residual adds,
    # the loss, gradient sums)
    def default(key):
        if "nvjet" in key or "gemm" in key.lower() or "cutlass" in key:
            return "gemm"
        if "flash_" in key:
            return "flash"
        if "multi_tensor_apply" in key:
            return "foreach"
        return "other"

    family = family or default
    families = {}
    for e in kernels:
        f = family(e.key)
        families[f] = families.get(f, 0.0) + e.self_device_time_total / 1e3
    return {
        "device_ms": total, "families_ms": families,
        "flash_fwd_ms": named("flash_fwd"),
        "flash_bwd_dq_ms": named("flash_bwd_dq"),
        "flash_bwd_dkv_ms": named("flash_bwd_dkv"),
        "kernel_launches": sum(e.count for e in kernels),
        "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                for e in sorted(kernels,
                                key=lambda e: -e.self_device_time_total)[:12]],
    }


def phase_train(torch):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    # free what earlier phases left in reference cycles (the serving
    # engines), so the peak below is the training step's own
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, TRAIN_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    L = TRAIN_CFG["num_hidden_layers"]

    def build(**over):
        model = LlamaForCausalLM(LlamaConfig(**dict(TRAIN_CFG, **over)),
                                 seed=0)
        opt = AdamW(learning_rate=3e-4, weight_decay=0.1,
                    parameters=model.parameters(), multi_precision=True)
        return model, TrainStep(model, _lm_loss, opt)

    def run(step, n):
        _build.reset_launch_counts()
        losses = [step(ids) for _ in range(n)]
        torch.cuda.synchronize()
        return [x.item() for x in losses], _flash_counts(
            _build.launch_counts())

    t0 = time.perf_counter()
    model, step = build()
    torch.cuda.synchronize()
    n_params = model.num_params()
    log(f"[train] model: {n_params / 1e6:.1f}M params bf16, built in "
        f"{time.perf_counter() - t0:.1f}s; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens; {resident / 2**20:.0f} MiB allocated "
        f"before it")

    # first step's loss and gradients, flash kernels vs plain attention
    def loss_and_grads():
        for p in model.parameters():
            p.grad = None
        loss = _lm_loss(model, ids)
        loss.backward()
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    loss_k, g_k = loss_and_grads()
    with plain_attention(fa):
        loss_p, g_p = loss_and_grads()
    rel = {n: ((g_k[n] - g_p[n]).norm() / g_p[n].norm().clamp_min(1e-30)
               ).item() for n in g_p}
    del g_k, g_p
    worst = max(rel, key=rel.get)
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          f"train: first-step loss {loss_k} vs plain attention {loss_p}")
    check(all(np.isfinite(list(rel.values()))) and
          rel[worst] <= TRAIN_GRAD_RTOL,
          f"train: gradient of {worst} differs from plain attention by "
          f"{rel[worst]} (relative L2) > {TRAIN_GRAD_RTOL}")
    log(f"[train] first step, kernels vs plain attention: loss {loss_k:.5f}"
        f" vs {loss_p:.5f}; worst gradient relative L2 error "
        f"{rel[worst]:.3g} ({worst}), median "
        f"{float(np.median(list(rel.values()))):.3g}")

    # 1 first step + 3 warm-up + 10 timed, one launch count over all 14;
    # the wgmma dq kernel computes delta, so attention_delta never runs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with counted(fa, "attention_delta") as delta_calls:
        t0 = time.perf_counter()
        losses = [step(ids)]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        losses += [step(ids) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(ids) for _ in range(10)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 10 * 1e3
    counts = _flash_counts(_build.launch_counts())
    variant_counts = _build.variant_counts()
    check(delta_calls[0] == 0 and all(
        variant_counts.get(f"{n}/wgmma") == 14 * L for n in FLASH),
        f"train: attention_delta ran {delta_calls[0]} times, launches by "
        f"design {variant_counts}: want every flash launch on wgmma")
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(abs(losses[0] - loss_k) <= TRAIN_LOSS_TOL,
          f"train: TrainStep's first loss {losses[0]} != {loss_k}")
    check(counts == {n: 14 * L for n in FLASH},
          f"train: flash launches {counts} over 14 steps, want {L} of "
          f"each per step")
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    # bench.py's accounting: 6N per token plus causal attention
    flops_token = 6 * n_params + 12 * L * TRAIN_CFG["hidden_size"] * \
        TRAIN_SEQ * 0.5
    mfu = tokens_s * flops_token / BF16_FLOPS
    prof = _profiled_step(torch, step, ids)
    flash_ms = (prof["flash_fwd_ms"] + prof["flash_bwd_dq_ms"]
                + prof["flash_bwd_dkv_ms"])
    log(f"[train] first step {first_s:.2f}s; 10 steps: {step_ms:.2f} "
        f"ms/step, {tokens_s:.0f} tokens/s, MFU {mfu * 100:.2f}% of "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    # the profiler may see no device time; the share is then unknown
    prof["flash_share"] = (flash_ms / prof["device_ms"]
                           if prof["device_ms"] else None)
    log(f"[train] profiled step: device {prof['device_ms']:.2f} ms in "
        f"{prof['kernel_launches']} kernels; flash fwd "
        f"{prof['flash_fwd_ms']:.3f} ms, bwd dq "
        f"{prof['flash_bwd_dq_ms']:.3f} ms, bwd dk/dv "
        f"{prof['flash_bwd_dkv_ms']:.3f} ms (share of device time: "
        f"{prof['flash_share']})")
    log("[train] device ms by kernel family: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(prof["families_ms"].items())))
    for name, ms, n in prof["top"]:
        log(f"[train]   {name:80s} {ms:9.3f} ms {n:5d} calls")
    log(f"[train] launches over 14 steps {counts}")
    del step, model
    torch.cuda.empty_cache()

    # recompute: the same first two steps, the forward run twice
    model, step = build(recompute=True)
    torch.cuda.reset_peak_memory_stats()
    rc_losses, rc_counts = run(step, 2)
    want = {"flash_attention": 4 * L, "flash_attention_bwd_dq": 2 * L,
            "flash_attention_bwd_dkv": 2 * L}
    check(rc_counts == want,
          f"train recompute: launches {rc_counts}, want {want}")
    diff = max(abs(a - b) for a, b in zip(rc_losses, losses))
    check(diff <= TRAIN_LOSS_TOL,
          f"train recompute: losses {rc_losses} vs {losses[:2]}")
    rc_peak = torch.cuda.max_memory_allocated()
    log(f"[train] recompute: 2 steps, losses {rc_losses} (max difference "
        f"{diff:.3g}), launches {rc_counts}, peak memory "
        f"{rc_peak / 2**30:.2f} GiB")
    del step, model
    torch.cuda.empty_cache()

    # the plain loss head: full [b, s, vocab] logits and cross_entropy
    model, step = build(fused_loss_chunk=0)
    full_losses, full_counts = run(step, 1)
    check(full_counts == {n: L for n in FLASH},
          f"train fused_loss_chunk=0: launches {full_counts}")
    check(abs(full_losses[0] - losses[0]) <= TRAIN_LOSS_TOL,
          f"train fused_loss_chunk=0: loss {full_losses[0]} vs "
          f"{losses[0]}")
    log(f"[train] fused_loss_chunk=0: loss {full_losses[0]:.5f} vs "
        f"{losses[0]:.5f} fused")
    del step, model
    torch.cuda.empty_cache()
    return {
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "resident_bytes_before": resident,
        "first_step_s": first_s, "step_ms": step_ms,
        "tokens_per_s": tokens_s, "mfu": mfu, "peak_bytes": peak,
        "recompute_peak_bytes": rc_peak, "losses": losses,
        "launches": dict(counts, **variant_counts), "profile": prof,
        "grad_check": {"loss": loss_k, "plain_loss": loss_p,
                       "worst_rel_l2": rel[worst], "worst_param": worst,
                       "median_rel_l2": float(np.median(list(rel.values())))},
        "recompute_losses": rc_losses, "recompute_launches": rc_counts,
        "unfused_loss": full_losses[0],
    }


# ------------------------------------------------------- mixed precision
# train_amp: the pretraining cell through amp, in three modes; each runs
# 1 + 2 warm-up + 5 timed steps
AMP_MODES = {
    # name: (model dtype, decorate to, auto_cast level, AMP dtype,
    #        GradScaler initial scale or None)
    "o1_bf16": ("float32", None, "O1", "bfloat16", None),
    "o2_bf16": ("float32", "bfloat16", "O2", "bfloat16", None),
    "o2_f16": ("float32", "float16", "O2", "float16", 2.0 ** 16),
}
AMP_TIMED_STEPS = 5


def _amp_mode(torch, name, ids):
    """One amp mode of ``train_amp``: the model built in f32 (O2:
    ``amp.decorate``d), AdamW (masters under O2), the step under
    ``auto_cast`` (float16: through the ``GradScaler``). Returns the
    mode's record; raises ``PhaseError`` on a failed gate."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model_dtype, decorate_to, level, amp_dtype, init_scale = AMP_MODES[name]
    L = TRAIN_CFG["num_hidden_layers"]
    gc.collect()
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(LlamaConfig(**dict(TRAIN_CFG,
                                                dtype=model_dtype)), seed=0)
    opt = AdamW(learning_rate=3e-4, weight_decay=0.1,
                parameters=model.parameters(),
                multi_precision=decorate_to is not None)
    if decorate_to is not None:
        model, opt = amp.decorate(model, opt, level=level,
                                  dtype=decorate_to)
    scaler = (amp.GradScaler(init_loss_scaling=init_scale)
              if init_scale else None)
    n_params = model.num_params()

    def forward():
        with amp.auto_cast(True, level=level, dtype=amp_dtype):
            return _lm_loss(model, ids)

    # the first step's loss and gradients, kernels vs plain attention;
    # float16 backward runs on the scaled loss, as the scaler's steps do
    mult = init_scale or 1.0

    def loss_and_grads():
        for p in model.parameters():
            p.grad = None
        loss = forward()
        (loss * mult).backward()
        grads = {n: p.grad.float() / mult
                 for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    dmax = []
    real_bwd = fa.flash_attention_bwd

    def recording_bwd(q, k, v, out, lse, do, **kw):   # max |dO| per call
        dmax.append(do.detach().abs().amax().float())
        return real_bwd(q, k, v, out, lse, do, **kw)

    fa.flash_attention_bwd = recording_bwd
    try:
        loss_k, g_k = loss_and_grads()
        with plain_attention(fa):
            loss_p, g_p = loss_and_grads()
    finally:
        fa.flash_attention_bwd = real_bwd
    rel = {n: ((g_k[n] - g_p[n]).norm() / g_p[n].norm().clamp_min(1e-30)
               ).item() for n in g_p}
    del g_k, g_p
    worst = max(rel, key=rel.get)
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          f"train_amp {name}: first-step loss {loss_k} vs plain attention "
          f"{loss_p}")
    check(all(np.isfinite(list(rel.values()))) and
          rel[worst] <= TRAIN_GRAD_RTOL,
          f"train_amp {name}: gradient of {worst} differs from plain "
          f"attention by {rel[worst]} (relative L2) > {TRAIN_GRAD_RTOL}")

    def step():
        loss = forward()
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            skipped.append(scaler._found_inf)
            scaler.update()
            scales.append(scaler.get_scale_ratio())
        opt.clear_grad()
        return loss.detach()

    scales, skipped = [], []
    n_steps = 3 + AMP_TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    fa.flash_attention_bwd = recording_bwd
    try:
        losses = [step() for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step() for _ in range(AMP_TIMED_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / AMP_TIMED_STEPS * 1e3
    finally:
        fa.flash_attention_bwd = real_bwd
    peak = torch.cuda.max_memory_allocated()
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    losses = [x.item() for x in losses]
    want = n_steps * L
    for n in FLASH:
        check(counts[n] == want and counts.get(f"{n}/{amp_dtype}", 0) == want
              and counts.get(f"{n}/wgmma", 0) == want,
              f"train_amp {name}: {n} launches {counts[n]} ({amp_dtype}: "
              f"{counts.get(f'{n}/{amp_dtype}', 0)}, wgmma "
              f"{counts.get(f'{n}/wgmma', 0)}), want {want} = {n_steps} "
              f"steps x {L} layers on the {amp_dtype} instance")
    check(all(np.isfinite(losses)), f"train_amp {name}: non-finite loss "
          f"{losses}")
    check(losses[-1] < losses[0], f"train_amp {name}: loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    check(abs(losses[0] - loss_k) <= TRAIN_LOSS_TOL,
          f"train_amp {name}: the first step's loss {losses[0]} != "
          f"{loss_k}")
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    flops_token = 6 * n_params + 12 * L * TRAIN_CFG["hidden_size"] * \
        TRAIN_SEQ * 0.5
    rec = {
        "model_dtype": model_dtype, "decorate": decorate_to, "level": level,
        "amp_dtype": amp_dtype, "params": n_params, "step_ms": step_ms,
        "tokens_per_s": tokens_s,
        "mfu": tokens_s * flops_token / BF16_FLOPS, "peak_bytes": peak,
        "losses": losses, "steps": n_steps,
        "launches": counts,
        "grad_check": {"loss": loss_k, "plain_loss": loss_p,
                       "worst_rel_l2": rel[worst], "worst_param": worst,
                       "median_rel_l2": float(np.median(list(
                           rel.values())))},
        "max_abs_dout": max(float(x) for x in dmax),
    }
    if scaler is not None:
        rec.update(init_scale=init_scale, scales=scales,
                   skipped_steps=int(sum(skipped)))
    log(f"[train_amp] {name}: {step_ms:.2f} ms/step, {tokens_s:.0f} "
        f"tokens/s, MFU {rec['mfu'] * 100:.2f}%, peak "
        f"{peak / 2**30:.2f} GiB; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; first step vs plain attention: loss "
        f"{loss_k:.5f} / {loss_p:.5f}, worst gradient {rel[worst]:.3g} "
        f"({worst}); max |dO| {rec['max_abs_dout']:.4g}"
        + (f"; scales {scales}, skipped {rec['skipped_steps']}"
           if scaler is not None else "")
        + f"; flash launches on {amp_dtype}: "
        f"{[counts.get(f'{n}/{amp_dtype}', 0) for n in FLASH]}")
    del model, opt, scaler
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_amp(torch):
    """``train_amp``: the pretraining cell (12 layers, 12 x 1024 tokens a
    step, the fused loss) through ``amp``: O1 bf16 on an f32 model, O2
    bf16 via ``decorate`` with AdamW masters (the ``train`` phase's
    setup), O2 float16 with ``GradScaler(init_loss_scaling=2**16)``.
    Gates, each mode: flash launches = steps x L per kernel, on the AMP
    dtype's instance (the float16 ones in the third mode) and the wgmma
    design; the first step's loss within ``TRAIN_LOSS_TOL`` and every
    gradient within ``TRAIN_GRAD_RTOL`` (relative L2) of the same mode
    with plain attention; losses finite and falling. Recorded: step ms,
    tokens/s, MFU against 989e12, peak memory, max |dO| at the flash
    backward; float16: the scale after every step and the skipped
    steps."""
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, TRAIN_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    result = {"launches": {}}
    for name in AMP_MODES:
        result[name] = _amp_mode(torch, name, ids)
        for key, n in result[name]["launches"].items():
            result["launches"][key] = result["launches"].get(key, 0) + n
    result["o1_vs_o2_step_ms"] = (result["o1_bf16"]["step_ms"]
                                  / result["o2_bf16"]["step_ms"])
    log(f"[train_amp] O1 / O2 bf16 step time: "
        f"{result['o1_vs_o2_step_ms']:.3f}x (O1 casts every weight in "
        f"each op)")
    return result


# ------------------------------------------------------------------ DiT
# dit: the DiT cell (DIT_CFG, bench.py:402-442) through jit.TrainStep with
# AdamW(1e-4), in two modes: f32 (the bench's dtype; TF32 off, as every
# phase here) and amp O2 bf16 (amp.decorate, AdamW masters). Each runs
# 1 + 3 warm-up + 10 timed steps on bench.py's seeded batch.
DIT_MODES = {
    # name: (AMP dtype or None, peak FLOP/s, flash forward design, flash
    # backward design, launch dtype)
    "f32": (None, F32_FLOPS, "tf32x3", "tf32x3", "float32"),
    "o2_bf16": ("bfloat16", BF16_FLOPS, "wgmma", "wgmma", "bfloat16"),
}
DIT_TIMED_STEPS = 10
DIT_DROPOUT_P = 0.1
# the new optimizers' card update against the same update on the CPU:
# f32 weights and every accumulator (relative L2); LBFGS over a quadratic
DIT_OPT_RTOL = 1e-5
DIT_LBFGS_RTOL = 1e-4
DIT_OPTIMIZERS = (
    ("SGD", dict(learning_rate=1e-2)),
    ("Momentum", dict(learning_rate=1e-2, momentum=0.9, use_nesterov=True,
                      weight_decay=5e-4)),
    ("Adagrad", dict(learning_rate=1e-2)),
    ("Adadelta", dict(learning_rate=1.0)),
    ("Adamax", dict(learning_rate=1e-3)),
    ("ASGD", dict(learning_rate=1e-2, batch_num=4)),
    ("Lamb", dict(learning_rate=1e-3,
                  exclude_from_weight_decay_fn=lambda p: p.dim() == 1)),
    ("NAdam", dict(learning_rate=1e-3)),
    ("RAdam", dict(learning_rate=1e-3)),
    ("RMSProp", dict(learning_rate=1e-3, momentum=0.9, centered=True)),
    ("Rprop", dict(learning_rate=1e-3)),
    # controls: the optimizers earlier slices ported
    ("Adam", dict(learning_rate=1e-3)),
    ("AdamW", dict(learning_rate=1e-3, weight_decay=0.01)),
)


def _dit_batch(torch):
    """bench.py's batch (its seeded order): latents, int32 timesteps in
    [0, 1000), int64 labels in [0, 10), the noise target."""
    rng = np.random.RandomState(0)
    c, n = DIT_CFG["in_channels"], DIT_CFG["input_size"]
    x = rng.randn(DIT_BATCH, c, n, n).astype("float32")
    t = rng.randint(0, 1000, (DIT_BATCH,)).astype("int32")
    y = rng.randint(0, DIT_CFG["num_classes"], (DIT_BATCH,)).astype("int64")
    target = rng.randn(*x.shape).astype("float32")
    return [torch.from_numpy(a).to("cuda") for a in (x, t, y, target)]


def _dit_flops(model):
    """Model FLOPs of one training step (forward and backward, 3x the
    forward): 6 x the per-token linear parameters (x_embed, qkv, proj,
    the MLP, final) x tokens, 6 x the per-sample ones (the timestep MLP,
    every block's ada) x samples, and 12 b s^2 hidden a layer for the
    two attention products."""
    per_token = ["x_embed", "final"] + [
        f"blocks.{i}.{n}" for i in range(DIT_CFG["depth"])
        for n in ("qkv", "proj", "mlp_fc1", "mlp_fc2")]
    per_sample = ["t_embed.fc1", "t_embed.fc2"] + [
        f"blocks.{i}.ada" for i in range(DIT_CFG["depth"])]
    mods = dict(model.named_modules())

    def count(names):
        return sum(p.numel() for n in names for p in mods[n].parameters())

    p_tok, p_smp = count(per_token), count(per_sample)
    tokens = DIT_BATCH * DIT_SEQ
    attn = 12 * DIT_CFG["depth"] * DIT_BATCH * DIT_SEQ ** 2 * \
        DIT_CFG["hidden_size"]
    return {"per_token_params": p_tok, "per_sample_params": p_smp,
            "tokens": tokens, "attention_flops": attn,
            "flops": 6 * p_tok * tokens + 6 * p_smp * DIT_BATCH + attn}


def _dit_mode(torch, name, data, flush):
    """One mode of ``dit``. Returns (record, the f32 model's parameters
    and gradients after its steps or None)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import DiT, DiTConfig
    from paddle_tpu_torch.optimizer import AdamW

    amp_dtype, peak_flops, fwd_design, bwd_design, launch_dtype = \
        DIT_MODES[name]
    L = DIT_CFG["depth"]
    gc.collect()
    torch.cuda.empty_cache()
    model = DiT(DiTConfig(**DIT_CFG), seed=0)
    n_params = model.num_params()
    flops = _dit_flops(model)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=amp_dtype is not None)
    if amp_dtype is not None:
        model, opt = amp.decorate(model, opt, level="O2", dtype=amp_dtype)

    def loss_fn(m, x, t, y, target):
        # f32: no policy at all (a disabled auto_cast still pushes its
        # dispatch mode)
        with (amp.auto_cast(True, level="O2", dtype=amp_dtype)
              if amp_dtype else contextlib.nullcontext()):
            return ((m(x, t, y) - target) ** 2).mean()

    step = TrainStep(model, loss_fn, opt)

    def loss_and_grads():
        for p in model.parameters():
            p.grad = None
        loss = loss_fn(model, *data)
        loss.backward()
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    def grad_check(tag):
        """Loss and every gradient, flash kernels vs plain attention."""
        loss_k, g_k = loss_and_grads()
        with plain_attention(fa):
            loss_p, g_p = loss_and_grads()
        rel = {n: ((g_k[n] - g_p[n]).norm()
                   / g_p[n].norm().clamp_min(1e-30)).item() for n in g_p}
        worst = max(rel, key=rel.get)
        check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
              f"dit {name} ({tag}): loss {loss_k} vs plain attention "
              f"{loss_p}")
        check(all(np.isfinite(list(rel.values())))
              and rel[worst] <= TRAIN_GRAD_RTOL,
              f"dit {name} ({tag}): gradient of {worst} differs from plain "
              f"attention by {rel[worst]} (relative L2) > "
              f"{TRAIN_GRAD_RTOL}")
        qkv = [rel[f"blocks.{i}.qkv.weight"] for i in range(L)]
        return {"loss": loss_k, "plain_loss": loss_p,
                "worst_rel_l2": rel[worst], "worst_param": worst,
                "median_rel_l2": float(np.median(list(rel.values()))),
                "qkv_weight_rel_l2_max": max(qkv),
                "qkv_weight_grad_norm": float(g_k["blocks.0.qkv.weight"]
                                              .norm())}, g_k

    # the first step: with every block's ada zero (adaLN-Zero), the
    # gates are 0 and the attention and MLP weights get no gradient yet
    first, _ = grad_check("first step")

    n_steps = 4 + DIT_TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses = [step(*data) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(*data) for _ in range(DIT_TIMED_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / DIT_TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    counts = dict(_build.launch_counts(), **_build.variant_counts())
    losses = [x.item() for x in losses]
    want = n_steps * L
    for n in FLASH:
        design = fwd_design if n == "flash_attention" else bwd_design
        check(counts[n] == want
              and counts.get(f"{n}/{design}", 0) == want
              and counts.get(f"{n}/{launch_dtype}", 0) == want,
              f"dit {name}: {n} launches {counts[n]} ({design}: "
              f"{counts.get(f'{n}/{design}', 0)}, {launch_dtype}: "
              f"{counts.get(f'{n}/{launch_dtype}', 0)}), want {want} = "
              f"{n_steps} steps x {L} layers on the {design} design")
    check(all(np.isfinite(losses)), f"dit {name}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"dit {name}: loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    check(abs(losses[0] - first["loss"]) <= TRAIN_LOSS_TOL,
          f"dit {name}: the first step's loss {losses[0]} != "
          f"{first['loss']}")
    # after the steps the gates are open: the attention's gradients are
    # the flash backward's, held to the plain version the same way
    late, grads = grad_check(f"after {n_steps} steps")
    check(late["qkv_weight_grad_norm"] > 0,
          f"dit {name}: no gradient reached the attention after "
          f"{n_steps} steps")
    prof = _profiled_step(torch, lambda _: step(*data), None)
    designs = bwd_designs = None
    if fwd_design == "tf32x3":
        designs = _dit_designs(torch, fa, lambda: step(*data), step_ms,
                               prof, "forward")
    if bwd_design == "tf32x3":
        bwd_designs = _dit_designs(torch, fa, lambda: step(*data), step_ms,
                                   prof, "backward")
    samples_s = DIT_BATCH / (step_ms / 1e3)
    # the strided q, k, v views of the qkv projection: the flash wrapper
    # copies each contiguous in the forward and again in the backward
    qkv = torch.randn(DIT_BATCH, DIT_SEQ, 3, DIT_CFG["num_heads"],
                      DIT_HEAD_DIM, device="cuda").to(
        torch.bfloat16 if amp_dtype else torch.float32)
    views = [qkv[:, :, i] for i in range(3)]
    copy_ms = cuda_ms(torch, lambda: [fa._aligned(v) for v in views], 20,
                      flush)
    rec = {
        "amp_dtype": amp_dtype, "params": n_params, "batch": DIT_BATCH,
        "tokens_per_sample": DIT_SEQ, "step_ms": step_ms,
        "samples_per_s": samples_s, **flops,
        "mfu": flops["flops"] / (step_ms / 1e3) / peak_flops,
        "peak_flops": peak_flops, "peak_bytes": peak, "losses": losses,
        "steps": n_steps, "launches": counts, "first_step_check": first,
        "late_check": late, "profile": prof,
        "busy_share": (prof["device_ms"] / step_ms
                       if prof["device_ms"] else None),
        "qkv_copies_ms_per_layer_pass": copy_ms,
        "qkv_copies_ms_per_step": 2 * L * copy_ms,
        "forward_designs": designs, "backward_designs": bwd_designs,
    }
    log(f"[dit] {name}: {step_ms:.2f} ms/step, {samples_s:.1f} samples/s, "
        f"MFU {rec['mfu'] * 100:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"({flops['flops'] / 1e12:.4f} TFLOP a step: "
        f"{flops['per_token_params'] / 1e6:.2f}M per-token and "
        f"{flops['per_sample_params'] / 1e6:.2f}M per-sample linear "
        f"parameters, attention {flops['attention_flops'] / 1e12:.4f}); "
        f"peak {peak / 2**30:.2f} GiB; losses {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; kernels vs plain attention, first step: loss "
        f"{first['loss']:.6f} / {first['plain_loss']:.6f}, worst gradient "
        f"{first['worst_rel_l2']:.3g}; after {n_steps} steps: worst "
        f"{late['worst_rel_l2']:.3g} ({late['worst_param']}), qkv "
        f"{late['qkv_weight_rel_l2_max']:.3g}")
    log(f"[dit] {name} profiled step: device {prof['device_ms']:.3f} ms in "
        f"{prof['kernel_launches']} kernels (busy {rec['busy_share']}); "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    sorted(prof["families_ms"].items()))
        + f"; flash fwd {prof['flash_fwd_ms']:.3f}, dq "
        f"{prof['flash_bwd_dq_ms']:.3f}, dk/dv "
        f"{prof['flash_bwd_dkv_ms']:.3f}; q/k/v copies "
        f"{copy_ms:.4f} ms a layer pass, {rec['qkv_copies_ms_per_step']:.3f}"
        f" ms a step")
    for kname, ms, n in prof["top"]:
        log(f"[dit]   {kname:80s} {ms:9.3f} ms {n:5d} calls")
    kept = None
    if amp_dtype is None:
        kept = ([(n, p.detach()) for n, p in model.named_parameters()],
                grads)
    del model, opt, step
    return rec, kept


@contextlib.contextmanager
def forced_design(fa, design, part="forward"):
    """Inside: the flash forward (``part`` "forward") or backward
    ("backward") launches ``design`` wherever the wrapper would choose the
    f32 3xTF32 kernels (the comparison runs only)."""
    attr = "_fwd_variant" if part == "forward" else "_bwd_variant"
    real = getattr(fa, attr)

    def variant(*args):
        chosen = real(*args)
        return design if chosen == "tf32x3" else chosen

    setattr(fa, attr, variant)
    try:
        yield
    finally:
        setattr(fa, attr, real)


def _flash_part_ms(prof, part):
    return (prof["flash_fwd_ms"] if part == "forward"
            else prof["flash_bwd_dq_ms"] + prof["flash_bwd_dkv_ms"])


# the designs record's key of each part
_PART_KEY = {"forward": "fwd", "backward": "bwd"}


def _dit_designs(torch, fa, step, step_ms, prof, part):
    """The f32 DiT step with its flash forward or backward (``part``) on
    the 3xTF32 design (the wrapper's; ``step_ms`` and ``prof`` already
    measured) and on the FMA design it had before, in turns on the same
    model and data (FMA, 3xTF32, FMA): each turn's wall ms a step (mean of
    ``DIT_TIMED_STEPS``), and one profiled step of each: device ms, the
    part's flash ms and its share (``flash_fwd_ms`` / ``flash_fwd_share``
    or ``flash_bwd_ms`` / ``flash_bwd_share``)."""
    times = {"tf32x3": [step_ms], "fma": []}
    profs = {"tf32x3": prof}
    for design in ("fma", "tf32x3", "fma"):
        with forced_design(fa, design, part):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DIT_TIMED_STEPS):
                step()
            torch.cuda.synchronize()
            times[design].append(
                (time.perf_counter() - t0) / DIT_TIMED_STEPS * 1e3)
            if design not in profs:
                profs[design] = _profiled_step(torch, lambda _: step(), None)
    key = _PART_KEY[part]
    out = {}
    for d in times:
        flash_ms = _flash_part_ms(profs[d], part)
        device_ms = profs[d]["device_ms"]
        out[d] = {"step_ms": times[d], "device_ms": device_ms,
                  f"flash_{key}_ms": flash_ms,
                  f"flash_{key}_share": (flash_ms / device_ms
                                         if device_ms else None)}
    log(f"[dit] f32 step by {part} design (turns: 3xTF32, FMA, 3xTF32, "
        "FMA): " + "; ".join(
            f"{d} {', '.join(f'{t:.3f}' for t in r['step_ms'])} ms, device "
            f"{r['device_ms']:.3f} ms, flash {part} "
            f"{r[f'flash_{key}_ms']:.3f} ms "
            f"({(r[f'flash_{key}_share'] or 0) * 100:.2f} %)"
            for d, r in out.items()))
    return out


def _dit_optimizers(torch, named, grads):
    """One ``step()`` of each new optimizer (and Adam/AdamW) on the card
    against the same step on CPU copies of the parameters, gradients and
    state: the DiT's f32 parameters and gradients at bench width. The
    first step on the card builds the state; the compared, timed step is
    the second."""
    from paddle_tpu_torch import optimizer as optim

    def rel(a, b):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    out = {}
    grads_cpu = {n: g.cpu() for n, g in grads.items()}
    for cls, kw in DIT_OPTIMIZERS:
        card = [(n, torch.nn.Parameter(p.clone())) for n, p in named]
        opt = getattr(optim, cls)(parameters=card, **kw)
        for n, p in card:
            p.grad = grads[n].clone()
        opt.step()
        host = [(n, torch.nn.Parameter(p.detach().to("cpu", copy=True)))
                for n, p in card]
        ref = getattr(optim, cls)(parameters=host, **kw)
        ref.set_state_dict(opt.state_dict())
        for (n, p), (_, q) in zip(card, host):
            p.grad = grads[n].clone()
            q.grad = grads_cpu[n].clone()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.step()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        ref.step()
        worst = max(rel(p, q) for (_, p), (_, q) in zip(card, host))
        got, want = opt.state_dict(), ref.state_dict()
        check(set(got) == set(want), f"dit optimizer {cls}: state keys "
              f"{sorted(set(got) ^ set(want))} differ")
        acc = [rel(got[k], want[k]) for k in want
               if torch.is_tensor(want[k])]
        worst_acc = max(acc) if acc else 0.0
        check(worst <= DIT_OPT_RTOL and worst_acc <= DIT_OPT_RTOL,
              f"dit optimizer {cls}: card step vs CPU step: weights "
              f"{worst}, accumulators {worst_acc} (relative L2) > "
              f"{DIT_OPT_RTOL}")
        out[cls] = {"update_ms": ms, "weights_rel_l2": worst,
                    "accumulators_rel_l2": worst_acc,
                    "accumulators": len(acc)}
        del card, host, opt, ref
        torch.cuda.empty_cache()

    # LBFGS: one closure step over a fixed quadratic of the same size
    n = sum(p.numel() for _, p in named)
    g = torch.Generator().manual_seed(5)
    a = torch.rand(n, generator=g) * 1.5 + 0.5
    b = torch.randn(n, generator=g)

    def lbfgs(device):
        x = torch.nn.Parameter(torch.zeros(n, device=device))
        ad, bd = a.to(device), b.to(device)
        # max_eval above the first search's doublings (~25 evaluations
        # from alpha = 1 / |g|_1), so all 5 iterations run and the later
        # directions come from the two-loop recursion over the history
        opt = optim.LBFGS(parameters=[x], learning_rate=1.0, max_iter=5,
                          max_eval=100, history_size=4,
                          line_search_fn="strong_wolfe")

        def closure():
            opt.clear_grad()
            loss = 0.5 * (ad * x * x).sum() - (bd * x).sum()
            loss.backward()
            return loss

        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss0 = float(opt.step(closure))
        if device != "cpu":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return (x.detach(), loss0, float(closure().detach()),
                opt._func_evals, ms, opt._len)

    xc, l0, l1, evals, ms, pairs = lbfgs("cuda")
    xh, _, l1h, evals_h, _, _ = lbfgs("cpu")
    err = rel(xc, xh)
    check(err <= DIT_LBFGS_RTOL and l1 < l0 and pairs > 1,
          f"dit optimizer LBFGS: card vs CPU iterate {err} (relative L2) > "
          f"{DIT_LBFGS_RTOL}, or loss {l0} -> {l1} did not fall, or "
          f"{pairs} history pairs")
    out["LBFGS"] = {"step_ms": ms, "weights_rel_l2": err, "loss": l0,
                    "loss_after": l1, "loss_after_cpu": l1h,
                    "func_evals": evals, "func_evals_cpu": evals_h,
                    "history_pairs": pairs, "elements": n}
    log("[dit] optimizers, card step vs CPU step (relative L2; update ms): "
        + ", ".join(f"{k} {v['weights_rel_l2']:.2g}/"
                    f"{v.get('accumulators_rel_l2', 0.0):.2g} "
                    f"{v.get('update_ms', v.get('step_ms')):.3f}"
                    for k, v in out.items()))
    return out


def _dit_dropout(torch, flush):
    """One DiT-shaped attention call at p = 0.1 on the card: the math
    form (no flash launch), the probabilities kept at 1 - p within 5
    binomial sigma, the same output for the same generator seed."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.ops import nn_ops

    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(DIT_BATCH, DIT_SEQ, DIT_CFG["num_heads"],
                           DIT_HEAD_DIM, device="cuda", generator=g)
               for _ in range(3))
    masks = []
    real = nn_ops._keep_mask

    def recording(p, shape, device, generator):
        masks.append(real(p, shape, device, generator))
        return masks[-1]

    def call(seed):
        return nn_ops.scaled_dot_product_attention(
            q, k, v, dropout_p=DIT_DROPOUT_P,
            generator=torch.Generator(device="cuda").manual_seed(seed))

    _build.reset_launch_counts()
    nn_ops._keep_mask = recording
    try:
        a, b, c = call(11), call(11), call(12)
    finally:
        nn_ops._keep_mask = real
    torch.cuda.synchronize()
    flash = {n: _build.launch_counts()[n] for n in FLASH}
    kept = int(masks[0].sum())
    n = masks[0].numel()
    sigma = (n * DIT_DROPOUT_P * (1 - DIT_DROPOUT_P)) ** 0.5
    dev = (kept - n * (1 - DIT_DROPOUT_P)) / sigma
    plain = nn_ops.scaled_dot_product_attention(q, k, v)
    check(not any(flash.values()), f"dit dropout: flash launches {flash}")
    check(abs(dev) <= 5, f"dit dropout: kept {kept} of {n}, {dev:.2f} "
          f"sigma from {1 - DIT_DROPOUT_P}")
    check(torch.equal(a, b) and not torch.equal(a, c)
          and bool(a.isfinite().all()) and not torch.equal(a, plain),
          "dit dropout: not repeatable under one generator seed, or no "
          "different under another")
    ms = cuda_ms(torch, lambda: call(11), 5, flush)
    rec = {"p": DIT_DROPOUT_P, "kept": kept, "probabilities": n,
           "sigma_from_mean": dev, "flash_launches": flash, "ms": ms}
    log(f"[dit] attention dropout p {DIT_DROPOUT_P}: kept {kept} of {n} "
        f"({dev:+.2f} sigma), no flash launch, repeatable; {ms:.3f} ms a "
        f"call (math form)")
    return rec


def phase_dit(torch):
    """``dit``: the DiT cell (``bench.py``'s ``bench_dit``: hidden 512,
    depth 8, 8 heads of d 64, 256 tokens, batch 32, AdamW(1e-4), MSE to a
    noise target; 38.4M parameters from seed 0) through ``jit.TrainStep``
    in f32 (the bench's dtype, TF32 off) and amp O2 bf16. Gates, each
    mode: every flash kernel launched steps x 8 times on the mode's
    design (FMA f32, wgmma bf16); the first step's loss within
    ``TRAIN_LOSS_TOL`` and every gradient within ``TRAIN_GRAD_RTOL``
    (relative L2) of the same step with plain attention, and again after
    the steps (the first step's gates are zero, so its attention gets no
    gradient); losses finite and falling. Recorded: step ms (mean of 10
    after 1 + 3), samples/s, MFU (f32 against 67e12, bf16 against
    989e12), peak memory, one profiled step (device ms by family,
    kernels, busy share), the q/k/v copies. Then one update of each of
    the twelve new optimizers (Adam and AdamW as controls) on the card
    against the CPU, and one dropout call."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    data = _dit_batch(torch)
    result = {"launches": {}}
    kept = None
    for name in DIT_MODES:
        rec, got = _dit_mode(torch, name, data, flush)
        result[name] = rec
        kept = got or kept
        for key, n in rec["launches"].items():
            result["launches"][key] = result["launches"].get(key, 0) + n
    result["f32_vs_o2_step_ms"] = (result["f32"]["step_ms"]
                                   / result["o2_bf16"]["step_ms"])
    result["optimizers"] = _dit_optimizers(torch, *kept)
    del kept
    result["dropout"] = _dit_dropout(torch, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------ ResNet-50
# bench.py's bench_resnet (BASELINE config #1, its TPU branch): ResNet-50
# with a 10-class head on 32 x 32 images, batch 128, Momentum(0.1, 0.9,
# weight_decay 5e-4), cross entropy, through jit.TrainStep; f32 (the
# bench's dtype, TF32 off) and amp O2 bf16 (every parameter bf16, the
# batch norms' running buffers f32)
RESNET_BATCH = 128
RESNET_MODES = {"f32": (None, F32_FLOPS), "o2_bf16": ("bfloat16", BF16_FLOPS)}
RESNET_TIMED_STEPS = 10
# lr 0.1 on one fixed batch first throws the loss up (to ~10x at steps
# 2-4 in a CPU run at batch 32) before it falls: the losses are followed
# to step 40, and the last must be below the first
RESNET_STEPS = 40
# the first f32 step on the card: the loss within 1e-4 relative of the
# same step on the CPU, and each layer's running mean and variance
# within 1e-4 relative L2 of the CPU's; each gradient within 1e-3
# relative L2 of the step in f64 on the CPU that takes the card's ReLU
# and max-pool decisions (``_pin_decisions``). Against a step that makes
# its own decisions no such bound holds: the f32 forward stands ~7e-5
# from f64 at the logits, enough to flip a few ReLUs near 0, and each
# flip moves the gradients of every layer below it, so the CPU's own
# f32 gradients stand up to ~2e-2 from its f64 ones (recorded: the card
# against the CPU)
RESNET_LOSS_RTOL = 1e-4
RESNET_GRAD_RTOL = 1e-3
RESNET_STATS_RTOL = 1e-4
# O2 bf16's first step, unit by unit (``_resnet_o2_units``): each unit
# of the network (the stem, each block, the head) redone on the CPU
# from the card's bf16 weights, input and output gradient, with the
# card's decisions, in f64 and under O2 bf16. Each output (the head's
# loss), input gradient and parameter gradient on the card within 2e-2
# relative L2 of the f64 unit, plus twice the CPU bf16 unit's distance
# from it: a gradient that sums many terms that cancel (the stem batch
# norm's bias: 32768 terms a channel that largely cancel) carries its
# bf16 rounding magnified, on any device (the port's O2 on the CPU:
# 2.5e-2 there, 3-9e-3 elsewhere). Through
# the whole network the roundings compound (the f32 forward's own
# error grows ~12 % a batch norm), so O2's whole first step is
# recorded against f32's, stage by stage, and gated only after the
# stem's max pool and after layer1
RESNET_O2_UNIT_RTOL = 2e-2
RESNET_O2_STAGE_RTOL = {"stem": 1e-2, "layer1": 5e-2}
RESNET_STAGES = ("maxpool", "layer1", "layer2", "layer3", "layer4")
# the gradient that the gates' self-test plants a fault in: 1 % off in
# f32, 10 % in O2, the gate must name it
RESNET_PLANT = ("layer1.0.conv2.weight", {"f32": 1.01, "o2_bf16": 1.1})
# the data path: bench's step fed by the CIFAR pipeline users run
RESNET_DATA = dict(synthetic_size=2048, num_workers=4)


def _resnet_batch(torch, dev="cuda", batch=RESNET_BATCH):
    """bench.py's batch: RandomState(0) randn images, then labels."""
    rng = np.random.RandomState(0)
    x = rng.randn(batch, 3, 32, 32).astype("float32")
    y = rng.randint(0, 10, (batch,)).astype("int64")
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _resnet_flops(torch, model, x):
    """Model FLOPs of one training step (3x the forward): 2 x the
    multiply-adds of every convolution and of the head, counted from the
    shapes of one forward (no-grad)."""
    from paddle_tpu_torch.nn import Conv2D, Linear

    total = [0]

    def conv(m, inp, out):
        k = int(np.prod(m.weight.shape[1:]))
        total[0] += 2 * k * out.numel()

    def linear(m, inp, out):
        total[0] += 2 * m.weight.shape[0] * out.numel()

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2D)
                                     else linear)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(x)
    model.train(was)
    for h in hooks:
        h.remove()
    return {"forward_flops": total[0], "flops": 3 * total[0],
            "forward_flops_per_image": total[0] / x.shape[0]}


def _rel(torch, a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _stage_hooks(model, stages):
    """Record each of ``RESNET_STAGES``' outputs (f32) into ``stages``."""
    def keep(name):
        def hook(m, inp, out):
            stages[name] = out.detach().float()
        return hook
    return [getattr(model, n).register_forward_hook(keep(n))
            for n in RESNET_STAGES]


def _record_decisions(torch, model, dec):
    """Forward hooks that keep, in call order under the module's name in
    ``dec``, each ReLU's mask and each max pool's argmax (the flat H * W
    index): the network's only discrete choices."""
    from paddle_tpu_torch import nn, ops

    def relu(name):
        def hook(m, inp, out):
            dec.setdefault(name, []).append(out.detach() > 0)
        return hook

    def pool(name):
        def hook(m, inp, out):
            dec.setdefault(name, []).append(ops.max_pool2d_with_index(
                inp[0].detach(), m.kernel_size, m.stride, m.padding,
                m.ceil_mode)[1])
        return hook

    return [m.register_forward_hook(
        (relu if isinstance(m, nn.ReLU) else pool)(n))
        for n, m in model.named_modules()
        if isinstance(m, (nn.ReLU, nn.MaxPool2D))]


def _pin_decisions(torch, model, dec, prefix=""):
    """Forward hooks that make ``model``'s ReLUs and max pools take, in
    call order, the choices ``_record_decisions`` kept in ``dec`` for
    the modules named ``prefix`` + theirs. The step is then a smooth
    function of the weights and the input, and its f64 value the
    reference of an f32 or bf16 step that made those choices."""
    from paddle_tpu_torch import nn

    def pinned(name):
        calls = iter(dec[name])

        def hook(m, inp, out):
            d = next(calls).to(inp[0].device)
            if isinstance(m, nn.ReLU):
                return inp[0] * d.to(inp[0].dtype)
            return inp[0].flatten(2).gather(2, d.flatten(2)).view(out.shape)
        return hook

    return [m.register_forward_hook(pinned(prefix + n))
            for n, m in model.named_modules()
            if isinstance(m, (nn.ReLU, nn.MaxPool2D)) and prefix + n in dec]


def _resnet_grads(torch, model, x, y, bn_inputs=None, stages=None,
                  hooks=()):
    """Loss and every gradient of one forward and backward in train
    mode (the batch norms' running statistics advance once); with
    ``bn_inputs`` (a dict), each batch norm's input statistics in f64:
    {layer name: (mean, biased variance)}; with ``stages``, the stages'
    outputs; ``hooks``, handles to remove after the step."""
    from paddle_tpu_torch import nn

    hooks = list(hooks) + ([] if stages is None
                           else _stage_hooks(model, stages))
    if bn_inputs is not None:
        def capture(name):
            def hook(m, inp):
                t = inp[0].detach().double()
                bn_inputs[name] = (t.mean(dim=(0, 2, 3)),
                                   t.var(dim=(0, 2, 3), unbiased=False))
            return hook
        hooks += [m.register_forward_pre_hook(capture(n))
                  for n, m in model.named_modules()
                  if isinstance(m, nn.BatchNorm2D)]
    for p in model.parameters():
        p.grad = None
    loss = nn.CrossEntropyLoss()(model(x), y)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    for h in hooks:
        h.remove()
    return float(loss.detach()), grads


def _leaf_gate(torch, kind, card, ref, rtol, plant=None, floor=None):
    """Relative L2 of each leaf of ``card`` from ``ref``; fails unless
    every one is within ``rtol``, plus twice ``floor[leaf]`` where a
    floor is given (the distance from ``ref`` of the same computation
    on another device). With ``plant`` (leaf, factor), first shows that
    the gate names that leaf once its value is scaled by ``factor``: a
    check that cannot fail holds nothing."""
    tol = {n: rtol + 2 * (floor[n] if floor else 0.0) for n in ref}

    def over(c):
        rels = {n: _rel(torch, c[n], ref[n]) for n in ref}
        return rels, {n: (e, tol[n]) for n, e in rels.items() if e > tol[n]}

    if plant is not None:
        leaf, factor = plant
        _, caught = over({**card, leaf: card[leaf] * factor})
        check(leaf in caught, f"{kind}: the gate missed a planted fault "
              f"(x{factor} on {leaf})")
    rels, bad = over(card)
    check(not bad, f"{kind}: {len(bad)} leaves over their limit (relative "
          f"L2, limit): {sorted(bad.items(), key=lambda kv: -kv[1][0])[:4]}")
    return rels


def _summary(rels):
    """Worst, median and the worst leaf of a {leaf: relative L2}."""
    worst = max(rels, key=rels.get)
    return {"worst": rels[worst], "worst_leaf": worst,
            "median": float(np.median(list(rels.values())))}


def _resnet_first_step(torch, model):
    """The f32 model's first step on the card against the same step of
    the port on the CPU (the loss, the running statistics; the
    gradients recorded), and its gradients against the step in f64 on
    the CPU that takes the card's decisions, from the same weights and
    batch (copies; ``model`` is left as built)."""
    from paddle_tpu_torch.vision.models import resnet50

    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cpu_init = {k: v.cpu() for k, v in init.items()}
    x, y = _resnet_batch(torch)
    bn_in, stages, dec, host_dec = {}, {}, {}, {}
    loss, grads = _resnet_grads(torch, model, x, y, bn_in, stages,
                                _record_decisions(torch, model, dec))
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(init)
    host = resnet50(num_classes=10, device="cpu")
    host.load_state_dict(cpu_init)
    t0 = time.perf_counter()
    loss_h, grads_h = _resnet_grads(
        torch, host, x.cpu(), y.cpu(),
        hooks=_record_decisions(torch, host, host_dec))
    host_s = time.perf_counter() - t0
    exact = resnet50(num_classes=10, device="cpu").double()
    exact.load_state_dict(cpu_init)
    t0 = time.perf_counter()
    loss_d, grads_d = _resnet_grads(
        torch, exact, x.cpu().double(), y.cpu(),
        hooks=_pin_decisions(torch, exact, dec))
    exact_s = time.perf_counter() - t0
    bufs = {k: v for k, v in after.items()
            if k.endswith(("._mean", "._variance"))}
    host_bufs = {k: v for k, v in host.state_dict().items() if k in bufs}
    del host, exact
    flips = sum(int((a.cpu() != b).sum()) for n in dec
                for a, b in zip(dec[n], host_dec[n]))
    choices = sum(a.numel() for n in dec for a in dec[n])

    check(abs(loss - loss_h) <= RESNET_LOSS_RTOL * abs(loss_h),
          f"resnet f32 first step: loss {loss} on the card vs {loss_h} on "
          f"the CPU")
    g = _leaf_gate(torch, "resnet f32 first step: gradients against the "
                   "pinned f64 step", grads, grads_d, RESNET_GRAD_RTOL,
                   (RESNET_PLANT[0], RESNET_PLANT[1]["f32"]))
    g_cpu = {n: _rel(torch, grads[n], grads_h[n]) for n in grads_h}
    s = _leaf_gate(torch, "resnet f32 first step: running statistics "
                   "against the CPU's", bufs, host_bufs, RESNET_STATS_RTOL)
    # the running statistics are the JAX formula over the batch: m = 0.9,
    # the biased variance, from the initial 0 / 1
    formula = 0.0
    for name, (mean, var) in bn_in.items():
        for buf, want in (("_mean", 0.1 * mean),
                          ("_variance", 0.9 + 0.1 * var)):
            formula = max(formula, _rel(torch, bufs[f"{name}.{buf}"], want))
    check(formula <= RESNET_STATS_RTOL, f"resnet f32 first step: running "
          f"statistics {formula:.3g} from the JAX formula over the batch")
    return {"loss": loss, "cpu_loss": loss_h, "f64_pinned_loss": loss_d,
            "cpu_step_s": host_s, "f64_step_s": exact_s,
            "gradients_vs_pinned_f64": _summary(g),
            "gradients_vs_cpu_f32": _summary(g_cpu),
            "gradients_by_leaf": {n: [g[n], g_cpu[n]] for n in g},
            "decisions": choices, "decisions_differing_from_cpu": flips,
            "running_stats": _summary(s),
            "stats_vs_formula_rel_l2": formula,
            "batch_norms": len(bn_in)}, grads, loss, stages


def _resnet_units(torch, model):
    """(name, module, parameter prefix) of the units that tile ResNet in
    order: the stem (conv1, bn1, relu, maxpool), each block, and the
    head (avgpool, flatten, fc)."""
    seq = torch.nn.Sequential
    stem = seq(collections.OrderedDict(
        (n, getattr(model, n)) for n in ("conv1", "bn1", "relu", "maxpool")))
    head = seq(collections.OrderedDict(
        avgpool=model.avgpool, flatten=torch.nn.Flatten(1), fc=model.fc))
    blocks = [(f"{s}.{i}", b, f"{s}.{i}.")
              for s in ("layer1", "layer2", "layer3", "layer4")
              for i, b in enumerate(getattr(model, s))]
    return [("stem", stem, ""), *blocks, ("head", head, "")]


def _resnet_o2_units(torch, model, loss_fn, x, y):
    """O2's first forward and backward on the card, held unit by unit
    (``_resnet_units``): each unit's input, output and output gradient
    are kept from the one step of the whole model, and each unit's step
    is redone on the CPU from the card's bf16 weights and input, with
    the card's decisions, back from the card's output gradient: in f64,
    the reference, and under O2 bf16, the same rounding on another
    device. Gated (``RESNET_O2_UNIT_RTOL``), each quantity against the
    f64 unit within the limit plus twice the CPU bf16 unit's distance:
    each unit's output (the head's: the loss), its input gradient
    (against the card's output gradient of the unit before) and every
    parameter gradient. Returns (record, loss, gradients, stage
    outputs)."""
    from paddle_tpu_torch import amp, nn

    units = _resnet_units(torch, model)
    kept, dec, stages = {}, {}, {}

    def keep(name):
        def hook(m, inp, out):
            kept[name] = {"out": out.detach()}
            out.register_hook(
                lambda g: kept[name].__setitem__("gout", g.detach()))
        return hook

    hooks = (_record_decisions(torch, model, dec)
             + _stage_hooks(model, stages)
             + [model.maxpool.register_forward_hook(keep("stem"))]
             + [m.register_forward_hook(keep(n))
                for n, m, _ in units[1:-1]])
    for p in model.parameters():
        p.grad = None
    loss_t = loss_fn(model, x, y)
    loss_t.backward()
    loss = float(loss_t.detach())
    for h in hooks:
        h.remove()
    grads = {n: p.grad.detach().float() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    card = {f"out:{n}": v["out"] for n, v in kept.items()}
    card["out:head"] = torch.tensor([loss])
    card.update({f"grad_in:{units[k + 1][0]}": kept[n]["gout"]
                 for k, (n, _, _) in enumerate(units[:-1])})
    card.update(grads)

    def redo(unit, name, prefix, xin, exact):
        """The unit's step on the CPU: (output, gradients by the card's
        names)."""
        ref = copy.deepcopy(unit).cpu()
        ref = ref.double() if exact else ref
        for p in ref.parameters():
            p.grad = None
        pins = _pin_decisions(torch, ref, dec, prefix)
        a = xin.detach().cpu()
        a = (a.double() if exact else a).requires_grad_()
        with (contextlib.nullcontext() if exact else
              amp.auto_cast(True, level="O2", dtype="bfloat16")):
            out = ref(a)
            if name == "head":
                out = nn.CrossEntropyLoss()(out, y.cpu()).reshape(1)
        out.backward(None if name == "head" else
                     kept[name]["gout"].cpu().to(out.dtype).reshape(out.shape))
        for h in pins:
            h.remove()
        got = {f"out:{name}": out.detach()}
        if name != "stem":
            got[f"grad_in:{name}"] = a.grad
        got.update({prefix + n: p.grad for n, p in ref.named_parameters()})
        return got

    t0 = time.perf_counter()
    exact, low = {}, {}
    for k, (name, unit, prefix) in enumerate(units):
        xin = x if k == 0 else kept[units[k - 1][0]]["out"]
        exact.update(redo(unit, name, prefix, xin, True))
        low.update(redo(unit, name, prefix, xin, False))
    ref_s = time.perf_counter() - t0
    floor = {n: _rel(torch, low[n], exact[n]) for n in exact}
    rels = _leaf_gate(torch, "resnet o2_bf16 units: against the pinned f64 "
                      "units", card, exact, RESNET_O2_UNIT_RTOL, (
                          RESNET_PLANT[0], RESNET_PLANT[1]["o2_bf16"]),
                      floor)

    def part(d, keep):
        return _summary({n: e for n, e in d.items() if keep(n)})

    kinds = {"outputs": lambda n: n.startswith("out:"),
             "input_grads": lambda n: n.startswith("grad_in:"),
             "gradients": lambda n: ":" not in n}
    rec = {"units": len(units), "reference_s": ref_s,
           "head_loss": rels["out:head"],
           **{k: part(rels, f) for k, f in kinds.items()},
           "cpu_bf16": {k: part(floor, f) for k, f in kinds.items()},
           "by_quantity": {n: [rels[n], floor[n]] for n in rels}}
    return rec, loss, grads, stages


def _resnet_family(key):
    """A ResNet step's kernel family, from the kernel's name."""
    k = key.lower()
    if "multi_tensor_apply" in k:
        return "foreach"
    if "pool" in k:
        return "pooling"
    if "batch_norm" in k or "bn_" in k or "welford" in k:
        return "batch_norm"
    if any(t in k for t in ("conv", "cudnn", "xmma", "implicit", "fprop",
                            "dgrad", "wgrad", "nchwtonhwc", "nhwctonchw",
                            "winograd", "fft")):
        return "convolution"
    if "gemm" in k or "nvjet" in k or "cutlass" in k:
        return "gemm"
    if "elementwise" in k or "relu" in k or "threshold" in k:
        return "elementwise"
    return "other"


def _resnet_mode(torch, name, f32_ref):
    """One mode of ``resnet``. ``f32_ref``: None for f32 (then the first
    step is held to the CPU and f64), else the f32 mode's (loss,
    gradients, stage outputs) for O2. Returns (record, (loss, gradients,
    stage outputs))."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    amp_dtype, peak_flops = RESNET_MODES[name]
    gc.collect()
    torch.cuda.empty_cache()
    model = resnet50(num_classes=10, seed=0)
    x, y = _resnet_batch(torch)
    flops = _resnet_flops(torch, model, x)
    rec = {"amp_dtype": amp_dtype, "batch": RESNET_BATCH,
           "params": sum(p.numel() for p in model.parameters()),
           "state_entries": len(model.state_dict()), **flops,
           "cudnn_benchmark": bool(torch.backends.cudnn.benchmark)}
    if f32_ref is None:
        rec["first_step"], grads, loss, stages = _resnet_first_step(
            torch, model)
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.named_parameters(), weight_decay=5e-4,
                   multi_precision=amp_dtype is not None)
    if amp_dtype is not None:
        model, opt = amp.decorate(model, opt, level="O2", dtype=amp_dtype)
        bufs = {b.dtype for b in model.buffers()}
        check(bufs == {torch.float32} and all(
            p.dtype == torch.bfloat16 for p in model.parameters()),
            f"resnet {name}: parameters not all bf16 or buffers {bufs} not "
            f"f32 after amp.decorate")
    ce = nn.CrossEntropyLoss()

    def policy():
        return (amp.auto_cast(True, level="O2", dtype=amp_dtype)
                if amp_dtype else contextlib.nullcontext())

    def loss_fn(m, xb, yb):
        with policy():
            return ce(m(xb), yb)

    if f32_ref is not None:
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        units, loss, grads, stages = _resnet_o2_units(
            torch, model, loss_fn, x, y)
        model.load_state_dict(init)
        ref_loss, ref_grads, ref_stages = f32_ref
        each = sorted(_rel(torch, grads[n], ref_grads[n]) for n in grads)
        flat = _rel(torch, torch.cat([grads[n].flatten() for n in grads]),
                    torch.cat([ref_grads[n].flatten() for n in grads]))
        staged = {("stem" if n == "maxpool" else n):
                  _rel(torch, stages[n], ref_stages[n]) for n in stages}
        rec["first_step"] = {
            "units": units, "loss": loss, "f32_loss": ref_loss,
            "stages_rel_l2": staged, "grads_rel_l2": flat,
            "median_grad_rel_l2": float(np.median(each)),
            "worst_grad_rel_l2": each[-1]}
        check(np.isfinite(loss) and all(
            staged[n] <= tol for n, tol in RESNET_O2_STAGE_RTOL.items()),
            f"resnet {name}: first forward against f32: loss {loss} vs "
            f"{ref_loss}, stages {staged} (gates {RESNET_O2_STAGE_RTOL})")
    step = TrainStep(model, loss_fn, opt)
    n_steps = 4 + RESNET_TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses = [step(x, y) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(RESNET_TIMED_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / RESNET_TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses += [step(x, y) for _ in range(RESNET_STEPS - n_steps)]
    counts = dict(_build.launch_counts())
    losses = [float(v) for v in losses]
    check(not any(counts.values()), f"resnet {name}: hand kernels launched "
          f"{ {k: v for k, v in counts.items() if v} }")
    check(all(np.isfinite(losses)), f"resnet {name}: non-finite loss "
          f"{losses}")
    check(losses[-1] < losses[0], f"resnet {name}: loss did not fall "
          f"over {RESNET_STEPS} steps: {[round(v, 3) for v in losses]}")
    check(abs(losses[0] - loss) <= RESNET_LOSS_RTOL * abs(loss),
          f"resnet {name}: TrainStep's first loss {losses[0]} != {loss}")
    # eval: the running statistics, the same on the CPU, no update
    model.eval()
    bufs = {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("._mean", "._variance"))}
    with torch.no_grad(), policy():
        logits = model(x).float()
    check(all(torch.equal(v, model.state_dict()[k]) for k, v in
              bufs.items()), f"resnet {name}: an eval forward changed the "
          f"running statistics")
    eval_rec = {"logits_finite": bool(logits.isfinite().all())}
    if amp_dtype is None:
        from paddle_tpu_torch.vision.models import resnet50 as build

        host = build(num_classes=10, device="cpu").eval()
        host.load_state_dict({k: v.cpu() for k, v in
                              model.state_dict().items()})
        with torch.no_grad():
            want = host(x.cpu())
        eval_rec["cpu_rel_l2"] = _rel(torch, logits, want)
        check(eval_rec["cpu_rel_l2"] <= RESNET_STATS_RTOL * 10,
              f"resnet {name}: eval logits {eval_rec['cpu_rel_l2']:.3g} "
              f"from the CPU's")
        del host
    with torch.no_grad(), policy():
        train_logits = model.train()(x).float()
    model.load_state_dict({**model.state_dict(), **bufs})
    eval_rec["train_vs_eval_rel_l2"] = _rel(torch, train_logits, logits)
    check(eval_rec["logits_finite"] and eval_rec["train_vs_eval_rel_l2"]
          > 1e-3, f"resnet {name}: eval logits {eval_rec}")
    prof = _profiled_step(torch, lambda _: step(x, y), None,
                          family=_resnet_family)
    images_s = RESNET_BATCH / (step_ms / 1e3)
    rec.update({
        "step_ms": step_ms, "images_per_s": images_s,
        "mfu": flops["flops"] / (step_ms / 1e3) / peak_flops,
        "peak_flops": peak_flops,
        "bound_ms": flops["flops"] / peak_flops * 1e3,
        "peak_bytes": peak, "losses": losses, "steps": RESNET_STEPS,
        "launches": counts, "eval": eval_rec, "profile": prof,
        "busy_share": prof["device_ms"] / step_ms,
    })
    log(f"[resnet] {name}: {step_ms:.2f} ms/step, {images_s:.0f} images/s, "
        f"MFU {rec['mfu'] * 100:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"({flops['flops'] / 1e9:.2f} GFLOP a step, bound "
        f"{rec['bound_ms']:.3f} ms); peak {peak / 2**30:.2f} GiB; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    first = rec["first_step"]
    if amp_dtype is None:
        flips = first["decisions_differing_from_cpu"]
        log(f"[resnet] {name} first step: loss {first['loss']!r} (CPU "
            f"{first['cpu_loss']!r}, pinned f64 {first['f64_pinned_loss']!r});"
            f" gradients against the pinned f64 step "
            f"{first['gradients_vs_pinned_f64']}, against the CPU "
            f"{first['gradients_vs_cpu_f32']}; {flips} of "
            f"{first['decisions']} decisions differ from the CPU's; running "
            f"statistics {first['running_stats']}, "
            f"{first['stats_vs_formula_rel_l2']:.3g} from the formula")
    else:
        u = first["units"]
        log(f"[resnet] {name} first step: loss {first['loss']!r} (f32 "
            f"{first['f32_loss']!r}); {u['units']} units against pinned "
            f"f64 (the CPU bf16 units' in brackets): outputs "
            f"{u['outputs']} [{u['cpu_bf16']['outputs']}], head loss "
            f"{u['head_loss']:.3g}, input gradients {u['input_grads']} "
            f"[{u['cpu_bf16']['input_grads']}], parameter gradients "
            f"{u['gradients']} [{u['cpu_bf16']['gradients']}]; whole step "
            f"against f32: stages "
            f"{ {k: round(v, 4) for k, v in first['stages_rel_l2'].items()} }"
            f", gradients {first['grads_rel_l2']:.3g}")
    log(f"[resnet] {name} profiled step: device {prof['device_ms']:.3f} ms "
        f"in {prof['kernel_launches']} kernels (busy "
        f"{rec['busy_share']:.3f}); "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    sorted(prof["families_ms"].items())))
    for kname, ms, n in prof["top"]:
        log(f"[resnet]   {kname:80s} {ms:9.3f} ms {n:5d} calls")
    ref = (loss, {n: g.float() for n, g in grads.items()}, stages)
    del model, opt, step
    return rec, ref


class _Probed:
    """A dataset's items, the image as a CPU torch tensor (collated in
    the worker), plus the loading process's pid."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        import torch

        img, label = self.ds[i]
        return torch.from_numpy(img), label, np.asarray([os.getpid()])


class _CudaInWorker:
    """A dataset whose items are made on the card: in a worker forked
    from a process with a CUDA context, the first item must fail."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        import torch

        return torch.full((2,), float(i), device="cuda").cpu().numpy()


def _resnet_data(torch, fixed_images_s):
    """The f32 step fed by the CIFAR pipeline: synthetic CIFAR-10 (2048
    images) with RandomCrop(32, 4), RandomHorizontalFlip, ToTensor,
    Normalize, batch 128, shuffle, 4 forked workers over shared memory."""
    from paddle_tpu_torch import io, nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import datasets, transforms as T
    from paddle_tpu_torch.vision.models import resnet50

    cfg = RESNET_DATA
    norm = T.Normalize([0.4914, 0.4822, 0.4465], [0.2470, 0.2435, 0.2616])
    plain = datasets.Cifar10(mode="train", backend="synthetic",
                             synthetic_size=cfg["synthetic_size"],
                             transform=T.Compose([T.ToTensor(), norm]))

    def seeded(ds, **kw):
        sampler = io.BatchSampler(sampler=io.RandomSampler(ds, seed=3),
                                  batch_size=RESNET_BATCH, drop_last=True)
        return io.DataLoader(ds, batch_sampler=sampler, **kw)

    # deterministic transform: the first 4 batches equal the in-process
    # loader's bit for bit; the items come from other processes, whose
    # default collate stacks the CPU tensors the dataset returns
    procs = seeded(_Probed(plain), num_workers=cfg["num_workers"],
                   use_shared_memory=True)
    sync = seeded(plain)
    got = []
    for i, batch in enumerate(procs):
        got.append(batch)
        if i == 3:
            break
    segments = [n for n in os.listdir("/dev/shm") if n.startswith("ptt")]
    want = [b for _, b in zip(range(4), sync)]
    equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                for a, b in zip(got, want))
    pids = sorted(set(int(p) for b in got for p in b[2].flatten()))
    check(equal and len(got) == 4, "resnet data: process batches differ "
          "from the in-process loader's")
    check(os.getpid() not in pids and len(pids) == cfg["num_workers"],
          f"resnet data: items loaded by pids {pids} (parent "
          f"{os.getpid()})")
    check(not segments, f"resnet data: shared memory left after an early "
          f"break: {segments[:4]}")
    # the negative control: this process holds a CUDA context, so a
    # worker whose dataset calls CUDA fails, and the loader raises with
    # the worker's traceback (a worker never reaches the card)
    try:
        list(io.DataLoader(_CudaInWorker(), batch_size=2, num_workers=2,
                           use_shared_memory=True))
        cuda_error = None
    except RuntimeError as e:
        cuda_error = str(e)
    check(cuda_error is not None and "in __getitem__" in cuda_error
          and "forked subprocess" in cuda_error,
          f"resnet data: a CUDA call in a worker gave {cuda_error!r}")
    # the augmented pipeline feeding the f32 step
    aug = datasets.Cifar10(
        mode="train", backend="synthetic",
        synthetic_size=cfg["synthetic_size"],
        transform=T.Compose([T.RandomCrop(32, padding=4),
                             T.RandomHorizontalFlip(), T.ToTensor(), norm]))
    loader = io.DataLoader(aug, batch_size=RESNET_BATCH, shuffle=True,
                           drop_last=True, num_workers=cfg["num_workers"],
                           use_shared_memory=True)
    model = resnet50(num_classes=10, seed=0)
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters(), weight_decay=5e-4)
    ce = nn.CrossEntropyLoss()
    step = TrainStep(model, lambda m, xb, yb: ce(m(xb), yb), opt)
    waits, losses = [], []
    it = iter(loader)
    t_start = None
    for i in range(len(loader)):
        t0 = time.perf_counter()
        xb, yb = next(it)
        waits.append(time.perf_counter() - t0)
        if i == 1:       # after the first step: workers warm, step built
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(step(xb, yb))
    torch.cuda.synchronize()
    steady = len(loader) - 1
    secs = time.perf_counter() - t_start
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"resnet data: losses {losses}")
    rec = {"batches": len(loader), "workers": cfg["num_workers"],
           "images_per_s": steady * RESNET_BATCH / secs,
           "fixed_batch_images_per_s": fixed_images_s,
           "wait_ms_per_step": float(np.mean(waits[1:]) * 1e3),
           "first_wait_ms": waits[0] * 1e3, "losses": losses,
           "worker_pids": pids, "equal_to_in_process": equal,
           "cuda_in_worker_error": cuda_error.strip().splitlines()[-1]}
    rec["vs_fixed_batch"] = rec["images_per_s"] / fixed_images_s
    log(f"[resnet] data path: {rec['images_per_s']:.0f} images/s over "
        f"{steady} steps ({rec['vs_fixed_batch']:.3f} of the fixed batch's "
        f"{fixed_images_s:.0f}); waiting in next() "
        f"{rec['wait_ms_per_step']:.2f} ms a step (first "
        f"{rec['first_wait_ms']:.1f} ms); workers {pids}; 4 batches equal "
        f"to the in-process loader's; no segment left after a break")
    del model, opt, step, loader, it
    return rec


def phase_resnet(torch):
    """``resnet``: BASELINE config #1, ``bench.py``'s ``bench_resnet``:
    ResNet-50 (23.5M parameters from seed 0, 10 classes) on the bench's
    batch of 128 32 x 32 images, Momentum(0.1, 0.9, weight_decay 5e-4),
    cross entropy, through ``jit.TrainStep`` in f32 (TF32 off) and amp O2
    bf16, 40 steps each (1 + 3 + 10 timed, then on to 40: lr 0.1 first
    throws the loss up). Gates: the f32 first step against the CPU and
    the pinned f64 step (``_resnet_first_step``) and the running
    statistics against the JAX formula over the batch; O2's first step
    unit by unit against pinned f64 units (``_resnet_o2_units``) and its
    forward against f32 after the stem and layer1; losses finite and
    falling; the eval forward on the running statistics (the CPU's
    within 1e-3 in f32), leaving them as they were; no hand kernel
    launched. Recorded: step ms, images/s, MFU (64.1 GFLOP a step, f32
    against 67e12, bf16 against 989e12), peak memory, one profiled step
    (device ms by family, kernels, busy share), cudnn.benchmark. Then
    the data path (``_resnet_data``)."""
    result = {"launches": {}}
    ref = None
    for name in RESNET_MODES:
        rec, got = _resnet_mode(torch, name, ref)
        result[name] = rec
        ref = ref or got
        for key, n in rec["launches"].items():
            result["launches"][key] = result["launches"].get(key, 0) + n
    result["f32_vs_o2_step_ms"] = (result["f32"]["step_ms"]
                                   / result["o2_bf16"]["step_ms"])
    result["data"] = _resnet_data(torch, result["f32"]["images_per_s"])
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------ resumable training
# train_resume: full width, depth cut to 1 layer (183M parameters; a
# checkpoint of weights, f32 masters and both moments ~2.9 GB; 2 layers
# and ~3.7 GB until the jit phase joined the script), 12 x 1024 tokens a
# step, 6 steps over 48 seeded sequences (4 steps an epoch, so every run
# crosses an epoch boundary)
RESUME_CFG = dict(TRAIN_CFG, num_hidden_layers=1)
RESUME_STEPS = 6
RESUME_SEQS = 48
RESUME_SEED = 11


def _tree_digest(torch, sd):
    """sha256 over one state dict's tensors' bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k]
        if isinstance(v, torch.Tensor):
            h.update(k.encode())
            h.update(v.detach().contiguous().cpu().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def train_worker_main(spec_path, out_path):
    """One life of a ``train_resume`` job, run as its own process
    (``chip_smoke.py --train-worker SPEC OUT``): the resume cell's model
    (O2 via ``amp.decorate``, bf16 or float16 with a ``GradScaler``),
    AdamW with masters under ``LinearWarmup`` over
    ``CosineAnnealingDecay`` and ``ClipGradByGlobalNorm``, a seeded
    ``DataLoader`` (``RandomSampler(seed=)``, ``BatchSampler``) and a
    ``TrainLoop`` on the spec's checkpoint directory (auto-resume,
    ``save_every``). The spec may plant a ``train.step`` fault or stall a
    step under a ``CommWatchdog``. Prints ``STEP n`` after each step;
    writes its record (losses, scales, digests of the final weights and
    optimizer state, checkpoint and restore times, launches) to OUT on
    any exit."""
    import torch

    sys.path.insert(0, REPO)
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.distributed.watchdog import CommWatchdog
    from paddle_tpu_torch.io import (
        BatchSampler,
        DataLoader,
        RandomSampler,
        TensorDataset,
    )
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    from paddle_tpu_torch.resilience import (
        FaultSpec,
        TrainLoop,
        TrainState,
        faults,
    )

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = spec["dtype"]
    rec = {"spec": spec, "losses": [], "scales": [], "skipped": 0}
    model = LlamaForCausalLM(LlamaConfig(**dict(RESUME_CFG,
                                                dtype="float32")), seed=0)
    rec["params"] = model.num_params()
    amp.decorate(model, level="O2", dtype=dtype)
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4,
                                                    T_max=RESUME_STEPS),
                            warmup_steps=2, start_lr=0.0, end_lr=3e-4)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0),
                multi_precision=True)
    scaler = (amp.GradScaler(init_loss_scaling=2.0 ** 16)
              if dtype == "float16" else None)
    tokens = np.random.RandomState(RESUME_SEED).randint(
        0, RESUME_CFG["vocab_size"], (RESUME_SEQS, TRAIN_SEQ))
    ds = TensorDataset([tokens])
    loader = DataLoader(ds, batch_sampler=BatchSampler(
        sampler=RandomSampler(ds, seed=RESUME_SEED),
        batch_size=TRAIN_BATCH, drop_last=True))
    state = TrainState(model=model, optimizer=opt, scaler=scaler,
                       dataloader=loader)
    real_save, real_load = state.save, state.load

    def timed_save(path, keep_last_k=2, emergency=False):
        t0 = time.perf_counter()
        real_save(path, keep_last_k=keep_last_k, emergency=emergency)
        ms = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(path, "latest")) as f:
            d = os.path.join(path, f.read().strip())
        nbytes = sum(os.path.getsize(os.path.join(d, n))
                     for n in os.listdir(d))
        rec.setdefault("saves", []).append(
            {"step": state.step, "emergency": emergency, "ms": ms,
             "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6})
        return ms / 1e3

    def timed_load(path):
        before = checkpoint._fallbacks.value
        t0 = time.perf_counter()
        real_load(path)
        torch.cuda.synchronize()
        rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
        rec["restored_step"] = state.step
        rec["restore_fallbacks"] = checkpoint._fallbacks.value - before
        return state

    state.save, state.load = timed_save, timed_load

    def step_fn(batch, st):
        if spec.get("stall_at") == st.step:
            time.sleep(spec["stall_s"])     # past the watchdog's deadline
        ids = batch[0]
        with amp.auto_cast(True, level="O2", dtype=dtype):
            loss = model(ids, labels=ids)[1]
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            rec["skipped"] += int(scaler._found_inf)
            scaler.update()
            rec["scales"].append(scaler.get_scale_ratio())
        opt.clear_grad()
        sched.step()
        rec["losses"].append(loss.item())        # syncs the step
        if "first_step_ms" not in rec:
            rec["first_step_ms"] = (time.perf_counter() - t_run) * 1e3
            rec["first_step_done_at"] = time.time()
        print(f"STEP {st.step + 1}", flush=True)

    wd = None
    if spec.get("step_timeout"):
        wd = CommWatchdog(timeout=spec["step_timeout"], poll_interval=0.05)
    loop = TrainLoop(state, step_fn, spec["dir"],
                     save_every=spec.get("save_every"), keep_last_k=2,
                     watchdog=wd, step_timeout=spec.get("step_timeout"),
                     hang_grace=30.0)
    inject = ({"train.step": FaultSpec(
        RuntimeError("injected train.step fault"), at=spec["fault_at"])}
        if spec.get("fault_at") else {})
    code = 0
    try:
        with faults.inject(inject):
            t_run = time.perf_counter()
            loop.run(RESUME_STEPS)
        torch.cuda.synchronize()
        rec["model_digest"] = _tree_digest(torch, model.state_dict())
        rec["opt_digest"] = _tree_digest(torch, opt.state_dict())
        rec["scaler_state"] = scaler.state_dict() if scaler else None
    except SystemExit as e:
        code = e.code
        raise
    except BaseException as e:
        code = 1
        rec["error"] = repr(e)
        raise
    finally:
        rec.update(code=code, final_step=state.step,
                   launches=dict(_build.launch_counts(),
                                 **_build.variant_counts()),
                   peak_bytes=torch.cuda.max_memory_allocated())
        if wd is not None:
            wd.shutdown()
        with open(out_path, "w") as f:
            json.dump(rec, f)
    return 0


class _Worker:
    """A running ``--train-worker`` process and its files."""

    def __init__(self, tmp, name, **spec):
        self.name = name
        self.spec = dict(spec, dtype=spec.get("dtype", "bfloat16"))
        self.spec_path = os.path.join(tmp, f"{name}.spec.json")
        self.out_path = os.path.join(tmp, f"{name}.out.json")
        with open(self.spec_path, "w") as f:
            json.dump(self.spec, f)
        self.t_start = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--train-worker",
             self.spec_path, self.out_path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.killed_at = None

    def sigterm_after(self, n):
        """Send SIGTERM once the worker reports step ``n`` done."""
        import signal

        for line in self.proc.stdout:
            if line.strip() == f"STEP {n}":
                self.killed_at = time.time()
                self.proc.send_signal(signal.SIGTERM)
                return
        raise PhaseError(f"train_resume {self.name}: the worker ended "
                         f"before step {n}")

    def finish(self, want_code):
        """Wait (bounded), then the worker's record; fails the phase if
        it exited with another code than ``want_code``."""
        try:
            _, err = self.proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise PhaseError(f"train_resume {self.name}: timed out")
        rec = {}
        if os.path.exists(self.out_path):
            with open(self.out_path) as f:
                rec = json.load(f)
        rec["stderr"] = err
        rec["wall_s"] = time.time() - self.t_start
        check(self.proc.returncode == want_code,
              f"train_resume {self.name}: exit {self.proc.returncode}, "
              f"want {want_code}: {err[-2000:]}")
        return rec


def _ckpt_meta(path):
    """The python values of the checkpoint ``latest`` names under
    ``path`` (its train.* counters) and that checkpoint's directory."""
    with open(os.path.join(path, "latest")) as f:
        d = os.path.join(path, f.read().strip())
    with open(os.path.join(d, "metadata.json")) as f:
        return json.load(f)["python_values"], d


def phase_train_resume(torch):
    """``train_resume``: worker processes train the resume cell (full
    width, 1 layer) with O2 bf16 (float16 + GradScaler in gate 6) and
    are stopped and resumed. Gates, every resumed run's final weights and
    optimizer state bit-identical (sha256 over each tensor's bytes) to
    the uninterrupted run's:
      1. two uninterrupted runs are bit-identical (determinism);
      2. SIGTERM mid-run: exit 76 with a verified emergency checkpoint; a
         fresh process resumes from it;
      3. a seeded ``train.step`` fault kills a worker (exit 1); the resume
         starts from the last periodic checkpoint;
      4. gate 3's job resumed, its first step stalled past
         ``CommWatchdog(step_timeout=)``: exit 68, and a fresh process
         resumes it (from the checkpoint of gate 5);
      5. that job's newest checkpoint torn (bytes flipped in its
         data.npz): the resume falls back to the previous one, counted;
      6. float16 O2 + GradScaler, SIGTERM and resume: weights and scaler
         state equal the uninterrupted float16 run's.
    Recorded: emergency checkpoint ms, bytes and GB/s, restore ms, the
    resumed incarnation's restore + first step (``bench.py``'s
    ``train_resume_ms``), SIGTERM to the first resumed step, the phase's
    seconds."""
    import shutil
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    # the checkpoints go where there is more room: the temporary
    # directory or the checkout's build directory (one checkpoint with
    # the v1 view is ~7.4 GB; at most one job's directory exists at once)
    roots = [tempfile.gettempdir(), os.path.join(REPO, "build")]
    os.makedirs(roots[1], exist_ok=True)
    root = max(roots, key=lambda r: shutil.disk_usage(r).free)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_", dir=root)
    free = shutil.disk_usage(tmp).free
    result = {"ckpt_root": root, "ckpt_root_free_bytes": free,
              "launches": {}}
    d = {k: os.path.join(tmp, k) for k in ("C", "D", "F")}
    recs = {}

    def done(w, code):
        recs[w.name] = r = w.finish(code)
        for key, n in r.get("launches", {}).items():
            result["launches"][key] = result["launches"].get(key, 0) + n
        return r

    def same_state(r, ref):
        return (r["model_digest"], r["opt_digest"]) == (
            ref["model_digest"], ref["opt_digest"])

    try:
        # the two reference runs (bf16, float16) beside the fault job
        ws = [_Worker(tmp, "A", dir=os.path.join(tmp, "A")),
              _Worker(tmp, "B", dir=os.path.join(tmp, "B")),
              _Worker(tmp, "F1", dir=os.path.join(tmp, "F1"),
                      dtype="float16"),
              _Worker(tmp, "D1", dir=d["D"], save_every=2, fault_at=5)]
        ra, rb, rf1, rd1 = (done(w, c) for w, c in zip(ws, (0, 0, 0, 1)))
        check(same_state(rb, ra) and rb["losses"] == ra["losses"],
              f"train_resume gate 1: two uninterrupted runs differ "
              f"(losses {ra['losses']} / {rb['losses']})")
        check("injected train.step fault" in rd1["stderr"]
              and rd1["final_step"] == 4
              and _ckpt_meta(d["D"])[0]["train.step"] == 4,
              f"train_resume gate 3: the fault worker stopped at step "
              f"{rd1['final_step']}: {rd1['stderr'][-2000:]}")
        # the resume of gate 3 beside the float16 job's SIGTERM
        d2 = _Worker(tmp, "D2", dir=d["D"])
        f2 = _Worker(tmp, "F2", dir=d["F"], dtype="float16")
        f2.sigterm_after(3)
        rd2, rf2 = done(d2, 0), done(f2, 76)
        check(rd2["restored_step"] == 4 and same_state(rd2, ra),
              f"train_resume gate 3: resumed at {rd2['restored_step']} "
              f"(want 4), final state equal: {same_state(rd2, ra)}")
        # gate 4 on the same job: resumed at step 4, its first step
        # stalls past the watchdog's deadline; beside it the float16
        # resume (gate 6)
        e1 = _Worker(tmp, "E1", dir=d["D"], stall_at=4, stall_s=8.0,
                     step_timeout=5.0)
        f3 = _Worker(tmp, "F3", dir=d["F"], dtype="float16")
        re1, rf3 = done(e1, 68), done(f3, 0)
        check("[comm_watchdog]" in re1["stderr"] and "step 4 stuck" in
              re1["stderr"] and re1["restored_step"] == 4
              and re1["final_step"] == 4,
              f"train_resume gate 4: the stalled worker: "
              f"{re1['stderr'][-2000:]}")
        check(rf2["saves"][-1]["emergency"]
              and rf3["restored_step"] == rf2["saves"][-1]["step"]
              and same_state(rf3, rf1)
              and rf3["scaler_state"] == rf1["scaler_state"],
              f"train_resume gate 6: float16 resume at step "
              f"{rf3['restored_step']}: scaler {rf3['scaler_state']} vs "
              f"{rf1['scaler_state']}, state equal: "
              f"{same_state(rf3, rf1)}")
        shutil.rmtree(d["F"], ignore_errors=True)
        # gate 5: tear the newest checkpoint (bytes flipped mid-file);
        # the resume of the stalled job falls back to the one before
        raw = os.path.join(_ckpt_meta(d["D"])[1], "data.npz")
        with open(raw, "r+b") as fh:
            fh.seek(os.path.getsize(raw) // 2)
            fh.write(b"\xff" * 4096)
        re2 = done(_Worker(tmp, "E2", dir=d["D"]), 0)
        check(re2["restore_fallbacks"] == 1 and re2["restored_step"] == 2
              and same_state(re2, ra),
              f"train_resume gates 4 and 5: fallbacks "
              f"{re2['restore_fallbacks']}, restored step "
              f"{re2['restored_step']} (want 1, 2), final state equal: "
              f"{same_state(re2, ra)}")
        shutil.rmtree(d["D"], ignore_errors=True)

        # gate 2 last and alone, as it is timed
        c1 = _Worker(tmp, "C1", dir=d["C"])
        c1.sigterm_after(3)
        rc1 = done(c1, 76)
        c_meta, _ = _ckpt_meta(d["C"])
        emergency = rc1["saves"][-1]
        check(emergency["emergency"] and c_meta["train.emergency"] is True
              and c_meta["train.step"] == emergency["step"]
              and "emergency checkpoint saved" in rc1["stderr"],
              f"train_resume gate 2: no emergency checkpoint: "
              f"{rc1['stderr'][-2000:]}")
        rc2 = done(_Worker(tmp, "C2", dir=d["C"]), 0)
        check(rc2["restored_step"] == emergency["step"]
              and same_state(rc2, ra),
              f"train_resume gate 2: resumed at {rc2['restored_step']}, "
              f"final state equal: {same_state(rc2, ra)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result.update({
        "params": ra["params"], "reference_losses": ra["losses"],
        "f16_losses": rf1["losses"], "f16_scales": rf1["scales"],
        "f16_skipped_steps": rf1["skipped"],
        "f16_scaler_state": rf1["scaler_state"],
        "emergency_ckpt": emergency,
        "emergency_step": emergency["step"],
        "restore_ms": rc2["restore_ms"],
        "train_resume_ms": rc2["first_step_ms"],
        "kill_to_first_resumed_step_ms":
            (rc2["first_step_done_at"] - c1.killed_at) * 1e3,
        "periodic_saves": rd1["saves"],
        "worker_wall_s": {n: r["wall_s"] for n, r in recs.items()},
        "peak_bytes": max(x["peak_bytes"] for x in (ra, rc2, rf1)),
    })
    log(f"[train_resume] gates 1-6 hold; emergency checkpoint at step "
        f"{emergency['step']}: {emergency['ms']:.1f} ms, "
        f"{emergency['bytes']} B ({emergency['gb_per_s']:.3f} GB/s); "
        f"restore {rc2['restore_ms']:.1f} ms; restore + first step "
        f"{rc2['first_step_ms']:.1f} ms; SIGTERM to first resumed step "
        f"{result['kill_to_first_resumed_step_ms']:.1f} ms; float16 "
        f"scales {rf1['scales']}, skipped {rf1['skipped']}; "
        f"{free / 2**30:.1f} GiB free under {root}")
    return result


# ------------------------------------------------------------------- moe
def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def plain_gmm(gk):
    """Inside: ``grouped_matmul`` computes with its plain version (the
    comparison runs only)."""
    saved = gk.grouped_matmul
    gk.grouped_matmul = gk.grouped_matmul_ref
    try:
        yield
    finally:
        gk.grouped_matmul = saved


@contextlib.contextmanager
def int8_on_mma(gk):
    """Inside: int8 rhs takes the mma.sync kernel at every size (the
    comparison's timing only)."""
    saved = gk.INT8_WGMMA_MIN_MACS
    gk.INT8_WGMMA_MIN_MACS = float("inf")
    try:
        yield
    finally:
        gk.INT8_WGMMA_MIN_MACS = saved


def _forward_ms(torch, fn, iters=10):
    """Host-clock ms of ``fn`` ending in a synchronize, after 3 warm-ups."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_moe(torch):
    """bench_kernels' MoE layer (ragged and dense, float and int8
    experts) and bench_moe's level-0 Llama MoE forward, bf16. Launches
    on this path: the ragged forward, the int8 forward and the Llama MoE
    forward, each counted from 0; the comparisons and the backward are
    not counted."""
    import copy

    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import grouped_matmul as gk
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_moe_experts

    gc.collect()
    torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    e, k = MOE_LAYER["num_experts"], MOE_LAYER["k"]
    ragged = MoELayer(**MOE_LAYER, impl="ragged", dtype=bf16, seed=0)
    # capacity e / k: the dense path can drop nothing
    dense = MoELayer(**MOE_LAYER, impl="dense", capacity_factor=e / k,
                     dtype=bf16, seed=1)
    dense.load_state_dict(ragged.state_dict())
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(MOE_BATCH, MOE_SEQ, MOE_LAYER["d_model"], generator=g,
                    device="cuda").to(bf16)
    tokens = MOE_BATCH * MOE_SEQ
    path = {}

    def count_into(counts):
        for name, n in counts.items():
            path[name] = path.get(name, 0) + n

    # ragged forward: 3 grouped GEMM launches
    with torch.no_grad():
        _build.reset_launch_counts()
        out, aux = ragged(x)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        count_into(counts)
        count_into(_build.variant_counts())
        check(counts["grouped_matmul"] == 3,
              f"moe: ragged forward launched {counts}")
        with plain_gmm(gk):
            out_p, aux_p = ragged(x)
        ok, stats = compare(out, out_p)
        check(ok, f"moe: ragged forward vs plain grouped GEMM {stats}")
        del out_p, aux_p
        out_d, aux_d, st_d = dense(x, return_stats=True)
        dense_l2 = _rel_l2(out, out_d)
        check(int(st_d["dropped_assignments"]) == 0 and
              dense_l2 <= MOE_DENSE_L2 and aux.item() == aux_d.item(),
              f"moe: ragged vs dense: relative L2 {dense_l2}, aux "
              f"{aux.item()} vs {aux_d.item()}, dropped "
              f"{int(st_d['dropped_assignments'])}")
    layer_aux = aux.item()
    log(f"[moe] ragged forward: 3 grouped_matmul launches; vs plain "
        f"{json.dumps(stats)}; vs dense relative L2 {dense_l2:.3g}, aux "
        f"{layer_aux:.6f} both")

    # ragged backward, every parameter and the input, kernel vs plain
    wgt = torch.randn(x.shape, generator=g, device="cuda")

    def grads():
        ragged.zero_grad(set_to_none=True)
        xi = x.detach().clone().requires_grad_()
        o, a = ragged(xi)
        ((o.float() * wgt).sum() + a).backward()
        got = {n: p.grad.float() for n, p in ragged.named_parameters()}
        got["input"] = xi.grad.float()
        return got

    g_k = grads()
    with plain_gmm(gk):
        g_p = grads()
    grad_l2 = {n: _rel_l2(g_k[n], g_p[n]) for n in g_p}
    worst = max(grad_l2, key=grad_l2.get)
    check(all(np.isfinite(list(grad_l2.values()))) and
          grad_l2[worst] <= MOE_GRAD_L2,
          f"moe: gradient of {worst} differs from the plain grouped GEMM "
          f"by {grad_l2[worst]} > {MOE_GRAD_L2}")
    ragged.zero_grad(set_to_none=True)
    del g_k, g_p
    log(f"[moe] ragged backward vs plain: relative L2 {json.dumps(grad_l2)}")

    # speed: ragged and dense forward tokens/s (the card's counterpart of
    # bench.py's moe_ragged_vs_dense_speedup)
    with torch.no_grad():
        ragged_ms = _forward_ms(torch, lambda: ragged(x))
        dense_ms = _forward_ms(torch, lambda: dense(x))
    del dense
    speed = {"ragged_ms": ragged_ms, "dense_ms": dense_ms,
             "ragged_tokens_per_s": tokens / ragged_ms * 1e3,
             "dense_tokens_per_s": tokens / dense_ms * 1e3,
             "ragged_vs_dense_speedup": dense_ms / ragged_ms}
    log(f"[moe] forward, {tokens} tokens: ragged {ragged_ms:.3f} ms "
        f"({speed['ragged_tokens_per_s']:.0f} tokens/s), dense "
        f"{dense_ms:.3f} ms ({speed['dense_tokens_per_s']:.0f} tokens/s), "
        f"ragged/dense speedup {speed['ragged_vs_dense_speedup']:.3f}x")

    # int8 experts: 3 grouped_matmul_quant launches, against plain int8
    # and the float layer; a gradient through them raises on the card
    quant = copy.deepcopy(ragged)
    saved = quantize_moe_experts(quant)
    with torch.no_grad():
        _build.reset_launch_counts()
        out_q, _ = quant(x)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        count_into(counts)
        count_into(_build.variant_counts())
        variants = _build.variant_counts()
        check(counts["grouped_matmul_quant"] == 3
              and variants.get("grouped_matmul_quant/wgmma", 0) == 3,
              f"moe: int8 forward launched {counts} {variants}")
        with plain_gmm(gk):
            out_qp, _ = quant(x)
        ok_q, stats_q = compare(out_q, out_qp)
        int8_l2 = _rel_l2(out_q, out)
        check(ok_q and int8_l2 <= MOE_INT8_L2,
              f"moe: int8 experts vs plain {stats_q}, vs float relative "
              f"L2 {int8_l2}")
        int8_ms = _forward_ms(torch, lambda: quant(x))
        # the same forward on the mma.sync int8 kernel (the wrapper's
        # choice before the int8 wgmma kernel), in the same run
        with int8_on_mma(gk):
            int8_mma_ms = _forward_ms(torch, lambda: quant(x))
    try:
        quant(x.detach().clone().requires_grad_())
    except RuntimeError as err:
        check("inference-only" in str(err), f"moe: int8 grad guard: {err}")
    else:
        raise PhaseError("moe: int8 experts gave an output needing a "
                         "gradient")
    log(f"[moe] int8 experts (saved {saved} bytes): 3 grouped_matmul_quant "
        f"launches (wgmma); vs plain {json.dumps(stats_q)}; vs float "
        f"relative L2 {int8_l2:.4f}; forward {int8_ms:.3f} ms (on the "
        f"mma.sync kernel {int8_mma_ms:.3f} ms); a gradient raises")
    del quant, ragged
    gc.collect()
    torch.cuda.empty_cache()

    # float16: the ragged layer and its int8 experts, 3 launches each on
    # the wgmma kernels, against the plain grouped GEMM
    f16 = {}
    half = MoELayer(**MOE_LAYER, impl="ragged", dtype=torch.float16, seed=0)
    xh = x.to(torch.float16)
    with torch.no_grad():
        for tag, layer, name in (
                ("ragged", half, "grouped_matmul"),
                ("int8", None, "grouped_matmul_quant")):
            if layer is None:
                layer = copy.deepcopy(half)
                quantize_moe_experts(layer)
            _build.reset_launch_counts()
            out_h, _ = layer(xh)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            variants = _build.variant_counts()
            count_into(counts)
            count_into(variants)
            check(counts[name] == 3
                  and variants.get(f"{name}/wgmma", 0) == 3,
                  f"moe: float16 {tag} forward launched {counts} {variants}")
            with plain_gmm(gk):
                out_hp, _ = layer(xh)
            ok_h, stats_h = compare(out_h, out_hp)
            check(ok_h and bool(out_h.isfinite().all()),
                  f"moe: float16 {tag} forward vs plain {stats_h}")
            f16[tag] = {"vs_plain": stats_h,
                        "forward_ms": _forward_ms(torch, lambda: layer(xh)),
                        "vs_bf16_rel_l2": _rel_l2(out_h, out)}
            log(f"[moe] float16 {tag} forward: 3 {name} launches (wgmma); "
                f"vs plain {json.dumps(stats_h)}; forward "
                f"{f16[tag]['forward_ms']:.3f} ms")
            del layer
    del half
    gc.collect()
    torch.cuda.empty_cache()

    # bench_moe level 0: one no-grad forward with labels, 2 x 1024 tokens
    model = LlamaForCausalLM(LlamaConfig(**MOE_LLAMA_CFG), seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, MOE_LLAMA_CFG["vocab_size"], (2, 1024))).to("cuda")
    with torch.no_grad():
        _build.reset_launch_counts()
        _, loss = model(ids, labels=ids)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        count_into(counts)
        count_into(_build.variant_counts())
        with plain_attention(fa):
            _, loss_p = model(ids, labels=ids)
        _, aux = model.llama(ids)
    L = MOE_LLAMA_CFG["num_hidden_layers"]
    check(counts["flash_attention"] == L,
          f"moe: Llama MoE forward flash launches {counts}, want {L}")
    check(np.isfinite(loss.item()) and
          abs(loss.item() - loss_p.item()) <= TRAIN_LOSS_TOL,
          f"moe: Llama MoE loss {loss.item()} vs plain attention "
          f"{loss_p.item()}")
    llama = {"params": model.num_params(), "loss": loss.item(),
             "plain_loss": loss_p.item(), "aux": aux.item(),
             "launches": counts}
    log(f"[moe] Llama MoE ({model.num_params() / 1e6:.1f}M params bf16, "
        f"{L} layers): loss {loss.item():.5f} (aux {aux.item():.4f}) vs "
        f"{loss_p.item():.5f} with plain attention; launches {counts}")
    del model
    torch.cuda.empty_cache()
    log(f"[moe] launches on the path {path}")
    return {"layer": MOE_LAYER, "tokens": tokens,
            "forward_vs_plain": stats, "dense_rel_l2": dense_l2,
            "aux": layer_aux, "grad_rel_l2": grad_l2,
            "int8_vs_plain": stats_q, "int8_vs_float_rel_l2": int8_l2,
            "int8_bytes_saved": saved, "int8_forward_ms": int8_ms,
            "int8_forward_mma_ms": int8_mma_ms, "float16": f16,
            **speed, "llama_moe": llama, "launches": path}


# ----------------------------------------------------------- MoE training
# moe_train: bench_moe's level-0 Llama MoE trained with AdamW (1 + 3
# warm-up + 10 timed steps, as the train phase), and the ragged MoE layer
# trained through the grouped GEMM kernels: 3 forward launches
# (grouped_matmul/wgmma), 3 for dlhs on the transposed instance
# (grouped_matmul/wgmma_t) and 3 of the weight-gradient kernel
# (grouped_matmul_wgrad/wgmma) a step
MOE_TRAIN_BATCH = 8
MOE_LAYER_STEPS = 6
MOE_LAYER_LAUNCHES = {"grouped_matmul/wgmma": 3, "grouped_matmul/wgmma_t": 3,
                      "grouped_matmul_wgrad/wgmma": 3}
# the planted faults, in drhs and in dlhs: the f32 sums 1 % off (a
# relative L2 of 1e-2, the bf16 gate's limit, before the cast's rounding
# adds to it)
MOE_WGRAD_PLANT = 1.01
MOE_DLHS_PLANT = 1.01


def _plain_forward(gk):
    """``gk._forward``'s plain counterpart: ``grouped_matmul_ref``, on
    ``rhs.transpose(1, 2)`` for the transposed instance."""
    def forward(lhs, rhs, group_sizes, rhs_scales=None, trans_rhs=False):
        if trans_rhs:
            rhs = rhs.transpose(1, 2)
        return gk.grouped_matmul_ref(lhs, rhs, group_sizes, rhs_scales)
    return forward


@contextlib.contextmanager
def plain_gmm_autograd(gk):
    """Inside: the grouped GEMM op runs the plain forward and dlhs
    (``grouped_matmul_ref``, on the transposed view for dlhs) and the
    plain weight gradient (``_segment_outer``): the comparison's step."""
    saved = gk._forward, gk.grouped_matmul_wgrad
    gk._forward = _plain_forward(gk)
    gk.grouped_matmul_wgrad = gk._segment_outer
    try:
        yield
    finally:
        gk._forward, gk.grouped_matmul_wgrad = saved


@contextlib.contextmanager
def sync_free_gmm(torch, gk):
    """Inside: every grouped GEMM call (forward, dlhs through the same
    entry with ``trans_rhs``, drhs) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read of the
    group sizes there raises."""
    saved = gk._forward, gk.grouped_matmul_wgrad

    def guarded(fn):
        def call(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    gk._forward = guarded(saved[0])
    gk.grouped_matmul_wgrad = guarded(saved[1])
    try:
        yield
    finally:
        gk._forward, gk.grouped_matmul_wgrad = saved


@contextlib.contextmanager
def routing(moe_ops, record, replay=False):
    """Inside: the MoE router's top-k choices are appended to ``record``
    call by call, or with ``replay`` taken from it in the same order (the
    gates and combine weights still computed from this run's logits):
    the comparison step takes the kernel step's discrete decisions, as
    the resnet phase pins its ReLU decisions."""
    real = moe_ops._route
    replayed = iter(record)

    def route(gate_logits, k):
        if replay:
            idx = next(replayed)
            gates = gate_logits.float().softmax(dim=-1)
            return gates, gates.gather(-1, idx), idx
        gates, vals, idx = real(gate_logits, k)
        record.append(idx)
        return gates, vals, idx

    moe_ops._route = route
    try:
        yield
    finally:
        moe_ops._route = real


def _moe_llama_train(torch):
    """bench_moe level 0 on the card: vocab 32000, hidden 1024, 8 layers,
    8 experts top-2 (impl dense), bf16 weights, AdamW 3e-4, 8 x 1024
    tokens a step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import moe_ops
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**MOE_LLAMA_CFG)
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, seed=0)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters())
    step = TrainStep(model, _lm_loss, opt)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (MOE_TRAIN_BATCH, 1024))).to("cuda")
    n = model.num_params()
    # bench.py's count: every parameter but the (e - k) idle experts' FFNs
    expert = 3 * cfg.hidden_size * cfg.intermediate_size
    active = n - L * (cfg.num_experts - cfg.num_experts_per_tok) * expert

    def loss_and_grads():
        for p in model.parameters():
            p.grad = None
        loss = _lm_loss(model, ids)
        loss.backward()
        grads = {k: p.grad.float() for k, p in model.named_parameters()
                 if p.grad is not None}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    # the first step with plain attention takes the kernel step's routing
    # (top-2 of 8 flips for a few tokens on differences at bf16 rounding,
    # and a flip moves the expert weights' gradients by more than the
    # kernels do); how many it would flip is recorded
    decisions, unpinned = [], []
    with routing(moe_ops, decisions):
        loss_k, g_k = loss_and_grads()
    with plain_attention(fa), routing(moe_ops, decisions, replay=True):
        loss_p, g_p = loss_and_grads()
    with torch.no_grad(), plain_attention(fa), routing(moe_ops, unpinned):
        _lm_loss(model, ids)
    flips = sum(int((a != b).sum()) for a, b in zip(decisions, unpinned))
    rel = {k: _rel_l2(g_k[k], g_p[k]) for k in g_p}
    del g_k, g_p
    worst = max(rel, key=rel.get)
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          f"moe_train: first-step loss {loss_k} vs plain attention "
          f"{loss_p}")
    check(all(np.isfinite(list(rel.values()))) and
          rel[worst] <= TRAIN_GRAD_RTOL,
          f"moe_train: gradient of {worst} differs from plain attention "
          f"by {rel[worst]} > {TRAIN_GRAD_RTOL}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(ids)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses += [step(ids) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(ids) for _ in range(10)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    counts = _build.launch_counts()
    variants = _build.variant_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"moe_train: losses {losses}")
    check(all(counts[k] == 14 * L for k in FLASH),
          f"moe_train: flash launches {_flash_counts(counts)} over 14 "
          f"steps, want {L} of each a step")
    tokens_s = MOE_TRAIN_BATCH * 1024 / (step_ms / 1e3)
    mfu = tokens_s * 6 * active / BF16_FLOPS
    prof = _profiled_step(torch, step, ids)
    rec = {"params": n, "active_params": active, "batch": MOE_TRAIN_BATCH,
           "seq": 1024, "first_step_s": first_s, "step_ms": step_ms,
           "tokens_per_s": tokens_s, "mfu_active": mfu, "peak_bytes": peak,
           "losses": losses, "launches": dict(counts, **variants),
           "grad_check": {"loss": loss_k, "plain_loss": loss_p,
                          "worst_rel_l2": rel[worst], "worst_param": worst,
                          "median_rel_l2": float(np.median(
                              list(rel.values()))),
                          "routing_flips_unpinned": flips,
                          "routing_decisions": sum(
                              d.numel() for d in decisions)},
           "profile": prof}
    log(f"[moe_train] Llama MoE {n / 1e6:.1f}M params ({active / 1e6:.1f}M "
        f"active) bf16, {L} layers, batch {MOE_TRAIN_BATCH} x 1024: "
        f"{step_ms:.2f} ms/step, {tokens_s:.0f} tokens/s, active MFU "
        f"{mfu * 100:.2f}% of {BF16_FLOPS / 1e12:.0f} TFLOP/s, peak "
        f"{peak / 2**30:.2f} GiB; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; first step vs plain attention: loss {loss_k:.5f}"
        f" vs {loss_p:.5f}, worst gradient {rel[worst]:.3g} ({worst}) with "
        f"the routing pinned ({flips} of "
        f"{sum(d.numel() for d in decisions)} top-2 choices flip "
        f"unpinned)")
    log(f"[moe_train] profiled step: device {prof['device_ms']:.2f} ms in "
        f"{prof['kernel_launches']} kernels; by family " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(prof["families_ms"].items())))
    for name, ms, c in prof["top"]:
        log(f"[moe_train]   {name:80s} {ms:9.3f} ms {c:5d} calls")
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _moe_layer_family(key):
    """A ragged layer step's kernel by part: the grouped GEMM forward, its
    transposed instance (``dlhs``), the weight gradient, AdamW's foreach
    kernels, and the rest (routing, dispatch, SwiGLU, the loss)."""
    if "gmm_wgrad" in key:
        return "weight_gradient"
    if "gmm_" in key:
        return "dlhs" if ", true>" in key else "forward"
    if "multi_tensor_apply" in key:
        return "adamw"
    return "other"


def _moe_layer_train(torch):
    """The bench's ragged MoE layer trained with AdamW on the grouped GEMM
    kernels, held to the same step on the plain versions."""
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import grouped_matmul as gk
    from paddle_tpu_torch.optimizer import AdamW

    bf16 = torch.bfloat16
    layer = MoELayer(**MOE_LAYER, impl="ragged", dtype=bf16, seed=0)
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(MOE_BATCH, MOE_SEQ, MOE_LAYER["d_model"], generator=g,
                    device="cuda").to(bf16)
    wgt = torch.randn(x.shape, generator=g, device="cuda")

    def grads():
        layer.zero_grad(set_to_none=True)
        xi = x.detach().clone().requires_grad_()
        o, a = layer(xi)
        ((o.float() * wgt).sum() + a).backward()
        got = {n: p.grad.clone() for n, p in layer.named_parameters()}
        got["input"] = xi.grad.clone()
        layer.zero_grad(set_to_none=True)
        return got

    def held(got, ref):
        out = {}
        for n in ref:
            ok, stats = compare(got[n], ref[n])
            out[n] = (ok, stats)
        return out

    # the kernel step with every grouped GEMM call sync-free, its launches
    _build.reset_launch_counts()
    with sync_free_gmm(torch, gk):
        g_k = grads()
    torch.cuda.synchronize()
    one = _build.launch_counts()
    one_v = _build.variant_counts()
    check(one["grouped_matmul"] == 6 and one["grouped_matmul_wgrad"] == 3
          and all(one_v.get(k, 0) == n
                  for k, n in MOE_LAYER_LAUNCHES.items()),
          f"moe_train layer: a step launched {one['grouped_matmul']} "
          f"grouped_matmul and {one['grouped_matmul_wgrad']} "
          f"grouped_matmul_wgrad ({one_v}), want {MOE_LAYER_LAUNCHES}")
    # the comparison step must not reach a kernel: every grouped GEMM call
    # in it is the plain version
    _build.reset_launch_counts()
    with plain_gmm_autograd(gk):
        g_p = grads()
    torch.cuda.synchronize()
    check(_build.launch_counts()["grouped_matmul"] == 0
          and _build.launch_counts()["grouped_matmul_wgrad"] == 0,
          f"moe_train layer: the plain step launched kernels: "
          f"{_build.variant_counts()}")
    # the negative control: the plain weight gradient reads the group
    # sizes on the host, which the same mode refuses
    gsz = torch.full((8,), 2, dtype=torch.int32, device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        gk._segment_outer(x[0, :16], x[0, :16], gsz, 8)
        control = None
    except RuntimeError as err:
        control = str(err).splitlines()[0][:120]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(control is not None, "moe_train layer: a host read of the group "
          "sizes under set_sync_debug_mode('error') did not raise")
    res = held(g_k, g_p)
    log("[moe_train] ragged layer, kernel step vs the plain step: " + ", ".join(
        f"{n} rel_l2 {st['rel_l2']:.3g} ({st['limit_frac']:.2f} of the "
        f"element bound)" for n, (_, st) in res.items()))
    bad = {n: st for n, (ok, st) in res.items() if not ok}
    check(not bad, f"moe_train layer: gradients off the gate against the "
                   f"plain step: {json.dumps(bad)[:600]}")
    # the planted fault: a weight gradient 1 % off in its f32 sums, before
    # the cast to bf16, must fail the gate (1 % of an already rounded bf16
    # value rounds to 0.4-1.2 %: its relative L2 can fall under 1e-2)
    real = gk.grouped_matmul_wgrad

    def faulty(lhs, gr, gs, e):
        exact = gk._segment_outer(lhs.float(), gr.float(), gs, e)
        return (exact * MOE_WGRAD_PLANT).to(lhs.dtype)

    gk.grouped_matmul_wgrad = faulty
    try:
        g_f = grads()
    finally:
        gk.grouped_matmul_wgrad = real
    planted = held(g_f, g_p)
    caught = sorted(n for n, (ok, _) in planted.items() if not ok)
    log("[moe_train] planted drhs fault: " + ", ".join(
        f"{n} rel_l2 {st['rel_l2']:.4g}" for n, (_, st) in planted.items()
        if n.startswith("experts.")))
    check(set(caught) >= {"experts.w_gate", "experts.w_up",
                          "experts.w_down"},
          f"moe_train layer: the planted drhs fault (x{MOE_WGRAD_PLANT}) "
          f"was caught only in {caught}")
    del g_f
    # the planted fault in dlhs: the transposed product 1 % off in its f32
    # sums, before the cast; it must fail the gate on the input gradient
    real_fwd = gk._forward

    def faulty_dlhs(lhs, rhs, gs, rhs_scales=None, trans_rhs=False):
        if not trans_rhs:
            return real_fwd(lhs, rhs, gs, rhs_scales)
        exact = gk.grouped_matmul_ref(lhs.float(),
                                      rhs.float().transpose(1, 2), gs)
        return (exact * MOE_DLHS_PLANT).to(lhs.dtype)

    gk._forward = faulty_dlhs
    try:
        g_f = grads()
    finally:
        gk._forward = real_fwd
    planted_dlhs = held(g_f, g_p)
    caught_dlhs = sorted(n for n, (ok, _) in planted_dlhs.items() if not ok)
    log(f"[moe_train] planted dlhs fault: input rel_l2 "
        f"{planted_dlhs['input'][1]['rel_l2']:.4g}; caught in {caught_dlhs}")
    check("input" in caught_dlhs,
          f"moe_train layer: the planted dlhs fault (x{MOE_DLHS_PLANT}) "
          f"was not caught on the input gradient (caught in {caught_dlhs})")
    del g_f
    # AdamW steps on the kernels, then the same on the plain versions
    opt = AdamW(learning_rate=3e-4, parameters=layer.parameters())

    def train_step():
        # the input needs its gradient, as inside a model (the layer
        # before takes it): the backward runs dlhs for all three
        # projections
        opt.clear_grad()
        o, a = layer(x.detach().requires_grad_())
        loss = (o.float() * wgt).mean() + a
        loss.backward()
        opt.step()
        return loss.detach()

    _build.reset_launch_counts()
    losses = [train_step()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [train_step() for _ in range(MOE_LAYER_STEPS - 1)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (MOE_LAYER_STEPS - 1) * 1e3
    counts = _build.launch_counts()
    variants = _build.variant_counts()
    # one more step under the profiler: device ms by part of the backward
    # (the transposed instance is the grouped GEMM template's TransRhs =
    # true, ``Lb1E`` in its mangled name)
    prof = _profiled_step(torch, lambda _: train_step(), None,
                          family=_moe_layer_family)
    gmm_ms = sum(prof["families_ms"].get(f, 0.0)
                 for f in ("forward", "dlhs", "weight_gradient"))
    losses = [v.item() for v in losses]
    check(all(np.isfinite(losses)),
          f"moe_train layer: losses {losses}")
    check(counts["grouped_matmul"] == 6 * MOE_LAYER_STEPS
          and counts["grouped_matmul_wgrad"] == 3 * MOE_LAYER_STEPS
          and all(variants.get(k, 0) == n * MOE_LAYER_STEPS
                  for k, n in MOE_LAYER_LAUNCHES.items()),
          f"moe_train layer: {MOE_LAYER_STEPS} steps launched {counts}, "
          f"{variants}")
    with plain_gmm_autograd(gk):
        train_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            train_step()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) / 2 * 1e3
    worst = {n: st["rel_l2"] for n, (_, st) in res.items()}
    rec = {"steps": MOE_LAYER_STEPS, "step_ms": step_ms,
           "plain_step_ms": plain_ms,
           "tokens_per_s": MOE_BATCH * MOE_SEQ / (step_ms / 1e3),
           "losses": losses, "grad_vs_plain_rel_l2": worst,
           "grad_vs_plain_limit_frac": {n: st["limit_frac"]
                                        for n, (_, st) in res.items()},
           "profile": prof, "grouped_gemm_device_ms": gmm_ms,
           "planted_fault_caught_in": caught,
           "planted_dlhs_fault_caught_in": caught_dlhs,
           "planted_dlhs_input_rel_l2": planted_dlhs["input"][1]["rel_l2"],
           "sync_control": control,
           "launches": dict(counts, **variants)}
    log(f"[moe_train] ragged layer: a step {one_v} launches, none "
        f"reading the group sizes on the host (control: {control!r}); "
        f"gradients vs the plain step {json.dumps(worst)}; planted drhs "
        f"fault caught in {caught}, dlhs fault in {caught_dlhs}; "
        f"AdamW step {step_ms:.3f} ms ({rec['tokens_per_s']:.0f} tokens/s; "
        f"plain {plain_ms:.3f} ms); losses {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}")
    log(f"[moe_train] ragged layer, a profiled step: device "
        f"{prof['device_ms']:.3f} ms in {prof['kernel_launches']} kernels, "
        f"the grouped GEMM kernels {gmm_ms:.3f} ms; by part " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(prof["families_ms"].items())))
    del layer, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_moe_train(torch):
    """``moe_train``: MoE pretraining on the card. Launches on this path:
    the Llama MoE's 14 counted steps and the ragged layer's counted AdamW
    steps (the comparisons are not counted)."""
    llama = _moe_llama_train(torch)
    layer = _moe_layer_train(torch)
    launches = {}
    for part in (llama, layer):
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"[moe_train] launches on the path {launches}")
    return {"llama_moe": llama, "layer": layer, "launches": launches}


# ------------------------------------------------------------------ hapi
# hapi: BASELINE config #1 as its users write it (hapi.Model over
# resnet50, the CIFAR pipeline through 4 process workers), and the
# Transformer base (the JAX class's defaults) on a copy task
HAPI_RESNET_LOSS_RTOL = 1e-6
TRANSFORMER_CFG = dict(d_model=512, nhead=8, num_encoder_layers=6,
                       num_decoder_layers=6, dim_feedforward=2048,
                       dropout=0.1)
TRANSFORMER_VOCAB, TRANSFORMER_BATCH, TRANSFORMER_SEQ = 32000, 32, 256
TRANSFORMER_STEPS = 12
# the eval loss with the flash kernels against plain attention (f32
# activations; the kernels' f32 FMA path sums in another order)
TRANSFORMER_EVAL_TOL = 1e-2
# the first training step at dropout 0, card against the CPU (f32)
TRANSFORMER_CPU_TOL = 1e-4


class _FixedFirst:
    """bench's fixed batch (its 128 images and labels, unaugmented), then
    the items of ``rest``: with ``shuffle=False`` the first batch is the
    manual step's."""

    def __init__(self, x, y, rest):
        self.x, self.y, self.rest = x, y, rest

    def __len__(self):
        return len(self.x) + len(self.rest)

    def __getitem__(self, i):
        if i < len(self.x):
            return self.x[i], int(self.y[i])
        return self.rest[i - len(self.x)]


class _Steps:
    """A hapi callback: each fit step's loss and host time."""

    def __init__(self):
        self.losses, self.times = [], []

    def set_model(self, model):
        self.model = model

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])
        self.times.append(time.perf_counter())


def _count_syncs(torch, fn):
    """(fn's result, the synchronizing CUDA calls it made), counted by
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def _hapi_resnet(torch):
    from paddle_tpu_torch import hapi, io, metric, nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import datasets, transforms as T
    from paddle_tpu_torch.vision.models import resnet50

    def momentum(model):
        return Momentum(learning_rate=0.1, momentum=0.9,
                        parameters=model.parameters(), weight_decay=5e-4)

    gc.collect()
    torch.cuda.empty_cache()
    # the manual step of the resnet phase: fixed batch, same seed
    x, y = _resnet_batch(torch)
    model = resnet50(num_classes=10, seed=0)
    ce = nn.CrossEntropyLoss()
    step = TrainStep(model, lambda m, xb, yb: ce(m(xb), yb), momentum(model))
    manual_loss = step(x, y).item()
    for _ in range(2):
        step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RESNET_TIMED_STEPS):
        step(x, y)
    torch.cuda.synchronize()
    manual_ms = (time.perf_counter() - t0) / RESNET_TIMED_STEPS * 1e3
    del model, step
    # hapi: the same weights and first batch, then synthetic CIFAR-10 with
    # the augmentations, through 4 forked workers
    norm = T.Normalize([0.4914, 0.4822, 0.4465], [0.2470, 0.2435, 0.2616])
    aug = datasets.Cifar10(
        mode="train", backend="synthetic",
        synthetic_size=RESNET_DATA["synthetic_size"],
        transform=T.Compose([T.RandomCrop(32, padding=4),
                             T.RandomHorizontalFlip(), T.ToTensor(), norm]))
    xs, ys = x.cpu().numpy(), y.cpu().numpy()
    train = io.DataLoader(_FixedFirst(xs, ys, aug), batch_size=RESNET_BATCH,
                          shuffle=False, drop_last=True,
                          num_workers=RESNET_DATA["num_workers"],
                          use_shared_memory=True)
    test = datasets.Cifar10(mode="test", backend="synthetic",
                            transform=T.Compose([T.ToTensor(), norm]))
    net = resnet50(num_classes=10, seed=0)
    m = hapi.Model(net).prepare(momentum(net), nn.CrossEntropyLoss(),
                                metric.Accuracy())
    rec = _Steps()
    _build.reset_launch_counts()
    (hist, syncs) = _count_syncs(torch, lambda: m.fit(
        train, epochs=1, verbose=0, callbacks=[rec]))
    steps = len(rec.losses)
    check(abs(rec.losses[0] - manual_loss)
          <= HAPI_RESNET_LOSS_RTOL * abs(manual_loss),
          f"hapi resnet: first fit loss {rec.losses[0]} vs the manual "
          f"step's {manual_loss}")
    check(all(np.isfinite(rec.losses)), f"hapi resnet: losses {rec.losses}")
    # steady state: from the end of step 1 (workers warm) to the last
    fit_ms = (rec.times[-1] - rec.times[1]) / (steps - 2) * 1e3
    logs = m.evaluate(test, batch_size=RESNET_BATCH, verbose=0)
    counts = _build.launch_counts()
    check(set(counts.values()) == {0},
          f"hapi resnet: hand kernels launched {counts}")
    out = {"manual_loss": manual_loss, "first_fit_loss": rec.losses[0],
           "steps": steps, "losses": rec.losses,
           "fit_step_ms": fit_ms, "manual_step_ms": manual_ms,
           "fit_images_per_s": RESNET_BATCH / (fit_ms / 1e3),
           "manual_images_per_s": RESNET_BATCH / (manual_ms / 1e3),
           "syncs": syncs, "syncs_per_step": syncs / steps,
           "eval": logs, "history": hist, "launches": counts}
    out["fit_vs_manual"] = out["fit_images_per_s"] / out[
        "manual_images_per_s"]
    log(f"[hapi] resnet50 through Model.fit, {steps} steps over 4 workers: "
        f"first loss {rec.losses[0]:.7f} vs the manual step's "
        f"{manual_loss:.7f}; {out['fit_images_per_s']:.0f} images/s "
        f"against the manual step's {out['manual_images_per_s']:.0f} "
        f"({out['fit_vs_manual']:.3f}); {syncs} host syncs in the fit "
        f"({out['syncs_per_step']:.2f} a step); evaluate {logs}")
    del m, net, train
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _seq2seq(torch, dropout, device, seed=0):
    """The Transformer base with a shared 32000-token embedding (scaled by
    sqrt(d)) and output projection, sinusoidal positions, a causal
    target mask."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import ops as F
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.nn import initializer as I

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            d = TRANSFORMER_CFG["d_model"]
            self.embed = nn.Embedding(TRANSFORMER_VOCAB, d)
            self.transformer = nn.Transformer(
                **dict(TRANSFORMER_CFG, dropout=dropout))
            pos = np.arange(TRANSFORMER_SEQ)[:, None] / np.power(
                10000.0, np.arange(0, d, 2)[None, :] / d)
            pe = np.zeros((TRANSFORMER_SEQ, d), np.float32)
            pe[:, 0::2], pe[:, 1::2] = np.sin(pos), np.cos(pos)
            self.register_buffer("pe", torch.from_numpy(pe),
                                 persistable=False)
            self.register_buffer("mask", nn.Transformer
                                 .generate_square_subsequent_mask(
                                     TRANSFORMER_SEQ), persistable=False)
            self.scale = d ** 0.5

        def forward(self, src, tgt):
            s = self.embed(src) * self.scale + self.pe[:src.shape[1]]
            t = self.embed(tgt) * self.scale + self.pe[:tgt.shape[1]]
            n = tgt.shape[1]
            h = self.transformer(s, t, tgt_mask=self.mask[:n, :n]
                                 .to(t.dtype))
            return F.linear(h, self.embed.weight.t())

    with I.init_generator(torch.Generator().manual_seed(seed)):
        model = Seq2Seq()
    return model.to(resolve_device(device))


def _copy_task(torch, n):
    """n seeded copy sequences: source tokens, the target input (a start
    token, then the source shifted right) and the target (the source)."""
    rng = np.random.RandomState(5)
    src = rng.randint(1, TRANSFORMER_VOCAB, (n, TRANSFORMER_SEQ))
    tgt_in = np.concatenate([np.zeros((n, 1), np.int64), src[:, :-1]], 1)
    return [torch.from_numpy(a.astype(np.int64)) for a in (src, tgt_in, src)]


class _SeqLoss:
    """Token cross entropy over [b, s, vocab] logits."""

    def __init__(self, nn):
        self.ce = nn.CrossEntropyLoss()

    def __call__(self, logits, labels):
        return self.ce(logits.reshape(-1, logits.shape[-1]).float(),
                       labels.reshape(-1))


def _transformer_flops(torch):
    """Training FLOPs of one step, counted from the shapes: 6 x the
    multiply-adds of every projection per token (encoder, decoder,
    output), plus 3 x 4 s d per token per attention (scores and the
    weighted sum, forward and backward)."""
    d, f = TRANSFORMER_CFG["d_model"], TRANSFORMER_CFG["dim_feedforward"]
    le, ld = (TRANSFORMER_CFG["num_encoder_layers"],
              TRANSFORMER_CFG["num_decoder_layers"])
    tokens = TRANSFORMER_BATCH * TRANSFORMER_SEQ
    enc = le * (4 * d * d + 2 * d * f)
    dec = ld * (8 * d * d + 2 * d * f) + d * TRANSFORMER_VOCAB
    attn = 12 * TRANSFORMER_SEQ * d * (le + 2 * ld)
    return 6 * (enc + dec) * tokens + attn * tokens


def _hapi_transformer(torch):
    from paddle_tpu_torch import amp, hapi, io, nn
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    src, tgt_in, tgt = _copy_task(torch, TRANSFORMER_BATCH
                                  * TRANSFORMER_STEPS)
    train = io.TensorDataset([src, tgt_in, tgt])
    evalset = io.TensorDataset([t[:TRANSFORMER_BATCH]
                                for t in (src, tgt_in, tgt)])
    flops = _transformer_flops(torch)
    out = {"flops_per_step": flops}
    # the first step at dropout 0, card against the CPU (f32)
    first = {}
    for dev in ("cpu", "cuda"):
        net = _seq2seq(torch, 0.0, dev)
        m = hapi.Model(net).prepare(
            AdamW(learning_rate=5e-4, parameters=net.parameters()),
            _SeqLoss(nn))
        rec = _Steps()
        m.fit(train, batch_size=TRANSFORMER_BATCH, epochs=1, shuffle=False,
              verbose=0, callbacks=[rec], num_iters=1)
        first[dev] = rec.losses[0]
        del m, net
    check(abs(first["cuda"] - first["cpu"])
          <= TRANSFORMER_CPU_TOL * abs(first["cpu"]),
          f"hapi transformer: first step at dropout 0 on the card "
          f"{first['cuda']} vs the CPU {first['cpu']}")
    out["first_step_dropout0"] = first
    L = TRANSFORMER_CFG["num_encoder_layers"]
    for mode in ("f32", "o2_bf16"):
        gc.collect()
        torch.cuda.empty_cache()
        net = _seq2seq(torch, TRANSFORMER_CFG["dropout"], "cuda")
        opt = AdamW(learning_rate=5e-4, parameters=net.parameters(),
                    multi_precision=mode == "o2_bf16")
        if mode == "o2_bf16":
            net, opt = amp.decorate(net, opt, level="O2", dtype="bfloat16")
        m = hapi.Model(net).prepare(opt, _SeqLoss(nn))
        ctx = (amp.auto_cast(True, level="O2", dtype="bfloat16")
               if mode == "o2_bf16" else contextlib.nullcontext())
        rec = _Steps()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        with ctx:
            m.fit(train, batch_size=TRANSFORMER_BATCH, epochs=1,
                  shuffle=False, verbose=0, callbacks=[rec])
            train_counts = _build.launch_counts()
            _build.reset_launch_counts()
            logs = m.evaluate(evalset, batch_size=TRANSFORMER_BATCH,
                              verbose=0)
            eval_counts = dict(_build.launch_counts(),
                               **_build.variant_counts())
            with plain_attention(fa):
                plain_logs = m.evaluate(evalset,
                                        batch_size=TRANSFORMER_BATCH,
                                        verbose=0)
        peak = torch.cuda.max_memory_allocated()
        losses = rec.losses
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"hapi transformer {mode}: losses {losses}")
        # d 64 heads: the 3xTF32 forward in f32, wgmma in bf16
        design = "tf32x3" if mode == "f32" else "wgmma"
        check(eval_counts["flash_attention"] == 2 * L
              and eval_counts.get(f"flash_attention/{design}", 0) == 2 * L,
              f"hapi transformer {mode}: evaluate launched "
              f"{eval_counts['flash_attention']} flash forwards "
              f"({design}: {eval_counts.get(f'flash_attention/{design}')}),"
              f" want {2 * L} (the encoder's self-attention and the "
              f"cross-attention) on the {design} design")
        gap = abs(logs["eval_loss"] - plain_logs["eval_loss"])
        check(gap <= TRANSFORMER_EVAL_TOL,
              f"hapi transformer {mode}: eval loss {logs['eval_loss']} vs "
              f"plain attention {plain_logs['eval_loss']}")
        step_ms = ((rec.times[-1] - rec.times[1]) / (len(rec.times) - 2)
                   * 1e3)
        tokens_s = TRANSFORMER_BATCH * TRANSFORMER_SEQ / (step_ms / 1e3)
        peak_flops = F32_FLOPS if mode == "f32" else BF16_FLOPS
        mfu = flops / (step_ms / 1e3) / peak_flops
        out[mode] = {"step_ms": step_ms, "tokens_per_s": tokens_s,
                     "mfu": mfu, "peak_bytes": peak, "losses": losses,
                     "eval_loss": logs["eval_loss"],
                     "plain_eval_loss": plain_logs["eval_loss"],
                     "train_launches": train_counts,
                     "eval_launches": eval_counts}
        log(f"[hapi] transformer base {mode}: {step_ms:.2f} ms/step, "
            f"{tokens_s:.0f} target tokens/s, MFU {mfu * 100:.2f}% of "
            f"{peak_flops / 1e12:.0f} TFLOP/s ({flops / 1e12:.3f} TFLOP a "
            f"step), peak {peak / 2**30:.2f} GiB; losses {losses[0]:.4f} "
            f"-> {losses[-1]:.4f}; eval loss {logs['eval_loss']:.5f} "
            f"({eval_counts['flash_attention']} flash launches) vs plain "
            f"{plain_logs['eval_loss']:.5f}; fit launched "
            f"{train_counts['flash_attention']} flash forwards (dropout "
            f"0.1: the math form)")
        del m, net, opt
    out["launches"] = {}
    for mode in ("f32", "o2_bf16"):
        for k, v in out[mode]["train_launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        for k, v in out[mode]["eval_launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    return out


def phase_hapi(torch):
    """``hapi``: ``hapi.Model`` training ResNet-50 (BASELINE config #1) and
    the Transformer base. Launches on this path: the fits' and the
    kernel evaluations' (the plain-attention evaluation is not
    counted)."""
    resnet = _hapi_resnet(torch)
    transformer = _hapi_transformer(torch)
    launches = dict(transformer["launches"])
    return {"resnet": resnet, "transformer": transformer,
            "launches": launches}


# ---------------------------------------------------------------- nn_zoo
# every zoo factory at its native size (the MobileNets at CIFAR's, as the
# JAX tests run them), the recurrent layers, vision.ops and the resize
# ops: the card against the CPU
ZOO_CASES = [
    ("lenet", 28), ("alexnet", 224), ("mobilenet_v1", 32),
    ("mobilenet_v2", 32), ("mobilenet_v3_small", 32),
    ("mobilenet_v3_large", 32), ("vgg11", 224), ("vgg13", 224),
    ("vgg16", 224), ("vgg19", 224), ("vgg11_bn", 224), ("vgg13_bn", 224),
    ("vgg16_bn", 224), ("vgg19_bn", 224), ("squeezenet1_0", 224),
    ("squeezenet1_1", 224), ("densenet121", 224), ("densenet161", 224),
    ("densenet169", 224), ("densenet201", 224), ("densenet264", 224),
    ("googlenet", 224), ("shufflenet_v2_x0_25", 224),
    ("shufflenet_v2_x0_5", 224), ("shufflenet_v2_x1_0", 224),
    ("shufflenet_v2_x1_5", 224), ("shufflenet_v2_x2_0", 224),
    ("inception_v3", 299),
]
ZOO_BATCH = 8
ZOO_TOL = 1e-4
RNN_CFG = dict(input_size=256, hidden_size=512, num_layers=2,
               direction="bidirect")
RNN_BATCH, RNN_SEQ = 32, 128
OPS_TOL = 1e-5


def _zoo_model(torch, name):
    """Factory ``name`` (``_bn``: with batch norm) on the CPU, seed 0,
    10 classes; LeNet (no factory) from the same seed."""
    from paddle_tpu_torch.nn import initializer as I
    from paddle_tpu_torch.vision import models as M

    if name == "lenet":
        with I.init_generator(torch.Generator().manual_seed(0)):
            return M.LeNet(num_classes=10)
    kw = {}
    if name.endswith("_bn"):
        name, kw = name[:-3], dict(batch_norm=True)
    return getattr(M, name)(num_classes=10, device="cpu", seed=0, **kw)


def _nn_zoo_models(torch):
    import copy

    out = {}
    for name, hw in ZOO_CASES:
        cpu = _zoo_model(torch, name)
        cpu.eval()
        card = copy.deepcopy(cpu).to("cuda").eval()
        ch = 1 if name == "lenet" else 3
        x = torch.from_numpy(np.random.RandomState(0).randn(
            ZOO_BATCH, ch, hw, hw).astype(np.float32))
        with torch.no_grad():
            want = cpu(x)
            got = card(x.to("cuda"))
        rel = _rel_l2(got.cpu(), want)
        check(np.isfinite(rel) and rel <= ZOO_TOL,
              f"nn_zoo: {name} eval forward on the card vs the CPU "
              f"{rel} > {ZOO_TOL}")
        out[name] = {"input": hw, "rel_l2": rel}
        del cpu, card
    log(f"[nn_zoo] {len(out)} factories, eval forward batch {ZOO_BATCH}, "
        f"card vs CPU relative L2: worst "
        f"{max(v['rel_l2'] for v in out.values()):.3g} "
        f"({max(out, key=lambda k: out[k]['rel_l2'])})")
    return out


def _nn_zoo_rnn(torch):
    import copy

    from paddle_tpu_torch import nn

    out = {}
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(RNN_BATCH, RNN_SEQ, RNN_CFG["input_size"])
                         .astype(np.float32))
    for cls in ("LSTM", "GRU", "SimpleRNN"):
        torch.manual_seed(0)
        cpu = getattr(nn, cls)(**RNN_CFG)
        card = copy.deepcopy(cpu).to("cuda")

        def run(layer, xin):
            xin = xin.clone().requires_grad_()
            y, states = layer(xin)
            states = states if isinstance(states, tuple) else (states,)
            g = torch.Generator().manual_seed(2)
            cot = torch.randn(y.shape, generator=g).to(y.device)
            loss = (y * cot).sum() + sum(s.sum() for s in states)
            loss.backward()
            grads = {n: p.grad.cpu() for n, p in layer.named_parameters()}
            grads["input"] = xin.grad.cpu()
            return [y.detach().cpu()] + [s.detach().cpu()
                                         for s in states], grads

        outs_c, grads_c = run(cpu, x)
        outs_g, grads_g = run(card, x.to("cuda"))
        rel = max(_rel_l2(a, b) for a, b in zip(outs_g, outs_c))
        grel = max(_rel_l2(grads_g[n], grads_c[n]) for n in grads_c)
        check(rel <= ZOO_TOL and grel <= ZOO_TOL,
              f"nn_zoo: {cls} on the card vs the CPU: outputs {rel}, "
              f"gradients {grel} (> {ZOO_TOL})")
        out[cls] = {"rel_l2": rel, "grad_rel_l2": grel}
    log(f"[nn_zoo] LSTM / GRU / SimpleRNN {RNN_CFG} batch {RNN_BATCH} x "
        f"{RNN_SEQ}: card vs CPU {json.dumps(out)}")
    return out


def _nn_zoo_ops(torch):
    from paddle_tpu_torch import ops as F
    from paddle_tpu_torch.vision import ops as V

    rng = np.random.RandomState(3)
    x = rng.rand(2, 12, 32, 32).astype(np.float32)
    boxes = np.array([[1.0, 1.0, 20.0, 22.0], [4.5, 3.0, 30.0, 12.5],
                      [0.0, 8.0, 16.0, 31.0]], np.float32)
    num = np.array([2, 1], np.int64)
    grid = (rng.rand(2, 24, 20, 2) * 2.4 - 1.2).astype(np.float32)
    off = (rng.randn(2, 18, 30, 30) * 0.7).astype(np.float32)
    w = rng.randn(6, 12, 3, 3).astype(np.float32)
    cases = {
        "roi_align": lambda t: V.roi_align(t(x), t(boxes), t(num), 7),
        "roi_pool": lambda t: V.roi_pool(t(x), t(boxes), t(num), 4),
        "psroi_pool": lambda t: V.psroi_pool(t(x), t(boxes), t(num), 2),
        "deform_conv2d": lambda t: V.deform_conv2d(t(x), t(off), t(w)),
        "box_coder": lambda t: V.box_coder(
            t(boxes), None, t(boxes[::-1].copy() + 1.0)),
        "grid_sample_zeros": lambda t: F.grid_sample(t(x), t(grid)),
        "grid_sample_border": lambda t: F.grid_sample(
            t(x), t(grid), padding_mode="border", align_corners=False),
        "bicubic_up": lambda t: F.interpolate(t(x), size=[45, 51],
                                              mode="bicubic"),
        "bicubic_down": lambda t: F.interpolate(t(x), size=[13, 9],
                                                mode="bicubic"),
        "area_down": lambda t: F.interpolate(t(x), size=[10, 14],
                                             mode="area"),
        "area_up": lambda t: F.interpolate(t(x), size=[40, 33],
                                           mode="area"),
    }
    out = {}
    for name, fn in cases.items():
        want = fn(torch.from_numpy)
        got = fn(lambda a: torch.from_numpy(a).to("cuda"))
        rel = _rel_l2(got.cpu(), want)
        check(rel <= OPS_TOL, f"nn_zoo: {name} on the card vs the CPU "
                              f"{rel} > {OPS_TOL}")
        out[name] = rel
    keep_c = V.nms(torch.from_numpy(boxes), 0.3,
                   torch.from_numpy(np.array([0.5, 0.9, 0.7], np.float32)))
    keep_g = V.nms(torch.from_numpy(boxes).cuda(), 0.3, torch.from_numpy(
        np.array([0.5, 0.9, 0.7], np.float32)).cuda())
    check(keep_g.cpu().tolist() == keep_c.tolist(),
          f"nn_zoo: nms {keep_g.tolist()} vs {keep_c.tolist()}")
    log(f"[nn_zoo] vision.ops and resize ops, card vs CPU relative L2: "
        f"{json.dumps(out)}; nms equal")
    return out


def phase_nn_zoo(torch):
    """``nn_zoo``: the vision zoo, the recurrent layers, vision.ops and the
    resize ops on the card against the CPU (f32, TF32 off); no hand
    kernel on this path."""
    from paddle_tpu_torch.kernels import _build

    gc.collect()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    rec = {"models": _nn_zoo_models(torch), "rnn": _nn_zoo_rnn(torch),
           "ops": _nn_zoo_ops(torch)}
    counts = _build.launch_counts()
    check(set(counts.values()) == {0},
          f"nn_zoo: hand kernels launched {counts}")
    rec["launches"] = counts
    return rec


# ----------------------------------------------------------- signal_dist
# An ASR front end at Whisper's published log-mel settings (openai/whisper,
# whisper/audio.py: SAMPLE_RATE 16000, N_FFT 400, HOP_LENGTH 160, N_MELS
# 80, CHUNK_LENGTH 30 s) over a batch of seeded clips, held on its first
# clips against the same layers in float64 on the CPU; then the
# distributions' samplers by distribution and their deterministic methods
# against the CPU. No hand kernel lies on this path: the FFTs are cuFFT's
# (torch.fft), the draws PyTorch's samplers.
# (the mel layers' default filterbank norm is "slaney", as Whisper's)
ASR = dict(sr=16000, n_fft=400, hop_length=160, n_mels=80, f_min=0.0,
           f_max=8000.0)
ASR_CLIP_S, ASR_BATCH, ASR_REF_CLIPS, ASR_MFCC = 30, 64, 8, 40
ASR_TOP_DB = 80.0
# f32 on the card against float64 on the CPU: the power spectrum and the
# MFCCs by relative L2, the log-mel in dB (max abs); istft(stft(x)) within
# this fraction of the signal's peak
ASR_POWER_L2, ASR_LOGMEL_DB, ASR_MFCC_L2 = 1e-5, 1e-2, 1e-5
ISTFT_PEAK_TOL = 1e-5
DIST_DRAWS = 10 ** 6
# the KS statistic of n draws against the exact CDF: below KS_C / sqrt(n)
# (P(sqrt(n) D > 2.69) ~ 2 exp(-2 x 2.69^2) ~ 1e-6); moments within
# MOMENT_SE standard errors (each estimated from the draws)
KS_C, MOMENT_SE = 2.69, 6.0
# log_prob, entropy and KL on the card against the CPU, relative L2 (f32)
DIST_CPU_RTOL = 1e-5
VAE_SHAPE, VAE_GRAD_RTOL = (4096, 512), 1e-5
# the port's modules on this path (the end-of-run isolation check)
SIGNAL_DIST_MODULES = tuple(f"paddle_tpu_torch.{m}" for m in (
    "fft", "signal", "audio", "audio.functional", "audio.features",
    "audio.backends", "distribution", "distribution.transform",
    "ops.random", "ops.math", "ops.fft_ops"))


@contextlib.contextmanager
def no_host_sync(torch):
    """Inside: a CUDA call that synchronizes with the host raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _asr_clips(torch, batch, dev):
    """``batch`` seeded 30 s clips at 16 kHz: a linear chirp from 50-150
    Hz to 6-7.5 kHz (amplitude 0.2-0.7) plus white noise (0.05), f32."""
    g = torch.Generator(device=dev).manual_seed(0)
    n = ASR["sr"] * ASR_CLIP_S
    f64 = dict(dtype=torch.float64, device=dev)
    t = torch.arange(n, **f64) / ASR["sr"]
    f0 = 50.0 + 100.0 * torch.rand(batch, 1, generator=g, **f64)
    f1 = 6000.0 + 1500.0 * torch.rand(batch, 1, generator=g, **f64)
    amp = 0.2 + 0.5 * torch.rand(batch, 1, generator=g, **f64)
    chirp = amp * torch.sin(2 * np.pi * (
        f0 * t + (f1 - f0) * t * t / (2 * ASR_CLIP_S)))
    noise = 0.05 * torch.randn(batch, n, generator=g, **f64)
    return (chirp + noise).float()


def _asr_layers(dtype):
    """The four feature layers at Whisper's settings, built on the CPU."""
    from paddle_tpu_torch.audio import features as A

    mel = dict(ASR, htk=False, dtype=dtype)
    spec = dict(n_fft=ASR["n_fft"], hop_length=ASR["hop_length"],
                dtype=dtype)
    return {
        "spectrogram": A.Spectrogram(**spec),
        "mel": A.MelSpectrogram(**mel),
        "logmel": A.LogMelSpectrogram(**mel, top_db=ASR_TOP_DB),
        "mfcc": A.MFCC(n_mfcc=ASR_MFCC, top_db=ASR_TOP_DB, **mel),
    }


def _asr_front_end(torch, dev, flush):
    """(a): the feature layers on the card against float64 on the CPU,
    istft(stft(x)), the 16-bit refusal, times."""
    from paddle_tpu_torch import fft, signal
    from paddle_tpu_torch.audio.functional import get_window

    x = _asr_clips(torch, ASR_BATCH, dev)
    ref_x = x[:ASR_REF_CLIPS].cpu().double()
    card = {k: m.to(dev).eval() for k, m in _asr_layers("float32").items()}
    cpu = _asr_layers("float64")
    rec = {"clips": ASR_BATCH, "clip_s": ASR_CLIP_S, "settings": ASR}
    with torch.no_grad():
        with no_host_sync(torch):
            outs = {k: m(x) for k, m in card.items()}
            head = {k: m(x[:ASR_REF_CLIPS]) for k, m in card.items()}
        frames = 1 + ASR["sr"] * ASR_CLIP_S // ASR["hop_length"]
        for k, want in (("spectrogram", ASR["n_fft"] // 2 + 1),
                        ("mel", ASR["n_mels"]), ("logmel", ASR["n_mels"]),
                        ("mfcc", ASR_MFCC)):
            o = outs[k]
            check(o.device.type == dev and o.dtype == torch.float32
                  and tuple(o.shape) == (ASR_BATCH, want, frames)
                  and bool(torch.isfinite(o).all()),
                  f"signal_dist: {k} output {o.device} {o.dtype} "
                  f"{tuple(o.shape)}, finite {bool(torch.isfinite(o).all())}")
        refs = {k: m(ref_x) for k, m in cpu.items()}
    gates = {
        "power_rel_l2": (_rel_l2(head["spectrogram"].cpu().double(),
                                 refs["spectrogram"]), ASR_POWER_L2),
        "logmel_max_abs_db": (float((head["logmel"].cpu().double()
                                     - refs["logmel"]).abs().max()),
                              ASR_LOGMEL_DB),
        "mfcc_rel_l2": (_rel_l2(head["mfcc"].cpu().double(),
                                refs["mfcc"]), ASR_MFCC_L2),
        "mel_rel_l2": (_rel_l2(head["mel"].cpu().double(), refs["mel"]),
                       ASR_POWER_L2),
    }
    for k, (got, lim) in gates.items():
        check(got <= lim, f"signal_dist: {k} {got} > {lim} against float64 "
                          f"on the CPU")
    rec["against_cpu_f64"] = {k: v[0] for k, v in gates.items()}

    # istft(stft(x)) on the card, twice: within the peak gate, bit-equal
    win = get_window("hann", ASR["n_fft"], fftbins=True,
                     dtype="float32").to(dev)
    n_fft, hop = ASR["n_fft"], ASR["hop_length"]

    def stft():
        return signal.stft(x, n_fft, hop, window=win)

    with no_host_sync(torch):
        spec = stft()
        y1 = signal.istft(spec, n_fft, hop, window=win, length=x.shape[-1])
        y2 = signal.istft(spec, n_fft, hop, window=win, length=x.shape[-1])
    peak = float(x.abs().max())
    err = float((y1 - x).abs().max())
    check(spec.device.type == dev and y1.device.type == dev
          and spec.dtype == torch.complex64,
          f"signal_dist: stft {spec.device} {spec.dtype}, istft {y1.device}")
    check(err <= ISTFT_PEAK_TOL * peak,
          f"signal_dist: istft(stft(x)) max error {err} > "
          f"{ISTFT_PEAK_TOL} x peak {peak}")
    check(torch.equal(y1, y2), "signal_dist: two istft calls differ")
    rec["istft_max_err_over_peak"] = err / peak
    for dt in (torch.float16, torch.bfloat16):
        refused = False
        try:
            fft.rfft(x[:1, :1024].to(dt))
        except ValueError:
            refused = True
        check(refused, f"signal_dist: rfft took a {dt} input")
    rec["refuses_16_bit"] = True

    # times: each layer's forward over the batch (host clock, ending in a
    # synchronize), stft and the overlap-add by CUDA events
    audio_s = ASR_BATCH * ASR_CLIP_S
    rec["forward_ms"], rec["audio_s_per_s"] = {}, {}
    with torch.no_grad():
        for k, m in card.items():
            ms = _forward_ms(torch, lambda m=m: m(x), iters=5)
            rec["forward_ms"][k] = ms
            rec["audio_s_per_s"][k] = audio_s / (ms / 1e3)
        wave = torch.fft.irfft(spec.transpose(1, 2), n=n_fft).transpose(1, 2)
        wave = wave.contiguous()
        rec["stft_ms"] = cuda_ms(torch, stft, 5, flush)
        rec["overlap_add_ms"] = cuda_ms(
            torch, lambda: signal.overlap_add(wave, hop), 5, flush)
        rec["istft_ms"] = cuda_ms(
            torch, lambda: signal.istft(spec, n_fft, hop, window=win,
                                        length=x.shape[-1]), 5, flush)
    log(f"[signal_dist] Whisper front end, {ASR_BATCH} x {ASR_CLIP_S} s "
        f"clips: against float64 on the CPU "
        f"{json.dumps(rec['against_cpu_f64'])}; istft(stft(x)) max error / "
        f"peak {rec['istft_max_err_over_peak']:.3g}, bit-identical twice; "
        f"forward ms {json.dumps(rec['forward_ms'])}; audio s per wall s "
        f"{json.dumps(rec['audio_s_per_s'])}; stft {rec['stft_ms']:.3f} ms, "
        f"overlap_add {rec['overlap_add_ms']:.3f} ms, istft "
        f"{rec['istft_ms']:.3f} ms (CUDA events)")
    return rec


def _continuous_bernoulli_cdf(p):
    def cdf(x):
        return (p ** x * (1 - p) ** (1 - x) + p - 1) / (2 * p - 1)
    return cdf


def _dist_cases(torch, np_logits):
    """name -> (constructor over a device, the exact CDF or None, the
    exact mean and covariance or None). Python-number parameters, so a
    distribution on the card is placed there by default."""
    from scipy import stats

    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch.core.device import resolve_device

    logits = np_logits.astype(np.float32)

    def cat_logits(a, dev):
        # a tensor parameter keeps its device: None places it as a number
        # would be placed
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            resolve_device(dev))

    p_cat = np.exp(logits.astype(np.float64) - logits.max())
    p_cat /= p_cat.sum()
    ks = np.arange(p_cat.size, dtype=np.float64)
    cat_mean = float((ks * p_cat).sum())
    p_mult = np.array([0.1, 0.2, 0.3, 0.4])
    alpha = np.array([2.0, 3.0, 5.0])
    a0 = alpha.sum()
    a_ = np.random.RandomState(1).randn(3, 3)
    mvn_cov = a_ @ a_.T + np.eye(3)
    mvn_loc = np.array([0.5, -1.0, 2.0])

    def moments(dist):
        return np.array([dist.mean()]), np.array([[dist.var()]])

    cases = {
        "Normal": (lambda d: D.Normal(0.5, 2.0, device=d),
                   stats.norm(0.5, 2.0).cdf, None),
        "Uniform": (lambda d: D.Uniform(-1.0, 3.0, device=d),
                    stats.uniform(-1.0, 4.0).cdf, None),
        "Exponential": (lambda d: D.Exponential(1.5, device=d),
                        stats.expon(scale=1 / 1.5).cdf, None),
        "Laplace": (lambda d: D.Laplace(0.5, 2.0, device=d),
                    stats.laplace(0.5, 2.0).cdf, None),
        "LogNormal": (lambda d: D.LogNormal(0.2, 0.7, device=d),
                      stats.lognorm(0.7, scale=np.exp(0.2)).cdf, None),
        "Gumbel": (lambda d: D.Gumbel(0.5, 2.0, device=d),
                   stats.gumbel_r(0.5, 2.0).cdf, None),
        "Gamma": (lambda d: D.Gamma(2.5, 1.5, device=d),
                  stats.gamma(2.5, scale=1 / 1.5).cdf, None),
        "Beta": (lambda d: D.Beta(2.0, 3.0, device=d),
                 stats.beta(2.0, 3.0).cdf, None),
        "Cauchy": (lambda d: D.Cauchy(0.5, 2.0, device=d),
                   stats.cauchy(0.5, 2.0).cdf, None),
        "Chi2": (lambda d: D.Chi2(5.0, device=d), stats.chi2(5.0).cdf, None),
        "StudentT": (lambda d: D.StudentT(4.0, 0.5, 2.0, device=d),
                     stats.t(4.0, 0.5, 2.0).cdf, None),
        "ContinuousBernoulli": (
            lambda d: D.ContinuousBernoulli(0.3, device=d),
            _continuous_bernoulli_cdf(0.3), None),
        "Bernoulli": (lambda d: D.Bernoulli(0.3, device=d), None,
                      moments(stats.bernoulli(0.3))),
        "Categorical": (
            lambda d: D.Categorical(logits=cat_logits(logits, d)), None,
            (np.array([cat_mean]),
             np.array([[float(((ks - cat_mean) ** 2 * p_cat).sum())]]))),
        "Poisson": (lambda d: D.Poisson(4.5, device=d), None,
                    moments(stats.poisson(4.5))),
        # failures before the first success: scipy's geom shifted by 1
        "Geometric": (lambda d: D.Geometric(0.3, device=d), None,
                      moments(stats.geom(0.3, loc=-1))),
        "Binomial": (lambda d: D.Binomial(20.0, 0.3, device=d), None,
                     moments(stats.binom(20, 0.3))),
        "Multinomial": (
            lambda d: D.Multinomial(10, p_mult.astype(np.float32), device=d),
            None, (10 * p_mult, 10 * (np.diag(p_mult)
                                     - np.outer(p_mult, p_mult)))),
        "Dirichlet": (
            lambda d: D.Dirichlet(alpha.astype(np.float32), device=d), None,
            (alpha / a0, (a0 * np.diag(alpha) - np.outer(alpha, alpha))
             / (a0 ** 2 * (a0 + 1)))),
        "MultivariateNormal": (
            lambda d: D.MultivariateNormal(
                mvn_loc.astype(np.float32),
                covariance_matrix=mvn_cov.astype(np.float32), device=d),
            None, (mvn_loc, mvn_cov)),
    }
    return cases, cat_logits


def _ks_statistic(x, cdf):
    """sup |F_n - F| of the sorted draws ``x`` against the exact CDF
    (float64)."""
    n = x.size
    f = cdf(x)
    return float(max((np.arange(1, n + 1) / n - f).max(),
                     (f - np.arange(n) / n).max()))


def _moment_errors(torch, draws, mean, cov):
    """The largest |estimate - exact| / standard error over the mean's and
    the covariance's entries; each standard error estimated from the
    draws [n, d] (float64 on their device)."""
    x = draws.reshape(draws.shape[0], -1).double()
    n = x.shape[0]
    mu = x.mean(0)
    c = x - mu
    cov_hat = c.T @ c / (n - 1)
    m22 = (c * c).T @ (c * c) / n
    se_mean = torch.sqrt(torch.diagonal(cov_hat) / n)
    se_cov = torch.sqrt(torch.clamp(m22 - cov_hat ** 2, min=0.0) / n)
    mean_t = torch.as_tensor(mean, dtype=torch.float64, device=x.device)
    cov_t = torch.as_tensor(cov, dtype=torch.float64, device=x.device)
    z_mean = (mu - mean_t).abs() / se_mean.clamp_min(1e-30)
    z_cov = (cov_hat - cov_t).abs() / se_cov.clamp_min(1e-30)
    return float(z_mean.max()), float(z_cov.max())


def _has(dist, method):
    from paddle_tpu_torch.distribution import Distribution

    return getattr(type(dist), method) is not getattr(Distribution, method)


def _distributions(torch, dev):
    """(b): draws by distribution, one seed one output, the deterministic
    methods against the CPU, the host syncs of each ``sample``."""
    from paddle_tpu_torch.distribution import distributions as DD

    np_logits = np.random.RandomState(0).randn(32000) * 2.0
    cases, cat_logits = _dist_cases(torch, np_logits)
    rec = {"draws": DIST_DRAWS, "ks": {}, "moments": {}, "sample_syncs": {},
           "cpu_rel": {}, "sample_ms": {}}
    n = DIST_DRAWS
    ks_bound = KS_C / np.sqrt(n)
    for name, (make, cdf, mom) in cases.items():
        dist, dist_cpu = make(None), make("cpu")
        check(dist._device.type == dev,
              f"signal_dist: {name} placed on {dist._device}")
        g = torch.Generator(device=dev).manual_seed(1)
        draws, syncs = _count_syncs(torch, lambda: dist.sample([n], g))
        check(draws.device.type == dev,
              f"signal_dist: {name} drew on {draws.device}")
        rec["sample_syncs"][name] = syncs
        rec["sample_ms"][name] = _forward_ms(
            torch, lambda: dist.sample([n], g), iters=3)
        if cdf is not None:
            d = _ks_statistic(
                torch.sort(draws.double()).values.cpu().numpy(), cdf)
            rec["ks"][name] = d
            check(d < ks_bound, f"signal_dist: {name} KS statistic {d} >= "
                                f"{ks_bound} over {n} draws")
        else:
            zm, zc = _moment_errors(torch, draws, *mom)
            rec["moments"][name] = {"mean_se": zm, "cov_se": zc}
            check(zm <= MOMENT_SE and zc <= MOMENT_SE,
                  f"signal_dist: {name} moments off by {zm} (mean), {zc} "
                  f"(covariance) standard errors > {MOMENT_SE}")
        # one seed, one output
        a, b = (dist.sample([1000], torch.Generator(device=dev).manual_seed(7))
                for _ in range(2))
        check(torch.equal(a, b), f"signal_dist: {name}: one seed, two draws")
        # the deterministic methods on the card against the CPU, on the
        # card's draws; rsample, log_prob and entropy with no host sync
        v = draws[:4096]
        with no_host_sync(torch):
            lp = dist.log_prob(v)
            ent = dist.entropy() if _has(dist, "entropy") else None
            rs = dist.rsample([16]) if _has(dist, "rsample") else None
        check(all(t.device.type == dev for t in (lp, ent, rs)
                  if t is not None),
              f"signal_dist: {name} computed off the card")
        got = {"log_prob": (lp, dist_cpu.log_prob(v.cpu()))}
        if ent is not None:
            got["entropy"] = (ent, dist_cpu.entropy())
        rels = {k: _rel_l2(a.cpu(), b) for k, (a, b) in got.items()}
        rec["cpu_rel"][name] = rels
        for k, r in rels.items():
            check(r <= DIST_CPU_RTOL, f"signal_dist: {name}.{k} on the card "
                                      f"vs the CPU {r} > {DIST_CPU_RTOL}")
    # every registered KL pair: the second argument's parameters differ
    kl_q = {DD.Normal: lambda d: DD.Normal(-0.3, 1.2, device=d),
            DD.Uniform: lambda d: DD.Uniform(-2.0, 4.0, device=d),
            DD.Bernoulli: lambda d: DD.Bernoulli(0.6, device=d),
            DD.Categorical: lambda d: DD.Categorical(logits=cat_logits(
                np_logits[::-1].astype(np.float32), d)),
            DD.Exponential: lambda d: DD.Exponential(0.7, device=d)}
    rec["kl_rel"] = {}
    for pc, qc in DD._KL_REGISTRY:
        check(pc is qc and pc in kl_q,
              f"signal_dist: no case for the KL pair {pc.__name__}, "
              f"{qc.__name__}")
        make = cases[pc.__name__][0]
        p_card, q_card = make(None), kl_q[qc](None)
        with no_host_sync(torch):
            kl = DD.kl_divergence(p_card, q_card)
        ref = DD.kl_divergence(make("cpu"), kl_q[qc]("cpu"))
        r = _rel_l2(kl.cpu(), ref)
        rec["kl_rel"][pc.__name__] = r
        check(kl.device.type == dev and r <= DIST_CPU_RTOL,
              f"signal_dist: kl_divergence({pc.__name__}) on the card vs "
              f"the CPU {r} > {DIST_CPU_RTOL}")
    synced = {k: v for k, v in rec["sample_syncs"].items() if v}
    log(f"[signal_dist] {len(cases)} distributions, {n} draws each: KS "
        f"(bound {ks_bound:.5f}) {json.dumps(rec['ks'])}; moments in "
        f"standard errors {json.dumps(rec['moments'])}; one seed one "
        f"output; log_prob / entropy / KL vs the CPU within "
        f"{DIST_CPU_RTOL} (worst "
        f"{max(max(v.values()) for v in rec['cpu_rel'].values()):.3g}, KL "
        f"{max(rec['kl_rel'].values()):.3g}); sample ms "
        f"{json.dumps(rec['sample_ms'])}; samples that synchronize: "
        f"{synced or 'none'}")
    return rec


@contextlib.contextmanager
def fixed_noise(DD, eps):
    """Inside: the reparameterized draws take ``eps`` as their noise (the
    same noise on the card and on the CPU)."""
    saved = DD._randn
    DD._randn = lambda shape, like, generator: eps.to(like.device)
    try:
        yield
    finally:
        DD._randn = saved


def _vae_step(torch, dev):
    """A VAE-sized step: q = Normal(loc, exp(log_scale)) over [4096, 512],
    z = q.rsample(), a reconstruction term, the analytic KL to N(0, 1) and
    its Monte Carlo estimate by ``log_prob``, then backward; the gradients
    on the card against the CPU on the same noise, and the step's time."""
    from paddle_tpu_torch.distribution import distributions as DD

    rng = np.random.RandomState(2)
    init = [rng.randn(*VAE_SHAPE).astype(np.float32) * s
            for s in (0.5, 0.1, 1.0)]
    eps = torch.randn(VAE_SHAPE, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)

    def leaves(d):
        loc, log_scale, target = (torch.tensor(a, device=d) for a in init)
        return loc.requires_grad_(), log_scale.requires_grad_(), target

    def step(loc, log_scale, target):
        loc.grad = log_scale.grad = None
        q = DD.Normal(loc, torch.exp(log_scale))
        p = DD.Normal(0.0, 1.0, device=loc.device)
        z = q.rsample()
        recon = 0.5 * torch.square(z - target).sum(-1).mean()
        kl = DD.kl_divergence(q, p).sum(-1).mean()
        mc = (q.log_prob(z) - p.log_prob(z)).sum(-1).mean()
        loss = recon + kl + 0.5 * mc
        loss.backward()
        return loss.detach(), loc.grad, log_scale.grad

    on_card = leaves(dev)
    with fixed_noise(DD, eps):
        with no_host_sync(torch):
            card = step(*on_card)
        cpu = step(*leaves("cpu"))
        ms = _forward_ms(torch, lambda: step(*on_card), iters=10)
    rels = {k: _rel_l2(a.cpu(), b)
            for k, a, b in zip(("loss", "d_loc", "d_log_scale"), card, cpu)}
    check(all(t.device.type == dev for t in card) and all(
        r <= VAE_GRAD_RTOL for r in rels.values()),
        f"signal_dist: VAE step on the card vs the CPU {rels} > "
        f"{VAE_GRAD_RTOL}")
    log(f"[signal_dist] VAE step over {VAE_SHAPE}: {ms:.3f} ms (host clock, "
        f"mean of 10), card vs CPU {json.dumps(rels)}")
    return {"shape": list(VAE_SHAPE), "step_ms": ms, "rel_l2": rels}


def phase_signal_dist(torch):
    """``signal_dist``: the Whisper log-mel front end, the distributions on
    the card and a VAE-sized step; no hand kernel on this path."""
    from paddle_tpu_torch.kernels import _build

    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    _build.reset_launch_counts()
    rec = {"asr": _asr_front_end(torch, "cuda", flush),
           "distributions": _distributions(torch, "cuda"),
           "vae": _vae_step(torch, "cuda")}
    counts = _build.launch_counts()
    check(set(counts.values()) == {0},
          f"signal_dist: hand kernels launched {counts}")
    rec["launches"] = counts
    return rec


# host runtime calls that launch device work, as torch.profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")


def _profiled_steps(torch, engine, n, tag, port_names):
    """``n`` engine steps under torch.profiler (after one profiled step
    that takes the profiler's first-use set-up out of the window), then
    the same ``n`` without it: wall ms per step both ways, device busy ms
    and kernels per step, the host's launch calls per step
    (``HOST_LAUNCH_CALLS``) and the port's kernels named in
    ``port_names`` (device us and calls per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            engine.step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    events = prof.key_averages()
    # kernels only: an ATen op's own row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels) / n
    host = {e.key: e.count / n for e in events if e.key in HOST_LAUNCH_CALLS}
    ours = {}
    for e in kernels:
        for name in port_names:
            # a whole name: "kv_write" is not "rope_kv_write_kernel"
            if re.search(rf"(?<!\w){name}", e.key):
                us, calls = ours.get(name, (0.0, 0.0))
                ours[name] = (us + e.self_device_time_total / n,
                              calls + e.count / n)
    log(f"[profile] {tag}: wall {wall:.3f} ms/step under the profiler, "
        f"device busy {device_us / n / 1e3:.3f} ms/step in {launches:.0f} "
        f"kernels/step; host launch calls/step {host}; the port's kernels "
        f"(device us, calls)/step {ours}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile] {e.key[:60]:60s} device "
            f"{e.self_device_time_total / n:9.1f} us/step, "
            f"calls/step {e.count / n:6.1f}")
    t0 = time.perf_counter()
    for _ in range(n):
        engine.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / n * 1e3
    log(f"[profile] {tag} without the profiler: {plain_wall:.3f} ms/step")
    return {"wall_ms_profiled": wall, "wall_ms": plain_wall,
            "device_busy_ms": device_us / n / 1e3,
            "kernels_per_step": launches,
            "host_launch_calls_per_step": host,
            "port_kernels_us_calls_per_step": ours}


@contextlib.contextmanager
def _ring_paged_prefill():
    """Every continuation-kernel launch made inside takes the ring design
    (the engine has no such knob: its programs take the split design), so
    the profile can set the two designs side by side in one run."""
    from paddle_tpu_torch.kernels import paged_prefill as pp

    design_for = pp.design_for
    pp.design_for = lambda dtype, d, page, design=None: design_for(
        dtype, d, page, "ring")
    try:
        yield
    finally:
        pp.design_for = design_for


def _spec_profile(torch, model, kv, pool, design, n):
    """The serving_spec cell's step, replayed, under torch.profiler
    (``_profiled_steps``): ``speculate_tokens=4`` over 8 prompts of one
    repeated token, n steps after 40, with the verify step's device time
    and the continuation kernel's share of it."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    engine = Engine(model, EngineConfig(
        max_batch_slots=8, max_model_len=512, page_size=16,
        kv_cache_dtype=kv, speculate_tokens=SPEC_K))
    rng = np.random.RandomState(3)
    for t in rng.randint(1, 32000, 8):
        engine.add_request([int(t)] * SPEC_PROMPT_COPIES,
                           SamplingParams(max_new_tokens=496))
    for _ in range(40):
        engine.step()
    m = engine.metrics
    v0, d0 = m.verify_steps, m.decode_steps
    r = _profiled_steps(
        torch, engine, n, f"{pool} pool, speculative step (K = {SPEC_K}, 8 "
                          f"slots, {design} design)",
        ("rope_kv_write", "kv_write", "paged_decode", "paged_prefill"))
    # the window ran 2n steps (profiled, then plain)
    r["verify_steps"] = m.verify_steps - v0
    r["decode_steps"] = m.decode_steps - d0
    # the verify step's device time and the continuation kernel's share
    # of it: L paged_prefill launches a verify step
    us, calls = r["port_kernels_us_calls_per_step"].get(
        "paged_prefill", (0.0, 0.0))
    L = SERVING_CFG["num_hidden_layers"]
    r["verify_fraction"] = calls / L
    r["paged_prefill_ms_per_verify_step"] = (
        us / 1e3 / r["verify_fraction"] if calls else None)
    r["paged_prefill_share"] = us / 1e3 / r["device_busy_ms"]
    log(f"[profile] {pool} pool, {design} design: {r['verify_steps']} "
        f"verify and {r['decode_steps']} decode steps in {2 * n} steps; "
        f"device busy {r['device_busy_ms']:.3f} ms/step with "
        f"{r['verify_fraction']:.2f} verify steps a step; paged_prefill "
        f"{us / 1e3:.4f} ms/step ({calls:.1f} launches), "
        f"{100 * r['paged_prefill_share']:.1f} % of the device time")
    del engine
    return r


def phase_profile(torch):
    """Where a full-width decode step's time goes, over the bf16 pool and
    the int8 pool, both ways: the decode program replayed (the engine's
    path) and its function run eagerly over the same static buffers
    (``_eager_programs``). torch.profiler over 20 steps with all 8 slots
    decoding: device busy time and kernels per step, and the host's
    launch calls per step (``HOST_LAUNCH_CALLS``: one graph launch a step
    when replayed); then the same 20 steps without the profiler (wall ms
    per step), and 20 runs of the 128-token bucket's prefill program
    (wall ms to a sync). Then the serving_spec cell's step, replayed
    (``_spec_profile``), with the continuation kernel's split design (the
    engine's) and then its ring design (``_ring_paged_prefill``): the
    verify step's device time and the kernel's share of it on each; and
    the decode step with the step observatory on and off
    (``_observatory_profile``: equal kernels and host launch calls). Not
    part of the default run."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    model = LlamaForCausalLM(LlamaConfig(**SERVING_CFG), seed=0)
    result = {}
    n = 20
    for pool in ("bf16", "int8"):
        kv = "int8" if pool == "int8" else None
        for way in ("replay", "eager"):
            engine = Engine(model, EngineConfig(
                max_batch_slots=8, max_model_len=512, page_size=16,
                kv_cache_dtype=kv))
            if way == "eager":
                _eager_programs(engine)
            rng = np.random.RandomState(0)
            for _ in range(8):
                engine.add_request(rng.randint(1, 32000, 100).tolist(),
                                   SamplingParams(max_new_tokens=200))
            for _ in range(30):   # admit, prefill, warm up
                engine.step()
            tag = f"{pool} pool, {way}"
            r = _profiled_steps(
                torch, engine, n, f"{tag}, decode step (8 slots, ~130 "
                                  f"cached tokens each)",
                ("rope_kv_write", "kv_write", "paged_decode"))
            # the 128-token bucket's prefill program alone, over the last
            # prefill's staged inputs (a 100-token prompt: it rewrites the
            # same K/V into the same pages), host clock to a sync
            prefill = engine._prefill_programs[128]
            engine._prefill_buffers.stage()
            prefill()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                prefill()
                torch.cuda.synchronize()
            r["prefill_128_ms"] = (time.perf_counter() - t0) / n * 1e3
            log(f"[profile] {tag}, prefill of a 100-token prompt (bucket "
                f"128): {r['prefill_128_ms']:.3f} ms")
            result[f"{pool}_{way}"] = r
            del engine
        # the speculative step on each design of the continuation kernel,
        # split (the engine's) then ring, each engine capturing its own
        # programs
        result[f"{pool}_spec"] = _spec_profile(torch, model, kv, pool,
                                               "split", n)
        with _ring_paged_prefill():
            result[f"{pool}_spec_ring"] = _spec_profile(torch, model, kv,
                                                        pool, "ring", n)
        split, ring = result[f"{pool}_spec"], result[f"{pool}_spec_ring"]
        log(f"[profile] {pool} pool, verify step device time: split "
            f"{split['device_busy_ms']:.3f} ms against ring "
            f"{ring['device_busy_ms']:.3f} ms; paged_prefill "
            f"{split['paged_prefill_ms_per_verify_step'] or 0:.4f} against "
            f"{ring['paged_prefill_ms_per_verify_step'] or 0:.4f} ms a "
            f"verify step")
    # the step observatory on and off: the same kernels and host launch
    # calls per replayed decode step
    result["observatory"] = _observatory_profile(torch, model, n)
    return result


def flash_f16_entries(flash, bwd, launches):
    """The kernels line's float16 flash entries: the forward and each
    backward kernel at the training shape in float16 (the wgmma
    instances), with the worst error over the float16 cases, the
    launches of the float16 instance on the main paths, the plain
    version's time and SDPA's (forward) or its autograd's (backward)."""
    fwd = [c for c in flash if c["dtype"] == "float16"]
    bw = [c for c in bwd if c["dtype"] == "float16"]
    head = next(c for c in fwd
                if c["case"] == f"s{TRAIN_SEQ}_b{TRAIN_BATCH}_f16")
    shape = f"b{TRAIN_BATCH} h16 d128 s{TRAIN_SEQ} causal, float16"
    out = [{
        "name": "flash_attention_fwd/float16", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/kernels/pallas/flash_attention.py:37",
        **launches("flash_attention/float16"),
        "max_abs_err": max(c["max_abs_err"] for c in fwd),
        "variant": head["variant"], "ms": head["ms"],
        "prev_ms": head["prev_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": shape,
        "cases": {c["case"]: {k: c[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
            for c in fwd},
    }]
    head = next(c for c in bw if c["case"] == "train_f16")
    for part, line in (("dq", 138), ("dkv", 191)):
        grads = ("dq",) if part == "dq" else ("dk", "dv")
        name = f"flash_attention_bwd_{part}"
        out.append({
            "name": f"{name}/float16", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/kernels/pallas/flash_attention.py:{line}",
            **launches(f"{name}/float16"),
            "max_abs_err": max(c["max_abs_err"][g] for c in bw
                               for g in grads),
            "variant": head["variant"], "ms": head[f"{part}_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head[f"{part}_bound_ms"],
            "bound_by": head[f"{part}_bound_by"],
            "library_ms": head["library_ms"], "shape": shape,
            "backward_ms": head["ms"],
            "backward_bound_ms": head["bound_ms"],
            "cases": {c["case"]: {
                "ms": c["ms"], f"{part}_ms": c[f"{part}_ms"],
                "plain_ms": c["plain_ms"], "library_ms": c["library_ms"],
                "bound_ms": c["bound_ms"],
                "max_abs_err": {g: c["max_abs_err"][g] for g in grads}}
                for c in bw},
        })
    return out


def flash_tf32_entry(flash, plants, launches):
    """The kernels line's entry of the f32 forward's 3xTF32 design at the
    DiT shape (its main path, 8 launches a f32 DiT step): ``ms`` through
    the wrapper, ``prev_ms`` the FMA kernel there, the plain version's
    and SDPA f32's times, its bound (three TF32 products) beside the FMA
    design's, every f32 case it ran (times, float64 errors of both
    designs) and what the gate read on the planted copies."""
    cases = [c for c in flash if c["variant"] == "tf32x3"]
    head = next(c for c in cases if c["case"] == DIT_F32_CASE)
    return {
        "name": "flash_attention_fwd/tf32x3", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "paddle_tpu/kernels/pallas/flash_attention.py:37",
        **launches("flash_attention", ["tf32x3"]),
        "max_abs_err": max(c["variants"]["tf32x3"]["max_abs_err"]
                           for c in cases),
        "variant": "tf32x3", "ms": head["ms"], "prev_ms": head["prev_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "fma_bound_ms": head["fma_bound_ms"],
        "library_ms": head["library_ms"],
        "shape": f"b{DIT_BATCH} h{DIT_CFG['num_heads']} d{DIT_HEAD_DIM} "
                 f"s{DIT_SEQ} full, float32",
        "cases": {c["case"]: {
            "ms": c["ms"], "kernel_ms": c["variants"]["tf32x3"].get(
                "kernel_ms", c["variants"]["tf32x3"]["ms"]),
            "prev_ms": c["prev_ms"], "plain_ms": c["plain_ms"],
            "library_ms": c["library_ms"], "bound_ms": c["bound_ms"],
            "fma_bound_ms": c["fma_bound_ms"],
            "max_abs_err": c["variants"]["tf32x3"]["max_abs_err"],
            "f64_rel_l2": c["variants"]["tf32x3"]["f64_rel_l2"],
            "fma_f64_rel_l2": c["variants"]["fma"]["f64_rel_l2"]}
            for c in cases},
        "plants": {n: {"rel_l2": st["rel_l2"], "gate_ok": st["gate_ok"]}
                   for n, st in plants.items()},
    }


def flash_bwd_tf32_entries(bwd, plants, launches):
    """The kernels line's entries of the f32 backward's 3xTF32 kernels
    (dq, dk/dv) at the DiT shape (their main path, 8 launches each a f32
    DiT step): ``ms`` each kernel alone, ``prev_ms`` the FMA kernel
    there, the plain version's and SDPA f32 autograd's times of the whole
    backward, the bounds (three TF32 products) beside the FMA design's,
    every f32 case the kernels ran (times, float64 errors of both designs
    per gradient) and what the gate read on the planted copies."""
    cases = [c for c in bwd if c["variant"] == "tf32x3"]
    head = next(c for c in cases if c["case"] == "dit_f32")
    out = []
    for part, line in (("dq", 138), ("dkv", 191)):
        grads = ("dq",) if part == "dq" else ("dk", "dv")
        name = f"flash_attention_bwd_{part}"
        out.append({
            "name": f"{name}/tf32x3", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/kernels/pallas/flash_attention.py:{line}",
            **launches(name, ["tf32x3"]),
            "max_abs_err": max(c["variants"]["tf32x3"]["max_abs_err"][g]
                               for c in cases for g in grads),
            "variant": "tf32x3", "ms": head[f"{part}_ms"],
            "median_ms": head["variants"]["tf32x3"][f"{part}_median_ms"],
            "prev_ms": head["variants"]["fma"][f"{part}_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head[f"{part}_bound_ms"],
            "bound_by": head[f"{part}_bound_by"],
            "fma_bound_ms": head[f"fma_{part}_bound_ms"],
            "library_ms": head["library_ms"],
            "shape": f"b{DIT_BATCH} h{DIT_CFG['num_heads']} d{DIT_HEAD_DIM} "
                     f"s{DIT_SEQ} full, float32",
            "backward_ms": head["ms"], "backward_prev_ms": head["prev_ms"],
            "backward_bound_ms": head["bound_ms"],
            "backward_fma_bound_ms": head["fma_bound_ms"],
            "cases": {c["case"]: {
                "ms": c["ms"], f"{part}_ms": c[f"{part}_ms"],
                f"{part}_prev_ms": c["variants"]["fma"][f"{part}_ms"],
                "prev_ms": c["prev_ms"], "plain_ms": c["plain_ms"],
                "library_ms": c["library_ms"], "bound_ms": c["bound_ms"],
                f"{part}_bound_ms": c[f"{part}_bound_ms"],
                "fma_bound_ms": c["fma_bound_ms"],
                f"fma_{part}_bound_ms": c[f"fma_{part}_bound_ms"],
                "max_abs_err": {g: c["variants"]["tf32x3"]["max_abs_err"][g]
                                for g in grads},
                "f64_rel_l2": {g: c["variants"]["tf32x3"]["f64_rel_l2"][g]
                               for g in grads},
                "fma_f64_rel_l2": {g: c["variants"]["fma"]["f64_rel_l2"][g]
                                   for g in grads}}
                for c in cases},
            "plants": {n: {"rel_l2": st["rel_l2"], "gate_ok": st["gate_ok"]}
                       for n, st in plants.items()
                       if n.rsplit(".", 1)[1] in grads},
        })
    return out


def dit_flash_cases(flash, bwd, part=None):
    """The DiT cell's attention shape (non-causal, b 32, h 8, d 64, s 256)
    in bf16 and f32, for the kernels line: the forward's cases, or with
    ``part`` ("dq", "dkv") one backward kernel's, each with its time,
    bound, plain and library times and error."""
    if part is None:
        cases = [c for c in flash if c["case"].startswith(
            f"s{DIT_SEQ}_b{DIT_BATCH}_d{DIT_HEAD_DIM}_full")]
        return {c["dtype"]: {k: c[k] for k in (
            "variant", "ms", "prev_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")} for c in cases}
    grads = ("dq",) if part == "dq" else ("dk", "dv")
    return {c["dtype"]: {
        "variant": c["variant"], "ms": c[f"{part}_ms"],
        "bound_ms": c[f"{part}_bound_ms"], "bound_by": c[f"{part}_bound_by"],
        "backward_ms": c["ms"], "backward_bound_ms": c["bound_ms"],
        "plain_ms": c["plain_ms"], "library_ms": c["library_ms"],
        "max_abs_err": max(c["max_abs_err"][g] for g in grads)}
        for c in bwd if c["case"] in ("dit", "dit_f32")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--phases",
        default="kernels,parity,serving,serving_int8,serving_f16,"
                "serving_prefix,serving_spec,analysis,jit,server,journal,"
                "poison,fleet,spill,stepstats,train_parity,train,train_amp,"
                "train_resume,dit,resnet,moe,moe_train,hapi,nn_zoo,"
                "signal_dist",
        help="comma list of kernels, parity, serving, serving_int8, "
             "serving_f16, serving_prefix, serving_spec, analysis, jit, "
             "server, journal, poison, fleet, spill, stepstats, "
             "train_parity, "
             "train, train_amp, train_resume, dit, resnet, moe, moe_train, "
             "hapi, nn_zoo, signal_dist, profile (default: all but "
             "profile)",
    )
    ap.add_argument("--out", help="write the full report as JSON here")
    # the processes the server and journal phases start
    ap.add_argument("--http-client", nargs=2, metavar=("SPEC", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--journal-worker", nargs=3,
                    metavar=("DIR", "OUT", "KILL_AT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--train-worker", nargs=2, metavar=("SPEC", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--jit-worker", nargs=2, metavar=("SPEC", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.http_client:
        return http_client_main(*args.http_client)
    if args.journal_worker:
        jdir, out, kill_at = args.journal_worker
        return journal_worker_main(jdir, out, int(kill_at))
    if args.train_worker:
        return train_worker_main(*args.train_worker)
    if args.jit_worker:
        return jit_worker_main(*args.jit_worker)
    phases = set(args.phases.split(","))
    unknown = phases - {"kernels", "parity", "serving", "serving_int8",
                        "serving_f16", "serving_prefix", "serving_spec",
                        "analysis", "jit", "server", "journal", "poison",
                        "fleet", "spill",
                        "stepstats", "train_parity", "train", "train_amp",
                        "train_resume", "dit", "resnet", "moe", "moe_train",
                        "hapi", "nn_zoo", "signal_dist", "profile"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from paddle_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2

    report = {"phases": {}}
    t_start = time.perf_counter()
    try:
        card = device_line()
        log(card)   # name, power limit: exactly as nvidia-smi prints them
        log(f"[device] torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("[device] TF32 off for matmul and cuDNN: f32 phases run in "
            "full f32")
        report["device"] = card

        t0 = time.perf_counter()
        _build.build()
        log(f"[build] {len(_build.KERNELS)} kernels in "
            f"{time.perf_counter() - t0:.1f}s")
        report["build"] = {}
        for name, text in _build.build_logs().items():
            # each kernel's name (mangled), its spills and registers, and
            # warning C7515 where ptxas serialized its wgmmas
            lines = [line.strip() for line in text.splitlines()
                     if "entry function" in line or "registers" in line
                     or "spill" in line or "C7515" in line]
            report["build"][name] = lines
            for line in lines:
                log(f"[build] {name}: {line}")

        runners = {
            "kernels": phase_kernels, "parity": phase_parity,
            "serving": phase_serving, "serving_int8": phase_serving_int8,
            "serving_f16": phase_serving_f16,
            "serving_prefix": phase_serving_prefix,
            "serving_spec": phase_serving_spec,
            "analysis": phase_analysis, "jit": phase_jit,
            "server": phase_server, "journal": phase_journal,
            "poison": phase_poison, "fleet": phase_fleet,
            "spill": phase_spill, "stepstats": phase_stepstats,
            "train_parity": phase_train_parity, "train": phase_train,
            "train_amp": phase_train_amp,
            "train_resume": phase_train_resume, "dit": phase_dit,
            "resnet": phase_resnet, "moe": phase_moe,
            "moe_train": phase_moe_train, "hapi": phase_hapi,
            "nn_zoo": phase_nn_zoo, "signal_dist": phase_signal_dist,
            "profile": phase_profile,
        }
        results, report["phase_seconds"] = {}, {}
        for name, run in runners.items():
            if name not in phases:
                continue
            t0 = time.perf_counter()
            results[name] = run(torch)
            report["phase_seconds"][name] = time.perf_counter() - t0
            log(f"[{name}] phase done in "
                f"{report['phase_seconds'][name]:.1f}s")
        paged = flash = bwd = None
        if "kernels" in results:
            (paged, flash, bwd, faults, quant, gmm, gmm_quant, kvw, rkv,
             pfx, pfx_batched, wgrad, dlhs, plants,
             bwd_plants) = results.pop("kernels")
            report["phases"]["kernels"] = {
                "paged": paged, "flash": flash, "flash_bwd": bwd,
                "gate_faults": faults, "f32_forward_plants": plants,
                "f32_backward_plants": bwd_plants,
                "paged_quant": quant, "gmm": gmm,
                "gmm_quant": gmm_quant, "kv_write": kvw,
                "rope_kv_write": rkv,
                "paged_prefill": pfx, "paged_prefill_batched": pfx_batched,
                "grouped_matmul_wgrad": wgrad, "grouped_matmul_dlhs": dlhs,
            }
            # the wrapper's choice against the previous kernel, same
            # inputs, run and host path: reported, not gated (the small
            # cases are ~0.01 ms), by the mean and by the median, and by
            # the median of the kernels alone (the unaligned flash case
            # without its copies; the backward's dq plus dk/dv kernels)
            for stat in ("ms", "median_ms", "kernel_median_ms"):
                slower = {}
                for c in (flash + bwd + gmm + gmm_quant + paged + quant
                          + wgrad):
                    prev = c.get("prev") or (
                        "fma" if c["dtype"] == "float32" else "mma")
                    now, was = (
                        c["variants"][x].get(stat,
                                             c["variants"][x]["median_ms"])
                        for x in (c["variant"], prev))
                    if now > 1.1 * was:
                        slower[f"{c['case']} ({c['variant']})"] = round(
                            now / was, 3)
                report["phases"]["kernels"][f"slower_than_prev_{stat}"] = \
                    slower
                log(f"[kernels] cases >10% slower on the wrapper's choice "
                    f"than on the previous kernel ({stat}): "
                    f"{slower or 'none'}")
            # the continuation kernel's split design against the ring
            # design, kernels alone, same inputs and run: reported, not
            # gated (the cases are 0.01-0.04 ms)
            ratio = {c["case"]: round(c["kernel_median_ms"]
                                      / c["ring_kernel_median_ms"], 3)
                     for c in pfx + pfx_batched if c["design"] == "split"}
            report["phases"]["kernels"]["paged_prefill_split_vs_ring"] = ratio
            log(f"[kernels] paged_prefill split / ring median (kernel "
                f"alone): {ratio}; slower than the ring: "
                f"{[k for k, r in ratio.items() if r > 1] or 'none'}")
        report["phases"].update(results)
        (serving, serving_int8, serving_f16, serving_prefix, serving_spec,
         analysis, jit_, server, journal, poison, fleet, spill, stepstats,
         train, train_amp, train_resume, dit, resnet, moe, moe_train, hapi,
         nn_zoo, signal_dist) = (
             results.get(p) for p in (
                 "serving", "serving_int8", "serving_f16", "serving_prefix",
                 "serving_spec", "analysis", "jit", "server", "journal",
                 "poison", "fleet",
                 "spill", "stepstats", "train", "train_amp", "train_resume",
                 "dit", "resnet", "moe", "moe_train", "hapi", "nn_zoo",
                 "signal_dist"))
        check("jax" not in sys.modules and not any(
            m == "paddle_tpu" or m.startswith("paddle_tpu.")
            for m in sys.modules),
            "the port imported jax or paddle_tpu")
        if signal_dist is not None:
            # the modules the phase ran are the port's own, and loaded
            missing = [m for m in SIGNAL_DIST_MODULES if m not in sys.modules]
            check(not missing, f"signal_dist: {missing} not loaded")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    report["seconds"] = time.perf_counter() - t_start

    kernels = []
    # launches on each main path: serving (float and int8 pools; float16
    # with both; the prefix cache with chunked prefill, both pools;
    # speculative decoding and its spec-disabled twin, both pools), the
    # HTTP front door's first pass, the journal's recovered engine, the
    # poisoned decode run, the fleet's counted runs (the 2-replica rate
    # runs and the warm-routing pass), the spill cell's counted engines
    # (unconstrained, spill and recompute, both pools), the observatory's
    # timed runs (on and off), the 14 counted train steps, the amp modes'
    # counted steps (O1 bf16, O2 bf16, O2 float16), the resume workers'
    # steps (bf16 and float16), the DiT cell's counted steps (f32 and O2
    # bf16), the ResNet-50 cell's (f32 and O2 bf16: no hand kernel on its
    # path, all 0), the jit phase's compiled calls (to_static's, the loaded
    # program's, the compiled training step and MoE forward, the cached
    # engines' serving), the moe phase's counted forwards, moe_train's counted
    # steps (the Llama MoE's 14, the ragged layer's AdamW steps), hapi's
    # fits and kernel evaluations (the Transformer's; ResNet-50's launch
    # none), nn_zoo's and signal_dist's (none)
    by_path = {p: r["launches"] if r else {} for p, r in (
        ("serving", serving), ("serving_int8", serving_int8),
        ("serving_f16", serving_f16), ("serving_prefix", serving_prefix),
        ("serving_spec", serving_spec), ("analysis", analysis),
        ("jit", jit_), ("server", server),
        ("journal", journal), ("poison", poison), ("fleet", fleet),
        ("spill", spill), ("stepstats", stepstats), ("train", train),
        ("train_amp", train_amp), ("train_resume", train_resume),
        ("dit", dit), ("resnet", resnet), ("moe", moe),
        ("moe_train", moe_train), ("hapi", hapi), ("nn_zoo", nn_zoo),
        ("signal_dist", signal_dist))}

    def launches(name, variants=None):
        """Launches of ``name`` on each main path; with ``variants``, the
        sum of ``name/<variant>`` over them (the grouped GEMM's forward
        and its transposed instance share the name ``grouped_matmul``)."""
        keys = [name] if variants is None else [f"{name}/{v}"
                                                for v in variants]
        per = {p: sum(c.get(key, 0) for key in keys)
               for p, c in by_path.items()}
        return {"launches": sum(per.values()), "launches_by_path": per}

    def variant_entry(name, v, case, cases):
        """One device kernel of a function that has several: its launches
        on the main paths, its time at ``case``, its worst error over
        ``cases``."""
        return {"variant": v, **launches(f"{name}/{v}"),
                "max_abs_err": max(c["variants"][v]["max_abs_err"]
                                   for c in cases if v in c["variants"]),
                "ms": case["variants"][v]["ms"],
                "median_ms": case["variants"][v]["median_ms"],
                "shape": case["case"]}

    def paged_entry(name, line, cases):
        """The paged kernel at the serving shape, on the wrapper's choice
        (the cluster kernel; the split-K kernel as prev_ms), and both
        under "variants" with their launches on the main paths."""
        head = cases[0]
        return {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": f"paddle_tpu/kernels/pallas/paged_attention.py:{line}",
            **launches(name),
            "max_abs_err": max(c["variants"][v]["max_abs_err"]
                               for c in cases for v in PAGED_VARIANTS),
            "variant": head["variant"], "ms": head["ms"],
            "prev_ms": head["prev_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shape": head["case"],
            "variants": [variant_entry(name, v, head, cases)
                         for v in PAGED_VARIANTS],
        }

    if paged is not None:
        kernels.append(paged_entry("paged_attention", 73, paged))
        # the forward at the training shape, on the wrapper's choice
        # (wgmma), the mma.sync kernel there as prev_ms; "variants" lists
        # every device kernel of the function (the f32 3xTF32 and FMA
        # ones at the DiT shape) with its launches on the main paths
        head = next(c for c in flash
                    if c["case"] == f"s{TRAIN_SEQ}_b{TRAIN_BATCH}")
        f32 = next(c for c in flash if c["case"] == DIT_F32_CASE)
        kernels.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/kernels/pallas/flash_attention.py:37",
            **launches("flash_attention"),
            "max_abs_err": max(c["max_abs_err"] for c in flash),
            "variant": head["variant"], "ms": head["ms"],
            "prev_ms": head["prev_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "variants": [
                variant_entry("flash_attention", v, case, flash)
                for v, case in (("wgmma", head), ("mma", head),
                                ("tf32x3", f32), ("fma", f32))],
            "dit": dit_flash_cases(flash, bwd),
        })
        kernels.append(flash_tf32_entry(flash, plants, launches))
        # the training shape, on the wrapper's choice (wgmma), the
        # mma.sync kernels there as prev_ms; each kernel alone (the wgmma
        # dq kernel with delta), plain and library times of the whole
        # backward (dq, dk and dv), the function both kernels make up;
        # "variants" lists every design (the f32 3xTF32 and FMA ones at
        # s 100 d 128)
        head = next(c for c in bwd if c["case"] == "train")
        f32 = next(c for c in bwd if c["case"] == "f32")
        for part, line in (("dq", 138), ("dkv", 191)):
            grads = ("dq",) if part == "dq" else ("dk", "dv")
            name = f"flash_attention_bwd_{part}"
            kernels.append({
                "name": name, "route": "cuda",
                "source":
                    "paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
                "replaces":
                    f"paddle_tpu/kernels/pallas/flash_attention.py:{line}",
                **launches(name),
                "max_abs_err": max(c["max_abs_err"][g] for c in bwd
                                   for g in grads),
                "variant": head["variant"], "ms": head[f"{part}_ms"],
                "median_ms": head["variants"][head["variant"]][
                    f"{part}_median_ms"],
                "prev_ms": head["variants"]["mma"][f"{part}_ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head[f"{part}_bound_ms"],
                "bound_by": head[f"{part}_bound_by"],
                "library_ms": head["library_ms"],
                "shape": f"b{TRAIN_BATCH} h16 d128 s{TRAIN_SEQ} causal",
                "backward_ms": head["ms"],
                "backward_median_ms": head["median_ms"],
                "backward_prev_ms": head["prev_ms"],
                "backward_bound_ms": head["bound_ms"],
                "variants": [{
                    "variant": v, **launches(f"{name}/{v}"),
                    "max_abs_err": max(c["variants"][v]["max_abs_err"][g]
                                       for c in bwd if v in c["variants"]
                                       for g in grads),
                    "ms": case["variants"][v][f"{part}_ms"],
                    "median_ms": case["variants"][v][f"{part}_median_ms"],
                    "shape": case["case"]}
                    for v, case in (("wgmma", head), ("mma", head),
                                    ("tf32x3", f32), ("fma", f32))],
                "dit": dit_flash_cases(flash, bwd, part),
            })
        kernels.extend(flash_bwd_tf32_entries(bwd, bwd_plants, launches))
        # the float16 instances (PR 15) of the forward and of both
        # backward kernels, at the training shape: their launches on the
        # main paths are the ``/float16`` counts (the entries above count
        # every dtype)
        kernels.extend(flash_f16_entries(flash, bwd, launches))
        kernels.append(paged_entry("paged_attention_quant", 103, quant))
        # the grouped GEMM at the MoE layer's up projection, bf16 rhs
        # (wgmma, the mma.sync kernel as prev_ms; the f32 FMA kernel
        # under "variants") and int8 rhs (the int8 wgmma kernel, the
        # mma.sync kernel as prev_ms)
        f32 = next(c for c in gmm if c["dtype"] == "float32")
        for name, line, cases, variants in (
                ("grouped_matmul", 100, gmm,
                 (("wgmma", gmm[0]), ("mma", gmm[0]), ("fma", f32))),
                ("grouped_matmul_quant", 128, gmm_quant,
                 (("wgmma", gmm_quant[0]), ("mma", gmm_quant[0])))):
            head = cases[0]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/kernels/csrc/grouped_matmul.cu",
                "replaces":
                    f"paddle_tpu/kernels/pallas/grouped_matmul.py:{line}",
                **launches(name, [v for v, _ in variants]),
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "variant": head["variant"], "ms": head["ms"],
                "prev_ms": head["prev_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "shape": f"{head['case']}: n {head['n']}, k {head['k']}, "
                         f"m {head['m']}, e {head['experts']}",
                "variants": [variant_entry(name, v, case, cases)
                             for v, case in variants],
            })
        # the weight gradient at the MoE layer's up projection, bf16 (the
        # wgmma kernel, the mma.sync kernel as prev_ms); the f32 FMA
        # kernel under "variants"; library: one torch._grouped_mm call
        # where this PyTorch takes the ragged contraction, else the plain
        # per-expert loop (its note says which)
        head = wgrad[0]
        f32 = next(c for c in wgrad if c["case"] == "f32")
        kernels.append({
            "name": "grouped_matmul_wgrad", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/grouped_matmul_bwd.cu",
            "replaces": "paddle_tpu/kernels/pallas/grouped_matmul.py:220 "
                        "(_gmm_pallas_bwd: drhs from the XLA fallback's "
                        "VJP, no TPU kernel)",
            **launches("grouped_matmul_wgrad"),
            "max_abs_err": max(c["variants"][v]["max_abs_err"]
                               for c in wgrad for v in c["variants"]),
            "variant": head["variant"], "ms": head["ms"],
            "median_ms": head["median_ms"], "prev_ms": head["prev_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library": head["library"],
            "shape": f"{head['case']}: n {head['n']}, k {head['k']}, "
                     f"m {head['m']}, e {head['experts']}",
            "variants": [variant_entry("grouped_matmul_wgrad", v, case,
                                       wgrad)
                         for v, case in (("wgmma", head), ("mma", head),
                                         ("fma", f32))],
        })
        # dlhs at the up projection, bf16, on the transposed instance of
        # the grouped GEMM kernels (wgmma_t; prev_ms: the transposing copy
        # of rhs and the forward on it, what the backward ran before);
        # its launches are grouped_matmul's under the _t variants
        head = dlhs[0]
        f32 = next(c for c in dlhs if c["case"] == "f32")
        kernels.append({
            "name": "grouped_matmul_dlhs", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "paddle_tpu/kernels/pallas/grouped_matmul.py:220 "
                        "(_gmm_pallas_bwd: dlhs from the XLA fallback's "
                        "VJP, no TPU kernel)",
            **launches("grouped_matmul", ["wgmma_t", "mma_t", "fma_t"]),
            "max_abs_err": max(c["variants"][v]["max_abs_err"]
                               for c in dlhs for v in c["variants"]),
            "variant": head["variant"], "ms": head["ms"],
            "median_ms": head["median_ms"], "prev_ms": head["prev_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library": head["library"],
            "shape": f"{head['case']}: g [{head['n']}, {head['m']}] @ "
                     f"rhs[g]^T, rhs [{head['experts']}, {head['k']}, "
                     f"{head['m']}]",
            "variants": [variant_entry("grouped_matmul", v, case, dlhs)
                         for v, case in (("wgmma_t", head), ("mma_t", head),
                                         ("fma_t", f32))],
        })
    if paged is not None:
        # the fused KV write at the serving decode shape on the bf16 pool
        # (library: index_put_ of K and V), with each pool type's kernel
        # under "variants" (launches on the main paths, the decode case):
        # the serving programs write through rope_kv_write, so its
        # launches there are 0 and it is held in the kernels phase only
        head = kvw[0]
        kernels.append({
            "name": "kv_write", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/kv_write.cu",
            "replaces": "paddle_tpu/kernels/pallas/paged_attention.py:292 "
                        "(update_pages and quantize_tokens :59: XLA ops, "
                        "no TPU kernel)",
            **launches("kv_write"),
            "max_abs_err": max(c["max_abs_err"] for c in kvw),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": f"{head['case']}: {head['rows']} rows, hkv 16, d 128, "
                     f"page 16",
            "variants": [{
                "variant": v, **launches(f"kv_write/{v}"),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "library_ms": c["library_ms"], "bound_ms": c["bound_ms"],
                "shape": c["case"]}
                for v, c in (("float", head),
                             ("int8", next(c for c in kvw
                                           if c["case"] == "decode_int8")))],
        })
    if paged is not None:
        # the rotating page write at the serving decode shape on the bf16
        # pool (prev_ms: rope_qk then the kv_write kernel, what the
        # programs ran before it), each pool type's kernel under
        # "variants" (launches on the main paths, the decode case)
        head = rkv[0]
        kernels.append({
            "name": "rope_kv_write", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/kv_write.cu",
            "replaces": "paddle_tpu/ops/impl/fused_ops.py:87 (rope_qk, "
                        "_apply_rope :29) + paddle_tpu/kernels/pallas/"
                        "paged_attention.py:292 (update_pages, "
                        "quantize_tokens :59): XLA ops, no TPU kernel",
            **launches("rope_kv_write"),
            "max_abs_err": max(c["max_abs_err"] for c in rkv),
            "ms": head["ms"], "median_ms": head["median_ms"],
            "prev_ms": head["prev_ms"],
            "prev_median_ms": head["prev_median_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "shape": f"{head['case']}: {head['rows']} rows, hq "
                     f"{head['hq']}, hkv {head['hkv']}, d {head['d']}, "
                     f"page 16",
            "variants": [{
                "variant": v, **launches(f"rope_kv_write/{v}"),
                **{key: c[key] for key in ("ms", "median_ms", "prev_ms",
                                           "prev_median_ms", "plain_ms",
                                           "library_ms", "bound_ms")},
                "shape": c["case"]}
                for v, c in (("float", head),
                             ("int8", next(c for c in rkv
                                           if c["case"] == "decode_int8")))],
        })

    def prefill_entry(name, replaces, cases, head, int8, paths, shape):
        """The continuation kernel at ``head``'s shape on its default
        design (``split``), the ring design's times beside it, both
        designs under "designs" and the int8-page instance under
        "variants", each with its launches on ``paths`` ({path:
        counts})."""
        def count(key):
            per = {p: c.get(key, 0) for p, c in paths.items()}
            return {"launches": sum(per.values()), "launches_by_path": per}

        return {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_prefill.cu",
            "replaces": replaces, **count("paged_prefill"),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "design": head["design"], "ms": head["ms"],
            "median_ms": head["median_ms"], "kernel_ms": head["kernel_ms"],
            "kernel_median_ms": head["kernel_median_ms"],
            "ring_ms": head["ring_ms"],
            "ring_median_ms": head["ring_median_ms"],
            "ring_kernel_median_ms": head["ring_kernel_median_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": shape,
            "designs": [{
                "design": design, **count(f"paged_prefill/{design}"),
                **{k: v[k] for k in ("ms", "median_ms", "kernel_ms",
                                     "kernel_median_ms", "max_abs_err")}}
                for design, v in head["variants"].items()],
            "variants": [{
                "variant": v, **count(f"paged_prefill/{v}"),
                **{k: c[k] for k in ("ms", "median_ms", "kernel_ms",
                                     "kernel_median_ms", "ring_ms",
                                     "ring_median_ms", "plain_ms",
                                     "library_ms", "bound_ms")},
                "shape": c["case"]}
                for v, c in (("float", head), ("int8", int8))],
        }

    if paged is not None:
        # the continuation kernel at the serving shape (a 128-token chunk
        # after 192 cached tokens, bf16 pages; library: the page gather and
        # F.scaled_dot_product_attention with the mask)
        head = pfx[0]
        kernels.append(prefill_entry(
            "paged_prefill",
            "paddle_tpu/serving/adapter.py:428 (_gather_context :246 + "
            "masked _sdpa: XLA, no TPU kernel)", pfx, head,
            next(c for c in pfx if c["case"] == "int8_192_128"), by_path,
            f"{head['case']}: hq 16, hkv 16, d 128, page 16, cache_len "
            f"{head['cache_len']}, chunk {head['chunk']}"))
        # its batched form at the serving cell's verify shape (8 slots, a
        # 5-token window each, bf16 pages; library: the batched page gather
        # and one SDPA call with the [slots, 1, S, C] mask); its launches
        # are serving_spec's paged_prefill launches (there, every one is a
        # verify step's)
        head = pfx_batched[0]
        kernels.append(prefill_entry(
            "paged_prefill_batched",
            "paddle_tpu/serving/adapter.py:544 (verify: "
            "_gather_context_batch :232 + masked _sdpa: XLA, no TPU kernel)",
            pfx_batched, head,
            next(c for c in pfx_batched if c["case"] == "verify_int8"),
            {"serving_spec": by_path["serving_spec"]},
            f"{head['case']}: 8 slots x 5 rows, hq 16, hkv 16, d 128, page "
            f"16, positions {head['positions']}, lengths {head['lengths']}"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(report, kernels=kernels), f, indent=1)
    log(f"[done] {report['seconds']:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
