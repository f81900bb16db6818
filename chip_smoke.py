#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, each fatal on failure (exit code 1, no result line):
  1. card: name and power limit from nvidia-smi; build the CUDA kernels
     of the serving and training paths from the sources in the checkout
     (one nvcc per source, started together) and time the build;
  2. kernels: each kernel against its plain PyTorch version on the card:
     the forward (causal / masked / non-causal, head_dim 64 and 128,
     lengths that are not tile multiples, below one 128-row tile and one
     past it, key starts inside a tile and ones that fully mask the
     first tiles, heads of distinct magnitudes at a length that ends
     inside a tile, each head on its own), the backward pair dq / dkv
     (the training shape, d 64 with unaligned lengths, non-causal
     sq != sk, rows whose lse is the NEG_INF sentinel, a length that
     cuts the 128-row and 64-query tiles, causal sk > sq whose key
     tiles past the last query must write zero dk and dv, heads of
     distinct magnitudes with each head's relative error and max
     |err| / RMS printed),
     flash_attention's autograd path (GQA), and the
     two passes of the two-pass causal forward (pass A flash_fwd_full,
     pass B flash_fwd_diag) and their merge (the training split, d 64,
     fitted blocks that are not multiples of 64 or of the 128-row tile,
     a length that is not a tile multiple, the pure band; a shape
     outside the two-pass dispatch launches neither);
  3. timing: each kernel at the shape its path gives it, beside its
     plain version, its bound, and one PyTorch library call; every row
     also with its TFLOP/s, its share of its bound and its instance's
     registers and shared memory; the backward pair plus the float32
     delta pass beside SDPA's backward; the two-pass forward beside the
     single-pass kernel on the same inputs;
  4. serve: export a seeded 188M LM (bench.py's configuration, random
     weights), start the port's REST server in this process with bucketed
     static batching (--lm_static_batcher: the continuous-batching engine
     is the default and launches no flash kernel), send concurrent
     mixed-length :predict requests and one direct two-row request; the
     kernels' launch counters are zeroed just before and read just after,
     and every serving kernel must have run.  The same server also
     serves gRPC (--grpc_port 0; without grpcio it fails to start): one
     Predict alone must equal a REST :predict of the same prompt and the
     grpc.health.v1 check answer SERVING; every other phase's server
     runs REST only (--grpc_port -1);
  5. check: every reply is prompt + max_new_tokens tokens in the
     vocabulary, and the prefill logits of one left-padded bf16 batch
     through the kernel are no further from a float32 run of the same
     weights than the same batch through the plain version is;
  6. breakdown (information only): prefill and decode time of one
     bucketed batch, and under torch.profiler the device's busy share
     and the kernels that take its time;
 6b. engine: the same server with the JAX CLI's engine defaults (the
     continuous-batching DecodeEngine: 8 slots, fused rounds of 8 steps,
     64-token prefill chunks, 16-token KV blocks, prefix cache on) and
     the bf16 model, its chunked-prefill and rounds programs captured as
     CUDA graphs.  Checks on the captured engine: the eight prompts as
     one concurrent burst, two requests sharing a 1024-token prefix, one
     request with the card's sync debug mode at "error"; every reply
     prompt + max_new_tokens tokens in the vocabulary, no flash kernel
     launched, :stats showing the slots reused, a prefix hit and the JAX
     engine's compiled_programs(); the same engine with the float32
     model (TF32 off) must give generate()'s greedy tokens on four
     prompts; one captured round of 8 steps at 8 live slots must equal
     the eager decode_rounds on the same state (tokens, counts,
     steps_run and the slot scalars), and one captured round runs under
     sync debug mode "error".  Information only, in the same call: the
     capture time and graph-pool bytes; the same burst through the
     engine with cuda_graphs=False and through the static batcher
     (--lm_static_batcher), each with requests/s, tokens/s, TTFT and
     latency p50/p99; the bf16 engine's first difference from bf16
     generate() per prompt; the captured and the eager round at 8 live
     slots in turns, with their device busy shares and the paged-view
     gathers' share under torch.profiler, and one 64-token prefill chunk
     captured and eager;
 6c. speculation: the same server with --speculative_tokens 4 (bf16,
     the engine defaults; its verify program captured beside the
     others) answers a burst of 8 prompts, 4 tiling a random 4-token
     pattern and 4 random (256-1024 tokens); every reply prompt +
     max_new_tokens tokens in the vocabulary, :stats showing verify
     calls (spec_steps > 0) and the JAX engine's compiled_programs()
     for these flags with "verify": 1, no flash kernel launched; at
     float32 (TF32 off) the captured engine with speculation on and
     off gives generate()'s greedy tokens on 4 of the prompts (a
     difference prints the top-2 logit gap where it starts); one
     captured verify call at 8 live slots (a fully accepted window,
     rejected ones, a slot with one token of budget, a retired slot)
     equals the eager verify_step on the same state (tokens, emit,
     lengths, last_token, done; pool within 1e-6), and one runs under
     sync debug mode "error".  Information only: the burst's tokens/s,
     TTFT and latency p50/p99 with speculation on and (same server)
     off, the acceptance, whether the throughput gate was open, and
     the verify call's time beside a captured round of 8 steps;
 6d. tiers: a --role prefill and a --role decode server on the same
     export (/readyz shows each role).  :prefill of a 1024-token prompt
     answers a kv_handoff covering 1008 tokens in 49,545,216 bytes of
     bf16 pages; the decode server's NDJSON :generate with that payload
     streams what its engine answers unstreamed for the same payload,
     and the pages it imported, gathered back, are the exported bytes;
     a 16-token prompt exports nothing; no flash kernel launched; at
     float32 a decode-tier engine importing a prefill-tier engine's
     pages gives the unified engine's and generate()'s tokens on 2
     prompts.  Information only: the payload's bytes, its encode and
     decode time, the :prefill latency, and the decode tier's TTFT
     beside the unified engine's on the same prompt;
 6e. int8: the same weights exported with quantize and kv_cache int8
     (the JAX loader's keys), served over REST through the captured
     engine (int8 weights on the card, an int8 pool of 405,504-byte
     pages with float32 scales) and through the static batcher: every
     reply prompt + max_new_tokens tokens in the vocabulary, the JAX
     engine's compiled_programs(), no flash kernel launched; at float32
     the captured int8 engine gives int8 generate()'s greedy tokens on 4
     prompts; in bf16 the first-step logits of int8 weights over an int8
     cache reach cosine > 0.99 against the unquantized model's.
     Information only: the weight bytes on the card against bf16, the
     pool bytes a page against bf16, a captured round of 8 steps and a
     verify call at 8 live slots on an int8 state beside phase 6b's bf16
     round, and the int8 -> bf16 weight converts' share of the round's
     device time;
 6f. spill tier: a server with --kv_pool_blocks 128 and
     --host_spill_blocks 1024 parks eight sessions of 512-1024 prompt
     tokens (park_kv), more pages than its pool holds: it must spill,
     never shed, never destroy-evict, and every second turn must equal
     that of a control server with the default pool; a failover, the
     parking server's :fetch_kv of a session resumed on a fresh server
     with resume_tokens over :generate, gives the parking server's
     tokens, for the bf16 export and for the int8 one; no flash kernel
     launched.  Information only: pages spilled out and re-imported,
     spill-out and re-import ms a page, the resume TTFT against the
     cold prefill's, and the fetched payload's bytes and its encode and
     decode time;
 6g. adapters: three seeded rank-4 adapters (alpha, beta, gamma; factor
     scale 0.05) written with the port's save_adapter and served with
     --adapters_dir at the engine defaults (--adapter_slots 8, programs
     captured): a REST burst of eight :predict requests, two each of lm,
     lm@alpha, lm@beta and lm@gamma, every reply prompt + max_new_tokens
     tokens in the vocabulary, :stats with the three resident and the
     JAX engine's compiled_programs(), /readyz advertising them,
     lm@ghost answering 404.  At float32 (TF32 off): each co-batched
     request equals its run alone on the same engine, base rows equal a
     base-only engine's, each variant differs from base, the engine
     captured and ran the base-only engine's programs; in a 2-slot
     registry a hot load with one adapter pinned evicts only the idle
     one, and the evicted adapter reloaded into another's row decodes
     its tokens again through the graphs captured at construction.  No
     flash kernel launched.  Information only (bf16): the burst's TTFT
     and tokens/s, the stack's bytes on the card, one hot load's ms,
     and a captured round of 8 steps at 8 live slots with mixed adapter
     rows against the same round with no adapter stack;
 6h. serving surface: the same weights exported under the JAX package's
     ``lm`` loader name (logits).  Direct: the loader's predict on [2,
     1024] tokens, launch counters zeroed just before and read just
     after: flash_fwd 12 launches a call, every other kernel 0; logits
     float32 of shape [2, 1024, 32000], finite, and their mean error
     against a float32 run of the same weights (plain attention) within
     LOGITS_ERR_RATIO of the plain bf16 path's.  Over REST in-process
     with --trace_sample_rate 1: a 16-token :predict whose JSON logits
     equal the direct predict's; a client traceparent's trace id back in
     /debug/traces under server.predict; /metrics, parsed with the
     port's parse_metrics, counting the requests and reading 0 in
     flight during the scrape; two POSTs with one x-kft-idempotency-key
     running the model once (12 flash launches); a token id outside
     the vocabulary answering 400 with no launch, the next request
     answered as before; a corrupt version 2
     failing its load while version 1 keeps serving, the breaker gauge
     at 1 and a second load skipped; loader.load:raise*1 (the port's
     KFT_FAULTS grammar) failing exactly one reload of version 3, which
     loads once the backoff has passed.  Information only: the forward
     (CUDA events) and the whole predict (host clock), the 262,144,000
     bytes of logits' copy to the host, the JSON answer's bytes and
     latency, and phase 6b's burst with tracing at sample rate 1
     against tracing off, in turns;
 6i. tensor-parallel decode: four servers of serving.main --mesh
     tensor=2, each 2 processes sharing the card over gloo
     (KFT_DIST_BACKEND=gloo), serving at once at the engine's CLI
     defaults: the bf16 export (phase 6b's burst of eight, then phase
     6d's 1024-token handoff into this decode tier), the bf16 export
     with --speculative_tokens 4 and --adapters_dir (6c's speculating
     burst, then 6g's adapter burst) and the int8 export (6e's burst).
     Every request answered; each first generated token equal to the
     single-device phase's, or a near tie (the two tokens, and one
     device's own top two, within MESH_TIE_GAP in one device's bf16
     logits; the requests whose top two are further apart, which must
     be equal, counted); the handoff's pages
     imported, a verify call, :stats mesh_devices 2; each rank's digest
     of its engine's slot scalars, logged at release, equal to rank 0's,
     and both ranks exiting 0 (the servers' kernel launches are not
     counted).  Beside the servers, a 2-rank job on the engine's
     forward: one 1024-token prompt's prefill logits at tensor=2 against
     tensor=1 within the MESH_* bounds in bf16 and in float32, the
     ranks' scalars equal after their rounds, and no flash kernel
     launched by either rank (each counts its own).  A fourth server,
     the bf16 export with phase 6f's --kv_pool_blocks 128 and
     --host_spill_blocks 1024, parks phase 6f's eight sessions
     (park_kv; first tokens held as above), then takes their second
     turns on 6f's first-turn tokens: each whole stream equal to 6f's or
     parting at a near tie (the same gaps, at the first differing
     position), pages spilled out and re-imported, no shed, no kv shed,
     8 parked; rank 0's :fetch_kv of 6f's fetched tokens answers
     whole-head pages of 6f's coverage, shape and dtype, each side within
     MESH_TWO_PATHS times the one-device pages' distance (relative
     Frobenius) from a float32 forward's; the phase within MESH_PHASE_S.
     Information only: streams equal and first differing positions,
     TTFT and tokens/s, one chunk and one fused round of 8 steps at 8
     live slots against 6b's rounds, the all-reduces and all-gathers of
     each with their ms, one all-reduce alone on CUDA and host tensors,
     one lockstep broadcast, busy share, pool bytes and peak memory a
     rank;
  7. train: the port's LM training entry point (tools/train_lm.run) on
     bench.py's LM configuration (batch 8 x 2048, flash, remat, adamw
     1e-3) for a few steps, launch counters zeroed just before and read
     just after: flash_fwd, flash_dq and flash_dkv must each launch 12
     times a step; losses and grad_norm finite; step time, tokens/s, MFU
     and peak memory printed; then the same cell with the two-pass
     forward (--flash-block-diag 256, adafactor 1e-3, 2 steps a call)
     through lm_task and Trainer as bench.py builds it: flash_fwd_full,
     flash_fwd_diag, flash_dq and flash_dkv 12 times a step, flash_fwd
     never;
 7c. MoE: bench.py's lm_moe cell (the 188M preset with 4 experts,
     top-2, capacity 1.25, the einsum dispatch in routing groups of 128,
     adafactor, batch 8 x 2048, remat nobatch, flash, bf16) through
     lm_task and Trainer on one repeated batch: 2 warm-up steps, then 8
     with the launch counters zeroed just before and read just after:
     flash_fwd, flash_dq and flash_dkv 12 times a step each; losses,
     grad_norm and moe_aux finite; the loss falling by 1 nat.  One MoE
     layer at [8, 2048, 1024] under the einsum dispatch and the gather
     dispatch (groups 128 and 256), and under both at capacity 0.5
     (many choices dropped), each held to references: float32 on the
     card equal to float32 on the CPU (the batch row with the most
     dropped choices: routing, slots and drops), bf16 on the card near
     that float32 reference, and the bf16 gather output within 2 bf16
     ulps of the einsum one.
     Information only: step time, tokens/s, MFU (flops_per_token counts
     the top-2 experts' MLPs and the router), peak memory, one profiled
     step (busy share, top device ops), and that layer's forward and
     backward under each dispatch;
 7d. dropout: the dense 188M at 8 x 2048 with dropout 0.1: one training
     step's gradients (lm_task forward and backward) with remat on and
     off from one generator seed within 1e-3 relative Frobenius; the
     same seed again gives the same loss and seed + 1 another;
     flash_fwd, flash_dq and flash_dkv 12 times in the step;
  7e. HFTA: a width-4 FusedTrainer (runtime/hfta.py) on bench.py's LM
     cell (8 x 2048, flash, remat, adamw, bf16), member i at lr 1e-4 (i +
     1) from seed i, m1 stopping at step 2: 2 warm-up steps, then 6 from
     the members' states with the launch counters zeroed just before and
     read just after: flash_fwd, flash_dq and flash_dkv 12 times a fused
     step (one launch a layer for all members, folded to bh 256); m1's
     parameters bit-equal to its step-2 snapshot; one fused step's
     per-member loss and gradients against a solo step on the same
     weights and batch; the folded kernels at bh 256 against their plain
     versions (phase 2's bounds).  Information only: the fused step
     against phase 7's solo step, tokens/s per member and in all, MFU,
     peak memory, one profiled fused step;
 7f. parallel: (a) ring attention (parallel/ring.py) as 4 processes
     sharing the one GPU over gloo (testing/ring_check.py, each hop
     staged through host memory) at the 188M LM's attention widths, b 1,
     s 16384 (4096 a rank), 8 heads of 128, bf16, forward and backward:
     causal, causal GQA with 2 kv heads, and non-causal; each case's o,
     dq, dk and dv joined over the ranks against the kernel's
     flash_attention on the whole sequence in this process and against
     float32 attention, within the bounds below; the kernels' launches
     summed over the ranks exactly the ring's live hops, 10 each of
     flash_fwd, flash_dq and flash_dkv causal (R (R + 1) / 2 at R = 4)
     and 16 non-causal, and no other kernel.  (b) tools/train_lm.run on
     bench.py's LM cell with --mesh data=1: the bootstrap's one-process
     job, a one-rank NCCL group, FSDP2 wrapping; 3 steps' losses within
     1e-3 of phase 7's (same seed and batches), and 12 launches a step
     of flash_fwd, flash_dq and flash_dkv.  (c) the same with --mesh
     sequence=2 --attention ring as 2 processes on the card over gloo
     (KFT_DIST_BACKEND=gloo): the ranks' losses equal, finite and within
     1e-3 of phase 7's, 36 launches a step of each of the three over the
     ranks (3 live hops a layer).  Information only: each rank's ring
     forward and backward ms against the single process (the ranks
     time-share one GPU: no scaling figure), the mesh step's ms, busy
     share and peak memory against phase 7's, the ring trainer's step
     ms;
 7g. tensor parallelism: tools/train_lm.run on bench.py's LM cell with
     --mesh tensor=2 as 2 processes sharing the one GPU over gloo
     (KFT_DIST_BACKEND=gloo), 3 steps from phase 7's seed and batches:
     each rank holds half the heads, mlp and vocab (Megatron's column/
     row split, the vocab-parallel embedding and cross-entropy).  The
     ranks' losses equal, finite and within TENSOR_LOSS_ATOL of phase
     7's; each rank launches exactly 36 each of flash_fwd, flash_dq and
     flash_dkv (one a layer a step), every one at bh 32 (8 rows x 4
     local heads), and none of the other kernels; the forward and
     backward at bh 32 against their plain versions within phase 2's
     bounds.  Information only:
     each rank's step ms and the host time inside its gloo all-reduces
     in that step, a profiled step's busy share, its peak memory, and
     its all-reduces a step with the time of one of [8, 2048, 1024]
     bf16 (32 MB) alone;
 7h. pipeline parallelism (GPipe): tools/train_lm.run on bench.py's LM
     cell with --mesh pipeline=2 --pipeline-microbatches 4 as 2 processes
     sharing the one GPU over gloo (KFT_DIST_BACKEND=gloo), 3 steps from
     phase 7's seed and batches: each stage holds 6 of the 12 layers and
     runs them on 4 microbatches of 2 rows (parallel/pipeline.py, the
     hops and broadcasts staged through host memory).  The ranks' losses
     equal, finite and within 1e-3 of phase 7's; each rank launches
     exactly 72 each of flash_fwd, flash_dq and flash_dkv (24 a step),
     every one at bh 16, and none of the other kernels; one stage's
     forward and backward at bh 16 against their plain versions within
     phase 2's bounds; the phase within 90 s.  Information only: each
     rank's step ms against phase 7's, the host time and bytes of its
     hops and broadcasts, the time it waits on its neighbour beside
     GPipe's bubble share, a profiled step's busy share and its peak
     memory;
 7i. MoE over a mesh: tools/train_lm.run on bench.py's lm_moe cell
     (phase 7c's model) as 2 processes sharing the one GPU over gloo, 3
     steps each, with --mesh data=2 and adafactor (bench.py's own layout
     at 2 chips: 4 rows a rank, the aux from the per-expert statistics
     summed over the data ranks) and with --mesh expert=2 and adamw (2 of
     the 4 experts a rank, all 8 rows, the partial outputs summed over
     the expert group).  For each: the ranks' losses equal, finite and
     within 1e-3 of one process on the same global batch from the same
     seed; the data job's last moe_aux within 1e-3 (relative) of that
     process's global one and ten times nearer it than the mean of the
     ranks' own auxes; the first step's loss, grad_norm and routers'
     gradient norm within 1e-4 (data) or 3e-3 (expert) relative of that
     process's; each rank launches exactly 36 each of flash_fwd,
     flash_dq and flash_dkv (12 a step), at bh 32 (data) or 64
     (expert), and none of the other kernels; the forward and backward
     at bh 32 and 64 against their plain versions within phase 2's
     bounds; the phase within 90 s.  Information only: each
     rank's step ms, a profiled step's busy share, its gloo all-reduces a
     step (those over the expert group apart: count, bytes, ms) and its
     peak memory (the two jobs run side by side), and the mean of
     per-rank auxes beside the global one.  The data job's ranks then
     take one forward and backward of the model with the gather dispatch
     at routing groups of 16384 tokens (each group both ranks' 8192: its
     slot positions carried from the first rank's counts), each on its 4
     rows of one global batch: the loss, moe_aux and the routers'
     gradient norm (summed over the ranks) within 1e-4 (relative) of one
     process on the 8 rows;
 7j. adafactor over a mesh: tools/train_lm.run on bench.py's LM cell with
     --optimizer adafactor as 2 processes sharing the one GPU over gloo,
     3 steps each, the two jobs side by side: --mesh fsdp=2 (4 rows a
     rank; FSDP2 shards every weight's embed dim, and the factored
     statistics' means over it are all-reduced) and --mesh tensor=2 (all
     8 rows; the heads, mlp and vocab split).  For each: the ranks' losses
     equal, finite and within the job's bound of one process with
     adafactor on the same global batch from the same seed; the first
     step's loss and grad_norm within the job's relative bound of that
     process's; each rank launches exactly 36 each of flash_fwd, flash_dq
     and flash_dkv (12 a step), all at bh 32, and none of the other
     kernels; the forward and backward at bh 32 against their plain
     versions within phase 2's bounds; the phase within 90 s.
     Information only: each rank's step ms, a profiled step's busy share,
     its gloo all-reduces a step (count, bytes, ms), its peak memory and
     the shapes of its share of the embedding's statistics;
 7k. the fused trainer over a mesh: phase 7e's width-4 gang (m1
     stopping at step 2) as FusedTrainer(mesh=MeshSpec(data=2)) over 2
     processes sharing the one GPU over gloo, 3 fused steps, every rank
     given the global 8 x 2048 batch and keeping its 4 rows, the stacked
     float32 gradients summed over the ranks in one flat all-reduce a
     step.  The ranks' per-member losses equal and finite, the first
     step's within 1e-3 of one process's fused step on the 8 rows; the
     stacked state (parameters, moments, counts, steps) bit-equal on
     both ranks (checksums of its bits); m1 bit-equal to its step-2
     state; each rank launches exactly 36 each of flash_fwd, flash_dq and
     flash_dkv (12 a fused step, the members folded), all at bh 128, and
     none of the other kernels; the forward and backward at bh 128
     against their plain versions within phase 2's bounds; the phase
     within 90 s.  Information only: each rank's step ms against phase
     7e's fused step, the gradient all-reduce's bytes and ms, a profiled
     step's busy share and its peak memory;
  8. gradients: one step's gradients of the bf16 model (full width and
     depth, batch 2 x 2048) through the kernels (single pass, then two
     passes) and through the plain versions, each held to a float32 run
     of the same weights with plain attention: a kernel path may be at
     most 1.25x further from it;
  9. learning: Trainer.fit for 20 steps on one repeated batch must lower
     the loss by at least 1 nat; then (information only) one profiled
     training step: device busy share, the kernels with the most device
     time, and the share of flash fwd, dq and dkv;
 10. checkpoints and data: tools/train_lm.run with adafactor, KFTR
     shards written by the port and verified checkpoints every 2 steps:
     the saved steps verify, a rerun resumes after the last one, a
     truncated newest step is walked back over; one save and one
     restore timed;
 11. CNN serve: a seeded ResNet-50 (224 x 224) and Inception-v3 (299 x
     299), 1000 classes, every leaf drawn from numpy, exported under the
     JAX loader name and served by the port's REST server with
     --micro_batch_size 8 (the classifier loader, the MicroBatcher): a
     concurrent burst of 16 :predict requests per model (uint8 pixel
     lists and float32 lists in turns), one :predict and one :classify
     of one image alone, one direct 8-row request.  Every reply's scores
     sum to 1 within 1e-3 with the top k their sorted head; :classify
     gives :predict's top k; each served row equals the loader's own
     predict on the same image at a batch size the batcher served; the
     bf16 logits are within a bound (relative Frobenius) of a float32 run
     of the same weights, and a control run with BatchNorm normalizing in
     bf16 is not (2.6e-3 for ResNet-50, 1.9e-3 for Inception-v3); no flash
     kernel launches.  Information only:
     requests/s, latency p50/p99, the batch-size histogram, and one
     batch of 8 under torch.profiler (busy share, top kernels);
 12. CNN train: tools/train_cnn.run on bench.py's ResNet-50 cell (batch
     256 x 224 x 224, bf16, sgd 0.1 with momentum 0.9, synthetic data)
     for 4 steps with checkpoints every 2: losses finite, the saved
     steps verify; Trainer.fit for 30 steps on one repeated batch of 32
     must bring the mean loss of the last 5 below the first; no flash
     kernel launches.  Information only: the step on a batch staged on
     the card (time, images/s, MFU, peak memory) and one profiled step;
 12b. CNN gang: tools/train_cnn.run on the same cell as 2 processes
     sharing the one GPU over gloo (KFT_DIST_BACKEND=gloo), 128 rows a
     process (the global batch of 256), 3 steps: MeshSpec(data=2), FSDP2
     at the root, BatchNorm's statistics over the global batch.  The
     ranks' losses equal, finite and within CNN_GANG_LOSS_ATOL of one
     process on the same 256 rows from the same seed; bn_init's running
     mean and variance equal on both ranks (bit for bit) and within
     CNN_GANG_STATS_RTOL (relative Frobenius) of that process's; no flash
     kernel launches; the phase within 90 s.  Information only: each
     rank's step ms, its gloo all-reduces a step (count, bytes, ms), a
     profiled step's busy share and its peak memory;
 13. tools: runtime/profiling.py's ProfileSchedule(start=1, count=2)
     around 4 steps of phase 7's trainer (lm_task and Trainer on bench.py's
     LM cell, each step under step_marker), the launch counters zeroed as
     the window opens and read as it closes, summarized by
     tools/xplane_summary.py (its table printed): its events of
     flash_fwd, flash_dq and flash_dkv equal the counters, 24 each, and
     the window holds steps 1 and 2; then side by side as processes:
     tools/launcher.py running ``python -m
     kubeflow_tpu_torch.tools.train_lm`` on the LM cell for 3 steps with
     KFT_SLICE_TYPE=h100-1 (exit 0, finite losses, each logged MFU over
     topology.py's 989 TFLOP/s, this smoke's peak), tools/train_torch.py
     on the card (its loss falls) and tools/telemetry.py --once (exit 0,
     the report logged); MeshSpec.build(topology=h100-1) builds a
     one-rank mesh and topology=h100-8 raises ValueError; the phase
     within TOOLS_PHASE_S.  Information only: the window's device busy
     share beside phase 9's step, the overlapped copies, the trace's
     bytes, the launched trainer's MFU.

The phases' times are printed.  The line before the last is a JSON
object {"kernels": [...]}; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import http.client
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SEED = 20261016
# bench.py's 188M LM (vocab 32000), bf16, flash attention, tied embed.
MODEL = {"vocab_size": 32000, "d_model": 1024, "n_layers": 12,
         "n_heads": 8, "n_kv_heads": 8, "d_ff": 2816, "head_dim": 128,
         "max_seq_len": 2048, "dtype": "bfloat16", "attention": "flash",
         "tied_embeddings": True}
MAX_NEW_TOKENS = 32
BUCKETS = "512,1024,2048"
MICRO_BATCH = 4
PROMPT_LENS = (300, 1800, 520, 1620, 760, 1440, 980, 1210)
DIRECT_ROWS, DIRECT_LEN = 2, 1024
# Phase 6b: two engine requests share a prefix of this many tokens; the
# engine's prefill chunk width (the CLI default).
SHARED_PREFIX = 1024
CHUNK = 64
# Phase 6c: the server's --speculative_tokens, and the burst's prompt
# lengths (a tiled and a random prompt of each).
SPEC_TOKENS = 4
SPEC_LENS = (256, 512, 768, 1024)
# Phase 6d: the handed-off prompt, and its bf16 pages' bytes: 12 layers x
# 1008 covered positions (63 full 16-token pages, at most length - 1) x 8
# kv heads x 128 x 2 bytes x 2 sides.
HANDOFF_LEN = 1024
HANDOFF_BYTES = 12 * 1008 * 8 * 128 * 2 * 2
# Phase 6e: the int8 export's config keys, and a pool page's bytes by the
# code: 12 layers x 16 positions x 8 kv heads x (128 int8 values + one
# float32 scale) x 2 sides, against 12 x 16 x 8 x 128 x 2 bytes x 2 sides
# in bf16.  The float32 identity's prompt lengths; the cosine bound of
# tests/test_quantize.py.
INT8_CONFIG = {"quantize": "int8", "kv_cache": "int8"}
INT8_PAGE_BYTES = 12 * 16 * 8 * (128 + 4) * 2
BF16_PAGE_BYTES = 12 * 16 * 8 * 128 * 2 * 2
INT8_LENS = (300, 170, 410, 90)
INT8_COSINE = 0.99
# Phase 6f: the spilling server's pool and host tier in pages, the parked
# sessions' prompt lengths (their contexts fill 346 pages), the new
# tokens of each second turn, and the tokens a failed-over request had
# delivered before its :fetch_kv.
SPILL_POOL, SPILL_HOST = 128, 1024
SPILL_LENS = (512, 1024, 576, 640, 512, 704, 544, 768)
TURN2_NEW = 16
FETCH_DELIVERED = 8
# Phase 6g: three seeded adapters at rank 4 whose factors are drawn at
# random_adapter_factors' default scale of 0.05 (each variant's greedy
# tokens must differ from base), and the two prompts each of base and the
# three variants decodes.
ADAPTERS = ("alpha", "beta", "gamma")
ADAPTER_RANK = 4
ADAPTER_SCALE = 0.05
ADAPTER_LENS = (300, 170)
# Phase 6h: the phase-4 weights exported under the JAX lm loader's name;
# the direct call's tokens ([2, 1024]: bh 16 at 8 heads, the kernel
# table's serve shape) and its counted calls; the REST request's tokens.
LM_LOGITS_LOADER = "kubeflow_tpu.serving.loaders:lm"
LM_BATCH, LM_LEN = 2, 1024
LM_CALLS = 3
LM_REST_LEN = 16
# Phase 6i: the serving mesh's ranks (processes sharing the card over
# gloo) and their start, stop and job time limits.  The bounds on one
# 1024-token prompt's prefill logits at tensor=2 against tensor=1's
# (PERF.md section 6): in bf16 the two are two bf16 paths of one
# function, so their distance (relative Frobenius) is bounded by
# MESH_TWO_PATHS times the tensor=1 path's own distance from float32,
# and tensor=2's mean error against float32 by LOGITS_ERR_RATIO times
# tensor=1's (phase 5's rule for another bf16 path); in float32 (TF32
# off), where only summation order differs, a relative Frobenius
# distance of at most MESH_F32_REL_FRO, the last position's argmax equal
# and at least MESH_F32_ARGMAX of the positions' argmax equal.  The
# largest gap in one device's bf16 logits between a mesh reply's first
# token and the single-device phase's, and between one device's own top
# two, at which a differing first token counts as a near tie (phase 5's
# largest difference between two bf16 paths of the model, 9.57e-2).
MESH_WORLD = 2
MESH_START_S, MESH_STOP_S, MESH_JOB_S = 180, 60, 180
# Intra-op threads of each mesh process: the six server processes and
# the job's two share the host's cores, and their host work (gloo's
# staged collectives, the lockstep channel) is serial, as torchrun sets
# one thread a process in a multi-process job.
MESH_THREADS = 1
MESH_TWO_PATHS = 2.0
MESH_F32_REL_FRO = 1e-4
MESH_F32_ARGMAX = 0.999
MESH_TIE_GAP = 0.1
# Replies of the single-device phases that phase 6i holds the mesh's
# first generated tokens to: "6b", "6c", "6e" (prompts, replies), "6g"
# (the adapter work's replies), "6d" (prompt, wire payload, tokens),
# "6f" (the parked sessions, both turns' replies and one :fetch_kv
# payload's pages).
SERVED = {}
# Phase 6i's bound on the whole phase (its four servers, their requests
# and the 2-rank job, side by side), twice its slowest run before the
# spill server joined it (PERF.md section 6).
MESH_PHASE_S = 240.0
# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 rate).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# Kernel vs plain version, bf16 inputs, plain version in float32: o
# differs by bf16 rounding of p and of the output, lse by summation order.
# Elementwise bounds, and a bound on ||o - ref||_F / ||ref||_F that holds
# the many small outputs of long rows, which the atol alone would not.
O_TOL = dict(atol=2e-2, rtol=2e-2)
O_REL_TOL = 1e-2
LSE_ATOL = 2e-3
# Prefill logits of the bf16 model against a float32 run of the same
# weights: the kernel path's mean error may exceed the plain bf16 path's
# by this factor at most (both round p and o to bf16, at other points).
LOGITS_ERR_RATIO = 1.25
# Backward kernels against the float32 plain version on the same bf16
# inputs: each of dq, dk, dv within this relative Frobenius error, and
# elementwise within atol + rtol |ref|.  The kernels round ds and p to
# bf16 before their products (2^-9 relative each) and write bf16 (2^-9
# again); an entry near 1 sums thousands of such terms, so a few bf16
# ulps (4e-3 each at 1) is the expected error, and 5e-2 leaves room
# for the sums whose errors do not cancel.
BWD_REL_TOL = 2e-2
BWD_ELEM_TOL = dict(atol=5e-2, rtol=5e-2)
# One training step's gradients of the bf16 model against float32: the
# kernel path's relative error may exceed the plain bf16 path's by this
# factor at most.
GRAD_ERR_RATIO = 1.25
JAX_LOADER = "kubeflow_tpu.serving.loaders:lm_generate"
FWD_SOURCE = "kubeflow_tpu_torch/ops/csrc/flash_fwd.cu"
BWD_SOURCE = "kubeflow_tpu_torch/ops/csrc/flash_bwd.cu"
TPU_KERNELS = {
    "flash_fwd": "kubeflow_tpu/ops/flash.py:70",
    "flash_fwd_masked": "kubeflow_tpu/ops/flash.py:70",
    "flash_fwd_full": "kubeflow_tpu/ops/flash.py:241",
    "flash_fwd_diag": "kubeflow_tpu/ops/flash.py:291",
    "flash_dq": "kubeflow_tpu/ops/flash.py:508",
    "flash_dkv": "kubeflow_tpu/ops/flash.py:560",
}
# bench.py's LM training cell (bench.py --model lm defaults): the flags
# of the port's training entry point.
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_FLAGS = [
    "--d-model", "1024", "--n-layers", "12", "--n-heads", "8",
    "--n-kv-heads", "8", "--d-ff", "2816", "--head-dim", "128",
    "--vocab-size", "32000", "--seq-len", str(TRAIN_SEQ),
    "--batch-size-per-device", str(TRAIN_BATCH), "--attention", "flash",
    "--remat", "--learning-rate", "1e-3", "--optimizer", "adamw",
    "--device", "cuda"]
TRAIN_STEPS = 6
# bench.py --model lm --flash-block-diag 256 --optimizer adafactor
# --steps-per-call 2: the two-pass forward's (block_q, block_k,
# block_diag) on the training path.
TWO_PASS_BLOCKS = (512, 1024, 256)
TWO_PASS_STEPS, TWO_PASS_STEPS_PER_CALL = 6, 2
TWO_PASS_KERNELS = ("flash_fwd_full", "flash_fwd_diag", "flash_dq",
                    "flash_dkv")
# The checkpoint and data phase: train_lm.run on the bench flags, saving
# every CKPT_EVERY steps, over KFTR shards of CKPT_EXAMPLES examples.
CKPT_EVERY, CKPT_EXAMPLES, CKPT_SHARDS = 2, 64, 4
LEARN_STEPS, LEARN_BATCH, LEARN_VOCAB = 20, 2, 512
# Phase 7c, bench.py's lm_moe cell: the 188M preset with 4 experts
# (top-2, capacity 1.25, the einsum dispatch in routing groups of 128)
# and adafactor, batch 8 x 2048, remat nobatch, flash, bf16.  A repeated
# batch of LEARN_VOCAB ids, MOE_WARMUP steps, then MOE_STEPS counted and
# timed ones; the loss must fall by MOE_LEARN_NATS over all of them.
MOE = {"moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 1.25,
       "moe_impl": "einsum", "moe_group_size": 128}
MOE_WARMUP, MOE_STEPS, MOE_LR, MOE_LEARN_NATS = 2, 8, 1e-2, 1.0
MOE_LAYER_REPS = 5
# The layer's dispatches and groups (the cell's capacity 1.25), then both
# dispatches at capacity 0.5, where many choices are dropped (at 1.25
# random routing drops almost none).
MOE_LAYER_CASES = (("einsum", 128, 1.25), ("gather", 128, 1.25),
                   ("gather", 256, 1.25), ("einsum", 128, 0.5),
                   ("gather", 128, 0.5))
# One MoE layer at the cell's shape against references (moe_layer):
# float32 on the card vs float32 on the CPU, and bf16 on the card vs the
# same float32 reference, each as max |err| / max |ref|; the bf16 gather
# dispatch vs the bf16 einsum one in bf16 ulps at the output's largest
# magnitude.  Sound readings (NVIDIA H100 80GB HBM3 at 700 W): 1.87e-6,
# 7.41e-3 and 1 ulp; a token routed or slotted otherwise moves O(1).
MOE_F32_REL_TOL = 1e-4
MOE_BF16_REL_TOL = 1.5e-2
MOE_DISPATCH_ULPS = 2
# Phase 7d: dropout 0.1 on the dense 188M at 8 x 2048.  One step's
# gradients with remat on and off from one generator seed: the masks are
# drawn outside the checkpointed regions, so the two differ only by the
# order of bf16 arithmetic, if at all; a mask drawn anew on recompute
# would move them by O(1).
DROPOUT_RATE = 0.1
DROPOUT_REMAT_REL_TOL = 1e-3
# Phase 7e: HFTA, a width-4 FusedTrainer on bench.py's LM cell (8 x 2048,
# flash, remat, adamw, bf16): member i at lr 1e-4 (i + 1) from seed i, m1
# stopping at step 2.  HFTA_WARMUP steps, then HFTA_STEPS counted and
# timed ones; one fused step's per-member loss and gradients against a
# solo step on the same weights and batch within HFTA_LOSS_ATOL and
# HFTA_GRAD_REL_TOL (relative Frobenius over every parameter).  Sound
# readings (NVIDIA H100 80GB HBM3 at 700 W): losses within 1e-6 and
# gradients 1.97e-9 to 2.14e-9 apart (the batched GEMMs rounded as the
# solo ones did).  The bounds are phase 7d's 1e-3: room for a GEMM
# algorithm that rounds the bf16 activations otherwise, where a member's
# weights, lr or batch mixed up with another's moves them by O(1).
HFTA_MEMBERS, HFTA_STOP, HFTA_LR = 4, 2, 1e-4
HFTA_WARMUP, HFTA_STEPS = 2, 6
HFTA_LOSS_ATOL, HFTA_GRAD_REL_TOL = 1e-3, 1e-3
# Phase 7f: ring attention as RING_WORLD processes sharing the one GPU,
# at the 188M LM's attention widths (MODEL's 8 heads of 128) over a
# sequence of RING_SEQ; each case is (kv heads, causal).  Bounds, relative
# Frobenius over each of o, dq, dk, dv joined over the ranks, against the
# kernel on the whole sequence (both round p, ds and their outputs to
# bf16, at other points of the sum; the ring also rounds each hop's dk
# and dv before summing them in float32) and against float32 attention.
# Sound readings (NVIDIA H100 80GB HBM3 at 700 W): 1.23e-3 to 3.24e-3
# against the kernel, 2.19e-3 to 2.95e-3 against float32, where the
# kernel's own reads 2.09e-3 to 2.95e-3; the bounds sit about 1.5x above
# (phase 2's are 1e-2 and 2e-2); a hop merged at the wrong place or a
# shard of the wrong rank moves them by O(1).
RING_WORLD, RING_SEQ, RING_TIME_REPS = 4, 16384, 3
RING_CASES = {"causal": (8, True), "gqa": (2, True), "full": (8, False)}
RING_KERNEL_REL_TOL = 5e-3
RING_F32_REL_TOL = {"o": 5e-3, "dq": 5e-3, "dk": 5e-3, "dv": 5e-3}
RING_JOB_TIMEOUT_S = 300
# The mesh trainer: --mesh data=1 for MESH_STEPS steps, each loss within
# MESH_LOSS_ATOL of phase 7's (phase 7d's bound).
MESH_STEPS, MESH_LOSS_ATOL = 3, 1e-3
# The ring trainer: --mesh sequence=2 --attention ring at the same cell
# as RING_TRAIN_WORLD processes sharing the GPU over gloo
# (KFT_DIST_BACKEND=gloo: gloo moves FSDP2's collectives of CUDA tensors
# on the card's torch, and the ring stages its hops through host memory),
# each loss within MESH_LOSS_ATOL of phase 7's on the same global batch
# (sound reading: 4.67e-4, the ring's merge rounding otherwise).
RING_TRAIN_WORLD, RING_TRAIN_STEPS, RING_TRAIN_TIMEOUT_S = 2, 3, 300
# Phase 7g: --mesh tensor=TENSOR_WORLD at the same cell as TENSOR_WORLD
# processes sharing the GPU over gloo, each loss within TENSOR_LOSS_ATOL
# of phase 7's.  Each row-parallel projection's output is two bf16
# partial sums added in bf16 by the all-reduce, where one device rounds
# its float32 accumulator once: about 2^-9 more relative error in each
# element of the residual stream, which the loss averages over 16384
# positions (predicted 1e-4 to 3e-3); a wrong slice or a missed
# reduction moves the activations by O(1).  TENSOR_LOCAL_BH: the flash
# kernels' batch x heads a rank (8 rows x 8 / TENSOR_WORLD heads).
TENSOR_WORLD, TENSOR_STEPS, TENSOR_TIMEOUT_S = 2, 3, 300
TENSOR_LOSS_ATOL = 1e-2
TENSOR_LOCAL_BH = TRAIN_BATCH * MODEL["n_heads"] // TENSOR_WORLD
# Phase 7h: --mesh pipeline=PIPE_WORLD --pipeline-microbatches PIPE_MICRO
# at the same cell as PIPE_WORLD processes sharing the GPU over gloo, each
# loss within MESH_LOSS_ATOL of phase 7's (a microbatch's GEMMs round
# otherwise than the whole batch's; a layer run on the wrong stage, a
# microbatch out of place or a cotangent taken twice moves the loss by
# O(1)).  Each rank runs its 6 layers on 4 microbatches of 2 rows: the
# flash kernels at bh PIPE_LOCAL_BH (2 rows x 8 heads), PIPE_PER_STEP
# times a step each.  The phase must end within PIPE_PHASE_S.
PIPE_WORLD, PIPE_MICRO, PIPE_STEPS, PIPE_TIMEOUT_S = 2, 4, 3, 240
PIPE_LOCAL_BH = TRAIN_BATCH // PIPE_MICRO * MODEL["n_heads"]
PIPE_PER_STEP = MODEL["n_layers"] // PIPE_WORLD * PIPE_MICRO
PIPE_PHASE_S = 90.0
# Phase 7i: bench.py's lm_moe cell (phase 7c's model: the 188M preset with
# 4 experts, top-2, capacity 1.25, the einsum dispatch in groups of 128;
# 8 x 2048, remat, flash, bf16) through train_lm.run over a mesh of
# MOE_MESH_WORLD processes sharing the GPU over gloo, MOE_MESH_STEPS
# steps from train_lm's seed and synthetic stream, the two jobs side by
# side (alone, one after the other, they took 56.5 to 90.6 s as hosts
# vary, NVIDIA H100 80GB HBM3 at 700 W).  Each job: (its flags
# beside TRAIN_FLAGS and --moe-experts, the rows a rank).  "data" is
# bench.py's own layout at 2 chips (MeshSpec(data=n_chips), adafactor):
# each rank draws its 4 rows; "expert" holds 2 of the 4 experts a rank,
# every rank the same 8 rows (adamw: adafactor over expert slices is
# ROADMAP item 24).  Each job's losses must be equal on both ranks and
# within MOE_MESH_LOSS_ATOL of one process on the same global batch from
# the same seed, and every rank must launch flash_fwd, flash_dq and
# flash_dkv once a layer a step at bh (its rows x 8 heads), and the
# kernels at that bh must agree with their plain versions.  The data
# job's last moe_aux must be the global one, over all 8 rows: within
# MOE_MESH_AUX_RTOL (relative) of that process's (a sum over the 12
# layers, whose inputs the 4-row GEMMs round otherwise) and ten times
# nearer it than the mean of the ranks' auxes over their own rows.
# Sound readings (NVIDIA H100 80GB HBM3 at 700 W): 1.5e-4 from the
# global aux, where that mean stood 7.4e-2 from it.  The phase must end
# within MOE_MESH_PHASE_S.
MOE_MESH_WORLD, MOE_MESH_STEPS, MOE_MESH_TIMEOUT_S = 2, 3, 180
MOE_MESH_LOSS_ATOL, MOE_MESH_AUX_RTOL = 1e-3, 1e-3
# The first step (before the optimizer moves the router, whose collapse
# under adamw makes the later losses ride on near ties): its loss,
# grad_norm and routers' gradient norm, each within the job's
# MOE_MESH_FIRST_RTOL (relative) of one process's on every rank.  Sound
# readings (NVIDIA H100 80GB HBM3 at 700 W): data 8.5e-6; expert 9.7e-4
# on the routers' norm and 3.2e-4 on grad_norm, where each rank's
# experts' partial output and the einsum dispatch's gradient round to
# bf16 before the sum over the group.  The aux's share of the routers'
# gradient counted twice (summed over an expert group of 2) would move
# that norm by 0.94 (data) and 0.97 (expert), 300 times either bound.
MOE_MESH_FIRST = ("loss", "grad_norm", "router_grad_norm")
MOE_MESH_FIRST_RTOL = {"data": 1e-4, "expert": 3e-3}
MOE_MESH_PHASE_S = 90.0
MOE_MESH_JOBS = {
    "data": (["--mesh", "data=2", "--optimizer", "adafactor"], 4),
    "expert": (["--mesh", "expert=2", "--optimizer", "adamw"], 8),
}
# Phase 7j: adafactor over a mesh (ROADMAP item 24 done): bench.py's LM
# cell through train_lm.run with --optimizer adafactor over
# ADAFACTOR_MESH_WORLD processes sharing the GPU over gloo,
# ADAFACTOR_MESH_STEPS steps from train_lm's seed and synthetic stream,
# the two jobs side by side.  Each job: (its flags beside TRAIN_FLAGS,
# the rows a rank, the bound on its losses against one process with
# adafactor on the same global batch, the relative bound on its first
# step's loss and grad_norm).  "fsdp": each rank draws its 4 rows and
# holds half of every weight's embed dim; the first step's weights are
# one process's, and the later losses move by the bf16 rounding of each
# rank's 4-row gradients before FSDP2 sums them (7i's data job read
# 7.92e-5 and 8.5e-6 at these bounds).  "tensor": every rank the same 8
# rows; each row-parallel output is two bf16 partial sums (7g read
# 5.52e-4 against adamw's bound of 1e-2; 7i's expert job 9.7e-4 on its
# first step).  Every rank's flash kernels run at bh 32 (4 rows x 8
# heads, 8 rows x 4 heads).  The phase must end within
# ADAFACTOR_MESH_PHASE_S.
ADAFACTOR_MESH_WORLD, ADAFACTOR_MESH_STEPS = 2, 3
ADAFACTOR_MESH_TIMEOUT_S, ADAFACTOR_MESH_PHASE_S = 240, 90.0
ADAFACTOR_MESH_BH = 32
ADAFACTOR_MESH_JOBS = {
    "fsdp": (["--mesh", "fsdp=2"], 4, 1e-3, 1e-4),
    "tensor": (["--mesh", "tensor=2"], 8, 1e-2, 3e-3),
}
# Phase 7k: the fused trainer over a mesh (ROADMAP item 22 done): phase
# 7e's width-HFTA_MEMBERS gang (m1 stopping at HFTA_STOP) on bench.py's LM
# cell, 8 x 2048 global, as FusedTrainer(mesh=MeshSpec(data=2)) over
# HFTA_MESH_WORLD processes sharing the GPU over gloo, every rank given the
# global batch and keeping its 4 rows, HFTA_MESH_STEPS steps.  Each rank
# holds the whole stacked state and sums the stacked float32 gradients
# (4 x 188M, about 3 GB) over the data group in one flat all-reduce a
# step.  The losses must be equal on both ranks, each member's first one
# within HFTA_LOSS_ATOL of one process's fused step on the same 8 rows,
# the stacked state (parameters, moments, counts, steps) bit-equal on both
# ranks (checksums of its bits), m1 frozen at its stop, and every rank
# must launch flash_fwd, flash_dq and flash_dkv once a layer a fused step
# at bh HFTA_MESH_BH (4 members x 4 rows x 8 heads); the kernels at that
# bh against their plain versions.  The phase must end within
# HFTA_MESH_PHASE_S.
HFTA_MESH_WORLD, HFTA_MESH_STEPS, HFTA_MESH_TIMEOUT_S = 2, 3, 300
HFTA_MESH_BH = HFTA_MEMBERS * TRAIN_BATCH // HFTA_MESH_WORLD * MODEL[
    "n_heads"]
HFTA_MESH_PHASE_S = 90.0
# Phase 7i's data job also takes one forward and backward of its model
# with the gather dispatch in routing groups of SPANNING_GROUP tokens,
# twice a rank's 4 x 2048 (ROADMAP item 27 done: each group spans both
# ranks), each rank on its rows of one global batch, against one process
# on the 16384 global tokens: the loss, moe_aux and the routers' gradient
# norm (summed over the ranks) within MOE_MESH_FIRST_RTOL["data"].
SPANNING_GROUP = TRAIN_BATCH * TRAIN_SEQ
# Phases 11-12: the CNN family.  Phase 11 serves these exports through the
# classifier loader and the MicroBatcher; each model's name, its loader
# config and its image size (the canonical input of each).
CNN_SERVED = {
    "resnet": ({"family": "resnet50", "num_classes": 1000, "top_k": 5}, 224),
    "inception": ({"family": "inception_v3", "num_classes": 1000,
                   "top_k": 5}, 299),
}
CNN_LOADER = "kubeflow_tpu.serving.loaders:classifier"
CNN_MICRO_BATCH, CNN_BURST, CNN_DIRECT_ROWS = 8, 16, 8
# bf16 logits against a float32 run of the same weights (TF32 off): each
# model's relative Frobenius error bound, between its sound readings
# (NVIDIA H100 80GB HBM3 at 700 W, here: ResNet-50 2.05e-3, Inception-v3
# 1.49e-3) and its control run with BatchNorm normalizing in bf16
# (3.30e-3 and 2.42e-3), about 1.25x from each.  Phase 11 runs the
# control too: it must exceed the bound.
CNN_LOGITS_REL_TOL = {"resnet": 2.6e-3, "inception": 1.9e-3}
# bench.py's ResNet-50 cell (bench_resnet): 224 x 224, batch 256 a chip,
# bf16, optax.sgd(0.1, momentum=0.9); the flags of the port's entry point.
CNN_TRAIN_BATCH = 256
CNN_TRAIN_FLAGS = [
    "--model", "resnet50", "--image-size", "224", "--num-classes", "1000",
    "--batch-size-per-device", str(CNN_TRAIN_BATCH), "--dtype", "bfloat16",
    "--learning-rate", "0.1", "--device", "cuda"]
CNN_TRAIN_STEPS, CNN_CKPT_EVERY = 4, 2
CNN_LEARN_STEPS, CNN_LEARN_BATCH = 30, 32
# Phase 12b: the same cell through train_cnn.run as a gang of
# CNN_GANG_WORLD processes sharing the GPU over gloo, each on its
# CNN_TRAIN_BATCH / CNN_GANG_WORLD rows, CNN_GANG_STEPS steps, against one
# process on the same 256 rows (rank d's from RandomState(d)) from the
# same seed: each loss within CNN_GANG_LOSS_ATOL and bn_init's running
# mean and variance within CNN_GANG_STATS_RTOL (relative Frobenius), where
# each rank rounds its rows' bf16 weight gradients before the all-reduce
# and one process rounds the whole batch's once; the running statistics
# equal on both ranks bit for bit (each rank's own rows, or weights out of
# step, would part them).  The phase must end within CNN_GANG_PHASE_S.
CNN_GANG_WORLD, CNN_GANG_STEPS, CNN_GANG_TIMEOUT_S = 2, 3, 240
CNN_GANG_LOSS_ATOL, CNN_GANG_STATS_RTOL = 5e-3, 1e-2
CNN_GANG_PHASE_S = 90.0
# Phase 13: the worker runtime and tooling.  The one-GPU shape the
# launched trainer's KFT_SLICE_TYPE names, its steps, the profiled window
# of phase 7's trainer (steps [1, 3) of 4) and the phase's bound.
TOOLS_SLICE = "h100-1"
TOOLS_TRAIN_STEPS = 3
PROFILE_START, PROFILE_COUNT, PROFILE_STEPS = 1, 2, 4
TORCH_WORKER_STEPS = 20
TOOLS_TIMEOUT_S = 120
TOOLS_PHASE_S = 60.0
SERVE_KERNELS = ("flash_fwd", "flash_fwd_masked")
TRAIN_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def live_work(bh, sq, sk, causal, starts):
    """What these inputs need: (query, key) pairs attended, query rows
    with at least one valid key, and key rows some query attends.  Rows
    before their first valid key and keys above the diagonal are neither
    read nor computed; such a row's o and lse are still written."""
    allowed = [min(i + 1, sk) if causal else sk for i in range(sq)]
    key_end = min(sq, sk) if causal else sk
    pairs = q_rows = kv_rows = 0
    for s0 in ([0] * bh if starts is None else starts):
        lo = min(max(s0, 0), sk)
        pairs += sum(max(hi - lo, 0) for hi in allowed)
        q_rows += sum(hi > lo for hi in allowed)
        kv_rows += max(key_end - lo, 0)
    return pairs, q_rows, kv_rows


def make_inputs(torch, gen, bh, sq, sk, d, starts):
    q = torch.randn(bh, sq, d, device="cuda", generator=gen).bfloat16()
    k = torch.randn(bh, sk, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(bh, sk, d, device="cuda", generator=gen).bfloat16()
    ks = None if starts is None else torch.tensor(
        starts, dtype=torch.int32, device="cuda")
    return q, k, v, ks


def check_kernels(torch, flash, gen):
    """Phase 2: each variant against the plain version on the card."""
    variants = [
        # name, bh, sq, sk, d, causal, kv_start per row
        ("causal_188m", 8, 2048, 2048, 128, True, None),
        ("causal_direct_request", DIRECT_ROWS * MODEL["n_heads"],
         DIRECT_LEN, DIRECT_LEN, 128, True, None),
        ("masked_188m", 32, 2048, 2048, 128, True,
         [0] * 8 + [248] * 8 + [1088] * 8 + [1748] * 8),
        ("causal_d64_unaligned", 6, 1000, 1000, 64, True, None),
        ("masked_d64_full_tiles", 4, 777, 777, 64, True,
         [0, 63, 200, 777]),
        ("noncausal_d128", 4, 333, 1500, 128, False, None),
        ("noncausal_masked_d64", 4, 333, 777, 64, False,
         [0, 64, 500, 900]),
        # The kernel's 128-row query and 128-key tiles: below one tile,
        # one past a tile, and key starts inside a tile.
        ("causal_below_one_tile", 4, 100, 100, 128, True, None),
        ("causal_one_past_a_tile", 4, 129, 129, 128, True, None),
        ("noncausal_one_past_tiles_d64", 4, 129, 257, 64, False, None),
        ("masked_start_inside_a_tile", 4, 300, 300, 128, True,
         [129, 200, 255, 1]),
    ]
    results = []
    for name, bh, sq, sk, d, causal, starts in variants:
        q, k, v, ks = make_inputs(torch, gen, bh, sq, sk, d, starts)
        o, lse = flash.flash_fwd(q, k, v, causal=causal, kv_start=ks)
        results.append(check_fwd(torch, flash, name, q, k, v, ks, causal,
                                 o, lse))
        del q, k, v, o, lse
    check_cross_head(torch, flash, gen)
    return results


def check_cross_head(torch, flash, gen):
    """Phase 2: heads of distinct magnitudes (k and v scaled by the head's
    index) at a length that ends inside a tile, each head held to the plain
    version on its own: a tile that read the next head's rows instead of
    the zeros the kernel's loads fill in past a head's end would show.
    Fails on disagreement; its errors (of scaled data) stay out of the
    kernels line."""
    bh, s, d = 6, 200, 128
    q, k, v, _ = make_inputs(torch, gen, bh, s, s, d, None)
    mag = torch.arange(1, bh + 1, device="cuda",
                       dtype=torch.float32)[:, None, None]
    k = (k.float() * (1 + mag / 4)).bfloat16()
    v = (v.float() * (1 + mag / 2)).bfloat16()
    for causal in (True, False):
        o, lse = flash.flash_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = flash.flash_fwd_reference(q.float(), k.float(),
                                             v.float(), causal=causal)
        for h in range(bh):
            compare_out(torch, f"cross_head_causal{int(causal)}_h{h}", o[h],
                        lse[h], ro[h], rlse[h],
                        f"head {h} of bh={bh} s={s} d={d} causal={causal}, "
                        f"k x {1 + (h + 1) / 4}, v x {1 + (h + 1) / 2}")


def check_fwd(torch, flash, name, q, k, v, ks, causal, o, lse):
    """The forward kernel's (o, lse) on these inputs against the plain
    version in float32; fails on disagreement, else returns the errors."""
    torch.cuda.synchronize()
    ro, rlse = flash.flash_fwd_reference(
        q.float(), k.float(), v.float(), causal=causal, kv_start=ks)
    row = compare_out(torch, name, o, lse, ro, rlse,
                      f"bh={q.shape[0]} sq={q.shape[1]} sk={k.shape[1]} "
                      f"d={q.shape[2]} causal={causal} "
                      f"masked={ks is not None}")
    return dict(row, masked=ks is not None)


def compare_out(torch, name, o, lse, ro, rlse, what):
    """(o, lse) of a kernel against its plain version's (ro, rlse) within
    O_TOL, O_REL_TOL and LSE_ATOL; fails on disagreement, else returns
    the errors.  Against a reference of all zeros (pass A where no row
    has a key: o = 0, lse = NEG_INF) the relative bound applies to the
    largest error itself."""
    err_o = (o.float() - ro).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    ref_norm = ro.norm().item()
    rel_o = ((o.float() - ro).norm().item() / ref_norm if ref_norm
             else err_o)
    ok_o = torch.allclose(o.float(), ro, **O_TOL) and rel_o <= O_REL_TOL
    ok_lse = torch.allclose(lse, rlse, atol=LSE_ATOL, rtol=0)
    finite = bool(torch.isfinite(o).all())
    log(f"check {name}: {what} max|o-ref|={err_o:.3e} "
        f"|o-ref|_F/|ref|_F={rel_o:.3e} max|lse-ref|={err_lse:.3e} "
        f"(bounds o atol/rtol {O_TOL['atol']}, o relative "
        f"{O_REL_TOL}, lse atol {LSE_ATOL})")
    if not (ok_o and ok_lse and finite):
        fail(f"kernel disagrees with its plain version on {name}")
    return {"variant": name, "max_abs_err_o": err_o, "rel_err_o": rel_o,
            "max_abs_err_lse": err_lse}


def check_two_pass_kernels(torch, flash, gen):
    """Phase 2, two-pass forward: pass A (flash_fwd_full) and pass B
    (flash_fwd_diag) each against its plain version, and their merge
    against the single pass's plain version, at the training shape and
    split, d 64, fitted blocks that are not multiples of 64 or of the
    128-row tile (per-row bounds), a length that is not a tile multiple
    and the pure band (pass A not launched); then a shape that fails the
    two-pass dispatch must launch neither pass."""
    bq, bk, bd = TWO_PASS_BLOCKS
    variants = [
        # name, bh, s, d, block_q, block_k
        ("train", TRAIN_BATCH * MODEL["n_heads"], TRAIN_SEQ, 128, bq, bk),
        ("d64", 16, TRAIN_SEQ, 64, bq, bk),
        ("bq32_bk64", 8, 128, 128, 32, 64),
        ("bq_bk32_s96", 8, 96, 64, 32, 32),
        ("bq_bk400_s1200", 8, 1200, 128, 400, 400),
        ("pure_band", 8, 1024, 128, bq, bk),
        # Fitted blocks that are multiples of 64 but not of the kernel's
        # 128-row or 128-key tile: per-row bounds.
        ("bq_bk192_s768", 8, 768, 128, 192, 192),
        ("bq64_bk128_s512_d64", 8, 512, 64, 64, 128),
    ]
    results = {"flash_fwd_full": [], "flash_fwd_diag": [], "merged": []}
    for name, bh, s, d, vq, vk in variants:
        q, k, v, _ = make_inputs(torch, gen, bh, s, s, d, None)
        ref = [t.float() for t in (q, k, v)]
        what = f"bh={bh} s={s} d={d} block_q={vq} block_k={vk}"
        for kernel, fn, plain in (
                ("flash_fwd_full", flash.flash_fwd_full,
                 flash.flash_fwd_full_reference),
                ("flash_fwd_diag", flash.flash_fwd_diag,
                 flash.flash_fwd_diag_reference)):
            o, lse = fn(q, k, v, block_q=vq, block_k=vk)
            torch.cuda.synchronize()
            results[kernel].append(compare_out(
                torch, f"{kernel}_{name}", o, lse,
                *plain(*ref, block_q=vq, block_k=vk), what))
        before = dict(flash.launch_counts)
        o, lse = flash.flash_fwd_two_pass(q, k, v, block_q=vq, block_k=vk,
                                          block_diag=bd)
        torch.cuda.synchronize()
        launched = {key: flash.launch_counts[key] - before[key]
                    for key in ("flash_fwd", "flash_fwd_full",
                                "flash_fwd_diag")}
        full = 0 if name == "pure_band" else 1
        if launched != {"flash_fwd": 0, "flash_fwd_full": full,
                        "flash_fwd_diag": 1}:
            fail(f"two-pass forward on {name} launched {launched}")
        results["merged"].append(compare_out(
            torch, f"two_pass_merged_{name}", o, lse,
            *flash.flash_fwd_reference(*ref, causal=True),
            f"{what} against the single pass's plain version"))
        del q, k, v, ref, o, lse
    q, k, v, _ = make_inputs(torch, gen, 8, TRAIN_SEQ, TRAIN_SEQ, 128, None)
    before = dict(flash.launch_counts)
    # sq <= block_k: the single pass.
    flash._fwd_dispatch(q, k, v, True, bq, TRAIN_SEQ, bd)
    torch.cuda.synchronize()
    launched = {key: flash.launch_counts[key] - before[key]
                for key in ("flash_fwd", "flash_fwd_full", "flash_fwd_diag")}
    if launched != {"flash_fwd": 1, "flash_fwd_full": 0, "flash_fwd_diag": 0}:
        fail(f"a shape outside the two-pass dispatch launched {launched}")
    log(f"check two-pass dispatch: s {TRAIN_SEQ} <= block_k {TRAIN_SEQ} "
        f"launched {launched}")
    return results


def _bwd_errors(torch, got, want):
    """(relative Frobenius error, max |error|, elementwise ok, finite)."""
    err = got.float() - want.float()
    rel = (err.norm() / want.float().norm()).item()
    ok = torch.allclose(got.float(), want.float(), **BWD_ELEM_TOL)
    return rel, err.abs().max().item(), ok, bool(torch.isfinite(got).all())


def check_bwd_kernels(torch, flash, gen, fwd_checks):
    """Phase 2, backward: dq and dkv against the plain version.  The
    forward kernel's (o, lse) they start from is first held against its
    own plain version at the same shape (the training shape among them),
    and its row is added to ``fwd_checks``."""
    variants = [
        # name, bh, sq, sk, d, causal, rows whose lse is NEG_INF
        ("causal_train", TRAIN_BATCH * MODEL["n_heads"], TRAIN_SEQ,
         TRAIN_SEQ, 128, True, False),
        ("causal_d64_unaligned", 6, 1000, 1000, 64, True, False),
        ("noncausal_sq_ne_sk", 4, 333, 1500, 128, False, False),
        ("neg_inf_rows_d64", 4, 777, 777, 64, True, True),
        # 1153 = 9 x 128 + 1: cuts dq's 128-row and 128-key tiles and
        # dkv's 128-key and 64-query tiles.
        ("causal_tile_cut_d128", 6, 1153, 1153, 128, True, False),
        # Causal sk > sq: dkv's key tiles from 256 on hold no live query
        # and must still write their zero dk and dv.
        ("causal_sk_gt_sq_zero_store", 4, 200, 777, 128, True, False),
    ]
    results = []
    for name, bh, sq, sk, d, causal, neg_inf in variants:
        q, k, v, _ = make_inputs(torch, gen, bh, sq, sk, d, None)
        g = torch.randn(bh, sq, d, device="cuda", generator=gen).bfloat16()
        o, lse = flash.flash_fwd(q, k, v, causal=causal)
        fwd_checks.append(check_fwd(torch, flash, f"fwd_of_bwd_{name}", q,
                                    k, v, None, causal, o, lse))
        if neg_inf:
            lse[1, ::3] = flash.NEG_INF
            lse[3] = flash.NEG_INF
        delta = (g.float() * o.float()).sum(-1)
        got = flash.flash_bwd(q, k, v, g, lse, delta, causal=causal)
        torch.cuda.synchronize()
        want = flash.flash_bwd_reference(q.float(), k.float(), v.float(),
                                         g.float(), lse, delta,
                                         causal=causal)
        row = {"variant": name, "shape": [bh, sq, sk, d], "causal": causal}
        line = []
        for grad, a, b in zip(("dq", "dk", "dv"), got, want):
            rel, mx, ok, finite = _bwd_errors(torch, a, b)
            row[f"rel_err_{grad}"], row[f"max_abs_err_{grad}"] = rel, mx
            line.append(f"{grad} rel {rel:.3e} max {mx:.3e}")
            if not (ok and finite and rel <= BWD_REL_TOL):
                fail(f"backward kernel {grad} disagrees with its plain "
                     f"version on {name}: relative {rel:.3e}, max {mx:.3e}")
        if neg_inf and not (torch.all(got[0][3] == 0)
                            and torch.all(got[1][3] == 0)):
            fail("a row block with NEG_INF lse got non-zero gradients")
        if causal and sk > sq and not (torch.all(got[1][:, sq:] == 0)
                                       and torch.all(got[2][:, sq:] == 0)):
            fail("keys past the last query got non-zero dk or dv")
        log(f"check bwd {name}: bh={bh} sq={sq} sk={sk} d={d} "
            f"causal={causal} neg_inf_rows={neg_inf}: {'; '.join(line)} "
            f"(bounds: relative {BWD_REL_TOL}, elementwise atol "
            f"{BWD_ELEM_TOL['atol']} rtol {BWD_ELEM_TOL['rtol']})")
        results.append(row)
        del q, k, v, g, o, lse, delta, got, want
    return results


def check_bwd_heads_apart(torch, flash):
    """Phase 2, backward: heads of distinct magnitudes (q, k, v and g
    scaled up to 4x by the head's index) at a length that ends inside
    every tile, as tests/test_torch_flash_bwd_cuda.py's
    test_heads_stay_apart builds them: each head's relative Frobenius
    error and its largest error over the head's RMS, for dq, dk and dv.
    A head that read another head's rows would stand apart from the
    rest; a scale effect moves them together.  Fails when a head's
    relative error exceeds BWD_REL_TOL."""
    import numpy as np

    bh, s = 6, 200
    rng = np.random.default_rng(5)
    worst = 0.0
    for d in (64, 128):
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (bh, s, d), np.float32)).to("cuda", torch.bfloat16)
            for _ in range(4))
        mag = torch.arange(1, bh + 1, device="cuda",
                           dtype=torch.float32)[:, None, None]
        q, k, v, g = ((t.float() * (1 + mag / f)).bfloat16()
                      for t, f in ((q, 8), (k, 4), (v, 2), (g, 3)))
        for causal in (True, False):
            o, lse = flash.flash_fwd(q, k, v, causal=causal)
            delta = (g.float() * o.float()).sum(-1)
            got = flash.flash_bwd(q, k, v, g, lse, delta, causal=causal)
            torch.cuda.synchronize()
            ref = flash.flash_bwd_reference(q.float(), k.float(), v.float(),
                                            g.float(), lse, delta,
                                            causal=causal)
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                cells = []
                for h in range(bh):
                    err = a[h].float() - b[h].float()
                    rel = (err.norm() / b[h].float().norm()).item()
                    rms = b[h].float().pow(2).mean().sqrt()
                    worst = max(worst, rel)
                    cells.append(f"h{h} {rel:.3e} "
                                 f"{(err.abs().max() / rms).item():.3e}")
                log(f"check bwd heads apart d={d} causal={causal} {name} "
                    f"(relative Frobenius, max|err|/rms per head): "
                    + "; ".join(cells))
    if worst > BWD_REL_TOL:
        fail(f"a head's backward error {worst:.3e} exceeds {BWD_REL_TOL}")


def check_autograd(torch, flash, gen):
    """Phase 2, autograd: flash_attention(...).backward(g) on the card
    (forward, dq and dkv kernels, GQA repeat) against the same call with
    the plain versions swapped in."""
    b, s, h, hkv, d = 2, 1024, 8, 2, 128
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    base = [torch.randn(shape, device="cuda", generator=gen).bfloat16()
            for shape in shapes]
    g = torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16()

    def grads():
        q, k, v = (t.clone().requires_grad_() for t in base)
        flash.flash_attention(q, k, v, causal=True).backward(g)
        return q.grad, k.grad, v.grad

    before = dict(flash.launch_counts)
    through_kernels = grads()
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        if flash.launch_counts[name] != before[name] + 1:
            fail(f"autograd through flash_attention did not launch {name}")
    with plain_kernels(flash):
        through_plain = grads()
    line = []
    for name, a, ref in zip(("dq", "dk", "dv"), through_kernels,
                            through_plain):
        rel, mx, ok, finite = _bwd_errors(torch, a, ref)
        line.append(f"{name} rel {rel:.3e} max {mx:.3e}")
        if not (ok and finite and rel <= BWD_REL_TOL):
            fail(f"autograd {name} through the kernels disagrees with the "
                 f"plain path: relative {rel:.3e}")
    log(f"check autograd flash_attention b={b} s={s} h={h} hkv={hkv} "
        f"d={d}: kernels vs plain path {'; '.join(line)}")


class plain_kernels:
    """Swap the kernels' plain versions in for the CUDA launches (the
    comparison runs; nothing of the port's own code path does this)."""

    def __init__(self, flash):
        self.flash = flash

    def __enter__(self):
        f = self.flash
        self.saved = f._flash_fwd_cuda, f._flash_bwd_cuda, \
            f._flash_fwd_pass_cuda
        plain = {"flash_fwd_full": f.flash_fwd_full_reference,
                 "flash_fwd_diag": f.flash_fwd_diag_reference}

        def fwd(q, k, v, *, causal, kv_start=None):
            return f.flash_fwd_reference(q, k, v, causal=causal,
                                         kv_start=kv_start)

        def one_pass(name, q, k, v, *, block_q, block_k):
            return plain[name](q, k, v, block_q=block_q, block_k=block_k)

        f._flash_fwd_cuda, f._flash_bwd_cuda, f._flash_fwd_pass_cuda = \
            fwd, f.flash_bwd_reference, one_pass
        return self

    def __exit__(self, *exc):
        (self.flash._flash_fwd_cuda, self.flash._flash_bwd_cuda,
         self.flash._flash_fwd_pass_cuda) = self.saved


def _instance(lib, entry, *args):
    """What a kernel instance uses, as the loaded kernel reports it through
    the C entry point ``entry``: registers a thread at entry (ptxas's
    count) and shared memory a CTA at launch."""
    import ctypes

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 2)()
    err = fn(*args, info)
    if err != 0:
        fail(f"instance query failed: {lib.kft_cuda_error_string(err)}")
    return dict(zip(("registers", "smem_bytes"), list(info)))


def instance_info(flash, d, causal, masked, pass_=0, bq=0, bk=0):
    """The forward instance launched for these arguments."""
    return _instance(flash._lib(), "kft_flash_fwd_instance_bf16", d,
                     int(causal), int(masked), pass_, bq, bk)


def bwd_instance_info(flash, name, d, causal):
    """The dq or dkv instance launched for these arguments."""
    return _instance(flash._bwd_lib(), "kft_flash_bwd_instance_bf16",
                     int(name == "flash_dkv"), d, int(causal))


def row_stats(row, ops):
    """TFLOP/s and share of its bound of a timed row, in place."""
    row["tflops"] = ops / (row["ms"] * 1e-3) / 1e12
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return (f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} of its "
            f"bound; instance {row['instance']['registers']} registers, "
            f"{row['instance']['smem_bytes']} bytes shared memory")


def bound(ops, nbytes):
    """(bound ms, what sets it, operations ms, bytes ms)."""
    t_ops = ops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", t_ops, t_bytes)


def time_kernels(torch, flash, gen, checks):
    """Phase 3: each forward variant at the serving path's heaviest
    shape."""
    import torch.nn.functional as F

    heads, d = MODEL["n_heads"], MODEL["head_dim"]
    # Masked: a full bucketed batch at the largest bucket, key starts from
    # the smoke's own prompt mix.  Unmasked: the direct two-row request.
    starts = [2048 - n for n in (1800, 1620, 1440, 1210) for _ in
              range(heads)]
    shapes = {
        "flash_fwd": (DIRECT_ROWS * heads, DIRECT_LEN, None),
        "flash_fwd_masked": (MICRO_BATCH * heads, 2048, starts),
    }
    rows = {}
    for name, (bh, s, st) in shapes.items():
        q, k, v, ks = make_inputs(torch, gen, bh, s, s, d, st)
        ms = time_ms(torch, lambda: flash.flash_fwd(
            q, k, v, causal=True, kv_start=ks), reps=20)
        plain_ms = time_ms(torch, lambda: flash.flash_fwd_reference(
            q, k, v, causal=True, kv_start=ks), reps=5)
        q4, k4, v4 = (t[None] for t in (q, k, v))  # [1, bh, s, d]
        if ks is None:
            def library():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True)
        else:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[None, :, None] >= pos[None, None, :])
                    & (pos[None, None, :] >= ks.long()[:, None, None]))[None]

            def library():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=mask)
        library_ms = time_ms(torch, library, reps=10)
        pairs, q_rows, kv_rows = live_work(bh, s, s, True, st)
        ops = 4 * d * pairs  # q.k and p.v, 2 operations per multiply-add
        # bf16 q, k, v of the live rows read once; o (bf16) and lse (f32)
        # of every row written once; the int32 key starts read once.
        nbytes = 2 * d * (q_rows + 2 * kv_rows) + 2 * bh * s * d \
            + 4 * bh * s + (0 if ks is None else 4 * bh)
        t_bound, by, t_ops, t_bytes = bound(ops, nbytes)
        mine = [c for c in checks if c["masked"] == (ks is not None)]
        rows[name] = {
            "name": name, "route": "cuda", "source": FWD_SOURCE,
            "replaces": TPU_KERNELS[name],
            "shape": {"bh": bh, "sq": s, "sk": s, "d": d, "causal": True},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound,
            "bound_by": by, "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "library_ms": library_ms,
            "max_abs_err": max(c["max_abs_err_o"] for c in mine),
            "checks": mine,
            "instance": instance_info(flash, d, True, ks is not None),
        }
        stats = row_stats(rows[name], ops)
        log(f"time {name}: bh={bh} s={s} d={d} kernel {ms:.4f} ms ({stats})"
            f", plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{t_bound:.4f} ms ({by}; operations {t_ops:.4f} ms for "
            f"{ops:.4g}, bytes {t_bytes:.4f} ms for {nbytes:.4g})")
        del q, k, v, ks
    return rows


def time_train_kernels(torch, flash, gen, fwd_rows, bwd_checks):
    """Phase 3, training path: the forward, dq and dkv kernels at the
    training shape (bh 64, s 2048, d 128, causal).  The library yardstick
    of the backward pair is the backward alone of one causal SDPA call
    (torch.autograd.grad on a retained graph, 4-D inputs), which computes
    dq, dk and dv together: it stands on both rows, beside their sum.
    Returns the dq and dkv rows; the forward's numbers go into the
    ``train_shape`` object of its serving-shape row in ``fwd_rows``."""
    import torch.nn.functional as F

    heads, d = MODEL["n_heads"], MODEL["head_dim"]
    bh, s = TRAIN_BATCH * heads, TRAIN_SEQ
    q, k, v, _ = make_inputs(torch, gen, bh, s, s, d, None)
    g = torch.randn(bh, s, d, device="cuda", generator=gen).bfloat16()
    o, lse = flash.flash_fwd(q, k, v, causal=True)
    delta = (g.float() * o.float()).sum(-1)
    args = (q, k, v, g, lse, delta)
    pairs, q_rows, kv_rows = live_work(bh, s, s, True, None)
    fwd_ms = time_ms(torch, lambda: flash.flash_fwd(q, k, v, causal=True),
                     reps=20)
    fwd_plain = time_ms(torch, lambda: flash.flash_fwd_reference(
        q, k, v, causal=True), reps=3)
    dq_ms = time_ms(torch, lambda: flash._flash_dq_cuda(*args, causal=True),
                    reps=20)
    dkv_ms = time_ms(torch, lambda: flash._flash_dkv_cuda(
        *args, causal=True), reps=20)
    dq_plain = time_ms(torch, lambda: flash.flash_dq_reference(
        *args, causal=True), reps=3)
    dkv_plain = time_ms(torch, lambda: flash.flash_dkv_reference(
        *args, causal=True), reps=3)
    # The float32 row sum delta = rowsum(g * o) that _FlashFunction's
    # backward computes before the pair (SDPA's backward includes its own).
    delta_ms = time_ms(torch, lambda: (g.float() * o.float()).sum(-1),
                       reps=20)
    q4, k4, v4 = (t.reshape(TRAIN_BATCH, heads, s, d).detach()
                  .requires_grad_() for t in (q, k, v))
    g4 = g.reshape(TRAIN_BATCH, heads, s, d)
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4.detach(), k4.detach(), v4.detach(), is_causal=True), reps=20)
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
        out4, (q4, k4, v4), g4, retain_graph=True), reps=20)
    shape = {"bh": bh, "sq": s, "sk": s, "d": d, "causal": True}
    io = 2 * d * (2 * q_rows + 2 * kv_rows) + 8 * bh * s  # q g k v lse delta
    work = {
        # name: (ms, plain ms, library ms, operations, bytes, source)
        "flash_fwd": (fwd_ms, fwd_plain, fwd_lib, 4 * d * pairs,
                      2 * d * (q_rows + 2 * kv_rows) + 2 * bh * s * d
                      + 4 * bh * s, FWD_SOURCE),
        # s, dp and dq: three products, 2 d operations per pair each.
        "flash_dq": (dq_ms, dq_plain, bwd_lib, 6 * d * pairs,
                     io + 2 * d * bh * s, BWD_SOURCE),
        # s, dp, dv and dk: four products.
        "flash_dkv": (dkv_ms, dkv_plain, bwd_lib, 8 * d * pairs,
                      io + 4 * d * bh * s, BWD_SOURCE),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms, ops, nbytes, src) in work.items():
        t_bound, by, t_ops, t_bytes = bound(ops, nbytes)
        rows[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": TPU_KERNELS[name], "shape": shape, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": t_bound, "bound_by": by,
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "library_ms": lib_ms,
        }
        log(f"time {name} (training shape): bh={bh} s={s} d={d} kernel "
            f"{ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {t_bound:.4f} "
            f"ms ({by}; operations {t_ops:.4f} ms for {ops:.4g}, bytes "
            f"{t_bytes:.4f} ms for {nbytes:.4g})")
    for name in ("flash_dq", "flash_dkv"):
        rows[name]["instance"] = bwd_instance_info(flash, name, d, True)
        log(f"time {name} (training shape): "
            f"{row_stats(rows[name], work[name][3])}")
        rows[name]["library_note"] = (
            "backward of one causal SDPA call: dq, dk and dv together")
        rows[name]["delta_pass_ms"] = delta_ms
        rows[name]["max_abs_err"] = max(
            c[f"max_abs_err_{g_}"] for c in bwd_checks
            for g_ in (("dq",) if name == "flash_dq" else ("dk", "dv")))
        rows[name]["checks"] = bwd_checks
    log(f"time backward pair: dq + dkv {dq_ms + dkv_ms:.4f} ms, with the "
        f"float32 delta pass ({delta_ms:.4f} ms) "
        f"{dq_ms + dkv_ms + delta_ms:.4f} ms, against the SDPA backward's "
        f"{bwd_lib:.4f} ms (its own row sum included)")
    rows["flash_fwd"]["instance"] = instance_info(flash, d, True, False)
    log(f"time flash_fwd (training shape): "
        f"{row_stats(rows['flash_fwd'], work['flash_fwd'][3])}")
    # The forward's row keeps the serving shape's numbers at its top level
    # (as the serving slice defined them); the training shape's stand in
    # its train_shape object.
    train_fwd = rows.pop("flash_fwd")
    fwd_rows["flash_fwd"]["train_shape"] = {
        key: train_fwd[key] for key in
        ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_bound_ms",
         "bytes_bound_ms", "library_ms", "tflops", "bound_share",
         "instance")}
    del q, k, v, g, o, lse, delta, q4, k4, v4, out4
    return rows


def two_pass_work(bh, s, bq, bk):
    """Per pass, what the two-pass split needs: (pairs attended, query
    rows with at least one key, key rows some query attends), and each
    row's boundary.  Pass A: keys [0, boundary(r)); pass B: [boundary(r),
    r], so every key is its own row's."""
    bnd = [((r // bq) * bq // bk) * bk for r in range(s)]
    full = (bh * sum(bnd), bh * sum(b > 0 for b in bnd), bh * max(bnd))
    diag = (bh * sum(r - b + 1 for r, b in enumerate(bnd)), bh * s, bh * s)
    return full, diag, bnd


def time_two_pass(torch, flash, gen, checks):
    """Phase 3, two-pass forward at the training shape and split: pass A,
    pass B, the merge and the whole two-pass forward, beside the
    single-pass kernel on the same inputs.  Yardsticks: pass A, one SDPA
    call of the rows past the split against the keys before it (every
    such row's boundary); pass B, SDPA with the band's boolean mask; the
    two-pass forward, SDPA is_causal."""
    import torch.nn.functional as F

    heads, d = MODEL["n_heads"], MODEL["head_dim"]
    bh, s = TRAIN_BATCH * heads, TRAIN_SEQ
    bq, bk, bd = TWO_PASS_BLOCKS
    q, k, v, _ = make_inputs(torch, gen, bh, s, s, d, None)
    fns = {
        "flash_fwd_full": (lambda: flash.flash_fwd_full(
            q, k, v, block_q=bq, block_k=bk), lambda: (
            flash.flash_fwd_full_reference(q, k, v, block_q=bq,
                                           block_k=bk))),
        "flash_fwd_diag": (lambda: flash.flash_fwd_diag(
            q, k, v, block_q=bq, block_k=bk), lambda: (
            flash.flash_fwd_diag_reference(q, k, v, block_q=bq,
                                           block_k=bk))),
    }
    full_work, diag_work, bnd = two_pass_work(bh, s, bq, bk)
    split = bnd[-1]
    if any(b != split for b in bnd[split:]):
        fail("the training split's rows past the boundary differ")
    q4, k4, v4 = (t.reshape(TRAIN_BATCH, heads, s, d) for t in (q, k, v))
    pos = torch.arange(s, device="cuda")
    band = ((pos[None, :] >= torch.tensor(bnd, device="cuda")[:, None])
            & (pos[None, :] <= pos[:, None]))
    library = {
        "flash_fwd_full": lambda: F.scaled_dot_product_attention(
            q4[:, :, split:], k4[:, :, :split], v4[:, :, :split]),
        "flash_fwd_diag": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=band),
    }
    rows = {}
    work = {"flash_fwd_full": full_work, "flash_fwd_diag": diag_work}
    for name, (kernel, plain) in fns.items():
        ms = time_ms(torch, kernel, reps=20)
        plain_ms = time_ms(torch, plain, reps=3)
        lib_ms = time_ms(torch, library[name], reps=20)
        pairs, q_rows, kv_rows = work[name]
        ops = 4 * d * pairs
        # bf16 q of the rows with keys, k and v of the keys attended, read
        # once; o (bf16) and lse (f32) of every row written once.
        nbytes = 2 * d * (q_rows + 2 * kv_rows) + 2 * bh * s * d + 4 * bh * s
        t_bound, by, t_ops, t_bytes = bound(ops, nbytes)
        rows[name] = {
            "name": name, "route": "cuda", "source": FWD_SOURCE,
            "replaces": TPU_KERNELS[name],
            "shape": {"bh": bh, "s": s, "d": d, "block_q": bq,
                      "block_k": bk, "block_diag": bd},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound,
            "bound_by": by, "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
            "library_ms": lib_ms,
            "max_abs_err": max(c["max_abs_err_o"] for c in checks[name]),
            "checks": checks[name],
            "instance": instance_info(flash, d, True, False,
                                      flash._PASSES[name], bq, bk),
        }
        stats = row_stats(rows[name], ops)
        log(f"time {name} (training shape): bh={bh} s={s} d={d} block_q="
            f"{bq} block_k={bk}: kernel {ms:.4f} ms "
            f"({stats}), plain {plain_ms:.4f} ms,"
            f" sdpa {lib_ms:.4f} ms, bound {t_bound:.4f} ms ({by}; "
            f"operations {t_ops:.4f} ms for {ops:.4g}, bytes {t_bytes:.4f} "
            f"ms for {nbytes:.4g})")
    (o_a, lse_a), (o_b, lse_b) = fns["flash_fwd_full"][0](), \
        fns["flash_fwd_diag"][0]()
    merge_ms = time_ms(torch, lambda: flash.merge_partials(
        o_a, lse_a, o_b, lse_b), reps=20)
    total_ms = time_ms(torch, lambda: flash.flash_fwd_two_pass(
        q, k, v, block_q=bq, block_k=bk, block_diag=bd), reps=20)
    single_ms = time_ms(torch, lambda: flash.flash_fwd(q, k, v, causal=True),
                        reps=20)
    causal_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=20)
    summary = {
        "pass_a_ms": rows["flash_fwd_full"]["ms"],
        "pass_b_ms": rows["flash_fwd_diag"]["ms"], "merge_ms": merge_ms,
        "two_pass_ms": total_ms, "single_pass_kernel_ms": single_ms,
        "sdpa_causal_ms": causal_ms,
        "max_abs_err_merged": max(c["max_abs_err_o"]
                                  for c in checks["merged"]),
    }
    log(f"time two-pass forward (training shape): pass A "
        f"{summary['pass_a_ms']:.4f} + pass B {summary['pass_b_ms']:.4f} + "
        f"merge {merge_ms:.4f} ms; whole call {total_ms:.4f} ms against the "
        f"single-pass kernel's {single_ms:.4f} ms and SDPA is_causal's "
        f"{causal_ms:.4f} ms")
    del q, k, v, q4, k4, v4, band, o_a, lse_a, o_b, lse_b
    return rows, summary


def export_model(torch, base: Path) -> None:
    from kubeflow_tpu_torch.models.convert import params_to_jax
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from kubeflow_tpu_torch.serving.export import export

    cfg = TransformerConfig(**dict(MODEL, dtype=torch.float32))
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    export(base, 1, {"params": params_to_jax(model)}, loader=JAX_LOADER,
           config={"model": MODEL, "max_new_tokens": MAX_NEW_TOKENS},
           signature={"inputs": ["tokens"], "outputs": ["tokens"]})
    log(f"exported seeded {n_params / 1e6:.1f}M-parameter LM to {base}")


def post(port: int, body: dict, path: str = "/model/lm:predict") -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"POST {path} answered {resp.status}: {payload}")
    return payload


def grpc_predict(grpc_port: int, rest_port: int, prompt) -> None:
    """One gRPC Predict of ``prompt`` on the phase 4 server, held equal
    to a REST :predict of the same prompt, each sent alone."""
    import numpy as np

    from kubeflow_tpu_torch.serving.grpc_server import PredictionClient

    rest = post(rest_port, {"instances": [{"tokens": prompt}]})
    client = PredictionClient(f"127.0.0.1:{grpc_port}")
    try:
        t0 = time.perf_counter()
        out = client.predict("lm", {"tokens": np.asarray([prompt],
                                                         np.int32)},
                             timeout=600.0)
        t_grpc = time.perf_counter() - t0
        ready = client.ready()
    finally:
        client.close()
    got = np.asarray(out["tokens"])[0].tolist()
    want = rest["predictions"][0]["tokens"]
    log(f"grpc: Predict of a {len(prompt)}-token prompt on :{grpc_port} in "
        f"{t_grpc * 1e3:.1f} ms (host clock), health SERVING {ready}, "
        f"tokens equal to REST's: {got == want}")
    if got != want or not ready:
        fail("the gRPC Predict answer differs from REST's, or the health "
             "check is not SERVING")


def serve(torch, flash, base: Path, prompts, direct):
    """Phase 4: the port's serving entry point, driven over REST, on the
    static bucketed batcher (--lm_static_batcher: the engine is the
    default for lm_generate models and launches no flash kernel)."""
    from kubeflow_tpu_torch.serving import main as serving_main

    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--grpc_port", "0", "--host", "127.0.0.1",
        "--device", "cuda",
        "--lm_static_batcher", "--lm_buckets", BUCKETS,
        "--micro_batch_size", str(MICRO_BATCH)])
    port = httpd.server_address[1]
    try:
        # One short request first, so the timed burst does not carry the
        # process's one-off CUDA and cuBLAS start-up.
        post(port, {"instances": [{"tokens": prompts[0][:16]}]})
        for key in flash.launch_counts:
            flash.launch_counts[key] = 0
        replies, latencies, t_batched = burst(port, prompts)
        t1 = time.perf_counter()
        direct_reply = post(port, {"instances": [{"tokens": p}
                                                 for p in direct]})
        t_direct = time.perf_counter() - t1
        stats = server.batcher_stats("lm")
        grpc_predict(httpd.grpc_server.bound_port, port, prompts[0])
    finally:
        serving_main.shutdown(server, httpd)
    counts = {k: flash.launch_counts[k] for k in SERVE_KERNELS}
    n_req = len(prompts) + 1
    n_tok = (len(prompts) + len(direct)) * MAX_NEW_TOKENS
    log(f"served {len(prompts)} concurrent bucketed requests in "
        f"{t_batched:.3f} s and one direct {len(direct)}-row request in "
        f"{t_direct:.3f} s: {n_req / (t_batched + t_direct):.3f} requests/s,"
        f" {n_tok / (t_batched + t_direct):.1f} generated tokens/s "
        f"(host clock, information only)")
    log(f"kernel launches on the serving path: {counts}; batcher: "
        f"{stats['batches']} batches, sizes {stats['batch_size_hist']}")
    return replies, direct_reply, counts


def pct(values, q):
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(len(ordered) * q))]


def burst(port: int, prompts, extra=None):
    """Every prompt as its own concurrent :predict request (its instance
    with ``extra``'s keys too); returns the replies, each request's
    latency and the burst's wall time (host clock)."""
    replies = [None] * len(prompts)
    latencies = [None] * len(prompts)

    def call(i):
        t = time.perf_counter()
        replies[i] = post(port, {"instances": [
            dict(extra or {}, tokens=prompts[i])]})
        latencies[i] = time.perf_counter() - t

    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or None in replies:
        fail("a request of the burst did not complete")
    return replies, latencies, time.perf_counter() - t0


def get(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        payload = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"GET {path} answered {resp.status}: {payload}")
    return payload


def engine_prefill_width() -> int:
    """The serving entry point's engine prefill width for these flags:
    the largest bucket, clamped to the prompt room."""
    return min(max(int(b) for b in BUCKETS.split(",")),
               MODEL["max_seq_len"] - MAX_NEW_TOKENS)


def burst_info(prompts, latencies, t_burst, stats) -> dict:
    """Throughput and latency of one burst; TTFT from the engine's clock
    (the static batcher returns no token before its last: None)."""
    n_tok = len(prompts) * MAX_NEW_TOKENS
    return {
        "burst_s": t_burst,
        "requests_per_s": len(prompts) / t_burst,
        "tokens_per_s": n_tok / t_burst,
        "ttft_p50_ms": stats.get("ttft_p50_ms"),
        "ttft_p99_ms": stats.get("ttft_p99_ms"),
        "latency_p50_s": pct(latencies, 0.5),
        "latency_p99_s": pct(latencies, 0.99),
    }


def log_burst(what: str, info: dict) -> None:
    ttft = ("TTFT not delivered before the last token"
            if info["ttft_p50_ms"] is None else
            f"TTFT p50 {info['ttft_p50_ms']:.1f} ms p99 "
            f"{info['ttft_p99_ms']:.1f} ms (engine clock)")
    log(f"{what} burst: {info['burst_s']:.3f} s, "
        f"{info['requests_per_s']:.3f} requests/s, "
        f"{info['tokens_per_s']:.1f} generated tokens/s; {ttft}; latency "
        f"p50 {info['latency_p50_s']:.3f} s p99 "
        f"{info['latency_p99_s']:.3f} s (client clock; information only; "
        f"{card_line()})")


def serve_engine(torch, flash, base: Path, prompts):
    """Phase 6b: the port's serving entry point with the JAX CLI's engine
    defaults (8 slots, fused rounds of 8, 64-token chunks, 16-token
    blocks, prefix cache on), the bf16 188M LM at full width and depth,
    its programs captured as CUDA graphs.  The eight prompts as one
    concurrent burst, then two requests that share a 1024-token prefix,
    then one request with the card's sync debug mode at "error".  No
    flash kernel may launch; :stats must show the slots reused, a prefix
    hit, and the JAX engine's compiled_programs() for these flags.  Then
    (information only) the same burst through the same server with the
    engine's programs run eagerly (cuda_graphs=False), then through the
    static batcher."""
    from kubeflow_tpu_torch.serving import main as serving_main
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    def eager_engine(loaded):
        spec = loaded.predict.engine_spec
        return DecodeEngine(spec["model"], spec["decode"], slots=8,
                            prefill_len=engine_prefill_width(),
                            decode_rounds=8, name="lm-eager",
                            cuda_graphs=False)

    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
        "--device", "cuda",
        "--lm_buckets", BUCKETS])
    port = httpd.server_address[1]
    rng = torch.Generator().manual_seed(SEED + 1)
    vocab = MODEL["vocab_size"]
    prefix = torch.randint(1, vocab, (SHARED_PREFIX,), generator=rng)
    pair = [(prefix.tolist() + torch.randint(1, vocab, (n,), generator=rng)
             .tolist()) for n in (100, 200)]
    launches_before = dict(flash.launch_counts)
    try:
        engine = server._batchers["lm"]
        if not engine.cuda_graphs or engine.capture_info is None:
            fail("the served engine did not capture its programs")
        capture = dict(engine.capture_info)
        replies, latencies, t_burst = burst(port, prompts)
        SERVED["6b"] = [r["predictions"][0]["tokens"] for r in replies]
        burst_stats = get(port, "/model/lm:stats")["batcher"]
        pair_replies = [post(port, {"instances": [{"tokens": p}]})
                        for p in pair]
        torch.cuda.set_sync_debug_mode("error")
        try:
            post(port, {"instances": [{"tokens": prompts[0][:64]}]})
        finally:
            torch.cuda.set_sync_debug_mode(0)
        stats = get(port, "/model/lm:stats")["batcher"]
        # The same burst, same server, engine programs run eagerly.
        server.enable_batching("lm", eager_engine)
        eager_replies, eager_lat, t_eager = burst(port, prompts)
        eager_stats = get(port, "/model/lm:stats")["batcher"]
        launches_engine = dict(flash.launch_counts)
        # And through the static batcher (--lm_static_batcher's).
        server.enable_batching("lm", serving_main.batcher_factory(
            micro_batch_size=MICRO_BATCH, batch_timeout_s=5e-3,
            lm_buckets=BUCKETS, lm_engine=False))
        static_replies, static_lat, t_static = burst(port, prompts)
    finally:
        serving_main.shutdown(server, httpd)
    if launches_engine != launches_before:
        fail("the engine path launched a flash kernel: "
             f"{launches_before} -> {launches_engine}")
    check_replies(prompts + pair, replies + pair_replies, [], None)
    check_replies(prompts, eager_replies, [], None)
    check_replies(prompts, static_replies, [], None)
    want_programs = {"chunked_prefill": 1, "step": 0, "verify": 0,
                     "decode_rounds": 1}
    for what, got in (("captured", stats), ("eager", eager_stats)):
        if got["compiled_programs"] != want_programs:
            fail(f"{what} engine compiled_programs "
                 f"{got['compiled_programs']}, the JAX engine reports "
                 f"{want_programs} for these flags")
    if stats["prefix_hits"] < 1 or stats["cached_prompt_tokens"] \
            < SHARED_PREFIX:
        fail(f"no prefix hit on the shared {SHARED_PREFIX}-token prefix: "
             f"{stats['prefix_hits']} hits, "
             f"{stats['cached_prompt_tokens']} cached tokens")
    if stats["requests"] <= stats["slots"] or stats["active_slots"] \
            or stats["in_flight_requests"]:
        fail(f"slots not reused and released: {stats['requests']} "
             f"requests through {stats['slots']} slots, "
             f"{stats['active_slots']} still active")
    info = {
        "capture": capture,
        "captured": dict(
            burst_info(prompts, latencies, t_burst, burst_stats),
            token_latency_p50_ms=burst_stats["token_latency_p50_ms"],
            steps_per_round_p50=burst_stats["steps_per_round_p50"],
            prefill_chunks=burst_stats["prefill_chunks"]),
        "eager": dict(
            burst_info(prompts, eager_lat, t_eager, eager_stats),
            token_latency_p50_ms=eager_stats["token_latency_p50_ms"]),
        "static": burst_info(prompts, static_lat, t_static, {}),
        "prefix_hits": stats["prefix_hits"],
        "cached_prompt_tokens": stats["cached_prompt_tokens"],
        "compiled_programs": stats["compiled_programs"],
    }
    log(f"engine capture: {capture['programs']} as CUDA graphs in "
        f"{capture['seconds']:.3f} s, graph pool {capture['pool_bytes']} "
        f"bytes")
    log_burst("captured engine", info["captured"])
    log_burst("eager engine (cuda_graphs=False)", info["eager"])
    log_burst("static batcher", info["static"])
    log(f"burst time, captured engine / eager engine / static batcher: "
        f"{t_burst:.3f} / {t_eager:.3f} / {t_static:.3f} s; the captured "
        f"engine's {info['captured']['prefill_chunks']} prefill chunks, "
        f"steps per round p50 {info['captured']['steps_per_round_p50']}")
    log(f"engine :stats: {stats['requests']} requests through "
        f"{stats['slots']} slots, prefix hits {stats['prefix_hits']} "
        f"({stats['cached_prompt_tokens']} cached tokens), "
        f"compiled_programs {stats['compiled_programs']}; one request "
        f"served under sync debug mode 'error'")
    return [r["predictions"][0]["tokens"] for r in replies], info


def engine_identity(torch, flash, base: Path, prompts, bf16_tokens):
    """Phase 6b, token identity: the same engine with the float32 model
    (TF32 off) on four of the prompts must give each prompt's greedy
    tokens of generate() alone at float32.  The bf16 engine's tokens
    against bf16 generate() are information only: the first position
    where the two differ, per prompt."""
    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    model = load_model(torch, base, torch.float32)
    # Built after TF32 was switched off: the captured graphs keep the
    # math mode of their capture.
    engine = DecodeEngine(model, decode, slots=8,
                          prefill_len=engine_prefill_width(),
                          decode_rounds=8, name="fp32-identity")
    if not engine.cuda_graphs:
        fail("the float32 identity engine did not capture its programs")
    four = prompts[:4]
    outs = [None] * len(four)

    def call(i):
        outs[i] = engine.submit({"tokens": four[i]})["tokens"][0].tolist()

    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(four))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        engine.close()
    if None in outs:
        fail("a float32 engine request did not complete")
    with plain_kernels(flash):
        for prompt, got in zip(four, outs):
            want, _ = generate(model, torch.tensor([prompt]), decode)
            if got != want[0].tolist():
                fail(f"float32 engine tokens of a {len(prompt)}-token prompt "
                     "differ from generate() alone")
    log(f"captured engine token identity at float32: {len(four)} prompts "
        f"{[len(p) for p in four]} equal generate() alone, "
        f"{MAX_NEW_TOKENS} tokens each")
    del model
    model = load_model(torch, base, torch.bfloat16)
    firsts = []
    for prompt, got in zip(prompts, bf16_tokens):
        want, _ = generate(model, torch.tensor([prompt]), decode)
        new_got, new_want = got[len(prompt):], want[0, len(prompt):].tolist()
        firsts.append(next((j for j, (a, b) in enumerate(
            zip(new_got, new_want)) if a != b), None))
    log(f"bf16 engine against bf16 generate() alone, first differing new "
        f"token per prompt (None = identical; information only): {firsts}")
    return firsts


def engine_round(torch, base: Path):
    """Phase 6b, the fused round at 8 live slots (the burst's prompt
    lengths, pool and tables as the engine sizes them), called directly
    through the engine's Rounds program, captured and eager, on one
    state.  Checked: one captured round equals the eager decode_rounds
    on a copy of the same state (tokens, counts, steps_run, slot
    scalars), and one captured round runs under sync debug mode
    "error".  Information only: the captured and the eager round's time
    (host clock after a synchronize, median of 5, in turns), then under
    torch.profiler each one's device busy share, and the share of the
    device time the paged-view gathers take (one gather timed alone by
    CUDA events, times the round's 2 x layers x steps gathers); last,
    one 64-token prefill chunk at offset 1024, captured and eager, timed
    the same way."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        _pool_with_scratch,
        decode_rounds,
        init_paged_state,
    )
    from kubeflow_tpu_torch.serving.programs import ChunkedPrefill, Rounds

    model = load_model(torch, base, torch.bfloat16)
    slots, bt, k = 8, 16, 8
    mb = -(-(engine_prefill_width() + MAX_NEW_TOKENS) // bt)
    nb = slots * mb

    def fresh():
        return init_paged_state(model.cfg, slots, nb, bt, device="cuda")

    state = fresh()
    tables = torch.full((slots, mb), nb, dtype=torch.int64, device="cuda")
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    progs = {"captured": Rounds(model, decode, state, tables, k, True),
             "eager": Rounds(model, decode, state, tables, k, False)}
    chunks = {"captured": ChunkedPrefill(model, decode, state, tables,
                                         CHUNK, True),
              "eager": ChunkedPrefill(model, decode, state, tables, CHUNK,
                                      False)}
    pool = torch.cuda.graph_pool_handle()
    t0 = time.perf_counter()
    with torch.inference_mode():       # on the fresh state, as the engine
        progs["captured"].capture(pool)
        chunks["captured"].capture(pool)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    tables.copy_(torch.arange(nb, device="cuda").view(slots, mb))
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device="cuda")
    live = {"lengths": lengths, "stop_len": lengths + MAX_NEW_TOKENS,
            "done": torch.zeros(slots, dtype=torch.bool, device="cuda"),
            "last_token": torch.randint(
                1, MODEL["vocab_size"], (slots,), dtype=torch.int32,
                device="cuda")}

    def reset():
        for name, value in live.items():
            state[name].copy_(value)

    def one_round(name):
        with torch.inference_mode():
            return progs[name].run(k)

    # Identity: the captured round against decode_rounds on a copy.
    reset()
    twin = fresh()
    for name, value in state.items():
        twin[name].copy_(value)
    with torch.inference_mode():
        twin, want_toks, want_counts, want_steps = decode_rounds(
            model, twin, decode, k, tables, k)
    toks, counts, steps = one_round("captured")
    torch.cuda.synchronize()
    if not (torch.equal(toks, want_toks) and torch.equal(counts, want_counts)
            and int(steps) == int(want_steps) == k
            and counts.tolist() == [k] * slots):
        fail(f"a captured round differs from decode_rounds: steps "
             f"{int(steps)} / {int(want_steps)}, counts {counts.tolist()} / "
             f"{want_counts.tolist()}")
    for name in ("lengths", "stop_len", "last_token", "done", "keys"):
        if not torch.equal(state[name], twin[name]):
            fail(f"a captured round's {name} differs from decode_rounds'")
    pool_err = max(float((state[n].float() - twin[n].float()).abs().max())
                   for n in ("cache_k", "cache_v"))
    del twin
    log(f"captured round equals decode_rounds on the same state: {k} "
        f"steps at {slots} slots, tokens, counts and slot scalars equal; "
        f"pool max |err| {pool_err:.3e}")

    def timed(name):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round(name)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in progs:
        timed(name)
    times = {name: [] for name in progs}
    for i in range(5):
        for name in (("captured", "eager") if i % 2 == 0
                     else ("eager", "captured")):
            times[name].append(timed(name))
    round_ms = {name: sorted(t)[2] * 1e3 for name, t in times.items()}
    reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one_round("captured")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    info = {"steps": k, "slots": slots, "capture_s": capture_s,
            "pool_max_abs_err": pool_err}
    pool = _pool_with_scratch(state["cache_k"])[0]
    gather_ms = time_ms(torch, lambda: pool[tables], 20)
    gathers = 2 * MODEL["n_layers"] * k
    info.update(gather_ms=gather_ms, gathers_per_round=gathers)
    for name in progs:
        reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_round(name)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        row = {"round_ms": round_ms[name], "profiled_ms": t_prof * 1e3}
        if busy_us == 0:
            log(f"{name} round: the profiler saw no device time; busy "
                "share and gather share not measured")
        else:
            kernels.sort(key=lambda e: e.self_device_time_total,
                         reverse=True)
            row.update(busy_ms=busy_us / 1e3,
                       busy_share=busy_us / (t_prof * 1e6),
                       gather_share=gather_ms * gathers / (busy_us / 1e3))
            log(f"{name} round under torch.profiler: wall "
                f"{t_prof * 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms "
                f"({row['busy_share']:.3f} of the profiled wall); "
                f"paged-view gather {gather_ms:.4f} ms x {gathers} = "
                f"{gather_ms * gathers:.2f} ms, {row['gather_share']:.3f} "
                f"of busy")
            for e in kernels[:6]:
                log(f"  {e.self_device_time_total / busy_us:.3f} of busy, "
                    f"{e.count} launches: {e.key[:100]}")
        info[name] = row
    # One prefill chunk of slot 0's prompt at offset 1024, in turns.
    segment = torch.ones(CHUNK, dtype=torch.int64).numpy()
    chunk_times = {name: [] for name in chunks}
    for i in range(6):
        for name in (("captured", "eager") if i % 2 == 0
                     else ("eager", "captured")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                chunks[name].run(segment, 1024, 1100, MAX_NEW_TOKENS, 0, 0)
            torch.cuda.synchronize()
            chunk_times[name].append(time.perf_counter() - t0)
    info["chunk_ms"] = {name: sorted(t[1:])[2] * 1e3
                        for name, t in chunk_times.items()}
    for prog in (progs["captured"], chunks["captured"]):
        prog.release()
    log(f"engine prefill chunk of {CHUNK} tokens at offset 1024: captured "
        f"{info['chunk_ms']['captured']:.2f} ms, eager "
        f"{info['chunk_ms']['eager']:.2f} ms (host clock after "
        f"synchronize, median of 5 after one warm-up, in turns)")
    log(f"engine fused round, {k} steps at {slots} live slots (lengths "
        f"{list(PROMPT_LENS)}): captured {round_ms['captured']:.2f} ms "
        f"({round_ms['captured'] / k:.2f} ms a step), eager "
        f"{round_ms['eager']:.2f} ms ({round_ms['eager'] / k:.2f} ms a "
        f"step), in turns, host clock after synchronize, median of 5; "
        f"capture {capture_s:.3f} s; one captured round under sync debug "
        f"mode 'error' ({card_line()})")
    return info


# -- phase 6c: speculation --------------------------------------------------

def spec_prompts(torch, seed: int):
    """Phase 6c's burst: for each length, a prompt tiling a random
    4-token pattern and a random prompt, in turns (8 prompts)."""
    rng = torch.Generator().manual_seed(seed)
    vocab = MODEL["vocab_size"]
    prompts = []
    for n in SPEC_LENS:
        pattern = torch.randint(1, vocab, (4,), generator=rng).tolist()
        prompts.append((pattern * (n // 4 + 1))[:n])
        prompts.append(torch.randint(1, vocab, (n,), generator=rng).tolist())
    return prompts


def stream_generate(port: int, body: dict):
    """POST :generate and read its NDJSON stream line by line; returns
    (the streamed tokens, seconds to the first token line, seconds to the
    done line), client clock."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/model/lm:generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            fail(f"POST :generate answered {resp.status}: {resp.read()!r}")
        tokens, ttft, done = [], None, None
        while True:
            line = resp.readline()
            if not line:
                break
            msg = json.loads(line)
            if "tokens" in msg:
                ttft = ttft if ttft is not None else time.perf_counter() - t0
                tokens += msg["tokens"]
            elif msg.get("done"):
                done = time.perf_counter() - t0
            elif "error" in msg:
                fail(f":generate streamed an error line: {msg}")
    finally:
        conn.close()
    if done is None or ttft is None:
        fail(":generate ended without a token or a done line")
    return tokens, ttft, done


def first_difference(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def top2_gap(torch, flash, model, tokens) -> float:
    """The gap between the two largest next-token logits after
    ``tokens`` (plain attention): how near a tie a differing argmax
    was."""
    with plain_kernels(flash), torch.inference_mode():
        logits = model(torch.tensor([tokens], device="cuda"))[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def engine_tokens(engine, prompts, extra=None):
    """Every prompt as its own concurrent submit; the token lists."""
    outs = [None] * len(prompts)

    def call(i):
        inputs = {"tokens": prompts[i], **(extra[i] if extra else {})}
        outs[i] = engine.submit(inputs)["tokens"][0].tolist()

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if None in outs:
        fail(f"a request to engine {engine._metric_name!r} did not "
             "complete")
    return outs


def check_identity(torch, flash, model, what, prompts, got, want):
    """Fatal token identity, with the top-2 logit gap where the tokens
    first differ."""
    for prompt, a, b in zip(prompts, got, want):
        j = first_difference(a, b)
        if j is not None or len(a) != len(b):
            gap = top2_gap(torch, flash, model, b[:j]) if j else None
            fail(f"{what}: a {len(prompt)}-token prompt's tokens differ at "
                 f"position {j} of {len(b)}; the reference's top-2 logit "
                 f"gap there is {gap}")


def serve_spec(torch, flash, base: Path):
    """Phase 6c over REST: the server with --speculative_tokens 4 at the
    JAX CLI's engine defaults (bf16 model, programs captured), a burst of
    8 prompts (4 tiled, 4 random); then, information only, the same burst
    through the same server with speculation off."""
    from kubeflow_tpu_torch.serving import main as serving_main
    from kubeflow_tpu_torch.serving.engine import _SPEC_RATE_MARGIN

    prompts = spec_prompts(torch, SEED + 3)
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
        "--device", "cuda",
        "--lm_buckets", BUCKETS, "--speculative_tokens", str(SPEC_TOKENS)])
    port = httpd.server_address[1]
    launches_before = dict(flash.launch_counts)
    try:
        engine = server._batchers["lm"]
        if engine.speculative_tokens != SPEC_TOKENS or not engine.cuda_graphs \
                or "Verify" not in engine.capture_info["programs"]:
            fail("the speculating engine did not capture its verify program")
        replies, latencies, t_burst = burst(port, prompts)
        SERVED["6c"] = [r["predictions"][0]["tokens"] for r in replies]
        stats = get(port, "/model/lm:stats")["batcher"]
        gate = {"verify_rate_ema": engine._rate_verify_ema,
                "step_rate_ema": engine._rate_step_ema}
        server.enable_batching("lm", serving_main.batcher_factory(
            micro_batch_size=0, batch_timeout_s=5e-3, lm_buckets=BUCKETS,
            decode_rounds=8))
        off_replies, off_lat, t_off = burst(port, prompts)
        off_stats = get(port, "/model/lm:stats")["batcher"]
    finally:
        serving_main.shutdown(server, httpd)
    if dict(flash.launch_counts) != launches_before:
        fail("the speculating engine launched a flash kernel")
    check_replies(prompts, replies, [], None)
    check_replies(prompts, off_replies, [], None)
    want_programs = {"chunked_prefill": 1, "step": 0, "verify": 1,
                     "decode_rounds": 1}
    if stats["spec_steps"] <= 0:
        fail(f"no verify call ran in the speculating burst: {stats}")
    if stats["compiled_programs"] != want_programs:
        fail(f"speculating engine compiled_programs "
             f"{stats['compiled_programs']}, the JAX engine reports "
             f"{want_programs} under these flags")
    gate_open = (gate["verify_rate_ema"] is not None
                 and gate["step_rate_ema"] is not None
                 and gate["verify_rate_ema"]
                 >= _SPEC_RATE_MARGIN * gate["step_rate_ema"])
    on_tokens = [r["predictions"][0]["tokens"] for r in replies]
    off_tokens = [r["predictions"][0]["tokens"] for r in off_replies]
    info = {
        "on": burst_info(prompts, latencies, t_burst, stats),
        "off": burst_info(prompts, off_lat, t_off, off_stats),
        "spec_steps": stats["spec_steps"],
        "spec_drafted": stats["spec_drafted"],
        "spec_accepted": stats["spec_accepted"],
        "spec_acceptance_rate": stats["spec_acceptance_rate"],
        "accepted_per_step": stats["accepted_per_step"],
        "fused_rounds": stats["fused_rounds"],
        "gate": dict(gate, open=gate_open),
        "bf16_on_off_first_difference": [
            first_difference(a, b) for a, b in zip(on_tokens, off_tokens)],
        "compiled_programs": stats["compiled_programs"],
    }
    log_burst("speculating engine (--speculative_tokens 4)", info["on"])
    log_burst("same server, speculation off", info["off"])
    log(f"speculation: {stats['spec_steps']} verify calls beside "
        f"{stats['fused_rounds']} fused rounds, drafted "
        f"{stats['spec_drafted']}, accepted {stats['spec_accepted']} "
        f"(rate {stats['spec_acceptance_rate']}, "
        f"{stats['accepted_per_step']} extra tokens a verify call); "
        f"throughput gate {'open' if gate_open else 'closed'} at the end "
        f"(verify {gate['verify_rate_ema']} / round "
        f"{gate['step_rate_ema']} delivered tokens/s EMA); bf16 on/off "
        f"first differing position per prompt "
        f"{info['bf16_on_off_first_difference']} (information only)")
    return info


def spec_identity(torch, flash, base: Path):
    """Phase 6c, token identity at float32 (TF32 off): the captured
    engine with speculation on and off, and generate() alone, on 4 of
    the burst's prompts (tiled and random in turns)."""
    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    prompts = spec_prompts(torch, SEED + 3)[:4]
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    model = load_model(torch, base, torch.float32)
    outs, stats = {}, {}
    for spec in (SPEC_TOKENS, 0):
        engine = DecodeEngine(model, decode, slots=8,
                              prefill_len=engine_prefill_width(),
                              decode_rounds=8, speculative_tokens=spec,
                              name=f"fp32-spec{spec}")
        try:
            outs[spec] = engine_tokens(engine, prompts)
            stats[spec] = engine.stats()
        finally:
            engine.close()
    with plain_kernels(flash):
        want = [generate(model, torch.tensor([p]), decode)[0][0].tolist()
                for p in prompts]
    check_identity(torch, flash, model, "float32 engine, speculation on",
                   prompts, outs[SPEC_TOKENS], want)
    check_identity(torch, flash, model, "float32 engine, speculation off",
                   prompts, outs[0], want)
    on = stats[SPEC_TOKENS]
    log(f"float32 token identity: the engine with speculation on "
        f"({on['spec_steps']} verify calls, {on['spec_accepted']} of "
        f"{on['spec_drafted']} drafts accepted) and off equal generate() "
        f"alone on {len(prompts)} prompts {[len(p) for p in prompts]}, "
        f"{MAX_NEW_TOKENS} tokens each")
    del model
    return {"verify_calls": on["spec_steps"],
            "accepted": on["spec_accepted"], "drafted": on["spec_drafted"]}


def verify_call(torch, base: Path):
    """Phase 6c, the verify program at 8 live slots (the burst's lengths,
    pool and tables as the engine sizes them, the pool filled with
    random k/v): one captured call against the eager verify_step on a
    copy of the same state (tokens, emit, lengths, last_token and done
    equal, the pool within 1e-6), one captured call under sync debug
    mode "error"; then, information only, the captured verify call's
    time beside a captured fused round of 8 steps on the same state."""
    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        init_paged_state,
        verify_step,
    )
    from kubeflow_tpu_torch.serving.programs import Rounds, Verify

    model = load_model(torch, base, torch.bfloat16)
    slots, bt, k = 8, 16, 8
    mb = -(-(engine_prefill_width() + MAX_NEW_TOKENS) // bt)
    nb = slots * mb
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    state = init_paged_state(model.cfg, slots, nb, bt, device="cuda")
    tables = torch.full((slots, mb), nb, dtype=torch.int64, device="cuda")
    verify = Verify(model, decode, state, tables, SPEC_TOKENS, True)
    rounds = Rounds(model, decode, state, tables, k, True)
    pool = torch.cuda.graph_pool_handle()
    with torch.inference_mode():       # on the fresh state, as the engine
        verify.capture(pool)
        rounds.capture(pool)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for name in ("cache_k", "cache_v"):
        state[name].copy_(0.5 * torch.randn(
            state[name].shape, generator=gen, device="cuda"))
    tables.copy_(torch.arange(nb, device="cuda").view(slots, mb))
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device="cuda")
    live = {"lengths": lengths, "stop_len": lengths + MAX_NEW_TOKENS,
            "done": torch.zeros(slots, dtype=torch.bool, device="cuda"),
            "last_token": torch.randint(
                1, MODEL["vocab_size"], (slots,), dtype=torch.int32,
                device="cuda", generator=gen)}
    live["stop_len"][1] = PROMPT_LENS[1] + 1      # one token of budget
    live["done"][6] = True                        # a retired slot
    draft = torch.randint(1, MODEL["vocab_size"], (slots, SPEC_TOKENS),
                          dtype=torch.int32, generator=torch.Generator()
                          .manual_seed(SEED + 5)).numpy()
    draft_len = [4, 4, 3, 2, 4, 0, 4, 1]

    def reset():
        for name, value in live.items():
            state[name].copy_(value)

    def eager(draft):
        twin = init_paged_state(model.cfg, slots, nb, bt, device="cuda")
        for name, value in state.items():
            twin[name].copy_(value)
        with torch.inference_mode():
            return verify_step(model, twin, decode, SPEC_TOKENS,
                               torch.from_numpy(draft),
                               torch.tensor(draft_len), tables)

    reset()
    # Slot 0 drafts its window's own greedy targets, one position at a
    # time: a fully accepted window beside the random (rejected) ones.
    for j in range(SPEC_TOKENS):
        draft[0, j] = int(eager(draft)[1][0, j])
    twin, want_toks, want_emit = eager(draft)
    with torch.inference_mode():
        toks, emit = verify.run(draft, draft_len)
    torch.cuda.synchronize()
    if not (torch.equal(toks, want_toks) and torch.equal(emit, want_emit)):
        fail(f"a captured verify call differs from verify_step: emit "
             f"{emit.tolist()} / {want_emit.tolist()}")
    for name in ("lengths", "last_token", "done", "stop_len"):
        if not torch.equal(state[name], twin[name]):
            fail(f"a captured verify call's {name} differs from "
                 "verify_step's")
    pool_err = max(float((state[n].float() - twin[n].float()).abs().max())
                   for n in ("cache_k", "cache_v"))
    if pool_err > 1e-6:
        fail(f"a captured verify call's pool is {pool_err:.3e} from "
             "verify_step's")
    if int(emit[0]) != SPEC_TOKENS + 1 or int(emit[6]) != 0 \
            or int(emit[1]) != 1 or not bool(state["done"][1]):
        fail(f"verify emit {emit.tolist()}: the accepted window, the "
             "retired slot or the slot with one token of budget is wrong")
    del twin
    reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            verify.run(draft, draft_len)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    def timed(fn):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    calls = {"verify": lambda: verify.run(draft, draft_len),
             "round": lambda: rounds.run(k)}
    for fn in calls.values():
        timed(fn)
    times = {name: [] for name in calls}
    for i in range(5):
        for name in (("verify", "round") if i % 2 == 0
                     else ("round", "verify")):
            times[name].append(timed(calls[name]))
    ms = {name: sorted(t)[2] * 1e3 for name, t in times.items()}

    def one_verify():
        reset()
        with torch.inference_mode():
            verify.run(draft, draft_len)
        torch.cuda.synchronize()

    profiled = profile_busy(torch, one_verify,
                            f"captured verify call at {slots} live slots",
                            top=6)
    for prog in (verify, rounds):
        prog.release()
    log(f"captured verify call at {slots} live slots (window "
        f"{SPEC_TOKENS + 1}) equals verify_step on the same state: tokens, "
        f"emit {emit.tolist()}, lengths, last_token and done equal, pool "
        f"max |err| {pool_err:.3e}; one call under sync debug mode "
        f"'error'.  Verify call {ms['verify']:.2f} ms against a fused round "
        f"of {k} steps {ms['round']:.2f} ms ({ms['round'] / k:.2f} ms a "
        f"step), captured, host clock after synchronize, median of 5 in "
        f"turns ({card_line()})")
    return {"verify_ms": ms["verify"], "round_ms": ms["round"],
            "round_steps": k, "pool_max_abs_err": pool_err,
            "emit": emit.tolist(), "profile": profiled}


# -- phase 6d: the disaggregated tiers --------------------------------------

def serve_tiers(torch, flash, base: Path):
    """Phase 6d over REST: a --role prefill and a --role decode server on
    the same export (bf16, engine defaults).  The decode server first
    streams a unified :generate of a 1024-token prompt (its TTFT is the
    yardstick); the prefill server's :prefill of the same prompt must
    cover 1008 tokens in 49,545,216 bytes of bf16 pages; the decode
    server's :generate with that payload must stream the tokens its
    engine returns for the same payload unstreamed, and the pages it
    imported, gathered back, must be the exported bytes; a 16-token
    prompt exports nothing.  No flash kernel launches."""
    from kubeflow_tpu_torch.models.generate import gather_kv_pages
    from kubeflow_tpu_torch.serving import http as serving_http
    from kubeflow_tpu_torch.serving import main as serving_main

    rng = torch.Generator().manual_seed(SEED + 6)
    vocab = MODEL["vocab_size"]
    prompt = torch.randint(1, vocab, (HANDOFF_LEN,), generator=rng).tolist()
    short = torch.randint(1, vocab, (16,), generator=rng).tolist()
    # A second prompt of the same length, new to both servers: the
    # engines' own times for an export and an import, without REST.
    fresh = torch.randint(1, vocab, (HANDOFF_LEN,), generator=rng).tolist()
    servers = {}
    launches_before = dict(flash.launch_counts)
    try:
        for role in ("prefill", "decode"):
            servers[role] = serving_main.start([
                "--model_name", "lm", "--model_base_path", str(base),
                "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
                "--device", "cuda",
                "--lm_buckets", BUCKETS, "--role", role])
        ports = {role: httpd.server_address[1]
                 for role, (_, httpd) in servers.items()}
        for role, port in ports.items():
            ready = get(port, "/readyz")
            if ready.get("role") != role:
                fail(f"/readyz of the {role} server shows {ready}")
        unified, ttft_unified, t_unified = stream_generate(
            ports["decode"], {"tokens": prompt})
        t0 = time.perf_counter()
        answer = post(ports["prefill"], {"tokens": prompt},
                      "/model/lm:prefill")
        t_prefill = time.perf_counter() - t0
        wire = answer["kv_handoff"]
        if wire is None or answer["tokens_covered"] != HANDOFF_LEN - 16:
            fail(f":prefill of {HANDOFF_LEN} tokens covered "
                 f"{answer['tokens_covered']}, expected {HANDOFF_LEN - 16}")
        t0 = time.perf_counter()
        payload = serving_http.decode_kv_handoff(wire)
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = serving_http.encode_kv_handoff(
            dict(payload, tokens_covered=answer["tokens_covered"]))
        t_encode = time.perf_counter() - t0
        if again != wire:
            fail("the handoff re-encoded is not the wire form it came in")
        nbytes = sum(payload[s].numel() * payload[s].element_size()
                     for s in ("k", "v"))
        if nbytes != HANDOFF_BYTES or payload["k"].dtype != torch.bfloat16:
            fail(f"the handoff payload holds {nbytes} bytes of "
                 f"{payload['k'].dtype}, expected {HANDOFF_BYTES} of bf16")
        streamed, ttft_tiered, t_tiered = stream_generate(
            ports["decode"], {"tokens": prompt, "kv_handoff": wire})
        SERVED["6d"] = (prompt, wire, streamed)
        engine = servers["decode"][0]._batchers["lm"]
        direct = engine.submit({"tokens": prompt, "kv_handoff": payload})[
            "tokens"][0].tolist()
        # The last request took slot 0 (every other slot idle); its table
        # row and pages stay until that slot's next admission.
        n = answer["tokens_covered"] // 16
        (pages_k, _), (pages_v, _) = gather_kv_pages(
            engine._state, engine._tables[0][:n])
        # The breakdown (information only): the body's JSON both ways,
        # and each engine's own export and import of the fresh prompt.
        body = {"tokens": prompt, "kv_handoff": wire}
        t0 = time.perf_counter()
        text = json.dumps(body)
        t_dumps = time.perf_counter() - t0
        t0 = time.perf_counter()
        json.loads(text)
        t_loads = time.perf_counter() - t0
        del text, body
        pre_engine = servers["prefill"][0]._batchers["lm"]
        t0 = time.perf_counter()
        fresh_out = pre_engine.prefill_export({"tokens": fresh})
        t_export = time.perf_counter() - t0
        timing = engine.submit({"tokens": fresh, "return_timing": True,
                                "kv_handoff": fresh_out["kv_handoff"]})
        short_answer = post(ports["prefill"], {"tokens": short},
                            "/model/lm:prefill")
        pre_stats = get(ports["prefill"], "/model/lm:stats")["batcher"]
        dec_stats = get(ports["decode"], "/model/lm:stats")["batcher"]
    finally:
        for server, httpd in servers.values():
            serving_main.shutdown(server, httpd)
    if dict(flash.launch_counts) != launches_before:
        fail("the tiered engines launched a flash kernel")
    if prompt + streamed != direct:
        fail("the decode tier's streamed tokens differ from its unstreamed "
             "reply to the same payload")
    if len(streamed) != MAX_NEW_TOKENS or not all(
            0 <= t < vocab for t in streamed):
        fail(f"the decode tier streamed {len(streamed)} tokens")
    if not (torch.equal(pages_k, payload["k"])
            and torch.equal(pages_v, payload["v"])):
        fail("the pages the decode tier imported are not the exported bytes")
    if short_answer["kv_handoff"] is not None:
        fail("a 16-token prompt exported a kv_handoff")
    if dec_stats["handoff_pages_in"] != 3 * n \
            or dec_stats["compiled_programs"].get("kv_import") != 1 \
            or pre_stats["handoff_pages_out"] != 2 * n:
        fail(f"handoff counters: out {pre_stats['handoff_pages_out']}, in "
             f"{dec_stats['handoff_pages_in']}, programs "
             f"{dec_stats['compiled_programs']}")
    info = {
        "payload_bytes": nbytes, "wire_bytes": len(json.dumps(wire)),
        "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
        "encode_ms": t_encode * 1e3,
        "json_dumps_ms": t_dumps * 1e3, "json_loads_ms": t_loads * 1e3,
        "engine_export_ms": t_export * 1e3,
        "engine_import_ttft_ms": timing["ttft_s"] * 1e3,
        "ttft_unified_s": ttft_unified, "ttft_tiered_s": ttft_tiered,
        "latency_unified_s": t_unified, "latency_tiered_s": t_tiered,
        "bf16_tiered_first_difference": first_difference(
            streamed, unified[:len(streamed)]),
    }
    log(f"tiers: :prefill of {HANDOFF_LEN} tokens in {t_prefill * 1e3:.1f} "
        f"ms covers {answer['tokens_covered']} in {nbytes} bytes of bf16 "
        f"pages ({info['wire_bytes']} bytes of JSON); decode "
        f"{t_decode * 1e3:.1f} ms, encode {t_encode * 1e3:.1f} ms; decode "
        f"tier TTFT {ttft_tiered * 1e3:.1f} ms against the unified "
        f"engine's {ttft_unified * 1e3:.1f} ms, latency "
        f"{t_tiered:.3f} / {t_unified:.3f} s (client clock); imported "
        f"pages equal the exported bytes; bf16 tiered against unified, "
        f"first differing new token {info['bf16_tiered_first_difference']}"
        f" (information only; {card_line()})")
    log(f"tiers, breakdown (information only): the :generate body's JSON "
        f"{t_dumps * 1e3:.1f} ms to write and {t_loads * 1e3:.1f} ms to "
        f"parse; without REST the prefill engine exports a fresh "
        f"{HANDOFF_LEN}-token prompt in {t_export * 1e3:.1f} ms (prefill "
        f"and the page gather) and the decode engine's TTFT on it, the "
        f"import and one chunk, is {timing['ttft_s'] * 1e3:.1f} ms")
    return info


def tier_identity(torch, flash, base: Path):
    """Phase 6d, token identity at float32 (TF32 off): a prefill-tier
    engine exports two prompts' pages and a decode-tier engine imports
    them; its tokens must equal its own unified run of each prompt
    (served first, before any page was imported) and generate()."""
    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    rng = torch.Generator().manual_seed(SEED + 7)
    prompts = [torch.randint(1, MODEL["vocab_size"], (n,),
                             generator=rng).tolist() for n in (300, 170)]
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    model = load_model(torch, base, torch.float32)
    engines = [DecodeEngine(model, decode, slots=8, prefill_len=512,
                            decode_rounds=8, name=f"fp32-{role}")
               for role in ("prefill", "decode")]
    pre, dec = engines
    try:
        unified = engine_tokens(dec, prompts)
        payloads = [pre.prefill_export({"tokens": p})["kv_handoff"]
                    for p in prompts]
        tiered = engine_tokens(dec, prompts,
                               [{"kv_handoff": ho} for ho in payloads])
        pages_in = dec.stats()["handoff_pages_in"]
    finally:
        for engine in engines:
            engine.close()
    with plain_kernels(flash):
        want = [generate(model, torch.tensor([p]), decode)[0][0].tolist()
                for p in prompts]
    check_identity(torch, flash, model, "float32 decode tier", prompts,
                   tiered, unified)
    check_identity(torch, flash, model, "float32 unified engine", prompts,
                   unified, want)
    covered = [ho["tokens_covered"] for ho in payloads]
    log(f"float32 token identity: the decode tier ({pages_in} pages "
        f"imported, coverage {covered}) equals the unified engine and "
        f"generate() on {len(prompts)} prompts {[len(p) for p in prompts]}")
    del model
    return {"covered": covered, "pages_in": pages_in}


# -- phase 6e: int8 weights and the int8 KV pool ---------------------------

def export_int8(base: Path, int8_base: Path) -> None:
    """The int8 serving export of the same weights: the params file linked
    and model.json naming ``quantize`` and ``kv_cache`` int8 (the JAX
    loader's keys)."""
    import os

    from kubeflow_tpu_torch.serving.export import (
        FORMAT,
        MODEL_FILE,
        PARAMS_FILE,
    )

    vdir = int8_base / "1"
    vdir.mkdir(parents=True)
    os.link(base / "1" / PARAMS_FILE, vdir / PARAMS_FILE)
    (vdir / MODEL_FILE).write_text(json.dumps({
        "format": FORMAT, "loader": JAX_LOADER,
        "config": dict(INT8_CONFIG, model=MODEL,
                       max_new_tokens=MAX_NEW_TOKENS),
        "signature": {"inputs": ["tokens"], "outputs": ["tokens"]}}))


def int8_model(torch, base: Path, dtype):
    """The exported weights quantized as the loader stages them (int8
    matmul weights on the card), computing in ``dtype``, and its int8
    decode config."""
    from kubeflow_tpu_torch.serving.export import PARAMS_FILE, msgpack_restore
    from kubeflow_tpu_torch.serving.loaders import lm_generate

    tree = msgpack_restore((base / "1" / PARAMS_FILE).read_bytes())
    name = str(dtype).replace("torch.", "")
    predict = lm_generate(dict(
        INT8_CONFIG, model=dict(MODEL, dtype=name),
        max_new_tokens=MAX_NEW_TOKENS), device="cuda")(tree)
    return predict.engine_spec["model"], predict.engine_spec["decode"]


def weight_bytes(model) -> int:
    """Bytes of the model's weights on the card: its parameters and its
    int8 QTensors (values and scales)."""
    from kubeflow_tpu_torch.ops.quantize import QTensor

    total = sum(p.numel() * p.element_size() for p in model.parameters())
    for module in model.modules():
        total += sum(v.nbytes for v in vars(module).values()
                     if isinstance(v, QTensor))
    return total


def page_bytes(state) -> int:
    """Bytes of one pool page, both sides, values and scales."""
    from kubeflow_tpu_torch.ops.quantize import QTensor

    total = 0
    for name in ("cache_k", "cache_v"):
        pool = state[name]
        parts = (pool.values, pool.scale) if isinstance(pool, QTensor) \
            else (pool,)
        total += sum(t[:, 0].numel() * t.element_size() for t in parts)
    return total


def serve_int8(torch, flash, base: Path, int8_base: Path):
    """Phase 6e over REST: the int8 export (``quantize`` and ``kv_cache``
    int8) served through the captured engine (a burst of four prompts,
    its weights int8 QTensors on the card, its pool int8 with float32
    scales), then through the static batcher (``generate()`` over an int8
    cache); neither may launch a flash kernel."""
    from kubeflow_tpu_torch.ops.quantize import QTensor
    from kubeflow_tpu_torch.serving import main as serving_main

    prompts = [torch.randint(1, MODEL["vocab_size"], (n,),
                             generator=torch.Generator().manual_seed(
                                 SEED + 9 + n)).tolist()
               for n in PROMPT_LENS[:4]]
    launches_before = dict(flash.launch_counts)
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(int8_base),
        "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
        "--device", "cuda",
        "--lm_buckets", BUCKETS])
    port = httpd.server_address[1]
    try:
        engine = server._batchers["lm"]
        if engine.capture_info is None:
            fail("the int8 engine did not capture its programs")
        model = engine.model
        if not isinstance(model.layers[0].attn.wq, QTensor) \
                or model.embed.values.dtype != torch.int8:
            fail("the int8 export's weights are not int8 on the card")
        if not isinstance(engine._state["cache_k"], QTensor):
            fail("the int8 export's pool is not int8")
        served_bytes = weight_bytes(model)
        pool_page = page_bytes(engine._state)
        replies, latencies, t_burst = burst(port, prompts)
        SERVED["6e"] = (prompts, [r["predictions"][0]["tokens"]
                                  for r in replies])
        stats = get(port, "/model/lm:stats")["batcher"]
        server.enable_batching("lm", serving_main.batcher_factory(
            micro_batch_size=MICRO_BATCH, batch_timeout_s=5e-3,
            lm_buckets=BUCKETS, lm_engine=False))
        static_replies, static_lat, t_static = burst(port, prompts)
    finally:
        serving_main.shutdown(server, httpd)
    launches = {k: flash.launch_counts[k] - launches_before.get(k, 0)
                for k in flash.launch_counts}
    if any(launches.values()):
        fail(f"the int8 path launched flash kernels: {launches}")
    check_replies(prompts, replies, [], None)
    check_replies(prompts, static_replies, [], None)
    if stats["compiled_programs"] != {"chunked_prefill": 1, "step": 0,
                                      "verify": 0, "decode_rounds": 1}:
        fail(f"int8 engine compiled_programs {stats['compiled_programs']}")
    if pool_page != INT8_PAGE_BYTES:
        fail(f"an int8 pool page holds {pool_page} bytes, expected "
             f"{INT8_PAGE_BYTES}")
    info = {"engine": burst_info(prompts, latencies, t_burst, stats),
            "static": burst_info(prompts, static_lat, t_static, {}),
            "weight_bytes": served_bytes, "page_bytes": pool_page,
            "flash_launches": launches}
    log_burst("int8 engine", info["engine"])
    log_burst("int8 static batcher", info["static"])
    return info


def int8_identity(torch, flash, base: Path):
    """Phase 6e, token identity at float32 (TF32 off): the engine with
    int8 weights over an int8 pool (programs captured) gives the port's
    int8 generate()'s greedy tokens on four prompts."""
    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    model, decode = int8_model(torch, base, torch.float32)
    rng = torch.Generator().manual_seed(SEED + 10)
    prompts = [torch.randint(1, MODEL["vocab_size"], (n,),
                             generator=rng).tolist() for n in INT8_LENS]
    launches_before = dict(flash.launch_counts)
    engine = DecodeEngine(model, decode, slots=8, prefill_len=512,
                          decode_rounds=8, name="int8-fp32")
    try:
        got = engine_tokens(engine, prompts)
    finally:
        engine.close()
    want = [generate(model, torch.tensor([p]), decode)[0][0].tolist()
            for p in prompts]
    if dict(flash.launch_counts) != launches_before:
        fail("the float32 int8 engine or generate() launched a flash kernel")
    check_identity(torch, flash, model, "float32 int8 engine", prompts, got,
                   want)
    log(f"float32 token identity: the int8 engine (int8 weights and pool) "
        f"equals int8 generate() on {len(prompts)} prompts "
        f"{list(INT8_LENS)}")
    del model


def int8_numbers(torch, flash, base: Path, bf16_round_ms):
    """Phase 6e in bf16: the first-step logits of int8 weights over an int8
    cache against the unquantized model's (cosine above INT8_COSINE, the
    bound of the reference's own tests); then, information only, the
    weight bytes of both on the card, a captured fused round of 8 steps
    at 8 live slots and a captured verify call on an int8 state (host
    clock after synchronize, median of 5), the round's device busy time
    under torch.profiler and the share of it the int8 -> bf16 weight
    converts take (one decode step's converts timed alone by CUDA events,
    times the steps)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        generate,
        init_paged_state,
    )
    from kubeflow_tpu_torch.ops.quantize import QTensor
    from kubeflow_tpu_torch.serving.programs import Rounds, Verify

    model_q, decode_q = int8_model(torch, base, torch.bfloat16)
    model = load_model(torch, base, torch.bfloat16)
    rng = torch.Generator().manual_seed(SEED + 11)
    prompt = torch.randint(1, MODEL["vocab_size"], (2, 512), generator=rng)
    launches_before = dict(flash.launch_counts)
    _, logits_q = generate(model_q, prompt, DecodeConfig(
        max_new_tokens=1, kv_cache_dtype="int8"))
    if dict(flash.launch_counts) != launches_before:
        fail("int8 generate() launched a flash kernel")
    _, logits = generate(model, prompt, DecodeConfig(max_new_tokens=1))
    a, b = logits_q.double().flatten(), logits.double().flatten()
    cosine = float(a @ b / (a.norm() * b.norm()))
    if not cosine > INT8_COSINE:
        fail(f"bf16 int8 logits against the unquantized model: cosine "
             f"{cosine:.6f}, bound {INT8_COSINE}")
    bytes_q, bytes_bf16 = weight_bytes(model_q), weight_bytes(model)
    del model
    slots, bt, k = 8, 16, 8
    mb = -(-(engine_prefill_width() + MAX_NEW_TOKENS) // bt)
    nb = slots * mb
    state = init_paged_state(model_q.cfg, slots, nb, bt, "int8",
                             device="cuda")
    tables = torch.full((slots, mb), nb, dtype=torch.int64, device="cuda")
    rounds = Rounds(model_q, decode_q, state, tables, k, True)
    verify = Verify(model_q, decode_q, state, tables, SPEC_TOKENS, True)
    pool = torch.cuda.graph_pool_handle()
    with torch.inference_mode():
        rounds.capture(pool)
        verify.capture(pool)
    tables.copy_(torch.arange(nb, device="cuda").view(slots, mb))
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device="cuda")

    def reset():
        state["lengths"].copy_(lengths)
        state["stop_len"].copy_(lengths + MAX_NEW_TOKENS)
        state["done"].zero_()
        state["last_token"].fill_(7)

    draft = torch.randint(1, MODEL["vocab_size"], (slots, SPEC_TOKENS),
                          generator=rng).int().numpy()
    draft_len = torch.full((slots,), SPEC_TOKENS, dtype=torch.int32).numpy()

    def timed(fn):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    calls = {"round": lambda: rounds.run(k),
             "verify": lambda: verify.run(draft, draft_len)}
    times = {name: [] for name in calls}
    for i in range(6):
        for name in (("round", "verify") if i % 2 == 0
                     else ("verify", "round")):
            times[name].append(timed(calls[name]))
    ms = {name: sorted(t[1:])[2] * 1e3 for name, t in times.items()}
    reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            rounds.run(k)
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    weights = [v for m in model_q.modules() for v in vars(m).values()
               if isinstance(v, QTensor)]
    # One decode step converts each int8 weight once: wq, both wkv sides,
    # wo, both wi sides and the MLP's wo per layer (each QTensor here
    # whole), and the tied embedding for the logits.
    convert_ms = time_ms(torch, lambda: [w.values.to(torch.bfloat16)
                                         for w in weights], 20)
    rounds.release()
    verify.release()
    info = {"cosine": cosine, "weight_bytes_int8": bytes_q,
            "weight_bytes_bf16": bytes_bf16,
            "page_bytes_int8": INT8_PAGE_BYTES,
            "page_bytes_bf16": BF16_PAGE_BYTES,
            "round_ms": ms["round"], "verify_ms": ms["verify"],
            "bf16_round_ms": bf16_round_ms,
            "convert_ms_per_step": convert_ms}
    if busy_us:
        info.update(round_busy_ms=busy_us / 1e3,
                    convert_share=convert_ms * k / (busy_us / 1e3))
    log(f"int8 against bf16 (information only; {card_line()}): weights "
        f"{bytes_q} / {bytes_bf16} bytes on the card "
        f"({bytes_q / bytes_bf16:.3f}x); pool page {INT8_PAGE_BYTES} / "
        f"{BF16_PAGE_BYTES} bytes ({INT8_PAGE_BYTES / BF16_PAGE_BYTES:.3f}"
        f"x); captured round of {k} steps at {slots} live slots "
        f"{ms['round']:.2f} ms against the bf16 round's {bf16_round_ms:.2f}"
        f" ms (phase 6b, this call); captured verify call, window "
        f"{SPEC_TOKENS + 1}, {ms['verify']:.2f} ms; first-step logits "
        f"cosine {cosine:.6f} against the unquantized model")
    if busy_us:
        log(f"int8 round under torch.profiler: device busy "
            f"{busy_us / 1e3:.2f} ms; one step's int8 -> bf16 weight "
            f"converts {convert_ms:.4f} ms (CUDA events), "
            f"{info['convert_share']:.3f} of the round's busy time")
    else:
        log("int8 round: the profiler saw no device time; the converts' "
            "share is not measured")
    return info


# -- phase 6f: the host spill tier, session park and :fetch_kv ------------

def spill_tier(torch, flash, base: Path, int8_base: Path):
    """Phase 6f over REST.  Server A serves the bf16 export with
    ``--kv_pool_blocks 128 --host_spill_blocks 1024``; control server C
    with the default pool (1024 pages, nothing spills).  Eight sessions
    of 512-1024 prompt tokens park (``park_kv``) on both: their pages
    exceed A's pool, so A must spill, never shed and never
    destroy-evict; each second turn on A must equal C's.  Then a
    failover: A's ``:fetch_kv`` of a session's prompt plus its first
    delivered tokens, resumed with ``resume_tokens`` on a fresh server
    B over :generate, must give A's tokens; likewise between two int8
    servers.  Information only: the pages spilled out and in, the
    spill-out and re-import ms a page (host clock), the resume TTFT on A
    against the cold prefill TTFT of the same context on B (client
    clock, :generate), and the fetched payload's bytes and its decode
    and encode ms.  No flash kernel launches."""
    from kubeflow_tpu_torch.serving import http as serving_http
    from kubeflow_tpu_torch.serving import main as serving_main

    rng = torch.Generator().manual_seed(SEED + 12)
    vocab = MODEL["vocab_size"]
    prompts = [torch.randint(1, vocab, (n,), generator=rng).tolist()
               for n in SPILL_LENS]
    extra = [torch.randint(1, vocab, (TURN2_NEW,), generator=rng).tolist()
             for _ in SPILL_LENS]

    def start(export, *flags):
        return serving_main.start([
            "--model_name", "lm", "--model_base_path", str(export),
            "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
            "--device", "cuda",
            "--lm_buckets", BUCKETS, *flags])

    def tokens_of(reply):
        return reply["predictions"][0]["tokens"]

    launches_before = dict(flash.launch_counts)
    servers = {}
    try:
        servers["a"] = start(base, "--kv_pool_blocks", str(SPILL_POOL),
                             "--host_spill_blocks", str(SPILL_HOST))
        servers["c"] = start(base)
        servers["b"] = start(base)
        port = {k: httpd.server_address[1]
                for k, (_, httpd) in servers.items()}
        turn1 = {}
        for name in ("a", "c"):
            turn1[name] = [tokens_of(post(port[name], {"instances": [
                {"tokens": p, "park_kv": True}]})) for p in prompts]
        parked = get(port["a"], "/model/lm:stats")["batcher"]
        engine_a = servers["a"][0]._batchers["lm"]
        mgr_parked = engine_a._mgr.stats()
        turn2 = {"a": [], "c": []}
        ttft_resume = None
        for i, t1 in enumerate(turn1["a"]):
            ctx = t1 + extra[i]
            if i == 0:
                streamed, ttft_resume, _ = stream_generate(
                    port["a"], {"tokens": ctx})
                turn2["a"].append(ctx + streamed)
            else:
                turn2["a"].append(tokens_of(post(
                    port["a"], {"instances": [{"tokens": ctx}]})))
            turn2["c"].append(tokens_of(post(
                port["c"], {"instances": [{"tokens": ctx}]})))
        # The cold prefill of session 0's second-turn context on fresh B.
        _, ttft_cold, _ = stream_generate(
            port["b"], {"tokens": turn1["a"][0] + extra[0]})
        resumed = get(port["a"], "/model/lm:stats")["batcher"]
        mgr_resumed = engine_a._mgr.stats()
        timing = dict(engine_a.spill_timing)
        # Failover of session 1 after FETCH_DELIVERED tokens: A's pages
        # over :fetch_kv, resumed on B.
        p = prompts[1]
        delivered = turn1["a"][1][len(p):len(p) + FETCH_DELIVERED]
        t0 = time.perf_counter()
        fetched = post(port["a"], {"tokens": p + delivered},
                       "/model/lm:fetch_kv")
        t_fetch = time.perf_counter() - t0
        wire = fetched["kv_handoff"]
        if wire is None:
            fail(f":fetch_kv of a parked session missed: {fetched}")
        t0 = time.perf_counter()
        payload = serving_http.decode_kv_handoff(wire)
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = serving_http.encode_kv_handoff(
            dict(payload, tokens_covered=fetched["tokens_covered"]))
        t_encode = time.perf_counter() - t0
        if again != wire:
            fail("the fetched payload re-encoded is not its wire form")
        nbytes = sum(payload[s].numel() * payload[s].element_size()
                     for s in ("k", "v"))
        SERVED["6f"] = {"prompts": prompts, "extra": extra,
                        "turn1": turn1["a"], "turn2": turn2["a"],
                        "fetch_tokens": p + delivered,
                        "fetch_covered": fetched["tokens_covered"],
                        "fetch": (payload["k"], payload["v"])}
        streamed, _, _ = stream_generate(port["b"], {
            "tokens": p, "resume_tokens": delivered, "kv_handoff": wire})
        fetch_resumed = p + delivered + streamed
        fetch_b = get(port["b"], "/model/lm:stats")["batcher"]
    finally:
        for server, httpd in servers.values():
            serving_main.shutdown(server, httpd)
    # The same failover between two int8 servers.
    servers = {}
    try:
        servers["a8"] = start(int8_base, "--host_spill_blocks",
                              str(SPILL_HOST))
        servers["b8"] = start(int8_base)
        port8 = {k: httpd.server_address[1]
                 for k, (_, httpd) in servers.items()}
        p8 = prompts[2]
        want8 = tokens_of(post(port8["a8"], {"instances": [
            {"tokens": p8, "park_kv": True}]}))
        delivered8 = want8[len(p8):len(p8) + FETCH_DELIVERED]
        fetched8 = post(port8["a8"], {"tokens": p8 + delivered8},
                        "/model/lm:fetch_kv")
        wire8 = fetched8["kv_handoff"]
        if wire8 is None or set(wire8["k"]) != {"values", "scale"} \
                or wire8["k"]["values"]["dtype"] != "int8":
            fail(f"the int8 :fetch_kv payload is not int8 values and "
                 f"scales: {None if wire8 is None else wire8['k'].keys()}")
        payload8 = serving_http.decode_kv_handoff(wire8)
        nbytes8 = sum(t.numel() * t.element_size() for s in ("k", "v")
                      for t in payload8[s].values())
        streamed8, _, _ = stream_generate(port8["b8"], {
            "tokens": p8, "resume_tokens": delivered8, "kv_handoff": wire8})
    finally:
        for server, httpd in servers.values():
            serving_main.shutdown(server, httpd)
    if dict(flash.launch_counts) != launches_before:
        fail("the spill tier's engines launched a flash kernel")
    if turn1["a"] != turn1["c"]:
        fail("a parked first turn differs between the spilling server and "
             "the control")
    for i, (got, want) in enumerate(zip(turn2["a"], turn2["c"])):
        if got != want:
            fail(f"session {i}'s second turn on the spilling server differs "
                 f"from the control at new token "
                 f"{first_difference(got, want)}")
    if parked["kv_spill_pages_out"] <= 0 or resumed["kv_spill_pages_in"] \
            <= 0 or resumed["shed"] or mgr_resumed["evictions"] \
            or mgr_resumed["block_evictions"] \
            or parked["parked_sessions"] != len(prompts):
        fail(f"spill tier: pages out {parked['kv_spill_pages_out']}, in "
             f"{resumed['kv_spill_pages_in']}, shed {resumed['shed']}, "
             f"evictions {mgr_resumed['evictions']} records / "
             f"{mgr_resumed['block_evictions']} blocks, parked "
             f"{parked['parked_sessions']}")
    if fetch_resumed != turn1["a"][1] or fetch_b["handoff_pages_in"] < 1:
        fail(f"the bf16 fetch-resume on B differs from A's tokens at new "
             f"token {first_difference(fetch_resumed, turn1['a'][1])}")
    if p8 + delivered8 + streamed8 != want8:
        fail("the int8 fetch-resume differs from the parking server's "
             "tokens")
    info = {
        "sessions": len(prompts),
        "parked_pages": sum((len(t) - 1) // 16 for t in turn1["a"]),
        "pages_out": resumed["kv_spill_pages_out"],
        "pages_in": resumed["kv_spill_pages_in"],
        "host_tier_used": resumed["host_tier_used"],
        "prefix_hits": resumed["prefix_hits"],
        "spill_out_ms_per_page": timing["out_s"] * 1e3
        / max(1, timing["out_pages"]),
        "spill_in_ms_per_page": timing["in_s"] * 1e3
        / max(1, timing["in_pages"]),
        "timed_pages": {"out": timing["out_pages"],
                        "in": timing["in_pages"]},
        "ttft_resume_ms": ttft_resume * 1e3,
        "ttft_cold_ms": ttft_cold * 1e3,
        "fetch_bytes": nbytes, "fetch_wire_bytes": len(json.dumps(wire)),
        "fetch_ms": t_fetch * 1e3, "decode_ms": t_decode * 1e3,
        "encode_ms": t_encode * 1e3,
        "fetch_covered": fetched["tokens_covered"],
        "fetch_bytes_int8": nbytes8,
        "fetch_covered_int8": fetched8["tokens_covered"],
    }
    log(f"spill tier: {len(prompts)} sessions parked ({info['parked_pages']}"
        f" full pages) on a {SPILL_POOL}-page pool with a {SPILL_HOST}-page "
        f"host tier: {info['pages_out']} pages spilled out, "
        f"{info['pages_in']} re-imported, shed 0, evictions 0; every second "
        f"turn equals the control's; spill-out "
        f"{info['spill_out_ms_per_page']:.3f} ms a page, re-import "
        f"{info['spill_in_ms_per_page']:.3f} ms a page (host clock, "
        f"{timing['out_pages']} and {timing['in_pages']} pages timed)")
    log(f"spill tier, resume TTFT of a {len(turn1['a'][0] + extra[0])}-token"
        f" second turn {info['ttft_resume_ms']:.1f} ms against its cold "
        f"prefill's {info['ttft_cold_ms']:.1f} ms (client clock, "
        f":generate); :fetch_kv of {fetched['tokens_covered']} tokens in "
        f"{info['fetch_ms']:.1f} ms, {nbytes} bytes of bf16 pages "
        f"({info['fetch_wire_bytes']} of JSON), decode "
        f"{info['decode_ms']:.1f} ms, encode {info['encode_ms']:.1f} ms; "
        f"the resumed failover equals the parking server's tokens at bf16 "
        f"and at int8 ({nbytes8} bytes of int8 pages and scales for "
        f"{fetched8['tokens_covered']} tokens) (information only; "
        f"{card_line()})")
    return info


# -- phase 6g: adapter-array serving ----------------------------------------

def write_adapters(torch, adir: Path) -> dict:
    """The three seeded adapters of the phase, written with the port's
    ``save_adapter`` (the JAX package's artifact format); their
    digests."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serving.adapters import (
        random_adapter_factors,
        save_adapter,
    )

    cfg = TransformerConfig(**dict(MODEL, dtype=torch.float32))
    adir.mkdir(parents=True)
    return {name: save_adapter(str(adir / f"{name}.npz"),
                               random_adapter_factors(
                                   cfg, ADAPTER_RANK, SEED + 40 + i,
                                   scale=ADAPTER_SCALE))
            for i, name in enumerate(ADAPTERS)}


def adapter_prompts(torch):
    rng = torch.Generator().manual_seed(SEED + 13)
    return [torch.randint(1, MODEL["vocab_size"], (n,),
                          generator=rng).tolist() for n in ADAPTER_LENS]


def adapter_work(prompts):
    """Two requests each of base and every adapter: (adapter or None,
    prompt) in the order base, alpha, beta, gamma for each prompt."""
    return [(a, p) for p in prompts for a in (None,) + ADAPTERS]


def post_status(port: int, path: str, body: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def stack_bytes(stack) -> int:
    return sum(t.numel() * t.element_size()
               for leaves in stack.values() for t in leaves.values())


def serve_adapters(torch, flash, base: Path, adir: Path):
    """Phase 6g over REST: the bf16 export with ``--adapters_dir`` at the
    JAX CLI's engine defaults (8 slots, ``--adapter_slots 8``,
    ``--adapter_rank 4``; programs captured).  A burst of eight
    concurrent :predict requests, two each of ``lm``, ``lm@alpha``,
    ``lm@beta`` and ``lm@gamma``: every reply prompt + max_new_tokens
    tokens in the vocabulary, :stats with the three adapters resident and
    the JAX engine's compiled_programs() for these flags, /readyz
    advertising them, ``lm@ghost`` answering 404.  Information only:
    the burst's TTFT and tokens/s, the stack's bytes on the card, and
    which bf16 variants' tokens differ from base."""
    from kubeflow_tpu_torch.serving import main as serving_main

    prompts = adapter_prompts(torch)
    work = adapter_work(prompts)
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
        "--device", "cuda",
        "--lm_buckets", BUCKETS, "--adapters_dir", str(adir),
        "--adapter_slots", "8", "--adapter_rank", str(ADAPTER_RANK)])
    port = httpd.server_address[1]
    try:
        engine = server._batchers["lm"]
        if engine.capture_info is None:
            fail("the adapter engine did not capture its programs")
        # One short request first: the burst must not carry the
        # process's one-off start-up.
        post(port, {"instances": [{"tokens": prompts[0][:16]}]})
        replies = [None] * len(work)
        latencies = [None] * len(work)

        def call(i):
            adapter, prompt = work[i]
            name = "lm" if adapter is None else f"lm@{adapter}"
            t = time.perf_counter()
            replies[i] = post(port, {"instances": [{"tokens": prompt}]},
                              f"/model/{name}:predict")
            latencies[i] = time.perf_counter() - t

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(work))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_burst = time.perf_counter() - t0
        if None in replies:
            fail("a request of the adapter burst did not complete")
        stats = get(port, "/model/lm:stats")["batcher"]
        ready = get(port, "/readyz")
        status, body = post_status(port, "/model/lm@ghost:predict", {
            "instances": [{"tokens": prompts[0][:8]}]})
        on_card = stack_bytes(engine._adapter_stack)
    finally:
        serving_main.shutdown(server, httpd)
    check_replies([p for _, p in work], replies, [], None)
    if stats["compiled_programs"] != {"chunked_prefill": 1, "step": 0,
                                      "verify": 0, "decode_rounds": 1}:
        fail(f"adapter engine compiled_programs {stats['compiled_programs']}")
    if stats["adapters"]["adapters_resident"] != len(ADAPTERS):
        fail(f"adapter engine stats {stats['adapters']}")
    if {a["name"] for a in ready.get("adapters", {}).get("lm", ())} \
            != set(ADAPTERS):
        fail(f"/readyz does not advertise the adapters: {ready}")
    if status != 404:
        fail(f"an unknown adapter answered {status}: {body}")
    toks = [r["predictions"][0]["tokens"] for r in replies]
    SERVED["6g"] = toks
    differs = {a: [toks[i] != toks[i - 1 - j] for i, (b, _) in
                   enumerate(work) if b == a]
               for j, a in enumerate(ADAPTERS)}
    info = {"burst": burst_info([p for _, p in work], latencies, t_burst,
                                stats),
            "stack_bytes": on_card,
            "bf16_differs_from_base": differs}
    log_burst("adapter engine (2 x base, lm@alpha, lm@beta, lm@gamma)",
              info["burst"])
    log(f"adapter stack on the card: {on_card} bytes for 9 rows (8 slots "
        f"and the base row) at rank {ADAPTER_RANK}, "
        f"{on_card / 9 / 1e6:.3f} MB a row; bf16 variants differing from "
        f"base per prompt (information only): {differs}; lm@ghost "
        f"answered 404")
    return info


def adapter_identity(torch, flash, base: Path, adir: Path):
    """Phase 6g at float32 (TF32 off), engines with programs captured and
    the prefix cache off (so a rerun of a prompt prefills as its first
    run did): the burst of eight mixed requests through one engine gives
    each request its tokens alone on the same engine; base rows equal a
    base-only engine's; each variant differs from base on both prompts;
    the engine captured and ran the programs the base-only engine did.
    Then a 2-slot registry: with alpha pinned, loading gamma evicts only
    the idle beta, and beta reloaded into a row another adapter held
    decodes its tokens again through the graphs captured at
    construction."""
    from kubeflow_tpu_torch.models.generate import DecodeConfig
    from kubeflow_tpu_torch.serving.adapters import AdapterRegistry
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    model = load_model(torch, base, torch.float32)
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    geometry = dict(slots=8, prefill_len=512, decode_rounds=8,
                    prefix_caching=False)
    prompts = adapter_prompts(torch)
    work = adapter_work(prompts)

    def registry(slots, name):
        return AdapterRegistry(model.cfg, slots=slots, rank=ADAPTER_RANK,
                               directory=str(adir), name=name)

    def request(adapter, prompt):
        return dict({"tokens": prompt},
                    **({"adapter": adapter} if adapter else {}))

    def alone(engine, items):
        return [engine.submit(request(a, p))["tokens"][0].tolist()
                for a, p in items]

    def programs_of(engine):
        return (engine.capture_info["programs"], engine.compiled_programs())

    engine = DecodeEngine(model, decode, adapters=registry(8, "ad-fp32"),
                          name="adapters-fp32", **geometry)
    try:
        together = engine_tokens(engine, [p for _, p in work],
                                 extra=[request(a, p) for a, p in work])
        single = alone(engine, work)
        ad_programs = programs_of(engine)
        ad_pool = engine.capture_info["pool_bytes"]
    finally:
        engine.close()
    engine = DecodeEngine(model, decode, name="base-fp32", **geometry)
    try:
        base_rows = alone(engine, [w for w in work if w[0] is None])
        base_programs = programs_of(engine)
        base_pool = engine.capture_info["pool_bytes"]
    finally:
        engine.close()
    for (adapter, prompt), a, b in zip(work, together, single):
        if a != b:
            fail(f"float32 adapter engine: {adapter or 'base'} on a "
                 f"{len(prompt)}-token prompt co-batched differs from its "
                 f"run alone at position {first_difference(a, b)}")
    if [t for (a, _), t in zip(work, together) if a is None] != base_rows:
        fail("float32 adapter engine: base rows differ from a base-only "
             "engine's")
    for i, (adapter, _) in enumerate(work):
        if adapter is not None and together[i] == together[
                i - 1 - ADAPTERS.index(adapter)]:
            fail(f"float32: adapter {adapter} decoded base's tokens")
    if ad_programs != base_programs:
        fail(f"the adapter engine's programs {ad_programs} differ from a "
             f"base-only engine's {base_programs}")
    log(f"float32 adapter identity: {len(work)} co-batched requests (2 x "
        f"base, alpha, beta, gamma on prompts of {list(ADAPTER_LENS)} "
        f"tokens) equal their runs alone; base rows equal a base-only "
        f"engine's; every variant differs from base; programs "
        f"{ad_programs[0]}, compiled {ad_programs[1]}, as the base-only "
        f"engine's (graph pool {ad_pool} bytes against {base_pool})")
    want = {(a, tuple(p)): t for (a, p), t in zip(work, single)}
    prompt = prompts[0]
    reg = registry(2, "ad-hot")
    engine = DecodeEngine(model, decode, adapters=reg, name="adapters-hot",
                          **geometry)
    try:
        graphs = [id(p.graph) for p in engine._programs()]
        for adapter in ("alpha", "beta"):
            if alone(engine, [(adapter, prompt)])[0] != want[
                    (adapter, tuple(prompt))]:
                fail(f"2-slot registry: {adapter} differs from its tokens "
                     "on the 8-slot engine")
        pin, _ = reg.acquire("alpha")
        try:
            got = alone(engine, [("gamma", prompt)])[0]
            resident = {r["name"] for r in reg.loaded()}
        finally:
            reg.release(pin)
        if resident != {"alpha", "gamma"}:
            fail(f"a hot load with alpha pinned left {resident} resident")
        if got != want[("gamma", tuple(prompt))]:
            fail("gamma hot-loaded into beta's row decodes other tokens")
        got = alone(engine, [("beta", prompt)])[0]
        rows = {r["name"]: r["index"] for r in reg.loaded()}
        if got != want[("beta", tuple(prompt))]:
            fail(f"beta reloaded into row {rows.get('beta')} decodes other "
                 "tokens through the captured graphs")
        if [id(p.graph) for p in engine._programs()] != graphs:
            fail("the engine recaptured a program for a hot load")
        hot_stats = engine.stats()["adapters"]
    finally:
        engine.close()
    log(f"float32 hot load into a 2-slot registry: gamma evicted only the "
        f"idle beta while alpha was pinned; beta reloaded into row "
        f"{rows['beta']} (resident now {sorted(rows)}) decodes its tokens "
        f"again through the graphs captured at construction; registry "
        f"{hot_stats['adapters_resident']} resident, "
        f"{hot_stats['adapters_pinned']} pinned")
    del model
    return {"requests": len(work), "programs": ad_programs[0],
            "graph_pool_bytes": ad_pool, "base_graph_pool_bytes": base_pool,
            "beta_reload_row": rows["beta"]}


def adapter_numbers(torch, base: Path, adir: Path, bf16_round_ms):
    """Phase 6g in bf16, information only: one hot load (the registry's
    acquire of an adapter from disk, host clock; then the copy of the
    whole stack into the device stack, as the engine makes it, host clock
    after synchronize), and a captured round of 8 steps at 8 live slots
    with the adapter rows (0, 1, 2, 3, 0, 1, 2, 3) against the same round
    with no adapter stack, in turns (median of 5 after one warm-up),
    each with its device busy time under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        init_paged_state,
    )
    from kubeflow_tpu_torch.serving.adapters import AdapterRegistry
    from kubeflow_tpu_torch.serving.engine import copy_adapter_stack
    from kubeflow_tpu_torch.serving.programs import Rounds

    model = load_model(torch, base, torch.bfloat16)
    reg = AdapterRegistry(model.cfg, slots=8, rank=ADAPTER_RANK,
                          directory=str(adir), name="ad-numbers")
    acquire_ms = {}
    for name in ADAPTERS:
        t0 = time.perf_counter()
        idx, _ = reg.acquire(name)
        acquire_ms[name] = (time.perf_counter() - t0) * 1e3
        reg.release(idx)
    snapshot, _ = reg.stack_snapshot()
    stack = {grp: {k: torch.zeros(a.shape, dtype=torch.bfloat16,
                                  device="cuda")
                   for k, a in leaves.items()}
             for grp, leaves in snapshot.items()}
    copy_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy_adapter_stack(stack, snapshot)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    slots, bt, k = 8, 16, 8
    mb = -(-(engine_prefill_width() + MAX_NEW_TOKENS) // bt)
    nb = slots * mb
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)
    states = {name: init_paged_state(model.cfg, slots, nb, bt,
                                     device="cuda")
              for name in ("adapters", "base")}
    tables = torch.full((slots, mb), nb, dtype=torch.int64, device="cuda")
    rounds = {"adapters": Rounds(model, decode, states["adapters"], tables,
                                 k, True, adapters=stack),
              "base": Rounds(model, decode, states["base"], tables, k,
                             True)}
    pool = torch.cuda.graph_pool_handle()
    with torch.inference_mode():
        for prog in rounds.values():
            prog.capture(pool)
    tables.copy_(torch.arange(nb, device="cuda").view(slots, mb))
    lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device="cuda")
    rows = torch.tensor([0, 1, 2, 3] * 2, dtype=torch.int32, device="cuda")

    def reset(name):
        state = states[name]
        state["lengths"].copy_(lengths)
        state["stop_len"].copy_(lengths + MAX_NEW_TOKENS)
        state["done"].zero_()
        state["last_token"].fill_(7)
        state["adapter_ids"].copy_(rows if name == "adapters" else 0 * rows)

    def timed(name):
        reset(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            rounds[name].run(k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    times = {name: [] for name in rounds}
    for i in range(6):
        for name in (("adapters", "base") if i % 2 == 0
                     else ("base", "adapters")):
            times[name].append(timed(name))
    ms = {name: sorted(t[1:])[2] * 1e3 for name, t in times.items()}
    busy = {}
    for name in rounds:
        reset(name)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                rounds[name].run(k)
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        busy[name] = busy_us / 1e3 if busy_us else None
    for prog in rounds.values():
        prog.release()
    info = {"round_ms": ms["adapters"], "base_round_ms": ms["base"],
            "ratio": ms["adapters"] / ms["base"],
            "phase_6b_round_ms": bf16_round_ms,
            "round_busy_ms": busy["adapters"],
            "base_round_busy_ms": busy["base"],
            "acquire_ms": acquire_ms, "stack_copy_ms": sorted(copy_ms)[1],
            "stack_bytes": stack_bytes(stack)}
    log(f"adapters in bf16 (information only; {card_line()}): captured "
        f"round of {k} steps at {slots} live slots with adapter rows "
        f"{rows.tolist()} {ms['adapters']:.2f} ms against "
        f"{ms['base']:.2f} ms with no adapter stack, in turns "
        f"({info['ratio']:.3f}x; phase 6b's round {bf16_round_ms:.2f} ms); "
        f"device busy {busy['adapters']} / {busy['base']} ms under "
        f"torch.profiler; one hot load: acquire from disk "
        f"{acquire_ms} ms (host clock), copy of the {info['stack_bytes']}"
        f"-byte stack to the card {info['stack_copy_ms']:.3f} ms (host "
        f"clock after synchronize, median of 3)")
    del model
    return info


# -- phase 6h: the rest of the serving surface ------------------------------

def export_lm_logits(base: Path, lm_base: Path, version: int) -> None:
    """The phase-4 export's weights as a version of the JAX package's
    ``lm`` loader: its config is the TransformerConfig overrides
    themselves.  The params file is linked (or copied), and model.json is
    written last, so the version appears complete."""
    import os

    from kubeflow_tpu_torch.serving.export import MODEL_FILE, PARAMS_FILE

    src, dst = base / "1", lm_base / str(version)
    dst.mkdir(parents=True)
    try:
        os.link(src / PARAMS_FILE, dst / PARAMS_FILE)
    except OSError:
        shutil.copyfile(src / PARAMS_FILE, dst / PARAMS_FILE)
    meta = json.loads((src / MODEL_FILE).read_text())
    meta.update(loader=LM_LOGITS_LOADER, config=MODEL,
                signature={"inputs": ["tokens"], "outputs": ["logits"]})
    (dst / MODEL_FILE).write_text(json.dumps(meta))


def post_raw(port: int, path: str, body: dict, headers=None):
    """(status, raw body bytes, seconds on the client clock)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(body),
                     headers=dict({"Content-Type": "application/json"},
                                  **(headers or {})))
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, raw, time.perf_counter() - t0
    finally:
        conn.close()


def get_text(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        text = resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"GET {path} answered {resp.status}: {text[:200]}")
    return text


def lm_logits_direct(torch, flash, lm_base: Path):
    """Phase 6h, direct: the ``lm`` loader's predict on [2, 1024] tokens
    (bh 16 at 8 heads: the kernel table's serve shape), counts zeroed
    just before the counted calls and read just after: flash_fwd 12
    launches a call, no other kernel.  The logits' mean error against a
    float32 run of the same weights (plain attention) within
    LOGITS_ERR_RATIO of the plain bf16 path's.  Information only: the
    forward alone (CUDA events, synchronized before the copy to the host)
    and the whole predict (host clock)."""
    import numpy as np

    from kubeflow_tpu_torch.serving.export import load_version

    predict, meta = load_version(lm_base, 1, device="cuda")
    if meta["loader"] != LM_LOGITS_LOADER:
        fail(f"the lm export loaded as {meta['loader']!r}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    tokens = torch.randint(1, MODEL["vocab_size"], (LM_BATCH, LM_LEN),
                           device="cuda", generator=gen)
    host_tokens = tokens.cpu().numpy().astype(np.int32)
    predict({"tokens": host_tokens})  # warm-up, outside the count
    torch.cuda.synchronize()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    host_ms = []
    out = None
    for _ in range(LM_CALLS):
        t0 = time.perf_counter()
        out = predict({"tokens": host_tokens})["logits"]
        host_ms.append((time.perf_counter() - t0) * 1e3)
    counts = dict(flash.launch_counts)
    want = {k: (MODEL["n_layers"] * LM_CALLS if k == "flash_fwd" else 0)
            for k in counts}
    if counts != want:
        fail(f"the lm loader's {LM_CALLS} calls launched {counts}, want "
             f"{want}")
    if out.shape != (LM_BATCH, LM_LEN, MODEL["vocab_size"]) \
            or out.dtype != np.float32 or not np.isfinite(out).all():
        fail(f"lm logits {out.shape} {out.dtype} (finite "
             f"{bool(np.isfinite(out).all())})")
    fwd_ms = []
    for _ in range(LM_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits = predict.forward(tokens)
        end.record()
        torch.cuda.synchronize()
        fwd_ms.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    logits.cpu()
    copy_ms = (time.perf_counter() - t0) * 1e3

    def one_forward():
        predict.forward(tokens)
        torch.cuda.synchronize()

    profiled = profile_busy(torch, one_forward,
                            f"lm forward [{LM_BATCH}, {LM_LEN}]")
    with plain_kernels(flash):
        plain = predict.forward(tokens)
        with torch.inference_mode():
            reference = load_model(torch, lm_base, torch.float32)(tokens)
    err_k = (logits - reference).abs().mean().item()
    err_p = (plain - reference).abs().mean().item()
    agree = (logits.argmax(-1) == reference.argmax(-1)).float().mean().item()
    same_as_host = bool(torch.equal(logits.cpu(), torch.from_numpy(out)))
    del plain, reference
    torch.cuda.empty_cache()
    if err_k > LOGITS_ERR_RATIO * err_p:
        fail(f"lm logits through the kernel mean |err| {err_k:.4e} against "
             f"float32, over {LOGITS_ERR_RATIO} x the plain path's "
             f"{err_p:.4e}")
    flops = lm_forward_flops(LM_BATCH, LM_LEN)
    info = {
        "launches": counts, "calls": LM_CALLS,
        "forward_ms": sorted(fwd_ms), "predict_ms": sorted(host_ms),
        "copy_ms": copy_ms, "logits_bytes": int(out.nbytes),
        "forward_flops": flops,
        "forward_tflops": flops / (min(fwd_ms) * 1e-3) / 1e12,
        "mean_err_kernel": err_k, "mean_err_plain": err_p,
        "argmax_agreement": agree, "device_logits_equal_host": same_as_host,
        "profile": profiled,
    }
    log(f"lm loader, [{LM_BATCH}, {LM_LEN}] tokens: flash launches {counts} "
        f"over {LM_CALLS} calls; logits mean |err| against float32 "
        f"{err_k:.4e} (plain bf16 path {err_p:.4e}, bound {LOGITS_ERR_RATIO}"
        f"x), argmax agreement {agree:.4f}; forward {min(fwd_ms):.3f}-"
        f"{max(fwd_ms):.3f} ms (CUDA events, {flops / 1e9:.1f} GFLOP, "
        f"{info['forward_tflops']:.1f} TFLOP/s), copy of the "
        f"{out.nbytes}-byte logits to the host {copy_ms:.2f} ms, whole "
        f"predict {min(host_ms):.2f}-{max(host_ms):.2f} ms (host clock; "
        f"information only; {card_line()})")
    return predict, host_tokens, counts, info


def lm_forward_flops(batch: int, seq: int) -> float:
    """Matmul FLOPs of one causal forward: 2 x the non-embedding weights
    and the unembed per token, plus the causal half of q.k and p.v."""
    d, f, L = MODEL["d_model"], MODEL["d_ff"], MODEL["n_layers"]
    hd = MODEL["n_heads"] * MODEL["head_dim"]
    kv = MODEL["n_kv_heads"] * MODEL["head_dim"]
    per_layer = d * hd * 2 + d * kv * 2 + 3 * d * f
    weights = 2 * batch * seq * (L * per_layer + MODEL["vocab_size"] * d)
    attn = L * batch * 2 * 2 * seq * seq * hd / 2
    return float(weights + attn)


def serve_surface(torch, flash, base: Path, lm_base: Path, direct_predict,
                  host_tokens):
    """Phase 6h over REST, in-process, with --trace_sample_rate 1: a
    16-token :predict equal to the direct predict's logits; a client
    traceparent's trace id back in /debug/traces under server.predict;
    /metrics parsed with the port's parse_metrics; one idempotency key
    twice runs the loader once; an out-of-range token id answers 400
    and the server goes on serving; a corrupt version 2 trips the breaker
    while version 1 serves; loader.load:raise*1 fails exactly one
    reload."""
    import numpy as np

    from kubeflow_tpu_torch.runtime import tracing
    from kubeflow_tpu_torch.runtime.prom import parse_metrics, sample_value
    from kubeflow_tpu_torch.serving import main as serving_main
    from kubeflow_tpu_torch.testing import faults

    tokens16 = host_tokens[:1, :LM_REST_LEN]
    want = direct_predict({"tokens": tokens16})["logits"][0]
    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(lm_base),
        "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
        "--device", "cuda",
        "--trace_sample_rate", "1", "--poll_interval_s", "3600"])
    port = httpd.server_address[1]
    body = {"instances": [{"tokens": tokens16[0].tolist()}]}
    trace_id, parent = "5e" * 16, "c4" * 8
    info = {}
    try:
        status, raw, warm_s = post_raw(port, "/model/lm:predict", body)
        statuses = [status]
        status, raw, rest_s = post_raw(
            port, "/model/lm:predict", body,
            {"traceparent": tracing.format_traceparent(trace_id, parent)})
        statuses.append(status)
        t0 = time.perf_counter()
        reply = json.loads(raw)
        parse_s = time.perf_counter() - t0
        got = np.asarray(reply["predictions"][0]["logits"], np.float32)
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"REST logits {got.shape} differ from the direct "
                 f"predict's {want.shape}: max |diff| "
                 f"{float(np.abs(got - want).max()):.4e}")
        traces = get(port, "/debug/traces")["traces"]
        mine = [t for t in traces if t["trace_id"] == trace_id]
        spans = {s["name"]: s for t in mine for s in t["spans"]}
        if "server.predict" not in spans \
                or spans["server.predict"]["parent_id"] != parent:
            fail(f"the client traceparent's trace {trace_id} is not in "
                 f"/debug/traces under server.predict: {sorted(spans)}")
        parsed = parse_metrics(get_text(port, "/metrics"))
        ok = sample_value(parsed, "kft_serving_requests_total", model="lm",
                          route="predict", outcome="ok")
        inflight = sample_value(parsed, "kft_serving_inflight")
        if not ok or ok < 2 or inflight != 0.0:
            fail(f"/metrics: requests_total ok {ok}, in-flight {inflight} "
                 "(a scrape must not count as in flight)")
        before = flash.launch_counts["flash_fwd"]
        keyed = [post_raw(port, "/model/lm:predict", body,
                          {"x-kft-idempotency-key": "chip-smoke-1"})
                 for _ in range(2)]
        ran = flash.launch_counts["flash_fwd"] - before
        if ran != MODEL["n_layers"] or keyed[0][1] != keyed[1][1] \
                or {k[0] for k in keyed} != {200}:
            fail(f"two POSTs with one idempotency key ran {ran} flash "
                 f"launches (want {MODEL['n_layers']}: one execution)")
        # An id outside the vocabulary answers 400 before the card sees
        # it (a device-side assert would poison the CUDA context), and
        # the next request is answered as before.
        before = flash.launch_counts["flash_fwd"]
        bad = {"instances": [{"tokens": [MODEL["vocab_size"]]
                              + tokens16[0, 1:].tolist()}]}
        bad_status, _, _ = post_raw(port, "/model/lm:predict", bad)
        status, raw_after, _ = post_raw(port, "/model/lm:predict", body)
        statuses.append(status)
        ran = flash.launch_counts["flash_fwd"] - before
        if bad_status != 400 or ran != MODEL["n_layers"] \
                or raw_after != raw:
            fail(f"an out-of-range token id: status {bad_status}, {ran} "
                 f"flash launches for it and the next request (want "
                 f"{MODEL['n_layers']}), next answer the same "
                 f"{raw_after == raw}")
        # A corrupt version 2 trips the breaker; version 1 keeps serving.
        (lm_base / "2").mkdir()
        (lm_base / "2" / "model.json").write_text("{corrupt")
        try:
            server.reload("lm")
            fail("the corrupt version 2 loaded")
        except faults.FaultInjected:
            fail("a fault was injected before any was installed")
        except Exception:  # noqa: BLE001 -- the corrupt model.json
            pass
        if server.reload("lm") is not False:
            fail("the open breaker let a second load of version 2 run")
        status, raw2, _ = post_raw(port, "/model/lm:predict", body)
        statuses.append(status)
        version = get(port, "/model/lm:metadata")["model_spec"]["version"]
        parsed = parse_metrics(get_text(port, "/metrics"))
        open_ = sample_value(parsed, "kft_serving_reload_breaker_open",
                             model="lm")
        failures = sample_value(parsed, "kft_serving_reload_failures_total",
                                model="lm")
        if version != "1" or raw2 != raw or open_ != 1.0 or failures != 1:
            fail(f"after the corrupt version: serving v{version}, breaker "
                 f"gauge {open_}, failures {failures}")
        # loader.load:raise*1, in the KFT_FAULTS grammar, fails one reload.
        with faults.injected("loader.load:raise*1") as inj:
            export_lm_logits(base, lm_base, 3)
            try:
                server.reload("lm")
                fail("loader.load:raise*1 did not fail the reload")
            except faults.FaultInjected:
                pass
            skipped = server.reload("lm")
            inj.advance_clock(3600.0)
            t0 = time.perf_counter()
            loaded = server.reload("lm")
            reload_s = time.perf_counter() - t0
            fired = inj.fired("loader.load")
        status, raw3, _ = post_raw(port, "/model/lm:predict", body)
        statuses.append(status)
        parsed = parse_metrics(get_text(port, "/metrics"))
        open_after = sample_value(parsed, "kft_serving_reload_breaker_open",
                                  model="lm")
        version = get(port, "/model/lm:metadata")["model_spec"]["version"]
        if skipped is not False or loaded is not True or fired != 2 \
                or version != "3" or open_after != 0.0 or raw3 != raw:
            fail(f"loader.load:raise*1: skipped {skipped}, loaded "
                 f"{loaded}, fired {fired}, serving v{version}, breaker "
                 f"gauge {open_after}, same logits {raw3 == raw}")
        if set(statuses) != {200}:
            fail(f"REST statuses {statuses}")
        info = {"json_bytes": len(raw), "rest_s": rest_s,
                "warm_rest_s": warm_s, "client_parse_s": parse_s,
                "spans": sorted(spans), "reload_v3_s": reload_s,
                "metrics_samples": sum(len(v) for v in parsed.values())}
    finally:
        serving_main.shutdown(server, httpd)
        tracing.disable()
    log(f"lm over REST: a {LM_REST_LEN}-token :predict answered "
        f"{len(raw)} bytes of JSON in {rest_s * 1e3:.1f} ms (client "
        f"parse {parse_s * 1e3:.1f} ms), logits equal to the direct "
        f"predict's; trace {trace_id[:8]}... back with spans "
        f"{info['spans']}; one idempotency key twice, one execution; an "
        f"out-of-range token id answered 400 and the server served on; a "
        f"corrupt v2 tripped the breaker while v1 served; "
        f"loader.load:raise*1 failed one reload, then v3 loaded in "
        f"{reload_s:.2f} s (host clock; information only; {card_line()})")
    return info


def tracing_cost(torch, base: Path, prompts):
    """Phase 6h, information only: phase 6b's burst through the captured
    engine with tracing at sample rate 1 and with tracing off, in turns,
    in one server after one untimed burst.  The prefix cache is off, so
    every burst prefills all its prompts, as phase 6b's first does."""
    from kubeflow_tpu_torch.runtime import tracing
    from kubeflow_tpu_torch.serving import main as serving_main

    server, httpd = serving_main.start([
        "--model_name", "lm", "--model_base_path", str(base),
        "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
        "--device", "cuda",
        "--lm_buckets", BUCKETS, "--trace_sample_rate", "1",
        "--no_prefix_cache"])
    port = httpd.server_address[1]
    times = {"on": [], "off": []}
    retained = 0
    try:
        burst(port, prompts)
        for mode in ("on", "off", "on", "off"):
            if mode == "on":
                store = tracing.enable(sample_rate=1.0, capacity=128)
            else:
                tracing.disable()
            replies, _, t = burst(port, prompts)
            check_replies(prompts, replies, [], None)
            times[mode].append(t)
            if mode == "on":
                retained = max(retained, len(store))
    finally:
        serving_main.shutdown(server, httpd)
        tracing.disable()
    ratio = sum(times["on"]) / sum(times["off"])
    log(f"engine burst with tracing at sample rate 1 / off, in turns: "
        f"{times['on']} / {times['off']} s ({ratio:.3f}x; {retained} "
        f"traces retained; host clock; information only; {card_line()})")
    return {"on_s": times["on"], "off_s": times["off"], "ratio": ratio,
            "traces_retained": retained}


# -- phase 6i: tensor-parallel decode ----------------------------------------

_MESH_DECODE_RANK = r"""
import dataclasses, hashlib, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from kubeflow_tpu_torch.models.convert import load_params, param_tree
from kubeflow_tpu_torch.models.generate import (
    DecodeConfig, _forward_with_cache, init_paged_state)
from kubeflow_tpu_torch.models.transformer import Transformer
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.runtime import bootstrap
from kubeflow_tpu_torch.serving import lockstep, sharding
from kubeflow_tpu_torch.serving.export import load_version
from kubeflow_tpu_torch.serving.programs import ChunkedPrefill, Rounds

base, seed, length = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
lens = [int(n) for n in sys.argv[4].split(",")]
new, width, rounds = int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7])
chunk = int(sys.argv[8])
env = bootstrap.initialize(device="cuda")
mesh = sharding.build_mesh({"tensor": env.num_processes}, device="cuda")
rank = env.process_id
whole = load_version(base, 1, device="cuda")[0].engine_spec["model"]
cfg = whole.cfg
prompt = torch.randint(1, cfg.vocab_size, (1, length),
                       generator=torch.Generator().manual_seed(seed)).cuda()
calls = {"all_reduce": [0, 0, 0.0], "all_gather": [0, 0, 0.0]}


def counted(name):
    fn = getattr(dist, name)

    def call(*args, **kw):
        t = args[0] if name == "all_reduce" else args[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        rec = calls[name]
        rec[0] += 1
        rec[1] += t.numel() * t.element_size()
        rec[2] += time.perf_counter() - t0
        return out
    return call


def counting(fn):
    # fn() with every collective counted and timed alone (each
    # synchronized before and after); returns the counts.
    plain = {name: getattr(dist, name) for name in calls}
    for rec in calls.values():
        rec[:] = [0, 0, 0.0]
    for name in calls:
        setattr(dist, name, counted(name))
    try:
        fn()
    finally:
        for name, f in plain.items():
            setattr(dist, name, f)
    return {name: {"calls": rec[0], "bytes": rec[1], "ms": rec[2] * 1e3}
            for name, rec in calls.items()}


def prefill(model):
    # The engine's forward: the paged pool, one slot's table, the whole
    # prompt in one call from offset 0.
    bt = 16
    nb = length // bt + 1
    state = init_paged_state(
        model.cfg, 1, nb, bt, device="cuda",
        kv_heads=sharding.local_kv_heads(cfg.n_kv_heads, model.mesh))
    table = torch.arange(nb, device="cuda")[None]
    with torch.inference_mode():
        return _forward_with_cache(
            model, prompt, (state["cache_k"], state["cache_v"]),
            torch.zeros(1, dtype=torch.int32, device="cuda"),
            tables=table)[0]


def compare(got, want):
    diff = (got - want).float()
    return {"max_abs": float(diff.abs().max()),
            "mean_abs": float(diff.abs().mean()),
            "rel_fro": float(diff.norm() / want.float().norm()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean()),
            "last_argmax_equal": bool(got[-1].argmax() == want[-1].argmax()),
            "finite": bool(torch.isfinite(got).all())}


out = {"rank": rank}
# float32 (TF32 off): the same weights, widened.
f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
tree = param_tree(whole)


def widen(node):
    if isinstance(node, dict):
        return {k: widen(v) for k, v in node.items()}
    return node.float()


whole32 = load_params(Transformer(f32_cfg, device="meta"), widen(tree))
del tree
want = {"bf16": prefill(whole), "f32": prefill(whole32)} if rank == 0 \
    else None
model = sharding.shard_model(whole, mesh)
model32 = sharding.shard_model(whole32, mesh)
del whole, whole32
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats()
got = {"bf16": prefill(model), "f32": prefill(model32)}
if rank == 0:
    f32 = want["f32"].float()
    out["logits"] = {k: compare(got[k], want[k]) for k in got}
    out["logits"]["bf16"]["tensor1_rel_fro_f32"] = float(
        (want["bf16"] - f32).norm() / f32.norm())
    out["logits"]["bf16"]["tensor1_mean_abs_f32"] = float(
        (want["bf16"] - f32).abs().mean())
    out["logits"]["bf16"]["tensor2_mean_abs_f32"] = float(
        (got["bf16"] - f32).abs().mean())
del got, want, model32
torch.cuda.empty_cache()
decode = DecodeConfig(max_new_tokens=new)

# One prefill chunk at offset ``length`` of a slot (6b's chunk).
bt = 16
mb = -(-(width + new) // bt)
slots = len(lens)
nb = slots * mb
state = init_paged_state(cfg, slots, nb, bt, device="cuda",
                         kv_heads=sharding.local_kv_heads(cfg.n_kv_heads,
                                                          mesh))
tables = torch.arange(nb, device="cuda").view(slots, mb)
chunk_prog = ChunkedPrefill(model, decode, state, tables, chunk, graphs=False)
segment = np.arange(1, chunk + 1, dtype=np.int64)


def one_chunk():
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with torch.inference_mode():
        chunk_prog.run(segment, length, length + chunk, new, 0, 0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


one_chunk()
out["chunk_ms"] = sorted(one_chunk() for _ in range(3))[1]
out["chunk_collectives"] = counting(one_chunk)

# A fused round of 8 steps at 8 live slots (6b's round).
prog = Rounds(model, decode, state, tables, rounds, graphs=False)
lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
last = torch.randint(1, cfg.vocab_size, (slots,), dtype=torch.int32,
                     generator=torch.Generator().manual_seed(seed + 1))
live = {"lengths": lengths, "stop_len": lengths + 2 * rounds,
        "done": torch.zeros(slots, dtype=torch.bool, device="cuda"),
        "last_token": last.cuda()}


def one_round():
    for name, value in live.items():
        state[name].copy_(value)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, _, steps = prog.run(rounds)
    torch.cuda.synchronize()
    out["steps"] = int(steps)
    return (time.perf_counter() - t0) * 1e3


one_round()
times = [one_round() for _ in range(3)]
out["round_ms"] = sorted(times)[1]
out["round_ms_all"] = times
per_round = counting(one_round)
out["collectives_per_step"] = {
    name: {k: v / out["steps"] for k, v in rec.items()}
    for name, rec in per_round.items()}
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    wall = one_round()
busy = sum(e.self_device_time_total for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
out["profiled_round_ms"] = wall
out["busy_ms"] = busy if busy > 0 else None

# One all-reduce alone, 20 times, of a decode step's and a chunk's
# row-parallel partial: CUDA tensors over the tensor group (gloo stages
# them through host memory) against host tensors over the lockstep
# channel's gloo group, and one lockstep-sized broadcast.
tensor_group = mesh.get_group("tensor")
chan = lockstep.channel(mesh)


def reduce_ms(shape, device, group):
    t = torch.ones(shape, dtype=torch.float32, device=device)
    dist.all_reduce(t, group=group)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(t, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 20


out["reduce_alone_ms"] = {
    f"{where} {list(shape)}": reduce_ms(shape, where, group)
    for shape in ((slots, 1, cfg.d_model), (1, chunk, cfg.d_model))
    for where, group in (("cuda", tensor_group), ("cpu", chan.group))}
dist.barrier()
t0 = time.perf_counter()
for _ in range(20):
    dist.broadcast_object_list([("engine-1", "_op_round_step", ())],
                               src=0, group=chan.group)
out["broadcast_ms"] = (time.perf_counter() - t0) * 1e3 / 20
out["pool_bytes"] = sum(
    t.numel() * t.element_size() for t in (state["cache_k"],
                                          state["cache_v"]))
out["pool_blocks"] = nb
out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
digest = hashlib.sha256()
for name in ("lengths", "done", "last_token", "keys"):
    digest.update(state[name].cpu().numpy().tobytes())
out["scalars_sha256"] = digest.hexdigest()
out["flash_launches"] = sum(flash.launch_counts.values())
print("RESULT " + json.dumps(out), flush=True)
dist.barrier()
"""


def start_mesh_server(workdir: Path, name: str, base: Path, *flags):
    """Start ``serving.main --mesh tensor=MESH_WORLD`` as MESH_WORLD
    processes sharing the card over gloo; returns (processes, stderr
    paths) at once (``mesh_port`` waits for it)."""
    from kubeflow_tpu_torch.testing.ranks import free_port

    coordinator = f"127.0.0.1:{free_port()}"
    procs, errs = [], []
    for rank in range(MESH_WORLD):
        err = workdir / f"mesh-{name}-rank{rank}.err"
        errs.append(err)
        env = dict(os.environ, KFT_NUM_PROCESSES=str(MESH_WORLD),
                   KFT_PROCESS_ID=str(rank),
                   KFT_COORDINATOR_ADDRESS=coordinator,
                   KFT_DIST_BACKEND="gloo", PYTHONUNBUFFERED="1",
                   OMP_NUM_THREADS=str(MESH_THREADS))
        with open(err, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeflow_tpu_torch.serving.main",
                 "--model_name", "lm", "--model_base_path", str(base),
                 "--port", "0", "--grpc_port", "-1", "--host",
                 "127.0.0.1", "--lm_buckets", BUCKETS, "--mesh",
                 f"tensor={MESH_WORLD}", *flags],
                cwd=str(Path(__file__).resolve().parent), env=env,
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                stderr=f))
    return procs, errs


def mesh_port(name: str, procs, errs) -> int:
    """The REST port of a started mesh server, once rank 0 printed its
    ready line (MESH_START_S at most)."""
    deadline = time.monotonic() + MESH_START_S
    while time.monotonic() < deadline:
        for line in errs[0].read_text().splitlines():
            if line.startswith("KFT_SERVING_READY"):
                return int(line.split("rest=")[1].split()[0])
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.1)
    for p in procs:
        p.kill()
        p.wait()
    fail(f"the mesh server {name!r} did not start: "
         + errs[0].read_text()[-2000:] + errs[1].read_text()[-2000:])


def stop_mesh_server(name: str, procs, errs):
    """SIGTERM rank 0 (it drains, closes its engines and the lockstep
    channel); every rank must exit 0.  Returns each rank's digests of
    its engines' slot scalars, logged at their release."""
    procs[0].send_signal(signal.SIGTERM)
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(MESH_STOP_S))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(None)
    if codes != [0] * MESH_WORLD:
        fail(f"mesh server {name!r} ranks exited {codes}: "
             + "".join(e.read_text()[-1500:] for e in errs))
    digests = []
    for err in errs:
        digests.append([line.rsplit(" ", 1)[1] for line in
                        err.read_text().splitlines()
                        if "slot scalars sha256" in line])
    if not digests[0] or any(d != digests[0] for d in digests):
        fail(f"mesh server {name!r}: the ranks' slot scalars differ at "
             f"the end: {digests}")
    log(f"mesh server {name!r}: rank 1's digest of its engine's slot "
        f"scalars {digests[1]} equals rank 0's; both ranks exited 0")
    return digests


_REF_MODELS = {}
_REF_LOCK = threading.Lock()


def mesh_ref_logits(torch, flash, export: Path, prompt, adapter=None,
                    adir=None):
    """The next-token logits after ``prompt`` on one device: the model
    ``export``'s loader serves (bf16 or int8 weights, its KV dtype), with
    ``adapter``'s delta when named, plain attention.  The yardstick of a
    near tie."""
    with _REF_LOCK:  # the servers' threads may ask at once
        return _ref_logits(torch, flash, export, prompt, adapter, adir)


def _ref_logits(torch, flash, export: Path, prompt, adapter, adir):
    from kubeflow_tpu_torch.models.generate import (
        _forward_with_cache,
        init_cache,
    )
    from kubeflow_tpu_torch.serving.adapters import AdapterRegistry
    from kubeflow_tpu_torch.serving.export import load_version

    key = str(export)
    if key not in _REF_MODELS:
        spec = load_version(export, 1, device="cuda")[0].engine_spec
        _REF_MODELS[key] = (spec["model"], spec["decode"])
    model, decode = _REF_MODELS[key]
    ids = stack = None
    if adapter is not None:
        reg = AdapterRegistry(model.cfg, slots=8, rank=ADAPTER_RANK,
                              directory=str(adir))
        row, _ = reg.acquire(adapter)
        host, _ = reg.stack_snapshot()
        stack = {g: {k: torch.as_tensor(v).to("cuda", model.cfg.dtype)
                     for k, v in leaves.items()}
                 for g, leaves in host.items()}
        ids = torch.tensor([row], device="cuda")
    tokens = torch.tensor([prompt], device="cuda")
    cache = init_cache(model.cfg, 1, len(prompt), device="cuda",
                       kv_cache_dtype=decode.kv_cache_dtype)
    with plain_kernels(flash), torch.inference_mode():
        return _forward_with_cache(model, tokens, cache, 0, adapter_ids=ids,
                                   adapters=stack)[0, -1].float()


def mesh_compare(what: str, prompts, replies, want, ref):
    """Every reply's first generated token must equal ``want``'s (the
    single-device phase's reply to the same prompt), or, where it does
    not, be a near tie on one device: in its logits (``ref(i)``, the
    single-device forward) the two tokens lie within MESH_TIE_GAP of each
    other and its own top two within MESH_TIE_GAP too.  A request whose
    single-device top-2 gap exceeds MESH_TIE_GAP is decisive: its first
    token must be equal, so a mesh that drew the runner-up fails there;
    how many requests are decisive is logged (the check's power).  Whole
    streams that equal the phase's and the first differing positions are
    information."""
    got = [r["predictions"][0]["tokens"] for r in replies]
    firsts = [(g[len(p)], w[len(p)]) for p, g, w in zip(prompts, got, want)]
    ties, top2 = {}, []
    for i, (mine, theirs) in enumerate(firsts):
        logits = ref(i)
        top2.append(torch_top2_gap(logits))
        if mine == theirs:
            continue
        gap = float(logits[theirs] - logits[mine])
        ties[i] = {"gap": gap, "top2_gap": top2[i]}
        if abs(gap) > MESH_TIE_GAP or top2[i] > MESH_TIE_GAP:
            fail(f"mesh {what}: request {i}'s first generated token "
                 f"{mine} differs from the single-device phase's {theirs}: "
                 f"their gap {gap:.4f} and the single-device top-2 gap "
                 f"{top2[i]:.4f} in one device's logits are not both "
                 f"within {MESH_TIE_GAP}: {firsts}")
    decisive = sum(g > MESH_TIE_GAP for g in top2)
    diffs = [first_difference(g[len(p):], w[len(p):])
             for p, g, w in zip(prompts, got, want)]
    log(f"mesh {what}: first generated tokens equal the single-device "
        f"phase's for {len(firsts) - len(ties)} / {len(firsts)} requests"
        + (f", near ties (single-device logit gap, top-2 gap) "
           + ", ".join(f"request {i}: {t['gap']:.4f}, {t['top2_gap']:.4f}"
                       for i, t in ties.items()) if ties else "")
        + f"; {decisive} / {len(firsts)} requests decisive (single-device "
        f"top-2 gap above {MESH_TIE_GAP}: their first tokens must be "
        f"equal); whole streams equal for {diffs.count(None)} / "
        f"{len(diffs)}, first differing positions {diffs} (information "
        f"only)")
    return {"first_equal": len(firsts) - len(ties), "near_ties": ties,
            "decisive": decisive, "requests": len(firsts),
            "streams_equal": diffs.count(None), "first_difference": diffs}


def mesh_streams(torch, flash, export: Path, prompts, replies, want):
    """Every reply's whole stream must equal ``want``'s (the one-device
    phase's reply to the same context), or part from it at a near tie:
    at the first differing position, in one device's logits after the
    common prefix, the two tokens and its own top two lie within
    MESH_TIE_GAP (``mesh_compare``'s rule, at the position where the
    streams part).  Returns the streams equal and the first differing
    positions with their gaps."""
    got = [r["predictions"][0]["tokens"] for r in replies]
    parted = {}
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        at = first_difference(g[len(p):], w[len(p):])
        if at is None:
            continue
        pos = len(p) + at
        logits = mesh_ref_logits(torch, flash, export, w[:pos])
        gap = float(logits[w[pos]] - logits[g[pos]])
        top2 = torch_top2_gap(logits)
        parted[i] = {"at": at, "gap": gap, "top2_gap": top2}
        if abs(gap) > MESH_TIE_GAP or top2 > MESH_TIE_GAP:
            fail(f"mesh spill tier: second turn {i} parts from the "
                 f"one-device stream at new token {at} ({g[pos]} against "
                 f"{w[pos]}): their gap {gap:.4f} and the one-device top-2 "
                 f"gap {top2:.4f} are not both within {MESH_TIE_GAP}")
    log(f"mesh spill tier: second turns equal the one-device streams for "
        f"{len(got) - len(parted)} / {len(got)} sessions"
        + (", parting at near ties " + ", ".join(
            f"session {i} at token {t['at']} (gap {t['gap']:.4f}, top-2 "
            f"{t['top2_gap']:.4f})" for i, t in parted.items())
           if parted else ""))
    return {"streams_equal": len(got) - len(parted), "parted": parted}


def f32_pages(torch, flash, export: Path, tokens, n: int):
    """The first ``n`` pages of ``tokens``' keys and values from a float32
    forward of the export's weights on one device (plain attention):
    the yardstick of a bf16 page's error."""
    from kubeflow_tpu_torch.models.generate import (
        _forward_with_cache,
        init_cache,
    )

    width = n * 16
    model = load_model(torch, export, torch.float32)
    cache = init_cache(model.cfg, 1, width, device="cuda")
    with plain_kernels(flash), torch.inference_mode():
        _forward_with_cache(model, torch.tensor([tokens[:width]],
                                                device="cuda"), cache, 0)
    del model
    return tuple(c[:, 0].reshape(c.shape[0], n, 16, *c.shape[3:]).cpu()
                 for c in cache)


def mesh_fetch(torch, flash, export: Path, fetched: dict,
               six: dict) -> dict:
    """Rank 0's :fetch_kv answer against phase 6f's one-device server's
    for the same tokens: the same coverage and page shapes (whole heads,
    every rank's gathered), and each side's pages within MESH_TWO_PATHS
    times the one-device pages' own distance (relative Frobenius) from
    a float32 forward's: two bf16 paths of one function (phase 6i's
    logits rule)."""
    from kubeflow_tpu_torch.serving import http as serving_http

    if fetched["kv_handoff"] is None \
            or fetched["tokens_covered"] != six["fetch_covered"]:
        fail(f"mesh :fetch_kv covered {fetched['tokens_covered']} tokens, "
             f"the one-device server {six['fetch_covered']}")
    payload = serving_http.decode_kv_handoff(fetched["kv_handoff"])
    want = six["fetch"]
    n = want[0].shape[1]
    with _REF_LOCK:
        ref = f32_pages(torch, flash, export, six["fetch_tokens"], n)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    out = {"pages": n, "covered": fetched["tokens_covered"]}
    for side, mine, theirs, f32 in zip(("k", "v"), (payload["k"],
                                                     payload["v"]),
                                       want, ref):
        if tuple(mine.shape) != tuple(theirs.shape) \
                or mine.dtype != theirs.dtype:
            fail(f"mesh :fetch_kv {side} pages {tuple(mine.shape)} "
                 f"{mine.dtype}, one device's {tuple(theirs.shape)} "
                 f"{theirs.dtype}")
        d_mesh, d_one = rel(mine, theirs), rel(theirs, f32)
        out[side] = {"rel_fro_to_one_device": d_mesh,
                     "one_device_rel_fro_to_f32": d_one,
                     "mesh_rel_fro_to_f32": rel(mine, f32),
                     "max_abs": float((mine.float()
                                       - theirs.float()).abs().max())}
        if d_mesh > MESH_TWO_PATHS * d_one:
            fail(f"mesh :fetch_kv {side} pages {d_mesh:.3e} (relative "
                 f"Frobenius) from the one-device server's, over "
                 f"{MESH_TWO_PATHS} x its own {d_one:.3e} from float32")
    log(f"mesh :fetch_kv on rank 0: {n} whole-head pages "
        f"{tuple(payload['k'].shape)} {payload['k'].dtype}, as the "
        f"one-device server's; relative Frobenius to it k "
        f"{out['k']['rel_fro_to_one_device']:.3e} v "
        f"{out['v']['rel_fro_to_one_device']:.3e} (bound "
        f"{MESH_TWO_PATHS} x the one-device pages' distance from float32:"
        f" k {out['k']['one_device_rel_fro_to_f32']:.3e} v "
        f"{out['v']['one_device_rel_fro_to_f32']:.3e}); the mesh's own "
        f"from float32 k {out['k']['mesh_rel_fro_to_f32']:.3e} v "
        f"{out['v']['mesh_rel_fro_to_f32']:.3e}")
    return out


def torch_top2_gap(logits) -> float:
    top = logits.topk(2).values
    return float(top[0] - top[1])


def check_mesh_stats(what: str, stats: dict) -> None:
    if stats.get("mesh_devices") != MESH_WORLD:
        fail(f"mesh {what}: :stats mesh_devices {stats.get('mesh_devices')}"
             f", want {MESH_WORLD}")
    if stats["active_slots"] or stats["in_flight_requests"]:
        fail(f"mesh {what}: slots still active after the bursts: {stats}")


def adapter_burst(port: int, work):
    """The adapter work as one concurrent burst; the replies."""
    replies = [None] * len(work)

    def call(i):
        adapter, prompt = work[i]
        name = "lm" if adapter is None else f"lm@{adapter}"
        replies[i] = post(port, {"instances": [{"tokens": prompt}]},
                          f"/model/{name}:predict")

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(work))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if None in replies:
        fail("a request of the mesh adapter burst did not complete")
    return replies


def mesh_serving(torch, flash, workdir: Path, base: Path, int8_base: Path,
                 adir: Path, prompts, alongside):
    """Phase 6i over REST: four servers of ``serving.main --mesh
    tensor=2``, 2 processes each on the card over gloo, at the engine's
    JAX CLI defaults, serving at once (each is latency-bound on its
    host-staged collectives; the card is idle most of the time): (a) the
    bf16 export: phase 6b's burst of eight, then phase 6d's 1024-token
    handoff from its single-device prefill tier into this decode tier;
    (b) the bf16 export with --speculative_tokens 4 and --adapters_dir:
    phase 6c's speculating burst, then phase 6g's adapter burst; (c)
    phase 6e's int8 export and its burst.  Checked: every request
    answered, each first generated token equal to the single-device
    phase's or a near tie (``mesh_compare``), the handoff's pages
    imported, at least one verify call, :stats mesh_devices 2, both
    ranks' slot-scalar digests equal at the end and both exiting 0.
    The servers' kernel launches are not counted here (``mesh_job``
    counts its ranks').  ``alongside()`` (the 2-rank job, ``mesh_job``)
    runs in a thread from the servers' start to past their bursts, its
    result kept under "job": the two are independent, and both are
    bound by the host's cores, not the card.  (d) the bf16 export with
    phase 6f's spill flags: 6f's sessions parked, their second turns
    (``mesh_streams``) and rank 0's :fetch_kv (``mesh_fetch``), spills
    and re-imports counted, no shed.  The phase within MESH_PHASE_S.
    Information: streams equal, TTFT and tokens/s (four servers and the
    job share the card and the host's cores)."""

    def ref(export, prompts_, adapters=None):
        return lambda i: mesh_ref_logits(
            torch, flash, export, prompts_[i],
            None if adapters is None else adapters[i], adir)

    def serve_base(port):
        out = {}
        replies, latencies, t_burst = burst(port, prompts)
        check_replies(prompts, replies, [], None)
        out["burst"] = dict(
            burst_info(prompts, latencies, t_burst,
                       get(port, "/model/lm:stats")["batcher"]),
            **mesh_compare("6b burst", prompts, replies, SERVED["6b"],
                           ref(base, prompts)))
        ho_prompt, wire, want = SERVED["6d"]
        streamed, ttft, t_total = stream_generate(
            port, {"tokens": ho_prompt, "kv_handoff": wire})
        if len(streamed) != MAX_NEW_TOKENS:
            fail(f"mesh decode tier streamed {len(streamed)} tokens")
        out["handoff"] = dict(mesh_compare(
            "6d handoff", [ho_prompt],
            [{"predictions": [{"tokens": ho_prompt + streamed}]}],
            [ho_prompt + want], ref(base, [ho_prompt])),
            ttft_s=ttft, latency_s=t_total)
        stats = get(port, "/model/lm:stats")["batcher"]
        check_mesh_stats("bf16", stats)
        if stats["handoff_pages_in"] != (HANDOFF_LEN - 16) // 16:
            fail(f"mesh decode tier imported {stats['handoff_pages_in']} "
                 "pages")
        return out

    def serve_spec(port):
        out = {}
        sprompts = spec_prompts(torch, SEED + 3)
        replies, latencies, t_burst = burst(port, sprompts)
        check_replies(sprompts, replies, [], None)
        out["spec"] = dict(
            burst_info(sprompts, latencies, t_burst,
                       get(port, "/model/lm:stats")["batcher"]),
            **mesh_compare("6c burst", sprompts, replies, SERVED["6c"],
                           ref(base, sprompts)))
        work = adapter_work(adapter_prompts(torch))
        wprompts = [p for _, p in work]
        replies = adapter_burst(port, work)
        check_replies(wprompts, replies, [], None)
        out["adapters"] = mesh_compare(
            "6g adapter burst", wprompts, replies, SERVED["6g"],
            ref(base, wprompts, [a for a, _ in work]))
        stats = get(port, "/model/lm:stats")["batcher"]
        check_mesh_stats("spec-adapters", stats)
        if stats["spec_steps"] <= 0:
            fail(f"the speculating mesh server ran no verify call: {stats}")
        out["spec_steps"] = stats["spec_steps"]
        return out

    def serve_int8(port):
        iprompts, want = SERVED["6e"]
        replies, latencies, t_burst = burst(port, iprompts)
        check_replies(iprompts, replies, [], None)
        stats = get(port, "/model/lm:stats")["batcher"]
        check_mesh_stats("int8", stats)
        return {"int8": dict(
            burst_info(iprompts, latencies, t_burst, stats),
            **mesh_compare("6e int8 burst", iprompts, replies, want,
                           ref(int8_base, iprompts)))}

    def serve_spill(port):
        six = SERVED["6f"]
        sessions = six["prompts"]
        replies, latencies, t_burst = burst(port, sessions,
                                            {"park_kv": True})
        check_replies(sessions, replies, [], None)
        out = {"parked": dict(
            burst_info(sessions, latencies, t_burst,
                       get(port, "/model/lm:stats")["batcher"]),
            **mesh_compare("6f parked first turns", sessions, replies,
                           six["turn1"], ref(base, sessions)))}
        # Each second turn on 6f's first-turn tokens, so its stream is
        # held to 6f's whole stream.
        contexts = [t + e for t, e in zip(six["turn1"], six["extra"])]
        replies, latencies, t_burst = burst(port, contexts)
        check_replies(contexts, replies, [], None)
        out["resumed"] = dict(
            burst_info(contexts, latencies, t_burst,
                       get(port, "/model/lm:stats")["batcher"]),
            **mesh_streams(torch, flash, base, contexts, replies,
                           six["turn2"]))
        stats = get(port, "/model/lm:stats")["batcher"]
        check_mesh_stats("spill", stats)
        if stats["kv_spill_pages_out"] <= 0 or stats["kv_spill_pages_in"] \
                <= 0 or stats["shed"] or stats["kv_shed_no_blocks"] \
                or stats["parked_sessions"] != len(sessions):
            fail(f"mesh spill tier: pages out "
                 f"{stats['kv_spill_pages_out']}, in "
                 f"{stats['kv_spill_pages_in']}, shed {stats['shed']}, kv "
                 f"shed {stats['kv_shed_no_blocks']}, parked "
                 f"{stats['parked_sessions']}")
        out["spill_stats"] = {k: stats[k] for k in (
            "kv_spill_pages_out", "kv_spill_pages_in", "host_tier_used",
            "parked_sessions", "kv_shed_no_blocks", "prefix_hits")}
        t0 = time.perf_counter()
        fetched = post(port, {"tokens": six["fetch_tokens"]},
                       "/model/lm:fetch_kv")
        out["spill_fetch"] = dict(mesh_fetch(torch, flash, base, fetched,
                                             six),
                            fetch_ms=(time.perf_counter() - t0) * 1e3)
        return out

    plan = {"bf16": (base, (), serve_base),
            "spec-adapters": (base, (
                "--speculative_tokens", str(SPEC_TOKENS), "--adapters_dir",
                str(adir), "--adapter_slots", "8", "--adapter_rank",
                str(ADAPTER_RANK)), serve_spec),
            "int8": (int8_base, (), serve_int8),
            "spill": (base, ("--kv_pool_blocks", str(SPILL_POOL),
                             "--host_spill_blocks", str(SPILL_HOST)),
                      serve_spill)}
    servers, results, info = {}, {}, {}
    t_phase = time.perf_counter()
    try:
        for name, (export, flags, _) in plan.items():
            servers[name] = start_mesh_server(workdir, name, export, *flags)

        def job():
            try:
                results["job"] = alongside()
            except BaseException as exc:  # noqa: BLE001 -- re-raised below
                results["job"] = exc

        job_thread = threading.Thread(target=job)
        job_thread.start()
        ports = {name: mesh_port(name, *procs)
                 for name, procs in servers.items()}

        def run(name):
            try:
                results[name] = plan[name][2](ports[name])
            except BaseException as exc:  # noqa: BLE001 -- re-raised below
                results[name] = exc

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(name,))
                   for name in plan]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        info["bursts_s"] = time.perf_counter() - t0
        job_thread.join(timeout=MESH_JOB_S + MESH_START_S)
        for name in ("job", *plan):
            out = results.get(name)
            if out is None:
                fail(f"the mesh server {name!r}'s requests did not finish"
                     if name in plan else "the tensor=2 job did not finish")
            if isinstance(out, BaseException):
                raise out
            if name == "job":
                info["job"] = out
            else:
                info.update(out)
    finally:
        stopped = None
        for name, (procs, errs) in servers.items():
            try:
                info[f"digests_{name}"] = stop_mesh_server(name, procs,
                                                           errs)
            except BaseException as exc:  # noqa: BLE001 -- stop the rest
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                stopped = stopped or exc
        if stopped is not None:
            raise stopped
    log_burst("mesh tensor=2 engine (6b's prompts)", info["burst"])
    log_burst("mesh tensor=2 speculating engine with adapters (6c's "
              "prompts)", info["spec"])
    log_burst("mesh tensor=2 int8 engine (6e's prompts)", info["int8"])
    log_burst("mesh tensor=2 spill tier, parked first turns (6f's "
              "sessions)", info["parked"])
    log_burst("mesh tensor=2 spill tier, second turns", info["resumed"])
    spill = info["spill_stats"]
    log(f"mesh spill tier: {len(SERVED['6f']['prompts'])} sessions parked "
        f"on a {SPILL_POOL}-page pool a rank: {spill['kv_spill_pages_out']} "
        f"pages spilled out, {spill['kv_spill_pages_in']} re-imported, "
        f"kv shed {spill['kv_shed_no_blocks']}; :fetch_kv on rank 0 "
        f"{info['spill_fetch']['fetch_ms']:.1f} ms (client clock)")
    log(f"mesh decode tier: phase 6d's handoff streamed {MAX_NEW_TOKENS} "
        f"tokens; TTFT {info['handoff']['ttft_s'] * 1e3:.1f} ms; "
        f"{info['spec_steps']} verify calls; the four servers' requests "
        f"took {info['bursts_s']:.1f} s together (client clock; "
        f"information only; {card_line()})")
    _REF_MODELS.clear()
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 6i took {info['phase_s']:.1f} s (bound {MESH_PHASE_S})")
    if info["phase_s"] > MESH_PHASE_S:
        fail(f"phase 6i took {info['phase_s']:.1f} s, over {MESH_PHASE_S}")
    return info


def mesh_job(torch, base: Path, captured):
    """Phase 6i in process: a 2-rank job on the engine's forward (the
    ranks share the card over gloo).  Checked: one 1024-token prompt's
    prefill logits at tensor=2 against tensor=1 on the same weights
    (rank 0 runs both) within the bounds beside MESH_WORLD: bf16
    against tensor=1 and against float32, float32 against tensor=1;
    the ranks' slot scalars equal after their rounds; no flash kernel
    launched by either rank (each counts its own).  Information (taken
    beside phase 6i's servers, ``mesh_serving``): one 64-token chunk and
    one fused round of 8 steps at 8 live slots (against 6b's captured
    and eager rounds at one rank, ``captured``), the collectives of each
    and their ms, one
    all-reduce alone over CUDA and over host tensors, one lockstep
    broadcast, busy share, pool bytes and peak memory a rank."""
    from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_ranks(
        ["-c", _MESH_DECODE_RANK, str(base), str(SEED + 21),
         str(HANDOFF_LEN), ",".join(map(str, PROMPT_LENS)),
         str(MAX_NEW_TOKENS), str(engine_prefill_width()), "8",
         str(CHUNK)],
        MESH_WORLD, timeout_s=MESH_JOB_S,
        cwd=str(Path(__file__).resolve().parent),
        env=dict(os.environ, KFT_DIST_BACKEND="gloo"), threads=MESH_THREADS)
    try:
        check_ranks(results)
    except RuntimeError as e:
        fail(f"the tensor=2 decode job failed: {e}")
    ranks = [json.loads(next(ln for ln in r.stdout.splitlines()
                             if ln.startswith("RESULT "))[7:])
             for r in results]
    info = {"job_s": time.perf_counter() - t0}
    for kind, lg in ranks[0]["logits"].items():
        log(f"mesh prefill logits of one {HANDOFF_LEN}-token prompt in "
            f"{kind}, tensor=2 against tensor=1 on the engine's forward: "
            f"max |diff| {lg['max_abs']:.4e}, mean {lg['mean_abs']:.4e}, "
            f"relative Frobenius {lg['rel_fro']:.4e}, argmax agreement "
            f"{lg['argmax_agree']:.4f}, last position's argmax equal "
            f"{lg['last_argmax_equal']}")
    lg, lf = ranks[0]["logits"]["bf16"], ranks[0]["logits"]["f32"]
    bound = MESH_TWO_PATHS * lg["tensor1_rel_fro_f32"]
    log(f"mesh prefill logits in bf16 against float32 (tensor=1): "
        f"tensor=1 relative Frobenius {lg['tensor1_rel_fro_f32']:.4e}, "
        f"mean |err| {lg['tensor1_mean_abs_f32']:.4e}; tensor=2 mean "
        f"|err| {lg['tensor2_mean_abs_f32']:.4e} (bounds: tensor=2 "
        f"against tensor=1 {bound:.4e} = {MESH_TWO_PATHS} x tensor=1's "
        f"distance; mean |err| {LOGITS_ERR_RATIO} x tensor=1's; float32 "
        f"relative Frobenius {MESH_F32_REL_FRO}, argmax agreement "
        f"{MESH_F32_ARGMAX})")
    if not lg["finite"] or lg["rel_fro"] > bound \
            or lg["tensor2_mean_abs_f32"] \
            > LOGITS_ERR_RATIO * lg["tensor1_mean_abs_f32"]:
        fail(f"tensor=2 bf16 prefill logits are not finite, further from "
             f"tensor=1's than {bound:.4e}, or further from float32 than "
             f"{LOGITS_ERR_RATIO} x tensor=1's: {lg}")
    if not (lf["finite"] and lf["last_argmax_equal"]
            and lf["rel_fro"] <= MESH_F32_REL_FRO
            and lf["argmax_agree"] >= MESH_F32_ARGMAX):
        fail(f"tensor=2 float32 prefill logits differ from tensor=1's "
             f"(bounds {MESH_F32_REL_FRO}, argmax {MESH_F32_ARGMAX}): "
             f"{lf}")
    if ranks[0]["scalars_sha256"] != ranks[1]["scalars_sha256"]:
        fail("the tensor=2 job's ranks hold different slot scalars after "
             "their rounds")
    launched = [r["flash_launches"] for r in ranks]
    if any(launched):
        fail(f"the tensor=2 job's ranks launched flash kernels {launched}: "
             "the engine attends through dot_product_attention")
    log(f"the tensor=2 job's ranks launched {launched} flash kernels "
        "(the engine attends through dot_product_attention)")
    info["logits"] = ranks[0]["logits"]
    info["ranks"] = [{k: v for k, v in r.items() if k != "logits"}
                     for r in ranks]
    for r in ranks:
        per, ch = r["collectives_per_step"], r["chunk_collectives"]
        busy = r["busy_ms"]
        share = ("not measured" if busy is None
                 else f"{busy / r['profiled_round_ms']:.3f}")
        alone = ", ".join(f"{k} {v:.3f} ms"
                          for k, v in r["reduce_alone_ms"].items())
        log(f"mesh rank {r['rank']}: fused round of {r['steps']} steps at "
            f"8 live slots {r['round_ms']:.2f} ms (median of 3; 6b's "
            f"captured {captured['captured']['round_ms']:.2f} ms, eager "
            f"{captured['eager']['round_ms']:.2f} ms at one rank); a "
            f"decode step {per['all_reduce']['calls']:.1f} all-reduces of "
            f"{per['all_reduce']['bytes'] / 1024:.1f} KiB in all, "
            f"{per['all_reduce']['ms']:.2f} ms, and "
            f"{per['all_gather']['calls']:.1f} all-gathers of "
            f"{per['all_gather']['bytes'] / 1024:.1f} KiB, "
            f"{per['all_gather']['ms']:.2f} ms (each synchronized to time "
            f"it); a {CHUNK}-token chunk {r['chunk_ms']:.2f} ms with "
            f"{ch['all_reduce']['calls']} all-reduces "
            f"({ch['all_reduce']['ms']:.2f} ms) and "
            f"{ch['all_gather']['calls']} all-gathers "
            f"({ch['all_gather']['ms']:.2f} ms); one all-reduce alone: "
            f"{alone}; one lockstep broadcast {r['broadcast_ms']:.3f} ms; "
            f"busy share {share}; pool {r['pool_bytes']} bytes for "
            f"{r['pool_blocks']} blocks; peak {r['peak_gib']:.2f} GiB "
            f"(host clock; gloo stages CUDA tensors through host memory, "
            f"both ranks on one GPU; information only; {card_line()})")
    return info


def check_replies(prompts, replies, direct, direct_reply):
    vocab = MODEL["vocab_size"]
    got = [r["predictions"][0]["tokens"] for r in replies]
    if direct_reply is not None:
        got += [p["tokens"] for p in direct_reply["predictions"]]
    for prompt, tokens in zip(list(prompts) + list(direct), got):
        if len(tokens) != len(prompt) + MAX_NEW_TOKENS:
            fail(f"reply of {len(tokens)} tokens for a {len(prompt)}-token "
                 f"prompt, expected {len(prompt) + MAX_NEW_TOKENS}")
        if tokens[:len(prompt)] != prompt:
            fail("a reply does not start with its prompt")
        if not all(0 <= t < vocab for t in tokens):
            fail("a reply holds tokens outside the vocabulary")
    log(f"replies: {len(got)} rows, each prompt + {MAX_NEW_TOKENS} tokens in "
        f"[0, {vocab})")


def load_model(torch, base: Path, dtype):
    """The exported model on the card, weights narrowed to bf16 as the
    loader stages them, computing in ``dtype``."""
    from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from kubeflow_tpu_torch.ops.quantize import narrow_params
    from kubeflow_tpu_torch.serving.export import PARAMS_FILE, msgpack_restore

    tree = msgpack_restore((base / "1" / PARAMS_FILE).read_bytes())
    params = narrow_params(params_from_jax(tree["params"]), torch.bfloat16)
    cfg = TransformerConfig(**dict(MODEL, dtype=dtype))
    return load_params(Transformer(cfg, device="meta"), params).cuda()


def padded_batch(torch, gen):
    """One bucketed batch at the largest bucket: left-padded tokens, real
    lengths and pad widths."""
    width = 2048
    lengths = torch.tensor([2048, 1500, 900, 300], device="cuda")
    tokens = torch.randint(1, MODEL["vocab_size"], (4, width), device="cuda",
                           generator=gen)
    pad = width - lengths
    tokens[torch.arange(width, device="cuda")[None, :] < pad[:, None]] = 0
    return tokens, lengths, pad


def check_prefill_logits(torch, flash, base: Path, gen) -> None:
    """Phase 5: one left-padded prefill of the bf16 model through the
    kernel and through the plain version, each held to a float32 run of
    the same weights (plain attention) at the real positions."""
    from kubeflow_tpu_torch.models.generate import (
        _forward_with_cache,
        init_cache,
    )

    tokens, lengths, pad = padded_batch(torch, gen)
    width = tokens.shape[1]
    real = torch.arange(width, device="cuda")[None, :] >= pad[:, None]

    def prefill(dtype):
        model = load_model(torch, base, dtype)
        with torch.inference_mode():
            return _forward_with_cache(
                model, tokens, init_cache(model.cfg, 4, width, device="cuda"),
                0, pad_amount=pad)[real]

    before = flash.launch_counts["flash_fwd_masked"]
    through_kernel = prefill(torch.bfloat16)
    if flash.launch_counts["flash_fwd_masked"] != before + MODEL["n_layers"]:
        fail("the padded prefill did not launch the masked kernel per layer")
    with plain_kernels(flash):
        through_plain = prefill(torch.bfloat16)
        reference = prefill(torch.float32)
    for name, logits in (("kernel", through_kernel), ("plain", through_plain)):
        if not torch.isfinite(logits).all():
            fail(f"non-finite prefill logits through the {name} path")
    err_k = (through_kernel - reference).abs()
    err_p = (through_plain - reference).abs()
    top_ref = reference.argmax(-1)
    log(f"prefill logits, padded batch lengths {lengths.tolist()} at bucket "
        f"{width}, {int(real.sum())} real positions, against float32: "
        f"kernel path mean |err| {err_k.mean().item():.4e} max "
        f"{err_k.max().item():.4e} argmax agreement "
        f"{(through_kernel.argmax(-1) == top_ref).float().mean().item():.4f}"
        f"; plain path mean |err| {err_p.mean().item():.4e} max "
        f"{err_p.max().item():.4e} argmax agreement "
        f"{(through_plain.argmax(-1) == top_ref).float().mean().item():.4f}"
        f"; max |kernel - plain| "
        f"{(through_kernel - through_plain).abs().max().item():.4e} "
        f"(bound: kernel mean error <= {LOGITS_ERR_RATIO} x plain)")
    if err_k.mean() > LOGITS_ERR_RATIO * err_p.mean():
        fail("prefill logits through the kernel are further from float32 "
             "than through the plain version")


def breakdown(torch, base: Path, gen) -> None:
    """Phase 6, information only: where the time of one bucketed batch
    goes in generate(): prefill and decode wall time (host clock after a
    synchronize), then, under torch.profiler, the device's busy share and
    the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeConfig,
        _forward_with_cache,
        generate,
        init_cache,
    )

    model = load_model(torch, base, torch.bfloat16)
    tokens, lengths, pad = padded_batch(torch, gen)
    decode = DecodeConfig(max_new_tokens=MAX_NEW_TOKENS)

    def run():
        out, _ = generate(model, tokens, decode, prompt_len=lengths)
        torch.cuda.synchronize()
        return out

    def prefill():
        with torch.inference_mode():
            _forward_with_cache(
                model, tokens,
                init_cache(model.cfg, 4, tokens.shape[1] + MAX_NEW_TOKENS,
                           device="cuda"), 0, pad_amount=pad)
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    prefill()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    t_total = time.perf_counter() - t0
    step_ms = (t_total - t_prefill) / MAX_NEW_TOKENS * 1e3
    log(f"breakdown, batch of 4 at bucket {tokens.shape[1]}, "
        f"{MAX_NEW_TOKENS} new tokens: generate {t_total * 1e3:.1f} ms = "
        f"prefill {t_prefill * 1e3:.1f} ms + {MAX_NEW_TOKENS} decode steps "
        f"of {step_ms:.2f} ms (host clock)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        t_prof = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log("breakdown: the profiler saw no device time; device busy share "
            "not measured")
        return
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_fwd_kernel" in e.key)
    log(f"breakdown under torch.profiler: wall {t_prof * 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({busy_us / (t_prof * 1e6):.3f}"
        f" of the profiled wall, {busy_us / (t_total * 1e6):.3f} of the "
        f"unprofiled one), flash_fwd kernel {flash_us / 1e3:.3f} ms "
        f"({flash_us / busy_us:.3f} of busy)")
    for e in kernels[:6]:
        log(f"  {e.self_device_time_total / busy_us:.3f} of busy, "
            f"{e.count} launches: {e.key[:100]}")


def step_stats(records, tokens):
    """Median step time of the logged records, and MFU at ``tokens`` a
    step (3 x flops_per_token x tokens over the bf16 peak)."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    step_s = sorted(r["step_time_s"] for r in records)
    step_s = step_s[len(step_s) // 2]
    cfg = TransformerConfig(**{k: v for k, v in MODEL.items()
                               if k not in ("dtype",)})
    return step_s, 3 * cfg.flops_per_token() * tokens / step_s \
        / PEAK_BF16_FLOPS


def train(torch, flash, workdir: Path):
    """Phase 7: the port's training entry point on the bench LM config
    (``train_lm.run``, the work of ``train_lm.main``, which returns the
    trainer and so its last step's metrics)."""
    from kubeflow_tpu_torch.tools import train_lm

    out = workdir / "train_metrics.json"
    argv = TRAIN_FLAGS + ["--steps", str(TRAIN_STEPS), "--log-every", "1",
                          "--max-restarts", "0", "--metrics-out", str(out)]
    torch.cuda.reset_peak_memory_stats()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    trainer = train_lm.run(argv)
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = MODEL["n_layers"] * TRAIN_STEPS
    log(f"kernel launches on the training path ({TRAIN_STEPS} steps): "
        f"{counts} (want {want} = {MODEL['n_layers']} layers x "
        f"{TRAIN_STEPS} steps of each of {', '.join(TRAIN_KERNELS)})")
    bad = [k for k in TRAIN_KERNELS if counts[k] != want]
    if bad:
        fail(f"training-path kernels launched the wrong number of times: "
             f"{bad}")
    history = json.loads(out.read_text())["history"]
    losses = [r["loss"] for r in history]
    last = trainer.last_metrics
    if len(losses) != TRAIN_STEPS or not all(
            map(math.isfinite,
                losses + [last.get("grad_norm", float("nan"))])):
        fail(f"non-finite or missing training metrics: losses {losses}, "
             f"last {last}")
    # Steps 0-1 carry one-off start-up (cuBLAS handles, allocator growth).
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s, mfu = step_stats(history[2:], tokens)
    log(f"train: {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"losses {[round(x, 4) for x in losses]}, last grad_norm "
        f"{last['grad_norm']:.4f}; median step {step_s * 1e3:.1f} ms over "
        f"steps 2-{TRAIN_STEPS - 1} (host clock after a sync each step), "
        f"{tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} (3 x "
        f"flops_per_token x tokens / {PEAK_BF16_FLOPS:.3g}), peak memory "
        f"{peak_gib:.2f} GiB (information only)")
    return counts, {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                    "mfu": mfu, "peak_gib": peak_gib, "losses": losses}


def train_two_pass(torch, flash):
    """Phase 7b: bench.py's LM cell with --flash-block-diag 256
    --optimizer adafactor --steps-per-call 2, built as bench_lm builds it
    (lm_task and Trainer over one repeated random batch), launch counters
    zeroed just before fit and read just after: flash_fwd_full,
    flash_fwd_diag, flash_dq and flash_dkv 12 times a step each,
    flash_fwd never."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.train import Trainer

    bq, bk, bd = TWO_PASS_BLOCKS
    cfg = TransformerConfig(**dict(
        MODEL, max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16, remat=True,
        flash_block_q=bq, flash_block_k=bk, flash_block_diag=bd))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adafactor(1e-3), device="cuda",
                      flops_per_example=cfg.flops_per_token() * TRAIN_SEQ,
                      peak_flops_per_chip=PEAK_BF16_FLOPS)
    state = trainer.create_state()
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, size=(
        TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    trainer.fit(itertools.repeat(batch), TWO_PASS_STEPS, state=state,
                examples_per_step=TRAIN_BATCH, log_every=1,
                steps_per_call=TWO_PASS_STEPS_PER_CALL)
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = MODEL["n_layers"] * TWO_PASS_STEPS
    log(f"kernel launches on the two-pass training path ({TWO_PASS_STEPS} "
        f"steps): {counts} (want {want} of each of "
        f"{', '.join(TWO_PASS_KERNELS)}, 0 of flash_fwd)")
    bad = [k for k in TWO_PASS_KERNELS if counts[k] != want]
    if bad or counts["flash_fwd"] or counts["flash_fwd_masked"]:
        fail(f"two-pass training launched the wrong kernels: {counts}")
    history = trainer.metrics.history
    losses = [r["loss"] for r in history]
    last = trainer.last_metrics
    if len(losses) != TWO_PASS_STEPS // TWO_PASS_STEPS_PER_CALL or not all(
            map(math.isfinite, losses + [last.get("grad_norm", math.nan)])):
        fail(f"non-finite or missing two-pass training metrics: losses "
             f"{losses}, last {last}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # The first call carries one-off start-up.
    step_s, mfu = step_stats(history[1:], tokens)
    log(f"train two-pass: {TWO_PASS_STEPS} steps ({TWO_PASS_STEPS_PER_CALL}"
        f" a call) of batch {TRAIN_BATCH} x {TRAIN_SEQ}, adafactor 1e-3, "
        f"blocks {TWO_PASS_BLOCKS}: losses {[round(x, 4) for x in losses]}, "
        f"last grad_norm {last['grad_norm']:.4f}; median step "
        f"{step_s * 1e3:.1f} ms over calls 2-{len(history)} (host clock "
        f"after a sync each call), {tokens / step_s:.0f} tokens/s, MFU "
        f"{mfu:.4f}, peak memory {peak_gib:.2f} GiB (information only)")
    return counts, {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                    "mfu": mfu, "peak_gib": peak_gib, "losses": losses}


def train_moe(torch, flash):
    """Phase 7c: bench.py's lm_moe cell through lm_task and Trainer on
    one repeated batch: warm-up, then MOE_STEPS steps with the launch
    counters zeroed just before and read just after (flash_fwd,
    flash_dq and flash_dkv 12 times a step each); loss and moe_aux
    finite, the loss falling by MOE_LEARN_NATS; then, information only,
    one profiled step; last, one MoE layer under each dispatch held to
    its references and timed (moe_layer)."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.train import Trainer

    cfg = TransformerConfig(**dict(MODEL, **MOE, max_seq_len=TRAIN_SEQ,
                                   dtype=torch.bfloat16, remat=True,
                                   remat_policy="nobatch"))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adafactor(MOE_LR), device="cuda",
                      flops_per_example=cfg.flops_per_token() * TRAIN_SEQ,
                      peak_flops_per_chip=PEAK_BF16_FLOPS)
    state = trainer.create_state(SEED)
    n_params = sum(p.numel() for p in state.params.parameters())
    rng = np.random.RandomState(SEED)
    batch = {"tokens": rng.randint(0, LEARN_VOCAB, size=(
        TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    state = trainer.fit(itertools.repeat(batch), MOE_WARMUP, state=state,
                        log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    state = trainer.fit(itertools.repeat(batch), MOE_STEPS, state=state,
                        examples_per_step=TRAIN_BATCH, log_every=1)
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = MODEL["n_layers"] * MOE_STEPS
    log(f"kernel launches on the MoE training path ({MOE_STEPS} steps): "
        f"{counts} (want {want} of each of {', '.join(TRAIN_KERNELS)})")
    bad = [k for k in TRAIN_KERNELS if counts[k] != want]
    if bad:
        fail(f"MoE training launched the wrong number of kernels: {bad}")
    history = trainer.metrics.history
    losses = [r["loss"] for r in history]
    last = trainer.last_metrics
    finite = losses + [last.get("grad_norm", math.nan),
                       last.get("moe_aux", math.nan)]
    if len(losses) != MOE_WARMUP + MOE_STEPS or not all(
            map(math.isfinite, finite)):
        fail(f"non-finite or missing MoE training metrics: losses {losses},"
             f" last {last}")
    log(f"MoE learning: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(losses)} steps on one repeated batch (bound: a drop of at "
        f"least {MOE_LEARN_NATS} nat); last moe_aux {last['moe_aux']:.4f}")
    if not losses[-1] <= losses[0] - MOE_LEARN_NATS:
        fail("the MoE LM did not learn a repeated batch")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = sorted(r["step_time_s"] for r in history[MOE_WARMUP:])
    step_s = step_s[len(step_s) // 2]
    mfu = 3 * cfg.flops_per_token() * tokens / step_s / PEAK_BF16_FLOPS
    log(f"train MoE ({n_params / 1e6:.1f}M parameters, 4 experts top-2, "
        f"capacity 1.25, einsum dispatch in groups of 128, adafactor "
        f"{MOE_LR}): median step {step_s * 1e3:.1f} ms over {MOE_STEPS} "
        f"steps (host clock after a sync each step), {tokens / step_s:.0f}"
        f" tokens/s, MFU {mfu:.4f} (3 x flops_per_token "
        f"{cfg.flops_per_token():.4g} x tokens / {PEAK_BF16_FLOPS:.3g}), "
        f"peak memory {peak_gib:.2f} "
        f"GiB (information only)")
    step = trainer.compile_step()
    staged = trainer.shard_batch(batch)

    def one():
        nonlocal state
        state, _ = step(state, staged)
        torch.cuda.synchronize()

    one()
    busy = profile_busy(torch, one, "MoE training step")
    del trainer, state, staged
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                    "mfu": mfu, "peak_gib": peak_gib, "losses": losses,
                    "moe_aux": last["moe_aux"], "params": n_params,
                    "profile": busy, "layer": moe_layer(torch)}


def moe_layer(torch):
    """One MoE layer at the cell's shape ([8, 2048, 1024], one seed's
    weights), held to references, then timed.

    Checks (the phase fails on any): in each of MOE_LAYER_CASES (einsum
    and gather at group 128, gather at 256, and both dispatches at
    capacity 0.5, which drops many choices) the float32 layer on the card,
    run on the whole input, equals the float32 layer on the CPU, run on
    the batch row with the most choices dropped past capacity, within
    MOE_F32_REL_TOL of the reference's largest magnitude (routing groups
    never cross rows, so that row routes alone as it does in the batch;
    a token routed, slotted or dropped otherwise on the card moves its
    row by O(1)); the aux of that row alike; the bf16
    layer on the card within MOE_BF16_REL_TOL of the same reference; the
    bf16 gather output within MOE_DISPATCH_ULPS bf16 ulps (at the einsum
    output's largest magnitude) of the bf16 einsum output at group 128.
    Then each bf16 layer's forward and backward, CUDA events
    (information only)."""
    from kubeflow_tpu_torch.models.moe import MoEMLP

    d, f = MODEL["d_model"], MODEL["d_ff"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, d), device="cuda",
                    generator=gen).to(torch.bfloat16)
    cot = torch.randn((TRAIN_BATCH, TRAIN_SEQ, d), device="cuda",
                      generator=gen).to(torch.bfloat16)
    x_cpu = x.float().cpu()
    n_exp, top_k = MOE["moe_experts"], MOE["moe_top_k"]

    def make(impl, group, cf, dtype, weights=None):
        """The seeded layer on the card, or one holding ``weights``
        (float32 tensors, on the device they lie on)."""
        kw = dict(group_size=group, capacity_factor=cf, dtype=dtype,
                  impl=impl)
        if weights is None:
            return MoEMLP(d, f, MOE["moe_experts"], device="cuda",
                          generator=torch.Generator(
                              device="cuda").manual_seed(SEED), **kw)
        layer = MoEMLP(d, f, MOE["moe_experts"], device="meta", **kw)
        layer.load_state_dict(weights, assign=True)
        return layer

    rows, einsum_out, bad = {}, None, []
    for impl, group, cf in MOE_LAYER_CASES:
        key = f"{impl}_{group}" + (
            "" if cf == MOE["moe_capacity_factor"] else f"_cf{cf}")
        layer = make(impl, group, cf, torch.bfloat16)
        weights = {k: v.detach().clone() for k, v in
                   layer.state_dict().items()}
        with torch.no_grad():
            y, _ = layer(x)
            cpu32 = make(impl, group, cf, torch.float32, {
                k: v.cpu() for k, v in weights.items()})
            # The row with the most choices dropped past capacity (routed
            # on the CPU), so the comparison covers the drop path.
            *_, routes = cpu32._route(x_cpu.reshape(-1, group, d), max(
                top_k, math.ceil(group * top_k / n_exp * cf)))
            dropped = sum((~keep).int() for *_, keep in routes).reshape(
                TRAIN_BATCH, -1).sum(1)
            r = int(dropped.argmax())
            ref, ref_aux = cpu32(x_cpu[r:r + 1])
            scale = ref.abs().max().item()
            card32 = make(impl, group, cf, torch.float32, weights)
            y32, _ = card32(x.float())
            _, aux32 = card32(x[r:r + 1].float())
            del card32
        err32 = (y32[r:r + 1].cpu() - ref).abs().max().item() / scale
        aux_err = abs(aux32.item() - ref_aux.item()) / abs(ref_aux.item())
        err16 = (y[r:r + 1].float().cpu() - ref).abs().max().item() / scale
        del y32
        if key == "einsum_128":
            einsum_out = y
        xx = x.detach().requires_grad_()

        def fwd_bwd():
            out, aux = layer(xx)
            torch.autograd.backward((out, aux), (cot, torch.ones_like(aux)))

        rows[key] = {
            "fwd_bwd_ms": time_ms(torch, fwd_bwd, MOE_LAYER_REPS),
            "fwd_ms": time_ms(torch, lambda: layer(x), MOE_LAYER_REPS),
            "f32_card_vs_cpu_rel": err32, "aux_card_vs_cpu_rel": aux_err,
            "bf16_vs_f32_rel": err16, "ref_max_abs": scale, "row": r,
            "row_choices_dropped": int(dropped[r]),
            "choices_dropped": int(dropped.sum())}
        if max(err32, aux_err) > MOE_F32_REL_TOL:
            bad.append(f"{key}: float32 on the card vs the CPU {err32:.3e},"
                       f" aux {aux_err:.3e} (bound {MOE_F32_REL_TOL})")
        if err16 > MOE_BF16_REL_TOL:
            bad.append(f"{key}: bf16 vs float32 {err16:.3e} (bound "
                       f"{MOE_BF16_REL_TOL})")
        if key == "gather_128":
            peak = einsum_out.float().abs().max().item()
            ulp = 2.0 ** (math.floor(math.log2(peak)) - 7)
            diff = (y.float() - einsum_out.float()).abs().max().item()
            rows[key].update(max_abs_diff_from_einsum=diff,
                             einsum_max_abs=peak, bf16_ulp_at_max=ulp)
            if diff > MOE_DISPATCH_ULPS * ulp:
                bad.append(f"gather vs einsum at group 128: {diff:.3e} "
                           f"(bound {MOE_DISPATCH_ULPS} x {ulp:.3e})")
        del layer, xx, y
    ratio = rows["einsum_128"]["fwd_bwd_ms"] / rows["gather_128"]["fwd_bwd_ms"]
    vs = rows["gather_128"]
    log("MoE layer at [8, 2048, 1024]: float32 on the card vs the CPU on "
        "one batch row, max |err| / max |ref|: " + ", ".join(
            f"{k} {v['f32_card_vs_cpu_rel']:.3e} (aux "
            f"{v['aux_card_vs_cpu_rel']:.3e}), bf16 {v['bf16_vs_f32_rel']:.3e}"
            f" (row {v['row']}, {v['row_choices_dropped']} of the batch's "
            f"{v['choices_dropped']} dropped choices, max |ref| "
            f"{v['ref_max_abs']:.4f})" for k, v in rows.items())
        + f"; bounds {MOE_F32_REL_TOL} and {MOE_BF16_REL_TOL}; bf16 gather "
        f"vs einsum at group 128 {vs['max_abs_diff_from_einsum']:.3e} "
        f"(bound {MOE_DISPATCH_ULPS} x the bf16 ulp "
        f"{vs['bf16_ulp_at_max']:.3e} at max |out| "
        f"{vs['einsum_max_abs']:.4f})")
    log("MoE layer at [8, 2048, 1024] bf16, forward + backward (CUDA "
        "events, median of 5): " + ", ".join(
            f"{k} {v['fwd_bwd_ms']:.3f} ms (forward {v['fwd_ms']:.3f})"
            for k, v in rows.items())
        + f"; einsum / gather_128 {ratio:.3f} (information only)")
    if bad:
        fail("the MoE layer on the card disagrees with its references: "
             + "; ".join(bad))
    return rows


def dropout_phase(torch, flash):
    """Phase 7d: dropout 0.1 on the dense 188M LM at 8 x 2048: one
    training step's gradients (lm_task forward and backward) with remat
    on and off from one generator seed within DROPOUT_REMAT_REL_TOL
    (relative Frobenius), two runs at one seed with equal losses and
    another seed with another loss, and flash_fwd, flash_dq and
    flash_dkv 12 times in the step."""
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        lm_task,
    )

    base = dict(MODEL, max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16,
                dropout_rate=DROPOUT_RATE)
    model = Transformer(TransformerConfig(**base, remat=True), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            SEED))
    plain = Transformer(TransformerConfig(**base, remat=False),
                        device="meta")
    plain.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()}, assign=True)
    tokens = torch.randint(0, MODEL["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(SEED + 2))

    def step(m, seed):
        _, loss_fn = lm_task(m.cfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(m, {}, {"tokens": tokens}, gen)
        loss.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.item(), flat, dt

    step(model, SEED)  # warm-up
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    loss_a, g_a, t_a = step(model, SEED)
    counts = dict(flash.launch_counts)
    want = MODEL["n_layers"]
    log(f"kernel launches in one dropout training step: {counts} (want "
        f"{want} of each of {', '.join(TRAIN_KERNELS)})")
    if any(counts[k] != want for k in TRAIN_KERNELS):
        fail(f"the dropout step launched the wrong kernels: {counts}")
    loss_b, g_b, t_b = step(plain, SEED)
    rel = ((g_a - g_b).norm() / g_b.norm()).item()
    loss_c, g_c, _ = step(model, SEED)
    loss_d, _, _ = step(model, SEED + 1)
    log(f"dropout {DROPOUT_RATE}, batch {TRAIN_BATCH} x {TRAIN_SEQ}: loss "
        f"remat on {loss_a:.6f}, off {loss_b:.6f}; gradients remat on vs "
        f"off relative Frobenius {rel:.3e} (bound {DROPOUT_REMAT_REL_TOL}; "
        f"bit-equal {torch.equal(g_a, g_b)}); same seed again {loss_c:.6f}"
        f" (gradients bit-equal {torch.equal(g_a, g_c)}), seed + 1 "
        f"{loss_d:.6f}; step {t_a * 1e3:.1f} ms remat on, "
        f"{t_b * 1e3:.1f} ms off (host clock after a sync, information "
        f"only)")
    if not (math.isfinite(loss_a) and rel <= DROPOUT_REMAT_REL_TOL):
        fail("dropout gradients with remat on differ from remat off")
    if loss_c != loss_a or loss_d == loss_a:
        fail("dropout is not determined by its generator seed")
    del model, plain, g_a, g_b, g_c
    torch.cuda.empty_cache()
    return counts, {"loss": loss_a, "remat_rel_err": rel,
                    "step_ms_remat": t_a * 1e3, "step_ms_no_remat": t_b * 1e3}


def hfta_members():
    from kubeflow_tpu_torch.runtime.hfta import MemberSpec

    return [MemberSpec(name=f"m{i}", seed=i, lr=HFTA_LR * (i + 1),
                       stop_step=HFTA_STOP if i == 1 else None)
            for i in range(HFTA_MEMBERS)]


class _CaptureGrads:
    """The fused trainer's optimizer, keeping a float32 copy of the
    stacked gradients it is handed (the solo comparison reads them)."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def update_members(self, grads, state, params, keep):
        self.grads = {k: g.float().clone() for k, g in grads.items()}
        self.tx.update_members(grads, state, params, keep)


def hfta_against_solo(torch, trainer, states, batch, loss_fn):
    """One fused step from ``states`` (solo member states at the warm-up's
    end) against each member's solo step on the same weights and batch:
    loss difference and relative Frobenius error of all gradients."""
    capture = _CaptureGrads(trainer._tx)
    trainer._tx = capture
    trainer.fit(itertools.repeat(batch), HFTA_WARMUP + 1,
                member_states=states, log_every=1)
    trainer._tx = capture.tx
    fused_losses = [trainer.last_metrics[f"loss/m{i}"]
                    for i in range(HFTA_MEMBERS)]
    tokens = {"tokens": torch.as_tensor(batch["tokens"], device="cuda")}
    rows = []
    for i, st in enumerate(states):
        model = st.params
        loss, _ = loss_fn(model, {}, tokens, st.rng)
        loss.backward()
        named = dict(model.named_parameters())
        num = sum((named[k].grad.float() - g[i]).square().sum()
                  for k, g in capture.grads.items())
        den = sum(g[i].square().sum() for g in capture.grads.values())
        rows.append({"loss_fused": fused_losses[i], "loss_solo": loss.item(),
                     "grad_rel_err": (num / den).sqrt().item()})
        model.zero_grad(set_to_none=True)
    del capture
    for i, row in enumerate(rows):
        log(f"hfta m{i}: one fused step against a solo step on the same "
            f"weights and batch: loss {row['loss_fused']:.6f} / "
            f"{row['loss_solo']:.6f}, gradients relative Frobenius "
            f"{row['grad_rel_err']:.3e} (bounds {HFTA_LOSS_ATOL} and "
            f"{HFTA_GRAD_REL_TOL})")
        if not (abs(row["loss_fused"] - row["loss_solo"]) <= HFTA_LOSS_ATOL
                and row["grad_rel_err"] <= HFTA_GRAD_REL_TOL):
            fail(f"fused member m{i} disagrees with its solo step")
    return rows


def hfta_folded_kernels(torch, flash):
    """The members' folded call at the phase's shape: 4 members of [8,
    2048, 8 heads of 128] on one launch of each kernel at bh 256, o and
    lse against the forward's plain version per member, dq, dk and dv
    (the backward of the retained graph) against the backward's plain
    version on the kernel's own o and lse, within phase 2's bounds."""
    from torch.func import vmap

    m, bh = HFTA_MEMBERS, TRAIN_BATCH * MODEL["n_heads"]
    d = MODEL["head_dim"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v, g = (torch.randn(m, bh, TRAIN_SEQ, d, device="cuda",
                              generator=gen).bfloat16() for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(flash.launch_counts)
    o, lse = vmap(lambda a, b, c: flash._FlashFunction.apply(
        a, b, c, True, 512, 512, 0))(q, k, v)
    o.backward(g)
    torch.cuda.synchronize()
    once = {n: flash.launch_counts[n] - before[n] for n in TRAIN_KERNELS}
    if once != {n: 1 for n in TRAIN_KERNELS}:
        fail(f"the folded call did not launch each kernel once: {once}")
    worst = {"o": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for i in range(m):
        qi, ki, vi = q[i].detach(), k[i].detach(), v[i].detach()
        ro, rlse = flash.flash_fwd_reference(qi.float(), ki.float(),
                                             vi.float(), causal=True)
        row = compare_out(torch, "flash_fwd", o[i].detach(), lse[i], ro,
                          rlse, f"hfta member {i} of {m}, folded bh "
                          f"{m * bh}")
        worst["o"] = max(worst["o"], row["rel_err_o"])
        worst["lse"] = max(worst["lse"], row["max_abs_err_lse"])
        del ro, rlse
        delta = (g[i].float() * o[i].detach().float()).sum(-1)
        want = flash.flash_bwd_reference(qi, ki, vi, g[i], lse[i].detach(),
                                         delta, causal=True)
        for name, got, ref in zip(("dq", "dk", "dv"),
                                  (q.grad[i], k.grad[i], v.grad[i]), want):
            rel, mx, ok, finite = _bwd_errors(torch, got, ref)
            worst[name] = max(worst[name], rel)
            if not (ok and finite and rel <= BWD_REL_TOL):
                fail(f"folded {name} of member {i} disagrees with the plain "
                     f"version: relative {rel:.3e}, max {mx:.3e}")
        del want
    log(f"hfta folded kernels at bh {m * bh} ({m} members x {bh}): one "
        f"launch each of {', '.join(TRAIN_KERNELS)}; worst member: o "
        f"relative {worst['o']:.3e}, lse {worst['lse']:.3e}, dq "
        f"{worst['dq']:.3e}, dk {worst['dk']:.3e}, dv {worst['dv']:.3e} "
        f"(bounds {O_REL_TOL}, {LSE_ATOL}, {BWD_REL_TOL})")
    del q, k, v, g, o, lse
    torch.cuda.empty_cache()
    return worst


def ring_phase(torch, flash, workdir: Path):
    """Phase 7f (a): the ring on RING_WORLD processes sharing the one GPU
    against the kernel on the whole sequence and float32 attention, with
    its launches per live hop.  Returns the causal case's launches
    summed over the ranks, and the readings."""
    from kubeflow_tpu_torch.testing import ring_check

    torch.cuda.empty_cache()  # the ranks share the card with this process
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h, d = MODEL["n_heads"], MODEL["head_dim"]

    def draw(heads):
        return torch.randn((1, RING_SEQ, heads, d), generator=gen,
                           device="cuda").to(torch.bfloat16)

    cases = {name: {"q": draw(h), "k": draw(hkv), "v": draw(hkv),
                    "g": draw(h), "causal": causal}
             for name, (hkv, causal) in RING_CASES.items()}
    jobdir = workdir / "ring"
    jobdir.mkdir()
    t0 = time.perf_counter()
    results = ring_check.run_job(jobdir, cases, RING_WORLD, "cuda",
                                 time_reps=RING_TIME_REPS,
                                 timeout_s=RING_JOB_TIMEOUT_S)
    job_s = time.perf_counter() - t0
    shutil.rmtree(jobdir, ignore_errors=True)
    info = {"world": RING_WORLD, "seq": RING_SEQ, "job_s": job_s,
            "cases": {}}
    for name, c in cases.items():
        args = [c[x] for x in "qkvg"]
        launches = ring_check.totals(results, name, "launches")
        hops = (RING_WORLD * (RING_WORLD + 1) // 2 if c["causal"]
                else RING_WORLD * RING_WORLD)
        want = {k: 0 for k in flash.launch_counts}
        want.update(flash_fwd=hops, flash_dq=hops, flash_dkv=hops)
        log(f"ring {name} (kv heads {c['k'].shape[2]}, causal "
            f"{c['causal']}): launches over {RING_WORLD} ranks {launches}"
            f" (want {hops} each of flash_fwd, flash_dq, flash_dkv)")
        if launches != want:
            fail(f"ring {name}: launches {launches}, want {want}")
        whole = ring_check.whole_sequence(*args, c["causal"])
        f32 = ring_check.reference_f32(*args, c["causal"])
        errs = {}
        for i, key in enumerate(("o", "dq", "dk", "dv")):
            got = ring_check.gathered(results, name, key)
            errs[key] = {"kernel": ring_check.rel_err(got, whole[i]),
                         "f32": ring_check.rel_err(got, f32[i]),
                         "whole_f32": ring_check.rel_err(whole[i], f32[i])}
        log(f"ring {name}: relative Frobenius error of the ring against "
            "the whole-sequence kernel / float32 (the kernel's own against"
            " float32): " + ", ".join(
                f"{k} {e['kernel']:.3e} / {e['f32']:.3e} "
                f"({e['whole_f32']:.3e})" for k, e in errs.items())
            + f" (bounds {RING_KERNEL_REL_TOL} / {RING_F32_REL_TOL['o']})")
        bad = [k for k, e in errs.items()
               if not (e["kernel"] < RING_KERNEL_REL_TOL
                       and e["f32"] < RING_F32_REL_TOL[k])]
        if bad:
            fail(f"ring {name}: {bad} outside the bounds: {errs}")
        del f32
        q, k, v = (t.detach().clone().requires_grad_() for t in args[:3])
        with torch.no_grad():
            single_fwd = time_ms(torch, lambda: flash.flash_attention(
                q, k, v, causal=c["causal"]), RING_TIME_REPS)
        o = flash.flash_attention(q, k, v, causal=c["causal"])
        single_bwd = time_ms(torch, lambda: torch.autograd.grad(
            o, (q, k, v), args[3], retain_graph=True), RING_TIME_REPS)
        fwd = [r[name]["fwd_ms"] for r in results]
        bwd = [r[name]["bwd_ms"] for r in results]
        log(f"ring {name}: forward ms per rank {[round(x, 3) for x in fwd]}"
            f", backward {[round(x, 3) for x in bwd]}; one process on the "
            f"whole sequence: forward {single_fwd:.3f}, backward "
            f"{single_bwd:.3f} ms (CUDA events; the {RING_WORLD} ranks "
            "time-share one GPU and stage hops through host memory: no "
            "scaling figure; information only)")
        info["cases"][name] = {"errors": errs, "launches": launches,
                               "rank_fwd_ms": fwd, "rank_bwd_ms": bwd,
                               "single_fwd_ms": single_fwd,
                               "single_bwd_ms": single_bwd}
    return ring_check.totals(results, "causal", "launches"), info


# One rank of the ring trainer: tools/train_lm.run with its own metrics
# file, then its launch counts.
_RING_TRAIN_RANK = r"""
import json, os, sys
import torch
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.tools import train_lm
rank = os.environ["KFT_PROCESS_ID"]
train_lm.run(sys.argv[2:] + ["--metrics-out", f"{sys.argv[1]}/rank{rank}.json"])
torch.cuda.synchronize()
print("LAUNCHES " + json.dumps(flash.launch_counts), flush=True)
"""


def ring_train_phase(torch, flash, solo_info, workdir: Path):
    """Phase 7f (c): tools/train_lm.run with --mesh sequence=2 --attention
    ring as RING_TRAIN_WORLD processes on the one GPU: the ranks' losses
    equal, finite and near phase 7's on the same global batch; the
    kernels' launches over the ranks the ring's live hops (3 a layer of
    each at R = 2).  Information: the step time, staged hops and all."""
    from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

    out = workdir / "ring_train"
    out.mkdir()
    argv = TRAIN_FLAGS + ["--mesh", f"sequence={RING_TRAIN_WORLD}",
                          "--attention", "ring",
                          "--steps", str(RING_TRAIN_STEPS), "--log-every",
                          "1", "--max-restarts", "0"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_ranks(["-c", _RING_TRAIN_RANK, str(out), *argv],
                        RING_TRAIN_WORLD, timeout_s=RING_TRAIN_TIMEOUT_S,
                        cwd=str(Path(__file__).resolve().parent),
                        env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
    job_s = time.perf_counter() - t0
    try:
        check_ranks(results)
    except RuntimeError as e:
        fail(f"the ring trainer failed: {e}")
    launches = {}
    for r in results:
        line = next(ln for ln in r.stdout.splitlines()
                    if ln.startswith("LAUNCHES "))
        for key, n in json.loads(line[9:]).items():
            launches[key] = launches.get(key, 0) + n
    hops = RING_TRAIN_WORLD * (RING_TRAIN_WORLD + 1) // 2
    want = {k: 0 for k in flash.launch_counts}
    want.update({k: MODEL["n_layers"] * hops * RING_TRAIN_STEPS
                 for k in TRAIN_KERNELS})
    log(f"ring trainer (--mesh sequence={RING_TRAIN_WORLD} --attention "
        f"ring, {RING_TRAIN_WORLD} processes over gloo): launches over "
        f"the ranks {launches} (want {want['flash_fwd']} of each of "
        f"{', '.join(TRAIN_KERNELS)}: {hops} live hops a layer a step)")
    if launches != want:
        fail(f"ring trainer launches {launches}, want {want}")
    histories = [json.loads((out / f"rank{r}.json").read_text())["history"]
                 for r in range(RING_TRAIN_WORLD)]
    losses = [[h["loss"] for h in hist] for hist in histories]
    solo = solo_info["losses"][:RING_TRAIN_STEPS]
    diff = max(abs(a - b) for a, b in zip(losses[0], solo))
    steps_ms = [h["step_time_s"] * 1e3 for h in histories[0]]
    log(f"ring trainer losses {[round(x, 5) for x in losses[0]]} on every "
        f"rank: {all(x == losses[0] for x in losses)}; phase 7's "
        f"{[round(x, 5) for x in solo]}: max |diff| {diff:.2e}; steps "
        f"{[round(x, 1) for x in steps_ms]} ms (the first carries start-up;"
        f" both ranks on one GPU, hops and FSDP2's gradient all-reduce "
        f"through host memory), job {job_s:.1f} s (information only)")
    if not (len(losses[0]) == RING_TRAIN_STEPS
            and all(x == losses[0] for x in losses)
            and all(map(math.isfinite, losses[0]))
            and diff <= MESH_LOSS_ATOL):
        fail(f"ring trainer losses differ across ranks, are not finite or "
             f"are more than {MESH_LOSS_ATOL} from phase 7's: {losses}")
    return launches, {"losses": losses[0], "max_loss_diff": diff,
                      "step_ms": steps_ms, "job_s": job_s}


# What every rank of phases 7g-7i records: the flash kernels' bh
# (``shapes``) and each gloo all-reduce's group, bytes and host seconds
# (``reduces``); ``run_trainer`` is tools/train_lm.run with the rank's own
# metrics file, after the launch counts and the peak memory are reset,
# and ``result`` prints the rank's RESULT line.  Each rank is started as
# ``python -c SCRIPT OUT_DIR STEPS TRAIN_LM_FLAGS...``.
_RANK_PRELUDE = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.tools import train_lm
rank = os.environ["KFT_PROCESS_ID"]
steps = int(sys.argv[2])
shapes = set()


def recorded(fn, kind):
    def call(q, *args, **kw):
        shapes.add((kind, q.shape[0]))
        return fn(q, *args, **kw)
    return call


flash.flash_fwd = recorded(flash.flash_fwd, "fwd")
flash.flash_bwd = recorded(flash.flash_bwd, "bwd")
reduces = []
all_reduce = dist.all_reduce


def counted(t, *args, **kw):
    t0 = time.perf_counter()
    out = all_reduce(t, *args, **kw)
    reduces.append((kw.get("group"), t.numel() * t.element_size(),
                    time.perf_counter() - t0))
    return out


dist.all_reduce = counted


def run_trainer():
    torch.cuda.reset_peak_memory_stats()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    trainer = train_lm.run(sys.argv[3:] + [
        "--metrics-out", f"{sys.argv[1]}/rank{rank}.json"])
    torch.cuda.synchronize()
    return (trainer, dict(flash.launch_counts),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def result(launches, peak, **fields):
    print("RESULT " + json.dumps(dict(
        launches=launches, bh=sorted(shapes), peak_gib=peak, **fields)),
        flush=True)
"""

# One rank of the tensor-parallel trainer: its gloo all-reduces a step,
# then one step on a fresh state timed alone and one under
# torch.profiler, and the time of one all-reduce of an activation.
_TENSOR_TRAIN_RANK = _RANK_PRELUDE + r"""
trainer, launches, peak = run_trainer()
per_step = {"calls": len(reduces) / steps,
            "bytes": sum(c[1] for c in reduces) / steps}
from torch.profiler import ProfilerActivity, profile
state = trainer.create_state(0)
batch = trainer.shard_batch({"tokens": np.random.RandomState(0).randint(
    0, 32000, size=(8, 2048)).astype(np.int32)})
step = trainer.compile_step()
torch.cuda.synchronize()
first = len(reduces)
t0 = time.perf_counter()
state, _ = step(state, batch)
torch.cuda.synchronize()
timed_step = (time.perf_counter() - t0) * 1e3
reduce_in_step = sum(c[2] for c in reduces[first:]) * 1e3
dist.barrier()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
busy = sum(e.self_device_time_total for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
del state
group = trainer.mesh.get_group("tensor")
x = torch.ones((8, 2048, 1024), dtype=torch.bfloat16, device="cuda")
all_reduce(x, group=group)
torch.cuda.synchronize()
dist.barrier()
t0 = time.perf_counter()
for _ in range(5):
    all_reduce(x, group=group)
torch.cuda.synchronize()
reduce_ms = (time.perf_counter() - t0) * 1e3 / 5
result(launches, peak, reduces_per_step=per_step, reduce_32mb_ms=reduce_ms,
       step_ms=timed_step, in_reduces_ms=reduce_in_step,
       profiled_step_ms=wall, busy_ms=busy or None)
"""


def rank_results(results, what: str, want: dict, bh: int):
    """Each rank's RESULT line of a mesh trainer job (``what`` names it),
    once every rank has exited 0, launched the kernels ``want`` times and
    run them at ``bh`` alone."""
    from kubeflow_tpu_torch.testing.ranks import check_ranks

    try:
        check_ranks(results)
    except RuntimeError as e:
        fail(f"{what} failed: {e}")
    ranks = [json.loads(next(ln for ln in r.stdout.splitlines()
                             if ln.startswith("RESULT "))[7:])
             for r in results]
    for r, info in enumerate(ranks):
        log(f"{what} rank {r}: launches {info['launches']} (want {want}); "
            f"kernel bh {info['bh']} (want {bh})")
        if info["launches"] != want:
            fail(f"{what} rank {r} launches {info['launches']}, want {want}")
        if sorted(info["bh"]) != [["bwd", bh], ["fwd", bh]]:
            fail(f"{what} rank {r} ran the kernels at bh {info['bh']}, "
                 f"want {bh}")
    return ranks


def tensor_train_phase(torch, flash, solo_info, workdir: Path):
    """Phase 7g: tools/train_lm.run with --mesh tensor=TENSOR_WORLD as
    TENSOR_WORLD processes on the one GPU over gloo: the ranks' losses
    equal, finite and near phase 7's; each rank's kernels one a layer a
    step at bh TENSOR_LOCAL_BH; the kernels at that shape against their
    plain versions.  Information: a profiled step, peak memory and the
    gloo all-reduces of each rank."""
    from kubeflow_tpu_torch.testing.ranks import run_ranks

    out = workdir / "tensor_train"
    out.mkdir()
    argv = TRAIN_FLAGS + ["--mesh", f"tensor={TENSOR_WORLD}",
                          "--steps", str(TENSOR_STEPS), "--log-every", "1",
                          "--max-restarts", "0"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_ranks(
        ["-c", _TENSOR_TRAIN_RANK, str(out), str(TENSOR_STEPS), *argv],
        TENSOR_WORLD, timeout_s=TENSOR_TIMEOUT_S,
        cwd=str(Path(__file__).resolve().parent),
        env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
    job_s = time.perf_counter() - t0
    want = {k: 0 for k in flash.launch_counts}
    want.update({k: MODEL["n_layers"] * TENSOR_STEPS for k in TRAIN_KERNELS})
    ranks = rank_results(results, "the tensor trainer", want,
                         TENSOR_LOCAL_BH)
    histories = [json.loads((out / f"rank{r}.json").read_text())["history"]
                 for r in range(TENSOR_WORLD)]
    losses = [[h["loss"] for h in hist] for hist in histories]
    solo = solo_info["losses"][:TENSOR_STEPS]
    diff = max(abs(a - b) for a, b in zip(losses[0], solo))
    steps_ms = [h["step_time_s"] * 1e3 for h in histories[0]]
    log(f"tensor trainer losses {[round(x, 5) for x in losses[0]]} on "
        f"every rank: {all(x == losses[0] for x in losses)}; phase 7's "
        f"{[round(x, 5) for x in solo]}: max |diff| {diff:.2e} (bound "
        f"{TENSOR_LOSS_ATOL}); steps {[round(x, 1) for x in steps_ms]} ms "
        f"(the first carries start-up), job {job_s:.1f} s")
    if not (len(losses[0]) == TENSOR_STEPS
            and all(x == losses[0] for x in losses)
            and all(map(math.isfinite, losses[0]))
            and diff <= TENSOR_LOSS_ATOL):
        fail(f"tensor trainer losses differ across ranks, are not finite "
             f"or are more than {TENSOR_LOSS_ATOL} from phase 7's: "
             f"{losses}")
    kernels = path_kernels(torch, flash, TENSOR_LOCAL_BH, "a tensor rank")
    for r, info in enumerate(ranks):
        busy = info["busy_ms"]
        share = ("not measured" if busy is None
                 else f"{busy / info['profiled_step_ms']:.3f}")
        per = info["reduces_per_step"]
        log(f"tensor trainer rank {r}: step {info['step_ms']:.1f} ms, "
            f"{info['in_reduces_ms']:.1f} ms of it inside gloo "
            f"all-reduces; profiled step {info['profiled_step_ms']:.1f} "
            f"ms, busy {busy} ms (share {share}), peak "
            f"{info['peak_gib']:.2f} GiB; {per['calls']:.0f} gloo "
            f"all-reduces a step moving {per['bytes'] / 2 ** 20:.1f} MiB, "
            f"one of 32 MB alone {info['reduce_32mb_ms']:.2f} ms (both "
            "ranks on one GPU, staged through host memory; host clock "
            "after a sync; information only)")
    launches = {k: sum(info["launches"][k] for info in ranks)
                for k in flash.launch_counts}
    return launches, {"losses": losses[0], "max_loss_diff": diff,
                      "step_ms": steps_ms, "job_s": job_s, "ranks": ranks,
                      "kernels": kernels}


# One rank of the pipelined trainer: the stage's hops (parallel/p2p.py
# Send and recv) and the broadcasts of the outputs and of the input
# gradient, timed; then one profiled step on a fresh state.
_PIPE_TRAIN_RANK = _RANK_PRELUDE + r"""
from kubeflow_tpu_torch.parallel import p2p
moved = {k: {"calls": 0, "bytes": 0, "s": 0.0}
         for k in ("send", "recv", "broadcast")}


def timed(kind, fn, nbytes):
    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        rec = moved[kind]
        rec["s"] += time.perf_counter() - t0
        rec["calls"] += 1
        rec["bytes"] += nbytes(args, out)
        return out
    return call


def size(t):
    return t.numel() * t.element_size()


class Send(p2p.Send):
    def __init__(self, t, *args, **kw):
        t0 = time.perf_counter()
        super().__init__(t, *args, **kw)
        moved["send"]["s"] += time.perf_counter() - t0
        moved["send"]["calls"] += 1
        moved["send"]["bytes"] += size(t)

    def wait(self):
        t0 = time.perf_counter()
        super().wait()
        moved["send"]["s"] += time.perf_counter() - t0


p2p.Send = Send
p2p.recv = timed("recv", p2p.recv, lambda a, out: size(out))
p2p.broadcast = timed("broadcast", p2p.broadcast, lambda a, out: size(out))
trainer, launches, peak = run_trainer()
per_step = {k: {"calls": v["calls"] / steps, "bytes": v["bytes"] / steps,
                "ms": v["s"] * 1e3 / steps} for k, v in moved.items()}
from torch.profiler import ProfilerActivity, profile
state = trainer.create_state(0)
batch = trainer.shard_batch({"tokens": np.random.RandomState(0).randint(
    0, 32000, size=(8, 2048)).astype(np.int32)})
step = trainer.compile_step()
state, _ = step(state, batch)
torch.cuda.synchronize()
for v in moved.values():
    v["s"] = 0.0
dist.barrier()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
busy = sum(e.self_device_time_total for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
result(launches, peak, moved_per_step=per_step, profiled_step_ms=wall,
       profiled_recv_ms=moved["recv"]["s"] * 1e3,
       profiled_comm_ms=sum(v["s"] for v in moved.values()) * 1e3,
       busy_ms=busy or None)
"""


def path_kernels(torch, flash, bh: int, what: str):
    """The training kernels at a mesh path's shape (``what`` names it):
    [bh, 2048, 128] bf16, one launch of each of the forward and the
    backward, o and lse against the forward's plain version, dq, dk and
    dv against the backward's plain version on the kernel's own o and
    lse, within phase 2's bounds."""
    d = MODEL["head_dim"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    q, k, v, g = (torch.randn(bh, TRAIN_SEQ, d, device="cuda",
                              generator=gen).bfloat16() for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(flash.launch_counts)
    o, lse = flash._FlashFunction.apply(q, k, v, True, 512, 512, 0)
    o.backward(g)
    torch.cuda.synchronize()
    once = {n: flash.launch_counts[n] - before[n] for n in TRAIN_KERNELS}
    if once != {n: 1 for n in TRAIN_KERNELS}:
        fail(f"{what}'s kernels did not launch once each: {once}")
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    ro, rlse = flash.flash_fwd_reference(qd.float(), kd.float(), vd.float(),
                                         causal=True)
    row = compare_out(torch, "flash_fwd", o.detach(), lse, ro, rlse,
                      f"{what}'s call at bh {bh}")
    worst = {"o": row["rel_err_o"], "lse": row["max_abs_err_lse"]}
    delta = (g.float() * o.detach().float()).sum(-1)
    want = flash.flash_bwd_reference(qd, kd, vd, g, lse.detach(), delta,
                                     causal=True)
    for name, got, ref in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                              want):
        rel, mx, ok, finite = _bwd_errors(torch, got, ref)
        worst[name] = rel
        if not (ok and finite and rel <= BWD_REL_TOL):
            fail(f"{what}'s {name} at bh {bh} disagrees with the plain "
                 f"version: relative {rel:.3e}, max {mx:.3e}")
    log(f"{what}'s kernels at bh {bh}: o relative {worst['o']:.3e}, "
        f"lse {worst['lse']:.3e}, dq {worst['dq']:.3e}, dk "
        f"{worst['dk']:.3e}, dv {worst['dv']:.3e} (bounds {O_REL_TOL}, "
        f"{LSE_ATOL}, {BWD_REL_TOL})")
    del q, k, v, g, o, lse, ro, rlse, want
    torch.cuda.empty_cache()
    return worst


def pipeline_train_phase(torch, flash, solo_info, workdir: Path):
    """Phase 7h: tools/train_lm.run with --mesh pipeline=PIPE_WORLD
    --pipeline-microbatches PIPE_MICRO as PIPE_WORLD processes on the one
    GPU over gloo: the ranks' losses equal, finite and within
    MESH_LOSS_ATOL of phase 7's; each rank's kernels once a (layer,
    microbatch) a step at bh PIPE_LOCAL_BH; one stage's kernels at that
    shape against their plain versions.  Information: each rank's step,
    its hops and broadcasts, the time it waits on its neighbour, a
    profiled step's busy share and its peak memory."""
    from kubeflow_tpu_torch.testing.ranks import run_ranks

    t_phase = time.perf_counter()
    out = workdir / "pipeline_train"
    out.mkdir()
    argv = TRAIN_FLAGS + ["--mesh", f"pipeline={PIPE_WORLD}",
                          "--pipeline-microbatches", str(PIPE_MICRO),
                          "--steps", str(PIPE_STEPS), "--log-every", "1",
                          "--max-restarts", "0"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = run_ranks(
        ["-c", _PIPE_TRAIN_RANK, str(out), str(PIPE_STEPS), *argv],
        PIPE_WORLD, timeout_s=PIPE_TIMEOUT_S,
        cwd=str(Path(__file__).resolve().parent),
        env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
    job_s = time.perf_counter() - t0
    # A stage's layers x the microbatches x the steps.
    want = {k: 0 for k in flash.launch_counts}
    want.update({k: PIPE_PER_STEP * PIPE_STEPS for k in TRAIN_KERNELS})
    ranks = rank_results(results, "the pipeline trainer", want,
                         PIPE_LOCAL_BH)
    histories = [json.loads((out / f"rank{r}.json").read_text())["history"]
                 for r in range(PIPE_WORLD)]
    losses = [[h["loss"] for h in hist] for hist in histories]
    solo = solo_info["losses"][:PIPE_STEPS]
    diff = max(abs(a - b) for a, b in zip(losses[0], solo))
    steps_ms = [[h["step_time_s"] * 1e3 for h in hist] for hist in histories]
    log(f"pipeline trainer losses {[round(x, 5) for x in losses[0]]} on "
        f"every rank: {all(x == losses[0] for x in losses)}; phase 7's "
        f"{[round(x, 5) for x in solo]}: max |diff| {diff:.2e} (bound "
        f"{MESH_LOSS_ATOL}); job {job_s:.1f} s")
    if not (len(losses[0]) == PIPE_STEPS
            and all(x == losses[0] for x in losses)
            and all(map(math.isfinite, losses[0]))
            and diff <= MESH_LOSS_ATOL):
        fail(f"pipeline trainer losses differ across ranks, are not finite "
             f"or are more than {MESH_LOSS_ATOL} from phase 7's: {losses}")
    kernels = path_kernels(torch, flash, PIPE_LOCAL_BH, "a pipeline stage")
    bubble = (PIPE_WORLD - 1) / (PIPE_MICRO + PIPE_WORLD - 1)
    for r, info in enumerate(ranks):
        busy = info["busy_ms"]
        wall = info["profiled_step_ms"]
        share = "not measured" if busy is None else f"{busy / wall:.3f}"
        per = info["moved_per_step"]
        log(f"pipeline trainer rank {r}: steps "
            f"{[round(x, 1) for x in steps_ms[r]]} ms (the first carries "
            f"start-up; phase 7's median {solo_info['step_ms']:.1f} ms on "
            f"one process); a step's sends {per['send']['calls']:.0f} "
            f"({per['send']['bytes'] / 2 ** 20:.1f} MiB, "
            f"{per['send']['ms']:.1f} ms), receives "
            f"{per['recv']['calls']:.0f} ({per['recv']['bytes'] / 2 ** 20:.1f}"
            f" MiB, {per['recv']['ms']:.1f} ms, the wait on the neighbour "
            f"included), broadcasts {per['broadcast']['calls']:.0f} "
            f"({per['broadcast']['bytes'] / 2 ** 20:.1f} MiB, "
            f"{per['broadcast']['ms']:.1f} ms); profiled step {wall:.1f} ms"
            f", {info['profiled_recv_ms']:.1f} ms of it in receives and "
            f"{info['profiled_comm_ms']:.1f} ms in all transfers (GPipe's "
            f"bubble (S-1)/(M+S-1) = {bubble:.3f}), busy {busy} ms (share "
            f"{share}), peak {info['peak_gib']:.2f} GiB (both ranks on one "
            "GPU, staged through host memory; host clock after a sync; "
            "information only)")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 7h took {phase_s:.1f} s (bound {PIPE_PHASE_S})")
    if phase_s > PIPE_PHASE_S:
        fail(f"phase 7h took {phase_s:.1f} s, over {PIPE_PHASE_S}")
    launches = {k: sum(info["launches"][k] for info in ranks)
                for k in flash.launch_counts}
    return launches, {"losses": losses[0], "max_loss_diff": diff,
                      "step_ms": steps_ms, "job_s": job_s, "ranks": ranks,
                      "kernels": kernels, "bubble": bubble,
                      "phase_s": phase_s}


# One rank of a mesh MoE trainer: the first step's loss, grad_norm,
# moe_aux and routers' gradient norm (read from the step's gradients as
# the optimizer takes them), its all-reduces (those over the expert group
# apart), its last step under torch.profiler.
_MOE_MESH_RANK = _RANK_PRELUDE + r"""
from torch.profiler import ProfilerActivity, profile
from kubeflow_tpu_torch.runtime.train import Trainer
body, view = Trainer._step_body, Trainer._opt_view
profiled, first, seen = {}, {}, [0]


def opt_view(self, named):
    # The first step's first view is of its gradients.
    named = view(self, named)
    if seen[0] == 1 and "router_grad_norm" not in first:
        first["router_grad_norm"] = sum(
            float(getattr(g, "to_local", lambda: g)().float().square().sum())
            for n, g in named.items() if n.endswith("moe.router")) ** 0.5
    return named


def step_body(self, state, batch):
    seen[0] += 1
    if seen[0] < steps:
        state, m = body(self, state, batch)
        if seen[0] == 1:
            first.update({k: float(m[k])
                          for k in ("loss", "grad_norm", "moe_aux")})
        return state, m
    torch.cuda.synchronize()
    # Device activity only: host-op tracing of the step's thousands of
    # launches would take longer than the step.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = body(self, state, batch)
        torch.cuda.synchronize()
        profiled["wall"] = (time.perf_counter() - t0) * 1e3
    profiled["busy"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return out


Trainer._step_body, Trainer._opt_view = step_body, opt_view
trainer, launches, peak = run_trainer()
sizes = dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))


def ranks_of(group):
    return dist.get_process_group_ranks(
        dist.group.WORLD if group is None else group)


# The expert group's ranks (the world's group stands for it when it is
# every rank).
expert = (ranks_of(trainer.mesh.get_group("expert"))
          if sizes["expert"] > 1 else None)


def summary(picked):
    return {"calls": len(picked) / steps,
            "bytes": sum(c[1] for c in picked) / steps,
            "ms": sum(c[2] for c in picked) * 1e3 / steps}


per_step = {"all": summary(reduces), "expert": summary(
    [c for c in reduces if ranks_of(c[0]) == expert])}


def spanning_step(spec):
    # One forward and backward of the model at routing groups that span
    # the ranks (KFT_SMOKE_SPANNING), on this rank's rows of one global
    # batch: the loss, moe_aux and the routers' gradient norm, the
    # gradients summed over the ranks.
    from kubeflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       lm_task)
    from kubeflow_tpu_torch.parallel import p2p
    cfg = TransformerConfig(**dict(spec["model"], dtype=torch.bfloat16,
                                   remat=True))
    init_fn, loss_fn = lm_task(cfg, device="cuda", mesh=trainer.mesh)
    model, _ = init_fn(torch.Generator(device="cuda").manual_seed(
        spec["seed"]))
    tokens = np.random.RandomState(spec["seed"]).randint(
        0, cfg.vocab_size, size=(spec["rows"], cfg.max_seq_len))
    b = spec["rows"] // dist.get_world_size()
    mine = tokens[dist.get_rank() * b:(dist.get_rank() + 1) * b]
    loss, (metrics, _) = loss_fn(model, {}, {"tokens": torch.as_tensor(
        mine.astype(np.int32), device="cuda")}, None)
    loss.backward()
    routers = torch.cat([p.grad.float().flatten() for n, p in
                         model.named_parameters()
                         if n.endswith("moe.router")])
    routers = p2p.all_reduce(routers, dist.group.WORLD)
    return {"loss": float(loss.detach()), "aux": float(metrics["moe_aux"]),
            "router_grad_norm": float(routers.norm())}


spanning = os.environ.get("KFT_SMOKE_SPANNING")
result(launches, peak, last=trainer.last_metrics, first=first,
       reduces_per_step=per_step, profiled_step_ms=profiled["wall"],
       busy_ms=profiled["busy"] or None,
       spanning=spanning and spanning_step(json.loads(spanning)))
"""


def moe_mesh_reference(torch, job: str, rows: int):
    """One process on the global batch that job ``job``'s ranks draw
    (train_lm's synthetic stream: rank d's rows from RandomState(d),
    ``rows`` of them a step), from train_lm's seed and optimizer: the
    losses and moe_aux of MOE_MESH_STEPS steps, the first step's
    grad_norm and routers' gradient norm, how far that norm would move
    with the aux's share of it counted twice, and for the data job the
    mean of the two ranks' auxes over their own rows alone on the last
    step's weights (what a per-rank aux would give)."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.train import Trainer

    cfg = TransformerConfig(**dict(MODEL, **MOE, max_seq_len=TRAIN_SEQ,
                                   dtype=torch.bfloat16, remat=True))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    tx = optim.adafactor(1e-3) if job == "data" else optim.adamw(1e-3)
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=tx,
                      device="cuda")
    state = trainer.create_state(0)
    step = trainer.compile_step()
    dp = MOE_MESH_WORLD if job == "data" else 1
    streams = [np.random.RandomState(d) for d in range(dp)]
    losses, auxes, local_aux, first = [], [], None, {}
    for i in range(MOE_MESH_STEPS):
        parts = [r.randint(0, MODEL["vocab_size"], size=(
            rows, TRAIN_SEQ)).astype(np.int32) for r in streams]
        batch = trainer.shard_batch({"tokens": np.concatenate(parts)})
        if i == 0:
            first = router_gradients(torch, state.params, loss_fn, batch,
                                     cfg.moe_aux_coef)
        if dp > 1 and i == MOE_MESH_STEPS - 1:
            with torch.no_grad():
                local_aux = sum(float(state.params(
                    batch["tokens"][d * rows:(d + 1) * rows],
                    return_aux=True)[1]) for d in range(dp)) / dp
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux"]))
        if i == 0:
            first["grad_norm"] = float(m["grad_norm"])
    del trainer, state, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "auxes": auxes, "local_aux": local_aux,
            "first": first}


def spanning_spec() -> dict:
    """Phase 7i's step at routing groups that span ranks: the cell's MoE
    model with the gather dispatch in groups of SPANNING_GROUP tokens,
    its weights and its global batch of TRAIN_BATCH x TRAIN_SEQ from one
    seed."""
    moe = dict(MOE, moe_impl="gather", moe_group_size=SPANNING_GROUP)
    return {"model": dict(MODEL, **moe, max_seq_len=TRAIN_SEQ, dtype=None),
            "rows": TRAIN_BATCH, "seed": SEED + 13}


def spanning_reference(torch) -> dict:
    """``spanning_spec``'s forward and backward in one process on the
    whole global batch: the loss, moe_aux and routers' gradient norm."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )

    spec = spanning_spec()
    cfg = TransformerConfig(**dict(spec["model"], dtype=torch.bfloat16,
                                   remat=True))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    model, _ = init_fn(torch.Generator(device="cuda").manual_seed(
        spec["seed"]))
    tokens = np.random.RandomState(spec["seed"]).randint(
        0, cfg.vocab_size, size=(spec["rows"], cfg.max_seq_len))
    loss, (metrics, _) = loss_fn(model, {}, {"tokens": torch.as_tensor(
        tokens.astype(np.int32), device="cuda")}, None)
    loss.backward()
    norm = float(torch.cat([p.grad.float().flatten() for n, p in
                            model.named_parameters()
                            if n.endswith("moe.router")]).norm())
    out = {"loss": float(loss.detach()), "aux": float(metrics["moe_aux"]),
           "router_grad_norm": norm}
    del model, loss, metrics
    torch.cuda.empty_cache()
    return out


def router_gradients(torch, model, loss_fn, batch, coef):
    """The routers' gradient norm of the loss at ``model``'s weights on
    ``batch``, and that norm with the aux term's share of the gradient
    counted twice (what summing the whole-on-every-rank aux gradient over
    an expert group of 2 would give)."""
    routers = [p for n, p in model.named_parameters()
               if n.endswith("moe.router")]
    with torch.enable_grad():
        loss, _ = loss_fn(model, {}, batch, None)
        whole = torch.autograd.grad(loss, routers)
        aux = model(batch["tokens"], return_aux=True)[1]
        share = torch.autograd.grad(coef * aux, routers)

    def norm(gs):
        return float(sum(g.float().square().sum() for g in gs)) ** 0.5

    return {"router_grad_norm": norm(whole), "router_aux_twice": norm(
        [g + a for g, a in zip(whole, share)])}


def moe_spanning_check(ranks, ref) -> dict:
    """The data job's step at routing groups that span both ranks against
    one process on the global batch (``spanning_spec``)."""
    worst = max(abs(rank["spanning"][k] - ref[k]) / abs(ref[k])
                for rank in ranks for k in ref)
    bound = MOE_MESH_FIRST_RTOL["data"]
    share = TRAIN_SEQ * TRAIN_BATCH // MOE_MESH_WORLD
    log(f"MoE --mesh data=2 at routing groups of {SPANNING_GROUP} tokens "
        f"(the gather dispatch, each group both ranks' {share}): "
        + ", ".join(f"{k} {ranks[0]['spanning'][k]:.6g} against "
                    f"{ref[k]:.6g}" for k in ref)
        + f" of one process on the {TRAIN_BATCH * TRAIN_SEQ} global tokens:"
        f" worst relative {worst:.2e} over the ranks (bound {bound})")
    if not (worst <= bound and all(
            rank["spanning"]["loss"] == ranks[0]["spanning"]["loss"]
            for rank in ranks)):
        fail(f"MoE at routing groups that span ranks differs from one "
             f"process: {[rank['spanning'] for rank in ranks]}, {ref}")
    return {"ranks": [rank["spanning"] for rank in ranks],
            "reference": ref, "worst_rel": worst}


def moe_mesh_phase(torch, flash, workdir: Path):
    """Phase 7i: bench.py's lm_moe cell through tools/train_lm.run over
    each of MOE_MESH_JOBS as MOE_MESH_WORLD processes on the one GPU over
    gloo (the jobs side by side), each against one process on the same
    global batch: the ranks' losses equal, finite and within
    MOE_MESH_LOSS_ATOL of it, the data job's last moe_aux within
    MOE_MESH_AUX_RTOL of its global one, the first step's loss,
    grad_norm and routers' gradient norm within the job's
    MOE_MESH_FIRST_RTOL of its, each rank's kernels once a layer a step
    at bh (rows x 8 heads) and the kernels at that shape against their
    plain versions; the phase within MOE_MESH_PHASE_S.  Information:
    each rank's step ms, a profiled step's busy share, its all-reduces
    (those over the expert group apart) and its peak memory."""
    from kubeflow_tpu_torch.testing.ranks import run_ranks

    t_phase = time.perf_counter()
    launches = {k: 0 for k in flash.launch_counts}
    info, futures, refs, done = {}, {}, {}, {}
    torch.cuda.empty_cache()

    def job_ranks(job, flags, rows):
        out = workdir / f"moe_mesh_{job}"
        out.mkdir()
        argv = TRAIN_FLAGS + ["--moe-experts", str(MOE["moe_experts"]),
                              "--batch-size-per-device", str(rows),
                              "--steps", str(MOE_MESH_STEPS), "--log-every",
                              "1", "--max-restarts", "0", *flags]
        env = dict(os.environ, KFT_DIST_BACKEND="gloo")
        if job == "data":
            env["KFT_SMOKE_SPANNING"] = json.dumps(spanning_spec())
        results = run_ranks(
            ["-c", _MOE_MESH_RANK, str(out), str(MOE_MESH_STEPS), *argv],
            MOE_MESH_WORLD, timeout_s=MOE_MESH_TIMEOUT_S,
            cwd=str(Path(__file__).resolve().parent), env=env)
        done[job] = time.perf_counter() - t_phase
        return results

    # Both jobs' ranks run side by side (the step is bound by the host's
    # gloo copies, the device busy a tenth of it), and the one-process
    # references run here while the ranks start.
    with ThreadPoolExecutor(len(MOE_MESH_JOBS)) as pool:
        for job, (flags, rows) in MOE_MESH_JOBS.items():
            futures[job] = pool.submit(job_ranks, job, flags, rows)
        for job, (flags, rows) in MOE_MESH_JOBS.items():
            refs[job] = moe_mesh_reference(torch, job, rows)
        refs["data"]["spanning"] = spanning_reference(torch)
        ref_s = time.perf_counter() - t_phase
        outcomes = {job: f.result() for job, f in futures.items()}
    for job, (flags, rows) in MOE_MESH_JOBS.items():
        out, ref, results = workdir / f"moe_mesh_{job}", refs[job], \
            outcomes[job]
        job_s = done[job]
        bh = rows * MODEL["n_heads"]
        want = {k: 0 for k in flash.launch_counts}
        want.update({k: MODEL["n_layers"] * MOE_MESH_STEPS
                     for k in TRAIN_KERNELS})
        ranks = rank_results(results, f"the MoE trainer over --mesh "
                             f"{flags[1]}", want, bh)
        for rank in ranks:
            for k in launches:
                launches[k] += rank["launches"][k]
        histories = [json.loads((out / f"rank{r}.json").read_text())[
            "history"] for r in range(MOE_MESH_WORLD)]
        losses = [[h["loss"] for h in hist] for hist in histories]
        diff = max(abs(a - b) for a, b in zip(losses[0], ref["losses"]))
        auxes = [rank["last"]["moe_aux"] for rank in ranks]
        want_aux = ref["auxes"][-1]
        aux_rel = abs(auxes[0] - want_aux) / abs(want_aux)
        local = ("" if ref["local_aux"] is None else
                 f"; the mean of the ranks' auxes over their own rows alone "
                 f"would be {ref['local_aux']:.6f} (relative "
                 f"{abs(ref['local_aux'] - want_aux) / abs(want_aux):.2e})")
        log(f"MoE --mesh {flags[1]} losses {[round(x, 5) for x in losses[0]]}"
            f" on every rank: {all(x == losses[0] for x in losses)}; one "
            f"process's {[round(x, 5) for x in ref['losses']]}: max |diff| "
            f"{diff:.2e} (bound {MOE_MESH_LOSS_ATOL}); last moe_aux "
            f"{auxes[0]:.6f} against the global {want_aux:.6f}: relative "
            f"{aux_rel:.2e} ("
            + (f"bound {MOE_MESH_AUX_RTOL}" if ref["local_aux"] is not None
               else "information only") +
            f"; the reference's auxes {[round(x, 4) for x in ref['auxes']]})"
            f"{local}; job {job_s:.1f} s beside the other job, both "
            f"references {ref_s:.1f} s beside the ranks' start")
        steps_ms = [[h["step_time_s"] * 1e3 for h in hist]
                    for hist in histories]
        for r, rank in enumerate(ranks):
            busy, wall = rank["busy_ms"], rank["profiled_step_ms"]
            share = "not measured" if busy is None else f"{busy / wall:.3f}"
            per = rank["reduces_per_step"]
            log(f"MoE --mesh {flags[1]} rank {r}: steps "
                f"{[round(x, 1) for x in steps_ms[r]]} ms (the first "
                f"carries start-up, the last is the profiled one); "
                f"profiled step {wall:.1f} ms, busy "
                f"{busy} ms (share {share}), peak {rank['peak_gib']:.2f} "
                f"GiB; a step's gloo all-reduces {per['all']['calls']:.0f}"
                f" ({per['all']['bytes'] / 2 ** 20:.1f} MiB, "
                f"{per['all']['ms']:.1f} ms), over the expert group "
                f"{per['expert']['calls']:.0f} ("
                f"{per['expert']['bytes'] / 2 ** 20:.1f} MiB, "
                f"{per['expert']['ms']:.1f} ms) (both ranks on one GPU "
                "beside the other job's two, staged through host memory; "
                "host clock after a sync; information only)")
        # The first step, before the optimizer has moved the router: the
        # loss, grad_norm and the routers' gradient norm of every rank
        # against one process's.  A router gradient whose aux share is
        # summed over the expert group, or whose other experts' gates are
        # lost, moves the last of them (the reach below).
        ref_first = dict(ref["first"], loss=ref["losses"][0])
        first_rel = max(abs(rank["first"][k] - ref_first[k]) / ref_first[k]
                        for rank in ranks for k in MOE_MESH_FIRST)
        reach = (ref_first["router_aux_twice"] / ref_first[
            "router_grad_norm"] - 1)
        log(f"MoE --mesh {flags[1]} first step: "
            + ", ".join(f"{k} {ranks[0]['first'][k]:.6g} against "
                        f"{ref_first[k]:.6g}" for k in MOE_MESH_FIRST)
            + f": worst relative {first_rel:.2e} over the ranks (bound "
            f"{MOE_MESH_FIRST_RTOL[job]}); the aux's share counted twice "
            f"would move the routers' gradient norm by {reach:.2e}")
        if not first_rel <= MOE_MESH_FIRST_RTOL[job]:
            fail(f"MoE --mesh {flags[1]}'s first step is more than "
                 f"{MOE_MESH_FIRST_RTOL[job]} from one process's: "
                 f"{[rank['first'] for rank in ranks]}, {ref_first}")
        if job == "data":
            info["spanning"] = moe_spanning_check(ranks, ref["spanning"])
        kernels = path_kernels(torch, flash, bh, f"an MoE --mesh {flags[1]} "
                               f"rank")
        info[job] = {"losses": losses[0], "max_loss_diff": diff,
                     "aux": auxes[0], "aux_rel": aux_rel,
                     "first_rel": first_rel, "router_reach": reach,
                     "reference": ref, "step_ms": steps_ms,
                     "job_s": job_s, "ref_s": ref_s, "ranks": ranks,
                     "kernels": kernels}
        # The data job's aux is the global one: within MOE_MESH_AUX_RTOL
        # of one process's and ten times nearer it than the mean of the
        # ranks' own, where a per-rank aux would sit.  The expert job's
        # ranks hold every row, so its aux is information only.
        aux_ok = ref["local_aux"] is None or (
            aux_rel <= MOE_MESH_AUX_RTOL and abs(auxes[0] - want_aux)
            < abs(ref["local_aux"] - want_aux) / 10)
        if not (len(losses[0]) == MOE_MESH_STEPS
                and all(x == losses[0] for x in losses)
                and all(map(math.isfinite, losses[0] + auxes))
                and auxes[0] == auxes[1] and diff <= MOE_MESH_LOSS_ATOL
                and aux_ok):
            fail(f"MoE --mesh {flags[1]} losses or auxes differ across "
                 f"ranks, are not finite or are too far from one "
                 f"process's: {losses}, {auxes}, {ref}")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 7i took {phase_s:.1f} s (bound {MOE_MESH_PHASE_S})")
    if phase_s > MOE_MESH_PHASE_S:
        fail(f"phase 7i took {phase_s:.1f} s, over {MOE_MESH_PHASE_S}")
    info["phase_s"] = phase_s
    return launches, info


# One rank of an adafactor mesh trainer: the first step's loss and
# grad_norm, its gloo all-reduces, its share of the embedding's
# statistics and its last step under torch.profiler.
_ADAFACTOR_MESH_RANK = _RANK_PRELUDE + r"""
from torch.profiler import ProfilerActivity, profile
from kubeflow_tpu_torch.runtime.train import Trainer
body = Trainer._step_body
profiled, first, seen, stats = {}, {}, [0], {}


def step_body(self, state, batch):
    seen[0] += 1
    if seen[0] < steps:
        state, m = body(self, state, batch)
        if seen[0] == 1:
            first.update({k: float(m[k]) for k in ("loss", "grad_norm")})
        return state, m
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = body(self, state, batch)
        torch.cuda.synchronize()
        profiled["wall"] = (time.perf_counter() - t0) * 1e3
    profiled["busy"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    opt = out[0].opt_state
    stats.update({k: list(getattr(opt, k)["embed"].shape)
                  for k in ("v_row", "v_col")})
    return out


Trainer._step_body = step_body
trainer, launches, peak = run_trainer()
per_step = {"calls": len(reduces) / steps,
            "bytes": sum(c[1] for c in reduces) / steps,
            "ms": sum(c[2] for c in reduces) * 1e3 / steps}
result(launches, peak, first=first, reduces_per_step=per_step,
       embed_stats=stats, profiled_step_ms=profiled["wall"],
       busy_ms=profiled["busy"] or None)
"""


def adafactor_mesh_reference(torch, rows: int, dp: int):
    """One process with adafactor on the global batch that an adafactor
    mesh job's ranks draw (train_lm's synthetic stream: rank d of ``dp``
    its ``rows`` from RandomState(d) a step), from train_lm's seed: the
    losses of ADAFACTOR_MESH_STEPS steps and the first step's
    grad_norm."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.train import Trainer

    cfg = TransformerConfig(**dict(MODEL, max_seq_len=TRAIN_SEQ,
                                   dtype=torch.bfloat16, remat=True))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adafactor(1e-3), device="cuda")
    state = trainer.create_state(0)
    step = trainer.compile_step()
    streams = [np.random.RandomState(d) for d in range(dp)]
    losses, first = [], {}
    for i in range(ADAFACTOR_MESH_STEPS):
        parts = [r.randint(0, MODEL["vocab_size"], size=(
            rows, TRAIN_SEQ)).astype(np.int32) for r in streams]
        state, m = step(state, trainer.shard_batch(
            {"tokens": np.concatenate(parts)}))
        losses.append(float(m["loss"]))
        if i == 0:
            first = {"loss": losses[0], "grad_norm": float(m["grad_norm"])}
    del trainer, state
    torch.cuda.empty_cache()
    return {"losses": losses, "first": first}


def adafactor_mesh_phase(torch, flash, workdir: Path):
    """Phase 7j: bench.py's LM cell with --optimizer adafactor through
    tools/train_lm.run over each of ADAFACTOR_MESH_JOBS as
    ADAFACTOR_MESH_WORLD processes on the one GPU over gloo (the jobs side
    by side), each against one process with adafactor on the same global
    batch: the ranks' losses equal, finite and within the job's bound of
    it, the first step's loss and grad_norm within the job's relative
    bound of its, each rank's kernels once a layer a step at bh
    ADAFACTOR_MESH_BH and the kernels at that shape against their plain
    versions; the phase within ADAFACTOR_MESH_PHASE_S.  Information:
    each rank's step ms, a profiled step's busy share, its all-reduces
    and peak memory, its share of the embedding's statistics."""
    from kubeflow_tpu_torch.testing.ranks import run_ranks

    t_phase = time.perf_counter()
    launches = {k: 0 for k in flash.launch_counts}
    info, futures, refs, done = {}, {}, {}, {}
    torch.cuda.empty_cache()

    def job_ranks(job, flags, rows):
        out = workdir / f"adafactor_mesh_{job}"
        out.mkdir()
        argv = TRAIN_FLAGS + ["--optimizer", "adafactor",
                              "--batch-size-per-device", str(rows),
                              "--steps", str(ADAFACTOR_MESH_STEPS),
                              "--log-every", "1", "--max-restarts", "0",
                              *flags]
        results = run_ranks(
            ["-c", _ADAFACTOR_MESH_RANK, str(out),
             str(ADAFACTOR_MESH_STEPS), *argv],
            ADAFACTOR_MESH_WORLD, timeout_s=ADAFACTOR_MESH_TIMEOUT_S,
            cwd=str(Path(__file__).resolve().parent),
            env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
        done[job] = time.perf_counter() - t_phase
        return results

    # Both jobs' ranks run side by side, the one-process references here
    # while the ranks start.
    with ThreadPoolExecutor(len(ADAFACTOR_MESH_JOBS)) as pool:
        for job, (flags, rows, _, _) in ADAFACTOR_MESH_JOBS.items():
            futures[job] = pool.submit(job_ranks, job, flags, rows)
        for job, (flags, rows, _, _) in ADAFACTOR_MESH_JOBS.items():
            dp = ADAFACTOR_MESH_WORLD if "fsdp" in flags[1] else 1
            refs[job] = adafactor_mesh_reference(torch, rows, dp)
        ref_s = time.perf_counter() - t_phase
        outcomes = {job: f.result() for job, f in futures.items()}
    want = {k: 0 for k in flash.launch_counts}
    want.update({k: MODEL["n_layers"] * ADAFACTOR_MESH_STEPS
                 for k in TRAIN_KERNELS})
    for job, (flags, rows, loss_atol, first_rtol) in \
            ADAFACTOR_MESH_JOBS.items():
        out, ref = workdir / f"adafactor_mesh_{job}", refs[job]
        ranks = rank_results(outcomes[job], f"the adafactor trainer over "
                             f"--mesh {flags[1]}", want, ADAFACTOR_MESH_BH)
        for rank in ranks:
            for k in launches:
                launches[k] += rank["launches"][k]
        histories = [json.loads((out / f"rank{r}.json").read_text())[
            "history"] for r in range(ADAFACTOR_MESH_WORLD)]
        losses = [[h["loss"] for h in hist] for hist in histories]
        diff = max(abs(a - b) for a, b in zip(losses[0], ref["losses"]))
        first_rel = max(abs(rank["first"][k] - ref["first"][k])
                        / ref["first"][k] for rank in ranks
                        for k in ("loss", "grad_norm"))
        log(f"adafactor --mesh {flags[1]} losses "
            f"{[round(x, 5) for x in losses[0]]} on every rank: "
            f"{all(x == losses[0] for x in losses)}; one process's "
            f"{[round(x, 5) for x in ref['losses']]}: max |diff| "
            f"{diff:.2e} (bound {loss_atol}); first step loss "
            f"{ranks[0]['first']['loss']:.6g} / grad_norm "
            f"{ranks[0]['first']['grad_norm']:.6g} against "
            f"{ref['first']['loss']:.6g} / {ref['first']['grad_norm']:.6g}"
            f": worst relative {first_rel:.2e} over the ranks (bound "
            f"{first_rtol}); job {done[job]:.1f} s beside the other job, "
            f"both references {ref_s:.1f} s beside the ranks' start")
        steps_ms = [[h["step_time_s"] * 1e3 for h in hist]
                    for hist in histories]
        for r, rank in enumerate(ranks):
            busy, wall = rank["busy_ms"], rank["profiled_step_ms"]
            share = "not measured" if busy is None else f"{busy / wall:.3f}"
            per = rank["reduces_per_step"]
            log(f"adafactor --mesh {flags[1]} rank {r}: steps "
                f"{[round(x, 1) for x in steps_ms[r]]} ms (the first "
                f"carries start-up, the last is the profiled one); "
                f"profiled step {wall:.1f} ms, busy {busy} ms (share "
                f"{share}), peak {rank['peak_gib']:.2f} GiB; a step's gloo "
                f"all-reduces {per['calls']:.0f} ({per['bytes'] / 2 ** 20:.2f}"
                f" MiB, {per['ms']:.1f} ms); its embedding's statistics "
                f"{rank['embed_stats']} of the whole [32000, 1024]'s "
                f"[1024] and [32000] (both ranks on one GPU beside the "
                "other job's two, staged through host memory; host clock "
                "after a sync; information only)")
        if not (len(losses[0]) == ADAFACTOR_MESH_STEPS
                and all(x == losses[0] for x in losses)
                and all(map(math.isfinite, losses[0]))
                and diff <= loss_atol and first_rel <= first_rtol):
            fail(f"adafactor --mesh {flags[1]} losses differ across ranks, "
                 f"are not finite or are too far from one process's: "
                 f"{losses}, {[rank['first'] for rank in ranks]}, {ref}")
        info[job] = {"losses": losses[0], "max_loss_diff": diff,
                     "first_rel": first_rel, "reference": ref,
                     "step_ms": steps_ms, "job_s": done[job],
                     "ref_s": ref_s, "ranks": ranks}
    info["kernels"] = path_kernels(torch, flash, ADAFACTOR_MESH_BH,
                                   "an adafactor mesh rank")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 7j took {phase_s:.1f} s (bound {ADAFACTOR_MESH_PHASE_S})")
    if phase_s > ADAFACTOR_MESH_PHASE_S:
        fail(f"phase 7j took {phase_s:.1f} s, over {ADAFACTOR_MESH_PHASE_S}")
    info["phase_s"] = phase_s
    return launches, info


# One rank of the fused trainer over a mesh: FusedTrainer(mesh=MeshSpec(
# data=N)) on the global batch, each fused step's per-member losses, the
# gloo all-reduces, the last step under torch.profiler (device only), and
# checksums of the stacked state's bits.  Started as ``python -c SCRIPT
# OUT_DIR STEPS SPEC_JSON``.
_HFTA_MESH_RANK = _RANK_PRELUDE + r"""
import itertools
from torch.profiler import ProfilerActivity, profile
from kubeflow_tpu_torch.models.transformer import TransformerConfig, lm_task
from kubeflow_tpu_torch.parallel.mesh import MeshSpec
from kubeflow_tpu_torch.runtime import bootstrap
from kubeflow_tpu_torch.runtime.hfta import FusedTrainer, MemberSpec
from kubeflow_tpu_torch.runtime.metrics import MetricsLogger
spec = json.loads(sys.argv[3])
bootstrap.initialize(device="cuda")
mesh = MeshSpec(data=spec["world"]).build("cuda")
cfg = TransformerConfig(**dict(spec["model"], dtype=torch.bfloat16,
                               remat=True))
init_fn, loss_fn = lm_task(cfg, device="cuda", mesh=mesh)
ft = FusedTrainer(init_fn=init_fn, loss_fn=loss_fn,
                  members=[MemberSpec(**m) for m in spec["members"]],
                  mesh=mesh, device="cuda", metrics=MetricsLogger(
                      stream=open(os.devnull, "w")))
body, profiled, losses, m1 = ft._fused_step, {}, [], {}


def digest(t):
    # Two sums of the tensor's bits (the second weighted by position):
    # equal tensors give equal pairs, a flipped bit another pair.
    t = t.detach().contiguous()
    bits = t.view(torch.int32 if t.element_size() == 4 else
                  torch.int64).flatten().to(torch.int64)
    w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return [int(bits.sum()), int((bits * w).sum())]


def member_digest(state, i):
    return {k: digest(v[i]) for k, v in state.params.items()}


def fused_step(state, active, stops, batch):
    if len(losses) < steps - 1:
        out = body(state, active, stops, batch)
    else:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = body(state, active, stops, batch)
            torch.cuda.synchronize()
            profiled["wall"] = (time.perf_counter() - t0) * 1e3
        profiled["busy"] = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    losses.append(out[2]["loss"].tolist())
    if len(losses) == spec["stop"]:
        m1["at_stop"] = member_digest(out[0], 1)
    return out


ft.compile_step = lambda: fused_step
batch = {"tokens": np.random.RandomState(spec["seed"]).randint(
    0, cfg.vocab_size, size=(spec["rows"], cfg.max_seq_len)).astype(
        np.int32)}
torch.cuda.reset_peak_memory_stats()
for key in flash.launch_counts:
    flash.launch_counts[key] = 0
t0 = time.perf_counter()
state = ft.fit(itertools.repeat(batch), steps, log_every=1,
               examples_per_step=spec["rows"])
torch.cuda.synchronize()
fit_s = time.perf_counter() - t0
launches = dict(flash.launch_counts)
peak = torch.cuda.max_memory_allocated() / 2 ** 30
inner = state.opt_state.inner
stack = {f"params.{k}": digest(v) for k, v in state.params.items()}
stack.update({f"{name}.{i}": digest(t) for name in ("mu", "nu")
              for i, t in enumerate(getattr(inner, name))})
stack.update(step=digest(state.step), count=digest(inner.count))
grads = [c for c in reduces if c[1] > 2 ** 20]
result(launches, peak, losses=losses, steps=state.step.tolist(),
       stack=stack, fit_s=fit_s,
       step_ms=[r["step_time_s"] * 1e3 for r in ft.metrics.history
                if r.get("event") == "train_step"],
       m1_frozen=m1["at_stop"] == member_digest(state, 1),
       reduces_per_step={"calls": len(reduces) / steps,
                         "bytes": sum(c[1] for c in reduces) / steps,
                         "ms": sum(c[2] for c in reduces) * 1e3 / steps},
       gradient_reduce_ms=[c[2] * 1e3 for c in grads],
       gradient_reduce_bytes=grads[0][1] if grads else 0,
       profiled_step_ms=profiled.get("wall"),
       busy_ms=profiled.get("busy") or None)
"""


def hfta_mesh_reference(torch, batch):
    """One process's fused step (phase 7e's gang without a mesh) on the
    global ``batch``: each member's loss."""
    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime.hfta import FusedTrainer
    from kubeflow_tpu_torch.runtime.metrics import MetricsLogger

    cfg = TransformerConfig(**dict(MODEL, max_seq_len=TRAIN_SEQ,
                                   dtype=torch.bfloat16, remat=True))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    ft = FusedTrainer(init_fn=init_fn, loss_fn=loss_fn,
                      members=hfta_members(), device="cuda",
                      metrics=MetricsLogger(stream=open(os.devnull, "w")))
    ft.fit(itertools.repeat(batch), 1, log_every=1)
    losses = [ft.last_metrics[f"loss/m{i}"] for i in range(HFTA_MEMBERS)]
    del ft
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def hfta_mesh_phase(torch, flash, hfta_info, workdir: Path):
    """Phase 7k: phase 7e's gang as FusedTrainer(mesh=MeshSpec(data=
    HFTA_MESH_WORLD)) over HFTA_MESH_WORLD processes on the one GPU over
    gloo, HFTA_MESH_STEPS fused steps on the global batch: each rank's
    losses equal, finite and, at the first step, within HFTA_LOSS_ATOL of
    one process's fused step on the same rows; the stacked state
    bit-equal on every rank; m1 frozen at its stop; each rank's kernels
    once a layer a step at bh HFTA_MESH_BH and the kernels at that shape
    against their plain versions; the phase within HFTA_MESH_PHASE_S.
    Information: each rank's step ms against phase 7e's fused step, the
    gradient all-reduce's ms and bytes, a profiled step's busy share and
    peak memory."""
    import numpy as np

    from kubeflow_tpu_torch.testing.ranks import run_ranks

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rows = TRAIN_BATCH
    batch = {"tokens": np.random.RandomState(SEED + 12).randint(
        0, MODEL["vocab_size"], size=(rows, TRAIN_SEQ)).astype(np.int32)}
    # Before the ranks start: three gangs of 4 x 188M do not fit the card
    # together.
    ref = hfta_mesh_reference(torch, batch)
    ref_s = time.perf_counter() - t_phase
    log(f"hfta mesh: this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved as "
        f"the ranks start")
    out = workdir / "hfta_mesh"
    out.mkdir()
    spec = {"world": HFTA_MESH_WORLD, "rows": rows, "seed": SEED + 12,
            "stop": HFTA_STOP,
            "model": dict(MODEL, max_seq_len=TRAIN_SEQ),
            "members": [dict(name=m.name, seed=m.seed, lr=m.lr,
                             stop_step=m.stop_step)
                        for m in hfta_members()]}
    del spec["model"]["dtype"]
    results = run_ranks(
        ["-c", _HFTA_MESH_RANK, str(out), str(HFTA_MESH_STEPS),
         json.dumps(spec)], HFTA_MESH_WORLD, timeout_s=HFTA_MESH_TIMEOUT_S,
        cwd=str(Path(__file__).resolve().parent),
        # Two gangs of 4 x 188M share the card: segments that grow in
        # place leave less of it stranded between blocks.
        env=dict(os.environ, KFT_DIST_BACKEND="gloo",
                 PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    job_s = time.perf_counter() - t_phase - ref_s
    want = {k: 0 for k in flash.launch_counts}
    want.update({k: MODEL["n_layers"] * HFTA_MESH_STEPS
                 for k in TRAIN_KERNELS})
    ranks = rank_results(results, "the fused trainer over --mesh data=2",
                         want, HFTA_MESH_BH)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in flash.launch_counts}
    losses = ranks[0]["losses"]
    first = max(abs(a - b) for a, b in zip(losses[0], ref))
    same_stack = all(r["stack"] == ranks[0]["stack"] for r in ranks)
    steps = ranks[0]["steps"]
    frozen = all(r["m1_frozen"] for r in ranks)
    shown = [[round(x, 5) for x in step] for step in losses]
    log(f"hfta mesh: per-member losses {shown} on every rank: "
        f"{all(r['losses'] == losses for r in ranks)}; the first step "
        f"against one process's fused step on the same {rows} rows "
        f"{[round(x, 5) for x in ref]}: max |diff| {first:.2e} (bound "
        f"{HFTA_LOSS_ATOL}); member steps {steps}; stacked state "
        f"({len(ranks[0]['stack'])} tensors) bit-equal on every rank: "
        f"{same_stack}; m1 bit-equal to its step-{HFTA_STOP} state on "
        f"every rank: {frozen}; reference {ref_s:.1f} s, the ranks' job "
        f"{job_s:.1f} s")
    for r, rank in enumerate(ranks):
        busy, wall = rank["busy_ms"], rank["profiled_step_ms"]
        share = "not measured" if busy is None else f"{busy / wall:.3f}"
        per = rank["reduces_per_step"]
        log(f"hfta mesh rank {r}: steps "
            f"{[round(x, 1) for x in rank['step_ms']]} ms (the first "
            f"carries start-up, the last is the profiled one) against "
            f"phase 7e's fused step {hfta_info['step_ms']:.1f} ms on "
            f"twice the rows; profiled step {wall:.1f} ms, busy {busy} "
            f"ms (share {share}), peak {rank['peak_gib']:.2f} GiB; the "
            f"gradients' all-reduce {rank['gradient_reduce_bytes'] / 2 ** 30:.3f}"
            f" GiB in {[round(x, 1) for x in rank['gradient_reduce_ms']]} "
            f"ms; a step's gloo all-reduces {per['calls']:.0f} "
            f"({per['bytes'] / 2 ** 20:.1f} MiB, {per['ms']:.1f} ms) "
            f"(both ranks on one GPU, staged through host memory; host "
            f"clock after a sync; information only)")
    if not (len(losses) == HFTA_MESH_STEPS
            and all(r["losses"] == losses for r in ranks)
            and all(math.isfinite(x) for step in losses for x in step)
            and first <= HFTA_LOSS_ATOL and same_stack and frozen
            and steps == [HFTA_MESH_STEPS, HFTA_STOP, HFTA_MESH_STEPS,
                          HFTA_MESH_STEPS]):
        fail(f"the fused trainer over a mesh: losses differ across ranks, "
             f"are not finite or too far from one process's, or the "
             f"stacks differ: {[r['losses'] for r in ranks]}, {ref}, "
             f"{steps}, stacks equal {same_stack}")
    kernels = path_kernels(torch, flash, HFTA_MESH_BH,
                           "an HFTA mesh rank (4 members folded)")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 7k took {phase_s:.1f} s (bound {HFTA_MESH_PHASE_S})")
    if phase_s > HFTA_MESH_PHASE_S:
        fail(f"phase 7k took {phase_s:.1f} s, over {HFTA_MESH_PHASE_S}")
    return launches, {"losses": losses, "reference": ref,
                      "first_diff": first, "steps": steps,
                      "ranks": [{k: v for k, v in r.items() if k != "stack"}
                                for r in ranks],
                      "ref_s": ref_s, "job_s": job_s, "kernels": kernels,
                      "phase_s": phase_s}


def profile_step(torch, trainer, state, batch):
    """(host ms, device busy ms or None) of one training step, the second
    of two, the step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    step = trainer.compile_step()
    placed = trainer.shard_batch(batch)
    state, _ = step(state, placed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, placed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall * 1e3, (busy_us / 1e3 if busy_us else None)


def mesh_phase(torch, flash, solo_info, workdir: Path):
    """Phase 7f (b): tools/train_lm.run with --mesh data=1 (a one-rank
    NCCL group and FSDP2 over it): MESH_STEPS losses against phase 7's,
    12 launches a step of each training kernel; then, information, one
    profiled step of the mesh trainer and of the trainer without one."""
    import numpy as np
    import torch.distributed as dist

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime.train import Trainer
    from kubeflow_tpu_torch.tools import train_lm

    out = workdir / "mesh_metrics.json"
    argv = TRAIN_FLAGS + ["--mesh", "data=1", "--steps", str(MESH_STEPS),
                          "--log-every", "1", "--max-restarts", "0",
                          "--metrics-out", str(out)]
    torch.cuda.reset_peak_memory_stats()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    trainer = train_lm.run(argv)
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    try:
        if trainer.mesh is None or dist.get_backend() != "nccl" or \
                dist.get_world_size() != 1:
            fail("--mesh data=1 did not train over a one-rank NCCL mesh")
        want = MODEL["n_layers"] * MESH_STEPS
        log(f"mesh trainer (--mesh data=1, NCCL, FSDP2): launches over "
            f"{MESH_STEPS} steps {counts} (want {want} of each of "
            f"{', '.join(TRAIN_KERNELS)})")
        bad = [k for k in TRAIN_KERNELS if counts[k] != want]
        if bad:
            fail(f"mesh trainer kernels launched the wrong number of "
                 f"times: {bad}")
        history = json.loads(out.read_text())["history"]
        losses = [r["loss"] for r in history]
        solo = solo_info["losses"][:MESH_STEPS]
        diff = max(abs(a - b) for a, b in zip(losses, solo))
        log(f"mesh trainer losses {[round(x, 5) for x in losses]} against "
            f"phase 7's {[round(x, 5) for x in solo]}: max |diff| "
            f"{diff:.2e} (bound {MESH_LOSS_ATOL})")
        if len(losses) != MESH_STEPS or not diff <= MESH_LOSS_ATOL:
            fail("the mesh trainer's losses differ from phase 7's")
        batch = {"tokens": np.random.RandomState(SEED).randint(
            0, MODEL["vocab_size"],
            size=(TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
        state = trainer.create_state(SEED)
        mesh_ms, mesh_busy = profile_step(torch, trainer, state, batch)
        del state
    finally:
        dist.destroy_process_group()
    cfg = TransformerConfig(**dict(MODEL, max_seq_len=TRAIN_SEQ, remat=True,
                                   attention="flash", dtype=torch.bfloat16))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    plain = Trainer(init_fn=init_fn, loss_fn=loss_fn, tx=trainer.tx,
                    device="cuda")
    state = plain.create_state(SEED)
    solo_ms, solo_busy = profile_step(torch, plain, state, batch)
    del state

    def share(busy, wall):
        return "not measured" if busy is None else f"{busy / wall:.3f}"

    log(f"mesh trainer step (one profiled step after one more): "
        f"{mesh_ms:.1f} ms, busy share {share(mesh_busy, mesh_ms)}, peak "
        f"memory {peak_gib:.2f} GiB over its run; without a mesh "
        f"{solo_ms:.1f} ms, busy share {share(solo_busy, solo_ms)}; phase "
        f"7's median step {solo_info['step_ms']:.1f} ms, peak "
        f"{solo_info['peak_gib']:.2f} GiB (host clock; information only)")
    return counts, {"losses": losses, "max_loss_diff": diff,
                    "step_ms": mesh_ms, "busy_ms": mesh_busy,
                    "peak_gib": peak_gib, "solo_step_ms": solo_ms,
                    "solo_busy_ms": solo_busy}


def train_hfta(torch, flash, solo_info):
    """Phase 7e: a width-4 FusedTrainer (runtime/hfta.py) on bench.py's
    LM cell: HFTA_WARMUP fused steps, then, the launch counters zeroed
    just before and read just after, HFTA_STEPS more from the members'
    states (m1 re-enters frozen at its stop): flash_fwd, flash_dq and
    flash_dkv 12 times a fused step (one folded launch a layer for every
    member), m1's parameters bit-equal to its step-2 snapshot, losses
    finite.  Then one fused step against solo steps on the same weights,
    and the folded kernels against their plain versions at bh 256.
    Information: the fused step against phase 7's solo step, tokens/s,
    peak memory, one profiled fused step."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime.hfta import FusedTrainer

    cfg = TransformerConfig(**dict(MODEL, max_seq_len=TRAIN_SEQ,
                                   dtype=torch.bfloat16, remat=True))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    members = hfta_members()

    def trainer():
        return FusedTrainer(init_fn=init_fn, loss_fn=loss_fn,
                            members=members, device="cuda")

    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, size=(
        TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    ft = trainer()
    warm = ft.fit(itertools.repeat(batch), HFTA_WARMUP, log_every=1,
                  examples_per_step=TRAIN_BATCH)
    snapshot = {k: v[1].detach().clone() for k, v in warm.params.items()}
    states = [ft.member_state(warm, i) for i in range(HFTA_MEMBERS)]
    del warm
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    final = ft.fit(itertools.repeat(batch), HFTA_WARMUP + HFTA_STEPS,
                   member_states=states, log_every=1,
                   examples_per_step=TRAIN_BATCH)
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = MODEL["n_layers"] * HFTA_STEPS
    log(f"kernel launches on the HFTA path ({HFTA_STEPS} fused steps of "
        f"{HFTA_MEMBERS} members): {counts} (want {want} = "
        f"{MODEL['n_layers']} layers x {HFTA_STEPS} steps of each of "
        f"{', '.join(TRAIN_KERNELS)}: one folded launch a layer)")
    if any(counts[k] != want for k in TRAIN_KERNELS):
        fail(f"the fused step launched the wrong number of kernels: {counts}")
    steps = [int(s) for s in final.step.tolist()]
    frozen = all(torch.equal(final.params[k][1], v)
                 for k, v in snapshot.items())
    log(f"hfta member steps {steps}; m1 bit-equal to its step-"
        f"{HFTA_STOP} snapshot: {frozen}")
    if not frozen or steps != [HFTA_WARMUP + HFTA_STEPS, HFTA_STOP,
                               HFTA_WARMUP + HFTA_STEPS,
                               HFTA_WARMUP + HFTA_STEPS]:
        fail("the early-stopped member moved, or the steps are wrong")
    losses = [ft.last_metrics[f"loss/m{i}"] for i in range(HFTA_MEMBERS)]
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite HFTA losses {losses}")
    history = ft.metrics.history[-HFTA_STEPS:]
    step_s = sorted(r["step_time_s"] for r in history)[HFTA_STEPS // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    active = HFTA_MEMBERS - 1
    mfu = 3 * cfg.flops_per_token() * tokens * HFTA_MEMBERS / step_s \
        / PEAK_BF16_FLOPS
    step = ft.compile_step()
    still = torch.tensor([i != 1 for i in range(HFTA_MEMBERS)],
                         device="cuda")
    stops = torch.full((HFTA_MEMBERS,), 10 ** 6, device="cuda")
    device_batch = ft.shard_batch(batch)
    busy = profile_busy(torch, lambda: (
        step(final, still, stops, device_batch), torch.cuda.synchronize()),
        "one HFTA fused step")
    log(f"hfta: {HFTA_STEPS} fused steps of {HFTA_MEMBERS} members ("
        f"{active} active, m1 frozen) on batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"losses {[round(x, 4) for x in losses]}; median fused step "
        f"{step_s * 1e3:.1f} ms (host clock after a sync each step) against "
        f"phase 7's solo step {solo_info['step_ms']:.1f} ms in this call "
        f"({step_s * 1e3 / solo_info['step_ms']:.3f}x for "
        f"{HFTA_MEMBERS} members); {tokens / step_s:.0f} tokens/s a member, "
        f"{HFTA_MEMBERS * tokens / step_s:.0f} computed and "
        f"{active * tokens / step_s:.0f} applied in all, against "
        f"{solo_info['tokens_per_s']:.0f} solo; MFU {mfu:.4f} over the "
        f"{HFTA_MEMBERS} members' work; peak memory {peak_gib:.2f} GiB "
        f"(information only)")
    del final, step, device_batch
    torch.cuda.empty_cache()
    check = trainer()
    vs_solo = hfta_against_solo(torch, check, states, batch, loss_fn)
    del check, states
    torch.cuda.empty_cache()
    folded = hfta_folded_kernels(torch, flash)
    return counts, {"step_ms": step_s * 1e3, "solo_step_ms":
                    solo_info["step_ms"], "tokens_per_s_member":
                    tokens / step_s, "tokens_per_s_total":
                    HFTA_MEMBERS * tokens / step_s, "mfu": mfu,
                    "peak_gib": peak_gib, "losses": losses, "busy": busy,
                    "vs_solo": vs_solo, "folded": folded}


def checkpoint_and_data(torch, workdir: Path):
    """Phase 10: tools/train_lm.run on the bench flags with
    --optimizer adafactor, --data-files (KFTR shards written by the
    port's writer) and --checkpoint-dir: 4 steps saving every 2, each
    saved step verified; a rerun to 6 steps resumes at step 4; with the
    newest step's file truncated, a rerun to 8 steps walks back to the
    step before it.  Then one save and one restore of the trained state,
    timed."""
    import numpy as np

    from kubeflow_tpu_torch.data import write_example_shards
    from kubeflow_tpu_torch.runtime import checkpoint
    from kubeflow_tpu_torch.tools import train_lm

    rng = np.random.RandomState(SEED)
    files = [str(p) for p in write_example_shards(
        ({"tokens": rng.randint(0, MODEL["vocab_size"], size=(
            TRAIN_SEQ,)).astype(np.int32)} for _ in range(CKPT_EXAMPLES)),
        workdir / "data", examples_per_shard=CKPT_EXAMPLES // CKPT_SHARDS)]
    ckpt = workdir / "ckpt"
    flags = TRAIN_FLAGS + [
        "--optimizer", "adafactor", "--data-files", *files,
        "--checkpoint-dir", str(ckpt), "--checkpoint-every", str(CKPT_EVERY),
        "--log-every", "1", "--max-restarts", "0"]

    def run(steps):
        t0 = time.perf_counter()
        trainer = train_lm.run(flags + ["--steps", str(steps)])
        seen = [r["step"] for r in trainer.metrics.history]
        losses = [r["loss"] for r in trainer.metrics.history]
        if not all(map(math.isfinite, losses)):
            fail(f"non-finite losses with checkpoints and data: {losses}")
        return trainer, seen, time.perf_counter() - t0

    trainer, seen, t_first = run(4)
    steps = trainer.checkpoints.all_steps()
    verdicts = {s: checkpoint.verify_step(ckpt, s) for s in steps}
    if seen != [0, 1, 2, 3] or steps != [1, 3] or not all(
            ok for ok, _ in verdicts.values()):
        fail(f"first run: history {seen}, saved {steps}, verify {verdicts}")
    _, seen, t_resume = run(6)
    if seen != [4, 5]:
        fail(f"the rerun to 6 steps did not resume at step 4: {seen}")
    newest = checkpoint.list_checkpoint_steps(ckpt)[-1]
    state_file = ckpt / str(newest) / checkpoint.STATE_FILE
    state_file.write_bytes(state_file.read_bytes()[:-4096])
    trainer, seen, t_walk = run(8)
    if newest != 5 or seen != [4, 5, 6, 7]:
        fail(f"truncated step {newest}: the rerun to 8 steps trained "
             f"{seen}, not a walk back to step 3 (steps 4-7)")
    nbytes = sum(v["size"] for v in json.loads(checkpoint.manifest_path(
        ckpt, 7).read_text())["files"].values())
    # One save and one restore of the trained state, timed.
    fresh = trainer.create_state()
    mgr = checkpoint.CheckpointManager(workdir / "timed")
    t0 = time.perf_counter()
    _, start = checkpoint.CheckpointManager(ckpt).restore_or_init(fresh)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.save(0, fresh)
    t_save_call = time.perf_counter() - t0
    mgr.wait()
    t_save = time.perf_counter() - t0
    if start != 8 or not checkpoint.verify_step(workdir / "timed", 0)[0]:
        fail(f"restore started at {start}, want 8; or the timed save "
             "did not verify")
    log(f"checkpoint and data: 4 steps saved {steps} (verified), a rerun "
        f"resumed at step 4, a truncated step {newest} walked back to "
        f"step 3; runs took {t_first:.1f} / {t_resume:.1f} / {t_walk:.1f} "
        f"s (three model inits included); checkpoint {nbytes} bytes; save "
        f"{t_save:.3f} s ({t_save_call:.3f} s in the caller: the host "
        f"copy), restore {t_restore:.3f} s (information only)")
    return {"checkpoint_bytes": nbytes, "save_s": t_save,
            "save_call_s": t_save_call, "restore_s": t_restore}


def check_gradients(torch, flash):
    """Phase 8: one step's gradients of the bf16 model at full width and
    depth through the kernels and through the plain versions, each held
    to a float32 run of the same weights with plain attention."""
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        lm_task,
    )

    base = dict(MODEL, max_seq_len=TRAIN_SEQ, remat=True)
    cfg = TransformerConfig(**dict(base, dtype=torch.bfloat16))
    cfg32 = TransformerConfig(**dict(base, dtype=torch.float32,
                                     attention="dot"))
    model = Transformer(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    model32 = Transformer(cfg32, device="meta")
    model32.load_state_dict(
        {k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    tokens = torch.randint(0, MODEL["vocab_size"], (2, TRAIN_SEQ),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(SEED + 1))

    def grads(m):
        _, loss_fn = lm_task(m.cfg, device="cuda")
        loss, _ = loss_fn(m, {}, {"tokens": tokens}, None)
        loss.backward()
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.item(), flat

    before = dict(flash.launch_counts)
    loss_k, g_k = grads(model)
    launched = {k: flash.launch_counts[k] - before[k] for k in TRAIN_KERNELS}
    if any(n != MODEL["n_layers"] for n in launched.values()):
        fail(f"the gradient step did not launch each kernel once per layer: "
             f"{launched}")
    # The same weights with the two-pass forward (pass A, pass B, merge).
    bq, bk, bd = TWO_PASS_BLOCKS
    model2 = Transformer(TransformerConfig(**dict(
        base, dtype=torch.bfloat16, flash_block_q=bq, flash_block_k=bk,
        flash_block_diag=bd)), device="meta")
    model2.load_state_dict(
        {k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    before = dict(flash.launch_counts)
    loss_2, g_2 = grads(model2)
    launched = {k: flash.launch_counts[k] - before[k]
                for k in TWO_PASS_KERNELS + ("flash_fwd",)}
    if launched != dict({k: MODEL["n_layers"] for k in TWO_PASS_KERNELS},
                        flash_fwd=0):
        fail(f"the two-pass gradient step launched {launched}")
    del model2
    with plain_kernels(flash):
        loss_p, g_p = grads(model)
    loss_r, g_r = grads(model32)
    ref = g_r.norm()
    err_k = ((g_k - g_r).norm() / ref).item()
    err_2 = ((g_2 - g_r).norm() / ref).item()
    err_p = ((g_p - g_r).norm() / ref).item()
    log(f"gradients, batch 2 x {TRAIN_SEQ}, {g_r.numel()} parameters, "
        f"against float32 with plain attention (loss {loss_r:.6f}): kernel "
        f"path relative error {err_k:.4e} (loss {loss_k:.6f}), two-pass "
        f"kernel path {err_2:.4e} (loss {loss_2:.6f}), plain bf16 "
        f"path {err_p:.4e} (loss {loss_p:.6f}), |kernel - plain| / |ref| "
        f"{((g_k - g_p).norm() / ref).item():.4e} (bound: each kernel "
        f"path <= {GRAD_ERR_RATIO} x plain)")
    if not (torch.isfinite(g_k).all() and torch.isfinite(g_2).all()
            and max(err_k, err_2) <= GRAD_ERR_RATIO * err_p):
        fail("gradients through the kernels are further from float32 than "
             "through the plain versions")
    return {"rel_err_kernel": err_k, "rel_err_two_pass": err_2,
            "rel_err_plain": err_p}


def learn_and_breakdown(torch):
    """Phase 9: Trainer.fit on one repeated batch must learn; then one
    profiled training step of the bench batch (information only)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.train import Trainer

    cfg = TransformerConfig(**dict(MODEL, max_seq_len=TRAIN_SEQ, remat=True,
                                   dtype=torch.bfloat16))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adamw(1e-3), device="cuda")
    state = trainer.create_state(SEED)
    rng = np.random.RandomState(SEED)
    # Tokens from a 512-id subset of the vocabulary: a batch to memorize.
    batch = {"tokens": rng.randint(0, LEARN_VOCAB, size=(
        LEARN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    state = trainer.fit(itertools.repeat(batch), LEARN_STEPS, state=state,
                        log_every=1)
    losses = [r["loss"] for r in trainer.metrics.history]
    log(f"learning: {LEARN_STEPS} steps on one repeated {LEARN_BATCH} x "
        f"{TRAIN_SEQ} batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(bound: a drop of at least 1 nat)")
    if not (math.isfinite(losses[-1]) and losses[-1] <= losses[0] - 1.0):
        fail("the loss did not fall by 1 nat on a repeated batch")

    step = trainer.compile_step()
    big = {"tokens": rng.randint(0, MODEL["vocab_size"], size=(
        TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}

    def one():
        nonlocal state
        state, _ = step(state, trainer.shard_batch(big))
        torch.cuda.synchronize()

    one()  # warm-up at this batch shape
    t0 = time.perf_counter()
    one()
    t_step = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        t_prof = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log("train breakdown: the profiler saw no device time; device busy "
            "share not measured")
        return {"step_ms": t_step * 1e3}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    shares = {}
    for name in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
        shares[name] = sum(e.self_device_time_total for e in kernels
                           if name in e.key) / busy_us
    log(f"train breakdown, one step of batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"under torch.profiler: wall {t_prof * 1e3:.1f} ms (unprofiled "
        f"{t_step * 1e3:.1f} ms), device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / (t_prof * 1e6):.3f} of the profiled wall, "
        f"{busy_us / (t_step * 1e6):.3f} of the unprofiled one); share of "
        f"busy: " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    for e in kernels[:8]:
        log(f"  {e.self_device_time_total / busy_us:.3f} of busy, "
            f"{e.count} launches: {e.key[:100]}")
    return {"step_ms": t_step * 1e3, "busy_ms": busy_us / 1e3,
            "shares": shares}


def cnn_model(name: str, dtype, device):
    """The served model of ``name`` as its loader config builds it."""
    from kubeflow_tpu_torch.models.inception import InceptionV3
    from kubeflow_tpu_torch.models.resnet import ResNetConfig

    config, _ = CNN_SERVED[name]
    if config["family"] == "inception_v3":
        return InceptionV3(num_classes=config["num_classes"], dtype=dtype,
                           device=device)
    return ResNetConfig._FACTORIES[config["family"]](
        num_classes=config["num_classes"], dtype=dtype, device=device,
        num_filters=config.get("num_filters", 64))


def export_cnn(torch, base: Path, name: str) -> dict:
    from kubeflow_tpu_torch.serving.export import export

    config, size = CNN_SERVED[name]
    from kubeflow_tpu_torch.testing.cnn import random_cnn_variables

    model = cnn_model(name, torch.float32, "meta")
    variables = random_cnn_variables(model, SEED)
    export(base, 1, variables, loader=CNN_LOADER, config=config,
           signature={"inputs": {"image": [None, size, size, 3]},
                      "outputs": {"scores": [None, config["num_classes"]]}})
    n = sum(p.numel() for p in model.parameters())
    log(f"exported seeded {config['family']} ({n} parameters, "
        f"{size} x {size}, {config['num_classes']} classes) to {base}")
    return variables


def profile_busy(torch, fn, what: str, top: int = 8) -> dict:
    """One call of ``fn`` (which ends in a synchronize) under
    torch.profiler: device busy time, its share of the profiled wall,
    and the kernels with the most device time (information only)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log(f"{what}: the profiler saw no device time; busy share not "
            "measured")
        return {"wall_ms": wall * 1e3, "busy_ms": None}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log(f"{what} under torch.profiler: wall {wall * 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms ({busy_us / (wall * 1e6):.3f} of the "
        f"wall), {sum(e.count for e in kernels)} kernel launches "
        f"(information only)")
    tops = []
    for e in kernels[:top]:
        share = e.self_device_time_total / busy_us
        tops.append({"kernel": e.key[:100], "share": share,
                     "launches": e.count})
        log(f"  {share:.3f} of busy, {e.count} launches: {e.key[:100]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / (wall * 1e6), "top": tops}


def cnn_images(name: str, n: int, seed: int, floats: bool = False):
    """n uint8 images of the model's size; with ``floats``, every odd one
    sent as float32 pixels scaled to [0, 1] instead."""
    import numpy as np

    _, size = CNN_SERVED[name]
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for _ in range(n)]
    return [im.astype(np.float32) / 255.0 if floats and i % 2 else im
            for i, im in enumerate(images)]


def check_cnn_reply(name: str, reply: dict) -> None:
    """Scores of the model's width summing to 1, the top k sorted and
    equal to the scores at its classes."""
    import numpy as np

    config, _ = CNN_SERVED[name]
    scores = np.asarray(reply["scores"], np.float64)
    classes = np.asarray(reply["top_k_classes"])
    top = np.asarray(reply["top_k_scores"], np.float64)
    if scores.shape != (config["num_classes"],) or not np.all(
            np.isfinite(scores)) or abs(scores.sum() - 1.0) > 1e-3:
        fail(f"{name}: scores of shape {scores.shape} summing to "
             f"{scores.sum()}")
    if classes.shape != (config["top_k"],) or np.any(np.diff(top) > 0) \
            or not np.array_equal(top, scores[classes]) \
            or top[0] != scores.max():
        fail(f"{name}: top k {classes.tolist()} / {top.tolist()} is not the "
             "sorted head of the scores")


class bf16_batchnorm:
    """Phase 11's control run: eval-mode BatchNorm normalizing in bf16
    (its statistics, scale and bias rounded to bf16, the arithmetic in
    bf16) where the models normalize in float32.  The logits bound must
    not hold this run."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from kubeflow_tpu_torch.models import resnet

        torch = self.torch
        self.resnet, self.forward = resnet, resnet.BatchNorm.forward
        forward = self.forward

        def bf16_forward(module, x, stats, train):
            if train or x.dtype != torch.bfloat16:
                return forward(module, x, stats, train)

            def channel(t):
                return t.to(torch.bfloat16)[:, None, None]

            inv = torch.rsqrt(channel(stats["var"]) + module.epsilon)
            return (x - channel(stats["mean"])) * inv \
                * channel(module.scale) + channel(module.bias), stats

        resnet.BatchNorm.forward = bf16_forward
        return self

    def __exit__(self, *exc):
        self.resnet.BatchNorm.forward = self.forward


def serve_cnn_model(torch, base: Path, name: str, variables: dict):
    """Phase 11, one model: the port's serving entry point with
    --micro_batch_size 8, a concurrent burst of 16 :predict requests
    (uint8 pixel lists and float32 lists in turns), then one :predict and
    one :classify of the same image alone, and one direct 8-row request
    of uint8 pixels.
    Every reply checked; the served scores equal to the loader's own
    predict on the same rows at the batch size they were served in; the
    bf16 logits held to a float32 run of the same weights."""
    import numpy as np

    from kubeflow_tpu_torch.models.convert_cnn import load_cnn_variables
    from kubeflow_tpu_torch.serving import main as serving_main

    config, size = CNN_SERVED[name]
    images = cnn_images(name, CNN_BURST, SEED + 11, floats=True)
    direct = cnn_images(name, CNN_DIRECT_ROWS, SEED + 12)
    server, httpd = serving_main.start([
        "--model_name", name, "--model_base_path", str(base),
        "--port", "0", "--grpc_port", "-1", "--host", "127.0.0.1",
        "--device", "cuda",
        "--micro_batch_size", str(CNN_MICRO_BATCH)])
    port = httpd.server_address[1]
    route = f"/model/{name}"
    try:
        post(port, {"instances": [images[0].tolist()]},
             f"{route}:predict")  # the process's first cuDNN work
        before = server.batcher_stats(name)["batch_size_hist"]
        replies, latencies = [None] * CNN_BURST, [None] * CNN_BURST

        def call(i):
            t = time.perf_counter()
            replies[i] = post(port, {"instances": [images[i].tolist()]},
                              f"{route}:predict")["predictions"][0]
            latencies[i] = time.perf_counter() - t

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(CNN_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_burst = time.perf_counter() - t0
        if None in replies:
            fail(f"{name}: a request of the burst did not complete")
        stats = server.batcher_stats(name)
        alone = post(port, {"instances": [images[0].tolist()]},
                     f"{route}:predict")["predictions"][0]
        classified = post(port, {"instances": [images[0].tolist()]},
                          f"{route}:classify")
        t1 = time.perf_counter()
        direct_reply = post(port, {"instances": [x.tolist()
                                                 for x in direct]},
                            f"{route}:predict")["predictions"]
        t_direct = time.perf_counter() - t1
        predict = server.get(name).predict
    finally:
        serving_main.shutdown(server, httpd)
    for reply in replies + [alone] + direct_reply:
        check_cnn_reply(name, reply)
    pairs = classified["result"]["classifications"]
    want = [[str(c), s] for c, s in zip(alone["top_k_classes"],
                                        alone["top_k_scores"])]
    if len(pairs) != 1 or pairs[0] != want:
        fail(f"{name}: :classify {pairs} is not :predict's top k {want}")

    # The server adds no numeric change: each served row equals the
    # loader's predict on the same image at its served batch size (the
    # batcher pads to 1, 2, 4 or 8 rows; the image repeated to fill).
    hist = {n: k - before.get(n, 0)
            for n, k in stats["batch_size_hist"].items()
            if k > before.get(n, 0)}
    padded = sorted({next(s for s in (1, 2, 4, 8) if s >= int(n))
                     for n in hist})

    def scores_at(image, rows):
        batch = np.stack([image] * rows)
        return predict({"image": batch})["scores"][0]

    for i, reply in enumerate(replies):
        got = np.asarray(reply["scores"], np.float32)
        if not any(np.array_equal(got, scores_at(images[i], rows))
                   for rows in padded):
            fail(f"{name}: served request {i} differs from the loader's "
                 f"predict at every served batch size {padded}")
    mine = predict({"image": np.stack(direct)})["scores"]
    if not np.array_equal(np.asarray([r["scores"] for r in direct_reply],
                                     np.float32), mine):
        fail(f"{name}: the direct 8-row reply differs from the loader's "
             "predict on the same rows")
    if not np.array_equal(np.asarray(alone["scores"], np.float32),
                          scores_at(images[0], 1)):
        fail(f"{name}: the lone request differs from the loader's predict")

    # bf16 logits against float32 (TF32 off) on the direct rows.
    x = torch.from_numpy(np.stack(direct).astype(np.float32) / 255.0).cuda()
    f32 = cnn_model(name, torch.float32, "cuda")
    stats32 = load_cnn_variables(f32, variables)
    with torch.inference_mode():
        want32 = f32(x, stats32)
        got16 = predict.model(x, predict.batch_stats)
        with bf16_batchnorm(torch):
            control = predict.model(x, predict.batch_stats)
    rel = ((got16 - want32).norm() / want32.norm()).item()
    rel_control = ((control - want32).norm() / want32.norm()).item()
    bound = CNN_LOGITS_REL_TOL[name]
    log(f"{name}: bf16 logits against float32 (TF32 off) on "
        f"{CNN_DIRECT_ROWS} images: relative Frobenius error {rel:.4e}, "
        f"the control with BatchNorm normalizing in bf16 {rel_control:.4e} "
        f"(bound {bound}); argmax agrees on "
        f"{int((got16.argmax(-1) == want32.argmax(-1)).sum())} of "
        f"{CNN_DIRECT_ROWS}")
    if not rel <= bound:
        fail(f"{name}: bf16 logits are {rel:.4e} from float32")
    if not rel_control > bound:
        fail(f"{name}: the bf16-BatchNorm control reads {rel_control:.4e}, "
             f"inside the bound {bound}: the bound would not see that loss "
             "of precision")
    del f32, stats32

    def one_batch():
        predict({"image": np.stack(direct)})
        torch.cuda.synchronize()

    one_batch()
    t0 = time.perf_counter()
    one_batch()
    t_batch = time.perf_counter() - t0
    busy = profile_busy(torch, one_batch,
                        f"{name}: one served batch of {CNN_DIRECT_ROWS}")
    info = {
        "burst_s": t_burst, "requests_per_s": CNN_BURST / t_burst,
        "latency_p50_s": pct(latencies, 0.5),
        "latency_p99_s": pct(latencies, 0.99),
        "batch_size_hist": hist, "direct_8_rows_s": t_direct,
        "batch_of_8_ms": t_batch * 1e3, "logits_rel_err": rel,
        "control_rel_err": rel_control,
        "profile": busy}
    log(f"{name} ({config['family']}, {size} x {size}): burst of "
        f"{CNN_BURST} :predict in {t_burst:.3f} s, "
        f"{info['requests_per_s']:.2f} requests/s, latency p50 "
        f"{info['latency_p50_s']:.3f} s p99 {info['latency_p99_s']:.3f} s "
        f"(client clock, JSON encoding in the same process); batch sizes "
        f"{hist}; direct {CNN_DIRECT_ROWS}-row request {t_direct:.3f} s; "
        f"one batch of {CNN_DIRECT_ROWS} through the loader "
        f"{t_batch * 1e3:.2f} ms (host clock after a sync; information "
        f"only; {card_line()})")
    return info


def serve_cnn(torch, flash, workdir: Path) -> dict:
    """Phase 11: ResNet-50 at 224 and Inception-v3 at 299 (1000 classes,
    seeded weights) served over REST through the classifier loader and
    the MicroBatcher; no flash kernel may launch."""
    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    info = {}
    for name in CNN_SERVED:
        base = workdir / name
        variables = export_cnn(torch, base, name)
        info[name] = serve_cnn_model(torch, base, name, variables)
    launched = {k: n for k, n in flash.launch_counts.items() if n}
    if launched:
        fail(f"the CNN serving path launched flash kernels: {launched}")
    log("CNN serving launched no flash kernel")
    return info


def train_cnn_phase(torch, flash, workdir: Path) -> dict:
    """Phase 12: tools/train_cnn.run on bench.py's ResNet-50 cell (batch
    256 at 224, bf16, sgd(0.1, momentum 0.9), synthetic data) for 4
    steps, verified checkpoints every 2; Trainer.fit for 30 steps on one
    repeated batch of 32 must lower the loss; then, information only,
    the step on a batch staged on the card: time, images/s, MFU, peak
    memory and one profiled step."""
    import numpy as np

    from kubeflow_tpu_torch.models.classification import classification_task
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.runtime import checkpoint, optim
    from kubeflow_tpu_torch.runtime.train import Trainer
    from kubeflow_tpu_torch.tools import train_cnn

    for key in flash.launch_counts:
        flash.launch_counts[key] = 0
    ckpt = workdir / "cnn_ckpt"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_cnn.run(CNN_TRAIN_FLAGS + [
        "--steps", str(CNN_TRAIN_STEPS), "--log-every", "1",
        "--checkpoint-dir", str(ckpt), "--checkpoint-every",
        str(CNN_CKPT_EVERY), "--max-restarts", "0"])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    history = trainer.metrics.history
    losses = [r["loss"] for r in history]
    if len(losses) != CNN_TRAIN_STEPS or not all(
            map(math.isfinite, losses + [trainer.last_metrics.get(
                "grad_norm", float("nan"))])):
        fail(f"train_cnn: non-finite or missing losses {losses}")
    saved = trainer.checkpoints.all_steps()
    verdicts = {s: checkpoint.verify_step(ckpt, s) for s in saved}
    if saved != [1, 3] or not all(ok for ok, _ in verdicts.values()):
        fail(f"train_cnn: saved steps {saved}, verify {verdicts}")
    run_step = sorted(r["step_time_s"] for r in history[1:])
    run_step = run_step[len(run_step) // 2]
    log(f"train_cnn.run: {CNN_TRAIN_STEPS} steps of ResNet-50, batch "
        f"{CNN_TRAIN_BATCH} x 224 x 224, losses "
        f"{[round(x, 4) for x in losses]}, saved steps {saved} (verified); "
        f"median step {run_step * 1e3:.1f} ms over steps 1-"
        f"{CNN_TRAIN_STEPS - 1} with the host drawing each synthetic batch "
        f"(numpy randn), whole run {t_run:.1f} s (information only)")

    flops = ResNetConfig("resnet50").fwd_flops_per_image
    cfg = ResNetConfig("resnet50", dtype=torch.bfloat16)

    def fresh_trainer():
        init_fn, loss_fn = classification_task(
            cfg.build(device="cuda"), (1, 224, 224, 3), device="cuda")
        return Trainer(init_fn=init_fn, loss_fn=loss_fn,
                       tx=optim.sgd(0.1, momentum=0.9), device="cuda")

    learner = fresh_trainer()
    rng = np.random.RandomState(SEED)
    batch = {"image": rng.randn(CNN_LEARN_BATCH, 224, 224, 3).astype(
        np.float32), "label": rng.randint(0, 1000, size=(CNN_LEARN_BATCH,))}
    learner.fit(itertools.repeat(batch), CNN_LEARN_STEPS,
                state=learner.create_state(SEED), log_every=1)
    learned = [r["loss"] for r in learner.metrics.history]
    tail = sum(learned[-5:]) / 5
    log(f"learning: {CNN_LEARN_STEPS} steps on one repeated batch of "
        f"{CNN_LEARN_BATCH}: first loss {learned[0]:.4f}, mean of the last "
        f"5 {tail:.4f}, a drop of {learned[0] - tail:.4f} (bound: the mean "
        f"of the last 5 below the first)")
    if not (math.isfinite(tail) and tail < learned[0]):
        fail("the ResNet-50 loss did not fall on a repeated batch")
    del learner

    timer = fresh_trainer()
    state = timer.create_state(SEED)
    step = timer.compile_step()
    big = timer.shard_batch({
        "image": rng.randn(CNN_TRAIN_BATCH, 224, 224, 3).astype(np.float32),
        "label": rng.randint(0, 1000, size=(CNN_TRAIN_BATCH,))})
    torch.cuda.reset_peak_memory_stats()

    def one():
        nonlocal state
        state, _ = step(state, big)
        torch.cuda.synchronize()

    one()  # warm-up at this batch shape
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[1]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    mfu = 3 * flops * CNN_TRAIN_BATCH / step_s / PEAK_BF16_FLOPS
    log(f"ResNet-50 step on a staged batch of {CNN_TRAIN_BATCH} x 224 x "
        f"224: median of 3 {step_s * 1e3:.1f} ms (host clock after a "
        f"sync), {CNN_TRAIN_BATCH / step_s:.1f} images/s, MFU {mfu:.4f} "
        f"(3 x {flops:.3g} x {CNN_TRAIN_BATCH} / step / "
        f"{PEAK_BF16_FLOPS:.3g}), peak memory {peak_gib:.2f} GiB "
        f"(information only; {card_line()})")
    busy = profile_busy(torch, one, f"one ResNet-50 training step of "
                        f"batch {CNN_TRAIN_BATCH}")
    launched = {k: n for k, n in flash.launch_counts.items() if n}
    if launched:
        fail(f"the CNN training path launched flash kernels: {launched}")
    log("CNN training launched no flash kernel")
    return {"run_losses": losses, "run_step_ms": run_step * 1e3,
            "saved_steps": saved, "learn_first": learned[0],
            "learn_last5": tail, "step_ms": step_s * 1e3,
            "images_per_s": CNN_TRAIN_BATCH / step_s, "mfu": mfu,
            "peak_gib": peak_gib, "profile": busy}


# One rank of the CNN gang: train_cnn.run with its flash launches, its
# gloo all-reduces, bn_init's running statistics after the last step and
# that step under torch.profiler.
_CNN_GANG_RANK = r"""
import json, os, sys, time
import torch
import torch.distributed as dist
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.runtime.train import Trainer
from kubeflow_tpu_torch.tools import train_cnn
from torch.profiler import ProfilerActivity, profile
steps = int(sys.argv[1])
reduces, seen, profiled, final = [], [0], {}, {}
all_reduce, body, fit = dist.all_reduce, Trainer._step_body, Trainer.fit


def counted(t, *args, **kw):
    t0 = time.perf_counter()
    out = all_reduce(t, *args, **kw)
    reduces.append((t.numel() * t.element_size(), time.perf_counter() - t0))
    return out


def step_body(self, state, batch):
    seen[0] += 1
    if seen[0] < steps:
        return body(self, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = body(self, state, batch)
        torch.cuda.synchronize()
        profiled["wall"] = (time.perf_counter() - t0) * 1e3
    profiled["busy"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return out


def kept_fit(self, *args, **kw):
    final["state"] = fit(self, *args, **kw)
    return final["state"]


dist.all_reduce, Trainer._step_body, Trainer.fit = counted, step_body, kept_fit
for key in flash.launch_counts:
    flash.launch_counts[key] = 0
torch.cuda.reset_peak_memory_stats()
trainer = train_cnn.run(sys.argv[2:])
torch.cuda.synchronize()
bn = final["state"].mutable["batch_stats"]["bn_init"]
print("RESULT " + json.dumps(dict(
    launches=dict(flash.launch_counts), history=trainer.metrics.history,
    bn_mean=bn["mean"].tolist(), bn_var=bn["var"].tolist(),
    world=dist.get_world_size(),
    reduces_per_step={"calls": len(reduces) / steps,
                      "bytes": sum(c[0] for c in reduces) / steps,
                      "ms": sum(c[1] for c in reduces) * 1e3 / steps},
    profiled_step_ms=profiled["wall"], busy_ms=profiled["busy"] or None,
    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)), flush=True)
"""


def cnn_gang_reference(torch, rows: int):
    """One process on the global batch of the CNN gang (train_cnn's
    synthetic stream: rank d's ``rows`` from RandomState(d) a step), from
    train_cnn's seed and optimizer: the losses of CNN_GANG_STEPS steps and
    bn_init's running mean and variance after them."""
    import numpy as np

    from kubeflow_tpu_torch.models.classification import classification_task
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.runtime import optim
    from kubeflow_tpu_torch.runtime.train import Trainer

    cfg = ResNetConfig("resnet50", dtype=torch.bfloat16)
    init_fn, loss_fn = classification_task(
        cfg.build(device="cuda"), (1, 224, 224, 3), device="cuda")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.sgd(0.1, momentum=0.9), device="cuda")
    state = trainer.create_state()
    step = trainer.compile_step()
    streams = [np.random.RandomState(d) for d in range(CNN_GANG_WORLD)]
    losses = []
    for _ in range(CNN_GANG_STEPS):
        parts = [{"image": r.randn(rows, 224, 224, 3).astype(np.float32),
                  "label": r.randint(0, 1000, size=(rows,))}
                 for r in streams]
        state, m = step(state, trainer.shard_batch(
            {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}))
        losses.append(float(m["loss"]))
    bn = state.mutable["batch_stats"]["bn_init"]
    out = {"losses": losses, "bn_mean": bn["mean"].cpu(),
           "bn_var": bn["var"].cpu()}
    del trainer, state
    torch.cuda.empty_cache()
    return out


def cnn_gang_phase(torch, flash, workdir: Path) -> dict:
    """Phase 12b: tools/train_cnn.run on bench.py's ResNet-50 cell as a
    gang of CNN_GANG_WORLD processes on the one GPU over gloo, each on
    its share of the batch of 256, against one process on the same rows:
    the ranks' losses equal, finite and within CNN_GANG_LOSS_ATOL of it,
    bn_init's running statistics equal on both ranks and within
    CNN_GANG_STATS_RTOL of its, no flash launch, the phase within
    CNN_GANG_PHASE_S.  Information: each rank's step ms, its all-reduces
    a step, a profiled step's busy share and its peak memory."""
    from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

    t_phase = time.perf_counter()
    rows = CNN_TRAIN_BATCH // CNN_GANG_WORLD
    argv = CNN_TRAIN_FLAGS + [
        "--batch-size-per-device", str(rows), "--steps",
        str(CNN_GANG_STEPS), "--log-every", "1", "--max-restarts", "0"]
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(
            run_ranks, ["-c", _CNN_GANG_RANK, str(CNN_GANG_STEPS), *argv],
            CNN_GANG_WORLD, timeout_s=CNN_GANG_TIMEOUT_S,
            cwd=str(Path(__file__).resolve().parent),
            env=dict(os.environ, KFT_DIST_BACKEND="gloo"))
        ref = cnn_gang_reference(torch, rows)
        results = future.result()
    try:
        check_ranks(results)
    except RuntimeError as e:
        fail(f"the CNN gang failed: {e}")
    ranks = [json.loads(next(ln for ln in r.stdout.splitlines()
                             if ln.startswith("RESULT "))[7:])
             for r in results]
    losses = [[h["loss"] for h in r["history"]] for r in ranks]
    diff = max(abs(a - b) for a, b in zip(losses[0], ref["losses"]))

    def rel(key):
        got = torch.tensor(ranks[0][key])
        return float((got - ref[key]).norm() / ref[key].norm())

    stats_rel = max(rel("bn_mean"), rel("bn_var"))
    equal = all(r["bn_mean"] == ranks[0]["bn_mean"]
                and r["bn_var"] == ranks[0]["bn_var"] for r in ranks)
    launched = {k: n for r in ranks for k, n in r["launches"].items() if n}
    log(f"CNN gang ({CNN_GANG_WORLD} processes x {rows} rows): losses "
        f"{[round(x, 5) for x in losses[0]]} on every rank: "
        f"{all(x == losses[0] for x in losses)}; one process's on the same "
        f"{CNN_TRAIN_BATCH} rows {[round(x, 5) for x in ref['losses']]}: "
        f"max |diff| {diff:.2e} (bound {CNN_GANG_LOSS_ATOL}); bn_init's "
        f"running statistics equal on both ranks: {equal}, relative "
        f"{rel('bn_mean'):.2e} (mean) and {rel('bn_var'):.2e} (var) from "
        f"one process's (bound {CNN_GANG_STATS_RTOL}); flash launches "
        f"{launched or 0}")
    for r, rank in enumerate(ranks):
        busy, wall = rank["busy_ms"], rank["profiled_step_ms"]
        share = "not measured" if busy is None else f"{busy / wall:.3f}"
        per = rank["reduces_per_step"]
        steps_ms = [round(h["step_time_s"] * 1e3, 1)
                    for h in rank["history"]]
        log(f"CNN gang rank {r}: steps {steps_ms} ms (the first carries "
            f"start-up, the last is the profiled one, each with the host "
            f"drawing its synthetic batch); profiled step {wall:.1f} ms, "
            f"busy {busy} ms (share {share}), peak {rank['peak_gib']:.2f} "
            f"GiB; a step's gloo all-reduces {per['calls']:.0f} "
            f"({per['bytes'] / 2 ** 20:.1f} MiB, {per['ms']:.1f} ms) (both "
            "ranks on one GPU, staged through host memory; host clock "
            "after a sync; information only)")
    if launched:
        fail(f"the CNN gang launched flash kernels: {launched}")
    if not (all(r["world"] == CNN_GANG_WORLD for r in ranks)
            and len(losses[0]) == CNN_GANG_STEPS
            and all(x == losses[0] for x in losses)
            and all(map(math.isfinite, losses[0])) and equal
            and diff <= CNN_GANG_LOSS_ATOL
            and stats_rel <= CNN_GANG_STATS_RTOL):
        fail(f"the CNN gang's losses or running statistics differ across "
             f"ranks, are not finite or are too far from one process's: "
             f"{losses}, {ref['losses']}, statistics equal {equal}, "
             f"relative {stats_rel:.2e}")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 12b took {phase_s:.1f} s (bound {CNN_GANG_PHASE_S})")
    if phase_s > CNN_GANG_PHASE_S:
        fail(f"phase 12b took {phase_s:.1f} s, over {CNN_GANG_PHASE_S}")
    return {"losses": losses[0], "reference": ref["losses"],
            "max_loss_diff": diff, "stats_rel": stats_rel,
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("bn_mean", "bn_var")} for r in ranks],
            "phase_s": phase_s}


def profiled_window(torch, flash, workdir: Path) -> dict:
    """Phase 13 (a): a ProfileSchedule(start=1, count=2) around 4 steps
    of phase 7's trainer (bench.py's LM cell, the port's ``lm_task`` and
    ``Trainer``), each step under ``step_marker``; the launch counters
    zeroed as the window opens and read as it closes; the trace
    summarized by tools/xplane_summary.py (its table printed), whose
    events of flash_fwd, flash_dq and flash_dkv must equal the counters,
    24 each (12 layers x 2 steps)."""
    import numpy as np

    from kubeflow_tpu_torch.models.transformer import (
        TransformerConfig,
        lm_task,
    )
    from kubeflow_tpu_torch.runtime import optim, profiling
    from kubeflow_tpu_torch.runtime.train import Trainer
    from kubeflow_tpu_torch.tools import xplane_summary

    cfg = TransformerConfig(**dict(MODEL, max_seq_len=TRAIN_SEQ, remat=True,
                                   attention="flash", dtype=torch.bfloat16))
    init_fn, loss_fn = lm_task(cfg, device="cuda")
    trainer = Trainer(init_fn=init_fn, loss_fn=loss_fn,
                      tx=optim.adamw(1e-3), device="cuda")
    state = trainer.create_state(SEED)
    step = trainer.compile_step()
    batch = trainer.shard_batch({"tokens": np.random.RandomState(
        SEED).randint(0, MODEL["vocab_size"], size=(
            TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)})
    logdir = workdir / "profile"
    sched = profiling.ProfileSchedule(str(logdir), start=PROFILE_START,
                                      count=PROFILE_COUNT)
    counts, wall = None, 0.0
    for i in range(PROFILE_STEPS):
        sched.before_step(i)
        if i == PROFILE_START:
            for key in flash.launch_counts:
                flash.launch_counts[key] = 0
            t0 = time.perf_counter()
        with profiling.step_marker(i):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        if i == PROFILE_START + PROFILE_COUNT - 1:
            wall = time.perf_counter() - t0
            counts = dict(flash.launch_counts)
        sched.after_step(i)
    sched.close()
    del trainer, state, step, batch
    torch.cuda.empty_cache()
    traces = sorted(logdir.rglob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"ProfileSchedule wrote {len(traces)} traces: {traces}")
    log(f"xplane_summary of the profiled window ({PROFILE_COUNT} steps, "
        f"per step):")
    planes = xplane_summary.summarize_xplane(traces[0], top_n=12,
                                             steps=PROFILE_COUNT)
    (plane,) = [p for p in planes if p.name.startswith("GPU")]
    want = MODEL["n_layers"] * PROFILE_COUNT
    events = {k: plane.events(k + "_kernel") for k in TRAIN_KERNELS}
    log(f"profiled window: trace events {events}, launch counters "
        f"{ {k: counts[k] for k in TRAIN_KERNELS} } (want {want} each)")
    if any(events[k] != counts[k] or counts[k] != want
           for k in TRAIN_KERNELS):
        fail(f"the trace summary's kernel events {events} are not the "
             f"launch counters {counts} ({want} each)")
    steps = sorted(n for n in plane.containers if n.startswith("train_step"))
    if steps != [f"train_step {i}" for i in range(
            PROFILE_START, PROFILE_START + PROFILE_COUNT)]:
        fail(f"the profiled window holds the steps {steps}")
    return {"counts": counts, "events": events, "busy_ms": plane.busy_ms,
            "wall_ms": wall * 1e3, "busy_share": plane.busy_ms
            / (wall * 1e3), "overlapped_ms": sum(plane.overlap.values()),
            "trace_bytes": traces[0].stat().st_size}


def tools_phase(torch, flash, workdir: Path, breakdown: dict):
    """Phase 13: the worker runtime and tooling.  (a) ``profiled_window``;
    (b) side by side as processes: tools/launcher.py running
    ``python -m kubeflow_tpu_torch.tools.train_lm`` on bench.py's LM cell
    for 3 steps with KFT_SLICE_TYPE=h100-1 (exit 0, 3 finite losses, and
    each logged MFU over topology.py's 989 TFLOP/s, this smoke's
    PEAK_BF16_FLOPS), tools/train_torch.py on the card (its loss falls)
    and ``tools/telemetry.py --once`` (exit 0, the report logged); (c)
    ``MeshSpec.build(topology=)`` builds a one-rank mesh for h100-1 and
    raises ValueError for h100-8.  The phase within TOOLS_PHASE_S."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.parallel.mesh import MeshSpec
    from kubeflow_tpu_torch.runtime import topology

    t_phase = time.perf_counter()
    if topology.PEAK_BF16_FLOPS["H100"] != PEAK_BF16_FLOPS:
        fail(f"topology.py's H100 peak {topology.PEAK_BF16_FLOPS} is not "
             f"this smoke's {PEAK_BF16_FLOPS}")
    info = {"profile": profiled_window(torch, flash, workdir)}
    repo = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFT_")}
    env.update(PYTHONPATH=str(repo), PYTHONUNBUFFERED="1",
               KFT_SLICE_TYPE=TOOLS_SLICE, KFT_PROCESS_ID="0")
    metrics = workdir / "launched_metrics.json"
    commands = {
        "launcher": [sys.executable, "-m", "kubeflow_tpu_torch.tools.launcher",
                     "--", sys.executable, "-m",
                     "kubeflow_tpu_torch.tools.train_lm", *TRAIN_FLAGS,
                     "--steps", str(TOOLS_TRAIN_STEPS), "--log-every", "1",
                     "--max-restarts", "0", "--metrics-out", str(metrics)],
        "train_torch": [sys.executable, "-m",
                        "kubeflow_tpu_torch.tools.train_torch", "--steps",
                        str(TORCH_WORKER_STEPS)],
        "telemetry": [sys.executable, "-m",
                      "kubeflow_tpu_torch.tools.telemetry", "--usage-id",
                      "chip-smoke", "--once"]}
    procs, errs = {}, {}
    t0 = time.perf_counter()
    try:
        for name, argv in commands.items():
            errs[name] = workdir / f"tools-{name}.err"
            with open(errs[name], "w") as f:
                procs[name] = subprocess.Popen(
                    argv, cwd=str(repo), env=env, stdin=subprocess.DEVNULL,
                    stdout=subprocess.DEVNULL, stderr=f)
        codes = {}
        for name, proc in procs.items():
            try:
                codes[name] = proc.wait(max(1.0, TOOLS_TIMEOUT_S - (
                    time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                codes[name] = None
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t_procs = time.perf_counter() - t0
    bad = {k: c for k, c in codes.items() if c != 0}
    if bad:
        fail(f"phase 13 tools exited {bad}: " + "".join(
            errs[k].read_text()[-1500:] for k in bad))
    history = json.loads(metrics.read_text())["history"]
    cfg = TransformerConfig(**{k: v for k, v in MODEL.items()
                               if k != "dtype"})
    flops = 3 * cfg.flops_per_token() * TRAIN_SEQ * TRAIN_BATCH
    peaks = [flops / (r["step_time_s"] * r["mfu"]) if r.get("mfu")
             else float("inf") for r in history]
    # mfu is logged at 4 decimals: the peak it implies is that close.
    slack = [0.5e-4 / r["mfu"] + 1e-5 if r.get("mfu") else 0.0
             for r in history]
    if len(history) != TOOLS_TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) for r in history) or any(
            abs(p / PEAK_BF16_FLOPS - 1) > e for p, e in zip(peaks, slack)):
        fail(f"the launched train_lm logged {history}: the peaks its MFU "
             f"implies {peaks} are not {PEAK_BF16_FLOPS:.4g}")
    worker = errs["train_torch"].read_text()
    losses = [float(x) for x in re.findall(r"step \d+ loss ([0-9.]+)",
                                           worker)]
    if len(losses) < 2 or not losses[-1] < losses[0]:
        fail(f"train_torch's loss did not fall on the card: {losses}")
    report = errs["telemetry"].read_text()
    if "usage report" not in report or '"torch_version"' not in report:
        fail(f"telemetry --once reported nothing: {report[-500:]}")
    info["launched"] = {"losses": [r["loss"] for r in history],
                        "mfu": [r["mfu"] for r in history],
                        "implied_peak": peaks, "step_s": [
                            r["step_time_s"] for r in history]}
    info["train_torch_losses"] = losses
    info["processes_s"] = t_procs
    created = not dist.is_initialized()
    try:
        mesh = MeshSpec(data=1).build(
            "cuda", topology=topology.get_topology(TOOLS_SLICE))
        if mesh.size() != 1:
            fail(f"MeshSpec.build(topology={TOOLS_SLICE}) built {mesh}")
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    try:
        MeshSpec(data=-1).build("cuda",
                                topology=topology.get_topology("h100-8"))
        fail("MeshSpec.build(topology=h100-8) built on one GPU")
    except ValueError as exc:
        info["mismatch"] = str(exc)
    prof = info["profile"]
    phase_s = time.perf_counter() - t_phase
    info["phase_s"] = phase_s
    nine = breakdown.get("busy_ms", 0.0) / breakdown["step_ms"] \
        if breakdown.get("busy_ms") else None
    log(f"tools: launcher -> train_lm ({TOOLS_TRAIN_STEPS} steps, "
        f"KFT_SLICE_TYPE={TOOLS_SLICE}) losses "
        f"{[round(x, 4) for x in info['launched']['losses']]}, MFU "
        f"{info['launched']['mfu']} over {PEAK_BF16_FLOPS:.4g} FLOP/s; "
        f"train_torch losses {losses}; telemetry --once exit 0; the three "
        f"processes {t_procs:.1f} s side by side; MeshSpec.build(topology="
        f"{TOOLS_SLICE}) built, h100-8 raised: {info['mismatch']}")
    log(f"profiled window of phase 7's trainer: device busy "
        f"{prof['busy_ms']:.2f} ms over {prof['wall_ms']:.2f} ms of "
        f"{PROFILE_COUNT} steps (share {prof['busy_share']:.3f}; phase 9's "
        f"one profiled step of the same cell "
        + (f"{nine:.3f}" if nine is not None else "not measured")
        + f"), overlapped copies {prof['overlapped_ms']:.3f} ms, trace "
        f"{prof['trace_bytes']} bytes (information only; {card_line()})")
    log(f"phase 13 took {phase_s:.1f} s (bound {TOOLS_PHASE_S})")
    if phase_s > TOOLS_PHASE_S:
        fail(f"phase 13 took {phase_s:.1f} s, over {TOOLS_PHASE_S}")
    return prof["counts"], info


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs on an "
             "NVIDIA GPU")
    repo = Path(__file__).resolve().parent
    if not (repo / "kubeflow_tpu_torch").is_dir():
        fail(f"no kubeflow_tpu_torch package beside {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, str(repo))
    from kubeflow_tpu_torch.ops import _build, flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phase_s = {}
    t_phase = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 3)
        t_phase[0] = now

    t0 = time.perf_counter()
    sources = ("flash_fwd", "flash_bwd")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))  # one nvcc each, together
    log(f"built CUDA kernels {sources} in {time.perf_counter() - t0:.2f} s")
    for src in sources:
        for line in _build.build_logs.get(src, "").splitlines():
            if "Compiling entry" in line:
                log(f"  ptxas {src}: {line.split(chr(39))[1][:90]}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")
    phase_done("1 card and build")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = check_kernels(torch, flash, gen)
    bwd_checks = check_bwd_kernels(torch, flash, gen, checks)
    check_bwd_heads_apart(torch, flash)
    check_autograd(torch, flash, gen)
    two_pass_checks = check_two_pass_kernels(torch, flash, gen)
    phase_done("2 kernels")
    timed = time_kernels(torch, flash, gen, checks)
    timed.update(time_train_kernels(torch, flash, gen, timed, bwd_checks))
    two_pass_rows, two_pass_times = time_two_pass(torch, flash, gen,
                                                  two_pass_checks)
    phase_done("3 timing")

    rng = torch.Generator().manual_seed(SEED)
    vocab = MODEL["vocab_size"]
    prompts = [torch.randint(1, vocab, (n,), generator=rng).tolist()
               for n in PROMPT_LENS]
    direct = [torch.randint(1, vocab, (DIRECT_LEN,), generator=rng).tolist()
              for _ in range(DIRECT_ROWS)]
    workdir = Path(tempfile.mkdtemp(prefix="kft-chip-smoke-"))
    try:
        base = workdir / "lm"
        export_model(torch, base)
        replies, direct_reply, counts = serve(
            torch, flash, base, prompts, direct)
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            fail(f"kernels never launched on the serving path: {missing}")
        phase_done("4 serve")
        check_replies(prompts, replies, direct, direct_reply)
        check_prefill_logits(torch, flash, base, gen)
        phase_done("5 check")
        breakdown(torch, base, gen)
        phase_done("6 breakdown")
        engine_tokens, engine_info = serve_engine(torch, flash, base,
                                                  prompts)
        engine_info["bf16_first_difference"] = engine_identity(
            torch, flash, base, prompts, engine_tokens)
        engine_info["round"] = engine_round(torch, base)
        phase_done("6b engine")
        spec_info = serve_spec(torch, flash, base)
        spec_info["identity"] = spec_identity(torch, flash, base)
        spec_info["verify_call"] = verify_call(torch, base)
        phase_done("6c speculation")
        tier_info = serve_tiers(torch, flash, base)
        tier_info["identity"] = tier_identity(torch, flash, base)
        phase_done("6d tiers")
        int8_base = workdir / "lm_int8"
        export_int8(base, int8_base)
        int8_info = serve_int8(torch, flash, base, int8_base)
        int8_identity(torch, flash, base)
        int8_info.update(int8_numbers(
            torch, flash, base,
            engine_info["round"]["captured"]["round_ms"]))
        phase_done("6e int8")
        spill_info = spill_tier(torch, flash, base, int8_base)
        phase_done("6f spill tier")
        launches_before = dict(flash.launch_counts)
        adir = workdir / "adapters"
        write_adapters(torch, adir)
        adapter_info = serve_adapters(torch, flash, base, adir)
        adapter_info["identity"] = adapter_identity(torch, flash, base,
                                                    adir)
        adapter_info.update(adapter_numbers(
            torch, base, adir, engine_info["round"]["captured"]["round_ms"]))
        launches = {k: flash.launch_counts[k] - launches_before.get(k, 0)
                    for k in flash.launch_counts}
        if any(launches.values()):
            fail(f"the adapter phase launched flash kernels: {launches}")
        adapter_info["flash_launches"] = launches
        log(f"flash launch counters over phase 6g: {launches}")
        phase_done("6g adapters")
        lm_base = workdir / "lm_logits"
        export_lm_logits(base, lm_base, 1)
        lm_predict, lm_tokens, lm_counts, surface_info = lm_logits_direct(
            torch, flash, lm_base)
        surface_info["rest"] = serve_surface(
            torch, flash, base, lm_base, lm_predict, lm_tokens)
        del lm_predict
        surface_info["tracing"] = tracing_cost(torch, base, prompts)
        phase_done("6h serving surface")
        serving_mesh_info = mesh_serving(
            torch, flash, workdir, base, int8_base, adir, prompts,
            lambda: mesh_job(torch, base, engine_info["round"]))
        phase_done("6i mesh")
        train_counts, train_info = train(torch, flash, workdir)
        two_pass_counts, two_pass_info = train_two_pass(torch, flash)
        phase_done("7 train")
        moe_counts, moe_info = train_moe(torch, flash)
        phase_done("7c MoE train")
        dropout_counts, dropout_info = dropout_phase(torch, flash)
        phase_done("7d dropout")
        hfta_counts, hfta_info = train_hfta(torch, flash, train_info)
        phase_done("7e HFTA")
        ring_counts, ring_info = ring_phase(torch, flash, workdir)
        mesh_counts, mesh_info = mesh_phase(torch, flash, train_info,
                                            workdir)
        ring_train_counts, ring_train_info = ring_train_phase(
            torch, flash, train_info, workdir)
        phase_done("7f parallel")
        tensor_counts, tensor_info = tensor_train_phase(
            torch, flash, train_info, workdir)
        phase_done("7g tensor")
        pipe_counts, pipe_info = pipeline_train_phase(
            torch, flash, train_info, workdir)
        phase_done("7h pipeline")
        moe_mesh_counts, moe_mesh_info = moe_mesh_phase(torch, flash,
                                                        workdir)
        phase_done("7i MoE mesh")
        ada_counts, ada_info = adafactor_mesh_phase(torch, flash, workdir)
        phase_done("7j adafactor mesh")
        hfta_mesh_counts, hfta_mesh_info = hfta_mesh_phase(
            torch, flash, hfta_info, workdir)
        phase_done("7k HFTA mesh")
        log(f"train, single pass + adamw against two-pass + adafactor: "
            f"median step {train_info['step_ms']:.1f} / "
            f"{two_pass_info['step_ms']:.1f} ms, MFU "
            f"{train_info['mfu']:.4f} / {two_pass_info['mfu']:.4f}, peak "
            f"memory {train_info['peak_gib']:.2f} / "
            f"{two_pass_info['peak_gib']:.2f} GiB (host clock, one call; "
            f"information only)")
        ckpt_info = checkpoint_and_data(torch, workdir)
        phase_done("10 checkpoints and data")
        grads = check_gradients(torch, flash)
        phase_done("8 gradients")
        learned = learn_and_breakdown(torch)
        phase_done("9 learning")
        cnn_serve_info = serve_cnn(torch, flash, workdir)
        phase_done("11 CNN serve")
        cnn_train_info = train_cnn_phase(torch, flash, workdir)
        phase_done("12 CNN train")
        cnn_train_info["gang"] = cnn_gang_phase(torch, flash, workdir)
        phase_done("12b CNN gang")
        tools_counts, tools_info = tools_phase(torch, flash, workdir,
                                               learned)
        phase_done("13 tools")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = []
    for name, row in timed.items():
        # Each kernel's launches on the path its top-level numbers come
        # from: serving for the forward (its training-shape numbers and
        # launches stand in train_shape), training for dq and dkv.
        on_train = name in ("flash_dq", "flash_dkv")
        row["launches"] = train_counts[name] if on_train else counts[name]
        row["path"] = "train" if on_train else "serve"
        row["launches_by_path"] = {"serve": counts.get(name, 0),
                                   "train": train_counts[name],
                                   "lm": lm_counts[name],
                                   "moe": moe_counts[name],
                                   "dropout": dropout_counts[name],
                                   "hfta": hfta_counts[name],
                                   "ring": ring_counts[name],
                                   "mesh": mesh_counts[name],
                                   "ring_train": ring_train_counts[name],
                                   "tensor": tensor_counts[name],
                                   "pipeline": pipe_counts[name],
                                   "moe_mesh": moe_mesh_counts[name],
                                   "adafactor_mesh": ada_counts[name],
                                   "hfta_mesh": hfta_mesh_counts[name],
                                   "tools": tools_counts[name]}
        kernels.append(row)
    timed["flash_fwd"]["train_shape"]["launches"] = train_counts["flash_fwd"]
    for name, row in two_pass_rows.items():
        # Their launches are the two-pass training phase's.
        row["launches"] = two_pass_counts[name]
        row["path"] = "train"
        row["launches_by_path"] = {"serve": counts.get(name, 0),
                                   "train": two_pass_counts[name],
                                   "lm": lm_counts[name],
                                   "moe": moe_counts[name],
                                   "dropout": dropout_counts[name],
                                   "hfta": hfta_counts[name],
                                   "ring": ring_counts[name],
                                   "mesh": mesh_counts[name],
                                   "ring_train": ring_train_counts[name],
                                   "tensor": tensor_counts[name],
                                   "pipeline": pipe_counts[name],
                                   "moe_mesh": moe_mesh_counts[name],
                                   "adafactor_mesh": ada_counts[name],
                                   "hfta_mesh": hfta_mesh_counts[name],
                                   "tools": tools_counts[name]}
        kernels.append(row)
    log(json.dumps({"engine": engine_info,
                    "speculation": spec_info, "tiers": tier_info,
                    "int8": int8_info, "spill": spill_info,
                    "adapters": adapter_info,
                    "serving_surface": surface_info,
                    "serving_mesh": serving_mesh_info,
                    "train": dict(train_info, gradients=grads,
                                  breakdown=learned),
                    "train_two_pass": dict(two_pass_info,
                                           forward=two_pass_times),
                    "train_moe": moe_info, "dropout": dropout_info,
                    "hfta": hfta_info,
                    "parallel": {"ring": ring_info, "mesh": mesh_info,
                                 "ring_train": ring_train_info,
                                 "tensor": tensor_info,
                                 "pipeline": pipe_info,
                                 "moe_mesh": moe_mesh_info,
                                 "adafactor_mesh": ada_info,
                                 "hfta_mesh": hfta_mesh_info},
                    "checkpoint": ckpt_info,
                    "cnn_serve": cnn_serve_info,
                    "cnn_train": cnn_train_info,
                    "tools": tools_info}))
    log(f"phase times (s): {json.dumps(phase_s)}; total "
        f"{sum(phase_s.values()):.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
