#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab-tiers N   # only: phase 4e's traffic, tiers off/retain/on, N rounds

Phases, in order (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from csrc/ (one nvcc each, in
   parallel; the float32 flash forward's, about a minute where the others
   take seconds, runs on beside kernel 1's checks of phases 3 and 3d and
   the bf16 batch engine's phases 4 to 4d, and the flash checks of phases
   2, 3, 3b and 3c run after those), and read each flash kernel's
   registers and spills (ptxas) and HGMMA count (cuobjdump) at every
   head_dim it is built for: the tensor-core (wgmma) variants (forward,
   dQ, dK/dV; built 64 and 128 wide, and padded at each for the head_dims
   between; the forward also 256 wide; and the wide kernel of each, which
   takes every other head_dim past 128 in 64-column slabs) must show HGMMA
   and no spill, the FMA variants (built the same way, with their wide
   kernels) no HGMMA; and kernel 1's
   registers and spills in each of its twenty-four builds (float32 and
   bf16 queries, three pool formats, 64, 128 and 256 wide, and the
   256-wide slabbed build for head_dims past 256), none of which may
   spill;
3. hold each kernel against its plain PyTorch version on the card at the
   serving slice's shapes (the paged kernel in each pool format: bf16/f32,
   int8 and int4 codes with float32 scale pools, and the int4 unpack on
   every byte value; under the profiler, one call of the paged kernel must
   be one device kernel, its splits merged inside the launch, in every
   format at 1 and 8 splits, and an empty kernel of the same launch shape
   is timed as its latency floor; the flash forward in both variants, bf16 on the
   tensor cores and float32 on the FMA kernel, over s 128, 200 (ragged),
   512 and 1024, window none and 100, causal and non-causal, kv group 4
   and 1, each case checking which variant launched), and time the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (the forward at s 128, greedy_generate's prefill,
   and s 1024, the training shape);
3b. hold the flash-backward kernels (dQ and dK/dV, each in both
   variants) against the plain backward over the same matrix at batch 2,
   each case checking which variants launched; at the training shape (b8
   h16 hk4 s1024 d64, causal; bf16 and float32) hold them once more, then
   time them, the plain backward, and SDPA's backward (by profiler device
   time, with the kernels timed the same way beside it);
3c. kernel 1 at head_dim 4, 20, 100, 192, 256 and 384 and page sizes 12,
   24 and 256, at kv groups 8, 48 and 71 (each head_dim and each page
   meeting each group), in every pool format, with float32 and bf16
   queries, 1 and the tuned splits, window none and 100; kernels 2-4 at
   the same head_dims in both variants, s 128 and 200, causal, window 100
   and non-causal, at a kv group of 8; each against its plain version,
   each call checking the launch it counted; kernel 1 at page 1 over rows
   of LONG_SPAN positions (the split's table staged beside the ring: 1
   split, and 8 with window 1000), every format; then kernels 1-4 timed at
   head_dim 128 and at Gemma-2B's attention shape (head_dim 256, 8 heads
   on 1 kv head: ``head_dim_128`` and ``gemma_d256`` in the kernel line),
   and kernel 1 at Falcon-7B's (head_dim 64, group 71, page 12:
   ``group71_page12``);
3d. kernel 1 on pages that came back from the host: a serving engine at
   the deployed widths (2 layers, bf16 pools and int8 pools with their
   scale pools) reads 255 pages through its KV-tier row reads and restores
   them into 255 others; every pool's rows must come back bit for bit, in
   place, and the kernel on the restored pages must equal the kernel on
   the source pages bit for bit and its plain version within tolerance;
4. run the batch serving engine at the deployed model's full width (vocab
   32000, hidden 1024, 8 layers, 16 heads / 4 kv heads, page 16, 512 pages,
   32 pages per sequence, 8 slots; 32 requests, prompt 128, 128 new
   tokens, greedy), decode block 1, synchronous and eager (``--overlap-steps
   0 --cuda-graphs 0``; phases 4, 4b and 4d run the batch engine with
   ``--overload=0 --slo=0``, without the overload limiter and the SLO plane
   that its CLI turns on by default), with the launch counters set to 0 just before and
   read just after: the paged-decode kernel must have launched (float
   pools) once per layer on every dispatched step;
4b. the same engine run with ``--quant=w8 --quant-kv``, then with
   ``--quant=w8a8 --quant-kv``, on the first 16 requests: each must return
   16 x 128 in-vocab tokens and must have launched the paged kernel's int8
   branch on every decode step (the deployed pod's plain ``--quant=w8``
   runs as the pod itself, at its 32 requests, in 16e);
4d. the same engine at ``--decode-block 16 --overlap-steps 1`` with its
   dispatches replayed as CUDA graphs: the greedy tokens must equal phase
   4's exactly, the paged kernel counted once per layer on every
   dispatched step (a replay counts what its capture launched), with
   overlapped rounds discarded at the finishes and graphs replayed; sampled
   (temperature 0.8, top-k 50) the run must repeat itself under one rng
   with graphs on and off; then ``decode_profile.profile_decode``'s step
   wall against device time per token at block 1 (synchronous and eager,
   and overlapped with graphs) and at block 16;
4e. the port's HTTP server (``models/http_server.py``) as a subprocess at
   the deployment's flags, nothing cut (hidden 1024, 8 layers, 16/4 heads,
   page 16, 512 pages, 8 slots, block 16, optimistic admission, prefill
   chunk 256, the KV tiers with a 512 MiB host arena, overload, SLO,
   watchdog, snapshots every 60 s into a directory under build/), an
   ephemeral port and vocab 32000: after a warm-up, phase 4d's traffic from 32
   client threads (24 unary, 8 SSE); the greedy tokens must equal an
   in-process engine built from the same flags; 8 sampled requests (0.8,
   top-k 50, n=2, logprobs) must return finite logprobs <= 0; the debug
   routes are read, ``/metrics`` must pass ``tools/metrics_lint.py``, the
   paged launches must equal layers x dispatched steps by the server's
   own counters, and SIGTERM must drain it to exit 0.  Then again at 96
   pages, where optimistic admission must preempt (the first 8 requests,
   admitted at the full limit, need at least 100 of its 95 allocatable
   pages by their last token) and the KV tiers must restore at least one
   resume: every request ends
   with 128 tokens, equal to the 512-page run's where never preempted and
   up to the first preemption where preempted (the first difference after
   it is reported); and GPTConfig.tiny() in float32 in process, where
   preempted streams must be identical in full;
4f. warm restart: a server on the same flags serves the 16 shared-prefix
   requests, SIGTERM drains it and the drain saves the snapshot; a second
   server on the same snapshot directory must load more than 0 entries
   and return the first's greedy tokens for the same requests (snapshot
   bytes, save and load seconds, prefill positions, host hits and TTFT,
   cold against warm, are reported);
4g. split roles: a ``--role=prefill`` and a ``--role=decode`` server on the
   one card; eight 256-token prompts go one at a time to the decode server
   with ``X-Handoff-Source`` naming the prefill server (this script plays
   the router), and must return the greedy tokens phase 4f's warm (unified)
   server returned for them, with prefill skipped on the decode server
   (TTFT and ITL beside the unified server's, the bytes handed off);
4h. speculation: the HTTP server at the pod manifest's flags with its
   latency variant ``--slots 2 --spec-gamma 2``, 8 requests (prompt 128,
   half sharing a 64-token prefix; 128 new), whose greedy tokens must equal
   its in-process twin's on the same flags, seed and order; the twin's
   draft steps launch the paged kernel exactly 8 layers x gamma x rounds
   (none in the verify pass, whose ``kernel.fallback`` flight event names
   ``spec_verify``) and its rounds replay CUDA graphs (the batch engine's
   speculation sweep, graphs against eager and the round costs were cut
   to make room for phase 18; tests/test_torch_spec.py holds them against
   the JAX engine);
4i. multi-LoRA: the HTTP server at phase 4e's flags plus ``--adapters`` over
   four rank-8 adapter directories (the port's CheckpointManager, seeded,
   ``lora_b`` not zero), phase 4e's 32 requests with ``adapter`` cycling
   none, 0, 1, 2, 3: tokens equal to an in-process engine on the same
   stacked tree and, by the margin rule, to a single-model engine on each
   adapter's ``merge_lora_params``; one prompt under two adapters shares no
   page; an adapter out of range answers 422; paged launches = layers x
   steps;
4c. ``decode_profile.sweep_formats``, the kernel benchmark (the reference
   reaches int4 pools only from its kernel benchmark): each pool format
   at the decode shape, launches counted by format;
5. run greedy_generate at full width (batch 8, prompt 128, 32 new tokens)
   the same way: the flash-forward kernel must have launched, as its
   tensor-core variant only;
5b. ``speculative_generate`` (batch 1, prompt 128, 128 new, gamma 2, the
   w8 self-draft) against ``greedy_generate``: equal tokens by the margin
   rule, the flash kernel launched once per layer of the target and of
   the draft, as its tensor-core variant only;
6. at 2 layers in float32, the engine's greedy tokens on the kernel path
   must equal those on the gathered-page path wherever the reference's
   top-2 logit margin clears the tolerance, at full width and page 16 and
   at GPTConfig.tiny() (head_dim 16) and page 4;
6b. the same with ``quant="w8"`` and ``quant_kv`` (int8 pools: the kernel
   scales scores and probabilities, the gather path dequantizes first);
7. train the decoder LM through ``models/benchmark.py`` at the reference's
   single-chip configuration (vocab 32000, hidden 1024, 8 layers, 16 heads
   / 4 kv heads, intermediate 2816, bf16 compute, float32 parameters,
   batch 8, seq 1024; 2 warmup and 5 timed steps on one synthetic batch),
   with the launch counters set to 0 just before and read just after: the
   forward, dQ and dK/dV kernels must each have launched 8 layers x the
   steps run, all three as their tensor-core variants only, and every
   step's loss must be finite; then profile one more step under
   ``torch.profiler``;
8. at 2 layers in float32 (full width, batch 2, seq 256, TF32 off), one
   train step on the card (the kernels, the forward, dQ and dK/dV as their
   FMA variants only) and the same step on the CPU (the plain versions) from
   the same weights: losses within 1e-5 relative and every updated
   parameter within 1e-5.
9a. train the four image and encoder models through ``models/benchmark.py``
   at their published widths, bf16 compute and float32 parameters, 2
   warmup and 5 timed steps each, with the launch counters set to 0 just
   before and read just after each run: ResNet-50 (conv7, 224 px, batch
   128: bench.py's headline), AlexNet (224 px, batch 256:
   deploy/k8s-pod-example-tpu.yaml), ViT-B/16 (256 px, 256 tokens, batch
   64: the ViT pod's 256 over 4 chips) and BERT-base (seq 384, batch 32:
   the BERT pod's 64 over dp 2).  ViT and BERT must launch the forward, dQ
   and dK/dV kernels exactly 12 layers x the steps run, non-causal, as
   their tensor-core variants only; ResNet-50 and AlexNet none of kernels
   1-4; every loss must be finite.  Each prints images/s or tokens/s, step
   ms and the busy share of one profiled step, ResNet-50 its MFU (bench.py's
   3 x 8.2e9 flops an image over ``utils/platform.peak_bf16_flops``).  Then
   one run with ``--stem=space_to_depth``, and its logits (float32) held
   against conv7's with the stem kernel mapped;
9b. one float32 train step of each, cut (ResNet18Thin at 64 px, AlexNet at
   width 0.125 on 224 px, ViT 2 layers at 128 px and patch 8 = 256 tokens,
   BERT 2 layers at seq 128), on the card (TF32 off; ViT and BERT on the FMA
   kernels only) and on the CPU from the same weights, batch and dropout
   keys: the loss, every parameter and every BatchNorm statistic within
   TOL_TRAIN (ViT, BERT) or TOL_TRAIN_CONV (ResNet, AlexNet);
9c. resume on the card: ResNet18Thin through ``benchmark.launch`` as the
   CLI runs it (an NCCL group of one, FSDP: the sharded save and restore)
   with ``--checkpoint-every 2 --steps 4``, then ``--resume --steps 4``
   (nothing trained: its restored state, gathered, and an unsharded
   restore of the files equal bit for bit to the state that was saved),
   then ``--resume --steps 6`` (``resumed_from`` 4, ``final_step`` 6) held
   against an uninterrupted run to 6: losses of steps 5 and 6 within
   TOL_DIST_BF16 relative, the final state within TOL_DIST_BF16;
9d. kernels 2-4 non-causal at the ViT shape (b64 h12 s256 d64) and the BERT
   shape (b32 h12 s384 d64), held against their plain versions and timed
   beside SDPA's forward and backward;
10a. ``benchmark.py --model serving`` at the reference's defaults (full-width
   ``gpt_config``: vocab 32000, hidden 1024, 8 layers, 16/4 heads,
   intermediate 2816, bf16; 4 slots, 16 requests, prompt 64, 128 new, the
   kernels phase on), the launch counters set to 0 just before: the paged
   kernel must launch once per layer on every step both engines dispatched
   (the main one and the disagg phase's decode role), beside the kernels
   phase's own launches; the overlapped greedy streams must equal the
   synchronous ones, tracing on equal tracing off; each kernels-phase shape
   must hold the kernel arm and its one-split arm against the gather arm
   (TOL_F32 for float32 queries, TOL_BF16 for bf16 ones over bf16, int8 and
   int4 pools); the disagg tokens must match; restart and elastic must
   restore entries; the record's keys must be the reference's, null exactly
   for ``tp``; the router-side blocks come from tiny replicas (GPTConfig.tiny(),
   float32, page 4) on the card behind the port's router: affinity's KV
   hits a request must exceed random's, no pass may drop a stream, the
   canary must detect its injected corruption and fence, the postmortem
   bundle must be found and classified ``watchdog_hang``, ``autoscale``
   must equal the block computed again on the host, and the tiny
   replicas' kernel 1 launches must equal their 2 layers x their device
   steps (beside the engines'); then kernel 1 is held against its
   plain version at the engines' own geometry (4 rows, 12 pages a row, the
   tuned splits, lens 65..192, bf16) within TOL_BF16;
10b. ``benchmark.py --model gpt-decode`` at full width (batch 128, prompt 64,
   128 new), greedy and then sampled (0.8, top-k 50; 32 new): kernel 2 must launch
   as its wgmma variant only, once per layer a generate call; every token in
   the vocabulary; a second generate under the same key must repeat it;
   then kernel 2 is held against its plain version at the bulk prefill's
   shape (b128 h16 hk4 s64 d64, causal, bf16) within TOL_BF16 and TOL_LSE;
10c. LoRA training (rank 8, alpha 16, every dense site) through the LM's
   train step: bf16 at phase 7's configuration under AdamW, 2 warm-up and 5
   timed steps (13 run), kernels 2-4 exactly 8 layers x 13 as their wgmma
   variants, every loss finite, every base parameter bit for bit
   unchanged, every ``lora_b`` moved, optimizer state for the adapters
   alone; then one float32 step at 2 layers on the card (the FMA variants)
   and on the CPU from the same weights: loss and parameters within
   TOL_TRAIN, each adapter's gradient within TOL_BWD_F32 of the CPU's
   relative to its norm;
11a. distributed training at a world of one: ``benchmark.launch`` at
   ``--model bert --batch-size 64 --seq-len 384 --dp 1 --mp 1`` (BERT-base
   at the BERT pod's global batch, bf16, 1 warm-up and 2 timed steps: 6
   run) joins an NCCL group of one, lays out the (1, 1) mesh and shards
   the model with FSDP (``parallel/sharding.shard_train_step``), after the
   unsharded run at the same flags and seed: the losses of every step
   within TOL_DIST_BF16 relative and every parameter within TOL_DIST_BF16
   of the unsharded run's (|a - b| / (1 + |b|), each element), and
   kernels 2-4 launched exactly 12 layers x 6 steps in the sharded run,
   the launch counters set to 0 just before it; each run's step time and
   peak allocated memory are printed.  Then ResNet-50 the same way at
   ``--batch-size 128 --image-size 224`` (the ResNet-50 pod's 512 over 4
   chips): its sharded step makes the channels-last conv kernels
   contiguous, so both step times are printed and the losses and state
   (BatchNorm statistics too) held within TOL_DIST_BF16;
11b. two ranks sharing the card over gloo (spawned by ``benchmark.launch``
   with ``backend="gloo", local_ranks=2``, after phase 18c, beside 18d),
   float32: BERT cut to 2 layers (seq 128, batch 8) at ``--dp 1 --mp 2``
   and ResNet18Thin at 64 px, 10 classes (batch 16) at ``--dp 2 --mp 1``
   (its BatchNorm takes the global batch's moments across the two ranks):
   each step's global loss within TOL_DIST_F32 relative and every final
   parameter and BatchNorm statistic within TOL_DIST_F32 of one rank's
   unsharded run in this process (|a - b| / (1 + |b|)), and at mp 2 each
   rank holding at most 0.6 of the parameter and momentum bytes one rank
   holds.  Their times stage through host memory and are not a speed (the
   AlexNet run and BERT at dp 2 were cut to make room for phase 18;
   tests/test_torch_parallel.py holds those meshes on gloo CPU ranks);
12a. tensor-parallel serving over an NCCL group of one: the batch engine at
   phase 4d's flags and traffic over a ``tp`` mesh of one
   (``models/engine_tp.launch(1)``, graphed) must return 4d's greedy tokens
   bit for bit (an all-reduce over one rank is the identity), launch the
   paged kernel once per layer on every step, and each graph must hold its
   collectives (per step 2 x 8 + 1 all-reduces, one all-gather of the
   logits, one broadcast of the tokens);
12b. two gloo ranks sharing the card (``launch(2, backend="gloo")``), float32,
   eager, at the deployed widths: ``__graft_entry__.py``'s tp bar, greedy
   under preemption churn (optimistic admission, the KV tiers with an 8 MB
   arena, the pool cut to 3 free pages) and sampled (``PRNGKey(42)``, 0.8,
   top-k 8) repeated after a reclaim so it restores through the host arena:
   the streams equal the unsharded float32 engine's on the card (a greedy
   difference is taken only at a step whose top-2 margin there is under
   TOL_TP_MARGIN, and reported), preemptions, restored resumes and overlap
   discards equal and above 0, the lint green on both ranks after the
   traffic, the ranks' pools gathered equal to the unsharded engine's
   within TOL_TP_F32, each rank's kernel 1 launches = layers x its device
   steps; then kernel 1 at the shard geometry (B 8, H 8, Hk 2, D 64, page
   16, bf16) held against its plain version and timed with its bound;
12c. the HTTP server at the deployment's flags plus ``--tp 2`` over gloo on
   the card (its ``main(tp_backend="gloo")``): 8 streamed requests (phase
   4d's prompts, 16 new tokens) whose
   greedy tokens equal an in-process tp=2 engine's built from the same
   flags on 12b's ranks, ``/debug/state``'s ``tp`` block and the
   ``tpu_engine_tp_size`` gauge at 2, SIGTERM draining it (the snapshot
   saved) with no follower left, then a restarted tp=2 server on the same
   snapshot directory loading its entries and answering a request with the
   first server's tokens;
12d. what the reference serves over its mesh, at 12b's float32 widths and
   weights, over an NCCL group of one (graphed) and over two gloo ranks
   sharing the card (eager): ``--quant w8``, ``--quant w8a8 --quant-kv``,
   4 rank-8 adapters (5 requests, one on the base model), ``--slots 2
   --spec-gamma 2`` and a prefill -> decode handoff of a 4-page prompt
   between a prefill-role and a decode-role engine on the group: greedy
   streams equal the unsharded engine's (a difference taken only under
   TOL_TP_MARGIN, as 12b; each scenario's least margin printed), pools
   within TOL_TP_F32 (int8 pools dequantized, one code step allowed), the
   handoff's wire record for record the unsharded one's (layout, keys,
   byte counts; rows within TOL_TP_F32), its prefill skipped on receipt,
   every rank launching kernel 1, the NCCL group replaying graphs;
13. the MoE LM (``parallel/moe.py``): 13a phase 7's LM with every MLP an
   8-expert top-2 MoE at capacity 1.25, aux loss 0.01, bf16, b8 s1024:
   finite losses, step ms and tokens/s, kernels 2-4 launched 8 x steps on
   ``wgmma``, the share of assignments dropped at capacity, and one traced
   step's device time by stage (expert GEMMs, dispatch/combine einsums,
   routing, kernels 2-4, the rest); 13b one float32 step of a cut MoE LM
   (2 layers, seq 256) card vs CPU within TOL_TRAIN; 13c
   ``tensor.shard_train_step_tp`` over an NCCL world of one, mesh (1, 1, 1),
   bit for bit with the unsharded step; 13d the same config over four gloo
   ranks sharing the card at (dp1, ep2, tp2) and (dp2, ep2, tp1), two steps
   each within TOL_DIST_F32 of two unsharded steps on the card (its ranks
   start after 11a and run beside phase 12);
14. sequence-parallel LM training (``parallel/sequence.py``, ``ring.py``,
   ``ulysses.py``): 14a ``shard_train_step_sp`` at (dp 1, sp 1) over an
   NCCL world of one at phase 7's width (b8 s1024, bf16): Ulysses, its
   all-to-alls made over the one rank and counted, bit for bit with the
   unsharded step, kernels 2-4 launched 8 layers x 6 steps as their
   ``wgmma`` variants; the ring (its float32 einsum fold in place of
   kernel 2, no hop at sp 1) within TOL_DIST_BF16, launching none of them;
   each run's step ms, tokens/s and peak allocated memory, timed between
   two unsharded runs, one traced step's device time and busy share, and
   one host-traced step's operators against the unsharded step's; 14b
   phase 8's cut over four gloo
   ranks sharing the card, float32, at (dp 2, sp 2) Ulysses, (dp 1, sp 4)
   ring and (dp 1, sp 2, tp 2) ring: two steps each within TOL_DIST_F32 of
   two unsharded steps on the card, every exchange staged through host
   memory (gloo carries neither all-to-all nor send/recv on CUDA tensors;
   chosen by the group's backend and counted), Ulysses's ranks launching
   kernels 2-4 as their FMA builds (its ranks start beside 13d's);
15. pipeline-parallel LM training (``parallel/pipeline_lm.py``,
   ``pipeline.py``, ``pipeline_1f1b.py``): 15a ``PipelinedLM`` at pp 1 over
   an NCCL world of one at phase 7's width (b8 s1024, bf16, n_micro 4),
   GPipe then 1F1B, 2 warm-up and 4 timed steps each, between two
   unsharded runs from the same weights (moved through ``convert``'s
   pipelined tree and back): every step's loss and the final parameters
   within TOL_DIST_BF16, kernels 2-4 launched exactly 8 layers x 4
   microbatches a step (kernel 2 twice that under 1F1B: its forward unit
   and its recompute) as their ``wgmma`` variants, no transfer, each run's
   step ms, tokens/s and peak allocated memory, 1F1B's peak below
   GPipe's, and one traced step's device time and busy share; 15b phase
   8's full width cut to 4 layers (seq 256, batch 8) at pp 4 over four
   gloo ranks sharing the card, float32, two steps of each schedule
   within TOL_DIST_F32 of two unsharded steps on the card,
   every transfer staged through host memory and counted, each rank
   launching kernels 2-4 as their FMA builds once per layer and active
   unit (its ranks start beside 13d's and 14b's); 15c ``benchmark.launch``
   at ``--model gpt --tiny --pp 2 --pp-schedule 1f1b --n-micro 4`` on two
   gloo ranks sharing the card: one ``gpt-pp`` record with the reference's
   keys.
16. the GPU device plugin (``plugin/``, ``kubelet/``): 16a ``discover("/")``
   through the probe library built from ``csrc/nvidia_probe.c`` against
   nvidia-smi (minor, UUID and PCI address of each card; the minor from
   ``nvidia-smi -q``) and ``torch.cuda.device_count()``, every card
   Healthy, one health sweep timed; 16b the daemon
   (``python -m k8s_device_plugin_tpu_torch.plugin.cli``) over gRPC against
   the script's own Registration server, on a host tree under /tmp that
   links the real dev, proc and sys: registration, ListAndWatch,
   GetPreferredAllocation and Allocate of one card (its node, the shared
   nodes, ``NVIDIA_VISIBLE_DEVICES`` and ``GPU_DEVICE_MINORS``), the
   health override streamed Unhealthy within PLUGIN_FLIP_LIMIT_S and
   Allocate aborting FAILED_PRECONDITION, Healthy again, SIGTERM exit 0
   with the socket gone; 16c the pod: the port's HTTP server at the
   deployment's flags started with exactly the granted env (and
   ``CUDA_VISIBLE_DEVICES``, as the container runtime's view), two
   requests, its chip-health feed on exactly the granted ``/dev/nvidiaN``,
   kernel 1 launched once a layer a step, Allocate to first token timed;
   16e the single-card pods as deployed: the command and args of
   ``deploy/k8s-pod-example-gpu.yaml`` (AlexNet, 30 steps) and of
   ``deploy/k8s-pod-serve-gpt-gpu.yaml`` (the batch engine at ``--quant=w8``,
   32 requests x 128 new tokens), read from the manifests at run time, each
   a subprocess under the env 16c's pod gets: each must exit 0 and print
   one JSON record of its run on the card (AlexNet: one chip, every step
   run, throughput > 0, its final loss recorded, not required finite: at
   the pod's SGD 0.1 it leaves the finite range within the run's 50 steps,
   as the reference's own run does, PERF.md section 7; the engine: 32 x 128
   tokens, which it checks are in the vocabulary, value > 0, kernel 1's
   float-pool branch launched once a layer on every dispatched step and its
   quantized branches never), each run's wall time logged;
   16d the self-test's probe on the card equal to ``matmul_checksum`` for
   three seeds, a ``selftest.probe`` corrupt failpoint quarantining the
   card after ``fail_threshold`` sweeps and the next health sweep reading
   it Unhealthy, a busy card skipped, one probe timed.
17. the router (``router/``) at full width: two port HTTP replicas of the
   deployed model in this process (phase 4e's flags: vocab 32000, hidden
   1024, 8 layers, 16/4 heads, intermediate 3072, bf16, page 16, 512
   pages, 8 slots; the same weights), the port's router as a subprocess
   with ``deploy/k8s-deploy-router-gpu.yaml``'s flags, and the port's
   ``RouterTraffic`` (8 sessions of a 64-token prefix, suffix 1-16, 4-32
   new tokens, 64 requests from 8 threads) under ``--policy=affinity`` and
   then ``--policy=random``, the tiers cleared between: KV-tier hits a
   request, TTFT p50/p99 through the router,
   client tokens/s, no stream dropped, kernel 1 launched exactly 8 layers
   x the replicas' device steps (the counters set to 0 just before each
   pass), every routed greedy stream equal to the in-process engine's on
   the same flags (or parting at a near-tie, by the margin rule); then 16 streams
   through the affinity router with one replica stopped (fenced, which
   cuts its streams, and shut down) mid-decode: none dropped, every one
   complete, at least one failover, each stream's tokens before its cut
   equal to the engine's.
18. Gemma-2B's attention widths through the entry points: the port's HTTP
   server with ``--hidden=2048 --heads=8 --kv-heads=1 --layers=18
   --vocab=256000 --page-size=16`` (intermediate 3 x hidden, as the CLI
   sets it; head_dim 256, a kv group of 8), 8 requests (prompt 128, 64 new,
   greedy, streamed one at a time after the server's warm-up) whose tokens
   must equal the in-process engine's on the same flags, seed and order,
   kernel 1 launched once a layer a dispatched step;
   ``greedy_generate`` at those widths cut to GEMMA_TRAIN_LAYERS layers
   (8 prompts of 128, 16 new), whose bulk prefill launches kernel 2 at
   head_dim 256 once a layer; three bf16 training steps on the same
   weights (batch 4, seq 1024), kernels 2-4 launched once a layer a step
   on ``wgmma``;
   then at 2 layers, float32, at three shapes (A: those widths at page 16;
   B: Falcon-7B's, hidden 4544, 71 heads on 1 kv head, vocab 65024, page
   12; C: StarCoder's, hidden 6144, 48 heads on 1 kv head, vocab 49152,
   page 24): the engine's greedy tokens on the kernel path equal to those
   on the gather path (by the margin rule), and one training step on the
   card within TOL_TRAIN of the CPU step (the ``gemma`` JSON line).

Then it prints one ``kernels`` JSON line (a row per kernel variant, each
with its design, HGMMA count, registers and spill bytes; every number in
it measured in this run, the bounds computed from its inputs), one
``slice`` JSON line, one ``blocks`` JSON line (phase 4d, 3c's worst
errors and the tiny phase 6), one
``quant`` JSON line, one ``train`` JSON line, one ``serve`` JSON line
(phase 4e), one ``warm_restart`` line (phases 4f, 4g and 3d), one
``spec_lora`` line (phases 5b and 4i), one ``train_models`` line
(phase 9), one ``serving_bench``, one ``decode_bench`` and one
``lora_train`` line (phase 10), one ``distributed`` line (phase 11), one
``tensor_parallel`` line (phase 12), one ``moe`` line (phase 13), one
``sp`` line (phase 14), one ``pipeline`` line (phase 15), one ``plugin``
line (phase 16), one ``router`` line (phase 17), one ``gemma`` line
(phase 18), one ``phase_seconds``
line, and last
the line
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time

TOL_BF16 = 2e-2  # bf16 output rounding (one ulp at |x| < 2 is 7.8e-3) plus f32 sum order
TOL_F32 = 2e-5  # f32 sum order over a few hundred terms
TOL_LSE = 1e-3  # f32 log-sum-exp, sum order in 16- vs 128-column online updates
TOL_MARGIN = 1e-3  # fp32 logits: kernel vs gather paths differ by sum order only
# Flash backward, max |kernel - plain| / max |plain| per gradient: bf16
# rounds dS, P and the gradients (one ulp is 2**-8 relative); f32 differs by
# sum order over up to 1024 terms.
TOL_BWD_BF16 = 2e-2
TOL_BWD_F32 = 1e-4
TOL_TRAIN = 1e-5  # fp32 train step, card vs CPU: loss (relative) and params (absolute)
# The conv models' fp32 step, card vs CPU (phase 9b): cuDNN sums each conv's
# k*k*C products in another order than the CPU, and BatchNorm divides by
# the batch's std, so parameters and statistics move more than phase 8's.
TOL_TRAIN_CONV = 1e-4
TOL_S2D = 1e-4  # space_to_depth vs conv7 logits, float32: 147 taps summed against 192
# Phase 11a: FSDP at a world of one against the unsharded step on the same
# card and seed (and 9c's resumed run against the uninterrupted one).  The
# all-gather and reduce-scatter over one rank copy, so the two compute the
# same thing; the bound leaves room for a kernel whose bf16 sums are not
# run-to-run deterministic, or a conv whose contiguous kernel (FSDP shards
# contiguous parameters only) picks another cuDNN algorithm than the
# channels-last one.
TOL_DIST_BF16 = 1e-3
# Phase 11b: two ranks' float32 step against one rank's: each rank sums the
# gradient over its half of the batch and the halves are averaged, another
# order of the same float32 sums, carried through 5 SGD-momentum steps.
TOL_DIST_F32 = 1e-4
RESNET50_TRAIN_FLOPS_PER_IMAGE = 3 * 8.2e9  # bench.py's count: 3 x the 8.2 GFLOP forward
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores (the FMA kernels' type)
DEVICE = "cuda"


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """Mean time per call of ``fn`` by CUDA events, two ways: replaying a
    CUDA graph of ``iters`` calls (device time; the host's launch cost is
    gone) and over a loop of ``iters`` eager calls (what a caller that
    launches from Python pays, host launch cost included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, eager


def bound(bytes_moved: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quantized_pools(quant, kv_format, k, v, dtype) -> dict:
    """Pool keyword arguments for the paged kernel in ``kv_format`` from
    float pools ``k``/``v``: ``dtype`` pools, or int8/int4 codes with
    float32 scale pools."""
    if kv_format == "f":
        return {"pool_k": k.to(dtype), "pool_v": v.to(dtype)}
    quantize = quant.quantize_kv if kv_format == "int8" else quant.quantize_kv4
    (pk, sk), (pv, sv) = quantize(k), quantize(v)
    return {"pool_k": pk, "pool_v": pv, "scale_k": sk, "scale_v": sv}


def hold_paged(torch, pa, q, pools, table, lens, *, window, splits, kv_format) -> float:
    """max |kernel - plain| of one paged call."""
    batch, heads, head_dim = q.shape
    kv_heads = pools["pool_k"].shape[2]
    out = pa.paged_attention(q, page_table=table, lens=lens, window=window, num_splits=splits,
                             **pools)
    ref = pa.paged_attention_reference(
        q.reshape(batch, kv_heads, heads // kv_heads, head_dim), pools["pool_k"],
        pools["pool_v"], table, lens, sm_scale=head_dim ** -0.5, window=window,
        num_splits=splits, scale_k=pools.get("scale_k"), scale_v=pools.get("scale_v"),
        kv_format=kv_format,
    ).reshape(out.shape)
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item()


def check_int4_bytes(torch, pa, quant) -> None:
    """The kernel's nibble unpack on all 256 byte values: with one live
    token, unit scales and float32 the output is V's row unpacked, exactly;
    with every byte value in K and V over the decode shape's pool the
    kernel agrees with the plain version."""
    dev = torch.device(DEVICE)
    every = (torch.arange(256, device=dev) - 128).to(torch.int8)
    pv = torch.zeros((5, 16, 2, 32), dtype=torch.int8, device=dev)
    pv[1:5, 0] = every.reshape(4, 2, 32)  # position 0 of pages 1..4
    ones = torch.ones((5, 16, 2), device=dev)
    out = pa.paged_attention(
        torch.zeros((4, 8, 64), device=dev), torch.zeros_like(pv), pv,
        torch.arange(1, 5, dtype=torch.int32, device=dev)[:, None],
        torch.ones(4, dtype=torch.int32, device=dev), scale_k=ones, scale_v=ones, num_splits=1,
    )
    want = quant.unpack_int4(pv[1:5, 0], torch.float32)[:, :, None].expand(4, 2, 4, 64)
    if not torch.equal(out.reshape(4, 2, 4, 64), want):
        fail("the int4 unpack on the card differs from unpack_int4 on some byte value")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, H, HK, D, PS, MPP, P = 8, 16, 4, 64, 16, 32, 512
    codes = every[torch.randint(0, 256, (2, P, PS, HK, D // 2), generator=gen, device=dev)]
    scales = torch.rand((2, P, PS, HK), generator=gen, device=dev) * 0.2 + 0.01
    pools = {"pool_k": codes[0], "pool_v": codes[1], "scale_k": scales[0], "scale_v": scales[1]}
    q = torch.randn((B, H, D), generator=gen, device=dev)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: B * MPP] + 1)
    lens = torch.tensor([1, 17, 100, 255, 256, 333, 480, 512], dtype=torch.int32, device=dev)
    err = hold_paged(torch, pa, q, pools, table.reshape(B, MPP).to(torch.int32), lens,
                     window=None, splits=8, kv_format="int4")
    log(f"int4 unpack: exact on all 256 bytes; every-byte pools f32 max_abs_err {err:.3e}")
    if not err <= TOL_F32:
        fail(f"paged_attention int4 over every byte value: {err} > {TOL_F32}")


def kernels_per_call(torch, dp, call, what: str) -> list[tuple[str, int]]:
    """(name, launches) of each device kernel that one ``call`` (already
    warm) runs (``decode_profile.profiled_call``)."""
    try:
        top = dp.profiled_call(call, 1)["top"]
    except RuntimeError as err:
        fail(f"{what}: {err}")
    return [(row["kernel"], row["calls"]) for row in top]


def check_paged(torch, pa, quant, tuning, dp):
    """Kernel 1 against its plain version in each pool format, and one
    device kernel per call; returns its kernel-line entries (float, int8,
    int4)."""
    dev = torch.device(DEVICE)
    B, H, HK, D, PS, MPP, P = 8, 16, 4, 64, 16, 32, 512
    gen = torch.Generator(device=dev).manual_seed(0)
    tuned = tuning.pick_num_splits(MPP, tuning.device_generation(dev))
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: B * MPP] + 1)
    table = table.reshape(B, MPP).to(torch.int32)
    ragged = torch.tensor([1, 17, 100, 255, 256, 333, 480, 512], dtype=torch.int32, device=dev)
    worst = dict.fromkeys(pa.FORMATS, 0.0)
    for kv_format in pa.FORMATS:
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((P, PS, HK, D), generator=gen, device=dev) for _ in range(2))
            pools = quantized_pools(quant, kv_format, k, v, dtype)
            for splits in sorted({1, tuned}):
                for window in (None, 100):
                    err = hold_paged(torch, pa, q, pools, table, ragged, window=window,
                                     splits=splits, kv_format=kv_format)
                    log(f"paged {kv_format} {dtype} splits={splits} window={window}: "
                        f"max_abs_err {err:.3e} (tol {tol})")
                    if not err <= tol:
                        fail(f"paged_attention {kv_format} {dtype} splits={splits} "
                             f"window={window}: {err} > {tol}")
                    if dtype == torch.bfloat16:
                        worst[kv_format] = max(worst[kv_format], err)
            # One call is one kernel: the splits merge inside the launch.
            for splits in (1, tuning.MAX_SPLITS):
                ran = kernels_per_call(
                    torch, dp, lambda: pa.paged_attention(q, page_table=table, lens=ragged,
                                                          num_splits=splits, **pools),
                    f"paged {kv_format} {dtype} splits={splits}")
                log(f"paged {kv_format} {dtype} splits={splits}: one call ran {ran}")
                if len(ran) != 1 or ran[0][1] != 1 or "paged_decode_kernel" not in ran[0][0]:
                    fail(f"one paged_attention call ({kv_format}, {dtype}, {splits} splits) "
                         f"ran {ran}, not one paged_decode_kernel")
    check_int4_bytes(torch, pa, quant)
    # Timing at the main path's shapes: bf16 queries, pools as the engine
    # sizes them in each format, the tuned split count, lens spread over
    # the decode phase (prompt 128 plus up to 128 new tokens).  L2 is warm
    # between launches.  The latency floor: an empty kernel launched with
    # the same grid, block and cluster shape, timed the same way.
    floor_ms, _ = time_ms(lambda: pa.launch_empty(B, H, HK, tuned, dev))
    rows = []
    for kv_format in pa.FORMATS:
        inputs = dp.decode_inputs(kv_format)
        q, table_t, lens = inputs["q"], inputs["page_table"], inputs["lens"]
        ms, eager_ms = time_ms(lambda: pa.paged_attention(**inputs, num_splits=tuned))
        plain_ms, _ = time_ms(
            lambda: pa.paged_attention_reference(
                q.reshape(B, HK, H // HK, D), inputs["pool_k"], inputs["pool_v"], table_t, lens,
                sm_scale=D ** -0.5, window=None, num_splits=tuned,
                scale_k=inputs.get("scale_k"), scale_v=inputs.get("scale_v"),
                kv_format=kv_format,
            ),
            iters=20,
        )
        live = lens.long().tolist()
        pages_read = sum(-(-n // PS) for n in live)
        code_bytes = {"f": 2, "int8": 1, "int4": 0.5}[kv_format]  # per K or V element
        scale_bytes = 0 if kv_format == "f" else 4  # per (position, kv head) and pool
        nbytes = (
            2 * B * H * D * 2  # q in, out
            + sum(live) * HK * 2 * (D * code_bytes + scale_bytes)  # live K and V rows
            + pages_read * 4 + B * 4  # table entries and lens
        )
        flops = sum(4 * H * n * D for n in live)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        log(f"paged {kv_format} at the decode shape: {ms * 1e3:.3f} us (bound "
            f"{b_ms * 1e3:.3f} us by {b_by}, empty-launch floor {floor_ms * 1e3:.3f} us, "
            f"plain {plain_ms * 1e3:.1f} us)")
        rows.append({
            "name": "paged_attention" if kv_format == "f" else f"paged_attention_{kv_format}",
            "route": "cuda",
            "source": "k8s_device_plugin_tpu_torch/csrc/paged_attention.cu",
            "replaces": "k8s_device_plugin_tpu/ops/paged_attention.py:197",
            "kv_format": kv_format,
            "launches": None,
            "max_abs_err": worst[kv_format],
            "tolerance": TOL_BF16,
            "ms": ms,
            "eager_ms": eager_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bytes": nbytes,
            "floor_ms": floor_ms,
            "floor_note": "an empty kernel with the same grid, block and cluster shape, "
                          "timed by the same graph replay",
            "library_ms": None,
            "shape": f"B{B} H{H} Hk{HK} D{D} page{PS} mpp{MPP} splits{tuned} "
                     f"lens{live[0]}..{live[-1]} bf16 q, {kv_format} pools",
        })
    return rows


def sass_hgmma(lib) -> dict[str, int]:
    """HGMMA (wgmma) instructions per kernel in a built library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            kernel = line.split("Function : ", 1)[1].strip()
            counts[kernel] = 0
        elif kernel is not None and "HGMMA" in line:
            counts[kernel] += 1
    return counts


# The flash kernels' rows in the kernel line, by (kernel, input type): (row
# name, the kernel's name as it appears in its mangled symbol).  Which
# source and design each runs is ops/flash_attention.py's VARIANTS.
FLASH_ROWS = {
    ("forward", "bfloat16"): ("flash_attention", "flash_fwd_wgmma_kernel"),
    ("forward", "float32"): ("flash_attention_fma", "flash_fwd_kernel"),
    ("dq", "bfloat16"): ("flash_attention_bwd_dq", "flash_bwd_dq_wgmma_kernel"),
    ("dq", "float32"): ("flash_attention_bwd_dq_fma", "flash_bwd_dq_kernel"),
    ("dkv", "bfloat16"): ("flash_attention_bwd_dkv", "flash_bwd_dkv_wgmma_kernel"),
    ("dkv", "float32"): ("flash_attention_bwd_dkv_fma", "flash_bwd_dkv_kernel"),
}


def build_facts(torch, fa, _build) -> dict:
    """Per flash kernel row, keyed as FLASH_ROWS: its name, source, design,
    and per build (``widths``: 64 and 128 wide, and padded at each,
    "pad64" and "pad128", for the head_dims between; 256 wide for the bf16
    forward; "wide", the kernel that takes every other head_dim past 128)
    its registers, spill
    bytes (ptxas) and HGMMA count (cuobjdump); the row's own registers,
    spills and HGMMA are the head_dim 64 build's, the main paths'.  Fails if
    a wgmma build spills or has no HGMMA, or an FMA build has any."""
    facts = {}
    for (kernel, dtype), (name, function) in FLASH_ROWS.items():
        var = fa.variant(kernel, getattr(torch, dtype))
        hgmma = sass_hgmma(_build.library_path(var.source))
        widths = {}
        for sym, regs in _build.ptxas_report(var.source).items():
            # <function><D, PAD> in the mangled name.
            m = re.search(function + r"ILi(\d+)ELb([01])E", sym)
            if m:
                widths[("pad" if m.group(2) == "1" else "") + m.group(1)] = {
                    "registers": regs["registers"],
                    "spill_bytes": regs["spill_stores"] + regs["spill_loads"],
                    "hgmma": hgmma.get(sym, 0),
                }
        wide = function.replace("_kernel", "_wide_kernel")
        for sym, regs in _build.ptxas_report(var.source).items():
            if re.search(wide + r"E", sym):
                widths["wide"] = {
                    "registers": regs["registers"],
                    "spill_bytes": regs["spill_stores"] + regs["spill_loads"],
                    "hgmma": hgmma.get(sym, 0),
                }
        built = {"64", "128", "pad64", "pad128", "wide"}
        if (kernel, dtype) == ("forward", "bfloat16"):
            built.add("256")
        if set(widths) != built:
            fail(f"csrc/{var.source}.cu builds {function} at head_dim {sorted(widths)}, "
                 f"not {sorted(built)}")
        fact = facts[(kernel, dtype)] = {
            "name": name,
            "route": "cuda",
            "source": f"k8s_device_plugin_tpu_torch/csrc/{var.source}.cu",
            "design": var.design,
            **widths["64"],
            "widths": widths,
        }
        log(f"{var.source} {function}: {fact}")
        for width, w in widths.items():
            if var.design == "wgmma" and (w["hgmma"] == 0 or w["spill_bytes"]):
                fail(f"{function} at head_dim {width}: {w['hgmma']} HGMMA, "
                     f"{w['spill_bytes']} spill bytes")
            if var.design == "fma" and w["hgmma"]:
                fail(f"{function} at head_dim {width} is the FMA variant but has "
                     f"{w['hgmma']} HGMMA")
    return facts


PAGED_FORMATS = {"0": "f", "1": "int8", "2": "int4"}


def paged_build_facts(_build) -> dict:
    """Kernel 1's registers and spill bytes (ptxas) per build, keyed by pool
    format, then "<query type>_<width>" (float32 or bf16 queries, 64, 128
    and 256 wide, and the 256-wide slabbed build "_wide": twenty-four
    builds).  Fails if one is missing or spills."""
    facts = {fmt: {} for fmt in PAGED_FORMATS.values()}
    for sym, regs in _build.ptxas_report("paged_attention").items():
        # paged_decode_kernel<T, FMT, D, WIDE> in the mangled name.
        m = re.search(r"paged_decode_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d+)ELb([01])E", sym)
        if m:
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            wide = "_wide" if m.group(4) == "1" else ""
            facts[PAGED_FORMATS[m.group(2)]][f"{dtype}_{m.group(3)}{wide}"] = {
                "registers": regs["registers"],
                "spill_bytes": regs["spill_stores"] + regs["spill_loads"],
            }
    want = {f"{t}_{w}" for t in ("float32", "bfloat16") for w in (64, 128, 256, "256_wide")}
    log(f"paged_attention paged_decode_kernel builds: {facts}")
    for fmt, builds in facts.items():
        if set(builds) != want:
            fail(f"csrc/paged_attention.cu builds the {fmt} kernel as {sorted(builds)}, "
                 f"not {sorted(want)}")
        for name, b in builds.items():
            if b["spill_bytes"]:
                fail(f"paged_decode_kernel {fmt} {name}: {b['spill_bytes']} spill bytes "
                     f"at {b['registers']} registers")
    return facts


def expect_designs(counts: dict, design: str, n: int, what: str) -> None:
    """Fail unless ``counts`` (launches by design) ran ``design`` n times
    and no other."""
    want = {d: (n if d == design else 0) for d in counts}
    if counts != want:
        fail(f"{what} launched {counts}, not {want}")


def check_flash(torch, fa, facts):
    """Kernel 2 against its plain version, both variants (bf16 wgmma, f32
    FMA); returns their kernel-line entries."""
    dev = torch.device(DEVICE)
    B, H, D = 8, 16, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    types = (("bfloat16", TOL_BF16, BF16_FLOPS), ("float32", TOL_F32, FP32_FLOPS))
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for dtype_name, tol, _ in types:
        dtype, design = getattr(torch, dtype_name), facts[("forward", dtype_name)]["design"]
        for s in (128, 200, 512, 1024):  # 200: ragged last q and kv tiles; 1024: training
            for group in (4, 1):
                hk = H // group
                q = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
                k = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                v = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                for causal, window in ((True, None), (True, 100), (False, None)):
                    fa.reset_launches()
                    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
                    expect_designs(fa.flash_attention.launches_by_design, design, 1,
                                   f"flash_forward {dtype}")
                    ref, ref_lse = fa.flash_attention_reference(
                        q, k, v, causal=causal, sm_scale=D ** -0.5, window=window, block_kv=128
                    )
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    lerr = (lse - ref_lse).abs().max().item()
                    label = f"{dtype} s={s} group={group} causal={causal} window={window}"
                    log(f"flash {design} {label}: max_abs_err {err:.3e} (tol {tol}), "
                        f"lse {lerr:.3e}")
                    if not (err <= tol and lerr <= TOL_LSE):
                        fail(f"flash_attention {label}: out {err}, lse {lerr}")
                    worst[dtype_name] = max(worst[dtype_name], err)
    rows = []
    for dtype_name, tol, peak in types:
        dtype = getattr(torch, dtype_name)
        row = {
            **facts[("forward", dtype_name)],
            "replaces": "k8s_device_plugin_tpu/ops/flash_attention.py:218",
            "launches": None,
            "max_abs_err": worst[dtype_name],
            "tolerance": tol,
        }
        # Timing at the main path's shapes: greedy_generate's bulk prefill
        # (s 128, the row's own keys) and the training step (s 1024).
        for s in (128, 1024):
            q = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, 4, s, D), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, 4, s, D), generator=gen, device=dev).to(dtype)
            ms, eager_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                                   iters=50 if s == 128 else 20)
            plain_ms, _ = time_ms(
                lambda: fa.flash_attention_reference(
                    q, k, v, causal=True, sm_scale=D ** -0.5, window=None, block_kv=128
                ),
                iters=20 if s == 128 else 5, warmup=2,
            )
            library_ms, _ = time_ms(sdpa_forward(torch, q, k, v), iters=20)
            pairs = B * H * s * (s + 1) // 2  # causal (row, col) pairs
            size = q.element_size()
            nbytes = (B * H * s * D * size) * 2 + (B * 4 * s * D * size) * 2 + B * H * s * 4
            b_ms, b_by = bound(nbytes, 4 * D * pairs, peak)
            timed = {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms}
            shape = f"b{B} h{H} hk4 s{s} d{D} causal {dtype_name}"
            if s == 128:
                row.update(timed, shape=shape)
            else:
                row.update({f"train_{key}": val for key, val in timed.items()}, train_shape=shape)
            log(f"flash {row['design']} at {shape}: {ms:.4f} ms (bound {b_ms:.4f}, "
                f"SDPA {library_ms:.4f}, plain {plain_ms:.4f})")
        rows.append(row)
    return rows


# Phase 3c's shapes, the ones kernels 1-4 once refused: head_dims that are
# no multiple of 8 (4, 20, 100), past 128 (192, 384) and Gemma-2B's 256;
# page sizes that are no power of two (12, 24) or past 128 (256); kv groups
# of 8 (Gemma-2B), 48 (StarCoder) and 71 (Falcon-7B).
SWEEP_HEAD_DIMS = (4, 20, 100, 192, 256, 384)
SWEEP_PAGES = (12, 24, 256)
SWEEP_GROUPS = (8, 48, 71)
LONG_SPAN = 20000  # a row's positions at page 1: 20,000 table entries at one split


def paged_shape_inputs(torch, gen, *, B, H, HK, D, ps, span, dtype=None):
    """Kernel 1's inputs at one shape: bf16 (or ``dtype``) q [B, H, D], a
    random table over a pool of whole rows of ``span`` positions, float
    pools [pages, ps, HK, D] in float32 (quantized by the caller)."""
    dev = torch.device(DEVICE)
    mpp = -(-span // ps)
    n_pool = B * mpp + 1
    table = torch.randperm(n_pool - 1, generator=gen, device=dev)[: B * mpp] + 1
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype or torch.bfloat16)
    k, v = (torch.randn((n_pool, ps, HK, D), generator=gen, device=dev) for _ in range(2))
    return q, table.reshape(B, mpp).to(torch.int32), k, v


def check_widths(torch, pa, fa, quant, tuning) -> dict:
    """Phase 3c: kernel 1 at SWEEP_HEAD_DIMS x SWEEP_PAGES, each pair at one
    of SWEEP_GROUPS in turn (so each head_dim and each page meets each
    group), in every pool format, float32 and bf16 queries, and kernels
    2-4 at SWEEP_HEAD_DIMS in both variants at a kv group of 8, against
    their plain versions, each call checking the launch it counted.
    Returns the worst errors by kernel."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(9)
    B, SPAN = 4, 256  # SPAN: the positions a row's table covers
    lens = torch.tensor([1, 100, 241, 256], dtype=torch.int32, device=dev)
    worst = {}
    for i, d in enumerate(SWEEP_HEAD_DIMS):
        for j, ps in enumerate(SWEEP_PAGES):
            group = SWEEP_GROUPS[(i + j) % len(SWEEP_GROUPS)]
            for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
                q, table, k, v = paged_shape_inputs(torch, gen, B=B, H=group, HK=1, D=d, ps=ps,
                                                    span=SPAN, dtype=dtype)
                tuned = tuning.pick_num_splits(table.shape[1], tuning.device_generation(dev))
                for kv_format in pa.FORMATS:
                    pools = quantized_pools(quant, kv_format, k, v, dtype)
                    for splits in sorted({1, tuned}):
                        for window in (None, 100):
                            pa.reset_launches()
                            err = hold_paged(torch, pa, q, pools, table, lens, window=window,
                                             splits=splits, kv_format=kv_format)
                            label = (f"paged {kv_format} {dtype} d={d} page={ps} group={group} "
                                     f"splits={splits} window={window}")
                            if pa.paged_attention.launches_by_format[kv_format] != 1:
                                fail(f"{label}: launched {pa.paged_attention.launches_by_format}")
                            if not err <= tol:
                                fail(f"{label}: max_abs_err {err} > {tol}")
                            key = f"paged_{kv_format}_{str(dtype)[6:]}"
                            worst[key] = max(worst.get(key, 0.0), err)
    # A page of one position over a long row: at one split the table's
    # LONG_SPAN entries are staged in shared memory beside the ring.
    q, table, k, v = paged_shape_inputs(torch, gen, B=2, H=4, HK=1, D=64, ps=1, span=LONG_SPAN)
    long_lens = torch.tensor([LONG_SPAN - 7, LONG_SPAN], dtype=torch.int32, device=dev)
    for kv_format in pa.FORMATS:
        pools = quantized_pools(quant, kv_format, k, v, torch.bfloat16)
        for splits, window in ((1, None), (8, 1000)):
            pa.reset_launches()
            err = hold_paged(torch, pa, q, pools, table, long_lens, window=window, splits=splits,
                             kv_format=kv_format)
            label = f"paged {kv_format} page=1 span={LONG_SPAN} splits={splits} window={window}"
            if pa.paged_attention.launches_by_format[kv_format] != 1:
                fail(f"{label}: launched {pa.paged_attention.launches_by_format}")
            if not err <= TOL_BF16:
                fail(f"{label}: max_abs_err {err} > {TOL_BF16}")
            key = f"paged_{kv_format}_long_table"
            worst[key] = max(worst.get(key, 0.0), err)
    log(f"paged kernel at head_dim {SWEEP_HEAD_DIMS} x page {SWEEP_PAGES} x group "
        f"{SWEEP_GROUPS} x {pa.FORMATS}, and page 1 over {LONG_SPAN} positions: worst {worst}")
    B, H, HK = 2, 8, 1
    for d in SWEEP_HEAD_DIMS:
        for dtype_name, tol, tol_bwd in (("bfloat16", TOL_BF16, TOL_BWD_BF16),
                                         ("float32", TOL_F32, TOL_BWD_F32)):
            dtype = getattr(torch, dtype_name)
            design = fa.variant("forward", dtype).design
            for s in (128, 200):
                q, dout = (torch.randn((B, H, s, d), generator=gen, device=dev).to(dtype)
                           for _ in range(2))
                k, v = (torch.randn((B, HK, s, d), generator=gen, device=dev).to(dtype)
                        for _ in range(2))
                for causal, window in ((True, None), (True, 100), (False, None)):
                    label = f"flash {dtype_name} d={d} s={s} causal={causal} window={window}"
                    fa.reset_launches()
                    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
                    got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
                    expect_designs(fa.flash_attention.launches_by_design, design, 1, label)
                    expect_designs(fa.flash_backward.dq_launches_by_design, design, 1, label)
                    expect_designs(fa.flash_backward.dkv_launches_by_design, design, 1, label)
                    opts = dict(causal=causal, sm_scale=d ** -0.5, window=window, block_kv=128)
                    ref, ref_lse = fa.flash_attention_reference(q, k, v, **opts)
                    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, **opts)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    lerr = (lse - ref_lse).abs().max().item()
                    rels = [rel_err(g, w) for g, w in zip(got, want)]
                    if not (err <= tol and lerr <= TOL_LSE and max(rels) <= tol_bwd):
                        fail(f"{label}: out {err}, lse {lerr}, dq/dk/dv rel {rels}")
                    for key, e in ((f"forward_{dtype_name}", err),
                                   (f"backward_rel_{dtype_name}", max(rels))):
                        worst[key] = max(worst.get(key, 0.0), e)
    log(f"kernels 1-4 at every head_dim: worst {worst}")
    return worst


def time_paged(torch, pa, tuning, *, B, H, HK, D, ps, span=256, seed=12) -> dict:
    """Kernel 1 in bf16 at one shape, timed as the decode-shape rows are
    (graph replay, L2 warm), lens spread over the decode phase, beside its
    bound and plain version."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, table, k, v = paged_shape_inputs(torch, gen, B=B, H=H, HK=HK, D=D, ps=ps, span=span)
    pk, pv = k.to(torch.bfloat16), v.to(torch.bfloat16)
    lens = torch.tensor([span // 2 + 1 + (span // 2 - 1) * i // (B - 1) for i in range(B)],
                        dtype=torch.int32, device=DEVICE)
    tuned = tuning.pick_num_splits(table.shape[1], tuning.device_generation(DEVICE))
    call = lambda: pa.paged_attention(q, pk, pv, table, lens, num_splits=tuned)  # noqa: E731
    ms, _ = time_ms(call)
    plain_ms, _ = time_ms(lambda: pa.paged_attention_reference(
        q.reshape(B, HK, H // HK, D), pk, pv, table, lens, sm_scale=D ** -0.5, window=None,
        num_splits=tuned), iters=20)
    live = lens.long().tolist()
    nbytes = (2 * B * H * D * 2 + sum(live) * HK * 2 * D * 2
              + sum(-(-n // ps) for n in live) * 4 + B * 4)
    b_ms, b_by = bound(nbytes, sum(4 * H * n * D for n in live), BF16_FLOPS)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "shape": f"B{B} H{H} Hk{HK} D{D} page{ps} splits{tuned} "
                     f"lens{live[0]}..{live[-1]} bf16"}


def time_head_dim(torch, pa, fa, tuning, D: int, H: int = 16, HK: int = 4) -> dict:
    """Kernels 1-4 at head_dim D, H heads on HK kv heads, in bf16, timed as
    the head_dim 64 rows are (kernel 1 at batch 8 over pages of 16, kernels
    2-4 at b8 s1024 causal), beside their bounds, plain versions and
    library calls; keyed by kernel row name."""
    B = 8
    out = {"paged_attention": time_paged(torch, pa, tuning, B=B, H=H, HK=HK, D=D, ps=16)}
    S = 1024
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    q, dout = (torch.randn((B, H, S, D), generator=gen, device=DEVICE).to(torch.bfloat16)
               for _ in range(2))
    k, v = (torch.randn((B, HK, S, D), generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(2))
    opts = dict(causal=True, sm_scale=D ** -0.5, window=None)
    o, lse = fa.flash_forward(q, k, v, causal=True)
    _, delta = fa.launch_dq(q, k, v, o, lse, dout, **opts)
    pairs = B * H * S * (S + 1) // 2
    row_q, row_kv, vec = B * H * S * D * 2, B * HK * S * D * 2, B * H * S * 4
    plain_bwd, _ = time_ms(lambda: fa.flash_attention_backward_reference(
        q, k, v, o, lse, dout, block_kv=128, **opts), iters=3, warmup=1)
    sdpa_bwd = profiled_ms(torch, sdpa_backward(torch, q, k, v, dout), f"SDPA's backward (d{D})")
    shape = f"b{B} h{H} hk{HK} s{S} d{D} causal bfloat16"
    cases = {
        "flash_attention": (lambda: fa.flash_forward(q, k, v, causal=True),
                            2 * row_q + 2 * row_kv + vec, 4 * D * pairs),
        "flash_attention_bwd_dq": (lambda: fa.launch_dq(q, k, v, o, lse, dout, **opts),
                                   4 * row_q + 2 * vec + 2 * row_kv, 6 * D * pairs),
        "flash_attention_bwd_dkv": (lambda: fa.launch_dkv(q, k, v, lse, delta, dout, **opts),
                                    2 * row_q + 2 * vec + 4 * row_kv, 8 * D * pairs),
    }
    for name, (call, nbytes, flops) in cases.items():
        ms, _ = time_ms(call, iters=20)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        if name == "flash_attention":
            plain_ms, _ = time_ms(lambda: fa.flash_attention_reference(
                q, k, v, block_kv=128, **opts), iters=3, warmup=1)
            library_ms, _ = time_ms(sdpa_forward(torch, q, k, v), iters=20)
        else:
            plain_ms, library_ms = plain_bwd, sdpa_bwd
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms, "shape": shape}
        if name != "flash_attention":
            out[name]["library_note"] = ("SDPA backward (profiler device time), one call "
                                         "yields dq, dk and dv")
    log(f"kernels 1-4 at head_dim {D}, {H}/{HK} heads: {out}")
    return out


# The batch engine's deployed widths (phases 4, 4b, 4d, 12a).
ENGINE_WIDTHS = (
    "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--vocab=32000",
    "--page-size=16", "--num-pages=512", "--max-pages-per-seq=32", "--slots=8",
    "--prompt-len=128", "--max-new=128",
)
BLOCK16_TOKENS: list = []  # phase 4d's greedy streams


def run_engine(torch, engine, pa, fa, flags=(), requests: int = 32):
    """Phases 4 and 4b: the batch engine at full width with the extra
    ``flags`` on ``requests`` of the synthetic stream; returns (summary,
    paged launches by pool format)."""
    args = engine.parse_args([*ENGINE_WIDTHS, f"--requests={requests}", f"--device={DEVICE}",
                              *flags])
    pa.reset_launches()
    fa.reset_launches()
    summary, done = engine.benchmark(args)
    torch.cuda.synchronize()
    launches = dict(pa.paged_attention.launches_by_format)
    log(f"engine {list(flags)}: {summary}; paged launches {launches}, "
        f"flash launches {fa.flash_attention.launches}")
    want, other = ("int8", "f") if "--quant-kv" in flags else ("f", "int8")
    if launches[want] <= 0 or launches[other] or launches["int4"]:
        fail(f"the engine's decode {list(flags)} launched the paged kernel as {launches}, "
             f"not in its {want} branch alone")
    # Once per layer on every single-token step dispatched, eager or
    # replayed in a graph (a replay counts what its capture launched).
    if launches[want] != args.layers * summary["device_steps"]:
        fail(f"the engine {list(flags)} counted {launches[want]} paged launches over "
             f"{summary['device_steps']} dispatched steps of {args.layers} layers")
    if len(done) != requests or any(len(r.tokens) != 128 for r in done):
        fail(f"the engine did not return {requests} requests of 128 tokens")
    if any(not 0 <= t < 32000 for r in done for t in r.tokens):
        fail("the engine emitted a token id outside the vocabulary")
    # The summary's quantiles interpolate histogram buckets; these are exact
    # over the timed requests' own stamps (ITL as each request's mean gap).
    ttft = [r.first_token_at - r.submitted_at for r in done]
    itl = [(r.finished_at - r.first_token_at) / (len(r.tokens) - 1) for r in done]
    summary["ttft_exact_ms"] = {"p50": quantile(ttft, 0.5) * 1e3, "p99": quantile(ttft, 0.99) * 1e3}
    summary["itl_request_mean_ms"] = {"p50": quantile(itl, 0.5) * 1e3, "p99": quantile(itl, 0.99) * 1e3}
    summary["flags"] = list(flags)
    return summary, launches, [r.tokens for r in done]


# Phases 4, 4b and 4d measure the batch engine without the overload
# limiter and the SLO plane (the CLI's defaults since it took the
# reference's flags); 4e's in-process twin takes the server's flags.
NO_LIMITER = ("--overload=0", "--slo=0")
SYNC_EAGER = ("--decode-block=1", "--overlap-steps=0", "--cuda-graphs=0", *NO_LIMITER)
QUANT_REQUESTS = 16  # phase 4b: two waves of 8 slots, so slots free and re-admit
BLOCKS = ("--decode-block=16", "--overlap-steps=1", *NO_LIMITER)  # graphs: the card's default
SAMPLED = ("--temperature=0.8", "--top-k=50")


def first_difference(a, b) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            j = next(j for j, (u, w) in enumerate(zip(x, y)) if u != w)
            return f"request {i} token {j}: {x[j]} vs {y[j]}"
    return "the request counts differ"


# ------------------------------------------------------------- phase 4e

# The GPU deployment's serving flags (deploy/k8s-deploy-serve-http-gpu.yaml),
# nothing cut; vocab is the CLI's default 32000.  ``--snapshot-dir`` and
# ``--http-port`` are what each run sets itself (snapshot_flag, SERVE_EXTRA);
# tests/test_torch_deploy.py holds the rest equal to the manifest's.
SERVE_FLAGS = (
    "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--page-size=16",
    "--num-pages=512", "--max-pages-per-seq=32", "--slots=8", "--decode-block=16",
    "--admission=optimistic", "--prefill-chunk=256", "--kv-retain=1",
    "--kv-host-cache-mb=512", "--overload=1", "--overload-target-wait=0.5",
    "--overload-max-queue=512", "--slo=1", "--watchdog=1", "--watchdog-min-deadline=5",
    "--watchdog-grace=120", "--snapshot-interval=60", "--dump-budget-mb=256",
    "--compilation-cache-dir=/var/cache/xla",
)
# What the serving phases add to them: an ephemeral port, and a flight ring
# big enough that no preemption event of the run is dropped.
SERVE_EXTRA = ("--http-port=0", "--flight-ring=65536")
SERVE_STREAMED = 8  # of the 32 requests; the other 24 are unary


def snapshot_flag(name: str) -> str:
    """``--snapshot-dir`` at an empty directory of the checkout's build/
    (ignored by git) for the run ``name``."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "build" / "snapshots" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return f"--snapshot-dir={path}"


def http_call(port: int, path: str, payload=None, timeout: float = 300.0):
    """(status, parsed JSON or raw bytes) of one request to the server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body, status, ctype = resp.read(), resp.status, resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        body, status, ctype = e.read(), e.code, e.headers.get("Content-Type", "")
    return status, json.loads(body) if "json" in ctype else body


def start_server(flags, log_path, env) -> tuple:
    """Start the port's HTTP server as a subprocess; returns (process,
    port) once /healthz answers 200.  Fails (killing it) if it exits or
    does not come up in 600 s."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch.models.http_server", *flags,
         *SERVE_EXTRA],
        stdout=subprocess.DEVNULL, stderr=open(log_path, "w"), env=env,
    )
    return proc, await_http(proc, log_path, r"serving on :(\d+)", "HTTP server", 600)


def await_http(proc, log_path, pattern: str, what: str, limit_s: float) -> int:
    """The port a subprocess prints (``pattern``'s group 1 in its log) once
    its /healthz answers 200; fails, killing it, if it exits or does not
    come up within ``limit_s``."""
    deadline, port = time.monotonic() + limit_s, None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            fail(f"the {what} exited with {proc.returncode}: {open(log_path).read()[-3000:]}")
        if port is None:
            m = re.search(pattern, open(log_path).read())
            port = int(m.group(1)) if m else None
        if port is not None:
            try:
                if http_call(port, "/healthz", timeout=5)[0] == 200:
                    return port
            except OSError:
                pass
        time.sleep(0.2)
    proc.kill()
    fail(f"the {what} did not come up: {open(log_path).read()[-3000:]}")


def stop_server(proc, log_path) -> float:
    """SIGTERM: the server must drain and exit 0; returns the seconds it
    took."""
    import signal

    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("the HTTP server did not exit within 120 s of SIGTERM")
    if rc != 0:
        fail(f"the HTTP server exited {rc} after SIGTERM: {open(log_path).read()[-3000:]}")
    if "draining" not in open(log_path).read():
        fail("the HTTP server did not drain on SIGTERM")
    return time.perf_counter() - t0


def stream_request(port: int, body: dict, headers=None) -> dict:
    """One SSE /generate: status, tokens, rid and the client's stamps
    (send, each token, done)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    stamps, final = [], None
    try:
        resp = urllib.request.urlopen(req, timeout=600)
    except urllib.error.HTTPError as e:
        return {"status": e.code, "t_send": t0, "t_done": time.perf_counter(), "stamps": [],
                "tokens": None, "rid": None, "body": e.read().decode(errors="replace")}
    with resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            ev = json.loads(line[len("data: "):])
            if "token" in ev:
                stamps.append(time.perf_counter())
            if ev.get("done") or ev.get("error"):
                final = ev
                break
    return {"status": 200 if final and final.get("done") else 500, "t_send": t0,
            "t_done": time.perf_counter(), "stamps": stamps,
            "tokens": (final or {}).get("tokens"), "rid": (final or {}).get("rid"),
            "body": final}


def http_traffic(port: int, jobs, payload_kw=None, streamed: int = SERVE_STREAMED) -> tuple:
    """Send ``jobs`` from one client thread each, at once: the first
    ``streamed`` streamed (SSE), the rest unary.  Returns (results in
    job order, wall seconds); a result holds the status, tokens, rid and
    its client-side stamps (send, first token and each token for a
    stream, the answer for a unary request)."""
    import threading

    results = [None] * len(jobs)

    def one(i, prompt, n, extra=None):
        try:
            send(i, prompt, n, extra)
        except Exception as e:  # noqa: BLE001 - reported below as a failed request
            results[i] = {"status": None, "body": repr(e)}

    def send(i, prompt, n, extra):
        body = {"prompt": prompt, "max_new_tokens": n, **(payload_kw or {}), **(extra or {})}
        t0 = time.perf_counter()
        if i >= streamed:
            status, out = http_call(port, "/generate", body)
            ok = status == 200
            results[i] = {"status": status, "t_send": t0, "t_done": time.perf_counter(),
                          "tokens": out.get("tokens") if ok else None,
                          "rid": out.get("rid") if ok else None, "body": out}
            return
        results[i] = stream_request(port, body)

    threads = [threading.Thread(target=one, args=(i, *job)) for i, job in enumerate(jobs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    bad = [(i, r["status"], r["body"]) for i, r in enumerate(results) if r["status"] != 200]
    if bad:
        fail(f"HTTP requests failed: {bad[:4]}")
    return results, wall


def client_latency(results, wall: float) -> dict:
    """Client-side tokens/s over the run, TTFT (the streams' first token)
    and ITL (the streams' token gaps) quantiles in ms, and the unary
    requests' answer time."""
    streams = [r for r in results if "stamps" in r]
    ttft = [r["stamps"][0] - r["t_send"] for r in streams]
    itl = [b - a for r in streams for a, b in zip(r["stamps"], r["stamps"][1:])]
    unary = [r["t_done"] - r["t_send"] for r in results if "stamps" not in r]
    tokens = sum(len(r["tokens"]) for r in results)
    return {
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms": {"p50": quantile(ttft, 0.5) * 1e3, "p99": quantile(ttft, 0.99) * 1e3},
        "itl_ms": {"p50": quantile(itl, 0.5) * 1e3, "p99": quantile(itl, 0.99) * 1e3},
        "unary_answer_ms": {"p50": quantile(unary, 0.5) * 1e3, "p99": quantile(unary, 0.99) * 1e3}
        if unary else None,
        "streams": len(streams), "unary": len(unary),
    }


def engine_latency(done, wall: float) -> dict:
    """The same numbers for an in-process run, from the requests' own
    stamps (ITL as each request's mean gap: a block lands its tokens at
    once)."""
    tokens = sum(len(r.tokens) for r in done)
    ttft = [r.first_token_at - r.submitted_at for r in done]
    itl = [(r.finished_at - r.first_token_at) / (len(r.tokens) - 1) for r in done]
    # The requests the HTTP run streams, and those it sends unary: the
    # same populations as client_latency's.
    ttft_streamed = ttft[:SERVE_STREAMED]
    answer = [r.finished_at - r.submitted_at for r in done[SERVE_STREAMED:]]
    return {
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms": {"p50": quantile(ttft, 0.5) * 1e3, "p99": quantile(ttft, 0.99) * 1e3},
        "itl_ms": {"p50": quantile(itl, 0.5) * 1e3, "p99": quantile(itl, 0.99) * 1e3},
        "ttft_streamed_jobs_ms": {"p50": quantile(ttft_streamed, 0.5) * 1e3,
                                  "p99": quantile(ttft_streamed, 0.99) * 1e3},
        "unary_jobs_answer_ms": {"p50": quantile(answer, 0.5) * 1e3,
                                 "p99": quantile(answer, 0.99) * 1e3} if answer else None,
    }


def profile_delta(before: dict, after: dict, admission: dict) -> dict:
    """What ``/debug/profile`` (engine_profiler.snapshot) accrued between
    two reads: steps, tokens and seconds per phase, plus the overload
    limiter's state at the second read."""
    return {
        "steps": after["steps"] - before["steps"],
        "tokens": after["tokens"] - before["tokens"],
        "phase_s": {ph: after["phases"][ph]["total_s"] - before["phases"][ph]["total_s"]
                    for ph in after["phases"]},
        "limit": {k: admission[k] for k in ("limit", "limit_decreases", "limit_increases")},
    }


def lint_metrics(port: int) -> None:
    """/metrics must pass tools/metrics_lint.py."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tools" / "metrics_lint.py"
    spec = importlib.util.spec_from_file_location("metrics_lint", path)
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    errors = lint.lint_url(f"http://127.0.0.1:{port}/metrics")
    if errors:
        fail(f"/metrics fails tools/metrics_lint.py: {errors[:5]}")


def warm_up(port: int, jobs) -> float:
    """What the in-process twin's warm-up runs, over HTTP: the first two
    prompts for 32 tokens, unary, one after the other, so the first
    launches, the prefill bucket and every block's CUDA graph are behind
    the measured traffic.  One at a time: a request queued behind a cold
    server's first step (seconds) would feed that wait to the overload
    limiter, which would cut the measured run's concurrency for it.
    Returns the seconds until both answered."""
    t0 = time.perf_counter()
    for prompt, *_ in jobs[:2]:
        status, body = http_call(port, "/generate", {"prompt": prompt, "max_new_tokens": 32})
        if status != 200:
            fail(f"warm-up request failed: {status} {body}")
    return time.perf_counter() - t0


def serve_once(flags, jobs, log_path, env, sampled: bool, probe=None) -> dict:
    """One server run: a warm-up, greedy traffic over HTTP, optionally the
    sampled requests and ``probe(port)`` (its result under ``probe``), the
    debug reads (the KV tiers' included), the launch accounting, then
    SIGTERM (the drain saves the snapshot).  A job is (prompt, n) or
    (prompt, n, extra payload)."""
    proc, port = start_server((*flags, snapshot_flag(log_path.stem)), log_path, env)
    try:
        cold_s = warm_up(port, jobs)
        limit0 = http_call(port, "/debug/admission")[1]["limit"]
        prof0 = http_call(port, "/debug/profile")[1]
        results, wall = http_traffic(port, jobs)
        out = {"results": results, "client": client_latency(results, wall),
               "cold_warm_up_s": cold_s, "limit_at_start": limit0,
               "traffic_profile": profile_delta(prof0, http_call(port, "/debug/profile")[1],
                                                http_call(port, "/debug/admission")[1])}
        if sampled:
            # 8 sampled requests (n=2 is unary only), concurrently.
            import threading

            answers = [None] * 8

            def one(i):
                p, n = jobs[i]
                answers[i] = http_call(port, "/generate", {
                    "prompt": p, "max_new_tokens": n, "temperature": 0.8, "top_k": 50,
                    "n": 2, "logprobs": True})

            ts = [threading.Thread(target=one, args=(i,)) for i in range(len(answers))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            for status, body in answers:
                if status != 200:
                    fail(f"sampled request answered {status}: {body}")
                for choice in body["choices"]:
                    lps = choice["logprobs"]
                    if len(lps) != len(choice["tokens"]) or not all(
                            math.isfinite(x) and x <= 0.0 for x in lps):
                        fail(f"sampled logprobs not finite and <= 0: {lps[:8]}")
            out["sampled"] = {"requests": len(answers), "choices": 2 * len(answers),
                              "all_logprobs_finite_and_nonpositive": True}
        if probe is not None:
            out["probe"] = probe(port)
        status, out["summary"] = http_call(port, "/debug/state?summary=1")
        status, out["profile"] = http_call(port, "/debug/profile")
        status, out["admission"] = http_call(port, "/debug/admission")
        status, state = http_call(port, "/debug/state")
        status, flight = http_call(port, "/debug/flight")
        status, out["kvcache"] = http_call(port, "/debug/kvcache")
        lint_metrics(port)
    except BaseException:
        proc.kill()
        raise
    out["drain_s"] = stop_server(proc, log_path)
    eng = state["engine"]
    dev = eng["device"]
    out["preemptions"] = eng["preemptions"]
    if not eng["kvcache"]["retain"] or not eng["kvcache"]["host"]["enabled"]:
        fail(f"the server runs without the KV tiers: {eng['kvcache']}")
    out["device"] = dev
    launches = dev["paged_launches"]["f"]
    if launches != dev["num_layers"] * dev["device_steps"] or launches <= 0:
        fail(f"the server counted {launches} paged launches over {dev['device_steps']} "
             f"dispatched steps of {dev['num_layers']} layers")
    preempt = {}
    for ev in flight["events"]:
        if ev["kind"] == "engine.preempt":
            preempt[ev["rid"]] = min(preempt.get(ev["rid"], 1 << 30), ev["generated"])
    out["preempted_at"] = preempt
    out["flight_dropped"] = flight["dropped"]
    return out


def run_serve(torch, tf, http_server, smi, phase_4d: dict) -> dict:
    """Phase 4e: the port's HTTP server as the deployment runs it, on the
    card, at full width: phase 4d's traffic over HTTP (greedy tokens
    equal to an in-process engine built from the same flags), 8 sampled
    requests with logprobs, the debug reads, /metrics linted, the launch
    accounting, and a drain on SIGTERM; then again at 96 pages, where
    optimistic admission preempts and the KV tiers restore the resumes;
    and GPTConfig.tiny() in float32 in process, where preempted streams
    must equal unpreempted ones in full."""
    import os
    import pathlib

    from k8s_device_plugin_tpu_torch.models.engine import synthetic_jobs

    root = pathlib.Path(__file__).resolve().parent
    out_dir = root / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    jobs = synthetic_jobs(32, 128, 128, 32000)

    # The in-process twin: the same flags, weights and traffic.
    args = http_server.parse_args([*SERVE_FLAGS, f"--device={DEVICE}"])
    eng = http_server.build_engine(args)
    eng.run([(p, 32) for p, _ in jobs[:2]])  # warm: kernels, graphs, buckets
    prof0 = eng.profiler.snapshot()
    t0 = time.perf_counter()
    done = eng.run(jobs)
    torch.cuda.synchronize()
    inproc = engine_latency(done, time.perf_counter() - t0)
    inproc["preemptions"] = eng.preemptions
    inproc["traffic_profile"] = profile_delta(prof0, eng.profiler.snapshot(),
                                              eng.overload.snapshot())
    want = [r.tokens for r in done]
    del eng, done
    torch.cuda.empty_cache()
    log(f"phase 4e in-process twin: {inproc}")

    full = serve_once(SERVE_FLAGS, jobs, out_dir / "serve_512.log", env, sampled=True)
    got = [r["tokens"] for r in full["results"]]
    if got != want:
        fail(f"HTTP greedy tokens differ from the in-process engine's at "
             f"{first_difference(got, want)}")
    if full["preemptions"]:
        log(f"the 512-page run preempted {full['preemptions']} times")
    log(f"phase 4e 512 pages: client {full['client']}, preemptions {full['preemptions']}")

    small_flags = tuple(f for f in SERVE_FLAGS if not f.startswith("--num-pages")) + (
        "--num-pages=96",)
    small = serve_once(small_flags, jobs, out_dir / "serve_96.log", env, sampled=False)
    # Preemption does not hang on timing: the limiter only cuts on queue
    # waits past its setpoint, which the first wave (admitted as it
    # arrives, at the full limit the serial warm-up leaves) does not have,
    # and any 8 of the jobs need more pages than the pool holds: the 8
    # that share a prefix need the fewest.
    demand = first_wave_pages(jobs[0::2][:8], page_size=16)
    small["first_wave_pages"] = demand
    if small["limit_at_start"] < 8:
        fail(f"the warm-up left the 96-page server's limiter at {small['limit_at_start']}, "
             f"not 8")
    if demand <= 95:
        fail(f"the first wave needs {demand} pages, which 95 allocatable pages hold")
    if small["preemptions"] <= 0:
        fail(f"the 96-page server never preempted (the first wave needs {demand} of 95 "
             f"pages)")
    resumes = small["kvcache"]["resumes"]
    if resumes["restored"] <= 0:
        fail(f"the 96-page server preempted {small['preemptions']} times and restored no "
             f"resume from the KV tiers: {small['kvcache']}")
    if any(len(r["tokens"]) != n for r, (_, n) in zip(small["results"], jobs)):
        fail("a request on the 96-page server did not end with its 128 tokens")
    # Both runs served the same 32 jobs: compare by job index (a server's
    # rids are its own), with each 96-page request's first preemption
    # point from that server's flight recorder.
    divergence = {}
    for i, (a, b) in enumerate(zip(small["results"], full["results"])):
        at = small["preempted_at"].get(a["rid"])
        if at is None:
            if a["tokens"] != b["tokens"]:
                fail(f"request {i} was never preempted at 96 pages but differs from the 512-page "
                     f"run at {first_difference([a['tokens']], [b['tokens']])}")
            continue
        if a["tokens"][:at] != b["tokens"][:at]:
            fail(f"request {i} differs from the 512-page run before its preemption at {at}")
        diff = next((j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y), None)
        divergence[i] = {"preempted_at": at, "first_difference": diff}
    log(f"phase 4e 96 pages: client {small['client']}, preemptions {small['preemptions']}, "
        f"resumes {resumes}, preempted requests {divergence}")

    tiny = run_tiny_preemption(torch, tf)
    keep = ("client", "cold_warm_up_s", "limit_at_start", "traffic_profile", "preemptions",
            "drain_s", "device", "flight_dropped", "kvcache")
    report = {
        "card": smi,
        "flags": list(SERVE_FLAGS),
        "in_process": inproc,
        "phase_4d_in_process": {
            "flags": phase_4d["flags"], "tokens_per_s": phase_4d["value"],
            "ttft_ms": phase_4d["ttft_exact_ms"], "itl_ms": phase_4d["itl_request_mean_ms"],
        },
        "http_512": {k: full[k] for k in keep},
        "http_96": {k: small[k] for k in keep},
        "preempted_96": divergence,
        "first_wave_pages_96": demand,
        "sampled": full["sampled"],
        "summary_512": full["summary"],
        "admission_512": full["admission"],
        "profile_512": full["profile"],
        "profile_96": small["profile"],
        "admission_96": small["admission"],
        "tiny_f32": tiny,
    }
    return report


def first_wave_pages(jobs, page_size: int) -> int:
    """Pages ``jobs`` hold together once each has its every token: each
    prompt's whole pages shared with an earlier job's (the prefix trie)
    counted once."""
    seen, pages = set(), 0
    for prompt, n in jobs:
        total = -(-(len(prompt) + n) // page_size)
        shared = 0
        for i in range(len(prompt) // page_size):
            key = tuple(prompt[: (i + 1) * page_size])
            if key not in seen:
                break
            shared += 1
        seen.update(tuple(prompt[: (i + 1) * page_size]) for i in range(len(prompt) // page_size))
        pages += total - shared
    return pages


def run_tiny_preemption(torch, tf) -> dict:
    """GPTConfig.tiny() in float32 on the card: optimistic admission on a
    pool that preempts must return, in full, the streams of a pool that
    does not (block 16, overlap, CUDA graphs)."""
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine

    cfg = tf.GPTConfig.tiny()
    params = tf.init_params(cfg, seed=3)
    gen = torch.Generator().manual_seed(4)
    jobs = [(torch.randint(1, 512, (8 + 3 * i,), generator=gen).tolist(), 40 + 4 * i)
            for i in range(8)]
    streams, pre = [], []
    for pages in (200, 36):
        eng = ServingEngine(cfg, params, tf.PagedConfig(4, pages, 32), max_slots=4,
                            decode_block=16, overlap_steps=1, admission="optimistic",
                            device=DEVICE)
        streams.append([r.tokens for r in eng.run(jobs)])
        pre.append(eng.preemptions)
    if pre[1] <= 0 or pre[0]:
        fail(f"tiny float32: preemptions {pre} (want 0 on 200 pages, > 0 on 36)")
    if streams[1] != streams[0]:
        fail(f"tiny float32: preempted streams differ at {first_difference(streams[1], streams[0])}")
    log(f"tiny float32 preemption: {pre[1]} preemptions, streams identical")
    return {"preemptions": pre[1], "requests": len(jobs), "identical": True}


# ------------------------------------------------------- phases 4f and 4g


def long_jobs(n: int, length: int = 256, new: int = 128) -> list:
    """``n`` distinct page-aligned prompts of ``length`` tokens (16 full
    pages at page 16) with ``new`` tokens each, in vocab 32000."""
    return [([(i * 7919 + j * 104729) % 31999 + 1 for j in range(length)], new)
            for i in range(n)]


def http_sequential(port: int, jobs, headers=None) -> list:
    """Each job streamed alone, one after the other (prefill and decode at
    batch 1 on every server, so the tokens of the split and the unified
    setups are comparable bit for bit)."""
    out = []
    for prompt, n in jobs:
        r = stream_request(port, {"prompt": prompt, "max_new_tokens": n}, headers)
        if r["status"] != 200:
            fail(f"a sequential request answered {r['status']}: {r['body']}")
        out.append(r)
    return out


def stream_latency(results) -> dict:
    """TTFT and ITL quantiles (ms) of streamed results."""
    ttft = [r["stamps"][0] - r["t_send"] for r in results]
    itl = [b - a for r in results for a, b in zip(r["stamps"], r["stamps"][1:])]
    return {"ttft_ms": {"p50": quantile(ttft, 0.5) * 1e3, "p99": quantile(ttft, 0.99) * 1e3},
            "itl_ms": {"p50": quantile(itl, 0.5) * 1e3, "p99": quantile(itl, 0.99) * 1e3},
            "requests": len(results)}


def exit_dump_events(dump_dir, kind: str, recorder: str = "engine") -> list:
    """The ``kind`` events of the ``recorder`` ring in the flight dump a
    server (or the router) wrote at exit under ``dump_dir``."""
    import pathlib

    events = []
    for path in sorted(pathlib.Path(dump_dir).glob("tpu-flight-*-exit-*.json")):
        payload = json.loads(path.read_text())
        events += [e for e in payload["recorders"][recorder]["events"] if e["kind"] == kind]
    return events


def run_warm_restart(smi, jobs, reference_jobs) -> dict:
    """Phase 4f: server A on the deployment's flags serves the
    shared-prefix half of the traffic, SIGTERM drains it and the drain
    saves the snapshot; server B starts on the same snapshot directory,
    must load more than 0 entries, and replays the same requests with A's
    greedy tokens.  B then serves ``reference_jobs`` one at a time (phase
    4g's unified reference) and drains."""
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parent
    out_dir = root / "build" / "logs"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    snap_arg = snapshot_flag("warm_restart")
    snap_file = pathlib.Path(snap_arg.split("=", 1)[1]) / "kv_arena.snapshot"
    shared = jobs[0::2]  # the 16 requests that share a 64-token prefix
    runs = {}
    for name in ("cold", "warm"):
        dump_dir = root / "build" / "dumps" / f"warm_restart_{name}"
        shutil.rmtree(dump_dir, ignore_errors=True)
        log_path = out_dir / f"warm_restart_{name}.log"
        proc, port = start_server((*SERVE_FLAGS, snap_arg, f"--dump-dir={dump_dir}"), log_path,
                                  env)
        try:
            restore_line = re.search(r"kv snapshot restore: (\{.*\})", open(log_path).read())
            state0 = http_call(port, "/debug/state")[1]
            warm_s = warm_up(port, jobs[1::2])  # prompts outside the measured half
            dev0 = http_call(port, "/debug/state")[1]["engine"]["device"]
            kv0 = http_call(port, "/debug/kvcache")[1]
            results, wall = http_traffic(port, shared, streamed=len(shared))
            dev1 = http_call(port, "/debug/state")[1]["engine"]["device"]
            kv1 = http_call(port, "/debug/kvcache")[1]
            reference = http_sequential(port, reference_jobs) if name == "warm" else None
        except BaseException:
            proc.kill()
            raise
        drain_s = stop_server(proc, log_path)
        saved = exit_dump_events(dump_dir, "engine.snapshot.saved")
        runs[name] = {
            "tokens": [r["tokens"] for r in results],
            "latency": stream_latency(results),
            "tokens_per_s": sum(len(r["tokens"]) for r in results) / wall,
            "prefill_positions": dev1["prefill_positions"] - dev0["prefill_positions"],
            "host_hits": kv1["hits"]["host"] - kv0["hits"]["host"],
            "retained_hits": kv1["hits"]["retained"] - kv0["hits"]["retained"],
            "restores": kv1["restores"] - kv0["restores"],
            "snapshot_load": state0["fence"]["snapshot"]["last_load"],
            "restore_line": restore_line.group(1) if restore_line else None,
            "drain_s": drain_s,
            "warm_up_s": warm_s,
            "drain_save": saved[-1] if saved else None,
            "snapshot_bytes": snap_file.stat().st_size if snap_file.exists() else 0,
            "reference": reference,
        }
        if not saved or not saved[-1].get("ok", True) or not snap_file.exists():
            fail(f"phase 4f {name}: the drain saved no snapshot ({saved[-1:]})")
    cold, warm = runs["cold"], runs["warm"]
    load = warm["snapshot_load"] or {}
    if not load.get("ok") or load.get("restored", 0) <= 0:
        fail(f"phase 4f: the restarted server loaded no entry (a cold start): {load}")
    if warm["tokens"] != cold["tokens"]:
        fail(f"phase 4f: the warm server's greedy tokens differ from the cold one's at "
             f"{first_difference(warm['tokens'], cold['tokens'])}")
    if warm["host_hits"] <= 0:
        fail(f"phase 4f: the warm server's replay never hit the restored arena: {warm}")
    report = {
        "card": smi,
        "requests": len(shared),
        "snapshot_bytes": cold["snapshot_bytes"],
        "snapshot_entries": cold["drain_save"]["entries"],
        "save_s": cold["drain_save"]["ms"] / 1e3,
        "load_s": load["ms"] / 1e3,
        "loaded_entries": load["restored"],
        "loaded_arena_bytes": load["bytes"],
        "greedy_tokens_equal": True,
    }
    for name, run in runs.items():
        report[name] = {k: run[k] for k in ("latency", "tokens_per_s", "prefill_positions",
                                            "host_hits", "retained_hits", "restores", "drain_s",
                                            "warm_up_s")}
    log(f"phase 4f warm restart: {report}")
    return report, warm["reference"]


def run_split_roles(smi, reference_jobs, reference) -> dict:
    """Phase 4g: a ``--role=prefill`` and a ``--role=decode`` server on the
    one card, on the deployment's flags; this script plays the router,
    sending each long prompt to the decode server with ``X-Handoff-Source``
    naming the prefill server.  The greedy tokens must equal the unified
    server's (phase 4f's warm server, the same prompts one at a time) and
    the decode server must skip prefill tokens."""
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parent
    out_dir = root / "build" / "logs"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    warm_job, measured = reference_jobs[0], reference_jobs[1:]
    servers = {}
    try:
        for role in ("prefill", "decode"):
            servers[role] = start_server((*SERVE_FLAGS, snapshot_flag(f"split_{role}"),
                                          f"--role={role}"), out_dir / f"split_{role}.log", env)
        source = {"X-Handoff-Source": f"127.0.0.1:{servers['prefill'][1]}"}
        dport = servers["decode"][1]
        http_sequential(dport, [warm_job], source)  # captures, first launches
        d0 = http_call(dport, "/debug/disagg")[1]
        results = http_sequential(dport, measured, source)
        d1 = http_call(dport, "/debug/disagg")[1]
        p1 = http_call(servers["prefill"][1], "/debug/disagg")[1]
        layout = http_call(dport, "/debug/state")[1]["engine"]["config"]
    except BaseException:
        for proc, _ in servers.values():
            proc.kill()
        raise
    drains = {role: stop_server(proc, out_dir / f"split_{role}.log")
              for role, (proc, _) in servers.items()}
    got = [r["tokens"] for r in results]
    want = [r["tokens"] for r in reference[1:]]
    if got != want:
        fail(f"phase 4g: the split replicas' greedy tokens differ from the unified server's at "
             f"{first_difference(got, want)}")
    delta = {k: d1[k] - d0[k] for k in ("fetches", "fetch_failures", "fetched_entries",
                                        "skipped_prefill_tokens", "noprefill_admits")}
    if delta["skipped_prefill_tokens"] <= 0 or delta["fetches"] != len(measured) \
            or delta["fetch_failures"]:
        fail(f"phase 4g: the decode server skipped no prefill or its pulls failed: {delta}")
    # One entry is one page's rows: K and V, every layer (bf16 pools).
    flag = dict(f[2:].split("=", 1) for f in SERVE_FLAGS)
    entry_bytes = (2 * int(flag["layers"]) * layout["page_size"] * int(flag["kv-heads"])
                   * (int(flag["hidden"]) // int(flag["heads"])) * 2)
    report = {
        "card": smi,
        "requests": len(measured),
        "prompt_tokens": len(measured[0][0]),
        "new_tokens": measured[0][1],
        "greedy_tokens_equal": True,
        "decode": delta,
        "prefill_served_entries": p1["served_entries"],
        "bytes_handed_off": delta["fetched_entries"] * entry_bytes,
        "bytes_note": "fetched entries x one page's K and V rows over every layer (bf16), "
                      "wire headers aside",
        "split": stream_latency(results),
        "unified": stream_latency(reference[1:]),
        "drain_s": drains,
    }
    log(f"phase 4g split roles: {report}")
    return report


def run_ab_tiers(smi, rounds: int) -> dict:
    """``--ab-tiers N``: phase 4e's traffic over HTTP at 512 and 96 pages
    with the KV tiers off, with retained pages only (no host arena) and
    with both, the three in a rotated order in each of ``N`` rounds, the
    rest of the deployment's flags as they are.  Per run: client tokens/s,
    TTFT, ITL, steps, the limiter, seconds by profiler phase, preemptions,
    reclaims, offloads and how the resumes went."""
    import os
    import pathlib

    from k8s_device_plugin_tpu_torch.models.engine import synthetic_jobs

    root = pathlib.Path(__file__).resolve().parent
    out_dir = root / "build" / "logs"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    jobs = synthetic_jobs(32, 128, 128, 32000)
    base = [f for f in SERVE_FLAGS
            if not f.startswith(("--kv-retain", "--kv-host-cache-mb", "--num-pages"))]
    tiers = {"on": ["--kv-retain=1", "--kv-host-cache-mb=512"],
             "retain": ["--kv-retain=1", "--kv-host-cache-mb=0"],
             "off": ["--kv-retain=0", "--kv-host-cache-mb=0"]}
    modes = list(tiers)
    order = [modes[i % 3:] + modes[: i % 3] for i in range(rounds)]
    rows = []
    for i, mode in enumerate(m for pair in order for m in pair):
        for pages in (512, 96):
            log_path = out_dir / f"ab_tiers_{i}_{mode}_{pages}.log"
            proc, port = start_server((*base, f"--num-pages={pages}", *tiers[mode]), log_path,
                                      env)
            try:
                warm_up(port, jobs)
                prof0 = http_call(port, "/debug/profile")[1]
                results, wall = http_traffic(port, jobs)
                prof = profile_delta(prof0, http_call(port, "/debug/profile")[1],
                                     http_call(port, "/debug/admission")[1])
                eng = http_call(port, "/debug/state")[1]["engine"]
            except BaseException:
                proc.kill()
                raise
            stop_server(proc, log_path)
            c = client_latency(results, wall)
            kv = eng["kvcache"]
            rows.append({"run": i, "tiers": mode, "pages": pages,
                         "tokens_per_s": c["tokens_per_s"], "ttft_ms": c["ttft_ms"],
                         "itl_ms": c["itl_ms"], "steps": prof["steps"], "limit": prof["limit"],
                         "phase_s": prof["phase_s"], "preemptions": eng["preemptions"],
                         "reclaims": kv["reclaims"], "offloads": kv["offloads"],
                         "resumes": kv["resumes"], "hits": kv["hits"]})
            log(f"ab tiers: {rows[-1]}")
    return {"ab_tiers": rows, "rounds": rounds, "card": smi}


def check_restored_pages(torch, pa, quant, tf) -> dict:
    """Kernel 1 on pages that came back from the host: a serving engine at
    the deployed widths (2 layers; page 16, 512 pages) in bf16 and with
    int8 pools, its pools filled, pages 1-255 read to the host through the
    engine's row reads (one gather per pool per layer) and written into
    pages 256-511 through its restore (one in-place ``index_copy_`` per
    pool per layer).  Every pool's rows must come back bit for bit, the
    kernel on the restored pages must equal the kernel on the source
    pages bit for bit and its plain version within tolerance."""
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine

    dev = torch.device(DEVICE)
    B, H, HK, D, PS, MPP, P = 8, 16, 4, 64, 16, 32, 512
    out = {}
    for kv_format, quant_kv in (("f", False), ("int8", True)):
        cfg = tf.GPTConfig(vocab_size=512, hidden_size=1024, num_layers=2, num_heads=16,
                           intermediate_size=3072, max_seq=PS * MPP, num_kv_heads=4,
                           dtype=torch.bfloat16, quant_kv=quant_kv)
        eng = ServingEngine(cfg, tf.init_params(cfg, 0), tf.PagedConfig(PS, P, MPP),
                            max_slots=B, kv_retain=True, kv_host_cache_mb=64, device=DEVICE)
        gen = torch.Generator(device=dev).manual_seed(11)
        for layer in range(cfg.num_layers):
            pools = eng.kv_pools(layer)
            k, v = (torch.randn((P, PS, HK, D), generator=gen, device=dev) for _ in range(2))
            fill = quantized_pools(quant, kv_format, k, v, torch.bfloat16)
            pools["pool_key"].copy_(fill["pool_k"])
            pools["pool_value"].copy_(fill["pool_v"])
            if quant_kv:
                pools["pool_key_scale"].copy_(fill["scale_k"])
                pools["pool_value_scale"].copy_(fill["scale_v"])
        src = list(range(1, P // 2))
        dst = list(range(P // 2, P // 2 + len(src)))
        before = [{n: (t.data_ptr(), t.clone()) for n, t in eng.kv_pools(i).items()}
                  for i in range(cfg.num_layers)]
        rows = eng._kv_read_pages_rows(src)
        eng._kv_write_page_rows(dst, rows)
        torch.cuda.synchronize()
        for layer in range(cfg.num_layers):
            for name, t in eng.kv_pools(layer).items():
                ptr, old = before[layer][name]
                if t.data_ptr() != ptr:
                    fail(f"restored pages: layer {layer} {name} was rebound, not written in "
                         f"place ({kv_format})")
                if not torch.equal(t[dst], old[src]):
                    fail(f"restored pages: layer {layer} {name} rows differ after the round "
                         f"trip ({kv_format})")
        q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
        lens = torch.tensor([1, 17, 100, 255, 256, 333, 480, 500], dtype=torch.int32,
                            device=dev)
        pick = torch.randperm(len(src) - 1, generator=gen, device=dev)[: B * MPP // 2]
        table_src = torch.tensor(src, device=dev)[pick].reshape(B, MPP // 2).to(torch.int32)
        table_src = torch.cat([table_src, table_src], dim=1)  # 32 pages a row
        table_dst = table_src + (P // 2 - 1)
        pools0 = eng.kv_pools(0)
        kw = {"pool_k": pools0["pool_key"], "pool_v": pools0["pool_value"]}
        if quant_kv:
            kw.update(scale_k=pools0["pool_key_scale"], scale_v=pools0["pool_value_scale"])
        lens = lens.clamp(max=MPP * PS)
        got = pa.paged_attention(q, page_table=table_dst, lens=lens, num_splits=8, **kw)
        want = pa.paged_attention(q, page_table=table_src, lens=lens, num_splits=8, **kw)
        if not torch.equal(got, want):
            fail(f"kernel 1 on restored {kv_format} pages differs from the source pages")
        err = hold_paged(torch, pa, q, kw, table_dst, lens, window=None, splits=8,
                         kv_format=kv_format)
        log(f"kernel 1 on host-restored {kv_format} pages: equal to the source pages, "
            f"max_abs_err {err:.3e} against the plain version (tol {TOL_BF16})")
        if not err <= TOL_BF16:
            fail(f"kernel 1 on restored {kv_format} pages: {err} > {TOL_BF16}")
        out[kv_format] = {"max_abs_err": err, "tolerance": TOL_BF16, "pages": len(src),
                          "equal_to_source_pages": True}
        del eng
        torch.cuda.empty_cache()
    return out


def run_blocks(torch, engine, pa, fa, dp, sync_tokens) -> dict:
    """Phase 4d: the full-width engine at decode block 16 with the overlap
    round and CUDA graphs must return phase 4's greedy tokens exactly,
    discard overlapped rounds at the finishes and replay graphs; sampled
    (temperature 0.8, top-k 50) it must repeat itself under one rng with
    graphs on and off.  Then decode_profile's step wall against device
    time per token at block 1 (synchronous and eager, then overlapped and
    graphed) and at block 16."""
    greedy, launches, tokens = run_engine(torch, engine, pa, fa, BLOCKS)
    BLOCK16_TOKENS[:] = tokens  # phase 12a holds its tensor-parallel run to them
    if tokens != sync_tokens:
        fail(f"block 16 with overlap and graphs differs from phase 4's greedy tokens at "
             f"{first_difference(tokens, sync_tokens)}")
    if greedy["overlap_discards"] <= 0 or greedy["graph_replays"] <= 0:
        fail(f"block 16 run: {greedy['overlap_discards']} discards, "
             f"{greedy['graph_replays']} graph replays")
    sampled = {}
    for graphs in (1, 0):
        summary, _, stream = run_engine(torch, engine, pa, fa,
                                        BLOCKS + SAMPLED + (f"--cuda-graphs={graphs}",))
        sampled[graphs] = (summary, stream)
    if sampled[1][1] != sampled[0][1]:
        fail(f"sampled block 16 streams differ with graphs on and off at "
             f"{first_difference(sampled[1][1], sampled[0][1])}")
    if sampled[1][1] == tokens:
        fail("the sampled run returned the greedy tokens")
    profiles = {}
    for name, flags, steps in (
        ("block1_sync_eager", SYNC_EAGER, 16),
        ("block1_overlap_graphs", ("--decode-block=1", "--overlap-steps=1", *NO_LIMITER), 16),
        ("block16_overlap_graphs", BLOCKS, 8),  # 8 blocks: 128 tokens a row, twice
    ):
        prof = dp.profile_decode(steps, flags)
        profiles[name] = {key: prof[key] for key in (
            "flags", "steps", "tokens", "step_ms", "wall_ms_per_token", "device_ms_per_step",
            "device_ms_per_token", "busy_share", "unprofiled_step_ms",
            "unprofiled_wall_ms_per_token", "paged_launches", "top")}
        log(f"decode profile {name}: {profiles[name]}")
    return {"greedy": greedy, "paged_launches": launches["f"],
            "sampled_graphs": sampled[1][0], "sampled_eager": sampled[0][0],
            "decode_profile": profiles}


def quantile(values, q: float) -> float:
    """Linear-interpolated q-quantile of ``values``."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run_generate(torch, tf, pa, fa):
    """Phase 5: greedy_generate at full width; returns flash launches."""
    cfg = tf.GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16,
        intermediate_size=3072, max_seq=512, num_kv_heads=4,
    )
    params = tf.init_params(cfg, seed=0)
    prompt = torch.randint(0, 32000, (8, 128), generator=torch.Generator().manual_seed(2))
    pa.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    out = tf.greedy_generate(cfg, params, prompt, 32, device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    log(f"greedy_generate: {tuple(out.shape)} in {dt:.3f}s; flash launches "
        f"{fa.flash_attention.launches_by_design}")
    if launches <= 0:
        fail("greedy_generate's bulk prefill never launched the flash kernel")
    expect_designs(fa.flash_attention.launches_by_design, "wgmma", launches,
                   "greedy_generate's bf16 prefill")
    if tuple(out.shape) != (8, 160) or not torch.equal(out[:, :128].cpu(), prompt):
        fail(f"greedy_generate returned {tuple(out.shape)} or altered the prompt")
    if int(out.min()) < 0 or int(out.max()) >= 32000:
        fail("greedy_generate emitted a token id outside the vocabulary")
    return launches


def check_paths_agree(torch, tf, engine, cfg=None, page=(16, 512, 32), prompt_len=64,
                      params=None, **quant_kw):
    """Phases 6 and 6b: fp32, 2 layers, full width (``quant_kw`` sets the
    weight and KV formats), or ``cfg`` at the paged geometry ``page`` (6:
    GPTConfig.tiny(), head_dim 16, at page 4): kernel path == gather path
    wherever the top-2 margin of the reference decode clears TOL_MARGIN.
    ``params``: the weights (default ``init_params(cfg, seed=3)``)."""
    if cfg is None:
        cfg = tf.GPTConfig(
            vocab_size=32000, hidden_size=1024, num_layers=2, num_heads=16,
            intermediate_size=3072, max_seq=512, num_kv_heads=4, dtype=torch.float32,
            **quant_kw,
        )
    params = tf.init_params(cfg, seed=3) if params is None else params
    jobs = engine.synthetic_jobs(8, prompt_len, 16, cfg.vocab_size)
    streams = {}
    for use_kernel in (None, False):
        paged = tf.PagedConfig(*page, use_kernel=use_kernel)
        eng = engine.ServingEngine(cfg, params, paged, max_slots=8, device=DEVICE)
        streams[use_kernel] = [r.tokens for r in eng.run(jobs)]
    held = hold_streams(torch, tf, eng.model, jobs, streams[None], streams[False],
                        f"fp32 {quant_kw or 'float'} kernel against gather path",
                        tol=TOL_MARGIN)
    log(f"fp32 {quant_kw or 'float'} head_dim {cfg.head_dim} page {page[0]}: paths agree on "
        f"{held['checked']} tokens ({len(held['near_ties'])} near-ties)")
    return held


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def sdpa_forward(torch, q, k, v, causal=True):
    """A call of SDPA's forward on these inputs (the yardstick, never
    called by the port)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    except TypeError:  # a PyTorch without enable_gqa: expanded kv
        group = q.shape[1] // k.shape[1]
        ke, ve = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
        return lambda: sdpa(q, ke, ve, is_causal=causal)


def profiled_ms(torch, fn, what: str, iters: int = 10, warmup: int = 3,
                whole: bool = True) -> float:
    """Device time per call of ``fn`` (``decode_profile.profiled_device_us``;
    ``whole``: ``fn`` launches the same kernels every call, and a window
    that traced fewer is profiled again).  SDPA's backward is timed this
    way because a CUDA graph cannot capture its ``autograd.grad`` here; the
    backward kernels are timed the same way beside it, so the two compare
    by one method."""
    from k8s_device_plugin_tpu_torch.decode_profile import profiled_device_us

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    try:
        return profiled_device_us(fn, iters, whole) / 1e3
    except RuntimeError as err:
        fail(f"{what}: {err}")


def sdpa_backward(torch, q, k, v, dout, causal=True):
    """A call of SDPA's backward on these inputs (one call yields dq, dk
    and dv; the yardstick, never called by the port)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa_forward(torch, *leaves, causal=causal)()
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def hold_backward(got, want, tol: float, label: str, worst: dict, dtype_name: str) -> None:
    """Fail unless each of (dq, dk, dv) is within ``tol`` of the plain
    backward's, as max |got - want| / max |want|; fold the errors into
    ``worst``, keyed as FLASH_ROWS: dq's under ("dq", dtype_name), dk and
    dv's under ("dkv", dtype_name)."""
    rels = [rel_err(g, w) for g, w in zip(got, want)]
    log(f"flash bwd {label}: rel dq {rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e} (tol {tol})")
    if not max(rels) <= tol:
        fail(f"flash backward {label}: {rels} > {tol}")
    abss = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
    for key, idx in ((("dq", dtype_name), (0,)), (("dkv", dtype_name), (1, 2))):
        worst[key][0] = max(worst[key][0], *(abss[i] for i in idx))
        worst[key][1] = max(worst[key][1], *(rels[i] for i in idx))


def check_flash_bwd(torch, fa, facts):
    """Phase 3b: kernels 3 and 4 (both variants of each) against the plain
    backward; times them at the training shape and returns their
    kernel-line entries, keyed as FLASH_ROWS."""
    dev = torch.device(DEVICE)
    B, H, D = 2, 16, 64
    gen = torch.Generator(device=dev).manual_seed(4)
    types = (("bfloat16", TOL_BWD_BF16, BF16_FLOPS), ("float32", TOL_BWD_F32, FP32_FLOPS))
    worst = {key: [0.0, 0.0] for key in FLASH_ROWS if key[0] != "forward"}  # (abs, rel)
    for dtype_name, tol, _ in types:
        dtype = getattr(torch, dtype_name)
        for s in (128, 200, 512, 1024):  # 200: ragged last q and kv tiles
            for group in (4, 1):
                hk = H // group
                q = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
                k = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                v = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                dout = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
                for causal, window in ((True, None), (True, 100), (False, None)):
                    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
                    fa.reset_launches()
                    got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
                    for kernel in ("dq", "dkv"):
                        expect_designs(getattr(fa.flash_backward, f"{kernel}_launches_by_design"),
                                       facts[(kernel, dtype_name)]["design"], 1,
                                       f"flash_backward {dtype}'s {kernel} kernel")
                    want = fa.flash_attention_backward_reference(
                        q, k, v, out, lse, dout, causal=causal, sm_scale=D ** -0.5,
                        window=window, block_kv=128,
                    )
                    hold_backward(got, want, tol,
                                  f"{dtype} s={s} group={group} causal={causal} window={window}",
                                  worst, dtype_name)
    # The training shape: the kernels exactly as the training step launches
    # them (bf16; float32 for the FMA variants), held against the plain
    # backward, then timed (L2 warm between launches).
    B, H, HK, S = 8, 16, 4, 1024
    opts = dict(causal=True, sm_scale=D ** -0.5, window=None)
    pairs = B * H * S * (S + 1) // 2  # causal (row, col) pairs
    rows = {}
    for dtype_name, tol, peak in types:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, HK, S, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, HK, S, D), generator=gen, device=dev).to(dtype)
        dout = torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
        shape = f"b{B} h{H} hk{HK} s{S} d{D} causal {dtype_name}"
        out, lse = fa.flash_forward(q, k, v, causal=True)
        dq, delta = fa.launch_dq(q, k, v, out, lse, dout, **opts)
        got = (dq, *fa.launch_dkv(q, k, v, lse, delta, dout, **opts))
        want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, block_kv=128,
                                                     **opts)
        hold_backward(got, want, tol, f"at {shape}", worst, dtype_name)
        calls = {"dq": lambda: fa.launch_dq(q, k, v, out, lse, dout, **opts),
                 "dkv": lambda: fa.launch_dkv(q, k, v, lse, delta, dout, **opts)}
        plain_ms, _ = time_ms(
            lambda: fa.flash_attention_backward_reference(q, k, v, out, lse, dout, block_kv=128,
                                                          **opts),
            iters=5, warmup=2,
        )
        library_ms = profiled_ms(torch, sdpa_backward(torch, q, k, v, dout),
                                 f"SDPA's backward ({shape})")
        size = q.element_size()
        row_q, row_kv, vec = B * H * S * D * size, B * HK * S * D * size, B * H * S * 4
        for kernel, call in calls.items():
            key = (kernel, dtype_name)
            ms, eager = time_ms(call, iters=20)
            prof = profiled_ms(torch, call, f"{facts[key]['name']} ({shape})")
            if kernel == "dq":
                # kernel 3 reads q, dO, O, lse, k, v and writes dq, D: 6 d flops a pair
                nbytes, flops, line = 4 * row_q + 2 * vec + 2 * row_kv, 6 * D * pairs, 433
            else:
                # kernel 4 reads q, dO, lse, D, k, v and writes dk, dv: 8 d flops a pair
                nbytes, flops, line = 2 * row_q + 2 * vec + 4 * row_kv, 8 * D * pairs, 500
            b_ms, b_by = bound(nbytes, flops, peak)
            rows[key] = {
                **facts[key],
                "replaces": f"k8s_device_plugin_tpu/ops/flash_attention.py:{line}",
                "launches": None,
                "max_abs_err": worst[key][0],
                "max_rel_err": worst[key][1],
                "tolerance": tol,
                "ms": ms,
                "eager_ms": eager,
                "profiled_ms": prof,
                "plain_ms": plain_ms,
                "plain_note": "the plain backward computes dq, dk and dv together",
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": library_ms,
                "library_note": "SDPA backward (profiler device time, compare with the sum of "
                                "the dq and dk/dv rows' profiled_ms), one call yields dq, dk "
                                "and dv",
                "shape": shape,
            }
            log(f"flash bwd {facts[key]['name']} at {shape}: graph {ms:.4f} ms, profiler "
                f"{prof:.4f} ms (bound {b_ms:.4f}); SDPA backward {library_ms:.4f} ms; "
                f"plain {plain_ms:.3f} ms")
    return rows


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """The MFU numerator: 6 x non-embedding parameters x tokens (forward and
    backward products) plus 3 x the causal attention forward's products
    (4 x head_dim flops per (row, col) pair and head, per layer)."""
    from k8s_device_plugin_tpu_torch.models.transformer import param_shapes

    n = sum(math.prod(shape) for name, shape in param_shapes(cfg).items()
            if not name.startswith("embed."))
    pairs = batch * seq * (seq + 1) // 2
    attn_fwd = cfg.num_layers * cfg.num_heads * 4 * cfg.head_dim * pairs
    return 6 * n * batch * seq + 3 * attn_fwd


def flash_launches(fa) -> tuple[dict, dict]:
    """Kernels 2-4's launch counts since the last reset: in total and by
    design."""
    launches = {"flash_attention": fa.flash_attention.launches,
                "flash_attention_bwd_dq": fa.flash_backward.dq_launches,
                "flash_attention_bwd_dkv": fa.flash_backward.dkv_launches}
    by_design = {"forward": dict(fa.flash_attention.launches_by_design),
                 "dq": dict(fa.flash_backward.dq_launches_by_design),
                 "dkv": dict(fa.flash_backward.dkv_launches_by_design)}
    return launches, by_design


def profiled_step(step, state, batch):
    """One training step traced by ``decode_profile.profiled_call`` (host
    and card, after one untraced warm-up step): (state after both, the
    traced step's wall seconds, its ``trace_stats``)."""
    from k8s_device_plugin_tpu_torch.decode_profile import profiled_call

    walls = []

    def one_step():
        nonlocal state
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        loss.item()
        walls.append(time.perf_counter() - t0)

    try:
        stats = profiled_call(one_step, 1, whole=False, cpu=True)
    except RuntimeError as err:
        fail(f"profiled training step: {err}")
    return state, walls[-1], stats


def run_training(torch, fa, bench, smi):
    """Phase 7: LM training at full width through the benchmark entry
    point; then one profiled step.  Returns (train summary, launches)."""
    args = bench.parse_args([
        "--model=gpt", "--batch-size=8", "--seq-len=1024", "--steps=5", "--warmup=2",
        "--dtype=bfloat16", f"--device={DEVICE}",
    ])
    built = bench.build(args)
    state, step, batch = built.state, built.step, built.batch
    cfg = state.model.config
    fa.reset_launches()
    state, losses, dt = bench.timed_steps(step, state, batch, args.warmup, args.steps)
    torch.cuda.synchronize()
    launches, by_design = flash_launches(fa)
    record = bench.make_record(args, state, losses, dt, args.steps, built.items_per_step)
    log(f"training: {record}; launches {launches}, by design {by_design} over {state.step} steps")
    n = cfg.num_layers * state.step
    for name, count in launches.items():
        if count != n:
            fail(f"training launched {name} {count} times, not {cfg.num_layers} x "
                 f"{state.step} steps")
    # bf16 runs the tensor-core kernels 2, 3 and 4, never their FMA variants.
    for kernel, counts in by_design.items():
        expect_designs(counts, "wgmma", n, f"the bf16 training run's {kernel} kernel")
    bad = [i for i, loss in enumerate(losses) if not torch.isfinite(loss).item()]
    if bad:
        fail(f"training loss not finite at steps {bad}")
    step_s, steps_run = dt / args.steps, state.step
    flops = model_flops_per_step(cfg, args.batch_size, args.seq_len)
    state, wall, stats = profiled_step(step, state, batch)
    stats["top"] = stats["top"][:16]  # deep enough to list kernels 2 and 4
    summary = {
        "config": "vocab 32000, hidden 1024, 8 layers, 16/4 heads, intermediate 2816, "
                  "bf16 compute, float32 params, batch 8, seq 1024",
        "tokens_per_s": args.batch_size * args.seq_len / step_s,
        "step_time_ms": step_s * 1e3,
        "steps_run": steps_run,
        "losses": [loss.item() for loss in losses],
        "model_flops_per_step": flops,
        "mfu": flops / step_s / BF16_FLOPS,
        "mfu_formula": "(6 x non-embedding params x tokens + 3 x causal attention forward "
                       "flops) / step time / 989e12",
        "profiled_step": {"wall_ms": wall * 1e3, **stats},
        "launches": launches,
        "launches_by_design": by_design,
        "record": record,
        "card": smi,
    }
    return summary, launches


def check_train_parity(torch, fa, tf, train, data, cfg=None, batch_shape=(2, 256), params=None):
    """Phase 8: one fp32 train step on the card (kernels) and on the CPU
    (plain versions) from the same weights and batch (phase 18 passes its
    ``cfg``, a smaller ``batch_shape`` and the weights its engine check
    used: ``params``, default ``init_params(cfg, seed=5)``)."""
    if cfg is None:
        cfg = tf.GPTConfig(
            vocab_size=32000, hidden_size=1024, num_layers=2, num_heads=16, num_kv_heads=4,
            intermediate_size=2816, max_seq=256, dtype=torch.float32,
        )
    params = tf.init_params(cfg, seed=5) if params is None else params
    batch = data.synthetic_lm_batch(*batch_shape, cfg.vocab_size,
                                    generator=torch.Generator().manual_seed(6), device="cpu")
    result = {}
    for device in (DEVICE, "cpu"):
        state = train.create_train_state(cfg, params, 0.1, 0.9, device=device)
        fa.reset_launches()
        state, loss = train.make_train_step()(state, {k: v.to(device) for k, v in batch.items()})
        result[device] = loss.item(), {k: v.cpu() for k, v in state.model.state_dict().items()}
        if device == DEVICE:
            # float32 runs the FMA kernels 2, 3 and 4, never the tensor-core ones.
            launches = {"forward": dict(fa.flash_attention.launches_by_design),
                        "dq": dict(fa.flash_backward.dq_launches_by_design),
                        "dkv": dict(fa.flash_backward.dkv_launches_by_design)}
            for kernel, counts in launches.items():
                expect_designs(counts, "fma", cfg.num_layers, f"the float32 step's {kernel} kernel")
    (card_loss, card_params), (cpu_loss, cpu_params) = result[DEVICE], result["cpu"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    param_err = max((card_params[k] - cpu_params[k]).abs().max().item() for k in cpu_params)
    log(f"fp32 train step card vs CPU: loss {card_loss:.6f} vs {cpu_loss:.6f} (rel {loss_rel:.2e}), "
        f"max param diff {param_err:.2e} (tol {TOL_TRAIN}); kernel launches {launches}")
    if not (loss_rel <= TOL_TRAIN and param_err <= TOL_TRAIN):
        fail(f"train step card vs CPU: loss rel {loss_rel}, params {param_err}")
    return {"loss_rel_err": loss_rel, "param_max_abs_err": param_err,
            "launches_by_design": launches}


# ---------------------------------------------------------------- phase 9

# Phase 9a's runs: (--model, its flags, where the width and batch come from).
TRAIN_MODELS = (
    ("resnet50", ["--batch-size=128", "--image-size=224", "--stem=conv7"],
     "bench.py's headline: ResNet-50, conv7, 224 px, batch 128"),
    ("alexnet", ["--batch-size=256", "--image-size=224"],
     "deploy/k8s-pod-example-tpu.yaml: AlexNet, 224 px, batch 256"),
    ("vit", ["--batch-size=64"],
     "deploy/k8s-pod-vit-tpu4.yaml's 256 over 4 chips: ViT-B/16, 256 px (256 tokens), batch 64"),
    ("bert", ["--batch-size=32", "--seq-len=384"],
     "deploy/k8s-pod-bert-tpu8.yaml's 64 over dp 2: BERT-base, seq 384, batch 32"),
)
FLASH_MODELS = ("vit", "bert")


def train_model(torch, fa, pa, bench, model: str, flags, source: str) -> dict:
    """One phase 9a run through the benchmark's entry points, its launch
    counts checked, then one profiled step."""
    from k8s_device_plugin_tpu_torch.utils.platform import peak_bf16_flops

    args = bench.parse_args([f"--model={model}", *flags, "--steps=5", "--warmup=2",
                             "--dtype=bfloat16", f"--device={DEVICE}"])
    built = bench.build(args)
    fa.reset_launches()
    pa.reset_launches()
    state, losses, dt = bench.timed_steps(built.step, built.state, built.batch, args.warmup,
                                          args.steps)
    torch.cuda.synchronize()
    launches, by_design = flash_launches(fa)
    paged = sum(pa.paged_attention.launches_by_format.values())
    record = bench.make_record(args, state, losses, dt, args.steps, built.items_per_step)
    log(f"phase 9a {model}: {record}; launches {launches}, by design {by_design}, paged {paged}")
    layers = state.model.config.num_layers if model in FLASH_MODELS else 0
    n = layers * state.step
    for name, count in launches.items():
        if count != n:
            fail(f"{model} training launched {name} {count} times, not {layers} layers x "
                 f"{state.step} steps")
    for kernel, counts in by_design.items():
        expect_designs(counts, "wgmma", n, f"{model}'s bf16 training run's {kernel} kernel")
    if paged:
        fail(f"{model} training launched the paged kernel {paged} times")
    bad = [i for i, loss in enumerate(losses) if not torch.isfinite(loss).item()]
    if bad:
        fail(f"{model} training loss not finite at steps {bad}: {[l.item() for l in losses]}")
    steps_run = state.step
    state, wall, stats = profiled_step(built.step, state, built.batch)
    stats["top"] = stats["top"][:12]
    step_s = dt / args.steps
    row = {
        "source": source,
        "flags": flags,
        "throughput": record["throughput"],
        "unit": record["unit"],
        "step_time_ms": step_s * 1e3,
        "steps_run": steps_run,
        "attention_layers": layers,
        "losses": [l.item() for l in losses],
        "launches": launches,
        "launches_by_design": by_design,
        "profiled_step": {"wall_ms": wall * 1e3, **stats},
        "record": record,
    }
    if model == "resnet50":
        peak = peak_bf16_flops(state.model.device)
        row["mfu"] = (None if peak is None else
                      args.batch_size / step_s * RESNET50_TRAIN_FLOPS_PER_IMAGE / peak)
        row["mfu_formula"] = "images/s x 3 x 8.2e9 (bench.py) / peak_bf16_flops"
    log(f"phase 9a {model}: {row['throughput']} {row['unit']}, step {row['step_time_ms']:.2f} "
        f"ms, busy {row['profiled_step']['busy_share']}, mfu {row.get('mfu')}")
    return row


def check_space_to_depth(torch, bench) -> dict:
    """Phase 9a's space_to_depth run, then its logits against conv7's with
    the stem kernel mapped (a 7x7 kernel zero-padded to 8x8 and repacked as
    [4, 4, 12, out], tests/test_models.py), in float32 at ResNet-50's full
    width, eval mode."""
    from k8s_device_plugin_tpu_torch.models.resnet import ResNet50

    args = bench.parse_args(["--model=resnet50", "--batch-size=128", "--image-size=224",
                             "--stem=space_to_depth", "--steps=5", "--warmup=2",
                             "--dtype=bfloat16", f"--device={DEVICE}"])
    built = bench.build(args)
    state, losses, dt = bench.timed_steps(built.step, built.state, built.batch, args.warmup,
                                          args.steps)
    record = bench.make_record(args, state, losses, dt, args.steps, built.items_per_step)
    if not all(torch.isfinite(l).item() for l in losses):
        fail(f"space_to_depth training loss not finite: {[l.item() for l in losses]}")
    del built, state
    conv7, s2d = (ResNet50(num_classes=1000, dtype=torch.float32, norm_dtype=torch.float32,
                           stem=stem, device=DEVICE, seed=3) for stem in ("conv7", "space_to_depth"))
    sd = {k: v for k, v in conv7.state_dict().items() if not k.startswith("Conv_stem.")}
    s2d.load_state_dict({**sd, "Conv_stem.kernel": s2d.Conv_stem.kernel}, strict=True)
    with torch.no_grad():
        w7 = conv7.Conv_stem.kernel.permute(2, 3, 1, 0)  # [7, 7, 3, out]
        w8 = torch.zeros((8, 8, 3, w7.shape[-1]), device=w7.device)
        w8[:7, :7] = w7
        wp = w8.reshape(4, 2, 4, 2, 3, -1).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 12, -1)
        s2d.Conv_stem.kernel.copy_(wp.permute(3, 2, 0, 1))
        images = torch.randn((8, 224, 224, 3), generator=torch.Generator(device=DEVICE)
                             .manual_seed(11), device=DEVICE)
        err = rel_err(s2d(images), conv7(images))
    log(f"phase 9a space_to_depth: {record}; logits vs conv7 (float32, mapped kernel) rel "
        f"{err:.2e} (tol {TOL_S2D})")
    if not err <= TOL_S2D:
        fail(f"space_to_depth logits differ from conv7's with the kernel mapped: {err}")
    return {"record": record, "logits_rel_err_vs_conv7": err, "tolerance": TOL_S2D,
            "losses": [l.item() for l in losses]}


def cut_models(torch):
    """Phase 9b's models as (name, factory(device), batch on the CPU, input
    key, tolerance): each at the reference's widths, cut as the docstring
    says."""
    import dataclasses as dc

    from k8s_device_plugin_tpu_torch.models.alexnet import AlexNet
    from k8s_device_plugin_tpu_torch.models.bert import Bert, BertConfig
    from k8s_device_plugin_tpu_torch.models.resnet import ResNet18Thin
    from k8s_device_plugin_tpu_torch.models.data import (
        synthetic_image_batch,
        synthetic_token_batch,
    )
    from k8s_device_plugin_tpu_torch.models.resnet import ResNet18Thin
    from k8s_device_plugin_tpu_torch.models.vit import ViT, ViTConfig

    f32 = torch.float32
    vit = ViTConfig(image_size=128, patch_size=8, num_layers=2, dtype=f32)
    bert = dc.replace(BertConfig.base(), num_layers=2, dtype=f32)
    gen = torch.Generator().manual_seed(12)
    return (
        ("resnet18thin", lambda d: ResNet18Thin(num_classes=1000, dtype=f32, norm_dtype=f32,
                                                device=d, seed=13),
         synthetic_image_batch(8, 64, 1000, generator=gen), "images", TOL_TRAIN_CONV),
        ("alexnet_w0.125", lambda d: AlexNet(1000, f32, width=0.125, image_size=224, device=d,
                                             seed=14),
         synthetic_image_batch(8, 224, 1000, generator=gen), "images", TOL_TRAIN_CONV),
        ("vit_2l_128px_p8", lambda d: ViT(vit, device=d, seed=15),
         synthetic_image_batch(2, 128, 1000, generator=gen), "images", TOL_TRAIN),
        ("bert_2l_s128", lambda d: Bert(bert, device=d, seed=16),
         synthetic_token_batch(2, 128, bert.vocab_size, generator=gen), "input_ids", TOL_TRAIN),
    )


def check_models_card_vs_cpu(torch, fa, train) -> dict:
    """Phase 9b: one float32 train step of each cut model on the card and
    on the CPU from the same weights, batch and dropout keys (step 0's)."""
    out = {}
    for name, make, batch, key, tol in cut_models(torch):
        cpu_model = make("cpu")
        weights = {k: v.clone() for k, v in cpu_model.state_dict().items()}
        result = {}
        for device in (DEVICE, "cpu"):
            model = cpu_model if device == "cpu" else make(device)
            model.load_state_dict(weights)
            state = train.state_for(model, 0.1, 0.9)
            fa.reset_launches()
            state, loss = train.make_train_step(input_key=key)(
                state, {k: v.to(device) for k, v in batch.items()})
            result[device] = loss.item(), {k: v.cpu() for k, v in model.state_dict().items()}
            if device == DEVICE:
                launches, by_design = flash_launches(fa)
                n = model.config.num_layers if key == "input_ids" or name.startswith("vit") else 0
                # float32 runs the FMA kernels 2, 3 and 4, never the tensor-core ones.
                for kernel, counts in by_design.items():
                    expect_designs(counts, "fma", n, f"{name}'s float32 step's {kernel} kernel")
        (card_loss, card_sd), (cpu_loss, cpu_sd) = result[DEVICE], result["cpu"]
        loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        errs = {k: (card_sd[k] - cpu_sd[k]).abs().max().item() for k in cpu_sd}
        worst = max(errs, key=errs.get)
        stats = [k for k in cpu_sd if k.endswith((".mean", ".var"))]
        row = {"loss_card": card_loss, "loss_cpu": cpu_loss, "loss_rel_err": loss_rel,
               "param_max_abs_err": max(v for k, v in errs.items() if k not in stats),
               "batch_stats_max_abs_err": max((errs[k] for k in stats), default=None),
               "worst_leaf": worst, "tolerance": tol, "flash_launches_by_design": by_design}
        log(f"phase 9b {name} fp32 step card vs CPU: {row}")
        if not (loss_rel <= tol and errs[worst] <= tol):
            fail(f"{name} train step card vs CPU: loss rel {loss_rel}, {worst} {errs[worst]} "
                 f"(tol {tol})")
        out[name] = row
    return out


def check_resume(torch, bench) -> dict:
    """Phase 9c: ResNet18Thin through ``benchmark.launch`` as the CLI runs
    it (an NCCL group of one, the model sharded by FSDP): trained to step 4
    with saves every 2 steps, resumed at ``--steps 4`` and then to 6, and an
    uninterrupted run to 6.  The run resumed at step 4 trains nothing, and
    its state (restored into the sharded model, gathered again) must equal
    the state saved there bit for bit, as must an unsharded restore of the
    files; the run resumed to 6 must take steps 5 and 6 as the
    uninterrupted run does, within TOL_DIST_BF16."""
    import functools

    from k8s_device_plugin_tpu_torch.models.checkpoint import CheckpointManager
    from k8s_device_plugin_tpu_torch.models.resnet import ResNet18Thin
    from k8s_device_plugin_tpu_torch.models.train import state_for

    ckpt, whole_dir = "build/checkpoints/resnet18thin", "build/checkpoints/resnet18thin-whole"
    for directory in (ckpt, whole_dir):
        shutil.rmtree(directory, ignore_errors=True)
    model_fn = functools.partial(ResNet18Thin, num_classes=1000, seed=17)

    def launch(directory, *extra):
        args = bench.parse_args(["--model=resnet50", "--batch-size=8", "--image-size=64",
                                 "--warmup=1", "--checkpoint-every=2",
                                 f"--checkpoint-dir={directory}", "--dtype=bfloat16",
                                 f"--device={DEVICE}", *extra])
        return bench.launch(args, model_fn=model_fn, gather_params=True)

    first = launch(ckpt, "--steps=4")
    again = launch(ckpt, "--resume", "--steps=4")
    restored = CheckpointManager(ckpt).restore(state_for(model_fn(device=DEVICE), 0.1, 0.9), 4)
    torch.cuda.synchronize()
    unsharded = {k: v.detach().cpu() for k, v in restored.model.state_dict().items()}
    del restored
    saved = first.state_dict
    unequal = []
    for what, got in (("sharded restore", again.state_dict), ("unsharded restore", unsharded)):
        if got.keys() != saved.keys():
            fail(f"{what}: names {sorted(got.keys() ^ saved.keys())[:5]} differ from the saved")
        unequal += [f"{what}: {k}" for k, v in saved.items() if not torch.equal(got[k], v)]
    if unequal:
        fail(f"the restored state differs from the saved one at {unequal[:5]}")
    if (again.record["resumed_from"], again.record["final_step"], again.record["noop"]) != (
            4, 4, True):
        fail(f"resume at --steps 4 trained: {again.record}")
    second = launch(ckpt, "--resume", "--steps=6")
    whole = launch(whole_dir, "--steps=6")
    if (second.record["resumed_from"], second.record["final_step"], second.record["noop"]) != (
            4, 6, False):
        fail(f"resume: resumed_from {second.record['resumed_from']}, final_step "
             f"{second.record['final_step']}")
    held = _held(torch, "9c resumed against uninterrupted", second,
                 {"losses": whole.losses[4:], "state_dict": whole.state_dict}, TOL_DIST_BF16)
    report = {"first": first.record, "resumed": second.record, "uninterrupted": whole.record,
              "steps_on_disk": CheckpointManager(ckpt).steps(),
              "tensors_compared": 2 * len(saved), "resumed_held": held,
              "path": "benchmark.launch: NCCL world of one, FSDP, sharded save and restore"}
    log(f"phase 9c resume: {report}")
    return report


# Phase 9d's shapes (b, h, s, d): ViT-B/16 at 256 px, batch 64; BERT-base at
# seq 384, batch 32; one kv head per head, non-causal.
NONCAUSAL_SHAPES = {"vit": (64, 12, 256, 64), "bert": (32, 12, 384, 64)}


# SDPA's backends, each timed alone at phase 9d's shapes.
SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_backward_kernels(torch, q, k, v, dout, what: str, iters: int = 10) -> dict:
    """SDPA's non-causal backward on these inputs: device time per call and
    the kernels the profiler saw (each with its time per call), under the
    backend SDPA picks by itself ("default", measured first and again
    last, "default_again") and under each of SDPA_BACKENDS alone
    ("refused" where it does not take the inputs).  Phase 9d records which
    kernels the yardstick ran and whether its reading holds in one run."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from k8s_device_plugin_tpu_torch.decode_profile import profiled_call

    def measure(fn) -> dict:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        try:
            stats = profiled_call(fn, iters, name_chars=200)
        except RuntimeError as err:
            fail(f"{what}: {err}")
        return {"ms": stats["device_us"] / iters / 1e3,
                "kernels": [{"kernel": t["kernel"], "us": t["us"] / iters,
                             "calls": t["calls"] / iters} for t in stats["top"][:6]]}

    out = {"default": measure(sdpa_backward(torch, q, k, v, dout, causal=False))}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            out[name.lower()] = {"ms": None, "refused": "not in this PyTorch"}
            continue
        try:
            with sdpa_kernel(backend):
                fn = sdpa_backward(torch, q, k, v, dout, causal=False)
        except RuntimeError as err:
            out[name.lower()] = {"ms": None, "refused": str(err).splitlines()[0][:160]}
            continue
        out[name.lower()] = measure(fn)
    out["default_again"] = measure(sdpa_backward(torch, q, k, v, dout, causal=False))
    return out


def time_noncausal(torch, fa) -> dict:
    """Phase 9d: kernels 2-4 at the ViT and BERT training shapes, held
    against their plain versions and timed (CUDA graph replay; the
    backward kernels also by profiler, beside SDPA's backward) with SDPA's
    forward and backward as yardsticks.  Returns {"forward"|"dq"|"dkv":
    {model: entry}}."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {"forward": {}, "dq": {}, "dkv": {}}
    for model, (B, H, S, D) in NONCAUSAL_SHAPES.items():
        q, k, v, dout = (torch.randn((B, H, S, D), generator=gen, device=dev).bfloat16()
                         for _ in range(4))
        shape = f"b{B} h{H} hk{H} s{S} d{D} non-causal bfloat16"
        opts = dict(causal=False, sm_scale=D ** -0.5, window=None)
        fa.reset_launches()
        o, lse = fa.flash_forward(q, k, v)
        expect_designs(fa.flash_attention.launches_by_design, "wgmma", 1, f"forward at {shape}")
        ref, _ = fa.flash_attention_reference(q, k, v, block_kv=128, **opts)
        fwd_err = (o.float() - ref.float()).abs().max().item()
        dq, delta = fa.launch_dq(q, k, v, o, lse, dout, **opts)
        got = (dq, *fa.launch_dkv(q, k, v, lse, delta, dout, **opts))
        want = fa.flash_attention_backward_reference(q, k, v, o, lse, dout, block_kv=128, **opts)
        rels = [rel_err(g, w) for g, w in zip(got, want)]
        log(f"phase 9d {shape}: forward max_abs_err {fwd_err:.3e} (tol {TOL_BF16}); backward "
            f"rel {rels} (tol {TOL_BWD_BF16})")
        if not (fwd_err <= TOL_BF16 and max(rels) <= TOL_BWD_BF16):
            fail(f"kernels 2-4 at {shape}: forward {fwd_err}, backward {rels}")
        pairs = B * H * S * S
        size = q.element_size()
        row, vec = B * H * S * D * size, B * H * S * 4
        sdpa_fwd = sdpa_forward(torch, q, k, v, causal=False)
        sdpa_bwd = sdpa_backward_kernels(torch, q, k, v, dout, f"SDPA's backward ({shape})")
        log(f"phase 9d SDPA backward at {shape}: {sdpa_bwd}")
        calls = {
            # kernel 2 reads q, k, v and writes o, lse: 4 d flops a pair
            "forward": (lambda: fa.flash_forward(q, k, v), 4 * row + vec, 4 * D * pairs),
            # kernel 3 reads q, dO, O, lse, k, v and writes dq, D: 6 d flops a pair
            "dq": (lambda: fa.launch_dq(q, k, v, o, lse, dout, **opts), 6 * row + 2 * vec,
                   6 * D * pairs),
            # kernel 4 reads q, dO, lse, D, k, v and writes dk, dv: 8 d flops a pair
            "dkv": (lambda: fa.launch_dkv(q, k, v, lse, delta, dout, **opts), 6 * row + 2 * vec,
                    8 * D * pairs),
        }
        plain_fwd_ms, _ = time_ms(lambda: fa.flash_attention_reference(q, k, v, block_kv=128,
                                                                        **opts), iters=5, warmup=2)
        plain_bwd_ms, _ = time_ms(lambda: fa.flash_attention_backward_reference(
            q, k, v, o, lse, dout, block_kv=128, **opts), iters=5, warmup=2)
        for kernel, (call, nbytes, flops) in calls.items():
            ms, eager = time_ms(call, iters=20)
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
            entry = {"shape": shape, "ms": ms, "eager_ms": eager, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "flops": flops,
                     "max_err": fwd_err if kernel == "forward" else max(rels)}
            if kernel == "forward":
                entry.update(plain_ms=plain_fwd_ms, library_ms=time_ms(sdpa_fwd, iters=20)[0],
                             library_note="SDPA forward, non-causal, CUDA graph replay")
            else:
                entry.update(profiled_ms=profiled_ms(torch, call, f"{kernel} ({shape})"),
                             plain_ms=plain_bwd_ms,
                             plain_note="the plain backward computes dq, dk and dv together",
                             library_ms=sdpa_bwd["default"]["ms"],
                             library_kernels=[t["kernel"] for t in sdpa_bwd["default"]["kernels"]],
                             library_by_backend={name: run["ms"] for name, run in sdpa_bwd.items()
                                                 if name != "default"},
                             library_note="SDPA backward as it dispatches by itself (profiler "
                                          "device time; compare with the dq and dk/dv rows' "
                                          "profiled_ms summed); library_kernels are the "
                                          "kernels it ran, library_by_backend each backend "
                                          "alone (null: refused) and the default again, "
                                          "last")
            out[kernel][model] = entry
            log(f"phase 9d {kernel} at {shape}: {ms:.4f} ms (bound {b_ms:.4f} {b_by}), "
                f"library {entry['library_ms']:.4f}, plain {entry['plain_ms']:.3f}")
    return out


def run_phase_9(torch, fa, pa, bench, train, smi, mark) -> tuple[dict, dict]:
    """Phases 9a-9d; returns (the train_models line, 9d's kernel entries)."""
    models = {}
    for model, flags, source in TRAIN_MODELS:
        models[model] = train_model(torch, fa, pa, bench, model, flags, source)
        torch.cuda.empty_cache()
    models["resnet50_space_to_depth"] = check_space_to_depth(torch, bench)
    torch.cuda.empty_cache()
    mark("9a_models")
    card_vs_cpu = check_models_card_vs_cpu(torch, fa, train)
    mark("9b_card_vs_cpu")
    resume = check_resume(torch, bench)
    mark("9c_resume")
    timed = time_noncausal(torch, fa)
    mark("9d_timings")
    line = {"models": models, "card_vs_cpu": card_vs_cpu, "resume": resume,
            "noncausal_kernels": timed, "card": smi}
    return line, timed


# ------------------------------------------------------------- phase 11

# deploy/k8s-pod-bert-tpu8.yaml's model and global batch (--dp=2 --mp=4 there).
DIST_FLAGS = ("--model=bert", "--batch-size=64", "--seq-len=384", "--steps=2", "--warmup=1")
# ResNet-50 at deploy/k8s-pod-resnet50-tpu4.yaml's share of one chip (its
# global batch 512 over 4), 224 px: the sharded step's channels-last conv
# kernels are made contiguous, so it is timed against the unsharded one.
RESNET_DIST_FLAGS = ("--model=resnet50", "--batch-size=128", "--image-size=224", "--steps=2",
                     "--warmup=1")
# (dp, mp) of each 11b run: BERT at mp 2, whose ranks each hold about half
# of one rank's parameter and momentum bytes; ResNet18Thin at dp 2, whose
# BatchNorm takes the global batch's moments across the ranks.  Each spawn
# costs about 20 s; both run beside phase 18d, which times nothing.
SHARED_CARD_MESHES = {"bert": (1, 2), "resnet18thin": (2, 1)}
# What gloo does not carry on CUDA tensors (PyTorch 2.11 on an H100):
# DTensor's functional collectives segfault, so 11b gathers no DTensor
# (``sharding.gather_full_state`` sends local shards through c10d) and saves
# no checkpoint.  The c10d all_reduce, all_gather_into_tensor and
# reduce_scatter_tensor that FSDP's step runs all work, so both meshes run.
GLOO_NOT_CARRIED = ("DTensor functional collectives (full_tensor, redistribute, "
                    "torch.distributed.checkpoint's full-state gather)",)


def _relative_errors(got, want) -> list:
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want)]


def _max_rel_err(torch, got: dict, want: dict) -> float:
    """The largest |got - want| / (1 + |want|) of any element: absolute for
    values under 1, relative above (AlexNet's weights grow by orders of
    magnitude at SGD 0.1 on a small batch)."""
    if set(got) != set(want):
        fail(f"state dicts name different tensors: {sorted(set(got) ^ set(want))[:5]}")
    return max(float(((got[k].float() - want[k].float()).abs()
                      / (1 + want[k].float().abs())).max()) for k in want)


def _unsharded(torch, bench, args, model=None) -> dict:
    """``args`` trained unsharded in this process: losses, final state dict
    (CPU), step ms, peak allocated bytes, parameter and momentum bytes."""
    from k8s_device_plugin_tpu_torch.parallel.sharding import local_state_bytes

    torch.cuda.reset_peak_memory_stats()
    built = bench.build(args, model)
    state, losses, dt = bench.timed_steps(built.step, built.state, built.batch, args.warmup,
                                          args.steps)
    torch.cuda.synchronize()
    out = {"losses": [l.item() for l in losses], "step_time_ms": dt / args.steps * 1e3,
           "steps_run": state.step, "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "state_bytes": local_state_bytes(state),
           "state_dict": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}
    del built, state, losses
    torch.cuda.empty_cache()
    return out


def _held(torch, what: str, run, want: dict, tol: float) -> dict:
    """A sharded run's losses and final state against an unsharded run's."""
    if len(run.losses) != len(want["losses"]):
        fail(f"{what}: {len(run.losses)} steps against {len(want['losses'])}")
    loss_err = max(_relative_errors(run.losses, want["losses"]))
    param_err = _max_rel_err(torch, run.state_dict, want["state_dict"])
    log(f"phase {what}: loss rel err {loss_err:.3g}, param rel err {param_err:.3g} "
        f"(tol {tol}); losses {run.losses}")
    if not loss_err <= tol or not param_err <= tol:
        fail(f"{what}: the sharded run parts from the unsharded one (loss rel {loss_err}, "
             f"params rel {param_err}, tolerance {tol})")
    return {"loss_rel_err": loss_err, "param_rel_err": param_err, "tolerance": tol,
            "losses": run.losses}


def run_phase_11(torch, fa, bench, smi, mark, after_11a=None) -> tuple[dict, dict]:
    """Phase 11a; returns (the distributed line, its launches).
    ``after_11a`` runs after it (the gloo ranks of phases 13d-15b start
    there)."""
    from k8s_device_plugin_tpu_torch.models.bert import BertConfig

    args = bench.parse_args([*DIST_FLAGS, "--dp=1", "--mp=1", "--dtype=bfloat16",
                             f"--device={DEVICE}"])
    plain = _unsharded(torch, bench, args)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    run = bench.launch(args, gather_params=True)
    torch.cuda.synchronize()
    launches, by_design = flash_launches(fa)
    sharded_peak = torch.cuda.max_memory_allocated()
    steps = run.record["final_step"]
    layers = BertConfig.base().num_layers
    for name, count in launches.items():
        if count != layers * steps:
            fail(f"the sharded BERT run launched {name} {count} times, not {layers} layers x "
                 f"{steps} steps")
    for kernel, counts in by_design.items():
        expect_designs(counts, "wgmma", layers * steps, f"the sharded BERT run's {kernel} kernel")
    world_of_one = {
        "flags": [*DIST_FLAGS, "--dp=1", "--mp=1"],
        "backend": "nccl", "world": run.record["chips"], "mesh": {"dp": 1, "mp": 1},
        "record": run.record,
        "held": _held(torch, "11a world of one", run, plain, TOL_DIST_BF16),
        "sharded_step_ms": run.record["step_time_ms"],
        "unsharded_step_ms": plain["step_time_ms"],
        "sharded_max_memory_allocated": sharded_peak,
        "unsharded_max_memory_allocated": plain["max_memory_allocated"],
        "rank_bytes": run.rank_bytes,
        "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
    }
    log(f"phase 11a: {world_of_one}")
    torch.cuda.empty_cache()

    args = bench.parse_args([*RESNET_DIST_FLAGS, "--dp=1", "--mp=1", "--dtype=bfloat16",
                             f"--device={DEVICE}"])
    plain = _unsharded(torch, bench, args)
    torch.cuda.reset_peak_memory_stats()
    run = bench.launch(args, gather_params=True)
    torch.cuda.synchronize()
    resnet_world_of_one = {
        "flags": [*RESNET_DIST_FLAGS, "--dp=1", "--mp=1"],
        "backend": "nccl", "world": run.record["chips"], "mesh": {"dp": 1, "mp": 1},
        "record": run.record,
        "held": _held(torch, "11a ResNet-50 world of one", run, plain, TOL_DIST_BF16),
        "sharded_step_ms": run.record["step_time_ms"],
        "unsharded_step_ms": plain["step_time_ms"],
        "sharded_max_memory_allocated": torch.cuda.max_memory_allocated(),
        "unsharded_max_memory_allocated": plain["max_memory_allocated"],
        "rank_bytes": run.rank_bytes,
    }
    del run, plain
    torch.cuda.empty_cache()
    log(f"phase 11a ResNet-50: {resnet_world_of_one}")
    mark("11a_world_of_one")
    if after_11a is not None:
        after_11a()

    line = {"world_of_one": world_of_one, "resnet50_world_of_one": resnet_world_of_one,
            "card": smi}
    return line, launches


def start_phase_11b(torch, bench) -> dict:
    """Phase 11b's one-rank runs in this process, float32, then its
    two-rank runs (``benchmark.launch`` over gloo, two ranks sharing the
    card) on a thread: they run beside what this process does until
    :func:`run_phase_11b` joins them."""
    import functools
    import threading

    from k8s_device_plugin_tpu_torch.models.bert import Bert, BertConfig
    from k8s_device_plugin_tpu_torch.models.resnet import ResNet18Thin

    cut = {
        "bert": (["--model=bert", "--seq-len=128", "--batch-size=8"], functools.partial(
            Bert, BertConfig(num_layers=2, dtype=torch.float32))),
        # 10 classes, float32 statistics.
        "resnet18thin": (["--model=resnet50", "--image-size=64", "--batch-size=16"],
                         functools.partial(ResNet18Thin, num_classes=10, dtype=torch.float32,
                                           norm_dtype=torch.float32, seed=3)),
    }
    jobs = {}
    for model, (flags, model_fn) in cut.items():
        base = [*flags, "--steps=1", "--warmup=1", "--dtype=float32", f"--device={DEVICE}"]
        one = _unsharded(torch, bench, bench.parse_args([*base, "--dp=1", "--mp=1"]),
                         model_fn(device=torch.device(DEVICE)))
        jobs[model] = (base, model_fn, one)
    started = {"jobs": jobs, "runs": {}, "errors": []}

    def spawn():
        try:
            for model, (base, model_fn, _) in jobs.items():
                dp_, mp_ = SHARED_CARD_MESHES[model]
                t0 = time.perf_counter()
                run = bench.launch(bench.parse_args([*base, f"--dp={dp_}", f"--mp={mp_}"]),
                                   backend="gloo", local_ranks=2, model_fn=model_fn,
                                   gather_params=True)
                started["runs"][model] = (run, time.perf_counter() - t0)
        except BaseException as e:  # reported by run_phase_11b
            started["errors"].append(e)

    started["thread"] = threading.Thread(target=spawn, name="phase-11b", daemon=True)
    started["thread"].start()
    return started


def run_phase_11b(torch, started: dict, smi) -> dict:
    """Phase 11b: wait for :func:`start_phase_11b`'s ranks, then hold
    each two-rank run against its one-rank run (TOL_DIST_F32) and, at mp 2,
    each rank's share of one rank's parameter and momentum bytes."""
    t0 = time.perf_counter()
    started["thread"].join()
    waited = time.perf_counter() - t0
    if started["errors"]:
        fail(f"phase 11b's ranks failed: {started['errors'][0]!r}")
    shared = {}
    for model, (base, _, one) in started["jobs"].items():
        dp_, mp_ = SHARED_CARD_MESHES[model]
        run, wall = started["runs"][model]
        share = max(run.rank_bytes) / one["state_bytes"]
        if mp_ == 2 and share > 0.6:
            fail(f"{model} at mp 2 holds {share:.3f} of one rank's parameter and momentum "
                 "bytes a rank, not about half")
        shared[model] = {
            "flags": base, "unsharded_step_ms": one["step_time_ms"],
            "one_rank_bytes": one["state_bytes"],
            f"dp{dp_}_mp{mp_}": {
                "held": _held(torch, f"11b {model} dp{dp_} mp{mp_}", run, one, TOL_DIST_F32),
                "rank_bytes": run.rank_bytes, "share_of_one_rank_bytes": share,
                "staged_step_ms": run.record["step_time_ms"], "launch_wall_s": wall,
            },
        }
        log(f"phase 11b {model}: {shared[model]}")
    return {"backend": "gloo", "world": 2, "ranks_per_card": 2,
            "meshes": {k: {"dp": d, "mp": m} for k, (d, m) in SHARED_CARD_MESHES.items()},
            "gloo_not_carried": list(GLOO_NOT_CARRIED),
            "times": "staged through host memory by gloo, beside phase 18d: not a speed",
            "joined_after_s": waited, "card": smi, **shared}


# ------------------------------------------------- phases 4h, 5b and 4i

# The deployed model's logits come from bf16 activations through the
# float32 head: two computations of one step (the verify pass's gathered
# pages against the paged kernel, a merged kernel against the base plus an
# adapter's delta) differ by a few hundredths.  A greedy stream may part
# from its reference only where the reference's top-2 margin is under this.
TOL_MARGIN_BF16 = 0.1
# A merged bf16 kernel (W + delta rounded to bf16) is other weights than W
# and the delta kept apart: at 8 layers that moves the logits by up to about
# a tenth (phase 4i reports the measured gap beside each check).
TOL_MARGIN_MERGED = 0.25
SPEC_JOBS = 8  # phase 4h: prompt 128 (half share a 64-token prefix), 128 new
# The pod manifest's flags (deploy/k8s-pod-serve-http.yaml) at the latency
# variant it names, --slots 2 --spec-gamma 2 (decode block 1 under it).
POD_SPEC_FLAGS = (
    "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--page-size=16",
    "--num-pages=512", "--max-pages-per-seq=32", "--slots=2", "--spec-gamma=2",
    "--kv-retain=1", "--kv-host-cache-mb=512", "--overload=1", "--slo=1", "--watchdog=1",
    "--snapshot-interval=60",
)
LORA_RANK, LORA_ADAPTERS = 8, 4
# lora_b's std: each adapter's delta moves some logit by several tenths or
# more (phase 4i reports the shift), well above the limits that hold it.
LORA_B_STD = 0.08
# The bf16 multi-LoRA model's logits against a float32 model of plain
# x·W + (alpha/rank)·(x·A)·B sites over the same weights: bf16 rounding
# over 8 layers.  Each adapter's measured shift must be 4x this or more.
TOL_LORA_F32 = 0.25
LORA_COST_ADAPTERS = (4, 32)  # 4i's count, and tens of tenants


def hold_streams(torch, tf, model, jobs, got, want, what: str,
                 tol: float = TOL_MARGIN_BF16) -> dict:
    """Greedy streams ``got`` against the reference's ``want`` (computed on
    ``model``'s weights): equal, or at a request's first difference the
    reference's top-2 margin there (the dense cached append over the prompt
    and ``want``'s tokens so far, as a decode step attends) is under
    ``tol``, past which the two legitimately part."""
    checked, ties = 0, []
    for job, a, b in zip(jobs, got, want):
        if len(a) != len(b):
            fail(f"{what}: a request returned {len(a)} tokens against {len(b)}")
        for j, (x, y) in enumerate(zip(a, b)):
            checked += 1
            if x == y:
                continue
            with torch.no_grad():
                ids = torch.tensor([list(job[0]) + list(b[:j])], device=DEVICE)
                cache = tf.DenseCache.zeros(model.config, 1, DEVICE, max_seq=ids.shape[1])
                top2 = model(ids, cache=cache, append_mode="cached")[0, -1].topk(2).values
            margin = float(top2[0] - top2[1])
            if margin >= tol:
                fail(f"{what}: token {j} differs ({x} vs {y}) where the reference's top-2 "
                     f"margin is {margin}")
            ties.append({"token": j, "margin": margin})
            break
    return {"checked": checked, "near_ties": ties, "tolerance": tol}












def run_speculation(torch, http_server, pa) -> dict:
    """Phase 4h: the HTTP server at the pod's flags with --slots 2
    --spec-gamma 2 against its in-process twin: equal greedy tokens.  The
    twin's draft steps launch kernel 1 exactly layers x gamma x rounds (the
    launch counters set to 0 just before its run), its verify pass none
    (the ``kernel.fallback`` flight event names ``spec_verify``), and its
    rounds replay CUDA graphs."""
    import os
    import pathlib

    from k8s_device_plugin_tpu_torch.models.engine import synthetic_jobs

    jobs = synthetic_jobs(SPEC_JOBS, 128, 128, 32000)
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    args = http_server.parse_args([*POD_SPEC_FLAGS, f"--device={DEVICE}"])
    twin = http_server.build_engine(args)
    twin.run([(p, 32) for p, _ in jobs[:2]])
    rounds0 = twin.spec_rounds
    pa.reset_launches()
    t0 = time.perf_counter()
    done = twin.run(jobs)
    torch.cuda.synchronize()
    inproc = engine_latency(done, time.perf_counter() - t0)
    launches = dict(pa.paged_attention.launches_by_format)
    rounds = twin.spec_rounds - rounds0
    if launches["f"] != args.layers * args.spec_gamma * rounds or launches["int8"] or \
            launches["int4"] or rounds <= 0:
        fail(f"the spec twin launched kernel 1 {launches} times over {rounds} rounds of gamma "
             f"{args.spec_gamma}, not {args.layers} layers x gamma x rounds")
    fallback = twin.flight.window(kinds=["kernel.fallback"])
    if not fallback or fallback[0]["reason"] != "spec_verify":
        fail("the spec twin recorded no kernel.fallback flight event with reason spec_verify")
    if twin.graph_replays <= 0:
        fail("the spec twin's rounds never replayed a CUDA graph")
    want = [r.tokens for r in done]
    del twin, done
    torch.cuda.empty_cache()
    log_dir = root / "build" / "logs"
    log_dir.mkdir(parents=True, exist_ok=True)
    served = serve_once(POD_SPEC_FLAGS, jobs, log_dir / "spec_http.log", env, sampled=False)
    got = [r["tokens"] for r in served["results"]]
    if got != want:
        fail(f"spec HTTP tokens differ from the in-process engine's at "
             f"{first_difference(got, want)}")
    report = {"flags": list(POD_SPEC_FLAGS), "requests": SPEC_JOBS,
              "tokens_equal_in_process": True, "client": served["client"],
              "in_process": inproc, "device": served["device"],
              "profile": served["traffic_profile"], "drain_s": served["drain_s"],
              "summary": served["summary"], "twin_rounds": rounds,
              "main_path_launches": launches["f"]}
    log(f"phase 4h: {report}")
    return report


def run_dense_spec(torch, tf, fa, pa, quant) -> dict:
    """Phase 5b: speculative_generate at batch 1 (prompt 128, 128 new,
    gamma 2, the w8 self-draft) against greedy_generate: the same tokens
    (margin rule), the flash forward launched (the target's and the draft's
    bulk prefill) as its tensor-core variant only; tokens/s of each, with
    each call's model builds timed apart."""
    from k8s_device_plugin_tpu_torch.models import speculative

    cfg = tf.GPTConfig(vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16,
                       intermediate_size=3072, max_seq=512, num_kv_heads=4)
    params = tf.init_params(cfg, seed=0)
    dcfg = dataclasses.replace(cfg, quant="w8")
    dparams = quant.quantize_lm_params(params)
    prompt = torch.randint(0, 32000, (1, 128), generator=torch.Generator().manual_seed(5))

    def build_s(c, p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = tf.TransformerLM(c, device=DEVICE)
        model.load_state_dict(p)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, model

    # Warm: kernel builds and first launches stay out of both timings.
    tf.greedy_generate(cfg, params, prompt, 2, device=DEVICE)
    speculative.speculative_generate(cfg, params, dcfg, dparams, prompt, 4, gamma=2,
                                     device=DEVICE)
    target_build, model = build_s(cfg, params)
    draft_build, _ = build_s(dcfg, dparams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tf.greedy_generate(cfg, params, prompt, 128, device=DEVICE)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    pa.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    seq, acc = speculative.speculative_generate(cfg, params, dcfg, dparams, prompt, 128, gamma=2,
                                                device=DEVICE)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    if launches != 2 * cfg.num_layers:
        fail(f"speculative_generate's prefills launched the flash kernel {launches} times, not "
             f"once per layer of the target and the draft")
    expect_designs(fa.flash_attention.launches_by_design, "wgmma", launches,
                   "speculative_generate's bf16 prefill")
    if tuple(seq.shape) != (1, 256) or not torch.equal(seq[:, :128].cpu(), prompt):
        fail(f"speculative_generate returned {tuple(seq.shape)} or altered the prompt")
    held = hold_streams(torch, tf, model, [(prompt[0].tolist(), 128)], [seq[0, 128:].tolist()],
                        [want[0, 128:].tolist()], "speculative_generate against greedy_generate")
    greedy_tps = 128 / (greedy_s - target_build)
    spec_tps = 128 / (spec_s - target_build - draft_build)
    out = {"flash_launches": launches, "paged_launches": dict(pa.paged_attention.launches_by_format),
           "acceptance": float(acc.float().mean()), "tokens_equal": held,
           "greedy_s": greedy_s, "spec_s": spec_s, "target_build_s": target_build,
           "draft_build_s": draft_build, "greedy_tokens_per_s": greedy_tps,
           "spec_tokens_per_s": spec_tps, "speedup": spec_tps / greedy_tps}
    log(f"phase 5b: {out}")
    return out


def write_adapters(torch, tf, ckpt, root) -> tuple:
    """LORA_ADAPTERS adapter directories (the port's CheckpointManager) of
    rank-LORA_RANK trees at the deployed widths, seeded: ``lora_a`` normal
    with variance 1/fan_in, ``lora_b`` normal at LORA_B_STD (not zero, so
    each adapter changes the tokens).  Only the adapter leaves are written:
    the server stacks them over its own base weights."""
    cfg = tf.GPTConfig(vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16,
                       intermediate_size=3072, max_seq=512, num_kv_heads=4, lora_rank=LORA_RANK)
    shapes = {k: v for k, v in tf.param_shapes(cfg).items() if ".lora_" in k}
    dirs, trees = [], []
    for i in range(LORA_ADAPTERS):
        gen = torch.Generator().manual_seed(100 + i)
        tree = {}
        for name, shape in shapes.items():
            scale = LORA_B_STD if ".lora_b" in name else math.prod(shape[:-1]) ** -0.5
            tree[name] = torch.randn(shape, generator=gen) * scale
        path = root / "build" / "adapters" / f"adapter_{i}"
        shutil.rmtree(path, ignore_errors=True)
        ckpt.CheckpointManager(path).save(tree, 0)
        dirs.append(str(path))
        trees.append(tree)
    return dirs, trees


def adapter_effect(torch, tf, model, prompt) -> dict:
    """One prompt's last-position logits on the multi-LoRA ``model``
    under every adapter and none, in one batch (rows -1, 0, .., n-1),
    against a float32 model of plain LoRA sites (``LoRADense``:
    x·W + (alpha/rank)·(x·A)·B) on the same weights, adapter by adapter.
    Fails where the card's logits part from the float32 ones by
    TOL_LORA_F32 or more, or where an adapter shifts the float32 logits by
    less than 4 x TOL_LORA_F32 (the check would then not see the adapter
    ignored)."""
    cfg = model.config
    ref = tf.TransformerLM(dataclasses.replace(cfg, dtype=torch.float32, lora_serve=0), DEVICE)
    served = model.state_dict()
    n = cfg.lora_serve
    want = []
    with torch.no_grad():
        ids = torch.tensor([list(prompt)] * (n + 1), device=DEVICE)
        got = model(ids, adapter_ids=torch.arange(-1, n, device=DEVICE))[:, -1].float()
        for i in range(-1, n):
            tree = {}
            for name, value in served.items():
                if name.endswith("_stack"):
                    leaf = name[: -len("_stack")]
                    value = value[max(i, 0)]
                    tree[leaf] = torch.zeros_like(value) if i < 0 and ".lora_b" in leaf else value
                else:
                    tree[name] = value
            ref.load_state_dict({k: v.float() for k, v in tree.items()})
            want.append(ref(ids[:1])[0, -1])
    want = torch.stack(want)
    err = (got - want).abs().amax(dim=-1).tolist()
    shift = (want[1:] - want[0]).abs().amax(dim=-1).tolist()
    out = {"max_abs_err_vs_float32": err, "adapter_logit_shift": shift,
           "tolerance": TOL_LORA_F32, "rows": list(range(-1, n))}
    if max(err) >= TOL_LORA_F32:
        fail(f"multi-LoRA logits part from the float32 plain sites: {out}")
    if min(shift) < 4 * TOL_LORA_F32:
        fail(f"an adapter moves the logits too little for the check to see it: {out}")
    del ref
    return out


def gather_site(torch, mod, x, adapter_ids):
    """The reference's per-row multi-LoRA site (the JAX package's
    ``MultiLoRADense``): clamp the ids, gather each row's adapter, two
    batched products, -1 rows gated off.  Timed beside the port's site
    only."""
    batch = x.shape[0]
    keep = x.shape[1 : x.dim() - len(mod.in_shape)]
    n_in, n_out = math.prod(mod.in_shape), math.prod(mod.features)
    xd = x.reshape(batch, -1, n_in).to(mod.dtype)
    base = xd @ mod.kernel.reshape(n_in, n_out)
    ids = adapter_ids.long().clamp(min=0)
    a = mod.lora_a_stack.reshape(mod.n_adapters, n_in, mod.rank)[ids]
    b = mod.lora_b_stack.reshape(mod.n_adapters, mod.rank, n_out)[ids]
    gate = (adapter_ids >= 0).to(mod.dtype) * (mod.alpha / mod.rank)
    out = base + gate[:, None, None] * torch.bmm(torch.bmm(xd, a), b)
    return out.reshape(batch, *keep, *mod.features)


def lora_site_costs(torch, tf, lora) -> dict:
    """Device time (profiler) of one pass over the deployed model's dense
    sites (every projection and the head), the products a step runs beside
    attention: plain sites against multi-LoRA sites over LORA_COST_ADAPTERS
    stacked rank-8 adapters (the port's stacked products), and the
    reference's per-row gather at the larger count, at a decode step's 8
    rows (4i's slots, each on another adapter or none) and a 256-position
    prefill (two prompts of 128 on two adapters)."""
    widths = dict(vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16,
                  intermediate_size=3072, max_seq=512, num_kv_heads=4)
    models = {0: tf.TransformerLM(tf.GPTConfig(**widths), DEVICE)}
    for n in LORA_COST_ADAPTERS:
        models[n] = tf.TransformerLM(
            tf.GPTConfig(**widths, lora_rank=LORA_RANK, lora_serve=n), DEVICE)
    sites = {}
    with torch.no_grad():
        for n, m in models.items():
            for p in m.parameters():
                p.normal_(0.0, 0.02)
            sites[n] = [mod for mod in m.modules()
                        if isinstance(mod, (tf.DenseGeneral, lora.MultiLoRADense))]
    top = max(LORA_COST_ADAPTERS)
    out = {"sites": len(sites[0]), "rank": LORA_RANK}
    for label, lead, rows_ids in (
        ("decode_8_rows", (8, 1), lambda n: [-1] + [(i * n) // 7 for i in range(7)]),
        ("prefill_256_positions", (2, 128), lambda n: [0, n - 1]),
    ):
        xs = [torch.randn(*lead, *mod.in_shape, device=DEVICE, dtype=mod.dtype)
              for mod in sites[0]]
        ids = {n: torch.tensor(rows_ids(n), device=DEVICE) for n in LORA_COST_ADAPTERS}
        calls = {"plain": lambda: [mod(x) for mod, x in zip(sites[0], xs)]}
        for n in LORA_COST_ADAPTERS:
            calls[f"stacked_{n}"] = (lambda n=n: [lora.site_call(mod, x, ids[n])
                                                  for mod, x in zip(sites[n], xs)])
        calls[f"gather_{top}"] = lambda: [gather_site(torch, mod, x, ids[top])
                                          for mod, x in zip(sites[top], xs)]
        with torch.no_grad():
            out[label] = {name: profiled_ms(torch, call, f"LoRA sites {name} {label}",
                                            iters=5, warmup=2)
                          for name, call in calls.items()}
    del models, sites
    torch.cuda.empty_cache()
    log(f"phase 4i LoRA site costs (device ms a pass over the sites): {out}")
    return out


def run_multi_lora(torch, tf, http_server, serve: dict) -> dict:
    """Phase 4i: the HTTP server at phase 4e's deployment flags plus
    --adapters over four rank-8 adapter directories, phase 4e's 32
    requests with "adapter" cycling none, 0, 1, 2, 3: tokens equal an
    in-process engine on the same stacked tree, and (margin rule) a
    single-model engine on each adapter's merge_lora_params; one prompt
    under adapters 0, 0, 1 and none shares pages only between the two
    0s, and decodes three different streams; the logits hold against
    float32 plain LoRA sites (``adapter_effect``); an adapter out of range
    answers 422; paged launches = layers x steps; the sites' device time
    (``lora_site_costs``)."""
    import os
    import pathlib

    from k8s_device_plugin_tpu_torch.models import checkpoint as ckpt
    from k8s_device_plugin_tpu_torch.models import lora
    from k8s_device_plugin_tpu_torch.models.engine import synthetic_jobs

    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    dirs, trees = write_adapters(torch, tf, ckpt, root)
    flags = (*SERVE_FLAGS, f"--adapters={','.join(dirs)}", f"--lora-rank={LORA_RANK}")
    cycle = (None, 0, 1, 2, 3)
    jobs = [(p, n) if cycle[i % 5] is None else (p, n, {"adapter": cycle[i % 5]})
            for i, (p, n) in enumerate(synthetic_jobs(32, 128, 128, 32000))]

    def aid(job):
        return job[2]["adapter"] if len(job) > 2 else None

    # The in-process twin; first, one prompt under adapters 0, 0, 1 and
    # none in one burst: the two adapter-0 requests share its full pages,
    # adapter 1 and the base model share none of them; over 32 tokens the
    # two adapter-0 streams are equal and those of adapter 0, adapter 1 and
    # none all differ.
    twin = http_server.build_engine(http_server.parse_args([*flags, f"--device={DEVICE}"]))
    prompt = jobs[0][0]
    probe = [twin.submit(prompt, 32, adapter=a) for a in (0, 0, 1, None)]
    twin.step()
    pages = [twin._slot_pages[s][:8] for s in range(4)]
    if pages[0] != pages[1] or set(pages[0]) & (set(pages[2]) | set(pages[3])):
        fail(f"the prefix trie crossed adapters: slot pages {pages}")
    while not all(r.done for r in probe):
        twin.step()
    probe_streams = [r.tokens for r in probe]
    if probe_streams[0] != probe_streams[1] or len(
            {tuple(t) for t in probe_streams[1:]}) != 3:
        fail(f"one prompt under adapters 0, 0, 1 and none: {probe_streams}")
    effect = adapter_effect(torch, tf, twin.model, prompt)
    twin.kvcache_clear()
    twin.run([(p, 32) for p, *_ in jobs[:2]])
    reqs = [twin.submit(j[0], j[1], adapter=aid(j)) for j in jobs]
    t0 = time.perf_counter()
    while not all(r.done for r in reqs):
        twin.step()
    torch.cuda.synchronize()
    inproc = engine_latency(reqs, time.perf_counter() - t0)
    want = [r.tokens for r in reqs]
    lora_model = twin.model
    del twin, reqs
    torch.cuda.empty_cache()

    def bad_adapter(port):
        status, body = http_call(port, "/generate", {"prompt": prompt, "max_new_tokens": 2,
                                                     "adapter": LORA_ADAPTERS})
        if status != 422:
            fail(f"an adapter out of range answered {status}, not 422: {body}")
        return {"status": status, "body": body}

    log_dir = root / "build" / "logs"
    log_dir.mkdir(parents=True, exist_ok=True)
    served = serve_once(flags, jobs, log_dir / "lora_http.log", env, sampled=False,
                        probe=bad_adapter)
    got = [r["tokens"] for r in served["results"]]
    if got != want:
        fail(f"multi-LoRA HTTP tokens differ from the in-process engine's at "
             f"{first_difference(got, want)}")

    # Each adapter's requests on a single-model engine over its merged
    # weights (loaded in place, so the engine's graphs stay valid).
    plain = http_server.build_engine(http_server.parse_args([*SERVE_FLAGS, f"--device={DEVICE}"]))
    base = tf.init_params(tf.GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16, intermediate_size=3072,
        max_seq=512, num_kv_heads=4), seed=0)
    merged_held = {}
    for a in cycle:
        plain.kvcache_clear()
        weights = base if a is None else lora.merge_lora_params({**base, **trees[a]}, alpha=16.0)
        plain.model.load_state_dict(weights)
        idx = [i for i, j in enumerate(jobs) if aid(j) == a]
        done = plain.run([jobs[i][:2] for i in idx])
        merged_held[str(a)] = hold_streams(
            torch, tf, plain.model, [jobs[i] for i in idx], [got[i] for i in idx],
            [r.tokens for r in done], f"adapter {a} against its merged single model",
            tol=TOL_MARGIN_MERGED)
        # The two computations' logits over one request's prompt and first
        # 64 tokens: how far merging moves them.
        with torch.no_grad():
            ids = torch.tensor([jobs[idx[0]][0] + done[0].tokens[:64]], device=DEVICE)
            aids = torch.tensor([-1 if a is None else a], device=DEVICE)
            gap = (lora_model(ids, adapter_ids=aids) - plain.model(ids)).abs().max()
        merged_held[str(a)]["max_logit_gap"] = float(gap)
    del plain, lora_model
    torch.cuda.empty_cache()
    e = served["client"]
    ref = serve["http_512"]["client"]
    report = {
        "flags": list(flags), "adapters": LORA_ADAPTERS, "rank": LORA_RANK,
        "lora_b_std": LORA_B_STD, "client": e, "in_process": inproc,
        "no_adapter_http_512": {k: ref[k] for k in ("tokens_per_s", "ttft_ms", "itl_ms")},
        "tokens_per_s_vs_no_adapter": e["tokens_per_s"] / ref["tokens_per_s"],
        "device": served["device"], "profile": served["traffic_profile"],
        "preemptions": served["preemptions"], "drain_s": served["drain_s"],
        "merged_single_models": merged_held, "out_of_range": served["probe"],
        "trie_pages_disjoint_across_adapters": True, "probe_streams_differ": True,
        "logits_vs_float32": effect, "site_costs": lora_site_costs(torch, tf, lora),
    }
    log(f"phase 4i: {report}")
    return report


# ---------------------------------------------------------------- phase 10

# The reference's run_serving record (k8s_device_plugin_tpu/models/
# benchmark.py), key for key; tests/test_torch_benchmark_serving.py holds
# the port's to it on the CPU.
SERVING_KEYS = (
    "model", "chips", "slots", "requests", "prompt_len", "new_tokens", "throughput", "unit",
    "overlap", "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms", "kvcache", "tp",
    "kernels", "overload", "restart", "elastic", "disagg", "router", "fabric", "slo", "canary",
    "autoscale", "postmortem", "trace", "spans_recorded", "profile",
)
# Printed null on one card: tensor parallelism (as the reference's on one
# device).
SERVING_NULL = ("tp",)
# The router-side phases' tiny replicas (GPTConfig.tiny(): 2 layers) and
# the device steps they report under ``extras["device_steps"]``.
ROUTER_PHASES = ("router", "fabric", "canary", "postmortem")
# The kernels phase's arms against the gather arm: float32 shapes by sum
# order, bf16 queries (bf16, int8 and int4 pools) by bf16 rounding, as
# phase 3 holds the kernel against its plain version in every format.
KERNEL_ARM_TOL = {"f32": TOL_F32, "bf16": TOL_BF16, "int8": TOL_BF16, "int4": TOL_BF16}
LORA_RANK, LORA_ALPHA = 8, 16.0  # phase 4i's adapters' rank


def check_engine_paged(torch, pa, tuning, cfg, slots: int, prompt_len: int,
                       new_tokens: int) -> dict:
    """Kernel 1 against its plain version at the serving engine's geometry
    (``run_serving``'s page 16, ``slots`` rows, a row's pages covering
    prompt plus new tokens, bf16 queries and pools, the tuned split count
    the engine's default routing takes), over lens from the first decode
    step (prompt + 1) to the last: the rows the main path's decode steps
    give it."""
    dev = torch.device(DEVICE)
    page = 16
    mpp = -(-(prompt_len + new_tokens) // page)
    n_pages = slots * mpp + 1
    splits = tuning.pick_num_splits(mpp, tuning.device_generation(dev))
    gen = torch.Generator(device=dev).manual_seed(11)
    heads, kv_heads, head_dim = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    first, last = prompt_len + 1, prompt_len + new_tokens
    worst = 0.0
    for draw in range(3):
        if draw == 0:  # both ends, a page boundary and a partial page
            lens = [first, last, first + page * (slots // 2) - 1, (first + last) // 2][:slots]
            lens += [last] * (slots - len(lens))
        else:
            lens = torch.randint(first, last + 1, (slots,), generator=gen, device=dev).tolist()
        q = torch.randn((slots, heads, head_dim), generator=gen, device=dev).to(torch.bfloat16)
        pools = {name: torch.randn((n_pages, page, kv_heads, head_dim), generator=gen,
                                   device=dev).to(torch.bfloat16) for name in ("pool_k", "pool_v")}
        table = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1)
        table = table.reshape(slots, mpp).to(torch.int32)
        err = hold_paged(torch, pa, q, pools, table,
                         torch.tensor(lens, dtype=torch.int32, device=dev),
                         window=cfg.attention_window, splits=splits, kv_format="f")
        log(f"phase 10a kernel 1 at the engine's geometry (B{slots} H{heads} Hk{kv_heads} "
            f"D{head_dim} page {page}, {mpp} pages a row, {splits} splits, lens {lens}): "
            f"max_abs_err {err:.3e} (tol {TOL_BF16})")
        if not err <= TOL_BF16:
            fail(f"paged_attention at the serving engine's geometry, lens {lens}: "
                 f"{err} > {TOL_BF16}")
        worst = max(worst, err)
    return {"shape": f"B{slots} H{heads} Hk{kv_heads} D{head_dim} page{page} mpp{mpp} "
                     f"splits{splits} lens{first}..{last} bf16 q and pools",
            "max_abs_err": worst, "tolerance": TOL_BF16}


def check_router_blocks(record) -> None:
    """Phase 10a's router-side blocks, from tiny replicas on the card behind
    the port's router: affinity's KV hits a request above random's, no
    stream dropped in any pass, the injected corruption detected and
    fenced, the injected watchdog fence captured and classified, and the
    controller's simulation passing the serving gate's autoscale verdicts."""
    router, fabric, canary = record["router"], record["fabric"], record["canary"]
    postmortem = record["postmortem"]
    if not router["affinity"]["hit_rate"] > router["random"]["hit_rate"]:
        fail(f"10a router: affinity's KV hits a request do not exceed random's: {router}")
    dropped = {"router": [router["affinity"]["dropped"], router["random"]["dropped"]],
               "fabric": [fabric["fabric"]["dropped"], fabric["control"]["dropped"]],
               "canary": [canary["dropped"]], "postmortem": [postmortem["dropped"]]}
    if any(n for passes in dropped.values() for n in passes):
        fail(f"10a: streams dropped through the router: {dropped}")
    if not (canary["mismatch_detected"] and canary["fences"] >= 1):
        fail(f"10a canary: the injected corruption was not detected and fenced: {canary}")
    if not (postmortem["bundle_found"] and postmortem["root_cause"] == "watchdog_hang"):
        fail(f"10a postmortem: the injected watchdog fence was not captured and classified "
             f"watchdog_hang: {postmortem}")
    # The serving gate's two autoscale verdicts (tools/bench_diff.py): the
    # controller bills fewer replica-minutes than the static peak fleet
    # and violates no SLO second.  The block is host-side simulation; the
    # CPU tests hold it against the reference's value for value.
    ctrl, static = record["autoscale"]["controller"], record["autoscale"]["static_peak"]
    if not (ctrl["replica_minutes"] < static["replica_minutes"] and ctrl["slo_violations"] == 0
            and ctrl["actions"] > 0):
        fail(f"10a autoscale: REPLICA-MINUTES-REGRESSED or AUTOSCALE-SLO-VIOLATED, or no "
             f"action: {record['autoscale']}")


def run_serving_bench(torch, bench, pa, fa, tuning) -> dict:
    """Phase 10a: ``benchmark.py --model serving`` at the reference's
    defaults on the card (full-width ``gpt_config``, bf16, 4 slots, 16
    requests, prompt 64, 128 new, the kernels phase on), the launch
    counters set to 0 just before the call; then kernel 1 against its
    plain version at the engines' geometry (``check_engine_paged``)."""
    args = bench.parse_args(["--model=serving", f"--device={DEVICE}"])
    pa.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    run = bench.run_serving(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.paged_attention.launches_by_format)
    record, extras = run.record, run.extras
    log(f"phase 10a serving benchmark ({wall:.1f}s): {json.dumps(record)}; device steps "
        f"{extras['device_steps']}, graphs {extras['graphs']}, paged launches {launches}")
    if tuple(record) != SERVING_KEYS:
        fail(f"the serving record's keys {list(record)} are not the reference's")
    if tuple(k for k, v in record.items() if v is None) != SERVING_NULL:
        fail(f"the serving record's null blocks are not {SERVING_NULL}")
    kernels = extras["kernels"]
    steps = extras["device_steps"]
    layers = bench.gpt_config(args).num_layers
    tiny_layers = bench.GPTConfig.tiny().num_layers
    # The count's change over each router-side phase (run_serving reads it
    # around the phase, while the main engine is idle) is its tiny replicas'
    # launches; what is left after the kernels phase is the engines'.
    replica_launches = extras["paged_launches"]
    engine_launches = {fmt: n - kernels["launches"][fmt]
                       - sum(replica_launches[name][fmt] for name in ROUTER_PHASES)
                       for fmt, n in launches.items()}
    # Once per layer on every dispatched step of both engines (the main one
    # and the disagg phase's decode role) and of the router-side phases'
    # tiny replicas (float32 pools, the same count): no int8 or int4 pool.
    want = layers * (steps["main"] + steps["disagg_decode"])
    if engine_launches != {"f": want, "int8": 0, "int4": 0}:
        fail(f"the serving engines launched the paged kernel {engine_launches} times over "
             f"{steps} dispatched steps of {layers} layers, not {want}")
    for name in ROUTER_PHASES:
        want_tiny = tiny_layers * steps[name]
        if replica_launches[name] != {"f": want_tiny, "int8": 0, "int4": 0} or want_tiny <= 0:
            fail(f"10a {name}: the tiny replicas launched the paged kernel "
                 f"{replica_launches[name]} times over {steps[name]} dispatched steps of "
                 f"{tiny_layers} layers, not {want_tiny} (and more than 0)")
    check_router_blocks(record)
    if extras["graphs"]["timed"] != extras["graphs"]["warmup"]:
        fail(f"the timed runs dispatched shapes the warm-up did not: {extras['graphs']}")
    done = [list(r.tokens) for r in run.done]
    if len(done) != args.requests or any(len(t) != args.decode_tokens for t in done):
        fail(f"the serving run did not return {args.requests} requests of "
             f"{args.decode_tokens} tokens")
    if any(not 0 <= t < 32000 for tokens in done for t in tokens):
        fail("the serving run emitted a token id outside the vocabulary")
    if extras["sync_tokens"] != done:
        fail(f"overlapped greedy streams differ from the synchronous ones at "
             f"{first_difference(done, extras['sync_tokens'])}")
    if extras["trace_on_tokens"] != extras["trace_off_tokens"]:
        fail(f"greedy streams with tracing on differ from tracing off at "
             f"{first_difference(extras['trace_on_tokens'], extras['trace_off_tokens'])}")
    arms = {}
    for name, row in record["kernels"]["shapes"].items():
        held, tol = kernels[name], KERNEL_ARM_TOL[row["fmt"]]
        arms[name] = {"kernel": held["kernel_err"], "single": held["single_err"], "tol": tol}
        if not (held["kernel_err"] <= tol and held["single_err"] <= tol):
            fail(f"kernels phase {name}: kernel {held['kernel_err']}, one split "
                 f"{held['single_err']} from the gather arm (tol {tol})")
    if not record["disagg"]["disagg"]["tokens_match"]:
        fail(f"the disagg decode engine's tokens differ from the unified engine's: "
             f"{record['disagg']}")
    if record["restart"].get("entries_loaded", 0) <= 0 or \
            record["elastic"].get("entries_restored", 0) <= 0:
        fail(f"restart / elastic restored no entry: {record['restart']}, {record['elastic']}")
    held = check_engine_paged(torch, pa, tuning, bench.gpt_config(args), args.slots,
                              args.prompt_len, args.decode_tokens)
    return {"record": record, "wall_s": wall, "paged_launches": launches,
            "engine_paged_launches": engine_launches["f"],
            "router_replica_paged_launches": {name: replica_launches[name]["f"]
                                              for name in ROUTER_PHASES},
            "kernels_phase_launches": kernels["launches"], "device_steps": steps,
            "arm_errors": arms, "engine_geometry_kernel": held}


# Phase 10b's sampled run: the greedy run's batch and prompt, 32 new tokens
# (the sampling path at full width; the depth cut for the script's time).
SAMPLED_DECODE = (*SAMPLED, "--decode-tokens=32")


def run_decode_bench(torch, tf, bench, fa, dp) -> dict:
    """Phase 10b: ``benchmark.py --model gpt-decode`` at full width and the
    reference's defaults (batch 128, prompt 64, 128 new), greedy, then
    sampled at 0.8 and top-k 50 over 32 new tokens.  Kernel 2 (the bulk prefill) must launch
    as its wgmma variant only, once per layer a generate call: run_decode
    makes two warm-up calls and measure_two_point's three.  Then one more
    generate under the profiler: device time a step against the record's
    wall time a step.  Last, kernel 2 against its plain version at the bulk
    prefill's shape (bf16, batch x 16 heads over 4 KV heads, prompt-long,
    64 wide, causal)."""
    from k8s_device_plugin_tpu_torch.utils import prng

    out, streams = {}, {}
    for name, flags in (("greedy", ()), ("sampled", SAMPLED_DECODE)):
        args = bench.parse_args(["--model=gpt-decode", "--batch-size=128", f"--device={DEVICE}",
                                 *flags])
        cfg = bench.gpt_config(args)
        fa.reset_launches()
        record, tokens = bench.run_decode(args)
        torch.cuda.synchronize()
        by_design = dict(fa.flash_attention.launches_by_design)
        calls = 5 if args.decode_tokens > 1 else 1
        expect_designs(by_design, "wgmma", cfg.num_layers * calls,
                       f"gpt-decode {name}'s bulk prefill")
        shape = (args.batch_size, args.prompt_len + args.decode_tokens)
        if tuple(tokens.shape) != shape:
            fail(f"gpt-decode {name} returned {tuple(tokens.shape)}, not {shape}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
            fail(f"gpt-decode {name} emitted a token id outside the vocabulary")
        # The same weights, prompt and key once more: the stream repeats.
        params = {k: v.to(DEVICE) for k, v in tf.init_params(cfg, 0).items()}
        prompt = tokens[:, : args.prompt_len]

        def generate():
            if args.temperature is None:
                return tf.greedy_generate(cfg, params, prompt, args.decode_tokens, device=DEVICE)
            return tf.sample_generate(cfg, params, prompt, args.decode_tokens,
                                      rng=prng.PRNGKey(1), temperature=args.temperature,
                                      top_k=args.top_k, device=DEVICE)

        if not torch.equal(generate(), tokens):
            fail(f"gpt-decode {name}: a second generate under the same key differs")
        streams[name] = tokens
        try:
            prof = dp.profiled_call(generate, 1)
        except RuntimeError as err:
            fail(f"gpt-decode {name} profile: {err}")
        out[name] = {"record": record, "flash_launches": by_design["wgmma"],
                     "launches_by_design": by_design, "generate_calls": calls,
                     "profiled_generate": {
                         "device_ms": prof["device_us"] / 1e3,
                         "device_ms_per_step": prof["device_us"] / 1e3 / args.decode_tokens,
                         "busy_share": prof["busy_share"],
                         "kernels": sum(row["calls"] for row in prof["top"]),
                         "top": prof["top"][:8]}}
        log(f"phase 10b gpt-decode {name}: {record}; flash launches {by_design}")
    if torch.equal(streams["greedy"][:, :streams["sampled"].shape[1]], streams["sampled"]):
        fail("the sampled gpt-decode run returned the greedy tokens")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(12)
    b, s, d = args.batch_size, args.prompt_len, cfg.head_dim
    q = torch.randn((b, cfg.num_heads, s, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, cfg.kv_heads, s, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    fa.reset_launches()
    got, lse = fa.flash_forward(q, k, v, causal=True, window=cfg.attention_window)
    expect_designs(fa.flash_attention.launches_by_design, "wgmma", 1,
                   "flash_forward at the bulk prefill's shape")
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True, sm_scale=d ** -0.5,
                                                window=cfg.attention_window, block_kv=128)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    lerr = (lse - ref_lse).abs().max().item()
    shape = f"b{b} h{cfg.num_heads} hk{cfg.kv_heads} s{s} d{d} causal bfloat16"
    log(f"phase 10b kernel 2 at the bulk prefill's shape ({shape}): max_abs_err {err:.3e} "
        f"(tol {TOL_BF16}), lse {lerr:.3e} (tol {TOL_LSE})")
    if not (err <= TOL_BF16 and lerr <= TOL_LSE):
        fail(f"flash_forward at the bulk prefill's shape {shape}: out {err}, lse {lerr}")
    return {"runs": out, "prefill_kernel": {"shape": shape, "max_abs_err": err,
                                            "lse_max_abs_err": lerr, "tolerance": TOL_BF16,
                                            "lse_tolerance": TOL_LSE}}


def run_lora_training(torch, tf, train, lora, data, bench, fa, smi) -> dict:
    """Phase 10c: LoRA training (rank 8, alpha 16) through the LM's train
    step.  bf16 at phase 7's configuration under AdamW (1e-3, weight decay
    1e-4), 2 warm-up and 5 timed steps: kernels 2-4 exactly layers x steps
    run, wgmma only; every loss finite; then one profiled step (after a
    warm-up step); every base parameter bit for bit unchanged, every
    ``lora_b`` moved; optimizer state for the adapters only.  Then float32
    at 2 layers, one step (SGD 0.1, momentum 0.9, a seeded non-zero
    ``lora_b`` so both adapters see gradients) on the card (the FMA
    variants) and on the CPU from the same weights: loss and parameters
    within TOL_TRAIN, and each adapter's gradient within TOL_BWD_F32 of the
    CPU's relative to its norm (the base frozen, kernels 3-4 reach the
    parameters only through the adapters' lr x gradient, which the
    absolute check alone would pass for small updates)."""
    import functools

    cfg = tf.GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16, num_kv_heads=4,
        intermediate_size=2816, max_seq=1024, dtype=torch.bfloat16, lora_rank=LORA_RANK,
        lora_alpha=LORA_ALPHA,
    )
    batch = data.synthetic_lm_batch(8, 1024, cfg.vocab_size,
                                    generator=torch.Generator(device=DEVICE).manual_seed(0),
                                    device=DEVICE)
    adamw = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)
    state = train.create_train_state(cfg, tf.init_params(cfg, 0), tx=lora.make_lora_tx(adamw),
                                     device=DEVICE)
    named = dict(state.model.named_parameters())
    labels = lora.lora_labels(named)
    before = {n: p.detach().clone() for n, p in named.items()}
    fa.reset_launches()
    state, losses, dt = bench.timed_steps(train.make_train_step(), state, batch, 2, 5)
    torch.cuda.synchronize()
    launches, by_design = flash_launches(fa)
    n = cfg.num_layers * state.step
    for name, count in launches.items():
        if count != n:
            fail(f"LoRA training launched {name} {count} times, not {cfg.num_layers} x "
                 f"{state.step} steps")
    for kernel, counts in by_design.items():
        expect_designs(counts, "wgmma", n, f"the bf16 LoRA step's {kernel} kernel")
    bad = [i for i, loss in enumerate(losses) if not torch.isfinite(loss).item()]
    if bad:
        fail(f"LoRA training loss not finite at steps {bad}")
    steps_run = state.step
    state, wall, stats = profiled_step(train.make_train_step(), state, batch)
    stats["top"] = stats["top"][:12]
    moved_base = [k for k, p in named.items() if labels[k] == "frozen"
                  and not torch.equal(p.detach(), before[k])]
    still_b = [k for k, p in named.items() if k.endswith(".lora_b")
               and torch.equal(p.detach(), before[k])]
    if moved_base or still_b:
        fail(f"LoRA training moved base parameters {moved_base[:4]} or left lora_b "
             f"{still_b[:4]} where it was")
    held = {id(p) for p in state.optimizer.state}
    adapters = {id(p) for k, p in named.items() if labels[k] == "lora"}
    if held != adapters or not held:
        fail(f"the LoRA optimizer holds state for {len(held)} tensors, not the "
             f"{len(adapters)} adapters alone")
    step_s = dt / 5
    bf16 = {
        "config": "vocab 32000, hidden 1024, 8 layers, 16/4 heads, intermediate 2816, bf16 "
                  f"compute, float32 params, batch 8, seq 1024, LoRA rank {LORA_RANK} alpha "
                  f"{LORA_ALPHA:g} on every dense site, AdamW(1e-3, weight decay 1e-4)",
        "tokens_per_s": 8 * 1024 / step_s,
        "step_time_ms": step_s * 1e3,
        "steps_run": steps_run,
        "losses": [loss.item() for loss in losses],
        "profiled_step": {"wall_ms": wall * 1e3, **stats},
        "adapter_tensors": len(adapters),
        "optimizer_state_tensors": len(held),
        "launches": launches,
        "launches_by_design": by_design,
    }
    log(f"phase 10c LoRA bf16: {bf16}")
    del state, named, before
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, num_layers=2, max_seq=256, dtype=torch.float32)
    params = tf.init_params(cfg32, seed=5)
    gen = torch.Generator().manual_seed(7)
    for name in params:
        if name.endswith(".lora_b"):
            params[name] = torch.randn(params[name].shape, generator=gen) * 0.05
    batch32 = data.synthetic_lm_batch(2, 256, cfg32.vocab_size,
                                      generator=torch.Generator().manual_seed(6), device="cpu")
    sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
    result, grads = {}, {}
    for device in (DEVICE, "cpu"):
        st = train.create_train_state(cfg32, params, tx=lora.make_lora_tx(sgd), device=device)
        fa.reset_launches()
        st, loss = train.make_train_step()(st, {k: v.to(device) for k, v in batch32.items()})
        result[device] = loss.item(), {k: v.cpu() for k, v in st.model.state_dict().items()}
        grads[device] = {k: p.grad.cpu() for k, p in st.model.named_parameters()
                         if p.grad is not None}
        if device == DEVICE:
            fma = flash_launches(fa)[1]
            for kernel, counts in fma.items():
                expect_designs(counts, "fma", cfg32.num_layers,
                               f"the float32 LoRA step's {kernel} kernel")
    (card_loss, card_params), (cpu_loss, cpu_params) = result[DEVICE], result["cpu"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    param_err = max((card_params[k] - cpu_params[k]).abs().max().item() for k in cpu_params)
    frozen_moved = [k for k in cpu_params if ".lora_" not in k
                    and not torch.equal(card_params[k], params[k])]
    adapters = sorted(k for k in params if ".lora_" in k)
    if set(grads[DEVICE]) != set(adapters) or set(grads["cpu"]) != set(adapters):
        fail(f"the float32 LoRA step gave gradients to {sorted(grads[DEVICE])[:4]}..., not the "
             f"{len(adapters)} adapters alone")
    grad_rel = {k: ((grads[DEVICE][k] - grads["cpu"][k]).norm() / grads["cpu"][k].norm()).item()
                for k in adapters}
    worst_grad = max(grad_rel, key=grad_rel.get)
    # The q/k/v sites' adapters: their gradients are dQ, dK and dV through
    # the site.
    qkv_rel = max(v for k, v in grad_rel.items() if any(f".attn.{s}." in k
                                                        for s in ("query", "key", "value")))
    update = max((cpu_params[k] - params[k]).abs().max().item() for k in adapters)
    log(f"phase 10c LoRA fp32 step card vs CPU: loss {card_loss:.6f} vs {cpu_loss:.6f} (rel "
        f"{loss_rel:.2e}), max param diff {param_err:.2e} (tol {TOL_TRAIN}) beside the largest "
        f"adapter update {update:.2e}; adapter gradients rel {grad_rel[worst_grad]:.2e} at "
        f"{worst_grad}, q/k/v sites {qkv_rel:.2e} (tol {TOL_BWD_F32})")
    if not (loss_rel <= TOL_TRAIN and param_err <= TOL_TRAIN) or frozen_moved:
        fail(f"LoRA step card vs CPU: loss rel {loss_rel}, params {param_err}, base moved "
             f"{frozen_moved[:4]}")
    if not grad_rel[worst_grad] <= TOL_BWD_F32:
        fail(f"LoRA step card vs CPU: the gradient of {worst_grad} is {grad_rel[worst_grad]} "
             f"from the CPU's relative to its norm (tol {TOL_BWD_F32})")
    return {"bf16": bf16, "card_vs_cpu": {"loss_rel_err": loss_rel,
                                          "param_max_abs_err": param_err,
                                          "adapter_update_max_abs": update,
                                          "adapter_grad_rel_err": grad_rel[worst_grad],
                                          "adapter_grad_rel_err_at": worst_grad,
                                          "qkv_adapter_grad_rel_err": qkv_rel,
                                          "grad_tolerance": TOL_BWD_F32,
                                          "launches_by_design": fma}, "card": smi}


# ------------------------------------------------------------- phase 12

# Phase 12b: __graft_entry__.py's tensor-parallel bar at the deployed widths
# (vocab 32000, hidden 1024, 8 layers, 16/4 heads, the CLI's intermediate
# 3072), float32, two slots, optimistic admission, the KV tiers with an 8 MB
# host arena, over two gloo ranks sharing the card.  Page 16: the sampled
# prompts are 40 tokens, two full pages the prefix trie registers (the
# reference's 8 at page 4).
TP_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16,
              num_kv_heads=4, intermediate_size=3072, max_seq=512)
TP_PAGED = dict(page_size=16, num_pages=64, max_pages_per_seq=32)
TP_FREE = 3  # pages left free in the greedy run: its two rows need 4 by their end
TP_SCENARIOS = (
    {"name": "greedy_churn", "jobs": [([3, 5, 7], 16), ([9, 10, 11], 16)], "park": True},
    {"name": "sampled_restore", "rng": 42, "reclaim": 3,
     "sample": {"temperature": 0.8, "top_k": 8},
     "jobs": [([(7 * j + 3) % 32000 for j in range(40)], 12),
              ([(13 * j + 9) % 32000 for j in range(40)], 12)]},
)
# The sharded float32 forward against the unsharded one on the card: the
# row-parallel sums split in two and added, another order of the same
# float32 sums (phase 11b's bound).
TOL_TP_F32 = 1e-5
# A greedy step the sharded and unsharded float32 runs may decide apart: a
# top-2 logit margin under this in the unsharded run.
TOL_TP_MARGIN = 1e-3
# Phase 12c: the deployment's flags at --tp 2, over gloo on the shared card;
# 8 of phase 4d's prompts, 16 new tokens each (the warm-up's too): gloo
# stages every collective through host memory (43-85 ms a token), and the
# overload limiter, which the slow steps feed, admits them in waves.
TP_SERVE_JOBS, TP_SERVE_NEW = 8, 16
TP_SERVER = ("import sys\n"
             "from k8s_device_plugin_tpu_torch.models import http_server\n"
             "if __name__ == '__main__':\n"
             "    http_server.main(sys.argv[1:], tp_backend='gloo')\n")


@functools.lru_cache(maxsize=1)
def tp_bar_params():
    """Phase 12b's config and seed 0's weights, drawn once a process."""
    import torch

    from k8s_device_plugin_tpu_torch.models.transformer import GPTConfig, init_params

    cfg = GPTConfig(**TP_CFG, dtype=torch.float32)
    return cfg, init_params(cfg, 0)


def tp_bar_engine(rng, mesh=None, device=None):
    """Phase 12b's engine (one rank of it, or the unsharded one without a
    mesh), from seed 0's weights."""
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine
    from k8s_device_plugin_tpu_torch.models.transformer import PagedConfig
    from k8s_device_plugin_tpu_torch.utils import prng

    cfg, params = tp_bar_params()
    return ServingEngine(cfg, params, PagedConfig(**TP_PAGED), max_slots=2,
                         mesh=mesh, rng=None if rng is None else prng.PRNGKey(rng),
                         admission="optimistic", kv_retain=True, kv_host_cache_mb=8,
                         cuda_graphs=False, overload=None, slo=None, device=device or DEVICE)


def tp_scenario(eng, scenario: dict) -> dict:
    """One scenario of the bar on ``eng``: its streams and counters."""
    kw = scenario.get("sample", {})
    parked = 0
    if scenario.get("park"):
        with eng._lock:
            parked = len(eng.free_pages) - TP_FREE
            for _ in range(parked):
                eng.free_pages.pop()
    t0 = time.perf_counter()
    done = eng.run(scenario["jobs"], **kw)
    if scenario.get("reclaim"):
        with eng._lock:
            eng._kv_reclaim(scenario["reclaim"])
        done += eng.run(scenario["jobs"], **kw)
    return {"tokens": [r.tokens for r in done], "wall_s": time.perf_counter() - t0,
            "pages_removed": parked,
            "counters": {k: getattr(eng, k) for k in (
                "preemptions", "kv_resumes_restored", "overlap_discards", "kv_host_hits",
                "kv_restores", "device_steps")}}


def greedy_margins(torch, tf, jobs, streams) -> list:
    """Each greedy step's top-2 logit margin in the unsharded float32 model
    (its full forward over the prompt and the tokens before the step)."""
    cfg = tf.GPTConfig(**TP_CFG, dtype=torch.float32)
    model = tf.TransformerLM(cfg, device=DEVICE)
    model.load_state_dict(tf.init_params(cfg, 0))
    out = []
    with torch.no_grad():
        for (prompt, _), tokens in zip(jobs, streams):
            logits = model(torch.tensor([prompt + tokens[:-1]], device=DEVICE))[0]
            top2 = logits[len(prompt) - 1:].topk(2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).tolist())
    del model
    return out


def hold_tp_streams(got: list, want: list, margins, what: str) -> dict | None:
    """Streams equal, or the first difference at a greedy step whose top-2
    margin in the unsharded run is under TOL_TP_MARGIN (``margins`` None:
    sampled, which must be equal)."""
    if got == want:
        return None
    i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    j = next(j for j, (a, b) in enumerate(zip(got[i], want[i])) if a != b)
    margin = None if margins is None or i >= len(margins) else margins[i][j]
    if margin is None or margin >= TOL_TP_MARGIN:
        fail(f"{what}: the tp=2 stream differs from the unsharded one at request {i} token "
             f"{j} (top-2 margin {margin}, tolerance {TOL_TP_MARGIN})")
    return {"request": i, "step": j, "margin": margin}


def shard_kernel_row(torch, pa, tuning) -> dict:
    """Kernel 1 at one rank's shard geometry at tp 2 (B 8, H 8, Hk 2, D 64,
    page 16, 32 pages a row, bf16 q and pools) against its plain version,
    timed with its bound."""
    dev = torch.device(DEVICE)
    B, H, HK, D, PS, MPP, P = 8, 8, 2, 64, 16, 32, 512
    gen = torch.Generator(device=dev).manual_seed(12)
    splits = tuning.pick_num_splits(MPP, tuning.device_generation(dev))
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    pools = {name: torch.randn((P, PS, HK, D), generator=gen, device=dev).to(torch.bfloat16)
             for name in ("pool_k", "pool_v")}
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: B * MPP] + 1)
    table = table.reshape(B, MPP).to(torch.int32)
    lens = torch.tensor([129, 145, 160, 176, 192, 208, 224, 256], dtype=torch.int32, device=dev)
    err = hold_paged(torch, pa, q, pools, table, lens, window=None, splits=splits,
                     kv_format="f")
    if not err <= TOL_BF16:
        fail(f"paged_attention at the tp=2 shard geometry: {err} > {TOL_BF16}")
    ms, _ = time_ms(lambda: pa.paged_attention(q, page_table=table, lens=lens,
                                               num_splits=splits, **pools))
    plain_ms, _ = time_ms(lambda: pa.paged_attention_reference(
        q.reshape(B, HK, H // HK, D), pools["pool_k"], pools["pool_v"], table, lens,
        sm_scale=D ** -0.5, window=None, num_splits=splits), iters=20)
    live = lens.tolist()
    nbytes = (2 * B * H * D * 2 + sum(live) * HK * 2 * D * 2
              + sum(-(-n // PS) for n in live) * 4 + B * 4)
    b_ms, b_by = bound(nbytes, sum(4 * H * n * D for n in live), BF16_FLOPS)
    row = {"shape": f"B{B} H{H} Hk{HK} D{D} page{PS} mpp{MPP} splits{splits} "
                    f"lens{live[0]}..{live[-1]} bf16 q and pools",
           "max_abs_err": err, "tolerance": TOL_BF16, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    log(f"phase 12b kernel 1 at the tp=2 shard geometry: {row}")
    return row


def run_phase_12a(torch, engine, engine_tp, pa, blocks) -> dict:
    """Phase 12a: an NCCL group of one, graphed: phase 4d's traffic through
    the batch engine over a ``tp`` mesh of one must return 4d's greedy
    tokens bit for bit, with the collectives captured in its graphs."""
    import functools

    args = engine.parse_args([*ENGINE_WIDTHS, "--requests=32", f"--device={DEVICE}", *BLOCKS])
    with engine_tp.launch(1, backend="nccl", device=DEVICE) as group:
        pa.reset_launches()
        eng = group.build(functools.partial(engine.build_engine, args))
        summary, done = engine.benchmark(args, eng)
        torch.cuda.synchronize()
        launches = dict(pa.paged_attention.launches_by_format)
        captured = dict(eng.captured_collectives)
        tp_state = eng.debug_state()["tp"]
        del eng
    tokens = [r.tokens for r in done]
    if tokens != BLOCK16_TOKENS:
        fail(f"12a: the tp mesh of one differs from phase 4d's greedy tokens at "
             f"{first_difference(tokens, BLOCK16_TOKENS)}")
    if launches["f"] != args.layers * summary["device_steps"] or launches["f"] <= 0:
        fail(f"12a: {launches} paged launches over {summary['device_steps']} steps of "
             f"{args.layers} layers")
    if summary["graph_replays"] <= 0 or not captured:
        fail(f"12a: {summary['graph_replays']} graph replays, collectives captured {captured}")
    for key, calls in captured.items():
        steps = int(key.split(",")[0].strip("("))
        want = {"all_reduce": (2 * args.layers + 1) * steps, "all_gather": steps,
                "broadcast": steps}
        if calls != want:
            fail(f"12a: graph {key} captured {calls}, not {want}")
    if tp_state != {"size": 1, "axis": "tp", "mesh": {"tp": 1}, "devices": ["cuda:0"]}:
        fail(f"12a: debug_state tp block {tp_state}")
    block16 = max(captured, key=lambda k: int(k.split(",")[0].strip("(")))
    out = {"flags": [*BLOCKS], "backend": "nccl", "tp": tp_state,
           "tokens_per_s": summary["value"], "phase_4d_tokens_per_s": blocks["greedy"]["value"],
           "ratio_to_4d": summary["value"] / blocks["greedy"]["value"],
           "graph_replays": summary["graph_replays"], "device_steps": summary["device_steps"],
           "overlap_discards": summary["overlap_discards"], "paged_launches": launches["f"],
           "collectives_per_graph": captured, "block16_graph": block16,
           "tokens_equal_4d": True}
    log(f"phase 12a: {out}")
    return out


def run_phase_12b_c(torch, tf, pa, tuning, http_server, engine_tp, smi) -> tuple[dict, dict]:
    """Phases 12b (the bar over two gloo ranks sharing the card, then the
    in-process twin of 12c's server) and 12c (the HTTP server at --tp 2)."""
    import functools

    from k8s_device_plugin_tpu_torch.models.engine import synthetic_jobs

    bar = {}
    with engine_tp.launch(2, backend="gloo", device=DEVICE) as group:
        for scenario in TP_SCENARIOS:
            eng = group.build(functools.partial(tp_bar_engine, scenario.get("rng")))
            eng.rank_stats(reset=True)
            got = tp_scenario(eng, scenario)
            ranks = eng.rank_stats()
            got["lint_leaves"] = eng.assert_sharded()
            pools = eng.gathered_pools()
            got["ranks"] = ranks
            bar[scenario["name"]] = (got, pools)
        # 12c's in-process twin: the server's flags at --tp 2, same jobs.
        args = http_server.parse_args([*SERVE_FLAGS, "--tp=2", f"--device={DEVICE}"])
        twin = group.build(functools.partial(http_server.build_engine, args))
        jobs = synthetic_jobs(32, 128, TP_SERVE_NEW, 32000)[:TP_SERVE_JOBS]
        twin.run([(p, TP_SERVE_NEW) for p, _ in jobs[:2]])
        t0 = time.perf_counter()
        twin_done = twin.run(jobs)
        twin_s = time.perf_counter() - t0
        want_http = [r.tokens for r in twin_done]
        del twin, eng
    layers = TP_CFG["num_layers"]
    report = {"card": smi, "backend": "gloo", "ranks_per_card": 2, "dtype": "float32",
              "config": TP_CFG, "paged": TP_PAGED, "tolerance_pools": TOL_TP_F32,
              "tolerance_margin": TOL_TP_MARGIN, "scenarios": {}}
    for scenario in TP_SCENARIOS:
        name = scenario["name"]
        got, pools = bar[name]
        plain_eng = tp_bar_engine(scenario.get("rng"))
        want = tp_scenario(plain_eng, scenario)
        margins = None
        if "sample" not in scenario:
            margins = greedy_margins(torch, tf, scenario["jobs"], want["tokens"])
        differs = hold_tp_streams(got["tokens"], want["tokens"], margins, f"12b {name}")
        keys = ("preemptions", "kv_resumes_restored", "overlap_discards")
        if any(got["counters"][k] != want["counters"][k] for k in keys):
            fail(f"12b {name}: counters {got['counters']} vs unsharded {want['counters']}")
        if "sample" not in scenario and not all(got["counters"][k] > 0 for k in keys):
            fail(f"12b {name}: preemptions, restored resumes and discards must be above 0: "
                 f"{got['counters']}")
        if "sample" in scenario and not (got["counters"]["kv_host_hits"] > 0
                                         and got["counters"]["kv_restores"] > 0):
            fail(f"12b {name}: the repeat did not restore through the host arena: "
                 f"{got['counters']}")
        worst = 0.0
        for layer, layer_pools in plain_eng.gathered_pools().items():
            for pool, value in layer_pools.items():
                worst = max(worst, (pools[layer][pool] - value).abs().max().item())
        if not worst <= TOL_TP_F32:
            fail(f"12b {name}: the gathered pools differ from the unsharded engine's by {worst}")
        for rank, stats in enumerate(got["ranks"]):
            if stats["paged_launches"]["f"] != layers * stats["device_steps"] or \
                    stats["device_steps"] <= 0:
                fail(f"12b {name}: rank {rank} launched kernel 1 {stats['paged_launches']} "
                     f"times over {stats['device_steps']} steps of {layers} layers")
        report["scenarios"][name] = {
            "pages_removed": got["pages_removed"], "counters": got["counters"],
            "unsharded_counters": want["counters"], "ranks": got["ranks"],
            "lint_leaves": got["lint_leaves"], "pools_max_abs_err": worst,
            "first_difference": differs,
            "min_greedy_margin": None if margins is None else min(min(m) for m in margins),
            "tp2_wall_s": got["wall_s"], "unsharded_wall_s": want["wall_s"],
            "times": "staged through host memory by gloo: not a speed"}
        del plain_eng
        torch.cuda.empty_cache()
    report["shard_kernel"] = shard_kernel_row(torch, pa, tuning)
    log(f"phase 12b: {report}")
    serve = run_phase_12c(jobs, want_http, twin_s, smi)
    return report, serve


def tp_server(flags, log_path, env) -> tuple:
    """Start the HTTP server at ``flags`` (with --tp) over gloo; returns
    (process, port, follower pids)."""
    proc = subprocess.Popen([sys.executable, "-c", TP_SERVER, *flags, *SERVE_EXTRA],
                            stdout=subprocess.DEVNULL, stderr=open(log_path, "w"), env=env)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        text = open(log_path).read()
        if proc.poll() is not None:
            fail(f"the tp=2 HTTP server exited with {proc.returncode}: {text[-3000:]}")
        port = re.search(r"serving on :(\d+)", text)
        pids = re.search(r"follower pids \[([\d, ]+)\]", text)
        if port and pids and http_call(int(port.group(1)), "/healthz", timeout=5)[0] == 200:
            return proc, int(port.group(1)), [int(p) for p in pids.group(1).split(",")]
        time.sleep(0.2)
    proc.kill()
    fail(f"the tp=2 HTTP server did not come up: {open(log_path).read()[-3000:]}")


def pids_gone(pids) -> bool:
    """No process of ``pids`` is left running (an exited one a zombie of
    nobody is gone)."""
    import os

    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split(") ")[-1].split()[0] != "Z":
                    return False
        except OSError:
            continue
    return True


def run_phase_12c(jobs, want, twin_s: float, smi) -> dict:
    """Phase 12c: the HTTP server's launcher at --tp 2 over gloo on the
    shared card, the deployment's flags otherwise (snapshots included):
    8 streamed requests whose greedy tokens equal the in-process tp=2
    twin's, the ``tp`` block and gauge, a drain that saves the snapshot and
    leaves no follower, and a restarted tp=2 server that loads it."""
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parent
    (root / "chiprun_out").mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    snap = snapshot_flag("tp2")
    flags = (*SERVE_FLAGS, "--tp=2", snap)
    out = {"card": smi, "flags": [*flags], "backend": "gloo", "twin_wall_s": twin_s}
    servers = []
    for run in ("first", "restarted"):
        log_path = root / "chiprun_out" / f"serve_tp2_{run}.log"
        t0 = time.perf_counter()
        proc, port, pids = tp_server(flags, log_path, env)
        servers.append((proc, pids))
        try:
            up_s = time.perf_counter() - t0
            if run == "first":
                # The twin's warm-up, concurrent: over gloo a request takes
                # seconds, and two sequential ones would give the limiter a
                # drain rate under which the burst's tail sheds.
                http_traffic(port, [(p, TP_SERVE_NEW) for p, _ in jobs[:2]], streamed=0)
                results, wall = http_traffic(port, jobs, streamed=len(jobs))
                got = [r["tokens"] for r in results]
                if got != want:
                    fail(f"12c: the tp=2 server's greedy tokens differ from the in-process "
                         f"tp=2 engine's at {first_difference(got, want)}")
                state = http_call(port, "/debug/state")[1]["engine"]
                tp_block = state["tp"]
                if {k: tp_block[k] for k in ("size", "axis", "mesh")} != {
                        "size": 2, "axis": "tp", "mesh": {"tp": 2}}:
                    fail(f"12c: /debug/state tp block {tp_block}")
                gauge = [line for line in http_call(port, "/metrics")[1].decode().splitlines()
                         if line.startswith("tpu_engine_tp_size ")]
                if gauge != ["tpu_engine_tp_size 2"]:
                    fail(f"12c: the tp gauge reads {gauge}")
                out.update(tp=tp_block, gauge=gauge[0], client=client_latency(results, wall),
                           start_s=up_s, tokens_equal_twin=True,
                           device_steps=state["device"]["device_steps"],
                           admission_limit=http_call(port, "/debug/admission")[1].get("limit"))
            else:
                restored = re.search(r"kv snapshot restore: (\{.*\})", log_path.read_text())
                loaded = ast.literal_eval(restored.group(1)) if restored else {}
                if not loaded.get("ok") or loaded.get("restored", 0) <= 0:
                    fail(f"12c: the restarted tp=2 server loaded {loaded}")
                status, body = http_call(port, "/generate", {"prompt": jobs[0][0],
                                                             "max_new_tokens": jobs[0][1]})
                if status != 200 or body["tokens"] != want[0]:
                    fail(f"12c: the restarted server answered {status} with other tokens")
                kv = http_call(port, "/debug/kvcache")[1]
                out.update(restart_start_s=up_s, snapshot_load=loaded,
                           restart_kvcache_hits=kv.get("hits"))
        except BaseException:
            proc.kill()
            raise
        out[f"{run}_drain_s"] = stop_server(proc, log_path)
        time.sleep(1.0)
        if not pids_gone(pids):
            fail(f"12c: follower(s) {pids} still run after the {run} server exited")
        out[f"{run}_follower_pids"] = pids
    out["followers_left"] = 0
    log(f"phase 12c: {out}")
    return out


def run_phase_12(torch, tf, engine, http_server, pa, tuning, blocks, smi, mark) -> dict:
    """Phase 12: tensor-parallel serving; returns the tensor_parallel line."""
    from k8s_device_plugin_tpu_torch.models import engine_tp

    world_of_one = run_phase_12a(torch, engine, engine_tp, pa, blocks)
    mark("12a_nccl_group_of_one")
    shared, serve = run_phase_12b_c(torch, tf, pa, tuning, http_server, engine_tp, smi)
    mark("12b_12c_gloo_tp2")
    served = run_phase_12d(torch, pa, engine_tp, smi)
    mark("12d_served_over_tp")
    return {"world_of_one": world_of_one, "shared_card": shared, "http_tp2": serve,
            "served": served, "card": smi}


# ---------------------------------------------------------------- phase 12d

# What the reference serves over its mesh, at phase 12b's float32
# widths and weights: (name, config overrides, engine arguments, jobs of
# (prompt, new tokens, adapter)).
TP_PROMPTS = [[(7 * j + 3) % 32000 for j in range(40)], [(13 * j + 9) % 32000 for j in range(40)]]
TP_SERVED = (
    ("w8", {"quant": "w8"}, {}, [(p, 16, None) for p in TP_PROMPTS]),
    ("w8a8_int8kv", {"quant": "w8a8", "quant_kv": True}, {}, [(p, 16, None) for p in TP_PROMPTS]),
    ("lora4_rank8", {"lora_rank": 8, "lora_serve": 4}, {},
     [(TP_PROMPTS[i % 2], 12, a) for i, a in enumerate((0, 1, 2, 3, None))]),
    ("spec_gamma2", {}, {"spec_gamma": 2}, [(p, 16, None) for p in TP_PROMPTS]),
)
TP_HANDOFF = ([(11 * j + 5) % 32000 for j in range(64)], 12)  # 4 full pages of 16
TP_ROLE_KW = dict(kv_retain=True, kv_host_cache_mb=64, prefill_chunk=32)


@functools.lru_cache(maxsize=None)
def tp_served_weights(name: str) -> tuple:
    """(config, weights, draft weights) of a phase 12d scenario from seed
    0's phase 12b weights: quantized, or with 4 stacked rank-8 adapters
    (``lora_b`` drawn, as phase 4i's, so each adapter moves the logits)."""
    import torch

    from k8s_device_plugin_tpu_torch.models.transformer import init_params
    from k8s_device_plugin_tpu_torch.ops.quant import quantize_lm_params

    cfg, params = tp_bar_params()
    overrides = next(s[1] for s in TP_SERVED if s[0] == name) if name != "handoff" else {}
    cfg = dataclasses.replace(cfg, **overrides)
    draft = None
    if cfg.quant:
        params = quantize_lm_params(params)
    elif cfg.lora_serve:
        params = init_params(cfg, 0)
        gen = torch.Generator().manual_seed(14)
        for k in [k for k in params if k.endswith("lora_b_stack")]:
            params[k] = torch.randn(params[k].shape, generator=gen) * LORA_B_STD
    elif name == "spec_gamma2":
        draft = quantize_lm_params(params)
    return cfg, params, draft


def tp_served_engine(name: str, role: str = "unified", mesh=None, device=None):
    """One rank of a phase 12d engine (the unsharded one without a mesh)."""
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine
    from k8s_device_plugin_tpu_torch.models.transformer import PagedConfig

    cfg, params, draft = tp_served_weights(name)
    kw = dict(next((s[2] for s in TP_SERVED if s[0] == name), {}))
    if draft is not None:
        kw["draft_params"] = draft
    if role != "unified":
        kw.update(role=role, **TP_ROLE_KW)
    return ServingEngine(cfg, params, PagedConfig(**TP_PAGED), max_slots=2, mesh=mesh,
                         overload=None, slo=None, device=device or DEVICE, **kw)


def served_jobs(eng, jobs) -> list:
    """``(prompt, new, adapter)`` jobs through ``eng`` until drained."""
    subs = [eng.submit(list(p), n, adapter=a) for p, n, a in jobs]
    while not all(r.done for r in subs):
        eng.step()
    return [list(r.tokens) for r in subs]


def handoff_wire(eng, prompt) -> tuple:
    """A prefill-role engine's probe of ``prompt``: (the wire's entries as
    the snapshot format's bytes, the shipped logits section)."""
    from k8s_device_plugin_tpu_torch.models import engine_handoff as handoff
    from k8s_device_plugin_tpu_torch.models import engine_snapshot as snap

    tap = eng.handoff_begin(list(prompt), None)
    entries = []
    try:
        for _ in range(1000):
            eng.step()
            while (e := tap.pop(0.0)) is not None:
                entries.append(e)
            if tap.req.done and tap.pushed <= len(entries):
                break
    finally:
        eng.handoff_end(tap)
    layout = snap.snapshot_layout(eng)
    wire = snap.encode_preamble(layout, eng.params_fingerprint, len(entries)) + b"".join(
        snap.encode_entry(layout, k, r) for k, r in entries)
    return wire, handoff.encode_logits_section(tap.logits)


def handoff_receive(eng, wire: bytes, prompt, new: int) -> dict:
    """A decode-role engine admitting ``wire`` and decoding ``prompt``."""
    import io

    from k8s_device_plugin_tpu_torch.models import engine_snapshot as snap

    layout = snap.snapshot_layout(eng)
    _, parsed = snap._parse_snapshot(io.BytesIO(wire), layout, eng.params_fingerprint)
    admitted = snap._admit_entries(eng, parsed)
    tokens = served_jobs(eng, [(prompt, new, None)])
    return {"tokens": tokens, "admitted": admitted, "skipped": eng.handoff_skipped_tokens}


def wire_parts(wire: bytes) -> tuple:
    """A wire as (preamble without its clock, [(key, bytes)], rows)."""
    import io

    from k8s_device_plugin_tpu_torch.models import engine_snapshot as snap

    header, parsed = snap._parse_snapshot(io.BytesIO(wire), None, None)
    header.pop("created_unix_ms", None)
    return header, [(k, n) for k, _, n in parsed], [rows for _, rows, _ in parsed]


def served_margins(torch, eng, jobs, streams) -> list:
    """Each greedy step's top-2 logit margin in an unsharded engine's model
    (its full forward over the prompt and the tokens before the step)."""
    out = []
    with torch.no_grad():
        for (prompt, _, adapter), tokens in zip(jobs, streams):
            ids = torch.tensor([list(prompt) + tokens[:-1]], device=DEVICE)
            kw = {}
            if eng.cfg.lora_serve:
                kw["adapter_ids"] = torch.tensor([-1 if adapter is None else adapter],
                                                 device=DEVICE)
            logits = eng.model(ids, **kw)[0]
            top2 = logits[len(prompt) - 1:].topk(2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).tolist())
    return out


def pools_apart(got: dict, want: dict) -> tuple:
    """(largest difference, int8 codes apart) of two engines' gathered
    pools.  Float pools are compared as they are.  int8 pools are compared
    dequantized, less one quantization step of the unsharded scale: K/V a
    few ulps apart (float32 sums in another order) may round to the next
    code (their dequantized difference is then one step)."""
    import torch

    worst, flips = 0.0, 0
    for layer, pools in want.items():
        for pool, value in pools.items():
            if pool.endswith("_scale"):
                continue
            mine = got[layer][pool]
            if value.dtype == torch.int8:
                scale, other = pools[pool + "_scale"], got[layer][pool + "_scale"]
                a, b = mine.float() * other[..., None], value.float() * scale[..., None]
                flips += int((mine != value).sum())
                diff = ((a - b).abs() - scale[..., None] * (mine != value)).clamp_min(0)
            else:
                diff = (mine.float() - value.float()).abs()
            worst = max(worst, diff.max().item())
    return worst, flips


def run_group_served(group, functools) -> dict:
    """Every phase 12d scenario and the handoff on one launched group."""
    out = {}
    for name, _, _, jobs in TP_SERVED:
        eng = group.build(functools.partial(tp_served_engine, name))
        eng.rank_stats(reset=True)
        t0 = time.perf_counter()
        tokens = served_jobs(eng, jobs)
        wall = time.perf_counter() - t0
        ranks = eng.rank_stats()
        for rank, stats in enumerate(ranks):
            if sum(stats["paged_launches"].values()) <= 0 or stats["device_steps"] <= 0:
                fail(f"12d {name}: rank {rank} launched kernel 1 {stats['paged_launches']} "
                     f"times over {stats['device_steps']} steps")
        out[name] = {"tokens": tokens, "ranks": ranks, "lint_leaves": eng.assert_sharded(),
                     "pools": eng.gathered_pools(), "wall_s": wall,
                     "graph_replays": eng.graph_replays, "spec_rounds": eng.spec_rounds}
        del eng
    pre = group.build(functools.partial(tp_served_engine, "handoff", "prefill"))
    wire, logits = handoff_wire(pre, TP_HANDOFF[0])
    dec = group.build(functools.partial(tp_served_engine, "handoff", "decode"))
    dec.rank_stats(reset=True)
    out["handoff"] = dict(handoff_receive(dec, wire, *TP_HANDOFF), wire=wire, logits=logits,
                          ranks=dec.rank_stats(), pools=dec.gathered_pools())
    del pre, dec
    return out


def run_phase_12d(torch, pa, engine_tp, smi) -> dict:
    """Phase 12d: w8, w8a8 with int8 pools, 4 rank-8 adapters, gamma-2
    speculation and a prefill -> decode handoff over an NCCL tp mesh of one
    (graphed) and over two gloo ranks sharing the card (eager), each held
    to the unsharded engine on the same weights: greedy streams equal (or
    apart only after a top-2 margin under TOL_TP_MARGIN), pools within
    TOL_TP_F32, the handoff's wire the unsharded one's record for record."""
    import functools

    runs = {}
    for label, tp, backend in (("nccl_tp1", 1, "nccl" if DEVICE == "cuda" else "gloo"),
                               ("gloo_tp2", 2, "gloo")):
        with engine_tp.launch(tp, backend=backend, device=DEVICE) as group:
            runs[label] = run_group_served(group, functools)
        torch.cuda.empty_cache()
    report = {"card": smi, "dtype": "float32", "config": TP_CFG, "paged": TP_PAGED,
              "tolerance_pools": TOL_TP_F32, "tolerance_margin": TOL_TP_MARGIN,
              "scenarios": {}}
    for name, _, _, jobs in TP_SERVED:
        plain = tp_served_engine(name)
        pa.reset_launches()
        t0 = time.perf_counter()
        want = served_jobs(plain, jobs)
        wall = time.perf_counter() - t0
        launches = sum(pa.paged_attention.launches_by_format.values())
        margins = served_margins(torch, plain, jobs, want)
        want_pools = plain.gathered_pools()
        row = {"unsharded_wall_s": wall, "unsharded_paged_launches": launches,
               "min_greedy_margin": min(min(m) for m in margins)}
        for label, run in runs.items():
            got = run[name]
            differs = hold_tp_streams(got["tokens"], want, margins, f"12d {label} {name}")
            worst, flips = 0.0, 0
            if differs is None:
                worst, flips = pools_apart(got["pools"], want_pools)
                if not worst <= TOL_TP_F32:
                    fail(f"12d {label} {name}: the gathered pools differ from the unsharded "
                         f"engine's by {worst}")
            if name == "spec_gamma2" and got["spec_rounds"] <= 0:
                fail(f"12d {label} {name}: no speculative round ran")
            if label == "nccl_tp1" and got["graph_replays"] <= 0:
                fail(f"12d {label} {name}: the NCCL group of one replayed no graph")
            row[label] = {"first_difference": differs, "pools_max_abs_err": worst,
                          "int8_codes_one_step_apart": flips,
                          "kernel1_launches_by_rank": [sum(r["paged_launches"].values())
                                                       for r in got["ranks"]],
                          "device_steps_by_rank": [r["device_steps"] for r in got["ranks"]],
                          "lint_leaves": got["lint_leaves"], "graph_replays": got["graph_replays"],
                          "spec_rounds": got["spec_rounds"], "wall_s": got["wall_s"]}
        report["scenarios"][name] = row
        del plain
        torch.cuda.empty_cache()
    pre = tp_served_engine("handoff", "prefill")
    wire, logits = handoff_wire(pre, TP_HANDOFF[0])
    dec = tp_served_engine("handoff", "decode")
    want = handoff_receive(dec, wire, *TP_HANDOFF)
    want_parts, want_pools = wire_parts(wire), dec.gathered_pools()
    del pre, dec
    row = {"prompt_tokens": len(TP_HANDOFF[0]), "wire_bytes": len(wire),
           "logits_bytes": len(logits), "unsharded": {k: want[k] for k in ("admitted", "skipped")}}
    for label, run in runs.items():
        got = run["handoff"]
        parts = wire_parts(got["wire"])
        if parts[:2] != want_parts[:2] or len(got["logits"]) != len(logits):
            fail(f"12d {label} handoff: the wire's layout, keys or sizes are not the unsharded "
                 f"engine's: {parts[:2]} vs {want_parts[:2]}")
        worst = max((mine[layer][pool].float() - theirs[layer][pool].float()).abs().max().item()
                    for mine, theirs in zip(parts[2], want_parts[2])
                    for layer in theirs for pool in theirs[layer])
        if not worst <= TOL_TP_F32:
            fail(f"12d {label} handoff: the wire's rows differ from the unsharded one's by {worst}")
        hold_tp_streams(got["tokens"], want["tokens"], None, f"12d {label} handoff")
        if got["admitted"] != want["admitted"] or got["skipped"] <= 0:
            fail(f"12d {label} handoff: admitted {got['admitted']} (unsharded {want['admitted']}), "
                 f"skipped {got['skipped']} prefill positions")
        row[label] = {"wire_bytes": len(got["wire"]), "rows_max_abs_err": worst,
                      "admitted": got["admitted"], "skipped": got["skipped"],
                      "kernel1_launches_by_rank": [sum(r["paged_launches"].values())
                                                   for r in got["ranks"]]}
    report["handoff"] = row
    log(f"phase 12d: {report}")
    return report


# ---------------------------------------------------------------- phase 13

MOE_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16, num_kv_heads=4,
               intermediate_size=2816, max_seq=1024)  # phase 7's LM, its MLPs MoE
MOE_EXPERTS, MOE_TOP, MOE_CF, MOE_AUX = 8, 2, 1.25, 0.01
MOE_BATCH, MOE_SEQ, MOE_STEPS = 8, 1024, 3
# 13b/13d's cut config: phase 8's (2 layers, seq 256), MoE.
MOE_CUT = dict(MOE_CFG, num_layers=2, max_seq=256)
MOE_MESHES = ({"dp": 1, "ep": 2, "tp": 2}, {"dp": 2, "ep": 2, "tp": 1})


def moe_state(torch, tf, train, moe, cfg_kw, dtype, device, seed: int = 0):
    """A fresh MoE LM train state (SGD 0.1, momentum 0.9) from ``seed``."""
    cfg = tf.GPTConfig(**cfg_kw, dtype=dtype)
    params = moe.init_moe_params(cfg, MOE_EXPERTS, seed)
    return train.create_train_state(cfg, params, 0.1, 0.9, device=device,
                                    mlp_factory=moe.moe_mlp_factory(cfg, MOE_EXPERTS, MOE_TOP,
                                                                    MOE_CF))


def moe_split(torch, prof, moe) -> dict:
    """One traced MoE step's device time (us) by stage: each forward op
    under a ``moe.*`` range and each backward node whose forward op ran
    under one (autograd's sequence numbers), kernels 2-4 by name, the
    rest."""
    events = list(prof.events())

    def dev(e):
        return e.device_time_total

    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if getattr(e, "device_type", None) == cuda
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.time_range.end - e.time_range.start for e in kernels)
    flash = sum(e.time_range.end - e.time_range.start for e in kernels if "flash_" in e.name)
    fwd, bwd, seq_phase = dict.fromkeys(moe.PHASES, 0.0), dict.fromkeys(moe.PHASES, 0.0), {}
    for e in events:
        if getattr(e, "device_type", None) == cuda:
            continue
        if e.name in moe.PHASES and not (e.cpu_parent and e.cpu_parent.name in moe.PHASES):
            fwd[e.name] += dev(e)
        anc = e.cpu_parent
        while anc is not None and anc.name not in moe.PHASES:
            anc = anc.cpu_parent
        if anc is not None and getattr(e, "sequence_nr", -1) >= 0:
            seq_phase[e.sequence_nr] = anc.name
    for e in events:
        if e.name.startswith("autograd::engine::evaluate_function") and \
                getattr(e, "sequence_nr", -1) in seq_phase:
            bwd[seq_phase[e.sequence_nr]] += dev(e)
    parts = {"expert_gemms": fwd["moe.experts"] + bwd["moe.experts"],
             "dispatch_combine_einsums": sum(fwd[k] + bwd[k] for k in ("moe.dispatch",
                                                                      "moe.combine")),
             "routing": fwd["moe.route"] + bwd["moe.route"], "kernels_2_4": flash}
    parts["other"] = total - sum(parts.values())
    return {"device_us": total, "parts_us": parts,
            "parts_share": {k: v / total for k, v in parts.items()} if total else None,
            "forward_us": fwd, "backward_us": bwd}


def run_phase_13a(torch, fa, tf, train, moe, data, smi) -> dict:
    """13a: the MoE LM at phase 7's full width, 8 experts top 2 at capacity
    1.25, aux loss 0.01, bf16 compute and float32 parameters, SGD 0.1/0.9,
    b8 s1024: a warm-up and MOE_STEPS timed steps, then one traced step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    state = moe_state(torch, tf, train, moe, MOE_CFG, torch.bfloat16, DEVICE)
    cfg = state.model.config
    batch = data.synthetic_lm_batch(MOE_BATCH, MOE_SEQ, cfg.vocab_size,
                                    generator=torch.Generator(device=DEVICE).manual_seed(13),
                                    device=DEVICE)
    step = train.make_train_step(MOE_AUX)
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    fa.reset_launches()
    losses, t0 = [], time.perf_counter()
    for _ in range(MOE_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOE_STEPS
    losses = [l.item() for l in losses]
    launches, by_design = flash_launches(fa)
    n = cfg.num_layers * MOE_STEPS
    for name, count in launches.items():
        if count != n:
            fail(f"13a: the MoE LM launched {name} {count} times, not {cfg.num_layers} x "
                 f"{MOE_STEPS} steps")
    for kernel, counts in by_design.items():
        expect_designs(counts, "wgmma", n, f"13a's {kernel} kernel")
    if not all(math.isfinite(l) for l in losses):
        fail(f"13a: MoE training loss not finite: {losses}")
    layers = [m for m in state.model.modules() if isinstance(m, moe.MoeMlp)]
    dropped = sum(float(m.dropped) for m in layers) / sum(m.assigned for m in layers)
    aux = train.sown_aux_loss(state.model).item()
    split = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: split.append(moe_split(torch, p, moe))) as prof:
        for _ in range(2):
            state, loss = step(state, batch)
            loss.item()
            torch.cuda.synchronize()
            prof.step()
    out = {"config": f"{MOE_CFG}, {MOE_EXPERTS} experts, top {MOE_TOP}, capacity factor "
                     f"{MOE_CF}, aux {MOE_AUX}, bf16 compute, float32 params, SGD 0.1/0.9, "
                     f"batch {MOE_BATCH}, seq {MOE_SEQ}",
           "losses": losses, "step_time_ms": step_s * 1e3,
           "tokens_per_s": MOE_BATCH * MOE_SEQ / step_s, "launches": launches,
           "launches_by_design": by_design, "dropped_share": dropped, "aux_loss_sum": aux,
           "capacity": layers[0].capacity(MOE_SEQ),
           "max_memory_allocated": torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None,
           "profiled_step": split[0] if split else "no window traced", "card": smi}
    log(f"phase 13a: {out}")
    del state, batch
    torch.cuda.empty_cache()
    return out


def moe_steps(torch, state, train, batch, steps: int) -> tuple:
    step = train.make_train_step(MOE_AUX)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(loss.item())
    return losses, {k: v.detach().cpu() for k, v in state.model.state_dict().items()}


def moe_cut_batch(torch, data, device):
    return data.synthetic_lm_batch(2, MOE_CUT["max_seq"], MOE_CUT["vocab_size"],
                                   generator=torch.Generator().manual_seed(6), device=device)


def run_phase_13b_c(torch, fa, tf, train, moe, data) -> dict:
    """13b: one float32 step of the cut MoE LM on the card and on the CPU;
    13c: ``shard_train_step_tp`` over an NCCL world of one, mesh (1, 1, 1),
    against the unsharded step on the card, bit for bit."""
    from k8s_device_plugin_tpu_torch.parallel import distributed, sharding, tensor

    result = {}
    for device in (DEVICE, "cpu"):
        state = moe_state(torch, tf, train, moe, MOE_CUT, torch.float32, device, seed=5)
        fa.reset_launches()
        result[device] = moe_steps(torch, state, train, moe_cut_batch(torch, data, device), 1)
        if device == DEVICE:
            by_design = flash_launches(fa)[1]
            for kernel, counts in by_design.items():
                expect_designs(counts, "fma", MOE_CUT["num_layers"], f"13b's {kernel} kernel")
    (card_loss, card_params), (cpu_loss, cpu_params) = result[DEVICE], result["cpu"]
    loss_rel = abs(card_loss[0] - cpu_loss[0]) / abs(cpu_loss[0])
    param_err = max((card_params[k] - cpu_params[k]).abs().max().item() for k in cpu_params)
    if not (loss_rel <= TOL_TRAIN and param_err <= TOL_TRAIN):
        fail(f"13b: MoE train step card vs CPU: loss rel {loss_rel}, params {param_err} "
             f"(tolerance {TOL_TRAIN})")
    parity = {"loss_rel_err": loss_rel, "param_max_abs_err": param_err, "tolerance": TOL_TRAIN,
              "launches_by_design": by_design}
    log(f"phase 13b: {parity}")
    distributed.join_local(DEVICE, 0, 1, distributed.local_init_method(),
                           "nccl" if DEVICE == "cuda" else "gloo")
    try:
        mesh = distributed.make_slice_mesh({"dp": 1, "ep": 1, "tp": 1}, device_type=DEVICE)
        state = moe_state(torch, tf, train, moe, MOE_CUT, torch.float32, DEVICE, seed=5)
        step, state = tensor.shard_train_step_tp(train.make_train_step(MOE_AUX), mesh, state)
        batch = sharding.shard_batch(moe_cut_batch(torch, data, DEVICE),
                                     *sharding.dp_coordinate(mesh))
        state, loss = step(state, batch)
        sharded = (loss.item(), {k: v.detach().cpu() for k, v in state.model.state_dict().items()})
        calls = dict(state.model.tp.calls)
        del state
    finally:
        torch.distributed.destroy_process_group()
    equal = sharded[0] == card_loss[0] and all(torch.equal(sharded[1][k], card_params[k])
                                               for k in card_params)
    if not equal:
        err = max((sharded[1][k] - card_params[k]).abs().max().item() for k in card_params)
        fail(f"13c: the (1, 1, 1) sharded step is not the unsharded one bit for bit: loss "
             f"{sharded[0]} vs {card_loss[0]}, params {err}")
    world_of_one = {"bit_for_bit": True, "loss": sharded[0], "tp_calls": calls}
    log(f"phase 13c: {world_of_one}")
    return {"card_vs_cpu": parity, "world_of_one": world_of_one}


def _moe_rank(rank: int, world: int, init_method: str, out_path: str) -> None:
    """A phase 13d rank: each mesh of MOE_MESHES for two steps of the cut
    MoE LM in float32, gloo ranks sharing the card; rank 0 saves."""
    import torch

    from k8s_device_plugin_tpu_torch.models import data, train
    from k8s_device_plugin_tpu_torch.models import transformer as tf
    from k8s_device_plugin_tpu_torch.parallel import distributed, moe, sharding, tensor
    from k8s_device_plugin_tpu_torch.utils.device import fp32_reference_precision

    fp32_reference_precision()
    device = distributed.join_local(DEVICE, rank, world, init_method, "gloo")
    results = []
    try:
        for axes in MOE_MESHES:
            mesh = distributed.make_slice_mesh(axes, device_type=DEVICE)
            state = moe_state(torch, tf, train, moe, MOE_CUT, torch.float32, device, seed=5)
            step, state = tensor.shard_train_step_tp(train.make_train_step(MOE_AUX), mesh,
                                                     state)
            batch = sharding.shard_batch(moe_cut_batch(torch, data, device),
                                         *sharding.dp_coordinate(mesh))
            losses = []
            for _ in range(2):
                state, loss = step(state, batch)
                losses.append(loss.item())
            full = sharding.gather_full_state(state.model)
            local = sum(p.numel() for p in state.model.parameters())
            results.append({"mesh": axes, "losses": losses, "state_dict": full,
                            "local_params": local})
            del state
        if rank == 0:
            torch.save(results, out_path)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def start_phase_13d() -> dict:
    """Start 13d's four gloo ranks (they share the card with what runs
    meanwhile: phase 12); :func:`run_phase_13d` waits for them."""
    import multiprocessing
    import pathlib

    from k8s_device_plugin_tpu_torch.parallel import distributed

    out_path = pathlib.Path(__file__).resolve().parent / "build" / "moe_ranks.pt"
    out_path.parent.mkdir(exist_ok=True)
    out_path.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    init = distributed.local_init_method()
    procs = [ctx.Process(target=_moe_rank, args=(r, 4, init, str(out_path))) for r in range(4)]
    for p in procs:
        p.start()
    return {"procs": procs, "out_path": out_path, "t0": time.perf_counter()}


def run_phase_13d(torch, tf, train, moe, data, started: dict) -> dict:
    """13d: dp x ep x tp over four gloo ranks sharing the card, float32, the
    cut config: each mesh's two steps against two unsharded steps on the
    card within TOL_DIST_F32 (relative).  Arithmetic, not a speed."""
    procs, out_path, t0 = started["procs"], started["out_path"], started["t0"]
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        fail(f"13d: the ranks exited with {[p.exitcode for p in procs]}")
    runs = torch.load(out_path, weights_only=False)
    state = moe_state(torch, tf, train, moe, MOE_CUT, torch.float32, DEVICE, seed=5)
    want_losses, want = moe_steps(torch, state, train, moe_cut_batch(torch, data, DEVICE), 2)
    del state
    out = {"ranks": 4, "backend": "gloo", "ranks_per_card": 4, "wall_s": wall,
           "tolerance": TOL_DIST_F32, "meshes": []}
    for run in runs:
        loss_err = max(_relative_errors(run["losses"], want_losses))
        param_err = _max_rel_err(torch, run["state_dict"], want)
        if not loss_err <= TOL_DIST_F32 or not param_err <= TOL_DIST_F32:
            fail(f"13d {run['mesh']}: loss rel {loss_err}, params rel {param_err} "
                 f"(tolerance {TOL_DIST_F32})")
        out["meshes"].append({"mesh": run["mesh"], "losses": run["losses"],
                              "loss_rel_err": loss_err, "param_rel_err": param_err,
                              "rank0_local_params": run["local_params"]})
    out["unsharded_losses"] = want_losses
    log(f"phase 13d: {out}")
    return out


def run_phase_13(torch, fa, tf, train, data, smi, mark, started_13d: dict) -> dict:
    """Phase 13: the MoE LM and its dp x ep x tp step (13d's ranks started
    by :func:`start_phase_13d`); the moe line."""
    from k8s_device_plugin_tpu_torch.parallel import moe

    full = run_phase_13a(torch, fa, tf, train, moe, data, smi)
    mark("13a_moe_train")
    parity = run_phase_13b_c(torch, fa, tf, train, moe, data)
    mark("13b_13c_moe_parity")
    shared = run_phase_13d(torch, tf, train, moe, data, started_13d)
    mark("13d_moe_ranks")
    return {"train": full, **parity, "dp_ep_tp": shared, "card": smi}


# ---------------------------------------------------------------- phase 14

# 14a: phase 7's LM (b8 s1024, bf16 compute, float32 parameters), 1 warm-up
# and SP_STEPS - 1 timed steps a run.
SP_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16, num_kv_heads=4,
              intermediate_size=2816, max_seq=1024)
SP_BATCH, SP_SEQ, SP_STEPS = 8, 1024, 6
SP_KINDS = ("ulysses", "ring")
# 14b: phase 8's cut (2 layers, seq 256, its seeds), float32, each mesh with
# its engine over four gloo ranks sharing the card.
SP_CUT = dict(SP_CFG, num_layers=2, max_seq=256)
SP_MESHES = (({"dp": 2, "sp": 2}, "ulysses"), ({"dp": 1, "sp": 4}, "ring"),
             ({"dp": 1, "sp": 2, "tp": 2}, "ring"))
# What gloo does not carry on CUDA tensors, for the sp engines' exchanges.
SP_GLOO_NOT_CARRIED = ("c10d all_to_all_single (Ulysses) and batch_isend_irecv (the ring) on "
                       "CUDA tensors: a gloo group stages each exchange through host memory, "
                       "chosen by its backend and counted as host_staged",)


def sp_fresh(torch, tf, train, cfg, params, device, attention_fn=None):
    """A train state (SGD 0.1, momentum 0.9) over ``params``."""
    model = tf.TransformerLM(cfg, device=device, train=True, attention_fn=attention_fn)
    model.load_state_dict(params)
    return train.state_for(model, 0.1, 0.9)


def sp_steps(torch, step, state, batch, steps: int) -> tuple:
    """``steps`` steps from a fresh peak-memory count: the losses, ms a
    step and tokens/s over all but the first, the peak allocated bytes and
    those allocated at the start (the train state and what earlier phases
    hold); the final state dict on the host; and the state."""
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    state, loss = step(state, batch)
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (steps - 1)
    tokens = batch["input_ids"].numel()
    run = {"losses": [l.item() for l in losses], "step_time_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "memory_allocated_at_start": at_start}
    return run, {k: v.detach().cpu() for k, v in state.model.state_dict().items()}, state


def sp_profiled(torch, step, state, batch) -> dict:
    """One more step traced after a warm-up one (:func:`profiled_step`):
    its wall and device ms and the device's busy share."""
    _, wall, stats = profiled_step(step, state, batch)
    return {"wall_ms": wall * 1e3, "device_ms": stats["device_us"] / 1e3,
            "busy_share": stats["busy_share"]}


def sp_host_ops(torch, step, state, batch) -> dict:
    """One more step traced on the host alone, after a warm-up one: each
    operator's self host ms and calls, by name."""
    from torch.profiler import ProfilerActivity, profile

    state, loss = step(state, batch)
    loss.item()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, loss = step(state, batch)
        loss.item()
    return {e.key: (e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()}


def sp_host_delta(mine: dict, dense: dict, top: int = 10) -> dict:
    """Where a sharded step's host time goes beyond the unsharded one's:
    both steps' self host ms in total and the ``top`` operators by the
    difference."""
    names = sorted(set(mine) | set(dense),
                   key=lambda k: -(mine.get(k, (0, 0))[0] - dense.get(k, (0, 0))[0]))
    return {"self_host_ms": sum(ms for ms, _ in mine.values()),
            "unsharded_self_host_ms": sum(ms for ms, _ in dense.values()),
            "top": [{"op": k, "ms": mine.get(k, (0, 0))[0], "calls": mine.get(k, (0, 0))[1],
                     "unsharded_ms": dense.get(k, (0, 0))[0]} for k in names[:top]]}


def run_phase_14a(torch, fa, tf, train, data, smi) -> dict:
    """14a: ``sequence.shard_train_step_sp`` at (dp 1, sp 1) over an NCCL
    world of one, Ulysses and then the ring, against the unsharded step on
    the card at phase 7's width: Ulysses bit for bit with kernels 2-4
    launched layers x steps on ``wgmma``, the ring (its float32 einsum
    fold in place of kernel 2) within TOL_DIST_BF16 and launching none of
    them.  Ulysses issues its exchanges over the one rank, counted; a ring
    of one has no hop to make."""
    from k8s_device_plugin_tpu_torch.parallel import distributed, sequence

    cfg = tf.GPTConfig(**SP_CFG, dtype=torch.bfloat16)
    params = tf.init_params(cfg, 14)
    batch = data.synthetic_lm_batch(SP_BATCH, SP_SEQ, cfg.vocab_size,
                                    generator=torch.Generator(device=DEVICE).manual_seed(14),
                                    device=DEVICE)
    fa.reset_launches()
    step = train.make_train_step()
    dense, want, state = sp_steps(torch, step, sp_fresh(torch, tf, train, cfg, params, DEVICE),
                                  batch, SP_STEPS)
    dense["launches"] = flash_launches(fa)[0]
    dense["profiled_step"] = sp_profiled(torch, step, state, batch)
    dense_ops = sp_host_ops(torch, step, state, batch)
    del step, state
    torch.cuda.empty_cache()
    n = cfg.num_layers * SP_STEPS
    runs = {}
    distributed.join_local(DEVICE, 0, 1, distributed.local_init_method(), "nccl")
    try:
        mesh = distributed.make_slice_mesh({"dp": 1, "sp": 1}, device_type=DEVICE)
        for kind in SP_KINDS:
            fn = sequence.sp_attention_fn(mesh, kind=kind)
            step, state = sequence.shard_train_step_sp(
                train.make_train_step(), mesh, sp_fresh(torch, tf, train, cfg, params, DEVICE, fn))
            fa.reset_launches()
            mine = sequence.sp_batch_sharding(batch, mesh)
            run, got, state = sp_steps(torch, step, state, mine, SP_STEPS)
            launches, by_design = flash_launches(fa)
            calls = dict(fn.sp.calls)
            run.update(launches=launches, launches_by_design=by_design, sp_calls=calls,
                       loss_rel_err=max(_relative_errors(run["losses"], dense["losses"])),
                       param_rel_err=_max_rel_err(torch, got, want),
                       profiled_step=sp_profiled(torch, step, state, mine),
                       host_ops=sp_host_delta(sp_host_ops(torch, step, state, mine), dense_ops))
            del step, state
            torch.cuda.empty_cache()
            if calls.get("host_staged"):
                fail(f"14a {kind}: an NCCL group staged {calls['host_staged']} exchanges "
                     "through host memory")
            if kind == "ulysses":
                equal = run["losses"] == dense["losses"] and all(torch.equal(got[k], want[k])
                                                               for k in want)
                if not equal:
                    fail(f"14a: Ulysses at sp 1 is not the unsharded step bit for bit: loss rel "
                         f"{run['loss_rel_err']}, params rel {run['param_rel_err']}")
                for name, count in launches.items():
                    if count != n:
                        fail(f"14a Ulysses launched {name} {count} times, not {cfg.num_layers} "
                             f"x {SP_STEPS} steps")
                for kernel, counts in by_design.items():
                    expect_designs(counts, "wgmma", n, f"14a Ulysses's {kernel} kernel")
                if calls["all_to_all"] != cfg.num_layers * SP_STEPS * 8:
                    fail(f"14a Ulysses issued {calls['all_to_all']} all-to-alls, not 8 a "
                         "layer a step (q, k, v and the output, and their gradients)")
                run["bit_for_bit"] = True
            else:
                if any(launches.values()):
                    fail(f"14a: the ring launched kernels 2-4: {launches}")
                if not (run["loss_rel_err"] <= TOL_DIST_BF16
                        and run["param_rel_err"] <= TOL_DIST_BF16):
                    fail(f"14a ring: loss rel {run['loss_rel_err']}, params rel "
                         f"{run['param_rel_err']} (tolerance {TOL_DIST_BF16})")
                if calls.get("ring_shift"):
                    fail(f"14a ring issued {calls['ring_shift']} shifts: a ring of one has no "
                         "hop to make")
            runs[kind] = run
            log(f"phase 14a {kind}: {run}")
    finally:
        torch.distributed.destroy_process_group()
    # The unsharded step once more, so each run is timed between two of it.
    again = sp_steps(torch, train.make_train_step(),
                     sp_fresh(torch, tf, train, cfg, params, DEVICE), batch, SP_STEPS)[0]
    torch.cuda.empty_cache()
    dense["step_time_ms_after"] = again["step_time_ms"]
    return {"config": f"{SP_CFG}, bf16 compute, float32 params, SGD 0.1/0.9, batch {SP_BATCH}, "
                      f"seq {SP_SEQ}, {SP_STEPS} steps (1 warm-up)",
            "mesh": {"dp": 1, "sp": 1}, "backend": "nccl", "unsharded": dense, **runs,
            "tolerance_ring": TOL_DIST_BF16, "card": smi}


def sp_cut(torch, tf, data, device):
    """14b's config, phase 8's parameters and batch (float32, on ``device``)."""
    cfg = tf.GPTConfig(**SP_CUT, dtype=torch.float32)
    batch = data.synthetic_lm_batch(2, SP_CUT["max_seq"], cfg.vocab_size,
                                    generator=torch.Generator().manual_seed(6), device=device)
    return cfg, tf.init_params(cfg, 5), batch


def _sp_rank(rank: int, world: int, init_method: str, out_path: str) -> None:
    """A phase 14b rank: each mesh of SP_MESHES for two steps of the cut LM
    in float32, gloo ranks sharing the card; rank 0 saves."""
    import torch

    from k8s_device_plugin_tpu_torch.models import data, train
    from k8s_device_plugin_tpu_torch.models import transformer as tf
    from k8s_device_plugin_tpu_torch.ops import flash_attention as fa
    from k8s_device_plugin_tpu_torch.parallel import distributed, sequence, sharding
    from k8s_device_plugin_tpu_torch.utils.device import fp32_reference_precision

    fp32_reference_precision()
    device = distributed.join_local(DEVICE, rank, world, init_method, "gloo")
    results = []
    try:
        for axes, kind in SP_MESHES:
            mesh = distributed.make_slice_mesh(axes, device_type=DEVICE)
            fn = sequence.sp_attention_fn(mesh, kind=kind)
            cfg, params, batch = sp_cut(torch, tf, data, device)
            step, state = sequence.shard_train_step_sp(
                train.make_train_step(), mesh, sp_fresh(torch, tf, train, cfg, params, device, fn))
            batch = sequence.sp_batch_sharding(batch, mesh)
            fa.reset_launches()
            losses = []
            for _ in range(2):
                state, loss = step(state, batch)
                losses.append(loss.item())
            mine = {"launches_by_design": flash_launches(fa)[1], "sp_calls": dict(fn.sp.calls)}
            every = [None] * world
            torch.distributed.all_gather_object(every, mine)
            full = sharding.gather_full_state(state.model)
            results.append({"mesh": axes, "kind": kind, "losses": losses, "state_dict": full,
                            "by_rank": every})
            del state
        if rank == 0:
            torch.save(results, out_path)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def start_phase_14b() -> dict:
    """Start 14b's four gloo ranks (beside phase 12 and 13d's ranks);
    :func:`run_phase_14` waits for them."""
    import multiprocessing
    import pathlib

    out_path = pathlib.Path(__file__).resolve().parent / "build" / "sp_ranks.pt"
    rendezvous = out_path.with_suffix(".rendezvous")
    out_path.parent.mkdir(exist_ok=True)
    out_path.unlink(missing_ok=True)
    rendezvous.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    # A file rendezvous: no port picked beside 13d's, which starts just before.
    init = f"file://{rendezvous}"
    procs = [ctx.Process(target=_sp_rank, args=(r, 4, init, str(out_path))) for r in range(4)]
    for p in procs:
        p.start()
    return {"procs": procs, "out_path": out_path, "t0": time.perf_counter()}


def run_phase_14b(torch, fa, tf, train, data, started: dict) -> dict:
    """14b: dp x sp (x tp) over four gloo ranks sharing the card, float32,
    phase 8's cut: each mesh's two steps against two unsharded steps on the
    card within TOL_DIST_F32 (relative); Ulysses's ranks launch kernels
    2-4 as their FMA builds, the ring's none.  Arithmetic, not a speed."""
    procs, out_path, t0 = started["procs"], started["out_path"], started["t0"]
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        fail(f"14b: the ranks exited with {[p.exitcode for p in procs]}")
    runs = torch.load(out_path, weights_only=False)
    cfg, params, batch = sp_cut(torch, tf, data, DEVICE)
    fa.reset_launches()
    step, state = train.make_train_step(), sp_fresh(torch, tf, train, cfg, params, DEVICE)
    want_losses = []
    for _ in range(2):
        state, loss = step(state, batch)
        want_losses.append(loss.item())
    want = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    del state
    out = {"ranks": 4, "backend": "gloo", "ranks_per_card": 4, "wall_s": wall,
           "tolerance": TOL_DIST_F32, "gloo_not_carried": list(SP_GLOO_NOT_CARRIED),
           "times": "staged through host memory by gloo: not a speed", "meshes": []}
    for run in runs:
        loss_err = max(_relative_errors(run["losses"], want_losses))
        param_err = _max_rel_err(torch, run["state_dict"], want)
        what = f"14b {run['kind']} {run['mesh']}"
        if not loss_err <= TOL_DIST_F32 or not param_err <= TOL_DIST_F32:
            fail(f"{what}: loss rel {loss_err}, params rel {param_err} (tolerance {TOL_DIST_F32})")
        for rank, mine in enumerate(run["by_rank"]):
            calls = mine["sp_calls"]
            exchanges = calls.get("all_to_all", 0) + calls.get("ring_shift", 0)
            if not exchanges or calls.get("host_staged", 0) != exchanges:
                fail(f"{what} rank {rank}: {exchanges} exchanges, {calls.get('host_staged', 0)} "
                     "staged through host memory: a gloo group stages every one")
            for kernel, counts in mine["launches_by_design"].items():
                if run["kind"] == "ulysses":
                    expect_designs(counts, "fma", 2 * cfg.num_layers,
                                   f"{what} rank {rank} {kernel}")
                elif any(counts.values()):
                    fail(f"{what} rank {rank}: the ring launched kernel {kernel}: {counts}")
        out["meshes"].append({"mesh": run["mesh"], "kind": run["kind"], "losses": run["losses"],
                              "loss_rel_err": loss_err, "param_rel_err": param_err,
                              "by_rank": run["by_rank"]})
    out["unsharded_losses"] = want_losses
    log(f"phase 14b: {out}")
    return out


def run_phase_14(torch, fa, tf, train, data, smi, mark, started_14b: dict) -> dict:
    """Phase 14: sequence-parallel LM training (14b's ranks started by
    :func:`start_phase_14b`); the sp line."""
    world_of_one = run_phase_14a(torch, fa, tf, train, data, smi)
    mark("14a_sp_world_of_one")
    shared = run_phase_14b(torch, fa, tf, train, data, started_14b)
    mark("14b_sp_ranks")
    return {"world_of_one": world_of_one, "dp_sp_tp": shared, "card": smi}


# ---------------------------------------------------------------- phase 15

# 15a: phase 7's LM (SP_CFG, b8 s1024, bf16 compute, float32 parameters) at
# pp 1 over an NCCL world of one, PP_WARMUP + PP_TIMED steps a run.
PP_MICRO, PP_WARMUP, PP_TIMED = 4, 2, 4
PP_SCHEDULES = ("gpipe", "1f1b")
# Kernel 2's launches a layer and microbatch in one step: 1F1B's forward
# unit runs the stage without autograd and its backward unit again under it.
PP_FORWARDS = {"gpipe": 1, "1f1b": 2}
# 15b: phase 8's full width cut to 4 layers (seq 256, batch 8), float32, pp 4
# over four gloo ranks sharing the card, two steps of each schedule.
PP_CUT = dict(SP_CFG, num_layers=4, max_seq=256)
PP_CUT_BATCH, PP_RANKS, PP_CUT_STEPS = 8, 4, 2
# 15c: the CLI's pipelined path on two gloo ranks sharing the card, at the
# tiny config (bf16: its transfers are staged bf16 tensors).
PP_CLI_FLAGS = ["--model=gpt", "--tiny", "--pp=2", "--pp-schedule=1f1b", "--n-micro=4",
                "--batch-size=8", "--seq-len=64", "--steps=2", "--warmup=1"]
# The reference's gpt-pp record (k8s_device_plugin_tpu/models/benchmark.py
# run_pipelined), plus the port's ``device``.
GPT_PP_KEYS = {"model", "schedule", "chips", "pp", "n_micro", "global_batch", "throughput",
               "unit", "step_time_ms", "final_loss", "device"}


def pp_steps(torch, step, state, batch) -> tuple:
    """PP_WARMUP then PP_TIMED steps from a fresh peak-memory count: every
    step's loss, ms a step and tokens/s over the timed ones, the peak
    allocated bytes and those allocated at the start; the final state dict
    on the host; and the state."""
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    losses = []
    for _ in range(PP_WARMUP):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PP_TIMED):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / PP_TIMED
    run = {"losses": [l.item() for l in losses], "step_time_ms": step_s * 1e3,
           "tokens_per_s": batch["input_ids"].numel() / step_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "memory_allocated_at_start": at_start}
    return run, {k: v.detach().cpu() for k, v in state.model.state_dict().items()}, state


def run_phase_15a(torch, fa, tf, train, data, smi) -> dict:
    """15a: ``PipelinedLM`` at pp 1 over an NCCL world of one, GPipe then
    1F1B, between two unsharded runs from the same weights (moved through
    ``convert``'s pipelined tree and back) at phase 7's width: every
    step's loss and the final parameters within TOL_DIST_BF16, kernels 2-4
    launched exactly per layer and active unit on ``wgmma``, no transfer,
    and 1F1B's peak memory below GPipe's; then one traced step of each run
    (wall and device ms, busy share)."""
    from k8s_device_plugin_tpu_torch import convert
    from k8s_device_plugin_tpu_torch.parallel import distributed
    from k8s_device_plugin_tpu_torch.parallel.pipeline_lm import PipelinedLM

    cfg = tf.GPTConfig(**SP_CFG, dtype=torch.bfloat16)
    params = tf.init_params(cfg, 15)
    staged = convert.pipelined_flax_to_state_dict(convert.pipelined_state_dicts_to_flax([params]),
                                                  stage=0)
    if set(staged) != set(params) or not all(torch.equal(staged[k], params[k]) for k in params):
        fail("15a: the LM's weights did not come back whole through the pipelined tree")
    batch = data.synthetic_lm_batch(SP_BATCH, SP_SEQ, cfg.vocab_size,
                                    generator=torch.Generator(device=DEVICE).manual_seed(15),
                                    device=DEVICE)

    def unsharded():
        step = train.make_train_step()
        run, got, state = pp_steps(torch, step, sp_fresh(torch, tf, train, cfg, params, DEVICE),
                                   batch)
        run["profiled_step"] = sp_profiled(torch, step, state, batch)
        del state
        torch.cuda.empty_cache()
        return run, got

    dense, want = unsharded()
    steps = PP_WARMUP + PP_TIMED
    runs = {}
    distributed.join_local(DEVICE, 0, 1, distributed.local_init_method(), "nccl")
    try:
        mesh = distributed.make_slice_mesh({"pp": 1}, device_type=DEVICE)
        for schedule in PP_SCHEDULES:
            plm = PipelinedLM(cfg, mesh, PP_MICRO, device=DEVICE)
            plm.load_state_dict(staged)
            state = plm.create_train_state(0.1, 0.9)
            step = plm.make_train_step(schedule)
            fa.reset_launches()
            run, got, state = pp_steps(torch, step, state, batch)
            launches, by_design = flash_launches(fa)
            run.update(launches=launches, launches_by_design=by_design, calls=dict(plm.pp.calls),
                       loss_rel_err=max(_relative_errors(run["losses"], dense["losses"])),
                       param_rel_err=_max_rel_err(torch, got, want),
                       profiled_step=sp_profiled(torch, step, state, batch))
            del plm, state, step
            torch.cuda.empty_cache()
            what = f"15a {schedule}"
            if run["calls"]:
                fail(f"{what}: a stage of one made {run['calls']}: no transfer was due")
            if not (run["loss_rel_err"] <= TOL_DIST_BF16 and run["param_rel_err"] <= TOL_DIST_BF16):
                fail(f"{what}: loss rel {run['loss_rel_err']}, params rel {run['param_rel_err']} "
                     f"(tolerance {TOL_DIST_BF16})")
            units = cfg.num_layers * PP_MICRO * steps
            want_launches = {"forward": PP_FORWARDS[schedule] * units, "dq": units, "dkv": units}
            for kernel, counts in by_design.items():
                expect_designs(counts, "wgmma", want_launches[kernel], f"{what}'s {kernel} kernel")
            runs[schedule] = run
            log(f"phase 15a {schedule}: {run}")
    finally:
        torch.distributed.destroy_process_group()
    again = unsharded()[0]
    dense["step_time_ms_after"] = again["step_time_ms"]
    if not runs["1f1b"]["max_memory_allocated"] < runs["gpipe"]["max_memory_allocated"]:
        fail(f"15a: 1F1B's peak {runs['1f1b']['max_memory_allocated']} B is not below GPipe's "
             f"{runs['gpipe']['max_memory_allocated']} B")
    return {"config": f"{SP_CFG}, bf16 compute, float32 params, SGD 0.1/0.9, batch {SP_BATCH}, "
                      f"seq {SP_SEQ}, n_micro {PP_MICRO}, {steps} steps ({PP_WARMUP} warm-up)",
            "pp": 1, "backend": "nccl", "unsharded": dense, **runs,
            "tolerance": TOL_DIST_BF16, "card": smi}


def pp_cut(torch, tf, data, device):
    """15b's config, weights and batch (float32, on ``device``)."""
    cfg = tf.GPTConfig(**PP_CUT, dtype=torch.float32)
    batch = data.synthetic_lm_batch(PP_CUT_BATCH, PP_CUT["max_seq"], cfg.vocab_size,
                                    generator=torch.Generator().manual_seed(15), device=device)
    return cfg, tf.init_params(cfg, 15), batch


def _pp_rank(rank: int, world: int, init_method: str, out_path: str) -> None:
    """A phase 15b rank: stage ``rank`` of the cut LM at pp 4, two steps of
    each schedule in float32, gloo ranks sharing the card; rank 0 saves."""
    import torch

    from k8s_device_plugin_tpu_torch.models import data
    from k8s_device_plugin_tpu_torch.models import transformer as tf
    from k8s_device_plugin_tpu_torch.ops import flash_attention as fa
    from k8s_device_plugin_tpu_torch.parallel import distributed
    from k8s_device_plugin_tpu_torch.parallel.pipeline_lm import PipelinedLM
    from k8s_device_plugin_tpu_torch.utils.device import fp32_reference_precision

    fp32_reference_precision()
    device = distributed.join_local(DEVICE, rank, world, init_method, "gloo")
    results = {}
    try:
        mesh = distributed.make_slice_mesh({"pp": world}, device_type=DEVICE)
        cfg, params, batch = pp_cut(torch, tf, data, device)
        for schedule in PP_SCHEDULES:
            plm = PipelinedLM(cfg, mesh, PP_MICRO, device=device)
            plm.load_state_dict(params)
            state, step = plm.create_train_state(0.1, 0.9), plm.make_train_step(schedule)
            fa.reset_launches()
            losses = []
            for _ in range(PP_CUT_STEPS):
                state, loss = step(state, batch)
                losses.append(loss.item())
            mine = {"stage": plm.stage, "launches_by_design": flash_launches(fa)[1],
                    "calls": dict(plm.pp.calls),
                    "state_dict": {k: v.detach().cpu() for k, v in plm.state_dict().items()}}
            every = [None] * world
            torch.distributed.all_gather_object(every, mine)
            results[schedule] = {"losses": losses, "by_rank": every}
            del plm, state, step
        if rank == 0:
            torch.save(results, out_path)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def start_phase_15b() -> dict:
    """Start 15b's four gloo ranks (beside 13d's and 14b's);
    :func:`run_phase_15` waits for them."""
    import multiprocessing
    import pathlib

    out_path = pathlib.Path(__file__).resolve().parent / "build" / "pp_ranks.pt"
    rendezvous = out_path.with_suffix(".rendezvous")
    out_path.parent.mkdir(exist_ok=True)
    out_path.unlink(missing_ok=True)
    rendezvous.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{rendezvous}"
    procs = [ctx.Process(target=_pp_rank, args=(r, PP_RANKS, init, str(out_path)))
             for r in range(PP_RANKS)]
    for p in procs:
        p.start()
    return {"procs": procs, "out_path": out_path, "t0": time.perf_counter()}


def run_phase_15b(torch, fa, tf, train, data, started: dict) -> dict:
    """15b: pp 4 over four gloo ranks sharing the card, float32, GPipe and
    1F1B: each schedule's two steps against two unsharded steps on the card
    within TOL_DIST_F32 (relative), every transfer staged through host
    memory, each rank launching kernels 2-4 as their FMA builds once per
    layer and active unit.  Arithmetic, not a speed."""
    procs, out_path, t0 = started["procs"], started["out_path"], started["t0"]
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        fail(f"15b: the ranks exited with {[p.exitcode for p in procs]}")
    runs = torch.load(out_path, weights_only=False)
    cfg, params, batch = pp_cut(torch, tf, data, DEVICE)
    step, state = train.make_train_step(), sp_fresh(torch, tf, train, cfg, params, DEVICE)
    want_losses = []
    for _ in range(PP_CUT_STEPS):
        state, loss = step(state, batch)
        want_losses.append(loss.item())
    want = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    del state
    layers = cfg.num_layers // PP_RANKS
    out = {"ranks": PP_RANKS, "pp": PP_RANKS, "backend": "gloo", "wall_s": wall,
           "config": f"{PP_CUT}, float32, batch {PP_CUT_BATCH}, n_micro {PP_MICRO}, "
                     f"{PP_CUT_STEPS} steps", "tolerance": TOL_DIST_F32,
           "times": "staged through host memory by gloo: not a speed", "schedules": {}}
    for schedule, run in runs.items():
        what = f"15b {schedule}"
        got = {}
        for mine in run["by_rank"]:
            got.update(mine["state_dict"])
        loss_err = max(_relative_errors(run["losses"], want_losses))
        param_err = _max_rel_err(torch, got, want)
        if not loss_err <= TOL_DIST_F32 or not param_err <= TOL_DIST_F32:
            fail(f"{what}: loss rel {loss_err}, params rel {param_err} (tolerance {TOL_DIST_F32})")
        units = layers * PP_MICRO * PP_CUT_STEPS
        for rank, mine in enumerate(run["by_rank"]):
            calls = mine["calls"]
            if not calls.get("p2p") or calls.get("host_staged") != calls["p2p"]:
                fail(f"{what} rank {rank}: {calls.get('p2p')} transfers, "
                     f"{calls.get('host_staged')} staged through host memory: gloo stages "
                     "every one")
            want_launches = {"forward": PP_FORWARDS[schedule] * units, "dq": units, "dkv": units}
            for kernel, counts in mine["launches_by_design"].items():
                expect_designs(counts, "fma", want_launches[kernel], f"{what} rank {rank} {kernel}")
        out["schedules"][schedule] = {
            "losses": run["losses"], "loss_rel_err": loss_err, "param_rel_err": param_err,
            "by_rank": [{k: v for k, v in mine.items() if k != "state_dict"}
                        for mine in run["by_rank"]]}
    out["unsharded_losses"] = want_losses
    log(f"phase 15b: {out}")
    return out


def run_phase_15c(torch, bench) -> dict:
    """15c: ``benchmark.launch`` at PP_CLI_FLAGS on two gloo ranks sharing
    the card: one record with the reference's gpt-pp keys, finite loss."""
    got = bench.launch(bench.parse_args(PP_CLI_FLAGS), backend="gloo", local_ranks=2)
    record = got.record
    if set(record) != GPT_PP_KEYS:
        fail(f"15c: the gpt-pp record's keys are {sorted(record)}, not {sorted(GPT_PP_KEYS)}")
    want = {"model": "gpt-pp", "schedule": "1f1b", "pp": 2, "n_micro": 4, "chips": 2,
            "global_batch": 8, "device": torch.cuda.get_device_name(0)}
    if {k: record[k] for k in want} != want or not math.isfinite(record["final_loss"]):
        fail(f"15c: the gpt-pp record is {record}")
    log(f"phase 15c: {record}")
    return {"flags": PP_CLI_FLAGS, "backend": "gloo", "ranks_per_card": 2, "record": record,
            "losses": got.losses, "times": "staged through host memory by gloo: not a speed"}


def run_phase_15(torch, fa, tf, train, data, bench, smi, mark, started_15b: dict) -> dict:
    """Phase 15: pipeline-parallel LM training (15b's ranks started by
    :func:`start_phase_15b`); the pipeline line."""
    world_of_one = run_phase_15a(torch, fa, tf, train, data, smi)
    mark("15a_pp_world_of_one")
    shared = run_phase_15b(torch, fa, tf, train, data, started_15b)
    mark("15b_pp_ranks")
    cli = run_phase_15c(torch, bench)
    mark("15c_pp_cli")
    return {"world_of_one": world_of_one, "pp4_shared_card": shared, "cli": cli, "card": smi}


# ------------------------------------------------------------- phase 16

PLUGIN_PULSE_S = 0.25
# The daemon's stream must show an override within this (a heartbeat
# pulse, the sweep that reads it, and the gRPC delivery).
PLUGIN_FLIP_LIMIT_S = 2 * PLUGIN_PULSE_S
SELFTEST_SEEDS = (0, 1, 2)
POD_PROMPT = [(29 * j + 7) % 32000 for j in range(64)]
POD_NEW = 16


def smi_cards() -> list[dict]:
    """The cards as nvidia-smi lists them: index, PCI address (None where
    the driver reports none), UUID and device-node minor.  The minor
    comes from ``nvidia-smi -q``: ``--query-gpu`` has no minor_number
    field on every driver."""
    from k8s_device_plugin_tpu_torch.plugin.discovery import pci_address

    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,pci.bus_id,uuid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    query = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True, check=True,
                           timeout=60).stdout
    minors = [int(m) for m in re.findall(r"Minor Number\s*:\s*(\d+)", query)]
    if len(minors) != len(rows):
        fail(f"nvidia-smi lists {len(rows)} card(s) but {len(minors)} minor number(s)")
    cards = []
    for row, minor in zip(rows, minors):
        index, bus, uuid = (x.strip() for x in row.split(","))
        cards.append({"index": int(index), "minor": minor, "uuid": uuid,
                      "pci": None if "N/A" in bus else pci_address(bus)})
    return cards


def plugin_root() -> str:
    """A host tree for the daemon under a short /tmp path: the real dev,
    proc and sys through symlinks, and its own run/gpu for the health
    override files (so no file outside the tree is written)."""
    import os
    import tempfile

    root = tempfile.mkdtemp(dir="/tmp", prefix="p16-")
    for name in ("dev", "proc", "sys"):
        os.symlink(f"/{name}", os.path.join(root, name))
    os.makedirs(os.path.join(root, "run/gpu/health"))
    return root


def run_phase_16a(torch, smi) -> tuple:
    """Discovery on the real host against nvidia-smi, through the probe
    library built from the checkout's source, and one health sweep."""
    import pathlib

    from k8s_device_plugin_tpu_torch.plugin import discovery, health, native

    t0 = time.perf_counter()
    lib = pathlib.Path(native.build_probe_library())
    build_s = time.perf_counter() - t0
    if not lib.is_relative_to(pathlib.Path(__file__).resolve().parent / "build"):
        fail(f"the probe library {lib} is not the checkout's build")
    prober = native.load_prober(str(lib))
    if native.shared_prober() is None:
        fail("the daemon's shared prober did not load")
    inv = discovery.discover("/", environ={}, prober=prober)
    want = smi_cards()
    got = [{"minor": c.index, "uuid": c.uuid, "pci": c.pci_address} for c in inv.cards]
    if [(c["minor"], c["uuid"]) for c in got] != [(c["minor"], c["uuid"]) for c in want]:
        fail(f"discover('/') found minors {[c['minor'] for c in got]}, nvidia-smi "
             f"{[c['minor'] for c in want]} (or their UUIDs differ)")
    for g, w in zip(got, want):
        if w["pci"] is not None and g["pci"] != w["pci"]:
            fail(f"card minor {g['minor']}: PCI address {g['pci']} against nvidia-smi's {w['pci']}")
    if inv.card_count != torch.cuda.device_count():
        fail(f"discover('/') found {inv.card_count} card(s), torch {torch.cuda.device_count()}")
    checker = health.CardHealthChecker("/", prober=prober)
    verdicts = checker.check_many(inv.cards)
    if not all(verdicts.values()):
        fail(f"a card reads Unhealthy: {verdicts}")
    sweeps = 200
    t0 = time.perf_counter()
    for _ in range(sweeps):
        checker.check_many(inv.cards)
    sweep_ms = (time.perf_counter() - t0) / sweeps * 1e3
    log(f"16a: {inv.card_count} card(s) from {inv.source}: {got}; a health sweep "
        f"{sweep_ms:.4f} ms ({smi})")
    return {"source": inv.source, "cards": got, "nvidia_smi": want,
            "probe_library": str(lib.relative_to(pathlib.Path(__file__).resolve().parent)),
            "probe_build_s": build_s, "health": verdicts,
            "health_sweep_ms_per_card": sweep_ms / inv.card_count, "card": smi}, inv


class SmokeKubelet:
    """The kubelet's Registration service on ``<plugin_dir>/kubelet.sock``:
    records each RegisterRequest; the script then dials the registered
    plugin itself."""

    def __init__(self, plugin_dir: str):
        import threading

        self.plugin_dir = plugin_dir
        self.requests = []
        self.registered = threading.Event()
        self._server = None

    def Register(self, request, context):  # noqa: N802 — the gRPC method name
        from k8s_device_plugin_tpu_torch.kubelet.api import pb

        self.requests.append(request)
        self.registered.set()
        return pb.Empty()

    def start(self) -> None:
        import os
        from concurrent import futures

        import grpc

        from k8s_device_plugin_tpu_torch.kubelet.api import add_registration_servicer

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        add_registration_servicer(self, self._server)
        self._server.add_insecure_port(f"unix://{os.path.join(self.plugin_dir, 'kubelet.sock')}")
        self._server.start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=None).wait()

    def plugin_stub(self):
        import os

        import grpc

        from k8s_device_plugin_tpu_torch.kubelet.api import DevicePluginStub

        sock = os.path.join(self.plugin_dir, self.requests[-1].endpoint)
        return DevicePluginStub(grpc.insecure_channel(f"unix://{sock}"))


class DeviceStream:
    """One ListAndWatch stream read on a thread: each update as a dict of
    id -> health, stamped on arrival."""

    def __init__(self, stub):
        import queue
        import threading

        from k8s_device_plugin_tpu_torch.kubelet.api import pb

        self.updates = queue.Queue()
        self.call = stub.ListAndWatch(pb.Empty())
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        import grpc

        try:
            for resp in self.call:
                self.updates.put((time.perf_counter(), {d.ID: d.health for d in resp.devices}))
        except grpc.RpcError:
            pass
        self.updates.put(None)

    def until(self, pred, what: str, timeout: float = 30.0) -> tuple:
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                item = self.updates.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                fail(f"16b: the ListAndWatch stream never showed {what}")
            if item is None:
                fail(f"16b: the ListAndWatch stream ended before {what}")
            if pred(item[1]):
                return item


def run_phase_16b(inv, smi) -> tuple:
    """The real daemon against the script's kubelet: registration,
    ListAndWatch, GetPreferredAllocation and Allocate of one card, the
    health override's flip and abort, recovery, SIGTERM."""
    import os
    import pathlib
    import signal
    import tempfile

    import grpc

    from k8s_device_plugin_tpu_torch.kubelet.api import pb

    card = inv.cards[0]
    root = plugin_root()
    plugin_dir = tempfile.mkdtemp(dir="/tmp", prefix="p16k-")
    kubelet = SmokeKubelet(plugin_dir)
    kubelet.start()
    out_dir = pathlib.Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log_path = out_dir / "plugin_daemon.log"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch.plugin.cli", "--root", root,
         "--plugin-dir", plugin_dir, f"--pulse={PLUGIN_PULSE_S}", "--health-flap-threshold=1",
         "--require-chips"],
        stdout=subprocess.DEVNULL, stderr=open(log_path, "w"))
    rec = {"pulse_s": PLUGIN_PULSE_S, "transport": "grpc", "card": smi}
    try:
        if not kubelet.registered.wait(60):
            fail(f"16b: the daemon never registered: {log_path.read_text()[-3000:]}")
        rec["registration_s"] = time.perf_counter() - t0
        req = kubelet.requests[-1]
        if (req.version, req.resource_name, req.endpoint) != (
                "v1beta1", "nvidia.com/gpu", "nvidia.com_gpu.sock"):
            fail(f"16b: registered {req}")
        stub = kubelet.plugin_stub()
        stream = DeviceStream(stub)
        _, first = stream.until(lambda devs: True, "a device list")
        ids = [c.k8s_id for c in inv.cards]
        if first != {i: "Healthy" for i in ids}:
            fail(f"16b: the first list is {first}, not {ids} Healthy")
        pref = stub.GetPreferredAllocation(pb.PreferredAllocationRequest(container_requests=[
            pb.ContainerPreferredAllocationRequest(available_deviceIDs=ids, allocation_size=1)]))
        rec["preferred"] = list(pref.container_responses[0].deviceIDs)
        if rec["preferred"] != [card.k8s_id]:
            fail(f"16b: GetPreferredAllocation chose {rec['preferred']}")
        request = pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(devicesIDs=[card.k8s_id])])
        t = time.perf_counter()
        resp = stub.Allocate(request)
        allocated_at = time.perf_counter()
        rec["allocate_ms"] = (allocated_at - t) * 1e3
        [car] = resp.container_responses
        granted = {"envs": dict(car.envs), "devices": [d.host_path for d in car.devices]}
        rec["granted"] = granted
        shared = [p for p in ("/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools")
                  if os.path.exists(os.path.join(root, p.lstrip("/")))]
        if granted["devices"] != [card.device_path, *shared]:
            fail(f"16b: Allocate granted {granted['devices']}")
        if (granted["envs"].get("NVIDIA_VISIBLE_DEVICES"), granted["envs"].get("GPU_DEVICE_MINORS")) != (
                card.uuid, str(card.index)):
            fail(f"16b: Allocate injected {granted['envs']}")
        override = os.path.join(root, "run/gpu/health", f"nvidia{card.index}")
        with open(override, "w") as f:
            f.write("Unhealthy")
        t = time.perf_counter()
        seen, _ = stream.until(lambda devs: devs.get(card.k8s_id) == "Unhealthy", "Unhealthy")
        rec["unhealthy_after_s"] = seen - t
        if rec["unhealthy_after_s"] > PLUGIN_FLIP_LIMIT_S:
            fail(f"16b: the override showed after {rec['unhealthy_after_s']:.3f} s, over "
                 f"{PLUGIN_FLIP_LIMIT_S} s")
        try:
            stub.Allocate(request)
            fail("16b: Allocate of an Unhealthy card answered")
        except grpc.RpcError as e:
            rec["unhealthy_abort"] = e.code().name
        if rec["unhealthy_abort"] != "FAILED_PRECONDITION":
            fail(f"16b: Allocate of an Unhealthy card aborted {rec['unhealthy_abort']}")
        os.unlink(override)
        t = time.perf_counter()
        seen, _ = stream.until(lambda devs: devs.get(card.k8s_id) == "Healthy", "Healthy again")
        rec["healthy_after_s"] = seen - t
        socket = os.path.join(plugin_dir, req.endpoint)
        proc.send_signal(signal.SIGTERM)
        rec["exit"] = proc.wait(timeout=30)
        if rec["exit"] != 0 or os.path.exists(socket):
            fail(f"16b: SIGTERM: exit {rec['exit']}, socket left: {os.path.exists(socket)}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kubelet.stop()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(plugin_dir, ignore_errors=True)
    log(f"16b: registered in {rec['registration_s']:.2f} s, Allocate {rec['allocate_ms']:.3f} ms, "
        f"Unhealthy after {rec['unhealthy_after_s']:.3f} s ({smi})")
    return rec, granted, allocated_at


def pod_env(granted: dict) -> dict:
    """A pod's environment: this one's without any card or worker variable,
    plus exactly what Allocate ``granted``."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("GPU_", "TPU_")) and k not in ("NVIDIA_VISIBLE_DEVICES",
                                                               "CUDA_VISIBLE_DEVICES")}
    env.update(granted["envs"])
    # The NVIDIA container runtime mounts only the cards NVIDIA_VISIBLE_DEVICES
    # names, so CUDA in the container numbers exactly those from 0; outside a
    # container the same view is CUDA_VISIBLE_DEVICES set to their UUIDs.
    env["CUDA_VISIBLE_DEVICES"] = granted["envs"]["NVIDIA_VISIBLE_DEVICES"]
    return env


def run_phase_16c(granted: dict, allocated_at: float, smi) -> dict:
    """The pod: the port's HTTP server at the deployment's flags, started
    with exactly the granted env, serving two requests; its chip-health
    feed watches the granted node and kernel 1 launches."""
    import pathlib

    env = pod_env(granted)
    log_path = pathlib.Path(__file__).resolve().parent / "chiprun_out" / "plugin_pod.log"
    proc, port = start_server((*SERVE_FLAGS, snapshot_flag("plugin_pod")), log_path, env)
    try:
        up_s = time.perf_counter() - allocated_at
        first = stream_request(port, {"prompt": POD_PROMPT, "max_new_tokens": POD_NEW})
        if first["status"] != 200 or not first["stamps"]:
            fail(f"16c: the pod's streamed request answered {first['status']}: {first['body']}")
        status, body = http_call(port, "/generate", {"prompt": POD_PROMPT[:32],
                                                     "max_new_tokens": POD_NEW})
        if status != 200 or len(body["tokens"]) != POD_NEW:
            fail(f"16c: the pod's unary request answered {status}: {body}")
        status, state = http_call(port, "/debug/state")
    except BaseException:
        proc.kill()
        raise
    drain_s = stop_server(proc, log_path)
    minors = granted["envs"]["GPU_DEVICE_MINORS"].split(",")
    feed = state["fence"]["chip_health"]
    watched = feed["device_paths"] if feed else None
    if watched != [f"/dev/nvidia{m}" for m in minors]:
        fail(f"16c: the pod's chip-health feed watches {watched}, not the granted "
             f"/dev/nvidia{minors}")
    dev = state["engine"]["device"]
    launches = dev["paged_launches"]["f"]
    if launches <= 0 or launches != dev["num_layers"] * dev["device_steps"]:
        fail(f"16c: the pod launched kernel 1 {launches} times over {dev['device_steps']} "
             f"steps of {dev['num_layers']} layers")
    rec = {"allocate_to_serving_s": up_s,
           "allocate_to_first_token_s": first["stamps"][0] - allocated_at,
           "first_request_ttft_s": first["stamps"][0] - first["t_send"],
           "chip_health_paths": watched, "paged_launches": launches,
           "device_steps": dev["device_steps"], "drain_s": drain_s, "card": smi}
    log(f"16c: Allocate -> first token {rec['allocate_to_first_token_s']:.2f} s, kernel 1 "
        f"{launches} launches ({smi})")
    return rec


# The single-card pods 16e runs as deployed: their manifests' command and
# args, read at run time (tests/test_torch_deploy.py holds the script to
# the manifests).
POD_MANIFESTS = ("k8s-pod-example-gpu.yaml", "k8s-pod-serve-gpt-gpu.yaml")


def manifest_container(name: str) -> dict:
    """``command``, ``args`` and the ``nvidia.com/gpu`` limit of the one
    container of the single-card pod manifest ``deploy/<name>``."""
    import pathlib

    import yaml

    with open(pathlib.Path(__file__).resolve().parent / "deploy" / name) as f:
        [pod] = [doc for doc in yaml.safe_load_all(f) if doc and doc["kind"] == "Pod"]
    [container] = pod["spec"]["containers"]
    limits = container.get("resources", {}).get("limits", {})
    return {"command": container["command"], "args": container["args"],
            "cards": int(limits.get("nvidia.com/gpu", 0))}


def run_pod(name: str, env: dict, log_path) -> tuple:
    """The pod ``name``'s container command as a subprocess of this
    checkout (its ``python`` this interpreter) under ``env``; returns
    (container, the one JSON record it printed, wall seconds).  Fails
    unless it exits 0 with exactly one record."""
    import pathlib

    container = manifest_container(name)
    if container["cards"] != 1:
        fail(f"16e: {name} asks for {container['cards']} cards, not one")
    cmd = [sys.executable if c == "python" else c for c in container["command"]]
    t0 = time.perf_counter()
    with open(log_path, "w") as err:
        proc = subprocess.run([*cmd, *container["args"]], env=env, stdout=subprocess.PIPE,
                              stderr=err, text=True, timeout=300,
                              cwd=pathlib.Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"16e: {name} exited {proc.returncode}: {open(log_path).read()[-3000:]}")
    records = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    if len(records) != 1:
        fail(f"16e: {name} printed {len(records)} JSON records: {proc.stdout[-2000:]}")
    return container, records[0], wall


def run_phase_16e(torch, bench, engine, granted: dict, smi) -> dict:
    """The single-card pods as deployed (POD_MANIFESTS), each under the env
    16c's pod gets: AlexNet's training benchmark and the w8 batch engine,
    each on the card."""
    import pathlib

    env = pod_env(granted)
    out_dir = pathlib.Path(__file__).resolve().parent / "chiprun_out"
    card_name = torch.cuda.get_device_name(0)
    rec = {"card": smi}
    train_pod, serve_pod = POD_MANIFESTS
    container, record, wall = run_pod(train_pod, env, out_dir / "pod_alexnet.log")
    args = bench.parse_args(container["args"])
    if (record["model"], record["chips"], record["device"]) != (args.model, 1, card_name) \
            or record["final_step"] != 4 * args.warmup + args.steps \
            or not record["throughput"] > 0:
        fail(f"16e: {train_pod} ran {record}, not {args.model} on one {card_name} for "
             f"{4 * args.warmup + args.steps} steps")
    # Recorded, not required: at the pod's SGD 0.1 (no normalisation, one
    # fixed batch) the loss leaves the finite range within its 50 steps, on
    # the card and in the reference's own float32 run on the CPU alike
    # (PERF.md section 7, tools/train_loss_curve.py --reference).
    finite = record["final_loss"] is not None and math.isfinite(record["final_loss"])
    rec["alexnet"] = {"manifest": train_pod, "args": container["args"], "wall_s": wall,
                      "final_loss_finite": finite, "record": record}
    log(f"16e: {train_pod} in {wall:.1f} s: {record} ({smi})")
    container, record, wall = run_pod(serve_pod, env, out_dir / "pod_serve_gpt.log")
    args = engine.parse_args(container["args"])
    if (record["requests"], record["tokens"], record["quant"], record["device"]) != (
            args.requests, args.requests * args.max_new, args.quant, card_name) \
            or not record["value"] > 0:
        fail(f"16e: {serve_pod} ran {record}, not {args.requests} x {args.max_new} tokens at "
             f"--quant={args.quant} on one {card_name}")
    # The pod's process counted from 0: kernel 1's float-pool branch once a
    # layer on every dispatched step, the quantized branches never.
    launches = record["paged_launches"]
    if not record["kernel"] or launches["f"] != args.layers * record["device_steps"] \
            or launches["f"] <= 0 or launches["int8"] or launches["int4"]:
        fail(f"16e: {serve_pod} launched kernel 1 as {launches} over {record['device_steps']} "
             f"dispatched steps of {args.layers} layers (kernel {record['kernel']})")
    rec["serve_gpt"] = {"manifest": serve_pod, "args": container["args"], "wall_s": wall,
                        "record": record}
    log(f"16e: {serve_pod} in {wall:.1f} s: {record} ({smi})")
    return rec


def run_phase_16d(inv, smi) -> dict:
    """The idle-card self-test on the card: its checksum against the
    reference's for three seeds, a corrupt failpoint's quarantine and the
    health sweep after it, a busy card skipped, one probe timed."""
    import os

    from k8s_device_plugin_tpu_torch.plugin import health, selftest
    from k8s_device_plugin_tpu_torch.utils import failpoints

    card = inv.cards[0]
    sums = {seed: selftest.card_checksum(card, seed) for seed in SELFTEST_SEEDS}
    want = {seed: selftest.matmul_checksum(seed) for seed in SELFTEST_SEEDS}
    if sums != want:
        fail(f"16d: the card's checksums {sums} are not the reference's {want}")
    t = time.perf_counter()
    selftest.card_checksum(card, SELFTEST_SEEDS[0])
    probe_ms = (time.perf_counter() - t) * 1e3
    root = plugin_root()
    try:
        config = selftest.SelftestConfig(fail_threshold=2, seeds=SELFTEST_SEEDS)
        sweeper = selftest.SelftestSweeper(lambda: inv.cards, lambda: set(), config=config,
                                           root=root)
        verdicts = [sweeper.poll_once()]
        failpoints.arm_spec(f"{selftest.FAILPOINT_PROBE}.{card.k8s_id}=corrupt")
        try:
            verdicts += [sweeper.poll_once() for _ in range(config.fail_threshold)]
        finally:
            failpoints.disarm_all()
        if [v[card.k8s_id] for v in verdicts] != ["pass"] + ["fail"] * config.fail_threshold:
            fail(f"16d: the sweeps gave {verdicts}")
        if not sweeper.snapshot()["chips"][card.k8s_id]["quarantined"]:
            fail("16d: the corrupt card was not quarantined")
        after = health.CardHealthChecker(root).check_many(inv.cards)
        if after[card.k8s_id]:
            fail(f"16d: the quarantined card still reads Healthy: {after}")
        busy = selftest.SelftestSweeper(lambda: [card], lambda: {card.k8s_id},
                                        config=config, root=root,
                                        probe_fn=lambda c, s: fail("16d: a busy card was probed"))
        skipped = busy.poll_once()
        if skipped[card.k8s_id] != "skip_busy":
            fail(f"16d: the busy card's sweep gave {skipped}")
        os.unlink(health.override_path(root, card))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"16d: checksums equal for seeds {SELFTEST_SEEDS}; one probe {probe_ms:.3f} ms ({smi})")
    return {"checksums": {str(k): v for k, v in sums.items()}, "probe_ms": probe_ms,
            "verdicts": verdicts, "after_quarantine": after, "busy": skipped, "card": smi}


def run_phase_16(torch, bench, engine, smi, mark) -> dict:
    discovered, inv = run_phase_16a(torch, smi)
    mark("16a_discovery")
    daemon, granted, allocated_at = run_phase_16b(inv, smi)
    mark("16b_daemon")
    pod = run_phase_16c(granted, allocated_at, smi)
    mark("16c_pod")
    pods = run_phase_16e(torch, bench, engine, granted, smi)
    mark("16e_pods")
    selftest_run = run_phase_16d(inv, smi)
    mark("16d_selftest")
    return {"discovery": discovered, "daemon": daemon, "pod": pod, "pods": pods,
            "selftest": selftest_run, "card": smi}


# ---------------------------------------------------------------- phase 17

# deploy/k8s-deploy-router-gpu.yaml's router flags, but its replica list
# (here the static pair of in-process replicas), its port (ephemeral) and
# its dump directory (under build/); tests/test_torch_router.py holds the
# two lists equal.
ROUTER_FLAGS = (
    "--prefix-block-tokens=16", "--prefix-blocks=4", "--poll-interval=1",
    "--breaker-failures=3", "--breaker-open-s=5", "--retry-budget=32", "--hedge=1", "--slo=1",
    "--postmortem=1", "--dump-budget-mb=256", "--drain-grace=10",
)
# The routed traffic (the port's RouterTraffic): 8 sessions, each a
# 64-token prefix (4 KV pages, the affinity key) and a 1-16 token suffix,
# 4-32 new tokens, 64 requests from 8 client threads.
ROUTED = dict(sessions=8, prefix_len=64)
ROUTED_RUN = dict(concurrency=8, suffix_len=(1, 16), max_new=(4, 32))
ROUTED_REQUESTS = 64
ROUTED_SEED = 31
FAILOVER_REQUESTS, FAILOVER_NEW = 16, (24, 32)  # streams long enough to cut mid-decode


def start_router(names, flags, log_path, dump_dir, env) -> tuple:
    """The port's router (``python -m k8s_device_plugin_tpu_torch.router``)
    as a subprocess over ``names``; (process, port) once a replica polled
    reachable."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch.router",
         f"--replicas={','.join(names)}", "--http-port=0", f"--dump-dir={dump_dir}", *flags],
        stdout=subprocess.DEVNULL, stderr=open(log_path, "w"), env=env)
    return proc, await_http(proc, log_path, r"routing on :(\d+)", "router", 120)


def router_counters(port: int) -> dict:
    """The router's failover, retry, hedge and placement counters off its
    /metrics."""
    status, text = http_call(port, "/metrics")
    text = text.decode() if isinstance(text, bytes) else text
    out = {}
    for line in text.splitlines():
        m = re.match(r"(tpu_router_(?:failovers|retries|hedges|placements)_total)"
                     r"(\{[^}]*\})? ([0-9.e+-]+)$", line)
        if m:
            out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def routed_pass(traffic_mod, port: int, engines, n: int, **run_kw) -> tuple:
    """One replay of the routed traffic through the router at ``port``:
    (report, the request list, the replicas' KV-tier hits over it)."""
    traffic = traffic_mod.RouterTraffic("127.0.0.1", port, seed=ROUTED_SEED, vocab=32000,
                                        **ROUTED)
    hits0 = sum(e.kv_retained_hits + e.kv_host_hits for e in engines)
    report = traffic.run(n, timeout_s=300.0, **run_kw)
    hits = sum(e.kv_retained_hits + e.kv_host_hits for e in engines) - hits0
    requests = traffic.build_requests(n, suffix_len=run_kw["suffix_len"],
                                      max_new=run_kw["max_new"])
    return report, requests, hits


def routed_summary(report, hits: int, n: int) -> dict:
    """One routed pass: KV-tier hits a request (retained and host pages
    revived; a prefix page shared with a live request is not one), TTFT
    quantiles through the router, client tokens/s."""
    ttft = report.ttfts()
    return {"requests": n, "completed": report.completed, "dropped": report.dropped,
            "kv_hits": hits, "kv_hits_per_request": hits / n,
            "ttft_ms": {"p50": quantile(ttft, 0.5) * 1e3, "p99": quantile(ttft, 0.99) * 1e3},
            "tokens": report.tokens, "wall_s": report.duration_s,
            "tokens_per_s": report.tokens / report.duration_s}


def run_phase_17(torch, tf, http_server, pa, smi) -> dict:
    """Phase 17: the port's router in front of two port HTTP replicas of
    the deployed model on the card (in this process, the same weights, as
    a Deployment's replicas), the routed traffic under affinity then
    random placement, greedy streams held against the in-process engine,
    kernel 1 counted, then one replica stopped while streams are in
    flight."""
    import os
    import pathlib
    import threading

    from k8s_device_plugin_tpu_torch.models import traffic as traffic_mod
    from k8s_device_plugin_tpu_torch.utils.metrics import MetricsRegistry

    root = pathlib.Path(__file__).resolve().parent
    out_dir = root / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    args = http_server.parse_args([*SERVE_FLAGS, f"--device={DEVICE}"])
    servers = []
    for _ in range(2):
        registry = MetricsRegistry()
        eng = http_server.build_engine(args, registry=registry)
        servers.append(http_server.EngineServer(eng, host="127.0.0.1", port=0,
                                                registry=registry).start())
    engines = [s.engine for s in servers]
    names = [f"127.0.0.1:{s.port}" for s in servers]
    report = {"card": smi, "replica_flags": list(SERVE_FLAGS), "router_flags": list(ROUTER_FLAGS)}
    stopped = []
    try:
        # Each replica's first launches and CUDA graphs behind the timed
        # traffic, one replica at a time.
        warm = traffic_mod.RouterTraffic("127.0.0.1", 0, seed=ROUTED_SEED, vocab=32000, **ROUTED)
        warm_jobs = [(p, n) for p, n, _, _ in warm.build_requests(2, suffix_len=(16, 16),
                                                                  max_new=(32, 32))]
        report["warm_up_s"] = [warm_up(s.port, warm_jobs) for s in servers]
        passes = {}
        for mode in ("affinity", "random"):
            for eng in engines:
                eng.kvcache_clear()
            log_path = out_dir / f"router_{mode}.log"
            dump_dir = root / "build" / "dumps" / f"router_{mode}"
            shutil.rmtree(dump_dir, ignore_errors=True)
            dump_dir.mkdir(parents=True)
            proc, port = start_router(names, (*ROUTER_FLAGS, f"--policy={mode}"), log_path,
                                      dump_dir, env)
            try:
                steps0 = [e.device_steps for e in engines]
                torch.cuda.synchronize()
                pa.reset_launches()
                routed, requests, hits = routed_pass(traffic_mod, port, engines,
                                                     ROUTED_REQUESTS, **ROUTED_RUN)
                torch.cuda.synchronize()
                launches = dict(pa.paged_attention.launches_by_format)
                steps = [e.device_steps - s for e, s in zip(engines, steps0)]
                counters = router_counters(port)
            except BaseException:
                proc.kill()
                raise
            stop_server(proc, log_path)
            row = routed_summary(routed, hits, ROUTED_REQUESTS)
            row.update(device_steps=steps, paged_launches=launches, router=counters)
            want_launches = 8 * sum(steps)
            if launches != {"f": want_launches, "int8": 0, "int4": 0} or want_launches <= 0:
                fail(f"17 {mode}: kernel 1 launched {launches} over the replicas' {steps} "
                     f"device steps of 8 layers, not {want_launches}")
            if routed.dropped or routed.completed != ROUTED_REQUESTS:
                fail(f"17 {mode}: {routed.dropped} streams dropped, {routed.completed} of "
                     f"{ROUTED_REQUESTS} completed: {routed.as_dict()}")
            passes[mode] = (row, routed, requests)
            log(f"phase 17 {mode}: {row}")
        report["affinity"], report["random"] = passes["affinity"][0], passes["random"][0]

        # The failover: one replica stopped while streams are in flight
        # through the affinity router.
        dump_dir = root / "build" / "dumps" / "router_failover"
        shutil.rmtree(dump_dir, ignore_errors=True)
        dump_dir.mkdir(parents=True)
        log_path = out_dir / "router_failover.log"
        proc, port = start_router(names, (*ROUTER_FLAGS, "--policy=affinity"), log_path,
                                  dump_dir, env)
        try:
            traffic = traffic_mod.RouterTraffic("127.0.0.1", port, seed=ROUTED_SEED + 1,
                                                vocab=32000, **ROUTED)
            run_kw = dict(concurrency=8, suffix_len=(1, 16), max_new=FAILOVER_NEW)
            thread, holder = traffic.run_in_thread(FAILOVER_REQUESTS, timeout_s=300.0, **run_kw)
            # The victim is the first replica seen decoding a stream: the
            # affinity ring (over the replicas' ephemeral ports) may place
            # every session of this seed on one of them.
            deadline, victim = time.monotonic() + 120, None
            while victim is None:
                victim = next((s for s in servers if any(
                    r is not None and len(r.tokens) >= 4 for r in s.engine.slots)), None)
                if victim is None and time.monotonic() > deadline:
                    fail("17: no stream reached a replica to stop it under")
                time.sleep(0.01)
            # The replica stops: its fence cuts the in-flight streams (the
            # router resubmits each with the tokens it had), then it shuts down.
            victim.begin_fence(reason="stopped", source="operator")
            victim.stop()
            stopped.append(victim)
            thread.join(timeout=400)
            if thread.is_alive() or holder[0] is None:
                fail("17: the failover traffic did not resolve")
            cut = holder[0]
            failover_counters = router_counters(port)
        except BaseException:
            proc.kill()
            raise
        stop_server(proc, log_path)
        failovers = exit_dump_events(dump_dir, "router.failover", recorder="router")
        n_failovers = sum(v for k, v in failover_counters.items()
                          if k.startswith("tpu_router_failovers_total"))
        if cut.dropped or cut.completed != FAILOVER_REQUESTS or n_failovers < 1:
            fail(f"17 failover: {cut.dropped} dropped, {cut.completed} of {FAILOVER_REQUESTS} "
                 f"completed, {n_failovers} failovers: {cut.as_dict()}")
        failover_requests = traffic.build_requests(FAILOVER_REQUESTS, suffix_len=(1, 16),
                                                   max_new=FAILOVER_NEW)
    finally:
        for s in servers:
            if s not in stopped:
                s.stop()

    # The in-process engine on the same flags and weights (no limiter: it
    # takes each list at once): every routed greedy stream must be its
    # stream (or part from it at a near-tie), a failed-over one too, whole:
    # the surviving replica re-prefills the prompt and the tokens before the
    # cut, so past the cut it may part from the engine only at a near-tie.
    twin = http_server.build_engine(http_server.parse_args([*SERVE_FLAGS, f"--device={DEVICE}",
                                                            "--overload=0"]))
    held = {}
    for mode in ("affinity", "random"):
        _, routed, requests = passes[mode]
        jobs = [(p, n) for p, n, _, _ in requests]
        want = [list(r.tokens) for r in twin.run(jobs)]
        by_rid = {o.rid: o for o in routed.outcomes}
        got = [list(by_rid[f"traffic-{ROUTED_SEED}-{i}"].tokens) for i in range(len(jobs))]
        held[mode] = hold_streams(torch, tf, twin.model, jobs, got, want, f"17 {mode}")
    jobs = [(p, n) for p, n, _, _ in failover_requests]
    want = [list(r.tokens) for r in twin.run(jobs)]
    cut_at = {e["rid"]: e["emitted"] for e in failovers}
    by_rid = {o.rid: o for o in cut.outcomes}
    failed_over = []
    for i, (job, tokens) in enumerate(zip(jobs, want)):
        rid = f"traffic-{ROUTED_SEED + 1}-{i}"
        got = list(by_rid[rid].tokens)
        if len(got) != job[1]:
            fail(f"17 failover: stream {i} returned {len(got)} of {job[1]} tokens")
        row = hold_streams(torch, tf, twin.model, [job], [got], [tokens],
                           f"17 failover stream {i}")
        at = cut_at.get(rid)
        row.update(stream=i, cut_at=at,
                   checked_after_cut=None if at is None else max(0, row["checked"] - at))
        failed_over.append(row)
    del twin
    torch.cuda.empty_cache()
    report["greedy_held"] = held
    report["failover"] = {"requests": FAILOVER_REQUESTS, "completed": cut.completed,
                          "dropped": cut.dropped, "failovers": n_failovers,
                          "failover_events": failovers, "router": failover_counters,
                          "streams_cut": sum(1 for r in failed_over if r["cut_at"] is not None),
                          "tokens_checked_after_cut": sum(r["checked_after_cut"] or 0
                                                          for r in failed_over),
                          "held": failed_over}
    report["paged_launches"] = sum(report[m]["paged_launches"]["f"]
                                   for m in ("affinity", "random"))
    log(f"phase 17: KV-tier hits a request affinity "
        f"{report['affinity']['kv_hits_per_request']:.2f} vs random "
        f"{report['random']['kv_hits_per_request']:.2f}, {n_failovers} failovers, 0 dropped "
        f"({smi})")
    return report


# ---------------------------------------------------------------- phase 18

# Gemma-2B's attention widths (hidden 2048, 8 heads on 1 kv head: head_dim
# 256, a kv group of 8) on the repo's own GPTConfig, as the serving CLIs
# take them (intermediate 3 x hidden); no Gemma-only feature.
GEMMA_FLAGS = ("--hidden=2048", "--heads=8", "--kv-heads=1", "--layers=18", "--vocab=256000",
               "--page-size=16")
# The server's pool: 8 slots of prompt 128 + 64 new tokens (12 pages each).
GEMMA_SERVE = (*GEMMA_FLAGS, "--num-pages=160", "--max-pages-per-seq=16", "--slots=8",
               "--decode-block=16", "--overload=0", "--slo=0")
GEMMA_JOBS = (8, 128, 64)  # requests, prompt, new tokens (greedy)
# Of 18: the depth of the bf16 training steps and of greedy_generate, cut
# to fit the time (their weights, one CPU init, serve both).
GEMMA_TRAIN_LAYERS = 4
GEMMA_TRAIN = (4, 1024, 3)  # batch, seq, steps
# The 2-layer float32 checks: (name, hidden, heads, kv heads, vocab, page).
GEMMA_CHECKS = (
    ("A_gemma_2b", 2048, 8, 1, 256000, 16),
    ("B_falcon_7b", 4544, 71, 1, 65024, 12),
    ("C_starcoder", 6144, 48, 1, 49152, 24),
)


def gemma_config(tf, torch, hidden, heads, kv_heads, vocab, layers, dtype, max_seq=256):
    return tf.GPTConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                        num_heads=heads, num_kv_heads=kv_heads, intermediate_size=3 * hidden,
                        max_seq=max_seq, dtype=dtype)


def run_gemma_serve(torch, http_server, pa, smi) -> dict:
    """18a: the HTTP server at GEMMA_SERVE against its in-process twin,
    GEMMA_JOBS streamed one at a time."""
    import os
    import pathlib

    from k8s_device_plugin_tpu_torch.models.engine import synthetic_jobs

    root = pathlib.Path(__file__).resolve().parent
    (root / "chiprun_out").mkdir(exist_ok=True)
    log_path = root / "chiprun_out" / "serve_gemma.log"
    env = dict(os.environ, PYTHONPATH=str(root))
    n, prompt, new = GEMMA_JOBS
    jobs = synthetic_jobs(n, prompt, new, 256000)
    args = http_server.parse_args([*GEMMA_SERVE, f"--device={DEVICE}"])
    eng = http_server.build_engine(args)
    # One request at a time on both sides, the server's warm-up first
    # (warm_up: the first two prompts for 32 tokens): each prefill and
    # decode then runs at batch 1 with the same cached pages on both, so
    # the streams compare bit for bit (at 256000 random logits a greedy
    # step's top two sit close, and another batch shape parts them).
    for p, _ in jobs[:2]:
        eng.run([(p, 32)])
    steps0 = eng.device_steps
    pa.reset_launches()
    t0 = time.perf_counter()
    done = [r for job in jobs for r in eng.run([job])]
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    twin_launches = pa.paged_attention.launches_by_format["f"]
    twin_steps = eng.device_steps - steps0
    if twin_launches != args.layers * twin_steps or twin_launches <= 0:
        fail(f"the Gemma-width engine launched kernel 1 {twin_launches} times over "
             f"{twin_steps} steps of {args.layers} layers")
    want = [r.tokens for r in done]
    del eng, done
    torch.cuda.empty_cache()
    proc, port = start_server(GEMMA_SERVE, log_path, env)
    try:
        cold_s = warm_up(port, jobs)
        t0 = time.perf_counter()
        results = http_sequential(port, jobs)
        wall = time.perf_counter() - t0
        state = http_call(port, "/debug/state")[1]
    except BaseException:
        proc.kill()
        raise
    drain_s = stop_server(proc, log_path)
    got = [r["tokens"] for r in results]
    if got != want:
        fail(f"the Gemma-width server's greedy tokens differ from its in-process twin's at "
             f"{first_difference(got, want)}")
    dev = state["engine"]["device"]
    launches = dev["paged_launches"]["f"]
    if launches != dev["num_layers"] * dev["device_steps"] or launches <= 0:
        fail(f"the Gemma-width server counted {launches} kernel 1 launches over "
             f"{dev['device_steps']} steps of {dev['num_layers']} layers")
    out = {"flags": list(GEMMA_SERVE), "requests": n, "prompt": prompt, "new": new,
           "tokens_equal_in_process": True, "client": stream_latency(results),
           "client_wall_s": wall,
           "cold_warm_up_s": cold_s, "drain_s": drain_s, "server_kernel1_launches": launches,
           "server_device_steps": dev["device_steps"], "twin_kernel1_launches": twin_launches,
           "twin_s": twin_s, "card": smi}
    log(f"phase 18a: {out}")
    return out


def run_gemma_generate(torch, tf, fa, cfg, params) -> dict:
    """18b: greedy_generate at Gemma-2B's widths (``cfg``: GEMMA_TRAIN_LAYERS
    layers): its bulk prefill launches kernel 2 at head_dim 256 once a
    layer."""
    prompt = torch.randint(0, cfg.vocab_size, (8, 128), generator=torch.Generator().manual_seed(2))
    fa.reset_launches()
    t0 = time.perf_counter()
    out = tf.greedy_generate(cfg, params, prompt, 16, device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    expect_designs(fa.flash_attention.launches_by_design, "wgmma", cfg.num_layers,
                   "greedy_generate's bf16 prefill at Gemma-2B's widths")
    if tuple(out.shape) != (8, 144) or not torch.equal(out[:, :128].cpu(), prompt):
        fail(f"greedy_generate returned {tuple(out.shape)} or altered the prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail("greedy_generate emitted a token id outside the vocabulary")
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "kernel2_launches": launches, "wall_s": dt,
            "shape": list(out.shape)}


def run_gemma_training(torch, tf, fa, train, data, cfg, params) -> dict:
    """18c: bf16 training steps at Gemma-2B's widths, cut to
    GEMMA_TRAIN_LAYERS layers (``cfg``): kernels 2-4 once a layer a step,
    on wgmma."""
    batch_n, seq, steps = GEMMA_TRAIN
    state = train.create_train_state(cfg, params, 0.1, 0.9, device=DEVICE)
    batch = data.synthetic_lm_batch(batch_n, seq, cfg.vocab_size,
                                    generator=torch.Generator().manual_seed(7), device=DEVICE)
    step = train.make_train_step()
    state, loss = step(state, batch)  # warm
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(loss.item())
    dt = time.perf_counter() - t0
    launches, by_design = flash_launches(fa)
    n = cfg.num_layers * steps
    for kernel, counts in by_design.items():
        expect_designs(counts, "wgmma", n, f"the Gemma-width bf16 training's {kernel} kernel")
    if not all(math.isfinite(x) for x in losses):
        fail(f"Gemma-width training loss not finite: {losses}")
    del state
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "batch": batch_n, "seq": seq, "steps": steps,
            "losses": losses, "step_time_ms": dt / steps * 1e3,
            "tokens_per_s": batch_n * seq * steps / dt, "launches": launches,
            "launches_by_design": by_design}


def run_phase_18(torch, tf, fa, pa, engine, http_server, train, data, smi, mark,
                 before_18d=None) -> dict:
    """Phase 18: Gemma-2B's attention widths through the server,
    greedy_generate and training, then the 2-layer float32 checks at
    GEMMA_CHECKS (kernel path against gather path, card step against CPU
    step).  ``before_18d`` runs just before those checks (phase 11b's
    ranks start there: 18d times nothing)."""
    serve = run_gemma_serve(torch, http_server, pa, smi)
    mark("18a_gemma_serve")
    cfg = gemma_config(tf, torch, 2048, 8, 1, 256000, GEMMA_TRAIN_LAYERS, torch.bfloat16,
                       max_seq=GEMMA_TRAIN[1])
    params = tf.init_params(cfg, seed=4)
    generate = run_gemma_generate(torch, tf, fa, cfg, params)
    log(f"phase 18b: {generate}")
    trained = run_gemma_training(torch, tf, fa, train, data, cfg, params)
    log(f"phase 18c: {trained}")
    del params
    mark("18bc_gemma_generate_train")
    if before_18d is not None:
        before_18d()
    checks = {}
    for name, hidden, heads, kv_heads, vocab, ps in GEMMA_CHECKS:
        cfg = gemma_config(tf, torch, hidden, heads, kv_heads, vocab, 2, torch.float32)
        mpp = -(-(64 + 16) // ps) + 1
        # One CPU init a shape (about 5-9 s at these vocabularies) serves
        # both checks: each engine and train state loads its own copy.
        params = tf.init_params(cfg, seed=3)
        pa.reset_launches()
        agree = check_paths_agree(torch, tf, engine, cfg=cfg, page=(ps, 8 * mpp + 1, mpp),
                                  prompt_len=64, params=params)
        agree["kernel1_launches"] = pa.paged_attention.launches_by_format["f"]
        if agree["kernel1_launches"] <= 0:
            fail(f"{name}: the kernel path never launched kernel 1")
        parity = check_train_parity(torch, fa, tf, train, data, cfg=cfg, batch_shape=(1, 128),
                                    params=params)
        del params
        checks[name] = {"hidden": hidden, "heads": heads, "kv_heads": kv_heads,
                        "head_dim": cfg.head_dim, "group": heads // kv_heads, "vocab": vocab,
                        "page": ps, "paths_agree": agree, "card_vs_cpu": parity}
        log(f"phase 18d {name}: {checks[name]}")
        torch.cuda.empty_cache()
    mark("18d_gemma_checks")
    return {"serve": serve, "generate": generate, "train": trained, "checks": checks,
            "train_cut": f"{GEMMA_TRAIN_LAYERS} of 18 layers (18b and 18c)", "card": smi}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    ab_pairs = None
    if sys.argv[1:2] == ["--ab-tiers"]:
        ab_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    from k8s_device_plugin_tpu_torch.models import benchmark as bench
    from k8s_device_plugin_tpu_torch.models import data, engine, lora, train
    from k8s_device_plugin_tpu_torch import decode_profile as dp
    from k8s_device_plugin_tpu_torch.models import transformer as tf
    from k8s_device_plugin_tpu_torch.ops import _build, quant, tuning
    from k8s_device_plugin_tpu_torch.ops import flash_attention as fa
    from k8s_device_plugin_tpu_torch.ops import paged_attention as pa
    from k8s_device_plugin_tpu_torch.utils.device import fp32_reference_precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fp32_reference_precision()
    if ab_pairs is not None:
        print(json.dumps(run_ab_tiers(smi, ab_pairs)), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return

    t0 = time.perf_counter()
    phase_s, last = {}, [t0]

    def mark(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase], last[0] = now - last[0], now

    # The float32 flash forward (csrc/flash_attention.cu) takes about a minute of
    # nvcc where the others take seconds: it builds on beside kernel 1's
    # checks and phases 4-4c (bf16: kernel 1 and the wgmma builds only),
    # and its first load waits for it.
    _build.build_all(background=("flash_attention",))
    log(f"kernels built in {time.perf_counter() - t0:.1f}s (the float32 flash forward "
        f"builds on)")
    mark("build")
    paged_builds = paged_build_facts(_build)

    paged = {row["kv_format"]: row for row in check_paged(torch, pa, quant, tuning, dp)}
    paged_hgmma = sum(sass_hgmma(_build.library_path("paged_attention")).values())
    for fmt, row in paged.items():
        # The row's registers and spills are the main path's build: bf16
        # queries, 64 wide.
        row.update(design="fma", hgmma=paged_hgmma, **paged_builds[fmt]["bfloat16_64"],
                   builds=paged_builds[fmt])
    restored = check_restored_pages(torch, pa, quant, tf)
    for fmt, held in restored.items():
        paged[fmt]["restored_pages"] = held
    mark("paged_checks")
    summary, launches, sync_tokens = run_engine(torch, engine, pa, fa, SYNC_EAGER)
    paged["f"]["launches"] = launches["f"]
    mark("4_engine")
    quant_runs = []
    # The pod's plain --quant=w8 runs in 16e (k8s-pod-serve-gpt-gpu.yaml).
    for flags in (["--quant=w8", "--quant-kv"], ["--quant=w8a8", "--quant-kv"]):
        # Two slot waves (32 requests until phases 4h, 4i and 5b needed
        # the time): pages freed under int8 scales are admitted again.
        q_summary, launches, _ = run_engine(torch, engine, pa, fa, (*SYNC_EAGER, *flags),
                                            requests=QUANT_REQUESTS)
        q_summary["paged_launches"] = launches
        quant_runs.append(q_summary)
    mark("4b_quant")
    blocks = run_blocks(torch, engine, pa, fa, dp, sync_tokens)
    mark("4c_blocks")
    t_wait = time.perf_counter()
    _build.load("flash_attention")
    log(f"the float32 flash forward's build: waited {time.perf_counter() - t_wait:.1f}s more")
    facts = build_facts(torch, fa, _build)
    flash, flash_fma = check_flash(torch, fa, facts)
    bwd = check_flash_bwd(torch, fa, facts)
    widths = check_widths(torch, pa, fa, quant, tuning)
    by_width = {"head_dim_128": time_head_dim(torch, pa, fa, tuning, 128),
                "gemma_d256": time_head_dim(torch, pa, fa, tuning, 256, H=8, HK=1)}
    group71 = time_paged(torch, pa, tuning, B=8, H=71, HK=1, D=64, ps=12)
    log(f"kernel 1 at head_dim 64, group 71, page 12: {group71}")
    mark("kernel_checks")
    dq, dq_fma = bwd[("dq", "bfloat16")], bwd[("dq", "float32")]
    dkv, dkv_fma = bwd[("dkv", "bfloat16")], bwd[("dkv", "float32")]
    from k8s_device_plugin_tpu_torch.models import http_server

    serve = run_serve(torch, tf, http_server, smi, blocks["greedy"])
    mark("4d_4e_serve")
    warm_restart, reference = run_warm_restart(
        smi, engine.synthetic_jobs(32, 128, 128, 32000), long_jobs(9))
    mark("4f_warm_restart")
    split_roles = run_split_roles(smi, long_jobs(9), reference)
    mark("4g_split_roles")
    speculation = run_speculation(torch, http_server, pa)
    mark("4h_speculation")
    multi_lora = run_multi_lora(torch, tf, http_server, serve)
    mark("4i_multi_lora")
    paged["f"]["block16_launches"] = blocks["paged_launches"]
    paged["int8"]["launches"] = quant_runs[0]["paged_launches"]["int8"]
    paged["int8"]["w8a8_launches"] = quant_runs[1]["paged_launches"]["int8"]
    sweep = dp.sweep_formats(iters=100)
    log(f"format sweep (kernel benchmark): {sweep}")
    for row in sweep["rows"]:
        paged[row["format"]]["profiled_ms"] = row["device_us_per_call"] / 1e3
    paged["int4"]["launches"] = sweep["launches"]["int4"]
    if paged["int4"]["launches"] <= 0:
        fail("the kernel benchmark never launched the paged kernel's int4 branch")
    mark("format_sweep")
    flash["launches"] = run_generate(torch, tf, pa, fa)
    mark("5_generate")
    dense_spec = run_dense_spec(torch, tf, fa, pa, quant)
    mark("5b_dense_spec")
    flash["dense_spec_launches"] = dense_spec["flash_launches"]
    paged["f"]["multi_lora_launches"] = multi_lora["device"]["paged_launches"]["f"]
    paged["f"]["spec_launches"] = speculation["main_path_launches"]
    check_paths_agree(torch, tf, engine)
    agree_tiny = check_paths_agree(torch, tf, engine, cfg=tf.GPTConfig.tiny(), page=(4, 64, 16),
                                   prompt_len=16)
    agree_quant = check_paths_agree(torch, tf, engine, quant="w8", quant_kv=True)
    mark("6_paths_agree")
    trained, launches = run_training(torch, fa, bench, smi)
    flash["train_launches"] = launches["flash_attention"]
    dq["launches"] = launches["flash_attention_bwd_dq"]
    dkv["launches"] = launches["flash_attention_bwd_dkv"]
    trained["card_vs_cpu"] = check_train_parity(torch, fa, tf, train, data)
    mark("8_training")
    train_models, noncausal = run_phase_9(torch, fa, pa, bench, train, smi, mark)
    for row, kernel in ((flash, "forward"), (dq, "dq"), (dkv, "dkv")):
        for model in FLASH_MODELS:
            run = train_models["models"][model]
            launched = run["launches"][row["name"]]
            per_step = launched / run["steps_run"]
            if per_step != run["attention_layers"]:
                fail(f"{model} launched {row['name']} {per_step} times a step, not once for "
                     f"each of its {run['attention_layers']} layers")
            row[f"{model}_noncausal"] = noncausal[kernel][model]
            row[f"{model}_train_launches"] = launched
            row[f"{model}_launches_per_step"] = per_step
    # The FMA variants run on float32 inputs only: their launches are phase
    # 8's, the float32 train step's.
    fma_launches = trained["card_vs_cpu"]["launches_by_design"]
    for row, kernel in ((flash_fma, "forward"), (dq_fma, "dq"), (dkv_fma, "dkv")):
        row["launches"] = fma_launches[kernel]["fma"]
        row["launches_from"] = "phase 8, the float32 train step (2 layers, 1 step)"

    serving_bench = run_serving_bench(torch, bench, pa, fa, tuning)
    mark("10a_serving_bench")
    decode_bench = run_decode_bench(torch, tf, bench, fa, dp)
    mark("10b_decode_bench")
    lora_train = run_lora_training(torch, tf, train, lora, data, bench, fa, smi)
    mark("10c_lora_train")
    paged["f"]["serving_bench_launches"] = serving_bench["engine_paged_launches"]
    for fmt, row in paged.items():
        row["serving_bench_kernels_phase_launches"] = serving_bench["kernels_phase_launches"][fmt]
    flash["decode_bench_launches"] = {name: run["flash_launches"]
                                      for name, run in decode_bench["runs"].items()}
    for row, name in ((flash, "flash_attention"), (dq, "flash_attention_bwd_dq"),
                      (dkv, "flash_attention_bwd_dkv")):
        row["lora_train_launches"] = lora_train["bf16"]["launches"][name]
    for row, kernel in ((flash_fma, "forward"), (dq_fma, "dq"), (dkv_fma, "dkv")):
        row["lora_fp32_launches"] = lora_train["card_vs_cpu"]["launches_by_design"][kernel]["fma"]
    started_13d, started_14b, started_15b = {}, {}, {}

    def after_11a():
        started_13d.update(start_phase_13d())
        started_14b.update(start_phase_14b())
        started_15b.update(start_phase_15b())

    distributed, launches = run_phase_11(torch, fa, bench, smi, mark, after_11a)
    for row, name in ((flash, "flash_attention"), (dq, "flash_attention_bwd_dq"),
                      (dkv, "flash_attention_bwd_dkv")):
        row["distributed_launches"] = launches[name]
    tensor_parallel = run_phase_12(torch, tf, engine, http_server, pa, tuning, blocks, smi, mark)
    paged["f"]["tp_launches"] = {
        "12a_nccl_group_of_one": tensor_parallel["world_of_one"]["paged_launches"],
        **{f"12b_{name}_by_rank": [r["paged_launches"]["f"] for r in run["ranks"]]
           for name, run in tensor_parallel["shared_card"]["scenarios"].items()}}
    paged["f"]["tp_shard"] = tensor_parallel["shared_card"]["shard_kernel"]
    for name, row in {**tensor_parallel["served"]["scenarios"],
                      "handoff": tensor_parallel["served"]["handoff"]}.items():
        # 12d's kernel 1 launches on each rank, under the pool format's row.
        fmt = "int8" if tp_served_weights(name)[0].quant_kv else "f"
        launched = paged[fmt].setdefault("tp_served_launches_by_rank", {})
        for label in ("nccl_tp1", "gloo_tp2"):
            launched[f"12d_{label}_{name}"] = row[label]["kernel1_launches_by_rank"]
    moe_run = run_phase_13(torch, fa, tf, train, data, smi, mark, started_13d)
    for row, name in ((flash, "flash_attention"), (dq, "flash_attention_bwd_dq"),
                      (dkv, "flash_attention_bwd_dkv")):
        row["moe_train_launches"] = moe_run["train"]["launches"][name]
    for row, kernel in ((flash_fma, "forward"), (dq_fma, "dq"), (dkv_fma, "dkv")):
        row["moe_fp32_launches"] = moe_run["card_vs_cpu"]["launches_by_design"][kernel]["fma"]
    sp_run = run_phase_14(torch, fa, tf, train, data, smi, mark, started_14b)
    for row, name in ((flash, "flash_attention"), (dq, "flash_attention_bwd_dq"),
                      (dkv, "flash_attention_bwd_dkv")):
        row["sp_ulysses_launches"] = sp_run["world_of_one"]["ulysses"]["launches"][name]
    ulysses_ranks = next(m for m in sp_run["dp_sp_tp"]["meshes"] if m["kind"] == "ulysses")
    for row, kernel in ((flash_fma, "forward"), (dq_fma, "dq"), (dkv_fma, "dkv")):
        row["sp_fp32_launches_by_rank"] = [r["launches_by_design"][kernel]["fma"]
                                           for r in ulysses_ranks["by_rank"]]
    pp_run = run_phase_15(torch, fa, tf, train, data, bench, smi, mark, started_15b)
    for row, name in ((flash, "flash_attention"), (dq, "flash_attention_bwd_dq"),
                      (dkv, "flash_attention_bwd_dkv")):
        for schedule in PP_SCHEDULES:
            row[f"pp_{schedule}_launches"] = pp_run["world_of_one"][schedule]["launches"][name]
    for row, kernel in ((flash_fma, "forward"), (dq_fma, "dq"), (dkv_fma, "dkv")):
        for schedule in PP_SCHEDULES:
            row[f"pp4_{schedule}_fp32_launches_by_rank"] = [
                r["launches_by_design"][kernel]["fma"]
                for r in pp_run["pp4_shared_card"]["schedules"][schedule]["by_rank"]]

    plugin = run_phase_16(torch, bench, engine, smi, mark)
    paged["f"]["plugin_pod_launches"] = plugin["pod"]["paged_launches"]
    routed = run_phase_17(torch, tf, http_server, pa, smi)
    mark("17_router")
    started_11b = {}
    gemma = run_phase_18(torch, tf, fa, pa, engine, http_server, train, data, smi, mark,
                         lambda: started_11b.update(start_phase_11b(torch, bench)))
    distributed["shared_card"] = run_phase_11b(torch, started_11b, smi)
    mark("11b_shared_card")
    paged["f"]["gemma_server_launches"] = gemma["serve"]["server_kernel1_launches"]
    flash["gemma_generate_launches"] = gemma["generate"]["kernel2_launches"]
    for row, name in ((flash, "flash_attention"), (dq, "flash_attention_bwd_dq"),
                      (dkv, "flash_attention_bwd_dkv")):
        row["gemma_train_launches"] = gemma["train"]["launches"][name]
    for row, kernel in ((flash_fma, "forward"), (dq_fma, "dq"), (dkv_fma, "dkv")):
        row["gemma_fp32_launches"] = {name: check["card_vs_cpu"]["launches_by_design"][kernel]["fma"]
                                      for name, check in gemma["checks"].items()}
    paged["f"]["router_launches"] = routed["paged_launches"]
    paged["f"]["serving_bench_router_replica_launches"] = \
        serving_bench["router_replica_paged_launches"]

    for row, name in ((paged["f"], "paged_attention"), (flash, "flash_attention"),
                      (dq, "flash_attention_bwd_dq"), (dkv, "flash_attention_bwd_dkv")):
        for key, timed in by_width.items():
            row[key] = timed[name]
    paged["f"]["group71_page12"] = group71
    kernels = [paged["f"], paged["int8"], paged["int4"], flash, flash_fma, dq, dq_fma, dkv,
               dkv_fma]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"slice": summary, "card": smi}), flush=True)
    print(json.dumps({"blocks": blocks, "widths_worst_err": widths,
                      "paths_agree_tiny_page4": agree_tiny, "card": smi}), flush=True)
    print(json.dumps({"quant": quant_runs, "format_sweep": sweep, "paths_agree_w8_int8kv": agree_quant,
                      "card": smi}), flush=True)
    print(json.dumps({"train": trained}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"warm_restart": warm_restart, "split_roles": split_roles,
                      "restored_pages": restored, "card": smi}), flush=True)
    print(json.dumps({"spec_lora": {"speculation": speculation, "dense_speculation": dense_spec,
                                    "multi_lora": multi_lora}, "card": smi}), flush=True)
    print(json.dumps({"train_models": train_models}), flush=True)
    print(json.dumps({"serving_bench": serving_bench, "card": smi}), flush=True)
    print(json.dumps({"decode_bench": decode_bench, "card": smi}), flush=True)
    print(json.dumps({"lora_train": lora_train}), flush=True)
    print(json.dumps({"distributed": distributed}), flush=True)
    print(json.dumps({"tensor_parallel": tensor_parallel}), flush=True)
    print(json.dumps({"moe": moe_run}), flush=True)
    print(json.dumps({"sp": sp_run}), flush=True)
    print(json.dumps({"pipeline": pp_run}), flush=True)
    print(json.dumps({"plugin": plugin}), flush=True)
    print(json.dumps({"router": routed}), flush=True)
    print(json.dumps({"gemma": gemma}), flush=True)
    print(json.dumps({"phase_seconds": phase_s, "total_s": time.perf_counter() - t0,
                      "card": smi}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
