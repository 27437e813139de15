#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build the four CUDA kernels (K1's two routes and K2 from
   ``kernels/mpmm/csrc``, K3, K4 from ``kernels/flashattn/csrc``) with nvcc
   for sm_90a into seven libraries (K1's tensor-core route and K2 as two
   each, one per half of the 16 weight formats), one process per library,
   in parallel.
2. K1 (``mpmm_cuda``) against its plain version ``mpmm_torch``, through
   both routes (M 100 on the tensor-core route ``wgmma``, M 4 on the
   split-K route ``splitk``): all 16 weight formats (w and k in 1/2/4/8,
   k > w among them), both variants, the three epilogues, both output dtypes,
   ragged M/N/K, an int32-accumulator check; expert banks (3 experts in one
   launch, each its own weights and epilogue operands) at every format and
   variant on both routes; the ResNet serve path's own
   shapes (stem as im2col, classifier); and granite-8b's prefill and decode
   shapes, held against the plain version run on the card.
3. K2 (``conv_mpmm_cuda``, int8 tensor cores, padding in the kernel)
   against ``conv_mpmm_torch`` at every ResNet-18 conv shape, both on the
   unpadded input: at batches 8 and 1 with the path's epilogue (batch 1
   runs the split plans of ``conv_kernel.conv_plan``), and at batch 2 with
   Sum-Apart and the residual epilogue; every format the plan does not
   use (k > w among them) at two of those convs, batches 1 and 2.
4. ResNet end to end: full-width ResNet-18 (224x224, width 64, 1000
   classes) with random weights from a seeded generator, packed under
   ``examples/plans/resnet18_mixed.json`` and served by ``ImageServer`` with
   buckets (1, 2, 4, 8) for requests of 1, 3, 8 and 13 images.  The launch
   counters must show, per bucket call, K2 once for each conv that the
   layer's dataflow choice sends to the implicit conv and K1 once for the
   others and the classifier, by K1's route rule (``resnet_launches``:
   under ``dataflow="auto"`` the H100 cost model chooses); the logits are
   compared with the same forward through the plain versions.
5. ResNet timing at the serve path's shapes (K1 at batch 8, K2 at
   batches 8 and 1): each kernel, its plain version, one PyTorch library
   call for the same product (K2: ``F.conv2d`` in f32, TF32 off,
   channels_last, on the padded input) and the bound (the larger of bytes
   over 3.35 TB/s and int8 operations over 1979 TOP/s, the H100 SXM
   data-sheet peaks), K2's rows with their plan (N tile, splits, blocks);
   frames/s per bucket.  K2 and ``F.conv2d`` are timed as device time:
   calls captured in a CUDA graph and replayed between CUDA events
   (``Smoke.graph_ms``); K2 is also timed call by call, where the host's
   cost of a call sets the time.
6. K3 (``flash_fwd_cuda``) against ``flash_fwd_torch`` at granite-8b's
   attention shapes (B 4, H 32, KV 8, D 128, bf16): causal at Sq = Sk of
   1000 and 1024, a 256 window, q_offset continuations (Sq 8 and the
   speculative verify chunk Sq 9, Sk 1024) and a non-causal ragged Sk
   (forced causal, as the reference's padding does); and at head dim 256,
   recurrentgemma-9b's attention (B 2, H 16, KV 1, bf16, window 2048):
   Sq = Sk of 2560 and 3000 (above the window; 3000 pads its keys to
   recurrentgemma's 1024-key block) and a q_offset continuation (Sq 9).
7. K4 (``flash_fwd_packed_cuda``) against ``flash_fwd_packed_torch`` on the
   cache formats of ``examples/plans/granite_8b_mixed.json`` (kv2 k2, kv4
   k4, kv8 k4), K and V in different formats, q_offset continuations (Sq 8
   and 9) and a ragged Sk; and against K3 run on ``unpack_kv`` of the same
   cache.  Then both at head dim 192, nemotron-4-340b's attention (B 2, H
   96, KV 8, bf16): causal at Sq = Sk = 512, a q_offset continuation (Sq 9)
   and a window, K4 at kv4k4, K kv2k2 with V kv8k4, and K kv2k1 (24-byte
   rows of 1-bit digits) with V kv8k8.
8. LM end to end: granite-8b at full width (d_model 4096, 32 heads, 8 KV
   heads, head_dim 128, d_ff 14336, vocab 49152) with random weights from
   a seeded CUDA generator, all 36 layers, drawn and packed layer by layer
   on the card under ``granite_8b_mixed.json``, served by ``Generator``: 4
   prompts of
   1000 tokens, 16 new tokens, greedy.  The counters must show K4 once per
   layer per prefill, K1 7 times per layer plus the head per prefill and
   per decode step (the prefill's projections on ``wgmma``, its head and
   all of a decode step's calls on ``splitk``), K3 never.  The same weights
   served again under the plan
   without its KV keys (a bf16 cache) must launch K3 once per layer per
   prefill and K4 never.  Each run is held against the same model through
   the plain versions of K1, K3 and K4: finite, non-constant logits; in the
   prefill, every plain layer fed the kernel path's own input lands within
   2% of the largest |output| with at most 2% of its bf16 outputs
   different, and so do the last token's logits and head-input codes taken
   through the plain last layer; every decode step, fed the kernel path's
   token and a copy of its cache, gives bitwise-equal logits (decode runs
   no flash kernel and K1 is bitwise).  The two paths run free through all
   layers are printed per layer (``[drift]`` lines), not held: 8-bit
   requantization carries the flash kernels' sub-ulp differences onward.
9. LM timing at the path's shapes (batch 4, S 1000): K3 and K4 per layer
   and per prefill against their plain versions, ``F.scaled_dot_product_
   attention`` in bf16 (for K4 on the unpacked K/V: it reads unpacked
   bytes) and the bound (bytes over 3.35 TB/s or causal attention FLOPs
   over 989 TFLOP/s, the H100 SXM dense bf16 peak); K1 at the prefill
   and decode shapes, with its route and its share of the bound, beside its
   plain version and one library call for the same product
   (``torch._int_mm`` where it takes the shape, else ``torch.mm`` in f32);
   prefill tokens/s, decode ms per step and the share of a prefill spent
   in K4, K1 and the rest.

10. Speculative decoding, the schedulers and the entry point, at full
   width: (a) ``SpeculativeGenerator`` (k 4, batch 4, the 1000-token
   prompts, 16 new tokens) over two packed views of one granite-8b weight
   draw -- verify ``granite_8b_mixed.json``, draft
   ``granite_8b_draft_w2.json`` -- must emit exactly the tokens of the
   verify-only ``Generator`` (and of phase 8's, on the same draw), launch
   K1 and K4 as often as its cycles call them, and give one verify's
   logits and cache bitwise equal to 5 sequential decode steps on a copy
   of the cache; (b) the ``attn_impl='flash'`` verify launches K4 once a
   layer, whose attention stays within one bf16 ulp of K4's plain version
   and within 3e-2 absolute plus relative of the per-query route; (c)
   ``GenerateScheduler`` (4 slots, 6 requests of 1000 and 500 tokens, n_new
   4/6/8) over the ``Generator`` and over the ``SpeculativeGenerator``:
   every ticket's tokens equal its request served alone; (d)
   ``ImageScheduler`` over the ResNet-18 ``ImageServer`` on 13 single
   images in bursts: every ticket's logits bitwise its image's served
   alone; (e) ``repro_torch.launch.serve.main`` in process for ResNet-18
   and for granite-8b with ``--spec-decode 4``, whose trace and metrics
   dump pass the port's validators.  ``[time]`` lines give speculative
   against verify-only tokens/s, ms a cycle, the accept rate (random
   weights: nothing to learn about a trained draft's acceptance) and the
   scheduler's p50/p99 latency.

11. The design-space exploration and the control plane at full ResNet-18
   width (random weights from SEED): (a) ``weight_ptq_sensitivity`` and
   ``calibration_sensitivity`` (8 random images through the card: the fp
   reference through the fp baseline, each probe through K1/K2, packed
   layers cached by format after one bitwise check against a fresh pack)
   feed ``plan_search`` under the H100 cost model; the frontier rows, the
   chosen plan (which then packs and serves) and the H100 entry beside the
   card's SMs and shared memory (must agree); (b) the fp baseline through
   ``ImageServer`` at buckets 1 and 8 within FP_LOGIT_TOL of a float64 run
   of the same bf16 weights, its bytes against the mixed plan's; (c)
   ``layer_attribution`` of a batch-8 forward timed by CUDA events:
   roofline fraction and achieved TOps/s, and the model's time of each
   conv beside phase 5's measured one with their rank correlation; (d)
   ``examples/frontiers/resnet18_frontier.json`` through
   ``frontier_from_manifest``: every level held to phase 4's contract and
   launch rule, frames/s and measured rel_latency at bucket 8; (e)
   ``SLOScheduler`` over that frontier with seeded faults (transient
   errors, latency spikes, malformed payloads), its deadline SLO_BATCHES
   level-0 batch times: a burst degrades, a trickle recovers, every
   ticket is terminal and every served one bitwise its image served alone
   at its level; (f) ``launch.serve.main`` with ``--frontier``,
   ``--fp-baseline`` and ``--plan --trace --metrics-dump`` (roofline line
   timed by CUDA events; the telemetry validate command on the files);
   (g) granite-8b at full width, first 4 layers, two points drawn once
   behind ``SLOScheduler`` through ``GenerateBackend``: K1 and K4 launched
   as the generate calls need, tickets bitwise their requests served
   alone; (h) the per-layer dataflow the H100 model picks and frames/s at
   buckets 1 and 8 under ``auto`` and with ``implicit`` forced.

12. The rest of the decoder family at full width, random weights from a
   seeded CUDA generator, drawn and packed layer by layer: (a)
   olmoe-1b-7b, all 16 layers (64 experts top-8, expert ff 1024), under a
   plan of its default policy (w4k4, channel-wise) with ``l0.expert``
   w2k2, ``l1.expert`` w8k4 and a packed kv4 cache (K4); (b)
   deepseek-v2-lite-16b, all 27 layers (MLA, 64 experts top-6 + 2 shared,
   layer 0 dense), its default policy, the bf16 latent cache; each for 4
   prompts of 1000 tokens and 16 new tokens, greedy, through ``Generator``.
   The counters must show the calls the path makes (``k1_calls``): one K1
   launch per expert bank, not per expert (olmoe 7 a layer and the head per
   prefill and per decode step, deepseek 11 a MoE layer and 8 in layer 0,
   uk and uv over M = 4 x Smax at decode), each on the route its M picks,
   and K4 once a layer per prefill for olmoe.  Held as phase 8 holds
   granite (the prefill layer by layer within 2%, every decode step
   bitwise), ``decode_steps`` over 4 tokens bitwise equal to 4 sequential
   decode steps (logits and cache), and ``GenerateScheduler`` (4 slots,
   phase 10's six requests): every ticket bitwise its request served
   alone.  (c) granite-34b (MQA), yi-34b, chameleon-34b and
   nemotron-4-340b (head dim 192, vocab 256000), full width, first 2
   layers, 2 prompts of 512 tokens and 8 new tokens, under their default
   policy with a bf16 cache (K3), granite-34b and nemotron also with a
   packed kv4 cache (K4); the same counters and phase 8's contract, an
   MoE layer's block by block (``moe_prefill_contract``: the router turns
   K4's sub-ulp differences into another expert for a few tokens).
   ``[p12-time]`` lines: prefill ms and tokens/s, decode ms a step, the
   split (K1 and K3/K4 as their calls timed alone, the rest) per arch; each
   distinct bank call of K1 against its bound and a PyTorch loop over the
   experts; K3 and K4 at D 192 against their bound and SDPA.

13. The last three families at full width, through ``Generator`` with
   random weights drawn on the card from a seeded generator and packed
   layer by layer under the configs' default w4k4: mamba2-1.3b (48
   layers, 4 x 1000 tokens -- not a multiple of its 256-token chunk -- and
   16 new), recurrentgemma-9b (38 layers, 2 x 3000 tokens, above its 2048
   window, so K3's window and the decode ring's wrap are live, 16 new) and
   whisper-base (6 + 6 layers, 4 x (1536 stub frames, 64 tokens), 16 new).
   Per arch: the launch counts (K1 by route and K3) against the arch's
   ``gemm_workload``; phase 8's contract layer by layer (whisper's encoder
   layers too) and every decode step bitwise; mamba2's R6 repair (every
   layer's prefill state against the chunk = S oracle on the same input,
   the first layers against the prompt fed token by token);
   ``GenerateScheduler`` tickets bitwise their requests served alone
   (mamba2, first 4 layers; recurrentgemma, first 6); ``launch.serve`` once;
   ``[p13-time]`` lines (prefill and decode, the split K1 / K3 / rest, K3
   at D 256 against its bound and SDPA with the same window mask).  K1 at
   the new shapes (N 64, N 256, K 512) joins phase 2.

14. QAT training (slice 10; ``repro``'s training path reaches no Pallas
   kernel, so training runs torch's products under autograd, and the
   trained weights go through the kernels).  (a) ResNet-18 at full width
   (224x224, 1000 classes) under ``resnet18_mixed.json``, random weights
   from a CUDA generator seeded 0: four ``make_train_step`` steps at batch
   32 on ``SyntheticImages`` (loss and grad norm finite); one step's loss
   and gradients on the card against the port's CPU ones on the same 2
   images (loss within 2%; each weight leaf within 0.8 of its L2 norm,
   each weight step nonzero where the CPU's is; the gate must also reject
   the CPU's gradient of one image alone, a planted fault); BN
   calibrated by ``apply_with_state(training=True)``; ``pack_for_serve``
   and ``ImageServer.predict`` through K1/K2, counted as phase 4 counts,
   the served logits correlated above 0.85 with the QAT eval forward (the
   reference's ``test_serve_tracks_qat``).  (b) granite-8b at full width,
   first 2 layers, default w4k4, remat 'dots': the ``Trainer`` for 6
   steps (batch 4 x 1024, 2 microbatches), which writes the checkpoint of
   its step 3 in the background (``async_ckpt``, the ``Trainer``'s
   default) while its donated steps 4-6 update the state in place; a
   fresh ``Trainer`` restored from that checkpoint and run to step 6, its
   parameters, moments and losses bitwise the uninterrupted run's (the
   reference's ``test_restart_equivalence_exact``); one microbatch
   against two (loss within 2%, each gradient leaf, read back from the
   step's first moment, within 0.02 of its L2 norm); a step under a
   packed kv4 cache; ``pack_for_serving``
   under w4k4 + kv4 and ``Generator`` (2 x 256 + 8 tokens) through K1
   and K4, counted, the served logits correlated above 0.95 with the QAT
   forward (``test_packed_serve_tracks_qat_logits``).  (c) ``python -m
   repro_torch.launch.train --reduced`` then ``launch.serve --ckpt-dir``
   as subprocesses.  ``[p14-time]`` lines: ms a step, images/s and
   tokens/s trained, checkpoint save and restore, peak memory, and the
   step's split (forward and backward, their bf16 products, a fake-quant
   pass over the weights, AdamW, each timed alone).

15. QAT training of the MoE and MLA archs (slice 11): olmoe-1b-7b (64
   experts top-8, channel-wise expert steps) and deepseek-v2-lite-16b
   (MLA, 64 experts top-6 + 2 shared, layer 0 dense) at full width (d
   2048, each arch's full vocab), first 2 layers (about 1.05 and 1.09 B
   parameters), random weights from a CUDA generator seeded 0, each
   arch's default policy.  The ``Trainer`` for 3 steps (batch 4 x 1024, 2
   microbatches, each MoE row routed with a capacity of 256 (olmoe) or 192
   (deepseek) tokens an expert), which writes its step-2 checkpoint in the
   background as phase 14's does; a fresh ``Trainer`` restored from it
   and run to step 3, its parameters, moments and losses bitwise the
   uninterrupted run's; one microbatch against two (loss within 2%, each
   gradient leaf within 0.02 of its L2 norm); every gradient leaf finite
   and every router's gradient nonzero; ``pack_for_serving`` and
   ``Generator`` (2 x 256 + 8 tokens) through K1's expert banks (and K3
   for olmoe's flash prefill), counted as phase 12 counts, the served
   logits correlated above 0.95 with the QAT forward; ``launch.train
   --reduced`` then ``launch.serve --ckpt-dir`` for olmoe as
   subprocesses.  ``[p15-time]`` lines: ms a step, tokens/s trained,
   ``max_memory_allocated``, checkpoint save and restore, and the step's
   split (forward and backward, their bf16 products at the banks' real
   shapes, the MoE routing, a fake-quant pass over the weights, AdamW,
   each timed alone).  Checkpoints as phase 16 places them.

16. QAT training of the last three families (slice 12) at full width,
   random weights from a CUDA generator seeded 0, each arch's default
   policy: mamba2-1.3b whole (48 layers, batch 4 x 1000 tokens, not a
   multiple of its 256-token chunk, so the pad path trains),
   recurrentgemma-9b's first superblock (R, R, A: 2.8 B parameters, 2.1 B
   of them embedding and head; 2 x 2560 tokens, past its 2048 window) and
   whisper-base whole (4 x (1536 stub frames, 64 tokens)).  Per arch: the
   ``Trainer`` for 3 steps in 2 microbatches (its step donated, as the
   reference donates its state); a fresh ``Trainer`` restored from step
   2 and run to step 3, parameters, moments and losses bitwise the
   uninterrupted run's (mamba2's restart leg on its first 4 layers at
   full width, against an uninterrupted run of the same 4 layers); one
   microbatch against two (each gradient leaf within 0.02 of its L2
   norm, the conv taps' bf16 sums within 0.05);
   every gradient finite and the recurrences' own (``A_log``, ``D``,
   ``dt_bias``, ``lam``, the conv's) nonzero; the SSD / RG-LRU block's
   vjp with layer 0's trained weights on the card against the CPU's
   (each leaf within 1e-3 of its L2 norm, the conv's 5e-3);
   ``pack_for_serving`` and the serve-mode ``forward`` over the batch
   through K1 (and K3 for recurrentgemma), counted against the arch's
   GEMMs, its logits correlated above 0.95 with the QAT forward's; a
   prefill and 8 decode steps from the trained weights.  ``[p16-time]``
   lines: ms a step, tokens/s trained, ``max_memory_allocated``,
   checkpoint save and restore, and the step's split (forward and
   backward, their bf16 products, the SSD / scan / attention rest, a
   fake-quant pass over the weights, AdamW, each timed alone).
   Checkpoints under a folder of this run's own in ``/dev/shm`` where it
   has room for the state (else ``build/p16``), removed at the end;
   phases 14-16 write only the checkpoint their restart reads
   (``ckpt_root``, ``save_only_at``), 16's blocking, 14's and 15's in the
   background.
17. The paper's PE models (``core/ppg``): every variant (BP-ST-1D,
   BP-SA-1D, BP-ST-2D with 8-bit activations, BS-ST-1D) at every (w, k)
   of ``benchmarks/fig6_pe_dse.py``'s grid (M 64, K 256, N 256; w 8, 4,
   2, 1; k 1, 2, 4 with k <= w), drawn as it draws them, and at one
   full-width ResNet-18 layer as a GEMM (the s3 3x3 conv at batch 8: M
   392, K 4608, N 512): bitwise ``matmul_exact`` on the card and the
   host's product, the statistics equal to the CPU run's; BP-ST-1D at
   w8k4 bitwise K1 with gamma 1 and no epilogue (a_biased = a - 128,
   act_zero 128).  ``[p17-time]`` lines: us a call (CUDA events around
   calls that each wait once for an operand's range: host-bound) and the
   Fig. 6 score, weight bits/s per accumulator byte
   (``tools/ppg_device_time.py`` times the device alone).
18. Data-parallel serving, a contract check: the cells on one device in
   this process, then in a world of two ranks sharing cuda:0 over gloo
   (``launch.mesh.spawn``; the ranks load the libraries built above and
   would refuse to run ``nvcc``): full-width ResNet-18 under
   ``resnet18_mixed.json`` at batch 16 through ``ImageServer``; granite-8b
   at full width, first 2 layers, under ``granite_8b_mixed.json``, 4 x
   256 prompts + 8 tokens through ``Generator`` and five requests through
   a ``GenerateScheduler`` over it.  Every rank's logits, tokens and
   tickets bitwise the one-device run's; every rank's launches those the
   layers give at its rows (a kernel launches once a layer, so a rank
   launches as many as one device, each over half the rows).
   ``[p18-time]``: host-clock frames/s and tokens/s, which measure nothing
   of scaling with two ranks on one card.
19. Tensor-parallel serving (slice 14).  (a) K1's accumulator-only mode
   (int32 out, no epilogue): every format, both variants, both routes,
   bitwise its plain twin ``mpmm_torch_acc``, and ``epilogue.finish``
   after it bitwise the fused K1 (f32 and bf16 out); granite-8b's o and
   down projections (w8k4, K 4096 and 14336, N 4096) split in two over K
   at M 4000 (route A) and 4 (route B): each shard bitwise its twin, the
   shards' int32 sum finished bitwise the fused whole product;
   ``[p19-time]`` ms of a shard's call beside the fused call on the same
   shard and its bound.  (b) granite-8b at full width, first 4 layers,
   under ``granite_8b_mixed.json``, 4 x 1000 prompts + 16 tokens through
   ``Generator`` on one device here, then on a (1, 2) mesh of two ranks
   sharing cuda:0 over gloo (each rank its ``SERVE_RULES`` slice, o and
   down accumulator-only with an int32 sum across 'model', the head's
   columns all-gathered, split-sequence decode): prefill and decode
   logits bitwise one device, tokens equal, both ranks' logits equal,
   each rank's launches those
   of one device (K1 by route, K4, 2 accumulator-only calls a layer and
   step); the int32 all-reduce's bytes and host ms per prefill and per
   decode step, decode ms per step against one device.  (c) a
   ``GenerateScheduler`` over (b)'s ``Generator`` (tickets bitwise) and
   ResNet-18 batch 16, replicated over 'model' (logits bitwise, launches
   as one device).
20. Tensor-parallel serving of the MoE, MLA and encoder-decoder archs
   (slice 15), on one device here, then on a (1, 2) mesh of two ranks
   sharing cuda:0 over gloo: olmoe-1b-7b at full width, first 2 layers
   (32 experts a rank, one K1 launch a projection over them), under
   phase 12's plan (banks in w2k2 and w8k4, a packed kv4 cache: K4 over
   the rank's heads), 4 x 256 prompts + 8 tokens and a
   ``GenerateScheduler`` over it; deepseek-v2-lite-16b at full width,
   first 3 layers (the dense first layer, two MoE layers with shared
   experts, MLA's latent cache on 'kv_seq'), 4 x 256 + 8; whisper-base
   whole (6 + 6), 4 x 64 tokens + 1536 frames (the cross cache's frames
   on 'kv_seq'), 8 tokens.  Prefill and decode logits bitwise one
   device, tokens equal, both ranks equal, each rank's launches those of
   one device with the row shards accumulator-only, its slice (E/2
   experts a bank, half the heads' columns and the head's) and its
   ``kv_seq`` block of every cache; the scheduler's tickets bitwise.
   ``[p20-time]``: a rank's prefill and decode ms a step against one
   device (host clock), the bytes and host ms of each kind of collective
   (router gather, expert exchange, MLA's latent gather, the self and
   cross split decodes, the int32 sums, the head), and K1 over a rank's
   32-expert bank at its prefill shape against its bound and a
   ``torch._int_mm`` loop over the experts.
21. Tensor-parallel serving of mamba2, recurrentgemma and the fp baseline
   (slice 16), on one device here, then on a (1, 2) mesh of two ranks
   sharing cuda:0 over gloo: mamba2-1.3b at full width, first 4 layers, 4
   x 250 prompts (no multiple of its chunk) + 8 tokens (each rank its 32
   SSD heads: their x columns of ``in_xbc`` and the conv with B and C
   whole, the chunk math at the one-device head count, the gated norm's
   rows all-gathered, ``out`` accumulator-only); recurrentgemma-9b at
   full width, first 3 layers (R, R, A), 2 x 2040 + 16 (each rank its
   2048 RG-LRU channels, the gates and ``out`` accumulator-only with the
   rank keeping its gate columns, K3 over its 8 heads, its 1024 of the
   ring's 2048 slots, which wrap during decode, the split decode over
   them); granite-8b x2 as the fp baseline, 4 x 256 + 8 (column shards
   at the one-device shape, row shards on the all-gathered input against
   whole weights).  Prefill and decode logits bitwise one device, tokens
   equal, both ranks equal, each rank's launches those of one device with
   the row shards accumulator-only, its slices and its decode cache's
   shapes.  Then K1 accumulator-only at the ranks' row shards (mamba2's
   ``out``, recurrentgemma's ``w_a``; prefill and decode rows) bitwise
   ``mpmm_torch_acc``, and K3 over a rank's 8 heads bitwise the 16-head
   call's.  ``[p21-time]``: a rank's prefill and decode ms a step against
   one device (host clock), the bytes and host ms of each kind of
   collective, those K1 and K3 calls against their bounds, plain versions
   and ``torch._int_mm`` / SDPA.
22. Data-parallel and FSDP training (slice 17; the train path reaches no
   kernel): whisper-base at full width and depth (6 + 6), 4 x 64 tokens +
   1536 frames, M = 2.  The one-device ``Trainer`` runs to step 4 here,
   checkpointing at 2 and 4; a world of two gloo ranks sharing cuda:0 on
   a (2, 1) mesh (M = n) trains to step 2 and saves; a fresh world
   restores that checkpoint and trains to step 4; then this process
   restores the ranks' step-2 checkpoint on one device and trains to
   step 4.  Every loss, ``grad_norm`` and lr bitwise; the ranks'
   checkpoints of steps 2 and 4 (the gathered state) byte for byte the
   one device's; both restarts bitwise; each rank's resident state its
   FSDP blocks.  ``[p22-time]``: a rank's step ms against one device, its
   forward and backward, the parameter gathers and the gradient sum
   (bytes and ms), AdamW on the rank's blocks, save and restore (host
   clock, the card synchronized around each part).
23. Tensor-parallel QAT training over 'model' (slice 18; no kernel on the
   path): granite-8b at full width, 2 layers, 2 x 256 tokens, and
   ResNet-18 at 224, batch 8, 3 steps each at peak lr 0.1, on one device
   here and by two gloo ranks sharing cuda:0 on a (1, 2) mesh (spawned
   once for both, starting while this process runs the one-device
   steps).  The losses before any update within ``P23_FORWARD_RTOL``;
   every parameter leaf after 3 steps within ``P23_LEAF_RTOL`` (relative
   L2, each rank's block against the one-device leaf); the leaves no
   'model' axis cuts bitwise across the ranks after every step; the
   ResNet's mesh save restored on one device and saved again, byte for
   byte.  ``[p23-time]``: each rank's step ms against one device and its
   last step's collectives by kind (calls, bytes, ms).
24. Tensor-parallel QAT training of the MoE archs and whisper (slice 19;
   no kernel on the path): olmoe-1b-7b and deepseek-v2-lite-16b at full
   width, 2 layers (expert parallelism; deepseek's dense first layer,
   MLA by heads and shared experts), 2 x 256 tokens, and whisper-base at
   full width, 6 + 6 layers, 2 x 64 tokens and 1536 frames a row; phase
   23's contract, bounds and collectives by kind (the router's, gated
   rows', slot cotangents', head-broadcast and cut gathers added; whisper
   under bounds of its own, ``P24_WHISPER_*``), each cell beside one
   device on its batches' rows reversed.

Kernel outputs of K1 and K2 are compared bitwise with the plain version run
on the CPU copy of the inputs -- the version the CPU tests hold bitwise
against the JAX package (numeric contract in
``src/repro_torch/kernels/mpmm/epilogue.py``).  K3 and K4 are compared
with their plain versions on the card: f32 accumulation in another order,
so bf16 outputs within one bf16 ulp plus 1e-5 (the f32 tolerance, for
outputs near zero); K4 against K3 on the unpacked cache within 3e-2
absolute plus 3e-2 relative (K3 reads the bf16-rounded values code*s + z,
K4 the exact ones; the reference's own packed-vs-qdq tolerance).  Per-shape
times are printed as ``[time]`` lines.

The last three lines are the kernel summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``; nothing is printed there
unless every phase passed.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# phase 14's train steps run deterministically: cuBLAS needs this before it
# starts (the launch.train subprocess inherits it)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ARCH = "resnet18"
PLAN = ROOT / "examples" / "plans" / "resnet18_mixed.json"
BUCKETS = (1, 2, 4, 8)
REQUESTS = (1, 3, 8, 13)
TIME_BATCH = 8      # batch of the timed path shapes (the largest bucket)
SMALL_BATCH = 1     # K2's other checked and timed batch (split plans)
CHECK_BATCH = 2     # batch of K2's extra (Sum-Apart, residual) checks
SEED = 0
E2E_LOGIT_TOL = 0.02
E2E_MAX_FLIP_RATE = 0.02
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
PEAK_BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
LM_ARCH = "granite-8b"
LM_PLAN = ROOT / "examples" / "plans" / "granite_8b_mixed.json"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1000, 16
K3_DEPTH = 4           # the bf16-cache (K3) run: l0-l2 overrides + a default
LM_LOGIT_TOL = 0.02
LM_MAX_FLIP_RATE = 0.02
ATTN_HEADS, ATTN_KV, ATTN_D = 32, 8, 128
K4_VS_K3_TOL = 3e-2
DRAFT_PLAN = ROOT / "examples" / "plans" / "granite_8b_draft_w2.json"
SPEC_K = 4
# (prompt length, n_new) of the GenerateScheduler's six requests
SCHED_TRACE = ((LM_PROMPT, 4), (LM_PROMPT, 8), (500, 6), (LM_PROMPT, 6),
               (500, 4), (500, 8))
SCHED_SLOTS = 4
IMG_BURSTS = (8, 3, 1, 1)  # single images arriving together, 13 in all
FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]
EPILOGUES = ("none", "bn_relu", "bn_res_relu")
FRONTIER = ROOT / "examples" / "frontiers" / "resnet18_frontier.json"
P11_BATCH = 8        # phase 11's workload and timed batch
CALIB_IMAGES = 8     # calibration_sensitivity's random images
FP_LOGIT_TOL = 0.05  # fp baseline vs float64, of the largest |logit|
SLO_SEED = 11        # FaultInjector's seed in phase 11 (e)
SLO_BATCHES = 6      # the deadline in level-0 batch times
SLO_BURST = 64       # images of phase 11 (e)'s burst
LM_FRONTIER_DEPTH = 4
# (prompt length, n_new) of phase 11 (g)'s requests
LM_FRONTIER_REQS = ((128, 4), (128, 4), (64, 3), (128, 4), (64, 3),
                    (128, 4), (128, 4), (64, 3), (128, 4), (128, 4))


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    """State of one run: the device, a seeded generator, failures."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.gen = torch.Generator().manual_seed(SEED)
        self.failures = []
        self.max_err = {"mpmm_cuda": 0.0, "conv_mpmm_cuda": 0.0,
                        "flash_fwd_cuda": 0.0, "flash_fwd_packed_cuda": 0.0}

    # --- inputs ---------------------------------------------------------

    def codes(self, shape, lo=-128, hi=128):
        t = self.torch
        return t.randint(lo, hi, shape, generator=self.gen,
                         dtype=t.int32).to(t.int8)

    def weights(self, kdim, n, w_bits, k):
        from repro_torch.core import packing
        t = self.torch
        fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
        w_int = t.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1), (kdim, n),
                          generator=self.gen, dtype=t.int32)
        planes = packing.pack_planes(w_int, fmt)
        colsum = w_int.sum(0, dtype=t.int32).reshape(1, n)
        gamma = (t.rand((1, n), generator=self.gen) * 0.009 + 0.001)
        return fmt, planes, gamma, colsum

    def epilogue(self, kind, out_shape, res_dtype):
        from repro_torch.kernels.mpmm.epilogue import EpilogueSpec
        t = self.torch
        n = out_shape[-1]
        if kind == "none":
            return None, {}
        ops = {"scale": t.rand((1, n), generator=self.gen) + 0.5,
               "shift": t.randn((1, n), generator=self.gen) * 0.3}
        if kind == "bn":
            return EpilogueSpec(bn=True), ops
        if kind == "bn_relu":
            return EpilogueSpec(bn=True, relu=True), ops
        ops["residual"] = t.randn(out_shape, generator=self.gen).to(res_dtype)
        return EpilogueSpec(bn=True, residual=True, relu=True), ops

    def on_device(self, args):
        return {k: (v.to(self.device) if isinstance(v, self.torch.Tensor)
                    else v) for k, v in args.items()}

    # --- comparison -----------------------------------------------------

    def compare(self, kernel_name, label, got, want):
        """Bitwise check of a kernel output against the plain version."""
        t = self.torch
        got = got.cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            self.failures.append(f"{label}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
            return
        diff = (got.to(t.float32) - want.to(t.float32)).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        self.max_err[kernel_name] = max(self.max_err[kernel_name], err)
        if not t.equal(got, want):
            n_bad = int((diff > 0).sum())
            self.failures.append(f"{label}: {n_bad} of {diff.numel()} "
                                 f"differ, max abs err {err}")

    def check_phase(self, name):
        if self.failures:
            for f in self.failures[:40]:
                log(f"  FAIL {f}")
            raise SystemExit(f"{name}: {len(self.failures)} mismatches")
        log(f"[{name}] ok")

    # --- timing ---------------------------------------------------------

    def time_ms(self, fn, reps=20, warmup=3):
        """Mean device time of one call (CUDA events around ``reps``
        back-to-back calls, after ``warmup``; L2-warm)."""
        t = self.torch
        for _ in range(warmup):
            fn()
        t.cuda.synchronize()
        start = t.cuda.Event(enable_timing=True)
        end = t.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        t.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(self, fn, reps=20, warmup=3):
        """Device time of one call, back to back without the host: ``reps``
        calls captured in a CUDA graph (on a stream of their own, warmed up
        there first), the graph replayed between CUDA events; L2-warm."""
        t = self.torch
        if not hasattr(self, "graph_stream"):
            self.graph_stream = t.cuda.Stream(self.device)
        s = self.graph_stream
        s.wait_stream(t.cuda.current_stream())
        with t.cuda.stream(s):
            for _ in range(warmup):
                fn()
        s.synchronize()
        g = t.cuda.CUDAGraph()
        with t.cuda.graph(g, stream=s):
            for _ in range(reps):
                fn()
        g.replay()
        t.cuda.synchronize()
        start = t.cuda.Event(enable_timing=True)
        end = t.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        t.cuda.synchronize()
        del g
        return start.elapsed_time(end) / reps


# --- phase 2: K1 -----------------------------------------------------------


def k1_call(sm, m, kdim, n, w_bits, k, epi, variant, out_dtype, act_zero):
    fmt, planes, gamma, colsum = sm.weights(kdim, n, w_bits, k)
    spec, ops = sm.epilogue(epi, (m, n), out_dtype)
    args = dict(a_biased=sm.codes((m, kdim)), planes=planes, gamma=gamma,
                colsum=colsum, **ops)
    kw = dict(fmt=fmt, act_zero=act_zero, variant=variant,
              out_dtype=out_dtype, epilogue=spec)
    return args, kw


K1_ROWS = (100, 4)  # route A (M > 16) and route B (M <= 16)


def phase_k1(sm, path_k1, lm_shapes):
    from repro_torch.kernels.mpmm import kernel, ref
    t = sm.torch
    for m in K1_ROWS:
        route = kernel.mpmm_route(m, 45, 70)
        for w_bits, k in FORMATS:
            for variant in ("st", "sa"):
                # int32 accumulators: gamma = 1, act_zero = 0, f32 out gives
                # float(acc) exactly; held against the oracle's own decode.
                args, kw = k1_call(sm, m, 45, 70, w_bits, k, "none", variant,
                                   t.float32, 0)
                args["gamma"] = t.ones_like(args["gamma"])
                got = kernel.mpmm_cuda(**sm.on_device(args), **kw)
                want = ref.mpmm_ref_codes(args["a_biased"], args["planes"],
                                          kw["fmt"], act_zero=0).to(t.float32)
                sm.compare("mpmm_cuda",
                           f"K1 {route} acc M={m} w{w_bits}k{k} {variant}",
                           got, want)
                for epi in EPILOGUES:
                    for out_dtype in (t.float32, t.bfloat16):
                        args, kw = k1_call(sm, m, 45, 70, w_bits, k, epi,
                                           variant, out_dtype, 128)
                        got = kernel.mpmm_cuda(**sm.on_device(args), **kw)
                        sm.compare("mpmm_cuda",
                                   f"K1 {route} M={m} w{w_bits}k{k} "
                                   f"{variant} {epi} {out_dtype}",
                                   got, kernel.mpmm_torch(**args, **kw))
    # expert banks: E products in one launch, both routes, all 16 formats
    for m in K1_ROWS:
        route = kernel.mpmm_route(m, 45, 70)
        for w_bits, k in FORMATS:
            for variant in ("st", "sa"):
                args, kw = k1_bank_call(sm, m, 45, 70, w_bits, k, variant)
                got = kernel.mpmm_cuda(**sm.on_device(args), **kw)
                sm.compare("mpmm_cuda", f"K1 {route} bank E={BANK_E} M={m} "
                           f"w{w_bits}k{k} {variant}", got,
                           kernel.mpmm_torch(**args, **kw))
    for call in path_k1:
        for variant in ("st", "sa"):
            kw = dict(call["kw"], variant=variant)
            got = kernel.mpmm_cuda(**call["dev"], **kw)
            sm.compare("mpmm_cuda", f"K1 path {call['name']} {variant}", got,
                       kernel.mpmm_torch(**call["cpu"], **kw))
    # granite-8b's own prefill and decode shapes, against the plain version
    # on the card (its float64 integer product is exact there too)
    for phase, m, (kdim, n, w_bits, k), _ in lm_shapes:
        d, kw = k1_device_call(sm, m, kdim, n, w_bits, k, seed=m + kdim + n)
        got = kernel.mpmm_cuda(**d, **kw)
        want = kernel.mpmm_torch(**d, **kw)
        sm.compare("mpmm_cuda", f"K1 {kernel.mpmm_route(m, kdim, n)} LM "
                   f"{phase} M={m} K={kdim} N={n} w{w_bits}k{k}", got,
                   want.cpu())
        del d, got, want
    sm.check_phase("K1 mpmm_cuda vs mpmm_torch")


BANK_E = 3  # experts of phase 2's bank calls


def k1_bank_call(sm, m, kdim, n, w_bits, k, variant):
    """A bank of BANK_E experts (each its own weights, gamma, colsum and
    residual) with the residual epilogue, bf16 out."""
    from repro_torch.core import packing
    t = sm.torch
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    w_int = t.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1),
                      (BANK_E, kdim, n), generator=sm.gen, dtype=t.int32)
    spec, ops = sm.epilogue("bn_res_relu", (BANK_E, m, n), t.bfloat16)
    ops.update(scale=t.rand((BANK_E, 1, n), generator=sm.gen) + 0.5,
               shift=t.randn((BANK_E, 1, n), generator=sm.gen) * 0.3)
    args = dict(a_biased=sm.codes((BANK_E, m, kdim)),
                planes=packing.pack_planes(w_int, fmt).movedim(0, -3)
                .contiguous(),
                gamma=t.rand((BANK_E, 1, n), generator=sm.gen) * 0.009
                + 0.001,
                colsum=w_int.sum(-2, dtype=t.int32)[:, None], **ops)
    return args, dict(fmt=fmt, act_zero=128, variant=variant,
                      out_dtype=t.bfloat16, epilogue=spec)


def k1_device_call(sm, m, kdim, n, w_bits, k, seed):
    """A K1 call drawn on the card (bf16 out, no epilogue): the LM shapes
    are too large to draw and pack on the host."""
    from repro_torch.core import packing
    t = sm.torch
    g = t.Generator(device=sm.device).manual_seed(seed)
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    w_int = t.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1), (kdim, n),
                      generator=g, device=sm.device, dtype=t.int32)
    d = dict(a_biased=t.randint(-128, 128, (m, kdim), generator=g,
                                device=sm.device, dtype=t.int32).to(t.int8),
             planes=packing.pack_planes(w_int, fmt),
             gamma=t.rand((1, n), generator=g, device=sm.device) * 0.009
             + 0.001,
             colsum=w_int.sum(0, dtype=t.int32).reshape(1, n))
    return d, dict(fmt=fmt, act_zero=128, variant="st",
                   out_dtype=t.bfloat16, epilogue=None)


# --- phase 3: K2 -----------------------------------------------------------


def resnet_convs(cfg, plan):
    """The serve path's convs routed to K2, in order: (name, cin, cout,
    kernel, stride, h_in, w_bits, k, epilogue)."""
    from repro_torch.models import resnet as R
    out = []
    h = cfg.img_size // 4  # stem stride 2, max-pool stride 2
    for si, bi, cin, cmid, stride in R._block_channels(cfg):
        key = f"s{si}b{bi}"
        ho = -(-h // stride)
        layers = []
        if stride != 1 or cin != cmid:
            layers.append((key + "p", cin, cmid, 1, stride, h, "bn"))
        layers.append((key + "c1", cin, cmid, 3, stride, h, "bn_relu"))
        layers.append((key + "c2", cmid, cmid, 3, 1, ho, "bn_res_relu"))
        for name, ci, co, kk, s, hi, epi in layers:
            pol = plan.policy_for(name)
            out.append((name, ci, co, kk, s, hi, pol.bits_for("inner"), pol.k,
                        epi))
        h = ho
    return out


def k2_call(sm, batch, conv, epi, variant):
    """A K2 call at one of the path's convs: CPU and device operands (the
    unpadded input) and its keywords."""
    name, cin, cout, kk, stride, h, w_bits, k, _ = conv
    fmt, planes, gamma, colsum = sm.weights(kk * kk * cin, cout, w_bits, k)
    ho = -(-h // stride)
    spec, ops = sm.epilogue(epi, (batch, ho, ho, cout), sm.torch.bfloat16)
    kw = dict(fmt=fmt, act_zero=128, kh=kk, kw=kk, stride=stride,
              padding="SAME", variant=variant, out_dtype=sm.torch.bfloat16,
              epilogue=spec)
    cpu = dict(a_biased=sm.codes((batch, h, h, cin)), planes=planes,
               gamma=gamma, colsum=colsum, **ops)
    return cpu, sm.on_device(cpu), kw


def phase_k2(sm, convs):
    """Each conv at the path's batch and at batch 1 with its path
    epilogue, and at a small batch with Sum-Apart and the residual
    epilogue; then the formats the path's plan does not use, k > w among
    them, at two of its convs (N tiles 64 and 128; batch 1 splits)."""
    from repro_torch.kernels.mpmm import conv_kernel
    cases = [(conv, batch, epi, variant) for conv in convs
             for batch, epi, variant in ((TIME_BATCH, conv[-1], "st"),
                                         (SMALL_BATCH, conv[-1], "st"),
                                         (CHECK_BATCH, "bn_res_relu", "sa"))]
    path_formats = {conv[6:8] for conv in convs}
    for w_bits, k in FORMATS:
        if (w_bits, k) in path_formats:
            continue
        for conv in (convs[0], convs[5]):  # s0b0c1 (N 64), s1b0c1 (N 128)
            conv = conv[:6] + (w_bits, k) + conv[8:]
            cases += [(conv, SMALL_BATCH, conv[-1], "st"),
                      (conv, CHECK_BATCH, "bn_res_relu", "sa")]
    for conv, batch, epi, variant in cases:
        cpu, dev, kw = k2_call(sm, batch, conv, epi, variant)
        got = conv_kernel.conv_mpmm_cuda(**dev, **kw)
        want = conv_kernel.conv_mpmm_torch(**cpu, **kw)
        sm.compare("conv_mpmm_cuda", f"K2 {conv[0]} w{conv[6]}k{conv[7]} "
                   f"B={batch} {epi} {variant}", got, want)
    sm.check_phase("K2 conv_mpmm_cuda vs conv_mpmm_torch")


# --- phase 4: end to end ----------------------------------------------------


def phase_end_to_end(sm):
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels.mpmm import conv_kernel, kernel, ops
    from repro_torch.models import resnet as R
    from repro_torch.runtime.serve import ImageServer
    t = sm.torch
    api = configs.get(ARCH)
    plan = PrecisionPlan.load(PLAN)
    cfg = api.cfg
    t0 = time.perf_counter()
    params = api.init_params(sm.gen, device=sm.device)
    state = R.init_bn_state(api.specs(), device=sm.device)
    packed = R.pack_for_serve(cfg, params, state, plan)
    server = ImageServer(api=api, params=packed, batch_buckets=BUCKETS,
                         plan=plan, device=sm.device)
    plain = ImageServer(api=api, params=packed, batch_buckets=BUCKETS,
                        plan=plan, device=sm.device, impl="torch")
    log(f"[e2e] {cfg.name}: {cfg.img_size}x{cfg.img_size}, width "
        f"{cfg.width}, {cfg.n_classes} classes, plan {plan.name}; packed "
        f"in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    requests = [rng.normal(0, 1, (n, cfg.img_size, cfg.img_size, 3))
                .astype(np.float32) for n in REQUESTS]

    # The expected launches come from the layers' own dataflow choices at
    # each bucket's batch (the H100 cost model under 'auto').
    buckets = [b for n in REQUESTS for b in bucket_calls(server, n)]
    want, want_routes = {}, dict.fromkeys(kernel.ROUTES, 0)
    for b in buckets:
        w, r, flows = resnet_launches(cfg, plan, b)
        want = add_counts(want, w)
        want_routes = add_counts(want_routes, r)
        log(f"[e2e] bucket {b}: K1 {w['mpmm_cuda']} (routes {r}), K2 "
            f"{w['conv_mpmm_cuda']}; im2col convs "
            f"{[k for k, f in flows.items() if f == 'im2col']}")
    reset_counts()
    outs = [server.predict(x) for x in requests]
    t.cuda.synchronize()
    launches = {"mpmm_cuda": kernel.mpmm_cuda.launches,
                "conv_mpmm_cuda": conv_kernel.conv_mpmm_cuda.launches}
    log(f"[e2e] {len(buckets)} bucket calls {buckets}, launches {launches}, "
        f"compiled buckets {server.compiled_buckets}")
    routes = dict(kernel.mpmm_cuda.routes)
    log(f"[e2e] K1 routes {routes}")
    if launches != want or routes != want_routes:
        raise SystemExit(f"launch counts {launches} / routes {routes} != the "
                         f"layers' choices {want} / {want_routes}")

    for n, x, y in zip(REQUESTS, requests, outs):
        if y.shape != (n, cfg.n_classes) or not np.isfinite(y).all():
            raise SystemExit(f"request of {n}: logits {y.shape}, finite "
                             f"{np.isfinite(y).all()}")
        if float(y.std()) == 0.0:
            raise SystemExit(f"request of {n}: constant logits")
        ref_y = plain.predict(x)
        tol = E2E_LOGIT_TOL * float(np.abs(ref_y).max())
        err = float(np.abs(y - ref_y).max())
        # Flipped classifier-input codes between the two feature paths.
        xt = t.from_numpy(x[:min(n, BUCKETS[-1])]).to(sm.device)
        f_k = R.serve_features(cfg, server.params, xt, plan)
        f_p = R.serve_features(cfg, server.params, xt, plan, impl="torch")
        ga = server.params["fc"]["ga"]
        flips = float((ops.quantize_activations(f_k, ga)
                       != ops.quantize_activations(f_p, ga)).float().mean())
        log(f"[e2e] request {n}: logits {y.shape}, max |kernel - plain| "
            f"{err} (tol {tol}), identical {bool((y == ref_y).all())}, "
            f"flipped fc-input codes {flips}")
        if err > tol or flips > E2E_MAX_FLIP_RATE:
            raise SystemExit(f"request of {n}: outside the end-to-end "
                             f"contract")
    log("[e2e] ok")
    return server, cfg, plan, launches, routes


def frames_per_second(sm, server, cfg):
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    fps = {}
    for b in BUCKETS:
        x = rng.normal(0, 1, (b, cfg.img_size, cfg.img_size, 3)).astype(
            np.float32)
        server.predict(x)
        server.predict(x)
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            server.predict(x)  # returns host numpy: synchronized
        fps[b] = b * reps / (time.perf_counter() - t0)
    return fps


# --- phase 5: timing at the path's shapes ------------------------------------


def path_k1_calls(sm, cfg, plan, batch):
    """K1's two launches per forward: the stem as im2col, the classifier."""
    t = sm.torch
    calls = []
    hw = cfg.img_size // 2
    stem_pol = plan.policy_for("stem")
    fc_pol = plan.policy_for("fc")
    for name, m, kdim, n, pol, epi, az in (
            ("stem", batch * hw * hw, 147, cfg.width, stem_pol, "bn_relu", 0),
            ("fc", batch, cfg.fc_in, cfg.n_classes, fc_pol, "none", 128)):
        cpu, kw = k1_call(sm, m, kdim, n, pol.bits_for("boundary"), pol.k,
                          epi, "st", t.bfloat16, az)
        calls.append({"name": name, "cpu": cpu, "dev": sm.on_device(cpu),
                      "kw": kw, "m": m, "k": kdim, "n": n})
    return calls


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def bound_ms(bytes_moved, ops_done):
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = ops_done / PEAK_INT8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_library(sm, d, fmt):
    """K1's yardstick: one PyTorch call for the same product on the
    combined int8 weights -> (callable, its name)."""
    from repro_torch.kernels.mpmm import ref
    t = sm.torch
    a = d["a_biased"]
    w8 = ref.combined_int8_weights(d["planes"], fmt)
    (m, kdim), n = a.shape, w8.shape[1]
    if m > 16 and kdim % 8 == 0 and n % 8 == 0:
        try:
            t._int_mm(a, w8)
            return (lambda: t._int_mm(a, w8)), "torch._int_mm (int8)"
        except RuntimeError as e:  # a cuBLASLt refusal: the f32 yardstick
            log(f"[time] torch._int_mm refuses M={m} K={kdim} N={n}: {e}")
    # _int_mm needs M > 16 and K, N multiples of 8
    af, wf = a.float(), w8.float()
    return (lambda: t.mm(af, wf)), "torch.mm (f32, TF32 off)"


def measure(sm, path_k1, convs):
    from repro_torch.kernels.mpmm import kernel
    t = sm.torch
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    rows = []
    for call in path_k1:
        d, kw = call["dev"], call["kw"]
        out = kernel.mpmm_cuda(**d, **kw)
        m, kdim, n = call["m"], call["k"], call["n"]
        lib, lib_name = k1_library(sm, d, kw["fmt"])
        by = nbytes(d["a_biased"], d["planes"], d["gamma"], d["colsum"],
                    d.get("scale"), d.get("shift"), d.get("residual"), out)
        b_ms, b_by = bound_ms(by, 2 * m * n * kdim)
        rows.append({
            "kernel": "mpmm_cuda", "layer": call["name"],
            "route": kernel.mpmm_route(m, kdim, n),
            "shape": f"M={m} K={kdim} N={n} w{kw['fmt'].w_bits}k{kw['fmt'].k}",
            "ms": sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw)),
            "plain_ms": sm.time_ms(lambda: kernel.mpmm_torch(**d, **kw)),
            "library_ms": sm.time_ms(lib), "library": lib_name,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": by,
            "ops": 2 * m * n * kdim})
    for batch in (TIME_BATCH, SMALL_BATCH):
        rows += [measure_k2(sm, batch, conv) for conv in convs]
    return rows


def measure_k2(sm, batch, conv):
    """One K2 row: the kernel on the unpadded input, its plain version,
    ``F.conv2d`` in f32 on the padded input, the bound and the plan.  The
    kernel and ``F.conv2d`` are timed on the device (``graph_ms``): a K2
    call costs the host more than the device (``call_ms``, call after
    call), which would time the wrapper, not the kernel."""
    from repro_torch.kernels.mpmm import conv_kernel, ref
    t = sm.torch
    _, dev, kw = k2_call(sm, batch, conv, conv[-1], "st")
    out = conv_kernel.conv_mpmm_cuda(**dev, **kw)
    name, cin, cout, kk, stride = conv[:5]
    xp = ref.pad_spatial(dev["a_biased"], kk, kk, stride, "SAME", fill=-128)
    xf = xp.permute(0, 3, 1, 2).float().contiguous(
        memory_format=t.channels_last)
    wf = (ref.combined_int8_weights(dev["planes"], kw["fmt"])
          .reshape(kk, kk, cin, cout).permute(3, 2, 0, 1).float()
          .contiguous(memory_format=t.channels_last))
    _, ho, wo, _ = out.shape
    m = batch * ho * wo
    kdim = kk * kk * cin
    plan = conv_kernel.conv_plan(batch, ho, wo, cout, kdim, kw["fmt"])
    by = nbytes(dev["a_biased"], dev["planes"], dev["gamma"], dev["colsum"],
                dev.get("scale"), dev.get("shift"), dev.get("residual"), out)
    b_ms, b_by = bound_ms(by, 2 * m * cout * kdim)
    return {
        "kernel": "conv_mpmm_cuda", "layer": name, "batch": batch,
        "shape": (f"B={batch} H={conv[5]} C={cin} N={cout} "
                  f"{kk}x{kk}/{stride} w{conv[6]}k{conv[7]} {conv[-1]}"),
        "plan": (f"tile {plan.bm}x{plan.bn}, {plan.splits} split(s) of "
                 f"{plan.steps} K-step(s) ({plan.k_steps} in all), "
                 f"{plan.blocks} blocks"),
        "ms": sm.graph_ms(lambda: conv_kernel.conv_mpmm_cuda(**dev, **kw)),
        "call_ms": sm.time_ms(lambda: conv_kernel.conv_mpmm_cuda(**dev,
                                                                 **kw)),
        "plain_ms": sm.time_ms(lambda: conv_kernel.conv_mpmm_torch(
            **dev, **kw)),
        "library_ms": sm.graph_ms(lambda: t.nn.functional.conv2d(
            xf, wf, stride=stride)),
        "library": "F.conv2d (f32, TF32 off, channels_last)",
        "bound_ms": b_ms, "bound_by": b_by, "bytes": by,
        "ops": 2 * m * cout * kdim}


def k2_build_info(convs):
    """[build] lines for the K2 instantiations the path runs, and for the
    k > w formats at both N tiles: dynamic shared memory and resident
    blocks an SM."""
    from repro_torch.core.packing import PlaneFormat
    from repro_torch.kernels.mpmm import conv_kernel
    keys = [(w_bits, k, variant, conv_kernel.n_tile(cout))
            for _, _, cout, _, _, _, w_bits, k, _ in convs
            for variant in ("st", "sa")]
    keys += [(w_bits, k, variant, bn) for w_bits, k in FORMATS if k > w_bits
             for variant in ("st", "sa") for bn in conv_kernel.N_TILES]
    for key in dict.fromkeys(keys):
        w_bits, k, variant, bn = key
        fmt = PlaneFormat(w_bits=w_bits, k=k, k_dim=1152)
        smem, blocks = conv_kernel.kernel_info(fmt, variant, bn)
        log(f"[build] conv_mpmm: w{w_bits}k{k} {variant} N tile {bn}: "
            f"{smem} bytes of dynamic shared memory, {blocks} block(s) an "
            f"SM")


# --- phases 6-7: K3 and K4 -----------------------------------------------------


def bf16_ulp(t, x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    _, e = t.frexp(x.abs().clamp_min(2.0 ** -126))
    return t.ldexp(t.ones_like(x), e - 8)


def compare_close(sm, kernel_name, label, got, want, tol=None):
    """A flash kernel's output against another version of the same function
    on the card: bf16 within one ulp of the larger value plus 1e-5 (the f32
    tolerance: outputs near zero come from cancelling sums, more so in K4's
    affine scores), or within ``tol`` absolute plus ``tol`` relative.  Only
    comparisons with the plain version (tol None) enter the kernel's
    max_abs_err."""
    t = sm.torch
    if got.shape != want.shape or got.dtype != want.dtype:
        sm.failures.append(f"{label}: {tuple(got.shape)}/{got.dtype} vs "
                           f"{tuple(want.shape)}/{want.dtype}")
        return 0.0
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if tol is None:
        bound = bf16_ulp(t, t.maximum(g.abs(), w.abs())) + 1e-5
    else:
        bound = tol + tol * w.abs()
    max_err = float(err.max())
    if tol is None:
        sm.max_err[kernel_name] = max(sm.max_err[kernel_name], max_err)
    n_bad = int((err > bound).sum())
    if n_bad:
        sm.failures.append(f"{label}: {n_bad} of {err.numel()} outside the "
                           f"tolerance, max abs err {max_err}")
    return max_err


def attn_inputs(sm, b, sq, sk, seed):
    """bf16 q (B, Sq, H, D) and k, v (B, Sk, KV, D) at granite's heads."""
    t = sm.torch
    g = t.Generator(device=sm.device).manual_seed(seed)
    mk = lambda s, h: t.randn((b, s, h, ATTN_D), generator=g,  # noqa: E731
                              device=sm.device).to(t.bfloat16)
    return mk(sq, ATTN_HEADS), mk(sk, ATTN_KV), mk(sk, ATTN_KV)


K3_CASES = [dict(sq=1000, sk=1000), dict(sq=1024, sk=1024),
            dict(sq=1024, sk=1024, window=256),
            dict(sq=8, sk=1024, q_offset=1016),
            dict(sq=9, sk=1024, q_offset=1015),
            dict(sq=1000, sk=1000, causal=False)]


def phase_k3(sm, block_k):
    from repro_torch.kernels.flashattn import ops as fops
    for i, case in enumerate(K3_CASES):
        kw = {k: v for k, v in case.items() if k not in ("sq", "sk")}
        q, k, v = attn_inputs(sm, LM_BATCH, case["sq"], case["sk"], 100 + i)
        got = fops.flash_attention(q, k, v, block_k=block_k, impl="cuda",
                                   **kw)
        want = fops.flash_attention(q, k, v, block_k=block_k, impl="torch",
                                    **kw)
        sm.torch.cuda.synchronize()
        err = compare_close(sm, "flash_fwd_cuda", f"K3 {case}", got, want)
        log(f"[K3] {case}: max abs err vs plain {err}")
    sm.check_phase("K3 flash_fwd_cuda vs flash_fwd_torch")


K4_CASES = [((2, 2), (2, 2), dict(sq=1000, sk=1000)),
            ((4, 4), (4, 4), dict(sq=1000, sk=1000)),
            ((8, 4), (8, 4), dict(sq=1000, sk=1000)),
            ((2, 2), (4, 4), dict(sq=1024, sk=1024)),
            ((8, 4), (2, 2), dict(sq=8, sk=1024, q_offset=1016)),
            ((2, 2), (4, 4), dict(sq=9, sk=1024, q_offset=1015))]


def phase_k4(sm, block_k):
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.nn import kvcache
    for i, (fk, fv, case) in enumerate(K4_CASES):
        kw = {k: v for k, v in case.items() if k not in ("sq", "sk")}
        q, k, v = attn_inputs(sm, LM_BATCH, case["sq"], case["sk"], 200 + i)
        fmt_k = kvcache.KVFormat(*fk, ATTN_D)
        fmt_v = kvcache.KVFormat(*fv, ATTN_D)
        kq, vq = kvcache.pack_kv(k, fmt_k), kvcache.pack_kv(v, fmt_v)
        got = fops.flash_attention_packed(q, kq, vq, fmt_k, fmt_v,
                                          block_k=block_k, impl="cuda", **kw)
        want = fops.flash_attention_packed(q, kq, vq, fmt_k, fmt_v,
                                           block_k=block_k, impl="torch",
                                           **kw)
        k3 = fops.flash_attention(q, kvcache.unpack_kv(kq, fmt_k),
                                  kvcache.unpack_kv(vq, fmt_v),
                                  block_k=block_k, impl="cuda", **kw)
        sm.torch.cuda.synchronize()
        label = f"K4 k{fk} v{fv} {case}"
        err = compare_close(sm, "flash_fwd_packed_cuda", label, got, want)
        err_k3 = compare_close(sm, "flash_fwd_packed_cuda", label + " vs K3",
                               got, k3, tol=K4_VS_K3_TOL)
        log(f"[K4] kv bits/slice k{fk} v{fv} {case}: max abs err vs plain "
            f"{err}, vs K3 on the unpacked cache {err_k3} (tol "
            f"{K4_VS_K3_TOL} absolute + relative)")
    sm.check_phase("K4 flash_fwd_packed_cuda vs flash_fwd_packed_torch "
                   "and vs K3")


# --- phase 8: the LM end to end -----------------------------------------------


COUNTED = (("mpmm_cuda", "repro_torch.kernels.mpmm.kernel"),
           ("conv_mpmm_cuda", "repro_torch.kernels.mpmm.conv_kernel"),
           ("flash_fwd_cuda", "repro_torch.kernels.flashattn.kernel"),
           ("flash_fwd_packed_cuda", "repro_torch.kernels.flashattn.kernel"))


def reset_counts():
    import importlib
    from repro_torch.kernels.mpmm import kernel
    for name, mod in COUNTED:
        getattr(importlib.import_module(mod), name).launches = 0
    kernel.mpmm_cuda.routes = dict.fromkeys(kernel.ROUTES, 0)
    kernel.mpmm_cuda.acc_launches = 0


def read_counts():
    import importlib
    return {name: getattr(importlib.import_module(mod), name).launches
            for name, mod in COUNTED}


def lm_api(depth, plan):
    """granite-8b at full width under ``plan``; ``depth`` keeps the first
    layers (None: all of them)."""
    from repro_torch import configs
    api = configs.get(LM_ARCH)
    cfg = dataclasses.replace(api.cfg, n_layers=depth or api.cfg.n_layers)
    return dataclasses.replace(api, cfg=cfg, policy=plan)


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


def prefill_contract(sm, api, params, prompts, label):
    """The prefill, layer by layer.  One-layer error: each plain layer fed
    the kernel path's own input, against the kernel layer -- held to
    ``LM_LOGIT_TOL`` of the largest |output| and ``LM_MAX_FLIP_RATE`` of
    differing bf16 outputs, and so are the last token's logits and head-
    input codes taken through the plain last layer.  Carried drift: each
    path fed its own previous output, printed per layer as ``[drift]``
    lines (8-bit requantization carries any sub-ulp difference onward)."""
    from repro_torch.kernels.mpmm import ops
    from repro_torch.models import transformer as T
    t = sm.torch
    cfg, plan = api.cfg, api.policy
    kv = T.kv_formats(cfg, plan)
    store, fmts = kv if kv is not None else ("packed", [None] * cfg.n_layers)
    ga = params["head"]["ga"]

    def stats(a, b):
        a, b = a.float(), b.float()
        return (float((a - b).abs().max()) / float(a.abs().max()),
                float((a != b).float().mean()))

    def flips(a, b):
        return float((ops.quantize_activations(T._head_input(cfg, params, a),
                                               ga)
                      != ops.quantize_activations(
                          T._head_input(cfg, params, b), ga)).float().mean())

    worst = [0.0, 0.0]
    b, s = prompts.shape
    with t.inference_mode():
        tt = t.as_tensor(prompts, device=sm.device)
        x_k = x_p = T._embed(params, tt)
        sin, cos = T._rotary(cfg, T._positions(b, s, 0, sm.device))
        for i, lp in enumerate(params["layers"]):
            kw = dict(lname=f"l{i}.", kv_fmts=fmts[i], kv_store=store)
            y_k, _ = T._layer_fwd(cfg, lp, x_k, plan, sin, cos, impl="cuda",
                                  **kw)
            y_1, _ = T._layer_fwd(cfg, lp, x_k, plan, sin, cos,
                                  impl="torch", **kw)
            y_p, _ = T._layer_fwd(cfg, lp, x_p, plan, sin, cos,
                                  impl="torch", **kw)
            rel, diff = stats(y_k, y_1)
            c_rel, c_diff = stats(y_k, y_p)
            log(f"[drift] {label} layer {i}: one-layer {rel:.6f} of the "
                f"largest |output|, {diff:.6f} of outputs differ; carried "
                f"{c_rel:.6f}, {c_diff:.6f}")
            worst = [max(worst[0], rel), max(worst[1], diff)]
            if rel > LM_LOGIT_TOL or diff > LM_MAX_FLIP_RATE:
                raise SystemExit(f"{label} layer {i}: one-layer error "
                                 f"{rel:.5f} of the largest |output|, "
                                 f"{diff:.5f} of outputs differ (tol "
                                 f"{LM_LOGIT_TOL}, {LM_MAX_FLIP_RATE})")
            x_k, x_p = y_k, y_p
        last = (x_k[:, -1:], y_1[:, -1:], x_p[:, -1:])
        l_k = T._head(cfg, params, last[0], plan, "cuda")
        l_1 = T._head(cfg, params, last[1], plan, "torch")
        l_p = T._head(cfg, params, last[2], plan, "torch")
    out = {"layer_rel": worst[0], "layer_diff": worst[1],
           "logits_rel": stats(l_k, l_1)[0], "flips": flips(last[0], last[1]),
           "carried_rel": stats(l_k, l_p)[0],
           "carried_flips": flips(last[0], last[2])}
    if out["logits_rel"] > LM_LOGIT_TOL or out["flips"] > LM_MAX_FLIP_RATE:
        raise SystemExit(f"{label}: last-token logits {out['logits_rel']:.5f}"
                         f" of the largest |logit| apart, {out['flips']} "
                         f"head-input codes flipped")
    return out


def decode_contract(sm, gen, plain, prompts, toks, label, frames=None):
    """Every decode step, teacher-forced: the plain path runs on a copy of
    the kernel path's own cache with the kernel path's token; decode has no
    flash kernel and K1 is bitwise, so the logits must be equal.  prompts
    (B, S), toks (B, n_new): the run's shape; ``frames``: whisper's audio
    frames on the card."""
    t = sm.torch
    (b, s), n_new = prompts.shape, toks.shape[1]
    with t.inference_mode():
        logits, pre = gen.prefill(t.as_tensor(prompts, device=sm.device),
                                  frames)
        cache = gen._grow_cache(pre, b, s, s + n_new)
        for i in range(n_new - 1):
            feed = t.as_tensor(toks[:, i:i + 1], device=sm.device)
            l_p, _ = plain.decode(clone_tree(cache), feed, s + i)
            l_k, cache = gen.decode(cache, feed, s + i)
            if not t.equal(l_k, l_p):
                err = float((l_k.float() - l_p.float()).abs().max())
                raise SystemExit(f"{label} decode step {i}: kernel and plain "
                                 f"logits differ (max {err})")


def serve_lm(sm, api, params, prompts, label, expect):
    """One Generator run through the kernels, counted; then the contract
    against the same model through the plain versions."""
    import numpy as np
    from repro_torch.runtime.serve import Generator
    t = sm.torch
    depth = api.cfg.n_layers
    gen = Generator(api, params, device=sm.device)
    plain = Generator(api, params, device=sm.device, impl="torch")
    reset_counts()
    t0 = time.perf_counter()
    toks, logits = gen.run(prompts, LM_NEW)
    t.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    from repro_torch.kernels.mpmm import kernel
    routes = dict(kernel.mpmm_cuda.routes)
    want = dict(expect, mpmm_cuda=(7 * depth + 1) * LM_NEW, conv_mpmm_cuda=0)
    # the prefill's projections on route A, its head and every decode
    # step's projections and head on route B
    want_routes = {"wgmma": 7 * depth,
                   "splitk": 1 + (LM_NEW - 1) * (7 * depth + 1)}
    log(f"[lm] {label}: depth {depth}, {LM_BATCH} prompts x {LM_PROMPT} "
        f"tokens, {LM_NEW} new tokens in {wall:.2f} s (1 prefill + "
        f"{LM_NEW - 1} decode steps); launches {launches}; K1 routes "
        f"{routes}")
    if launches != want:
        raise SystemExit(f"{label}: launch counts {launches} != {want}")
    if routes != want_routes:
        raise SystemExit(f"{label}: K1 routes {routes} != {want_routes}")
    for step, a in enumerate(logits):
        a = a.float()
        if a.shape != (LM_BATCH, api.cfg.vocab) or not bool(
                t.isfinite(a).all()) or float(a.std()) == 0.0:
            raise SystemExit(f"{label} step {step}: logits {tuple(a.shape)} "
                             f"not finite or constant")
    pc = prefill_contract(sm, api, params, prompts, label)
    decode_contract(sm, gen, plain, prompts, toks, label)
    log(f"[lm] {label}: tokens[0] {toks[0].tolist()}; prefill one-layer "
        f"error <= {pc['layer_rel']:.5f} of the largest |output|, <= "
        f"{pc['layer_diff']:.5f} of outputs differ; last-token logits "
        f"{pc['logits_rel']:.5f}, head-input flips {pc['flips']:.5f} (tol "
        f"{LM_LOGIT_TOL}, {LM_MAX_FLIP_RATE}); {LM_NEW - 1} decode steps "
        f"bitwise equal; carried through {depth} layers: logits "
        f"{pc['carried_rel']:.5f}, head-input flips "
        f"{pc['carried_flips']:.5f}")
    return {"launches": launches, "routes": routes,
            "tokens": np.asarray(toks), "wall": wall, "contract": pc}


def phase_lm(sm):
    import numpy as np
    from repro_torch.core.plan import PrecisionPlan, strip_kv
    from repro_torch.runtime.serve import init_packed_lm
    t = sm.torch
    plan = PrecisionPlan.load(LM_PLAN)
    api = lm_api(None, plan)
    cfg = api.cfg
    depth = cfg.n_layers
    t0 = time.perf_counter()
    params = init_packed_lm(api, t.Generator(device=sm.device).manual_seed(
        SEED), device=sm.device)
    t.cuda.synchronize()
    log(f"[lm] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv} KV heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, depth {depth}, plan {plan.name}; drawn and "
        f"packed layer by layer in {time.perf_counter() - t0:.2f} s, "
        f"{t.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                   (LM_BATCH, LM_PROMPT))
    run = serve_lm(sm, api, params, prompts, "packed KV cache (K4)",
                   {"flash_fwd_packed_cuda": depth, "flash_fwd_cuda": 0})
    api3 = lm_api(K3_DEPTH, strip_kv(plan))
    params3 = dict(params, layers=params["layers"][:K3_DEPTH])
    run3 = serve_lm(sm, api3, params3, prompts, "bf16 KV cache (K3)",
                    {"flash_fwd_packed_cuda": 0, "flash_fwd_cuda": K3_DEPTH})
    log("[lm] ok")
    return api, params, prompts, run, run3


# --- phase 9: LM timing -------------------------------------------------------


def causal_pairs(sq, sk, q_offset=0):
    """(query, key) pairs a causal mask leaves: sum_i min(q_offset+i+1, Sk)."""
    return sum(min(q_offset + i + 1, sk) for i in range(sq))


def attn_bound(bytes_moved, pairs, b):
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = 4 * b * ATTN_HEADS * ATTN_D * pairs / PEAK_BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sdpa_call(sm, q, k, v):
    """The library yardstick: F.scaled_dot_product_attention in bf16,
    causal, GQA by enable_gqa (or K/V heads expanded beforehand)."""
    t = sm.torch
    F = t.nn.functional
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)), "enable_gqa"
    except TypeError:
        g = ATTN_HEADS // ATTN_KV
        ke, ve = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
        return (lambda: F.scaled_dot_product_attention(
            qt, ke, ve, is_causal=True)), "K/V heads expanded"


def measure_attention(sm, api):
    """K3 and K4 per layer at the path's prefill shapes, and summed per
    prefill (K4 over the plan's per-layer cache formats)."""
    from collections import Counter
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.models import transformer as T
    from repro_torch.nn import kvcache
    t = sm.torch
    block_k = api.cfg.attn_chunk
    q, k, v = attn_inputs(sm, LM_BATCH, LM_PROMPT, LM_PROMPT, 300)
    pairs = causal_pairs(LM_PROMPT, LM_PROMPT)
    rows = []
    out = fops.flash_attention(q, k, v, block_k=block_k, impl="cuda")
    lib, lib_how = sdpa_call(sm, q, k, v)
    b_ms, b_by = attn_bound(nbytes(q, k, v, out), pairs, LM_BATCH)
    rows.append({
        "kernel": "flash_fwd_cuda", "layer": "any", "count": K3_DEPTH,
        "shape": f"B={LM_BATCH} S={LM_PROMPT} H={ATTN_HEADS} KV={ATTN_KV} "
                 f"D={ATTN_D} bf16 causal",
        "ms": sm.time_ms(lambda: fops.flash_attention(
            q, k, v, block_k=block_k, impl="cuda"), reps=10),
        "plain_ms": sm.time_ms(lambda: fops.flash_attention(
            q, k, v, block_k=block_k, impl="torch"), reps=3, warmup=1),
        "library_ms": sm.time_ms(lib, reps=10),
        "library": f"F.scaled_dot_product_attention bf16 causal ({lib_how})",
        "bound_ms": b_ms, "bound_by": b_by})
    fmts = Counter(
        tuple((f.bits, f.k) for f in pair)
        for pair in T.kv_formats(api.cfg, api.policy)[1])
    for (fk, fv), count in sorted(fmts.items()):
        fmt_k = kvcache.KVFormat(*fk, ATTN_D)
        fmt_v = kvcache.KVFormat(*fv, ATTN_D)
        kq, vq = kvcache.pack_kv(k, fmt_k), kvcache.pack_kv(v, fmt_v)
        kd, vd = kvcache.unpack_kv(kq, fmt_k), kvcache.unpack_kv(vq, fmt_v)
        run = lambda impl: fops.flash_attention_packed(  # noqa: E731
            q, kq, vq, fmt_k, fmt_v, block_k=block_k, impl=impl)
        out = run("cuda")
        lib, lib_how = sdpa_call(sm, q, kd, vd)
        b_ms, b_by = attn_bound(nbytes(q, *kq.values(), *vq.values(), out),
                                pairs, LM_BATCH)
        rows.append({
            "kernel": "flash_fwd_packed_cuda", "layer": f"k{fk} v{fv}",
            "count": count,
            "shape": f"B={LM_BATCH} S={LM_PROMPT} H={ATTN_HEADS} "
                     f"KV={ATTN_KV} D={ATTN_D} K kv{fk[0]}k{fk[1]} "
                     f"V kv{fv[0]}k{fv[1]} causal",
            "ms": sm.time_ms(lambda: run("cuda"), reps=10),
            "plain_ms": sm.time_ms(lambda: run("torch"), reps=3, warmup=1),
            "library_ms": sm.time_ms(lib, reps=10),
            "library": f"F.scaled_dot_product_attention bf16 causal on the "
                       f"unpacked K/V, reading unpacked bytes ({lib_how})",
            "bound_ms": b_ms, "bound_by": b_by})
    return rows


def lm_k1_shapes(api):
    """Distinct K1 calls of one prefill: (K, N, w_bits, k) -> count, and
    the head's (K, N, w_bits, k) at M = batch."""
    from collections import Counter
    from repro_torch.core import plan as plan_lib
    cfg = api.cfg
    hd = cfg.hd
    calls = Counter()
    for i in range(cfg.n_layers):
        for name, kdim, n in (("q", cfg.d_model, cfg.n_heads * hd),
                              ("k", cfg.d_model, cfg.n_kv * hd),
                              ("v", cfg.d_model, cfg.n_kv * hd),
                              ("o", cfg.n_heads * hd, cfg.d_model),
                              ("mlp", cfg.d_model, cfg.d_ff),
                              ("mlp", cfg.d_model, cfg.d_ff),
                              ("mlp", cfg.d_ff, cfg.d_model)):
            pol = plan_lib.resolve_policy(api.policy, f"l{i}.{name}")
            calls[(kdim, n, pol.bits_for("inner"), pol.k)] += 1
    head = plan_lib.resolve_policy(api.policy, "head")
    from repro_torch.nn.layers import pad_vocab
    return calls, (cfg.d_model, pad_vocab(cfg.vocab),
                   head.bits_for("boundary"), head.k)


def lm_k1_calls(api):
    """K1's calls at the LM's shapes, per distinct shape: (phase, M, (K, N,
    w_bits, k), count) for the prefill's projections (M = batch x prompt)
    and head (M = batch), and a decode step's projections and head (M =
    batch)."""
    calls, head = lm_k1_shapes(api)
    shapes = [("prefill", LM_BATCH * LM_PROMPT, key, count)
              for key, count in sorted(calls.items())]
    shapes += [("prefill", LM_BATCH, head, 1)]
    shapes += [("decode", LM_BATCH, key, count)
               for key, count in sorted(calls.items())]
    shapes += [("decode", LM_BATCH, head, 1)]
    return shapes


def measure_k1_lm(sm, api):
    """K1 at the LM's shapes (``lm_k1_calls``): kernel, plain version and
    one library call, each shape's route and its bound."""
    from repro_torch.kernels.mpmm import kernel
    rows = []
    for phase, m, (kdim, n, w_bits, k), count in lm_k1_calls(api):
        d, kw = k1_device_call(sm, m, kdim, n, w_bits, k, seed=7 * m + n)
        out = kernel.mpmm_cuda(**d, **kw)
        by = nbytes(d["a_biased"], d["planes"], d["gamma"], d["colsum"], out)
        b_ms, b_by = bound_ms(by, 2 * m * n * kdim)
        lib, lib_name = k1_library(sm, d, kw["fmt"])
        rows.append({"kernel": "mpmm_cuda", "phase": phase,
                     "route": kernel.mpmm_route(m, kdim, n),
                     "shape": f"M={m} K={kdim} N={n} w{w_bits}k{k}",
                     "count": count,
                     "ms": sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw),
                                      reps=10, warmup=2),
                     "plain_ms": sm.time_ms(
                         lambda: kernel.mpmm_torch(**d, **kw), reps=2,
                         warmup=1),
                     "library_ms": sm.time_ms(lib, reps=10, warmup=2),
                     "library": lib_name,
                     "bound_ms": b_ms, "bound_by": b_by})
        del lib, d
    return rows


def measure_lm_end_to_end(sm, api, params, prompts, n_new=LM_NEW,
                          frames=None):
    """Prefill and decode through the kernels, timed with CUDA events;
    prompts (B, S), ``n_new`` tokens of cache room, ``frames`` whisper's
    audio frames on the card."""
    from repro_torch.runtime.serve import Generator
    t = sm.torch
    b, s = prompts.shape
    gen = Generator(api, params, device=sm.device)
    tt = t.as_tensor(prompts, device=sm.device)
    with t.inference_mode():
        prefill_ms = sm.time_ms(lambda: gen.prefill(tt, frames), reps=2,
                                warmup=1)
        logits, pre = gen.prefill(tt, frames)
        cache = gen._grow_cache(pre, b, s, s + n_new)
        tok = t.argmax(logits, -1)[:, None]
        steps = iter(range(n_new - 1))
        decode_ms = sm.time_ms(
            lambda: gen.decode(cache, tok, s + next(steps)),
            reps=n_new - 3, warmup=2)
    return prefill_ms, decode_ms


# --- phase 10: speculative decoding, the schedulers, the entry point ---------


class StepClock:
    """The schedulers' injected clock: the smoke sets it before each step
    (``tick``: to the host clock; ``advance``: by a fixed step), so every
    read inside a step sees one time and admission never races the host."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self):
        self.t = time.perf_counter()

    def advance(self, dt):
        self.t += dt


def phase_spec(sm, depth=None, phase8_tokens=None):
    """(a) ``SpeculativeGenerator`` (k = SPEC_K) over granite-8b at full
    width: two packed views of one weight draw, verify under
    ``granite_8b_mixed.json``, draft under ``granite_8b_draft_w2.json``.
    Its tokens must equal the verify-only ``Generator``'s on the same
    view (and phase 8's, which drew the same weights); its launch counts
    must be the calls the path makes, cycle by cycle; one verify cycle's
    logits must equal SPEC_K + 1 sequential decode steps on a copy of the
    cache, bitwise, caches included.  (b) The ``attn_impl='flash'``
    verify: K4 once a layer, its attention within one bf16 ulp of K4's
    plain version and within K4_VS_K3_TOL of the default per-query route
    on the cache the verify wrote.  -> (generator, prompts, results)."""
    import numpy as np
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.models import transformer as T
    from repro_torch.nn import attention as attn
    from repro_torch.runtime import telemetry as tele
    from repro_torch.runtime.serve import init_packed_views
    from repro_torch.runtime.specdec import SpeculativeGenerator
    t = sm.torch
    vplan, dplan = PrecisionPlan.load(LM_PLAN), PrecisionPlan.load(DRAFT_PLAN)
    api = lm_api(depth, vplan)
    cfg, n = api.cfg, api.cfg.n_layers
    t0 = time.perf_counter()
    views = init_packed_views(api, [vplan, dplan], t.Generator(
        device=sm.device).manual_seed(SEED), device=sm.device)
    t.cuda.synchronize()
    log(f"[spec] {cfg.name} depth {n}: verify [{vplan.name}] and draft "
        f"[{dplan.name}] drawn once and packed in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{t.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    tracer = tele.Tracer()
    sg = SpeculativeGenerator(api=api, packed_views=tuple(views),
                              draft_plan=dplan, k=SPEC_K, device=sm.device,
                              tracer=tracer)
    del views
    gen = sg.gen_verify
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                   (LM_BATCH, LM_PROMPT))
    t0 = time.perf_counter()
    want = gen.generate(prompts, LM_NEW)  # host numpy: synchronised
    verify_s = time.perf_counter() - t0
    reset_counts()
    n0 = len(tracer.events)
    t0 = time.perf_counter()
    got = sg.generate(prompts, LM_NEW)
    spec_s = time.perf_counter() - t0
    launches = read_counts()
    routes = dict(kernel.mpmm_cuda.routes)
    cycles = [e for e in list(tracer.events)[n0:] if e[1] == "specdec.accept"]
    k_effs = [e[6]["drafted"] // LM_BATCH for e in cycles]
    per_step = 7 * n + 1  # a step's projections and its head
    want_routes = {"wgmma": 2 * 7 * n, "splitk": 2}  # the two prefills
    for k in k_effs:
        want_routes["splitk"] += (k + 1) * per_step if k else 0  # draft
        want_routes[kernel.mpmm_route(LM_BATCH * (k + 1), 1, 1)] += per_step
    want_launches = {"mpmm_cuda": sum(want_routes.values()),
                     "conv_mpmm_cuda": 0, "flash_fwd_cuda": 0,
                     "flash_fwd_packed_cuda": 2 * n}
    log(f"[spec] k={SPEC_K}: {len(cycles)} cycles (k_eff {k_effs}), "
        f"drafted {sg.drafted_tokens}, accepted {sg.accepted_tokens}; "
        f"launches {launches}; K1 routes {routes}; tokens[0] "
        f"{got[0].tolist()}")
    if launches != want_launches or routes != want_routes:
        raise SystemExit(f"spec: launches {launches} / routes {routes} != "
                         f"{want_launches} / {want_routes}")
    if not np.array_equal(got, want):
        raise SystemExit(f"spec: tokens differ from the verify-only "
                         f"Generator's:\n{got}\n{want}")
    if phase8_tokens is not None and not np.array_equal(got, phase8_tokens):
        raise SystemExit("spec: tokens differ from phase 8's Generator on "
                         "the same weight draw")
    with t.inference_mode():
        _, pre = gen.prefill(t.as_tensor(prompts, device=sm.device))
        cache = gen._grow_cache(pre, LM_BATCH, LM_PROMPT, LM_PROMPT + LM_NEW)
        del pre
        fresh = clone_tree(cache)
        seq_cache = clone_tree(cache)
        feed = t.as_tensor(got[:, :SPEC_K + 1], device=sm.device)
        bat, cache = sg.api_verify.decode_steps(gen.params, cache, feed,
                                                LM_PROMPT)
        seq = t.stack([gen.decode(seq_cache, feed[:, i:i + 1],
                                  LM_PROMPT + i)[0]
                       for i in range(SPEC_K + 1)], dim=1)
        same_cache = all(t.equal(a, b) for a, b in zip(
            tree_leaves(cache), tree_leaves(seq_cache)))
        if not t.equal(bat, seq) or not same_cache:
            err = float((bat.float() - seq.float()).abs().max())
            raise SystemExit(f"spec: a verify's logits (max diff {err}) or "
                             f"cache (equal {same_cache}) differ from "
                             f"{SPEC_K + 1} sequential decode steps")
        del seq_cache, seq
        reset_counts()
        flash, _ = sg.api_verify.decode_steps(gen.params, fresh, feed,
                                              LM_PROMPT, attn_impl="flash")
        t.cuda.synchronize()
        k4 = read_counts()["flash_fwd_packed_cuda"]
        del fresh
        rel = float((flash.float() - bat.float()).abs().max()
                    / bat.float().abs().max())
        fmt_k, fmt_v = T.kv_formats(cfg, api.policy)[1][0]
        ck, cv = cache[0]["k"], cache[0]["v"]
        g = t.Generator(device=sm.device).manual_seed(SEED + 10)
        q = t.randn((LM_BATCH, SPEC_K + 1, ATTN_HEADS, ATTN_D), generator=g,
                    device=sm.device).to(t.bfloat16)
        run = lambda impl: fops.flash_attention_packed(  # noqa: E731
            q, ck, cv, fmt_k, fmt_v, q_offset=LM_PROMPT, impl=impl)
        k4_out, k4_plain = run("cuda"), run("torch")
        per_query = t.cat([attn.decode_attention_streamed(
            q[:, i:i + 1], ck, cv, fmt_k, fmt_v, LM_PROMPT + 1 + i)
            for i in range(SPEC_K + 1)], dim=1)
        t.cuda.synchronize()
    err = compare_close(sm, "flash_fwd_packed_cuda",
                        "flash verify K4 vs plain", k4_out, k4_plain)
    err_q = compare_close(sm, "flash_fwd_packed_cuda",
                          "flash verify K4 vs per-query route", k4_out,
                          per_query, tol=K4_VS_K3_TOL)
    log(f"[spec] verify bitwise equal to {SPEC_K + 1} decode steps; flash "
        f"verify: K4 launched {k4} times ({n} layers), attention vs plain "
        f"{err}, vs the per-query route {err_q} (tol {K4_VS_K3_TOL}), "
        f"logits {rel:.5f} of the largest apart through {n} layers (not "
        f"held: the routes round differently and 8-bit requantization "
        f"carries it on)")
    if k4 != n:
        sm.failures.append(f"flash verify launched K4 {k4} times, not {n}")
    sm.check_phase("speculative decoding (verify-only tokens, launches, "
                   "verify vs sequential decode, flash verify)")
    res = {"spec_s": spec_s, "verify_s": verify_s, "cycles": len(cycles),
           "cycle_ms": [e[5] * 1e3 for e in cycles],
           "accept_rate": sg.accept_rate, "launches": launches,
           "routes": routes}
    return sg, prompts, res


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def run_scheduler(sm, g, trace, alone, label):
    """``GenerateScheduler`` with SCHED_SLOTS slots over ``g`` (a
    ``Generator`` or a ``SpeculativeGenerator``) on ``trace`` [(prompt,
    n_new)], the injected clock read once a step; each ticket against its
    request served alone (``alone``) -> (bad ticket ids, wall, stats)."""
    import numpy as np
    from repro_torch.runtime.scheduler import GenerateScheduler
    max_len = max(len(p) + n_new for p, n_new in trace)
    clock = StepClock()
    s = GenerateScheduler(g, slots=SCHED_SLOTS, max_len=max_len, clock=clock)
    t0 = time.perf_counter()
    tickets = []
    for req in trace:
        clock.tick()
        tickets.append(s.submit(*req))
        clock.tick()
        s.step()
    for _ in range(1000):
        if not s.pending and not s.active:
            break
        clock.tick()
        s.step(flush=True)
    wall = time.perf_counter() - t0
    st = s.stats()
    bad = [tk.id for tk, want in zip(tickets, alone)
           if not tk.done or not np.array_equal(tk.result, want)]
    log(f"[sched] GenerateScheduler over the {label}: {len(trace)} requests "
        f"{[(len(p), n) for p, n in trace]} (prompt, n_new), {SCHED_SLOTS} "
        f"slots, {wall:.2f} s; events {[(e[1], e[2]) for e in s.events]}; "
        f"p50 {st['p50_latency_s'] * 1e3:.1f} ms, p99 "
        f"{st['p99_latency_s'] * 1e3:.1f} ms; tickets unlike served alone: "
        f"{bad or 'none'}")
    if bad:
        sm.failures.append(f"GenerateScheduler over the {label}: tickets "
                           f"{bad} differ from their requests served alone")
    return bad, wall, st


def sched_trace(vocab):
    """SCHED_TRACE's requests, prompts drawn from SEED + 2."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    return [(rng.integers(0, vocab, plen), n_new)
            for plen, n_new in SCHED_TRACE]


def phase_lm_schedulers(sm, sg):
    """(c) ``GenerateScheduler`` with SCHED_SLOTS slots over SCHED_TRACE
    (two prompt lengths, three n_new), over the verify view's
    ``Generator`` and then over the ``SpeculativeGenerator``: every
    ticket's tokens must equal the same request served alone by the
    ``Generator``."""
    gen = sg.gen_verify
    trace = sched_trace(gen.api.cfg.vocab)
    alone = [gen.generate(p[None], n_new)[0] for p, n_new in trace]
    out = {}
    for label, g in (("generator", gen), ("speculative", sg)):
        _, wall, st = run_scheduler(sm, g, trace, alone, label)
        out[label] = {"wall": wall, "stats": st}
    sm.check_phase("GenerateScheduler tickets vs requests served alone")
    return out


def phase_image_scheduler(sm, server, cfg):
    """(d) ``ImageScheduler`` over the ResNet-18 ``ImageServer`` (buckets
    1/2/4/8) on single images arriving in bursts (IMG_BURSTS, 13 in all):
    every ticket's logits must be bitwise the image's served alone."""
    import numpy as np
    from repro_torch.runtime.scheduler import ImageScheduler
    rng = np.random.default_rng(SEED + 3)
    images = rng.normal(0, 1, (sum(IMG_BURSTS), cfg.img_size, cfg.img_size,
                               3)).astype(np.float32)
    clock = StepClock()
    s = ImageScheduler(server, max_wait_s=0.005, clock=clock)
    tickets, i = [], 0
    for burst in IMG_BURSTS:  # a full bucket goes at once, the rest waits
        tickets += [s.submit(im) for im in images[i:i + burst]]
        i += burst
        s.step()
        clock.advance(0.01)
        s.step()
    s.drain()
    bad = [tk.id for tk, im in zip(tickets, images)
           if not tk.done or not np.array_equal(tk.result,
                                                server.predict(im[None])[0])]
    log(f"[sched] ImageScheduler: {len(images)} images in batches "
        f"{list(s.dispatched_batches)}; tickets unlike served alone: "
        f"{bad or 'none'}")
    if bad:
        sm.failures.append(f"ImageScheduler tickets {bad} differ from their "
                           f"images served alone")
    sm.check_phase("ImageScheduler tickets vs images served alone")
    return list(s.dispatched_batches)


def phase_cli(sm):
    """(e) ``repro_torch.launch.serve.main`` in process, for ResNet-18 and
    for granite-8b with speculative decoding, at full width, each with a
    trace and a metrics dump that must pass the port's validators."""
    import json
    import tempfile
    from repro_torch.launch import serve as launch
    from repro_torch.runtime import telemetry as tele
    runs = {
        "resnet18": ["--arch", "resnet18", "--plan", str(PLAN), "--batch",
                     "8"],
        "granite-8b": ["--arch", "granite-8b", "--plan", str(LM_PLAN),
                       "--spec-decode", str(SPEC_K), "--draft-plan",
                       str(DRAFT_PLAN), "--batch", str(LM_BATCH),
                       "--prompt-len", "128", "--new-tokens", "8"],
    }
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        for arch, argv in runs.items():
            trace, prom = Path(d) / f"{arch}.json", Path(d) / f"{arch}.prom"
            t0 = time.perf_counter()
            rc = launch.main(argv + ["--trace", str(trace),
                                     "--metrics-dump", str(prom)])
            sm.torch.cuda.empty_cache()
            problems = (tele.validate_chrome_trace(json.loads(
                trace.read_text())) + tele.validate_metrics_text(
                    prom.read_text()))
            log(f"[cli] launch.serve {arch}: rc {rc} in "
                f"{time.perf_counter() - t0:.2f} s; trace and metrics "
                f"problems: {problems or 'none'}")
            if rc != 0 or problems:
                sm.failures.append(f"launch.serve {arch}: rc {rc}, "
                                   f"{problems}")
    sm.check_phase("launch.serve on the card")


# --- phase 11: design-space exploration, fp baseline, frontier and SLO ------


def resnet_layer_shapes(cfg):
    """Every conv of a basic-block ResNet in serve order: (name, input
    size, C in, C out, kernel, stride, layer class), the stem first."""
    from repro_torch.models import resnet as R
    out = [("stem", cfg.img_size, 3, cfg.width, 7, 2, "boundary")]
    h = cfg.img_size // 4
    for si, bi, cin, cmid, stride in R._block_channels(cfg):
        key = f"s{si}b{bi}"
        if stride != 1 or cin != cmid:
            out.append((key + "p", h, cin, cmid, 1, stride, "inner"))
        out.append((key + "c1", h, cin, cmid, 3, stride, "inner"))
        h = -(-h // stride)
        out.append((key + "c2", h, cmid, cmid, 3, 1, "inner"))
    return out


def resnet_launches(cfg, plan, batch):
    """One quantized ResNet forward at ``batch``: its K1/K2 launches, K1's
    routes and each conv's dataflow, from the layers' own choices -- the
    plan's per-layer entry, else the H100 cost model
    (``nn.quantized.conv_serve_dataflow``), gated by K2's feasibility, as
    ``qconv_serve_apply`` resolves them -- and K1's route rule."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.packing import PlaneFormat
    from repro_torch.kernels.mpmm import kernel, ops
    from repro_torch.nn import quantized as Q
    k2, routes, flows = 0, dict.fromkeys(kernel.ROUTES, 0), {}
    for name, h, cin, cout, kk, s, cls in resnet_layer_shapes(cfg):
        pol = plan_lib.resolve_policy(plan, name)
        flow = plan_lib.resolve_dataflow(plan, name)
        if flow == "auto":
            flow = Q.conv_serve_dataflow((batch, h, h, cin), pol, k=kk,
                                         stride=s, padding="SAME",
                                         layer_class=cls, n_out=cout)
        elif not ops.conv_implicit_feasible(cin, PlaneFormat(
                pol.bits_for(cls), pol.k, kk * kk * cin)):
            flow = "im2col"
        flows[name] = flow
        ho = -(-h // s)
        if flow == "implicit":
            k2 += 1
        else:
            routes[kernel.mpmm_route(batch * ho * ho, kk * kk * cin,
                                     cout)] += 1
    routes[kernel.mpmm_route(batch, cfg.fc_in, cfg.n_classes)] += 1
    return ({"mpmm_cuda": sum(routes.values()), "conv_mpmm_cuda": k2},
            routes, flows)


def bucket_calls(server, n):
    """The bucket sizes ``ImageServer.predict`` runs for ``n`` images."""
    out, i = [], 0
    while i < n:
        b = server._bucket_for(n - i)
        out.append(b)
        i += min(n - i, b)
    return out


def read_p11():
    """The launch counts and K1's routes (``route:<name>``) since the last
    ``reset_counts``."""
    from repro_torch.kernels.mpmm import kernel
    counts = read_counts()
    counts.update({f"route:{k}": v
                   for k, v in kernel.mpmm_cuda.routes.items()})
    return counts


def runs(seq):
    """[1, 2, 2, 2, 0] -> '1, 2x3, 0'."""
    out = []
    for v in seq:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return ", ".join(f"{v}x{n}" if n > 1 else f"{v}" for v, n in out)


def add_counts(total, counts):
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def logits_contract(sm, label, cfg, plan, server, plain, x):
    """Phase 4's contract for one batch: the kernel path's logits within
    E2E_LOGIT_TOL of the largest plain |logit|, at most E2E_MAX_FLIP_RATE
    of the classifier-input codes flipped."""
    import numpy as np
    from repro_torch.kernels.mpmm import ops
    from repro_torch.models import resnet as R
    t = sm.torch
    y, ref_y = server.predict(x), plain.predict(x)
    tol = E2E_LOGIT_TOL * float(np.abs(ref_y).max())
    err = float(np.abs(y - ref_y).max())
    xt = t.from_numpy(x).to(sm.device)
    f_k = R.serve_features(cfg, server.params, xt, plan)
    f_p = R.serve_features(cfg, server.params, xt, plan, impl="torch")
    ga = server.params["fc"]["ga"]
    flips = float((ops.quantize_activations(f_k, ga)
                   != ops.quantize_activations(f_p, ga)).float().mean())
    ok = (np.isfinite(y).all() and float(y.std()) > 0 and err <= tol
          and flips <= E2E_MAX_FLIP_RATE)
    log(f"[p11] {label}: max |kernel - plain| {err} (tol {tol}), flipped "
        f"fc-input codes {flips}")
    if not ok:
        sm.failures.append(f"{label}: outside the end-to-end contract")
    return y


def spearman(a, b):
    """Rank correlation of two equal-length sequences (average ranks)."""
    import numpy as np

    def ranks(v):
        v = np.asarray(v, np.float64)
        order = np.argsort(v, kind="stable")
        r = np.empty(len(v))
        r[order] = np.arange(len(v), dtype=np.float64)
        for val in np.unique(v):
            idx = v == val
            r[idx] = r[idx].mean()
        return r
    ra, rb = ranks(a), ranks(b)
    ra, rb = ra - ra.mean(), rb - rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


def device_smem(torch):
    """(SMs, shared memory a block may opt into, shared memory an SM) of
    card 0, from torch's device properties or else the CUDA runtime."""
    props = torch.cuda.get_device_properties(0)
    block = getattr(props, "shared_memory_per_block_optin", None)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", None)
    if block is None or per_sm is None:
        import ctypes
        rt = ctypes.CDLL("libcudart.so")
        v = ctypes.c_int()
        vals = []
        for attr in (97, 81):  # MaxSharedMemoryPerBlockOptin, ...PerSM
            if rt.cudaDeviceGetAttribute(ctypes.byref(v), attr, 0) != 0:
                raise SystemExit("cudaDeviceGetAttribute failed")
            vals.append(v.value)
        block, per_sm = vals
    return props.multi_processor_count, int(block), int(per_sm)


def fp64_forward(t, cfg, packed, x):
    """The fp baseline's network in float64 on the same (bf16) weights,
    with ``F.conv2d`` on XLA-SAME-padded inputs: the reference of phase
    11 (b)."""
    import torch.nn.functional as F
    from repro_torch.kernels.mpmm import ref
    from repro_torch.models import resnet as R
    f64 = t.float64

    def conv(p, x, k, stride, bn, relu, res=None):
        xp = ref.pad_spatial(x, k, k, stride, "SAME", fill=0.0)
        w = p["w"].to(f64).reshape(k, k, x.shape[-1], -1).permute(3, 2, 0, 1)
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=stride)
        y = y.permute(0, 2, 3, 1)
        y = y * bn[0].to(f64).reshape(-1) + bn[1].to(f64).reshape(-1)
        if res is not None:
            y = y + res
        return y.clamp_min(0.0) if relu else y

    h = conv(packed["stem"], x.to(f64), 7, 2, packed["bn_stem"], True)
    h = R.max_pool_same(h)
    for si, bi, cin, cmid, stride in R._block_channels(cfg):
        p = packed[f"s{si}b{bi}"]
        sc = (conv(p["proj"], h, 1, stride, p["bn_proj"], False)
              if "proj" in p else h)
        m = conv(p["conv1"], h, 3, stride, p["bn1"], True)
        h = conv(p["conv2"], m, 3, 1, p["bn2"], True, res=sc)
    return h.mean(dim=(1, 2)) @ packed["fc"]["w"].to(f64)


class SpikeClock:
    """The SLO scheduler's clock on the card: the host clock plus the
    latency spikes the fault injector adds (``advance``)."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self):
        return time.perf_counter() + self.offset

    def advance(self, dt):
        self.offset += dt


def p11_dse(sm, api, params, state, images):
    """(a) ``plan_search`` at full ResNet-18 width under the H100 cost
    model, fed by ``weight_ptq_sensitivity`` of the random weights and by
    ``calibration_sensitivity`` of ``images`` through the card (the fp
    reference through the fp baseline, each probe through K1/K2); the
    H100 entry beside the card's own properties."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.core import planner
    from repro_torch.core.plan import (LayerPlan, PrecisionPlan,
                                       plan_footprint_report)
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.roofline import H100
    from repro_torch.models import resnet as R
    t = sm.torch
    cfg = api.cfg
    sms, smem_block, smem_sm = device_smem(t)
    log(f"[p11] H100 entry: {H100.sm_count} SMs, {H100.smem_per_block:.0f} B "
        f"shared memory a block, {H100.smem_bytes:.0f} B an SM, "
        f"{H100.peak_ops_int8 / 1e12:.0f} TOP/s int8, "
        f"{H100.hbm_bw / 1e12:.2f} TB/s; the card: {sms} SMs, {smem_block} "
        f"B a block (opt-in), {smem_sm} B an SM")
    if (sms, smem_block, smem_sm) != (H100.sm_count, H100.smem_per_block,
                                     H100.smem_bytes):
        sm.failures.append("the H100 entry disagrees with the card")
    inner = R.inner_layer_names(cfg)
    t0 = time.perf_counter()
    weights = R.layer_weights(cfg, params)
    w_sens = planner.weight_ptq_sensitivity({n: weights[n] for n in inner})
    t_w = time.perf_counter() - t0

    x = t.from_numpy(images).to(sm.device)
    trees = {}
    inv = {sfx: key for key, sfx in R._PLAN_SUFFIX.items()}

    def tree_of(pol):
        key = (pol.inner_bits, pol.k, pol.quantize)
        if key not in trees:
            trees[key] = R.pack_for_serve(cfg, params, state, pol)
        return trees[key]

    def cached(plan):
        """The plan's serve tree from uniform trees packed once: the base
        tree with each named layer's conv taken from the tree of its
        format."""
        if not plan.quantize:
            return tree_of(PrecisionPolicy(quantize=False))
        d = plan.default
        tree = dict(tree_of(PrecisionPolicy(inner_bits=d.w_bits, k=d.k)))
        for name, lp in plan.layers:
            sfx = next(s for s in inv if name.endswith(s))
            blk = name[:-len(sfx)]
            src = tree_of(PrecisionPolicy(inner_bits=lp.w_bits, k=lp.k))
            tree[blk] = dict(tree[blk])
            tree[blk][inv[sfx]] = src[blk][inv[sfx]]
        return tree

    calls = []

    def forward(plan):
        calls.append(plan.name)
        with t.inference_mode():
            y = R.serve_forward(cfg, cached(plan), x, plan)
        return y.float().cpu().numpy()

    reset_counts()
    t0 = time.perf_counter()
    c_sens = planner.calibration_sensitivity(forward, inner)
    t.cuda.synchronize()
    t_c = time.perf_counter() - t0
    counts = read_p11()
    probe = dc.replace(PrecisionPlan.uniform(PrecisionPolicy(inner_bits=8,
                                                             k=4)),
                       layers=(("s1b1c2", LayerPlan(2, 2)),))
    with t.inference_mode():
        fresh = R.serve_forward(cfg, R.pack_for_serve(cfg, params, state,
                                                      probe), x, probe)
        same = t.equal(fresh, R.serve_forward(cfg, cached(probe), x, probe))
    log(f"[p11] sensitivities: weight PTQ in {t_w:.2f} s; calibration on "
        f"{len(images)} images through the card in {t_c:.2f} s, "
        f"{len(calls)} forwards (fp reference through the fp baseline, "
        f"{len(trees)} uniform trees packed once), launches {counts}; the "
        f"cached probe tree's logits bitwise a fresh pack_for_serve's: "
        f"{same}")
    if not same:
        sm.failures.append("calibration: the cached probe tree's logits "
                           "differ from a fresh pack_for_serve's")
    if not counts["mpmm_cuda"] or not counts["conv_mpmm_cuda"]:
        sm.failures.append(f"calibration probes launched {counts}")
    gemms = api.gemm_workload(P11_BATCH)
    lp = R.layer_param_counts(cfg)
    mixed = PrecisionPlan.load(PLAN)
    budget = plan_footprint_report(lp, R.layer_classes(cfg),
                                   mixed)["quant_bytes"]
    results = {}
    for label, sens in (("weight PTQ", w_sens), ("calibration", c_sens)):
        res = planner.plan_search(gemms, sens, layer_params=lp,
                                  budget_bytes=budget)
        results[label] = res
        log(f"[p11] plan_search ({label} sensitivities, batch "
            f"{P11_BATCH}, H100 latencies, footprint budget {budget:.0f} B "
            f"= resnet18_mixed.json's): {len(res.points)} points, "
            f"{len(res.frontier)} on the frontier")
        for r in res.frontier_rows():
            log(f"[p11]   {r['name']:<14} error {r['error']:.6g} latency "
                f"{r['latency_s'] * 1e6:.3f} us ({r['fps']:.1f} /s) "
                f"footprint {r['footprint_bytes']:.0f} B w_bits "
                f"{r['distinct_wbits']}")
        ch = res.chosen
        log(f"[p11]   chosen {ch.name}: bits "
            f"{dict(ch.bits)}; latency {ch.latency_s * 1e6:.3f} us, "
            f"footprint {ch.footprint_bytes:.0f} B")
        lats = [p.latency_s for p in res.frontier]
        if lats != sorted(lats) or ch not in res.frontier:
            sm.failures.append(f"plan_search ({label}): frontier not "
                               f"sorted or the choice is off it")
    chosen = results["calibration"].chosen.plan
    with t.inference_mode():
        y = R.serve_forward(cfg, R.pack_for_serve(cfg, params, state,
                                                  chosen), x, chosen)
    ok = bool(t.isfinite(y.float()).all())
    log(f"[p11] the chosen plan packs and serves: logits {tuple(y.shape)}, "
        f"finite {ok}")
    if not ok:
        sm.failures.append("the chosen plan's logits are not finite")
    sm.check_phase("11 (a) plan_search at full width, H100 entry")
    return counts, tree_of(PrecisionPolicy(quantize=False))


def p11_fp_baseline(sm, api, packed_fp, mixed_server, images):
    """(b) The fp baseline through ``ImageServer`` at buckets 1 and 8,
    against a float64 run of the same bf16 weights; its packed bytes
    against the mixed plan's."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.core.plan import PrecisionPlan, plan_footprint_report
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.launch.serve import _tree_bytes
    from repro_torch.models import resnet as R
    from repro_torch.runtime.serve import ImageServer
    t = sm.torch
    cfg = api.cfg
    fp = PrecisionPolicy(quantize=False)
    server = ImageServer(api=dc.replace(api, policy=fp), params=packed_fp,
                         batch_buckets=(1, P11_BATCH), device=sm.device)
    reset_counts()
    y8 = server.predict(images)
    y1 = server.predict(images[:1])
    counts = read_p11()
    with t.inference_mode():
        ref = fp64_forward(t, cfg, server.params,
                           t.from_numpy(images).to(sm.device)).cpu().numpy()
    tol = FP_LOGIT_TOL * float(np.abs(ref).max())
    err8 = float(np.abs(y8 - ref).max())
    err1 = float(np.abs(y1 - ref[:1]).max())
    top = float(np.mean(np.argmax(y8, -1) == np.argmax(ref, -1)))
    lp, cls = R.layer_param_counts(cfg), R.layer_classes(cfg)
    rep_fp = plan_footprint_report(lp, cls, fp)
    rep_mx = plan_footprint_report(lp, cls, PrecisionPlan.load(PLAN))
    b_fp, b_mx = _tree_bytes(server.params), _tree_bytes(mixed_server.params)
    fps = {}
    for b in (1, P11_BATCH):
        x = images[:b]
        server.predict(x)
        t0 = time.perf_counter()
        for _ in range(10):
            server.predict(x)
        fps[b] = 10 * b / (time.perf_counter() - t0)
    log(f"[p11] fp baseline (bf16 weights, bf16 products, every conv "
        f"through im2col): logits at bucket 8 and 1 within {err8} and "
        f"{err1} of a float64 run of the same bf16 weights (tol {tol} = "
        f"{FP_LOGIT_TOL} of the largest |logit|), top-1 agreement {top}; "
        f"launches {counts} (no kernel of ours); frames/s bucket 1 "
        f"{fps[1]:.1f}, bucket 8 {fps[P11_BATCH]:.1f}")
    log(f"[p11] footprint (plan_footprint_report): fp baseline "
        f"{rep_fp['quant_bytes']:.0f} B (32 bits a weight), "
        f"resnet18_mixed.json {rep_mx['quant_bytes']:.0f} B, compression "
        f"{rep_mx['compression']:.3f}x; served trees on the card: fp "
        f"{b_fp} B (bf16), mixed {b_mx} B, {b_fp / b_mx:.3f}x")
    if max(err8, err1) > tol or not np.isfinite(y8).all():
        sm.failures.append(f"fp baseline: {max(err8, err1)} > {tol}")
    if counts["mpmm_cuda"] or counts["conv_mpmm_cuda"]:
        sm.failures.append(f"fp baseline launched {counts}")
    sm.check_phase("11 (b) the fp baseline")
    return fps


def p11_roofline(sm, api, server, plan, images, rows, card):
    """(c) ``layer_attribution`` of a measured batch-8 forward under the
    mixed plan; the cost model's per-conv time beside phase 5's measured
    K2 (and K1) times."""
    from repro_torch.core import dse
    from repro_torch.core.packing import PlaneFormat
    from repro_torch.models import resnet as R
    from repro_torch.runtime.telemetry import layer_attribution
    t = sm.torch
    cfg = api.cfg
    x = t.from_numpy(images).to(sm.device)
    fwd = lambda: R.serve_forward(cfg, server.params, x, plan)  # noqa: E731
    with t.inference_mode():
        ms = sm.time_ms(fwd)
        ms_graph = sm.graph_ms(fwd)
    gemms = api.gemm_workload(P11_BATCH)
    rep = layer_attribution(gemms, plan, ms / 1e3)
    rep_g = layer_attribution(gemms, plan, ms_graph / 1e3)
    log(f"[p11] roofline: batch-{P11_BATCH} forward under {plan.name}: "
        f"measured {ms:.4f} ms (CUDA events, 20 forwards back to back), "
        f"roofline {rep['roofline_s'] * 1e3:.4f} ms, roofline_fraction "
        f"{rep['roofline_fraction']:.4f}, achieved "
        f"{rep['achieved_tops']:.3f} TOps/s against "
        f"{rep['roofline_tops']:.1f} at the roofline and "
        f"{rep['peak_int8_tops']:.0f} peak  ({card})")
    log(f"[p11] roofline, device time alone: the same forward replayed in a "
        f"CUDA graph takes {ms_graph:.4f} ms: roofline_fraction "
        f"{rep_g['roofline_fraction']:.4f}, achieved "
        f"{rep_g['achieved_tops']:.3f} TOps/s  ({card})")
    pred, meas, names = [], [], []
    shapes = {s[0]: s for s in resnet_layer_shapes(cfg)}
    for r in rows:
        if r.get("batch", TIME_BATCH) != TIME_BATCH:
            continue
        name = r["layer"]
        if r["kernel"] == "conv_mpmm_cuda":
            _, h, cin, cout, kk, s, cls = shapes[name]
            pol = plan.policy_for(name)
            conv = dse.ConvShape(P11_BATCH, h, h, cin, cout, kk, kk, s)
            p = dse.choose_conv_dataflow(conv, w_bits=pol.bits_for(cls),
                                         k=pol.k).time_implicit_s
        elif r["kernel"] == "mpmm_cuda":
            g = next(g for g in gemms if g.name == name)
            pol = plan.policy_for(name)
            w, k = pol.bits_for(g.layer_class), pol.k
            tile = dse.autotune_tile(g.m, g.k, g.n, w_bits=w, k=k)
            p = max(dse.gemm_time(g, tile, PlaneFormat(w, k, g.k)))
        else:
            continue
        names.append(f"{r['kernel']}:{name}")
        pred.append(p * 1e3)
        meas.append(r["ms"])
        log(f"[p11]   {r['kernel']:<15} {name:<7} model {p * 1e3:.5f} ms, "
            f"measured {r['ms']:.5f} ms ({r['ms'] / (p * 1e3):.2f}x)")
    k2 = [i for i, n in enumerate(names) if n.startswith("conv")]
    rho = spearman(pred, meas)
    rho_k2 = spearman([pred[i] for i in k2], [meas[i] for i in k2])
    log(f"[p11] model vs measured: rank correlation {rho:.4f} over "
        f"{len(names)} calls (K2 alone {rho_k2:.4f} over {len(k2)}); sum "
        f"model {sum(pred):.4f} ms, measured {sum(meas):.4f} ms")
    if not 0 < rep["roofline_fraction"] < 1:
        sm.failures.append(f"roofline_fraction {rep['roofline_fraction']}")
    sm.check_phase("11 (c) roofline attribution")
    return {"ms": ms, "ms_graph": ms_graph, "rep": rep, "rho": rho,
            "rho_k2": rho_k2}


def p11_frontier(sm, api, params, state):
    """(d) ``examples/frontiers/resnet18_frontier.json`` through
    ``frontier_from_manifest`` on the card: every level held to phase 4's
    contract against its plain path, its launches against the layers' own
    choices, its frames/s at bucket 8 against the manifest's
    ``rel_latency``."""
    import numpy as np
    from repro_torch.core.plan import FrontierManifest
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.runtime.frontier import frontier_from_manifest
    from repro_torch.runtime.serve import ImageServer
    cfg = api.cfg
    manifest = FrontierManifest.load(FRONTIER)
    t0 = time.perf_counter()
    fr = frontier_from_manifest(api, params, manifest, state=state,
                                batch_buckets=BUCKETS, device=sm.device)
    sm.torch.cuda.synchronize()
    log(f"[p11] frontier {manifest.name}: {' -> '.join(fr.names)} packed "
        f"from one weight draw in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 11)
    x = rng.normal(0, 1, (P11_BATCH, cfg.img_size, cfg.img_size,
                          3)).astype(np.float32)
    total, times = {}, []
    for lvl, entry in enumerate(manifest.points):
        srv = fr.server(lvl).server
        plain = ImageServer(api=srv.api, params=srv.params, plan=srv.plan,
                            batch_buckets=BUCKETS, device=sm.device,
                            impl="torch")
        plan = srv.plan if srv.plan is not None else srv.api.policy
        reset_counts()
        fr.serve(list(x), level=lvl)
        sm.torch.cuda.synchronize()
        counts = read_p11()
        want, routes, flows = resnet_launches(cfg, plan, P11_BATCH)
        got = {k: counts[k] for k in want}
        if got != want or dict(kernel.mpmm_cuda.routes) != routes:
            sm.failures.append(f"frontier level {lvl}: launches {got} != "
                               f"{want} (routes {routes})")
        total = add_counts(total, counts)
        logits_contract(sm, f"frontier level {lvl} ({entry.name})", cfg,
                        plan, srv, plain, x)
        for _ in range(2):
            fr.serve(list(x), level=lvl)
        t0 = time.perf_counter()
        for _ in range(10):
            fr.serve(list(x), level=lvl)  # host numpy: synchronised
        times.append((time.perf_counter() - t0) / 10)
        log(f"[p11] frontier level {lvl} {entry.name}: launches {got}, K1 "
            f"routes {routes}, implicit convs "
            f"{sum(f == 'implicit' for f in flows.values())}/{len(flows)}")
    for lvl, entry in enumerate(manifest.points):
        log(f"[p11] frontier level {lvl} {entry.name}: "
            f"{P11_BATCH / times[lvl]:.1f} frames/s at bucket {P11_BATCH} "
            f"({times[lvl] * 1e3:.3f} ms a batch), measured rel_latency "
            f"{times[lvl] / times[0]:.4f} against the manifest's "
            f"{entry.rel_latency}")
    sm.check_phase("11 (d) the frontier's levels")
    return fr, times, total


def p11_slo(sm, fr, times, cfg):
    """(e) ``SLOScheduler`` over the frontier on the card, with seeded
    faults: a burst that degrades, a trickle that recovers; every ticket
    terminal, every served one bitwise its image served alone at its
    level.  The deadline is set from the measured level-0 batch time."""
    import numpy as np
    from repro_torch.runtime.faults import FaultInjector, FaultSpec
    from repro_torch.runtime.slo import HysteresisConfig, SLOScheduler
    t0_batch = times[0]
    slo_s = SLO_BATCHES * t0_batch
    clock = SpikeClock()
    inj = FaultInjector(FaultSpec(
        step_error_rate=0.3, latency_spike_rate=0.2,
        latency_spike_s=t0_batch, malformed_rate=0.15), SLO_SEED)
    faulty = inj.wrap_frontier(fr, advance=clock.advance)
    s = SLOScheduler(faulty, slo_s=slo_s, clock=clock,
                     est_serve_s=list(times), max_retries=4, backoff_s=1e-3,
                     hysteresis=HysteresisConfig(up_after=1, down_after=2))
    rng = np.random.default_rng(SEED + 12)
    imgs = rng.normal(0, 1, (SLO_BURST + 24, cfg.img_size, cfg.img_size,
                             3)).astype(np.float32)
    tickets, refused, levels = [], 0, []
    reset_counts()
    t_start = time.perf_counter()
    for im in imgs[:SLO_BURST]:
        p, bad = inj.maybe_malform(im)
        try:
            tickets.append((im, s.submit(p)))
        except ValueError:
            refused += 1
    for _ in range(100_000):
        if not s.pending:
            break
        s.step()
        levels.append(s.level)
    for im in imgs[SLO_BURST:]:
        tickets.append((im, s.submit(im)))
        s.drain()
        levels.append(s.level)
        if s.level == 0 and max(levels) > 0:
            break
    wall = time.perf_counter() - t_start
    counts = read_p11()
    st = s.stats()
    bad = []
    for im, tk in tickets:
        if not tk.done:
            bad.append(tk.id)
        elif tk.plan_point:
            lvl = fr.level_of(tk.plan_point)
            alone = fr.restricted(lvl).serve([im], level=0)[0]
            if not np.array_equal(tk.result, alone):
                bad.append(tk.id)
    outcomes = {}
    for _, tk in tickets:
        key = tk.plan_point or tk.outcome
        outcomes[key] = outcomes.get(key, 0) + 1
    log(f"[p11] SLOScheduler: slo {slo_s * 1e3:.3f} ms ({SLO_BATCHES} x the "
        f"level-0 batch time), burst {SLO_BURST} images then a trickle; "
        f"{len(tickets)} tickets in {wall:.2f} s, {refused} malformed "
        f"refused at submit; served by {outcomes}; level after each step "
        f"{runs(levels)}; transitions {list(s.controller.transitions)}; "
        f"faults "
        f"{dict(inj.counts)}; stats degraded {st['degraded']:.0f}, expired "
        f"{st['expired']:.0f}, retried {st['retried']:.0f}, failed "
        f"{st['failed']:.0f}, p50 {st['p50_latency_s'] * 1e3:.2f} ms, p99 "
        f"{st['p99_latency_s'] * 1e3:.2f} ms; launches {counts}; tickets "
        f"unlike served alone or not terminal: {bad or 'none'}")
    if bad or max(levels) == 0 or s.level != 0:
        sm.failures.append(f"SLO: bad tickets {bad}, levels {levels}")
    if not refused or refused != inj.counts["malformed"]:
        # the malformed rolls come first and are as many as the burst, so
        # the seed fixes them; the serve-side rolls follow the timing
        sm.failures.append(f"SLO: {refused} refused at submit, "
                           f"{inj.counts['malformed']} malformed rolled")
    sm.check_phase("11 (e) SLOScheduler under faults")
    return counts, st


def p11_cli(sm, slo_ms):
    """(f) ``launch.serve.main`` with ``--frontier``/``--slo-ms``, with
    ``--fp-baseline``, and with ``--plan --trace --metrics-dump``: exit
    codes, the roofline line, and ``python -m repro_torch.runtime.
    telemetry validate`` on the written files."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import serve as launch
    from repro_torch.runtime import telemetry as tele
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        trace, prom = Path(d) / "t.json", Path(d) / "m.prom"
        runs = {
            "frontier": ["--frontier", str(FRONTIER), "--slo-ms",
                         f"{slo_ms:.3f}"],
            "fp-baseline": ["--fp-baseline"],
            "plan": ["--plan", str(PLAN), "--trace", str(trace),
                     "--metrics-dump", str(prom)],
        }
        for label, extra in runs.items():
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = launch.main(["--arch", "resnet18", "--batch",
                                  str(P11_BATCH), *extra])
            sm.torch.cuda.empty_cache()
            out = buf.getvalue()
            for line in out.splitlines():
                log(f"[p11] cli {label}: {line}")
            roof = [ln for ln in out.splitlines() if "roofline:" in ln]
            log(f"[p11] cli {label}: rc {rc} in "
                f"{time.perf_counter() - t0:.2f} s")
            if rc != 0:
                sm.failures.append(f"launch.serve {label}: rc {rc}")
            if label != "frontier" and not (roof and "CUDA events" in roof[0]):
                sm.failures.append(f"launch.serve {label}: no roofline line "
                                   f"timed by CUDA events")
            if label == "frontier" and "drained back to level 0" not in out:
                sm.failures.append("launch.serve --frontier did not drain "
                                   "back to level 0")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tele._main(["validate", "--trace", str(trace), "--metrics",
                             str(prom)])
        log(f"[p11] telemetry validate: rc {rc}: "
            f"{buf.getvalue().strip()}")
        if rc != 0:
            sm.failures.append("telemetry validate failed")
    sm.check_phase("11 (f) launch.serve --frontier / --fp-baseline / "
                   "--plan, telemetry validate")


def p11_lm_frontier(sm):
    """(g) granite-8b at full width, first LM_FRONTIER_DEPTH layers, two
    points drawn once (``granite_8b_mixed.json``, ``granite_8b_draft_w2.
    json``) behind ``SLOScheduler`` through ``GenerateBackend``: K1 and K4
    launched as often as the generate calls made need, every served ticket
    bitwise its request served alone at its level."""
    import numpy as np
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.runtime.frontier import build_frontier
    from repro_torch.runtime.slo import HysteresisConfig, SLOScheduler
    t = sm.torch
    vplan, dplan = PrecisionPlan.load(LM_PLAN), PrecisionPlan.load(DRAFT_PLAN)
    api = lm_api(LM_FRONTIER_DEPTH, vplan)
    n, cfg = api.cfg.n_layers, api.cfg
    max_len = max(p + k for p, k in LM_FRONTIER_REQS)
    t0 = time.perf_counter()
    fr = build_frontier(api, None, [(vplan.name, vplan), (dplan.name, dplan)],
                        max_len=max_len, device=sm.device,
                        generator=t.Generator(device=sm.device).manual_seed(
                            SEED))
    t.cuda.synchronize()
    log(f"[p11] LM frontier: {cfg.name} depth {n}, {' -> '.join(fr.names)} "
        f"drawn once and packed in {time.perf_counter() - t0:.2f} s")
    calls = []
    for lvl in range(fr.n_levels):
        gen = fr.server(lvl).gen
        inner = gen.generate

        def counted(tokens, n_new, _inner=inner, **kw):
            calls.append((tokens.shape[0], n_new))
            return _inner(tokens, n_new, **kw)
        gen.generate = counted
    rng = np.random.default_rng(SEED + 13)
    reqs = [(rng.integers(0, cfg.vocab, plen).astype(np.int32), n_new)
            for plen, n_new in LM_FRONTIER_REQS]
    alone = {}
    for lvl in range(fr.n_levels):  # warm, and each request alone
        alone[lvl] = [fr.server(lvl).gen.generate(tk[None], k)[0]
                      for tk, k in reqs]
    t0 = time.perf_counter()
    fr.serve(reqs[:8], level=0)
    t_batch = time.perf_counter() - t0
    calls.clear()
    reset_counts()
    s = SLOScheduler(fr, slo_s=1.5 * t_batch, est_serve_s=t_batch,
                     hysteresis=HysteresisConfig(up_after=1))
    tickets = [(i, s.submit(r)) for i, r in enumerate(reqs)]
    s.drain()
    # then deadline-free requests one at a time: no pressure, so the
    # controller climbs back and the accurate point serves too
    for i in range(2 * len(reqs)):
        j = i % len(reqs)
        tickets.append((j, s.submit(reqs[j], slo_s=float("inf"))))
        s.drain()
        if tickets[-1][1].plan_point == fr.name(0):
            break
    t.cuda.synchronize()
    counts = read_p11()
    per_call = 7 * n + 1  # a step's projections and its head
    want_k1 = sum(per_call * k for _, k in calls)
    want_k4 = n * len(calls)
    bad = [tk.id for i, tk in tickets
           if tk.plan_point and not np.array_equal(
               tk.result, alone[fr.level_of(tk.plan_point)][i])]
    pts = {}
    for _, tk in tickets:
        key = tk.plan_point or tk.outcome
        pts[key] = pts.get(key, 0) + 1
    log(f"[p11] LM frontier behind SLOScheduler (slo {1.5 * t_batch:.3f} s "
        f"= 1.5 x a batch of 8): {len(reqs)} requests "
        f"{list(LM_FRONTIER_REQS)} (prompt, n_new), then one at a time "
        f"with no deadline; served by {pts}; levels' transitions "
        f"{list(s.controller.transitions)}; "
        f"generate calls (rows, n_new) {calls}; launches {counts}, "
        f"expected K1 {want_k1} and K4 {want_k4}; tickets unlike served "
        f"alone: {bad or 'none'}")
    if (counts["mpmm_cuda"], counts["flash_fwd_packed_cuda"]) != (want_k1,
                                                                  want_k4):
        sm.failures.append(f"LM frontier launches {counts} != K1 {want_k1}, "
                           f"K4 {want_k4}")
    if counts["flash_fwd_cuda"] or counts["conv_mpmm_cuda"]:
        sm.failures.append(f"LM frontier launched {counts}")
    if bad or not all(tk.done for _, tk in tickets) or not calls \
            or set(pts) != set(fr.names):
        sm.failures.append(f"LM frontier tickets {bad}, served by {pts}")
    sm.check_phase("11 (g) the LM frontier through GenerateBackend")
    del fr
    t.cuda.empty_cache()
    return counts


def p11_dataflow(sm, api, server, plan, card):
    """(h) The per-layer dataflow the H100 model picks, and frames/s at
    buckets 1 and 8 under ``auto`` and with ``implicit`` forced (runs in
    turns: auto, implicit, implicit, auto)."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.runtime.serve import ImageServer
    cfg = api.cfg
    for b in (1, P11_BATCH):
        _, routes, flows = resnet_launches(cfg, plan, b)
        log(f"[p11] dataflow auto at batch {b}: "
            + ", ".join(f"{k} {v}" for k, v in flows.items())
            + f"; K1 routes {routes}")
    forced = ImageServer(api=server.api, params=server.params,
                         plan=server.plan, batch_buckets=server.batch_buckets,
                         device=sm.device, dataflow="implicit")
    rng = np.random.default_rng(SEED + 14)
    x = rng.normal(0, 1, (P11_BATCH, cfg.img_size, cfg.img_size,
                          3)).astype(np.float32)
    res = {("auto", 1): [], ("auto", P11_BATCH): [],
           ("implicit", 1): [], ("implicit", P11_BATCH): []}
    for label, srv in (("auto", server), ("implicit", forced),
                       ("implicit", forced), ("auto", server)):
        for b in (1, P11_BATCH):
            xb = x[:b]
            srv.predict(xb)
            t0 = time.perf_counter()
            for _ in range(20):
                srv.predict(xb)
            res[(label, b)].append(20 * b / (time.perf_counter() - t0))
    same = np.array_equal(server.predict(x), forced.predict(x))
    from repro_torch.models import resnet as R
    dev = {}
    with sm.torch.inference_mode():
        for label in ("auto", "implicit", "implicit", "auto"):
            for b in (1, P11_BATCH):
                xb = sm.torch.from_numpy(x[:b]).to(sm.device)
                dev.setdefault((label, b), []).append(sm.graph_ms(
                    lambda: R.serve_forward(cfg, server.params, xb, plan,
                                            dataflow=label)))
    for b in (1, P11_BATCH):
        a, i = res[("auto", b)], res[("implicit", b)]
        da, di = dev[("auto", b)], dev[("implicit", b)]
        log(f"[p11] frames/s at bucket {b}: auto {a[0]:.1f} / {a[1]:.1f}, "
            f"implicit forced {i[0]:.1f} / {i[1]:.1f} (runs in turns); "
            f"auto/implicit {sum(a) / sum(i):.4f}; device time a forward "
            f"(CUDA graph): auto {da[0]:.4f} / {da[1]:.4f} ms, implicit "
            f"{di[0]:.4f} / {di[1]:.4f} ms  ({card})")
    log(f"[p11] auto and implicit logits bitwise equal: {same}")
    if not same:
        sm.failures.append("dataflow auto vs implicit: logits differ")
    sm.check_phase("11 (h) dataflow auto vs implicit")
    return res


def phase_p11(sm, server, rows, card):
    """Phase 11 at full ResNet-18 width (random weights from SEED): (a)-(h)
    above.  -> (launches of its main-path runs, results)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import resnet as R
    t = sm.torch
    t_start = time.perf_counter()
    api = configs.get(ARCH)
    cfg = api.cfg
    plan = PrecisionPlan.load(PLAN)
    gen = t.Generator(device=sm.device).manual_seed(SEED)
    params = api.init_params(gen, device=sm.device)
    state = R.init_bn_state(api.specs(), device=sm.device)
    images = np.random.default_rng(SEED + 10).normal(
        0, 1, (CALIB_IMAGES, cfg.img_size, cfg.img_size, 3)).astype(
            np.float32)
    launches = {}
    counts, packed_fp = p11_dse(sm, api, params, state, images)
    launches = add_counts(launches, counts)
    fps_fp = p11_fp_baseline(sm, api, packed_fp, server, images)
    del packed_fp
    roof = p11_roofline(sm, api, server, plan, images, rows, card)
    fr, times, counts = p11_frontier(sm, api, params, state)
    launches = add_counts(launches, counts)
    counts, slo_stats = p11_slo(sm, fr, times, cfg)
    launches = add_counts(launches, counts)
    del fr, params, state
    t.cuda.empty_cache()
    p11_cli(sm, SLO_BATCHES * times[0] * 1e3)
    launches = add_counts(launches, p11_lm_frontier(sm))
    flows = p11_dataflow(sm, api, server, plan, card)
    log(f"[p11] done in {time.perf_counter() - t_start:.1f} s; launches of "
        f"its runs {launches}")
    return launches, {"fps_fp": fps_fp, "roof": roof, "times": times,
                      "flows": flows, "slo": slo_stats}


KERNELS = (
    ("mpmm_cuda", "src/repro_torch/kernels/mpmm/csrc/mpmm_wgmma.cu",
     "src/repro/kernels/mpmm/kernel.py:164"),
    ("conv_mpmm_cuda", "src/repro_torch/kernels/mpmm/csrc/conv_mpmm.cu",
     "src/repro/kernels/mpmm/conv_kernel.py:140"),
    ("flash_fwd_cuda", "src/repro_torch/kernels/flashattn/csrc/flash_fwd.cu",
     "src/repro/kernels/flashattn/kernel.py:233"),
    ("flash_fwd_packed_cuda",
     "src/repro_torch/kernels/flashattn/csrc/flash_fwd_packed.cu",
     "src/repro/kernels/flashattn/kernel.py:178"),
)


# --- phase 12: the rest of the decoder family ------------------------------


P12_SHAPE = (4, 1000, 16)     # olmoe, deepseek: batch, prompt, new tokens
DENSE_SHAPE = (2, 512, 8)     # the four dense archs, their first layers
DENSE_DEPTH = 2
DENSE_ARCHS = ("granite-34b", "yi-34b", "chameleon-34b", "nemotron-4-340b")
KV4_ARCHS = ("granite-34b", "nemotron-4-340b")  # also under a kv4 cache
VERIFY_T = 4                  # decode_steps against sequential steps


def release(sm):
    """Free the card's memory of what the last run left: its objects may
    sit in reference cycles (a Generator and its step closures), which only
    the cycle collector frees."""
    import gc
    gc.collect()
    sm.torch.cuda.empty_cache()


def family_api(arch, plan=None, depth=None):
    """``arch`` at full width under ``plan`` (else its default policy),
    cut to its first ``depth`` layers (None: all)."""
    from repro_torch import configs
    api = configs.get(arch)
    cfg = dataclasses.replace(api.cfg, n_layers=depth or api.cfg.n_layers)
    return dataclasses.replace(api, cfg=cfg, policy=plan or api.policy)


def with_kv4(policy, **layers):
    """``policy`` as a plan (its default format, the named ``layers``
    overrides) with a packed kv4 cache, or without a cache section when
    ``kv`` is False."""
    from repro_torch.core.plan import KVCachePlan, LayerPlan, PrecisionPlan
    kv = layers.pop("kv", True)
    return PrecisionPlan.build(
        {name.replace("_", "."): LayerPlan(w_bits=w, k=k,
                                           channel_wise=policy.channel_wise)
         for name, (w, k) in layers.items()},
        default=LayerPlan(w_bits=policy.inner_bits, k=policy.k,
                          channel_wise=policy.channel_wise),
        a_bits=policy.a_bits, boundary_bits=policy.boundary_bits,
        kv=KVCachePlan(bits=4, k=4, store="packed") if kv else None,
        name="p12" + "".join(f"-{n.replace('_', '.')}w{w}k{k}"
                             for n, (w, k) in layers.items())
        + ("-kv4" if kv else ""))


def k1_calls(api, b, s, smax, step):
    """K1's calls of one prefill of ``b`` x ``s`` tokens (step 'prefill') or
    one decode step against an ``smax`` cache ('decode'), in order: [(name,
    M of one group, K, N, groups, w_bits, k)].  An expert bank is one call
    (groups = E) of ``b`` x capacity rows an expert; MLA's uk / uv expand
    the whole cache at decode."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.nn.layers import pad_vocab
    from repro_torch.nn.moe import capacity
    cfg, pol = api.cfg, api.policy
    rows = b * s if step == "prefill" else b
    d, h = cfg.d_model, cfg.n_heads
    out = []

    def add(name, lname, m, kdim, n, groups=1, cls="inner"):
        p = plan_lib.resolve_policy(pol, lname)
        out.append((name, m, kdim, n, groups, p.bits_for(cls), p.k))
    for i in range(cfg.n_layers):
        ln = f"l{i}."
        if cfg.mla is not None:
            m = cfg.mla
            lat = rows if step == "prefill" else b * smax
            add("q", ln + "q", rows, d, h * (m.qk_nope + m.qk_rope))
            add("dkv", ln + "dkv", rows, d, m.kv_lora + m.qk_rope)
            add("uk", ln + "uk", lat, m.kv_lora, h * m.qk_nope)
            add("uv", ln + "uv", lat, m.kv_lora, h * m.v_head)
            add("o", ln + "o", rows, h * m.v_head, d)
        else:
            for name, n in (("q", h * cfg.hd), ("k", cfg.n_kv * cfg.hd),
                            ("v", cfg.n_kv * cfg.hd)):
                add(name, ln + name, rows, d, n)
            add("o", ln + "o", rows, h * cfg.hd, d)
        if cfg.moe is not None and i >= cfg.dense_first_n:
            mc = cfg.moe
            me = b * capacity(mc, s if step == "prefill" else 1)
            for kdim, n in ((d, mc.d_ff), (d, mc.d_ff), (mc.d_ff, d)):
                add("expert", ln + "expert", me, kdim, n, mc.n_experts)
            if mc.n_shared:
                sh = mc.shared_hidden
                for kdim, n in ((d, sh), (d, sh), (sh, d)):
                    add("shared", ln + "shared", rows, kdim, n)
        else:
            ff = (cfg.dense_ff if i < cfg.dense_first_n and cfg.dense_ff
                  else cfg.d_ff)
            mats = ((d, ff), (d, ff), (ff, d)) if cfg.act == "swiglu" \
                else ((d, ff), (ff, d))
            for kdim, n in mats:
                add("mlp", ln + "mlp", rows, kdim, n)
    add("head", "head", b, d, pad_vocab(cfg.vocab), cls="boundary")
    return out


def expected_counts(api, b, s, n_new):
    """(K1 launches by route, K3 and K4 launches) of one ``Generator.run``
    of ``b`` prompts of ``s`` tokens and ``n_new`` new tokens."""
    from collections import Counter
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.models import transformer as T
    routes = Counter()
    for step, reps in (("prefill", 1), ("decode", n_new - 1)):
        for _, m, kdim, n, *_ in k1_calls(api, b, s, s + n_new, step):
            routes[kernel.mpmm_route(m, kdim, n)] += reps
    cfg = api.cfg
    kv = T.kv_formats(cfg, api.policy)
    flash = cfg.mla is None and cfg.attn_impl == "flash"
    k4 = cfg.n_layers if flash and kv is not None else 0
    k3 = cfg.n_layers if flash and kv is None else 0
    return dict(routes), k3, k4


def serve_family(sm, api, params, prompts, n_new, label):
    """One ``Generator`` run through the kernels, counted against the calls
    the path makes (``expected_counts``); then phase 8's contracts against
    the same model through the plain versions: the prefill layer by layer,
    every decode step bitwise."""
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.runtime.serve import Generator
    t = sm.torch
    b, s = prompts.shape
    gen = Generator(api, params, device=sm.device)
    plain = Generator(api, params, device=sm.device, impl="torch")
    reset_counts()
    t0 = time.perf_counter()
    toks, logits = gen.run(prompts, n_new)
    t.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    routes = {k: v for k, v in kernel.mpmm_cuda.routes.items() if v}
    want_routes, k3, k4 = expected_counts(api, b, s, n_new)
    want = {"mpmm_cuda": sum(want_routes.values()), "conv_mpmm_cuda": 0,
            "flash_fwd_cuda": k3, "flash_fwd_packed_cuda": k4}
    log(f"[p12] {label}: depth {api.cfg.n_layers}, {b} prompts x {s} "
        f"tokens, {n_new} new tokens in {wall:.2f} s; launches {launches}; "
        f"K1 routes {routes}")
    if launches != want or routes != want_routes:
        raise SystemExit(f"{label}: launches {launches} / routes {routes} "
                         f"!= {want} / {want_routes}")
    for step, a in enumerate(logits):
        a = a.float()
        if a.shape != (b, api.cfg.vocab) or not bool(
                t.isfinite(a).all()) or float(a.std()) == 0.0:
            raise SystemExit(f"{label} step {step}: logits {tuple(a.shape)} "
                             f"not finite or constant")
    if api.cfg.moe is not None:
        pc = moe_prefill_contract(sm, api, params, prompts, label)
        held = (f"prefill attention blocks <= {pc['attn'][0]:.5f} of the "
                f"largest |output|, <= {pc['attn'][1]:.5f} of outputs "
                f"differ, MoE/MLP blocks and the head bitwise, whole layers "
                f"<= {pc['layer'][1]:.5f} of outputs differ (largest "
                f"difference {pc['layer'][0]:.5f} of the largest |output|)")
    else:
        pc = prefill_contract(sm, api, params, prompts, label)
        held = (f"prefill one-layer error <= {pc['layer_rel']:.5f} of the "
                f"largest |output|, <= {pc['layer_diff']:.5f} of outputs "
                f"differ; last-token logits {pc['logits_rel']:.5f}, "
                f"head-input flips {pc['flips']:.5f}; carried through "
                f"{api.cfg.n_layers} layers: logits {pc['carried_rel']:.5f}")
    decode_contract(sm, gen, plain, prompts, toks, label)
    log(f"[p12] {label}: tokens[0] {toks[0].tolist()}; {held} (tol "
        f"{LM_LOGIT_TOL}, {LM_MAX_FLIP_RATE}); {n_new - 1} decode steps "
        f"bitwise equal")
    return {"launches": launches, "routes": routes, "tokens": toks,
            "gen": gen, "wall": wall}


def moe_prefill_contract(sm, api, params, prompts, label):
    """The prefill of an MoE model, layer by layer and block by block.
    The router decides discretely, so a sub-ulp difference from K4 that
    moves a token across a rounding boundary of its codes can send it to
    another expert: the whole layer then differs in that token's row by
    much more than phase 8's 2% of the largest output.  So each block is
    held on its own, fed the kernel path's own input: the attention block
    (K4 or MLA, and K1) within phase 8's bounds (``LM_LOGIT_TOL`` of the
    largest output, ``LM_MAX_FLIP_RATE`` of bf16 outputs different), the
    MoE (or dense) block bitwise (K1 is exact and the routing the same code
    on the same input), the whole layer's share of differing outputs
    within ``LM_MAX_FLIP_RATE`` (its largest difference printed), and the
    head on the last token bitwise."""
    from repro_torch.models import transformer as T
    from repro_torch.nn import attention as attn
    t = sm.torch
    cfg, plan = api.cfg, api.policy
    kv = T.kv_formats(cfg, plan)
    store, fmts = kv if kv is not None else ("packed", [None] * cfg.n_layers)
    _, napply = cfg.norm_fns

    def stats(a, b):
        a, b = a.float(), b.float()
        return (float((a - b).abs().max()) / float(a.abs().max()),
                float((a != b).float().mean()))

    def attend(lp, x, impl, i):
        h = napply(lp["ln1"], x)
        if cfg.mla is not None:
            o, _ = attn.mla_prefill(lp["attn"], h, plan, sin=sin, cos=cos,
                                    impl=impl, chunk=cfg.attn_chunk,
                                    lname=f"l{i}.", **T._mla_kw(cfg))
        else:
            o, _ = attn.gqa_prefill(
                lp["attn"], h, plan, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                head_dim=cfg.hd, sin=sin, cos=cos, impl=impl,
                chunk=cfg.attn_chunk, attn_impl=cfg.attn_impl,
                lname=f"l{i}.", kv_fmts=fmts[i], kv_store=store)
        return x + o

    def mlp(lp, y, impl, i):
        return y + T._apply_mlp(cfg, lp, napply(lp["ln2"], y), plan, impl,
                                f"l{i}.")
    worst = {"attn": [0.0, 0.0], "layer": [0.0, 0.0]}
    b, s = prompts.shape
    with t.inference_mode():
        x = T._embed(params, t.as_tensor(prompts, device=sm.device))
        sin, cos = T._rotary(cfg, T._positions(b, s, 0, sm.device))
        for i, lp in enumerate(params["layers"]):
            y_k, y_1 = attend(lp, x, "cuda", i), attend(lp, x, "torch", i)
            z_k, z_1 = mlp(lp, y_k, "cuda", i), mlp(lp, y_k, "torch", i)
            a_rel, a_diff = stats(y_k, y_1)
            l_rel, l_diff = stats(z_k, mlp(lp, y_1, "torch", i))
            log(f"[drift] {label} layer {i}: attention block {a_rel:.6f} of "
                f"the largest |output|, {a_diff:.6f} of outputs differ; "
                f"{'MoE' if 'moe' in lp else 'MLP'} block bitwise "
                f"{t.equal(z_k, z_1)}; whole layer {l_rel:.6f}, "
                f"{l_diff:.6f}")
            if a_rel > LM_LOGIT_TOL or a_diff > LM_MAX_FLIP_RATE \
                    or l_diff > LM_MAX_FLIP_RATE or not t.equal(z_k, z_1):
                raise SystemExit(
                    f"{label} layer {i}: attention block {a_rel:.5f} / "
                    f"{a_diff:.5f} (tol {LM_LOGIT_TOL}, {LM_MAX_FLIP_RATE}), "
                    f"MLP block bitwise {t.equal(z_k, z_1)}, whole layer "
                    f"{l_diff:.5f} of outputs differ (tol "
                    f"{LM_MAX_FLIP_RATE})")
            worst = {"attn": [max(worst["attn"][0], a_rel),
                              max(worst["attn"][1], a_diff)],
                     "layer": [max(worst["layer"][0], l_rel),
                               max(worst["layer"][1], l_diff)]}
            x = z_k
        head_k = T._head(cfg, params, x[:, -1:], plan, "cuda")
        head_1 = T._head(cfg, params, x[:, -1:], plan, "torch")
    if not t.equal(head_k, head_1):
        raise SystemExit(f"{label}: the head's kernel and plain logits "
                         f"differ on the same input")
    return worst


def verify_contract(sm, gen, prompts, toks, label):
    """``decode_steps`` over VERIFY_T tokens against as many sequential
    decode steps on a copy of the cache: logits and cache bitwise."""
    t = sm.torch
    b, s = prompts.shape
    with t.inference_mode():
        _, pre = gen.prefill(t.as_tensor(prompts, device=sm.device))
        cache = gen._grow_cache(pre, b, s, s + toks.shape[1])
        del pre
        seq_cache = clone_tree(cache)
        feed = t.as_tensor(toks[:, :VERIFY_T], device=sm.device)
        bat, cache = gen.api.decode_steps(gen.params, cache, feed, s)
        seq = t.stack([gen.decode(seq_cache, feed[:, i:i + 1], s + i)[0]
                       for i in range(VERIFY_T)], dim=1)
        same = all(t.equal(x, y) for x, y in zip(tree_leaves(cache),
                                                 tree_leaves(seq_cache)))
    if not t.equal(bat, seq) or not same:
        raise SystemExit(f"{label}: decode_steps over {VERIFY_T} tokens "
                         f"differs from sequential decode steps (cache "
                         f"equal {same})")
    log(f"[p12] {label}: decode_steps over {VERIFY_T} tokens bitwise equal "
        f"to {VERIFY_T} sequential decode steps, logits and cache")


def k1_operands(sm, m, kdim, n, groups, w_bits, k):
    """One K1 call's operands drawn on the card (a bank of ``groups``
    experts when groups > 1), bf16 out, no epilogue.  The weights are drawn
    and packed in column slices of about 2^28 codes (nemotron's head is
    4.7e9)."""
    from repro_torch.core import packing
    t = sm.torch
    g = t.Generator(device=sm.device).manual_seed(m + kdim + n + groups)
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    lead = (groups,) if groups > 1 else ()
    step = max(1, (1 << 28) // (kdim * groups))
    planes, colsum = [], []
    for c0 in range(0, n, step):
        w_int = t.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1),
                          lead + (kdim, min(step, n - c0)), generator=g,
                          device=sm.device, dtype=t.int32)
        planes.append(packing.pack_planes(w_int, fmt).movedim(0, -3))
        colsum.append(w_int.sum(-2, dtype=t.int32)[..., None, :])
        del w_int
    d = dict(a_biased=t.randint(-128, 128, lead + (m, kdim), generator=g,
                                device=sm.device, dtype=t.int32).to(t.int8),
             planes=t.cat(planes, -1).contiguous(), colsum=t.cat(colsum, -1),
             gamma=t.rand(lead + (1, n), generator=g, device=sm.device)
             * 0.01)
    return d, dict(fmt=fmt, act_zero=128, out_dtype=t.bfloat16)


def k1_split(sm, api, b, s, smax):
    """K1's time in one prefill and in one decode step: each distinct call
    of ``k1_calls`` timed alone at its shape (CUDA events, call by call),
    times its count -- the kernels' own times, as phase 9's split, which
    need no profiler."""
    from repro_torch.kernels.mpmm import kernel
    cache, out = {}, {}
    for step in ("prefill", "decode"):
        total = 0.0
        for call in k1_calls(api, b, s, smax, step):
            key = call[1:]
            if key not in cache:
                d, kw = k1_operands(sm, *key)
                cache[key] = sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw),
                                        reps=5, warmup=2)
                del d
            total += cache[key]
        out[step] = total
    return out


def flash_split(sm, api, b, s):
    """K3's or K4's time in one prefill: the layer's call at its prefill
    shape (bf16, causal; K4 at each layer's cache formats), timed alone,
    summed over the layers; 0 for MLA (no flash kernel)."""
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.models import transformer as T
    from repro_torch.nn import kvcache
    t = sm.torch
    cfg = api.cfg
    if cfg.mla is not None or cfg.attn_impl != "flash":
        return 0.0
    g = t.Generator(device=sm.device).manual_seed(420)
    mk = lambda h: t.randn((b, s, h, cfg.hd), generator=g,  # noqa: E731
                           device=sm.device).to(t.bfloat16)
    q, k, v = mk(cfg.n_heads), mk(cfg.n_kv), mk(cfg.n_kv)
    kv = T.kv_formats(cfg, api.policy)
    if kv is None:
        ms = sm.time_ms(lambda: fops.flash_attention(
            q, k, v, block_k=cfg.attn_chunk, impl="cuda"), reps=5)
        return ms * cfg.n_layers
    total, cache = 0.0, {}
    for fk, fv in kv[1]:
        key = (fk, fv)
        if key not in cache:
            kq, vq = kvcache.pack_kv(k, fk), kvcache.pack_kv(v, fv)
            cache[key] = sm.time_ms(lambda: fops.flash_attention_packed(
                q, kq, vq, fk, fv, block_k=cfg.attn_chunk, impl="cuda"),
                reps=5)
        total += cache[key]
    return total


def k1_bank_row(sm, label, m, kdim, n, e, w_bits, k):
    """An expert bank's K1 call held bitwise against its plain version on
    the same inputs, then timed against its bound and against a PyTorch
    loop over the experts (``torch._int_mm`` where it takes the shape,
    else ``torch.mm`` in f32), both on the same combined weights."""
    from repro_torch.kernels.mpmm import kernel, ref
    t = sm.torch
    d, kw = k1_operands(sm, m, kdim, n, e, w_bits, k)
    fmt = kw["fmt"]
    out = kernel.mpmm_cuda(**d, **kw)
    shape = f"E={e} M={m} K={kdim} N={n} w{w_bits}k{k}"
    sm.compare("mpmm_cuda", f"K1 {label} {shape}", out,
               kernel.mpmm_torch(**d, **kw).cpu())
    a, w8 = d["a_biased"], ref.combined_int8_weights(d["planes"], fmt)
    if m > 16 and kdim % 8 == 0 and n % 8 == 0:
        lib = lambda: [t._int_mm(a[i], w8[i]) for i in range(e)]  # noqa
        lib_name = f"torch._int_mm loop over {e} experts"
    else:  # _int_mm needs M > 16
        af, wf = a.float(), w8.float()
        lib = lambda: [t.mm(af[i], wf[i]) for i in range(e)]  # noqa: E731
        lib_name = f"torch.mm (f32) loop over {e} experts"
    by = nbytes(d["a_biased"], d["planes"], d["gamma"], d["colsum"], out)
    b_ms, b_by = bound_ms(by, 2 * e * m * n * kdim)
    row = {"kernel": "mpmm_cuda", "layer": label,
           "route": kernel.mpmm_route(m, kdim, n),
           "shape": shape,
           "ms": sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw), reps=10),
           "plain_ms": sm.time_ms(lambda: kernel.mpmm_torch(**d, **kw),
                                  reps=2, warmup=1),
           "library_ms": sm.time_ms(lib, reps=5, warmup=2),
           "library": lib_name, "bound_ms": b_ms, "bound_by": b_by}
    del d, out, w8
    return row


D192_CASES = [dict(sq=512, sk=512), dict(sq=9, sk=521, q_offset=512),
              dict(sq=512, sk=512, window=128)]
D192_FORMATS = [((4, 4), (4, 4)), ((2, 2), (8, 4)), ((2, 1), (8, 8))]


def phase_d192(sm):
    """K3 and K4 at head dim 192, nemotron's attention (H 96, KV 8, bf16,
    DENSE_SHAPE's batch): causal at Sq = Sk = 512, a q_offset continuation
    and a window, K4 at three cache formats (1-bit digits: 24-byte rows),
    each against its plain version within one bf16 ulp."""
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.nn import kvcache
    t = sm.torch
    b = DENSE_SHAPE[0]
    for i, case in enumerate(D192_CASES):
        kw = {k: v for k, v in case.items() if k not in ("sq", "sk")}
        g = t.Generator(device=sm.device).manual_seed(400 + i)
        mk = lambda s, h: t.randn((b, s, h, 192), generator=g,  # noqa: E731
                                  device=sm.device).to(t.bfloat16)
        q, k, v = mk(case["sq"], 96), mk(case["sk"], 8), mk(case["sk"], 8)
        got = fops.flash_attention(q, k, v, impl="cuda", **kw)
        want = fops.flash_attention(q, k, v, impl="torch", **kw)
        t.cuda.synchronize()
        err = compare_close(sm, "flash_fwd_cuda", f"K3 D192 {case}", got,
                            want)
        errs = []
        for fk, fv in D192_FORMATS:
            fmt_k, fmt_v = (kvcache.KVFormat(*fk, 192),
                            kvcache.KVFormat(*fv, 192))
            kq, vq = kvcache.pack_kv(k, fmt_k), kvcache.pack_kv(v, fmt_v)
            got = fops.flash_attention_packed(q, kq, vq, fmt_k, fmt_v,
                                              impl="cuda", **kw)
            want = fops.flash_attention_packed(q, kq, vq, fmt_k, fmt_v,
                                               impl="torch", **kw)
            t.cuda.synchronize()
            errs.append(compare_close(sm, "flash_fwd_packed_cuda",
                                      f"K4 D192 k{fk} v{fv} {case}", got,
                                      want))
        log(f"[D192] {case}: K3 max abs err vs plain {err}; K4 "
            f"{dict(zip(map(str, D192_FORMATS), errs))}")
    sm.check_phase("K3 / K4 at head dim 192 vs their plain versions")


def measure_d192(sm):
    """K3 and K4 at nemotron's prefill (B 2, S 512, H 96, KV 8, D 192,
    causal, bf16; K4 at kv4): kernel, plain version, SDPA and the bound."""
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.nn import kvcache
    t = sm.torch
    F = t.nn.functional
    b, s = DENSE_SHAPE[:2]
    g = t.Generator(device=sm.device).manual_seed(410)
    mk = lambda h: t.randn((b, s, h, 192), generator=g,  # noqa: E731
                           device=sm.device).to(t.bfloat16)
    q, k, v = mk(96), mk(8), mk(8)
    fmt = kvcache.KVFormat(4, 4, 192)
    kq, vq = kvcache.pack_kv(k, fmt), kvcache.pack_kv(v, fmt)
    kd, vd = kvcache.unpack_kv(kq, fmt), kvcache.unpack_kv(vq, fmt)
    pairs = causal_pairs(s, s)
    rows = []
    for name, run, ins, kv in (
            ("flash_fwd_cuda", lambda impl: fops.flash_attention(
                q, k, v, impl=impl), (q, k, v), (k, v)),
            ("flash_fwd_packed_cuda", lambda impl: fops.flash_attention_packed(
                q, kq, vq, fmt, fmt, impl=impl),
             (q, *kq.values(), *vq.values()), (kd, vd))):
        out = run("cuda")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, *kv))
        ke, ve = (x.repeat_interleave(12, dim=1) for x in (kt, vt))
        tb = nbytes(*ins, out) / PEAK_BYTES_PER_S * 1e3
        to = 4 * b * 96 * 192 * pairs / PEAK_BF16_FLOPS_PER_S * 1e3
        rows.append({
            "kernel": name, "layer": "D192",
            "shape": f"B={b} S={s} H=96 KV=8 D=192 bf16 causal"
                     + (" K/V kv4k4" if "packed" in name else ""),
            "count": DENSE_DEPTH,
            "ms": sm.time_ms(lambda: run("cuda"), reps=10),
            "plain_ms": sm.time_ms(lambda: run("torch"), reps=2, warmup=1),
            "library_ms": sm.time_ms(lambda: F.scaled_dot_product_attention(
                qt, ke, ve, is_causal=True), reps=10),
            "library": "F.scaled_dot_product_attention bf16 causal, K/V "
                       "heads expanded" + (" (unpacked K/V)" if "packed" in
                                           name else ""),
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"})
    return rows


def p12_moe(sm, arch, plan, card):
    """(a)/(b): one MoE arch at full width and depth, its Generator run
    counted and held to the contracts, decode_steps against sequential
    steps, the scheduler's tickets against requests served alone, and the
    timing: prefill, decode step, the profiled split, the bank's K1 calls."""
    import numpy as np
    from repro_torch.runtime.serve import init_packed_lm
    t = sm.torch
    b, s, n_new = P12_SHAPE
    api = family_api(arch, plan)
    cfg = api.cfg
    t0 = time.perf_counter()
    params = init_packed_lm(api, t.Generator(device=sm.device).manual_seed(
        SEED), device=sm.device)
    t.cuda.synchronize()
    log(f"[p12] {arch}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv} KV heads, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.topk} (ff {cfg.moe.d_ff}, shared {cfg.moe.n_shared}), "
        f"mla {cfg.mla}, dense prefix {cfg.dense_first_n}, vocab "
        f"{cfg.vocab}, depth {cfg.n_layers}, plan "
        f"{getattr(api.policy, 'name', '') or api.policy}; "
        f"drawn and packed layer by layer in {time.perf_counter() - t0:.2f} "
        f"s, {t.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (b, s))
    run = serve_family(sm, api, params, prompts, n_new, arch)
    gen = run["gen"]
    verify_contract(sm, gen, prompts, run["tokens"], arch)
    trace = sched_trace(cfg.vocab)
    alone = [gen.generate(p[None], n)[0] for p, n in trace]
    run_scheduler(sm, gen, trace, alone, f"{arch} Generator")
    sm.check_phase(f"12 {arch}: GenerateScheduler tickets vs requests "
                   f"served alone")
    prefill_ms, decode_ms = measure_lm_end_to_end(sm, api, params, prompts,
                                                  n_new)
    split = dict(k1_split(sm, api, b, s, s + n_new),
                 flash=flash_split(sm, api, b, s))
    bank = {}
    for step in ("prefill", "decode"):
        for call in k1_calls(api, b, s, s + n_new, step):
            if call[4] > 1:
                bank.setdefault((step,) + call[1:], 0)
                bank[(step,) + call[1:]] += 1
    rows = [dict(k1_bank_row(sm, f"{arch} {step} bank", *key), count=n,
                 phase=step)
            for (step, *key), n in sorted(bank.items())]
    counts = dict(run["launches"], **{f"route:{k}": v
                                       for k, v in run["routes"].items()})
    del params, gen, run
    release(sm)
    return {"arch": arch, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "split": split, "rows": rows, "shape": P12_SHAPE,
            "counts": counts}


def p12_dense(sm, arch, kv4, card):
    """(c): a dense arch at full width, its first DENSE_DEPTH layers, under
    its default policy (bf16 cache, K3) or a packed kv4 cache (K4)."""
    import numpy as np
    from repro_torch.runtime.serve import init_packed_lm
    t = sm.torch
    b, s, n_new = DENSE_SHAPE
    base = family_api(arch, depth=DENSE_DEPTH)
    api = dataclasses.replace(base, policy=with_kv4(base.policy, kv=kv4))
    cfg = api.cfg
    label = f"{arch} {'kv4 cache (K4)' if kv4 else 'bf16 cache (K3)'}"
    t0 = time.perf_counter()
    params = init_packed_lm(api, t.Generator(device=sm.device).manual_seed(
        SEED), device=sm.device)
    t.cuda.synchronize()
    log(f"[p12] {label}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv} KV heads, head_dim {cfg.hd}, d_ff {cfg.d_ff} "
        f"({cfg.act}), vocab {cfg.vocab}, depth {cfg.n_layers} of "
        f"{family_api(arch).cfg.n_layers}; drawn and packed in "
        f"{time.perf_counter() - t0:.2f} s, peak "
        f"{t.cuda.max_memory_allocated() / 2**30:.2f} GiB, now "
        f"{t.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (b, s))
    run = serve_family(sm, api, params, prompts, n_new, label)
    prefill_ms, decode_ms = measure_lm_end_to_end(sm, api, params, prompts,
                                                  n_new)
    split = dict(k1_split(sm, api, b, s, s + n_new),
                 flash=flash_split(sm, api, b, s))
    counts = dict(run["launches"], **{f"route:{k}": v
                                       for k, v in run["routes"].items()})
    del params, run
    release(sm)
    t.cuda.reset_peak_memory_stats()
    return {"arch": label, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "split": split, "rows": [], "shape": DENSE_SHAPE,
            "counts": counts}


def print_p12(p12, p12_rows, card):
    """Phase 12's ``[p12-time]`` lines."""
    for res in p12:
        b, s_, n_new = res["shape"]
        sp = res["split"]
        pf_ms, dc_ms = res["prefill_ms"], res["decode_ms"]
        log(f"[p12-time] {res['arch']}: prefill {pf_ms:.2f} ms = "
            f"{b * s_ / pf_ms * 1e3:.1f} tokens/s ({b} x {s_}); decode "
            f"{dc_ms:.2f} ms per step = {b / dc_ms * 1e3:.1f} tokens/s at "
            f"batch {b}  ({card})")
        rest = pf_ms - sp["prefill"] - sp["flash"]
        log(f"[p12-time] {res['arch']} split (each kernel's calls timed "
            f"alone): prefill K1 {sp['prefill']:.2f} ms "
            f"({sp['prefill'] / pf_ms:.1%}), K3/K4 {sp['flash']:.2f} ms "
            f"({sp['flash'] / pf_ms:.1%}), rest {rest:.2f} ms "
            f"({rest / pf_ms:.1%}); decode step K1 {sp['decode']:.2f} ms "
            f"call by call ({sp['decode'] / dc_ms:.1%}), rest "
            f"{dc_ms - sp['decode']:.2f} ms")
    for r in p12_rows:
        log(f"[p12-time] {r['kernel']} {r['layer']} {r['shape']}"
            + (f" route {r['route']}" if "route" in r else "")
            + f": kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms ({r['library']}; "
            f"kernel/library {r['ms'] / r['library_ms']:.2f}x), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of it), x{r['count']}"
            + (f" per {r['phase']}" if "phase" in r else " per prefill")
            + f"  ({card})")


def phase_p12(sm, card):
    """Phase 12 -> (summed launches of its main-path runs, results, timed
    rows).  Each arch's Generator run is counted from zero."""
    from repro_torch import configs
    t0 = time.perf_counter()
    release(sm)
    log(f"[p12] {sm.torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
        f"card before phase 12")
    olmoe = configs.get("olmoe-1b-7b").policy
    results = [p12_moe(sm, "olmoe-1b-7b", with_kv4(
        olmoe, l0_expert=(2, 2), l1_expert=(8, 4)), card),
        p12_moe(sm, "deepseek-v2-lite-16b", None, card)]
    for arch in DENSE_ARCHS:
        for kv4 in ((False, True) if arch in KV4_ARCHS else (False,)):
            results.append(p12_dense(sm, arch, kv4, card))
    launches = {}
    for res in results:
        launches = add_counts(launches, res["counts"])
    sm.check_phase("12 K1 expert banks at the path's shapes vs "
                   "mpmm_torch")
    rows = [r for res in results for r in res["rows"]] + measure_d192(sm)
    log(f"[p12] phase 12 took {time.perf_counter() - t0:.1f} s")
    return launches, results, rows


# --- phase 13: the last three families --------------------------------------


# arch -> (batch, prompt tokens, new tokens)
P13_RUNS = (("mamba2-1.3b", (4, 1000, 16)),
            ("recurrentgemma-9b", (2, 3000, 16)),
            ("whisper-base", (4, 64, 16)))
P13_SCHED_DEPTH = {"mamba2-1.3b": 4, "recurrentgemma-9b": 6}
R6_STEP_DEPTH = 2      # mamba2 layers fed the prompt token by token
R6_STEP_TOL = 0.1      # tests/test_torch_ssm.py STEP_TOL
R6_ORACLE_TOL = 1e-4   # against chunk = S: f32 sums over 4 chunks vs 1
# K1 at the new shapes of phase 13: mamba2's in_dt (N 64), recurrentgemma's
# MQA k / v (N 256), whisper's K 512 -- both routes, w4k4
P13_K1_SHAPES = [("prefill", 4096, (2048, 64, 4, 4), 1),
                 ("decode", 4, (2048, 64, 4, 4), 1),
                 ("prefill", 6000, (4096, 256, 4, 4), 1),
                 ("decode", 2, (4096, 256, 4, 4), 1),
                 ("prefill", 6144, (512, 512, 4, 4), 1),
                 ("decode", 4, (512, 2048, 4, 4), 1)]
# K3 at head dim 256: recurrentgemma's attention (H 16, KV 1, window 2048)
D256_CASES = [dict(sq=2560, sk=2560, window=2048),
              dict(sq=3000, sk=3000, window=2048),
              dict(sq=9, sk=2569, q_offset=2560, window=2048)]


def phase_d256(sm):
    """K3 at head dim 256 against its plain version within one bf16 ulp:
    recurrentgemma's attention (batch 2, 16 query heads on one KV head,
    bf16, window 2048) above the window, at its block_k 1024 (S 3000 pads
    its keys to 3072 and so runs causal), and a q_offset continuation."""
    from repro_torch import configs
    from repro_torch.kernels.flashattn import ops as fops
    t = sm.torch
    block_k = configs.get("recurrentgemma-9b").cfg.attn_chunk
    for i, case in enumerate(D256_CASES):
        kw = {k: v for k, v in case.items() if k not in ("sq", "sk")}
        g = t.Generator(device=sm.device).manual_seed(500 + i)
        mk = lambda s, h: t.randn((2, s, h, 256), generator=g,  # noqa: E731
                                  device=sm.device).to(t.bfloat16)
        q, k, v = mk(case["sq"], 16), mk(case["sk"], 1), mk(case["sk"], 1)
        got = fops.flash_attention(q, k, v, block_k=block_k, impl="cuda",
                                   **kw)
        want = fops.flash_attention(q, k, v, block_k=block_k, impl="torch",
                                    **kw)
        t.cuda.synchronize()
        err = compare_close(sm, "flash_fwd_cuda", f"K3 D256 {case}", got,
                            want)
        log(f"[D256] {case}: K3 max abs err vs plain {err}")
        del q, k, v, got, want
    sm.check_phase("K3 at head dim 256 vs its plain version")


def window_pairs(sq, window):
    """(query, key) pairs a causal window leaves at q_offset 0."""
    return sum(min(window, i + 1) for i in range(sq))


def visited_tiles(sq, window, bq=128, bkv=64):
    """Key tiles K3 reads for a causal window (csrc sweep_range), summed
    over the query tiles, against the causal sweep without the skip."""
    seen = full = 0
    for q0 in range(0, sq, bq):
        end = min(q0 + bq, sq)
        begin = max(0, q0 - window + 1) // bkv * bkv
        seen += -(-(end - begin) // bkv)
        full += -(-end // bkv)
    return seen, full


def measure_d256(sm, api, b, s):
    """K3 at recurrentgemma's prefill (B x S, H 16, KV 1, D 256, window
    2048, bf16): kernel, plain version, SDPA with the same boolean window
    mask, and the bound."""
    from repro_torch.kernels.flashattn import ops as fops
    t = sm.torch
    F = t.nn.functional
    cfg = api.cfg
    g = t.Generator(device=sm.device).manual_seed(510)
    mk = lambda h: t.randn((b, s, h, cfg.hd), generator=g,  # noqa: E731
                           device=sm.device).to(t.bfloat16)
    q, k, v = mk(cfg.n_heads), mk(cfg.n_kv), mk(cfg.n_kv)
    run = lambda impl: fops.flash_attention(  # noqa: E731
        q, k, v, window=cfg.window, block_k=cfg.attn_chunk, impl=impl)
    out = run("cuda")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ke, ve = (x.expand(-1, cfg.n_heads, -1, -1) for x in (kt, vt))
    pos = t.arange(s, device=sm.device)
    mask = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] > pos[:, None] - cfg.window)
    pairs = window_pairs(s, cfg.window)
    tb = nbytes(q, k, v, out) / PEAK_BYTES_PER_S * 1e3
    to = 4 * b * cfg.n_heads * cfg.hd * pairs / PEAK_BF16_FLOPS_PER_S * 1e3
    seen, full = visited_tiles(s, cfg.window)
    row = {
        "kernel": "flash_fwd_cuda", "layer": "D256",
        "shape": f"B={b} S={s} H={cfg.n_heads} KV={cfg.n_kv} D={cfg.hd} "
                 f"bf16 window {cfg.window}",
        "count": cfg.n_super,
        "ms": sm.time_ms(lambda: run("cuda"), reps=10),
        "plain_ms": sm.time_ms(lambda: run("torch"), reps=2, warmup=1),
        "library_ms": sm.time_ms(lambda: F.scaled_dot_product_attention(
            qt, ke, ve, attn_mask=mask), reps=10),
        "library": "F.scaled_dot_product_attention bf16, the same boolean "
                   "window mask, K/V heads expanded",
        "bound_ms": max(tb, to),
        "bound_by": "bytes" if tb >= to else "operations",
        "tiles": f"per prefill; {seen} of {full} causal key tiles a head "
                 f"read"}
    del q, k, v, out, qt, kt, vt, ke, ve, mask
    return row


def measure_p13_k1(sm):
    """K1 at phase 13's new shapes (``P13_K1_SHAPES``): kernel, plain
    version, one library call and the bound, each on its route."""
    from repro_torch.kernels.mpmm import kernel
    rows = []
    for phase, m, (kdim, n, w_bits, k), _ in P13_K1_SHAPES:
        d, kw = k1_device_call(sm, m, kdim, n, w_bits, k, seed=3 * m + n)
        out = kernel.mpmm_cuda(**d, **kw)
        b_ms, b_by = bound_ms(nbytes(d["a_biased"], d["planes"], d["gamma"],
                                     d["colsum"], out), 2 * m * n * kdim)
        lib, lib_name = k1_library(sm, d, kw["fmt"])
        rows.append({"kernel": "mpmm_cuda", "layer": f"K1 {phase}",
                     "shape": f"M={m} K={kdim} N={n} w{w_bits}k{k} route "
                              f"{kernel.mpmm_route(m, kdim, n)}",
                     "count": 1,
                     "ms": sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw),
                                      reps=10, warmup=2),
                     "plain_ms": sm.time_ms(
                         lambda: kernel.mpmm_torch(**d, **kw), reps=2,
                         warmup=1),
                     "library_ms": sm.time_ms(lib, reps=10, warmup=2),
                     "library": lib_name, "bound_ms": b_ms,
                     "bound_by": b_by, "tiles": "one call"})
        del lib, d, out
    return rows


def p13_k1_calls(api, b, s, step):
    """K1's calls of one prefill of ``b`` x ``s`` tokens (step 'prefill';
    mamba2's rows padded to its chunk, whisper's encoder and cross K/V over
    its frames) or one decode step ('decode'; whisper's encoder and cross
    K/V do not run), from the arch's ``gemm_workload``: [(name, M, K, N,
    groups, w_bits, k)], one entry a launch; the head at M = b."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.nn.layers import pad_vocab
    cfg = api.cfg
    rows = s
    if hasattr(cfg, "ssm"):
        rows = s + (-s) % cfg.ssm.chunk
    out = []
    for g in api.gemm_workload(1):
        p = plan_lib.resolve_policy(api.policy, g.name)
        audio = g.name.startswith("enc_") or g.name == "dec_cross_kv"
        if step == "decode" and audio:
            continue
        n = pad_vocab(g.n) if g.name == "head" else g.n
        if step == "decode" or g.name == "head":
            m = b
        else:
            m = b * (cfg.n_audio if audio else rows)
        out += [(g.name, m, g.k, n, 1, p.bits_for(g.layer_class), p.k)] * \
            g.count
    return out


def p13_expected(api, b, s, n_new):
    """(K1 launches by route, K3 launches) of one ``Generator.run``."""
    from collections import Counter
    from repro_torch.kernels.mpmm import kernel
    routes = Counter()
    for step, reps in (("prefill", 1), ("decode", n_new - 1)):
        for _, m, kdim, n, *_ in p13_k1_calls(api, b, s, step):
            routes[kernel.mpmm_route(m, kdim, n)] += reps
    cfg = api.cfg
    k3 = cfg.n_super if getattr(cfg, "attn_impl", "xla") == "flash" else 0
    return dict(routes), k3


def p13_prefill_contract(sm, api, params, prompts, frames, label):
    """Phase 8's contract layer by layer, each layer's kernel and plain
    versions fed the kernel path's input (real rows only: mamba2's pads are
    dropped): within LM_LOGIT_TOL of the largest |output| and
    LM_MAX_FLIP_RATE of bf16 outputs different; whisper's encoder layers
    first, then its decoder layers on the kernel path's encoder output.
    The head on the last token, kernel against plain on the same input,
    bitwise (K1 is exact)."""
    from repro_torch.nn import layers as nnl
    t = sm.torch
    mod, cfg, plan = api.mod, api.cfg, api.policy
    b, s = prompts.shape
    worst = [0.0, 0.0]

    def check(name, y_k, y_1):
        a, c = y_k[:, :s].float(), y_1[:, :s].float()
        rel = float((a - c).abs().max()) / float(a.abs().max())
        diff = float((a != c).float().mean())
        log(f"[drift] {label} {name}: one-layer {rel:.6f} of the largest "
            f"|output|, {diff:.6f} of outputs differ")
        worst[0], worst[1] = max(worst[0], rel), max(worst[1], diff)
        if rel > LM_LOGIT_TOL or diff > LM_MAX_FLIP_RATE:
            raise SystemExit(f"{label} {name}: one-layer error {rel:.5f} of "
                             f"the largest |output|, {diff:.5f} of outputs "
                             f"differ (tol {LM_LOGIT_TOL}, "
                             f"{LM_MAX_FLIP_RATE})")

    with t.inference_mode():
        tt = t.as_tensor(prompts, device=sm.device)
        if api.needs_frames:
            xe = mod._enc_inputs(cfg, frames)
            for i, lp in enumerate(params["enc_layers"]):
                y_k = mod._enc_layer_fwd(cfg, lp, xe, plan, impl="cuda")
                y_1 = mod._enc_layer_fwd(cfg, lp, xe, plan, impl="torch")
                check(f"encoder layer {i}", y_k, y_1)
                xe = y_k
            aux = {"enc_out": nnl.layernorm_apply(params["enc_norm"], xe)}
            x, _ = mod._prefill_inputs(cfg, params, tt, frames, plan, "cuda")
            stack = params["dec_layers"]
        else:
            x, aux = mod._prefill_inputs(cfg, params, tt)
            stack = params["layers"]
        for i, lp in enumerate(stack):
            y_k, _ = mod._layer_fwd(cfg, i, lp, x, plan, aux, impl="cuda")
            y_1, _ = mod._layer_fwd(cfg, i, lp, x, plan, aux, impl="torch")
            check(f"layer {i}", y_k, y_1)
            x = y_k
        last = x[:, s - 1:s]
        l_k = mod._head(cfg, params, last, plan, "cuda")
        l_1 = mod._head(cfg, params, last, plan, "torch")
    if not t.equal(l_k, l_1):
        raise SystemExit(f"{label}: the head's kernel and plain logits "
                         f"differ on the same input")
    return worst


def p13_r6(sm, api, params, prompts):
    """R6 on the card, mamba2 at full width: (a) every layer's prefill
    state (prompt padded to its chunk, the pads' dt zeroed) against the
    same layer run on the unpadded prompt with chunk = S, on the same
    input -- the reference's own oracle -- within R6_ORACLE_TOL, the conv
    cache bitwise; the state after the pads (the reference's) printed
    beside it; (b) the first R6_STEP_DEPTH layers' prefill state against
    the prompt fed token by token through ``ssd_decode_step`` from zero,
    within R6_STEP_TOL (the CPU test's contract)."""
    from repro_torch.nn import layers as nnl
    from repro_torch.nn import ssm as nnssm
    t = sm.torch
    mod, cfg, plan = api.mod, api.cfg, api.policy
    b, s = prompts.shape
    oracle = dataclasses.replace(cfg.ssm, chunk=s)

    def rel(a, c):
        return float((a - c).abs().max()) / float(c.abs().max())
    worst, fault, states = 0.0, 1.0, []
    with t.inference_mode():
        tt = t.as_tensor(prompts, device=sm.device)
        x, aux = mod._prefill_inputs(cfg, params, tt)
        for i, lp in enumerate(params["layers"]):
            h = nnl.rmsnorm_apply(lp["ln"], x)
            o, st = nnssm.ssd_forward(lp["ssm"], h, plan, cfg.ssm,
                                      valid=aux["valid"])
            _, st_o = nnssm.ssd_forward(lp["ssm"], h[:, :s], plan, oracle)
            _, st_p = nnssm.ssd_forward(lp["ssm"], h, plan, cfg.ssm)
            r = rel(st["ssm"], st_o["ssm"])
            worst = max(worst, r)
            fault = min(fault, rel(st_p["ssm"], st_o["ssm"]))
            if r > R6_ORACLE_TOL or not t.equal(st["conv"], st_o["conv"]):
                raise SystemExit(f"R6 layer {i}: state {r} from the chunk = "
                                 f"{s} oracle (tol {R6_ORACLE_TOL}), conv "
                                 f"equal {t.equal(st['conv'], st_o['conv'])}")
            if i < R6_STEP_DEPTH:
                states.append(st)
            x = x + o
            del h, st_o, st_p
        xs = nnl.embed_serve_apply(params["embed"], tt)
        run = [{k: t.zeros(sp.shape, device=sm.device)
                for k, sp in nnssm.ssm_state_spec(cfg.ssm, b).items()}
               for _ in range(R6_STEP_DEPTH)]
        for pos in range(s):
            xt = xs[:, pos:pos + 1]
            for i in range(R6_STEP_DEPTH):
                lp = params["layers"][i]
                o, run[i] = nnssm.ssd_decode_step(
                    lp["ssm"], nnl.rmsnorm_apply(lp["ln"], xt), run[i], plan,
                    cfg.ssm)
                xt = xt + o
    steps = max(rel(st[k], r[k]) for st, r in zip(states, run)
                for k in ("ssm", "conv"))
    log(f"[p13] R6: {cfg.n_layers} layers' prefill states (S {s} padded to "
        f"{x.shape[1]}, the pads' dt zeroed) within {worst:.3g} of the "
        f"chunk = {s} oracle (tol {R6_ORACLE_TOL}), conv caches bitwise; the "
        f"state after the pads (the reference's) at least {fault:.3f} away; "
        f"first {R6_STEP_DEPTH} layers within {steps:.4f} of the prompt fed "
        f"token by token (tol {R6_STEP_TOL})")
    if steps > R6_STEP_TOL:
        raise SystemExit(f"R6: prefill state {steps} from the token-by-token "
                         f"state (tol {R6_STEP_TOL})")
    return {"oracle": worst, "fault": fault, "steps": steps}


def p13_scheduler(sm, api, params, depth, label):
    """GenerateScheduler over the arch's first ``depth`` layers at full
    width: every ticket bitwise its request served alone."""
    from repro_torch.runtime.serve import Generator
    sapi = dataclasses.replace(api, cfg=dataclasses.replace(
        api.cfg, n_layers=depth))
    gen = Generator(sapi, dict(params, layers=params["layers"][:depth]),
                    device=sm.device)
    trace = sched_trace(api.cfg.vocab)
    alone = [gen.generate(p[None], n)[0] for p, n in trace]
    _, wall, st = run_scheduler(sm, gen, trace, alone,
                                f"{label} first {depth} layers")
    sm.check_phase(f"13 {label}: GenerateScheduler tickets vs requests "
                   f"served alone")
    del gen
    return wall


def p13_cli(sm, arch):
    """``launch.serve.main`` once for the arch at full width, its trace and
    metrics through the port's validators."""
    import json
    import tempfile
    from repro_torch.launch import serve as launch
    from repro_torch.runtime import telemetry as tele
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        trace, prom = Path(d) / "trace.json", Path(d) / "metrics.prom"
        t0 = time.perf_counter()
        rc = launch.main(["--arch", arch, "--batch", "2", "--prompt-len",
                          "64", "--new-tokens", "4", "--trace", str(trace),
                          "--metrics-dump", str(prom)])
        release(sm)
        problems = (tele.validate_chrome_trace(json.loads(
            trace.read_text())) + tele.validate_metrics_text(
                prom.read_text()))
    log(f"[cli] launch.serve {arch}: rc {rc} in "
        f"{time.perf_counter() - t0:.2f} s; trace and metrics problems: "
        f"{problems or 'none'}")
    if rc != 0 or problems:
        raise SystemExit(f"launch.serve {arch}: rc {rc}, {problems}")


def p13_split(sm, api, b, s, n_new):
    """K1's time in one prefill and one decode step (each distinct call
    timed alone, times its count) and K3's in one prefill (the layer's call
    timed alone, times the attention layers)."""
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.kernels.mpmm import kernel
    t = sm.torch
    cache, out = {}, {}
    for step in ("prefill", "decode"):
        total = 0.0
        for call in p13_k1_calls(api, b, s, step):
            key = call[1:]
            if key not in cache:
                d, kw = k1_operands(sm, *key)
                cache[key] = sm.time_ms(lambda: kernel.mpmm_cuda(**d, **kw),
                                        reps=5, warmup=2)
                del d
            total += cache[key]
        out[step] = total
    cfg = api.cfg
    out["flash"] = 0.0
    if getattr(cfg, "attn_impl", "xla") == "flash":
        g = t.Generator(device=sm.device).manual_seed(520)
        mk = lambda h: t.randn((b, s, h, cfg.hd), generator=g,  # noqa: E731
                               device=sm.device).to(t.bfloat16)
        q, k, v = mk(cfg.n_heads), mk(cfg.n_kv), mk(cfg.n_kv)
        out["flash"] = cfg.n_super * sm.time_ms(
            lambda: fops.flash_attention(q, k, v, window=cfg.window,
                                         block_k=cfg.attn_chunk,
                                         impl="cuda"), reps=5)
    return out


def p13_arch(sm, arch, shape):
    """One arch at full width and depth: drawn and packed layer by layer,
    its Generator run counted against ``gemm_workload``, the prefill layer
    by layer and every decode step against the plain versions, R6
    (mamba2), the scheduler (mamba2, recurrentgemma), the timing."""
    import numpy as np
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.runtime.serve import Generator, init_packed_lm
    t = sm.torch
    b, s, n_new = shape
    api = family_api(arch)
    cfg = api.cfg
    t0 = time.perf_counter()
    params = init_packed_lm(api, t.Generator(device=sm.device).manual_seed(
        SEED), device=sm.device)
    t.cuda.synchronize()
    log(f"[p13] {arch}: {cfg}; default policy; drawn and packed layer by "
        f"layer in {time.perf_counter() - t0:.2f} s, "
        f"{t.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (b, s))
    frames_np = frames = None
    if api.needs_frames:  # stub frame embeddings, drawn from the seed
        frames_np = rng.normal(0, 1, (b, cfg.n_audio, cfg.d_model)).astype(
            np.float32)
        frames = t.as_tensor(frames_np, device=sm.device)
    gen = Generator(api, params, device=sm.device)
    plain = Generator(api, params, device=sm.device, impl="torch")
    reset_counts()
    t0 = time.perf_counter()
    toks, logits = gen.run(prompts, n_new, frames=frames_np)
    t.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    routes = {k: v for k, v in kernel.mpmm_cuda.routes.items() if v}
    want_routes, k3 = p13_expected(api, b, s, n_new)
    want = {"mpmm_cuda": sum(want_routes.values()), "conv_mpmm_cuda": 0,
            "flash_fwd_cuda": k3, "flash_fwd_packed_cuda": 0}
    log(f"[p13] {arch}: {b} prompts x {s} tokens, {n_new} new tokens in "
        f"{wall:.2f} s; launches {launches}; K1 routes {routes}")
    if launches != want or routes != want_routes:
        raise SystemExit(f"{arch}: launches {launches} / routes {routes} != "
                         f"{want} / {want_routes} (gemm_workload)")
    for step, a in enumerate(logits):
        a = a.float()
        if a.shape != (b, cfg.vocab) or not bool(t.isfinite(a).all()) \
                or float(a.std()) == 0.0:
            raise SystemExit(f"{arch} step {step}: logits {tuple(a.shape)} "
                             f"not finite or constant")
    pc = p13_prefill_contract(sm, api, params, prompts, frames, arch)
    decode_contract(sm, gen, plain, prompts, toks, arch, frames=frames)
    log(f"[p13] {arch}: tokens[0] {toks[0].tolist()}; prefill one-layer "
        f"error <= {pc[0]:.5f} of the largest |output|, <= {pc[1]:.5f} of "
        f"outputs differ (tol {LM_LOGIT_TOL}, {LM_MAX_FLIP_RATE}); the head "
        f"bitwise; {n_new - 1} decode steps bitwise equal")
    del gen, plain
    r6 = p13_r6(sm, api, params, prompts) if arch == "mamba2-1.3b" else None
    sched_wall = None
    if arch in P13_SCHED_DEPTH:
        sched_wall = p13_scheduler(sm, api, params, P13_SCHED_DEPTH[arch],
                                   arch)
    prefill_ms, decode_ms = measure_lm_end_to_end(sm, api, params, prompts,
                                                  n_new, frames=frames)
    split = p13_split(sm, api, b, s, n_new)
    rows = [measure_d256(sm, api, b, s)] if arch == "recurrentgemma-9b" \
        else []
    counts = dict(launches, **{f"route:{k}": v for k, v in routes.items()})
    del params, frames
    release(sm)
    p13_cli(sm, arch)
    return {"arch": arch, "shape": shape, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "split": split, "rows": rows,
            "counts": counts, "r6": r6, "sched_wall": sched_wall,
            "contract": pc}


def print_p13(p13, card):
    """Phase 13's ``[p13-time]`` lines."""
    for res in p13:
        b, s_, n_new = res["shape"]
        sp = res["split"]
        pf_ms, dc_ms = res["prefill_ms"], res["decode_ms"]
        log(f"[p13-time] {res['arch']}: prefill {pf_ms:.2f} ms = "
            f"{b * s_ / pf_ms * 1e3:.1f} tokens/s ({b} x {s_}); decode "
            f"{dc_ms:.2f} ms per step = {b / dc_ms * 1e3:.1f} tokens/s at "
            f"batch {b}  ({card})")
        rest = pf_ms - sp["prefill"] - sp["flash"]
        log(f"[p13-time] {res['arch']} split (each kernel's calls timed "
            f"alone): prefill K1 {sp['prefill']:.2f} ms "
            f"({sp['prefill'] / pf_ms:.1%}), K3 {sp['flash']:.2f} ms "
            f"({sp['flash'] / pf_ms:.1%}), rest {rest:.2f} ms "
            f"({rest / pf_ms:.1%}); decode step K1 {sp['decode']:.2f} ms "
            f"({sp['decode'] / dc_ms:.1%}), rest "
            f"{dc_ms - sp['decode']:.2f} ms ({1 - sp['decode'] / dc_ms:.1%})")
        for r in res["rows"]:
            log(f"[p13-time] {r['kernel']} {r['layer']} {r['shape']}: kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms ({r['library']}; kernel/library "
                f"{r['ms'] / r['library_ms']:.2f}x), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{r['bound_ms'] / r['ms']:.1%} of it), x{r['count']}; "
                f"{r['tiles']}  ({card})")


def phase_p13(sm, card):
    """Phase 13 -> (summed launches of its main-path runs, results).  Each
    arch's Generator run is counted from zero."""
    t0 = time.perf_counter()
    release(sm)
    results = []
    for arch, shape in P13_RUNS:
        t1 = time.perf_counter()
        results.append(p13_arch(sm, arch, shape))
        log(f"[p13] {arch} took {time.perf_counter() - t1:.1f} s")
    results[0]["rows"] = measure_p13_k1(sm) + results[0]["rows"]
    launches = {}
    for res in results:
        launches = add_counts(launches, res["counts"])
    log(f"[p13] phase 13 took {time.perf_counter() - t0:.1f} s")
    return launches, results


# --- phase 14: QAT training --------------------------------------------------


P14_CNN_BATCH, P14_CNN_STEPS = 32, 4
P14_CPU_BATCH = 2         # images of the card-vs-CPU step
P14_CALIB = 8             # BN calibration batches of P14_CNN_BATCH images
P14_SERVE_IMAGES = 8
P14_LM_DEPTH = 2
P14_LM_BATCH, P14_LM_SEQ, P14_LM_MB = 4, 1024, 2
P14_LM_STEPS, P14_CKPT_EVERY = 6, 3
P14_LR = 1e-3
P14_SERVE = (2, 256, 8)   # granite: prompts, prompt length, new tokens
# Gradients are held leaf by leaf (tests/test_torch_resnet_step.py holds
# the same leaves against the reference op by op on the CPU):
# * the card's ResNet-18 step against the CPU's on the same params and
#   batch-2 slice: both add the same bf16 products in another order, and a
#   flipped 8-bit code moves every gradient behind it, so at full width a
#   sound run differs from the CPU by up to 0.643 of a leaf's L2 norm (BN
#   bias of s0b1; median 0.50; PERF.md).  The limit 0.8 passes that and
#   fails a planted fault that the smoke computes every run: the CPU's
#   gradient of the first image alone, over the limit on 55 of 61 leaves
#   (worst 1.47).  A leaf zeroed or doubled gives 1.0.
# * one microbatch against two (granite-8b): the same products, summed in
#   another order: 0.0020 of the worst leaf; a missing 1/mb gives 1.0.
# A step size's gradient (``gw``/``ga``) is a sum of nearly cancelling
# terms, on the card and the CPU of opposite signs at times (6.2x the
# CPU's value at worst): it is held to being finite, and a weight step
# ``gw`` (f32 terms) to being nonzero exactly where the other side's is.
P14_LOSS_RTOL = 2e-2
P14_LEAF_RELL2_MAX = 0.8       # card vs CPU, ResNet-18, each weight leaf
P14_MB_LEAF_RELL2_MAX = 0.02   # one microbatch vs two, granite, each leaf
P14_QAT_CORR = {"resnet": 0.85, "granite": 0.95}  # the reference's tests
STEP_SIZES = ("['ga']", "['gw']")


def p14_step_grads(api, state, batch):
    """One ``make_train_step`` from ``state`` with its moments zeroed ->
    (metrics as floats, the gradient the step took).  From zero moments
    AdamW's first moment is (1 - B1) times the clipped gradient, so the
    gradient is read back from the new state: m / ((1 - B1) * clip), clip
    = min(1, 1 / grad_norm)."""
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import B1
    from repro_torch.tree import tree_map
    fresh = dict(state, opt=adamw_init(state["params"],
                                       state_dtype=api.opt_dtype))
    new, m = S.make_train_step(api, peak_lr=P14_LR)(fresh, batch)
    m = {k: float(v) for k, v in m.items()}
    clip = min(1.0, 1.0 / (m["grad_norm"] + 1e-12))
    return m, tree_map(lambda x: x.float() / ((1 - B1) * clip),
                       new["opt"]["m"])


def leaf_errors(sm, got, want):
    """{path: (relative L2 error of ``got``'s leaf against ``want``'s, the
    two leaves' L2 norms)}, in float64 on the card."""
    from repro_torch.tree import flatten_with_paths
    t = sm.torch
    w = flatten_with_paths(want)
    out = {}
    for path, a in flatten_with_paths(got).items():
        a = a.detach().to(sm.device, t.float64)
        b = w[path].detach().to(sm.device, t.float64)
        nb = float(b.norm())
        out[path] = (float((a - b).norm()) / max(nb, 1e-300),
                     float(a.norm()), nb)
    return out


def leaf_gate(errs, limit):
    """-> (the leaves that fail, the worst weight leaf as (error, path)).
    Every leaf must be finite; a weight, BN or fc leaf within ``limit`` of
    its L2 norm; a leaf but an activation step ``ga`` zero on one side
    only fails (a ``ga`` gradient is a bf16 sum of nearly cancelling terms
    and rounds to exactly zero at times)."""
    import math
    bad = [p for p, (rel, na, nb) in errs.items()
           if not (math.isfinite(na) and math.isfinite(nb))
           or (not p.endswith("['ga']") and (na == 0) != (nb == 0))
           or (not p.endswith(STEP_SIZES) and not rel <= limit)]
    worst = max((rel, p) for p, (rel, _, _) in errs.items()
                if not p.endswith(STEP_SIZES))
    return bad, worst


def corr(a, b):
    import numpy as np
    return float(np.corrcoef(np.asarray(a, np.float64).ravel(),
                             np.asarray(b, np.float64).ravel())[0, 1])


def p14_split(sm, api, state, batch, rows, gemms=None, adamw=True):
    """Where a step's time goes, CUDA events around each part alone: one
    microbatch's forward and backward (``value_and_grad``), the bf16
    products inside it (every projection's forward product and its two
    backward products at ``rows`` rows, from ``gemm_workload``, or the
    given ``gemms`` [(M, K, N, groups, count)], a group a batched
    product), the weights' fake-quant (one forward pass over every
    quantized weight, in f32, an expert bank's experts each with its own
    step) and the AdamW update -> {part: ms}."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.core import quant
    from repro_torch.launch import steps as S
    from repro_torch.nn import quantized as Q
    from repro_torch.optim import adamw_update
    t = sm.torch
    out = {}
    loss_fn = lambda p, x, y, f: S.cross_entropy(  # noqa: E731
        api.forward(p, x, mode="train",
                    **({"frames": f} if api.needs_frames else {})), y)
    with S.deterministic(sm.device):  # as the step runs it
        out["fwd_bwd"] = sm.time_ms(lambda: S.value_and_grad(
            loss_fn, state["params"], batch["tokens"], batch["labels"],
            batch.get("frames")), reps=2, warmup=1)
    total = 0.0
    if gemms is None:
        gemms = [(g.m, g.k, g.n, 1, g.count)
                 for g in api.gemm_workload(rows)]
    for m, k, n, groups, count in gemms:
        a = t.randn((groups, m, k), device=sm.device).to(t.bfloat16)
        w = t.randn((groups, k, n), device=sm.device).to(t.bfloat16)
        dy = t.randn((groups, m, n), device=sm.device).to(t.bfloat16)
        if groups == 1:
            a, w, dy = a[0], w[0], dy[0]
        total += count * sm.time_ms(
            lambda: (a @ w, dy @ w.mT, a.mT @ dy), reps=3, warmup=1)
        del a, w, dy
    out["products"] = total
    specs = api.specs("train")

    def weights(p, sp):
        if Q.is_qlinear(sp):
            pol = plan_lib.resolve_policy(api.policy, Q._layer_name_of(sp))
            lead = p["w"].ndim - 2
            yield p["w"], p["gw"], lead, quant.weight_spec(
                pol.bits_for(Q._layer_class_of(sp)),
                channel_axis=-1 if p["gw"].ndim > lead and pol.channel_wise
                else None)
        elif isinstance(sp, dict):
            for k in sp:
                if k in p:
                    yield from weights(p[k], sp[k])
        elif isinstance(sp, list):
            for pi, si in zip(p, sp):
                yield from weights(pi, si)
    wq = list(weights(state["params"], specs))

    def fake_quant_all():
        with t.no_grad():
            for w, gw, lead, spec in wq:
                quant.fake_quant(w, gw, spec, lead=lead)
    out["weight_fake_quant"] = sm.time_ms(fake_quant_all, reps=3, warmup=1)
    if not adamw:  # the caller times it
        return out
    grads = {"g": state["params"]}  # any tree of the parameters' shapes
    out["adamw"] = sm.time_ms(lambda: adamw_update(
        grads["g"], state["opt"], state["params"], lr=1e-4), reps=2,
        warmup=1)
    return out


def p14_resnet(sm):
    """(a) ResNet-18 QAT at full width under resnet18_mixed.json: four
    steps at batch 32, one step against the CPU's, BN calibration, pack,
    serve through K1/K2 and hold the served logits to the QAT eval
    forward."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.device import tree_to
    from repro_torch.launch import steps as S
    from repro_torch.models import resnet as R
    from repro_torch.runtime.serve import ImageServer
    t = sm.torch
    plan = PrecisionPlan.load(PLAN)
    api = configs.get(ARCH, policy=plan)
    cfg = api.cfg
    release(sm)
    t.cuda.reset_peak_memory_stats()
    state = S.init_train_state(api, t.Generator(device=sm.device).manual_seed(
        SEED), device=sm.device)
    pipe = SyntheticImages(n_classes=cfg.n_classes, img_size=cfg.img_size,
                           global_batch=P14_CNN_BATCH, seed=SEED)

    def batch(i, n=None, dev=sm.device):
        b = pipe.batch_at(i)
        return {"tokens": t.as_tensor(b["images"][:n], device=dev),
                "labels": t.as_tensor(b["labels"][:n], device=dev).long()}
    step = S.make_train_step(api, peak_lr=P14_LR)
    times, losses = [], []
    for i in range(P14_CNN_STEPS):
        b = batch(i)
        t.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        m = {k: float(v) for k, v in m.items()}
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        log(f"[p14] resnet18 step {i}: loss {m['loss']:.4f}, grad_norm "
            f"{m['grad_norm']:.4f}, lr {m['lr']:.3e}, {times[-1] * 1e3:.1f} "
            f"ms")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            sm.failures.append(f"resnet18 step {i}: {m}")
    peak_train = t.cuda.max_memory_allocated()
    sm.check_phase("14 (a) resnet18 QAT steps at batch 32")
    split = p14_split(sm, api, state, batch(0), P14_CNN_BATCH)

    # the card's gradients against the port's CPU ones on the same inputs,
    # and against a planted fault the gate must reject
    params = state["params"]
    loss_fn = lambda p, x, y, f: S.cross_entropy(  # noqa: E731
        api.forward(p, x, mode="train"), y)
    bc = batch(P14_CNN_STEPS, n=P14_CPU_BATCH)
    lc, gc = S.value_and_grad(loss_fn, params, bc["tokens"], bc["labels"],
                              None)
    cpu_params = tree_to(params, t.device("cpu"))

    def cpu_grads(n):
        b = batch(P14_CNN_STEPS, n=n, dev="cpu")
        return S.value_and_grad(loss_fn, cpu_params, b["tokens"],
                                b["labels"], None)
    t0 = time.perf_counter()
    lh, gh = cpu_grads(P14_CPU_BATCH)
    cpu_s = time.perf_counter() - t0
    errs = leaf_errors(sm, gc, gh)
    bad, worst = leaf_gate(errs, P14_LEAF_RELL2_MAX)
    fault_bad, fault_worst = leaf_gate(
        leaf_errors(sm, gc, cpu_grads(P14_CPU_BATCH // 2)[1]),
        P14_LEAF_RELL2_MAX)
    rels = sorted(rel for p, (rel, _, _) in errs.items()
                  if not p.endswith(STEP_SIZES))
    dl = abs(float(lc) - float(lh)) / abs(float(lh))
    log(f"[p14] resnet18 card vs CPU gradients (batch {P14_CPU_BATCH}; CPU "
        f"{cpu_s:.1f} s): loss {float(lc):.6f} vs {float(lh):.6f} (rel "
        f"{dl:.2e}, tol {P14_LOSS_RTOL}); {len(rels)} weight leaves, "
        f"relative L2 worst {worst[1]} {worst[0]:.4f}, median "
        f"{rels[len(rels) // 2]:.4f} (limit {P14_LEAF_RELL2_MAX}); leaves "
        f"failing {bad or 'none'}; planted fault (the CPU's gradient of "
        f"the first image alone): {len(fault_bad)} leaves over the limit, "
        f"worst {fault_worst[1]} {fault_worst[0]:.4f}")
    if dl > P14_LOSS_RTOL or bad or not fault_bad:
        sm.failures.append(f"resnet18 card vs CPU: loss rel {dl}, leaves "
                           f"failing {bad}, planted fault caught on "
                           f"{len(fault_bad)} leaves")
    del gc, gh, cpu_params
    sm.check_phase("14 (a) resnet18 card gradients vs the CPU's")

    # BN calibration, pack, serve through the kernels, vs the QAT forward
    bn = R.init_bn_state(api.specs(), device=sm.device)
    with t.no_grad():
        for i in range(P14_CALIB):
            _, bn = R.apply_with_state(cfg, params, bn,
                                       batch(1000 + i)["tokens"], plan,
                                       training=True)
        packed = R.pack_for_serve(cfg, params, bn, plan)
        x = pipe.batch_at(2000)["images"][:P14_SERVE_IMAGES]
        server = ImageServer(api=api, params=packed, plan=plan,
                             batch_buckets=(P14_SERVE_IMAGES,),
                             device=sm.device)
        server.predict(x)  # warm
        reset_counts()
        t.cuda.synchronize()
        t0 = time.perf_counter()
        served = server.predict(x)
        t.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_p11()
        qat, _ = R.apply_with_state(cfg, params, bn,
                                    t.as_tensor(x, device=sm.device), plan,
                                    training=False)
    want, _, _ = resnet_launches(cfg, plan, P14_SERVE_IMAGES)
    got = {k: counts[k] for k in want}
    c = corr(qat.float().cpu(), np.asarray(served))
    log(f"[p14] resnet18 served {P14_SERVE_IMAGES} images from the trained "
        f"weights in {serve_s * 1e3:.2f} ms: launches {got} (want {want}); "
        f"served vs QAT eval forward correlation {c:.4f} (min "
        f"{P14_QAT_CORR['resnet']})")
    if got != want or not c > P14_QAT_CORR["resnet"]:
        sm.failures.append(f"resnet18 serve: launches {got} vs {want}, "
                           f"correlation {c}")
    sm.check_phase("14 (a) resnet18 trained weights through K1/K2")
    peak = t.cuda.max_memory_allocated()
    del server, packed, params, state, bn
    release(sm)
    steady = times[1:]
    return {"step_ms": 1e3 * sum(steady) / len(steady),
            "first_ms": 1e3 * times[0], "peak_train": peak_train,
            "peak": peak, "losses": losses, "counts": counts,
            "cpu_s": cpu_s, "split": split}


_SHM_RUN = []  # this run's own folder under /dev/shm, once one is made


def ckpt_root(name, need_bytes):
    """Where a phase writes its checkpoints: under this run's own folder in
    ``/dev/shm`` (``tempfile.mkdtemp``, so two runs on one host never
    share one) when that file system has room for one with a margin and
    the host memory stays above what the phase keeps there, else under
    ``build/`` in the checkout.  The choice is logged; the caller removes
    the directory, and ``main`` removes the run's folder when it ends."""
    import shutil
    import tempfile
    shm = Path("/dev/shm")
    free = avail = 0
    if shm.is_dir():
        st = os.statvfs(shm)
        free = st.f_bavail * st.f_frsize
        try:
            with open("/proc/meminfo") as f:
                avail = next(int(line.split()[1]) * 1024 for line in f
                             if line.startswith("MemAvailable:"))
        except (OSError, StopIteration):
            avail = 0
    # the file itself, the host copy of the uninterrupted state phase 16
    # keeps while it restores, and room to spare
    if free > 1.2 * need_bytes and avail > 2.5 * need_bytes:
        if not _SHM_RUN:
            _SHM_RUN.append(Path(tempfile.mkdtemp(prefix="repro_chip_smoke.",
                                                  dir=shm)))
        root = _SHM_RUN[0] / name
    else:
        root = ROOT / "build" / name
        shutil.rmtree(root, ignore_errors=True)
    log(f"[ckpt] {name}: a {need_bytes / 1e9:.1f} GB state; /dev/shm free "
        f"{free / 1e9:.1f} GB, host memory available {avail / 1e9:.1f} GB "
        f"-> checkpoints under {root}")
    return root


def remove_shm_run():
    """Remove this run's folder under ``/dev/shm``, if it made one."""
    import shutil
    while _SHM_RUN:
        shutil.rmtree(_SHM_RUN.pop(), ignore_errors=True)


def save_only_at(tr, steps):
    """Make a ``Trainer`` checkpoint at ``steps`` and nowhere else: the
    restart checks compare final states in memory, so every other
    checkpoint would be written and read by nothing."""
    save = tr._save
    tr._save = lambda step, state, blocking: (
        save(step, state, blocking) if step in steps else None)
    return tr


def p14_granite(sm):
    """(b) granite-8b at full width, first 2 layers: the Trainer for six
    steps, a restart from a step-3 checkpoint bitwise equal to the
    uninterrupted run, one microbatch against two, a step under a packed
    kv4 cache, then pack and serve the trained weights through K1 and
    K4."""
    import shutil
    import numpy as np
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.serve import Generator, pack_for_serving
    from repro_torch.runtime.train import TrainLoopConfig, Trainer
    from repro_torch.tree import leaves
    t = sm.torch
    api = dataclasses.replace(family_api(LM_ARCH, depth=P14_LM_DEPTH),
                              microbatches=P14_LM_MB)
    cfg = api.cfg
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=P14_LM_SEQ,
                       global_batch=P14_LM_BATCH, seed=SEED)
    root = ckpt_root("p14", api.total_params() * 12)

    def trainer():
        """A Trainer of P14_LM_STEPS steps that checkpoints at step
        P14_CKPT_EVERY and at no other, in the background (the Trainer's
        default): the donated steps that follow update the state in
        place while the checkpoint is written."""
        return save_only_at(Trainer(api, pipe, TrainLoopConfig(
            total_steps=P14_LM_STEPS, ckpt_every=P14_CKPT_EVERY,
            ckpt_dir=str(root), log_every=1, async_ckpt=True,
            peak_lr=P14_LR), device=sm.device), (P14_CKPT_EVERY,))

    def gen():
        return t.Generator(device=sm.device).manual_seed(SEED)
    release(sm)
    t.cuda.reset_peak_memory_stats()
    # the uninterrupted run, which leaves the checkpoint of its step 3
    full = trainer()
    s_full, h_full = full.run(gen())
    peak_train = t.cuda.max_memory_allocated()
    save_s = full.save_seconds
    log(f"[p14] granite-8b x{P14_LM_DEPTH} uninterrupted: losses "
        f"{[round(v, 4) for v in h_full]}, steps (s) "
        f"{[round(v, 3) for v in full.step_seconds]}")
    ab2 = trainer()  # restores step 3, runs steps 3-5
    s_ab, h_ab = ab2.run(gen())
    same = (h_ab == h_full[P14_CKPT_EVERY:] and all(
        t.equal(a, b) for a, b in zip(leaves(s_full), leaves(s_ab))))
    restore_s = ab2.restore_seconds
    log(f"[p14] restart from step {P14_CKPT_EVERY} (save (asynchronous: "
        f"the host copy) {[round(v, 2) for v in save_s]} s, restore "
        f"{restore_s:.2f} s): losses {[round(v, 4) for v in h_ab]};"
        f" parameters, moments and losses bitwise the uninterrupted run's: "
        f"{same}")
    if not same:
        sm.failures.append("granite-8b restart is not bitwise the "
                           "uninterrupted run")
    del s_ab, ab2
    release(sm)
    sm.check_phase("14 (b) granite-8b Trainer: restart bitwise")

    host = pipe.batch_at(P14_LM_STEPS)
    b = {k: t.as_tensor(v, device=sm.device).long() for k, v in host.items()}
    half = {k: v[:P14_LM_BATCH // P14_LM_MB] for k, v in b.items()}
    split = p14_split(sm, api, s_full, half,
                      P14_LM_BATCH // P14_LM_MB * P14_LM_SEQ)
    release(sm)
    m2, g2 = p14_step_grads(api, s_full, b)
    release(sm)
    m1, g1 = p14_step_grads(dataclasses.replace(api, microbatches=1),
                            s_full, b)
    bad, worst = leaf_gate(leaf_errors(sm, g1, g2), P14_MB_LEAF_RELL2_MAX)
    dl = abs(m1["loss"] - m2["loss"]) / abs(m2["loss"])
    log(f"[p14] one microbatch vs {P14_LM_MB}: loss {m1['loss']:.6f} vs "
        f"{m2['loss']:.6f} (rel {dl:.2e}); gradients' relative L2, worst "
        f"leaf {worst[1]} {worst[0]:.4f} (limit {P14_MB_LEAF_RELL2_MAX}); "
        f"leaves failing {bad or 'none'}")
    if dl > P14_LOSS_RTOL or bad:
        sm.failures.append(f"microbatches: loss rel {dl}, leaves failing "
                           f"{bad}")
    del g1, g2
    release(sm)
    kv_api = dataclasses.replace(api, policy=with_kv4(api.policy))
    mk, _ = p14_step_grads(kv_api, s_full, b)
    log(f"[p14] one step under a packed kv4 cache: loss {mk['loss']:.6f} "
        f"(unquantized cache {m2['loss']:.6f}), grad_norm "
        f"{mk['grad_norm']:.4f}")
    if not (np.isfinite(mk["loss"]) and np.isfinite(mk["grad_norm"])) \
            or mk["loss"] == m2["loss"]:
        sm.failures.append(f"kv4 step: {mk} vs {m2}")
    release(sm)
    sm.check_phase("14 (b) granite-8b microbatches and the kv4 step")

    # pack the trained weights under w4k4 + a packed kv4 cache and serve
    nb, ns, n_new = P14_SERVE
    packed = pack_for_serving(kv_api, s_full["params"])
    gen_s = Generator(kv_api, packed, device=sm.device)
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (nb, ns))
    gen_s.run(prompts[:, :16], 2)  # warm
    reset_counts()
    t.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = gen_s.run(prompts, n_new)
    t.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = read_p11()
    want_routes, _, k4 = expected_counts(kv_api, nb, ns, n_new)
    got = (sum(want_routes.values()), k4)
    with t.no_grad():
        seq = t.as_tensor(np.concatenate([prompts, toks[:, :-1]], 1),
                          device=sm.device).long()
        qat = kv_api.forward(s_full["params"], seq, mode="train")
    served = np.stack([lg.float().cpu().numpy() for lg in logits], 1)
    c = corr(qat[:, ns - 1:].float().cpu(), served)
    log(f"[p14] granite-8b served {nb} x {ns} + {n_new} tokens from the "
        f"trained weights in {serve_s:.2f} s: launches K1 "
        f"{counts['mpmm_cuda']} (want {got[0]}), K4 "
        f"{counts['flash_fwd_packed_cuda']} (want {k4}); served vs QAT "
        f"forward correlation {c:.4f} (min {P14_QAT_CORR['granite']})")
    if (counts["mpmm_cuda"], counts["flash_fwd_packed_cuda"]) != got \
            or not c > P14_QAT_CORR["granite"]:
        sm.failures.append(f"granite serve: launches {counts} vs {got}, "
                           f"correlation {c}")
    sm.check_phase("14 (b) granite-8b trained weights through K1/K4")
    peak = t.cuda.max_memory_allocated()
    del gen_s, packed, s_full, qat
    release(sm)
    shutil.rmtree(root, ignore_errors=True)
    steps = full.step_seconds[1:]
    return {"step_ms": 1e3 * sum(steps) / len(steps),
            "first_ms": 1e3 * full.step_seconds[0],
            "save_s": save_s, "restore_s": restore_s,
            "peak_train": peak_train, "peak": peak, "losses": h_full,
            "counts": counts, "restart": same, "split": split}


def p14_cli(sm):
    """(c) ``launch.train`` then ``launch.serve --ckpt-dir`` as
    subprocesses, reduced granite-8b on the card."""
    import shutil
    d = ROOT / "build" / "p14" / "cli"
    shutil.rmtree(d, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for argv in ([ "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                   "--reduced", "--steps", "4", "--ckpt-dir", str(d)],
                 ["-m", "repro_torch.launch.serve", "--arch", LM_ARCH,
                  "--reduced", "--ckpt-dir", str(d)]):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *argv], capture_output=True,
                           text=True, timeout=600, env=env, cwd=ROOT)
        runs.append(r)
        log(f"[p14] python {' '.join(argv[:2])}: rc {r.returncode} in "
            f"{time.perf_counter() - t0:.1f} s; last line "
            f"{(r.stdout.strip().splitlines() or [''])[-1][:120]!r}")
        if r.returncode != 0:
            sm.failures.append(f"{argv[1]}: rc {r.returncode}\n"
                               f"{r.stderr[-2000:]}")
    if "restored params from" not in runs[1].stdout:
        sm.failures.append("launch.serve did not say it restored")
    shutil.rmtree(d.parent, ignore_errors=True)
    sm.check_phase("14 (c) launch.train then launch.serve --ckpt-dir")


def phase_p14(sm):
    """Phase 14 -> (summed launches of its serve runs, results)."""
    t0 = time.perf_counter()
    cnn = p14_resnet(sm)
    lm = p14_granite(sm)
    p14_cli(sm)
    log(f"[p14] phase 14 took {time.perf_counter() - t0:.1f} s")
    return add_counts(dict(cnn["counts"]), lm["counts"]), {"resnet": cnn,
                                                           "granite": lm}


def print_p14(p14, card):
    """Phase 14's ``[p14-time]`` lines."""
    c, g = p14["resnet"], p14["granite"]
    gib = 2 ** 30
    log(f"[p14-time] resnet18 QAT step (224x224, batch {P14_CNN_BATCH}, "
        f"resnet18_mixed.json): {c['step_ms']:.2f} ms (mean of steps 2-"
        f"{P14_CNN_STEPS}; first {c['first_ms']:.1f} ms) = "
        f"{P14_CNN_BATCH / c['step_ms'] * 1e3:.1f} images/s trained; peak "
        f"memory {c['peak_train'] / gib:.2f} GiB training, "
        f"{c['peak'] / gib:.2f} GiB with serving  ({card})")
    toks = P14_LM_BATCH * P14_LM_SEQ
    log(f"[p14-time] granite-8b x{P14_LM_DEPTH} QAT step (full width, batch "
        f"{P14_LM_BATCH} x {P14_LM_SEQ}, {P14_LM_MB} microbatches, remat "
        f"dots): {g['step_ms']:.2f} ms (mean of steps 2-{P14_LM_STEPS}; "
        f"first {g['first_ms']:.1f} ms) = {toks / g['step_ms'] * 1e3:.1f} "
        f"tokens/s trained; checkpoint save (the host copy; written in the "
        f"background) "
        f"{', '.join(f'{v * 1e3:.0f}' for v in g['save_s'])} ms, restore "
        f"{g['restore_s'] * 1e3:.0f} ms (10.1 GB); peak memory "
        f"{g['peak_train'] / gib:.2f} GiB training, {g['peak'] / gib:.2f} "
        f"GiB with the restart, microbatch and kv4 checks and serving  "
        f"({card})")
    for name, r, mb in (("resnet18", c, 1), ("granite-8b", g, P14_LM_MB)):
        sp = r["split"]
        log(f"[p14-time] {name} step split (each part alone, CUDA events): "
            f"{mb} x forward+backward {mb * sp['fwd_bwd']:.2f} ms, of which "
            f"the projections' bf16 products {mb * sp['products']:.2f} ms; "
            f"one fake-quant pass over the weights "
            f"{sp['weight_fake_quant']:.2f} ms; AdamW "
            f"{sp['adamw']:.2f} ms; the step {r['step_ms']:.2f} ms  ({card})")


# --- phase 15: QAT training of the MoE and MLA archs -----------------------


P15_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
P15_DEPTH = 2             # olmoe: two MoE layers; deepseek: dense 0, MoE 1
P15_BATCH, P15_SEQ, P15_MB = 4, 1024, 2
P15_STEPS, P15_CKPT_EVERY = 3, 2
P15_SERVE = (2, 256, 8)   # prompts, prompt length, new tokens
P15_CLI_ARCH = "olmoe-1b-7b"
# as phase 14 holds granite: one microbatch against two, each gradient
# leaf within 0.02 of its L2 norm; the served logits against the QAT
# forward above 0.95 (the reference's test_packed_serve_tracks_qat_logits)
P15_MB_LEAF_RELL2_MAX = 0.02
P15_QAT_CORR = 0.95


def p15_gemms(api, b, s):
    """The bf16 products of one train forward of ``b`` x ``s`` tokens as
    [(M, K, N, groups, count)]: each projection at b * s rows, an expert
    bank as one batched product over its E experts at b x capacity rows
    an expert (``k1_calls``' serve shapes, the head at every token)."""
    from collections import Counter
    from repro_torch.nn.layers import pad_vocab
    calls = Counter((m, kdim, n, groups) for name, m, kdim, n, groups, *_
                    in k1_calls(api, b, s, s, "prefill") if name != "head")
    out = [(m, k, n, g, c) for (m, k, n, g), c in calls.items()]
    return out + [(b * s, api.cfg.d_model, pad_vocab(api.cfg.vocab), 1, 1)]


def p15_routing_ms(sm, api, b, s):
    """One MoE block's routing alone, forward and backward, CUDA events:
    ``nn.moe.route``, ``dispatch`` and ``gate_and_combine`` as
    ``moe_apply(serve=False)`` runs them, with the bank left out (its
    output is the dispatched input) -> ms."""
    from repro_torch.launch import steps as S
    from repro_torch.nn import moe as M
    t = sm.torch
    mc = api.cfg.moe
    g = t.Generator(device=sm.device).manual_seed(SEED)
    x = t.randn((b, s, mc.d_model), generator=g, device=sm.device).to(
        t.bfloat16).requires_grad_(True)
    router = (t.randn((mc.d_model, mc.n_experts), generator=g,
                      device=sm.device) / mc.d_model ** 0.5
              ).requires_grad_(True)
    ct = t.randn((b, s, mc.d_model), generator=g, device=sm.device).to(
        t.bfloat16)

    def block():
        idx, vals, tok_idx = M.route(x, router, mc)
        h = M.dispatch(x, tok_idx, idx, serve=False)
        y = M.gate_and_combine(h, vals, tok_idx, idx, s,
                               serve=False).to(x.dtype)
        t.autograd.grad(y, (x, router), grad_outputs=ct)
    with S.deterministic(sm.device):
        return sm.time_ms(block, reps=3, warmup=1)


def p15_arch(sm, arch):
    """One arch at full width, first P15_DEPTH layers: the ``Trainer`` for
    P15_STEPS steps, a restart from step P15_CKPT_EVERY bitwise the
    uninterrupted run, one microbatch against two, then ``pack_for_serving``
    and ``Generator`` through K1 (and K3 for olmoe) against the QAT
    forward."""
    import math
    import shutil
    import numpy as np
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.nn.moe import capacity
    from repro_torch.runtime.serve import Generator, pack_for_serving
    from repro_torch.runtime.train import TrainLoopConfig, Trainer
    from repro_torch.tree import flatten_with_paths, leaves
    t = sm.torch
    api = dataclasses.replace(family_api(arch, depth=P15_DEPTH),
                              microbatches=P15_MB)
    cfg = api.cfg
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=P15_SEQ,
                       global_batch=P15_BATCH, seed=SEED)
    root = ckpt_root(f"p15/{arch}", api.total_params() * 12)

    def trainer():
        """A Trainer of P15_STEPS steps that checkpoints at step
        P15_CKPT_EVERY and at no other, in the background, as phase 14's
        does."""
        return save_only_at(Trainer(api, pipe, TrainLoopConfig(
            total_steps=P15_STEPS, ckpt_every=P15_CKPT_EVERY,
            ckpt_dir=str(root), log_every=1, async_ckpt=True,
            peak_lr=P14_LR), device=sm.device), (P15_CKPT_EVERY,))

    def gen():
        return t.Generator(device=sm.device).manual_seed(SEED)
    release(sm)
    t.cuda.reset_peak_memory_stats()
    # the uninterrupted run, which leaves the checkpoint of its step
    # P15_CKPT_EVERY
    full = trainer()
    s_full, h_full = full.run(gen())
    peak_train = t.cuda.max_memory_allocated()
    save_s = full.save_seconds
    n_params = sum(p.numel() for p in leaves(s_full["params"]))
    log(f"[p15] {arch} x{P15_DEPTH} ({n_params / 1e9:.3f} B parameters, "
        f"capacity {capacity(cfg.moe, P15_SEQ)} a row) uninterrupted: "
        f"losses {[round(v, 4) for v in h_full]}, steps (s) "
        f"{[round(v, 3) for v in full.step_seconds]}")
    if not all(math.isfinite(v) for v in h_full):
        sm.failures.append(f"{arch} losses {h_full}")
    ab2 = trainer()  # restores step P15_CKPT_EVERY, runs the rest
    s_ab, h_ab = ab2.run(gen())
    same = (h_ab == h_full[P15_CKPT_EVERY:] and all(
        t.equal(a, b) for a, b in zip(leaves(s_full), leaves(s_ab))))
    restore_s = ab2.restore_seconds
    log(f"[p15] {arch} restart from step {P15_CKPT_EVERY} (save "
        f"(asynchronous: the host copy) {[round(v, 2) for v in save_s]} s, "
        f"restore "
        f"{restore_s:.2f} s): losses {[round(v, 4) for v in h_ab]}; "
        f"parameters, moments and losses bitwise the uninterrupted run's: "
        f"{same}")
    if not same:
        sm.failures.append(f"{arch} restart is not bitwise the "
                           f"uninterrupted run")
    del s_ab, ab2
    release(sm)
    shutil.rmtree(root, ignore_errors=True)
    sm.check_phase(f"15 {arch} Trainer: restart bitwise")

    host = pipe.batch_at(P15_STEPS)
    b = {k: t.as_tensor(v, device=sm.device).long() for k, v in host.items()}
    mb_rows = P15_BATCH // P15_MB
    half = {k: v[:mb_rows] for k, v in b.items()}
    split = p14_split(sm, api, s_full, half, mb_rows * P15_SEQ,
                      gemms=p15_gemms(api, mb_rows, P15_SEQ))
    split["routing"] = p15_routing_ms(sm, api, mb_rows, P15_SEQ)
    release(sm)
    m2, g2 = p14_step_grads(api, s_full, b)
    release(sm)
    m1, g1 = p14_step_grads(dataclasses.replace(api, microbatches=1),
                            s_full, b)
    bad, worst = leaf_gate(leaf_errors(sm, g1, g2), P15_MB_LEAF_RELL2_MAX)
    flat = flatten_with_paths(g2)
    routers = {p: float(v.abs().max()) for p, v in flat.items()
               if p.endswith("['router']")}
    finite = all(bool(t.isfinite(v).all()) for v in flat.values())
    dl = abs(m1["loss"] - m2["loss"]) / abs(m2["loss"])
    log(f"[p15] {arch} one microbatch vs {P15_MB}: loss {m1['loss']:.6f} vs "
        f"{m2['loss']:.6f} (rel {dl:.2e}); gradients' relative L2, worst "
        f"leaf {worst[1]} {worst[0]:.4f} (limit {P15_MB_LEAF_RELL2_MAX}); "
        f"leaves failing {bad or 'none'}; {len(flat)} gradient leaves all "
        f"finite: {finite}; router gradients' largest |value| {routers}")
    if dl > P14_LOSS_RTOL or bad or not finite or not routers \
            or not all(v > 0 for v in routers.values()):
        sm.failures.append(f"{arch} microbatches/gradients: loss rel {dl}, "
                           f"leaves failing {bad}, finite {finite}, "
                           f"routers {routers}")
    del g1, g2, flat
    release(sm)
    sm.check_phase(f"15 {arch} microbatches and gradients")

    # pack the trained weights under the arch's default policy and serve
    nb, ns, n_new = P15_SERVE
    packed = pack_for_serving(api, s_full["params"])
    gen_s = Generator(api, packed, device=sm.device)
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (nb, ns))
    gen_s.run(prompts[:, :16], 2)  # warm
    reset_counts()
    t.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = gen_s.run(prompts, n_new)
    t.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = read_p11()
    want_routes, k3, k4 = expected_counts(api, nb, ns, n_new)
    want = {"mpmm_cuda": sum(want_routes.values()), "flash_fwd_cuda": k3,
            "flash_fwd_packed_cuda": k4}
    got = {k: counts[k] for k in want}
    with t.no_grad():
        seq = t.as_tensor(np.concatenate([prompts, toks[:, :-1]], 1),
                          device=sm.device).long()
        qat = api.forward(s_full["params"], seq, mode="train")
    served = np.stack([lg.float().cpu().numpy() for lg in logits], 1)
    c = corr(qat[:, ns - 1:].float().cpu(), served)
    log(f"[p15] {arch} served {nb} x {ns} + {n_new} tokens from the trained "
        f"weights in {serve_s:.2f} s: launches {got} (want {want}); served "
        f"vs QAT forward correlation {c:.4f} (min {P15_QAT_CORR})")
    if got != want or not c > P15_QAT_CORR:
        sm.failures.append(f"{arch} serve: launches {got} vs {want}, "
                           f"correlation {c}")
    sm.check_phase(f"15 {arch} trained weights through the kernels")
    peak = t.cuda.max_memory_allocated()
    del gen_s, packed, s_full, qat
    release(sm)
    steps = full.step_seconds[1:]
    return {"step_ms": 1e3 * sum(steps) / len(steps),
            "first_ms": 1e3 * full.step_seconds[0],
            "save_s": save_s, "restore_s": restore_s,
            "peak_train": peak_train, "peak": peak, "losses": h_full,
            "counts": counts, "restart": same, "split": split,
            "params": n_params, "corr": c,
            "moe_layers": cfg.n_layers - cfg.dense_first_n}


def p15_cli(sm):
    """``launch.train`` then ``launch.serve --ckpt-dir`` as subprocesses,
    reduced P15_CLI_ARCH on the card."""
    import shutil
    d = ROOT / "build" / "p15" / "cli"
    shutil.rmtree(d, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for argv in (["-m", "repro_torch.launch.train", "--arch", P15_CLI_ARCH,
                  "--reduced", "--steps", "2", "--ckpt-dir", str(d)],
                 ["-m", "repro_torch.launch.serve", "--arch", P15_CLI_ARCH,
                  "--reduced", "--ckpt-dir", str(d)]):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *argv], capture_output=True,
                           text=True, timeout=600, env=env, cwd=ROOT)
        runs.append(r)
        log(f"[p15] python {' '.join(argv[:4])}: rc {r.returncode} in "
            f"{time.perf_counter() - t0:.1f} s; last line "
            f"{(r.stdout.strip().splitlines() or [''])[-1][:120]!r}")
        if r.returncode != 0:
            sm.failures.append(f"{argv[1]}: rc {r.returncode}\n"
                               f"{r.stderr[-2000:]}")
    if "restored params from" not in runs[1].stdout:
        sm.failures.append("launch.serve did not say it restored")
    shutil.rmtree(d.parent, ignore_errors=True)
    sm.check_phase("15 launch.train then launch.serve --ckpt-dir")


def phase_p15(sm):
    """Phase 15 -> (summed launches of its serve runs, results)."""
    t0 = time.perf_counter()
    out, counts = {}, {}
    for arch in P15_ARCHS:
        out[arch] = p15_arch(sm, arch)
        counts = add_counts(counts, out[arch]["counts"])
    p15_cli(sm)
    log(f"[p15] phase 15 took {time.perf_counter() - t0:.1f} s")
    return counts, out


def print_p15(p15, card):
    """Phase 15's ``[p15-time]`` lines."""
    gib = 2 ** 30
    toks = P15_BATCH * P15_SEQ
    for arch, r in p15.items():
        sp = r["split"]
        saves = ", ".join(f"{v * 1e3:.0f}" for v in r["save_s"])
        log(f"[p15-time] {arch} x{P15_DEPTH} QAT step (full width, "
            f"{r['params'] / 1e9:.3f} B parameters, batch {P15_BATCH} x "
            f"{P15_SEQ}, {P15_MB} microbatches): {r['step_ms']:.2f} ms (mean "
            f"of steps 2-{P15_STEPS}; first {r['first_ms']:.1f} ms) = "
            f"{toks / r['step_ms'] * 1e3:.1f} tokens/s trained; checkpoint "
            f"save (the host copy; written in the background) {saves} ms, "
            f"restore {r['restore_s'] * 1e3:.0f} "
            f"ms; "
            f"max_memory_allocated {r['peak_train'] / gib:.2f} GiB training, "
            f"{r['peak'] / gib:.2f} GiB with the checks and serving  ({card})")
        log(f"[p15-time] {arch} step split (each part alone, CUDA events): "
            f"{P15_MB} x forward+backward {P15_MB * sp['fwd_bwd']:.2f} ms, of "
            f"which the bf16 products {P15_MB * sp['products']:.2f} ms and "
            f"the MoE routing (router, top-k, dispatch, gating, combine) "
            f"{P15_MB * sp['routing'] * r['moe_layers']:.2f} "
            f"ms; one fake-quant pass over the weights "
            f"{sp['weight_fake_quant']:.2f} ms; AdamW {sp['adamw']:.2f} ms; "
            f"the step {r['step_ms']:.2f} ms  ({card})")


# --- phase 16: QAT training of mamba2, recurrentgemma and whisper ----------


# arch -> (depth (None: all layers), batch, tokens); mamba2's 1000 tokens
# are not a multiple of its 256-token chunk (the pad path trains), rg's
# 2560 pass its 2048 window
P16_RUNS = (("mamba2-1.3b", None, 4, 1000),
            ("recurrentgemma-9b", 3, 2, 2560),
            ("whisper-base", None, 4, 64))
P16_MB = 2
P16_STEPS, P16_CKPT_EVERY = 3, 2
# mamba2's restart leg runs its first 4 layers at full width: its 48
# layers' 17.3 GB checkpoint took about 36 s to write and read, and the
# uninterrupted state held on the host for the comparison about 35 s
# more (H100 80GB HBM3).  The other two restart at their phase's depth
# (recurrentgemma's state is mostly its embedding and head).
P16_RESTART_DEPTH = {"mamba2-1.3b": 4}
P16_DECODE = 8            # decode steps after the trained weights' prefill
# as phases 14-15: one microbatch against two, each gradient leaf within
# 0.02 of its L2 norm; the served forward against the QAT forward above
# 0.95.  The SSD and RG-LRU blocks' vjp on the card against the CPU's,
# each leaf but a step size within 1e-3 of its L2 norm (the same bf16
# products summed in another order).
P16_MB_LEAF_RELL2_MAX = 0.02
P16_QAT_CORR = 0.95
P16_VJP_RELL2_MAX = 1e-3
# The conv taps' and bias's gradients are bf16 sums over B x S, added one
# value at a time in the reference's windows of up to 2 x 32 or 4 x 32
# values (``nn.layers.xla_sum``): each add rounds to 8 bits, so a window's
# sum carries about 2% of its size in rounding, and a bias gradient is a
# sum of terms of both signs.  Another split of the rows (one microbatch
# against two) or an input one ulp off (the card's products against the
# CPU's) moves them by that much: mamba2 read 0.0241 and 1.66e-3 on an H100.
# They are held to these bounds, every other leaf to the two above.
P16_CONV = ("['conv']['w']", "['conv']['b']")
P16_CONV_MB_RELL2_MAX = 0.05
P16_CONV_VJP_RELL2_MAX = 5e-3
P16_VJP_ROWS = {"mamba2-1.3b": 512, "recurrentgemma-9b": 256}
# the served forward against the QAT forward end to end only up to this
# depth: a random stack drifts layer by layer (mamba2's 48 layers read
# 0.65 on the CPU while each layer alone reads 0.9993)
P16_E2E_MAX_DEPTH = 12
# gradients that must be nonzero: the recurrences' own parameters
P16_NONZERO = ("['A_log']", "['D']", "['dt_bias']", "['lam']",
               "['conv']['w']", "['conv']['b']")


def p16_grads(api, state, batch):
    """The gradient one ``make_train_step`` of ``state`` on ``batch`` hands
    to AdamW (its microbatches summed in f32 and averaged), and the loss;
    AdamW itself is skipped, so no second state is made."""
    from repro_torch.launch import steps as S
    seen = {}

    def spy(grads, opt, params, **kw):
        seen["g"] = grads
        return params, opt
    real = S.adamw_update
    S.adamw_update = spy
    try:
        _, m = S.make_train_step(api, peak_lr=P14_LR)(state, batch)
    finally:
        S.adamw_update = real
    return float(m["loss"]), seen["g"]


def p16_frames_kw(api, batch):
    return {"frames": batch["frames"]} if api.needs_frames else {}


def p16_block_vjp(sm, arch, params):
    """The arch's recurrent block (mamba2: an SSD block; recurrentgemma:
    an RG-LRU block) with layer 0's trained weights, its vjp on the card
    and on the CPU on the same input and cotangent -> (worst relative L2
    of a leaf but a step size, its path, the leaves failing)."""
    import math
    from repro_torch.nn import rglru as R
    from repro_torch.nn import ssm as SS
    from repro_torch.tree import flatten_with_paths, unflatten
    t = sm.torch
    api = family_api(arch)
    if arch == "mamba2-1.3b":
        lp = params["layers"][0]["ssm"]
        fn = lambda p, x: SS.ssd_forward(  # noqa: E731
            p, x, api.policy, api.cfg.ssm, serve=False)
    else:
        lp = params["layers"][0]["rnn"]
        fn = lambda p, x: R.rglru_block_forward(  # noqa: E731
            p, x, api.policy, api.cfg.rnn, serve=False)
    g = t.Generator(device="cpu").manual_seed(SEED)
    shape = (1, P16_VJP_ROWS[arch], api.cfg.d_model)
    x = t.randn(shape, generator=g).to(t.bfloat16)
    ct = t.randn(shape, generator=g).to(t.bfloat16)
    grads = []
    for dev in (sm.device, t.device("cpu")):  # the card's, then the CPU's
        flat = {k: v.detach().to(dev).requires_grad_(True)
                for k, v in flatten_with_paths(lp).items()}
        xd = x.to(dev).requires_grad_(True)
        y, _ = fn(unflatten(lp, list(flat.values())), xd)
        gs = t.autograd.grad(y, [xd] + list(flat.values()),
                             grad_outputs=ct.to(dev))
        grads.append(dict(zip(["x"] + list(flat), gs)))
    worst, bad = (0.0, ""), []
    for path, gc in grads[1].items():
        a = grads[0][path].detach().double().cpu()
        b = gc.detach().double()
        rel = float((a - b).norm() / max(float(b.norm()), 1e-300))
        if path.endswith(STEP_SIZES):
            if not math.isfinite(float(a.norm())):
                bad.append(path)
            continue
        worst = max(worst, (rel, path))
        if not rel <= (P16_CONV_VJP_RELL2_MAX if path.endswith(P16_CONV)
                       else P16_VJP_RELL2_MAX):
            bad.append(path)
    return worst, bad


def p16_gemms(api, b, s):
    """The bf16 products of one train forward of ``b`` x ``s`` tokens as
    [(M, K, N, groups, count)]: phase 13's serve shapes (mamba2's rows
    padded to its chunk, whisper's encoder and cross K/V over its frames),
    the head at every token."""
    from collections import Counter
    calls = Counter((m, kdim, n) for name, m, kdim, n, *_
                    in p13_k1_calls(api, b, s, "prefill") if name != "head")
    head = [(m, kdim, n) for name, m, kdim, n, *_
            in p13_k1_calls(api, b, s, "prefill") if name == "head"][0]
    return [(m, k, n, 1, c) for (m, k, n), c in calls.items()] + [
        (b * s, head[1], head[2], 1, 1)]


def p16_mixer_ms(sm, api, b, s):
    """The rest outside the products, forward and backward, CUDA events:
    mamba2's chunked SSD (one batch row at a time, as ``ssd_forward`` runs
    it on a card) over its layers; recurrentgemma's RG-LRU scan over its R
    layers and its windowed attention over its A layers; whisper's three
    attentions (encoder, causal decoder, cross) over its layers -> ms."""
    from repro_torch.launch import steps as S
    from repro_torch.models.recurrentgemma import layer_kind
    from repro_torch.nn import attention as A
    from repro_torch.nn import rglru as R
    from repro_torch.nn import ssm as SS
    t = sm.torch
    cfg = api.cfg
    g = t.Generator(device=sm.device).manual_seed(SEED)

    def rnd(*shape, dtype=t.float32):
        return t.randn(shape, generator=g, device=sm.device).to(
            dtype).requires_grad_(True)

    def attn(sq, sk, h, d, **kw):
        q, k, v = rnd(b, sq, h, d, dtype=t.bfloat16), rnd(
            b, sk, h, d, dtype=t.bfloat16), rnd(b, sk, h, d,
                                                dtype=t.bfloat16)
        ct = t.randn((b, sq, h, d), device=sm.device).to(t.bfloat16)
        return lambda: t.autograd.grad(A.chunked_attention(q, k, v, **kw),
                                       (q, k, v), grad_outputs=ct)
    parts = []
    if hasattr(cfg, "ssm"):
        c = cfg.ssm
        rows = s + (-s) % c.chunk
        xs = [rnd(1, rows, c.n_heads, c.head_dim), rnd(1, rows, c.n_heads,
                                                         c.d_state),
              rnd(1, rows, c.n_heads, c.d_state)]
        dtp = t.rand((1, rows, c.n_heads), generator=g,
                     device=sm.device).requires_grad_(True)
        a = -t.rand((c.n_heads,), generator=g, device=sm.device)

        def ssd():
            for _ in range(b):
                y, st = SS._ssd_chunks(*xs, dtp, a, c.chunk)
                t.autograd.grad((y.sum() + st.sum()), xs + [dtp])
        parts.append((ssd, cfg.n_layers))
    elif hasattr(cfg, "rnn"):
        a_ = t.rand((b, s, cfg.rnn.d_rnn), generator=g,
                    device=sm.device).requires_grad_(True)
        b_ = rnd(b, s, cfg.rnn.d_rnn)

        def scan():
            ha, hb = R.associative_scan(R.linear_combine, [a_, b_], axis=1)
            t.autograd.grad(hb.sum(), (a_, b_))
        n_a = sum(layer_kind(cfg, i) == "A" for i in range(cfg.n_layers))
        parts += [(scan, cfg.n_layers - n_a),
                  (attn(s, s, cfg.n_heads, cfg.hd, window=cfg.window,
                        chunk=cfg.attn_chunk), n_a)]
    else:
        hd = cfg.hd
        parts += [(attn(cfg.n_audio, cfg.n_audio, cfg.n_heads, hd,
                        causal=False, chunk=cfg.attn_chunk), cfg.n_layers),
                  (attn(s, s, cfg.n_heads, hd, chunk=cfg.attn_chunk),
                   cfg.n_layers),
                  (attn(s, cfg.n_audio, cfg.n_heads, hd, causal=False,
                        chunk=cfg.attn_chunk), cfg.n_layers)]
    with S.deterministic(sm.device):
        return sum(n * sm.time_ms(fn, reps=2, warmup=1) for fn, n in parts)


def p16_corr(sm, a, b):
    """Pearson correlation of two equal-shape tensors on the card, in
    float64 sums over row blocks (rg's logits hold 1.3e9 values)."""
    t = sm.torch
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    n, sums = a2.numel(), t.zeros(5, dtype=t.float64, device=sm.device)
    for i in range(0, a2.shape[0], 256):
        x = a2[i:i + 256].double()
        y = b2[i:i + 256].double()
        sums += t.stack([x.sum(), y.sum(), (x * x).sum(), (y * y).sum(),
                         (x * y).sum()])
    sx, sy, sxx, syy, sxy = (float(v) for v in sums)
    cov = sxy / n - sx * sy / n ** 2
    return cov / ((sxx / n - (sx / n) ** 2) * (syy / n - (sy / n) ** 2)
                  ) ** 0.5


def p16_layer_corr(sm, api, params, packed, batch):
    """Each served layer fed the QAT forward's input to that layer (whisper:
    the encoder layers, then the decoder layers on the QAT encoder's
    output), against the QAT layer, by the correlation of what the layer
    adds to its input; and the served head on the QAT forward's last
    hidden state against the QAT head -> (smallest layer correlation, its
    layer, head correlation).  Free-running, a random deep stack drifts
    (mamba2's 48 layers: 0.65 on the CPU at 256 tokens, each layer alone
    0.9993), so the layers are held one at a time."""
    from repro_torch.nn import layers as nnl
    t = sm.torch
    mod, cfg, pol = api.mod, api.cfg, api.policy
    toks = batch["tokens"]
    worst = (2.0, None)

    def check(label, x, yq, ys):
        nonlocal worst
        worst = min(worst, (p16_corr(sm, (yq - x).float(), (ys - x).float()),
                            label))
    with t.no_grad():
        if api.needs_frames:
            x = mod._enc_inputs(cfg, batch["frames"])
            for i, (lq, ls) in enumerate(zip(params["enc_layers"],
                                             packed["enc_layers"])):
                yq = mod._enc_layer_fwd(cfg, lq, x, pol, impl="auto",
                                        serve=False)
                check(f"enc {i}", x, yq, mod._enc_layer_fwd(
                    cfg, ls, x, pol, impl="auto", serve=True))
                x = yq
            aux = {"enc_out": nnl.layernorm_apply(params["enc_norm"], x)}
            b, s = toks.shape
            x = nnl.embed_apply(params["embed"], toks) + mod._sinusoid(
                mod._positions(b, s, toks.device), cfg.d_model).to(
                    t.bfloat16)
            stack = zip(params["dec_layers"], packed["dec_layers"])
        else:
            x, aux = mod._prefill_inputs(cfg, params, toks, serve=False)
            aux.pop("valid", None)  # every row, as the forward runs them
            stack = zip(params["layers"], packed["layers"])
        for i, (lq, ls) in enumerate(stack):
            yq = mod._layer_fwd(cfg, i, lq, x, pol, aux, impl="auto",
                                serve=False)[0]
            check(f"layer {i}", x, yq, mod._layer_fwd(
                cfg, i, ls, x, pol, aux, impl="auto", serve=True)[0])
            x = yq
        x = x[:, :toks.shape[1]]
        head = p16_corr(sm, mod._head(cfg, params, x, pol, "auto",
                                      serve=False).float(),
                        mod._head(cfg, packed, x, pol, "auto",
                                  serve=True).float())
    return worst[0], worst[1], head


def p16_arch(sm, arch, depth, b, s):
    """One arch at full width: the ``Trainer`` for P16_STEPS steps, a
    restart from step P16_CKPT_EVERY bitwise the uninterrupted run (at
    P16_RESTART_DEPTH where it names the arch), one
    microbatch against two, every gradient finite and the recurrences'
    own nonzero, the SSD / RG-LRU block's vjp on the card against the
    CPU's, then ``pack_for_serving`` and the serve-mode ``forward`` over
    the batch through K1 (and K3 for recurrentgemma) against the QAT
    forward, and a prefill with P16_DECODE decode steps."""
    import math
    import shutil
    import numpy as np
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw_update
    from repro_torch.runtime.serve import Generator, pack_for_serving
    from repro_torch.runtime.train import TrainLoopConfig, Trainer
    from repro_torch.tree import flatten_with_paths, leaves, tree_map
    t = sm.torch
    api = dataclasses.replace(family_api(arch, depth=depth),
                              microbatches=P16_MB)
    cfg = api.cfg
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=SEED,
                       with_frames=api.needs_frames,
                       n_audio=getattr(cfg, "n_audio", 0),
                       d_model=cfg.d_model)
    r_depth = P16_RESTART_DEPTH.get(arch)
    r_api = api if r_depth is None else dataclasses.replace(
        family_api(arch, depth=r_depth), microbatches=P16_MB)
    root = ckpt_root(f"p16/{arch}", r_api.total_params() * 12)
    t_arch = time.perf_counter()

    def at():  # the log prefix: phase 16, seconds into this arch
        return f"[p16] (+{time.perf_counter() - t_arch:.1f} s) "

    def trainer(a, saves=(P16_CKPT_EVERY,)):
        """A Trainer of ``a`` for P16_STEPS steps that checkpoints at
        ``saves`` and at no other step: the final state is compared in
        memory, and its checkpoint (34 GB for recurrentgemma) would be
        read by nothing."""
        return save_only_at(Trainer(a, pipe, TrainLoopConfig(
            total_steps=P16_STEPS, ckpt_every=P16_CKPT_EVERY,
            ckpt_dir=str(root), log_every=1, async_ckpt=False,
            peak_lr=P14_LR), device=sm.device), saves)

    def gen():
        return t.Generator(device=sm.device).manual_seed(SEED)
    release(sm)
    t.cuda.reset_peak_memory_stats()
    # the uninterrupted run, which leaves the checkpoint of its step 2
    # where it is the restart's
    full = trainer(api, () if r_depth else (P16_CKPT_EVERY,))
    s_full, h_full = full.run(gen())
    peak_train = t.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in leaves(s_full["params"]))
    log(at() + f"{arch} x{cfg.n_layers} ({n_params / 1e9:.3f} B parameters, "
        f"{b} x {s} tokens, {P16_MB} microbatches) uninterrupted: losses "
        f"{[round(v, 4) for v in h_full]}, steps (s) "
        f"{[round(v, 3) for v in full.step_seconds]}; max_memory_allocated "
        f"{peak_train / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for v in h_full):
        sm.failures.append(f"{arch} losses {h_full}")
    if r_depth:
        # the restart leg's own uninterrupted run, kept on the card
        state = s_full
        r_full = trainer(r_api)
        s_ref, h_ref = r_full.run(gen())
        save_s = r_full.save_seconds
        del r_full
    else:
        # the host keeps the uninterrupted state while the restart runs
        s_ref, h_ref = tree_map(lambda x: x.cpu(), s_full), h_full
        save_s = full.save_seconds
        del s_full
    release(sm)
    ab2 = trainer(r_api)  # restores step 2, runs step 3
    s_ab, h_ab = ab2.run(gen())
    same = (h_ab == h_ref[P16_CKPT_EVERY:] and all(
        t.equal(x.to(y.device), y) for x, y in zip(leaves(s_ab),
                                                   leaves(s_ref))))
    restore_s = ab2.restore_seconds
    log(at() + f"{arch} restart from step {P16_CKPT_EVERY}"
        + (f" at depth {r_depth} (full width)" if r_depth else "")
        + f" (save {[round(v, 2) for v in save_s]} s, restore "
        f"{restore_s:.2f} s): losses {[round(v, 4) for v in h_ab]}; "
        f"parameters, moments and losses bitwise the uninterrupted run's: "
        f"{same}")
    if not same:
        sm.failures.append(f"{arch} restart is not bitwise the "
                           f"uninterrupted run")
    if not r_depth:
        state = s_ab  # bitwise the uninterrupted run's final state
    del s_ref, s_ab, ab2
    release(sm)
    shutil.rmtree(root, ignore_errors=True)
    sm.check_phase(f"16 {arch} Trainer: restart bitwise")

    host = pipe.batch_at(P16_STEPS)
    batch = {k: t.as_tensor(v, device=sm.device) for k, v in host.items()}
    for k in ("tokens", "labels"):
        batch[k] = batch[k].long()
    mb_rows = b // P16_MB
    half = {k: v[:mb_rows] for k, v in batch.items()}
    split = p14_split(sm, api, state, half, mb_rows * s,
                      gemms=p16_gemms(api, mb_rows, s), adamw=False)
    split["mixer"] = p16_mixer_ms(sm, api, mb_rows, s)
    release(sm)
    l2, g2 = p16_grads(api, state, batch)
    g2 = tree_map(lambda x: x.cpu(), g2)
    release(sm)
    l1, g1 = p16_grads(dataclasses.replace(api, microbatches=1), state,
                       batch)
    errs = leaf_errors(sm, g1, g2)
    conv = {p: e for p, e in errs.items() if p.endswith(P16_CONV)}
    bad, worst = leaf_gate({p: e for p, e in errs.items() if p not in conv},
                           P16_MB_LEAF_RELL2_MAX)
    if conv:
        bad_c, worst_c = leaf_gate(conv, P16_CONV_MB_RELL2_MAX)
        bad += bad_c
    flat = flatten_with_paths(g1)
    finite = all(bool(t.isfinite(v).all()) for v in flat.values())
    own = {p: float(v.abs().max()) for p, v in flat.items()
           if p.endswith(P16_NONZERO)}
    dl = abs(l1 - l2) / abs(l2)
    log(at() + f"{arch} one microbatch vs {P16_MB}: loss {l1:.6f} vs "
        f"{l2:.6f} (rel {dl:.2e}); gradients' relative L2, worst leaf "
        f"{worst[1]} {worst[0]:.4f} (limit {P16_MB_LEAF_RELL2_MAX})"
        + (f", worst conv leaf {worst_c[1]} {worst_c[0]:.4f} (limit "
           f"{P16_CONV_MB_RELL2_MAX})" if conv else "")
        + f"; leaves failing {bad or 'none'}; {len(flat)} gradient leaves "
        f"all finite: "
        f"{finite}; the recurrences' own gradients nonzero: "
        f"{all(v > 0 for v in own.values())} ({len(own)} leaves, smallest "
        f"largest |value| {min(own.values(), default=0.0):.3e})")
    if dl > P14_LOSS_RTOL or bad or not finite \
            or not all(v > 0 for v in own.values()) \
            or (arch != "whisper-base" and not own):
        sm.failures.append(f"{arch} microbatches/gradients: loss rel {dl}, "
                           f"leaves failing {bad}, finite {finite}, "
                           f"zero: {[p for p, v in own.items() if v <= 0]}")
    del g1, g2, flat
    release(sm)
    vjp = None
    if arch in P16_VJP_ROWS:
        vjp, vbad = p16_block_vjp(sm, arch, state["params"])
        log(at() + f"{arch} {'SSD' if 'mamba' in arch else 'RG-LRU'} block "
            f"vjp ({P16_VJP_ROWS[arch]} rows, layer 0's trained weights), "
            f"card vs CPU: worst leaf {vjp[1]} relative L2 {vjp[0]:.3e} "
            f"(limit {P16_VJP_RELL2_MAX}, the conv's {P16_CONV_VJP_RELL2_MAX}"
            f"); failing {vbad or 'none'}")
        if vbad:
            sm.failures.append(f"{arch} block vjp card vs CPU: {vbad}")
    sm.check_phase(f"16 {arch} microbatches and gradients")

    # pack the trained weights under the arch's default policy and serve
    packed = pack_for_serving(api, state["params"])
    fkw = p16_frames_kw(api, batch)
    with t.no_grad():
        qat = api.forward(state["params"], batch["tokens"], mode="train",
                          **fkw)
        api.forward(packed, batch["tokens"][:, :16], mode="serve",
                    **({"frames": fkw["frames"]} if fkw else {}))  # warm
        reset_counts()
        t.cuda.synchronize()
        t0 = time.perf_counter()
        served = api.forward(packed, batch["tokens"], mode="serve", **fkw)
        t.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = read_p11()
    from collections import Counter
    from repro_torch.kernels.mpmm import kernel
    want_routes = Counter(kernel.mpmm_route(m, kdim, n) for m, kdim, n, *_
                          in ((m, k, n) for m, k, n, _, c
                              in p16_gemms(api, b, s) for _ in range(c)))
    k3 = p13_expected(api, b, s, 1)[1]
    want = {"mpmm_cuda": sum(want_routes.values()), "flash_fwd_cuda": k3}
    got = {k: counts[k] for k in want}
    c = p16_corr(sm, qat.float(), served.float())
    del qat, served
    release(sm)
    lc, lname, hc = p16_layer_corr(sm, api, state["params"], packed, batch)
    # free-running, a deep random stack drifts: the end-to-end correlation
    # is held where the stack is short, every layer and the head always
    deep = cfg.n_layers > P16_E2E_MAX_DEPTH
    log(at() + f"{arch} serve-mode forward of the trained weights over {b} x "
        f"{s} tokens in {serve_s * 1e3:.1f} ms: launches {got} (want "
        f"{want}), K1 routes {dict(want_routes)}; served vs QAT forward "
        f"correlation {c:.4f} end to end (min {P16_QAT_CORR}"
        + (f" at depth <= {P16_E2E_MAX_DEPTH}; {cfg.n_layers} layers: not "
           f"held" if deep else "") + f"), each served layer on the QAT "
        f"layer's input {lc:.4f} at worst ({lname}), the head {hc:.4f} "
        f"(min {P16_QAT_CORR})")
    if got != want or not min(lc, hc) > P16_QAT_CORR or (
            not deep and not c > P16_QAT_CORR):
        sm.failures.append(f"{arch} serve: launches {got} vs {want}, "
                           f"correlation {c} end to end, {lc} ({lname}), "
                           f"head {hc}")
    gen_s = Generator(api, packed, device=sm.device)
    host_frames = host.get("frames")
    prompts = host["tokens"]
    reset_counts()
    toks, logits = gen_s.run(prompts, P16_DECODE + 1, frames=host_frames)
    gen_counts = read_p11()
    ok = all(tuple(lg.shape) == (b, cfg.vocab) and bool(
        t.isfinite(lg.float()).all()) for lg in logits)
    log(at() + f"{arch} prefill of {b} x {s} and {P16_DECODE} decode steps "
        f"from the trained weights: launches {gen_counts['mpmm_cuda']} K1, "
        f"{gen_counts['flash_fwd_cuda']} K3; logits finite: {ok}; tokens[0] "
        f"{toks[0].tolist()}")
    if not ok:
        sm.failures.append(f"{arch} generate from the trained weights")
    sm.check_phase(f"16 {arch} trained weights through the kernels")
    peak = t.cuda.max_memory_allocated()
    del gen_s, packed
    release(sm)
    # AdamW as the Trainer's step runs it, donated (the state is spent:
    # any tree of its shapes serves as the gradients)
    split["adamw"] = sm.time_ms(lambda: adamw_update(
        state["params"], state["opt"], state["params"], lr=1e-4,
        donate=True), reps=2, warmup=1)
    del state
    release(sm)
    steps = full.step_seconds[1:]
    return {"arch": arch, "b": b, "s": s, "depth": cfg.n_layers,
            "step_ms": 1e3 * sum(steps) / len(steps),
            "first_ms": 1e3 * full.step_seconds[0], "save_s": save_s,
            "restore_s": restore_s, "restart_depth": r_depth,
            "peak_train": peak_train, "peak": peak,
            "losses": h_full, "counts": add_counts(counts, gen_counts),
            "restart": same, "split": split, "params": n_params, "corr": c,
            "layer_corr": (lc, lname), "head_corr": hc,
            "mb_worst": worst, "vjp": vjp}


def p16_allocator(sm):
    """Let the caching allocator grow its segments in place from here on:
    recurrentgemma's step peaks at 67 GiB of 79 in 4 GB pieces (the
    embedding's and the head's f32 leaves), and with fixed segments a
    second run of it found 14 GB cached but no 4 GB block free."""
    t = sm.torch
    setter = getattr(t._C, "_accelerator_setAllocatorSettings", None) \
        or t.cuda.memory._set_allocator_settings
    setter("expandable_segments:True")


def phase_p16(sm):
    """Phase 16 -> (summed launches of its serve runs, results)."""
    t0 = time.perf_counter()
    p16_allocator(sm)
    out, counts = {}, {}
    for arch, depth, b, s in P16_RUNS:
        t1 = time.perf_counter()
        out[arch] = p16_arch(sm, arch, depth, b, s)
        counts = add_counts(counts, out[arch]["counts"])
        log(f"[p16] {arch} took {time.perf_counter() - t1:.1f} s")
    log(f"[p16] phase 16 took {time.perf_counter() - t0:.1f} s")
    return counts, out


def print_p16(p16, card):
    """Phase 16's ``[p16-time]`` lines."""
    gib = 2 ** 30
    rest = {"mamba2-1.3b": "SSD", "recurrentgemma-9b": "scan and attention",
            "whisper-base": "attention"}
    for arch, r in p16.items():
        sp = r["split"]
        toks = r["b"] * r["s"]
        log(f"[p16-time] {arch} x{r['depth']} QAT step (full width, "
            f"{r['params'] / 1e9:.3f} B parameters, batch {r['b']} x "
            f"{r['s']}, {P16_MB} microbatches): {r['step_ms']:.2f} ms (mean "
            f"of steps 2-{P16_STEPS}; first {r['first_ms']:.1f} ms) = "
            f"{toks / r['step_ms'] * 1e3:.1f} tokens/s trained; checkpoint "
            + (f"(the restart leg's, x{r['restart_depth']}) "
               if r["restart_depth"] else "")
            + f"save {', '.join(f'{v * 1e3:.0f}' for v in r['save_s'])} ms, "
            f"restore {r['restore_s'] * 1e3:.0f} ms; max_memory_allocated "
            f"{r['peak_train'] / gib:.2f} GiB training, {r['peak'] / gib:.2f} "
            f"GiB with the checks and serving  ({card})")
        log(f"[p16-time] {arch} step split (each part alone, CUDA events): "
            f"{P16_MB} x forward+backward {P16_MB * sp['fwd_bwd']:.2f} ms, of "
            f"which the bf16 products {P16_MB * sp['products']:.2f} ms and "
            f"the {rest[arch]} rest {P16_MB * sp['mixer']:.2f} ms; one "
            f"fake-quant pass over "
            f"the weights {sp['weight_fake_quant']:.2f} ms; AdamW "
            f"{sp['adamw']:.2f} ms; the step {r['step_ms']:.2f} ms  ({card})")


# --- phase 17: the paper's PE models on the card ----------------------------

P17_GRID = (64, 256, 256)      # benchmarks/fig6_pe_dse.py's M, K, N
P17_LAYER = (392, 4608, 512)   # ResNet-18 s3 3x3 conv at batch 8 as a GEMM
P17_FORMATS = [(w, k) for w in (8, 4, 2, 1) for k in (1, 2, 4) if k <= w]
P17_A_BITS = 8                 # the 2-D variant's activation bits


def p17_inputs(m, kdim, n):
    """Fig. 6's operands, drawn as ``benchmarks/fig6_pe_dse.py`` draws
    them: unsigned 8-bit activations, then one signed code matrix per w."""
    import numpy as np
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (m, kdim)).astype(np.int32)
    ws = {}
    for w_bits in (8, 4, 2, 1):
        lo, hi = -(2 ** (w_bits - 1)), 2 ** (w_bits - 1) - 1
        ws[w_bits] = rng.integers(lo, hi + 1, (kdim, n)).astype(np.int32)
    return a, ws


def p17_call(fn, name, a, w, w_bits, k):
    if name == "BP-ST-2D":
        return fn(a, w, w_bits, P17_A_BITS, k)
    return fn(a, w, w_bits, k)


def p17_score(shape, w_bits, stats, ms):
    """Fig. 6's score of a call of ``ms``: weight bits a second per byte of
    live accumulators."""
    m, kdim, n = shape
    return m * kdim * n * w_bits / (ms * 1e-3) / (stats.accumulators * m
                                                   * n * 4)


def p17_shape(sm, shape, label):
    """Every PE variant x (w, k) at one GEMM shape on the card: bitwise
    ``matmul_exact`` on the card and the int32 product on the host, the
    statistics equal to the CPU run's; time and the Fig. 6 score."""
    from repro_torch.core import ppg
    t = sm.torch
    m, kdim, n = shape
    a_np, ws = p17_inputs(m, kdim, n)
    a_cpu = t.from_numpy(a_np)
    a = a_cpu.to(sm.device)
    rows = []
    for w_bits, k in P17_FORMATS:
        w_cpu = t.from_numpy(ws[w_bits])
        w = w_cpu.to(sm.device)
        # the host's exact product (float64 is exact below 2^53)
        want = (a_cpu.double() @ w_cpu.double()).to(t.int32)
        exact = ppg.matmul_exact(a, w)
        if not t.equal(exact.cpu(), want):
            sm.failures.append(f"p17 {label} matmul_exact w{w_bits}k{k}")
        for name, fn in ppg.PE_VARIANTS.items():
            got, stats = p17_call(fn, name, a, w, w_bits, k)
            if shape == P17_GRID:  # the CPU run of the same variant
                cpu, cpu_stats = p17_call(fn, name, a_cpu, w_cpu, w_bits, k)
                if not t.equal(cpu, want):
                    sm.failures.append(f"p17 CPU {name} w{w_bits}k{k}")
            else:
                cpu_stats = p17_call(fn, name, a_cpu[:1], w_cpu, w_bits,
                                     k)[1]
            if not t.equal(got, exact) or stats != cpu_stats:
                sm.failures.append(f"p17 {label} {name} w{w_bits}k{k}: "
                                   f"bitwise {t.equal(got, exact)}, stats "
                                   f"{stats} vs {cpu_stats}")
            ms = sm.time_ms(lambda: p17_call(fn, name, a, w, w_bits, k),
                            reps=10, warmup=2)
            rows.append({"shape": label, "variant": name, "w": w_bits,
                         "k": k, "us": ms * 1e3,
                         "score": p17_score(shape, w_bits, stats, ms),
                         "passes": stats.mxu_passes,
                         "cycles": stats.serial_cycles,
                         "accs": stats.accumulators})
        del w, got, exact
    return rows


def p17_k1(sm):
    """BP-ST-1D at the grid shape, w8k4, against K1 with gamma 1 and no
    epilogue (a_biased = a - 128, act_zero 128): bitwise, since every
    accumulator is below 2^24 in magnitude."""
    from repro_torch.core import packing, ppg
    from repro_torch.kernels.mpmm import kernel
    t = sm.torch
    m, kdim, n = P17_GRID
    a_np, ws = p17_inputs(m, kdim, n)
    a = t.from_numpy(a_np).to(sm.device)
    w = t.from_numpy(ws[8])
    fmt = packing.PlaneFormat(w_bits=8, k=4, k_dim=kdim)
    planes = packing.pack_planes(w, fmt).to(sm.device)
    colsum = w.sum(0, dtype=t.int32).reshape(1, n).to(sm.device)
    gamma = t.ones((1, n), device=sm.device)
    a_biased = (a - 128).to(t.int8)
    y = kernel.mpmm_cuda(a_biased, planes, gamma, colsum, fmt=fmt,
                         act_zero=128, variant="st", out_dtype=t.float32)
    acc, _ = ppg.matmul_bp_st_1d(a, w.to(sm.device), 8, 4)
    same = t.equal(y, acc.to(t.float32))
    bound = int(acc.abs().max())
    k1_us = sm.time_ms(lambda: kernel.mpmm_cuda(
        a_biased, planes, gamma, colsum, fmt=fmt, act_zero=128,
        variant="st", out_dtype=t.float32)) * 1e3
    log(f"[p17] K1 (gamma 1, no epilogue) vs BP-ST-1D w8k4 at M {m} K "
        f"{kdim} N {n}: bitwise {same} (max |acc| {bound} < 2^24); K1 "
        f"{k1_us:.2f} us a call")
    if not same or bound >= 2 ** 24:
        sm.failures.append("p17 K1 vs BP-ST-1D w8k4")
    return k1_us


def phase_p17(sm, card):
    """Phase 17: ``core.ppg`` on the card -> the rows of its table."""
    t0 = time.perf_counter()
    rows = (p17_shape(sm, P17_GRID, "fig6") +
            p17_shape(sm, P17_LAYER, "resnet18-s3"))
    k1_us = p17_k1(sm)
    sm.check_phase("17 PE models on the card: every variant bitwise "
                   "matmul_exact, BP-ST-1D bitwise K1")
    for r in rows:
        log(f"[p17-time] {r['shape']} {r['variant']} w{r['w']}k{r['k']}: "
            f"{r['us']:.2f} us a call, {r['score']:.3e} weight bits/s per "
            f"accumulator byte (passes {r['passes']}, cycles "
            f"{r['cycles']}, accumulators {r['accs']})  ({card})")
    for label in ("fig6", "resnet18-s3"):
        best = max((r for r in rows if r["shape"] == label),
                   key=lambda r: r["score"])
        log(f"[p17-time] {label}: highest score {best['variant']} "
            f"w{best['w']}k{best['k']} {best['score']:.3e} -- host-bound "
            f"calls: the score ranks the host's work a pass, not the PE "
            f"(tools/ppg_device_time.py times the device alone)  ({card})")
    log(f"[p17] phase 17 took {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "k1_us": k1_us}


# --- phase 18: data-parallel serving, two ranks on one card --------------------

P18_RANKS = 2
P18_CNN_BATCH = 16
P18_LM_DEPTH = 2
P18_LM = (4, 256, 8)   # prompts, prompt length, new tokens
# (prompt length, n_new) of the GenerateScheduler's requests
P18_SCHED = ((256, 8), (256, 4), (128, 6), (256, 8), (128, 3))


def p18_cells(mesh, device):
    """Phase 18's cells on ``mesh`` (None: one device) -> results with the
    launch counts of each cell's timed run."""
    import numpy as np
    import torch as t
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.models import resnet as R
    from repro_torch.runtime.scheduler import GenerateScheduler
    from repro_torch.runtime.serve import Generator, ImageServer, init_packed_lm
    out = {}
    api = configs.get(ARCH)
    plan = PrecisionPlan.load(PLAN)
    params = api.init_params(t.Generator(device=device).manual_seed(SEED),
                             device=device)
    state = R.init_bn_state(api.specs(), device=device)
    packed = R.pack_for_serve(api.cfg, params, state, plan)
    del params, state
    srv = ImageServer(api=api, params=packed, plan=plan, device=device,
                      batch_buckets=(P18_CNN_BATCH,), mesh=mesh)
    x = np.random.default_rng(SEED).normal(0, 1, (
        P18_CNN_BATCH, api.cfg.img_size, api.cfg.img_size, 3)).astype(
        np.float32)
    srv.predict(x)  # warm-up
    t.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    y = srv.predict(x)
    out["cnn"] = {"logits": y, "s": time.perf_counter() - t0,
                  "counts": read_p11()}
    del srv, packed
    lapi = lm_api(P18_LM_DEPTH, PrecisionPlan.load(LM_PLAN))
    b, s_, n_new = P18_LM
    packed = init_packed_lm(lapi, t.Generator(device=device).manual_seed(SEED),
                            device=device)
    gen = Generator(api=lapi, params=packed, device=device, mesh=mesh)
    prompts = np.random.default_rng(SEED).integers(
        0, lapi.cfg.vocab, (b, s_)).astype(np.int32)
    gen.generate(prompts, 2)  # warm-up
    t.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks, logits = gen.run(prompts, n_new)
    out["lm"] = {"tokens": toks, "s": time.perf_counter() - t0,
                 "logits": [lg.float().cpu().numpy() for lg in logits],
                 "counts": read_p11()}
    clock = StepClock()
    sched = GenerateScheduler(gen, slots=4, max_len=s_ + n_new, clock=clock)
    rng = np.random.default_rng(SEED + 1)
    reset_counts()
    t0 = time.perf_counter()
    tickets = [sched.submit(rng.integers(0, lapi.cfg.vocab, (plen,)).astype(
        np.int32), nn) for plen, nn in P18_SCHED]
    while sched.pending or sched.active:
        clock.advance(1.0)
        sched.step(flush=True)
    out["sched"] = {"results": [tk.result for tk in tickets],
                    "s": time.perf_counter() - t0, "counts": read_p11(),
                    "buckets": sched.prefill_buckets}
    return out


def p18_rank(rank, _args):
    """One rank of phase 18's world: two ranks on cuda:0 over gloo, the
    kernels loaded from the libraries the parent built."""
    import torch as t
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    stale = [n for n in _build.KERNEL_SOURCES if _build._stale(n)]

    def refuse(name, nvcc):
        raise RuntimeError(f"rank {rank} would run nvcc for {name}")
    _build._start = refuse
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_serve_mesh(
        P18_RANKS, 1, devices=["cuda:0"] * P18_RANKS)
    out = p18_cells(mesh, mesh_lib.local_device(mesh))
    out["stale"] = stale
    out["backend"] = mesh_lib.mesh_info(mesh).backend
    return out


def p18_equal(a, b) -> bool:
    import numpy as np
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(p18_equal(a[k], b[k])
                                              for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(p18_equal(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(a, b))


def phase_p18(sm, card):
    """Phase 18: each cell on one device in this process, then on a world
    of two ranks sharing cuda:0 -> (the ranks' summed launches, results).
    A contract check: every rank's results bitwise the one-device run's,
    every rank's launches those the layers' choices give at its rows."""
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    release(sm)
    one = p18_cells(None, sm.device)
    release(sm)
    t1 = time.perf_counter()
    ranks = mesh_lib.spawn(p18_rank, P18_RANKS, (None,),
                           store_dir=str(ROOT / "build" / "p18"),
                           backend="gloo", timeout_s=400)
    spawn_s = time.perf_counter() - t1
    cfg = configs.get(ARCH).cfg
    plan = PrecisionPlan.load(PLAN)
    lapi = lm_api(P18_LM_DEPTH, PrecisionPlan.load(LM_PLAN))
    b, s_, n_new = P18_LM
    launches = {}
    for r, res in enumerate(ranks):
        if res["stale"] or res["backend"] != "gloo":
            sm.failures.append(f"p18 rank {r}: stale libraries "
                               f"{res['stale']}, backend {res['backend']}")
        for cell in ("cnn", "lm", "sched"):
            a = {k: v for k, v in res[cell].items()
                 if k not in ("s", "counts")}
            w = {k: v for k, v in one[cell].items()
                 if k not in ("s", "counts")}
            if cell == "sched":
                a.pop("buckets")
                w.pop("buckets")
            if not p18_equal(a, w):
                sm.failures.append(f"p18 rank {r} {cell}: not bitwise the "
                                   f"one-device run")
        # launches: what the layers give at this rank's rows
        for cell, counts, rows in (("cnn", res["cnn"]["counts"],
                                    P18_CNN_BATCH // P18_RANKS),
                                   ("cnn-one", one["cnn"]["counts"],
                                    P18_CNN_BATCH)):
            want, want_routes, _ = resnet_launches(cfg, plan, rows)
            got = {k: counts[k] for k in want}
            got_routes = {k[6:]: v for k, v in counts.items()
                          if k.startswith("route:")}
            if got != want or got_routes != want_routes or (
                    counts["flash_fwd_cuda"] or counts["flash_fwd_packed_cuda"]):
                sm.failures.append(f"p18 rank {r} {cell} launches {counts} "
                                   f"!= {want} {want_routes}")
        for cell, counts, rows in (("lm", res["lm"]["counts"],
                                    b // P18_RANKS),
                                   ("lm-one", one["lm"]["counts"], b)):
            want_routes, k3, k4 = expected_counts(lapi, rows, s_, n_new)
            got_routes = {k[6:]: v for k, v in counts.items()
                          if k.startswith("route:") and v}
            if (got_routes != want_routes or counts["flash_fwd_cuda"] != k3
                    or counts["flash_fwd_packed_cuda"] != k4
                    or counts["conv_mpmm_cuda"]):
                sm.failures.append(f"p18 rank {r} {cell} launches {counts} "
                                   f"!= {want_routes} K3 {k3} K4 {k4}")
        for cell in ("cnn", "lm", "sched"):
            launches = add_counts(launches, res[cell]["counts"])
        log(f"[p18] rank {r}: ResNet-18 {res['cnn']['counts']}; granite-8b "
            f"x{P18_LM_DEPTH} {res['lm']['counts']}; scheduler "
            f"{res['sched']['counts']} (buckets "
            f"{res['sched']['buckets']})")
    log(f"[p18] one device: ResNet-18 {one['cnn']['counts']}; granite-8b "
        f"{one['lm']['counts']}; scheduler {one['sched']['counts']}")
    sm.check_phase("18 data-parallel serving, world 2 on cuda:0: every "
                   "rank bitwise one device, launches at its rows")
    fps = {k: P18_CNN_BATCH / v["cnn"]["s"] for k, v in
           (("one device", one), ("rank 0", ranks[0]), ("rank 1", ranks[1]))}
    tps = {k: b * n_new / v["lm"]["s"] for k, v in
           (("one device", one), ("rank 0", ranks[0]), ("rank 1", ranks[1]))}
    log("[p18-time] host clock, ResNet-18 batch " + str(P18_CNN_BATCH) + ": "
        + ", ".join(f"{k} {v:.1f} frames/s" for k, v in fps.items())
        + f"; granite-8b x{P18_LM_DEPTH} {b} x {s_} + {n_new}: "
        + ", ".join(f"{k} {v:.1f} tokens/s" for k, v in tps.items())
        + f"; world started and served in {spawn_s:.1f} s -- two ranks "
        f"sharing one card measure nothing of scaling  ({card})")
    log(f"[p18] phase 18 took {time.perf_counter() - t0:.1f} s")
    return launches, {"fps": fps, "tps": tps, "spawn_s": spawn_s}


# --- phase 19: tensor-parallel serving, two ranks on one card ----------------

P19_RANKS = 2
P19_LM_DEPTH = 4
P19_LM = (4, 1000, 16)   # prompts, prompt length, new tokens
P19_CNN_BATCH = 16
# granite-8b's row-parallel projections, split in two on K: (name, whole K)
P19_SPLITS = (("o", 4096), ("down", 14336))
P19_ROWS = (4000, 4)     # prefill (route A) and decode (route B) rows


def p19_acc_only(sm):
    """(a) K1's accumulator-only mode: at every format on both routes,
    bitwise its plain twin, and ``epilogue.finish`` after it bitwise the
    fused K1; at granite-8b's o and down projections split in two over K,
    each shard's accumulator bitwise its twin, their int32 sum ``finish``ed
    bitwise the fused whole product; times of a shard's call beside the
    fused call on the same shard and its bound -> timing rows."""
    from repro_torch.core import packing
    from repro_torch.kernels.mpmm import epilogue, kernel, ops
    t = sm.torch
    for m in K1_ROWS:
        route = kernel.mpmm_route(m, 45, 70)
        for w_bits, k in FORMATS:
            for variant in ("st", "sa"):
                fmt, planes, gamma, colsum = sm.weights(45, 70, w_bits, k)
                a = sm.codes((m, 45))
                d = sm.on_device(dict(a=a, planes=planes, gamma=gamma,
                                      colsum=colsum))
                acc = kernel.mpmm_cuda(d["a"], d["planes"], None, None,
                                       fmt=fmt, act_zero=0, variant=variant,
                                       out_dtype=t.int32)
                label = f"K1 {route} acc-only M={m} w{w_bits}k{k} {variant}"
                sm.compare("mpmm_cuda", label, acc,
                           kernel.mpmm_torch_acc(a, planes, fmt=fmt))
                for out_dtype in (t.float32, t.bfloat16):
                    fused = kernel.mpmm_cuda(
                        d["a"], d["planes"], d["gamma"], d["colsum"],
                        fmt=fmt, act_zero=128, variant=variant,
                        out_dtype=out_dtype)
                    sm.compare("mpmm_cuda", f"{label} finish {out_dtype}",
                               epilogue.finish(acc, d["gamma"], d["colsum"],
                                               act_zero=128, spec=None,
                                               out_dtype=out_dtype),
                               fused.cpu())
    rows = []
    n = 4096
    for name, kdim in P19_SPLITS:
        g = t.Generator(device=sm.device).manual_seed(kdim)
        whole = packing.PlaneFormat(w_bits=8, k=4, k_dim=kdim)
        half = packing.PlaneFormat(w_bits=8, k=4, k_dim=kdim // 2)
        w_int = t.randint(-128, 128, (kdim, n), generator=g,
                          device=sm.device, dtype=t.int32)
        planes = packing.pack_planes(w_int, whole)
        gamma = t.rand((1, n), generator=g, device=sm.device) * 1e-3
        colsum = w_int.sum(0, dtype=t.int32).reshape(1, n)
        del w_int
        kp = half.packed_k
        p_half = [planes[:, i * kp:(i + 1) * kp].contiguous()
                  for i in range(2)]
        for m in P19_ROWS:
            a = t.randint(-128, 128, (m, kdim), generator=g,
                          device=sm.device, dtype=t.int32).to(t.int8)
            a_half = [a[:, i * half.k_dim:(i + 1) * half.k_dim].contiguous()
                      for i in range(2)]
            route = kernel.mpmm_route(m, half.k_dim, n)
            label = f"K1 {route} acc-only granite {name} M={m} K={kdim}/2"
            accs = []
            for i in range(2):
                acc = ops.mpmm_acc(a_half[i], p_half[i], fmt=half,
                                   impl="cuda")
                sm.compare("mpmm_cuda", f"{label} shard {i}", acc,
                           kernel.mpmm_torch_acc(a_half[i], p_half[i],
                                                 fmt=half).cpu())
                accs.append(acc)
            fused = kernel.mpmm_cuda(a, planes, gamma, colsum, fmt=whole,
                                     act_zero=128, out_dtype=t.bfloat16)
            sm.compare("mpmm_cuda", f"{label} finish(sum) vs fused whole",
                       epilogue.finish(accs[0] + accs[1], gamma, colsum,
                                       act_zero=128, spec=None,
                                       out_dtype=t.bfloat16), fused.cpu())
            del fused, accs
            ms = sm.time_ms(lambda: kernel.mpmm_cuda(
                a_half[0], p_half[0], None, None, fmt=half, act_zero=0,
                out_dtype=t.int32))
            g_h, c_h = gamma.contiguous(), colsum.contiguous()
            fused_ms = sm.time_ms(lambda: kernel.mpmm_cuda(
                a_half[0], p_half[0], g_h, c_h, fmt=half, act_zero=128,
                out_dtype=t.bfloat16))
            plain_ms = sm.time_ms(lambda: kernel.mpmm_torch_acc(
                a_half[0], p_half[0], fmt=half), reps=3, warmup=1)
            lib, lib_name = k1_library(sm, {"a_biased": a_half[0],
                                            "planes": p_half[0]}, half)
            bound, by = bound_ms(nbytes(a_half[0], p_half[0]) + m * n * 4,
                                 2 * m * half.k_dim * n)
            rows.append({"name": name, "m": m, "k": half.k_dim, "n": n,
                         "route": route, "ms": ms, "fused_ms": fused_ms,
                         "plain_ms": plain_ms, "library_ms": sm.time_ms(lib),
                         "library": lib_name, "bound_ms": bound,
                         "bound_by": by})
            del a, a_half
        del planes, p_half
    sm.check_phase("19a K1 accumulator-only vs its plain twin; finish after "
                   "it vs the fused K1")
    return rows


def p19_cells(mesh, device):
    """Phase 19's cells on ``mesh`` (None: one device) -> results with each
    run's launch counts."""
    import numpy as np
    import torch as t
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.models import resnet as R
    from repro_torch.runtime.scheduler import GenerateScheduler
    from repro_torch.runtime.serve import Generator, ImageServer, init_packed_lm

    def counts():
        c = read_p11()
        c["acc_only"] = kernel.mpmm_cuda.acc_launches
        return c
    out = {}
    lapi = lm_api(P19_LM_DEPTH, PrecisionPlan.load(LM_PLAN))
    b, s_, n_new = P19_LM
    packed = init_packed_lm(lapi, t.Generator(device=device).manual_seed(SEED),
                            device=device)
    gen = Generator(api=lapi, params=packed, device=device, mesh=mesh)
    del packed
    prompts = np.random.default_rng(SEED).integers(
        0, lapi.cfg.vocab, (b, s_)).astype(np.int32)
    gen.generate(prompts, 2)  # warm-up
    t.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks, logits = gen.run(prompts, n_new)
    t.cuda.synchronize()
    run_s = time.perf_counter() - t0
    lm = {"tokens": toks, "logits": [lg.float().cpu().numpy()
                                     for lg in logits],
          "counts": counts(), "s": run_s}
    t0 = time.perf_counter()
    gen.run(prompts, 1)
    t.cuda.synchronize()
    lm["prefill_s"] = time.perf_counter() - t0
    if mesh is not None:  # the int32 all-reduces of a prefill, a step
        with Collectives(t) as col:
            gen.run(prompts, 1)
        pre = [c[2:] for c in col.calls if c[0] == "all_reduce_model"]
        with Collectives(t) as col:
            gen.run(prompts, 2)
        red = [c[2:] for c in col.calls if c[0] == "all_reduce_model"]
        lm["reduce"] = {"prefill": pre, "decode": red[len(pre):]}
    out["lm"] = lm
    clock = StepClock()
    sched = GenerateScheduler(gen, slots=4, max_len=s_ + n_new, clock=clock)
    rng = np.random.default_rng(SEED + 1)
    reset_counts()
    tickets = [sched.submit(rng.integers(0, lapi.cfg.vocab, (plen,)).astype(
        np.int32), nn) for plen, nn in P18_SCHED]
    while sched.pending or sched.active:
        clock.advance(1.0)
        sched.step(flush=True)
    out["sched"] = {"results": [tk.result for tk in tickets],
                    "counts": counts()}
    del gen, sched
    api = configs.get(ARCH)
    plan = PrecisionPlan.load(PLAN)
    params = api.init_params(t.Generator(device=device).manual_seed(SEED),
                             device=device)
    state = R.init_bn_state(api.specs(), device=device)
    packed = R.pack_for_serve(api.cfg, params, state, plan)
    del params, state
    srv = ImageServer(api=api, params=packed, plan=plan, device=device,
                      batch_buckets=(P19_CNN_BATCH,), mesh=mesh)
    x = np.random.default_rng(SEED).normal(0, 1, (
        P19_CNN_BATCH, api.cfg.img_size, api.cfg.img_size, 3)).astype(
        np.float32)
    srv.predict(x)  # warm-up
    t.cuda.synchronize()
    reset_counts()
    out["cnn"] = {"logits": srv.predict(x), "counts": counts()}
    return out


def p19_rank(rank, _args):
    """One rank of phase 19's world: two ranks on cuda:0 over gloo, a
    (1, 2) mesh, the kernels loaded from the libraries the parent built."""
    import torch as t
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    stale = [n for n in _build.KERNEL_SOURCES if _build._stale(n)]

    def refuse(name, nvcc):
        raise RuntimeError(f"rank {rank} would run nvcc for {name}")
    _build._start = refuse
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_serve_mesh(
        1, P19_RANKS, devices=["cuda:0"] * P19_RANKS)
    out = p19_cells(mesh, mesh_lib.local_device(mesh))
    out["stale"] = stale
    out["backend"] = mesh_lib.mesh_info(mesh).backend
    out["coords"] = mesh_lib.model_coords(mesh)
    return out


def p19_check(sm, ranks, one):
    """The contract of (b) and (c): prefill and decode logits bitwise one
    device (the cache's 1016 positions split evenly, so the split decode
    runs the one-device routine on the same row), tokens equal, every
    rank's logits the same, each rank's launches those of one device
    (every layer's K1 calls run on the rank's slice, o and down
    accumulator-only), the scheduler's tickets and the ResNet bitwise ->
    decode logits' largest difference over the largest |logit|."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.plan import PrecisionPlan
    lapi = lm_api(P19_LM_DEPTH, PrecisionPlan.load(LM_PLAN))
    b, s_, n_new = P19_LM
    want_routes, k3, k4 = expected_counts(lapi, b, s_, n_new)
    want_acc = 2 * P19_LM_DEPTH * n_new
    cnn_want, cnn_routes, _ = resnet_launches(configs.get(ARCH).cfg,
                                              PrecisionPlan.load(PLAN),
                                              P19_CNN_BATCH)
    rel = 0.0
    for r, res in enumerate(ranks):
        lm = res["lm"]
        if res["stale"] or res["backend"] != "gloo" \
                or res["coords"] != (r, P19_RANKS):
            sm.failures.append(f"p19 rank {r}: stale {res['stale']}, "
                               f"backend {res['backend']}, coords "
                               f"{res['coords']}")
        if not np.array_equal(lm["logits"][0], one["lm"]["logits"][0]):
            sm.failures.append(f"p19 rank {r}: prefill logits not bitwise "
                               f"one device")
        bad = [i for i, (a, w) in enumerate(zip(lm["logits"][1:],
                                                 one["lm"]["logits"][1:]))
               if not np.array_equal(a, w)]
        if bad:
            sm.failures.append(f"p19 rank {r}: decode logits not bitwise "
                               f"one device at steps {bad}")
        if not np.array_equal(lm["tokens"], one["lm"]["tokens"]):
            sm.failures.append(f"p19 rank {r}: tokens differ from one device")
        for a, w in zip(lm["logits"][1:], one["lm"]["logits"][1:]):
            rel = max(rel, float(np.abs(a - w).max() / np.abs(w).max()))
        if r and not p18_equal(lm["logits"], ranks[0]["lm"]["logits"]):
            sm.failures.append(f"p19 rank {r}: logits differ from rank 0")
        c = lm["counts"]
        got_routes = {k[6:]: v for k, v in c.items()
                      if k.startswith("route:") and v}
        if (got_routes != want_routes or c["flash_fwd_cuda"] != k3
                or c["flash_fwd_packed_cuda"] != k4
                or c["conv_mpmm_cuda"] or c["acc_only"] != want_acc):
            sm.failures.append(f"p19 rank {r} lm launches {c} != "
                               f"{want_routes} K3 {k3} K4 {k4} acc-only "
                               f"{want_acc}")
        if not p18_equal(res["sched"]["results"], one["sched"]["results"]):
            sm.failures.append(f"p19 rank {r}: scheduler tickets differ")
        if not np.array_equal(res["cnn"]["logits"], one["cnn"]["logits"]):
            sm.failures.append(f"p19 rank {r}: ResNet-18 not bitwise")
        c = res["cnn"]["counts"]
        if {k: c[k] for k in cnn_want} != cnn_want or {
                k[6:]: v for k, v in c.items()
                if k.startswith("route:")} != cnn_routes or c["acc_only"]:
            sm.failures.append(f"p19 rank {r} cnn launches {c} != "
                               f"{cnn_want} {cnn_routes}")
    return rel


def phase_p19(sm, card):
    """Phase 19: (a) K1 accumulator-only; then (b, c) granite-8b x4 at full
    width, its scheduler and ResNet-18 on one device here, then on a (1, 2)
    mesh of two ranks sharing cuda:0 -> (the ranks' summed launches, what
    was measured)."""
    import numpy as np
    t0 = time.perf_counter()
    release(sm)
    k1_rows = p19_acc_only(sm)
    release(sm)
    one = p19_cells(None, sm.device)
    release(sm)
    t1 = time.perf_counter()
    from repro_torch.launch import mesh as mesh_lib
    ranks = mesh_lib.spawn(p19_rank, P19_RANKS, (None,),
                           store_dir=str(ROOT / "build" / "p19"),
                           backend="gloo", timeout_s=500)
    spawn_s = time.perf_counter() - t1
    rel = p19_check(sm, ranks, one)
    sm.check_phase("19 tensor-parallel serving, (1, 2) mesh on cuda:0: "
                   "prefill and decode logits bitwise, tokens equal, ranks "
                   "equal, launches, scheduler and ResNet-18 bitwise")
    launches = {}
    for res in ranks:
        for cell in ("lm", "sched", "cnn"):
            launches = add_counts(launches, res[cell]["counts"])
    for r in k1_rows:
        log(f"[p19-time] K1 {r['name']} shard M={r['m']} K={r['k']} "
            f"N={r['n']} route {r['route']}: accumulator-only "
            f"{r['ms']:.4f} ms, fused epilogue {r['fused_ms']:.4f} ms, "
            f"plain twin {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms ({r['library']}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of it)  ({card})")
    b, s_, n_new = P19_LM
    red = ranks[0]["lm"]["reduce"]
    for step, calls in (("prefill", red["prefill"]),
                        ("decode step", red["decode"])):
        nb = sum(c[0] for c in calls)
        ms = sum(c[1] for c in calls)
        log(f"[p19-time] rank 0 int32 all-reduce per {step}: {len(calls)} "
            f"calls, {nb} bytes, {ms:.2f} ms host clock (card synchronized "
            f"around each; through the host, gloo)  ({card})")
    dec = {k: (v["lm"]["s"] - v["lm"]["prefill_s"]) / (n_new - 1) * 1e3
           for k, v in (("one device", one), ("rank 0", ranks[0]),
                        ("rank 1", ranks[1]))}
    pre = {k: v["lm"]["prefill_s"] * 1e3 for k, v in
           (("one device", one), ("rank 0", ranks[0]), ("rank 1", ranks[1]))}
    log(f"[p19-time] granite-8b x{P19_LM_DEPTH} {b} x {s_} + {n_new} host "
        f"clock: prefill " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                       pre.items())
        + "; decode per step " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                           dec.items())
        + f"; world started and served in {spawn_s:.1f} s -- two ranks "
        f"sharing one card over the host measure nothing of scaling  "
        f"({card})")
    log(f"[p19] prefill and decode logits bitwise one device (largest "
        f"difference {rel} of the largest |logit|); tokens equal; rank 0 "
        f"launches {ranks[0]['lm']['counts']}")
    log(f"[p19] phase 19 took {time.perf_counter() - t0:.1f} s")
    acc = {"launches": sum(res[c]["counts"]["acc_only"] for res in ranks
                           for c in ("lm", "sched", "cnn")),
           "ms": float(np.sum([r["ms"] for r in k1_rows])),
           "fused_ms": float(np.sum([r["fused_ms"] for r in k1_rows])),
           "plain_ms": float(np.sum([r["plain_ms"] for r in k1_rows])),
           "library_ms": float(np.sum([r["library_ms"] for r in k1_rows])),
           "bound_ms": float(np.sum([r["bound_ms"] for r in k1_rows])),
           "shapes": [f"{r['name']} M={r['m']} K={r['k']} N={r['n']}"
                      for r in k1_rows]}
    return launches, acc


# --- phase 20: tensor-parallel serving of olmoe, deepseek and whisper -------


P20_RANKS = 2
# arch -> (depth (None: all), (batch, prompt tokens, new tokens))
P20_RUNS = (("olmoe-1b-7b", 2, (4, 256, 8)),
            ("deepseek-v2-lite-16b", 3, (4, 256, 8)),
            ("whisper-base", None, (4, 64, 8)))
P20_SCHED_ARCH = "olmoe-1b-7b"
# olmoe's expert banks of a rank's prefill (4 x 256 tokens, capacity 64 a
# row): M = 256 rows an expert, 32 experts; (K, N) of gate/up and down, at
# each layer's expert format
P20_BANKS = ((2048, 1024), (1024, 2048))
P20_BANK_FORMATS = ((2, 2), (8, 4))
# the frames a caller of each all-gather / all-reduce is sorted by (the
# first one found walking out from the collective)
P20_KINDS = (("router_logits", "router gather"),
             ("expert_parallel_combine", "expert exchange"),
             ("mla_verify", "MLA latent gather"),
             ("cross_decode", "cross split decode"),
             ("gqa_verify", "self split decode"),
             ("_row_parallel_apply", "row-shard int32 sum"),
             ("embed_serve_apply", "embedding int32 sum"),
             ("_head", "head gather"))


def p20_api(arch, depth):
    """Phase 20's arch: olmoe under phase 12's plan (its two layers'
    banks in w2k2 and w8k4, a packed kv4 cache: K4), the others under
    their default policy."""
    from repro_torch import configs
    plan = None
    if arch == "olmoe-1b-7b":
        plan = with_kv4(configs.get(arch).policy, l0_expert=(2, 2),
                        l1_expert=(8, 4))
    return family_api(arch, plan, depth)


class Collectives:
    """Wraps ``launch.mesh.all_gather_model`` and ``all_reduce_model`` in a
    rank (phases 19-21): (function, kind, bytes of the rank's shard, host
    ms) of each call (the card synchronized around it), the kind read off
    the calling frames (``kinds``, by default ``P20_KINDS``): the first
    frame out from the collective that names one."""

    def __init__(self, torch, kinds=None):
        from repro_torch.launch import mesh as mesh_lib
        self.torch, self.mesh_lib = torch, mesh_lib
        self.orig = {n: getattr(mesh_lib, n)
                     for n in ("all_gather_model", "all_reduce_model")}
        self.kinds = dict(P20_KINDS if kinds is None else kinds)
        self.calls = []

    def _kind(self):
        frame = sys._getframe(2)
        names = self.kinds
        while frame is not None:
            if frame.f_code.co_name in names:
                return names[frame.f_code.co_name]
            frame = frame.f_back
        return "other"

    def __enter__(self):
        def wrap(fn):
            def counted(mesh, x, *args, **kw):
                kind = self._kind()
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(mesh, x, *args, **kw)
                self.torch.cuda.synchronize()
                self.calls.append((fn.__name__, kind,
                                   x.numel() * x.element_size(),
                                   (time.perf_counter() - t0) * 1e3))
                return out
            return counted
        for name, fn in self.orig.items():
            setattr(self.mesh_lib, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mesh_lib, name, fn)


def p20_slices(api, params):
    """What a rank holds of the packed tree: every bank's experts and the
    router's columns, the heads' q (and uk) columns, the head's columns."""
    if api.family == "audio":
        dec = params["dec_layers"][0]
        return {"xq_cols": dec["xattn"]["q"]["planes"].shape[-1],
                "head_cols": params["head"]["planes"].shape[-1]}
    layers = params["layers"]
    out = {"banks": [lp["moe"][k]["planes"].shape[0] for lp in layers
                     if "moe" in lp for k in ("gate", "up", "down")],
           "router_cols": [lp["moe"]["router"].shape[1] for lp in layers
                           if "moe" in lp],
           "q_cols": layers[-1]["attn"]["q"]["planes"].shape[-1],
           "head_cols": params["head"]["planes"].shape[-1]}
    if "uk" in layers[0]["attn"]:
        out["uk_cols"] = layers[0]["attn"]["uk"]["planes"].shape[-1]
    return out


def p20_cells(mesh, device):
    """Phase 20's runs on ``mesh`` (None: one device) -> {arch: results}
    with each run's launch counts, and the olmoe scheduler's tickets."""
    import gc
    import numpy as np
    import torch as t
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.runtime.scheduler import GenerateScheduler
    from repro_torch.runtime.serve import Generator, init_packed_lm

    def counts():
        c = read_p11()
        c["acc_only"] = kernel.mpmm_cuda.acc_launches
        return c
    out = {}
    for arch, depth, (b, s_, n_new) in P20_RUNS:
        api = p20_api(arch, depth)
        packed = init_packed_lm(api, t.Generator(device=device).manual_seed(
            SEED), device=device)
        gen = Generator(api=api, params=packed, device=device, mesh=mesh)
        del packed
        prompts = np.random.default_rng(SEED).integers(
            0, api.cfg.vocab, (b, s_)).astype(np.int32)
        kw = {}
        if api.needs_frames:
            kw["frames"] = np.random.default_rng(SEED + 2).normal(0, 1, (
                b, api.cfg.n_audio, api.cfg.d_model)).astype(np.float32)
        gen.generate(prompts, 2, **kw)  # warm-up
        t.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks, logits = gen.run(prompts, n_new, **kw)
        t.cuda.synchronize()
        res = {"tokens": toks, "logits": [lg.float().cpu().numpy()
                                          for lg in logits],
               "counts": counts(), "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        gen.run(prompts, 1, **kw)
        t.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        col = Collectives(t) if mesh is not None else None
        with col or contextlib.nullcontext():
            pre = gen.prefill(t.as_tensor(prompts, dtype=t.long,
                                          device=device),
                              gen._frames(kw.get("frames"), b))[1]
            cache = gen._grow_cache(pre, b, s_, s_ + n_new)
        del pre
        first = ([cache["self"][0], cache["cross"][0]]
                 if api.family == "audio" else cache[0])
        res["cache_shapes"] = [tuple(x.shape) for x in tree_leaves(first)]
        del cache, first
        if mesh is not None:
            res["slices"] = p20_slices(api, gen.params)
            res["collectives"] = {"prefill": col.calls}
            with Collectives(t) as col:
                gen.run(prompts, 2, **kw)
            res["collectives"]["decode"] = col.calls[len(
                res["collectives"]["prefill"]):]
        out[arch] = res
        if arch == P20_SCHED_ARCH:
            clock = StepClock()
            sched = GenerateScheduler(gen, slots=4, max_len=s_ + n_new,
                                      clock=clock)
            rng = np.random.default_rng(SEED + 1)
            reset_counts()
            tickets = [sched.submit(rng.integers(
                0, api.cfg.vocab, (plen,)).astype(np.int32), nn)
                for plen, nn in P18_SCHED]
            while sched.pending or sched.active:
                clock.advance(1.0)
                sched.step(flush=True)
            out["sched"] = {"results": [tk.result for tk in tickets],
                            "counts": counts()}
            del sched
        del gen
        gc.collect()
        t.cuda.empty_cache()
    return out


def p20_rank(rank, _args):
    """One rank of phase 20's world: two ranks on cuda:0 over gloo, a
    (1, 2) mesh, the kernels loaded from the libraries the parent built."""
    import torch as t
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    stale = [n for n in _build.KERNEL_SOURCES if _build._stale(n)]

    def refuse(name, nvcc):
        raise RuntimeError(f"rank {rank} would run nvcc for {name}")
    _build._start = refuse
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_serve_mesh(
        1, P20_RANKS, devices=["cuda:0"] * P20_RANKS)
    out = p20_cells(mesh, mesh_lib.local_device(mesh))
    out["stale"] = stale
    out["backend"] = mesh_lib.mesh_info(mesh).backend
    out["coords"] = mesh_lib.model_coords(mesh)
    return out


def p20_expected(api, b, s, n_new):
    """(K1 launches by route, K3, K4, accumulator-only launches) of one
    ``Generator.run`` on a rank of a 'model' axis above 1: the one-device
    launches (a projection launches once, over the rank's columns, rows,
    heads or experts; K1's route depends on M alone), of which each row
    shard -- o, a dense MLP's down, ``shared_down``, whisper's o and down
    in both stacks -- runs accumulator-only."""
    cfg = api.cfg
    if api.family == "audio":
        routes, k3 = p13_expected(api, b, s, n_new)
        acc = 2 * cfg.n_layers + 3 * cfg.n_layers * n_new
        return routes, k3, 0, acc
    routes, k3, k4 = expected_counts(api, b, s, n_new)
    per_step = sum(1 + (i < cfg.dense_first_n or cfg.moe is None
                        or bool(cfg.moe.n_shared))
                   for i in range(cfg.n_layers))
    return routes, k3, k4, per_step * n_new


def p20_check(sm, ranks, one):
    """Every arch: prefill and decode logits bitwise one device, tokens
    equal, both ranks' logits equal, each rank's launches (``p20_expected``;
    one device: the same without accumulator-only calls), its slice (E/2
    experts a bank and router columns, half the heads' columns, half the
    head) and its ``kv_seq`` block of each cache (half the one-device
    length); olmoe's scheduler tickets bitwise."""
    import numpy as np
    from repro_torch.nn.layers import pad_vocab
    for arch, depth, (b, s_, n_new) in P20_RUNS:
        api = p20_api(arch, depth)
        cfg = api.cfg
        routes, k3, k4, acc = p20_expected(api, b, s_, n_new)
        want1 = one[arch]
        for who, res, want_acc in ([("one device", want1, 0)]
                                   + [(f"rank {r}", x[arch], acc)
                                      for r, x in enumerate(ranks)]):
            c = res["counts"]
            got = {k[6:]: v for k, v in c.items()
                   if k.startswith("route:") and v}
            if (got != routes or c["flash_fwd_cuda"] != k3
                    or c["flash_fwd_packed_cuda"] != k4
                    or c["conv_mpmm_cuda"] or c["acc_only"] != want_acc):
                sm.failures.append(
                    f"p20 {arch} {who} launches {c} != {routes} K3 {k3} "
                    f"K4 {k4} acc-only {want_acc}")
        for r, res in enumerate(ranks):
            lm = res[arch]
            if res["stale"] or res["backend"] != "gloo" \
                    or res["coords"] != (r, P20_RANKS):
                sm.failures.append(f"p20 rank {r}: stale {res['stale']}, "
                                   f"backend {res['backend']}, coords "
                                   f"{res['coords']}")
            if not np.array_equal(lm["logits"][0], want1["logits"][0]):
                sm.failures.append(f"p20 {arch} rank {r}: prefill logits "
                                   f"not bitwise one device")
            bad = [i for i, (a, w) in enumerate(zip(lm["logits"][1:],
                                                     want1["logits"][1:]))
                   if not np.array_equal(a, w)]
            if bad:
                sm.failures.append(f"p20 {arch} rank {r}: decode logits "
                                   f"not bitwise one device at steps {bad}")
            if not np.array_equal(lm["tokens"], want1["tokens"]):
                sm.failures.append(f"p20 {arch} rank {r}: tokens differ "
                                   f"from one device")
            if r and not p18_equal(lm["logits"], ranks[0][arch]["logits"]):
                sm.failures.append(f"p20 {arch} rank {r}: logits differ "
                                   f"from rank 0")
            for step, lg in enumerate(lm["logits"]):
                if lg.shape != (b, cfg.vocab) or not np.isfinite(lg).all() \
                        or float(lg.std()) == 0.0:
                    sm.failures.append(f"p20 {arch} rank {r} step {step}: "
                                       f"logits {lg.shape} not finite or "
                                       f"constant")
            sl = lm["slices"]
            m = P20_RANKS
            want = {"head_cols": pad_vocab(cfg.vocab) // m}
            if api.family == "audio":
                want["xq_cols"] = cfg.d_model // m
            else:
                e = cfg.moe.n_experts // m
                n_moe = cfg.n_layers - cfg.dense_first_n
                qk = (cfg.mla.qk_nope + cfg.mla.qk_rope if cfg.mla
                      else cfg.hd)
                want.update(banks=[e] * 3 * n_moe, router_cols=[e] * n_moe,
                            q_cols=cfg.n_heads * qk // m)
                if cfg.mla is not None:
                    want["uk_cols"] = cfg.n_heads * cfg.mla.qk_nope // m
            # each cache leaf differs from one device's in one axis, kv_seq,
            # which holds half the positions
            diffs = [[(a, w) for a, w in zip(g, o) if a != w]
                     for g, o in zip(lm["cache_shapes"],
                                     want1["cache_shapes"])]
            if sl != want or not diffs or any(
                    len(d) != 1 or 2 * d[0][0] != d[0][1] for d in diffs):
                sm.failures.append(
                    f"p20 {arch} rank {r}: slices {sl} (want {want}), cache "
                    f"blocks {lm['cache_shapes']} of "
                    f"{want1['cache_shapes']}")
    for r, res in enumerate(ranks):
        if not p18_equal(res["sched"]["results"], one["sched"]["results"]):
            sm.failures.append(f"p20 rank {r}: {P20_SCHED_ARCH} scheduler "
                               f"tickets differ from one device")


def p20_banks(sm):
    """K1 over a 32-expert bank at the rank's prefill shape (M 256 an
    expert) for olmoe's gate/up and down at both layers' formats, held
    bitwise against its plain version, then timed against its bound and a
    ``torch._int_mm`` loop over the 32 experts."""
    from repro_torch import configs
    from repro_torch.nn.moe import capacity
    cfg = configs.get("olmoe-1b-7b").cfg
    b, s_, _ = P20_RUNS[0][2]
    m = b * capacity(cfg.moe, s_)
    e = cfg.moe.n_experts // P20_RANKS
    return [k1_bank_row(sm, f"olmoe rank bank w{w}k{k}", m, kdim, n, e, w,
                        k)
            for kdim, n in P20_BANKS for w, k in P20_BANK_FORMATS]


def phase_p20(sm, card):
    """Phase 20: olmoe-1b-7b x2 (expert parallelism, K4 under a kv4
    plan, a GenerateScheduler), deepseek-v2-lite-16b x3 (MLA's latent
    cache, shared experts, the dense first layer) and whisper-base (the
    cross cache) on one device here, then on a (1, 2) mesh of two ranks
    sharing cuda:0 -> (the ranks' summed launches, the bank rows)."""
    t0 = time.perf_counter()
    release(sm)
    one = p20_cells(None, sm.device)
    release(sm)
    t1 = time.perf_counter()
    from repro_torch.launch import mesh as mesh_lib
    ranks = mesh_lib.spawn(p20_rank, P20_RANKS, (None,),
                           store_dir=str(ROOT / "build" / "p20"),
                           backend="gloo", timeout_s=500)
    spawn_s = time.perf_counter() - t1
    p20_check(sm, ranks, one)
    sm.check_phase("20 tensor-parallel olmoe (expert parallel), deepseek "
                   "(MLA latent) and whisper (cross cache), (1, 2) mesh on "
                   "cuda:0: prefill and decode logits bitwise, tokens "
                   "equal, ranks equal, launches, slices, scheduler")
    release(sm)
    banks = p20_banks(sm)
    sm.check_phase("20 K1 over a rank's 32-expert bank vs mpmm_torch")
    launches = {}
    for res in ranks:
        for cell in [a for a, _, _ in P20_RUNS] + ["sched"]:
            launches = add_counts(launches, res[cell]["counts"])
    for arch, depth, (b, s_, n_new) in P20_RUNS:
        runs_ = (("one device", one[arch]), ("rank 0", ranks[0][arch]),
                 ("rank 1", ranks[1][arch]))
        pre = ", ".join(f"{k} {v['prefill_s'] * 1e3:.1f} ms"
                        for k, v in runs_)
        dec = ", ".join(f"{k} {(v['s'] - v['prefill_s']) / (n_new - 1) * 1e3:.1f}"
                        f" ms" for k, v in runs_)
        frames = (f" + {p20_api(arch, depth).cfg.n_audio} frames"
                  if arch == "whisper-base" else "")
        log(f"[p20-time] {arch} {f'x{depth}' if depth else 'whole'} {b} x "
            f"{s_}{frames} + "
            f"{n_new} host clock: prefill {pre}; decode per step {dec}  "
            f"({card})")
        for step, calls in ranks[0][arch]["collectives"].items():
            kinds = {}
            for _, kind, nb, ms in calls:
                k = kinds.setdefault(kind, [0, 0, 0.0])
                k[0] += 1
                k[1] += nb
                k[2] += ms
            log(f"[p20-time] {arch} rank 0 collectives per {step} (bytes of "
                f"the rank's shard, sent once and received once at M = 2; "
                f"host ms, card synchronized around each, through the "
                f"host, gloo): " + "; ".join(
                    f"{k} {v[0]} calls {v[1]} B {v[2]:.2f} ms"
                    for k, v in sorted(kinds.items())) + f"  ({card})")
    for r in banks:
        log(f"[p20-time] K1 a rank's olmoe bank {r['shape']} route "
            f"{r['route']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, {r['library']} "
            f"{r['library_ms']:.4f} ms (kernel/library "
            f"{r['ms'] / r['library_ms']:.2f}x), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it)  "
            f"({card})")
    log(f"[p20] world started and served in {spawn_s:.1f} s; rank 0 "
        f"launches " + "; ".join(f"{a} {ranks[0][a]['counts']}"
                                 for a, _, _ in P20_RUNS))
    log(f"[p20] phase 20 took {time.perf_counter() - t0:.1f} s")
    return launches, banks


# --- phase 21: tensor-parallel mamba2, recurrentgemma and the fp baseline --


P21_RANKS = 2
# (arch, depth, fp baseline?, (batch, prompt tokens, new tokens)): mamba2's
# 250 tokens are no multiple of its chunk (256); recurrentgemma's 2040 + 16
# pass its 2048-slot window, so the ring wraps during decode
P21_RUNS = (("mamba2-1.3b", 4, False, (4, 250, 8)),
            ("recurrentgemma-9b", 3, False, (2, 2040, 16)),
            ("granite-8b", 2, True, (4, 256, 8)))
P21_KINDS = P20_KINDS + (("ring_decode_attention", "ring split decode"),
                         ("_gated_out", "SSD gated-norm gather"),
                         ("qlinear_serve_apply",
                          "fp row-shard input gather"))
# K1 accumulator-only at a rank's row shards (w4k4, the default policy):
# (label, M, K, N) -- mamba2's out (prefill 4 x 256 padded rows, decode
# 4), recurrentgemma's w_a / w_x (prefill 2 x 2040, decode 2), K halved
P21_ACC = (("mamba2 out", 1024, 2048, 2048), ("mamba2 out", 4, 2048, 2048),
           ("rg w_a", 4080, 2048, 4096), ("rg w_a", 2, 2048, 4096))


def p21_label(arch, depth, fp):
    return f"{arch} x{depth}" + (" fp" if fp else "")


def p21_api(arch, depth, fp):
    """Phase 21's arch at full width, cut to ``depth`` layers, under its
    default policy or the fp baseline."""
    from repro_torch.core.precision import PrecisionPolicy
    return family_api(arch, PrecisionPolicy(quantize=False) if fp else None,
                      depth)


def p21_cols(p):
    """(columns, rows) of a serve layer: packed rows, or an fp weight's."""
    w = p["w"] if "w" in p else p["planes"]
    return int(w.shape[-1]), int(w.shape[-2])


def p21_slices(api, params):
    """What a rank holds of the tree: (columns, rows) of the projections,
    the conv's channels, the head's columns."""
    lp = params["layers"][0]
    out = {"head": p21_cols(params["head"])}
    if api.family == "ssm":
        blk = lp["ssm"]
        out.update({k: p21_cols(blk[k]) for k in ("in_xbc", "in_z", "out")},
                   conv=int(blk["conv"]["w"].shape[-1]),
                   heads=int(blk["A_log"].shape[0]))
    elif api.family == "hybrid":
        rnn, att = lp["rnn"], params["layers"][2]["attn"]
        out.update({k: p21_cols(rnn[k]) for k in ("in_x", "w_a", "out")},
                   w_a_gamma=int(rnn["w_a"]["gamma"].shape[-1]),
                   conv=int(rnn["conv"]["w"].shape[-1]),
                   q=p21_cols(att["q"]), o=p21_cols(att["o"]),
                   gate=p21_cols(lp["mlp"]["gate"]))
    else:
        out.update(q=p21_cols(lp["attn"]["q"]), o=p21_cols(lp["attn"]["o"]),
                   gate=p21_cols(lp["mlp"]["gate"]),
                   down=p21_cols(lp["mlp"]["down"]))
    return out


def p21_want_slices(api, m):
    """``p21_slices`` of a rank of ``m``, from the whole serve specs: its
    heads' (channels') columns and packed rows, mamba2's x columns with B
    and C whole, the fp baseline's rows whole."""
    from repro_torch.nn import param as nnp
    spec = nnp.strip_markers(api.specs("serve"))
    lp = spec["layers"][0]

    def col(p):
        c, r = p21_cols(p)
        return (c // m, r)

    def row(p):
        c, r = p21_cols(p)
        return (c, r if "w" in p else r // m)
    out = {"head": col(spec["head"])}
    if api.family == "ssm":
        s = api.cfg.ssm
        gn2 = 2 * s.n_groups * s.d_state
        out.update(in_xbc=(s.d_inner // m + gn2,
                           p21_cols(lp["ssm"]["in_xbc"])[1]),
                   in_z=col(lp["ssm"]["in_z"]), out=row(lp["ssm"]["out"]),
                   conv=s.d_inner // m + gn2, heads=s.n_heads // m)
    elif api.family == "hybrid":
        rnn = lp["rnn"]
        dr = api.cfg.rnn.d_rnn
        out.update(in_x=col(rnn["in_x"]), w_a=row(rnn["w_a"]),
                   out=row(rnn["out"]), w_a_gamma=dr // m, conv=dr // m,
                   q=col(spec["layers"][2]["attn"]["q"]),
                   o=row(spec["layers"][2]["attn"]["o"]),
                   gate=col(lp["mlp"]["gate"]))
    else:
        out.update(q=col(lp["attn"]["q"]), o=row(lp["attn"]["o"]),
                   gate=col(lp["mlp"]["gate"]), down=row(lp["mlp"]["down"]))
    return out


def p21_cells(mesh, device):
    """Phase 21's runs on ``mesh`` (None: one device) -> {label: results}
    with each run's launch counts, its decode cache's leaf shapes and, on
    a mesh, the rank's slices and collectives."""
    import gc
    import numpy as np
    import torch as t
    from repro_torch.kernels.mpmm import kernel
    from repro_torch.runtime.serve import Generator, init_packed_lm

    def counts():
        c = read_p11()
        c["acc_only"] = kernel.mpmm_cuda.acc_launches
        return c
    out = {}
    for arch, depth, fp, (b, s_, n_new) in P21_RUNS:
        api = p21_api(arch, depth, fp)
        packed = init_packed_lm(api, t.Generator(device=device).manual_seed(
            SEED), device=device)
        gen = Generator(api=api, params=packed, device=device, mesh=mesh)
        del packed
        prompts = np.random.default_rng(SEED).integers(
            0, api.cfg.vocab, (b, s_)).astype(np.int32)
        gen.generate(prompts[:, :min(s_, 256)], 2)  # warm-up
        t.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        toks, logits = gen.run(prompts, n_new)
        t.cuda.synchronize()
        res = {"tokens": toks, "logits": [lg.float().cpu().numpy()
                                          for lg in logits],
               "counts": counts(), "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        gen.run(prompts, 1)
        t.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        col = Collectives(t, P21_KINDS) if mesh is not None else None
        with col or contextlib.nullcontext():
            pre = gen.prefill(t.as_tensor(prompts, dtype=t.long,
                                          device=device))[1]
            cache = gen._grow_cache(pre, b, s_, s_ + n_new)
        del pre
        res["cache_shapes"] = [tuple(x.shape) for x in tree_leaves(cache)]
        if mesh is not None:
            res["slices"] = p21_slices(api, gen.params)
            res["collectives"] = {"prefill": col.calls}
            with Collectives(t, P21_KINDS) as col:  # one decode step
                gen.decode(cache, t.as_tensor(toks[:, :1], dtype=t.long,
                                              device=device), s_)
            res["collectives"]["decode"] = col.calls
        del cache
        out[p21_label(arch, depth, fp)] = res
        del gen
        gc.collect()
        t.cuda.empty_cache()
    return out


def p21_rank(rank, _args):
    """One rank of phase 21's world: two ranks on cuda:0 over gloo, a
    (1, 2) mesh, the kernels loaded from the libraries the parent built."""
    import torch as t
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    stale = [n for n in _build.KERNEL_SOURCES if _build._stale(n)]

    def refuse(name, nvcc):
        raise RuntimeError(f"rank {rank} would run nvcc for {name}")
    _build._start = refuse
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    mesh = mesh_lib.make_serve_mesh(
        1, P21_RANKS, devices=["cuda:0"] * P21_RANKS)
    out = p21_cells(mesh, mesh_lib.local_device(mesh))
    out["stale"] = stale
    out["backend"] = mesh_lib.mesh_info(mesh).backend
    out["coords"] = mesh_lib.model_coords(mesh)
    return out


def p21_expected(api, b, s, n_new):
    """(K1 launches by route, K3 launches, accumulator-only launches) of
    one ``Generator.run`` on a rank of a 'model' axis above 1: the
    one-device launches (each projection once, over the rank's share),
    of which the row shards run accumulator-only -- mamba2's ``out``; an
    R layer's ``w_a``, ``w_x``, ``out`` and the MLP's down, an A layer's
    o and down.  The fp baseline launches no K1."""
    cfg = api.cfg
    if api.family not in ("ssm", "hybrid"):
        _, k3, _ = expected_counts(api, b, s, n_new)
        return {}, k3, 0
    routes, k3 = p13_expected(api, b, s, n_new)
    if api.family == "ssm":
        return routes, k3, cfg.n_layers * n_new
    from repro_torch.models.recurrentgemma import layer_kind
    per_step = sum(4 if layer_kind(cfg, i) == "R" else 2
                   for i in range(cfg.n_layers))
    return routes, k3, per_step * n_new


def p21_cache_shapes(api, b, max_len, m):
    """The decode cache's leaf shapes, from ``cache_specs`` (a rank of
    ``m``: ``max_len`` rounded up to a multiple of it, its block)."""
    max_len = -(-max_len // m) * m
    return [tuple(x.shape) for x in tree_leaves(api.cache_specs(
        b, max_len, model=m))]


def p21_check(sm, ranks, one):
    """Every run: prefill and decode logits bitwise one device, tokens
    equal, both ranks' logits equal, each rank's launches
    (``p21_expected``; one device: the same without accumulator-only
    calls), its slices (``p21_want_slices``) and its decode cache's
    shapes (``cache_specs(model=2)``: the SSM heads, the RG-LRU channels,
    half the ring's slots, half the KV positions)."""
    import numpy as np
    for arch, depth, fp, (b, s_, n_new) in P21_RUNS:
        api = p21_api(arch, depth, fp)
        cfg = api.cfg
        label = p21_label(arch, depth, fp)
        routes, k3, acc = p21_expected(api, b, s_, n_new)
        want1 = one[label]
        for who, res, want_acc in ([("one device", want1, 0)]
                                   + [(f"rank {r}", x[label], acc)
                                      for r, x in enumerate(ranks)]):
            c = res["counts"]
            got = {k[6:]: v for k, v in c.items()
                   if k.startswith("route:") and v}
            if (got != routes or c["flash_fwd_cuda"] != k3
                    or c["flash_fwd_packed_cuda"] or c["conv_mpmm_cuda"]
                    or c["acc_only"] != want_acc):
                sm.failures.append(
                    f"p21 {label} {who} launches {c} != {routes} K3 {k3} "
                    f"acc-only {want_acc}")
        if want1["cache_shapes"] != p21_cache_shapes(api, b, s_ + n_new, 1):
            sm.failures.append(f"p21 {label} one device: cache "
                               f"{want1['cache_shapes']}")
        for r, res in enumerate(ranks):
            lm = res[label]
            if res["stale"] or res["backend"] != "gloo" \
                    or res["coords"] != (r, P21_RANKS):
                sm.failures.append(f"p21 rank {r}: stale {res['stale']}, "
                                   f"backend {res['backend']}, coords "
                                   f"{res['coords']}")
            if not np.array_equal(lm["logits"][0], want1["logits"][0]):
                sm.failures.append(f"p21 {label} rank {r}: prefill logits "
                                   f"not bitwise one device")
            bad = [i for i, (a, w) in enumerate(zip(lm["logits"][1:],
                                                     want1["logits"][1:]))
                   if not np.array_equal(a, w)]
            if bad:
                sm.failures.append(f"p21 {label} rank {r}: decode logits "
                                   f"not bitwise one device at steps {bad}")
            if not np.array_equal(lm["tokens"], want1["tokens"]):
                sm.failures.append(f"p21 {label} rank {r}: tokens differ "
                                   f"from one device")
            if r and not p18_equal(lm["logits"], ranks[0][label]["logits"]):
                sm.failures.append(f"p21 {label} rank {r}: logits differ "
                                   f"from rank 0")
            for step, lg in enumerate(lm["logits"]):
                if lg.shape != (b, cfg.vocab) or not np.isfinite(lg).all() \
                        or float(lg.std()) == 0.0:
                    sm.failures.append(f"p21 {label} rank {r} step {step}: "
                                       f"logits {lg.shape} not finite or "
                                       f"constant")
            want = p21_want_slices(api, P21_RANKS)
            shapes = p21_cache_shapes(api, b, s_ + n_new, P21_RANKS)
            if lm["slices"] != want or lm["cache_shapes"] != shapes:
                sm.failures.append(
                    f"p21 {label} rank {r}: slices {lm['slices']} (want "
                    f"{want}), cache {lm['cache_shapes']} (want {shapes})")


def p21_kernels(sm):
    """(a) K1 accumulator-only at a rank's row shards of mamba2's ``out``
    and recurrentgemma's gates (``P21_ACC``), bitwise its plain twin, then
    timed against its bound, its plain twin and ``torch._int_mm``
    (``torch.mm`` in f32 where that refuses the shape); (b) K3 over a
    rank's 8 of recurrentgemma's 16 heads (D 256, MQA, window 2048, 2 x
    2040 tokens) bitwise the 16-head call's heads, then timed as
    ``measure_d256`` times the whole (SDPA with the same window mask) ->
    (K1 rows, the K3 row)."""
    from repro_torch.core import packing
    from repro_torch.kernels.flashattn import ops as fops
    from repro_torch.kernels.mpmm import kernel, ops
    t = sm.torch
    rows = []
    for label, m, kdim, n in P21_ACC:
        g = t.Generator(device=sm.device).manual_seed(m + kdim + n)
        fmt = packing.PlaneFormat(w_bits=4, k=4, k_dim=kdim)
        w_int = t.randint(-8, 8, (kdim, n), generator=g, device=sm.device,
                          dtype=t.int32)
        planes = packing.pack_planes(w_int, fmt)
        del w_int
        a = t.randint(-128, 128, (m, kdim), generator=g, device=sm.device,
                      dtype=t.int32).to(t.int8)
        route = kernel.mpmm_route(m, kdim, n)
        acc = ops.mpmm_acc(a, planes, fmt=fmt, impl="cuda")
        sm.compare("mpmm_cuda", f"p21 K1 {route} acc-only {label} M={m} "
                   f"K={kdim} N={n}", acc,
                   kernel.mpmm_torch_acc(a, planes, fmt=fmt).cpu())
        lib, lib_name = k1_library(sm, {"a_biased": a, "planes": planes},
                                   fmt)
        b_ms, by = bound_ms(nbytes(a, planes) + m * n * 4, 2 * m * kdim * n)
        rows.append({"name": label, "m": m, "k": kdim, "n": n,
                     "route": route,
                     "ms": sm.time_ms(lambda: kernel.mpmm_cuda(
                         a, planes, None, None, fmt=fmt, act_zero=0,
                         out_dtype=t.int32)),
                     "plain_ms": sm.time_ms(lambda: kernel.mpmm_torch_acc(
                         a, planes, fmt=fmt), reps=3, warmup=1),
                     "library_ms": sm.time_ms(lib), "library": lib_name,
                     "bound_ms": b_ms, "bound_by": by})
        del a, planes, acc, lib
    api = p21_api("recurrentgemma-9b", 3, False)
    cfg = api.cfg
    g = t.Generator(device=sm.device).manual_seed(521)
    mk = lambda h: t.randn((2, 2040, h, cfg.hd), generator=g,  # noqa: E731
                           device=sm.device).to(t.bfloat16)
    q, k, v = mk(cfg.n_heads), mk(cfg.n_kv), mk(cfg.n_kv)
    run = lambda qq: fops.flash_attention(  # noqa: E731
        qq, k, v, window=cfg.window, block_k=cfg.attn_chunk, impl="cuda")
    whole = run(q)
    h = cfg.n_heads // P21_RANKS
    for r in range(P21_RANKS):
        part = run(q[:, :, r * h:(r + 1) * h].contiguous())
        sm.compare("flash_fwd_cuda", f"p21 K3 D256 heads {r * h}-"
                   f"{(r + 1) * h - 1} of {cfg.n_heads} vs the whole call",
                   part, whole[:, :, r * h:(r + 1) * h].cpu())
    del q, k, v, whole
    k3 = measure_d256(sm, dataclasses.replace(
        api, cfg=dataclasses.replace(cfg, n_heads=h, head_dim=cfg.hd)), 2,
        2040)
    return rows, k3


def phase_p21(sm, card):
    """Phase 21: mamba2-1.3b x4, recurrentgemma-9b x3 (its ring wrapping
    in decode) and granite-8b x2 as the fp baseline on one device here,
    then on a (1, 2) mesh of two ranks sharing cuda:0; then K1
    accumulator-only at the ranks' row shards and K3 over a rank's heads
    -> (the ranks' summed launches, the K1 rows, the K3 row)."""
    t0 = time.perf_counter()
    release(sm)
    one = p21_cells(None, sm.device)
    release(sm)
    t1 = time.perf_counter()
    from repro_torch.launch import mesh as mesh_lib
    ranks = mesh_lib.spawn(p21_rank, P21_RANKS, (None,),
                           store_dir=str(ROOT / "build" / "p21"),
                           backend="gloo", timeout_s=500)
    spawn_s = time.perf_counter() - t1
    p21_check(sm, ranks, one)
    sm.check_phase("21 tensor-parallel mamba2 (SSD heads), recurrentgemma "
                   "(RG-LRU channels, the ring) and the fp baseline, (1, 2) "
                   "mesh on cuda:0: prefill and decode logits bitwise, "
                   "tokens equal, ranks equal, launches, slices, caches")
    release(sm)
    acc_rows, k3_row = p21_kernels(sm)
    sm.check_phase("21 K1 accumulator-only at the ranks' row shards vs "
                   "mpmm_torch_acc; K3 over a rank's heads vs the whole")
    launches = {}
    for res in ranks:
        for arch, depth, fp, _ in P21_RUNS:
            launches = add_counts(launches,
                                  res[p21_label(arch, depth, fp)]["counts"])
    for arch, depth, fp, (b, s_, n_new) in P21_RUNS:
        label = p21_label(arch, depth, fp)
        runs_ = (("one device", one[label]), ("rank 0", ranks[0][label]),
                 ("rank 1", ranks[1][label]))
        pre = ", ".join(f"{k} {v['prefill_s'] * 1e3:.1f} ms"
                        for k, v in runs_)
        dec = ", ".join(
            f"{k} {(v['s'] - v['prefill_s']) / (n_new - 1) * 1e3:.1f} ms"
            for k, v in runs_)
        log(f"[p21-time] {label} {b} x {s_} + {n_new} host clock: prefill "
            f"{pre}; decode per step {dec}  ({card})")
        for step, calls in ranks[0][label]["collectives"].items():
            kinds = {}
            for _, kind, nb, ms in calls:
                k = kinds.setdefault(kind, [0, 0, 0.0])
                k[0] += 1
                k[1] += nb
                k[2] += ms
            log(f"[p21-time] {label} rank 0 collectives per {step} (bytes "
                f"of the rank's shard, sent once and received once at M = "
                f"2; host ms, card synchronized around each, through the "
                f"host, gloo): " + "; ".join(
                    f"{k} {v[0]} calls {v[1]} B {v[2]:.2f} ms"
                    for k, v in sorted(kinds.items())) + f"  ({card})")
    for r in acc_rows:
        log(f"[p21-time] K1 acc-only {r['name']} shard M={r['m']} "
            f"K={r['k']} N={r['n']} w4k4 route {r['route']}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"{r['library']} {r['library_ms']:.4f} ms (kernel/library "
            f"{r['ms'] / r['library_ms']:.2f}x), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it)  "
            f"({card})")
    log(f"[p21-time] K3 a rank's {k3_row['shape']}: kernel "
        f"{k3_row['ms']:.4f} ms, plain {k3_row['plain_ms']:.4f} ms, SDPA "
        f"{k3_row['library_ms']:.4f} ms (kernel/library "
        f"{k3_row['ms'] / k3_row['library_ms']:.2f}x), bound "
        f"{k3_row['bound_ms']:.4f} ms ({k3_row['bound_by']}; "
        f"{k3_row['bound_ms'] / k3_row['ms']:.1%} of it)  ({card})")
    log(f"[p21] world started and served in {spawn_s:.1f} s; rank 0 "
        f"launches " + "; ".join(
            f"{p21_label(a, d, f)} {ranks[0][p21_label(a, d, f)]['counts']}"
            for a, d, f, _ in P21_RUNS))
    log(f"[p21] phase 21 took {time.perf_counter() - t0:.1f} s")
    return launches, acc_rows, k3_row


# --- phase 22: data-parallel and FSDP training over ('pod', 'data') ---------

P22_ARCH = "whisper-base"
P22_BATCH, P22_SEQ, P22_MB = 4, 64, 2   # phase 16's batch, M = n = 2
P22_RANKS = 2
P22_STEPS, P22_CKPT_EVERY = 4, 2
P22_ABANDON = "abandon"   # tells a waiting world that the first one failed


def p22_api():
    return dataclasses.replace(family_api(P22_ARCH), microbatches=P22_MB)


def p22_trainer(api, ckpt_dir, total, **kw):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.train import TrainLoopConfig, Trainer
    cfg = api.cfg
    pipe = SyntheticLM(vocab=cfg.vocab, seq_len=P22_SEQ,
                       global_batch=P22_BATCH, seed=SEED, with_frames=True,
                       n_audio=cfg.n_audio, d_model=cfg.d_model)
    return Trainer(api, pipe, TrainLoopConfig(
        total_steps=total, ckpt_every=P22_CKPT_EVERY, ckpt_dir=str(ckpt_dir),
        log_every=100, async_ckpt=False, peak_lr=P14_LR), **kw)


def p22_run(tr, device):
    """``tr.run`` from the seeded generator -> (final state, metrics a
    step as floats)."""
    import torch as t
    metrics = []
    state, _ = tr.run(t.Generator(device=device).manual_seed(SEED),
                      on_metrics=lambda step, m: metrics.append(dict(m)))
    return state, metrics


def p22_same_files(a, b, step):
    """Whether checkpoint ``step`` holds the same files, byte for byte,
    under ``a`` and ``b``."""
    import filecmp
    pa, pb = Path(a) / f"step_{step:010d}", Path(b) / f"step_{step:010d}"
    names = sorted(f.name for f in pa.iterdir())
    return names == sorted(f.name for f in pb.iterdir()) and all(
        filecmp.cmp(pa / n, pb / n, shallow=False) for n in names)


def p22_want_held(api, rank):
    """The bytes of rank ``rank``'s FSDP blocks of the train state, from
    the state's shapes and ``train_state_shardings``."""
    from types import SimpleNamespace
    import numpy as np
    import torch as t
    from repro_torch.launch import steps as steps_lib
    from repro_torch.nn import partitioning as part
    from repro_torch.tree import flatten_with_paths
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.zeros((P22_RANKS, 1)),
                           get_local_rank=lambda ax: rank)
    sh = flatten_with_paths(steps_lib.train_state_shardings(api, mesh))
    total = 0
    for path, spec in flatten_with_paths(
            steps_lib.train_state_specs(api)).items():
        shape = tuple(spec.shape)
        idx = part.local_index(shape, sh[path])
        n = 1
        for i, d in zip(idx, shape):
            n *= len(range(*i.indices(d)))
        total += n * t.empty((), dtype=spec.dtype).element_size()
    return total


def p22_bytes(state):
    from repro_torch.tree import leaves
    return sum(x.numel() * x.element_size() for x in leaves(state))


class P22Timers:
    """The meshed step's parts, timed on the host clock with the card
    synchronized around each: forward and backward
    (``launch.steps.value_and_grad``), the parameter gathers
    (``nn.partitioning.gather_by`` inside a step; bytes received), the
    gradient sum (``launch.steps._sum_over_batch``; the rank's f32
    gradient bytes, sent once and received once at n = 2) and AdamW
    (``adamw_update`` on the rank's blocks), each step's apart."""

    def __init__(self, trainer):
        import torch as t
        from repro_torch.launch import steps as steps_lib
        from repro_torch.nn import partitioning as part
        from repro_torch.tree import leaves
        self.steps = []   # per step: {part: [seconds, bytes]}
        self.active = False

        def timed(name, fn, nbytes=None):
            def run(*a, **kw):
                if not self.active:
                    return fn(*a, **kw)
                t.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                t.cuda.synchronize()
                acc = self.steps[-1].setdefault(name, [0.0, 0])
                acc[0] += time.perf_counter() - t0
                acc[1] += nbytes(a, out) if nbytes else 0
                return out
            return run

        def size(tree):
            return sum(x.numel() * x.element_size() for x in leaves(tree))
        steps_lib.value_and_grad = timed("fwd_bwd", steps_lib.value_and_grad)
        part.gather_by = timed("gather", part.gather_by,
                               lambda a, out: size(out) - size(a[0]))
        steps_lib._sum_over_batch = timed(
            "grad_sum", steps_lib._sum_over_batch,
            lambda a, out: sum(4 * x.numel() for x in leaves(out)))
        steps_lib.adamw_update = timed("adamw", steps_lib.adamw_update)
        step = trainer.train_step

        def train_step(state, batch):
            self.steps.append({})
            self.active = True
            try:
                return step(state, batch)
            finally:
                self.active = False
        trainer.train_step = train_step

    def last(self):
        """{part: (ms, bytes)} of the last step."""
        return {k: (1e3 * v[0], v[1]) for k, v in self.steps[-1].items()}


def p22_rank(rank, args):
    """One rank of a phase-22 world: two ranks on cuda:0 over gloo, a (2,
    1) training mesh; the ``Trainer`` under ``ckpt_dir`` to step
    ``total``, after ``wait_for`` (a checkpoint's folder) appears, where
    given.  No kernel runs on this path: a rank that would build one
    fails."""
    import torch as t
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    ckpt_dir, total, wait_for = args

    def refuse(name, nvcc):
        raise RuntimeError(f"rank {rank} would run nvcc for {name}")
    _build._start = refuse
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = mesh_lib.make_train_mesh((P22_RANKS, 1),
                                    devices=["cuda:0"] * P22_RANKS)
    device = mesh_lib.local_device(mesh)
    waited = 0.0
    if wait_for is not None:
        # what a first step imports (torch._dynamo, for the remat's
        # checkpoint), while the other world trains
        import torch._dynamo  # noqa: F401
        t1 = time.perf_counter()
        while not Path(wait_for).exists():
            if (Path(ckpt_dir) / P22_ABANDON).exists() or \
                    time.perf_counter() - t1 > 280:
                raise RuntimeError(f"rank {rank}: no {wait_for}")
            time.sleep(0.1)
        waited = time.perf_counter() - t1
    tr = p22_trainer(p22_api(), ckpt_dir, total, mesh=mesh)
    timers = P22Timers(tr)
    state, metrics = p22_run(tr, device)
    return {"metrics": metrics, "step_s": tr.step_seconds,
            "save_s": tr.save_seconds, "restore_s": tr.restore_seconds,
            "held": p22_bytes(state), "parts": timers.last(),
            "backend": mesh_lib.mesh_info(mesh).backend,
            "coords": mesh_lib.data_coords(mesh), "waited": waited,
            "s": time.perf_counter() - t0}


def phase_p22(sm, card):
    """Phase 22 -> its results: the one-device run to step 4, a world of
    two ranks to step 2, a fresh world from its checkpoint to step 4, and
    this process from the ranks' step-2 checkpoint to step 4."""
    import shutil
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.tree import leaves
    t = sm.torch
    t0 = time.perf_counter()
    release(sm)
    api = p22_api()
    # five checkpoints of the f32 state (parameters and two moments)
    root = ckpt_root("p22", api.total_params() * 12 * 5)
    one_dir, mesh_dir, back_dir = root / "one", root / "mesh", root / "back"
    store = str(ROOT / "build" / "p22")
    step2 = f"step_{P22_CKPT_EVERY:010d}"
    pool = concurrent.futures.ThreadPoolExecutor(2)
    # world A (two ranks to step 2) and world B (two fresh ranks, which
    # wait for A's checkpoint, restore it and train to step 4) start at
    # once, beside the one-device run to step 4 with checkpoints at 2 and
    # 4: a rank's start-up (torch, the card's context, what the first
    # step imports) is most of a world's time.  The one-device restart
    # waits for world B: three processes restoring at once slowed B more
    # than the overlap saved
    world_a = pool.submit(mesh_lib.spawn, p22_rank, P22_RANKS,
                          ((str(mesh_dir), P22_CKPT_EVERY, None),),
                          store_dir=store, backend="gloo", timeout_s=300)
    world_b = pool.submit(mesh_lib.spawn, p22_rank, P22_RANKS,
                          ((str(mesh_dir), P22_STEPS,
                            str(mesh_dir / step2)),),
                          store_dir=store, backend="gloo", timeout_s=300)
    try:
        one = p22_trainer(api, one_dir, P22_STEPS, device=sm.device)
        s_one, m_one = p22_run(one, sm.device)
        one_held = p22_bytes(s_one)
        t1 = time.perf_counter()
        a = world_a.result()
    except BaseException:
        mesh_dir.mkdir(parents=True, exist_ok=True)
        (mesh_dir / P22_ABANDON).touch()
        raise
    t2 = time.perf_counter()
    same2 = p22_same_files(mesh_dir, one_dir, P22_CKPT_EVERY)
    shutil.rmtree(back_dir, ignore_errors=True)
    back_dir.mkdir(parents=True)
    shutil.copytree(mesh_dir / step2, back_dir / step2)
    b = world_b.result()
    t3 = time.perf_counter()
    pool.shutdown()
    # this process restores the ranks' step-2 checkpoint on one device and
    # trains to step 4, once world B is done with the card
    back = save_only_at(p22_trainer(api, back_dir, P22_STEPS,
                                    device=sm.device), ())
    s_back, m_back = p22_run(back, sm.device)
    t4 = time.perf_counter()
    same_back = m_back == m_one[P22_CKPT_EVERY:] and all(
        t.equal(x, y) for x, y in zip(leaves(s_back), leaves(s_one)))
    ok = {
        "world A metrics": all(r["metrics"] == m_one[:P22_CKPT_EVERY]
                               for r in a),
        "world B metrics": all(r["metrics"] == m_one[P22_CKPT_EVERY:]
                               for r in b),
        "step 2 files": same2,
        "step 4 files": p22_same_files(mesh_dir, one_dir, P22_STEPS),
        "one-device restart": same_back,
        "restored": all(r["restore_s"] is not None for r in b),
        "blocks": [r["held"] for r in a] == [r["held"] for r in b]
        == [p22_want_held(api, r) for r in range(P22_RANKS)],
        "gloo on cuda:0": all(r["backend"] == "gloo" for r in a + b)
        and [r["coords"] for r in a] == [(0, 2), (1, 2)]}
    del s_one, s_back
    shutil.rmtree(root, ignore_errors=True)
    release(sm)
    for name, good in ok.items():
        if not good:
            sm.failures.append(f"phase 22: {name}")
    log(f"[p22] whisper-base x{api.cfg.n_layers} (6 + 6, "
        f"{api.total_params() / 1e6:.1f} M parameters), {P22_BATCH} x "
        f"{P22_SEQ} + {api.cfg.n_audio} frames, M = {P22_MB}: losses "
        f"{[m['loss'] for m in m_one]}, grad_norm "
        f"{[m['grad_norm'] for m in m_one]}; checks {ok}")
    sm.check_phase("22 data-parallel and FSDP training of whisper-base, (2, "
                   "1) mesh on cuda:0: metrics, checkpoints of steps 2 and "
                   "4 and both restarts bitwise one device, each rank its "
                   "blocks")
    out = {"one": {"step_s": one.step_seconds, "save_s": one.save_seconds,
                   "held": one_held},
           "back": {"restore_s": back.restore_seconds,
                    "step_s": back.step_seconds},
           "a": a, "b": b, "s": (t1 - t0, t2 - t1, t3 - t2, t4 - t3),
           "params": api.total_params()}
    ends = [sum(out["s"][:i + 1]) for i in range(4)]
    log(f"[p22] phase 22 took {time.perf_counter() - t0:.1f} s: the one "
        f"device run {ends[0]:.1f} s and world A {ends[1]:.1f} s from the "
        f"phase's start; world B started with them, waited "
        f"{b[0]['waited']:.1f} s for A's checkpoint and ended at "
        f"{ends[2]:.1f} s; then the one-device restart {out['s'][3]:.1f} s")
    print_p22(out, card)
    return out


def print_p22(p22, card):
    """Phase 22's ``[p22-time]`` lines."""
    one, a, b = p22["one"], p22["a"], p22["b"]
    ms = lambda v: [round(x * 1e3, 1) for x in v]  # noqa: E731
    log(f"[p22-time] whisper-base one device, {P22_MB} microbatches (beside "
        f"the worlds' start-up): steps {ms(one['step_s'])} ms, saves "
        f"{ms(one['save_s'])} ms (state {one['held'] / 1e6:.1f} MB); restart "
        f"from the ranks' step-2 checkpoint (after world B): "
        f"restore {p22['back']['restore_s'] * 1e3:.1f} ms, steps "
        f"{ms(p22['back']['step_s'])} ms  (host clock; {card})")
    for label, world in (("A (steps 0-1)", a), ("B (steps 2-3)", b)):
        for r in world:
            rank = r["coords"][0]
            parts = r["parts"]
            log(f"[p22-time] world {label} rank {rank} (1 microbatch a "
                f"step): steps {ms(r['step_s'])} ms; the last step's "
                f"forward and backward {parts['fwd_bwd'][0]:.1f} ms, "
                f"parameter gathers {parts['gather'][0]:.1f} ms for "
                f"{parts['gather'][1] / 1e6:.1f} MB received, gradient sum "
                f"{parts['grad_sum'][0]:.1f} ms over "
                f"{parts['grad_sum'][1] / 1e6:.1f} MB of f32 gradients, "
                f"AdamW on its blocks {parts['adamw'][0]:.1f} ms; save "
                f"{ms(r['save_s'])} ms"
                + (f", restore {r['restore_s'] * 1e3:.1f} ms"
                   if r["restore_s"] is not None else "")
                + f"; resident state {r['held'] / 1e6:.1f} MB against "
                f"{one['held'] / 1e6:.1f} MB on one device "
                f"({r['held'] / one['held']:.3f})  (host clock, card "
                f"synchronized around each part, gloo through the host; "
                f"{card})")


# --- phase 23: tensor-parallel QAT training over 'model' ---------------------

P23_RANKS = 2
P23_LM = ("granite-8b", 2, 2, 256)   # arch, layers, batch, sequence
P23_CNN = ("resnet18", 8)            # arch, batch (224 x 224)
P23_STEPS, P23_LR = 3, 0.1           # lr 0 at step 0, 1e-3 at step 1
# The contract against the one-device step on the same batch, as
# tests/test_torch_tensor_parallel_train.py holds it on the CPU: the losses
# before any update (steps 0 and 1); every leaf's first moment after step 0
# (0.1 x the first clipped gradient: only the order of the sums differs
# there) but the step sizes'; every parameter leaf after 3 steps, relative
# L2.  A step size's gradient (ga, gw) is a sum of LSQ terms that cancel to
# a few ulps of the terms, so the ulp by which a product of another shape
# rounds an element of a cotangent moves it by as much as itself: the step
# sizes are held after 3 steps and bitwise across the ranks.  A leaf that
# starts at zero (ResNet's BN biases) is, after 3 steps, two small AdamW
# steps whose signs follow gradients of cancelling sums, so it is bounded
# apart (P23_ZERO_RTOL).  One device on each batch's rows reversed, the
# same arithmetic in another order, is printed beside them as their noise
# floor.  Measured on an H100 80GB HBM3 at 700 W (granite / ResNet): first
# moments 3.3e-3 / 1.6e-2, leaves after 3 steps 2.9e-2 / 4.6e-2, BN biases
# 0.49; one device on reversed rows 0.37, 6.5e-2, 0.77.  A column shard's
# input cotangent left partial reads 0.76 / 1.4, 0.24 / 0.13, 1.6; its gw
# gradient left unsummed 4.0e-2 / 0.11 after 3 steps, BN biases 0.63.  Both
# faults break the whole leaves' equality across the ranks.
P23_FORWARD_RTOL = 1e-5
P23_FIRST_RTOL = 5e-2
P23_LEAF_RTOL = {"lm": 7e-2, "cnn": 7e-2}
P23_ZERO_RTOL = 0.55
P23_ABANDON = "abandon"
P23_KINDS = {  # the collective's caller -> what it moves
    "_SumModel.forward": "row sums (f32 partial products)",
    "_CopyModel.backward": "copy sums (step-size and k/v gradients)",
    "_ColumnProduct.backward": "column input cotangent sums (f32)",
    "_GatherModel.forward": "channel all-gathers (conv outputs)",
    "_OwnedModel.forward": "owned sums (embedding rows)",
    "_VocabParallelCE.forward": "vocabulary-parallel loss",
    "_model_global_norm": "clip norm",
}


def p23_api(cell):
    from repro_torch import configs
    if cell == "lm":
        arch, depth, _, _ = P23_LM
        api = family_api(arch, depth=depth)
    else:
        api = configs.get(P23_CNN[0])
    return dataclasses.replace(api, microbatches=1)


def p23_batches(api, cell, device):
    """The cell's ``P23_STEPS`` batches (whole: a (1, 2) mesh's ranks
    share one data row) on ``device``."""
    import torch as t
    from repro_torch.data.pipeline import SyntheticImages, SyntheticLM
    out = []
    for i in range(P23_STEPS):
        if cell == "lm":
            _, _, b, s_ = P23_LM
            host = SyntheticLM(vocab=api.cfg.vocab, seq_len=s_,
                               global_batch=b, seed=SEED).batch_at(i)
        else:
            host = SyntheticImages(n_classes=api.cfg.n_classes,
                                   img_size=api.cfg.img_size,
                                   global_batch=P23_CNN[1],
                                   seed=SEED).batch_at(i)
            host = {"tokens": host["images"], "labels": host["labels"]}
        out.append({k: t.as_tensor(v).to(device).to(
            t.long if v.dtype.kind in "iu" else t.float32)
            for k, v in host.items()})
    return out


def p23_sync(device):
    import torch as t
    if t.device(device).type == "cuda":
        t.cuda.synchronize()


def p23_state(api, device, sh=None):
    """The seeded init on ``device`` (the same bits on every process of
    the card), cut to the rank's blocks by ``sh``; zero moments."""
    import torch as t
    from repro_torch.nn import partitioning as part
    from repro_torch.optim import adamw_init
    params = api.init_params(t.Generator(device=device).manual_seed(SEED),
                             "train", device=device)
    if sh is not None:
        params = part.shard_by(params, sh["params"])
    return {"params": params,
            "opt": adamw_init(params, state_dtype=api.opt_dtype),
            "step": t.zeros((), dtype=t.int32, device=device)}


class P23Collectives:
    """Counts every collective of a tensor-parallel step on a rank while
    ``active``: (kind, bytes of the rank's part, host ms with the card
    synchronized around it), the kind read off the outermost calling
    frame that ``kinds`` (default ``P23_KINDS``) names (a column product's
    backward sums through ``sum_model``)."""

    def __init__(self, device, kinds=None):
        kinds = P23_KINDS if kinds is None else kinds
        from repro_torch.launch import mesh as mesh_lib
        self.calls, self.active = [], False
        orig = mesh_lib._gather

        def counted(mesh, axis, n, x):
            if not self.active:
                return orig(mesh, axis, n, x)
            frame, kind = sys._getframe(1), "other"
            while frame is not None:  # the outermost caller named
                kind = kinds.get(frame.f_code.co_qualname, kind)
                frame = frame.f_back
            p23_sync(device)
            t0 = time.perf_counter()
            out = orig(mesh, axis, n, x)
            p23_sync(device)
            self.calls.append((kind, x.numel() * x.element_size(),
                               (time.perf_counter() - t0) * 1e3))
            return out
        mesh_lib._gather = counted

    def by_kind(self):
        kinds = {}
        for kind, nb, ms in self.calls:
            k = kinds.setdefault(kind, [0, 0, 0.0])
            k[0] += 1
            k[1] += nb
            k[2] += ms
        return kinds


def p23_digests(state, sh):
    """{path: sha256} of the leaves no 'model' axis cuts."""
    import hashlib
    import torch as t
    from repro_torch.nn import partitioning as part
    from repro_torch.tree import flatten_with_paths
    shs = flatten_with_paths(sh)
    return {k: hashlib.sha256(v.detach().contiguous().reshape(-1).view(
        t.uint8).cpu().numpy()).hexdigest()
        for k, v in flatten_with_paths(state).items()
        if not part.is_cut(shs[k], "model")}


def p23_saved(api, cell):
    """What a cell saves: the ResNet's whole train state; granite's
    parameters and step (its moments share their shardings and gathers,
    and would triple the phase's 10 GB of writes) -> (the keys, the
    template of their whole shapes)."""
    from repro_torch.launch import steps as steps_lib
    keys = ("params", "opt", "step") if cell == "cnn" else ("params", "step")
    specs = steps_lib.train_state_specs(api)
    return keys, {k: specs[k] for k in keys}


def p23_sq(tree, ref, shp, device):
    """{path: (squared L2 of the difference over the rank's block, squared
    L2 of the reference's block, whether 'model' cuts the leaf)} of
    ``tree`` (the rank's blocks) against ``ref`` (whole, on the host)."""
    import torch as t
    from repro_torch.nn import partitioning as part
    from repro_torch.tree import flatten_with_paths
    out = {}
    for k, v in flatten_with_paths(tree).items():
        r = ref[k]
        r = r[part.local_index(tuple(r.shape), shp[k])].to(device).to(
            t.float64)
        d = v.to(t.float64) - r
        out[k] = (float((d * d).sum()), float((r * r).sum()),
                  part.is_cut(shp[k], "model"))
    return out


def p23_cell_rank(cell, mesh, device, root):
    """One cell on this rank: the tensor-parallel step 3 times (the last
    one's collectives counted), the whole leaves' digests after each step,
    each parameter leaf's squared difference from the one-device result
    (``one-{cell}.pt``, the parent's) over the rank's block, after 3
    steps and, for the first moments, after step 0; then the mesh save
    (``p23_saved``) read back onto the mesh, each rank's blocks against
    its own."""
    import torch as t
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.tree import flatten_with_paths, leaves
    api = p23_api(cell)
    sh = steps_lib.train_state_shardings(api, mesh)
    state = p23_state(api, device, sh)
    held = sum(x.numel() * x.element_size()
               for x in flatten_with_paths(state).values())
    step = steps_lib.make_train_step(api, peak_lr=P23_LR,
                                     total_steps=P23_STEPS, donate=True,
                                     mesh=mesh)
    coll = P23Collectives(device)
    one = t.load(root / f"one-{cell}.pt", mmap=True)
    shp = flatten_with_paths(sh["params"])
    out = {"losses": [], "step_ms": [], "digests": [], "held": held}
    for i, batch in enumerate(p23_batches(api, cell, device)):
        coll.active = i == P23_STEPS - 1
        p23_sync(device)
        t0 = time.perf_counter()
        state, mt = step(state, batch)
        out["losses"].append(float(mt["loss"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        coll.active = False
        out["digests"].append(p23_digests(state, sh))
        if i == 0:
            out["sq_first"] = p23_sq(state["opt"]["m"], one["first"], shp,
                                     device)
    out["collectives"] = coll.by_kind()
    out["sq"] = p23_sq(state["params"], one["params"], shp, device)
    del one
    keys, template = p23_saved(api, cell)
    tree, tsh = {k: state[k] for k in keys}, {k: sh[k] for k in keys}
    store = CheckpointStore(str(root / f"ckpt-mesh-{cell}"))
    t0 = time.perf_counter()
    store.save(P23_STEPS, tree, shardings=tsh)
    mesh_lib.barrier(mesh)   # rank 0 has written
    _, back = store.restore(template, step=P23_STEPS, shardings=tsh)
    out["read_back"] = all(t.equal(a, b) for a, b in
                           zip(leaves(back), leaves(tree)))
    out["save_s"] = time.perf_counter() - t0
    del back
    mesh_lib.barrier(mesh)
    if mesh_lib.rank_of(mesh) == 0:
        (root / f"saved-{cell}").touch()
    return out


def p23_rank(rank, args):
    """One rank of phase 23: two ranks on the parent's card (``args``: the
    results' folder, the device) over gloo, a (1, 2) training mesh; each
    cell once the parent's one-device results of it are written.  The
    training path builds no kernel: a rank that would run nvcc fails."""
    import torch as t
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    root, dev = Path(args[0]), args[1]

    def refuse(name, nvcc):
        raise RuntimeError(f"rank {rank} would run nvcc for {name}")
    _build._start = refuse
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = mesh_lib.make_train_mesh((1, P23_RANKS),
                                    devices=[dev] * P23_RANKS)
    device = mesh_lib.local_device(mesh)
    import torch._dynamo  # noqa: F401 -- the remat's import, while waiting
    out, waited = {}, 0.0
    for cell in ("lm", "cnn"):
        t1 = time.perf_counter()
        while not (root / f"one-{cell}.pt").exists():
            if (root / P23_ABANDON).exists() or time.perf_counter() - t1 > 240:
                raise RuntimeError(f"rank {rank}: no one-device results")
            time.sleep(0.1)
        waited += time.perf_counter() - t1
        out[cell] = p23_cell_rank(cell, mesh, device, root)
    out.update(coords=mesh_lib.model_coords(mesh), waited=waited,
               backend=mesh_lib.mesh_info(mesh).backend,
               s=time.perf_counter() - t0)
    return out


def p23_run_one(sm, api, batches):
    """The one-device step over ``batches`` -> (losses, step ms, state,
    the first moments after step 0 on the host, the parameter leaves
    that start at zero)."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.tree import flatten_with_paths
    state = p23_state(api, sm.device)
    zero = sorted(k for k, v in flatten_with_paths(state["params"]).items()
                  if not bool(v.any()))
    step = steps_lib.make_train_step(api, peak_lr=P23_LR,
                                     total_steps=P23_STEPS, donate=True)
    losses, ms, first = [], [], None
    for batch in batches:
        p23_sync(sm.device)
        t0 = time.perf_counter()
        state, mt = step(state, batch)
        losses.append(float(mt["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:   # a copy: the next steps write the moments
            first = {k: v.to("cpu", copy=True) for k, v in
                     flatten_with_paths(state["opt"]["m"]).items()}
    del step
    return losses, ms, state, first, zero


def p23_step_size(path):
    """Whether a parameter leaf is an LSQ step size (``ga``, ``gw``)."""
    return path.endswith(("['ga']", "['gw']"))


def p23_gaps(got, want, keys=None, device="cpu"):
    """{path: relative L2 of ``got`` against ``want``} (flat trees on any
    device), each leaf in f64 on ``device``."""
    import torch as t
    out = {}
    for k in (want if keys is None else keys):
        a = got[k].to(device, t.float64)
        b = want[k].to(device, t.float64)
        out[k] = float(t.linalg.vector_norm(a - b)
                       / max(float(t.linalg.vector_norm(b)), 1e-300))
    return out


def p23_one(sm, cell, root):
    """The cell's one-device run here -> losses, step ms, the parameter
    leaves that start at zero; its final parameters and first moments
    written to ``one-{cell}.pt`` for the ranks.  The ResNet runs a second
    time on each batch's rows reversed: the same arithmetic summed in
    another order, whose gaps from the first run are the noise floor of
    its leaves (``witness``)."""
    import torch as t
    from repro_torch.tree import flatten_with_paths
    api = p23_api(cell)
    batches = p23_batches(api, cell, sm.device)
    losses, ms, state, first, zero = p23_run_one(sm, api, batches)
    out = {"losses": losses, "step_ms": ms, "zero": zero,
           "held": sum(x.numel() * x.element_size()
                       for x in flatten_with_paths(state).values())}
    params = {k: v.cpu() for k, v in
              flatten_with_paths(state["params"]).items()}
    del state
    t.save({"params": params, "first": first}, root / f"one-{cell}.tmp")
    os.replace(root / f"one-{cell}.tmp", root / f"one-{cell}.pt")
    if cell == "cnn":
        flip = [{k: v.flip(0) for k, v in b.items()} for b in batches]
        w_losses, _, w_state, w_first, _ = p23_run_one(sm, api, flip)
        w_params = {k: v.cpu() for k, v in
                    flatten_with_paths(w_state["params"]).items()}
        del w_state
        leaf = p23_gaps(w_params, params)
        w_first = p23_gaps(w_first, first)
        out["witness"] = {
            "losses": w_losses,
            "first": max((v, k) for k, v in w_first.items()
                         if not p23_step_size(k)),
            "first_ga": max((v, k) for k, v in w_first.items()
                            if p23_step_size(k)),
            "leaf": max((v, k) for k, v in leaf.items() if k not in zero),
            "zero": max(((leaf[k], k) for k in zero), default=(0.0, None))}
    del params, first
    release(sm)
    return out


def p23_check_files(sm, api, cell, root):
    """The cell's mesh save restored onto this device and saved again by
    one device: whether the two saves' files are the same bytes."""
    from repro_torch.checkpoint import CheckpointStore
    _, template = p23_saved(api, cell)
    _, st = CheckpointStore(str(root / f"ckpt-mesh-{cell}")).restore(
        template, device=sm.device)
    CheckpointStore(str(root / f"ckpt-one-{cell}")).save(P23_STEPS, st)
    del st
    same = p22_same_files(root / f"ckpt-mesh-{cell}",
                          root / f"ckpt-one-{cell}", P23_STEPS)
    release(sm)
    return same


def p23_wait(root, name, world):
    """Wait for ``root / name`` while the ranks run; their failure
    raises."""
    while not (root / name).exists():
        if world.done():
            world.result()
            raise RuntimeError(f"the ranks ended without {name}")
        time.sleep(0.05)


def p23_worst(got, key, keys=None):
    """(worst relative L2, path) over the ranks' ``key`` sums
    (``p23_sq``), a cut leaf's blocks summed over the ranks."""
    leaf = {}
    for k, (d, ref, cut) in got[0][key].items():
        if keys is not None and k not in keys:
            continue
        if cut:
            d += sum(g[key][k][0] for g in got[1:])
            ref += sum(g[key][k][1] for g in got[1:])
        leaf[k] = (d / max(ref, 1e-300)) ** 0.5
    return max(((v, k) for k, v in leaf.items()), default=(0.0, None))


def phase_p23(sm, card):
    """Phase 23: granite-8b (full width, 2 layers) and ResNet-18 at 224
    trained tensor-parallel on a (1, 2) mesh of two ranks sharing cuda:0,
    against the one-device step of each -> what was measured."""
    import shutil
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    release(sm)
    lm = p23_api("lm")
    root = ckpt_root("p23", (lm.total_params() + 2 * lm.cfg.vocab
                             * lm.cfg.d_model) * 4 * 2)
    root.mkdir(parents=True, exist_ok=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    # the ranks start (torch, the card's context, the first step's
    # imports) while this process runs both cells on one device
    world = pool.submit(mesh_lib.spawn, p23_rank, P23_RANKS,
                        ((str(root), str(sm.device)),),
                        store_dir=str(ROOT / "build" / "p23"),
                        backend="gloo", timeout_s=400)
    same_files = {}
    try:
        # each cell's ranks start once its one-device results are written
        one = {cell: p23_one(sm, cell, root) for cell in ("lm", "cnn")}
        t1 = time.perf_counter()
        # granite's files while the ranks train the ResNet
        p23_wait(root, "saved-lm", world)
        same_files["lm"] = p23_check_files(sm, lm, "lm", root)
        t_lm = time.perf_counter() - t1
        ranks = world.result()
    except BaseException:
        (root / P23_ABANDON).touch()
        raise
    finally:
        pool.shutdown()
    t2 = time.perf_counter()
    same_files["cnn"] = p23_check_files(sm, p23_api("cnn"), "cnn", root)
    shutil.rmtree(root, ignore_errors=True)
    release(sm)
    res = {"one": one, "ranks": ranks,
           "s": (t1 - t0, t2 - t1, time.perf_counter() - t2, t_lm)}
    for cell in ("lm", "cnn"):
        got = [r[cell] for r in ranks]
        want = one[cell]["losses"]
        zero = set(one[cell]["zero"])
        fwd = max(abs(a - b) / abs(b) for a, b in
                  zip(got[0]["losses"][:2], want[:2]))
        steps = {k for k in got[0]["sq_first"] if p23_step_size(k)}
        first = p23_worst(got, "sq_first", set(got[0]["sq_first"]) - steps)
        first_ga = p23_worst(got, "sq_first", steps)
        nonzero = set(got[0]["sq"]) - zero
        worst = p23_worst(got, "sq", nonzero)
        worst_zero = p23_worst(got, "sq", zero)
        worst_w = p23_worst(got, "sq", {k for k in nonzero
                                        if k.endswith("['w']")})
        res[cell] = {"forward_gap": fwd, "first": first,
                     "first_ga": first_ga, "worst": worst,
                     "worst_zero": worst_zero, "worst_w": worst_w}
        ok = {
            "ranks' losses alike": all(g["losses"] == got[0]["losses"]
                                       for g in got),
            "losses before any update": fwd <= P23_FORWARD_RTOL,
            "first moments after step 0": first[0] <= P23_FIRST_RTOL,
            "every leaf after 3 steps": worst[0] <= P23_LEAF_RTOL[cell]
            and worst_zero[0] <= P23_ZERO_RTOL,
            "whole leaves bitwise across the ranks": all(
                g["digests"] == got[0]["digests"] for g in got)
            and all(len(d) for d in got[0]["digests"]),
            "mesh save read back: each rank's blocks": all(
                g["read_back"] for g in got),
            "mesh save == one-device save of it": same_files[cell]}
        for name, good in ok.items():
            if not good:
                sm.failures.append(f"phase 23 {cell}: {name}")
        zero_txt = (f", of the leaves zero at init {worst_zero[0]:.3e} "
                    f"{worst_zero[1]} (bound {P23_ZERO_RTOL})"
                    if zero else "")
        log(f"[p23] {cell}: losses one device {want}, (1, 2) "
            f"{got[0]['losses']}; before any update relative gap {fwd:.3e} "
            f"(bound {P23_FORWARD_RTOL}); worst first moment after step 0 "
            f"{first[0]:.3e} {first[1]} (bound {P23_FIRST_RTOL}; of the "
            f"step sizes {first_ga[0]:.3e} {first_ga[1]}); worst "
            f"parameter leaf after {P23_STEPS} steps {worst[0]:.3e} "
            f"{worst[1]} (bound {P23_LEAF_RTOL[cell]}){zero_txt}, worst "
            f"weight leaf {worst_w[0]:.3e} {worst_w[1]}; checks {ok}")
        wit = one[cell].get("witness")
        if wit is not None:
            log(f"[p23] {cell} noise floor, one device on each batch's rows "
                f"reversed against one device (the same arithmetic in "
                f"another order): losses {wit['losses']}; worst first "
                f"moment {wit['first'][0]:.3e} {wit['first'][1]} (of the "
                f"step sizes {wit['first_ga'][0]:.3e} "
                f"{wit['first_ga'][1]}); worst "
                f"leaf after {P23_STEPS} steps {wit['leaf'][0]:.3e} "
                f"{wit['leaf'][1]}, of the leaves zero at init "
                f"{wit['zero'][0]:.3e} {wit['zero'][1]}")
    log(f"[p23] phase 23 took {time.perf_counter() - t0:.1f} s: one device "
        f"both cells {res['s'][0]:.1f} s (the ranks starting meanwhile), "
        f"then the ranks {res['s'][1]:.1f} s more (they waited "
        f"{ranks[0]['waited']:.1f} s in all for one-device results; granite's "
        f"save {ranks[0]['lm']['save_s']:.1f} s and its files checked "
        f"{res['s'][3]:.1f} s after the one-device runs, the ResNet's save "
        f"{ranks[0]['cnn']['save_s']:.1f} s), the ResNet's files "
        f"{res['s'][2]:.1f} s")
    print_p23(res, card)
    sm.check_phase("23 tensor-parallel QAT training, (1, 2) mesh on cuda:0: "
                   "granite-8b x2 and ResNet-18 held to the one-device "
                   "step, whole leaves bitwise across the ranks, the mesh "
                   "saves' files")
    return res


def print_p23(res, card):
    """Phase 23's ``[p23-time]`` lines."""
    arch, depth, b, s_ = P23_LM
    labels = {"lm": f"{arch} x{depth} {b} x {s_}",
              "cnn": f"{P23_CNN[0]} batch {P23_CNN[1]} at 224"}
    for cell, label in labels.items():
        one = res["one"][cell]
        log(f"[p23-time] {label} one device: steps "
            f"{[round(x, 1) for x in one['step_ms']]} ms, state "
            f"{one['held'] / 1e9:.2f} GB  (host clock; {card})")
        for r in res["ranks"]:
            got = r[cell]
            kinds = got["collectives"]
            tot_mb = sum(v[1] for v in kinds.values()) / 1e6
            tot_ms = sum(v[2] for v in kinds.values())
            log(f"[p23-time] {label} (1, 2) rank {r['coords'][0]}: steps "
                f"{[round(x, 1) for x in got['step_ms']]} ms; state "
                f"{got['held'] / 1e9:.2f} GB ({got['held'] / one['held']:.3f}"
                f" of one device's); the last step's collectives "
                f"{sum(v[0] for v in kinds.values())} calls, {tot_mb:.1f} MB "
                f"of the rank's parts, {tot_ms:.1f} ms (card synchronized "
                f"around each, gloo through the host): " + "; ".join(
                    f"{k} {v[0]} calls {v[1] / 1e6:.1f} MB {v[2]:.1f} ms"
                    for k, v in sorted(kinds.items())) + f"  ({card})")


# --- phase 24: tensor-parallel QAT training of MoE, MLA and whisper ----------

P24_RANKS = 2
# arch, layers (None: all), batch, tokens: olmoe's two MoE layers,
# deepseek's dense first layer and one MoE layer, whisper-base whole (its
# 1536 frames a row)
P24_CELLS = (("olmoe-1b-7b", 2, 2, 256), ("deepseek-v2-lite-16b", 2, 2, 256),
             ("whisper-base", None, 2, 64))
# phase 23's contract and bounds (P23_STEPS steps at P23_LR): the losses
# before any update; every first moment after step 0 but the step sizes';
# every parameter leaf after 3 steps, the leaves that start at zero
# (whisper's layernorm biases) apart; the whole leaves bitwise across the
# ranks.  One device on each batch's rows reversed is printed beside
# every cell as its noise floor.
P24_FORWARD_RTOL = 1e-5
P24_FIRST_RTOL = 5e-2
# whisper-base's own: a row shard's two f32 partial sums and one device's
# bf16 product round about one element in a million apart, and whisper
# spreads such an element (``tools/tp_whisper_trace.py``: its encoder's
# bidirectional attention over 1536 frames turns a few into thousands, the
# cross attention carries them into every decoder layer).  Measured on an
# H100 at 700 W: losses before any update 2.04e-5 apart, first moments
# 7.7e-2 (a decoder k), against 0.0 and 4.5e-3 for olmoe and deepseek.
# The planted faults of tests/test_torch_tensor_parallel_train_families.py
# read 1.0 and more in the first moments on the CPU, or break a bitwise
# check.
P24_WHISPER_FORWARD_RTOL = 1e-4
P24_WHISPER_FIRST_RTOL = 0.1
P24_LEAF_RTOL = 7e-2
P24_ZERO_RTOL = 0.55
P24_KINDS = {  # phase 23's, and what expert parallelism and MLA add
    **P23_KINDS,
    "whole_router": "router gathers (d x E f32)",
    "gather_gated": "gated-row gathers (B x E/M x C x D bf16)",
    "_Dispatch.backward": "slot-cotangent gathers",
    "_HeadBroadcast.backward": "head-broadcast sums (k_rope's cotangent, "
                               "gathered by heads)",
    "_CutModel.backward": "cut cotangent gathers (the gates, whisper's "
                          "cross K/V)",
}


def p24_name(cell):
    return cell[0].split("-")[0]


def p24_api(cell):
    arch, depth, _, _ = cell
    return dataclasses.replace(family_api(arch, depth=depth),
                               microbatches=1)


def p24_batches(api, cell, device, reverse=False):
    """The cell's ``P23_STEPS`` batches (whole: the (1, 2) mesh's ranks
    share one data row) on ``device``, whisper's with its frames; each
    batch's rows reversed with ``reverse``."""
    import torch as t
    from repro_torch.data.pipeline import SyntheticLM
    _, _, b, s_ = cell
    pipe = SyntheticLM(vocab=api.cfg.vocab, seq_len=s_, global_batch=b,
                       seed=SEED, with_frames=api.needs_frames,
                       n_audio=getattr(api.cfg, "n_audio", 0),
                       d_model=api.cfg.d_model)
    out = []
    for i in range(P23_STEPS):
        host = pipe.batch_at(i)
        got = {k: t.as_tensor(v).to(device).to(
            t.long if v.dtype.kind in "iu" else t.float32)
            for k, v in host.items()}
        out.append({k: v.flip(0) for k, v in got.items()} if reverse
                   else got)
    return out


def p24_one(sm, cell, root):
    """The cell's one-device run here, and again on each batch's rows
    reversed (the noise floor) -> losses, step ms, the leaves that start
    at zero, the floor's gaps; the first run's final parameters and first
    moments written to ``one-{name}.pt`` for the ranks."""
    import torch as t
    from repro_torch.tree import flatten_with_paths
    api = p24_api(cell)
    name = p24_name(cell)
    batches = p24_batches(api, cell, sm.device)
    t0 = time.perf_counter()
    losses, ms, state, first, zero = p23_run_one(sm, api, batches)
    out = {"losses": losses, "step_ms": ms, "zero": zero,
           "held": sum(x.numel() * x.element_size()
                       for x in flatten_with_paths(state).values())}
    params = {k: v.cpu() for k, v in
              flatten_with_paths(state["params"]).items()}
    del state
    t1 = time.perf_counter()
    t.save({"params": params, "first": first}, root / f"one-{name}.tmp")
    os.replace(root / f"one-{name}.tmp", root / f"one-{name}.pt")
    release(sm)
    t2 = time.perf_counter()
    w_losses, _, w_state, w_first, _ = p23_run_one(
        sm, api, p24_batches(api, cell, sm.device, reverse=True))
    # the floor's gaps leaf by leaf on the card (13 GB of f64 on the host
    # took most of a cell's time)
    leaf = p23_gaps(flatten_with_paths(w_state["params"]), params,
                    device=sm.device)
    del w_state
    w_first = p23_gaps(w_first, first, device=sm.device)
    out["s"] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
    out["witness"] = {
        "losses": w_losses,
        "first": max((v, k) for k, v in w_first.items()
                     if not p23_step_size(k)),
        "first_ga": max((v, k) for k, v in w_first.items()
                        if p23_step_size(k)),
        "leaf": max((v, k) for k, v in leaf.items() if k not in zero),
        "zero": max(((leaf[k], k) for k in zero), default=(0.0, None))}
    del params, first
    release(sm)
    return out


def p24_cell_rank(cell, mesh, device, root):
    """One cell on this rank: the tensor-parallel step 3 times (the last
    one's collectives counted), the whole leaves' digests after each step,
    each parameter leaf's squared difference from the one-device result
    over the rank's block, after 3 steps and, for the first moments,
    after step 0."""
    import torch as t
    from repro_torch.launch import steps as steps_lib
    from repro_torch.tree import flatten_with_paths
    api = p24_api(cell)
    sh = steps_lib.train_state_shardings(api, mesh)
    state = p23_state(api, device, sh)
    held = sum(x.numel() * x.element_size()
               for x in flatten_with_paths(state).values())
    step = steps_lib.make_train_step(api, peak_lr=P23_LR,
                                     total_steps=P23_STEPS, donate=True,
                                     mesh=mesh)
    coll = P23Collectives(device, P24_KINDS)
    one = t.load(root / f"one-{p24_name(cell)}.pt", mmap=True)
    shp = flatten_with_paths(sh["params"])
    out = {"losses": [], "step_ms": [], "digests": [], "held": held}
    for i, batch in enumerate(p24_batches(api, cell, device)):
        coll.active = i == P23_STEPS - 1
        p23_sync(device)
        t0 = time.perf_counter()
        state, mt = step(state, batch)
        out["losses"].append(float(mt["loss"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        coll.active = False
        out["digests"].append(p23_digests(state, sh))
        if i == 0:
            out["sq_first"] = p23_sq(state["opt"]["m"], one["first"], shp,
                                     device)
    out["collectives"] = coll.by_kind()
    out["sq"] = p23_sq(state["params"], one["params"], shp, device)
    del one, state, step
    return out


def p24_rank(rank, args):
    """One rank of phase 24: two ranks on the parent's card (``args``: the
    results' folder, the device) over gloo, a (1, 2) training mesh; each
    cell once the parent's one-device results of it are written, rank 0
    marking it done (``done-{name}``) when both ranks have read them.  The
    training path builds no kernel: a rank that would run nvcc fails."""
    import torch as t
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    root, dev = Path(args[0]), args[1]

    def refuse(name, nvcc):
        raise RuntimeError(f"rank {rank} would run nvcc for {name}")
    _build._start = refuse
    t.backends.cuda.matmul.allow_tf32 = False
    t.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = mesh_lib.make_train_mesh((1, P24_RANKS),
                                    devices=[dev] * P24_RANKS)
    device = mesh_lib.local_device(mesh)
    import torch._dynamo  # noqa: F401 -- the remat's import, while waiting
    out, waited = {}, 0.0
    for cell in P24_CELLS:
        name = p24_name(cell)
        t1 = time.perf_counter()
        while not (root / f"one-{name}.pt").exists():
            if (root / P23_ABANDON).exists() or time.perf_counter() - t1 > 300:
                raise RuntimeError(f"rank {rank}: no one-device results")
            time.sleep(0.1)
        waited += time.perf_counter() - t1
        out[name] = p24_cell_rank(cell, mesh, device, root)
        t.cuda.empty_cache()
        mesh_lib.barrier(mesh)
        if mesh_lib.rank_of(mesh) == 0:
            (root / f"done-{name}").touch()
    out.update(coords=mesh_lib.model_coords(mesh), waited=waited,
               s=time.perf_counter() - t0)
    return out


def phase_p24(sm, card):
    """Phase 24: olmoe-1b-7b x2, deepseek-v2-lite-16b x2 and whisper-base
    whole trained tensor-parallel on a (1, 2) mesh of two ranks sharing
    cuda:0, against the one-device step of each -> what was measured."""
    import shutil
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    release(sm)
    need = sum(p24_api(c).total_params() for c in P24_CELLS) * 4 * 2
    root = ckpt_root("p24", need)
    root.mkdir(parents=True, exist_ok=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    world = pool.submit(mesh_lib.spawn, p24_rank, P24_RANKS,
                        ((str(root), str(sm.device)),),
                        store_dir=str(ROOT / "build" / "p24"),
                        backend="gloo", timeout_s=500)
    one = {}
    try:
        # each cell's ranks start once its one-device results are
        # written; a file is removed once the ranks have read it
        for cell in P24_CELLS:
            one[p24_name(cell)] = p24_one(sm, cell, root)
            for c in P24_CELLS:
                n = p24_name(c)
                if (root / f"done-{n}").exists():
                    (root / f"one-{n}.pt").unlink(missing_ok=True)
        t1 = time.perf_counter()
        ranks = world.result()
    except BaseException:
        (root / P23_ABANDON).touch()
        raise
    finally:
        pool.shutdown()
    shutil.rmtree(root, ignore_errors=True)
    release(sm)
    res = {"one": one, "ranks": ranks,
           "s": (t1 - t0, time.perf_counter() - t1)}
    for cell in P24_CELLS:
        name = p24_name(cell)
        got = [r[name] for r in ranks]
        want = one[name]["losses"]
        zero = set(one[name]["zero"])
        fwd = max(abs(a - b) / abs(b) for a, b in
                  zip(got[0]["losses"][:2], want[:2]))
        steps = {k for k in got[0]["sq_first"] if p23_step_size(k)}
        first = p23_worst(got, "sq_first", set(got[0]["sq_first"]) - steps)
        first_ga = p23_worst(got, "sq_first", steps)
        nonzero = set(got[0]["sq"]) - zero
        worst = p23_worst(got, "sq", nonzero)
        worst_zero = p23_worst(got, "sq", zero)
        worst_w = p23_worst(got, "sq", {k for k in nonzero
                                        if k.endswith("['w']")})
        res[name] = {"forward_gap": fwd, "first": first,
                     "first_ga": first_ga, "worst": worst,
                     "worst_zero": worst_zero, "worst_w": worst_w}
        whisper = name == "whisper"
        fwd_rtol = P24_WHISPER_FORWARD_RTOL if whisper else P24_FORWARD_RTOL
        first_rtol = P24_WHISPER_FIRST_RTOL if whisper else P24_FIRST_RTOL
        ok = {
            "ranks' losses alike": all(g["losses"] == got[0]["losses"]
                                       for g in got),
            "losses before any update": fwd <= fwd_rtol,
            "first moments after step 0": first[0] <= first_rtol,
            "every leaf after 3 steps": worst[0] <= P24_LEAF_RTOL
            and worst_zero[0] <= P24_ZERO_RTOL,
            "whole leaves bitwise across the ranks": all(
                g["digests"] == got[0]["digests"] for g in got)
            and all(len(d) for d in got[0]["digests"])}
        for what, good in ok.items():
            if not good:
                sm.failures.append(f"phase 24 {name}: {what}")
        zero_txt = (f", of the leaves zero at init {worst_zero[0]:.3e} "
                    f"{worst_zero[1]} (bound {P24_ZERO_RTOL})"
                    if zero else "")
        wit = one[name]["witness"]
        log(f"[p24] {cell[0]}: losses one device {want}, (1, 2) "
            f"{got[0]['losses']}; before any update relative gap {fwd:.3e} "
            f"(bound {fwd_rtol}); worst first moment after step 0 "
            f"{first[0]:.3e} {first[1]} (bound {first_rtol}; of the "
            f"step sizes {first_ga[0]:.3e} {first_ga[1]}); worst "
            f"parameter leaf after {P23_STEPS} steps {worst[0]:.3e} "
            f"{worst[1]} (bound {P24_LEAF_RTOL}){zero_txt}, worst weight "
            f"leaf {worst_w[0]:.3e} {worst_w[1]}; checks {ok}")
        log(f"[p24] {cell[0]} one device: run {one[name]['s'][0]:.1f} s, "
            f"its results written {one[name]['s'][1]:.1f} s, the floor's "
            f"run and gaps {one[name]['s'][2]:.1f} s")
        log(f"[p24] {cell[0]} noise floor, one device on each batch's rows "
            f"reversed against one device: losses {wit['losses']}; worst "
            f"first moment {wit['first'][0]:.3e} {wit['first'][1]} (of the "
            f"step sizes {wit['first_ga'][0]:.3e} {wit['first_ga'][1]}); "
            f"worst leaf after {P23_STEPS} steps {wit['leaf'][0]:.3e} "
            f"{wit['leaf'][1]}, of the leaves zero at init "
            f"{wit['zero'][0]:.3e} {wit['zero'][1]}")
    log(f"[p24] phase 24 took {time.perf_counter() - t0:.1f} s: one device "
        f"every cell and its floor {res['s'][0]:.1f} s (the ranks starting "
        f"and training meanwhile), then the ranks {res['s'][1]:.1f} s more "
        f"(they waited {ranks[0]['waited']:.1f} s in all for one-device "
        f"results)")
    print_p24(res, card)
    sm.check_phase("24 tensor-parallel QAT training, (1, 2) mesh on cuda:0: "
                   "olmoe-1b-7b x2, deepseek-v2-lite-16b x2 and whisper-base "
                   "held to the one-device step, whole leaves bitwise "
                   "across the ranks")
    return res


def print_p24(res, card):
    """Phase 24's ``[p24-time]`` lines."""
    for cell in P24_CELLS:
        arch, depth, b, s_ = cell
        name = p24_name(cell)
        label = (f"{arch} x{depth} {b} x {s_}" if depth
                 else f"{arch} {b} x {s_}")
        one = res["one"][name]
        log(f"[p24-time] {label} one device: steps "
            f"{[round(x, 1) for x in one['step_ms']]} ms, state "
            f"{one['held'] / 1e9:.2f} GB  (host clock; {card})")
        for r in res["ranks"]:
            got = r[name]
            kinds = got["collectives"]
            tot_mb = sum(v[1] for v in kinds.values()) / 1e6
            tot_ms = sum(v[2] for v in kinds.values())
            log(f"[p24-time] {label} (1, 2) rank {r['coords'][0]}: steps "
                f"{[round(x, 1) for x in got['step_ms']]} ms; state "
                f"{got['held'] / 1e9:.2f} GB ({got['held'] / one['held']:.3f}"
                f" of one device's); the last step's collectives "
                f"{sum(v[0] for v in kinds.values())} calls, {tot_mb:.1f} MB "
                f"of the rank's parts, {tot_ms:.1f} ms (card synchronized "
                f"around each, gloo through the host): " + "; ".join(
                    f"{k} {v[0]} calls {v[1] / 1e6:.1f} MB {v[2]:.1f} ms"
                    for k, v in sorted(kinds.items())) + f"  ({card})")


def summarize(rows, launches, max_err, k1_routes):
    """One entry per kernel.  K1 and K2: times summed over one batch-8
    ResNet-18 forward (K2's batch-1 rows are printed, not summed); K3 and
    K4: over one prefill of the run that launched them (per-layer rows
    times their layer counts).  ``launches`` sums the main-path runs
    (ResNet, and the LM's two Generator runs); K1's entry also counts them
    by route and names both route sources."""
    out = []
    for name, src, replaces in KERNELS:
        rs = [r for r in rows if r["kernel"] == name
              and r.get("batch", TIME_BATCH) == TIME_BATCH]
        w = [r.get("count", 1) for r in rs]
        by_bytes = sum(c * r["bound_ms"] for c, r in zip(w, rs)
                       if r["bound_by"] == "bytes")
        by_ops = sum(c * r["bound_ms"] for c, r in zip(w, rs)
                     if r["bound_by"] != "bytes")
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": sum(c * r["ms"] for c, r in zip(w, rs)),
            "plain_ms": sum(c * r["plain_ms"] for c, r in zip(w, rs)),
            "bound_ms": by_bytes + by_ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": sum(c * r["library_ms"] for c, r in zip(w, rs))})
        if name == "mpmm_cuda":
            out[-1]["routes"] = k1_routes
            out[-1]["sources"] = [src, src.replace("mpmm_wgmma.cu",
                                                   "mpmm_splitk.cu")]
    return out


def ptxas_lines(text):
    """nvcc -Xptxas -v output -> one line per kernel instantiation: its
    template arguments, registers, stack and spills."""
    import re

    def short(mangled):  # _ZN..16flash_fwd_kernelILi128ELi4E..EEv.. -> name<args>
        end = mangled.find("I")
        while end >= 0 and not mangled[:end].endswith("kernel"):
            end = mangled.find("I", end + 1)
        if end < 0:
            return mangled
        for run in re.finditer(r"\d+", mangled[:end]):
            for k in range(len(run.group())):  # the length prefix's digits
                start = run.end()
                if start + int(run.group()[k:]) == end:
                    args = [v if t == "i" else ("true" if v == "1"
                                                  else "false")
                            for t, v in re.findall(r"L([ib])(\d+)E",
                                                   mangled[end:])]
                    if mangled[start:end].startswith("flash"):
                        args.append("bf16" if "bfloat16" in mangled
                                    else "f32")
                    return f"{mangled[start:end]}<{','.join(args)}>"
        return mangled

    name, out = "?", []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    try:
        return run_phases(torch)
    finally:
        remove_shm_run()


def run_phases(torch) -> int:
    """Every phase in order, then the ``kernels``, card and ``ok`` lines;
    a phase that fails raises ``SystemExit``."""
    from repro_torch.core.plan import PrecisionPlan
    from repro_torch.kernels import _build
    from repro_torch import configs

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    built = _build.build_all()
    log(f"[build] {sorted(_build.KERNEL_SOURCES)} built in "
        f"{built['seconds']:.2f} s (parallel nvcc); each: " + ", ".join(
            f"{n} {sec:.2f} s" for n, sec in built["per_source"].items()))
    for name, text in built["logs"].items():
        for line in ptxas_lines(text):
            log(f"[build] {name}: {line}")

    sm = Smoke(torch, device)
    cfg = configs.get(ARCH).cfg
    plan = PrecisionPlan.load(PLAN)
    path_k1 = path_k1_calls(sm, cfg, plan, TIME_BATCH)
    convs = resnet_convs(cfg, plan)
    if len(convs) != 19:
        raise SystemExit(f"expected 19 K2 convs, found {len(convs)}")
    k2_build_info(convs)

    lm_plan = PrecisionPlan.load(LM_PLAN)
    phase_k1(sm, path_k1, lm_k1_calls(lm_api(None, lm_plan)) + P13_K1_SHAPES)
    phase_k2(sm, convs)
    server, cfg, plan, launches, k1_routes = phase_end_to_end(sm)
    fps = frames_per_second(sm, server, cfg)
    rows = measure(sm, path_k1, convs)
    log(f"[resnet] done at {time.perf_counter() - t_start:.1f} s")

    lm_block_k = configs.get(LM_ARCH).cfg.attn_chunk
    phase_k3(sm, lm_block_k)
    phase_k4(sm, lm_block_k)
    phase_d192(sm)
    phase_d256(sm)
    api, params, prompts, run, run3 = phase_lm(sm)
    depth = api.cfg.n_layers
    for r in (run, run3):
        launches = {k: launches.get(k, 0) + r["launches"][k]
                    for k in r["launches"]}
        k1_routes = {k: k1_routes[k] + r["routes"][k] for k in k1_routes}
    attn_rows = measure_attention(sm, api)
    k1_rows = measure_k1_lm(sm, api)
    prefill_ms, decode_ms = measure_lm_end_to_end(sm, api, params, prompts)
    del params
    torch.cuda.empty_cache()
    log(f"[lm] done at {time.perf_counter() - t_start:.1f} s")

    sg, _, spec = phase_spec(sm, phase8_tokens=run["tokens"])
    launches = {k: launches[k] + spec["launches"][k] for k in launches}
    k1_routes = {k: k1_routes[k] + spec["routes"][k] for k in k1_routes}
    sched = phase_lm_schedulers(sm, sg)
    del sg
    torch.cuda.empty_cache()
    img_batches = phase_image_scheduler(sm, server, cfg)
    phase_cli(sm)
    log(f"[spec] done at {time.perf_counter() - t_start:.1f} s")
    p11_launches, p11 = phase_p11(sm, server, rows, card)
    launches = {k: launches[k] + p11_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p11_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    del server
    torch.cuda.empty_cache()
    log(f"[p11] phase 11 done at {time.perf_counter() - t_start:.1f} s")
    p12_launches, p12, p12_rows = phase_p12(sm, card)
    launches = {k: launches[k] + p12_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p12_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p12] phase 12 done at {time.perf_counter() - t_start:.1f} s")
    p13_launches, p13 = phase_p13(sm, card)
    launches = {k: launches[k] + p13_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p13_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p13] phase 13 done at {time.perf_counter() - t_start:.1f} s")
    p14_launches, p14 = phase_p14(sm)
    launches = {k: launches[k] + p14_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p14_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p14] phase 14 done at {time.perf_counter() - t_start:.1f} s")
    p15_launches, p15 = phase_p15(sm)
    launches = {k: launches[k] + p15_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p15_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p15] phase 15 done at {time.perf_counter() - t_start:.1f} s")
    p16_launches, p16 = phase_p16(sm)
    launches = {k: launches[k] + p16_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p16_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p16] phase 16 done at {time.perf_counter() - t_start:.1f} s")
    remove_shm_run()
    phase_p17(sm, card)
    log(f"[p17] phase 17 done at {time.perf_counter() - t_start:.1f} s")
    p18_launches, _ = phase_p18(sm, card)
    launches = {k: launches[k] + p18_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p18_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p18] phase 18 done at {time.perf_counter() - t_start:.1f} s")
    p19_launches, acc_only = phase_p19(sm, card)
    launches = {k: launches[k] + p19_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p19_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p19] phase 19 done at {time.perf_counter() - t_start:.1f} s")
    p20_launches, bank_rows = phase_p20(sm, card)
    launches = {k: launches[k] + p20_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p20_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p20] phase 20 done at {time.perf_counter() - t_start:.1f} s")
    p21_launches, p21_acc, p21_k3 = phase_p21(sm, card)
    launches = {k: launches[k] + p21_launches.get(k, 0) for k in launches}
    k1_routes = {k: k1_routes[k] + p21_launches.get(f"route:{k}", 0)
                 for k in k1_routes}
    log(f"[p21] phase 21 done at {time.perf_counter() - t_start:.1f} s")
    phase_p22(sm, card)
    log(f"[p22] phase 22 done at {time.perf_counter() - t_start:.1f} s")
    phase_p23(sm, card)
    log(f"[p23] phase 23 done at {time.perf_counter() - t_start:.1f} s")
    phase_p24(sm, card)
    log(f"[p24] phase 24 done at {time.perf_counter() - t_start:.1f} s")
    rows += attn_rows
    kernels = summarize(rows, launches, sm.max_err, k1_routes)
    acc_only["launches"] += (p20_launches.get("acc_only", 0)
                             + p21_launches.get("acc_only", 0))
    kernels[0]["acc_only"] = acc_only
    kernels[0]["rank_bank32"] = [
        {key: r[key] for key in ("shape", "route", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by")}
        for r in bank_rows]
    kernels[0]["rank_row_shards"] = [
        {key: r[key] for key in ("name", "m", "k", "n", "route", "ms",
                                 "plain_ms", "library", "library_ms",
                                 "bound_ms", "bound_by")}
        for r in p21_acc]
    kernels[2]["rank_heads_d256"] = {
        key: p21_k3[key] for key in ("shape", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}

    for r in rows:
        log(f"[time] {r['kernel']} {r['layer']:7s} {r['shape']}"
            + (f" route {r['route']}" if "route" in r else "")
            + f": kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it)"
            + (f", x{r['count']} per prefill" if "count" in r else "")
            + (f"; call by call {r['call_ms']:.4f} ms; {r['plan']}"
               if "plan" in r else ""))
    for batch in (TIME_BATCH, SMALL_BATCH):
        k2 = [r for r in rows if r["kernel"] == "conv_mpmm_cuda"
              and r["batch"] == batch]
        tot = {key: sum(r[key] for r in k2)
               for key in ("ms", "call_ms", "plain_ms", "library_ms",
                           "bound_ms")}
        slower = [r["layer"] for r in k2 if r["ms"] > r["library_ms"]]
        log(f"[time] conv_mpmm_cuda per batch-{batch} forward: kernel "
            f"{tot['ms']:.4f} ms, F.conv2d f32 {tot['library_ms']:.4f} ms "
            f"(kernel/library {tot['ms'] / tot['library_ms']:.2f}x; kernel "
            f"below library: {tot['ms'] < tot['library_ms']}), plain "
            f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_ms'] / tot['ms']:.1%} of it), call by call "
            f"{tot['call_ms']:.4f} ms; convs slower than "
            f"F.conv2d: {slower or 'none'}  ({card})")
    k1 = {ph: sum(r["count"] * r["ms"] for r in k1_rows if r["phase"] == ph)
          for ph in ("prefill", "decode")}
    for r in k1_rows:
        log(f"[time] mpmm_cuda LM {r['phase']} {r['shape']} route "
            f"{r['route']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
            f"({r['library']}; kernel/library "
            f"{r['ms'] / r['library_ms']:.2f}x), bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it), "
            f"x{r['count']} per {r['phase']}")
    for ph in ("prefill", "decode"):
        tot = {key: sum(r["count"] * r[key] for r in k1_rows
                        if r["phase"] == ph)
               for key in ("library_ms", "plain_ms", "bound_ms")}
        by_route = {rt: sum(r["count"] * r["ms"] for r in k1_rows
                            if r["phase"] == ph and r["route"] == rt)
                    for rt in ("wgmma", "splitk")}
        log(f"[time] mpmm_cuda LM per {ph}: kernel {k1[ph]:.2f} ms (wgmma "
            f"{by_route['wgmma']:.2f}, splitk {by_route['splitk']:.2f}), "
            f"library {tot['library_ms']:.2f} ms (kernel/library "
            f"{k1[ph] / tot['library_ms']:.2f}x; kernel below library: "
            f"{k1[ph] < tot['library_ms']}), plain {tot['plain_ms']:.2f} ms, "
            f"bound {tot['bound_ms']:.4f} ms ({tot['bound_ms'] / k1[ph]:.1%} "
            f"of it)  ({card})")
    k4_prefill = sum(r["count"] * r["ms"] for r in attn_rows
                     if r["kernel"] == "flash_fwd_packed_cuda")
    k3_layer = [r["ms"] for r in attn_rows if r["kernel"] == "flash_fwd_cuda"]
    log(f"[lm-time] depth {depth}: prefill {prefill_ms:.2f} ms = "
        f"{LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.1f} tokens/s; decode "
        f"{decode_ms:.2f} ms per step = {LM_BATCH / decode_ms * 1e3:.1f} "
        f"tokens/s at batch {LM_BATCH}  ({card})")
    log(f"[lm-time] prefill share: K4 {k4_prefill:.2f} ms "
        f"({k4_prefill / prefill_ms:.1%}), K1 {k1['prefill']:.2f} ms "
        f"({k1['prefill'] / prefill_ms:.1%}), rest "
        f"{prefill_ms - k4_prefill - k1['prefill']:.2f} ms "
        f"({1 - (k4_prefill + k1['prefill']) / prefill_ms:.1%}); decode "
        f"step share: K1 {k1['decode']:.2f} ms "
        f"({k1['decode'] / decode_ms:.1%}), rest "
        f"{decode_ms - k1['decode']:.2f} ms; K3 per layer {k3_layer[0]:.4f} "
        f"ms, x{depth} = {k3_layer[0] * depth:.2f} ms per "
        f"full-depth prefill")
    log("[fps] " + ", ".join(f"bucket {b}: {v:.1f} frames/s"
                             for b, v in fps.items()) + f"  ({card})")
    toks = LM_BATCH * LM_NEW
    cyc = spec["cycle_ms"]
    log(f"[time] speculative decoding, k={SPEC_K}, batch {LM_BATCH}, "
        f"{LM_PROMPT} + {LM_NEW} tokens: {toks / spec['spec_s']:.1f} "
        f"tokens/s ({spec['spec_s']:.2f} s, prefill of both views "
        f"included) against {toks / spec['verify_s']:.1f} tokens/s "
        f"verify-only ({spec['verify_s']:.2f} s); {spec['cycles']} cycles, "
        f"{sum(cyc) / len(cyc):.1f} ms a cycle (min {min(cyc):.1f}, max "
        f"{max(cyc):.1f}); accept rate {spec['accept_rate']:.4f} -- random "
        f"weights: says nothing of how often a trained draft is accepted "
        f"({card})")
    for label, r in sched.items():
        st = r["stats"]
        log(f"[time] GenerateScheduler over the {label}: {len(SCHED_TRACE)} "
            f"requests in {r['wall']:.2f} s, latency p50 "
            f"{st['p50_latency_s'] * 1e3:.1f} ms, p99 "
            f"{st['p99_latency_s'] * 1e3:.1f} ms (host clock read once a "
            f"step), accept rate {st['accept_rate']:.4f} -- random weights "
            f"({card})")
    log(f"[time] ImageScheduler: {sum(IMG_BURSTS)} images in batches "
        f"{img_batches}")
    print_p12(p12, p12_rows, card)
    print_p13(p13, card)
    print_p14(p14, card)
    print_p15(p15, card)
    print_p16(p16, card)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
