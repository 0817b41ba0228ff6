"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. identify the card (torch and nvidia-smi: name and power limit);
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels``, and count the selective scan's SASS instructions per
   (thread, timestep) in its loop over time (``cuobjdump -sass``);
3. hold the flash kernel against its plain PyTorch version on the card, at
   the ``tests/test_kernels.py`` shapes, the serving shapes, every other
   head dim (16, 32 and 96 in padded TMA boxes, phi3_mini_3_8b's prefill
   among them; 192, MLA's q/k width, with deepseek_v2_lite_16b's prefill
   (4, 16, 16, 1024, 192) causal and v zero past column 128; 80,
   zamba2_2_7b's shared attention, with its prefill (4, 32, 32, 1024, 80)
   causal and columns 64-79, past the first TMA box, held on their own;
   whisper_small's encoder (2, 12, 12, 1500, 64) without the causal mask,
   ragged at the last q and k tile; internvl2_26b's prefill at D 128, GQA
   48 on 8, (1, 48, 8, 1280, 128) causal),
   ragged lengths, lengths below one tile and window edges, in float32 and
   bf16, in the variant its rule names (``flash_attention.variant``) and
   beside it the one it replaced where that is built for the head dim
   (bf16 ``mma.sync`` beside ``wgmma``, float32 ``fma`` beside ``tf32x3``;
   not at 80 or 192); then
   a 6-layer cut of
   gemma3_1b at full width served on the card against the same params on the
   CPU (plain path) on one small input;
4. serve gemma3_1b at full width (26 layers, random params from a seed):
   8 requests, batch 4, prompt 1024, 32 new tokens, through
   ``repro_torch.launch.serve.serve``, counting the kernel's launches by
   variant: all of them on the Hopper variant;
5. time both bf16 variants at the serving shapes against the plain version
   and, as a yardstick only, ``F.scaled_dot_product_attention``, beside the
   bound, with each wrapper's host time per call;
6. profile one prefill batch and 8 decode steps with ``torch.profiler``:
   device time by kernel and the device's busy share of the wall time;
7. hold the matmul and selective-scan kernels against their plain versions
   on the card, in float32 and bf16, at the ``tests/test_kernels.py`` shapes
   and tolerances, at ragged shapes, at M and N off the Hopper tile and K
   over several turns of its ring, and at every shape of the calibration's
   ``"model"`` grid, the matmul in the variant the shape rule names and
   those beside it (``_BESIDE``: ``mma.sync`` beside bf16's ``wgmma``; the
   FMA kernel beside float32's ``tf32x3`` and ``stream``); then all three
   kernels at every shape of the
   ``"model"`` and ``"full"`` grids on the calibration's own float32 inputs;
8. time them at the ``"model"`` grid's shapes (the matmul in the same
   variants, float32 flash in ``tf32x3`` and ``fma``) against their plain
   versions, the library yardstick (``torch.matmul``; SDPA in float32; no PyTorch call
   computes a selective scan) and each variant's bound, with each
   wrapper's host time per call, and split a matmul ``tf32x3`` call's
   device time between its split pass and its product with
   ``torch.profiler``;
9. run the calibration loop (``repro_torch.kernels.calibrate.measure``) on
   the ``"model"`` and ``"full"`` grids, counting the three kernels'
   launches by variant (float32 matmul and flash as their rules name
   them: flash all ``tf32x3``), and print each kernel's fit;
10. run the paper's Table-III networks (``repro_torch.core.graph``, params
   from a seed) at batch 1 and 64 on the card and on the CPU (plain path)
   with the same params and input: every convolution and FC node, fed the
   card's inputs, at the float32 matmul tolerance; the logits at rtol 5e-4,
   atol 5e-4 max|CPU logits|; the matmul's launches by variant along each
   forward as the float32 rule names them (``GRAPH_LAUNCHES``);
11. time each net's forward (median wall ms of 20 synchronized runs,
   images/s), its products on the matmul kernel beside their bound and
   ``torch.matmul`` on the same operands, and at each batch its device
   time, split between the matmul kernels and the rest, over the wall time
   (``torch.profiler``): the paper's accelerator-versus-framework
   breakdown;
12. run one camera frame (``repro_torch.launch.camera.run_frame``: a seeded
   720x1280 raw frame, the ISP, CNN10 at batch 1) on the card against the
   CPU (RGB frame and DNN input at atol 1e-5), counting its matmul
   launches, and time it against the 33 ms frame budget;
13. hold the selective scan with its state (``h0`` in, h_S out) against its
   plain version on the card, float32 at ``SCAN_TOL``: y and h_S from zeros
   and from a random h0 at every ``SCAN_CASES`` shape and at
   falcon_mamba_7b's serving shape (4, 1024, 8192, 16); and a prompt split
   in two (the first part, then the rest from its h_S) against one call;
14. run falcon_mamba_7b cut to 2 layers at full width on the card against
   the same params on the CPU (plain path): 2 prompts of 300 tokens (off
   the kernel's 32-step chunk), the prefill logits, the ``conv`` and
   ``ssm`` caches and 2 decode steps fed the CPU's greedy tokens at
   ``BF16_TOL``, with exactly 2 scan launches;
15. serve falcon_mamba_7b at full width and depth (64 Mamba1 layers, bf16
   params from a seed made on the card; gemma3_1b's wait on the host for
   phase 27): 8
   requests, batch 4, prompt 1024, 32 new tokens, through ``serve``, with
   exactly 64 x 2 = 128 scan launches and every logit finite;
16. profile one falcon_mamba_7b prefill batch and 8 decode steps as in
   phase 6, with the scan's share of the prefill's device time;
17. time the scan at the serving shape with no state, with h_S out (what
   prefill runs) and with h0 in and h_S out, beside its bound (the state's
   bytes included) and its plain version;
18. run phi3_mini_3_8b cut to 4 layers at full width (d_model 3072, 32
   heads of head dim 96, MHA) on the card against the same params on the
   CPU (plain path): 2 prompts of 300 tokens, the prefill logits, the KV
   cache and 2 decode steps at ``BF16_TOL``, with exactly 4 flash launches
   of the variant the rule names at D = 96;
19. serve phi3_mini_3_8b at full width and depth (32 layers, bf16 params
   from a seed made on the card) under ``SERVE``, with exactly 32 x 2 = 64
   flash launches, all of that variant, and every logit finite;
20. profile one phi3_mini_3_8b prefill batch and 8 decode steps as in
   phase 6, with the flash kernel's share of the prefill's device time;
21. time both types' variants at phi3_mini_3_8b's prefill shape at head
   dims 16, 32 and 96, and float32 at the ``"full"`` grid's attention
   shapes of those head dims, both types at deepseek_v2_lite_16b's
   prefill shape at head dim 192 (v zero past column 128) and bf16 at
   granite_moe_1b_a400m's (4, 16, 8, 1024, 64), beside the plain version,
   SDPA and the bound (whose exponential term decides bf16 at D <= 32);
22. price each Table-III net at batch 1 and 64, not cut, with the port's
   simulator (``repro_torch.sim``): ``Graph.program`` at the default
   16,384-element tiles and at one tile a node, run on one H100
   (``EngineConfig()``: one worker, the hbm interface, the H100's
   constants) under the roofline, under the measured table of phase 9's
   ``model`` grid (``calibrate.table_backend``) and under the table with
   the matmul wrapper's host time a call (phase 8) charged a dispatch;
   each price (makespan, accelerator / transfer / host shares, op count,
   the engine's CPU time) beside phase 11's wall, device and matmul ms, and
   price over measured.  Asserts: every makespan finite and positive, the
   op count the sum of the chosen tilings' tile counts, the table
   reproducing its samples, and no kernel launched.  First, one small
   device copy's time (the tiling target's per-copy latency);
23. price the camera frame (the ISP's stages at 720x1280 on the
   accelerator, then CNN10 at batch 1) and its two parts under the same
   three backends beside phase 12's ms, and once on ``camera_soc()`` (ISP
   on the frontend CPU, CNN10 on 4 accelerators at the H100's rates);
24. the accelerator-size study (Fig 19/20): the 720x1280 frame (ISP, then
   CNN10 at batch 1) through ``apps.camera.frame_sweep`` over
   ``benchmarks/bench_camera.py``'s PE grid (8 workers x 1, 4 x 0.5, 2 x
   0.25 of the H100's peak, acp, 4 ports) and one H100, under the roofline
   at 16,384-element tiles and under phase 9's ``model``-grid table at one
   tile a node; each point's frame, ISP and DNN ms against 33 ms, the
   one-H100 point over phase 12's measured ms; every sweep result equal to
   ``engine.run`` of its config;
25. the camera-SoC tuning study: ``apps.camera.soc_frame_sweep`` over
   ``benchmarks/bench_soc.py``'s 16 topologies ({cpu, dsp} frontend x {1,
   2, 4, 8} accelerators x {1, 4} shared ports; CNN10 at 2,048-element
   tiles) on its embedded base point and with H100-rate accelerators: each
   topology's makespan, ISP, frontend and mean accelerator utilisation and
   energy, and the sweep's CPU seconds; every device in ``per_device``;
26. the analytic cost model (``sim.CostModel``): gemma3_1b's decode chain at
   ``SERVE``'s shape (5,000 ops) over a 64 x 64 grid of peak flops and HBM
   bandwidth (1/64 to 4x the H100's), numpy on the host against the
   ``torch`` backend on the card (rtol 1e-9, both wall times, the card's
   time a point) and its ``torch.func`` gradient against central
   differences (rtol 5e-2, atol 1e-3); the one-H100 roofline price of a
   decode step beside phase 4's measured ms; ``sweep.batched`` over the
   same grid on CNN10 at one tile a node (``relaxation_err == 0`` on a
   chain, else the bracket) and ``sweep.optimize`` for the cheapest design
   that keeps CNN10 at phase 12's measured ms, and that fits the frame in
   33 ms (verified on the exact engine; the torch backend on a chain).
   Phases 22-26 launch no kernel: the counts are asserted unchanged;
27. serving priced beside the card: gemma3_1b at full width through the
   measured mode of ``repro_torch.launch.serve_batch`` (``run_measured``:
   one batch of 4 prompts of 1024 tokens, 32 tokens, static batching, on
   phase 4's params), with exactly 26 flash launches, all bf16 ``wgmma``;
   then ``SERVE`` as a trace (8 requests at t = 0) priced by
   ``repro_torch.sim.serving.simulate_serving`` for gemma3_1b,
   falcon_mamba_7b, phi3_mini_3_8b, granite_moe_1b_a400m,
   deepseek_v2_lite_16b and zamba2_2_7b on one H100 at its bf16 peak
   (``apps.serving.default_config``), alone and with a host dispatch of
   50 us a step: each priced prefill step, mean decode step, makespan,
   tok/s and accelerator / transfer / host shares beside the measured
   prefill ms a batch, decode ms a step, tok/s and busy shares of phases
   4/6, 15/16, 19/20, 30, 32 and 34, with price / measured; 64 steps each and
   ``replay_serving`` equal to ``simulate_serving`` on every stats field;
   gemma3_1b's prefill once more at the float32 default ``EngineConfig()``;
   since phases 36-40, whisper_small (at its prompt of 224) and
   internvl2_26b too, eight served models;
28. the serving studies at H100 rates: ``serving_sweep`` over
   ``benchmarks/bench_serving.py``'s grid (static, dynamic 10 ms,
   continuous at max_batch 8 x 10, 50, 200 rps, 64 requests) for the eight
   served models, and ``simulate_fleet`` over ``bench_fleet.py``'s quick
   replay (100,000 diurnal requests at 4000 rps, continuous batching of
   64, 4 replicas, round robin) on gemma3_1b: simulated requests a second
   of host CPU and the memo's hit rate.  The pricing of phase 27 and phase
   28 launch no kernel: the counts are asserted unchanged;
29. run granite_moe_1b_a400m cut to 4 layers at full width (d_model 1024,
   16 heads on 8 of head dim 64, 32 experts top-8) on the card against the
   same params on the CPU (plain path): 2 prompts of 300 tokens, the
   prefill logits, the KV cache and 2 decode steps fed the CPU's greedy
   tokens at ``BF16_TOL``, with exactly 4 bf16 ``wgmma`` launches at D =
   64.  Routing is discontinuous, so the check has two parts: each MoE
   layer's router, fed the card's own input on the CPU, must choose the
   card's experts (every index; a port fault shows here), and the CPU run
   that takes the card's expert choices (as both take the CPU's greedy
   tokens) is held to the card at ``BF16_TOL``.  The CPU's free run (its
   own routing) is logged beside it with the share of expert choices the
   two runs share, per layer, and the first flip's probability gap (a
   flip that rounding upstream caused sits on a near-tie);
30. serve granite_moe_1b_a400m at full width and depth (24 layers, bf16
   params from a seed made on the card) under ``SERVE``, with exactly 24 x
   2 = 48 ``wgmma`` launches at D = 64 and every logit finite; profile one
   prefill batch and 8 decode steps as in phase 6: the busy share, flash's
   share and the MoE stages' shares (routing, the experts' products, and
   dispatch: the one-hot cumsum, the slot scatter, the gathers and the
   combine);
31. as phase 29 for deepseek_v2_lite_16b cut to 2 layers (d_model 2048, MLA
   with 16 heads, its prefill attention on the flash kernel at D = 192;
   64 experts top-6 + 2 shared): exactly 2 ``wgmma`` launches at D = 192,
   the ``ckv`` and ``krope`` caches;
32. as phase 30 for deepseek_v2_lite_16b at full width and depth (27 MoE
   layers, 16.2 B bf16 params, about 32.4 GB): exactly 27 x 2 = 54
   ``wgmma`` launches at D = 192.
33. run zamba2_2_7b (the hybrid family: Mamba2 blocks, d_model 2560, 80
   SSM heads of head dim 64, state 64, chunk 256, and one shared attention
   + MLP block, 32 heads of head dim 80, after every 6) cut to 12 layers
   (2 superblocks) at full width on the card against the same params on
   the CPU (plain path): 2 prompts of 512 tokens (2 chunks; the reference
   asserts S % chunk == 0), the prefill logits and 2 decode steps fed the
   CPU's greedy tokens at ``BF16_TOL``, with exactly 2 bf16 ``wgmma``
   launches at D = 80; the ``k``, ``v``, ``conv`` and ``ssm`` caches of
   that run logged layer by layer (each device's own hidden states: bf16
   rounding grows with depth, to some 2% of the largest value at layer
   11); then every block fed the card's hidden state on both devices, its
   output and cache entries at ``BF16_TOL``, 2 more launches;
34. serve zamba2_2_7b at full width and depth (54 Mamba2 blocks, the shared
   block 9 times, bf16 params from a seed made on the card) under
   ``SERVE``, with exactly 9 x 2 = 18 ``wgmma`` launches at D = 80 and
   every logit finite; profile one prefill batch and 8 decode steps as in
   phase 6: the busy share, flash's share, and the shares of the Mamba2
   mixer and of its chunked SSD (the program's spans, ``SSM_RANGES``);
35. time flash at zamba2_2_7b's prefill shape (4, 32, 32, 1024, 80) causal
   in bf16 ``wgmma`` and float32 ``tf32x3``, beside the plain version,
   SDPA (bf16 and fp32, yardsticks only), the bound and the wrapper's host
   us a call.
36. run whisper_small (the encdec family: a 12-layer encoder over 1500
   precomputed frame embeddings plus a sinusoid table, non-causal; a
   12-layer decoder with learned positions, causal self-attention and
   cross-attention to the encoder; d_model 768, 12 heads of head dim 64)
   cut to 2 encoder + 2 decoder layers at full width on the card against
   the same params on the CPU (plain path): 2 prompts of 224 tokens with
   2 x 1500 random frames, the prefill logits, the ``k``, ``v``, ``xk``
   and ``xv`` caches and 2 decode steps fed the CPU's greedy tokens at
   ``BF16_TOL``, with exactly 4 bf16 ``wgmma`` launches at D = 64, 2 of
   them non-causal (the encoder's) and 2 causal; cross-attention is plain
   torch on both devices (``models/attention.py``'s docstring says why);
37. serve whisper_small at full width and depth (12 + 12 layers, bf16
   params from a seed made on the card) under ``SERVE`` with a prompt of
   224 tokens (half its decoder's 448-token context, so that 224 + 32 new
   tokens fit; whisper's prompt-conditioning limit), the frames as the
   reference's launcher makes them: exactly 24 x 2 = 48 ``wgmma``
   launches at D = 64, 24 of them non-causal; profile one prefill batch
   and 8 decode steps as in phase 6: the busy share, flash's share, and
   the shares of the encoder, the plain cross-attention in prefill and
   in decode (the program's spans, ``ENCODER_RANGES``, ``XATTN_RANGES``);
38. run internvl2_26b (the vlm family: the InternLM2-20B decoder, d_model
   6144, 48 heads on 8 of head dim 128, over 256 precomputed patch
   embeddings ahead of the tokens) cut to 2 layers at full width on the
   card against the same params on the CPU (plain path): 2 prompts of 256
   random patches + 128 tokens, the prefill logits, the KV cache and 2
   decode steps at the positions after the patches at ``BF16_TOL``, with
   exactly 2 ``wgmma`` launches at D = 128;
39. free every earlier model, then serve internvl2_26b at full width and
   depth (48 layers, 19.86 B bf16 params made on the card, about 39.7 GB)
   under ``SERVE`` (prompts of 1024 tokens after 256 patches): exactly 48
   x 2 = 96 ``wgmma`` launches at D = 128, the peak memory; profile one
   prefill batch and 8 decode steps: the busy share, flash's share, and a
   decode step's device time beside the least time its weights' bytes
   take at the HBM rate;
40. time flash at whisper_small's encoder shape (4, 12, 12, 1500, 64)
   without the causal mask and at internvl2_26b's prefill shape (4, 48,
   8, 1280, 128) causal, in both types (bf16 ``wgmma`` beside
   ``mma.sync``, float32 ``tf32x3`` beside ``fma``), beside the plain
   version, SDPA (``is_causal=False`` at the encoder's shape), the bound
   and the wrapper's host us a call.
   Phases 29-40 run after phase 27's measured batch and before its
   pricing, which prices their serving beside the others';
41. training's autograd functions: ``ops.flash_attention`` on CUDA
   tensors that require grad (the kernel forward, one launch; the backward
   the plain version's gradient, recomputed a 512-row query chunk at a
   time) at tinyllama_1_1b's attention (2, 32, 4, 1024, 64) causal and
   gemma3_1b's local layer (2, 4, 1, 1024, 256) with window 512, in both
   types, and at the shape phase 43 gives the kernel (4, 32, 4, 4096, 64)
   causal in bf16; ``ops.mamba_scan`` at (2, 256, 128, 16) with h0 in and
   h_S out: outputs at the kernels' tolerances, every gradient against
   autograd's through the plain version (relative L2: float32 1e-4, bf16
   3e-2; the plain side one batch element at a time), forward + backward
   timed beside the plain autograd; the raw wrappers refuse an input that
   requires grad, with no launch.  Then the kernel alone at phase 43's
   shape beside its bound, the plain version and SDPA;
42. one train step on the card against the CPU from the same params, for
   every arch's SMOKE config (at a head dim of the kernel:
   ``_card_smoke``) at 2 x 32 tokens and tinyllama_1_1b cut to 4 layers at
   full width at 2 x 512 tokens: two kernel launches an attention (or
   scan) layer (forward and recompute), loss and grad norm at
   ``BF16_TOL``, every gradient leaf at 3e-2 (hybrid ``HYBRID_GRAD_TOL``,
   on 8 params seeds, and in float32 on 3 seeds at 1e-4), every updated
   param within AdamW's step; a MoE model's CPU step takes the card's
   expert choices.  Then the cut trained 2 steps with a checkpoint and
   resumed (``launch.train.train(resume=True)``) for a third, against 3
   steps at once: the third loss at ``BF16_TOL``;
43. tinyllama_1_1b at full width and depth (22 layers, 1.1 B params, bf16
   params from a seed made on the card) through ``launch.train.train`` at
   train_4k's seq 4096 with a global batch of 8 (train_4k's 256 cut for
   one card and the time limit) in 2 microbatches of 4, 4 steps: exactly
   2 x 22 x 2 = 88 ``wgmma`` launches a step at D 64; ms a step (steps
   2-4), tok/s, peak memory; one more step profiled: the busy share and
   the shares of the flash forward, the plain attention backward, the
   clip and AdamW;
44. gemma3_1b at full width with ``PerfFlags(windowed_attention=True)``
   beside the baseline: one ``SERVE`` batch's prefill and 8 decode steps
   fed the baseline's tokens (first tokens equal, logits at ``BF16_TOL``
   at every step), then ``SERVE`` and a profiled prefill and 8 decode
   steps each way: decode ms a step, tok/s and decode device ms a step;
45. phase 43's step priced by ``sim.training.simulate_training``
   (tinyllama_1_1b, 1 stage, 2 microbatches of 4 x 4096) on one H100 at
   its bf16 peak, alone and with 50 us host dispatch an op: ms a step,
   tok/s and the forward / backward / update shares of the priced busy
   time, each beside phase 43's ms a step, its profiled device ms and the
   shares of the flash forward, the plain attention backward, clip and
   AdamW, with price / measured; once at the float32 default
   ``EngineConfig()``; a 1-stage 1-microbatch price asserted equal to the
   flat ``from_training_step`` chain through ``engine.run``; then
   ``launch.train.dry_run`` at train_4k's own 256 x 4096 in 64
   microbatches;
46. the training study (``benchmarks/bench_training.py``'s grid: gemma_2b
   and tinyllama_1_1b, GPipe and 1F1B, 1/2/4/8 stages, 2/8 microbatches,
   on its 2-port link with 10 us dispatch) and the cluster study
   (``benchmarks/bench_cluster.py``'s: gemma_2b and deepseek_v2_lite_16b
   on 8/64/512 GPUs, every power-of-two dp x pp x tp, ring / tree /
   hierarchical) at H100 rates and the bf16 peak, the cluster on
   ``Fabric.cluster``'s 4 x 8 layout and on a DGX H100's (8 GPUs on one
   NVSwitch, InfiniBand between nodes): the best placement at each size,
   the cheapest under 1 s a step, the host seconds.  Phases 45-46 launch
   no kernel: the counts are asserted unchanged across them;
47. the NCCL path at world size 1: a world-1 NCCL group and
   ``launch.mesh.make_host_mesh(1, 1)`` on the card; a raw ``all_reduce``
   and ``broadcast`` over each of its dimensions' groups (the port's own
   collectives skip a dimension of size 1); ``launch.train``'s
   smoke path (tinyllama_1_1b's SMOKE at head dim 16, batch 4 x 64, 3
   steps) with the mesh and ``rules_for``'s rules installed, its losses
   and params bit for bit those of the no-mesh run (12 flash launches
   each); ``pipeline_apply`` on a 1-stage mesh against its sequential run;
   a checkpoint restored onto the mesh with the rules' placements and
   saved again from its DTensor leaves, every leaf equal; ``--multi-pod``
   raising the reference's RuntimeError (512 ranks); the group destroyed;
48. two ranks on the one card over gloo (NCCL puts no two ranks on one
   GPU; gloo stages its CUDA collectives through the host), spawned
   with a ``FileStore`` in a temp dir: (a) granite_moe_1b_a400m at full
   width and depth, a prefill of ``SERVE``'s 4 x 1024 through phase 30's
   path, first as one process, then on mesh (data 1, model 2) with the MoE
   on expert parallelism, 16 experts a rank: each MoE layer fed the
   single process's input to it chooses the same experts and agrees
   within ``BF16_TOL``; the whole EP prefill launches flash 24 times a
   rank (its counts set to 0 just before, read just after), its logits
   and expert choices logged against the single process's; each rank's
   EP prefill ms beside its single-process ms (alone on the card) and its
   ``all_reduce`` ms; (b) a data-parallel train step of tinyllama_1_1b
   cut to 4 layers at full width, global batch 2 x 512, one sequence a
   rank, against one process on the whole batch (phase 42's bounds; and
   in float32 at 1e-4); (c) gemma3_1b's MLP with d_ff split over the two
   ranks inside a region that binds ``model`` (``tp_project``), against
   the unsplit MLP, with ``bf16_tp_collectives`` off and on;
49. on the same two ranks, the train step over a ``model`` axis (mesh
   (data 1, model 2), ``rules_for``'s rules at train_4k, params and
   AdamW's moments the rules' DTensors, each rank holding its shards):
   (a) tinyllama_1_1b and falcon_mamba_7b each cut to 4 layers at full
   width, global batch 2 x 512, bf16, against one process's step on the
   whole batch (phase 48b's bounds on the metrics and on every leaf's
   gradient, ``m`` and sqrt(``v``) shard; the updated params within phase
   42's bound), the flash kernel (D 64, 16 query heads on 2 KV heads a
   rank) or the scan (4096 of d_inner's 8192 channels a rank) launched
   twice a layer under autograd; (b) tinyllama_1_1b at full width and depth, 2 x 4096 tokens,
   4 steps through ``launch.train.train`` beside one process alone at the
   same batch: ms a step (steps 2-4, synced), peak GiB a rank, the losses
   (within ``BF16_TOL``), flash launches a rank (2 x 22 a step), and one
   more step with every gloo collective timed: their share;
50. on the same two ranks, the serving steps over ``model``
   (``serve.step`` with mesh (data 1, model 2) and ``rules_for``'s rules
   installed, the params the rules' DTensors, the cache placed by the
   rules: gemma3_1b's one KV head split on ``head_dim``): gemma3_1b at full
   width and depth, a prefill of 2 x 1024 and 32 decode steps,
   teacher-forced on one process's greedy tokens: every step's bf16
   logits against one process's float32 run, their largest error at most
   1.5 times one process's bf16 run's (``SERVE_TP_RATIO``), the distance to
   one process's bf16 logits logged, at least 95% of the greedy tokens
   equal; the same steps in float32 within 1e-3 of one process's float32
   run (``SERVE_TP_TOL``); a planted fault in each dtype (rank 1's half of
   each new key and value erased) measured by the same checks and logged;
   flash launched once a layer a rank (26, ``wgmma`` at D 256), prefill ms
   and decode ms a step a rank beside one process alone;
51. ``core.sampling.measure_sampled`` on the card: flash at gemma3_1b's
   serving shape, the float32 matmul (``tf32x3``) at the ``model`` grid's
   first shape and the scan at falcon_mamba_7b's serving shape, each in a
   loop of 64 launches timed in full (CUDA events) and unsampled from 2
   and from 1 launches, with each estimate's ``sampling_error``;
52. the dry run on the card's host, with no launch
   (``launch.dryrun.lower_cell`` on rank 0 of a fake process group, fake
   tensors): tinyllama_1_1b's ``train_4k``, ``prefill_32k`` and
   ``decode_32k`` on the 16 x 16 mesh and ``train_4k`` on 2 x 16 x 16, each
   cell's trace s, rank 0's FLOPs, bytes, collective and temp bytes and its
   roofline at the bf16 peak; then phase 43's one-device step analyzed and
   priced beside phase 43's measured ms and phase 45's price;
53. ``examples_torch/quickstart.py``'s ``main`` on the card: the residual
   unit's two convolutions on the matmul kernel (exactly 2 ``tf32x3``
   launches an execute), each fed the card's inputs against the plain
   version at the float32 matmul tolerance, the output against the same
   script on the CPU at ``GRAPH_TOL``; the two products timed (kernel,
   plain, ``torch.matmul``, bound); the H100-priced 4-worker makespan and
   utilization;
54. ``examples_torch/camera_pipeline.py``'s ``main`` on the card: the 720p
   frame's ISP and CNN10 (phase 12's 4 ``tf32x3`` + 2 ``stream``) against
   its measured half, ``launch.camera.run_frame``, on the CPU; ISP ms,
   CNN10 ms, the frame
   priced on 8 accelerators at H100 constants after the measured ISP and
   its verdict against 33 ms;
55. ``examples_torch/train_lm.py``'s ``main`` with ``--preset full``:
   tinyllama_1_1b at full width and depth, 4 x 128 tokens, 4 steps and one
   save, then ``--resume`` to 6 steps (``resumed from step 3``), in a
   temporary directory: finite losses, the restored params and moments
   bit-equal to a host copy of the saved state, 44 ``wgmma`` launches a
   step; ms a step, tok/s, peak GiB, the checkpoint's GiB, save and
   restore s; then steps 1-3 of its ``run`` on batches keyed by step at 1
   x 128, on the card and on the CPU from the same params, each step's
   loss and grad norm within 2e-2; flash timed at (4, 32, 4, 128, 64);
56. ``examples_torch/serve_batch.py``: its ``main`` at its defaults
   (gemma3_1b's SMOKE); its ``run_measured`` is phase 27's function;
57. the tiling optimizer on the card (``core/tiling.py::
   choose_matmul_tiling``): (a) every tile of every matmul variant
   (``nvdla_matmul.tiles``) against the plain version at the
   ``tests/test_kernels.py`` shapes, ragged ones (M 17, K 1) and a split-K
   one, at the chooser's split for the tile, and the wrapper's and the
   kernel's refusals of a tile it does not instantiate and of a split its k
   ranges cannot give; (b) at the ``model`` grid, every Table-III product
   at batch 64 and 1 and the quickstart's two convs, the chosen tile, its
   stages and split, its ms beside the tile the kernel fixed before
   (``previous_tile``, passed explicitly), ``torch.matmul`` and the bound,
   and the wrapper's host us a call with the chooser; (c) every tf32x3 tile
   at each of those shapes tf32x3 takes, the chooser's pick beside the
   fastest, whose sum the chooser's constants were fit to;
58. the flash and scan kernels' block shapes from the caller: (a) every
   tile of both Hopper flash variants (``flash_attention.tiles``) at every
   head dim against the plain version at ragged S, S below one tile, a
   window edge off the tile grid, GQA and MQA and without the causal mask,
   and every scan tile (``mamba_scan.tiles``) in both types at both N with
   h0 in and h_S out; the library's report of each instance (stages, shared
   bytes, registers, local bytes) beside ``tile_of``'s layout, and no
   instance for any other tile; (b) the wrappers' and the libraries'
   refusals of a tile they do not instantiate; (c) each tile's ms beside
   the default's, timed in turns a b b a in one call, at the shape the
   PERF.md row of its variant and head dim times (the scan's serving shape
   with h_S out), with its bound.
59. the Mamba1 mixer's coefficient kernels (``kernels/mamba_coeffs.py``):
   one falcon_mamba_7b prefill at full width and depth, 1 x 1024 tokens,
   launching conv1d_silu, dt_softplus and the scan exactly once a layer;
   then at its served prefill shapes (8, 1024 / 2048 / 4000, 8192), x read
   in place from the (8, S, 16384) ``in_proj`` product, conv1d_silu within
   one bf16 ulp of the chain in float32 and dt_softplus within 2 float32
   ulps of its plain version, and each kernel's ms beside its bound
   (bytes), the plain chain's ms and the wrapper's host us a call.

Kernel times are CUDA events around back-to-back calls queued behind a
device-side wait (``torch.cuda._sleep``) that outlasts their enqueue, so
that they are the card's time and not the wrapper's host time.  The line
before the last is a JSON ``kernels`` summary (flash's launches by path:
gemma3_1b serving, phi3_mini_3_8b serving, calibration, serve_batch
(gemma3_1b), granite_moe_1b_a400m serving, deepseek_v2_lite_16b serving,
zamba2_2_7b serving, whisper_small serving, internvl2_26b serving,
tinyllama_1_1b training, gemma3_1b serving with the windowed flag, phase
48's EP prefill, phase 49's TP steps and phase 50's serving steps (each
rank's own count), phase 51's sampled loops, the train_lm and serve_batch
examples, and its times at head dims
16, 32, 64 (non-causal; and tinyllama_1_1b's training
shapes, phase 43's and train_lm's), 80, 96, 128 and 192; the matmul's
launches by path gain the quickstart and camera_pipeline examples, and its
``examples`` the quickstart's two products, and ``tiling`` phase 57's
summary (the model grid's rows, the other shapes' sums by origin); each
flash entry's ``tiles`` and the scan's phase 58's rows;
the scan's entry:
its launches by path, calibration, falcon_mamba_7b serving, phase
49a's TP step and phase 51's sampled loops, and its
times at the serving shape); the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import importlib.util
import io
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import sim  # noqa: E402
from repro_torch.apps.camera import (camera_program,  # noqa: E402
                                     camera_soc, frame_sweep,
                                     soc_frame_sweep)
from repro_torch.apps.paper_graphs import build_paper_graph  # noqa: E402
from repro_torch.apps.serving import default_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_nets import PAPER_NETS  # noqa: E402
from repro_torch.convert import to_device  # noqa: E402
from repro_torch.core import graph_ops, tree  # noqa: E402
from repro_torch.kernels import _build, calibrate, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_coeffs as mc  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import nvdla_matmul as mm  # noqa: E402
from repro_torch.launch import camera  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.serve_batch import run_measured  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batch  # noqa: E402
from repro_torch.dist import context as dist_ctx  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.policy import get_policy  # noqa: E402
from repro_torch.serve.step import (greedy, make_decode_step,  # noqa: E402
                                    make_prefill_step, prefill_inputs,
                                    prompt_positions)
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.tensor import TensorSpec  # noqa: E402
from repro_torch.core.tiling import H100 as H100_TILING  # noqa: E402
from repro_torch.core.tiling import choose_tiling  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.sim import hw  # noqa: E402
from repro_torch.sim.serving import (Request, diurnal_trace,  # noqa: E402
                                     replay_serving, serving_sweep,
                                     simulate_fleet, simulate_serving)
from repro_torch.sim.sweep import batched, lower_graph, optimize  # noqa: E402
from repro_torch.sim.sweep import (as_cluster_records,  # noqa: E402
                                   as_training_records, cluster_sweep,
                                   training_sweep)
from repro_torch.sim.training import simulate_training  # noqa: E402
from repro_torch.ckpt import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.core.config import SHAPE_BY_NAME  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.pipeline import pipeline_apply  # noqa: E402
from repro_torch.dist.tp import mark_shard  # noqa: E402
from repro_torch.dist.sharding import rules_for  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.layers import mlp_apply, mlp_init  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # tests/test_kernels.py
BF16_TOL = 2e-2              # tests/test_torch_serve.py
KERNEL_CASES = [  # B, H, Hkv, S, D, causal, window
    (1, 2, 2, 128, 32, True, 0),            # tests/test_kernels.py
    (2, 4, 2, 128, 64, True, 0),
    (1, 2, 1, 256, 32, True, 48),
    (1, 2, 2, 128, 32, False, 0),
    (4, 4, 1, 1024, 256, True, 512),        # gemma3_1b local layer
    (4, 4, 1, 1024, 256, True, 0),          # gemma3_1b global layer
    (4, 4, 1, 1000, 256, True, 512),        # ragged S
    (4, 4, 1, 1024, 64, True, 0),           # the Hopper variant's other Ds
    (4, 4, 1, 1024, 128, True, 512),
    (2, 4, 2, 1000, 128, True, 0),          # ragged S, GQA
    (1, 4, 1, 77, 256, True, 0),            # S below two tiles
    (1, 4, 1, 77, 64, True, 30),
    (2, 4, 1, 1024, 256, True, 64),         # window of one tile
    (1, 4, 1, 1000, 128, True, 100),        # window off the tile grid
    (1, 2, 1, 300, 256, False, 0),          # no causal mask
    (1, 2, 1, 256, 64, False, 70),          # window without causal
    (4, 32, 32, 1024, 96, True, 0),         # phi3_mini_3_8b prefill
    (4, 32, 32, 1024, 16, True, 0),         # padded boxes: D 16 and 32
    (4, 32, 32, 1024, 32, True, 0),
    (2, 4, 2, 1000, 96, True, 0),           # ragged S, GQA
    (1, 4, 1, 77, 16, True, 30),            # S below two tiles, window
    (1, 4, 2, 50, 96, True, 0),             # S below one tile
    (1, 2, 1, 300, 16, False, 0),           # no causal mask
    (1, 2, 2, 256, 96, False, 70),          # window without causal
    (2, 4, 1, 1000, 32, True, 100),         # window off the tile grid
    (2, 4, 4, 1000, 192, True, 0),          # MLA's q/k width: ragged S,
    (1, 4, 2, 77, 192, True, 30),           # GQA and a window,
    (1, 2, 2, 300, 192, False, 0),          # no causal mask
    (4, 32, 32, 1024, 80, True, 0),         # zamba2_2_7b prefill; D 80:
    (2, 4, 4, 1000, 80, True, 0),           # ragged S,
    (1, 4, 2, 77, 80, True, 0),             # ragged S below two tiles, GQA,
    (2, 4, 1, 1000, 80, True, 100),         # a window off the tile grid,
    (2, 4, 2, 1000, 80, True, 0),           # GQA 4 on 2,
    (1, 2, 2, 300, 80, False, 0),           # no causal mask
    (2, 12, 12, 1500, 64, False, 0),        # whisper_small encoder: no
    (1, 48, 8, 1280, 128, True, 0),         # mask; internvl2_26b prefill
    (4, 32, 4, 128, 64, True, 0),           # train_lm example, full preset
]
# deepseek_v2_lite_16b's MLA prefill attention in SERVE: B, H, Hkv, S, D,
# causal, window, with v zero past column 128 (MLA pads v from 128 to 192)
MLA_V = 128
MLA_CASES = [(4, 16, 16, 1024, 192, True, 0)]
SERVE = dict(requests=8, batch=4, prompt_len=1024, max_new=32)
# the head dims off whole 128-byte TMA boxes, and phi3_mini_3_8b's prefill
# attention in SERVE at each (causal): B, H, Hkv, S, D
SMALL_D = (16, 32, 96)
PHI3_PREFILL = [(SERVE["batch"], get_config("phi3_mini_3_8b").n_heads,
                 get_config("phi3_mini_3_8b").n_kv_heads, SERVE["prompt_len"],
                 D) for D in SMALL_D]
DEEPSEEK_PREFILL = MLA_CASES[0][:5]
GRANITE_PREFILL = (SERVE["batch"], get_config("granite_moe_1b_a400m").n_heads,
                   get_config("granite_moe_1b_a400m").n_kv_heads,
                   SERVE["prompt_len"],
                   get_config("granite_moe_1b_a400m").resolved_head_dim)
# phases 33-35: zamba2_2_7b, its shared attention at head dim 80 (columns
# 64-79 lie past the first TMA box); the cut's layers (2 superblocks) and
# prompts (2 chunks of 256: the reference asserts S % chunk == 0)
ZAMBA_PREFILL = (SERVE["batch"], get_config("zamba2_2_7b").n_heads,
                 get_config("zamba2_2_7b").n_kv_heads, SERVE["prompt_len"],
                 get_config("zamba2_2_7b").resolved_head_dim)
ZAMBA_CUT = 12
ZAMBA_PROMPTS = (2, 512)
# phases 36-40: whisper_small serves SERVE's requests at a prompt of 224
# tokens, half its decoder's 448-token context (arXiv:2212.04356), so that
# 224 + 32 new tokens fit; its encoder's prefill attention is non-causal
# over 1500 frames.  internvl2_26b serves SERVE, 256 patches ahead of each
# prompt.  The card-against-CPU cuts: layers (whisper: encoder and decoder
# each) and prompts (count, tokens)
SERVE_OF = {"whisper_small": dict(SERVE, prompt_len=224)}
WHISPER_ENCODER = (SERVE["batch"], get_config("whisper_small").n_heads,
                   get_config("whisper_small").n_kv_heads,
                   get_config("whisper_small").encoder.n_ctx,
                   get_config("whisper_small").resolved_head_dim)
INTERNVL_PREFILL = (SERVE["batch"], get_config("internvl2_26b").n_heads,
                    get_config("internvl2_26b").n_kv_heads,
                    prompt_positions(get_config("internvl2_26b"),
                                     SERVE["prompt_len"]),
                    get_config("internvl2_26b").resolved_head_dim)
ENCDEC_VLM_CUTS = {"whisper_small": (2, (2, 224)),
                   "internvl2_26b": (2, (2, 128))}
# phases 41-44: training.  The autograd functions' shapes (B, H, Hkv, S,
# D, causal, window) and types: tinyllama_1_1b's attention at its head dim
# 64, GQA 32 on 4, and gemma3_1b's local layer (D 256, MQA, window 512), in
# both types; then the shape phase 43's training gives the kernel (a
# microbatch of 4 at seq 4096), in bf16 as it trains; the scan with h0 in
# and h_S out, b, S, d, N
TRAIN_FLASH_SHAPE = (4, 32, 4, 4096, 64)
TRAIN_FLASH_CASES = [((2, 32, 4, 1024, 64, True, 0),
                      (torch.float32, torch.bfloat16)),
                     ((2, 4, 1, 1024, 256, True, 512),
                      (torch.float32, torch.bfloat16)),
                     ((*TRAIN_FLASH_SHAPE, True, 0), (torch.bfloat16,))]
TRAIN_SCAN_CASE = (2, 256, 128, 16)
# the relative L2 error of a gradient leaf, card against CPU, and of the
# Functions' gradients against the plain ones in bf16: the CPU tests' bf16
# bound (tests/_torch_grads.py); float32 gradients at the kernel's 1e-4
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the hybrid family's card-against-CPU gradients in bf16.  Its largest
# leaf is an ``A_log`` or ``dt_bias`` (a sum over every position of terms
# of both signs, so bf16 rounding survives where the terms cancel): over
# params seeds 1-8 of zamba2's SMOKE it read 2.479e-02 to 5.373e-02
# (H100 80GB HBM3, 700.00 W), every other family's leaves under 3e-2.  The
# same step in float32 holds the Functions, card against CPU, at
# ``GRAD_TOL[torch.float32]`` (5.192e-06 at most over seeds 1-3), where a
# fault of theirs would still show; the bf16 bound sits between that
# spread and the O(1) error of a missing or wrong gradient
HYBRID_GRAD_TOL = 1e-1
HYBRID_SEEDS = range(2, 9)       # params seeds beside 1, in bf16
HYBRID_F32_SEEDS = (1, 2, 3)     # and in float32
TRAIN_LR = 1e-3          # one step's lr (warmup 1): AdamW moves about lr
# tinyllama_1_1b cut to 4 layers at full width, 2 x 512 tokens, card
# against CPU; then resumed from a checkpoint
TRAIN_CUT, TRAIN_CUT_BATCH = 4, (2, 512)
# tinyllama_1_1b at full width and depth on train_4k's seq 4096 and a
# global batch of 8 (train_4k's is 256: cut for one card and the time
# limit) in 2 microbatches of 4, 4 steps
TRAIN_FULL = dict(batch=8, seq=4096, microbatches=2, steps=4)
# phase 44: gemma3_1b's decode steps compared with windowed_attention on
# and off (teacher-forced, the off run's greedy tokens)
WINDOWED_STEPS = 8
# the stages of a training step read from the program's spans
# (repro_torch.core.spans), label -> span: the plain attention backward
# (kernels.ref) and the optimizer (optim.optimizers)
BWD_RANGES = {"attention backward (plain)": "repro_torch.attn.bwd_ref"}
OPT_RANGES = {"clip": "repro_torch.optim.clip",
              "optimizer": "repro_torch.optim.adamw"}
# tests/test_kernels.py tolerances: matmul rtol tol, atol tol * sqrt(K);
# scan rtol tol, atol 4 tol
MM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
MM_CASES = [  # M, N, K
    (128, 128, 128), (256, 128, 384),       # tests/test_kernels.py
    (512, 256, 256), (128, 512, 640),
    (100, 72, 200), (17, 130, 33), (4, 6912, 1152),      # ragged edges
    (200, 6912, 1152), (4100, 1032, 1152),   # M, N off the Hopper tile
    (512, 1024, 4096),                       # K: 64 turns of a 4-stage ring
    (784, 32, 9), (1024, 32, 27), (1024, 64, 27),   # graph path: K under
    (1024, 192, 27),                                # one 32-wide TF32 row
    (64, 10, 512), (64, 100, 300),           # logits: tf32x3 at batch 64,
    (1, 10, 512), (1, 100, 300),             # stream at batch 1
    (1, 10, 6272),                           # stream, N % 4 != 0, large K
] + list(calibrate.MODEL_GRIDS["matmul"])
SCAN_CASES = [  # b, S, d, N
    (1, 32, 16, 8), (2, 64, 32, 16),        # tests/test_kernels.py
    (1, 128, 64, 8),
    (1, 77, 40, 16), (3, 200, 130, 8),                   # ragged S and d
] + list(calibrate.MODEL_GRIDS["mamba"])
CAL_TOL = {"matmul": MM_TOL[torch.float32], "attention": TOL[torch.float32],
           "mamba": SCAN_TOL[torch.float32]}   # calibration runs float32
CALIBRATION = (("model", 3), ("full", 3))   # grid, repeat
GRAPH_BATCHES = (1, 64)
# the matmul's launches by variant along one forward of each Table-III net,
# as nvdla_matmul.variant's float32 rule names them for the nets' conv and
# FC shapes (M > 16 rows: tf32x3, else stream): {net: {batch: counts}}
GRAPH_LAUNCHES = {
    "minerva": {1: {"stream": 4}, 64: {"tf32x3": 4}},
    "lenet5": {1: {"tf32x3": 2, "stream": 2}, 64: {"tf32x3": 4}},
    "cnn10": {1: {"tf32x3": 4, "stream": 2}, 64: {"tf32x3": 6}},
    "vgg16": {1: {"tf32x3": 7, "stream": 5}, 64: {"tf32x3": 12}},
    "elu16": {1: {"tf32x3": 5, "stream": 6}, 64: {"tf32x3": 11}},
}
# logits, card against CPU: rtol, and atol as a share of max |CPU logits|;
# looser than a node's because rounding compounds over up to 13 layers and
# batch norm divides by a batch std (vgg16 at batch 64 reaches 1.4e-4)
GRAPH_TOL = 5e-4
GRAPH_RUNS = 20           # timed forwards (and camera frames) a median takes
ISP_TOL = 1e-5            # RGB frame and DNN input, card against CPU
FALCON_CUT = 2            # layers of the full-width card-against-CPU check
FALCON_PROMPTS = (2, 300)  # prompts x tokens: 300 is off the 32-step chunk
PHI3_CUT = 4               # layers of phi3_mini_3_8b's card-against-CPU check
PHI3_PROMPTS = (2, 300)    # prompts x tokens: 300 is off the 64-row tile
# phases 29-32: the moe family; layers of each card-against-CPU check
MOE_CUTS = {"granite_moe_1b_a400m": 4, "deepseek_v2_lite_16b": 2}
MOE_PROMPTS = (2, 300)
# phase 24: benchmarks/bench_camera.py:27's PE grid, (workers, PE fraction)
# on its base point (acp, 4 ports), then one H100 (EngineConfig())
PE_GRID = ((8, 1.0), (4, 0.5), (2, 0.25))
# phase 25: benchmarks/bench_soc.py:43-56, frontends x accelerators x shared
# ports, and its embedded base point (SMAUG's SoC regime, not the card's)
SOC_GRID = [(frontend, n, ports) for frontend in ("cpu", "dsp")
            for n in (1, 2, 4, 8) for ports in (1.0, 4.0)]
SOC_BASE = sim.EngineConfig(interface="dma", peak_flops=1.28e11,
                            hbm_bw=25.6e9, vmem_bw=1e12, host_dispatch_s=1e-6)
SOC_TILE = 2048
# phase 26: gemma3_1b's decode chain at SERVE's shape (625 tokens x 8 ops =
# 5,000 ops) priced over 64 x 64 points, peak_flops and hbm_bw each
# geometric from 1/64 of the H100's value to 4x it
DECODE_CHAIN = dict(n_tokens=625, ops_per_token=8,
                    seq_len=SERVE["prompt_len"], batch=SERVE["batch"])
GRID_SIDE = 64
H100_POINT = {"peak_flops": hw.PEAK_FLOPS, "hbm_bw": hw.HBM_BW}
SPACE = {k: (v / 64, 4 * v) for k, v in H100_POINT.items()}
GRAD_Z = np.array([[0.3, 0.7], [0.5, 0.5], [0.9, 0.1], [0.1, 0.9]])
# phases 27-28: the served models, priced on one H100 at its bf16 peak
# (``apps.serving.default_config``), alone and with
# benchmarks/bench_serving.py:37-38's host dispatch of 50 us a step
SERVED = ("gemma3_1b", "falcon_mamba_7b", "phi3_mini_3_8b",
          "granite_moe_1b_a400m", "deepseek_v2_lite_16b", "zamba2_2_7b",
          "whisper_small", "internvl2_26b")
HOST_DISPATCH_S = 50e-6
# phase 28: benchmarks/bench_serving.py:30-35's policy x rate grid and
# benchmarks/bench_fleet.py's quick replay (100,000 diurnal requests)
GRID_POLICIES = (("static", {}), ("dynamic", {"max_wait_s": 0.010}),
                 ("continuous", {}))
GRID_RATES = (10.0, 50.0, 200.0)
GRID_REQUESTS = 64
FLEET_QUICK = dict(n_requests=100_000, rate_rps=4000.0, output_len=(4, 16),
                   max_batch=64, n_replicas=4)
# phase 45: launch.train.dry_run at train_4k's own shape: its global batch
# of 256 at seq 4096, in 64 microbatches of 4 (phase 43's microbatch)
DRY_RUN = dict(arch="tinyllama_1_1b", shape_name="train_4k",
               n_microbatches=64, schedule="1f1b")
# phase 46: benchmarks/bench_training.py:44-62's grid on its config (hbm,
# 2 shared ports, 10 us dispatch), at the bf16 peak
TRAIN_STUDY_MODELS = ("gemma_2b", "tinyllama_1_1b")
TRAIN_STUDY = dict(schedules=("gpipe", "1f1b"), n_stages_grid=(1, 2, 4, 8),
                   n_microbatches_grid=(2, 8), seq_len=512, global_batch=8)
TRAIN_STUDY_CONFIG = dict(interface="hbm", hbm_ports=2,
                          host_dispatch_s=10e-6)
# benchmarks/bench_cluster.py's grid and its 1 s a step target, on the
# reference's layout (Fabric.cluster's 4 x 8: 32 GPUs share NVLink) and on
# a DGX H100's (8 GPUs on one NVSwitch, NDR InfiniBand between nodes)
CLUSTER_STUDY_MODELS = ("gemma_2b", "deepseek_v2_lite_16b")
CLUSTER_STUDY = dict(n_accel_grid=(8, 64, 512),
                     algos=("ring", "tree", "hierarchical"), seq_len=512,
                     global_batch=32)
CLUSTER_LAYOUTS = (("Fabric.cluster defaults, 4 x 8", {}),
                   ("DGX H100, 8 x 1", dict(accels_per_chip=8,
                                            chips_per_node=1)))
STEP_TARGET_S = 1.0
# phase 47: launch.train's smoke path (batch 4 x 64) on a (1, 1) NCCL mesh
NCCL_STEPS = 3
# phase 48: two ranks on the one card over gloo (NCCL puts no two ranks on
# one GPU); granite's EP prefill at SERVE's batch, timed EP_TIMED times; the
# data-parallel step of tinyllama cut to TRAIN_CUT layers at
# TRAIN_CUT_BATCH, one sequence a rank; gemma3_1b's MLP split over the ranks
EP_RANKS = 2
EP_ARCH = "granite_moe_1b_a400m"
EP_TIMED = 5
TP_ARCH = "gemma3_1b"
TP_TOKENS = (4, 1024)
RANK_TIMEOUT_S = 600
# phase 49: the train step over a 'model' axis on the same two ranks, mesh
# (data 1, model 2), the rules of train_4k: (a) each arch cut to TRAIN_CUT
# layers at full width, global batch TRAIN_CUT_BATCH, against one process
# at phase 48b's bounds; (b) tinyllama_1_1b at full width and depth,
# TP_FULL, beside one process at the same batch
TP_CUTS = ("tinyllama_1_1b", "falcon_mamba_7b")
TP_FULL = dict(batch=2, seq=4096, steps=4)
# phase 50: the serving steps over 'model' on the same two ranks: gemma3_1b
# at full width and depth, a prefill of batch x prompt_len and steps decode
# steps, teacher-forced on one process's greedy tokens
SERVE_TP = dict(arch="gemma3_1b", batch=2, prompt_len=1024, steps=32)
# the mesh's float32 logits within SERVE_TP_TOL of one process's float32
# run's, every step, their largest error relative to the largest logit: on
# the card 2.4e-6 to 2.7e-5 (the bf16 caches round the two runs apart),
# and 1.0e-2 at the first step that reads the planted fault.  The bf16 runs
# are not held to a bound of their own: two bf16 runs of the 26 layers each
# sit about 2e-2 of the largest logit off the float32 one (and 2e-2 in
# norm: gemma3_1b's 2 x 64 prompt on the CPU, 1.9-2.0e-2), 1.7-2.6e-2 off
# each other on the card
SERVE_TP_TOL = 1e-3
# the mesh's bf16 logits held to one process's float32 run: their largest
# error at most this many times one process's bf16 run's
SERVE_TP_RATIO = 1.5
# at least this share of the mesh's bf16 greedy tokens equal to one
# process's
SERVE_TP_GREEDY = 0.95
# the planted fault: the mesh again for this many decode steps in each
# dtype, rank 1's shard of each new key and value erased after the step
# that wrote it, measured by the same checks (logged, not held)
SERVE_TP_FAULT_STEPS = 4
# phase 51: each kernel in a loop of SAMPLED_N launches, timed in full and
# at 2 and 1 launches (core.sampling.measure_sampled)
SAMPLED_N = 64
# phase 52: the dry run on the card's host (fake process group, fake
# tensors): tinyllama_1_1b's cells by mesh
DRY_CELLS = {"pod16x16": ("train_4k", "prefill_32k", "decode_32k"),
             "pod2x16x16": ("train_4k",)}
# phases 53-56: the port's examples (examples_torch/, loaded by path), each
# through its own main or its factored functions.  quickstart's unit runs
# conv0 as (1024, 72) @ (72, 64) and conv1 as (1024, 576) @ (576, 8), both
# float32 tf32x3 (M > 16).  train_lm's full preset is tinyllama_1_1b at
# full width and depth at the example's default batch 4 x 128 tokens:
# TRAIN_LM["steps"] steps with one save at the last, then a resume to
# TRAIN_LM["resume_steps"]
EXAMPLES = Path(__file__).resolve().parent / "examples_torch"
# phase 57: the tiling optimizer on the card.  (a) every tile of every
# matmul variant against the plain version: tests/test_kernels.py's four
# shapes, shapes off every tile (M 17, K 1) and one whose tiles are too few
# for the SMs (K split); the decoding-row variants' own at M <= 16.  (b) the
# quickstart's two convs (conv0 (1024, 72) @ (72, 64), conv1 (1024, 576) @
# (576, 8)) beside the model grid and the nets' products.  (c) every tf32x3
# tile, unsplit and at its split, at each of those shapes that tf32x3 takes
TILE_CASES = [(128, 128, 128), (256, 128, 384), (512, 256, 256),
              (128, 512, 640), (100, 72, 200), (17, 130, 33), (40, 24, 1),
              (64, 128, 6272)]
TILE_CASES_SMALL_M = [(1, 3, 1), (4, 100, 300), (16, 1030, 1000),
                      (4, 128, 6272)]
QUICKSTART_CONVS = [(1024, 64, 72), (1024, 8, 576)]
QUICKSTART_LAUNCHES = {"tf32x3": 2}
TRAIN_LM = dict(steps=4, resume_steps=6, batch=4, seq=128)
# and, since the example's two pipeline workers do not fix the order of the
# batches, steps [TRAIN_FIXED["start"], TRAIN_FIXED["steps"]) through its
# ``run`` on batches keyed by step (``synthetic_batch`` at seed i), cut to
# one sequence, on the card and on the host's CPU from the same params
# (step 0, whose lr is 0, left out: the CPU takes some 30 s a step)
TRAIN_FIXED = dict(start=1, steps=4, batch=1)
TRAIN_FIXED_TOL = 2e-2      # bf16, card against CPU (tests/test_torch_gpu.py)
TRAIN_LM_SHAPE = (TRAIN_LM["batch"], get_config("tinyllama_1_1b").n_heads,
                  get_config("tinyllama_1_1b").n_kv_heads, TRAIN_LM["seq"],
                  get_config("tinyllama_1_1b").resolved_head_dim)
# phase 58: the flash and scan kernels' block shapes from the caller.  (a)
# every tile of both Hopper flash variants at every head dim against the
# plain version, in its type at tests/test_kernels.py's tolerances, at
# TILE_FLASH_CASES (B, H, Hkv, S, causal, window); every scan tile, both
# types and both N, at TILE_SCAN_CASE (b, S, d) with h0 in and h_S out.
# (b) the refusals.  (c) each tile timed beside the default in one call,
# a b b a, at the shape PERF.md's row times for its variant and head dim
# (B, H, Hkv, S, D, causal), the scan's at its serving shape with h_S out
TILE_FLASH_CASES = [
    (1, 4, 2, 100, True, 0),     # S ragged, GQA
    (1, 2, 1, 40, True, 0),      # S below one tile, MQA
    (1, 4, 1, 300, True, 70),    # a window edge off the tile grid, MQA
    (1, 2, 2, 100, False, 0),    # no causal mask
]
TILE_SCAN_CASE = (2, 77, 40)
GEMMA_PREFILL = (SERVE["batch"], get_config("gemma3_1b").n_heads,
                 get_config("gemma3_1b").n_kv_heads, SERVE["prompt_len"],
                 get_config("gemma3_1b").resolved_head_dim)
TILE_FLASH_SHAPES = {
    "wgmma": {16: (*PHI3_PREFILL[0], True), 32: (*PHI3_PREFILL[1], True),
              64: (*TRAIN_FLASH_SHAPE, True), 80: (*ZAMBA_PREFILL, True),
              96: (*PHI3_PREFILL[2], True), 128: (*INTERNVL_PREFILL, True),
              192: (*DEEPSEEK_PREFILL, True), 256: (*GEMMA_PREFILL, True)},
    "tf32x3": {16: (*PHI3_PREFILL[0], True), 32: (*PHI3_PREFILL[1], True),
               64: (*WHISPER_ENCODER, False), 80: (*ZAMBA_PREFILL, True),
               96: (*PHI3_PREFILL[2], True), 128: (*INTERNVL_PREFILL, True),
               192: (*DEEPSEEK_PREFILL, True),
               256: (*calibrate.MODEL_GRIDS["attention"][1], True)}}
TILE_SCAN_SHAPE = (4, 1024, 8192, 16)


def log(*args):
    # one write a line: phase 48's ranks share the stream
    sys.stdout.write(" ".join(map(str, args)) + "\n")
    sys.stdout.flush()


def rand_qkv(B, H, Hkv, S, D, dtype, seed=0, v_width=None):
    """Random q, k, v; with ``v_width``, v zero past that column (MLA)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = [torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    if v_width is not None:
        v[..., v_width:] = 0
    return q, k, v


def identify():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {name}; count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    return name, smi


def build_kernels():
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR}")
    for name, path in libs.items():
        log_path = path.with_suffix(".log")
        if log_path.exists():   # ptxas report of a fresh build, by kernel
            for entry in log_path.read_text().split("Compiling entry")[1:]:
                kernel = entry.split("'")[1]
                kernel = kernel[max(kernel.find("GLOBAL__N_"), 0):][-72:]
                used = [line.split(":", 1)[-1].strip()
                        for line in entry.splitlines()
                        if "Used" in line or "spill" in line]
                log(f"  {name} ...{kernel}: {'; '.join(used)}")


def _check(name, out, expect, rtol, atol):
    """assert_allclose's rule, |out - expect| <= atol + rtol |expect|, on the
    card; returns the largest error."""
    diff = (out.float() - expect.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * expect.float().abs()).all()) \
        and bool(torch.isfinite(out.float()).all())
    log(f"{name}: max_abs_err {err:.3e} (rtol {rtol}, atol {atol:.3g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name} mismatch: {err}")
    return err


# the variants held and timed beside the one a shape rule names: the older
# kernels it replaced
_BESIDE = {(fa, "wgmma"): ["mma_sync"], (fa, "tf32x3"): ["fma"],
           (mm, "wgmma"): ["mma_sync"], (mm, "tf32x3"): ["fma"],
           (mm, "stream"): ["fma"]}


def _variants(kernel, dtype, *shape):
    """The variant that the shape rule of ``kernel`` (the module ``fa`` or
    ``mm``) names, and those ``_BESIDE`` it that are built for the shape
    (flash's older kernels are not built at head dim 192)."""
    name = kernel.variant(*shape, dtype)
    beside = _BESIDE.get((kernel, name), [])
    if kernel is fa:
        beside = [b for b in beside if shape[0] in fa.VARIANT_HEAD_DIMS[b]]
    return [name] + beside


def _ran(fn, name, call):
    """``call()`` after checking that it launched the kernel once, in the
    variant ``name``."""
    before = dict(fn.launches_by_variant)
    out = call()
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in fn.launches_by_variant.items()
           if n != before[k]}
    if ran != {name: 1}:
        raise AssertionError(f"expected one {name} launch, got {ran}")
    return out


def check_kernel():
    """Every case in fp32 and bf16, kernel vs plain version on the card, in
    each variant of ``_variants``.  Returns the largest error at the serving
    shapes in bf16 of the variant serving runs, and the largest error of
    float32 ``tf32x3``."""
    worst, worst_f32 = 0.0, 0.0
    cases = [(c, None) for c in KERNEL_CASES] + [(c, MLA_V) for c in MLA_CASES]
    for case, v_width in cases:
        B, H, Hkv, S, D, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = rand_qkv(B, H, Hkv, S, D, dtype, v_width=v_width)
            expect = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)
            for name in _variants(fa, dtype, D):
                out = _ran(fa.flash_attention, name,
                           lambda: fa.flash_attention(
                               q, k, v, causal=causal, window=window,
                               kernel=name))
                err = _check(f"kernel {name} vs plain {case} {dtype}"
                             + (f" v zero past {v_width}" if v_width else ""),
                             out, expect, TOL[dtype], TOL[dtype])
                if v_width and not bool((out[..., v_width:] == 0).all()):
                    raise AssertionError(f"{name} {case}: output past "
                                         f"column {v_width} not 0")
                if D == 80:   # the columns past the first TMA box
                    _check(f"kernel {name} vs plain {case} {dtype} columns "
                           f"64-79", out[..., 64:], expect[..., 64:],
                           TOL[dtype], TOL[dtype])
                if D == 256 and name == fa.variant(D, dtype) == "wgmma":
                    worst = max(worst, err)
                if name == "tf32x3":
                    worst_f32 = max(worst_f32, err)
    return worst, worst_f32


def _bf16_close(name, out, expect, strict=True):
    """``out`` against ``expect`` at ``BF16_TOL`` (rtol, and atol as a
    share of max |expect|); raises on a mismatch if ``strict``, else only
    logs it.  Returns whether they agree."""
    out, expect = out.float().cpu(), expect.float().cpu()
    err = (out - expect).abs().max().item()
    scale = expect.abs().max().item()
    ok = bool(((out - expect).abs()
               <= BF16_TOL * scale + BF16_TOL * expect.abs()).all())
    log(f"  {name}: max_abs_err {err:.3e} (max |ref| {scale:.3e}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if strict and not ok:
        raise AssertionError(f"{name}: card and CPU disagree ({err})")
    return ok


def _flash_masks_of(cfg):
    """The flash kernel's launches in one prefill of ``cfg``, by mask: one
    a causal self-attention layer (the hybrid family: one shared block a
    superblock), and the encdec family's encoder layers without the causal
    mask."""
    if cfg.family == "hybrid":
        return {"causal": cfg.n_layers // cfg.hybrid_attn_every,
                "non-causal": 0}
    enc = cfg.encoder.n_layers if cfg.family == "encdec" else 0
    return {"causal": cfg.n_layers, "non-causal": enc}


def _attn_layers(cfg):
    """The layers whose prefill attention runs the flash kernel."""
    return sum(_flash_masks_of(cfg).values())


@contextlib.contextmanager
def _flash_masks():
    """Counts, by mask, the calls in the block of ``ops.flash_attention``
    on CUDA tensors that returned, each of which launched the kernel once
    (the wrapper's own ``launches`` counts them all): {"causal": n,
    "non-causal": n}."""
    counts = {"causal": 0, "non-causal": 0}
    flash = ops.flash_attention

    def counted(q, k, v, *, causal=True, window=0):
        out = flash(q, k, v, causal=causal, window=window)
        if q.is_cuda:
            counts["causal" if causal else "non-causal"] += 1
        return out
    ops.flash_attention = counted
    try:
        yield counts
    finally:
        ops.flash_attention = flash


def _serve_of(arch):
    """The serving traffic of ``arch``: ``SERVE``, whisper's at its
    prompt of 224 (``SERVE_OF``)."""
    return SERVE_OF.get(arch, SERVE)


def _stub_inputs(cfg, B, seed):
    """Random float32 embeddings from ``seed`` for the stub frontends
    beside a prompt, on the CPU: whisper's ``frames``, InternVL2's
    ``patches``; none for the other families."""
    gen = torch.Generator().manual_seed(seed)
    n = {"encdec": ("frames", cfg.encoder.n_ctx if cfg.encoder else 0),
         "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if n is None:
        return {}
    return {n[0]: torch.randn(B, n[1], cfg.d_model, generator=gen)}


def _cut(arch, n_layers):
    """``arch``'s full config cut to ``n_layers`` (the encdec family's
    encoder too)."""
    cfg = get_config(arch)
    enc = cfg.encoder and dataclasses.replace(cfg.encoder, n_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers, encoder=enc)


def check_model_against_cpu(arch="gemma3_1b", n_layers=6, prompts=(2, 600)):
    """``arch`` cut to ``n_layers`` at full width, ``prompts`` (count,
    tokens): prefill logits and every cache plus 2 teacher-forced decode
    steps on the card (through the kernel, once an attention layer, in the
    variant the rule names) against the CPU (plain path).  gemma3_1b: 6
    layers (5 local, 1 global), prompt 600 (> window 512).

    The hybrid family (zamba2_2_7b: 12 layers, prompt 512) is checked in
    two parts, as the moe family is (``check_moe_against_cpu``).  Its
    caches after 12 layers of each device's own hidden states differ by
    bf16 rounding that grows with depth, from 0.4% of the largest value at
    layer 0 to some 2% at layer 11 on the card with the kernel and with
    the plain attention alike, past ``BF16_TOL`` at a few of millions of
    elements; so the logits are asserted, the caches logged layer by
    layer, and ``check_hybrid_blocks`` asserts every block's output and
    cache entries fed the card's own input at ``BF16_TOL``.

    The encdec family (whisper_small: 2 encoder + 2 decoder layers,
    prompt 224) takes random frames and the vlm family (internvl2_26b: 2
    layers, prompt 128) random patches ahead of the prompt, its decode
    steps at the positions after them; the flash launches are counted by
    mask too (``_flash_masks``: whisper's encoder non-causal)."""
    cfg = _cut(arch, n_layers)
    cpu = T.init_params(cfg, seed=1, device="cpu")
    gpu = to_device(cpu, "cuda")
    B, S = prompts
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    stub = _stub_inputs(cfg, B, 2)
    start = prompt_positions(cfg, S)
    log(f"model check: {cfg.name} cut to {cfg.n_layers} layers"
        + (f" (+ {cfg.encoder.n_layers} encoder layers)" if cfg.encoder
           else "")
        + f" at d_model {cfg.d_model}, head dim {cfg.resolved_head_dim}, "
        f"tokens {tuple(tokens.shape)}"
        + "".join(f", random {k} {tuple(t.shape)}" for k, t in stub.items())
        + ", card vs CPU")
    name = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    before = fa.flash_attention.launches_by_variant[name]
    out, toks = {}, []
    with _flash_masks() as masks:
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            batch = {"tokens": tokens.to(dev),
                     **{k: t.to(dev) for k, t in stub.items()}}
            logits, cache = T.prefill_forward(cfg, params, batch,
                                              max_seq=start + 2)
            steps = [logits]
            for i in range(2):   # both sides take the CPU's greedy tokens
                if dev == "cpu":
                    toks.append(torch.argmax(logits[:, -1], -1,
                                             keepdim=True))
                logits, cache = T.decode_forward(cfg, params, cache,
                                                 toks[i].to(dev), start + i)
                steps.append(logits)
            out[dev] = steps + [cache]
    ran = fa.flash_attention.launches_by_variant[name] - before
    log(f"  flash launches on the card: {ran} of {name} at D "
        f"{cfg.resolved_head_dim}, by mask {masks} (expected "
        f"{_flash_masks_of(cfg)})")
    if ran != _attn_layers(cfg) or masks != _flash_masks_of(cfg):
        raise AssertionError("model check did not go through the kernel")
    for i in range(3):
        _bf16_close(f"logits step {i}", out["cuda"][i], out["cpu"][i])
    hybrid = cfg.family == "hybrid"
    if hybrid:
        log("  caches, each device on its own hidden states (logged, not "
            "asserted; by layer: max_abs_err / max |ref|):")
    for key in sorted(out["cpu"][3]):
        card, cpu_c = out["cuda"][3][key].cpu().float(), \
            out["cpu"][3][key].float()
        _bf16_close(f"cache {key}", card, cpu_c, strict=not hybrid)
        if hybrid:
            log(f"    {key}: " + ", ".join(
                f"{(a - b).abs().max().item() / b.abs().max().item():.4f}"
                for a, b in zip(card, cpu_c)))
    if hybrid:
        check_hybrid_blocks(cfg, cpu, gpu, tokens)


def check_hybrid_blocks(cfg, cpu, gpu, tokens):
    """The hybrid family's prefill block by block: each Mamba2 block and
    each superblock's shared attention + MLP block run on the card on the
    card's hidden state, and on the CPU (plain path) on the same hidden
    state, copied: the block's output and its cache entries (``conv`` and
    ``ssm``; ``k`` and ``v``) at ``BF16_TOL``.  A fault of the port or of
    the kernel shows here, where only one block's rounding separates the
    two; the flash kernel runs once a superblock."""
    S = tokens.shape[1]
    x = T._embed_tokens(cfg, gpu, tokens.cuda())
    rope = T._rope_for(cfg, torch.arange(S))
    k = cfg.hybrid_attn_every
    name = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    before = fa.flash_attention.launches_by_variant[name]
    log(f"  blocks fed the card's hidden state, card vs CPU ({cfg.n_layers} "
        f"Mamba2 blocks, {_attn_layers(cfg)} shared blocks):")

    def run(dev, block):
        p = cpu if dev == "cpu" else gpu
        cos, sin = (t.to(dev) for t in rope)
        h = x.to(dev)
        if block == "shared":
            return T._shared_block(
                cfg, p["shared_attn"], h,
                lambda pa, hh: attn_mod.gqa_forward(pa, hh, cos, sin, cfg=cfg,
                                                    causal=True))
        states = []
        return T._mamba_blocks(cfg, [p["layers"][block]], h, states), \
            states[0]

    for sb in range(_attn_layers(cfg)):
        for block in list(range(sb * k, (sb + 1) * k)) + ["shared"]:
            out = {dev: run(dev, block) for dev in ("cpu", "cuda")}
            label = f"block {block}" if block != "shared" \
                else f"shared block {sb}"
            _bf16_close(f"{label} out", out["cuda"][0], out["cpu"][0])
            st = {dev: (o[1] if block != "shared" else dict(zip("kv", o[1])))
                  for dev, o in out.items()}
            for key in sorted(st["cpu"]):
                _bf16_close(f"{label} {key}", st["cuda"][key], st["cpu"][key])
            x = out["cuda"][0]
    ran = fa.flash_attention.launches_by_variant[name] - before
    log(f"  flash launches on the card, blocks: {ran} of {name} (expected "
        f"{_attn_layers(cfg)})")
    if ran != _attn_layers(cfg):
        raise AssertionError("block check did not go through the kernel")


def _flash_head_dim(cfg):
    """The head dim of ``cfg``'s prefill attention on the flash kernel:
    MLA's q/k width (v is padded to it), else the model's head dim."""
    m = cfg.mla
    return (m.qk_nope_dim + m.qk_rope_dim if m is not None
            else cfg.resolved_head_dim)


def serve_full(arch="gemma3_1b"):
    """``arch`` at full width and depth through ``serve``, params from a
    seed made on the card; the flash counts are set to 0 just before and
    read just after: one launch an attention layer (``_attn_layers``) a
    prefill batch, all of the variant the rule names at its head dim.
    Returns the config, the params, the
    launches, the launches by variant and ``_log_serving``'s measured
    times."""
    cfg = get_config(arch)
    moe = "" if cfg.moe is None else (
        f", MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
        f"{cfg.moe.n_shared} shared ({cfg.active_param_count() / 1e9:.3f} B "
        f"active)")
    hybrid = "" if cfg.family != "hybrid" else (
        f" (Mamba2: {cfg.ssm.n_heads} SSM heads of head dim "
        f"{cfg.ssm.head_dim}, state {cfg.ssm.d_state}, chunk "
        f"{cfg.ssm.chunk}; one shared attention + MLP block after every "
        f"{cfg.hybrid_attn_every})")
    if cfg.family == "encdec":
        hybrid = (f" (+ {cfg.encoder.n_layers} encoder layers, non-causal "
                  f"over {cfg.encoder.n_ctx} frames; cross-attention in "
                  f"plain torch)")
    if cfg.family == "vlm":
        hybrid = f" ({cfg.n_patches} patches ahead of each prompt)"
    kw = _serve_of(arch)
    log(f"card memory allocated before: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    log(f"serve: {cfg.name} full width, {cfg.n_layers} layers{hybrid}, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} of "
        f"head dim {_flash_head_dim(cfg)} in flash, vocab {cfg.vocab}, "
        f"{cfg.param_count() / 1e9:.3f} B params{moe}; {kw}")
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    with _flash_masks() as masks:
        stats = serve(cfg, device="cuda", seed=0, params=params, log=log,
                      **kw)
    launches = fa.flash_attention.launches
    by_variant = dict(fa.flash_attention.launches_by_variant)
    expect = _attn_layers(cfg) * stats["batches"]
    expect_masks = {k: n * stats["batches"]
                    for k, n in _flash_masks_of(cfg).items()}
    name = fa.variant(_flash_head_dim(cfg), torch.bfloat16)
    log(f"flash_attention launches in serving: {launches}, by variant "
        f"{by_variant}, by mask {masks} (expected {_attn_layers(cfg)} "
        f"attention layers x {stats['batches']} prefill batches = {expect}, "
        f"all {name}; by mask {expect_masks})")
    if launches != expect or by_variant[name] != expect \
            or masks != expect_masks:
        raise AssertionError(f"{by_variant} flash launches by mask {masks}, "
                             f"expected {expect} of {name}")
    measured = _log_serving(stats, kw)
    return cfg, params, launches, by_variant, measured


def _log_serving(stats, kw=SERVE):
    """Checks a ``serve`` call of ``kw`` (every request served, every
    logit finite) and logs its prefill ms a batch, decode ms a step, tok/s
    and peak device memory; returns the prefill ms of each batch, the
    decode ms of each token step and the tok/s."""
    if not stats["finite"]:
        raise AssertionError("non-finite logits")
    if stats["requests"] != kw["requests"]:
        raise AssertionError(f"served {stats['requests']} requests")
    per_tok = [1e3 * s / stats["decode_steps"] for s in stats["decode_s"]]
    tokens = stats["requests"] * kw["max_new"]
    log(f"prefill ms per batch: "
        f"{[round(1e3 * s, 3) for s in stats['prefill_s']]}")
    log(f"decode ms per token step (batch {kw['batch']}): "
        f"{[round(t, 3) for t in per_tok]}")
    log(f"aggregate {tokens / stats['seconds']:.1f} tok/s "
        f"({tokens} tokens in {stats['seconds']:.3f} s)")
    log(f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return {"prefill_ms": [1e3 * s for s in stats["prefill_s"]],
            "decode_ms": per_tok, "tok_s": tokens / stats["seconds"]}


def cuda_ms(fn, iters, hold=True):
    """Device ms a call: CUDA events around ``iters`` back-to-back calls,
    after 3 warm-ups.  With ``hold``, the start event waits behind a
    device-side sleep that outlasts the calls' enqueue (checked: the sleep
    must still be running when the last call is queued, else it is doubled
    and the run taken again), so the card runs them back to back whatever
    the host's time.  The plain versions are timed without: their thousands
    of small launches would fill the launch queue behind the sleep."""
    for _ in range(3):
        fn()
    cycles = 2_000_000
    while True:
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if hold:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time or not hold:
            return start.elapsed_time(end) / iters
        if cycles > 1 << 34:
            raise RuntimeError("the calls' enqueue outlasted a 2^34-cycle "
                               "device-side sleep")
        cycles *= 2


def host_us(fn, calls=100):
    """Host us a call: ``perf_counter`` over ``calls`` enqueues (argument
    checks, allocation, tensor maps, the launch), the card left to run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def _live_pairs(S, causal, window):
    """The (q, k) pairs of one head that the masks leave live: causal
    ``qpos >= kpos``, and ``qpos - kpos < window`` for ``window > 0``."""
    if causal:
        return sum(min(i + 1, window) if window else i + 1 for i in range(S))
    return sum(S - max(0, i - window + 1) if window else S for i in range(S))


def bound(B, H, Hkv, S, D, window, dtype, variant, causal=True):
    """Least time (ms) for the work these inputs need, the largest of three
    terms: live (q, k) pairs times 4 D operations at the variant's peak
    (bf16 on the tensor cores; float32 ``tf32x3`` as 3 passes of TF32 on
    the tensor cores, like ``matmul_bound``; float32 ``fma`` on the CUDA
    cores); one exponential a live pair at the special-function units'
    rate, as ``scan_bound`` counts them (it decides bf16 at D <= 32); q, k,
    v read once and o written once at the HBM rate.  Returns (ms, the term
    that sets it, {term: seconds}, operations, bytes)."""
    itemsize = torch.finfo(dtype).bits // 8
    live = B * H * _live_pairs(S, causal, window)
    flops = 4 * D * live
    if variant == "tf32x3":
        flops, peak = 3 * flops, hw.PEAK_FLOPS_TF32
    else:
        peak = hw.PEAK_FLOPS if dtype == torch.float32 \
            else hw.PEAK_FLOPS_BF16
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize
    terms = {"operations": flops / peak, "exp": live / hw.EXP_RATE,
             "bytes": nbytes / hw.HBM_BW}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by, terms, flops, nbytes


def _sdpa(q, k, v, window, causal=True):
    """The library yardstick: ``is_causal`` (or none) where there is no
    window, else the masks as an explicit one."""
    if not window:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    pos = torch.arange(q.shape[2], device="cuda")
    mask = (pos[:, None] - pos[None, :]) < window
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def time_flash(B, H, Hkv, S, D, window, dtype, smi, seed=2, v_width=None,
               causal=True):
    """Each variant of ``_variants`` at one shape: {variant: row} with the
    kernel's device ms and host us a call, the plain version's and SDPA's
    ms, and the bound.  With ``v_width``, v is zero past that column, as
    MLA gives it."""
    q, k, v = rand_qkv(B, H, Hkv, S, D, dtype, seed=seed, v_width=v_width)
    lib = _sdpa(q, k, v, window, causal)
    lib_err = (lib().float() - ref.flash_attention_ref(
        q, k, v, causal=causal, window=window).float()).abs().max().item()
    plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                    window=window),
                    10, hold=False)
    lib_ms = cuda_ms(lib, 20)
    rows = {}
    for name in _variants(fa, dtype, D):
        def call():
            return fa.flash_attention(q, k, v, causal=causal, window=window,
                                      kernel=name)
        ms = cuda_ms(call, 20)
        b_ms, b_by, terms, flops, nbytes = bound(B, H, Hkv, S, D, window,
                                                 dtype, name, causal)
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                          bound_ms=b_ms, host_us=host_us(call),
                          bound_by="bytes" if b_by == "bytes"
                          else "operations", bound_term=b_by, causal=causal)
        log(f"flash_attention {name} B={B} H={H} Hkv={Hkv} S={S} D={D} "
            f"{dtype} window={window}"
            + ("" if causal else " non-causal")
            + (f" v zero past {v_width}" if v_width else "")
            + f": kernel {ms:.4f} ms (host "
            f"{rows[name]['host_us']:.1f} us a call), plain {plain:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms (max_abs_err vs plain {lib_err:.2e}), "
            f"bound {b_ms:.4f} ms by {b_by} (ops "
            f"{1e3 * terms['operations']:.4f}, exp {1e3 * terms['exp']:.4f}, "
            f"bytes {1e3 * terms['bytes']:.4f} ms; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB), kernel {flops / ms / 1e9:.2f} TFLOP/s "
            f"= {100 * b_ms / ms:.2f}% of bound; card {smi}")
    return rows


def time_kernel(cfg, smi):
    """The serving shapes (bf16) by window: {window: {variant: row}}."""
    B, H, Hkv, S, D = SERVE["batch"], cfg.n_heads, cfg.n_kv_heads, \
        SERVE["prompt_len"], cfg.resolved_head_dim
    return {window: time_flash(B, H, Hkv, S, D, window, torch.bfloat16, smi)
            for window in (cfg.window, 0)}


def time_flash_small(smi):
    """The head dims 16, 32 and 96 (``SMALL_D``): both types at
    phi3_mini_3_8b's prefill shape at each, and float32 at the ``full``
    calibration grid's attention shapes of those head dims (what the
    calibration loop runs there); then head dim 192 at
    deepseek_v2_lite_16b's prefill shape in both types, v zero past column
    128 as MLA gives it, and granite_moe_1b_a400m's prefill (head dim 64,
    GQA 16 / 8) in bf16, what it serves; causal, no window: {(shape,
    type): {variant: row}}."""
    full = [s for s in calibrate.GRIDS["full"]["attention"]
            if s[-1] in SMALL_D]
    cases = [(shape, dtype) for shape in PHI3_PREFILL
             for dtype in (torch.bfloat16, torch.float32)] \
        + [(shape, torch.float32) for shape in full]
    rows = {(shape, dtype): time_flash(*shape, 0, dtype, smi)
            for shape, dtype in cases}
    for dtype in (torch.bfloat16, torch.float32):
        rows[(DEEPSEEK_PREFILL, dtype)] = time_flash(
            *DEEPSEEK_PREFILL, 0, dtype, smi, v_width=MLA_V)
    rows[(GRANITE_PREFILL, torch.bfloat16)] = time_flash(
        *GRANITE_PREFILL, 0, torch.bfloat16, smi)
    return rows


def time_flash_zamba(smi):
    """Phase 35: zamba2_2_7b's prefill shape (head dim 80, causal, no
    window) in bf16 and float32, each in the variant its rule names (the
    older ones are not built at 80): {(shape, type): {variant: row}}."""
    return {(ZAMBA_PREFILL, dtype): time_flash(*ZAMBA_PREFILL, 0, dtype, smi)
            for dtype in (torch.bfloat16, torch.float32)}


def time_flash_encdec_vlm(smi):
    """Phase 40: whisper_small's encoder shape (4, 12, 12, 1500, 64)
    without the causal mask and internvl2_26b's prefill shape (4, 48, 8,
    1280, 128) causal, no window, in bf16 and float32: {(shape, type):
    {variant: row}}."""
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        rows[(WHISPER_ENCODER, dtype)] = time_flash(
            *WHISPER_ENCODER, 0, dtype, smi, causal=False)
        rows[(INTERNVL_PREFILL, dtype)] = time_flash(*INTERNVL_PREFILL, 0,
                                                     dtype, smi)
    return rows


def time_flash_f32(smi):
    """The float32 kernel at the calibration's ``"model"`` attention shapes
    (causal, no window: what the calibration loop runs), ``tf32x3`` (the
    rule's variant there) beside ``fma``: {variant: [row by shape]}."""
    rows = {}
    for shape in calibrate.MODEL_GRIDS["attention"]:
        for name, row in time_flash(*shape, 0, torch.float32, smi).items():
            rows.setdefault(name, []).append(row)
    return rows


# the stages read from the program's spans (repro_torch.core.spans) while
# a model whose blocks hold them is profiled, label -> span.  The MoE
# layer's (models.moe), and the Mamba2 mixer's with its chunked SSD
# (models.ssm)
MOE_RANGES = {"moe layer": "repro_torch.moe.layer",
              "moe routing": "repro_torch.moe.route",
              "moe dispatch indices": "repro_torch.moe.dispatch",
              "moe experts": "repro_torch.moe.experts"}
SSM_RANGES = {"mamba2 mixer": "repro_torch.ssm.mamba2",
              "mamba2 ssd": "repro_torch.ssm.ssd",
              "mamba2 decode": "repro_torch.ssm.mamba2_decode"}
# the encdec family's: its encoder (models.transformer), and its
# cross-attention in plain torch (models.attention): ``chunked_attention``
# in prefill (where nothing else calls it), and the decoder's calls of
# ``gqa_decode`` on the encoder's keys in decode
ENCODER_RANGES = {"encoder": "repro_torch.encoder"}
XATTN_RANGES = {"cross-attention": "repro_torch.attn.chunked",
                "cross-attention decode": "repro_torch.attn.cross_decode"}


def _range_ms(averages, ranges):
    """The device time (ms) under each span of ``ranges`` (label -> span):
    the kernels launched inside it."""
    from torch.autograd import DeviceType
    return {label: sum(e.device_time_total for e in averages
                       if e.key == name
                       and e.device_type == DeviceType.CPU) / 1e3
            for label, name in ranges.items()}


def _log_shares(ms_of, busy_ms, phase):
    for label, t in ms_of.items():
        log(f"  {label}: {t:.3f} ms = {100 * t / busy_ms:.1f}% of the "
            f"{phase}'s device time")


def _log_moe_shares(averages, busy_ms, phase):
    """The device time under each ``MOE_RANGES`` span and its share of
    the phase's device time; dispatch is the MoE layer less routing and the
    experts' products: the one-hot cumsum, the scatter of buffer slots, the
    gather into the buffers and the weighted combine."""
    ms_of = _range_ms(averages, MOE_RANGES)
    if not ms_of["moe layer"]:
        log("  MoE spans: no device time under them (not measured)")
        return
    ms_of["moe dispatch (cumsum, scatter, gather, combine)"] = (
        ms_of["moe layer"] - ms_of["moe routing"] - ms_of["moe experts"])
    _log_shares(ms_of, busy_ms, phase)


def _log_range_shares(averages, busy_ms, phase, ranges, what):
    """The device time under each span of ``ranges`` that ran in the
    phase (Mamba2's mixer and its SSD in prefill, the mixer's step in
    decode; whisper's encoder and cross-attention in prefill, its
    cross-attention in decode) and its share of the phase's device time."""
    ms_of = {k: t for k, t in _range_ms(averages, ranges).items() if t}
    if not ms_of:
        log(f"  {what} spans: no device time under them (not measured)")
        return
    _log_shares(ms_of, busy_ms, phase)


def profile_serving(cfg, params, smi, kernel=None):
    """Device time by kernel over one prefill batch and over 8 decode steps,
    and the device's busy share: summed kernel time over the wall time of
    the profiled region (the profiler's own host cost lengthens the wall
    time, so the share is a lower bound).  With ``kernel``, also the share
    of the device time taken by the kernels whose name holds it; for a MoE
    model, the share of each MoE stage (``_log_moe_shares``; the program's
    spans add host time to the wall time under the profiler, so the busy
    share is lower still).  For a model of Mamba2 blocks, the shares of the
    Mamba2 mixer and its SSD; for whisper, of its encoder and its
    cross-attention (``_log_range_shares``).  The prompts are
    ``_serve_of(cfg.name)``'s, with the stub frontends' inputs of the
    launcher.  Returns the busy share of each phase and its device ms (a
    prefill batch; a decode step), None where not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kw = _serve_of(cfg.name)
    B, S, n = kw["batch"], kw["prompt_len"], 8
    tokens = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    batch, start = prefill_inputs(cfg, tokens), prompt_positions(cfg, S)
    prefill = make_prefill_step(cfg, start + n)
    decode = make_decode_step(cfg)
    busy = {"prefill": None, "decode": None}
    device_ms = dict(busy)
    for phase in ("prefill", "decode"):
        logits, cache = prefill(params, batch)
        tok = greedy(logits)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                prefill(params, batch)
            else:
                for i in range(n):
                    tok, cache, _ = decode(params, cache, tok, start + i)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        # device-side kernels only: a CPU op's device time repeats the
        # time of the kernels it launched, and a span's device-side
        # annotation spans kernels counted already
        averages = prof.key_averages()
        events = [e for e in averages
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not getattr(e, "is_user_annotation", False)
                  and e.key not in spans.NAMES]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        if not events:
            log(f"profile {phase}: no device time in the trace (not measured)")
            continue
        what = "1 batch" if phase == "prefill" else f"{n} steps"
        busy[phase] = busy_ms / wall_ms
        device_ms[phase] = busy_ms if phase == "prefill" else busy_ms / n
        log(f"profile {phase} ({what}, B={B}): wall {wall_ms:.3f} ms, device "
            f"kernels {busy_ms:.3f} ms, busy {100 * busy_ms / wall_ms:.1f}%, "
            f"{sum(e.count for e in events)} device events; card {smi}")
        if kernel:
            k_ms = sum(e.self_device_time_total for e in events
                       if kernel in e.key) / 1e3
            log(f"  {kernel}: {k_ms:.3f} ms = {100 * k_ms / busy_ms:.1f}% of "
                f"the {phase}'s device time")
        if cfg.moe is not None:
            _log_moe_shares(averages, busy_ms, phase)
        elif cfg.ssm is not None and cfg.ssm.version == 2:
            _log_range_shares(averages, busy_ms, phase, SSM_RANGES, "Mamba2")
        elif cfg.family == "encdec":
            _log_range_shares(averages, busy_ms, phase,
                              {**ENCODER_RANGES, **XATTN_RANGES}, "encdec")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                f"x{e.count:<5d} {e.key[:90]}")
    return busy, device_ms


def _rand(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _matmul_inputs(M, N, K, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return _rand((M, K), g, dtype), _rand((K, N), g, dtype)


def _scan_inputs(b, S, d, N, dtype, seed=0):
    """As tests/test_kernels.py makes them: dt = softplus(z), A = -exp(0.3 z),
    D = 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _rand((b, S, d), g, dtype)
    dt = F.softplus(_rand((b, S, d), g)).to(dtype)
    B, C = _rand((b, S, N), g, dtype), _rand((b, S, N), g, dtype)
    A = -torch.exp(0.3 * _rand((d, N), g))
    return x, dt, B, C, A, torch.ones(d, device="cuda")


def check_new_kernels():
    """The matmul and scan kernels against their plain versions on the card,
    the matmul in each variant of ``_variants``.  Returns each kernel's
    largest float32 error over the model grid."""
    model = {"matmul": calibrate.MODEL_GRIDS["matmul"],
             "mamba_scan": calibrate.MODEL_GRIDS["mamba"]}
    worst = {"matmul": 0.0, "mamba_scan": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = MM_TOL[dtype]
        for M, N, K in MM_CASES:
            a, b = _matmul_inputs(M, N, K, dtype)
            expect = ref.matmul_ref(a, b)
            for name in _variants(mm, dtype, M, N, K):
                out = _ran(mm.matmul, name,
                           lambda: mm.matmul(a, b, kernel=name))
                if out.dtype != dtype or out.shape != (M, N):
                    raise AssertionError(f"matmul gave {out.dtype} "
                                         f"{out.shape}")
                err = _check(f"matmul kernel {name} vs plain {(M, N, K)} "
                             f"{dtype}", out, expect, tol, tol * K ** 0.5)
                if dtype == torch.float32 and (M, N, K) in model["matmul"]:
                    worst["matmul"] = max(worst["matmul"], err)
        tol = SCAN_TOL[dtype]
        for shape in SCAN_CASES:
            args = _scan_inputs(*shape, dtype)
            out = ms.mamba_scan(*args)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != args[0].shape:
                raise AssertionError(f"scan gave {out.dtype} {out.shape}")
            err = _check(f"mamba_scan kernel vs plain {shape} {dtype}", out,
                         ref.mamba_scan_ref(*args), tol, 4 * tol)
            if dtype == torch.float32 and shape in model["mamba_scan"]:
                worst["mamba_scan"] = max(worst["mamba_scan"], err)
    return worst


def check_calibration_shapes():
    """All three kernels against their plain versions on the card at every
    shape of the ``"model"`` and ``"full"`` grids, on the calibration's own
    float32 inputs (``calibrate._inputs``), at the float32 tolerances above.
    Returns each kernel's largest error."""
    plain = {"matmul": ref.matmul_ref, "attention": ref.flash_attention_ref,
             "mamba": ref.mamba_scan_ref}
    worst = dict.fromkeys(plain, 0.0)
    for grid in ("model", "full"):
        for kernel in calibrate.KERNELS:
            for shape in calibrate.GRIDS[grid][kernel]:
                args, _, _ = calibrate._inputs(kernel, shape,
                                               torch.device("cuda"))
                out = calibrate._CALLS[kernel](*args)
                torch.cuda.synchronize()
                tol = CAL_TOL[kernel]
                atol = {"matmul": tol * shape[2] ** 0.5, "attention": tol,
                        "mamba": 4 * tol}[kernel]
                worst[kernel] = max(worst[kernel], _check(
                    f"calibration {grid} {kernel} {tuple(shape)} kernel vs "
                    "plain", out, plain[kernel](*args), tol, atol))
    return worst


def matmul_bound(M, N, K, dtype, variant):
    """Least time (ms) of a variant: its operations at their peak (bf16 on
    the tensor cores; float32 ``tf32x3`` as 3 x 2 M N K TF32 operations on
    the tensor cores; float32 ``stream`` and ``fma`` as 2 M N K on the CUDA
    cores) against a and b read once and c written once at the HBM rate."""
    itemsize = torch.finfo(dtype).bits // 8
    if variant == "tf32x3":
        ops = 3 * 2 * M * N * K / hw.PEAK_FLOPS_TF32
    else:
        ops = 2 * M * N * K / (hw.PEAK_FLOPS if dtype == torch.float32
                               else hw.PEAK_FLOPS_BF16)
    terms = {"operations": ops,
             "bytes": itemsize * (M * K + K * N + M * N) / hw.HBM_BW}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by, terms


def scan_bound(b, S, d, N, dtype, states=0):
    """Least time (ms), the largest of three terms: the float32 operations
    (the calibration's accounting, 10 b S d N) at the float32 peak; the
    b S d N exponentials at the special-function units' rate; x, dt, B, C,
    A, D read once, y written once and ``states`` float32 (b, d, N) states
    moved once (1: h_S written; 2: h0 read too) at the HBM rate."""
    itemsize = torch.finfo(dtype).bits // 8
    terms = {"operations": calibrate.mamba_cost(b, S, d, N)[0] / hw.PEAK_FLOPS,
             "exp": b * S * d * N / hw.EXP_RATE,
             "bytes": (itemsize * (3 * b * S * d + 2 * b * S * N)
                       + 4 * (d * N + d) + 4 * states * b * d * N)
             / hw.HBM_BW}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by, terms


def profile_tf32x3(call, shape, smi, calls=10):
    """A ``tf32x3`` call's device time by kernel (the split pass and the
    product) over ``calls`` calls, with ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ms = {e.key: e.self_device_time_total / 1e3 / calls
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    if not ms:
        log(f"matmul tf32x3 {shape} profile: no device time in the trace "
            "(not measured)")
        return
    split = sum(t for k, t in ms.items() if "tf32_split" in k)
    total = sum(ms.values())
    log(f"matmul tf32x3 {shape} profile: split pass {split:.4f} ms, product "
        f"{total - split:.4f} ms a call ({100 * split / total:.1f}% split); "
        f"card {smi}")


def time_new_kernels(smi):
    """Kernel (each variant of ``_variants``), plain and library times (CUDA
    events) and the wrappers' host time a call at the model grid's shapes,
    in float32 and bf16.  Returns the float32 rows (the type the calibration
    loop runs; the matmul's in the variant its rule names) by kernel, and
    the float32 ms by variant and shape of the matmul."""
    rows = {"matmul": [], "mamba_scan": []}
    by_variant = {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, N, K in calibrate.MODEL_GRIDS["matmul"]:
            a, b = _matmul_inputs(M, N, K, dtype, seed=2)
            plain = cuda_ms(lambda: ref.matmul_ref(a, b), 20, hold=False)
            lib = cuda_ms(lambda: torch.matmul(a, b), 20)
            for name in _variants(mm, dtype, M, N, K):
                def call():
                    return mm.matmul(a, b, kernel=name)
                kernel_ms, host = cuda_ms(call, 20), host_us(call)
                b_ms, by, terms = matmul_bound(M, N, K, dtype, name)
                tflops = 2 * M * N * K / kernel_ms / 1e9
                log(f"matmul {name} {(M, N, K)} {dtype}: kernel "
                    f"{kernel_ms:.4f} ms ({tflops:.2f} TFLOP/s; host "
                    f"{host:.1f} us a call), plain {plain:.4f} "
                    f"ms, torch.matmul {lib:.4f} ms, bound {b_ms:.4f} ms by "
                    f"{by} (ops {1e3 * terms['operations']:.4f}, bytes "
                    f"{1e3 * terms['bytes']:.4f} ms) = "
                    f"{100 * b_ms / kernel_ms:.2f}% of bound; card {smi}")
                if dtype != torch.float32:
                    continue
                by_variant.setdefault(name, {})[f"{M}x{N}x{K}"] = kernel_ms
                if name == mm.variant(M, N, K, dtype):
                    rows["matmul"].append(dict(
                        ms=kernel_ms, plain_ms=plain, library_ms=lib,
                        bound_ms=b_ms, bound_by=by, host_us=host))
                if name == "tf32x3":
                    profile_tf32x3(call, (M, N, K), smi)
        for shape in calibrate.MODEL_GRIDS["mamba"]:
            args = _scan_inputs(*shape, dtype, seed=2)
            plain = cuda_ms(lambda: ref.mamba_scan_ref(*args), 2, hold=False)
            b_ms, by, terms = scan_bound(*shape, dtype)

            def call():
                return ms.mamba_scan(*args)
            kernel_ms, host = cuda_ms(call, 20), host_us(call)
            log(f"mamba_scan L=4 {shape} {dtype}: kernel {kernel_ms:.4f} ms "
                f"(host {host:.1f} us a call), plain {plain:.4f} ms, library "
                f"none, bound {b_ms:.4f} ms by {by} (ops "
                f"{1e3 * terms['operations']:.4f}, exp "
                f"{1e3 * terms['exp']:.4f}, bytes "
                f"{1e3 * terms['bytes']:.4f} ms) = "
                f"{100 * b_ms / kernel_ms:.2f}% of bound; card {smi}")
            if dtype == torch.float32:
                rows["mamba_scan"].append(dict(
                    ms=kernel_ms, plain_ms=plain, library_ms=None,
                    bound_ms=b_ms, host_us=host,
                    bound_by="bytes" if by == "bytes" else "operations"))
    return rows, by_variant


def _loops(lines):
    """SASS lines of one function (``cuobjdump -sass``, branch targets as
    addresses) -> [(address, instruction)] and its loops, as the (first,
    last) addresses of each backward branch's range."""
    ins, loops = [], []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        ins.append((addr, m.group(2)))
        target = re.search(r"\bBRA\s+0x([0-9a-f]+)", m.group(2))
        if target and int(target.group(1), 16) <= addr:
            loops.append((int(target.group(1), 16), addr))
    return ins, loops


def scan_sass(lib, kernel):
    """SASS instructions per (thread, timestep) of the scan's loop over
    time, from ``cuobjdump -sass`` of the library ``lib``: in the function
    whose name holds ``kernel``, the innermost loop with the most
    exponentials (MUFU.EX2, which expf also ends in), its instructions over
    its timesteps (its exponentials over the N / 4 states a thread holds,
    N read from the name's template arguments).  Returns (instructions per
    step, instructions, timesteps)."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs = out.split("Function : ")[1:]
    body = [f for f in funcs if kernel in f.splitlines()[0]]
    if len(body) != 1:
        raise AssertionError(f"{len(body)} SASS functions match {kernel}")
    states = int(re.search(r"Li(\d+)E", body[0].splitlines()[0])[1]) // 4
    ins, loops = _loops(body[0].splitlines())

    def ex2(lo, hi):
        return sum("MUFU.EX2" in t for a, t in ins if lo <= a <= hi)

    live = [(lo, hi) for lo, hi in loops if ex2(lo, hi)]
    inner = [(lo, hi) for lo, hi in live
             if not any((a, b) != (lo, hi) and lo <= a and b <= hi
                        for a, b in live)]
    lo, hi = max(inner, key=lambda r: ex2(*r))
    n = sum(lo <= a <= hi for a, _ in ins)
    steps = ex2(lo, hi) / states
    return n / steps, n, steps


def run_calibration():
    """The calibration loop on the card, the path that runs the matmul and
    scan kernels: every count is set to 0 just before it and read just
    after.  Returns the launches by kernel and by variant, and the records
    by grid (phase 22 prices the nets from the ``model`` grid's)."""
    wrappers = {"matmul": mm.matmul, "flash_attention": fa.flash_attention,
                "mamba_scan": ms.mamba_scan}
    mm.reset_counts()
    fa.reset_counts()
    ms.mamba_scan.launches = 0
    records_by_grid = {}
    for grid, repeat in CALIBRATION:
        t0 = time.perf_counter()
        records, meta = calibrate.measure(grid=grid, repeat=repeat)
        records_by_grid[grid] = records
        report = calibrate.build_report(records, meta)
        log(f"calibration grid {grid} repeat {repeat} on {meta['device']} "
            f"(backend {meta['backend']}, interpret {meta['interpret']}): "
            f"{len(records)} samples in {time.perf_counter() - t0:.1f} s")
        if meta["backend"] != "cuda" or meta["interpret"]:
            raise AssertionError(f"calibration ran no kernel: {meta}")
        for r in records:
            log(f"  {r['kernel']} {tuple(r['shape'])}: "
                f"{1e3 * r['measured_s']:.4f} ms, {r['flops'] / 1e9:.4f} "
                f"GFLOP, {r['bytes'] / 1e6:.4f} MB")
        for kernel, fit in report["kernels"].items():
            f = fit["fitted"]
            log(f"  fit {grid} {kernel}: roofline_mape "
                f"{fit['roofline_mape']:.4g}, fitted_mape "
                f"{fit['fitted_mape']:.4g}, peak_flops_eff "
                f"{f['peak_flops_eff']}, bw_eff {f['bw_eff']}, overhead_s "
                f"{f['overhead_s']}, table_max_rel_err "
                f"{fit['table_max_rel_err']}")
            if fit["table_max_rel_err"] != 0.0:
                raise AssertionError(f"{kernel} table does not reproduce "
                                     "its samples")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {name: sum((1 + repeat) * len(calibrate.GRIDS[grid][kernel])
                        for grid, repeat in CALIBRATION)
              for name, kernel in (("matmul", "matmul"),
                                   ("flash_attention", "attention"),
                                   ("mamba_scan", "mamba"))}
    log(f"kernel launches in the calibration loop: {launches} (expected "
        f"{expect}: one warm-up and {CALIBRATION[0][1]} timed calls per "
        "shape)")
    if launches != expect:
        raise AssertionError(f"calibration launches {launches} != {expect}")
    by_variant = {
        "matmul": dict(mm.matmul.launches_by_variant),
        "flash_attention": dict(fa.flash_attention.launches_by_variant),
        "mamba_scan": {"cuda": launches["mamba_scan"]}}
    log(f"by variant: {by_variant}")
    # float32: each kernel in the variants its rule names (the matmul:
    # stream for M <= 16, tf32x3 above; flash: tf32x3 at head dims 64, 128
    # and 256, fma at the others)
    rules = {"matmul": ("matmul", lambda shape: mm.variant(
                 *shape, torch.float32)),
             "flash_attention": ("attention", lambda shape: fa.variant(
                 shape[-1], torch.float32))}
    for wrapper, (kernel, rule_of) in rules.items():
        rule = {}
        for grid, repeat in CALIBRATION:
            for shape in calibrate.GRIDS[grid][kernel]:
                name = rule_of(shape)
                rule[name] = rule.get(name, 0) + 1 + repeat
        ran = {k: n for k, n in by_variant[wrapper].items() if n}
        if ran != rule or sum(rule.values()) != launches[wrapper]:
            raise AssertionError(f"{wrapper} ran {ran} in float32, its rule "
                                 f"names {rule}")
    return launches, by_variant, records_by_grid


def _products(g):
    """The graph's convolution and matmul nodes: the products the matmul
    kernel runs."""
    return [g.nodes[k] for k in g.order
            if g.nodes[k].op in ("convolution", "matmul")]


def _path_launches(run):
    """``run()`` with the matmul's counts set to 0 just before it; returns
    its result and its launches by variant, read just after."""
    mm.reset_counts()
    out = run()
    torch.cuda.synchronize()
    return out, {k: n for k, n in mm.matmul.launches_by_variant.items() if n}


def check_graphs():
    """Each Table-III net at each batch of ``GRAPH_BATCHES`` on the card and
    on the CPU with the same params and input.  Returns the graphs by (net,
    batch), the matmul's launches by variant summed over the nets by batch,
    and the largest error of a conv or FC node."""
    graphs, by_batch, worst = {}, {}, 0.0
    for net in PAPER_NETS.values():
        for batch in GRAPH_BATCHES:
            g = graphs[net.name, batch] = build_paper_graph(net, batch)
            feeds = {"input": np.random.default_rng(batch).standard_normal(
                (batch, *net.input_shape)).astype(np.float32)}
            card, ran = _path_launches(lambda: g.values(feeds, device="cuda"))
            expect = GRAPH_LAUNCHES[net.name][batch]
            log(f"graph {net.name} batch {batch}: matmul launches {ran} "
                f"(rule: {expect})")
            if ran != expect:
                raise AssertionError(f"{net.name} batch {batch} ran {ran}, "
                                     f"the rule names {expect}")
            for k, n in ran.items():
                by_batch.setdefault(batch, {}).setdefault(k, 0)
                by_batch[batch][k] += n
            plan = g.fusion_plan()
            for n in _products(g):
                node = graph_ops.run_node(
                    g, n, {i: card[i].cpu() for i in n.inputs}, plan)
                w = card[n.inputs[1]]
                K, N = w.numel() // w.shape[-1], w.shape[-1]
                M = node.numel() // N
                worst = max(worst, _check(
                    f"graph {net.name} batch {batch} {n.name} {(M, N, K)} "
                    f"{mm.variant(M, N, K, torch.float32)} vs plain on the "
                    f"card's inputs", card[n.name].cpu(), node, MM_TOL[
                        torch.float32], MM_TOL[torch.float32] * K ** 0.5))
            cpu = g.values(feeds, device="cpu")
            for o in g.outputs:
                scale = cpu[o].abs().max().item()
                err = _check(f"graph {net.name} batch {batch} {o} card vs "
                             "CPU", card[o].cpu(), cpu[o], GRAPH_TOL,
                             GRAPH_TOL * scale)
                log(f"  {o}: max_abs_err / max|CPU| = {err / scale:.3e}")
    return graphs, by_batch, worst


def _is_matmul_kernel(key):
    """Whether a profiled kernel is one of ``csrc/nvdla_matmul.cu``'s."""
    return any(name in key for name in ("matmul_", "tf32_split_kernel",
                                        "splitk_sum_kernel"))


def profile_graph(forward, wall_ms, smi, runs=5, what="forward"):
    """Device time of a forward (or another call, ``what``) by kernel over
    ``runs`` calls: the matmul kernels' share against the rest (im2col
    copies, pads, activations, pools, norms), and the device's busy share
    of the median wall time measured without the profiler (and of the
    profiled wall time, which the profiler's host cost lengthens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            forward()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / runs
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        log("  profile: no device time in the trace (not measured)")
        return None
    total = sum(e.self_device_time_total for e in events) / 1e3 / runs
    mm_ms = sum(e.self_device_time_total for e in events
                if _is_matmul_kernel(e.key)) / 1e3 / runs
    log(f"  profile ({runs} x {what}): device {total:.4f} ms a "
        f"{what} = matmul kernels {mm_ms:.4f} ({100 * mm_ms / total:.1f}%) "
        f"+ other {total - mm_ms:.4f}; busy {100 * total / wall_ms:.1f}% of "
        f"the {wall_ms:.4f} ms wall ({100 * total / prof_ms:.1f}% of the "
        f"profiled {prof_ms:.4f} ms); card {smi}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3 / runs:9.4f} ms "
            f"x{e.count // runs:<4d} {e.key[:90]}")
    return {"device_ms": total, "matmul_ms": mm_ms}


def time_graphs(graphs, smi):
    """Per net and batch: the forward's median wall ms over ``GRAPH_RUNS``
    synchronized runs after 3 warm-ups, images/s, the matmul kernel's
    device ms summed over the forward's products (each timed alone on the
    forward's own operands) beside their summed bound and ``torch.matmul``
    on the same operands, and the profiled breakdown.  Returns, by (net,
    batch), the median wall ms and the profile's device and matmul ms a
    forward (None where the trace held no device time)."""
    measured = {}
    for (net, batch), g in graphs.items():
        gen = torch.Generator(device="cuda").manual_seed(batch)
        feeds = {"input": torch.randn(batch, *PAPER_NETS[net].input_shape,
                                      generator=gen, device="cuda")}

        def forward():
            return g.execute(feeds, device="cuda")
        for _ in range(3):
            forward()
        walls = []
        for _ in range(GRAPH_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall = statistics.median(walls)
        vals = g.values(feeds, device="cuda")
        kernel_ms = library_ms = bound_ms = 0.0
        for n in _products(g):
            a, b, _ = graph_ops.matmul_operands(n, vals)
            (M, K), N = a.shape, b.shape[1]
            name = mm.variant(M, N, K, torch.float32)
            k_ms = cuda_ms(lambda: mm.matmul(a, b), 20)
            l_ms = cuda_ms(lambda: torch.matmul(a, b), 20)
            b_ms = matmul_bound(M, N, K, torch.float32, name)[0]
            log(f"  {net} batch {batch} {n.name} {(M, N, K)} {name}: kernel "
                f"{k_ms:.4f} ms, torch.matmul {l_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({100 * b_ms / k_ms:.1f}%)")
            kernel_ms, library_ms, bound_ms = (kernel_ms + k_ms,
                                               library_ms + l_ms,
                                               bound_ms + b_ms)
        log(f"graph {net} batch {batch}: forward {wall:.4f} ms median of "
            f"{GRAPH_RUNS} (min {min(walls):.4f}, max {max(walls):.4f}), "
            f"{1e3 * batch / wall:.1f} images/s; its {len(_products(g))} "
            f"products: matmul kernel {kernel_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / kernel_ms:.1f}%), "
            f"torch.matmul {library_ms:.4f} ms; card {smi}")
        prof = profile_graph(forward, wall, smi) or {}
        measured[net, batch] = {"wall_ms": wall,
                                "device_ms": prof.get("device_ms"),
                                "matmul_ms": prof.get("matmul_ms")}
    return measured


def check_camera(smi):
    """One 720x1280 frame (ISP, then CNN10 at batch 1) on the card against
    the CPU, with the matmul's launches counted; then the median of
    ``GRAPH_RUNS`` frames against the budget.  Returns the launches and the
    median ISP, CNN10 and frame ms."""
    g = build_paper_graph(PAPER_NETS["cnn10"], 1)
    raw = camera.raw_frame(0)
    camera.run_frame(raw, g, "cuda")        # warm-up
    out, ran = _path_launches(lambda: camera.run_frame(raw, g, "cuda"))
    log(f"camera frame {camera.FRAME_HW}: matmul launches {ran} (CNN10 at "
        f"batch 1: {GRAPH_LAUNCHES['cnn10'][1]})")
    if ran != GRAPH_LAUNCHES["cnn10"][1]:
        raise AssertionError(f"camera frame ran {ran}")
    cpu = camera.run_frame(raw, g, "cpu")
    for key in ("rgb", "dnn_in"):
        _check(f"camera {key} card vs CPU", out[key].cpu(), cpu[key], 0.0,
               ISP_TOL)
    _check("camera CNN10 logits card vs CPU", out["logits"].cpu(),
           cpu["logits"], GRAPH_TOL,
           GRAPH_TOL * cpu["logits"].abs().max().item())
    if out["cls"] != cpu["cls"]:
        raise AssertionError(f"class {out['cls']} on the card, {cpu['cls']} "
                             "on the CPU")
    frames = [camera.run_frame(raw, g, "cuda") for _ in range(GRAPH_RUNS)]
    med = {k: statistics.median(f[k] for f in frames)
           for k in ("isp_ms", "cnn_ms", "frame_ms")}
    log(f"camera frame on the card, median of {GRAPH_RUNS}: ISP "
        f"{med['isp_ms']:.4f} ms, CNN10 {med['cnn_ms']:.4f} ms, frame "
        f"{med['frame_ms']:.4f} ms against {camera.BUDGET_MS:g} ms: "
        f"{'MEETS' if med['frame_ms'] < camera.BUDGET_MS else 'MISSES'}; "
        f"class {out['cls']}; CPU frame {cpu['frame_ms']:.3f} ms; card {smi}")
    return ran, med


def _scan_serve_shape(cfg):
    """(b, S, d_inner, N) of one falcon_mamba_7b prefill batch in ``SERVE``."""
    return (SERVE["batch"], SERVE["prompt_len"],
            cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state)


def check_scan_state(serve_shape):
    """The scan with its state, float32, kernel against plain on the card:
    y and h_S from zeros and from a random h0 at every ``SCAN_CASES`` shape
    and at ``serve_shape``; then the prompt split in two at S / 2 + 3 (off
    the 32-step chunk), the kernel on the first part and on the rest from
    its h_S, against one call over the whole.  Returns the largest error."""
    tol, worst = SCAN_TOL[torch.float32], 0.0
    for shape in SCAN_CASES + [serve_shape]:
        b, S, d, N = shape
        args = _scan_inputs(*shape, torch.float32, seed=4)
        h0 = torch.randn(b, d, N, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(5))
        for start, h in (("zeros", None), ("h0", h0)):
            y, hT = ms.mamba_scan(*args, h0=h, return_state=True)
            ey, ehT = ref.mamba_scan_ref(*args, h0=h, return_state=True)
            for what, out, expect in (("y", y, ey), ("h_S", hT, ehT)):
                worst = max(worst, _check(
                    f"mamba_scan from {start} {shape} {what} kernel vs plain",
                    out, expect, tol, 4 * tol))
        x, dt, B, C, A, D = args
        cut = S // 2 + 3
        y1, h1 = ms.mamba_scan(x[:, :cut], dt[:, :cut], B[:, :cut],
                               C[:, :cut], A, D, h0=h0, return_state=True)
        y2, h2 = ms.mamba_scan(x[:, cut:], dt[:, cut:], B[:, cut:],
                               C[:, cut:], A, D, h0=h1, return_state=True)
        y12 = torch.cat([y1, y2], 1)
        for what, out, expect in (("y", y12, y), ("h_S", h2, hT)):
            _check(f"mamba_scan {shape} split at {cut} {what} vs one call "
                   f"(bit-equal: {torch.equal(out, expect)})", out, expect,
                   tol, 4 * tol)
    return worst


def check_falcon_against_cpu():
    """falcon_mamba_7b cut to ``FALCON_CUT`` layers at full width, params
    from a seed made on the card and copied to the CPU: prefill logits, the
    ``conv`` and ``ssm`` caches and 2 decode steps fed the CPU's greedy
    tokens, on the card (the scan kernel) against the CPU (plain path)."""
    cfg = dataclasses.replace(get_config("falcon_mamba_7b"),
                              n_layers=FALCON_CUT)
    gpu = T.init_params(cfg, seed=1, device="cuda")
    cpu = to_device(gpu, "cpu")
    B, S = FALCON_PROMPTS
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    log(f"falcon check: {cfg.name} cut to {cfg.n_layers} layers at d_model "
        f"{cfg.d_model}, tokens {tuple(tokens.shape)}, card vs CPU")
    before = ms.mamba_scan.launches
    out, toks = {}, []
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        logits, cache = T.prefill_forward(cfg, params,
                                          {"tokens": tokens.to(dev)},
                                          max_seq=S + 2)
        steps = [logits]
        for i in range(2):   # both sides take the CPU's greedy tokens
            if dev == "cpu":
                toks.append(torch.argmax(logits[:, -1], -1, keepdim=True))
            logits, cache = T.decode_forward(cfg, params, cache,
                                             toks[i].to(dev), S + i)
            steps.append(logits)
        out[dev] = steps + [cache]
    torch.cuda.synchronize()
    launches = ms.mamba_scan.launches - before
    log(f"  scan launches on the card: {launches} (expected {cfg.n_layers})")
    if launches != cfg.n_layers:
        raise AssertionError("falcon check did not go through the kernel "
                             f"once a layer: {launches}")
    for i in range(3):
        _bf16_close(f"logits step {i}", out["cuda"][i], out["cpu"][i])
    for key in ("conv", "ssm"):
        _bf16_close(f"cache {key}", out["cuda"][3][key], out["cpu"][3][key])


@contextlib.contextmanager
def _captured_routes():
    """Keeps, for each call of ``moe_mod._route`` in the block, its float32
    input, the router's weights and the expert indices it chose."""
    records, route = [], moe_mod._route

    def capture(x32, router_w, n_experts, top_k):
        w, idx, aux = route(x32, router_w, n_experts, top_k)
        records.append((x32, router_w, idx))
        return w, idx, aux

    moe_mod._route = capture
    try:
        yield records
    finally:
        moe_mod._route = route


def _agreement(pairs):
    """(share of (token, slot) expert indices equal, share of tokens whose
    expert sets are equal, assignments) over pairs of (T, k) index
    tensors."""
    same = same_sets = n = rows = 0
    for a, b in pairs:
        a, b = a.cpu(), b.cpu()
        same += int((a == b).sum())
        same_sets += int((a.sort(-1).values == b.sort(-1).values)
                         .all(-1).sum())
        n, rows = n + a.numel(), rows + a.shape[0]
    return same / n, same_sets / rows, n


@contextlib.contextmanager
def _forced_routes(records):
    """``moe_mod._route`` choosing, call after call, the experts of the
    captured ``records`` (another run's); the probabilities, and so the
    combine weights gathered at those experts and renormalised, are this
    run's own.  Capacity slots follow from the experts alone."""
    route, chosen = moe_mod._route, iter(records)

    def forced(x32, router_w, n_experts, top_k):
        _, _, aux = route(x32, router_w, n_experts, top_k)
        idx = next(chosen)[2].to(x32.device)
        w = torch.softmax(x32 @ router_w, dim=-1).gather(1, idx)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx, aux

    moe_mod._route = forced
    try:
        yield
    finally:
        moe_mod._route = route


def _run_cut(cfg, params, tokens, toks, dev):
    """Prefill ``tokens`` and 2 decode steps of ``toks`` (filled from this
    run's greedy tokens when empty): [3 logits, cache]."""
    S = tokens.shape[1]
    logits, cache = T.prefill_forward(cfg, params, {"tokens": tokens.to(dev)},
                                      max_seq=S + 2)
    steps = [logits]
    for i in range(2):
        if len(toks) == i:
            toks.append(torch.argmax(logits[:, -1], -1, keepdim=True).cpu())
        logits, cache = T.decode_forward(cfg, params, cache, toks[i].to(dev),
                                         S + i)
        steps.append(logits)
    return steps + [cache]


def _log_flips(cfg, cpu_routes, card_routes, names=("CPU", "card")):
    """Per layer of the prefill, the share of tokens whose expert sets agree
    between the card's run and the CPU's (each fed its own input); for the
    first layer with a flip, its first flipped (token, slot) and the CPU's
    probability gap between its k-th and (k+1)-th expert there, beside that
    gap's median over all tokens: a flip sits on a near-tie.  ``names``:
    the two runs' names in the lines, the reference run's first."""
    ref, run = names
    e = cfg.moe
    for layer, (c, g) in enumerate(zip(cpu_routes[:cfg.n_layers],
                                       card_routes[:cfg.n_layers])):
        x32, w_r, cidx = c
        gidx = g[2].cpu()
        same = (cidx.sort(-1).values == gidx.sort(-1).values).all(-1)
        share = 100 * same.float().mean()
        log(f"  routing, prefill layer {layer}: {share:.4f}% of "
            f"{same.numel()} token expert sets agree, {run} run against {ref} "
            f"run")
        if bool(same.all()):
            continue
        p = torch.softmax(x32 @ w_r, dim=-1).sort(-1, descending=True).values
        gap = p[:, e.top_k - 1] - p[:, e.top_k]
        t = int((~same).nonzero()[0])
        slot = int((cidx[t] != gidx[t]).nonzero()[0])
        log(f"  first flip: layer {layer}, token {t}, slot {slot} ({ref} "
            f"expert {int(cidx[t, slot])}, {run} {int(gidx[t, slot])}); the "
            f"{ref}'s top-{e.top_k} edge gap there {float(gap[t]):.3e}, median "
            f"over flipped tokens {float(gap[~same].median()):.3e}, over all "
            f"tokens {float(gap.median()):.3e}")
        break


def check_moe_against_cpu(arch):
    """``arch`` cut to ``MOE_CUTS[arch]`` layers at full width, params from
    a seed made on the card and copied to the CPU: prefill logits, the
    cache and 2 decode steps fed the CPU's greedy tokens, on the card (the
    flash kernel once a layer, in the variant the rule names at the model's
    flash head dim) against the CPU (plain path) at ``BF16_TOL``.

    Routing is discontinuous: a bf16 rounding difference upstream of a
    router moves an assignment across the top-k edge, and the moved
    assignment shifts later tokens' capacity slots.  So the check is in
    two parts.  (1) Each MoE layer's router, fed the card's own input on
    the CPU, must choose the card's experts (every index equal: a port
    fault shows here).  (2) The CPU runs again with the card's expert
    choices (``_forced_routes``), as both runs take the CPU's greedy
    tokens, and that run is held to the card at ``BF16_TOL``.  The CPU's
    free run (its own routing) is compared too and logged, not asserted,
    with the routing agreement per layer and the first flip's probability
    gap."""
    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_CUTS[arch])
    gpu = T.init_params(cfg, seed=1, device="cuda")
    cpu = to_device(gpu, "cpu")
    tokens = torch.randint(0, cfg.vocab, MOE_PROMPTS,
                           generator=torch.Generator().manual_seed(1))
    D = _flash_head_dim(cfg)
    name = fa.variant(D, torch.bfloat16)
    e = cfg.moe
    log(f"moe check: {cfg.name} cut to {cfg.n_layers} layers at d_model "
        f"{cfg.d_model}, {e.n_experts} experts top-{e.top_k} + "
        f"{e.n_shared} shared, flash head dim {D}, tokens "
        f"{tuple(tokens.shape)}, card vs CPU")
    toks = []
    with _captured_routes() as cpu_routes:
        free = _run_cut(cfg, cpu, tokens, toks, "cpu")
    before = dict(fa.flash_attention.launches_by_variant)
    with _captured_routes() as card_routes:
        card = _run_cut(cfg, gpu, tokens, toks, "cuda")
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in
           fa.flash_attention.launches_by_variant.items() if n != before[k]}
    log(f"  flash launches on the card: {ran} (expected {cfg.n_layers} of "
        f"{name} at D {D})")
    if ran != {name: cfg.n_layers}:
        raise AssertionError(f"moe check did not go through the kernel "
                             f"once a layer: {ran}")
    fed = _agreement(
        (moe_mod._route(x32.cpu(), w_r.cpu(), e.n_experts, e.top_k)[1], idx)
        for x32, w_r, idx in card_routes)
    own = _agreement((c[2], g[2]) for c, g in zip(cpu_routes, card_routes))
    log(f"  routing, each router fed the card's input on the CPU: "
        f"{100 * fed[0]:.4f}% of {fed[2]} expert indices equal, "
        f"{100 * fed[1]:.4f}% of token expert sets equal")
    log(f"  routing, card run against CPU run (each fed its own input): "
        f"{100 * own[0]:.4f}% of {own[2]} expert indices equal, "
        f"{100 * own[1]:.4f}% of token expert sets equal")
    _log_flips(cfg, cpu_routes, card_routes)
    if fed[0] != 1.0:
        raise AssertionError(f"{arch}: routers fed the card's input chose "
                             f"other experts on the CPU ({fed})")
    log("  card against the CPU's free run (its own routing; logged, not "
        "asserted):")
    for i in range(3):
        _bf16_close(f"logits step {i}", card[i], free[i], strict=False)
    for key in sorted(free[3]):
        _bf16_close(f"cache {key}", card[3][key], free[3][key], strict=False)
    with _forced_routes(card_routes):
        forced = _run_cut(cfg, cpu, tokens, toks, "cpu")
    log("  card against the CPU run with the card's expert choices:")
    for i in range(3):
        _bf16_close(f"logits step {i}", card[i], forced[i])
    for key in sorted(forced[3]):
        _bf16_close(f"cache {key}", card[3][key], forced[3][key])


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def weight_bound(cfg, params, decode_ms, smi):
    """Phase 39: a decode step's device time (profiled, ms) beside the
    least time the card takes to read every weight once at the HBM rate,
    which each step does."""
    nbytes = _nbytes(params)
    floor_ms = 1e3 * nbytes / hw.HBM_BW
    if decode_ms is None:
        log(f"{cfg.name} decode: device time not measured; its "
            f"{nbytes / 1e9:.3f} GB of weights take {floor_ms:.3f} ms a step")
        return
    log(f"{cfg.name} decode: {decode_ms:.3f} ms of device time a step "
        f"(profiled, mean of 8) beside {floor_ms:.3f} ms, its "
        f"{nbytes / 1e9:.3f} GB of weights read once at "
        f"{hw.HBM_BW / 1e12:.2f} TB/s: {100 * floor_ms / decode_ms:.1f}% "
        f"of that bound; card {smi}")


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def serve_falcon():
    """falcon_mamba_7b at full width and depth through ``serve``; the scan's
    count is set to 0 just before and read just after.  Returns the config,
    the params, the scan's launches and ``_log_serving``'s measured
    times."""
    cfg = get_config("falcon_mamba_7b")
    params = T.init_params(cfg, seed=0, device="cuda")
    log(f"serve: {cfg.name} full width, {cfg.n_layers} Mamba1 layers, "
        f"d_model {cfg.d_model}, d_inner {cfg.ssm.expand * cfg.d_model}, N "
        f"{cfg.ssm.d_state}, vocab {cfg.vocab}, {_numel(params) / 1e9:.3f} B "
        f"params; {SERVE}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms.mamba_scan.launches = 0
    stats = serve(cfg, device="cuda", seed=0, params=params, log=log, **SERVE)
    launches = ms.mamba_scan.launches
    expect = cfg.n_layers * stats["batches"]
    log(f"mamba_scan launches in serving: {launches} (expected "
        f"{cfg.n_layers} layers x {stats['batches']} prefill batches = "
        f"{expect})")
    if launches != expect:
        raise AssertionError(f"{launches} scan launches, expected {expect}")
    return cfg, params, launches, _log_serving(stats)


def time_scan_serving(shape, smi):
    """The scan at ``shape`` (float32) with no state, with h_S out (what
    prefill runs) and with h0 in and h_S out: {state: row} of kernel ms,
    host us a call, the plain version's ms (with both) and the bound."""
    args = _scan_inputs(*shape, torch.float32, seed=2)
    b, _, d, N = shape
    h0 = torch.randn(b, d, N, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(3))
    plain = cuda_ms(lambda: ref.mamba_scan_ref(*args, h0=h0,
                                               return_state=True),
                    2, hold=False)
    rows = {}
    for name, kw, states in (("none", {}, 0),
                             ("h_S", dict(return_state=True), 1),
                             ("h0+h_S", dict(h0=h0, return_state=True), 2)):
        def call():
            return ms.mamba_scan(*args, **kw)
        kernel_ms, host = cuda_ms(call, 20), host_us(call)
        b_ms, by, terms = scan_bound(*shape, torch.float32, states=states)
        log(f"mamba_scan serving shape {shape} state {name}: kernel "
            f"{kernel_ms:.4f} ms (host {host:.1f} us a call), plain "
            f"{plain:.4f} ms, library none, bound {b_ms:.4f} ms by {by} (ops "
            f"{1e3 * terms['operations']:.4f}, exp {1e3 * terms['exp']:.4f}, "
            f"bytes {1e3 * terms['bytes']:.4f} ms) = "
            f"{100 * b_ms / kernel_ms:.2f}% of bound; card {smi}")
        rows[name] = dict(ms=kernel_ms, plain_ms=plain, library_ms=None,
                          bound_ms=b_ms, host_us=host,
                          bound_by="bytes" if by == "bytes" else "operations")
    return rows


def copy_latency(smi, elems=16384):
    """Log the device ms of one small copy (``elems`` float32, the default
    tile of ``Graph.program``), back to back: the per-copy latency of the
    tiling target (``core/tiling.py::H100``)."""
    src = torch.randn(elems, device="cuda")
    dst = torch.empty_like(src)
    t = cuda_ms(lambda: dst.copy_(src), 200)
    log(f"one {4 * elems // 1024} KiB device copy, back to back: {t:.6f} ms "
        f"(tiling target's copy latency {1e3 * H100_TILING.copy_latency_s:g} "
        f"ms); card {smi}")


def _tile_counts(g, max_tile_elems):
    """Each compute node's tile count as ``choose_tiling`` chooses it at the
    H100's target, the node's tensor as ``from_graph`` views it."""
    counts = {}
    for name in g.order:
        n = g.nodes[name]
        if n.op in ("input", "weight"):
            continue
        shape4 = tuple(n.shape) if len(n.shape) == 4 else \
            (1, 1, 1, math.prod(n.shape))
        counts[name] = max(choose_tiling(
            TensorSpec(shape4, "NHWC", "float32"), max_tile_elems,
            reduce_dim="C" if n.op in ("convolution", "matmul") else None)
            .n_tiles, 1)
    return counts


def _price(program, config):
    """One engine run: the result and the engine's own CPU seconds."""
    t0 = time.thread_time()
    res = sim.run(program, config)
    return res, time.thread_time() - t0


def _price_configs(table, host_s):
    """The three backends of phases 22-23 on one H100 (one worker, the hbm
    interface, the H100's constants): the roofline, the measured table, and
    the table with the matmul wrapper's host time charged a dispatch."""
    return {"roofline": sim.EngineConfig(),
            "table": sim.EngineConfig(cost_backend=table),
            "table+host": sim.EngineConfig(cost_backend=table,
                                           host_dispatch_s=host_s)}


def _price_line(label, res, cpu_s, wall_ms, device_ms=None):
    """Log one price beside the card's wall ms and, where profiled, its
    device ms."""
    f = res.breakdown.fractions()
    mk = 1e3 * res.makespan
    if not (math.isfinite(mk) and mk > 0):
        raise AssertionError(f"{label}: makespan {mk} ms")
    by_device = f"{mk / device_ms:.4f}" if device_ms else "not measured"
    log(f"  {label}: priced {mk:.6f} ms (accelerator "
        f"{100 * f['accelerator']:.1f}%, transfer {100 * f['transfer']:.1f}%"
        f", host {100 * f['host']:.1f}%), {len(res.program.ops)} ops, engine "
        f"{cpu_s:.3f} s CPU; price / wall {mk / wall_ms:.4f}, price / "
        f"device {by_device}")


def check_table(table, records):
    """The table still returns each of its samples' seconds exactly."""
    for r in records:
        got = table.op_time(sim.CostedOp("sample", flops=r["flops"],
                                         op_kind=r["kind"]))
        if got != r["measured_s"]:
            raise AssertionError(f"table gives {got} s for {r['kind']} "
                                 f"{r['shape']}, measured {r['measured_s']}")


def _one_tile_a_node(g):
    """The largest compute node's elements: ``Graph.program`` at this
    ``max_tile_elems`` gives every node one tile, as the card launches one
    matmul a conv or FC node."""
    return max(math.prod(n.shape) for n in g.nodes.values()
               if n.op not in ("input", "weight"))


def price_nets(table, host_s, measured, smi):
    """Phase 22: each Table-III net at each batch, not cut, lowered by
    ``Graph.program`` at the default 16,384-element tiles and at one tile a
    node, priced on one H100 under the roofline, the measured ``table`` and
    the table with ``host_s`` a dispatch, beside the card's median wall ms
    and profiled device and matmul ms (phase 11)."""
    kinds = sorted({kind for kind, _, _ in table.samples})
    log(f"price: table of {len(table.samples)} samples ({kinds}); host "
        f"dispatch {1e6 * host_s:.1f} us (the matmul wrapper's host time a "
        f"call, phase 8); card {smi}")
    for net in PAPER_NETS.values():
        for batch in GRAPH_BATCHES:
            g = build_paper_graph(net, batch)
            card = measured[net.name, batch]
            dev, mmk = card["device_ms"], card["matmul_ms"]
            log(f"price {net.name} batch {batch}: card wall "
                f"{card['wall_ms']:.4f} ms, device "
                + (f"{dev:.4f} ms, matmul {mmk:.4f} ms ({100 * mmk / dev:.1f}"
                   f"% of device, {100 * mmk / card['wall_ms']:.1f}% of wall)"
                   if dev else "not measured"))
            for tiling, elems in (("16384", 16384),
                                  ("node", _one_tile_a_node(g))):
                prog = g.program(batch, max_tile_elems=elems)
                counts = _tile_counts(g, elems)
                if len(prog.ops) != sum(counts.values()):
                    raise AssertionError(f"{net.name} {len(prog.ops)} ops, "
                                         f"tilings {sum(counts.values())}")
                if tiling == "node" and set(counts.values()) != {1}:
                    raise AssertionError(f"{net.name} tiles at {elems}")
                for name, cfg in _price_configs(table, host_s).items():
                    res, cpu_s = _price(prog, cfg)
                    _price_line(f"{net.name} b{batch} tiles {tiling} "
                                f"{name}", res, cpu_s, card["wall_ms"], dev)


def price_frame(table, host_s, frame_ms, smi):
    """Phase 23: the camera frame (the ISP's stages at 720x1280, then CNN10
    at batch 1) priced as in phase 22 beside phase 12's ms, and once on the
    camera SoC (ISP on the frontend CPU, CNN10 on 4 H100-rate
    accelerators)."""
    cnn10 = build_paper_graph(PAPER_NETS["cnn10"], 1).program(1)
    isp = camera_program(camera.FRAME_HW, camera.DNN_HW,
                         device_class="accel")
    frame = isp.then(cnn10, name="frame")
    log(f"price camera frame {camera.FRAME_HW}: card ISP "
        f"{frame_ms['isp_ms']:.4f} ms, CNN10 {frame_ms['cnn_ms']:.4f} ms, "
        f"frame {frame_ms['frame_ms']:.4f} ms; card {smi}")
    for name, cfg in _price_configs(table, host_s).items():
        for part, prog, key in (("ISP", isp, "isp_ms"),
                                ("CNN10", cnn10, "cnn_ms"),
                                ("frame", frame, "frame_ms")):
            res, cpu_s = _price(prog, cfg)
            _price_line(f"{part} {name}", res, cpu_s, frame_ms[key])
    soc = camera_soc()
    res, cpu_s = _price(camera_program(camera.FRAME_HW, camera.DNN_HW)
                        .then(cnn10, name="frame"),
                        sim.EngineConfig(topology=soc))
    _price_line(f"frame on {soc.name} ({soc.describe()}) roofline", res,
                cpu_s, frame_ms["frame_ms"])
    log(f"  per device: {res.per_device}")
    if not {"cpu0", "acc0"} <= set(res.per_device):
        raise AssertionError(f"frame on the SoC ran on {set(res.per_device)}")


def _pe_configs(**kw):
    """Phase 24's grid: ``PE_GRID``'s points at the H100's rates scaled by
    the PE fraction, then one H100."""
    return [sim.EngineConfig(n_workers=w, interface="acp", hbm_ports=4,
                             peak_flops=hw.PEAK_FLOPS * f, datapath_scale=f,
                             **kw) for w, f in PE_GRID] + \
        [sim.EngineConfig(**kw)]


def pe_study(table, frame_ms, smi):
    """Phase 24: the Fig 19/20 accelerator-size study.  The 720x1280 frame
    (ISP, then CNN10 at batch 1) through ``frame_sweep`` over ``PE_GRID``
    and one H100, under the roofline at 16,384-element tiles and under the
    ``model`` grid's measured table at one tile a node; each point's frame,
    ISP and DNN ms against the 33 ms budget, the one-H100 point beside
    phase 12's measured ms.  Asserts each sweep result equal to
    ``engine.run`` of its config."""
    g = build_paper_graph(PAPER_NETS["cnn10"], 1)
    labels = [f"{w} workers x {f:g} PE" for w, f in PE_GRID] + ["one H100"]
    log(f"accelerator-size study (Fig 19/20): frame {camera.FRAME_HW} + "
        f"CNN10 batch 1; card ISP {frame_ms['isp_ms']:.4f} ms, CNN10 "
        f"{frame_ms['cnn_ms']:.4f} ms, frame {frame_ms['frame_ms']:.4f} ms "
        f"(phase 12); card {smi}")
    for name, elems, kw in (
            ("roofline, 16384-element tiles", 16384, {}),
            ("table, one tile a node", _one_tile_a_node(g),
             {"cost_backend": table})):
        configs = _pe_configs(**kw)
        t0, c0 = time.perf_counter(), time.thread_time()
        frame, results = frame_sweep(lower_graph(g, 1, elems), configs,
                                     camera.FRAME_HW, camera.DNN_HW)
        wall_s, cpu_s = time.perf_counter() - t0, time.thread_time() - c0
        log(f"  {name}: {len(frame.ops)} ops, {len(configs)} points, sweep "
            f"{1e3 * wall_s:.3f} ms wall, {cpu_s:.4f} s CPU")
        for label, cfg, res in zip(labels, configs, results):
            exact = sim.run(frame, cfg)
            if (res.makespan, res.breakdown) != (exact.makespan,
                                                 exact.breakdown):
                raise AssertionError(f"{name} {label}: sweep {res.makespan}"
                                     f" s, engine.run {exact.makespan} s")
            mk, isp = 1e3 * res.makespan, 1e3 * res.per_phase["isp"]
            if not (math.isfinite(mk) and mk > 0):
                raise AssertionError(f"{name} {label}: frame {mk} ms")
            log(f"    {label}: frame {mk:.6f} ms, ISP {isp:.6f} ms, DNN "
                f"{mk - isp:.6f} ms; meets {camera.BUDGET_MS:g} ms: "
                f"{mk < camera.BUDGET_MS}")
        mk, isp = 1e3 * results[-1].makespan, 1e3 * results[-1].per_phase[
            "isp"]
        log(f"    one H100, priced / measured: ISP "
            f"{isp / frame_ms['isp_ms']:.4f}, CNN10 "
            f"{(mk - isp) / frame_ms['cnn_ms']:.4f}, frame "
            f"{mk / frame_ms['frame_ms']:.4f}")


def soc_study(smi):
    """Phase 25: the camera-SoC tuning study.  ``soc_frame_sweep`` over
    ``SOC_GRID``'s 16 topologies (CNN10 at 2,048-element tiles), on
    bench_soc's embedded base point and with the accelerators at the H100's
    rates (``EngineConfig()``); each topology's makespan, ISP, frontend and
    mean accelerator utilisation and energy.  Asserts every device of each
    topology in its ``per_device``."""
    dnn = lower_graph(build_paper_graph(PAPER_NETS["cnn10"], 1), 1, SOC_TILE)
    topos = [camera_soc(n, f, link_ports=p) for f, n, p in SOC_GRID]
    for name, base in (("embedded base (bench_soc.BASE)", SOC_BASE),
                       ("H100 accelerators (EngineConfig())", None)):
        t0, c0 = time.perf_counter(), time.thread_time()
        cells = soc_frame_sweep(dnn, topos, base, camera.FRAME_HW,
                                camera.DNN_HW)
        wall_s, cpu_s = time.perf_counter() - t0, time.thread_time() - c0
        log(f"camera-SoC study, {name}: {len(cells)} topologies, CNN10 at "
            f"{SOC_TILE}-element tiles ({len(dnn.ops)} ops), sweep "
            f"{1e3 * wall_s:.3f} ms wall ({len(cells) / wall_s:.1f} points/s)"
            f", {cpu_s:.4f} s CPU; card {smi}")
        for topo, frame, res in cells:
            missing = {d.name for d in topo.devices} - set(res.per_device)
            if missing or not (math.isfinite(res.makespan)
                               and res.makespan > 0):
                raise AssertionError(f"{topo.name}: {res.makespan} s, "
                                     f"devices {missing} idle")
            util = res.device_utilization()
            accel = [util[d.name] for d in topo.devices if d.kind == "accel"]
            log(f"  {topo.name}: makespan {1e3 * res.makespan:.6f} ms, ISP "
                f"{1e3 * res.per_phase['isp']:.6f} ms, frontend util "
                f"{util[topo.devices[0].name]:.4f}, accelerator util mean "
                f"{sum(accel) / len(accel):.4f}, energy "
                f"{res.energy['total_j']:.6e} J")


def _axes():
    """``SPACE``'s two axes, ``GRID_SIDE`` geometric points each."""
    return [np.geomspace(lo, hi, GRID_SIDE) for lo, hi in SPACE.values()]


def _design(params):
    return ", ".join(f"{k} {v:.6e} ({v / H100_POINT[k]:.4f} H100)"
                     for k, v in params.items())


def analytic_layer(decode_ms, frame_ms, smi):
    """Phase 26: the analytic cost model.  (1) gemma3_1b's decode chain at
    ``DECODE_CHAIN`` over the 4,096-point grid, numpy on the host against
    torch on the card (rtol 1e-9), and the torch gradient against central
    differences; (2) the one-H100 roofline price of a decode step beside
    phase 4's measured ms; (3) ``batched`` over the grid on CNN10 at one
    tile a node and ``optimize`` for the cheapest design that keeps CNN10 at
    the card's measured ms, and that fits the frame in 33 ms."""
    cfg = get_config("gemma3_1b")
    prog = sim.from_decode(cfg, **DECODE_CHAIN)
    host = sim.CostModel(prog, backend="numpy")
    card = sim.CostModel(prog, backend="torch", device="cuda")
    P = np.tile(host.params0, (GRID_SIDE ** 2, 1))
    for field, values in zip(SPACE, np.meshgrid(*_axes(), indexing="ij")):
        P[:, sim.PARAM_FIELDS.index(field)] = values.ravel()
    t0 = time.perf_counter()
    ms_np = host.makespans(P)
    np_s = time.perf_counter() - t0
    card.makespans(P[:8])      # the op arrays cross to the card once
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    ms_t = card.makespans(P)
    end.record()
    end.synchronize()
    t_s = time.perf_counter() - t0
    err = float(np.max(np.abs(ms_t - ms_np) / ms_np))
    log(f"cost model: {cfg.name} decode chain ({len(prog.ops)} ops) over "
        f"{len(P)} points: numpy on the host {1e3 * np_s:.3f} ms wall; "
        f"torch on the card {1e3 * t_s:.3f} ms wall (CUDA events "
        f"{start.elapsed_time(end):.3f} ms), {1e6 * t_s / len(P):.3f} us a "
        f"point; max rel diff {err:.3e} (rtol 1e-9); card {smi}")
    np.testing.assert_allclose(ms_t, ms_np, rtol=1e-9, atol=0)
    g_t = card.objective(SPACE).grad(GRAD_Z)
    g_np = host.objective(SPACE).grad(GRAD_Z)
    log(f"  log-makespan gradient at z {GRAD_Z.tolist()}: torch.func "
        f"{g_t.tolist()}, central differences {g_np.tolist()}")
    np.testing.assert_allclose(g_t, g_np, rtol=5e-2, atol=1e-3)

    step = sim.from_decode(cfg, n_tokens=SERVE["max_new"], ops_per_token=8,
                           seq_len=SERVE["prompt_len"], batch=SERVE["batch"])
    res = sim.run(step, sim.EngineConfig())
    price = 1e3 * res.makespan / SERVE["max_new"]
    f = res.breakdown.fractions()
    med = statistics.median(decode_ms)
    log(f"  {cfg.name} decode at SERVE's shape, one H100 roofline: "
        f"{price:.6f} ms a step (accelerator {100 * f['accelerator']:.1f}%,"
        f" transfer {100 * f['transfer']:.1f}%) beside phase 4's measured "
        f"{med:.4f} ms a step (median; {min(decode_ms):.4f}-"
        f"{max(decode_ms):.4f}): price / measured {price / med:.4f}")

    g = build_paper_graph(PAPER_NETS["cnn10"], 1)
    dnn = lower_graph(g, 1, _one_tile_a_node(g))
    base = sim.EngineConfig()
    model = sim.CostModel(dnn, base, backend="numpy")
    configs = [hw.apply_params(base, dict(zip(SPACE, point)))
               for point in zip(*(v.ravel() for v in np.meshgrid(
                   *_axes(), indexing="ij")))]
    t0 = time.perf_counter()
    bs = batched(dnn, configs, top_k=3)
    b_s = time.perf_counter() - t0
    best = bs.best()
    log(f"  batched: CNN10 one tile a node ({len(dnn.ops)} ops, chain "
        f"{bs.is_chain}) over {len(configs)} points, backend {bs.backend}, "
        f"{1e3 * b_s:.3f} ms wall; fastest verified "
        f"{_design({k: getattr(best['config'], k) for k in SPACE})}: "
        f"{1e3 * best['exact_s']:.6f} ms, relaxation_err "
        f"{best['relaxation_err']}")
    for v in bs.verified:
        i = v["index"]
        if bs.is_chain and v["relaxation_err"] != 0.0:
            raise AssertionError(f"chain relaxation_err {v}")
        if not bs.lower[i] <= v["exact_s"] <= bs.upper[i]:
            raise AssertionError(f"bracket {bs.lower[i]} {v['exact_s']} "
                                 f"{bs.upper[i]}")
    for name, target_ms in (("CNN10 at the card's ms", frame_ms["cnn_ms"]),
                            ("the frame in 33 ms",
                             camera.BUDGET_MS - frame_ms["isp_ms"])):
        t0 = time.perf_counter()
        opt = optimize(dnn, SPACE, base_config=base,
                       target_s=1e-3 * target_ms, device="cuda")
        o_s = time.perf_counter() - t0
        log(f"  optimize, {name} (target {target_ms:.4f} ms): "
            f"{_design(opt.params)}; exact {1e3 * opt.exact_s:.6f} ms, "
            f"feasible {opt.feasible}, n_evals {opt.n_evals}, backend "
            f"{opt.backend} (the lowering is "
            f"{'a chain' if model.is_chain else 'a DAG'}), relaxation_err "
            f"{opt.relaxation_err:.3e}, {1e3 * o_s:.1f} ms wall")
        want = "torch" if model.is_chain else "numpy"
        if (opt.backend != want or opt.feasible is not True
                or opt.exact_s != sim.run(dnn, opt.config).makespan
                or abs(opt.relaxation_err) > 1e-9):
            raise AssertionError(f"optimize {name}: {opt}")


def serve_batch_full(host_params):
    """Phase 27 (1): gemma3_1b at full width through the measured mode of
    ``launch.serve_batch``: one batch of ``policy.max_batch`` = 4 prompts of
    1024 tokens, 32 tokens each, on phase 4's params (brought back to the
    card).  The flash counts are set to 0 just before and read just after:
    one launch a layer, all bf16 ``wgmma``.  Returns the launches by
    variant."""
    cfg = get_config("gemma3_1b")
    params = to_device(host_params, "cuda")
    policy = get_policy("static", max_batch=SERVE["batch"])
    log(f"serve_batch: {cfg.name} full width, {policy}, prompt "
        f"{SERVE['prompt_len']}, {SERVE['max_new']} tokens, on the card")
    torch.cuda.synchronize()
    fa.reset_counts()
    out = run_measured(cfg, policy, prompt_len=SERVE["prompt_len"],
                       tokens=SERVE["max_new"], device="cuda", params=params,
                       log=log)
    launches = fa.flash_attention.launches
    by_variant = dict(fa.flash_attention.launches_by_variant)
    log(f"flash_attention launches in serve_batch: {launches}, by variant "
        f"{by_variant} (expected {cfg.n_layers} layers x 1 batch, all "
        f"wgmma)")
    if launches != cfg.n_layers or by_variant["wgmma"] != cfg.n_layers:
        raise AssertionError(f"serve_batch: {by_variant} flash launches")
    if not out["finite"] or out["tokens"].shape != (SERVE["batch"],
                                                    SERVE["max_new"]):
        raise AssertionError(f"serve_batch: finite {out['finite']}, tokens "
                             f"{out['tokens'].shape}")
    tok_s = SERVE["batch"] * SERVE["max_new"] / (out["prefill_s"]
                                                 + out["decode_s"])
    log(f"  prefill {1e3 * out['prefill_s']:.3f} ms, decode "
        f"{1e3 * out['decode_s'] / (SERVE['max_new'] - 1):.4f} ms a step, "
        f"{tok_s:.1f} tok/s")
    return by_variant


def _serve_requests(arch):
    """``arch``'s serving traffic (``_serve_of``) as a trace: every request
    at t = 0."""
    kw = _serve_of(arch)
    return [Request(i, 0.0, kw["prompt_len"], kw["max_new"])
            for i in range(kw["requests"])]


def _step_prices(res):
    """Mean priced prefill and decode step (ms) of a ``ServingResult``."""
    pre = [s.duration_s for s in res.steps if s.n_prefill]
    dec = [s.duration_s for s in res.steps if s.n_decode]
    return 1e3 * sum(pre) / len(pre), 1e3 * sum(dec) / len(dec)


def price_serving(measured, table, smi):
    """Phase 27 (2): ``SERVE`` for each served model priced by
    ``sim.serving.simulate_serving`` (8 requests at t = 0, prompt 1024, 32
    tokens, static batching of 4) on one H100 at its bf16 peak, alone (a)
    and with a host dispatch of 50 us a step (b); each priced prefill step,
    mean decode step, makespan, tok/s and accelerator / transfer / host
    shares beside ``measured`` (phases 4/6, 15/16, 19/20: the last batch's
    prefill ms, decode ms a step, tok/s, busy shares) with price /
    measured.
    Asserts finite positive prices, 64 steps, busy == engine makespan and
    ``replay_serving`` == ``simulate_serving`` on every stats field."""
    bf16 = default_config()
    configs = (("a", bf16), ("b", dataclasses.replace(
        bf16, host_dispatch_s=HOST_DISPATCH_S)))
    policy = get_policy("static", max_batch=SERVE["batch"])
    n_steps = SERVE["requests"] // SERVE["batch"] * SERVE["max_new"]
    log(f"serving priced (engine output, not times): {SERVE} as a trace at "
        f"t = 0, {policy}; (a) one H100 at its bf16 peak "
        f"{bf16.peak_flops:.4g} flop/s, HBM {bf16.hbm_bw:.4g} B/s; (b) (a) "
        f"plus {1e6 * HOST_DISPATCH_S:g} us host dispatch a step; beside "
        f"this run's measured serving (whisper_small at its prompt of "
        f"{_serve_of('whisper_small')['prompt_len']}; the simulator prices "
        f"neither whisper's encoder nor internvl2_26b's 256 patches, which "
        f"the card runs); card {smi}")
    biggest = 0.0
    for arch in SERVED:
        cfg = get_config(arch)
        trace = _serve_requests(arch)
        m = measured[arch]
        pre_ms = m["prefill_ms"][-1]
        dec_ms = statistics.median(m["decode_ms"])
        busy = {k: ("not measured" if v is None else f"{100 * v:.1f}%")
                for k, v in m["busy"].items()}
        log(f"  {arch} measured: prefill {pre_ms:.3f} ms a batch (the last; "
            f"each batch {[round(x, 3) for x in m['prefill_ms']]}, the "
            f"first with first-call costs), decode {dec_ms:.4f} ms a step "
            f"(median; {min(m['decode_ms']):.4f}-{max(m['decode_ms']):.4f}),"
            f" {m['tok_s']:.1f} tok/s; device busy prefill "
            f"{busy['prefill']}, decode {busy['decode']}")
        for label, config in configs:
            t0 = time.perf_counter()
            res = simulate_serving(cfg, trace, policy, config)
            cpu_s = time.perf_counter() - t0
            rep = replay_serving(cfg, trace, policy, config)
            p_pre, p_dec = _step_prices(res)
            f = res.engine.breakdown.fractions()
            tok_s = res.throughput_tok_s
            log(f"  {arch} ({label}): prefill step {p_pre:.6f} ms "
                f"(/ measured {p_pre / pre_ms:.4f}), decode step "
                f"{p_dec:.6f} ms (/ measured {p_dec / dec_ms:.4f}), makespan"
                f" {1e3 * res.makespan_s:.6f} ms, {tok_s:.1f} tok/s "
                f"(/ measured {tok_s / m['tok_s']:.4f}); accelerator "
                f"{100 * f['accelerator']:.1f}%, transfer "
                f"{100 * f['transfer']:.1f}%, host {100 * f['host']:.1f}%; "
                f"{len(res.steps)} steps, {1e3 * cpu_s:.1f} ms CPU")
            prices = (p_pre, p_dec, res.makespan_s, tok_s)
            if not all(math.isfinite(x) and x > 0 for x in prices):
                raise AssertionError(f"{arch} ({label}): prices {prices}")
            if len(res.steps) != n_steps or res.busy_s != res.engine.makespan:
                raise AssertionError(f"{arch} ({label}): {len(res.steps)} "
                                     f"steps, busy {res.busy_s} engine "
                                     f"{res.engine.makespan}")
            if rep.stats() != res.stats():
                raise AssertionError(f"{arch} ({label}): replay "
                                     f"{rep.stats()} != {res.stats()}")
            biggest = max(biggest, max(op.flops for op in res.program.ops))
        log(f"  {arch}: replay_serving == simulate_serving on every stats "
            f"field under (a) and (b)")
    res = simulate_serving(get_config("gemma3_1b"),
                           _serve_requests("gemma3_1b"), policy,
                           sim.EngineConfig())
    p_pre, p_dec = _step_prices(res)
    pre_ms = measured["gemma3_1b"]["prefill_ms"][-1]
    log(f"  the float32 trap: gemma3_1b at the default EngineConfig() "
        f"({hw.PEAK_FLOPS:.4g} flop/s, the CUDA cores' float32 rate) prices "
        f"a prefill step at {p_pre:.6f} ms ({p_pre / pre_ms:.4f}x the "
        f"measured {pre_ms:.3f} ms) and a decode step at {p_dec:.6f} ms; the "
        f"served models run bf16")
    top = max(flops for _, flops, _ in table.samples)
    log(f"  not priced from the measured table: a serving step is one "
        f"whole-model op of up to {biggest:.4g} flops, above the table's "
        f"largest sample ({top:.4g} flops), where TableBackend._lookup "
        f"clamps (np.interp) and the price would mean nothing")


def serving_studies(smi):
    """Phase 28: the serving studies at H100 rates, config (b) of phase 27.
    ``serving_sweep`` over ``GRID_POLICIES`` x ``GRID_RATES`` (max_batch 8,
    64 Poisson requests, seed 0) for each served model: throughput, TTFT
    p50/p99 and TPOT p50 a cell; then ``simulate_fleet`` over
    ``FLEET_QUICK``'s diurnal trace on gemma3_1b (continuous batching of
    64, 4 replicas, round robin): requests simulated a second of host CPU
    and the memo's hit rate."""
    config = dataclasses.replace(default_config(),
                                 host_dispatch_s=HOST_DISPATCH_S)
    policies = [get_policy(kind, max_batch=8, **kw)
                for kind, kw in GRID_POLICIES]
    log(f"serving grid (engine output): {[str(p) for p in policies]} x "
        f"{GRID_RATES} rps, {GRID_REQUESTS} Poisson requests, seed 0, one "
        f"H100 at its bf16 peak plus {1e6 * HOST_DISPATCH_S:g} us a step; "
        f"card {smi}")
    n_cells = 0
    for arch in SERVED:
        t0 = time.perf_counter()
        results = serving_sweep(get_config(arch), policies, GRID_RATES,
                                n_requests=GRID_REQUESTS, config=config,
                                seed=0)
        cpu_s = time.perf_counter() - t0
        by_cell = {}
        for res in results:
            st = res.stats()
            rate = res.meta["rate_rps"]
            by_cell[(res.policy.kind, rate)] = st
            log(f"  {arch} {res.policy.kind}@{rate:g}rps: "
                f"{st['throughput_tok_s']:.1f} tok/s, TTFT p50 "
                f"{1e3 * st['ttft_p50']:.3f} ms p99 "
                f"{1e3 * st['ttft_p99']:.3f} ms, TPOT p50 "
                f"{1e3 * st['tpot_p50']:.4f} ms, occupancy "
                f"{st['occupancy']:.3f}, {st['n_steps']} steps")
            if not (st["throughput_tok_s"] > 0
                    and all(math.isfinite(v) for v in st.values())):
                raise AssertionError(f"{arch} grid cell {st}")
            n_cells += 1
        top = max(GRID_RATES)
        gain = (by_cell[("continuous", top)]["throughput_tok_s"]
                / by_cell[("static", top)]["throughput_tok_s"])
        log(f"  {arch}: continuous over static at {top:g} rps "
            f"{gain:.3f}x; grid {1e3 * cpu_s:.1f} ms CPU")
    if n_cells != len(SERVED) * len(policies) * len(GRID_RATES):
        raise AssertionError(f"{n_cells} grid cells")
    q = FLEET_QUICK
    trace = diurnal_trace(q["n_requests"], q["rate_rps"],
                          output_len=q["output_len"], seed=0, arrays=True)
    t0 = time.perf_counter()
    f = simulate_fleet(get_config("gemma3_1b"), trace,
                       get_policy("continuous", max_batch=q["max_batch"]),
                       config, n_replicas=q["n_replicas"],
                       router="round_robin")
    wall = time.perf_counter() - t0
    if not np.isfinite(f.finish_s).all():
        raise AssertionError("fleet replay left requests unserved")
    st = f.stats()
    log(f"fleet replay: gemma3_1b, {q['n_requests']} diurnal requests at "
        f"{q['rate_rps']:g} rps, continuous batching of {q['max_batch']}, "
        f"{q['n_replicas']} replicas, round robin: {wall:.3f} s host CPU = "
        f"{q['n_requests'] / wall:.0f} simulated requests/s; memo hit rate "
        f"{f.meta['memo_hit_rate']:.4f}; {f.n_steps} steps, occupancy "
        f"{f.occupancy:.4f}, SLO attainment {st['slo_attainment']:.4f}, "
        f"simulated makespan {st['makespan_s']:.3f} s")

# ---------------------------------------------------------------------------
# phases 41-44: training on the card


def _grads(fn, inputs, douts):
    """(outputs, gradients of ``inputs``) of ``fn`` against ``douts``, on
    fresh leaves that require grad."""
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    return [o.detach() for o in outs], list(torch.autograd.grad(
        outs, ts, douts[:len(outs)]))


def _plain_flash_grads(q, k, v, dout, causal, window):
    """``ref.flash_attention_ref``'s output and its (dq, dk, dv) by
    autograd against ``dout``, one batch element at a time: at a microbatch
    of 4 x 32 heads x 4096^2 the dense float32 scores of a whole batch and
    what autograd keeps of them would take some 35 GB."""
    outs, grads = [], []
    for b in range(q.shape[0]):
        (o,), g = _grads(lambda *t: ref.flash_attention_ref(
            *t, causal=causal, window=window),
            (q[b:b + 1], k[b:b + 1], v[b:b + 1]), (dout[b:b + 1],))
        outs.append(o)
        grads.append(g)
    return torch.cat(outs), [torch.cat(g) for g in zip(*grads)]


def _rel_l2(got, expect):
    got, expect = got.float(), expect.float().to(got.device)
    return ((got - expect).norm() / expect.norm().clamp(min=1e-30)).item()


def _grad_close(name, got, expect, tol):
    err = _rel_l2(got, expect)
    ok = err <= tol and bool(torch.isfinite(got.float()).all())
    log(f"  {name}: relative L2 error {err:.3e} (tol {tol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: {err}")
    return err


def check_grad_functions(smi):
    """Phase 41: ``ops.flash_attention`` and ``ops.mamba_scan`` on CUDA
    tensors that require grad: one kernel launch each for the forward, the
    output against the plain version at the kernel's tolerance, and each
    gradient against autograd's through the plain version (relative L2:
    float32 1e-4, bf16 3e-2).  Times one forward + backward through the
    Function beside the plain version's autograd.  The plain side runs one
    batch element at a time (``_plain_flash_grads``), so that its dense
    scores fit at the training shape.  Then the raw wrappers refuse an
    input that requires grad, with no launch.  Returns the largest gradient
    error."""
    worst = 0.0
    for case, dtypes in TRAIN_FLASH_CASES:
        B, H, Hkv, S, D, causal, window = case
        for dtype in dtypes:
            q, k, v = rand_qkv(B, H, Hkv, S, D, dtype, seed=4)
            dout = rand_qkv(B, H, H, S, D, dtype, seed=5)[0]
            log(f"flash autograd function {case} {dtype}:")

            def fn(*t):
                return ops.flash_attention(*t, causal=causal, window=window)
            before = fa.flash_attention.launches
            (out,), grads = _grads(fn, (q, k, v), (dout,))
            torch.cuda.synchronize()
            if fa.flash_attention.launches != before + 1:
                raise AssertionError("the Function did not launch the "
                                     "kernel once")
            eout, expect = _plain_flash_grads(q, k, v, dout, causal, window)
            _check("  forward", out, eout, TOL[dtype], TOL[dtype])
            for name, g, e in zip(("dq", "dk", "dv"), grads, expect):
                if g.dtype != dtype or g.shape != e.shape:
                    raise AssertionError(f"{name}: {g.dtype} {g.shape}")
                worst = max(worst, _grad_close(name, g, e, GRAD_TOL[dtype]))
            ms_fn = cuda_ms(lambda: _grads(fn, (q, k, v), (dout,)), 3,
                            hold=False)
            ms_plain = cuda_ms(lambda: _plain_flash_grads(
                q, k, v, dout, causal, window), 3, hold=False)
            log(f"  forward + backward: Function (kernel forward, plain "
                f"chunked backward) {ms_fn:.3f} ms, plain (dense autograd, "
                f"one batch element at a time) {ms_plain:.3f} ms; card {smi}")
            del q, k, v, dout, out, grads, eout, expect
            torch.cuda.empty_cache()
    b, S, d, N = TRAIN_SCAN_CASE
    x, dt, Bm, Cm, A, D = _scan_inputs(b, S, d, N, torch.float32, seed=6)
    gen = torch.Generator(device="cuda").manual_seed(7)
    h0 = _rand((b, d, N), gen)
    douts = (_rand((b, S, d), gen), _rand((b, d, N), gen))
    log(f"scan autograd function (b, S, d, N) = {TRAIN_SCAN_CASE} float32, "
        f"h0 in, h_S out:")
    before = ms.mamba_scan.launches
    outs, grads = _grads(lambda *t: ops.mamba_scan(
        *t[:6], h0=t[6], return_state=True), (x, dt, Bm, Cm, A, D, h0), douts)
    torch.cuda.synchronize()
    if ms.mamba_scan.launches != before + 1:
        raise AssertionError("the scan Function did not launch once")
    eouts, expect = _grads(lambda *t: ref.mamba_scan_ref(
        *t[:6], h0=t[6], return_state=True), (x, dt, Bm, Cm, A, D, h0), douts)
    for name, o, e in zip(("y", "h_S"), outs, eouts):
        _check(f"  {name}", o, e, SCAN_TOL[torch.float32],
               4 * SCAN_TOL[torch.float32])
    for name, g, e in zip(("dx", "ddt", "dB", "dC", "dA", "dD", "dh0"),
                          grads, expect):
        worst = max(worst, _grad_close(name, g, e, GRAD_TOL[torch.float32]))
    counts = _counts()
    q, k, v = rand_qkv(*TRAIN_FLASH_CASES[0][0][:5], torch.bfloat16, seed=4)
    qg = q.requires_grad_()
    for call in (lambda: fa.flash_attention(qg, k, v),
                 lambda: ms.mamba_scan(x.requires_grad_(), dt, Bm, Cm, A, D)):
        try:
            call()
        except RuntimeError as e:
            log(f"raw wrapper under grad raised: {e}")
        else:
            raise AssertionError("a raw wrapper ran under grad")
    if _counts() != counts:
        raise AssertionError("a refused call launched")
    return worst


# the smoke configs at a head dim of the flash kernel: tinyllama's and
# internvl2's is 8, deepseek's MLA q/k width 16 + 8 = 24
def _card_smoke(arch):
    cfg = get_smoke_config(arch)
    D = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim if cfg.mla \
        else cfg.resolved_head_dim
    if cfg.family == "ssm" or D in fa.HEAD_DIMS:
        return cfg
    if cfg.mla:
        return dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, qk_nope_dim=24))
    return dataclasses.replace(cfg, head_dim=16)


@contextlib.contextmanager
def _captured_grads():
    """Copies of the gradients a train step hands its clip (they are
    clipped in place), in the params' leaf order."""
    got = []
    clip = step_mod.clip_by_global_norm

    def capture(grads, max_norm, **kw):
        got[:] = [g.detach().clone() for g in grads]
        return clip(grads, max_norm, **kw)
    step_mod.clip_by_global_norm = capture
    try:
        yield got
    finally:
        step_mod.clip_by_global_norm = clip


def _kernel_launches():
    return fa.flash_attention.launches + ms.mamba_scan.launches


@contextlib.contextmanager
def _float32_embedding(vocab_parallel=False):
    """``T._embed_tokens`` without its final bf16 cast, so that float32
    params train in float32 throughout (as ``tests/_torch_grads.py`` runs
    them).  ``vocab_parallel``: the rows gathered by ``T._token_rows``,
    which also takes this rank's shard of the vocab."""
    embed = T._embed_tokens

    def embed_f32(cfg, p, tokens, offset=0):
        x = T._token_rows(p["embed"], tokens) if vocab_parallel \
            else p["embed"][tokens]
        if cfg.family == "encdec":
            x = x + p["pos"][offset:offset + tokens.shape[1]]
        if cfg.name.startswith("gemma"):
            x = x * cfg.d_model ** 0.5
        return x
    T._embed_tokens = embed_f32
    try:
        yield
    finally:
        T._embed_tokens = embed


def _train_step_card_vs_cpu(cfg, batch, label, seed=1,
                            dtype=torch.bfloat16):
    """One train step (lr ``TRAIN_LR``) of ``cfg`` on the card and on the
    CPU from the same params (``seed``, on the CPU; with ``dtype`` float32
    cast to float32 and trained in float32, ``_float32_embedding``) and the
    numpy ``batch``:
    the kernel launches on the card (forward and recompute: twice an
    attention or scan layer), the loss and grad norm at ``BF16_TOL``, every
    gradient leaf (relative L2) at ``GRAD_TOL[dtype]`` (the hybrid
    family's in bf16 at ``HYBRID_GRAD_TOL``), every updated param within
    2.5 lr
    plus one bf16 step of its largest value (AdamW moves an element by
    about lr, either sign where its gradient is near 0).  A MoE model's
    CPU step takes the card's expert choices (a rounding flip of one
    token's experts moves its embedding row's gradient: granite's embed
    parted by 5.9% relative L2 on its own routing).  Returns the largest
    gradient error."""
    cpu = T.init_params(cfg, seed=seed, device="cpu")
    f32 = dtype == torch.float32
    if f32:
        cpu = tree.map_tree(lambda t: t.float(), cpu)
    gpu = to_device(cpu, "cuda")
    step = make_train_step(cfg, TrainConfig(lr=TRAIN_LR, warmup=1))
    out, routes = {}, []
    for dev, params in (("cuda", gpu), ("cpu", cpu)):
        embedding = _float32_embedding() if f32 \
            else contextlib.nullcontext()
        before = _kernel_launches()
        # routing is discontinuous (``check_moe_against_cpu``): the CPU
        # takes the card's experts, call for call (forward, then the
        # recomputes in the backward's order)
        routing = contextlib.nullcontext() if cfg.moe is None else (
            _captured_routes() if dev == "cuda" else _forced_routes(routes))
        with _captured_grads() as grads, routing as recs, embedding:
            _, _, metrics = step(params, adamw_init(params),
                                 {k: torch.from_numpy(v).to(dev)
                                  for k, v in batch.items()}, 1)
        if dev == "cuda" and cfg.moe is not None:
            routes = recs
        out[dev] = (metrics, grads, _kernel_launches() - before)
    expect = 2 * (cfg.n_layers if cfg.family == "ssm" else _attn_layers(cfg))
    log(f"train step {label}: {out['cuda'][2]} kernel launches on the card "
        f"(expected {expect}: forward and recompute), loss card "
        f"{float(out['cuda'][0]['loss']):.5f} CPU "
        f"{float(out['cpu'][0]['loss']):.5f}, grad_norm card "
        f"{float(out['cuda'][0]['grad_norm']):.5f} CPU "
        f"{float(out['cpu'][0]['grad_norm']):.5f}")
    if out["cuda"][2] != expect or out["cpu"][2]:
        raise AssertionError(f"{label}: launches {out['cuda'][2]}, "
                             f"{out['cpu'][2]} on the CPU")
    for key in ("loss", "nll", "zloss", "moe_loss", "grad_norm"):
        a, b = float(out["cuda"][0][key]), float(out["cpu"][0][key])
        if not (math.isfinite(a) and abs(a - b) <= BF16_TOL * abs(b) + 1e-6):
            raise AssertionError(f"{label} {key}: card {a} CPU {b}")
    worst, name = 0.0, None
    tol = HYBRID_GRAD_TOL if cfg.family == "hybrid" and not f32 \
        else GRAD_TOL[dtype]
    for (key, _), g, e in zip(tree.flatten(cpu).items(), out["cuda"][1],
                              out["cpu"][1]):
        err = _rel_l2(g, e)
        if not err <= tol:
            raise AssertionError(f"{label} gradient {key}: relative L2 "
                                 f"{err}")
        if err >= worst:
            worst, name = err, key
    bound = 0.0
    for (key, a), b in zip(tree.flatten(gpu).items(), tree.leaves(cpu)):
        a, b = a.detach().float().cpu(), b.detach().float()
        step_tol = 2.5 * TRAIN_LR + 2 ** -8 * b.abs().max().item()
        err = (a - b).abs().max().item()
        bound = max(bound, err / step_tol)
        if err > step_tol:
            raise AssertionError(f"{label} param {key}: {err} > {step_tol}")
    log(f"  {len(out['cpu'][1])} gradient leaves within {tol} (largest "
        f"{worst:.3e}, {name}); updated "
        f"params within {100 * bound:.1f}% of their bound")
    return worst


def check_training_against_cpu():
    """Phase 42: one train step card against CPU for every arch's SMOKE
    config (``_card_smoke``'s head dims) at 2 x 32 tokens, and for
    tinyllama_1_1b cut to ``TRAIN_CUT`` layers at full width, 2 x 512
    tokens.  Then the cut trained 2 steps on the card with a checkpoint,
    resumed for a third (``launch.train.train(resume=True)``, what
    ``--resume`` runs), against 3 steps at once: the third step's loss at
    ``BF16_TOL``.  Returns the largest gradient error and the checkpoint's
    (save, restore) seconds."""
    worst = 0.0
    for arch in ARCH_IDS:
        cfg = _card_smoke(arch)
        batch = synthetic_batch(cfg, 2, 32, np.random.default_rng(3))
        worst = max(worst, _train_step_card_vs_cpu(cfg, batch,
                                                   f"{arch} SMOKE"))
        if cfg.family != "hybrid":
            continue
        # the hybrid family's bf16 bound over more seeds, and in float32,
        # where a fault of the Functions would still part card from CPU
        for seed in HYBRID_SEEDS:
            worst = max(worst, _train_step_card_vs_cpu(
                cfg, batch, f"{arch} SMOKE, params seed {seed}", seed=seed))
        for seed in HYBRID_F32_SEEDS:
            _train_step_card_vs_cpu(cfg, batch, f"{arch} SMOKE float32, "
                                    f"params seed {seed}", seed=seed,
                                    dtype=torch.float32)
    cfg = _cut("tinyllama_1_1b", TRAIN_CUT)
    B, S = TRAIN_CUT_BATCH
    worst = max(worst, _train_step_card_vs_cpu(
        cfg, synthetic_batch(cfg, B, S, np.random.default_rng(3)),
        f"tinyllama_1_1b cut to {TRAIN_CUT} layers, {B} x {S}"))
    ckpt = _build.BUILD_DIR.parent / "train_ckpt"   # git-ignored
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(batch=B, seq=S, device="cuda", seed=2, log=log)
    whole = train_launch.train(cfg, steps=3, **kw)
    t0 = time.perf_counter()
    train_launch.train(cfg, steps=2, ckpt_dir=str(ckpt), ckpt_every=100,
                       **kw)
    t1 = time.perf_counter()
    resumed = train_launch.train(cfg, steps=3, ckpt_dir=str(ckpt),
                                 resume=True, **kw)
    t2 = time.perf_counter()
    size = sum(p.stat().st_size for p in ckpt.rglob("*") if p.is_file())
    shutil.rmtree(ckpt, ignore_errors=True)
    a, b = resumed["losses"], whole["losses"]
    log(f"resume: {size / 2**30:.3f} GiB checkpoint; 2 steps + save "
        f"{t1 - t0:.2f} s, restore + 1 step {t2 - t1:.2f} s; step 2 loss "
        f"resumed {a} vs uninterrupted {b[2]:.6f} (losses {b})")
    if resumed["start"] != 2 or len(a) != 1 \
            or not abs(a[0] - b[2]) <= BF16_TOL * abs(b[2]):
        raise AssertionError(f"resumed {a} vs {b}")
    return worst


def train_full(smi):
    """Phase 43: tinyllama_1_1b at full width and depth through
    ``launch.train.train`` at ``TRAIN_FULL``; the flash counts set to 0
    just before and read just after: 2 x 22 x 2 = 88 launches a step, all
    bf16 ``wgmma`` at D 64.  Logs ms a step (steps 2-4), tok/s, peak GiB;
    then one more step profiled: the busy share and the shares of the
    flash forward, the plain attention backward, the clip and the
    optimizer.  Returns (launches by variant, ms a step, tok/s, peak GiB,
    the profiled step's device ms, its stages' device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("tinyllama_1_1b")
    kw = TRAIN_FULL
    tokens = kw["batch"] * kw["seq"]
    log(f"train: {cfg.name} full width and depth ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} of "
        f"head dim {cfg.resolved_head_dim}, vocab {cfg.vocab}, "
        f"{cfg.param_count() / 1e9:.3f} B params), seq {kw['seq']}, global "
        f"batch {kw['batch']} in {kw['microbatches']} microbatches, "
        f"{kw['steps']} steps; card memory allocated before "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    out = train_launch.train(cfg, device="cuda", seed=0, log=log, **kw)
    launches = fa.flash_attention.launches
    by_variant = dict(fa.flash_attention.launches_by_variant)
    per_step = 2 * cfg.n_layers * kw["microbatches"]
    log(f"flash_attention launches in training: {launches} ({by_variant}); "
        f"expected {per_step} a step (forward and recompute of "
        f"{cfg.n_layers} layers x {kw['microbatches']} microbatches) x "
        f"{kw['steps']} steps")
    if launches != per_step * kw["steps"] or by_variant["wgmma"] != launches:
        raise AssertionError(f"training launches {by_variant}")
    losses = out["losses"]
    if not all(math.isfinite(x) and 0 < x < 30 for x in losses):
        raise AssertionError(f"losses {losses}")
    step_ms = 1e3 * statistics.mean(out["step_s"][1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"losses {[round(x, 4) for x in losses]}; ms a step "
        f"{[round(1e3 * s, 1) for s in out['step_s']]} (steps 2-4 mean "
        f"{step_ms:.1f} ms), {tokens / step_ms * 1e3:.0f} tok/s, peak "
        f"{peak:.3f} GiB; card {smi}")
    params, opt = out["params"], out["opt"]
    step = make_train_step(cfg, TrainConfig(total_steps=kw["steps"] + 1,
                                            n_microbatches=kw["microbatches"]))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in synthetic_batch(
        cfg, kw["batch"], kw["seq"], np.random.default_rng(9)).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch, kw["steps"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    averages = prof.key_averages()
    labels = {**BWD_RANGES, **OPT_RANGES}
    events = [e for e in averages if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and e.key not in spans.NAMES]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        log("profile train step: no device time in the trace (not measured)")
        return by_variant, step_ms, tokens / step_ms * 1e3, peak, None, None
    # the profiler's own host work lengthens the profiled step's wall, so
    # the device time is also given over the unprofiled steps' mean
    log(f"profile train step: wall {wall_ms:.3f} ms, device kernels "
        f"{busy_ms:.3f} ms, busy {100 * busy_ms / wall_ms:.1f}% of the "
        f"profiled wall, {100 * busy_ms / step_ms:.1f}% of the unprofiled "
        f"steps' mean {step_ms:.1f} ms, {sum(e.count for e in events)} "
        f"device events; card {smi}")
    flash_ms = sum(e.self_device_time_total for e in events
                   if "flash_fwd_" in e.key) / 1e3
    stage_ms = {"flash forward (kernel)": flash_ms,
                **_range_ms(averages, labels)}
    _log_shares(stage_ms, busy_ms, "train step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
            f"x{e.count:<6d} {e.key[:90]}")
    return (by_variant, step_ms, tokens / step_ms * 1e3, peak, busy_ms,
            stage_ms)


def serve_windowed(smi):
    """Phase 44: gemma3_1b at full width served with
    ``PerfFlags(windowed_attention=True)`` beside the baseline.  One batch
    of ``SERVE``'s prompts, prefill and ``WINDOWED_STEPS`` decode steps fed
    the baseline's greedy tokens: the first tokens equal and the logits at
    ``BF16_TOL`` at every step (the prefill is the same flash kernel with
    its window mask either way; decode reads the window's slice of a local
    layer's cache).  Then ``SERVE`` and a profiled prefill batch and 8
    decode steps (``profile_serving``) each way: decode ms a step, tok/s,
    decode device ms a step.  Returns the windowed run's flash launches by
    variant."""
    cfg = get_config("gemma3_1b")
    params = T.init_params(cfg, seed=0, device="cuda")
    B, S = SERVE["batch"], SERVE["prompt_len"]
    tokens = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(4))
    prefill = make_prefill_step(cfg, S + WINDOWED_STEPS)
    decode = make_decode_step(cfg)
    runs, toks = {}, []
    for on in (False, True):
        dist_ctx.set_perf_flags(dist_ctx.PerfFlags(windowed_attention=on))
        logits, cache = prefill(params, {"tokens": tokens})
        steps = [logits]
        for i in range(WINDOWED_STEPS):
            if not on:
                toks.append(greedy(logits))
            _, cache, logits = decode(params, cache, toks[i], S + i)
            steps.append(logits)
        runs[on] = steps
    dist_ctx.set_perf_flags(dist_ctx.PerfFlags())
    if not torch.equal(greedy(runs[True][0]), toks[0]):
        raise AssertionError("windowed prefill's first tokens differ")
    log(f"windowed_attention on against off, gemma3_1b, {B} x {S} + "
        f"{WINDOWED_STEPS} decode steps: first tokens equal")
    for i, (a, b) in enumerate(zip(runs[True], runs[False])):
        _bf16_close(f"logits step {i}", a, b)
    measured = {}
    for on in (False, True):
        dist_ctx.set_perf_flags(dist_ctx.PerfFlags(windowed_attention=on))
        try:
            log(f"serve gemma3_1b, windowed_attention={on}:")
            torch.cuda.reset_peak_memory_stats()
            fa.reset_counts()
            stats = serve(cfg, device="cuda", seed=0, params=params,
                          log=log, **SERVE)
            by_variant = dict(fa.flash_attention.launches_by_variant)
            if fa.flash_attention.launches != cfg.n_layers * stats["batches"]:
                raise AssertionError(f"windowed={on}: {by_variant}")
            m = _log_serving(stats)
            m["busy"], m["device_ms"] = profile_serving(cfg, params, smi)
            measured[on] = m
        finally:
            dist_ctx.set_perf_flags(dist_ctx.PerfFlags())
    for on, m in measured.items():
        log(f"windowed_attention={on}: decode ms a step "
            f"{statistics.mean(m['decode_ms']):.3f} (host clock), decode "
            f"device ms a step {m['device_ms']['decode']}, prefill device ms "
            f"{m['device_ms']['prefill']}, {m['tok_s']:.1f} tok/s; card {smi}")
    del params
    torch.cuda.empty_cache()
    return by_variant


# ---------------------------------------------------------------------------
# phases 45-46: the training and cluster simulators (no kernel launches)


def _op_busy(res):
    """A priced step's busy seconds by op: the forwards (``F/``), the
    backwards (``B/``), the update (``U/``, its state transfer included),
    the rest (boundary transfers, collectives) and the host's dispatch."""
    kinds = {"F": "fwd", "B": "bwd", "U": "update"}
    out = {"fwd": 0.0, "bwd": 0.0, "update": 0.0, "other": 0.0, "host": 0.0}
    for e in res.engine.timeline.events:
        if e.kind == "idle":
            continue
        key = "host" if e.kind == "host" else kinds.get(e.name[0], "other")
        out[key] += e.duration
    return out


def _train_price_line(res, measured):
    """One priced step beside phase 43's measure: ms and tok/s with price /
    measured, and the ops' shares of the accelerator's busy time."""
    busy = _op_busy(res)
    acc = sum(v for k, v in busy.items() if k != "host")
    ms_ = 1e3 * res.step_time_s
    shares = ", ".join(f"{k} {100 * busy[k] / acc:.2f}%"
                       for k in ("fwd", "bwd", "update", "other"))
    line = (f"step {ms_:.6f} ms, {res.tokens_per_s:.1f} tok/s; {shares} of "
            f"the accelerator's {1e3 * acc:.6f} ms, host "
            f"{1e3 * busy['host']:.3f} ms")
    if measured is not None:
        dev = measured["device_ms"]
        line += (f"; price / measured: {ms_ / measured['step_ms']:.4f} of the"
                 f" step, " + (f"{ms_ / dev:.4f} of its device ms" if dev
                               else "device ms not measured"))
    return line


def price_training(measured, smi):
    """Phase 45: phase 43's step, tinyllama_1_1b at ``TRAIN_FULL``'s shape
    on one card (1 stage, 2 microbatches of 4 x 4096), priced by
    ``sim.training.simulate_training`` on one H100 at its bf16 peak (a)
    and with ``HOST_DISPATCH_S`` a dispatch (b), beside ``measured`` (phase
    43's ms a step, tok/s, profiled device ms and its stages' device ms):
    each price's ms, tok/s and fwd / bwd / update shares with price /
    measured; the float32 default ``EngineConfig()`` once; then
    ``launch.train.dry_run`` at train_4k's own global batch (``DRY_RUN``).
    Asserts finite positive prices and that a 1-stage 1-microbatch price
    equals the flat ``from_training_step`` chain through ``engine.run``
    bit for bit."""
    cfg = get_config("tinyllama_1_1b")
    kw = TRAIN_FULL
    bf16 = default_config()
    configs = (("a", bf16), ("b", dataclasses.replace(
        bf16, host_dispatch_s=HOST_DISPATCH_S)))
    log(f"training priced (engine output, not times): {cfg.name} at seq "
        f"{kw['seq']}, global batch {kw['batch']} in {kw['microbatches']} "
        f"microbatches, 1 stage; (a) one H100 at its bf16 peak "
        f"{bf16.peak_flops:.4g} flop/s, HBM {bf16.hbm_bw:.4g} B/s; (b) (a) "
        f"plus {1e6 * HOST_DISPATCH_S:g} us host dispatch an op; card {smi}")
    dev = measured["device_ms"]
    device = "not measured"
    if dev:
        device = f"{dev:.1f} ms; of it " + ", ".join(
            f"{k} {100 * v / dev:.1f}%"
            for k, v in measured["stage_ms"].items())
    log(f"  measured (phase 43): {measured['step_ms']:.1f} ms a step, "
        f"{measured['tok_s']:.0f} tok/s, a profiled step's device time "
        f"{device}")
    for label, config in configs:
        t0 = time.perf_counter()
        res = simulate_training(cfg, n_stages=1,
                                n_microbatches=kw["microbatches"],
                                seq_len=kw["seq"], global_batch=kw["batch"],
                                config=config)
        cpu_s = time.perf_counter() - t0
        log(f"  ({label}) {_train_price_line(res, measured)}; "
            f"{1e3 * cpu_s:.1f} ms CPU")
        if not (math.isfinite(res.step_time_s) and res.step_time_s > 0
                and res.tokens_per_s > 0):
            raise AssertionError(f"({label}): price {res.stats()}")
        one = simulate_training(cfg, n_stages=1, n_microbatches=1,
                                seq_len=kw["seq"], global_batch=kw["batch"],
                                config=config)
        flat = sim.run(sim.from_training_step(cfg, seq_len=kw["seq"],
                                              batch=kw["batch"]), config)
        if (one.step_time_s != flat.makespan
                or one.engine.breakdown != flat.breakdown
                or one.engine.energy != flat.energy):
            raise AssertionError(f"({label}): 1 stage, 1 microbatch "
                                 f"{one.step_time_s} != the flat chain "
                                 f"{flat.makespan}")
        log(f"  ({label}) 1 stage, 1 microbatch: {1e3 * one.step_time_s:.6f}"
            f" ms, the flat from_training_step chain through engine.run "
            f"bit for bit (makespan, breakdown, energy)")
    res = simulate_training(cfg, n_stages=1,
                            n_microbatches=kw["microbatches"],
                            seq_len=kw["seq"], global_batch=kw["batch"],
                            config=sim.EngineConfig())
    log(f"  the float32 default EngineConfig() ({hw.PEAK_FLOPS:.4g} flop/s,"
        f" the CUDA cores' float32 rate): "
        f"{_train_price_line(res, measured)}; the model trains in bf16 with "
        f"a float32 attention backward")
    out = train_launch.dry_run(emit=log, **DRY_RUN)
    for r in out:
        if not (math.isfinite(r.step_time_s) and r.step_time_s > 0):
            raise AssertionError(f"dry run: {r.stats()}")
        log(f"  dry run at train_4k's {r.meta['global_batch']} x "
            f"{r.meta['seq_len']} in {r.n_microbatches} microbatches: "
            f"{_train_price_line(r, None)}; tok/s / phase 43's measured "
            f"{r.tokens_per_s / measured['tok_s']:.4f} (microbatches of "
            f"{r.meta['global_batch'] // r.n_microbatches}, phase 43's of "
            f"{kw['batch'] // kw['microbatches']})")


def training_studies(smi):
    """Phase 46: the training and cluster studies at H100 rates.
    ``training_sweep`` over ``TRAIN_STUDY`` for ``TRAIN_STUDY_MODELS`` on
    ``TRAIN_STUDY_CONFIG`` at the bf16 peak: step ms, tok/s, bubble
    against its bound and the stages' mean utilization a cell, 1F1B over
    GPipe at the deepest pipe.  Then ``cluster_sweep`` over
    ``CLUSTER_STUDY`` for ``CLUSTER_STUDY_MODELS`` on each of
    ``CLUSTER_LAYOUTS`` at the bf16 peak: the best placement by cluster
    tok/s at each size, each algorithm's best, the cheapest placement
    under ``STEP_TARGET_S`` a step, the host seconds.  Asserts finite
    positive step times, the grid's cell counts, and that the DGX layout's
    node tier (group size 1) carries no hop."""
    config = dataclasses.replace(default_config(), **TRAIN_STUDY_CONFIG)
    log(f"training study (engine output): {TRAIN_STUDY} on hbm, 2 ports, "
        f"{1e6 * TRAIN_STUDY_CONFIG['host_dispatch_s']:g} us dispatch, one "
        f"H100 at its bf16 peak a stage; card {smi}")
    for arch in TRAIN_STUDY_MODELS:
        t0 = time.perf_counter()
        results = training_sweep(get_config(arch), base_config=config,
                                 **TRAIN_STUDY)
        cpu_s = time.perf_counter() - t0
        by_cell = {}
        for res, rec in zip(results, as_training_records(results)):
            by_cell[(res.schedule, res.n_stages, res.n_microbatches)] = res
            if not (math.isfinite(rec["step_time_s"])
                    and rec["step_time_s"] > 0):
                raise AssertionError(f"{arch} training cell {rec}")
            log(f"  {arch} {res.schedule} p={res.n_stages} "
                f"m={res.n_microbatches}: {1e3 * rec['step_time_s']:.6f} ms,"
                f" {rec['tokens_per_s']:.0f} tok/s, bubble "
                f"{rec['bubble_fraction']:.4f} (bound "
                f"{rec['bubble_bound']:.4f}), stage util "
                f"{rec['stage_util_mean']:.3f}")
        want = (len(TRAIN_STUDY["schedules"])
                * len(TRAIN_STUDY["n_stages_grid"])
                * len(TRAIN_STUDY["n_microbatches_grid"]))
        if len(results) != want:
            raise AssertionError(f"{arch}: {len(results)} training cells")
        p = max(TRAIN_STUDY["n_stages_grid"])
        m = max(TRAIN_STUDY["n_microbatches_grid"])
        g, o = by_cell[("gpipe", p, m)], by_cell[("1f1b", p, m)]
        log(f"  {arch}: 1f1b over gpipe at p={p} m={m} "
            f"{g.step_time_s / o.step_time_s:.4f}x (< 1: the shared ports "
            f"favour the flush schedule); grid {1e3 * cpu_s:.1f} ms CPU")
    dgx = hw.Fabric.cluster(64, **CLUSTER_LAYOUTS[1][1])
    k = dgx.leaves_per_group()[0]
    B = 256e6
    t = sim.collective_time("all_reduce", B, 64, dgx, algo="hierarchical",
                            config=default_config())
    closed = (2.0 * (k - 1) * (hw.ICI_LAT_S + B / k / hw.ICI_BW)
              + 2.0 * (64 // k - 1) * (hw.INTER_LAT_S
                                       + B / 64 / hw.INTER_BW))
    if (dgx.describe() != "8ici x 1node x 8inter"
            or dgx.span_tier(range(k)) != 0 or dgx.span_tier((0, k)) != 2
            or abs(t - closed) > 1e-12 * closed):
        raise AssertionError(f"DGX layout {dgx.describe()}: hierarchical "
                             f"{t} against {closed}")
    log(f"DGX layout {dgx.describe()}: a node's 8 GPUs span the NVSwitch "
        f"tier, two nodes the InfiniBand tier, the node tier of 1 nothing; "
        f"hierarchical all-reduce of {B:.4g} B over 64 GPUs "
        f"{1e3 * t:.6f} ms, the per-tier closed form {1e3 * closed:.6f} ms")
    log(f"cluster study (engine output): {CLUSTER_STUDY}, 1f1b, one H100 "
        f"at its bf16 peak a GPU; NVLink {hw.ICI_BW:.4g} B/s, InfiniBand "
        f"{hw.INTER_BW:.4g} B/s a port (data sheets); hop latencies NVLink "
        f"{1e6 * hw.ICI_LAT_S:g} / {1e6 * hw.NODE_LAT_S:g} us and "
        f"InfiniBand {1e6 * hw.INTER_LAT_S:g} us are estimates "
        f"(sim/hw.py), not measured; TCO the JAX package's model "
        f"(${hw.ACCEL_COST_USD:,.0f} a GPU over 3 years, "
        f"${hw.USD_PER_KWH:g}/kWh), not an H100 price; card {smi}")
    for layout, fab_kw in CLUSTER_LAYOUTS:
        for arch in CLUSTER_STUDY_MODELS:
            t0 = time.perf_counter()
            results = cluster_sweep(get_config(arch),
                                    base_config=default_config(),
                                    **CLUSTER_STUDY, **fab_kw)
            rows = as_cluster_records(results)
            cpu_s = time.perf_counter() - t0
            if fab_kw and any(op.tier == "node" for r in results
                              for op in r.program.ops):
                raise AssertionError(f"{layout}: a hop on the node tier")
            bad = [r for r in rows if not (math.isfinite(r["step_time_s"])
                                           and r["step_time_s"] > 0)]
            if bad or not rows:
                raise AssertionError(f"{arch} {layout}: {len(rows)} cells, "
                                     f"bad {bad[:1]}")
            log(f"  {layout}, {arch}: {len(rows)} cells in {cpu_s:.3f} s "
                f"host CPU")
            for n in CLUSTER_STUDY["n_accel_grid"]:
                at_n = [r for r in rows if r["n_accel"] == n]
                best = max(at_n, key=lambda r: r["cluster_tokens_per_s"])
                algos = {a: max(r["cluster_tokens_per_s"] for r in at_n
                                if r["collective_algo"] == a)
                         for a in CLUSTER_STUDY["algos"]}
                log(f"    {n} GPUs ({best['fabric']}): best dp"
                    f"{best['dp_degree']} x pp{best['pp_degree']} x tp"
                    f"{best['tp_degree']} {best['collective_algo']}: "
                    f"{1e3 * best['step_time_s']:.6f} ms a step, "
                    f"{best['cluster_tokens_per_s']:.0f} tok/s, "
                    f"${best['tco_usd_per_mtok']:.6f}/Mtok; best tok/s by "
                    f"algorithm "
                    + ", ".join(f"{a} {v:.0f}" for a, v in algos.items()))
            fast = [r for r in rows if r["step_time_s"] <= STEP_TARGET_S]
            if fast:
                c = min(fast, key=lambda r: r["tco_usd_per_step"])
                log(f"    cheapest under {STEP_TARGET_S:g} s a step: "
                    f"{c['n_accel']} GPUs dp{c['dp_degree']} x pp"
                    f"{c['pp_degree']} x tp{c['tp_degree']} "
                    f"{c['collective_algo']}: "
                    f"{1e3 * c['step_time_s']:.6f} ms, "
                    f"${c['tco_usd_per_step']:.6f} a step")
            else:
                log(f"    no placement under {STEP_TARGET_S:g} s a step")


# ---------------------------------------------------------------------------
# phases 47-48: distribution


def check_nccl_world1(smi):
    """Phase 47: the NCCL path at world size 1.  A world-1 NCCL group and
    ``make_host_mesh(1, 1)`` on the card; ``launch.train``'s smoke path
    (tinyllama_1_1b's SMOKE at a kernel head dim, batch 4 x 64,
    ``NCCL_STEPS`` steps) on the mesh with ``rules_for``'s rules installed
    (``train.installed``) against the same run with no mesh: losses and
    params bit for bit, 2 flash launches a layer a step each way;
    ``pipeline_apply`` on a 1-stage mesh against its sequential run; a
    checkpoint restored onto the mesh with the rules' placements, and a
    checkpoint of those DTensor leaves, leaf for leaf equal; ``--multi-pod``
    raising the reference's RuntimeError.  The group is destroyed after.
    The port's collectives skip a mesh dimension of size 1, as the
    reference's do, so none of them reaches NCCL at world 1: a raw
    ``all_reduce`` and ``broadcast`` over each dimension's group show that
    the groups run; the port's reductions cross ranks in phase 48 (gloo)
    and in the CPU tests."""
    if dist.is_initialized():
        raise AssertionError("a process group is already up")
    t0 = time.perf_counter()
    cfg = _card_smoke("tinyllama_1_1b")
    shape = SHAPE_BY_NAME["train_4k"]
    kw = dict(batch=4, seq=64, steps=NCCL_STEPS, device="cuda",
              log=lambda *a: None)
    runs = {}
    mesh = make_host_mesh(1, 1, device_type="cuda")
    try:
        backend = dist.get_backend()
        for name in mesh.mesh_dim_names:
            group = mesh.get_group(name)
            x = torch.arange(4096, dtype=torch.float32, device="cuda")
            y = x.clone()
            dist.all_reduce(y, group=group)
            dist.broadcast(y, src=0, group=group)
            torch.cuda.synchronize()
            if not torch.equal(x, y):
                raise AssertionError(f"phase 47: NCCL over {name!r} changed "
                                     f"a world-1 tensor")
        log(f"phase 47: {backend} all_reduce and broadcast over each of "
            f"{mesh.mesh_dim_names}'s groups at world 1: tensor unchanged "
            f"(the port's own collectives skip a dimension of size 1)")
        for label, m in (("no mesh", None), ("mesh", mesh)):
            before = fa.flash_attention.launches
            with train_launch.installed(m, cfg, shape):
                runs[label] = train_launch.train(cfg, **kw)
            torch.cuda.synchronize()
            runs[label]["launches"] = fa.flash_attention.launches - before
        alone, on_mesh = runs["no mesh"], runs["mesh"]
        expect = 2 * cfg.n_layers * NCCL_STEPS
        log(f"phase 47: {backend} world {dist.get_world_size()}, mesh "
            f"{mesh}; smoke losses no mesh {alone['losses']}, on the mesh "
            f"{on_mesh['losses']}; flash launches {alone['launches']}, "
            f"{on_mesh['launches']} (expected {expect}); card {smi}")
        if backend != "nccl" or on_mesh["losses"] != alone["losses"] \
                or not all(torch.equal(a, b) for a, b in zip(
                    tree.leaves(on_mesh["params"]),
                    tree.leaves(alone["params"]))) \
                or not alone["launches"] == on_mesh["launches"] == expect:
            raise AssertionError("phase 47: the mesh run parted from the "
                                 "no-mesh run")
        stage_mesh = init_device_mesh("cuda", (1,),
                                      mesh_dim_names=("stage",))
        gen = torch.Generator(device="cuda").manual_seed(4)
        w = torch.randn(1024, 1024, generator=gen, device="cuda") / 32
        x = torch.randn(64, 1024, generator=gen, device="cuda")
        piped = pipeline_apply(stage_mesh, _tanh_stage, w, x, 4)
        err = (piped - _tanh_stage(w, x)).abs().max().item()
        log(f"phase 47: 1-stage pipeline, 4 microbatches of 16 x 1024, "
            f"against sequential: max_abs_err {err:.3e} (limit 1e-5)")
        if not err <= 1e-5:
            raise AssertionError(f"phase 47: pipeline {err}")
        ckpt = _build.BUILD_DIR.parent / "mesh_ckpt"   # git-ignored
        shutil.rmtree(ckpt, ignore_errors=True)
        params = alone["params"]
        placements = rules_for(cfg, shape, mesh).tree_shardings(
            T.param_axes(cfg), params)
        save_checkpoint(str(ckpt), 1, params)
        restored = load_checkpoint(str(ckpt), template=params,
                                   shardings=placements, mesh=mesh)["tree"]
        save_checkpoint(str(ckpt), 2, restored)      # DTensor leaves
        again = load_checkpoint(str(ckpt), template=params)["tree"]
        shutil.rmtree(ckpt, ignore_errors=True)
        leaves = list(zip(tree.leaves(restored), tree.leaves(again),
                          tree.leaves(params)))
        if not all(a.device_mesh == mesh and torch.equal(a.to_local(), c)
                   and torch.equal(b, c) for a, b, c in leaves):
            raise AssertionError("phase 47: the checkpoint restored onto "
                                 "the mesh differs")
        log(f"phase 47: checkpoint of {len(leaves)} leaves restored onto "
            f"the mesh with the rules' placements "
            f"({tree.leaves(restored)[0].placements}), saved from DTensor "
            f"leaves and reloaded: every leaf equal")
        try:
            train_launch.main(["--multi-pod"])
        except RuntimeError as e:
            if "512" not in str(e):
                raise
            log(f"phase 47: --multi-pod raises RuntimeError: {e}")
        else:
            raise AssertionError("phase 47: --multi-pod did not raise")
    finally:
        dist.destroy_process_group()
    log(f"phase 47: {time.perf_counter() - t0:.1f} s")


def _tanh_stage(w, x):
    return torch.tanh(x @ w)


def _rank_main(rank, world, store, out_dir, smi, single_ms):
    """A phase-48 rank: the gloo group on a ``FileStore``, then
    ``_rank_phases``; what it returns is pickled to ``out_dir``."""
    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        out = _rank_phases(rank, world, smi, single_ms)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(smi, single_ms):
    """Phase 48: ``EP_RANKS`` ranks spawned on the one card (spawn start
    method, a gloo group on a ``FileStore`` in a temp dir); each runs
    ``_rank_phases``.  A rank that fails, or is still running after
    ``RANK_TIMEOUT_S``, fails the phase; every rank is stopped before
    this returns.  Returns the ranks' results in rank order."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(EP_RANKS, os.path.join(tmp, "store"), tmp, smi,
                              single_ms),
            nprocs=EP_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 48: ranks still running "
                                         f"after {RANK_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(30)
        out = []
        for rank in range(EP_RANKS):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    log(f"phase 48: {EP_RANKS} ranks in {time.perf_counter() - t0:.1f} s")
    return out


def _in_turn(rank, world, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier, so
    that it runs alone on the card; returns this rank's result."""
    out = None
    for r in range(world):
        if r == rank:
            out = fn()
            torch.cuda.synchronize()
        dist.barrier()
    return out


def _median_ms(fn, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


@contextlib.contextmanager
def _timed_collectives():
    """Host ms of every ``all_reduce``, ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` in the block, the card synchronized before
    and after each: {"ms": total, "calls": n, "by_kind": {name: ms}}."""
    spent = {"ms": 0.0, "calls": 0, "by_kind": {}}
    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
    saved = {n: getattr(dist, n) for n in names}

    def timed(name):
        def fn(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*args, **kw)
            torch.cuda.synchronize()
            ms_ = 1e3 * (time.perf_counter() - t0)
            spent["ms"] += ms_
            spent["calls"] += 1
            spent["by_kind"][name] = spent["by_kind"].get(name, 0.0) + ms_
            return out
        return fn
    for n in names:
        setattr(dist, n, timed(n))
    try:
        yield spent
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


@contextlib.contextmanager
def _captured_moe():
    """Keeps, for each call of ``moe_mod.moe_apply`` in the block, its
    input, its output and the expert indices its router chose."""
    records, apply = [], moe_mod.moe_apply

    def capture(p, x, cfg, dispatch=None):
        with _captured_routes() as routes:
            out, aux = apply(p, x, cfg, dispatch)
        records.append((x, out, routes[-1][2]))
        return out, aux
    moe_mod.moe_apply = capture
    try:
        yield records
    finally:
        moe_mod.moe_apply = apply


def _rank_phases(rank, world, smi, single_ms):
    """Phases 48 to 50 on one rank: (48a) the EP prefill, (48b) the
    data-parallel step, (48c) the TP MLP; (49a) the train step over
    ``model`` on the cuts, (49b) on tinyllama_1_1b at full width and depth;
    (50) the serving steps over ``model``.  Returns their numbers."""
    out = {"rank": rank}
    out.update(_ep_prefill(rank, world, smi, single_ms))
    out.update(_dp_step(rank, world, smi))
    out.update(_tp_mlp(rank, world, smi))
    torch.cuda.empty_cache()
    out.update(_tp_cuts(rank, world, smi))
    torch.cuda.empty_cache()
    out.update(_tp_full(rank, world, smi))
    torch.cuda.empty_cache()
    out.update(_serve_tp(rank, world, smi))
    return out


def _ep_prefill(rank, world, smi, single_ms):
    """48a: granite_moe_1b_a400m at full width and depth (params from seed
    0 made on the card: the same on both ranks), a prefill of ``SERVE``'s
    batch of prompts through ``make_prefill_step`` (phase 30's path),
    first as one process (no mesh; each MoE layer's input, output and
    experts kept), then on mesh (data 1, model world): the MoE on expert
    parallelism, ``n_experts / world`` experts a rank.  Each MoE layer on
    EP fed the single-process run's input to it must choose the same
    experts and agree within ``BF16_TOL``; the whole EP prefill runs the
    flash kernel once a layer (counts set to 0 just before, read just
    after), its logits and expert choices are logged against the single
    process's.  Then the EP prefill timed (median of ``EP_TIMED``), and
    once more with each ``all_reduce`` timed."""
    cfg = get_config(EP_ARCH)
    e = cfg.moe
    B, S = SERVE["batch"], SERVE["prompt_len"]
    params = T.init_params(cfg, seed=0, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)), device="cuda")
    batch = prefill_inputs(cfg, tokens)
    prefill = make_prefill_step(cfg, S + SERVE["max_new"])
    mesh = make_host_mesh(1, world, device_type="cuda")
    with torch.inference_mode():
        with _captured_moe() as single:
            ref_logits, _ = prefill(params, batch)
        alone_ms = _in_turn(rank, world,
                            lambda: _median_ms(lambda: prefill(params, batch),
                                               EP_TIMED))
        dist_ctx.set_mesh(mesh)
        try:
            worst, same = 0.0, True
            for i, (x, expect, idx) in enumerate(single):
                with _captured_routes() as routes:
                    got, _ = moe_mod.moe_apply(params["layers"][i]["moe"],
                                               x, cfg)
                diff = (got.float() - expect.float()).abs()
                scale = expect.float().abs().max().item()
                ok = bool((diff <= BF16_TOL * scale
                           + BF16_TOL * expect.float().abs()).all())
                worst = max(worst, diff.max().item() / scale)
                same &= torch.equal(routes[-1][2], idx)
                if not ok:
                    raise AssertionError(f"48a rank {rank}: MoE layer {i} on "
                                         f"EP off the single process by "
                                         f"{diff.max().item()}")
            if not same:
                raise AssertionError(f"48a rank {rank}: an MoE layer on EP "
                                     f"chose other experts on the single "
                                     f"process's input")
            fa.reset_counts()
            with _captured_moe() as ep:
                ep_logits, _ = prefill(params, batch)
            torch.cuda.synchronize()
            launches = fa.flash_attention.launches
            by_variant = dict(fa.flash_attention.launches_by_variant)
            name = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
            if launches != cfg.n_layers or by_variant[name] != cfg.n_layers:
                raise AssertionError(f"48a rank {rank}: flash launches "
                                     f"{by_variant}, expected {cfg.n_layers} "
                                     f"of {name}")
            ep_ms = _median_ms(lambda: prefill(params, batch), EP_TIMED)
            with _timed_collectives() as spent:
                timed_ms = _median_ms(lambda: prefill(params, batch), 1)
        finally:
            dist_ctx.set_mesh(None)
    agree = _agreement((a[2], b[2]) for a, b in zip(single, ep))
    logit_err = (ep_logits.float() - ref_logits.float()).abs().max().item()
    logit_scale = ref_logits.float().abs().max().item()
    if not bool(torch.isfinite(ep_logits).all()):
        raise AssertionError(f"48a rank {rank}: non-finite logits")
    log(f"[rank {rank}] 48a: {cfg.name} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {e.n_experts} experts top-{e.top_k}, "
        f"{e.n_experts // world} a rank) prefill {B} x {S} on mesh {mesh}: "
        f"each MoE layer fed the single process's input chose its experts "
        f"and agrees within {BF16_TOL} (largest {worst:.3e} of max |out|); "
        f"flash {by_variant}; whole prefill: logits max_abs_err "
        f"{logit_err:.3e} (max |logit| {logit_scale:.3e}), "
        f"{100 * agree[0]:.4f}% of {agree[2]} expert indices and "
        f"{100 * agree[1]:.4f}% of token expert sets equal the single "
        f"process's; EP prefill {ep_ms:.3f} ms (median of {EP_TIMED}), "
        f"alone as one process {alone_ms:.3f} ms (phase 30: "
        f"{single_ms:.3f}); {spent['calls']} all_reduce calls "
        f"{spent['ms']:.3f} ms over gloo of a {timed_ms:.3f} ms prefill "
        f"timed with them (each call synchronized); card {smi}")
    if rank == 0 and agree[1] < 1.0:
        _log_flips(cfg, [(x.float().reshape(-1, cfg.d_model).cpu(),
                          params["layers"][i]["moe"]["router"].cpu(),
                          idx.cpu()) for i, (x, _, idx) in enumerate(single)],
                   ep, names=("single-process", "EP"))
    return {"ep_launches": launches, "ep_by_variant": by_variant,
            "ep_ms": ep_ms, "ep_alone_ms": alone_ms,
            "ep_all_reduce_ms": spent["ms"], "ep_timed_ms": timed_ms,
            "ep_all_reduce_calls": spent["calls"], "ep_layer_err": worst,
            "ep_logit_err": logit_err, "ep_logit_scale": logit_scale,
            "ep_index_agreement": agree[0], "ep_set_agreement": agree[1]}


def _step_state(cfg, params, batch):
    """One train step (lr ``TRAIN_LR``, warmup 1) of ``params`` (in place;
    plain tensors, or on a ``model`` axis the rules' DTensors; float32
    ones train in float32, ``_float32_embedding``) on ``batch``: (metrics
    as floats, the gradients handed to the clip, the optimizer state after
    it, the step's ms)."""
    step = make_train_step(cfg, TrainConfig(lr=TRAIN_LR, warmup=1))
    opt = adamw_init(params)
    embedding = _float32_embedding() \
        if params["embed"].dtype == torch.float32 \
        else contextlib.nullcontext()
    with _captured_grads() as grads, embedding:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = step(params, opt, batch, 1)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    return {k: float(v) for k, v in metrics.items()}, list(grads), opt, ms


def _dp_step(rank, world, smi):
    """48b: tinyllama_1_1b cut to ``TRAIN_CUT`` layers at full width, the
    global batch ``TRAIN_CUT_BATCH`` (one sequence a rank): a train step
    on mesh (data world, model 1) with ``rules_for``'s rules, each rank
    taking its sequence, against one process on the whole batch (run
    alone on the card, in turn): loss and grad norm at ``BF16_TOL``, every
    gradient leaf at relative L2 3e-2 in bf16; all at 1e-4 in float32
    (phase 42's bounds).  Each step's ms, and the DP step's all-reduce
    ms."""
    cfg = _cut("tinyllama_1_1b", TRAIN_CUT)
    Bg, Sg = TRAIN_CUT_BATCH
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in synthetic_batch(
        cfg, Bg, Sg, np.random.default_rng(3)).items()}
    params = T.init_params(cfg, seed=1, device="cuda")
    mesh = make_host_mesh(world, 1, device_type="cuda")
    _step_state(cfg, tree.map_tree(torch.clone, params), batch)  # warm
    out, failed = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        def copy():
            return tree.map_tree(
                lambda t: t.to(dtype, copy=True) if dtype == torch.float32
                else t.clone(), params)
        single = _in_turn(rank, world, lambda: _step_state(
            cfg, copy(), batch))
        dp_params = copy()
        with train_launch.installed(mesh, cfg, SHAPE_BY_NAME["train_4k"]), \
                _timed_collectives() as spent:
            got = _step_state(cfg, dp_params, batch)
        tol, grad_tol = (BF16_TOL, GRAD_TOL[dtype]) \
            if dtype == torch.bfloat16 else (GRAD_TOL[dtype],) * 2
        for key in ("loss", "nll", "zloss", "moe_loss", "grad_norm"):
            a, b = got[0][key], single[0][key]
            if not (math.isfinite(a) and abs(a - b) <= tol * abs(b) + 1e-6):
                failed.append(f"48b rank {rank} {dtype} {key}: DP {a} one "
                              f"process {b}")
        errs = {key: _rel_l2(g, e_) for key, g, e_ in
                zip(tree.flatten(params), got[1], single[1])}
        worst = max(errs.values())
        label = str(dtype)[6:]
        over = {k: f"{v:.3e}" for k, v in errs.items() if not v <= grad_tol}
        if over:
            failed.append(f"48b rank {rank} {label}: gradient leaves over "
                          f"{grad_tol}: {over}")
        log(f"[rank {rank}] 48b {label}: {cfg.name} cut to {cfg.n_layers} "
            f"layers, global batch {Bg} x {Sg} on mesh {mesh}: loss DP "
            f"{got[0]['loss']:.6f} one process {single[0]['loss']:.6f}, "
            f"grad_norm {got[0]['grad_norm']:.6f} / "
            f"{single[0]['grad_norm']:.6f}, {len(got[1])} gradient leaves "
            f"within {grad_tol} (largest {worst:.3e}); step ms DP "
            f"{got[3]:.1f} (all_reduce {spent['ms']:.1f} ms in "
            f"{spent['calls']} calls over gloo), one process alone "
            f"{single[3]:.1f}; card {smi}")
        out[f"dp_{label}"] = {"ms": got[3], "alone_ms": single[3],
                              "all_reduce_ms": spent["ms"],
                              "grad_err": worst}
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def _tp_mlp(rank, world, smi):
    """48c: gemma3_1b's MLP (d 1152, d_ff 6912, geglu) with d_ff split over
    the ``model`` ranks of mesh (1, world), each slice marked as the rank's
    shard, inside a region that binds ``model`` (``tp_project``
    all-reduces the down projection), against
    the unsplit MLP on 4 x 1024 tokens, in bf16 (the model's type) and
    float32, with ``bf16_tp_collectives`` off and on: at ``BF16_TOL``,
    float32 with the flag off at 1e-4."""
    cfg = get_config(TP_ARCH)
    d, f = cfg.d_model, cfg.d_ff
    n = f // world
    part = slice(rank * n, (rank + 1) * n)
    mesh = make_host_mesh(1, world, device_type="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    mlp = mlp_init(gen, d, f, cfg.activation)
    x = torch.randn(*TP_TOKENS, d, generator=gen, device="cuda")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        full = {k: v.to(dtype) for k, v in mlp.items()}
        # this rank's d_ff shards, marked so (``dist.tp.mark_shard``)
        local = {"up": mark_shard(full["up"][:, part], 1),
                 "gate": mark_shard(full["gate"][:, part], 1),
                 "down": mark_shard(full["down"][part], 0)}
        xd = x.to(dtype)
        expect = mlp_apply(full, xd, cfg.activation).float()
        scale = expect.abs().max().item()
        for flag in (False, True):
            dist_ctx.set_perf_flags(dist_ctx.PerfFlags(
                bf16_tp_collectives=flag))
            dist_ctx.set_mesh(mesh)
            try:
                with dist_ctx.bound_axes("model"):
                    got = mlp_apply(local, xd, cfg.activation).float()
                    ms = _median_ms(
                        lambda: mlp_apply(local, xd, cfg.activation), 5)
            finally:
                dist_ctx.set_mesh(None)
                dist_ctx.set_perf_flags(dist_ctx.PerfFlags())
            tol = 1e-4 if dtype == torch.float32 and not flag else BF16_TOL
            err = (got - expect).abs().max().item()
            label = f"{str(dtype)[6:]}, bf16_tp_collectives {flag}"
            log(f"[rank {rank}] 48c {label}: {TP_ARCH} MLP d {d} d_ff {f} "
                f"({n} a rank) on {TP_TOKENS} tokens against the unsplit "
                f"MLP: max_abs_err {err:.3e} (max |out| {scale:.3e}, limit "
                f"{tol} of it); {ms:.3f} ms with the all-reduce; card {smi}")
            if not err <= tol * scale:
                raise AssertionError(f"48c rank {rank} {label}: {err}")
            out[f"tp {label}"] = {"err": err, "ms": ms}
    return out


def _adamw_first_step(old, m, v, lr, weight_decay=0.1, b1=0.9, b2=0.95,
                      eps=1e-8):
    """``old`` after AdamW's first step (count 1) from its moments after
    that step, in ``optim.adamw_update``'s operations
    (``tests/_torch_dist.py::adamw_first_step``)."""
    c = torch.ones((), device=old.device)
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    p32 = old.float()
    step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
    return (p32 - lr * step).to(old.dtype)


def _hold_shards(label, one, got, dims, index, n, before):
    """The TP step's local shards (``got`` = metrics, gradients, {key:
    param}, {key: m}, {key: v}) against one process's (``one`` = metrics,
    gradients, updated params, opt; ``before`` its params before the step)
    sliced to this rank's ``index`` of ``n`` along each leaf's split
    dimension (``dims``): the metrics at ``BF16_TOL``, every gradient,
    ``m`` and sqrt(``v``) at relative L2 ``GRAD_TOL`` in bf16, every
    updated param within one step of its dtype of AdamW's first step from
    the rank's own ``m`` and ``v`` (``_adamw_first_step``: a missed or
    sign-flipped update is off by lr or 2 lr) and within 2.5 lr plus one
    bf16 step of its largest value of one process's (phase 42's bound),
    and each split leaf held as its shard only.  Returns (failures, the
    largest leaf error and its key)."""
    failed = []
    tol = GRAD_TOL[torch.bfloat16]
    for key in ("loss", "nll", "zloss", "moe_loss", "grad_norm"):
        a, b = got[0][key], one[0][key]
        if not (math.isfinite(a) and abs(a - b) <= BF16_TOL * abs(b) + 1e-6):
            failed.append(f"{label} {key}: TP {a} one process {b}")
    m, v = tree.flatten(one[3]["m"]), tree.flatten(one[3]["v"])
    before = tree.flatten(before)
    worst, name = 0.0, None
    for (key, full), g, ge in zip(tree.flatten(one[2]).items(), got[1],
                                  one[1]):
        d = dims[key]

        def mine(t):
            return t if d is None else t.narrow(d, index * t.shape[d] // n,
                                                t.shape[d] // n)
        local = got[2][key]
        if local.shape != mine(full).shape or (
                d is not None and local.shape[d] * n != full.shape[d]):
            failed.append(f"{label} {key}: shard {tuple(local.shape)} of "
                          f"{tuple(full.shape)}")
            continue
        err = max(_rel_l2(g, mine(ge)), _rel_l2(got[3][key], mine(m[key])),
                  _rel_l2(got[4][key].sqrt(), mine(v[key]).sqrt()))
        if not err <= tol:
            failed.append(f"{label} {key}: relative L2 {err:.3e}")
        if err >= worst:
            worst, name = err, key
        stepped = _adamw_first_step(mine(before[key]), got[3][key],
                                    got[4][key], TRAIN_LR).float()
        off = ((local.float() - stepped).abs()
               - torch.finfo(local.dtype).eps * stepped.abs()
               - 1e-6 * TRAIN_LR).max().item()
        if not off <= 0:
            failed.append(f"{label} {key}: updated param off AdamW's step "
                          f"from its moments by {off} beyond one step")
        expect = mine(full).detach().float()
        bound = 2.5 * TRAIN_LR + 2 ** -8 * expect.abs().max().item()
        if not (local.float() - expect).abs().max().item() <= bound:
            failed.append(f"{label} {key}: updated param off by more than "
                          f"{bound}")
    return failed, worst, name


def _tp_cuts(rank, world, smi):
    """49a: ``TP_CUTS`` each cut to ``TRAIN_CUT`` layers at full width,
    global batch ``TRAIN_CUT_BATCH``, params from seed 1 made on the card
    (the same on both ranks): one process's bf16 train step on the whole
    batch (alone on the card, in turn), then the step on mesh (data 1,
    model world) with ``rules_for``'s rules, the params placed by them as
    DTensors: every leaf's shard against one process's slice
    (``_hold_shards``).  The kernel counts set to 0 just before the TP step
    and read just after: tinyllama's flash at D 64 on 16 query heads of 2
    KV heads a rank, falcon's scan on 4096 of its 8192 channels a rank,
    each twice a layer (forward and recompute)."""
    out, failed = {}, []
    mesh = make_host_mesh(1, world, device_type="cuda")
    for arch in TP_CUTS:
        cfg = _cut(arch, TRAIN_CUT)
        Bg, Sg = TRAIN_CUT_BATCH
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in
                 synthetic_batch(cfg, Bg, Sg, np.random.default_rng(3)).items()}
        params = T.init_params(cfg, seed=1, device="cuda")

        def one_step():
            p = tree.map_tree(torch.clone, params)
            metrics, grads, opt, _ = _step_state(cfg, p, batch)
            return metrics, grads, p, opt
        one = _in_turn(rank, world, one_step)
        with train_launch.installed(mesh, cfg, SHAPE_BY_NAME["train_4k"]):
            rules = sharding.active_rules()
            placements = rules.tree_shardings(T.param_axes(cfg), params)
            dparams = sharding.distribute(params, placements, mesh)
            fa.reset_counts()
            ms.mamba_scan.launches = 0
            metrics, grads, opt, step_ms = _step_state(cfg, dparams, batch)
            launches = {"flash_attention": fa.flash_attention.launches,
                        "flash_by_variant": dict(
                            fa.flash_attention.launches_by_variant),
                        "mamba_scan": ms.mamba_scan.launches}
            local = {k: tree.flatten(sharding.local_shards(t))
                     for k, t in (("p", dparams), ("m", opt["m"]),
                                  ("v", opt["v"]))}
            index = dist_ctx.model_rank()
        dims = {k: sharding.sharded_dim(pl, "model", mesh) for k, pl in
                tree.flatten(placements, containers=list).items()}
        kernel = "mamba_scan" if cfg.family == "ssm" else "flash_attention"
        expect = 2 * cfg.n_layers
        if launches[kernel] != expect:
            failed.append(f"49a rank {rank} {arch}: {launches}, expected "
                          f"{expect} {kernel}")
        bad, worst, name = _hold_shards(
            f"49a rank {rank} {arch}", one, (metrics, grads, local["p"],
                                             local["m"], local["v"]),
            dims, index, world, params)
        failed += bad
        split = sum(d is not None for d in dims.values())
        heads = cfg.n_heads // world if cfg.family != "ssm" else None
        log(f"[rank {rank}] 49a {cfg.name} cut to {cfg.n_layers} layers at "
            f"full width, global batch {Bg} x {Sg} on mesh {mesh}: {split} of "
            f"{len(dims)} leaves split over model; loss TP "
            f"{metrics['loss']:.6f} one process {one[0]['loss']:.6f}, "
            f"grad_norm {metrics['grad_norm']:.6f} / "
            f"{one[0]['grad_norm']:.6f}; every leaf's gradient, m and "
            f"sqrt(v) within {GRAD_TOL[torch.bfloat16]} (largest "
            f"{worst:.3e}, {name}); kernels {launches} "
            + (f"(flash at {heads} query heads on "
               f"{cfg.n_kv_heads // world} KV heads of D "
               f"{cfg.resolved_head_dim})" if heads else
               f"(the scan on {cfg.ssm.expand * cfg.d_model // world} "
               f"channels)")
            + f"; step ms TP {step_ms:.1f}; card {smi}")
        out[f"tp_cut {arch}"] = {"launches": launches, "grad_err": worst,
                                 "ms": step_ms}
        del params, dparams, one, opt, grads, local
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def _tp_full(rank, world, smi):
    """49b: tinyllama_1_1b at full width and depth, ``TP_FULL`` (train_4k's
    seq, a global batch of 2), through ``launch.train.train`` (params from
    seed 0, the data pipeline's batches): first one process alone on the
    card (rank 0; rank 1 waits), then on mesh (data 1, model world) with
    ``rules_for``'s rules installed, where ``train`` places the params and
    moments by the rules.  Each: ms a step (steps 2 on, synced), peak GiB,
    the losses (TP within ``BF16_TOL`` of one process's).  The flash counts
    set to 0 just before the TP run and read just after: 2 x 22 a step a
    rank, all ``wgmma`` at D 64 on 16 query heads of 2 KV heads.  Then one
    more TP step with every collective timed (each synchronized): their
    share of that step, and its peak GiB a rank alone (the peak counter
    reset after the placement and the first steps)."""
    cfg = get_config("tinyllama_1_1b")
    kw = dict(TP_FULL, device="cuda", seed=0, log=lambda *a: None)
    tokens = kw["batch"] * kw["seq"]
    alone = [None]
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        res = train_launch.train(cfg, **kw)
        alone[0] = {"ms": 1e3 * statistics.mean(res["step_s"][1:]),
                    "step_ms": [1e3 * x for x in res["step_s"]],
                    "gib": torch.cuda.max_memory_allocated() / 2**30,
                    "losses": res["losses"]}
        del res
        torch.cuda.empty_cache()
    dist.barrier()
    dist.broadcast_object_list(alone, src=0)
    alone = alone[0]
    mesh = make_host_mesh(1, world, device_type="cuda")
    torch.cuda.reset_peak_memory_stats()
    with train_launch.installed(mesh, cfg, SHAPE_BY_NAME["train_4k"]):
        fa.reset_counts()
        res = train_launch.train(cfg, **kw)
        launches = fa.flash_attention.launches
        by_variant = dict(fa.flash_attention.launches_by_variant)
        step_ms = 1e3 * statistics.mean(res["step_s"][1:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        step = make_train_step(cfg, TrainConfig(total_steps=kw["steps"] + 1))
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in
                 synthetic_batch(cfg, kw["batch"], kw["seq"],
                                 np.random.default_rng(9)).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _timed_collectives() as spent:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(res["params"], res["opt"], batch, kw["steps"])
            torch.cuda.synchronize()
            timed_ms = 1e3 * (time.perf_counter() - t0)
        step_peak = torch.cuda.max_memory_allocated() / 2**30
        local = sum(t.to_local().numel() for t in tree.leaves(res["params"]))
    expect = 2 * cfg.n_layers * kw["steps"]
    name = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    losses = res["losses"]
    off = max(abs(a - b) / abs(b) for a, b in zip(losses, alone["losses"]))
    log(f"[rank {rank}] 49b {cfg.name} full width and depth "
        f"({cfg.n_layers} layers, {cfg.param_count() / 1e9:.3f} B params, "
        f"{local / 1e6:.1f} M on this rank), {kw['batch']} x {kw['seq']} "
        f"tokens on mesh {mesh}, {kw['steps']} steps: ms a step "
        f"{[round(1e3 * x, 1) for x in res['step_s']]} (steps "
        f"2-{kw['steps']} mean "
        f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tok/s), peak "
        f"{peak:.3f} GiB a rank over the run (placement and steps), "
        f"{step_peak:.3f} GiB over one step, flash {by_variant} ({launches}, expected "
        f"{expect}); one process alone at the same batch: "
        f"{[round(x, 1) for x in alone['step_ms']]} (mean {alone['ms']:.1f} "
        f"ms), {alone['gib']:.3f} GiB; losses TP "
        f"{[round(x, 4) for x in losses]} one process "
        f"{[round(x, 4) for x in alone['losses']]} (largest relative "
        f"difference {off:.3e}); a timed step {timed_ms:.1f} ms, of it "
        f"{spent['calls']} collectives {spent['ms']:.1f} ms over gloo "
        f"({100 * spent['ms'] / timed_ms:.1f}%; by kind "
        f"{ {k: round(v, 1) for k, v in spent['by_kind'].items()} }); card "
        f"{smi}")
    if launches != expect or by_variant[name] != expect:
        raise AssertionError(f"49b rank {rank}: flash {by_variant}, expected "
                             f"{expect} of {name}")
    if not (all(math.isfinite(x) for x in losses) and off <= BF16_TOL):
        raise AssertionError(f"49b rank {rank}: losses {losses} against one "
                             f"process's {alone['losses']}")
    return {"tp_full": {"ms": step_ms, "alone_ms": alone["ms"], "gib": peak,
                        "step_gib": step_peak, "alone_gib": alone["gib"], "launches": launches,
                        "by_variant": by_variant, "timed_ms": timed_ms,
                        "collective_ms": spent["ms"],
                        "collective_calls": spent["calls"],
                        "loss_off": off}}


def _whole_logits(lg, cfg):
    """The whole logits of a serving step: off a mesh ``lg`` itself; on
    the rules' shards the vocab shards of its ``DTensor`` gathered over
    ``model`` (``dist.context``'s all-gather, which gloo stages through the
    host for CUDA tensors)."""
    if not sharding.is_dtensor(lg):
        return lg
    local = lg.to_local()
    if local.shape[-1] == cfg.vocab:
        return local
    return dist_ctx.gather_from(local.contiguous(), "model", -1)


def _serve_tp(rank, world, smi):
    """Phase 50: the serving steps over ``model`` (``serve.step`` with a
    mesh and rules installed): gemma3_1b at full width and depth (params
    from seed 0 made on the card, the same on both ranks), ``SERVE_TP``'s
    prefill and decode steps.  First one process alone on the card (rank
    0; rank 1 waits): greedy decode, each step's last logits kept.  Then on
    mesh (data 1, model world) with ``rules_for``'s rules at the decode
    shape, the params the rules' DTensors (2 of the 4 query heads a rank;
    the one KV head's cache split on ``head_dim``, 128 of 256 a rank; the
    vocab split), teacher-forced on one process's tokens.  Every step's
    logits (gathered) are held against one process's float32 run on the
    same tokens (``_float32_embedding``; flash ``tf32x3``): their largest
    error, relative to the largest logit, at most ``SERVE_TP_RATIO`` times
    one process's bf16 run's, and at least ``SERVE_TP_GREEDY`` of the
    greedy tokens equal to one process's; the distance between the two
    bf16 runs is logged.  The mesh runs the same steps in float32 too:
    every step's logits within ``SERVE_TP_TOL`` of one process's float32
    run's.  Then a planted fault in each dtype, measured by the same checks
    and logged: the mesh again for ``SERVE_TP_FAULT_STEPS`` steps, rank
    1's half of each new key and value (the ``head_dim`` split) erased
    after its step.  The flash launches a rank (counts set to 0 just before the prefill, read just
    after the last step: one a layer, all ``wgmma`` at D 256); prefill ms
    (its second call) and decode ms a step (steps 2 on, synced) beside one
    process's."""
    t0 = time.perf_counter()
    cfg = get_config(SERVE_TP["arch"])
    B, S, n = SERVE_TP["batch"], SERVE_TP["prompt_len"], SERVE_TP["steps"]
    params = T.init_params(cfg, seed=0, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(50).integers(
        0, cfg.vocab, (B, S)), device="cuda")
    pre, dec = make_prefill_step(cfg, S + n), make_decode_step(cfg)

    def run(p, forced=None, steps=n, fault=None):
        """(prefill ms, [decode ms], [last logits float32 on the host], [the
        tokens fed], [each step's greedy tokens]); the prefill timed on its
        second call, the flash counts set to 0 just before it; ``fault(cache,
        i)`` after decode step i."""
        pre(p, prefill_inputs(cfg, tokens))
        fa.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = pre(p, prefill_inputs(cfg, tokens))
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.perf_counter() - t)
        whole = _whole_logits(lg, cfg)
        logits, fed, outs, dec_ms = [whole[:, -1].float().cpu()], [], [], []
        nxt = greedy(whole)
        outs.append(nxt.cpu())
        for i in range(steps):
            inp = nxt if forced is None else forced[:, i:i + 1].cuda()
            fed.append(inp.cpu())
            torch.cuda.synchronize()
            t = time.perf_counter()
            nxt, cache, lg = dec(p, cache, inp, S + i)
            torch.cuda.synchronize()
            dec_ms.append(1e3 * (time.perf_counter() - t))
            if fault is not None:
                fault(cache, i)
            whole = _whole_logits(lg, cfg)
            logits.append(whole[:, -1].float().cpu())
            outs.append(nxt.cpu())
        return pre_ms, dec_ms, logits, fed, outs
    one = [None]
    single_logits = truth = None
    if rank == 0:
        with torch.no_grad():
            pre_ms, dec_ms, single_logits, fed, outs = run(params)
            fed = torch.cat(fed, 1)
            p32 = tree.map_tree(lambda t: t.float(), params)
            with _float32_embedding():
                truth = run(p32, fed)[2]
            del p32
        one[0] = {"prefill_ms": pre_ms, "decode_ms": dec_ms, "fed": fed,
                  "outs": outs}
        torch.cuda.empty_cache()
    dist.barrier()
    dist.broadcast_object_list(one, src=0)
    one = one[0]
    mesh = make_host_mesh(1, world, device_type="cuda")
    rules = rules_for(cfg, dataclasses.replace(
        SHAPE_BY_NAME["decode_32k"], seq_len=S + n, global_batch=B), mesh)
    dist_ctx.set_mesh(mesh)
    sharding.set_active_rules(rules)
    fed = one["fed"]

    def erase(cache, i):
        """The planted fault: rank 1's shard of step i's keys and values
        erased, as if its write were lost."""
        if rank == 1:
            for key in ("k", "v"):
                cache[key].to_local()[:, :, :, S + i].zero_()
    try:
        placed = rules.tree_shardings(T.param_axes(cfg), params)
        dparams = sharding.distribute(params, placed, mesh)
        d32 = sharding.distribute(tree.map_tree(lambda t: t.float(), params),
                                  placed, mesh)
        del params
        torch.cuda.empty_cache()
        pre_ms, dec_ms, logits, _, outs = run(dparams, fed)
        launches = fa.flash_attention.launches
        by_variant = dict(fa.flash_attention.launches_by_variant)
        table = dict(rules.table)
        _, _, f_logits, _, f_outs = run(dparams, fed, SERVE_TP_FAULT_STEPS,
                                        erase)
        del dparams
        with _float32_embedding(vocab_parallel=True):
            m32 = run(d32, fed)[2]
            f32_fault = run(d32, fed, SERVE_TP_FAULT_STEPS, erase)[2]
        del d32
    finally:
        dist_ctx.set_mesh(None)
        sharding.set_active_rules(None)
    torch.cuda.empty_cache()
    # the mesh's greedy token of each step against one process's
    def equal_share(got):
        same = [float((a == b).float().mean())
                for a, b in zip(got, one["outs"])]
        return sum(same) / len(same)
    equal, f_equal = equal_share(outs), equal_share(f_outs)
    name = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    res = {"serve_tp": {
        "prefill_ms": pre_ms, "decode_ms": statistics.mean(dec_ms[1:]),
        "alone_prefill_ms": one["prefill_ms"],
        "alone_decode_ms": statistics.mean(one["decode_ms"][1:]),
        "launches": launches, "by_variant": by_variant,
        "greedy_equal": equal, "fault_greedy_equal": f_equal}}
    errs = f32_errs = mesh_err = one_err = fault = None
    if single_logits is not None:
        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        def ratios(got):
            return [rel(a, t) / rel(b, t)
                    for a, b, t in zip(got, single_logits, truth)]
        errs = [rel(a, b) for a, b in zip(logits, single_logits)]
        f32_errs = [rel(a, t) for a, t in zip(m32, truth)]
        mesh_err = [rel(a, t) for a, t in zip(logits, truth)]
        one_err = [rel(b, t) for b, t in zip(single_logits, truth)]
        fault = {"f32_err": [rel(a, t) for a, t in zip(f32_fault, truth)],
                 "bf16_ratio": ratios(f_logits), "greedy_equal": f_equal}
        fault["caught"] = (max(fault["f32_err"]) > SERVE_TP_TOL
                           or max(fault["bf16_ratio"]) > SERVE_TP_RATIO
                           or f_equal < SERVE_TP_GREEDY)
        res["serve_tp"].update(max_rel_err=max(errs),
                               f32_err=max(f32_errs),
                               mesh_f32_err=max(mesh_err),
                               one_f32_err=max(one_err),
                               f32_ratio=max(ratios(logits)), fault=fault)
    log(f"[rank {rank}] 50 {cfg.name} full width and depth "
        f"({cfg.n_layers} layers) served on mesh {mesh}, rules "
        f"{ {k: v for k, v in table.items() if v} }: prefill {B} x {S} "
        f"{pre_ms:.1f} ms (one process alone {one['prefill_ms']:.1f} ms), "
        f"decode {statistics.mean(dec_ms[1:]):.2f} ms a step over steps "
        f"2-{n} (alone {statistics.mean(one['decode_ms'][1:]):.2f} ms), "
        f"teacher-forced on one process's tokens; greedy tokens equal "
        f"{100 * equal:.2f}%; flash {by_variant} ({launches}, expected "
        f"{cfg.n_layers}); logits' largest error relative to the largest "
        f"logit, by step: against one process's bf16 run "
        f"{None if errs is None else [f'{e:.2e}' for e in errs]}, the "
        f"mesh's against one process's float32 run "
        f"{None if mesh_err is None else [f'{e:.2e}' for e in mesh_err]}, "
        f"one process's bf16 run's against it "
        f"{None if one_err is None else [f'{e:.2e}' for e in one_err]}; "
        f"{time.perf_counter() - t0:.1f} s; card {smi}")
    if f32_errs is not None:
        log(f"[rank {rank}] 50 the mesh's float32 logits against one "
            f"process's float32 run, by step "
            f"{[f'{e:.2e}' for e in f32_errs]} (at most {SERVE_TP_TOL}); "
            f"the mesh's bf16 error off the float32 run over one "
            f"process's, largest {res['serve_tp']['f32_ratio']:.3f} (at "
            f"most {SERVE_TP_RATIO}); planted fault (rank 1's half of each "
            f"new key and value erased, {SERVE_TP_FAULT_STEPS} steps): "
            f"float32 {[f'{e:.2e}' for e in fault['f32_err']]}, bf16 ratio "
            f"{[f'{e:.3f}' for e in fault['bf16_ratio']]}, bf16 greedy "
            f"equal {100 * fault['greedy_equal']:.2f}%; caught by the "
            f"checks: {fault['caught']}")
    if launches != cfg.n_layers or by_variant[name] != cfg.n_layers:
        raise AssertionError(f"50 rank {rank}: flash {by_variant}, expected "
                             f"{cfg.n_layers} of {name}")
    if mesh_err is not None and not all(
            m <= SERVE_TP_RATIO * o for m, o in zip(mesh_err, one_err)):
        raise AssertionError(f"50: the mesh's logits off the float32 run by "
                             f"{mesh_err}, one process's by {one_err}")
    if f32_errs is not None and max(f32_errs) > SERVE_TP_TOL:
        raise AssertionError(f"50: the mesh's float32 logits off one "
                             f"process's by {f32_errs}")
    if equal < SERVE_TP_GREEDY:
        raise AssertionError(f"50 rank {rank}: {100 * equal:.2f}% of the "
                             f"greedy tokens equal one process's")
    return res


def _loop_ms(call, n):
    """Device ms of ``n`` back-to-back launches of ``call`` (``cuda_ms``:
    CUDA events, held behind a device-side sleep)."""
    return cuda_ms(call, n) * n


def sampled_kernels(smi):
    """Phase 51: ``core.sampling.measure_sampled`` on the card for each
    kernel, a loop of ``SAMPLED_N`` launches: flash (bf16, ``wgmma``) at
    gemma3_1b's serving shape, the float32 matmul (``tf32x3``) at the
    ``model`` grid's first shape, the scan at falcon_mamba_7b's serving
    shape with h_S.  The loop timed in full; the estimates unsampled from
    2 launches (the two-point rule: startup and the marginal launch) and
    from 1, each with its ``sampling_error`` against the full loop.
    Returns {kernel: launches made here}."""
    from repro_torch.core.sampling import (measure_sampled, sampling_error,
                                           unsample)
    t0 = time.perf_counter()
    gcfg, fcfg = get_config("gemma3_1b"), get_config("falcon_mamba_7b")
    q, k, v = rand_qkv(SERVE["batch"], gcfg.n_heads, gcfg.n_kv_heads,
                       SERVE["prompt_len"], gcfg.resolved_head_dim,
                       torch.bfloat16, seed=51)
    M, N_, K = calibrate.MODEL_GRIDS["matmul"][0]
    a, b = _matmul_inputs(M, N_, K, torch.float32, seed=51)
    scan_shape = _scan_serve_shape(fcfg)
    scan_in = _scan_inputs(*scan_shape, torch.float32, seed=51)
    before = _counts()
    cases = (
        ("flash_attention", f"bf16 {SERVE['batch']}x{gcfg.n_heads}x"
         f"{gcfg.n_kv_heads}x{SERVE['prompt_len']}x"
         f"{gcfg.resolved_head_dim}",
         lambda: ops.flash_attention(q, k, v, causal=True)),
        ("matmul", f"float32 {M}x{N_}x{K} tf32x3",
         lambda: ops.matmul(a, b)),
        ("mamba_scan", f"float32 {'x'.join(map(str, scan_shape))} h_S",
         lambda: ops.mamba_scan(*scan_in, return_state=True)))
    out = {}
    for kernel, shape, call in cases:
        full = _loop_ms(call, SAMPLED_N)
        ests = {}
        for sample in (2, 1):
            node = measure_sampled(lambda n: _loop_ms(call, n), SAMPLED_N,
                                   sample)
            est = unsample(node)
            ests[sample] = (est, sampling_error(est, full))
        log(f"sampled {kernel} {shape}: {SAMPLED_N} launches {full:.4f} ms "
            f"({full / SAMPLED_N:.5f} ms a launch); unsampled from 2 "
            f"launches {ests[2][0]:.4f} ms (sampling_error "
            f"{ests[2][1]:.3e}), from 1 {ests[1][0]:.4f} ms (sampling_error "
            f"{ests[1][1]:.3e}); card {smi}")
        if not all(math.isfinite(e) and e > 0 for e, _ in ests.values()):
            raise AssertionError(f"51 {kernel}: estimates {ests}")
    after = _counts()
    out = {"matmul": after[0] - before[0], "flash_attention":
           after[2] - before[2], "mamba_scan": after[4] - before[4]}
    log(f"phase 51: launches {out}; {time.perf_counter() - t0:.1f} s")
    return out


def dry_run_on_host(measured_ms, smi):
    """Phase 52: the dry run on the card's host, with no launch: each of
    ``DRY_CELLS``' tinyllama_1_1b cells traced on rank 0 of a fake process
    group at the mesh's world size (``launch.dryrun.lower_cell``): trace
    s, rank 0's FLOPs, bytes, collective bytes and temp bytes, and its
    ``core.simulator.roofline`` on one H100 at its bf16 peak.  Then phase
    43's one-device step (``TRAIN_FULL``: 8 x 4096 in 2 microbatches)
    analyzed on fake tensors (``core.hlo.analyze_step``), priced the same
    way and set beside phase 43's measured ms and phase 45's
    ``simulate_training`` price.  Prices are not measurements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.config import ShapeConfig
    from repro_torch.core.hlo import analyze_step
    from repro_torch.core.simulator import roofline
    from repro_torch.launch import dryrun
    t00 = time.perf_counter()
    counts = _counts()
    cfg = get_config("tinyllama_1_1b")

    def line(hlo, rl):
        r = rl.to_dict()
        return (f"flops {hlo['flops']:.4e} (dot {hlo['dot_flops']:.4e}), "
                f"bytes {hlo['bytes']:.4e}, collective bytes "
                f"{hlo['collective_bytes']:.4e} (wire "
                f"{hlo['wire_bytes']:.4e}; "
                f"{ {k: v['count'] for k, v in hlo['collectives'].items()} }"
                f"), temp {hlo['memory']['temp_bytes'] / 2**30:.3f} GiB; "
                f"roofline compute {1e3 * r['compute_s']:.3f} ms, memory "
                f"{1e3 * r['memory_s']:.3f} ms, collective "
                f"{1e3 * r['collective_s']:.3f} ms, step "
                f"{1e3 * r['step_s']:.3f} ms ({r['bound']}-bound)")
    for mesh_name, shapes in DRY_CELLS.items():
        world, make_mesh = dryrun.MESHES[mesh_name]
        with dryrun.fake_world(world):
            mesh = make_mesh()
            for name in shapes:
                shape = SHAPE_BY_NAME[name]
                t0 = time.perf_counter()
                hlo, _ = dryrun.lower_cell(cfg, shape, mesh)
                trace_s = time.perf_counter() - t0
                rl = roofline(hlo, cfg, shape, world)
                log(f"dry run {cfg.name}|{name}|{mesh_name} (rank 0 of "
                    f"{world}, fake tensors): traced in {trace_s:.1f} s; "
                    f"{line(hlo, rl)}")
                if not (hlo["flops"] > 0 and hlo["bytes"] > 0):
                    raise AssertionError(f"52: {name} {hlo}")
                if shape.kind == "train" and not hlo["collective_bytes"] > 0:
                    raise AssertionError(f"52: {name} has no collectives")
    kw = TRAIN_FULL
    shape = ShapeConfig("phase43", seq_len=kw["seq"],
                        global_batch=kw["batch"], kind="train")
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = T.init_params(cfg, 0, "cpu")
        batch = {k: torch.empty(kw["batch"], kw["seq"], dtype=torch.long)
                 for k in ("tokens", "labels")}
        step = make_train_step(cfg, TrainConfig(
            n_microbatches=kw["microbatches"]))
        hlo = analyze_step(step, params, adamw_init(params), batch, 1)
    trace_s = time.perf_counter() - t0
    rl = roofline(hlo, cfg, shape, 1)
    price = simulate_training(cfg, n_stages=1,
                              n_microbatches=kw["microbatches"],
                              seq_len=kw["seq"], global_batch=kw["batch"],
                              config=default_config())
    log(f"dry run of phase 43's step ({kw['batch']} x {kw['seq']}, "
        f"{kw['microbatches']} microbatches, one device): traced in "
        f"{trace_s:.1f} s; {line(hlo, rl)}; flash calls "
        f"{hlo['custom_calls']}; its roofline step "
        f"{1e3 * rl.step_s:.1f} ms beside phase 43's measured "
        f"{measured_ms:.1f} ms (price / measured "
        f"{1e3 * rl.step_s / measured_ms:.3f}) and phase 45's "
        f"simulate_training price {1e3 * price.step_time_s:.1f} ms (price / "
        f"measured {1e3 * price.step_time_s / measured_ms:.3f}); card {smi}")
    if _counts() != counts:
        raise AssertionError(f"the dry run changed the launch counts: "
                             f"{counts} -> {_counts()}")
    log(f"phase 52: {time.perf_counter() - t00:.1f} s")


def load_example(name):
    """``examples_torch/<name>.py`` as a module (the directory is no
    package); the tests load the examples through it too."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quickstart_example(smi):
    """Phase 53: ``examples_torch/quickstart.py``'s ``main`` on the card,
    the matmul's counts set to 0 just before and read just after (conv0 and
    conv1, ``QUICKSTART_LAUNCHES``), and once more around a second run of
    the unit; each product, fed the card's inputs, against the plain
    version at the float32 matmul tolerance, and the unit's output against
    the same script on the CPU at ``GRAPH_TOL``; each product timed
    (kernel, plain, ``torch.matmul``, bound).  Returns the launches by
    variant, the products' rows and the largest product error."""
    t0 = time.perf_counter()
    qs = load_example("quickstart")
    with tempfile.TemporaryDirectory() as d:
        out, ran = _path_launches(lambda: qs.main(["--out", f"{d}/card"]))
        g = out["graph"]
        card, again = _path_launches(
            lambda: g.values(qs.feeds(), device="cuda"))
        log(f"quickstart: matmul launches {ran} in main, {again} in a "
            f"second run (expected {QUICKSTART_LAUNCHES} each)")
        if ran != QUICKSTART_LAUNCHES or again != QUICKSTART_LAUNCHES:
            raise AssertionError(f"quickstart ran {ran}, then {again}")
        cpu = qs.main(["--device", "cpu", "--out", f"{d}/cpu"])
    plan, rows, worst = g.fusion_plan(), {}, 0.0
    for n in _products(g):
        node = graph_ops.run_node(g, n, {i: card[i].cpu() for i in n.inputs},
                                  plan)
        a, b, _ = graph_ops.matmul_operands(n, card)
        (M, K), N = a.shape, b.shape[1]
        name = mm.variant(M, N, K, torch.float32)
        worst = max(worst, _check(
            f"quickstart {n.name} {(M, N, K)} {name} vs plain on the card's "
            f"inputs", card[n.name].cpu(), node, MM_TOL[torch.float32],
            MM_TOL[torch.float32] * K ** 0.5))

        def call():
            return mm.matmul(a, b)
        k_ms, host = cuda_ms(call, 20), host_us(call)
        plain = cuda_ms(lambda: ref.matmul_ref(a, b), 20, hold=False)
        lib = cuda_ms(lambda: torch.matmul(a, b), 20)
        b_ms, by, _ = matmul_bound(M, N, K, torch.float32, name)
        rows[f"quickstart {n.name} {M}x{N}x{K} {name}"] = dict(
            ms=k_ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=by, host_us=host)
        log(f"  quickstart {n.name} {(M, N, K)} {name}: kernel {k_ms:.4f} "
            f"ms (host {host:.1f} us a call), plain {plain:.4f} ms, "
            f"torch.matmul {lib:.4f} ms, bound {b_ms:.4f} ms by {by} "
            f"({100 * b_ms / k_ms:.2f}%); card {smi}")
    for o in g.outputs:
        expect = cpu["outputs"][o]
        scale = expect.abs().max().item()
        err = _check(f"quickstart {o} card vs CPU", out["outputs"][o].cpu(),
                     expect, GRAPH_TOL, GRAPH_TOL * scale)
        log(f"  {o}: max_abs_err / max|CPU| = {err / scale:.3e}")
    tl = out["timeline"]
    log(f"quickstart: 4-worker makespan {1e6 * tl.makespan:.4f} us, "
        f"utilization {tl.utilization():.4f} (priced at one H100's "
        f"constants: a price, not a measurement); tiling "
        f"{out['choice']}; phase 53: {time.perf_counter() - t0:.1f} s; "
        f"card {smi}")
    return ran, rows, worst


def camera_example(frame_ms, smi):
    """Phase 54: ``examples_torch/camera_pipeline.py``'s ``main`` on the
    card, the matmul's counts set to 0 just before and read just after
    (CNN10 at batch 1, phase 12's: ``GRAPH_LAUNCHES["cnn10"][1]``); its
    RGB frame and DNN input against its measured half,
    ``launch.camera.run_frame``, on the CPU at ``ISP_TOL`` and its logits
    at ``GRAPH_TOL``; the ISP ms, CNN10 ms
    (its first run, as the reference times it), the priced frame and its
    verdict beside phase 12's measured frame.  Returns the launches."""
    t0 = time.perf_counter()
    cam = load_example("camera_pipeline")
    out, ran = _path_launches(lambda: cam.main([]))
    expect = GRAPH_LAUNCHES["cnn10"][1]
    log(f"camera_pipeline: matmul launches {ran} (phase 12's frame: "
        f"{expect})")
    if ran != expect:
        raise AssertionError(f"camera_pipeline ran {ran}")
    cpu = camera.run_frame(camera.raw_frame(0),
                           build_paper_graph(PAPER_NETS["cnn10"], batch=1),
                           "cpu")
    for key in ("rgb", "dnn_in"):
        _check(f"camera_pipeline {key} card vs CPU", out[key].cpu(),
               cpu[key], 0.0, ISP_TOL)
    _check("camera_pipeline CNN10 logits card vs CPU", out["logits"].cpu(),
           cpu["logits"], GRAPH_TOL,
           GRAPH_TOL * cpu["logits"].abs().max().item())
    total_ms = 1e3 * out["timeline"].makespan
    log(f"camera_pipeline: ISP {out['isp_ms']:.4f} ms, CNN10 "
        f"{out['cnn_ms']:.4f} ms (its first run: params copied to the "
        f"card), class {out['cls']}; frame priced on 8 accelerators at one "
        f"H100's constants after the measured ISP {total_ms:.4f} ms: "
        f"{'MEETS' if total_ms < camera.BUDGET_MS else 'MISSES'} "
        f"{camera.BUDGET_MS:g} ms; phase 12's measured frame "
        f"{frame_ms['frame_ms']:.4f} ms; phase 54: "
        f"{time.perf_counter() - t0:.1f} s; card {smi}")
    return ran


def train_lm_example(smi):
    """Phase 55: ``examples_torch/train_lm.py``'s ``main`` with ``--preset
    full`` (tinyllama_1_1b at full width and depth) on the card, in a
    temporary checkpoint directory removed after: ``TRAIN_LM["steps"]``
    steps with ``--ckpt-every`` past them (one save, at the last step),
    then ``--resume`` to ``TRAIN_LM["resume_steps"]``, which must print
    ``resumed from step 3`` and run the rest.  The flash counts are set to
    0 just before each run and read just after: forward and recompute of
    each layer, 44 ``wgmma`` launches a step at D 64.  The example's
    ``restore`` is wrapped for the resume: the restored params and moments
    must equal, bit for bit, a host copy of the saved run's.  Logs ms a
    step (steps 1-3, synced), tok/s, peak GiB, the checkpoint's GiB, the
    save and restore seconds.  Then ``train_lm_fixed_order``.  Returns the
    launches by run."""
    t00 = time.perf_counter()
    ex = load_example("train_lm")
    cfg = ex.preset_config("tinyllama_1_1b", "full")
    kw = TRAIN_LM
    name = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    per_step = 2 * cfg.n_layers
    d = tempfile.mkdtemp(prefix="train_lm_")
    args = ["--preset", "full", "--batch", str(kw["batch"]), "--seq",
            str(kw["seq"]), "--ckpt-dir", d, "--ckpt-every",
            str(10 * kw["resume_steps"])]
    log(f"train_lm: {cfg.name} full width and depth ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} of "
        f"head dim {cfg.resolved_head_dim}, vocab {cfg.vocab}), "
        f"{kw['batch']} x {kw['seq']}, {kw['steps']} steps then a resume to "
        f"{kw['resume_steps']}, checkpoints in {d}; card memory allocated "
        f"before {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    restore = ex.restore
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        first = ex.main([*args, "--steps", str(kw["steps"])])
        torch.cuda.synchronize()
        ran = {k: n for k, n in fa.flash_attention.launches_by_variant.items()
               if n}
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = first["losses"]
        if ran != {name: per_step * kw["steps"]}:
            raise AssertionError(f"train_lm ran {ran}, expected "
                                 f"{per_step} {name} a step")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_lm losses {losses}")
        saved = sorted(Path(d).glob("step_*"))
        if [p.name for p in saved] != [f"step_{kw['steps'] - 1:010d}"]:
            raise AssertionError(f"train_lm saved {saved}")
        ckpt_gib = sum(f.stat().st_size for f in saved[0].iterdir()) / 2**30
        step_ms = [1e3 * s for s in first["step_s"]]
        mean_ms = statistics.mean(step_ms[1:])
        tok_s = kw["batch"] * kw["seq"] / mean_ms * 1e3
        t0 = time.perf_counter()
        host = tree.flatten(to_device({"params": first["params"],
                                       "opt": first["opt"]}, "cpu"))
        copy_s = time.perf_counter() - t0
        save_s = first["save_s"]
        del first
        torch.cuda.empty_cache()
        held = {}

        def checked(mgr, params, opt, log=print):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore(mgr, params, opt, log)
            torch.cuda.synchronize()
            held["s"] = time.perf_counter() - t0
            got = tree.flatten({"params": out[0], "opt": out[1]})
            held["unequal"] = sorted(
                set(got) ^ set(host)) + [
                k for k in host if k in got and not (
                    got[k].dtype == host[k].dtype
                    and torch.equal(got[k].cpu(), host[k]))]
            return out
        ex.restore = checked
        fa.reset_counts()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            second = ex.main([*args, "--steps", str(kw["resume_steps"]),
                              "--resume"])
        torch.cuda.synchronize()
        printed = printed.getvalue().splitlines()
        for line in printed:
            log(line)
        resumed = {k: n for k, n in
                   fa.flash_attention.launches_by_variant.items() if n}
        # one more step profiled: the device's busy share of a step
        i = kw["resume_steps"]
        batch = synthetic_batch(cfg, kw["batch"], kw["seq"],
                                np.random.default_rng(i))
        tc = TrainConfig(lr=1e-3, warmup=20, total_steps=i + 1)
        profile_graph(lambda: ex.run(cfg, tc, second["params"],
                                     second["opt"], [batch], i, i + 1,
                                     log=lambda s: None),
                      mean_ms, smi, runs=1, what="train_lm step")
    finally:
        ex.restore = restore
        shutil.rmtree(d, ignore_errors=True)
    rest = kw["resume_steps"] - kw["steps"]
    said = f"resumed from step {kw['steps'] - 1}"
    if said not in printed or second["start"] != kw["steps"] \
            or len(second["losses"]) != rest:
        raise AssertionError(f"train_lm resume: {printed}")
    if "s" not in held or held["unequal"]:
        raise AssertionError(f"train_lm restore not bit-equal: {held}")
    if resumed != {name: per_step * rest}:
        raise AssertionError(f"train_lm resume ran {resumed}")
    if not all(math.isfinite(x) for x in second["losses"]):
        raise AssertionError(f"train_lm resumed losses {second['losses']}")
    fixed = train_lm_fixed_order(ex, cfg, smi)
    log(f"train_lm: losses {[round(x, 4) for x in losses]} then "
        f"{[round(x, 4) for x in second['losses']]}; ms a step "
        f"{[round(x, 2) for x in step_ms]} (steps 1-3 mean {mean_ms:.2f} ms), "
        f"{tok_s:.0f} tok/s, peak {peak:.3f} GiB over the first run; "
        f"checkpoint {ckpt_gib:.3f} GiB ({len(host)} leaves), saved in "
        f"{save_s:.2f} s (host copy and write), {second['save_s']:.2f} s "
        f"after the resume; restored in {held['s']:.2f} s, every leaf equal "
        f"bit for bit to a host copy of the saved state (taken in "
        f"{copy_s:.2f} s); flash {ran} then {resumed} ({per_step} a step); "
        f"phase 55: {time.perf_counter() - t00:.1f} s; card {smi}")
    return {f"{kw['steps']} steps": ran, f"resume, {rest} steps": resumed,
            f"fixed order, steps {TRAIN_FIXED['start']}-"
            f"{TRAIN_FIXED['steps'] - 1}": fixed}


def train_lm_fixed_order(ex, cfg, smi):
    """Phase 55, its second half: steps [``TRAIN_FIXED["start"]``,
    ``TRAIN_FIXED["steps"]``) of the example's ``run`` at full width and
    depth on batches keyed by step (``synthetic_batch`` at seed i,
    ``TRAIN_FIXED["batch"]`` x ``TRAIN_LM["seq"]``) under ``main``'s
    schedule, on the card and on the CPU from the same params (made on the
    host from seed 0, copied to the card): each step's lr equal, its loss
    and grad norm within ``TRAIN_FIXED_TOL`` of the CPU's.  From the second
    step on, a loss reads the params that earlier steps updated.  The flash
    counts are set to 0 just before the card's run and read just after.
    Returns those launches."""
    t0 = time.perf_counter()
    kw = TRAIN_FIXED
    start, n = kw["start"], kw["steps"]
    tc = TrainConfig(lr=1e-3, warmup=20, total_steps=TRAIN_LM["resume_steps"])
    batches = [synthetic_batch(cfg, kw["batch"], TRAIN_LM["seq"],
                               np.random.default_rng(i))
               for i in range(start, n)]
    host = T.init_params(cfg, 0, "cpu")
    card = to_device(host, "cuda")
    torch.cuda.synchronize()
    fa.reset_counts()
    on_card = ex.run(cfg, tc, card, adamw_init(card), batches, start, n,
                     log=lambda s: None)
    torch.cuda.synchronize()
    ran = {k: c for k, c in fa.flash_attention.launches_by_variant.items()
           if c}
    del card, on_card["params"], on_card["opt"]
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    on_cpu = ex.run(cfg, tc, host, adamw_init(host), batches, start, n,
                    log=lambda s: None)
    cpu_s = time.perf_counter() - t1
    del host, on_cpu["params"], on_cpu["opt"]
    expect = {fa.variant(cfg.resolved_head_dim, torch.bfloat16):
              2 * cfg.n_layers * (n - start)}
    log(f"train_lm fixed order ({cfg.name} full, {kw['batch']} x "
        f"{TRAIN_LM['seq']}, steps {start}-{n - 1}, lr {on_card['lrs']}): "
        f"losses "
        f"card {[round(x, 4) for x in on_card['losses']]}, CPU "
        f"{[round(x, 4) for x in on_cpu['losses']]}; grad norms card "
        f"{[round(x, 3) for x in on_card['gnorms']]}, CPU "
        f"{[round(x, 3) for x in on_cpu['gnorms']]}; flash {ran} (expected "
        f"{expect}); CPU {cpu_s:.1f} s; {time.perf_counter() - t0:.1f} s; "
        f"card {smi}")
    if ran != expect:
        raise AssertionError(f"train_lm fixed order ran {ran}")
    if on_card["lrs"] != on_cpu["lrs"]:
        raise AssertionError(f"lr {on_card['lrs']} vs {on_cpu['lrs']}")
    for key in ("losses", "gnorms"):
        for i, (a, b) in enumerate(zip(on_card[key], on_cpu[key])):
            if not (math.isfinite(a) and abs(a - b) <= TRAIN_FIXED_TOL
                    * abs(b)):
                raise AssertionError(f"train_lm fixed order step {start + i} "
                                     f"{key}: card {a}, CPU {b}")
    return ran


def serve_batch_example(phase27, smi):
    """Phase 56: ``examples_torch/serve_batch.py``: its ``main`` at its
    defaults (gemma3_1b's SMOKE config, one batch of 4 x 32 and 15 decode
    steps; one flash launch an attention layer), the flash counts set to 0
    just before and read just after.  Its ``run_measured`` is
    ``launch.serve_batch.run_measured``, the function phase 27 ran at full
    width: phase 27's counts stand for it.  Returns the launches by run."""
    t0 = time.perf_counter()
    sb = load_example("serve_batch")
    if sb.run_measured is not run_measured:
        raise AssertionError("the serve_batch example's run_measured is "
                             "not launch.serve_batch's")
    smoke = get_smoke_config("gemma3_1b")
    torch.cuda.synchronize()
    fa.reset_counts()
    sb.main([])
    torch.cuda.synchronize()
    ran = {k: n for k, n in fa.flash_attention.launches_by_variant.items()
           if n}
    expect = {fa.variant(smoke.resolved_head_dim, torch.bfloat16):
              _attn_layers(smoke)}
    log(f"serve_batch main (SMOKE): flash launches {ran} (expected "
        f"{expect}); its run_measured is phase 27's (flash {phase27}); "
        f"phase 56: {time.perf_counter() - t0:.1f} s; card {smi}")
    if ran != expect:
        raise AssertionError(f"serve_batch main ran {ran}")
    return {"main (gemma3_1b SMOKE)": ran,
            "run_measured (gemma3_1b full, phase 27's run)": phase27}


def check_tiles():
    """Phase 57 (a): every tile of every matmul variant against the plain
    version on the card at ``TILE_CASES`` (and ``TILE_CASES_SMALL_M`` for
    the decoding rows), each variant at the shapes it takes, at the
    chooser's split of K for the tile; then the refusals: a tile no variant
    instantiates raises in the wrapper, and the C entry point itself
    returns cudaErrorInvalidValue for it and for a split count its k ranges
    cannot give.  Returns the largest error by dtype and the tiles held."""
    worst, held = dict.fromkeys(MM_TOL, 0.0), 0
    for name, (_, dtype) in mm.VARIANTS.items():
        tol = MM_TOL[dtype]
        for M, N, K in TILE_CASES + TILE_CASES_SMALL_M:
            if not mm._takes(name, M, N, K, dtype):
                continue
            a, b = _matmul_inputs(M, N, K, dtype, seed=3)
            expect = ref.matmul_ref(a, b)
            errs = []
            for bm, bn, bk in mm.tiles(name):
                t = mm.tiling_of(M, N, K, dtype, bm=bm, bn=bn, bk=bk,
                                 kernel=name)
                out = _ran(mm.matmul, name, lambda: mm.matmul(
                    a, b, bm=bm, bn=bn, bk=bk, kernel=name))
                if out.dtype != dtype or out.shape != (M, N):
                    raise AssertionError(f"matmul gave {out.dtype} "
                                         f"{out.shape}")
                errs.append(_check(
                    f"phase 57 {name} tile {(bm, bn, bk)} x{t.stages} "
                    f"splits {t.splits} {(M, N, K)} {dtype}", out, expect,
                    tol, tol * K ** 0.5))
                held += 1
            worst[dtype] = max(worst[dtype], max(errs))
    a, b = _matmul_inputs(128, 128, 128, torch.float32)
    try:
        mm.matmul(a, b, bm=128, bn=128, bk=128)
    except ValueError as e:
        log(f"phase 57: the wrapper refuses tile (128, 128, 128): {e}")
    else:
        raise AssertionError("the wrapper took tile (128, 128, 128)")
    lib, out = mm._lib(), torch.empty(128, 128, device="cuda")
    n_ws = mm.tf32x3_workspace(128, 128, 128, 7)
    ws = torch.empty(n_ws, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for tile, splits in (((128, 128, 128), 1), ((128, 128, 32), 7)):
        rc = lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              ws.data_ptr(), n_ws, 128, 128, 128, 0,
                              mm.VARIANTS["tf32x3"][0], *tile, splits,
                              stream)
        torch.cuda.synchronize()
        log(f"phase 57: nvdla_matmul at tf32x3 tile {tile}, {splits} "
            f"splits of K = 128: cudaError_t {rc}")
        if rc != 1:   # cudaErrorInvalidValue
            raise AssertionError(f"the kernel took tile {tile} x{splits}")
    return worst, held


def previous_tile(M, N, K, name):
    """The tile and split that ``csrc/nvdla_matmul.cu`` chose by itself
    before its tiles became launch parameters, for a float32 variant:
    tf32x3 128 rows by 112 or 128 columns, whichever takes the fewer rounds
    of tiles over 132 SMs times its width (ties 128; its ``tf32x3_bn``),
    never split; the stream kernel's one tile at the split its
    ``stream_split_k`` gave, which the chooser's rule keeps."""
    if name == "tf32x3":
        tiles_m = -(-M // 128)

        def cost(bn):
            return -(-(-(-N // bn) * tiles_m) // 132) * bn
        return (128, 112 if cost(112) < cost(128) else 128, 32), 1
    t = mm.tiling_of(M, N, K, torch.float32, kernel=name)
    return (t.bm, t.bn, t.bk), t.splits


def tiling_shapes():
    """Phase 57 (b)'s float32 products by origin: the ``model`` grid, each
    Table-III net's conv and FC products at batch 64 and 1 (unique shapes,
    from the graphs' static shapes) and the quickstart's two convs."""
    shapes = {"model": list(calibrate.MODEL_GRIDS["matmul"])}
    for batch in (64, 1):
        seen = shapes.setdefault(f"graph batch {batch}", [])
        for net in PAPER_NETS:
            g = build_paper_graph(PAPER_NETS[net], batch)
            for n in _products(g):
                s = graph_ops.product_shape(g, n)
                if s not in seen:
                    seen.append(s)
    shapes["quickstart"] = list(QUICKSTART_CONVS)
    return shapes


def time_tiles(smi):
    """Phase 57 (b): at each float32 shape of ``tiling_shapes`` the
    chooser's tile (its stages and split) and its kernel ms beside the
    previous tile's (``previous_tile``, passed explicitly), ``torch.matmul``
    and the bound, and the wrapper's host us a call with the chooser; (c)
    at each of those shapes that tf32x3 takes, every tf32x3 tile's ms,
    unsplit and at the chooser's split for it, the chooser's pick beside the
    fastest.  Returns the rows by origin and the picks' summed ms over the
    fastest tiles'."""
    rows = {}
    for origin, shapes in tiling_shapes().items():
        for M, N, K in shapes:
            a, b = _matmul_inputs(M, N, K, torch.float32, seed=4)
            t = mm.tiling_of(M, N, K, torch.float32)
            prev, prev_splits = previous_tile(M, N, K, t.variant)
            k_ms = cuda_ms(lambda: mm.matmul(a, b), 20)
            same = prev == (t.bm, t.bn, t.bk) and prev_splits == t.splits
            p_ms = k_ms if same else cuda_ms(lambda: mm.matmul(
                a, b, bm=prev[0], bn=prev[1], bk=prev[2],
                splits=prev_splits), 20)
            lib = cuda_ms(lambda: torch.matmul(a, b), 20)
            b_ms, by, _ = matmul_bound(M, N, K, torch.float32, t.variant)
            host = host_us(lambda: mm.matmul(a, b))
            row = dict(shape=[M, N, K], variant=t.variant,
                       tile=[t.bm, t.bn, t.bk], stages=t.stages,
                       splits=t.splits, ms=k_ms, previous_tile=list(prev),
                       previous_splits=prev_splits, previous_ms=p_ms,
                       library_ms=lib, bound_ms=b_ms, bound_by=by,
                       host_us=host)
            rows.setdefault(origin, []).append(row)
            log(f"phase 57 {origin} {(M, N, K)} {t.variant}: tile "
                f"{(t.bm, t.bn, t.bk)} x{t.stages} splits {t.splits}: "
                f"{k_ms:.4f} ms; previous {prev} splits {prev_splits}: "
                + ("the same tile" if same else f"{p_ms:.4f} ms") +
                f" ({k_ms / p_ms:.3f}x); torch.matmul {lib:.4f} ms; bound "
                f"{b_ms:.5f} ms by {by}; host {host:.1f} us a call")
    kern = tiling.matmul_kernel("tf32x3")
    picked = fastest = 0.0
    for M, N, K in sorted({tuple(r["shape"]) for v in rows.values()
                           for r in v if r["variant"] == "tf32x3"}):
        a, b = _matmul_inputs(M, N, K, torch.float32, seed=4)
        t = mm.tiling_of(M, N, K, torch.float32)
        times = {}
        for tile in kern.tiles:
            for splits in sorted({1, tiling.split_count(M, N, K, tile, kern,
                                                        hw.N_SMS)}):
                times[tile[:3], splits] = cuda_ms(lambda: mm.matmul(
                    a, b, bm=tile[0], bn=tile[1], bk=tile[2],
                    splits=splits), 10)
        best = min(times, key=times.get)
        pick = times[(t.bm, t.bn, t.bk), t.splits]
        picked, fastest = picked + pick, fastest + times[best]
        log(f"phase 57 sweep {(M, N, K)}: picked {(t.bm, t.bn, t.bk)} "
            f"splits {t.splits} {pick:.4f} ms, fastest {best[0]} splits "
            f"{best[1]} {times[best]:.4f} ms; " + ", ".join(
                f"{tile[0]}x{tile[1]}/{s} {ms_:.4f}"
                for (tile, s), ms_ in times.items()))
    log(f"phase 57 sweep: the chooser's tf32x3 picks {picked:.4f} ms in all, "
        f"the fastest tiles {fastest:.4f} ms ({picked / fastest:.4f}x); "
        f"card {smi}")
    return rows, picked / fastest


def tiling_phase(smi):
    """Phase 57: the tiling optimizer on the card (``check_tiles``,
    ``time_tiles``).  Returns the JSON line's ``tiling`` entry: the model
    grid's rows, and by origin the summed ms of the chooser's tiles, the
    previous tiles, ``torch.matmul`` and the bound (every row is on its
    ``phase 57`` line)."""
    t0 = time.perf_counter()
    worst, held = check_tiles()
    rows, sweep = time_tiles(smi)
    model = rows["model"]
    slow = [r for r in model if r["ms"] > 1.05 * r["previous_ms"]]
    log(f"phase 57: {held} tiles held, max_abs_err float32 "
        f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}; the "
        f"model grid's chosen tiles within 5% of the previous tile's ms: "
        f"{'MET' if not slow else 'MISSED at ' + str(slow)}; "
        f"{time.perf_counter() - t0:.1f} s; card {smi}")
    keys = ("ms", "previous_ms", "library_ms", "bound_ms")
    return {"tiles_held": held, "max_abs_err": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16],
            "seconds": time.perf_counter() - t0, "model": [
                {k: r[k] for k in ("shape", "variant", "tile", "stages",
                                   "splits", *keys)} for r in model],
            "sums": {origin: {"shapes": len(rs), **{
                k: sum(r[k] for r in rs) for k in keys}}
                for origin, rs in rows.items()},
            "sweep_picked_over_fastest": sweep}


def _tile_info(name, D, tile):
    """``tile_of``'s layout of a flash instance beside the library's report
    of it (``instance``); raises where they disagree."""
    t = fa.tile_of(D, VARIANT_DTYPE[name], bq=tile[0], bk=tile[1],
                   kernel=name)
    got = fa.instance(name, D, *tile)
    if got is None or (got["stages"], got["smem_bytes"], got["threads"]) \
            != (t.stages, t.smem_bytes, t.threads):
        raise AssertionError(f"flash {name} D {D} tile {tile}: the library "
                             f"reports {got}, tile_of {t}")
    return got


VARIANT_DTYPE = {name: dtype for name, (_, dtype) in fa.VARIANTS.items()}


def check_flash_tiles():
    """Phase 58 (a), (b) for flash: every tile of both Hopper variants at
    every head dim against the plain version at ``TILE_FLASH_CASES``, each
    call checked to launch its variant once; the library's instance of
    every tile beside ``tile_of``'s layout, and for every other (bq, bk) of
    ``TILE_BQ`` x ``TILE_BK`` (and (256, 256)) in every variant no
    instance; the wrapper's refusals.  Returns the largest error by type
    and {variant: {D: {tile: instance}}}."""
    worst, infos = dict.fromkeys(TOL, 0.0), {}
    for name in ("wgmma", "tf32x3"):
        dtype = VARIANT_DTYPE[name]
        for D in fa.HEAD_DIMS:
            for c, (B, H, Hkv, S, causal, window) in enumerate(
                    TILE_FLASH_CASES):
                q, k, v = rand_qkv(B, H, Hkv, S, D, dtype, seed=5 + c)
                expect = ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window)
                for tile in fa.tiles(name, D):
                    out = _ran(fa.flash_attention, name,
                               lambda: fa.flash_attention(
                                   q, k, v, causal=causal, window=window,
                                   bq=tile[0], bk=tile[1], kernel=name))
                    worst[dtype] = max(worst[dtype], _check(
                        f"phase 58 flash {name} D {D} tile {tile} "
                        f"{(B, H, Hkv, S)} causal {causal} window {window}",
                        out, expect, TOL[dtype], TOL[dtype]))
    for name in fa.VARIANTS:
        for D in fa.VARIANT_HEAD_DIMS[name]:
            have = fa.tiles(name, D)
            infos.setdefault(name, {})[D] = {
                tile: _tile_info(name, D, tile) for tile in have}
            for tile in [(bq, bk) for bq in fa.TILE_BQ for bk in fa.TILE_BK]\
                    + [(256, 256)]:
                if tile not in have and fa.instance(name, D, *tile):
                    raise AssertionError(f"the library has flash {name} D "
                                         f"{D} tile {tile}, tiles() not")
    q, k, v = rand_qkv(1, 2, 1, 64, 64, torch.bfloat16)
    for kw in (dict(bq=256, bk=256), dict(bq=64, bk=48), dict(bq=64)):
        try:
            fa.flash_attention(q, k, v, **kw)
        except ValueError as e:
            log(f"phase 58: the flash wrapper refuses {kw}: {e}")
        else:
            raise AssertionError(f"the flash wrapper took {kw}")
    stream = torch.cuda.current_stream().cuda_stream
    for name, D, tile in (("wgmma", 64, (256, 256)), ("wgmma", 64, (64, 48)),
                          ("tf32x3", 256, (128, 64)),
                          ("mma_sync", 64, (128, 64))):
        dtype = VARIANT_DTYPE[name]
        qd, kd, vd, od = (torch.zeros(1, h, 64, D, dtype=dtype,
                                      device="cuda") for h in (2, 1, 1, 2))
        n_ws = fa._lib().flash_attention_workspace(1, 2, 1, 64, D)
        ws = torch.empty(n_ws, device="cuda")
        rc = fa._lib().flash_attention_fwd(
            qd.data_ptr(), kd.data_ptr(), vd.data_ptr(), od.data_ptr(),
            ws.data_ptr(), n_ws, 1, 2, 1, 64, D, 1, 0,
            0 if dtype == torch.float32 else 1, fa.VARIANTS[name][0], *tile,
            stream)
        torch.cuda.synchronize()
        log(f"phase 58: flash_attention_fwd {name} D {D} tile {tile}: "
            f"cudaError_t {rc}")
        if rc != 1:   # cudaErrorInvalidValue
            raise AssertionError(f"the flash library took {name} D {D} "
                                 f"tile {tile}")
    return worst, infos


def check_scan_tiles():
    """Phase 58 (a), (b) for the scan: every tile in both types at both N
    against the plain version at ``TILE_SCAN_CASE`` with h0 in and h_S out;
    the library's instance of every tile; the refusals of the wrapper and
    of the library.  Returns the largest error by type and {(dtype, N):
    {tile: instance}}."""
    worst, infos = dict.fromkeys(SCAN_TOL, 0.0), {}
    b, S, d = TILE_SCAN_CASE
    for dtype in SCAN_TOL:
        tol = SCAN_TOL[dtype]
        for N in ms.STATE_DIMS:
            args = _scan_inputs(b, S, d, N, dtype, seed=6)
            h0 = torch.randn(b, d, N, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(7))
            y_ref, h_ref = ref.mamba_scan_ref(*args, h0=h0,
                                              return_state=True)
            infos[(dtype, N)] = {}
            for tile in ms.tiles():
                before = ms.mamba_scan.launches
                y, h = ms.mamba_scan(*args, h0=h0, return_state=True,
                                     bd=tile[0], chunk=tile[1])
                torch.cuda.synchronize()
                if ms.mamba_scan.launches != before + 1:
                    raise AssertionError("the scan did not launch once")
                label = f"phase 58 scan tile {tile} {(b, S, d, N)} {dtype}"
                worst[dtype] = max(worst[dtype],
                                   _check(f"{label} y", y, y_ref, tol,
                                          4 * tol),
                                   _check(f"{label} h_S", h, h_ref, tol,
                                          4 * tol))
                infos[(dtype, N)][tile] = ms.instance(dtype, N, *tile)
                if infos[(dtype, N)][tile] is None:
                    raise AssertionError(f"the scan library lacks {tile}")
    args = _scan_inputs(1, 8, 16, 16, torch.float32)
    for kw in (dict(bd=48, chunk=16), dict(bd=16), dict(bd=128, chunk=128)):
        try:
            ms.mamba_scan(*args, **kw)
        except ValueError as e:
            log(f"phase 58: the scan wrapper refuses {kw}: {e}")
        else:
            raise AssertionError(f"the scan wrapper took {kw}")
    y = torch.empty_like(args[0])
    for tile in ((48, 16), (16, 0), (128, 128)):
        rc = ms._lib().mamba_scan_fwd(
            *(t.data_ptr() for t in args), None, y.data_ptr(), None, 1, 8,
            16, 16, 0, *tile, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        log(f"phase 58: mamba_scan_fwd tile {tile}: cudaError_t {rc}")
        if rc != 1 or ms.instance(torch.float32, 16, *tile) is not None:
            raise AssertionError(f"the scan library took tile {tile}")
    return worst, infos


def _abba(default, tile, iters):
    """Device ms of ``default`` and ``tile`` timed in turns, a b b a, each
    the mean of its two runs."""
    a1, b1 = cuda_ms(default, iters), cuda_ms(tile, iters)
    b2, a2 = cuda_ms(tile, iters), cuda_ms(default, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def time_flash_tiles(infos, smi):
    """Phase 58 (c) for flash: at ``TILE_FLASH_SHAPES``'s shape of each
    variant and head dim, every tile's ms beside the default's in one call
    (a b b a), with the bound and the instance's stages, shared bytes,
    registers and local bytes.  Returns {variant: {D: [row]}}."""
    rows = {}
    for name, shapes in TILE_FLASH_SHAPES.items():
        dtype = VARIANT_DTYPE[name]
        for D, (B, H, Hkv, S, _, causal) in shapes.items():
            q, k, v = rand_qkv(B, H, Hkv, S, D, dtype, seed=8)
            b_ms = bound(B, H, Hkv, S, D, 0, dtype, name, causal)[0]
            first = fa.tiles(name, D)[0]

            def call(tile):
                return lambda: fa.flash_attention(
                    q, k, v, causal=causal, bq=tile[0], bk=tile[1],
                    kernel=name)
            out = rows.setdefault(name, {}).setdefault(D, [])
            for tile in fa.tiles(name, D):
                if tile == first:
                    d_ms = t_ms = cuda_ms(call(tile), 10)
                else:
                    d_ms, t_ms = _abba(call(first), call(tile), 10)
                info = infos[name][D][tile]
                out.append(dict(bq=tile[0], bk=tile[1], **info, ms=t_ms,
                                default_ms=d_ms, bound_ms=b_ms))
                log(f"phase 58 flash {name} D {D} tile {tile} "
                    f"x{info['stages']}: {info['smem_bytes']} B shared, "
                    f"{info['threads']} threads, {info['regs']} registers, "
                    f"{info['local_bytes']} B local; {t_ms:.4f} ms, default "
                    f"{first} {d_ms:.4f} ms ({t_ms / d_ms:.3f}x) at "
                    f"{(B, H, Hkv, S, D)}{'' if causal else ' non-causal'}; "
                    f"bound {b_ms:.4f} ms; card {smi}")
    return rows


def time_scan_tiles(infos, smi):
    """Phase 58 (c) for the scan: every tile at ``TILE_SCAN_SHAPE``
    (float32, h_S out, as prefill runs it) beside the default in one call,
    a b b a.  Returns [row]."""
    args = _scan_inputs(*TILE_SCAN_SHAPE, torch.float32, seed=2)
    b_ms = scan_bound(*TILE_SCAN_SHAPE, torch.float32, states=1)[0]
    rows = []

    def call(tile):
        return lambda: ms.mamba_scan(*args, return_state=True, bd=tile[0],
                                     chunk=tile[1])
    first = ms.tiles()[0]
    for tile in ms.tiles():
        if tile == first:
            d_ms = t_ms = cuda_ms(call(tile), 10)
        else:
            d_ms, t_ms = _abba(call(first), call(tile), 10)
        info = infos[(torch.float32, TILE_SCAN_SHAPE[-1])][tile]
        rows.append(dict(bd=tile[0], chunk=tile[1], **info, ms=t_ms,
                         default_ms=d_ms, bound_ms=b_ms))
        log(f"phase 58 scan tile (bd, chunk) {tile}: {info['threads']} "
            f"threads, {info['smem_bytes']} B shared, {info['regs']} "
            f"registers, {info['local_bytes']} B local; {t_ms:.4f} ms, "
            f"default {first} {d_ms:.4f} ms ({t_ms / d_ms:.3f}x) at "
            f"{TILE_SCAN_SHAPE} float32 with h_S; bound {b_ms:.4f} ms; card "
            f"{smi}")
    return rows


def block_tiles_phase(smi):
    """Phase 58: the flash and scan kernels' block shapes from the caller
    (``check_flash_tiles``, ``check_scan_tiles``, ``time_flash_tiles``,
    ``time_scan_tiles``).  Returns the JSON line's ``tiles`` entries of
    flash (by variant) and of the scan."""
    t0 = time.perf_counter()
    flash_err, flash_infos = check_flash_tiles()
    scan_err, scan_infos = check_scan_tiles()
    flash_rows = time_flash_tiles(flash_infos, smi)
    scan_rows = time_scan_tiles(scan_infos, smi)
    held = sum(len(fa.tiles(n, D)) for n in ("wgmma", "tf32x3")
               for D in fa.HEAD_DIMS)
    spills = [(n, D, (r["bq"], r["bk"]), r["local_bytes"])
              for n, by_d in flash_rows.items() for D, rs in by_d.items()
              for r in rs if r["local_bytes"]] + [
        ("scan", key, tile, i["local_bytes"])
        for key, by_tile in scan_infos.items()
        for tile, i in by_tile.items() if i["local_bytes"]]
    seconds = time.perf_counter() - t0
    log(f"phase 58: {held} flash tiles held x {len(TILE_FLASH_CASES)} "
        f"cases, max_abs_err float32 {flash_err[torch.float32]:.3e}, bf16 "
        f"{flash_err[torch.bfloat16]:.3e}; {len(ms.tiles())} scan tiles x "
        f"2 types x 2 N, max_abs_err float32 {scan_err[torch.float32]:.3e}, "
        f"bf16 {scan_err[torch.bfloat16]:.3e}; spills {spills or 'none'}; "
        f"{seconds:.1f} s (budget 40 s: "
        f"{'MET' if seconds <= 40 else 'MISSED'}); card {smi}")
    return ({"max_abs_err": flash_err[torch.float32],
             "max_abs_err_bf16": flash_err[torch.bfloat16],
             "seconds": seconds, "by_variant": {
                 n: {str(D): rs for D, rs in by_d.items()}
                 for n, by_d in flash_rows.items()}},
            {"max_abs_err": scan_err[torch.float32],
             "max_abs_err_bf16": scan_err[torch.bfloat16],
             "shape": list(TILE_SCAN_SHAPE), "rows": scan_rows})


# phase 59: falcon_mamba_7b's served prefill shapes (the benchmark's
# prefill_pool: batches of 8 prompts of 1024, 2048 and 4000 tokens)
COEFF_SHAPES = [(8, S, 8192) for S in (1024, 2048, 4000)]


def coeff_bound(b, S, d, name):
    """Least ms of a coefficient kernel, at the HBM rate: conv1d_silu reads
    x (bf16) and writes y (bf16) and yf (float32) once, with the taps and
    the bias (bf16, k 4); dt_softplus reads the product (bf16) and writes
    float32 once, with the float32 bias."""
    n = b * S * d
    nbytes = n * (2 + 2 + 4) + 2 * 5 * d if name == "conv1d_silu" \
        else n * (2 + 4) + 4 * d
    return 1e3 * nbytes / hw.HBM_BW


def mamba1_coeffs_phase(smi, params=None):
    """Phase 59: the Mamba1 mixer's coefficient kernels.  (a) One
    falcon_mamba_7b prefill at full width and depth (params from seed 0
    made on the card, or ``params``), 1 x 1024 tokens: each kernel and the
    scan launched once a layer.  (b) At ``COEFF_SHAPES``, x read in place
    from a (b, S, 2 d) product: conv1d_silu within one bf16 ulp of the
    chain in float32, dt_softplus within 2 float32 ulps of the plain
    version; each kernel's ms beside its bound, the plain chain's ms and
    the wrapper's host us a call.  Returns {"launches": {kernel: count},
    kernel: {S: row}}."""
    cfg = get_config("falcon_mamba_7b")
    if params is None:
        params = T.init_params(cfg, seed=0, device="cuda")
    d, k = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_conv
    g = torch.Generator("cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (1, 1024), generator=g,
                           device="cuda")

    def counts():
        return {"conv1d_silu": mc.conv1d_silu.launches,
                "dt_softplus": mc.dt_softplus.launches,
                "mamba_scan": ms.mamba_scan.launches}
    before = counts()
    with torch.no_grad():
        T.prefill_forward(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = {name: n - before[name] for name, n in counts().items()}
    log(f"phase 59: one {cfg.name} prefill (1 x 1024, {cfg.n_layers} "
        f"layers) launches {launches}")
    if set(launches.values()) != {cfg.n_layers}:
        raise AssertionError(f"{launches}, expected {cfg.n_layers} each")
    del params
    torch.cuda.empty_cache()
    w = (0.2 * torch.randn(d, k, generator=g, device="cuda")).bfloat16()
    bias = (0.5 * torch.randn(d, generator=g, device="cuda")).bfloat16()
    dt_bias = torch.randn(d, generator=g, device="cuda") - 4.6
    out = {"launches": launches}
    for b, S, _ in COEFF_SHAPES:
        xz = torch.randn(b, S, 2 * d, generator=g, device="cuda").bfloat16()
        x = xz[..., :d]
        p = (4 * torch.randn(b, S, d, generator=g, device="cuda")).bfloat16()
        with torch.no_grad():
            y, _ = mc.conv1d_silu(x, w, bias)
            e32 = ref.conv1d_silu_ref(x.float(), w.float(), bias.float())[1]
            conv_ulps = ((y.float() - e32).abs()
                         / ulp(e32, 8)).max().item()
            e = ref.dt_softplus_ref(p, dt_bias)
            dt_ulps = ((mc.dt_softplus(p, dt_bias) - e).abs()
                       / ulp(e, 24)).max().item()
        del y, e32, e
        log(f"phase 59 ({b}, {S}, {d}): conv1d_silu within {conv_ulps:.3f} "
            f"bf16 ulps of the chain in float32, dt_softplus within "
            f"{dt_ulps:.3f} float32 ulps of the plain version")
        if not (conv_ulps <= 1 and dt_ulps <= 2):
            raise AssertionError(f"conv1d_silu {conv_ulps} ulps, dt_softplus"
                                 f" {dt_ulps} ulps")
        for name, kernel, plain in (
                ("conv1d_silu", lambda: mc.conv1d_silu(x, w, bias),
                 lambda: ref.conv1d_silu_ref(x, w, bias)),
                ("dt_softplus", lambda: mc.dt_softplus(p, dt_bias),
                 lambda: ref.dt_softplus_ref(p, dt_bias))):
            kernel_ms, host = cuda_ms(kernel, 20), host_us(kernel)
            plain_ms = cuda_ms(plain, 5, hold=False)
            bound_ms = coeff_bound(b, S, d, name)
            log(f"{name} ({b}, {S}, {d}): kernel {kernel_ms:.4f} ms (host "
                f"{host:.1f} us a call), plain {plain_ms:.4f} ms, library "
                f"none, bound {bound_ms:.4f} ms by bytes = "
                f"{100 * bound_ms / kernel_ms:.2f}% of bound; card {smi}")
            out.setdefault(name, {})[S] = dict(
                ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, host_us=host, bound_by="bytes")
        del xz, x, p
        torch.cuda.empty_cache()
    return out


def ulp(v, mantissa_bits):
    """One unit in the last place at each value of float32 ``v`` for a
    type of ``mantissa_bits`` (with the implicit bit): bf16 8, float32
    24."""
    _, e = torch.frexp(v.abs().clamp(min=torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(v), e - mantissa_bits)


def _counts():
    """Every kernel wrapper's launch count."""
    return (mm.matmul.launches, dict(mm.matmul.launches_by_variant),
            fa.flash_attention.launches,
            dict(fa.flash_attention.launches_by_variant),
            ms.mamba_scan.launches, mc.conv1d_silu.launches,
            mc.dt_softplus.launches)


def _mean_row(rows):
    """One launch of the model grid: the mean of each time over its shapes;
    bound_by is that of the shape with the largest bound."""
    out = {key: (None if rows[0][key] is None
                 else sum(r[key] for r in rows) / len(rows))
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "host_us")}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    return out


def _head_dim_rows(small):
    """``time_flash_small``'s rows for the JSON line: by type and shape,
    each variant's ms beside the plain version's, SDPA's and the bound (with
    the term that sets it)."""
    out = {}
    for (shape, dtype), rows in small.items():
        first = next(iter(rows.values()))
        mask = "" if first["causal"] else " non-causal"
        out[f"{str(dtype)[6:]} {'x'.join(map(str, shape))}{mask}"] = {
            "ms_by_variant": {name: r["ms"] for name, r in rows.items()},
            **{k: first[k] for k in ("plain_ms", "library_ms", "bound_ms",
                                     "bound_term")}}
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 plain versions need TF32 off")
    name, smi = identify()
    build_kernels()
    # the scan's loop over time, float32, N = 16
    per_step, n, steps = scan_sass(_build.library_path("mamba_scan"),
                                   "mamba_scan_kernelIfLi16ELi32ELi32EE")
    log(f"mamba_scan L=4 SASS: {per_step:.2f} instructions per (thread, "
        f"timestep) ({n} in a loop of {steps:g} steps)")
    max_err, f32_err = check_kernel()
    check_model_against_cpu()
    cfg, params, launches, by_variant, measured = serve_full()
    rows = time_kernel(cfg, smi)
    measured["busy"], _ = profile_serving(cfg, params, smi)
    served = {"gemma3_1b": measured}
    host_params = to_device(params, "cpu")    # phase 27 serves them again
    del params
    torch.cuda.empty_cache()
    new_err = check_new_kernels()
    cal_err = check_calibration_shapes()
    new_rows, mm_by_variant = time_new_kernels(smi)
    log(f"matmul float32 ms by variant and shape: {mm_by_variant}")
    f32_rows = time_flash_f32(smi)
    f32_flash = {name: _mean_row(r) for name, r in f32_rows.items()}
    shapes = ["x".join(map(str, shape))
              for shape in calibrate.MODEL_GRIDS["attention"]]
    for var, r in f32_flash.items():
        log(f"flash_attention {var} float32, mean over the model grid (what "
            f"the calibration runs): {r}; ms by shape "
            f"{dict(zip(shapes, (x['ms'] for x in f32_rows[var])))}")
    cal_launches, cal_by_variant, cal_records = run_calibration()
    graphs, graph_by_batch, graph_err = check_graphs()
    graph_ms = time_graphs(graphs, smi)
    del graphs
    camera_launches, frame_ms = check_camera(smi)
    serve_shape = _scan_serve_shape(get_config("falcon_mamba_7b"))
    state_err = check_scan_state(serve_shape)
    check_falcon_against_cpu()
    torch.cuda.empty_cache()
    fcfg, fparams, scan_serve_launches, fmeasured = serve_falcon()
    fmeasured["busy"], _ = profile_serving(fcfg, fparams, smi,
                                        kernel="mamba_scan_kernel")
    served[fcfg.name] = fmeasured
    del fparams
    torch.cuda.empty_cache()
    scan_rows = time_scan_serving(serve_shape, smi)
    scan_by_path = {"calibration": cal_launches["mamba_scan"],
                    "falcon_mamba_7b serving": scan_serve_launches}
    # phase 49a's TP step (each rank's own count) joins it after phase 48
    log(f"mamba_scan launches by path: {scan_by_path}")
    check_model_against_cpu("phi3_mini_3_8b", PHI3_CUT, PHI3_PROMPTS)
    torch.cuda.empty_cache()
    pcfg, pparams, _, phi3_by_variant, pmeasured = serve_full(
        "phi3_mini_3_8b")
    pmeasured["busy"], _ = profile_serving(pcfg, pparams, smi,
                                        kernel="flash_fwd_")
    served[pcfg.name] = pmeasured
    del pparams
    torch.cuda.empty_cache()
    small = time_flash_small(smi)
    # phases 22-23: the simulator's price of each net and the frame, from
    # the model grid's table, beside the card's times; they launch nothing
    counts = _counts()
    copy_latency(smi)
    host_s = 1e-6 * _mean_row(new_rows["matmul"])["host_us"]
    table = calibrate.table_backend(cal_records["model"])
    check_table(table, cal_records["model"])
    price_nets(table, host_s, graph_ms, smi)
    price_frame(table, host_s, frame_ms, smi)
    # phases 24-26: the design-space studies and the analytic cost model;
    # no kernel wrapper runs in them either
    pe_study(table, frame_ms, smi)
    soc_study(smi)
    analytic_layer(measured["decode_ms"], frame_ms, smi)
    if _counts() != counts:
        raise AssertionError(f"pricing changed the launch counts: {counts} "
                             f"-> {_counts()}")
    # phase 27 (1): serve_batch's measured batch on the card
    batch_by_variant = serve_batch_full(host_params)
    del host_params
    torch.cuda.empty_cache()
    # phases 29-32: the moe family on the card, each model cut and held
    # against the CPU, then served at full width and depth and profiled;
    # they run before phase 27's pricing, which prices their serving too
    moe_by_path = {}
    for arch in MOE_CUTS:
        check_moe_against_cpu(arch)
        torch.cuda.empty_cache()
        mcfg, mparams, _, m_by_variant, mmeasured = serve_full(arch)
        mmeasured["busy"], _ = profile_serving(mcfg, mparams, smi,
                                            kernel="flash_fwd_")
        served[arch] = mmeasured
        moe_by_path[f"{arch} serving"] = m_by_variant
        del mparams
        torch.cuda.empty_cache()
    # phases 33-35: the hybrid family on the card, zamba2_2_7b cut and held
    # against the CPU, served at full width and depth and profiled; then
    # flash at its prefill shape, head dim 80
    check_model_against_cpu("zamba2_2_7b", ZAMBA_CUT, ZAMBA_PROMPTS)
    torch.cuda.empty_cache()
    zcfg, zparams, _, zamba_by_variant, zmeasured = serve_full("zamba2_2_7b")
    zmeasured["busy"], _ = profile_serving(zcfg, zparams, smi,
                                        kernel="flash_fwd_")
    served[zcfg.name] = zmeasured
    del zparams
    torch.cuda.empty_cache()
    small.update(time_flash_zamba(smi))
    # phases 36-40: the encdec and vlm families on the card, each cut and
    # held against the CPU, then served at full width and depth (each
    # model freed before the next) and profiled; then flash at their
    # prefill shapes
    encdec_vlm_by_path = {}
    for arch, (n_layers, prompts) in ENCDEC_VLM_CUTS.items():
        check_model_against_cpu(arch, n_layers, prompts)
        torch.cuda.empty_cache()
        ecfg, eparams, _, e_by_variant, emeasured = serve_full(arch)
        emeasured["busy"], emeasured["device_ms"] = profile_serving(
            ecfg, eparams, smi, kernel="flash_fwd_")
        if ecfg.family == "vlm":
            weight_bound(ecfg, eparams, emeasured["device_ms"]["decode"],
                         smi)
        served[arch] = emeasured
        encdec_vlm_by_path[f"{arch} serving"] = e_by_variant
        del eparams
        torch.cuda.empty_cache()
    small.update(time_flash_encdec_vlm(smi))
    # phase 27 (2): SERVE priced beside the card; phase 28: the serving
    # studies.  The pricing and the studies launch nothing
    counts = _counts()
    price_serving(served, table, smi)
    serving_studies(smi)
    if _counts() != counts:
        raise AssertionError(f"pricing changed the launch counts: {counts} "
                             f"-> {_counts()}")
    # phases 41-44: training on the card, and gemma3_1b's windowed decode
    grad_err = check_grad_functions(smi)
    # the kernel at the shape training gives it, beside its bound
    small[(TRAIN_FLASH_SHAPE, torch.bfloat16)] = time_flash(
        *TRAIN_FLASH_SHAPE, 0, torch.bfloat16, smi)
    train_err = check_training_against_cpu()
    torch.cuda.empty_cache()
    (train_by_variant, train_ms, train_tok_s, train_gib, train_device,
     train_stage_ms) = train_full(smi)
    torch.cuda.empty_cache()
    windowed_by_variant = serve_windowed(smi)
    # phase 45: phase 43's step priced beside its measure; phase 46: the
    # training and cluster studies.  They launch nothing
    counts = _counts()
    t0 = time.perf_counter()
    price_training({"step_ms": train_ms, "tok_s": train_tok_s,
                    "device_ms": train_device,
                    "stage_ms": train_stage_ms}, smi)
    training_studies(smi)
    log(f"phases 45-46: {time.perf_counter() - t0:.3f} s host")
    if _counts() != counts:
        raise AssertionError(f"pricing changed the launch counts: {counts} "
                             f"-> {_counts()}")
    # phases 47-49: distribution; the NCCL path at world size 1, then two
    # ranks on the one card over gloo (48: EP, DP, a TP MLP; 49: the train
    # step over a 'model' axis)
    t0 = time.perf_counter()
    check_nccl_world1(smi)
    ranks = run_ranks(smi, served[EP_ARCH]["prefill_ms"][-1])
    ep_by_rank = {f"rank {r['rank']}": r["ep_by_variant"] for r in ranks}
    for r in ranks:
        log(f"phase 48 rank {r['rank']}: EP prefill {r['ep_ms']:.3f} ms "
            f"(all_reduce {r['ep_all_reduce_ms']:.3f} ms of a "
            f"{r['ep_timed_ms']:.3f} ms prefill timed with it, "
            f"{100 * r['ep_all_reduce_ms'] / r['ep_timed_ms']:.1f}%), alone "
            f"as one process {r['ep_alone_ms']:.3f} ms, phase 30 "
            f"{served[EP_ARCH]['prefill_ms'][-1]:.3f} ms; expert indices "
            f"equal {100 * r['ep_index_agreement']:.4f}%; DP step "
            f"{ {k: v for k, v in r.items() if k.startswith('dp_')} }; TP "
            f"{ {k: v for k, v in r.items() if k.startswith('tp ')} }; card "
            f"{smi}")
    for r in ranks:
        full = r["tp_full"]
        log(f"phase 49 rank {r['rank']}: cuts "
            f"{ {k: v for k, v in r.items() if k.startswith('tp_cut')} }; "
            f"tinyllama_1_1b {TP_FULL['batch']} x {TP_FULL['seq']} on model "
            f"{EP_RANKS}: {full['ms']:.1f} ms a step (one process alone "
            f"{full['alone_ms']:.1f}), {full['gib']:.3f} GiB a rank over the "
            f"run, {full['step_gib']:.3f} over one step (alone "
            f"{full['alone_gib']:.3f} over its run), collectives {full['collective_ms']:.1f}"
            f" ms of a {full['timed_ms']:.1f} ms timed step "
            f"({100 * full['collective_ms'] / full['timed_ms']:.1f}%), flash "
            f"{full['launches']} a rank; card {smi}")
    log(f"phases 47-50: {time.perf_counter() - t0:.1f} s")
    for r in ranks:
        st = r["serve_tp"]
        log(f"phase 50 rank {r['rank']}: {SERVE_TP['arch']} "
            f"{SERVE_TP['batch']} x {SERVE_TP['prompt_len']} on model "
            f"{EP_RANKS}: prefill {st['prefill_ms']:.1f} ms (alone "
            f"{st['alone_prefill_ms']:.1f}), decode {st['decode_ms']:.2f} ms "
            f"a step (alone {st['alone_decode_ms']:.2f}), greedy equal "
            f"{100 * st['greedy_equal']:.2f}%, flash {st['launches']} a "
            f"rank; card {smi}")
    # phase 51: the three kernels timed in full and sampled; phase 52: the
    # dry run on the host, which launches nothing
    sampled = sampled_kernels(smi)
    dry_run_on_host(train_ms, smi)
    # phases 53-56: the examples, each through its main or its factored
    # functions; flash timed at the shape train_lm's full preset gives it
    t0 = time.perf_counter()
    quickstart_ran, quickstart_rows, quickstart_err = quickstart_example(smi)
    camera_example_ran = camera_example(frame_ms, smi)
    torch.cuda.empty_cache()
    train_lm_ran = train_lm_example(smi)
    torch.cuda.empty_cache()
    small[(TRAIN_LM_SHAPE, torch.bfloat16)] = time_flash(
        *TRAIN_LM_SHAPE, 0, torch.bfloat16, smi)
    serve_batch_ran = serve_batch_example(batch_by_variant, smi)
    log(f"phases 53-56: {time.perf_counter() - t0:.1f} s")
    # phase 57: the tiling optimizer on the card
    tiling_entry = tiling_phase(smi)
    # phase 58: the flash and scan kernels' block shapes from the caller
    flash_tiles, scan_tiles = block_tiles_phase(smi)
    # phase 59: the Mamba1 mixer's coefficient kernels
    coeffs = mamba1_coeffs_phase(smi)
    log(f"training: grad errors {grad_err:.3e} (Functions), {train_err:.3e} "
        f"(card vs CPU); tinyllama_1_1b {train_ms:.1f} ms a step, "
        f"{train_tok_s:.0f} tok/s, {train_gib:.3f} GiB, device ms a step "
        f"{train_device}")
    flash_by_path = {"gemma3_1b serving": by_variant,
                     "phi3_mini_3_8b serving": phi3_by_variant,
                     "calibration": cal_by_variant["flash_attention"],
                     "serve_batch (gemma3_1b)": batch_by_variant,
                     **moe_by_path,
                     "zamba2_2_7b serving": zamba_by_variant,
                     **encdec_vlm_by_path,
                     "tinyllama_1_1b training (4 steps)": train_by_variant,
                     "gemma3_1b serving, windowed_attention":
                         windowed_by_variant,
                     "ep_prefill": ep_by_rank,
                     "tp_cut (tinyllama_1_1b, 4 layers, model 2)": {
                         f"rank {r['rank']}": r[
                             "tp_cut tinyllama_1_1b"]["launches"][
                                 "flash_by_variant"] for r in ranks},
                     f"tp_train (tinyllama_1_1b, model 2, "
                     f"{TP_FULL['steps']} steps)": {
                         f"rank {r['rank']}": r["tp_full"]["by_variant"]
                         for r in ranks},
                     f"serve_tp (gemma3_1b, model 2, prefill + "
                     f"{SERVE_TP['steps']} steps)": {
                         f"rank {r['rank']}": r["serve_tp"]["by_variant"]
                         for r in ranks},
                     "sampling (phase 51)": sampled["flash_attention"],
                     "train_lm example (tinyllama_1_1b, full)": train_lm_ran,
                     "serve_batch example": serve_batch_ran}
    log(f"flash_attention launches by path: {flash_by_path}")
    scan_by_path["tp_cut (falcon_mamba_7b, 4 layers, model 2)"] = {
        f"rank {r['rank']}": r["tp_cut falcon_mamba_7b"]["launches"][
            "mamba_scan"] for r in ranks}
    scan_by_path["sampling (phase 51)"] = sampled["mamba_scan"]
    log(f"mamba_scan launches by path: {scan_by_path}")
    mm_by_path = {"calibration": cal_by_variant["matmul"],
                  **{f"graph batch {b}": n for b, n in graph_by_batch.items()},
                  "camera frame": camera_launches,
                  "sampling (phase 51)": sampled["matmul"],
                  "quickstart example": quickstart_ran,
                  "camera_pipeline example": camera_example_ran}
    log(f"matmul launches by path: {mm_by_path}")
    # one launch of the main path, averaged over its 26-layer local/global
    # mix, in each bf16 variant; the JSON line gives the one serving runs
    sched = T._window_schedule(cfg)
    mix = {w: sched.count(w) / len(sched) for w in rows}
    served = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    avg = {name: {key: sum(mix[w] * rows[w][name][key] for w in rows)
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "host_us")}
           for name in rows[0]}
    log(f"flash_attention serving mix by variant: {avg}")
    by = max(rows.values(),
             key=lambda r: r[served]["bound_ms"])[served]["bound_by"]
    log(smi)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99",
        "launches": launches, "launches_by_variant": by_variant,
        "launches_by_path": flash_by_path,
        "max_abs_err": max_err, **avg[served], "bound_by": by,
        "ms_by_variant": {name: row["ms"] for name, row in avg.items()},
        "head_dims": _head_dim_rows(small),
        "tiles": {"wgmma": flash_tiles["by_variant"]["wgmma"],
                  "max_abs_err": flash_tiles["max_abs_err_bf16"],
                  "seconds": flash_tiles["seconds"]}}, {
        "name": "flash_attention_fp32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99",
        "launches": cal_launches["flash_attention"],
        "launches_by_variant": cal_by_variant["flash_attention"],
        "max_abs_err": max(f32_err, cal_err["attention"]),
        **f32_flash[fa.variant(256, torch.float32)],
        "ms_by_variant": {name: r["ms"] for name, r in f32_flash.items()},
        "tiles": {"tf32x3": flash_tiles["by_variant"]["tf32x3"],
                  "max_abs_err": flash_tiles["max_abs_err"]}}, {
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nvdla_matmul.cu",
        "replaces": "src/repro/kernels/nvdla_matmul.py:60",
        "launches": cal_launches["matmul"],
        "launches_by_variant": cal_by_variant["matmul"],
        "max_abs_err": max(new_err["matmul"], cal_err["matmul"], graph_err,
                           quickstart_err, tiling_entry["max_abs_err"]),
        **_mean_row(new_rows["matmul"]), "ms_by_variant": mm_by_variant,
        "launches_by_path": mm_by_path, "examples": quickstart_rows,
        "tiling": tiling_entry}, {
        # the serving path's shape, with h_S out as prefill runs it
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:59",
        "launches": scan_serve_launches, "launches_by_path": scan_by_path,
        "max_abs_err": max(new_err["mamba_scan"], cal_err["mamba"],
                           state_err),
        **scan_rows["h_S"], "shape": list(serve_shape),
        "ms_by_state": {name: r["ms"] for name, r in scan_rows.items()},
        "model_grid": _mean_row(new_rows["mamba_scan"]),
        "tiles": scan_tiles}, *({
            # falcon_mamba_7b's largest served prefill, 8 x 4000
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_coeffs.cu",
            "replaces": None, "launches": coeffs["launches"][name],
            **coeffs[name][COEFF_SHAPES[-1][1]],
            "shape": list(COEFF_SHAPES[-1]),
            "ms_by_length": {S: r["ms"] for S, r in coeffs[name].items()}}
            for name in ("conv1d_silu", "dt_softplus"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
