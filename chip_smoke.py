#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device and build: the card's name and power limit from ``nvidia-smi``,
   then the CUDA kernels built from ``src/repro_torch/kernels/csrc``.
2. Kernel parity: each kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it and at edge cases, then the
   kernel's, the plain version's and (for flash) ``scaled_dot_product_
   attention``'s device time at the main path's shapes (calls captured in
   a CUDA graph and replayed), beside the wall time of back-to-back
   eager calls. Paged decode is also held at rows of length 0, 1, 7, 8, 9
   and the full capacity behind a NaN trash page, at head dims 16-256,
   groups of 1-20 and 1, 2 and 5 key ranges forced, and timed at 24 slots
   x 43 tokens (one range and two, forced) and at a design length, 256
   slots x 320 tokens with its pools past the L2 cache; beside them the
   launch floor, the device time of a 1-element ``add_``.
3. Small-input agreement: the reduced payload on the card (kernels) and on
   the CPU (plain versions), same seed and noise, in fp32: the same
   sampled tokens, log-likelihoods, scores and accepted designs, through
   the paged design loop and through the dense ``generate`` and
   ``generate_batch``.
4. Main path: ``ProteinPayload`` at the full width of progen-s and
   foldscore-s runs 2 IMPRESS design cycles for 4 pipelines, playing the
   executor's and protocol's part: a fused paged ``generate_batch``, the
   ranking by log-likelihood, a masked ``predict_batch`` on each
   pipeline's top 3 with the peptide appended, and ``fitness`` to accept
   or decline. The kernels' launch counters are zeroed just before and
   read just after: the paged kernel must have run once per layer per
   decode step, the flash kernel once per layer per prompt prefill and
   per ``predict_batch``.
5. Where the time goes: one more design cycle under ``torch.profiler``,
   device time by kernel and the device's busy share; paged decode must
   be one device kernel a layer a decode step, with no combine.
5b. The paper's main path: an im-rp campaign (4 structures, the session's
   defaults, 2 cycles) through the port's ``Coordinator``,
   ``AsyncExecutor`` (2 workers), ``DeviceAllocator`` of the card and
   ``ProteinPayload`` at full width, once in the default form (dense
   ``generate``, solo ``predict``) and once batched (paged
   ``generate_batch`` with live admission, ``predict_batch``). No task may
   fail or retry; the counters, zeroed just before each campaign and read
   just after, must equal what its completed tasks imply, by kernel and
   flash form. Prints the makespan, tasks by kind, occupancy, designs
   accepted by cycle and first calls per shape key, then profiles one
   cycle of each form.
5c. The session: two campaigns through ``ImpressSession`` at full width
   (progen-s, foldscore-s, foldscore-m). A, the paper's comparison: im-rp,
   cont-v and multi-objective on one executor (2 structures, 2 cycles, 6
   candidates), built with ``devices=None`` (every CUDA device); its
   checkpoint survives JSON and ``from_checkpoint`` rebuilds the same
   pipelines, whose run adds no trajectory. B: the staged binder
   (backbone -> seqdesign on the "binder" generator -> fold on the
   foldscore-m "multimer" scorer) beside the rescore co-tenant, 4
   structures at receptor lengths 24 and 32 (campaign-derived length
   buckets, masked forms), fair scheduling. No task may fail or retry,
   every pipeline must finish and every binder pipeline accept 2 designs,
   B's fold stage must fuse tasks, and the counters, zeroed just before
   each campaign and read just after, must equal what its completed tasks
   imply by kernel, flash form and param-set namespace (12 flash launches
   a "multimer" dispatch, 8 a "default" one). Prints makespans (campaign
   and protocol), tasks by kind and stage, dispatches and their run
   times, designs accepted by cycle, length buckets, first calls per shape
   key, ``predict_batch``'s wall time per scorer, whether the binder's
   designs are the same alone and beside the co-tenant, and one profiled
   cycle of B. Every distinct call the flash wrapper got in these runs
   (shapes, dtypes, layout, ``seq_k``: each decode step's) is recorded and
   then held against the plain version on fresh inputs, and a fixed-noise
   ``generate_batch`` on the "binder" namespace must give the tokens of
   the binder generator's weights, not the default one's.
5d. Model evolution at full width (progen-s). (a) The flash kernel's
   autograd Function (``flash_attention_grad``: the kernel's forward,
   which also writes each row's lse, the gradient kernel's backward,
   ``csrc/flash_bwd.cu``, which reads it) at the finetune
   batch's shape, 8 rows x 8/4 heads of 32 over 30 backbone rows + 24
   design tokens, causal, at a ragged length and at a GQA group of 1: its
   forward against the plain version and its dq/dk/dv against autograd
   through ``attention_ref``, each relative to that gradient's max, to
   ``TOL``; one launch a forward and one a backward (the ``backward``
   form), both in the forward's ``ops.tally``; then the forward kernel's,
   the plain version's and sdpa's device time at that shape, and the
   gradient kernel there in bf16 held to autograd, two calls bitwise
   equal, timed beside the plain backward (once), sdpa's backward and
   its bound (``flash_bwd_record``). (b) A
   reduced finetune of 5 steps in fp32 on one set of weights and one batch,
   card against CPU: the same losses and parameters (``EVO_LOSS_RTOL``,
   ``EVO_PARAM_ATOL``). (c) im-rp through ``ImpressSession`` (4
   structures, 3 cycles) without and with ``evolution=True``: no task
   failed, at least one finetune completed and lowered its loss, the store
   is at version 1 or more, the counters equal what the completed tasks
   imply, and each finetune task's own launches (``ops.tally``) are 6
   bf16 flash launches and 6 gradient kernel launches a step it ran
   (preempted runs included); the flash
   kernel is then held to its plain version, and its gradient kernel to
   autograd through ``attention_ref``, at every distinct call both runs
   made. (d) A fixed-noise ``generate_batch`` after it gives the
   tokens of ``progen_sample`` on the evolved weights, not on version
   0's. (e) ``ParamStore.save`` of version 0 and of the evolved version
   through a ``CheckpointManager``; the evolved one restores into a fresh
   store with bitwise logits, then its ``.npz`` is garbled and the restore
   falls back to version 0's copy, bitwise. (f) Prints the makespans with
   and without evolution, each finetune task's steps and wall time,
   designs by generator version, the evolution session's peak device
   memory over what was allocated before it, a train step's wall
   ms and one train step under ``torch.profiler``.
5e. The gateway at full width (progen-s, foldscore-s, the "binder"
   progen-s and the "multimer" foldscore-m): ``GatewayService(devices=
   None, reduced=False, max_workers=4)`` with equal quotas for alice and
   bob, its HTTP front-end (``make_server``, bearer tokens) on 127.0.0.1,
   every campaign submitted, polled and reported over HTTP. Each tenant
   runs ``benchmarks/bench_gateway.py``'s default spec (3 structures at
   receptor lengths 24 and 32, peptide 8, a staged binder of 2 cycles x 6
   candidates, fold batches of 3): (a) alice's campaign to its end, then
   bob's; (b) both live at once. Each prints its makespan, candidates/s,
   cross-tenant fused dispatches (none in (a), at least one in (b)), each
   tenant's p95 queue wait and quota stats from ``GET /metrics``, its
   launches (counters zeroed before, read after, held to what the
   completed tasks imply) and its own peak device memory; no task may fail
   or retry; an unknown bearer gets 401, a foreign report 404, and
   ``/healthz`` answers without a token. (c) carol's im-rp campaign with
   paged decode beside alice's binder under a ``FaultPlan``: a transient
   ``generate_batch`` error retried to done, a slow dispatch, a poison
   ``predict_batch`` row quarantined while its batch-mates complete, a
   corrupted auto-checkpoint after which ``load_campaign_checkpoint``
   falls back to the ``.1`` copy, and a protocol handler that raises
   once, which the supervisor restarts from its auto-checkpoint while
   alice's campaign runs on; the launches (paged decode one a layer a
   decode step) equal what the completed tasks imply. Device loss needs a
   second card and is not run. (d) ``python -m repro_torch.launch.serve
   --gateway --port 0 --checkpoint-dir D`` in a subprocess: a campaign
   over HTTP to its end, then SIGINT during a second one: exit 0, the
   campaign checkpointed and "gateway stopped" printed, the checkpoint
   restored by ``ImpressSession.from_checkpoint``. Every distinct flash
   and paged decode call of (a)-(c) is then held to its plain version.
5f. ``launch/train.py`` at full progen-s width: 6 steps of 8 rows x (64
   patches + 128 tokens) with a checkpoint every 3, a restore that runs 3
   more from step 6, and an uninterrupted 9-step run with the same losses
   (``TRAIN_LOSS_RTOL``); each step's own launches (``ops.tally``) one
   bf16 flash launch and one gradient kernel launch a layer; flash at that
   shape held and timed beside sdpa, and the gradient kernel there
   (``flash_bwd_record``, the ``flash_attention_bhsd_bwd_train`` record);
   flash and its gradient kernel held at every distinct call the steps
   made (``hold_flash_calls``); ms a step, tokens/s, one profiled step.
6. The LM serving path at full width: ``serve_batch`` on rwkv6-7b (32
   layers, d 4096, bf16 compute, seeded weights drawn on the card), one
   prefill of 8 x 512 tokens and 31 greedy decode steps through the
   RWKV-6 state. The counters are zeroed just before and read just after:
   the wkv6 kernels must have run once per layer per prefill (the prefill
   kernel) and per decode step (the decode kernel), the attention kernels
   not at all. Then a full-width fp32 check
   that the T=1 decode path agrees with one prefill over the same tokens,
   and one decode step under ``torch.profiler``.
7. recurrentgemma-2b serving at full width: ``serve_batch`` (26 layers,
   18 RG-LRU and 8 local-attention, d 2560, seeded weights drawn on the
   card), one prefill of 8 x 2560 tokens (past the 2048 window, so the
   window mask, the ring's rotation and its wrap at decode all run) and 31
   greedy decode steps. The counters must show the rglru kernel once per
   RG-LRU layer (its staged form at the prefill, its serial form at a
   decode step) and the flash kernel once per local-attention layer, per
   prefill (its fp32 sequence form) and per decode step (its decode form,
   over the bf16 ring in place), and the other two kernels not at all.
   Then the full-width fp32 per-layer check over a prompt past the window,
   and one decode step over a full ring under ``torch.profiler``.
8. The dense decoders and whisper's encoder-decoder. (a) llama3-8b,
   chatglm3-6b, smollm-360m, nemotron-4-15b, llava-next-34b (with its
   patch stub) and whisper-small (with its frame stub) reduced in fp32,
   card vs CPU as in 3b: the same greedy tokens, ``lm.generate`` the same,
   then each layer's prefill + decode held to one prefill on the card
   (``layer_consistency``); reduced smollm's head dim of 20 is not
   compiled, so a card call there must raise ``ValueError`` and it runs
   at head dim 16. (b) nemotron-4-15b and llava-next-34b whole on the meta
   device: parameters outside the norms equal ``param_count``, the total
   in the reference's range. (c) ``serve_batch`` at full width, one model
   at a time (``ARCH_SERVES``; ``serve_cfg`` keeps the deepest depth whose
   weights fit in the card's free memory, the cut and its reckoning
   printed): prefill ms and tokens/s,
   decode ms a step and tokens/s, peak memory, every logit finite. (d)
   The counters, zeroed before each serve: flash one sequence launch a
   layer at prefill (whisper: 12 encoder, 12 self, 12 cross) and one
   decode launch a self- or cross-attention layer a step. (e) Every
   distinct flash call of the six serves held to the plain version. (f)
   The kernel at llama3-8b's prefill and decode and whisper's encoder,
   cross prefill and cross decode, timed beside the plain version and
   sdpa, with its bound. (g) One llama3-8b decode step under
   ``torch.profiler``.
9. Mixture-of-experts and qk-norm: qwen3-moe-30b-a3b and
   llama4-maverick-400b-a17b. (a) Both reduced in fp32, card vs CPU as in
   8a (capacity form: the same greedy tokens, ``lm.generate`` the same),
   then each layer's prefill + decode held to one prefill on the card in
   the dense form (``moe_impl="dense"``: the capacity form routes a
   prompt's tokens in one group and a decode step's alone, so only the
   dense form makes the two agree). (b) Both whole on the meta device:
   parameters outside the norms equal ``param_count``, the totals and
   active counts in the reference's ranges. (c) ``serve_batch`` at full
   width (``MOE_SERVES``: 8 x 512 prompt tokens, 32 generated), each at
   the deepest depth of its segment's repeats whose weights (by each
   parameter's dtype: llama4's bf16, its routers fp32) and the draw's
   fp32 slice fit, the cut and its reckoning printed; prefill and decode
   ms and tokens/s, peak memory, every logit finite. (d) Counters zeroed
   before each serve: flash once a layer at prefill and once a layer a
   decode step, no other kernel. (e) Every distinct flash call of the two
   serves held to the plain version. (f) Flash at qwen3's prefill and
   decode, timed beside the plain version and sdpa, with its bound. (g)
   One qwen3 decode step under ``torch.profiler``, its device time by
   kind (casts, routing: sort, scatter and gather, GEMMs, flash).
10. Training the SSM archs. (a) The autograd Functions of the path on the
   card: ``WKV6`` at 8 x 64 x 512 x 64 in fp32 and bf16 and, in fp32, with
   logw at its two ends (-e^5 and -1e-6), at a tensor-parallel rank's 4 x
   16 x 512 x 64 and at the reduced K = 16 (4 x 4 x 40 x 16), ``RGLRU`` at
   8 and 4 x 2560 x 2560 and ``FlashAttention`` at recurrentgemma-2b's 8 x 10/1 x
   2560, hd 256, window 2048, fp32; each gradient at a seeded upstream
   against autograd through the plain version, relative to its max, to
   ``TOL``; one launch a forward, and a backward's (WKV6's gradient kernel:
   one; RGLRU's gradient kernel: one; flash's gradient kernel: one), which
   autograd runs on its own thread, counted in the forward's ``ops.tally``;
   each backward's time a call beside its forward kernel's. WKV6's gradient
   kernel also against its own algorithm (``wkv6_bwd_chunk_ref``) and
   the token-serial oracle (``wkv6_bwd_serial_ref``) at 2 x 8 x 45 x 64
   with dS absent; RG-LRU's gradient kernel (``rglru_bwd``) bitwise its
   plain version (``rglru_bwd_ref``) at both shapes, and at 8 x 2560
   timed beside its bound (4 x 2560's time is (f)'s record). Flash's
   gradient kernel at 8 x 10/1 x 2560 (the ``flash_attention_bhsd_bwd``
   record) and at phase 12's context-parallel chunks of rank 3, 4 x 10/1
   x 128 over 512 keys at offset 384 (hd 256, window 2048, fp32) and 4 x
   15/5 x 128 likewise (hd 64, bf16), records of their own: held to
   autograd, two calls bitwise equal, timed beside the plain backward
   (once), sdpa's backward and the bound (``flash_bwd_record``). (b) Both
   archs reduced in fp32 with remat "full": 5 ``make_train_step`` steps on
   the card and on the CPU from one set of weights and batches, losses to
   1e-5 relative and weights to 1e-4 (5d b's tolerances), each card step's
   launches held. (c) ``launch/train.py`` at full width, bf16 compute, the
   configs' remat "full" and CE chunks, ``SSM_TRAIN_STEPS`` steps, no
   checkpoint: rwkv6-7b at 8 x 512 and recurrentgemma-2b at 4 x 2560, each
   at the deepest depth (of its first segment's repeats) whose 16 bytes a
   parameter, kept layer inputs and a step's transient memory, measured on
   a one-repeat model, fit with ``SERVE_HEADROOM`` to spare, the reckoning
   printed; losses finite, every weight leaf moved; ms a step, tokens/s,
   peak memory. (d) Each step's launches (``ops.tally``) and the counters
   (zeroed before, read after): wkv6's prefill form twice a ``rwkv`` layer
   (forward and remat's recompute) and its backward form once, rglru three
   times an ``rglru`` layer (forward and recompute in the staged form, 10b's
   24 tokens in the serial one, and its gradient kernel, the ``backward``
   form), flash's fp32 sequence form twice an
   ``attn_local`` layer and its
   gradient kernel once, nothing else. (e) One more step of each under
   ``torch.profiler`` (the device alone), device time by kind
   (``TRAIN_KINDS``) and by each of flash's and WKV6's three gradient
   kernels (``kernel_split``); flash and its gradient kernel held at every
   distinct call of (c) (``hold_flash_calls``). (f) rglru, its gradient
   kernel (bitwise ``rglru_bwd_ref``, the ``rglru_btc_bwd`` record) and
   flash's fp32 form timed at recurrentgemma-2b's 4 x 2560, records of
   their own; rglru's forward also at phase 11a's 4 x 512 x 2560,
   printed. (g) WKV6's gradient kernel at rwkv6-7b's 8 x 64 x 512 x 64
   in fp32 and bf16 and at phase 11a's 4 x 64 x 512 x 64 in bf16: held to
   autograd through the plain version, two calls bitwise equal, timed
   beside the plain backward (``_bwd_plain`` on the card) and its bound at
   the split-TF32 rate (the record's: the kernel's products run there) and,
   printed beside it, at the fp32 FMA rate; the bf16 8 x 64 one is the
   ``wkv6_bhtk_bwd`` record.
11. Sharding and cost accounting on a one-rank NCCL mesh (1, 1) over
   ("data", "model"), the card being one GPU (multi-rank numerics are the
   CPU tests' ``tests/test_torch_mesh_train.py``). (a) ``launch/train.py``
   with ``--mesh none`` and then ``--mesh sim`` from seed 0
   (``MESH_TRAINS``: smollm-360m at 16 of 32 layers, 8 x 512; rwkv6-7b at
   2 layers and recurrentgemma-2b at one (rglru, rglru, attn_local)
   block, 4 x 512; full width, 4 steps): every mesh parameter a DTensor,
   losses within 1e-5 and weights within 1e-4 relative of the unsharded
   run, each step's
   launches (``ops.tally``) the unsharded run's by kernel and form and the
   remat rule's; the gathered uses and gradient reductions a step; flash
   and its gradient kernel held at every distinct call of both runs
   (``hold_flash_calls``). (b) A
   mesh checkpoint at step 2 of smollm-360m: the loss of step 3 from the
   saved weights, the restored mesh run's and a ``--mesh none`` launcher's
   restored from the same file all bitwise equal. (c) One smollm-360m mesh
   step under ``distributed.cost``'s counter: its ``Roofline`` record
   (FLOPs, bytes and collective bytes a device, attention and mixer tags,
   6·N·D), the measured step time and the step's model-FLOP share (mfu)
   at the bf16 peak; then one more step under ``torch.profiler`` (the
   device alone), device time by kind and by each of flash's three
   gradient kernels. (d) ``python -m
   repro_torch.launch.dryrun`` for llama3-8b ``train_4k`` (sequence
   parallel) and ``decode_32k`` (the head-dim fallback of KV 8 on 16
   ranks), rwkv6-7b ``decode_32k``, smollm-360m ``train_4k`` (sequence
   and context parallel: 15 heads on 16 ranks) and
   llama4-maverick-400b-a17b ``decode_32k`` (its experts on their model
   and data ranks, no weight gathered) on the single-pod mesh, in
   subprocesses on fake 256-rank groups started with the phase (they run
   on the host beside (a)-(c)): each roofline line (t_comp, t_mem, t_coll,
   mfr), its bottleneck and its collective bytes by kind. (e) Flash and
   its gradient kernel at smollm-360m's train shape (8 x 15/5 x 512, hd
   64, bf16), records of their own (``flash_bwd_record`` for the
   gradient). Since the step is tensor-parallel over "model", a one-rank
   mesh computes the unsharded code path.
12. Tensor-parallel training over "model". (a) The kernels at the local
   shapes the split hands each rank, held to their plain versions and timed
   beside their bounds (flash beside sdpa), records of their own: flash at
   llama3-8b's 4 x 8/2 x 512 and chatglm3-6b's 4 x 8/1 x 512 (hd 128,
   bf16), wkv6's forward and gradient kernels at rwkv6-7b's 4 x 16 x 512
   x 64, rglru at recurrentgemma-2b's 4 x 512 x 640; then flash 4 x 10/1 x
   512 (fp32, hd 256) and wkv6 4 x 64 x 512 x 64, phase 11's shapes, held
   and timed. (b)
   Four processes on the card join a gloo group with CUDA tensors (NCCL
   refuses two ranks on one device) as a (1, 4) ("data", "model") mesh;
   each of ``TP_TRAINS`` (llama3-8b, chatglm3-6b, rwkv6-7b and
   smollm-360m at 2 layers, recurrentgemma-2b at one block,
   qwen3-moe-30b-a3b at 1 layer, its 4 groups one a rank) trains
   ``TP_STEPS`` steps of 4 x 512 with ``launch/train.py``, in fp32 and in
   its config's bf16, against ``--mesh none`` run in this process from the
   same seed, whose gradients and weights the ranks read by CUDA IPC:
   every step's loss to 1e-5 (fp32; rwkv6-7b's first step only) or 2e-2
   (bf16), the first step's gradients to ``tp_grad_tol`` of each leaf's
   max, each step's launches the unsharded step's by kernel and form, and
   that sequence and context parallelism ran where the configs ask
   (llama3-8b, chatglm3-6b and smollm-360m split the residual stream, each
   rank's 128 positions in every layer; smollm-360m's and
   recurrentgemma-2b's attention computes each rank's 128 queries at its
   offset: the residual's shape and flash's (Sq, q_offset) a rank;
   qwen3's expert products one group of every expert a rank, no parameter
   gathered over model);
   printed: the weights, each rank's step walls, all-reduces a step and
   their bytes, FLOPs and MFU (one step under ``distributed.cost``'s
   counter). (c) Serving in the same four
   ranks: each of ``TP_TRAINS`` and llama4-maverick-400b-a17b (1 of its
   24 pairs at full width, each rank drawing and holding its 32 of the 128
   experts) prefills 4 x 512 seeded tokens under the
   train rules on the (1, 4) mesh (the rank's cache shards, its vocab
   slice of the logits) and decodes ``TP_DECODE`` steps on the serve
   rules' shards, fed --mesh none's greedy tokens, in fp32 and in its
   config's dtype; llama3-8b also on a (2, 2) mesh over the same ranks,
   whose decode multiplies each weight's "data2d" slice where it lies.
   Held against --mesh none run here: every call's logits
   (``tp_logit_tol`` of their max; a MoE arch's bf16 row whose last token
   was routed otherwise left out and counted), the fp32 greedy tokens,
   the MoE archs' expert products over each rank's experts and no
   parameter gathered over model, each call's
   launches by kernel and form, each cache shard's shape as
   ``cache_spec_tree`` places it, no all-gather in a decode step, the
   prefill's flash at each rank's chunk where context parallelism holds;
   printed: a decode step's wall and collectives a rank. Eight more
   records hold and time the kernels at the serving ranks' local shapes
   (``tp_serve_records``), two flash at llama4's (``ep_records``). (d)
   llama4's MoE block at full width, forward and backward on bf16 leaves
   over 4 x 512 tokens: unsharded here first, then every rank on its
   sequence chunk with its 32 experts; the output, the input's and the
   router's gradients, the aux values and each rank's expert gradients
   (read by CUDA IPC, against the whole gradient held in host memory)
   within 2e-2 of their max; each rank's peak memory printed.
13. One ``{"kernels": [...]}`` JSON line (flash at the finetune shape is
   its own record, its launches those of phase 5d's finetune tasks; flash
   at the train launcher's shape too, its launches phase 5f's; flash's
   gradient kernel in bf16 is the ``flash_attention_bhsd_bwd_finetune``
   record, its launches those of phase 5d's finetune tasks, and at 5f's
   shape the ``flash_attention_bhsd_bwd_train`` record, its launches 5f's
   steps'; phase 5e's launches are added to the records of the forms it
   ran; phase 8's five shapes are records of their own, their launches
   phase 8's serves'; phase 9's two likewise; phase 10's wkv6 prefill
   launches are added to phase 6's record, its shape, its wkv6 backward
   launches are the ``wkv6_bhtk_bwd`` record's, its rglru and flash
   launches are the 4 x 2560 records' (rglru's gradient kernel's the
   ``rglru_btc_bwd`` record's, with 11a's and 12's rank 0's), and its
   flash gradient launches
   the ``flash_attention_bhsd_bwd`` record's (fp32, recurrentgemma-2b);
   phase 11's mesh runs add theirs to the records of the kernels and
   forms they ran (recurrentgemma-2b's gradient launches to
   ``flash_attention_bhsd_bwd``), smollm-360m's flash shape its own, for
   the forward and the gradient kernel;
   phase 12's bf16 runs are the five local-shape records' launches (the
   wkv6 backward's ``wkv6_bhtk_bwd_tp``), rank 0's (llama4's serving the
   two ``ep_records``'), the context-parallel chunks' records (2c, and
   10a's gradient records) those of the ranks at their offsets, its
   serving prefills adding to the same records and its (2, 2) prefill and
   decode steps the eight serving records' launches),
   the total time, the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Phase 2 holds the flash kernel's bf16 sequence form (``mma.sync``) against
both the plain version and the tiled algebra it repeats
(``attention_tiled_ref``) and times it at three protein shapes beside
sdpa. It also holds the wkv6 kernels (2b: prefill and decode, the prefill
one also against ``wkv6_serial_ref``), the rglru kernel (2c: bitwise its
plain version, in the form each shape takes, ``staged`` from one ring
stage of tokens up and ``serial`` below it or at C % 4 != 0) and the flash
kernel at head dim 256 against their plain versions and times them;
2c also holds the flash kernel's decode form (one query over strided ring
views, bf16 K/V beside an fp32 q, every head dim, groups of 1 to 20 query
heads) and its fp32 sequence form (every head dim, ragged lengths, window,
softcap, no mask), and times both at recurrentgemma-2b's shapes; then
both sequence forms (and the decode form for one query) at a query offset
(``flash_offset_parity``: chunks 0 and 3 of 4 of 512 tokens in bf16 and
fp32, the last 640 queries of 2560 keys past the 2048 window, one-query
chunks, rows with no live key, each chunk's rows against the whole
call's), and times the context-parallel ranks' chunks of phase 12
beside sdpa on the same masked problem (``cp_records``). 2d holds
the decode form at the dense sampler's shape (6 rows x 8/4 heads of 32,
bf16, the whole 89-slot cache as strided views with ``seq_k`` its filled
slots) and at the binder seqdesign's (12 rows over 89 and 97 slots), at
the first, middle and last step, at 1, 2, the automatic
(``decode_key_splits``: 1) and ``decode_splits``' number of key ranges,
in bf16 and fp32, checks that recurrentgemma-2b's
decode keeps 16, and times it beside sdpa. Phase 3 also holds the reduced
rwkv6 (3b) and recurrentgemma (3c) models on the card against the CPU.

Imports neither jax nor the reference package. Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from importlib import metadata
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # flash, as the CPU tests
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
WKV_STATE_TOL = {"atol": 1e-4, "rtol": 1e-3}       # test_kernels.py's own
# rwkv6-7b serving (phase 6): batch x prompt tokens, tokens generated
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
# recurrentgemma-2b serving (phase 7): a prompt past the 2048 window, not a
# multiple of it
RG_BATCH, RG_PROMPT, RG_GEN = 8, 2560, 32
RGLRU_TOL = 1e-5                                 # test_kernels.py's own
# the port's kernels, as the profiler names them
PORT_KERNELS = ("decode_attention_", "flash_fwd_", "flash_bwd_", "wkv6_",
                "rglru_kernel", "rglru_staged_kernel", "rglru_bwd_kernel")
# session defaults (repro/session.py): receptor 24 + peptide 6, 6 candidates
RECEPTOR, PEPTIDE, N_CAND, TOP_K = 24, 6, 6, 3
# the campaign phase (5b): the session's im-rp defaults, two cycles, in the
# default form (dense generate, solo predict) and the batched form
CAMPAIGN_FORMS = {"default": {},
                  "batched": {"generate_batch_size": 4, "score_batch": 3,
                              "decode_kernel": True}}
CAMPAIGN_CYCLES = 2
# the session phase (5c): two cycles a protocol; campaign B's mixed lengths
SESSION_CYCLES, SESSION_B_LENS = 2, (24, 32)
# model evolution (5d): the im-rp session at the session's evolution
# defaults (a finetune every 2 accepted designs once 2 are held, 12 AdamW
# steps on up to 8 designs); 4 structures x 3 cycles, no sub-pipelines
EVO_STRUCTURES, EVO_CYCLES, EVO_BATCH = 4, 3, 8
# card vs CPU finetune (5d b), as tests/test_torch_evolution.py states it:
# losses to a relative 1e-5, every parameter to 1e-4 after 5 steps
EVO_LOSS_RTOL, EVO_PARAM_ATOL = 1e-5, 1e-4
# the gateway (5e): two tenants running bench_gateway.py's default binder
# spec at full width (3 structures, 2 cycles), a third tenant's im-rp
# campaign with paged decode under a fault plan; bearer tokens by tenant
GATEWAY_TENANTS, GATEWAY_STRUCTURES = ("alice", "bob"), 3
GATEWAY_TOKENS = {"tok-alice": "alice", "tok-bob": "bob",
                  "tok-carol": "carol"}
FAULTED_SPEC = {"structures": 2, "receptor_len": RECEPTOR,
                "peptide_len": PEPTIDE, "seed": 2, "reduced": False,
                "protocols": [{"kind": "im-rp", "n_cycles": 2,
                               "n_candidates": N_CAND,
                               "generate_batch_size": 4, "score_batch": 3,
                               "decode_kernel": True,
                               "max_sub_pipelines": 0}]}
# the train launcher (5f): rows x tokens a step (after the 64-row patch
# prefix); the resumed run's losses against the uninterrupted run's (the
# embedding's backward accumulates with atomics on the card)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LOSS_RTOL = 8, 128, 1e-4
# phase 8: the dense decoders and whisper-small at full width, one
# serve_batch each: arch -> (rows, prompt tokens, tokens generated). Each
# is served at the deepest depth whose fp32 weights fit in the card's free
# memory with SERVE_HEADROOM bytes to spare (llava-next-34b whole is
# 137.6 GB of fp32 weights); the headroom holds the bf16 casts of the
# head and of one layer at use, the activations and the caches (a
# 16-layer nemotron-4-15b peaked 4.1 GB over its weights on an NVIDIA
# H100 80GB HBM3 at 700 W)
ARCH_SERVES = {"llama3-8b": (8, 512, 32),
               "chatglm3-6b": (8, 512, 32),
               "smollm-360m": (8, 512, 32),
               "nemotron-4-15b": (8, 512, 32),
               "llava-next-34b": (8, 128, 32),
               "whisper-small": (8, 64, 32)}
SERVE_HEADROOM = 8e9
# phase 9: the two MoE archs at full width, as ARCH_SERVES
MOE_SERVES = {"qwen3-moe-30b-a3b": (8, 512, 32),
              "llama4-maverick-400b-a17b": (8, 512, 32)}
# phase 10: launch/train.py on the SSM archs at full width: arch -> (rows,
# tokens a row), rwkv6-7b at phase 6's prompt shape, recurrentgemma-2b past
# its 2048 window and not a multiple of it; steps a run (3 since phase 12
# took smollm-360m, 2 since it took the MoE archs, to keep the script near
# 600 s)
SSM_TRAINS = {"rwkv6-7b": (8, 512), "recurrentgemma-2b": (4, 2560)}
SSM_TRAIN_STEPS = 2
# phase 10b: card vs CPU, reduced, fp32, remat full: rows x tokens, steps;
# losses to 1e-5 relative and weights to 1e-4 after them (phase 5d b's)
SSM_AGREE_SHAPES = {"rwkv6-7b": (4, 40), "recurrentgemma-2b": (4, 24)}
SSM_AGREE_STEPS = 5
# phase 11: launch/train.py --mesh sim on a one-rank NCCL mesh, at full
# width: arch -> (rows, tokens a row, layers kept; None: the whole model).
# smollm-360m keeps 16 of its 32 layers (since phase 12 took it, to keep
# the script near 600 s), rwkv6-7b 2 layers, recurrentgemma-2b one repeat
# of its (rglru, rglru, attn_local) block, so its local attention runs
MESH_TRAINS = {"smollm-360m": (8, 512, 16), "rwkv6-7b": (4, 512, 2),
               "recurrentgemma-2b": (4, 512, 3)}
MESH_STEPS = 4
# mesh against --mesh none from one seed: the finetune's tolerances (5d b)
MESH_LOSS_RTOL, MESH_WEIGHT_RTOL = 1e-5, 1e-4
# phase 11d: launch/dryrun.py cells on the single-pod mesh
DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("rwkv6-7b", "decode_32k"),
                ("llama3-8b", "decode_32k"), ("smollm-360m", "train_4k"),
                ("llama4-maverick-400b-a17b", "decode_32k"))
DRYRUN_TIMEOUT_S = 600
# phase 12: launch/train.py tensor-parallel over "model" on a (1, 4) mesh of
# four processes sharing the one card over gloo with CUDA tensors (NCCL
# refuses two ranks on one device), at full width: arch -> layers kept
# (recurrentgemma-2b one (rglru, rglru, attn_local) block); rows x tokens,
# steps; each arch once in fp32 (the check) and once in its config's
# compute dtype (the path). llama3-8b, chatglm3-6b and smollm-360m set
# sequence_parallel: their residual stream is each rank's 128 of the 512
# positions; smollm-360m's 15 heads (KV 5) and recurrentgemma-2b's 10 do
# not divide 4: their attention computes each rank's 128 queries at its
# offset (context parallelism)
TP_TRAINS = {"llama3-8b": 2, "chatglm3-6b": 2, "rwkv6-7b": 2,
             "recurrentgemma-2b": 3, "smollm-360m": 2, "qwen3-moe-30b-a3b": 1}
# phase 12, expert parallelism (PR 28): qwen3-moe-30b-a3b trains and serves
# with TP_TRAINS at 1 of its 48 layers (the train rules replicate its
# experts over model: ~9.7 GB a rank a layer with AdamW), its 4 groups one
# a rank (an all-to-all over model under sequence parallelism), its experts
# on model at serve time. llama4-maverick-400b-a17b serves (no training: its
# fp32 experts alone would take 16.1 GB a rank, ~64 GB with gradients and
# AdamW moments) at 1 of its 24 (attn, moe) pairs, each rank drawing and
# holding its 32 of the 128 experts (8.05 GB in bf16, lm.init_lm with the
# mesh); its MoE block at full width runs forward and backward on bf16
# leaves (EP_BLOCK_SEED's input), the unsharded block first (32.2 + 32.2
# GB), each rank's experts' gradients held against it piece by piece from
# host memory
TP_SERVES = {"llama4-maverick-400b-a17b": 2}
EP_ARCH, EP_BLOCK_SEED = "llama4-maverick-400b-a17b", 47
EP_PIECE = 4            # experts a piece of the gradients' comparison
TP_RANKS, TP_MESH = 4, (1, 4)
# 2 steps a run since phase 12 took the MoE archs (4 before), to keep the
# script near 600 s: qwen3's replicated experts' gradient is a 2.4 GB fp32
# all-reduce over model a step, staged through the host by gloo
TP_BATCH, TP_SEQ, TP_STEPS = 4, 512, 2
# against --mesh none from one seed: every step's loss, to 1e-5 in fp32 and
# 2e-2 in bf16; rwkv6-7b's fp32 losses after the first step are printed,
# since AdamW's normalized step carries the split's rounding into its
# zero-initialised leaves (its mu_x: ~1 of the leaf's max after 4 steps)
TP_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the first step's gradients (the same weights), each leaf's max error over
# its max: in fp32 to the card's bound against autograd (2e-5: phases 5d,
# 10a); where splitting every feed-forward down-projection's sum in 4, with
# no mesh, moves the unsharded step's gradients further (this table, read
# by tools/tp_rounding.py at phase 12's shapes on an NVIDIA H100 80GB HBM3
# at 700 W; the unsplit step repeats bitwise), to TP_FLOOR_X times that
# move. rwkv6-7b's bf16 `u` gradient is a leaf 133x below the model's
# largest, whose sum cancels: one split moves it 1.79 of its max.
# smollm-360m's bf16 move is its first norm's scale (1.391e-2 of its max);
# its fp32 move, 2.052e-6, is under TP_GRAD_RTOL. qwen3-moe-30b-a3b has no
# MLP: its move is that of splitting attention's output projection over
# its heads (tools/tp_rounding.py --attn), which in bf16 flips a few
# tokens' top-8 choices, moving an expert's gradient 0.556 of the leaf's
# max (fp32: 2.973e-6)
TP_SPLIT_MOVES = {("rwkv6-7b", "float32"): 3.334e-3,
                  ("qwen3-moe-30b-a3b", "bfloat16"): 5.556e-1,
                  ("llama3-8b", "bfloat16"): 1.345e-2,
                  ("chatglm3-6b", "bfloat16"): 1.370e-2,
                  ("rwkv6-7b", "bfloat16"): 1.787,
                  ("recurrentgemma-2b", "bfloat16"): 3.356e-3,
                  ("smollm-360m", "bfloat16"): 1.391e-2}
TP_GRAD_RTOL, TP_FLOOR_X = 2e-5, 10
TP_TIMEOUT_S = 400          # a config's four ranks, from its task to results
# phase 12, serving: after training, each arch of TP_TRAINS at its depth
# prefills TP_BATCH x TP_SEQ seeded tokens under the train rules on the
# (1, 4) mesh and decodes TP_DECODE steps on the serve rules' shards, fed
# --mesh none's greedy tokens, in fp32 (the check) and its config's dtype
# (the path); llama3-8b also on TP_SERVE_2D's (2, 2) mesh over the same
# four ranks, whose decode multiplies each weight's "data2d" slice where it
# lies. That prefill's copy stores the weights with fsdp off: the train
# rules' FSDP storage needs an all-gather at use, which gloo never
# completes for CUDA tensors (tools/gloo_cuda_probe.py); the serve rules
# shard the would-be-FSDP dims over "data" either way
TP_DECODE = 8
TP_SERVE_2D = ("llama3-8b", (2, 2))
# each rank's logits (gathered over the vocab) against --mesh none's rows,
# max error over max |logit|; fp32 also the same greedy tokens. Where
# splitting every feed-forward down-projection's sum in 4, with no mesh,
# moves --mesh none's own logits so far that the arch cannot meet that
# (this table, read by tools/tp_rounding.py --serve at phase 12's shapes
# on an NVIDIA H100 80GB HBM3 at 700 W; the unsplit run repeats bitwise),
# to TP_FLOOR_X times that move: rwkv6-7b's state carries one step's
# rounding into the next
TP_LOGIT_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
TP_SERVE_SPLIT_MOVES = {("rwkv6-7b", "float32"): 7.072e-05,
                        ("rwkv6-7b", "bfloat16"): 2.214e-02}


def expect(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check(label, err, tol):
    print(f"  {label}: max_abs_err {err:.3e} (tol {tol:.0e})", flush=True)
    expect(err <= tol, f"{label}: max_abs_err {err} > {tol}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def wall_ms(torch, fn, iters=200, warmup=20):
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: for launches this small, the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_events(prof):
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def graph_ms(torch, fn, iters=20, replays=10):
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch gaps are not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(n_bytes, n_ops, dtype, peak=None):
    """The least time for the work: bytes over the memory rate or operations
    over the peak rate for their type (or ``peak``), whichever is larger
    (the card's rates: ``distributed.roofline``)."""
    from repro_torch.distributed.roofline import HBM_BW, PEAK_FLOPS_BY_DTYPE
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = n_ops / (peak or PEAK_FLOPS_BY_DTYPE[dtype]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound(q, k, v, causal=True, window=0, seq_k=None, q_offset=0):
    """(bound ms, what bounds it) of one flash call on these tensors, its
    bytes and operations from ``distributed.cost.flash_work``: q read and
    the output written, K and V read once over the keys some query reads,
    4 hd operations a live (q, k) pair at the queries' offset, at the peak
    of q's dtype."""
    from repro_torch.distributed import cost
    B, H, Sq, hd = q.shape
    flops, n_bytes = cost.flash_work(
        B, H, k.shape[1], Sq, k.shape[2] if seq_k is None else seq_k, hd,
        q.element_size(), k.element_size(), causal, window, q_offset)
    return bound_ms(n_bytes, flops, dtype_name(q.dtype))


def flash_bwd_bound(q, k, v, causal=True, window=0, seq_k=None,
                    q_offset=0):
    """(bound ms, what bounds it) of attention's gradient on these tensors,
    its work from ``distributed.cost.flash_bwd_work`` at the queries'
    offset, at the peak the gradient kernel's products can reach: bf16's on
    the tensor cores, or for fp32 a third of TF32's (each product three
    TF32 ones, ``roofline.PEAK_FLOPS_SPLIT_TF32``)."""
    from repro_torch.distributed import cost
    from repro_torch.distributed.roofline import PEAK_FLOPS_SPLIT_TF32
    B, H, Sq, hd = q.shape
    flops, n_bytes = cost.flash_bwd_work(
        B, H, k.shape[1], Sq, k.shape[2] if seq_k is None else seq_k, hd,
        q.element_size(), k.element_size(), causal, window, q_offset)
    dt = dtype_name(q.dtype)
    return bound_ms(n_bytes, flops, dt,
                    PEAK_FLOPS_SPLIT_TF32 if dt == "float32" else None)


def flash_forms(**n):
    """The flash kernel's launches by form (``ops.forms``): zero but for
    ``n``."""
    return dict({"decode": 0, "seq_f32": 0, "seq_bf16": 0, "backward": 0},
                **n)


def sdpa_bwd_ms(torch, fn, xs, do, reps):
    """Device ms of one backward of ``fn(*xs)`` (sdpa): its forward and
    ``torch.autograd.grad`` captured in one CUDA graph, less the forward
    alone, each by ``graph_ms`` (``reps``: its iters and replays)."""
    return (graph_ms(torch, lambda: torch.autograd.grad(fn(*xs), xs, do),
                     **reps) - graph_ms(torch, lambda: fn(*xs), **reps))


def flash_bwd_errors(torch, q, k, v, kw, do, got):
    """[(max abs error, its gradient's max |d|)] of the gradient kernel's
    dq, dk, dv ``got`` against autograd through ``attention_ref`` on the
    same inputs and upstream ``do``."""
    from repro_torch.kernels import flash_attention as fa

    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(fa.attention_ref(*xs, **kw), xs, do)
    return [(max_err(a, b), float(b.float().abs().max()) or 1.0)
            for a, b in zip(got, want)]


def flash_bwd_record(torch, name, label, q, k, v, kw, sdpa_kw):
    """One ``{"kernels": ...}`` record of flash's gradient kernel at a main
    path's shape: at a seeded upstream and the forward kernel's o and lse,
    its dq, dk, dv against autograd through ``attention_ref`` (``TOL``,
    relative to each gradient's max) and two calls bitwise equal; then the
    device ms by CUDA-graph replay of the kernel and of sdpa's backward
    (``sdpa_bwd_ms``, the same masked problem, ``enable_gqa``), the plain
    backward's wall time once (``attention_lse`` + ``attention_bwd``,
    between events) and the bound (``flash_bwd_bound``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(q.shape[2] + q.shape[1])
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    o, lse = fa.flash_attention_bhsd(q, k, v, return_lse=True, **kw)
    run_k = lambda: fa.flash_attention_bwd_bhsd(           # noqa: E731
        q, k, v, o, do, lse=lse, **kw)
    got, again = run_k(), run_k()
    expect(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"flash's gradient kernel {label}: two calls differ")
    errs = flash_bwd_errors(torch, q, k, v, kw, do, got)
    for n, (e, scale) in zip("qkv", errs):
        check(f"flash's gradient kernel {label} d{n} vs autograd / max |d|",
              e / scale, TOL[dtype_name(q.dtype)])
    err = max(e for e, _ in errs)
    del got, again
    big = q.shape[2] > 1000            # tens of ms a call
    reps = dict(iters=2, replays=3) if big else {}
    ms = graph_ms(torch, run_k, **reps)
    flash_bwd_dq_cuts(torch, q, k, v, o, do, lse, kw, ms, reps)
    plain = wall_ms(torch, lambda: fa.attention_bwd(
        q, k, v, o, fa.attention_lse(q, k, **kw), do, **kw), iters=1,
        warmup=1)
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa: E731
        q_, k_, v_, enable_gqa=k.shape[1] < q.shape[1], **sdpa_kw)
    lib = sdpa_bwd_ms(torch, sdpa, [x.detach().requires_grad_()
                                    for x in (q, k, v)], do, reps)
    b_ms, b_by = flash_bwd_bound(q, k, v, **kw)
    print(f"  flash's gradient kernel {label}, device ms per call: kernel "
          f"{ms:.4f}, plain backward {plain:.4f} (wall, once), sdpa's "
          f"backward {lib:.4f} (its forward and backward in one graph less "
          f"its forward), bound {b_ms:.6f} ({b_by}, "
          f"{100 * b_ms / ms:.1f}% of it); two calls bitwise equal; err "
          f"{err:.3e}", flush=True)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:82",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def flash_bwd_dq_cuts(torch, q, k, v, o, do, lse, kw, ms, reps):
    """Prints the gradient kernel's device ms with its dq walks cut the
    other way than ``bwd_segments`` cuts them at this shape (cut where its
    grid has ``BWD_FILL`` blocks or more, whole under), beside ``ms``, its
    time as cut: a reading on each side of the threshold."""
    from repro_torch.kernels import flash_attention as fa
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    seq_k, off = kw.get("seq_k"), kw.get("q_offset", 0)
    geo = (B, KV, Sq, Sk, Sk if seq_k is None else seq_k, causal, window,
           off, H // KV, fa.bwd_step(hd, q.dtype))
    cut = fa.bwd_segments(*geo)
    flip = fa.bwd_segments(*geo, fill=0 if cut[3] > 1 else 1 << 30)
    if flip == cut:
        return
    alt = graph_ms(torch, lambda: fa._launch_bwd(
        q, k, v, o, do, lse, causal, window, seq_k, off, segments=flip),
        **reps)
    blocks = -(-(H // KV) * Sq // fa.BWD_HELD) * KV * B
    print(f"  dq walks ({blocks} blocks, cut under {fa.BWD_FILL}): in "
          f"{cut[3]} segments {ms:.4f} ms, in {flip[3]} {alt:.4f} ms",
          flush=True)


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def check_close(label, got, want, atol, rtol):
    """``|got - want| <= atol + rtol |want|`` everywhere (numpy's
    ``assert_allclose``, as the CPU tests hold it); returns the max abs
    error."""
    got, want = got.float(), want.float()
    excess = float(((got - want).abs() - rtol * want.abs()).max())
    err = max_err(got, want)
    print(f"  {label}: max_abs_err {err:.3e} (atol {atol:.0e}, rtol "
          f"{rtol:.0e})", flush=True)
    expect(excess <= atol, f"{label}: error exceeds atol {atol} + rtol "
           f"{rtol} |want| by {excess - atol}")
    return err


def dtype_name(dt):
    return str(dt).split(".")[1]


def paged_inputs(torch, rng, lengths, dtype, *, KV=4, G=2, hd=32, page=8,
                 maxp=11, trash=float("nan")):
    """Paged decode inputs on the card, one row a length, at progen-s'
    heads and its 24-slot engine's 11 pages of 8 by default: every row's
    live pages drawn from a scrambled pool, every page past its length the
    trash page (the pool's last), which holds ``trash``: NaN by default,
    so that a key read past a row's length shows as NaN."""
    import numpy as np
    B = len(lengths)
    P = B * maxp + 1
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    q, kp, vp = mk(B, KV, G, hd), mk(P, KV, page, hd), mk(P, KV, page, hd)
    kp[P - 1] = vp[P - 1] = trash
    order = rng.permutation(P - 1)
    bt = np.full((B, maxp), P - 1, np.int32)
    for b, n in enumerate(lengths):
        live = -(-int(n) // page)
        bt[b, :live] = order[b * maxp:b * maxp + live]
    t = lambda a, dt=None: torch.from_numpy(a).to("cuda", dt)
    return (t(q, dtype), t(kp, dtype), t(vp, dtype), t(bt),
            t(np.asarray(lengths, np.int32)), page)


def paged_parity(torch, rng):
    """The paged kernel against its plain version: random lengths at the
    protein engine's shapes (24 and 32 slots), then rows of length 0, 1,
    7, 8, 9, the full capacity, 40 and 65 behind a NaN trash page at every
    head dim and groups of 1 to 20, at the wrapper's range count and
    forced to 1, 2 and 5 ranges (5: more ranges than a row has tiles), and
    a batch with no active row."""
    from repro_torch.kernels import paged_attention as pa

    for B in (24, 32):
        for dt in (torch.float32, torch.bfloat16):
            lengths = rng.integers(0, 11 * 8 + 1, size=B)
            lengths[::5] = 0
            q, kp, vp, bt, lens, page = paged_inputs(torch, rng, lengths, dt)
            got = pa.paged_decode_bkgh(q, kp, vp, bt, lens, page_size=page)
            want = pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
            torch.cuda.synchronize()
            check(f"paged_decode B={B} {dtype_name(dt)}", max_err(got, want),
                  PAGED_TOL[dtype_name(dt)])
            expect(bool((got[lens == 0] == 0).all()),
                   "paged_decode: inactive rows are not exactly zero")
    lengths = (0, 1, 7, 8, 9, 72, 40, 65)
    for G, hd in ((1, 16), (2, 16), (4, 16), (1, 32), (2, 32), (4, 32),
                  (2, 64), (8, 128), (20, 256)):
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, lens, page = paged_inputs(
                torch, rng, lengths, dt, KV=2, G=G, hd=hd, maxp=9)
            want = pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
            worst = 0.0
            for n_split in (None, 1, 2, 5):
                got = pa.paged_decode_bkgh(
                    q, kp, vp, bt, lens, page_size=page) if n_split is None \
                    else pa._launch(q, kp, vp, bt, lens, page, n_split)
                torch.cuda.synchronize()
                expect(bool(torch.isfinite(got).all()),
                       "paged_decode read a key past a row's length")
                expect(bool((got[lens == 0] == 0).all()),
                       "paged_decode: inactive rows are not exactly zero")
                worst = max(worst, max_err(got, want))
            check(f"paged_decode edges G={G} hd {hd} {dtype_name(dt)}, "
                  f"lengths {lengths}, NaN trash page, 1/1/2/5 ranges",
                  worst, PAGED_TOL[dtype_name(dt)])
    q, kp, vp, bt, lens, page = paged_inputs(torch, rng, (0,) * 24,
                                             torch.bfloat16)
    for n_split in (1, 3):
        got = pa._launch(q, kp, vp, bt, lens, page, n_split)
        expect(bool((got == 0).all()), "paged_decode: no active row, "
               f"{n_split} ranges: not exactly zero")
    print("  paged_decode with no active row: exact zeros at 1 and 3 ranges",
          flush=True)


def time_paged(torch, pa, rng, B, n_tok, maxp, n_split=None, cold=False):
    """Device time of paged decode at progen-s' heads in bf16: ``B`` slots
    of ``n_tok`` cached tokens each, ``maxp`` pages of 8 a row; the kernel
    at ``n_split`` ranges (None: the wrapper's choice), the plain version,
    and the bound. With ``cold`` the calls rotate over input sets past 100
    MB, twice the L2 cache, as a model's layers would find their pools.
    ``pa`` is the module of the tree under test, so older trees can be
    timed alike: the trash page holds zeros, since a plain version that
    weighs a dead key's value by 0 turns a NaN there into NaN. Returns a
    dict of the numbers."""
    import numpy as np
    from repro_torch.distributed import cost
    KV, G, hd = 4, 2, 32
    n_ops, n_bytes = cost.paged_work(B, KV, G, hd, B * n_tok, maxp, 2)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    sets = [paged_inputs(torch, rng, np.full(B, n_tok), torch.bfloat16,
                         maxp=maxp, trash=0.0)
            for _ in range(-(-100_000_000 // n_bytes) if cold else 1)]
    if n_split is None:
        kernel = lambda q, kp, vp, bt, lens, page: pa.paged_decode_bkgh(
            q, kp, vp, bt, lens, page_size=page)
    else:
        kernel = lambda q, kp, vp, bt, lens, page: pa._launch(
            q, kp, vp, bt, lens, page, n_split)
    q, kp, vp, bt, lens, page = sets[0]
    err = max_err(kernel(*sets[0]),
                  pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page))
    turn = itertools.cycle(sets)
    run_k = lambda: kernel(*next(turn))

    def run_p():
        q, kp, vp, bt, lens, page = next(turn)
        return pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
    reps = dict(iters=4, replays=3) if cold else {}
    out = {"ms": graph_ms(torch, run_k), "plain_ms": graph_ms(
        torch, run_p, **reps), "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err, "wall_ms": wall_ms(torch, run_k),
        "bytes": n_bytes}
    del sets, turn
    return out


def launch_floor_ms(torch):
    """Device time of the smallest launch that reads and writes device
    memory: a 1-element ``add_`` under the same CUDA-graph replay as the
    kernels' times."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(torch, lambda: x.add_(1.0))


def phase_kernels(torch):
    """Parity of both kernels against their plain versions, then timings at
    the main path's shapes. Returns the kernel records for the JSON line."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    print("phase 2: kernel parity on the card", flush=True)
    paged_parity(torch, rng)

    flash_cases = [  # label, (B, H, KV, S, hd), kwargs
        ("foldscore S=32", (4, 8, 8, 32, 32), {}),
        ("foldscore S=64", (4, 8, 8, 64, 32), {}),
        ("progen prefill GQA S=31", (1, 8, 4, 31, 32), {}),
        ("progen prefill GQA S=65", (1, 8, 4, 65, 32), {}),
        ("window 24", (2, 8, 8, 64, 32), {"window": 24}),
        ("softcap 20", (2, 8, 8, 64, 32), {"softcap": 20.0}),
        ("seq_q=seq_k=37 of 48", (2, 8, 8, 48, 32),
         {"seq_q": 37, "seq_k": 37}),
        ("non-causal", (2, 4, 4, 50, 32), {"causal": False}),
        ("hd 16 GQA", (1, 4, 2, 80, 16), {}),
        ("hd 64", (1, 2, 2, 64, 64), {}),
        ("hd 128 window", (1, 2, 1, 40, 128), {"window": 7}),
        ("hd 256 GQA", (2, 8, 2, 70, 256), {}),
        ("S = 1 + a tile, GQA", (2, 8, 4, 33, 32), {}),
        ("non-causal window 9, seq_k 40 of 64", (2, 4, 2, 64, 32),
         {"causal": False, "window": 9, "seq_k": 40}),
        # the campaign's own shapes (phase 5b): the dense generate's prefill
        # of 6 candidates, the solo predict, and predict_batch at exact
        # length in each row bucket it pads a dispatch to
        ("dense generate prefill 6 x GQA S=31", (6, 8, 4, 31, 32), {}),
        ("solo predict S=30", (1, 8, 8, 30, 32), {}),
        *((f"predict_batch {b} rows S=30", (b, 8, 8, 30, 32), {})
          for b in (2, 4, 8, 16)),
        # the session's (phase 5c, campaign B, which also holds every shape
        # its run gives the kernel): the binder's seqdesign prefill, 2 rows
        # of 6 candidates, at each receptor length, and the fold stage's
        # masked foldscore-m forward at the longer length bucket
        *((f"binder seqdesign prefill {2 * N_CAND} x GQA S={r + PEPTIDE + 1}",
           (2 * N_CAND, 8, 4, r + PEPTIDE + 1, 32), {})
          for r in SESSION_B_LENS),
        *((f"fold stage {b} rows S={SESSION_B_LENS[-1] + PEPTIDE}",
           (b, 8, 8, SESSION_B_LENS[-1] + PEPTIDE, 32), {})
          for b in (2, 4, 8)),
    ]
    for label, (B, H, KV, S, hd), kw in flash_cases:
        # rows with no live key: past seq_q, or past seq_k + window - 1
        # without the causal mask; the kernel writes exact zeros there
        no_key = torch.arange(S, device="cuda") >= kw.get("seq_q", S)
        if kw.get("window", 0) > 0 and not kw.get("causal", True):
            no_key |= torch.arange(S, device="cuda") - kw["window"] + 1 \
                >= kw.get("seq_k", S)
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, S, hd, device="cuda").to(dt)
            k = torch.randn(B, KV, S, hd, device="cuda").to(dt)
            v = torch.randn(B, KV, S, hd, device="cuda").to(dt)
            got = fa.flash_attention_bhsd(q, k, v, **kw)
            want = fa.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            expect(bool((got[:, :, no_key] == 0).all()),
                   "flash: rows without a live key are not exactly zero")
            check(f"flash {label} {dtype_name(dt)}", max_err(got, want),
                  TOL[dtype_name(dt)])
            if dt == torch.bfloat16:   # the mma form's own algebra
                check(f"flash {label} bf16 vs attention_tiled_ref",
                      max_err(got, fa.attention_tiled_ref(q, k, v, **kw)),
                      TOL["bfloat16"])

    # timings at the main path's shapes, in bf16 as the path runs them;
    # paged decode also at a design length (256 slots x 320 tokens: a
    # 64-row backbone + BOS + 255 residues), with its pools past the L2
    print(f"  launch floor (a 1-element add_, CUDA-graph replay): "
          f"{launch_floor_ms(torch):.4f} ms", flush=True)
    smem = fa.decode_smem_bytes
    print(f"  decode body (paged and flash decode): dynamic shared memory a "
          f"block {smem(32, 2)} B at hd 32 bf16, {smem(32, 4)} B fp32, "
          f"{smem(256, 2)} B at hd 256 bf16, {smem(256, 4)} B fp32",
          flush=True)
    records = []
    for name, B, n_tok, maxp, cold in (
            ("paged_decode_bkgh", 24, 43, 11, False),
            ("paged_decode_bkgh_256x320", 256, 320, 40, True)):
        r = time_paged(torch, pa, rng, B, n_tok, maxp, cold=cold)
        n_split = pa.paged_decode_splits(
            B, 4, 2, maxp, 8,
            torch.cuda.get_device_properties(0).multi_processor_count)
        cold_note = ", pools past the L2" if cold else ""
        print(f"  paged_decode at {B} slots x {n_tok} cached tokens bf16 "
              f"({n_split} range a row{cold_note}), device ms per call: "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.6f} ({r['bound_by']}, {r['bytes']} B), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; wall per "
              f"back-to-back call: kernel {r['wall_ms']:.4f}; err "
              f"{r['max_abs_err']:.3e}", flush=True)
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:120",
            "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    turns = [(n, time_paged(torch, pa, rng, 24, 43, 11, n_split=n)["ms"])
             for n in (1, 2, 2, 1)]
    print("  paged_decode at 24 slots x 43 tokens bf16, ranges forced (2: "
          "the split kernel and the combine), device ms per call in turns: "
          + ", ".join(f"{n} range{'s' * (n > 1)} {ms:.4f}" for n, ms in turns),
          flush=True)
    dt = torch.bfloat16

    print(f"  flash bf16 sequence form (mma.sync): dynamic shared memory "
          f"a block of {fa.MMA_ROWS} rows {fa.mma_smem_bytes(32)} B at hd 32,"
          f" {fa.mma_smem_bytes(256)} B at hd 256", flush=True)
    for label, (B, H, KV, S, hd) in (
            ("predict_batch 4 rows x 32 tokens", (4, 8, 8, 32, 32)),
            ("prefill 1 row x 31 tokens GQA", (1, 8, 4, 31, 32)),
            ("prefill 1 row x 65 tokens GQA", (1, 8, 4, 65, 32)),
            ("dense generate prefill 6 rows x 31 tokens GQA",
             (6, 8, 4, 31, 32)),
            ("solo predict 1 row x 30 tokens", (1, 8, 8, 30, 32))):
        q = torch.randn(B, H, S, hd, device="cuda", dtype=dt)
        k = torch.randn(B, KV, S, hd, device="cuda", dtype=dt)
        v = torch.randn(B, KV, S, hd, device="cuda", dtype=dt)
        run_k = lambda: fa.flash_attention_bhsd(q, k, v)
        run_p = lambda: fa.attention_ref(q, k, v)
        run_l = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=H != KV)
        err = max_err(run_k(), run_p())
        b_ms, b_by = flash_bound(q, k, v)
        ms, plain, lib = (graph_ms(torch, run_k), graph_ms(torch, run_p),
                          graph_ms(torch, run_l))
        print(f"  flash {label} bf16, device ms per call: kernel {ms:.4f}, "
              f"plain {plain:.4f}, sdpa {lib:.4f}, bound {b_ms:.6f} "
              f"({b_by}); wall per back-to-back call: kernel "
              f"{wall_ms(torch, run_k):.4f}, sdpa "
              f"{wall_ms(torch, run_l):.4f}; err {err:.3e}", flush=True)
        if len(records) == 2:      # the record holds the predict_batch shape
            records.append({
                "name": "flash_attention_bhsd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:82",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib})
    return records


def wkv_inputs(torch, g, B, H, T, K, dtype, s0=True, logw_ends=False):
    """wkv6 inputs on the card: r/k/v 0.5 N(0,1) in ``dtype``, logw
    -exp(N(0,1)) in fp32 (or alternating -e^5 and -1e-6, the two ends
    ``rwkv_streams`` clips to), u 0.3 + 0.1 N(0,1), s0 0.1 N(0,1) or zero
    (a fresh prefill's)."""
    import numpy as np
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    r, k, v = ((0.5 * mk(B, H, T, K)).to(dtype) for _ in range(3))
    logw = -torch.exp(mk(B, H, T, K))
    if logw_ends:
        logw[..., ::2] = -float(np.exp(5.0))
        logw[..., 1::2] = -1e-6
    s = 0.1 * mk(B, H, K, K) if s0 else torch.zeros(B, H, K, K,
                                                     device="cuda")
    return r, k, v, logw, 0.3 + 0.1 * mk(H, K), s


def wkv_bound(B, H, T, K, elem):
    """(bound ms, what bounds it, bytes) of one wkv6 call, its work from
    ``distributed.cost.wkv6_work``: r/k/v read and y written in the compute
    dtype, logw read in fp32, u read, s0 read and s_T written in fp32; two
    fp32 multiply-adds per state element per token."""
    from repro_torch.distributed import cost
    n_ops, n_bytes = cost.wkv6_work(B, H, T, K, elem)
    return (*bound_ms(n_bytes, n_ops, "float32"), n_bytes)


def phase_wkv6(torch):
    """Parity of the wkv6 kernels (prefill, T > 1, and decode, T = 1)
    against the plain version on the card, the prefill kernel also against
    its own algebra (``wkv6_serial_ref``) where T is short, then their and
    the plain version's device time at the serving path's prefill and
    decode shapes. Returns the two forms' JSON records."""
    from repro_torch.kernels import rwkv6

    print("phase 2b: wkv6 parity on the card", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, K = SERVE_BATCH, 64, 64
    cases = [  # label, (B, H, T, K), kwargs
        ("prefill 8x64x512x64, s0 = 0", (B, H, SERVE_PROMPT, K),
         {"s0": False}),
        ("decode 8x64x1x64", (B, H, 1, K), {}),
        ("ragged T=33", (2, 8, 33, K), {}),
        ("prime T=31", (2, 8, 31, K), {}),
        ("reduced K=16, T=70", (2, 4, 70, 16), {}),
        ("nonzero s0, T=100", (4, 16, 100, K), {}),
        ("logw at -e^5 and -1e-6, T=40", (2, 8, 40, K), {"logw_ends": True}),
        ("T=2", (2, 8, 2, K), {}),
        ("reduced K=16, logw at the ends, T=33", (2, 4, 33, 16),
         {"logw_ends": True}),
    ]
    for label, shape, kw in cases:
        for dt in (torch.float32, torch.bfloat16):
            args = wkv_inputs(torch, g, *shape, dt, **kw)
            y, s = rwkv6.wkv6_bhtk(*args)
            y_ref, s_ref = rwkv6.wkv6_ref(*args)
            torch.cuda.synchronize()
            expect(y.dtype == dt and s.dtype == torch.float32,
                   f"wkv6 dtypes {y.dtype} {s.dtype}")
            name = dtype_name(dt)
            check_close(f"wkv6 {label} {name} y", y, y_ref, TOL[name],
                        TOL[name])
            check_close(f"wkv6 {label} {name} s_T", s, s_ref,
                        **WKV_STATE_TOL)
            if 1 < shape[2] <= 100:
                y_ser, s_ser = rwkv6.wkv6_serial_ref(*args)
                check_close(f"wkv6 {label} {name} y vs wkv6_serial_ref", y,
                            y_ser, TOL[name], TOL[name])
                check_close(f"wkv6 {label} {name} s_T vs wkv6_serial_ref", s,
                            s_ser, **WKV_STATE_TOL)

    # timings at the serving path's shapes, in bf16 as the path runs them
    return [dict(time_wkv6(torch, g, B, H, T, K, label),
                 name="wkv6_bhtk" if T > 1 else "wkv6_bhtk_decode")
            for label, T in (("prefill", SERVE_PROMPT), ("decode", 1))]


def time_wkv6(torch, g, B, H, T, K, label):
    """wkv6 at (B, H, T, K) in bf16, as the paths run it: the kernel held
    to the plain version (phase 2b's tolerance), then the kernel's and the
    plain version's device time per call and the bound. Calls rotate
    over enough input sets to fill twice the 50 MB L2, as the path's calls
    find their state cold (a layer's weights pass through L2 between two
    calls). Returns the kernel's record without its name."""
    from repro_torch.kernels import rwkv6

    dt = torch.bfloat16
    b_ms, b_by, n_bytes = wkv_bound(B, H, T, K, 2)
    sets = [wkv_inputs(torch, g, B, H, T, K, dt, s0=T == 1)
            for _ in range(-(-100_000_000 // n_bytes))]
    err = check_close(f"wkv6 {label} {B}x{H}x{T}x{K} bf16 y vs wkv6_ref",
                      rwkv6.wkv6_bhtk(*sets[0])[0],
                      rwkv6.wkv6_ref(*sets[0])[0], TOL["bfloat16"],
                      TOL["bfloat16"])
    turn = itertools.cycle(sets)
    run_k = lambda: rwkv6.wkv6_bhtk(*next(turn))                # noqa: E731
    run_p = lambda: rwkv6.wkv6_ref(*next(turn))                 # noqa: E731
    ms = graph_ms(torch, run_k)
    plain = graph_ms(torch, run_p, iters=4, replays=3)
    print(f"  wkv6 {label} {B}x{H}x{T}x{K} bf16, device ms per call: "
          f"kernel {ms:.4f}, plain {plain:.4f}, bound {b_ms:.6f} "
          f"({b_by}); wall per back-to-back call: kernel "
          f"{wall_ms(torch, run_k):.4f}; err {err:.3e}", flush=True)
    return {"route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:69", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def rglru_inputs(torch, g, B, T, C, h0=True):
    """rglru inputs on the card: a = sigmoid(N(0,1)), b = 0.3 N(0,1) (the
    reference kernel test's draws), h0 N(0,1) or zero (a fresh prefill's)."""
    a = torch.sigmoid(torch.randn(B, T, C, generator=g, device="cuda"))
    b = 0.3 * torch.randn(B, T, C, generator=g, device="cuda")
    h = torch.randn(B, C, generator=g, device="cuda") if h0 else \
        torch.zeros(B, C, device="cuda")
    return a, b, h


def ring_view(torch, g, B, L, KV, n, hd, dtype):
    """The first n slots of a (B, L, KV, hd) ring cache as a (B, KV, n, hd)
    strided view; with n = L the whole cache, as ``attn_decode`` hands it
    to the decode form (with ``seq_k`` its filled slots)."""
    ring = torch.randn(B, L, KV, hd, generator=g, device="cuda").to(dtype)
    return ring[:, :n].transpose(1, 2)


def flash_form_parity(torch, g):
    """The flash kernel's decode form and fp32 sequence form against the
    plain version: the decode form over strided ring views, as
    ``attn_decode`` calls it, at every head dim; the sequence form at
    every head dim with ragged lengths, a window, softcap and no mask."""
    from repro_torch.kernels import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    decode_cases = [  # (B, H, KV, L, n, hd): n of a ring of L slots
        (8, 10, 1, 2048, 2048, 256),   # recurrentgemma-2b, ring filled
        (2, 10, 1, 2048, 1, 256),      # 1 key, 64 ranges
        (3, 2, 1, 2048, 127, 256),     # G 2
        (2, 4, 4, 2048, 1337, 256),    # G 1
        (1, 20, 1, 300, 300, 256),     # G 20: two blocks of query rows
        (2, 8, 4, 96, 43, 32), (2, 4, 2, 64, 64, 16), (3, 4, 1, 500, 333, 64),
        (2, 6, 3, 200, 150, 128),
    ]
    for B, H, KV, L, n, hd in decode_cases:
        for qdt, kvdt in ((f32, bf16), (f32, f32), (bf16, bf16)):
            q = torch.randn(B, H, 1, hd, generator=g, device="cuda").to(qdt)
            k, v = (ring_view(torch, g, B, L, KV, n, hd, kvdt)
                    for _ in range(2))
            got = fa.flash_attention_bhsd(q, k, v, causal=False)
            want = fa.attention_ref(q, k, v, causal=False)
            torch.cuda.synchronize()
            check(f"flash decode {B}x{H}/{KV} over {n} of {L} keys hd {hd}, "
                  f"q {dtype_name(qdt)} K/V {dtype_name(kvdt)}",
                  max_err(got, want), TOL[dtype_name(qdt)])
    q = torch.randn(2, 4, 1, 64, generator=g, device="cuda")
    k = ring_view(torch, g, 2, 90, 2, 90, 64, f32)
    for kw in ({"softcap": 5.0, "causal": False}, {}, {"seq_q": 0}):
        check(f"flash decode {kw}", max_err(
            fa.flash_attention_bhsd(q, k, k, **kw),
            fa.attention_ref(q, k, k, **kw)), TOL["float32"])

    seq_cases = [  # label, (B, H, KV, S), kwargs
        ("seq_q 70, seq_k 61 of 77", (2, 4, 2, 77),
         {"seq_q": 70, "seq_k": 61}),
        ("window 33, softcap 10", (1, 4, 1, 130), {"window": 33,
                                                   "softcap": 10.0}),
        ("non-causal", (2, 2, 2, 65), {"causal": False}),
        ("non-causal seq_k 40 window 9", (1, 3, 1, 100),
         {"causal": False, "seq_k": 40, "window": 9}),
    ]
    for hd in fa.HEAD_DIMS:
        for label, (B, H, KV, S), kw in seq_cases:
            q = torch.randn(B, H, S, hd, generator=g, device="cuda")
            k = torch.randn(B, KV, S, hd, generator=g, device="cuda")
            v = torch.randn(B, KV, S, hd, generator=g, device="cuda")
            got = fa.flash_attention_bhsd(q, k, v, **kw)
            want = fa.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            if "seq_q" in kw:
                expect(bool((got[:, :, kw["seq_q"]:] == 0).all()),
                       "flash: rows past seq_q are not exactly zero")
            check(f"flash fp32 sequence hd {hd} {label}", max_err(got, want),
                  TOL["float32"])


def time_flash_decode(torch, g, B, H, L, hd):
    """The decode form as the recurrentgemma-2b path calls it: an fp32
    query a head over the bf16 ring's L filled slots, read in place; then
    the same over fp32 K/V. Device time of the kernel, the plain version
    and sdpa (fp32, no mask: every key is live, so it is the same
    function; sdpa takes one dtype, so it gets the ring widened to fp32).
    Returns the kernel's JSON record."""
    import torch.nn.functional as F
    from repro_torch.distributed import cost
    from repro_torch.kernels import flash_attention as fa

    record = None
    for kvdt in (torch.bfloat16, torch.float32):
        kv_elem = 2 if kvdt == torch.bfloat16 else 4
        n_ops, n_bytes = cost.flash_work(B, H, 1, 1, L, hd, 4, kv_elem,
                                         causal=False)
        b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
        sets = []
        for _ in range(-(-100_000_000 // n_bytes)):
            q = torch.randn(B, H, 1, hd, generator=g, device="cuda")
            k, v = (ring_view(torch, g, B, L, 1, L, hd, kvdt)
                    for _ in range(2))
            sets.append((q, k, v, k.float(), v.float()))
        err = max_err(fa.flash_attention_bhsd(*sets[0][:3], causal=False),
                      fa.attention_ref(*sets[0][:3], causal=False))
        turn = itertools.cycle(sets)
        run_k = lambda: fa.flash_attention_bhsd(*next(turn)[:3],
                                                causal=False)
        run_p = lambda: fa.attention_ref(*next(turn)[:3], causal=False)

        def run_l():
            q, _, _, k32, v32 = next(turn)
            return F.scaled_dot_product_attention(q, k32, v32,
                                                  enable_gqa=True)
        ms, plain, lib = (graph_ms(torch, run_k), graph_ms(torch, run_p),
                          graph_ms(torch, run_l))
        print(f"  flash hd 256 decode {B}x{H}x1 over {L} {dtype_name(kvdt)} "
              f"ring keys in place, fp32 q (split-KV form), device ms per "
              f"call: kernel {ms:.4f}, plain {plain:.4f}, sdpa (fp32 K/V, no "
              f"mask) {lib:.4f}, bound {b_ms:.6f} ({b_by}); wall per "
              f"back-to-back call: kernel {wall_ms(torch, run_k):.4f}, sdpa "
              f"{wall_ms(torch, run_l):.4f}; err {err:.3e}", flush=True)
        if record is None:             # the record holds the path's dtypes
            record = {
                "name": "flash_attention_bhsd_hd256_decode", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
                "replaces": "src/repro/kernels/flash_attention.py:82",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib}
        del sets, turn
    return record


def phase_dense_decode(torch):
    """Phase 2d: flash's decode form at the dense sampler's shape, as a
    campaign's ``generate`` calls it (6 candidates of one backbone, 8/4
    heads of 32, one query over the first n slots of a (6, 89, 4, 32)
    cache: 64 + 1 + 24 slots; a 30-row backbone + BOS fills 31, and the 23
    decode steps read 32..54), handed the whole cache with ``seq_k = n`` as
    ``attn_decode`` does, and at the binder seqdesign's (12 rows over the
    89- and 97-slot caches of receptors 24 and 32). Held to the plain
    version at the first, middle and last step at 1, 2, the automatic
    (``decode_key_splits``: 1 over 89 slots) and ``decode_splits``' count
    (which ignores the key capacity) of key ranges in bf16 (q and cache, as
    the path runs it) and fp32, then timed by CUDA-graph replay beside sdpa
    (``enable_gqa``) over the n filled slots and its byte bound. Also
    checks that recurrentgemma-2b's decode (8 x 10/1 heads over its
    2048-key ring) keeps 16 ranges. Returns the kernel's JSON record."""
    import torch.nn.functional as F
    from repro_torch.distributed import cost
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa

    B, H, KV, hd = N_CAND, 8, 4, 32
    L = 64 + 1 + RECEPTOR
    sms = _cuda.sm_count(torch.device("cuda", 0))
    blocks = B * KV * -(-(H // KV) // fa.DECODE_GROUP)
    auto = fa.decode_key_splits(blocks, L, sms)
    blind = fa.decode_splits(blocks, sms)
    rg = fa.decode_key_splits(RG_BATCH * 1 * -(-10 // fa.DECODE_GROUP), 2048,
                              sms)
    print(f"phase 2d: flash decode form at the dense sampler's shape: "
          f"{B} x {H}/{KV} heads of {hd}, one query over n of {L} cache "
          f"slots (strided views of the whole cache, seq_k = n), {auto} key "
          f"range{'s' * (auto > 1)} by decode_key_splits ({blind} by "
          f"decode_splits alone); recurrentgemma-2b's 2048-key ring: {rg}",
          flush=True)
    expect(auto == 1 and rg == 16,
           f"decode_key_splits: {auto} at the dense sampler's shape, {rg} at "
           f"recurrentgemma-2b's ring (want 1 and 16)")
    g = torch.Generator(device="cuda").manual_seed(4)

    def run(q, k, v, n, n_split):
        return fa._launch_decode(q, k, v, False, 0.0, 1, n, n_split=n_split)

    # the dense sampler's shape, then the binder's seqdesign (phase 5c):
    # 2 rows of 6 candidates over the cache of each receptor length r, a
    # prompt of r + peptide + BOS, r - 1 decode steps
    shapes = [(B, L, 31)] + [(2 * N_CAND, 64 + 1 + r, r + PEPTIDE + 1)
                             for r in SESSION_B_LENS]
    for rows, slots, prompt in shapes:
        steps = slots - 64 - 1 - 1
        rows_blocks = rows * KV * -(-(H // KV) // fa.DECODE_GROUP)
        splits = {1, 2, fa.decode_key_splits(rows_blocks, slots, sms),
                  fa.decode_splits(rows_blocks, sms)}
        for dt in (torch.bfloat16, torch.float32):
            # the first, middle and last step
            for n in (prompt + 1, prompt + 1 + steps // 2, prompt + steps):
                q = torch.randn(rows, H, 1, hd, generator=g,
                                device="cuda").to(dt)
                k, v = (ring_view(torch, g, rows, slots, KV, slots, hd, dt)
                        for _ in range(2))
                want = fa.attention_ref(q, k, v, causal=False, seq_k=n)
                for n_split in sorted(splits):
                    got = run(q, k, v, n, n_split)
                    torch.cuda.synchronize()
                    check(f"flash decode {rows}x{H}/{KV} over {n} of {slots} "
                          f"keys {dtype_name(dt)}, {n_split} range"
                          f"{'s' * (n_split > 1)}", max_err(got, want),
                          TOL[dtype_name(dt)])
    n = 43
    dt = torch.bfloat16
    q = torch.randn(B, H, 1, hd, generator=g, device="cuda").to(dt)
    k, v = (ring_view(torch, g, B, L, KV, L, hd, dt) for _ in range(2))
    err = max_err(fa.flash_attention_bhsd(q, k, v, causal=False, seq_k=n),
                  fa.attention_ref(q, k, v, causal=False, seq_k=n))
    n_ops, n_bytes = cost.flash_work(B, H, KV, 1, n, hd, 2, 2, causal=False)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
    run_k = lambda: fa.flash_attention_bhsd(q, k, v, causal=False, seq_k=n)
    run_p = lambda: fa.attention_ref(q, k, v, causal=False, seq_k=n)
    kn, vn = k[:, :, :n], v[:, :, :n]
    run_l = lambda: F.scaled_dot_product_attention(q, kn, vn,
                                                   enable_gqa=True)
    ms, plain, lib = (graph_ms(torch, run_k), graph_ms(torch, run_p),
                      graph_ms(torch, run_l))
    turns = [(ns, graph_ms(torch, lambda: run(q, k, v, n, ns)))
             for ns in (1, 2, blind, blind, 2, 1)]
    print(f"  flash decode {B}x{H}/{KV}x1 over {n} of {L} bf16 cache keys "
          f"in place, bf16 q ({auto} range{'s' * (auto > 1)}, automatic), "
          f"device ms per call: kernel {ms:.4f}, plain {plain:.4f}, sdpa "
          f"{lib:.4f}, bound {b_ms:.6f} ({b_by}, {n_bytes} B); wall per "
          f"back-to-back call: kernel {wall_ms(torch, run_k):.4f}, sdpa "
          f"{wall_ms(torch, run_l):.4f}; err {err:.3e}", flush=True)
    print("  same call, ranges forced, device ms per call in turns: "
          + ", ".join(f"{ns} {t:.4f}" for ns, t in turns), flush=True)
    return {"name": "flash_attention_bhsd_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_attention.py:82",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def phase_rglru_flash256(torch):
    """Parity of the rglru kernel and of the flash kernel at head dim 256
    against their plain versions on the card, then their device times at
    recurrentgemma-2b's prefill and decode shapes, in fp32 as the path runs
    them. Returns the two kernel records for the JSON line."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, rglru

    print("phase 2c: rglru and flash head dim 256 parity on the card",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, P, C = RG_BATCH, RG_PROMPT, 2560
    L = rglru.STAGE_TOKENS
    cases = [  # label, (B, T, C), kwargs, the form the wrapper takes
        (f"prefill {B}x{P}x{C}, h0 = 0", (B, P, C), {"h0": False}, "staged"),
        (f"decode {B}x1x{C}", (B, 1, C), {}, "serial"),
        ("T=32 C=8", (1, 32, 8), {}, "staged"),
        ("T=96 C=40", (2, 96, 40), {}, "staged"),
        ("T=64 C=128", (2, 64, 128), {}, "staged"),
        ("T=50 C=24", (1, 50, 24), {}, "staged"),
        (f"T={L - 1} C={C}", (2, L - 1, C), {}, "serial"),
        (f"T={2 * L + 1} C=48, a short last tile", (3, 2 * L + 1, 48), {},
         "staged"),
        ("ragged T=17 C=130", (3, 17, 130), {}, "serial"),
    ]
    for label, shape, kw, form in cases:
        args = rglru_inputs(torch, g, *shape, **kw)
        with ops.tally() as n:
            h, h_T = rglru.rglru_btc(*args)
        h_ref, hT_ref = rglru.rglru_ref(*args)
        torch.cuda.synchronize()
        err = max(max_err(h, h_ref), max_err(h_T, hT_ref))
        expect(dict(n) == {"rglru_btc": 1, ("rglru_btc", form): 1},
               f"rglru {label}: launches {dict(n)}, not one {form}")
        expect(torch.equal(h, h_ref) and torch.equal(h_T, hT_ref),
               f"rglru {label}: h, h_T not bitwise rglru_ref's (max err "
               f"{err:.3e})")
        print(f"  rglru {label}: the {form} form, h and h_T bitwise "
              f"rglru_ref's", flush=True)

    W, H = 2048, 10
    flash_cases = [  # label, (B, Sq, Sk), kwargs
        (f"prefill {B}x{H}x{P} MQA window {W}", (B, P, P), {"window": W}),
        ("causal 2x600 MQA", (2, 600, 600), {}),
        ("window 100, 2x333", (2, 333, 333), {"window": 100}),
        (f"decode {B}x{H}x1 over {W} keys", (B, 1, W), {"causal": False}),
        ("decode 3x1 over 1337 keys", (3, 1, 1337), {"causal": False}),
        ("decode 2x1 over 1 key", (2, 1, 1), {"causal": False}),
    ]
    for label, (b, Sq, Sk), kw in flash_cases:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(b, H, Sq, 256, generator=g, device="cuda").to(dt)
            k = torch.randn(b, 1, Sk, 256, generator=g, device="cuda").to(dt)
            v = torch.randn(b, 1, Sk, 256, generator=g, device="cuda").to(dt)
            got = fa.flash_attention_bhsd(q, k, v, **kw)
            want = fa.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            check(f"flash hd 256 {label} {dtype_name(dt)}",
                  max_err(got, want), TOL[dtype_name(dt)])
            del q, k, v, got, want
    flash_form_parity(torch, g)
    flash_offset_parity(torch, g)

    # timings, in fp32 as the path runs them; inputs rotate past 100 MB as
    # in phase 2b; the record holds the prefill shape
    records = [dict(time_rglru(torch, g, B, P, C, "prefill"),
                    name="rglru_btc")]
    time_rglru(torch, g, B, 1, C, "decode", "serial")
    records.append(dict(time_flash256(torch, g, B, P, "prefill"),
                        name="flash_attention_bhsd_hd256"))
    records.append(time_flash_decode(torch, g, B, H, W, 256))
    records += cp_records(torch, g)
    gc.collect()
    torch.cuda.empty_cache()
    return records


def flash_offset_parity(torch, g):
    """Both sequence forms, and the decode form for one query, at a query
    offset (``q_offset``: a context-parallel rank's chunk) against the
    plain version to ``TOL`` of the query's dtype (the bf16 form also
    against ``attention_tiled_ref``): chunks 0 and 3 of 4 of a 512-token
    sequence, the last 640 queries of 2560 keys past recurrentgemma-2b's
    2048 window, one-query chunks, softcap with GQA, and rows with no live
    key (exactly zero). Then whether each chunk's rows equal the whole
    call's rows [off, off + Sq) bitwise (printed; held to ``TOL``)."""
    from repro_torch.kernels import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # label, dtype, (B, H, KV, Sq, Sk, hd), q_offset, kwargs
        ("chunk 0 of 4", bf16, (4, 15, 5, 128, 512, 64), 0, {}),
        ("chunk 3 of 4", bf16, (4, 15, 5, 128, 512, 64), 384, {}),
        ("chunk 0 of 4", f32, (4, 10, 1, 128, 512, 256), 0, {}),
        ("chunk 3 of 4", f32, (4, 10, 1, 128, 512, 256), 384, {}),
        ("last 640 of 2560, window 2048", f32, (1, 10, 1, 640, 2560, 256),
         1920, {"window": 2048}),
        ("last 640 of 2560, window 2048", bf16, (1, 10, 1, 640, 2560, 256),
         1920, {"window": 2048}),
        ("softcap 10, GQA 4", bf16, (2, 8, 2, 96, 384, 128), 288,
         {"softcap": 10.0}),
        ("one-query chunk", f32, (2, 10, 1, 1, 512, 256), 300, {}),
        ("one-query chunk, window 64", bf16, (2, 8, 2, 1, 512, 64), 300,
         {"window": 64}),
        ("no live key: non-causal window past the keys", f32,
         (1, 4, 2, 64, 128, 64), 400, {"causal": False, "window": 32}),
        ("no live key: non-causal window past the keys", bf16,
         (1, 4, 2, 64, 128, 64), 400, {"causal": False, "window": 32}),
    ]
    same = []
    for label, dt, (B, H, KV, Sq, Sk, hd), off, kw in cases:
        q = torch.randn(B, H, Sq, hd, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(B, KV, Sk, hd, generator=g, device="cuda").to(dt)
                for _ in range(2))
        kw = dict(kw, q_offset=off)
        got = fa.flash_attention_bhsd(q, k, v, **kw)
        refs = [("attention_ref", fa.attention_ref)]
        if dt == bf16 and Sq > 1:
            refs.append(("attention_tiled_ref", fa.attention_tiled_ref))
        tag = f"flash {B}x{H}/{KV}x{Sq} over {Sk} keys at offset {off} " \
              f"hd {hd} {label} {dtype_name(dt)}"
        for ref_name, ref in refs:
            check(f"{tag} vs {ref_name}", max_err(got, ref(q, k, v, **kw)),
                  TOL[dtype_name(dt)])
        live = fa._mask(Sq, torch.arange(Sk, device="cuda"),
                        kw.get("causal", True), kw.get("window", 0), Sq, Sk,
                        off, "cuda").any(-1)
        expect(bool((got[:, :, ~live] == 0).all()),
               f"{tag}: rows with no live key are not exactly zero")
        if Sq > 1 and off + Sq <= Sk:
            qs = torch.zeros(B, H, off + Sq, hd, device="cuda", dtype=dt)
            qs[:, :, off:] = q
            kw_whole = {n: x for n, x in kw.items() if n != "q_offset"}
            whole = fa.flash_attention_bhsd(qs, k, v, **kw_whole)[:, :, off:]
            check(f"{tag} vs the whole call's rows", max_err(got, whole),
                  TOL[dtype_name(dt)])
            same.append((tag, bool(torch.equal(got, whole))))
        del q, k, v, got
    print("  chunk rows against the whole call's rows, bitwise equal: "
          + "; ".join(f"{t}: {e}" for t, e in same), flush=True)


def cp_records(torch, g):
    """Flash at the context-parallel ranks' chunks of phase 12's training
    and prefills, records of their own: smollm-360m's 4 x 15/5 x 128
    queries at offsets 0 (rank 0) and 384 (rank 3) over 512 keys, hd 64,
    bf16; recurrentgemma-2b's 4 x 10/1 x 128 at offset 384 (rank 3) over
    512 keys, hd 256, fp32, window 2048. Each held to the plain version,
    timed beside sdpa on the same masked problem (``attn_mask`` the offset
    causal mask, ``enable_gqa``) and the bound (``flash_work`` at the
    offset)."""
    from repro_torch.kernels import flash_attention as fa

    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    records = []
    for name, label, dt, (B, H, KV, Sq, Sk, hd), off, kw in (
            ("flash_attention_bhsd_cp_smollm", "smollm-360m CP rank 0",
             torch.bfloat16, (4, 15, 5, 128, 512, 64), 0, {}),
            ("flash_attention_bhsd_cp_smollm_r3", "smollm-360m CP rank 3",
             torch.bfloat16, (4, 15, 5, 128, 512, 64), 384, {}),
            ("flash_attention_bhsd_cp_rg_r3", "recurrentgemma-2b CP rank 3",
             torch.float32, (4, 10, 1, 128, 512, 256), 384,
             {"window": 2048})):
        q = torch.randn(B, H, Sq, hd, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(B, KV, Sk, hd, generator=g, device="cuda").to(dt)
                for _ in range(2))
        mask = fa._mask(Sq, torch.arange(Sk, device="cuda"), True,
                        kw.get("window", 0), Sq, Sk, off, "cuda")
        records.append(flash_record(
            torch, name, f"{label} {B} x {H}/{KV} x {Sq} at offset {off} "
            f"over {Sk} keys, hd {hd}, causal, {dtype_name(dt)}", q, k, v,
            dict(kw, q_offset=off), {"attn_mask": mask}, src))
    return records


def time_rglru(torch, g, B, T, C, label, form="staged"):
    """rglru at (B, T, C) fp32: one launch in ``form`` (``staged``, or
    ``serial`` at decode), h and h_T bitwise the plain version's, then the
    kernel's and the plain version's device time per call, inputs rotating
    past 100 MB, and the bound; in the staged form also, launched through
    the library (uncounted), the serial kernel's time and the staged
    kernel's with the ring the plan's other rule would give (rings of 2 all
    resident where the plan runs waves of ``WAVE_DEPTH``, else
    ``WAVE_DEPTH``). Returns the kernel's record without its name."""
    from repro_torch.distributed import cost
    from repro_torch.kernels import _cuda, ops, rglru

    n_ops, n_bytes = cost.rglru_work(B, T, C)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
    sets = [rglru_inputs(torch, g, B, T, C, h0=T == 1)
            for _ in range(-(-100_000_000 // n_bytes))]
    with ops.tally() as n:
        got = rglru.rglru_btc(*sets[0])
    want = rglru.rglru_ref(*sets[0])
    err = max(max_err(x, y) for x, y in zip(got, want))
    expect(dict(n) == {"rglru_btc": 1, ("rglru_btc", form): 1},
           f"rglru {label} {B}x{T}x{C}: launches {dict(n)}, not one {form}")
    expect(all(torch.equal(x, y) for x, y in zip(got, want)),
           f"rglru {label} {B}x{T}x{C}: h, h_T not bitwise rglru_ref's "
           f"(max err {err:.3e})")
    del got, want
    turn = itertools.cycle(sets)
    run_k = lambda: rglru.rglru_btc(*next(turn))              # noqa: E731
    run_p = lambda: rglru.rglru_ref(*next(turn))              # noqa: E731
    ms = graph_ms(torch, run_k)
    plain = graph_ms(torch, run_p, iters=2, replays=2)
    others = ""
    if form == "staged":
        depth = rglru.staged_plan(B, T, C, _cuda.sm_count(sets[0][0].device)
                                  ).depth
        other = 2 if depth == rglru.WAVE_DEPTH else rglru.WAVE_DEPTH
        for name, extra in (("the serial kernel", ()),
                            (f"rings of {other}", (other,))):
            def run_lib(extra=extra):
                a, b, h0 = next(turn)
                h, h_T = torch.empty_like(a), torch.empty_like(h0)
                lib = _cuda.lib()
                launch = lib.repro_rglru_staged if extra else lib.repro_rglru
                expect(launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                              h.data_ptr(), h_T.data_ptr(), B, T, C, *extra,
                              *_cuda.device_and_stream(a.device)) == 0,
                       f"rglru {name}: launch failed")
            o_ms = graph_ms(torch, run_lib)
            others += f", {name} {o_ms:.4f} ({100 * b_ms / o_ms:.1f}%)"
        others += f" (the plan's rings: {depth})"
    print(f"  rglru {label} {B}x{T}x{C} fp32, the {form} form, device ms "
          f"per call: kernel {ms:.4f}, plain {plain:.4f}, bound {b_ms:.6f} "
          f"({b_by}), {100 * b_ms / ms:.1f}% of it{others}; wall per "
          f"back-to-back call: kernel {wall_ms(torch, run_k):.4f}; h, h_T "
          f"bitwise rglru_ref's", flush=True)
    return {"route": "cuda", "source": "src/repro_torch/kernels/csrc/rglru.cu",
            "replaces": "src/repro/kernels/rglru.py:44", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def time_rglru_bwd(torch, g, B, T, C, label):
    """RG-LRU's gradient kernel (``rglru_bwd``) at (B, T, C) fp32 from the
    forward kernel's h at a seeded upstream: da, db and dh0 bitwise the
    plain version's (``rglru_bwd_ref``), then both's device time per call,
    inputs rotating past 100 MB, and the bound (``cost.rglru_bwd_work``).
    Returns the kernel's record without its name."""
    from repro_torch.distributed import cost
    from repro_torch.kernels import rglru

    n_ops, n_bytes = cost.rglru_bwd_work(B, T, C)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
    sets = []
    for _ in range(-(-100_000_000 // n_bytes)):
        a, b, h0 = rglru_inputs(torch, g, B, T, C)
        sets.append((a, rglru.rglru_btc(a, b, h0)[0], h0,
                     torch.randn(B, T, C, generator=g, device="cuda"),
                     torch.randn(B, C, generator=g, device="cuda")))
        del b
    got, want = rglru.rglru_bwd(*sets[0]), rglru.rglru_bwd_ref(*sets[0])
    err = max(max_err(x, y) for x, y in zip(got, want))
    expect(all(torch.equal(x, y) for x, y in zip(got, want)),
           f"rglru gradient {label} {B}x{T}x{C}: da, db, dh0 not bitwise "
           f"rglru_bwd_ref's (max err {err:.3e})")
    del got, want
    turn = itertools.cycle(sets)
    ms = graph_ms(torch, lambda: rglru.rglru_bwd(*next(turn)))
    plain = graph_ms(torch, lambda: rglru.rglru_bwd_ref(*next(turn)),
                     iters=2, replays=2)
    print(f"  rglru gradient kernel {label} {B}x{T}x{C} fp32, device ms per "
          f"call: kernel {ms:.4f}, plain {plain:.4f}, bound {b_ms:.4f} "
          f"({b_by}, {n_bytes / 1e6:.0f} MB), {ms / b_ms:.2f}x it; da, db, "
          f"dh0 bitwise rglru_bwd_ref's", flush=True)
    return {"route": "cuda", "source": "src/repro_torch/kernels/csrc/rglru.cu",
            "replaces": "src/repro/kernels/rglru.py:44", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def time_flash256(torch, g, B, S, label, H=10, W=2048, hd=256):
    """Flash's fp32 sequence form at recurrentgemma-2b's attention (B x
    H/1 x S, hd 256, causal, window W): the kernel held to the plain
    version, then the kernel's, the plain version's and sdpa's device time
    per call, inputs rotating past 100 MB, and the bound. Returns the
    kernel's record without its name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import make_mask

    n_bytes = 4 * (2 * B * H * S * hd + 2 * B * S * hd)
    sets = [tuple(torch.randn(B, n, S, hd, generator=g, device="cuda")
                  for n in (H, 1, 1))
            for _ in range(-(-100_000_000 // n_bytes))]
    b_ms, b_by = flash_bound(*sets[0], window=W)
    mask = make_mask(torch.arange(S, device="cuda"),
                     torch.arange(S, device="cuda"), True, W)
    kw = dict(causal=True, window=W)
    err = max_err(fa.flash_attention_bhsd(*sets[0], **kw),
                  fa.attention_ref(*sets[0], **kw))
    check(f"flash hd 256 {label} {B}x{H}x{S} window {W} fp32 vs "
          f"attention_ref", err, TOL["float32"])
    turn = itertools.cycle(sets)
    run_k = lambda: fa.flash_attention_bhsd(*next(turn), **kw)  # noqa: E731
    run_p = lambda: fa.attention_ref(*next(turn), **kw)         # noqa: E731
    run_l = lambda: F.scaled_dot_product_attention(             # noqa: E731
        *next(turn), attn_mask=mask, enable_gqa=True)
    reps = dict(iters=2, replays=2)
    ms, plain, lib = (graph_ms(torch, run_k, **reps),
                      graph_ms(torch, run_p, **reps),
                      graph_ms(torch, run_l, **reps))
    print(f"  flash hd 256 {label} {B}x{H}x{S} window {W} MQA fp32 "
          f"(register-tiled form), device ms per call: kernel {ms:.4f}, "
          f"plain {plain:.4f}, sdpa {lib:.4f}, bound {b_ms:.6f} ({b_by}); "
          f"err {err:.3e}", flush=True)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:82",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def greedy(torch, params, prompts, cfg, steps, stub=None):
    """Greedy tokens (B, steps) through prefill + decode_step, and the
    logits of the last decode step. ``stub``: the frontend's patches or
    frames, {name: tensor}; the caches hold a patch prefix too."""
    from repro_torch.models import lm
    batch = {"inputs": prompts, **(stub or {})}
    logits, caches, t = lm.prefill(
        params, batch, cfg,
        cache_len=lm.prefix_len(batch, cfg) + prompts.shape[1] + steps)
    toks = [lm.sample_tokens(logits, 0.0)]
    for i in range(1, steps):
        logits, caches = lm.decode_step(params, caches, toks[-1], t + i - 1,
                                        cfg)
        toks.append(lm.sample_tokens(logits, 0.0))
    return torch.cat(toks, dim=1), logits


def layer_consistency(torch, params, seq, n_prompt, cfg, stub=None):
    """Every layer fed the input the prefill gives it: its outputs at the
    positions after ``n_prompt`` tokens through its own prefill over the
    first ``n_prompt`` tokens (after any patch prefix) and T=1 decode
    steps, against its outputs in one prefill over all of ``seq``; an
    encoder-decoder's layers read the encoder's output of ``stub``'s
    frames. Returns the largest error, each layer's relative to the
    largest magnitude of its prefill output."""
    from repro_torch.models import blocks, lm
    x, ctx, n_prefix = lm._context(params, {"inputs": seq, **(stub or {})},
                                   cfg)
    B, S = x.shape[:2]
    n0 = n_prefix + n_prompt
    worst = 0.0
    for layer, kind in zip(params.layers, cfg.layer_kinds):
        def fresh():
            return blocks.init_layer_cache(kind, cfg, B, S, device=x.device)
        full, _ = blocks.layer_prefill(kind, layer, x, ctx, cfg, fresh())
        _, state = blocks.layer_prefill(
            kind, layer, x[:, :n0],
            dict(ctx, positions=ctx["positions"][:n0]), cfg, fresh())
        for i in range(n0, S):
            h, state = blocks.layer_decode(kind, layer, x[:, i:i + 1], i, cfg,
                                           state)
            worst = max(worst, max_err(h[:, 0], full[:, i])
                        / float(full.abs().max()))
        x = full
    return worst


def frontend_stub(torch, cfg, B, seed):
    """The frontend's stub for ``B`` rows, {"patches" or "frames": 0.02 x a
    normal draw of (B, frontend_seq, d_model)} (fp32, CPU), as serve_batch
    draws it; empty without a frontend."""
    import numpy as np
    names = {"vision_patches": "patches", "audio_frames": "frames"}
    if cfg.frontend not in names:
        return {}
    draw = 0.02 * np.random.default_rng(seed).normal(
        size=(B, cfg.frontend_seq, cfg.d_model))
    return {names[cfg.frontend]: torch.from_numpy(draw.astype(np.float32))}


def phase_lm_agreement(torch, label, arch, prompt_len, cfg=None, note=""):
    """A reduced LM in fp32 (``cfg``, default the arch's reduced config):
    one model built on the CPU and copied to the card, the same prompts
    (and frontend stub), greedy decoding on the card (kernels) and on the
    CPU (plain versions)."""
    import copy

    import numpy as np
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import lm

    cfg = (cfg or get_reduced(arch)).replace(compute_dtype="float32")
    print(f"{label}: small-input agreement, {arch} card vs CPU (reduced, "
          f"fp32, {prompt_len}-token prompts{note})", flush=True)
    cpu = lm.init_lm(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(4, prompt_len)))
    stub = frontend_stub(torch, cfg, 4, 5)
    stub_g = {k: v.cuda() for k, v in stub.items()}
    with torch.inference_mode():
        toks_g, last_g = greedy(torch, card, prompts.cuda(), cfg, 12, stub_g)
        toks_c, last_c = greedy(torch, cpu, prompts, cfg, 12, stub)
        gen_g = lm.generate(card, {"inputs": prompts.cuda(), **stub_g}, cfg,
                            12)
    expect(torch.equal(toks_g.cpu(), toks_c), "greedy tokens differ, card vs "
           "CPU")
    expect(torch.equal(gen_g.cpu(), toks_c), "lm.generate differs from the "
           "prefill + decode_step loop")
    check("last-step logits card vs CPU", max_err(last_g.cpu(), last_c), 1e-4)
    return card, cfg, prompts.cuda(), toks_g, stub_g


def new_pipelines(rng, n):
    """Design tasks shaped as the session makes them: a backbone of
    receptor + peptide rows, a target descriptor, no accepted design."""
    return [{"backbone": rng.normal(size=(RECEPTOR + PEPTIDE, 16)).astype(
                 "float32"),
             "target": rng.normal(size=16).astype("float32"),
             "prev": None, "accepted": []} for _ in range(n)]


def design_cycle(torch, pp, mesh, pipes, cycle, aa_emb, peptide, noise=None,
                 times=None):
    """One IMPRESS cycle for every pipeline: one fused paged generate_batch,
    rank by log-likelihood, masked predict_batch on the top 3 (peptide
    appended), accept the first candidate whose fitness improves (the
    accepted sequence pulls the receptor backbone toward its embedding).
    Checks every output's shape and range. With ``times`` (a dict), adds
    the synchronized wall time of each call kind to it. Returns the
    generate result and the number of predict_batch calls."""
    import numpy as np
    from repro_torch.core.protocol import fitness

    def timed(kind, fn, *args):
        if times is None:
            return fn(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[kind] = times.get(kind, 0.0) + time.perf_counter() - t
        return out

    payload = {"backbones": np.stack([p["backbone"] for p in pipes]),
               "seeds": [1000 * i + cycle for i in range(len(pipes))],
               "n": N_CAND, "length": RECEPTOR, "temperature": 1.0,
               "decode": "paged"}
    if noise is not None:
        payload["noise"] = noise
    gen = timed("generate_batch", pp.generate_batch, mesh, payload)
    for p, (seqs, lls) in zip(pipes, gen["rows"]):
        expect(seqs.shape == (N_CAND, RECEPTOR), f"seqs {seqs.shape}")
        expect(((seqs >= 0) & (seqs < pp.gen_cfg.vocab_size)).all(),
               "sampled a pad-vocabulary token")
        expect(np.isfinite(lls).all() and (lls <= 0).all(), f"lls {lls}")
        top = seqs[np.argsort(-lls, kind="stable")[:TOP_K]]
        stack = np.concatenate([top, np.tile(peptide, (len(top), 1))], 1)
        out = timed("predict_batch", pp.predict_batch, mesh, {
            "sequences": stack, "target": p["target"],
            "receptor_len": RECEPTOR,
            "seq_lens": np.full(len(top), stack.shape[1], np.int32),
            "chain_splits": np.full(len(top), RECEPTOR, np.int32)})
        for seq, m in zip(top, out["rows"]):
            expect(0 <= m["plddt"] <= 100 and 0 <= m["ptm"] <= 1
                   and 0 <= m["pae"] <= 30, f"metrics out of range: {m}")
            fit = fitness(m)
            if p["prev"] is None or fit > p["prev"]:
                p["prev"] = fit
                p["accepted"].append((cycle, seq.tolist(), fit))
                p["backbone"][:RECEPTOR] = 0.75 * p["backbone"][:RECEPTOR] \
                    + 0.25 * aa_emb[seq]
                break
    return gen, len(pipes)


def phase_agreement(torch):
    """The reduced payload, fp32, on the card and on the CPU from one seed
    and one noise block: kernels vs plain versions through the whole slice
    at a small size."""
    import numpy as np
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.payload import ProteinPayload
    from repro_torch.runtime.allocator import SubMesh

    print("phase 3: small-input agreement, card vs CPU (reduced, fp32): the "
          "paged design loop, the dense generate and generate_batch",
          flush=True)
    gcfg = get_reduced("progen-s").replace(compute_dtype="float32")
    fcfg = get_reduced("foldscore-s").replace(compute_dtype="float32")
    noise = np.random.default_rng(1).gumbel(
        size=(2, N_CAND, RECEPTOR, gcfg.padded_vocab))
    backbones = np.random.default_rng(4).normal(
        size=(2, RECEPTOR + PEPTIDE, 16)).astype(np.float32)
    runs, dense = [], []
    for dev in ("cuda", "cpu"):
        pp = ProteinPayload(seed=0, gen_cfg=gcfg, fold_cfg=fcfg, device=dev)
        mesh = SubMesh((pp.device,))
        pipes = new_pipelines(np.random.default_rng(2), 2)
        aa_emb = np.random.default_rng(3).normal(size=(32, 16))
        scores = []
        for cycle in range(2):
            gen, _ = design_cycle(torch, pp, mesh, pipes, cycle, aa_emb,
                                  np.arange(1, 7), noise=noise)
            scores.append(gen["rows"])
        runs.append((scores, [p["accepted"] for p in pipes]))
        # the dense sampler: a solo generate and a dense generate_batch of
        # two rows, on the same noise
        one = pp.generate(mesh, {"backbone": backbones[0], "n": N_CAND,
                                 "length": RECEPTOR, "seed": 5,
                                 "noise": noise[0]})
        two = pp.generate_batch(mesh, {"backbones": backbones,
                                       "seeds": [5, 6], "n": N_CAND,
                                       "length": RECEPTOR, "noise": noise})
        dense.append([(one["seqs"], one["lls"])] + two["rows"])
    (gpu_rows, gpu_acc), (cpu_rows, cpu_acc) = runs
    err = 0.0
    for rows_a, rows_b in zip(gpu_rows, cpu_rows):
        for (s1, l1), (s2, l2) in zip(rows_a, rows_b):
            expect((s1 == s2).all(), "sampled tokens differ, card vs CPU")
            err = max(err, float(np.abs(l1 - l2).max()))
    check("log-likelihoods card vs CPU", err, 1e-3)
    err = 0.0
    for (s1, l1), (s2, l2) in zip(*dense):
        expect(s1.shape == (N_CAND, RECEPTOR) and (s1 == s2).all(),
               "dense generate / generate_batch: tokens differ, card vs CPU")
        err = max(err, float(np.abs(l1 - l2).max()))
    check("dense generate + generate_batch log-likelihoods card vs CPU",
          err, 1e-3)
    expect([[a[:2] for a in acc] for acc in gpu_acc]
           == [[a[:2] for a in acc] for acc in cpu_acc],
           "card and CPU accepted different designs")
    check("accepted fitness card vs CPU",
          max(abs(a[2] - b[2]) for x, y in zip(gpu_acc, cpu_acc)
              for a, b in zip(x, y)), 1e-3)


def phase_main_path(torch, pp):
    """The design loop at full width through the kernels; returns the
    launch counts of the counted window."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.runtime.allocator import SubMesh

    n_pipes, n_cycles = 4, 2
    g, f = pp.gen_cfg, pp.fold_cfg
    print(f"phase 4: main path, {n_cycles} design cycles x {n_pipes} "
          f"pipelines; {g.name} ({g.n_layers} layers, d {g.d_model}, "
          f"{g.n_heads}/{g.n_kv_heads} heads of {g.head_dim}, "
          f"{g.compute_dtype}) + {f.name} ({f.n_layers} layers, d "
          f"{f.d_model}) on {pp.device}", flush=True)
    mesh = SubMesh((pp.device,))
    rng = np.random.default_rng(0)
    peptide = rng.integers(1, 21, size=PEPTIDE).astype(np.int32)
    aa_emb = rng.normal(size=(g.vocab_size, 16)).astype(np.float32)
    # one cycle before the counted window: first-call allocations, library
    # handles and the engine of this (slots, length)
    design_cycle(torch, pp, mesh, new_pipelines(rng, n_pipes), 0, aa_emb,
                 peptide)
    pipes = new_pipelines(rng, n_pipes)
    times = {}
    steps = admits = n_pred = 0
    torch.cuda.synchronize()
    ops.reset_launches()
    for cycle in range(n_cycles):
        gen, n = design_cycle(torch, pp, mesh, pipes, cycle, aa_emb, peptide,
                              times=times)
        steps += gen["batch"]["steps"]
        admits += gen["batch"]["admits"]
        n_pred += n
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    n_tok = n_cycles * n_pipes * N_CAND * RECEPTOR
    t_gen, t_pred = times["generate_batch"], times["predict_batch"]
    print(f"  generate_batch: {n_cycles} calls of {n_pipes} rows x {N_CAND} "
          f"candidates x {RECEPTOR} tokens, {admits} admissions, {steps} "
          f"decode steps: {t_gen / n_cycles * 1e3:.1f} ms per call, "
          f"{n_tok / t_gen:.0f} tokens/s, {t_gen / steps * 1e3:.2f} ms per "
          f"decode step (admissions included)", flush=True)
    print(f"  predict_batch: {n_pred} calls of {TOP_K} rows x "
          f"{RECEPTOR + PEPTIDE} tokens (bucket 4 x 32): "
          f"{t_pred / n_pred * 1e3:.2f} ms per call", flush=True)
    for i, p in enumerate(pipes):
        print(f"  pipeline {i}: accepted (cycle, fitness) "
              f"{[(c, round(fit, 4)) for c, _, fit in p['accepted']]}",
              flush=True)
    print(f"  launches {counts}: {steps} decode steps, {admits} admissions, "
          f"{n_pred} predict_batch calls", flush=True)
    expect(admits == n_cycles * n_pipes * N_CAND and steps > 0,
           f"{admits} admissions, {steps} steps")
    expect(all(p["accepted"] and p["accepted"][0][0] == 0 for p in pipes),
           "a pipeline accepted nothing in its first cycle")
    want = {"paged_decode_bkgh": g.n_layers * steps,
            "flash_attention_bhsd": g.n_layers * admits + f.n_layers * n_pred,
            "wkv6_bhtk": 0, "rglru_btc": 0}
    expect(counts == want, f"launches {counts}, expected {want}")
    forms = dict(ops.forms["flash_attention_bhsd"])
    print(f"  flash launches by form {forms}", flush=True)
    expect(forms == flash_forms(seq_bf16=want["flash_attention_bhsd"]),
           f"flash forms {forms}: the protein path runs bf16 sequences")
    return counts


def phase_profile(torch, pp):
    """One design cycle under torch.profiler: device time by kernel and the
    device's busy share of the cycle's wall time."""
    import numpy as np
    from repro_torch.runtime.allocator import SubMesh

    print("phase 5: where the time goes (one design cycle, torch.profiler)",
          flush=True)
    mesh = SubMesh((pp.device,))
    rng = np.random.default_rng(5)
    peptide = rng.integers(1, 21, size=PEPTIDE).astype(np.int32)
    aa_emb = rng.normal(size=(32, 16)).astype(np.float32)
    pipes = new_pipelines(rng, 4)
    gens = []
    kernels = profile_step(torch, lambda: gens.append(design_cycle(
        torch, pp, mesh, pipes, 0, aa_emb, peptide)[0]), "cycle")
    steps = gens[0]["batch"]["steps"]
    paged = [e for e in kernels if "PagedKeys" in e.key]
    n_paged = sum(e.count for e in paged)
    n_comb = sum(e.count for e in kernels if "decode_attention_combine"
                 in e.key)
    print(f"  paged decode: {n_paged} device kernels, "
          f"{sum(e.self_device_time_total for e in paged) / 1e3:.3f} ms, "
          f"for {steps} decode steps x {pp.gen_cfg.n_layers} layers; "
          f"{n_comb} combine kernels", flush=True)
    expect(n_paged == steps * pp.gen_cfg.n_layers and n_comb == 0,
           "paged decode is not one device kernel a layer a step")


def run_campaign(torch, pp, form, n_cycles):
    """One im-rp campaign through the port's campaign engine on the card:
    ``protein_design_tasks(4, receptor_len=24, peptide_len=6)``,
    ``ImpressProtocol`` with the session's defaults (6 candidates, at most
    4 sub-pipelines, one device a generate and a predict) in ``form``, the
    ``Coordinator`` over an ``AsyncExecutor`` (2 workers) over a
    ``DeviceAllocator`` of the card. Checks that it ran to its end with no
    failed or retried task, that every pipeline made a trajectory and that
    every accepted design's metrics are in range. Returns (report, the
    executor's completed tasks)."""
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.core.pipeline import TaskState
    from repro_torch.core.protocol import ImpressProtocol, ProtocolConfig
    from repro_torch.data.synthetic import protein_design_tasks
    from repro_torch.runtime.allocator import DeviceAllocator
    from repro_torch.runtime.executor import AsyncExecutor

    kw = CAMPAIGN_FORMS[form]
    proto = ImpressProtocol(ProtocolConfig(
        n_candidates=N_CAND, n_cycles=n_cycles, max_sub_pipelines=4,
        gen_devices=1, predict_devices=1, **kw))
    ex = AsyncExecutor(DeviceAllocator([pp.device]), max_workers=2)
    try:
        pp.register_all(ex, generate_batch_rows=kw.get("generate_batch_size"),
                        decode_kernel=kw.get("decode_kernel", False))
        coord = Coordinator(ex, proto)
        for t in protein_design_tasks(4, receptor_len=RECEPTOR,
                                      peptide_len=PEPTIDE):
            coord.add_pipeline(proto.new_pipeline(
                t["name"], t["backbone"], t["target"], t["receptor_len"],
                t["peptide_tokens"]))
        rep = coord.run(timeout=300)
        torch.cuda.synchronize()
        # the executor's task table: every task it ran, in every state
        done = [t for t in ex._tasks.values() if t.state == TaskState.DONE]
    finally:
        ex.shutdown()
    pls = list(coord.pipelines.values())
    expect(not any(p.active for p in pls),
           f"{form} campaign: pipelines still active after "
           f"{rep['makespan_s']:.1f} s")
    expect(rep["executor"]["n_failed"] == 0
           and rep["executor"]["n_retried"] == 0,
           f"{form} campaign: {rep['executor']['n_failed']} failed, "
           f"{rep['executor']['n_retried']} retried")
    expect(all(p.meta["trajectories"] > 0 for p in pls),
           f"{form} campaign: a pipeline made no trajectory")
    for p in pls:
        for h in p.history:
            expect(0 <= h["plddt"] <= 100 and 0 <= h["ptm"] <= 1
                   and 0 <= h["pae"] <= 30 and len(h["sequence"]) == RECEPTOR
                   and all(0 <= a < pp.gen_cfg.vocab_size
                           for a in h["sequence"]),
                   f"{form} campaign: design out of range: {h}")
    return rep, done


def implied_launches(form, done, g, f):
    """The kernel launches the completed tasks of a campaign imply, by
    kernel and flash form. Default form: a ``generate`` prefills its 6 rows
    (one flash sequence launch a layer) and takes length - 1 decode steps
    (one decode-form launch a layer each); a solo ``predict`` is one flash
    sequence launch a scorer layer. Batched form: a dispatch's leader
    carries the paged engine's admissions (one prefill a layer each) and
    decode steps (one paged launch a layer each); a ``predict_batch``
    dispatch is one flash launch a scorer layer."""
    kinds = collections.Counter(t.kind for t in done)
    if form == "default":
        gen, pred = kinds["generate"], kinds["predict"]
        seq, dec, paged = (g.n_layers * gen + f.n_layers * pred,
                           g.n_layers * (RECEPTOR - 1) * gen, 0)
        info = f"{gen} generate, {pred} predict"
    else:
        leaders = [t for t in done if t.kind in ("generate_batch",
                                                 "predict_batch")
                   and t.result["batch"].get("leader", True)]
        steps = sum(t.result["batch"]["steps"] for t in leaders
                    if t.kind == "generate_batch")
        admits = sum(t.result["batch"]["admits"] for t in leaders
                     if t.kind == "generate_batch")
        disp = collections.Counter(t.kind for t in leaders)
        expect(admits == N_CAND * kinds["generate_batch"],
               f"{admits} admissions for {kinds['generate_batch']} rows")
        seq, dec, paged = (g.n_layers * admits
                           + f.n_layers * disp["predict_batch"], 0,
                           g.n_layers * steps)
        info = (f"{kinds['generate_batch']} generate_batch rows in "
                f"{disp['generate_batch']} dispatches ({admits} admissions, "
                f"{steps} decode steps), {kinds['predict_batch']} "
                f"predict_batch tasks in {disp['predict_batch']} dispatches")
    return ({"paged_decode_bkgh": paged, "flash_attention_bhsd": seq + dec,
             "wkv6_bhtk": 0, "rglru_btc": 0},
            flash_forms(decode=dec, seq_bf16=seq), info)


def phase_campaign(torch, pp):
    """Phase 5b: the paper's main path, an im-rp campaign through the
    port's Coordinator, AsyncExecutor, DeviceAllocator and ProteinPayload
    at full progen-s / foldscore-s width, in each form: the counters zeroed
    just before and read just after, and held to what the completed tasks
    imply. Then one cycle of each form under torch.profiler. Returns each
    form's flash launches by form."""
    from repro_torch.core import payload as payload_mod
    from repro_torch.kernels import ops
    from repro_torch.obs import CompileWatcher, MetricsRegistry

    g, f = pp.gen_cfg, pp.fold_cfg
    out = {}
    for form in CAMPAIGN_FORMS:
        print(f"phase 5b: im-rp campaign, {form} form "
              f"{CAMPAIGN_FORMS[form] or '(dense generate, solo predict)'}:"
              f" 4 structures (receptor {RECEPTOR} + peptide {PEPTIDE}), "
              f"{N_CAND} candidates, {CAMPAIGN_CYCLES} cycles, at most 4 "
              f"sub-pipelines; Coordinator -> AsyncExecutor (2 workers) -> "
              f"DeviceAllocator([{pp.device}]) -> ProteinPayload", flush=True)
        reg = MetricsRegistry()
        start = {k: len(v) for k, v in payload_mod.compile_log.items()}
        torch.cuda.synchronize()
        ops.reset_launches()
        with CompileWatcher(reg) as watcher:
            rep, done = run_campaign(torch, pp, form, CAMPAIGN_CYCLES)
            watcher.absorb_compile_log(payload_mod.compile_log, start)
        counts = dict(ops.launches)
        forms = dict(ops.forms["flash_attention_bhsd"])
        want, want_forms, info = implied_launches(form, done, g, f)
        kinds = collections.Counter(t.kind for t in done)
        accepted = {c: v["n"] for c, v in sorted(rep["cycles"].items())}
        first = {k.split("{")[1][5:-1]: round(v["count"] * v["mean"], 3)
                 for k, v in reg.snapshot().items()
                 if k.startswith("torch.payload_first_call_s")}
        print(f"  makespan {rep['makespan_s']:.3f} s; tasks by kind "
              f"{dict(kinds)}; {rep['n_pipelines']} pipelines + "
              f"{rep['n_sub_pipelines']} sub-pipelines, "
              f"{rep['trajectories']} trajectories; designs accepted by "
              f"cycle {accepted}; batch occupancy {rep['batch_occupancy']}, "
              f"generate batch occupancy {rep['gen_batch_occupancy']}; "
              f"device utilization (allocator) {rep['utilization']:.3f}",
              flush=True)
        print(f"  first calls per shape key (s, in the makespan): {first}",
              flush=True)
        print(f"  launches {counts}, flash by form {forms}; implied by the "
              f"completed tasks ({info}): {want}, {want_forms}", flush=True)
        expect(counts == want and forms == want_forms,
               f"{form} campaign: launches {counts} {forms}, the completed "
               f"tasks imply {want} {want_forms}")
        expect(set(kinds) == ({"generate", "predict"} if form == "default"
                              else {"generate_batch", "predict_batch"}),
               f"{form} campaign ran {dict(kinds)}")
        if form == "default":
            expect(forms["decode"] > 0 and counts["paged_decode_bkgh"] == 0,
                   "default form: no dense decode, or paged launches")
        else:
            expect(counts["paged_decode_bkgh"] > 0 and forms["decode"] == 0,
                   "batched form: no paged decode, or dense decode launches")
        out[form] = forms
    for form in CAMPAIGN_FORMS:
        profile_step(torch, lambda: run_campaign(torch, pp, form, 1),
                     f"campaign {form} form, 1 cycle", top=8)
    return out


def session_specs():
    """Phase 5c's campaigns, at full width: A, the paper's comparison (im-rp
    beside its cont-v control and the multi-objective demo); B, the staged
    binder (backbone -> seqdesign -> fold on the "binder" generator and the
    foldscore-m "multimer" scorer) beside the rescore co-tenant, at mixed
    receptor lengths, so both the seqdesign and the fold stage take their
    masked forms over campaign-derived length buckets."""
    from repro_torch.session import CampaignSpec, ProtocolSpec
    a = CampaignSpec(structures=2, receptor_len=RECEPTOR, peptide_len=PEPTIDE,
                     max_workers=2, seed=0, reduced=False, protocols=tuple(
                         ProtocolSpec(k, n_cycles=SESSION_CYCLES,
                                      n_candidates=N_CAND)
                         for k in ("im-rp", "cont-v", "multi-objective")))
    b = CampaignSpec(structures=4, receptor_len=SESSION_B_LENS,
                     peptide_len=PEPTIDE, max_workers=2, seed=0,
                     reduced=False, fair_scheduling=True, protocols=(
                         ProtocolSpec("binder", n_cycles=SESSION_CYCLES,
                                      n_candidates=N_CAND, score_batch=2),
                         ProtocolSpec("rescore", n_cycles=SESSION_CYCLES,
                                      score_batch=4)))
    return a, b


def implied_session_launches(done, pp):
    """The kernel launches a session's completed tasks imply, by kernel,
    flash form and param-set namespace. A solo ``generate`` of length L
    prefills (one flash sequence launch a layer of its namespace's
    generator) and takes L - 1 decode steps (one decode-form launch a layer
    each); a dense ``generate_batch`` dispatch (its leader's payload) does
    the same once for all its rows at their shared length; a ``predict``
    task or a ``predict_batch`` dispatch is one flash sequence launch a
    layer of its namespace's scorer: 8 for foldscore-s ("default"), 12 for
    foldscore-m ("multimer"). A ``finetune`` task is one flash sequence
    launch and one gradient kernel launch a generator layer a train step
    it ran. ``backbone_batch`` runs no kernel."""
    seq = dec = bwd = 0
    by_ns = collections.Counter()
    for t in done:
        if t.kind in ("generate_batch", "predict_batch") \
                and not t.result["batch"].get("leader", True):
            continue                 # a fused dispatch counts at its leader
        ns = t.payload.get("params") or "default"
        if t.kind in ("generate", "generate_batch"):
            expect(t.payload.get("decode") != "paged",
                   "phase 5c runs no paged decode")
            n_layers, length = pp.gen_cfgs[ns].n_layers, int(
                t.payload["length"])
            seq += n_layers
            dec += n_layers * (length - 1)
            by_ns[ns] += n_layers * length
        elif t.kind in ("predict", "predict_batch"):
            n_layers = pp.fold_sets[ns][0].n_layers
            seq += n_layers
            by_ns[ns] += n_layers
        elif t.kind == "finetune":
            # one bf16 sequence launch a layer a train step (its forward)
            # and one of the gradient kernel (its backward, counted in the
            # forward's namespace), preempted runs included
            n = pp.gen_cfgs[ns].n_layers * int(t.result["steps_run"])
            seq += n
            bwd += n
            by_ns[ns] += 2 * n
    zero = {"paged_decode_bkgh": 0, "flash_attention_bhsd": 0,
            "wkv6_bhtk": 0, "rglru_btc": 0}
    return (dict(zero, flash_attention_bhsd=seq + dec + bwd),
            flash_forms(decode=dec, seq_bf16=seq, backward=bwd),
            {ns: dict(zero, flash_attention_bhsd=n)
             for ns, n in by_ns.items()})


@contextlib.contextmanager
def flash_calls(seen):
    """Count in the ``collections.Counter`` ``seen`` each distinct call the
    block makes to the flash wrapper, as (q shape, k shape, q dtype, K/V
    dtype, whether K/V are contiguous, keyword arguments), and to its
    gradient wrapper (``flash_attention_bwd_bhsd``, which
    ``FlashAttention.backward`` runs on autograd's thread), as ("backward",
    q shape, k shape, dtype, keyword arguments but the forward's ``lse``),
    by pass-throughs in the wrappers' places in their module, where ``ops``
    and the backward look them up at each call; the wrappers themselves run
    and count their launches as ever."""
    import threading

    from repro_torch.kernels import flash_attention as fa

    inner, inner_bwd = fa.flash_attention_bhsd, fa.flash_attention_bwd_bhsd
    lock = threading.Lock()

    def recording(q, k, v, **kw):
        key = (tuple(q.shape), tuple(k.shape), q.dtype, k.dtype,
               k.is_contiguous(), tuple(sorted(kw.items())))
        with lock:
            seen[key] += 1
        return inner(q, k, v, **kw)

    def recording_bwd(q, k, v, o, g, **kw):
        key = ("backward", tuple(q.shape), tuple(k.shape), q.dtype,
               tuple(sorted((n, x) for n, x in kw.items() if n != "lse")))
        with lock:
            seen[key] += 1
        return inner_bwd(q, k, v, o, g, **kw)
    fa.flash_attention_bhsd = recording
    fa.flash_attention_bwd_bhsd = recording_bwd
    try:
        yield seen
    finally:
        fa.flash_attention_bhsd = inner
        fa.flash_attention_bwd_bhsd = inner_bwd


def hold_flash_calls(torch, seen, phase="phase 5c"):
    """The flash kernel at every forward call ``flash_calls`` recorded, on
    fresh N(0, 1) inputs of the same shapes, dtypes, layout
    (non-contiguous K/V: strided views of a (B, L, KV, hd) cache, as
    ``attn_decode`` hands them) and arguments, against the plain version
    (and the bf16 sequence form also against ``attention_tiled_ref``), to
    ``TOL`` of the query's dtype; a call that asked for lse (``return_lse``,
    ``FlashAttention``'s forward) also its lse against ``attention_lse``,
    to 1e-5 (absolute and relative). Prints the calls and the worst error
    by form. Then the gradient kernel at every backward call it recorded
    (``hold_flash_bwd_calls``)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(5)
    worst = collections.defaultdict(lambda: [0, 0.0, 0.0])
    bwd = {key: n for key, n in seen.items() if key[0] == "backward"}
    for qs, ks, qdt, kdt, contiguous, kw in sorted(
            (key for key in seen if key[0] != "backward"), key=str):
        kw = dict(kw)
        asked = kw.pop("return_lse", False)
        B, KV, T, hd = ks
        q = torch.randn(*qs, generator=g, device="cuda").to(qdt)
        if contiguous:
            k, v = (torch.randn(*ks, generator=g, device="cuda").to(kdt)
                    for _ in range(2))
        else:
            k, v = (ring_view(torch, g, B, T, KV, T, hd, kdt)
                    for _ in range(2))
        got = fa.flash_attention_bhsd(q, k, v, return_lse=asked, **kw)
        if asked:
            got, lse = got
            want = fa.attention_lse(q, k, **{
                n: x for n, x in kw.items() if n not in ("seq_q", "softcap")})
            excess = float(((lse - want).abs() - 1e-5 * want.abs()).max())
            expect(excess <= 1e-5, f"flash's lse at a {phase} call {qs} over "
                   f"{ks} {dtype_name(qdt)} {kw}: off attention_lse by "
                   f"{excess} over 1e-5 + 1e-5 |lse|")
        tol = TOL[dtype_name(qdt)]
        refs = [fa.attention_ref(q, k, v, **kw)]
        form = ("decode" if qs[2] == 1 and not asked
                else f"seq_{dtype_name(qdt)}")
        if form == "seq_bfloat16":
            refs.append(fa.attention_tiled_ref(q, k, v, **kw))
        torch.cuda.synchronize()
        w = worst[form]
        w[0] += 1
        for i, want in enumerate(refs):
            err = max_err(got, want)
            expect(err <= tol, f"flash at a {phase} call {qs} over {ks} "
                   f"{dtype_name(qdt)} {kw}: max_abs_err {err} > {tol}"
                   + (" (attention_tiled_ref)" if i else ""))
            w[1 + i] = max(w[1 + i], err)
    if worst:
        print(f"  flash at every distinct call {phase} made, held to the "
              "plain version (bf16 sequence form also to "
              "attention_tiled_ref): "
              + "; ".join(f"{form} {n} calls, max_abs_err {e:.3e}"
                          + (f" ({t:.3e} tiled)" if form == "seq_bfloat16"
                             else "")
                          for form, (n, e, t) in sorted(worst.items()))
              + f" (tol {TOL})", flush=True)
    hold_flash_bwd_calls(torch, bwd, phase)


def hold_flash_bwd_calls(torch, seen, phase):
    """Flash's gradient kernel at every backward call ``flash_calls``
    recorded (``seen``: key -> calls), on fresh N(0, 1) q, k, v and upstream
    of the same shapes, dtype and arguments, ``o`` and ``lse`` the forward
    kernel's: its dq, dk, dv against autograd through ``attention_ref``,
    each relative to that gradient's max, to ``TOL`` of the dtype, and two
    calls bitwise equal; then its device ms a call (CUDA-graph replay)
    beside its bound
    (``flash_bwd_bound``). Prints each call with its launches."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(6)
    for key in sorted(seen, key=str):
        _, qs, ks, dt, kw = key
        kw = dict(kw)
        q, do = (torch.randn(*qs, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(*ks, generator=g, device="cuda").to(dt)
                for _ in range(2))
        o, lse = fa.flash_attention_bhsd(q, k, v, return_lse=True, **kw)
        run_k = lambda: fa.flash_attention_bwd_bhsd(       # noqa: E731
            q, k, v, o, do, lse=lse, **kw)
        got, again = run_k(), run_k()
        rel = [e / scale for e, scale in
               flash_bwd_errors(torch, q, k, v, kw, do, got)]
        tol = TOL[dtype_name(dt)]
        label = (f"flash's gradient kernel at a {phase} call {qs} over {ks} "
                 f"{dtype_name(dt)} {kw}")
        expect(max(rel) <= tol, f"{label}: dq, dk, dv errors relative to "
               f"the gradient's max {rel} > {tol}")
        expect(all(torch.equal(a, b) for a, b in zip(got, again)),
               f"{label}: two calls differ")
        del got, again
        big = qs[0] * qs[1] * qs[2] * ks[2] > 1 << 26
        ms = graph_ms(torch, run_k,
                      **(dict(iters=2, replays=2) if big else {}))
        b_ms, b_by = flash_bwd_bound(q, k, v, **kw)
        print(f"  {label}: {seen[key]} calls; dq, dk, dv max error "
              f"relative to the gradient's max "
              + ", ".join(f"{e:.3e}" for e in rel) + f" (tol {tol:.0e}), "
              f"two calls bitwise equal; device ms a call {ms:.4f}, bound "
              f"{b_ms:.6f} ({b_by}, "
              f"{100 * b_ms / ms:.1f}% of it)", flush=True)
        del q, k, v, o, lse, do


def run_session(torch, pp, spec, devices, label, *, keep=False, calls=None):
    """One campaign through ``ImpressSession`` on the card: the launch
    counters zeroed just before ``run()`` and read just after, held to what
    the completed tasks imply by kernel, flash form and namespace; no task
    failed or retried; every pipeline finished; one report section per
    protocol; every design in range. The run's flash calls are counted
    in ``calls`` (``flash_calls``). Prints the makespan (campaign and
    per protocol), tasks by kind and stage, dispatches, designs accepted by
    cycle, the length buckets and first calls per shape key. Returns
    (session or None, report, accepted designs by pipeline)."""
    from repro_torch.core.pipeline import TaskState
    from repro_torch.kernels import ops
    from repro_torch.session import ImpressSession

    sess = ImpressSession(spec, payload=pp, devices=devices)
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        with flash_calls(collections.Counter() if calls is None else calls):
            rep = sess.run(timeout=300)
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        forms = dict(ops.forms["flash_attention_bhsd"])
        by_ns = {ns: dict(c) for ns, c in ops.by_namespace.items()}
        coord = sess.coordinator
        done = [t for t in sess.executor._tasks.values()
                if t.state == TaskState.DONE]
        first = {k.split("{")[1][5:-1]: round(v["count"] * v["mean"], 3)
                 for k, v in sess.metrics_snapshot().items()
                 if k.startswith("torch.payload_first_call_s")}
        t0 = sess._run_t0
    except BaseException:
        sess.shutdown()
        raise
    if not keep:
        sess.shutdown()
    pls = list(coord.pipelines.values())
    names = {ps.name or ps.kind for ps in sess.protocol_specs}
    proto_of = {p.uid: (p.name.split("/")[0] if len(names) > 1
                        else next(iter(names))) for p in pls}
    ex = rep.executor
    expect(ex["n_failed"] == 0 and ex["n_retried"] == 0,
           f"{label}: {ex['n_failed']} failed, {ex['n_retried']} retried")
    expect(not any(p.active for p in pls), f"{label}: pipelines still active")
    expect(set(rep.protocols) == names,
           f"{label}: report sections {sorted(rep.protocols)}")
    for p in pls:
        for h in p.history:
            if "sequence" in h:
                expect(0 <= h["plddt"] <= 100 and 0 <= h["ptm"] <= 1
                       and 0 <= h["pae"] <= 30
                       and all(0 <= a < pp.gen_cfg.vocab_size
                               for a in h["sequence"]),
                       f"{label}: design out of range: {h}")
    want, want_forms, want_ns = implied_session_launches(done, pp)
    kinds = collections.Counter(t.kind for t in done)
    print(f"  {label}: makespan {rep.makespan_s:.3f} s; tasks by kind "
          f"{dict(kinds)}; {rep.n_pipelines} pipelines + "
          f"{rep.n_sub_pipelines} sub-pipelines, {rep.trajectories} "
          f"trajectories; device utilization (allocator) "
          f"{rep.utilization:.3f}; length buckets "
          f"{rep['compile']['length_buckets']}", flush=True)
    for name in sorted(names):
        mine = [t for t in done if proto_of.get(t.pipeline_id) == name]
        end = max(t.timestamps["DONE"] for t in mine) - t0
        lead = [t for t in mine if t.kind not in ("generate_batch",
                                                  "predict_batch")
                or t.result["batch"].get("leader", True)]
        by_cycle = {c: v["n"]
                    for c, v in rep.protocols[name]["cycles"].items()}
        print(f"    {name}: makespan {end:.3f} s; tasks by kind "
              f"{dict(collections.Counter(t.kind for t in mine))}; "
              f"{len(lead)} dispatches led; designs accepted by cycle "
              f"{by_cycle}", flush=True)
    runs = collections.defaultdict(list)
    for t in done:
        if t.kind in ("generate_batch", "predict_batch") \
                and not t.result["batch"].get("leader", True):
            continue
        runs[t.kind, t.payload.get("params") or "default"].append(
            1e3 * t.duration())
    print("    ms a dispatch (run, host clock, first calls included), by "
          "kind and namespace: " + "; ".join(
              f"{k}@{ns} {len(v)}x median {statistics.median(v):.2f}, "
              f"{min(v):.2f}-{max(v):.2f}"
              for (k, ns), v in sorted(runs.items())), flush=True)
    stages = {k: (v["tasks"], v["dispatches"])
              for k, v in rep["stages"].items() if k != "__bands__"}
    if stages:
        print(f"    tasks, dispatches by stage: {stages}", flush=True)
    print(f"    first calls per shape key (s, in the makespan): {first}",
          flush=True)
    print(f"    launches {counts}, flash by form {forms}, flash by namespace "
          f"{ {ns: c['flash_attention_bhsd'] for ns, c in by_ns.items()} }; "
          f"implied by the completed tasks: {want['flash_attention_bhsd']} "
          f"flash, {want_forms}, "
          f"{ {ns: c['flash_attention_bhsd'] for ns, c in want_ns.items()} }",
          flush=True)
    expect(counts == want and forms == want_forms and by_ns == want_ns,
           f"{label}: launches {counts} {forms} {by_ns}, the completed tasks "
           f"imply {want} {want_forms} {want_ns}")
    accepted = {p.name: [(h["cycle"], h["sequence"], h["fitness"])
                         for h in p.history if "sequence" in h] for p in pls}
    return (sess if keep else None), rep, accepted


def time_scorers(torch, pp):
    """``predict_batch`` as campaign B's fold stage calls it (4 rows of 24 +
    6 tokens, masked, bucketed to 32) on foldscore-m ("multimer", 12
    layers) and on foldscore-s ("default", 8 layers), and foldscore-s's
    exact form (4 x 30): wall ms per call to the end of its device work,
    median of 20 after 3 warm-up calls."""
    import numpy as np
    from repro_torch.runtime.allocator import SubMesh

    mesh = SubMesh((pp.device,))
    rng = np.random.default_rng(9)
    exact = {"sequences": rng.integers(1, 21, size=(4, RECEPTOR + PEPTIDE)),
             "target": rng.normal(size=16).astype(np.float32),
             "receptor_len": RECEPTOR}
    masked = dict(exact, seq_lens=np.full(4, RECEPTOR + PEPTIDE),
                  chain_splits=np.full(4, RECEPTOR))
    out = []
    for label, payload in (("foldscore-m masked", dict(masked,
                                                       params="multimer")),
                           ("foldscore-s masked", masked),
                           ("foldscore-s exact", exact)):
        walls = []
        for i in range(23):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pp.predict_batch(mesh, payload)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t))
        out.append(f"{label} {statistics.median(walls[3:]):.2f}")
    print(f"  predict_batch 4 rows x {RECEPTOR + PEPTIDE} tokens (masked: "
          f"bucket {pp.length_buckets}), wall ms a call, median of 20: "
          + ", ".join(out), flush=True)


def namespace_weights(torch, pp):
    """That a param-set label picks its own weights, which the launch
    counts cannot show where two namespaces run the same model ("binder"
    and "default" are both progen-s): a dense ``generate_batch`` of 2 rows
    x 6 candidates on the "binder" namespace, with fixed Gumbel noise, must
    give the tokens of ``progen_sample`` on ``gen_stores["binder"]``'s
    weights with the same noise at the same shape, and not those of the
    "default" generator's."""
    import numpy as np
    from repro_torch.models import protein as prot
    from repro_torch.runtime.allocator import SubMesh

    rng = np.random.default_rng(11)
    rows, length = 2, RECEPTOR
    bbs = rng.normal(size=(rows, RECEPTOR + PEPTIDE, 16)).astype(np.float32)
    noise = rng.gumbel(size=(rows, N_CAND, length,
                             pp.gen_cfgs["binder"].padded_vocab)) \
        .astype(np.float32)
    got = pp.generate_batch(SubMesh((pp.device,)), {
        "backbones": bbs, "seeds": np.arange(rows), "n": N_CAND,
        "length": length, "noise": noise, "params": "binder"})
    got = np.stack([s for s, _ in got["rows"]])
    want = {}
    with torch.inference_mode():
        for ns in ("binder", "default"):
            ver, w = pp.gen_stores[ns].current()
            seqs, _ = prot.progen_sample(
                pp._params_on(("gen", ns, ver), w, pp.device),
                torch.tensor(bbs, device=pp.device), N_CAND, length,
                pp.gen_cfgs[ns], noise=noise)
            want[ns] = seqs.cpu().numpy()
    same = {ns: bool(np.array_equal(got, t)) for ns, t in want.items()}
    print(f"  generate_batch on the \"binder\" namespace, {rows} x {N_CAND} "
          f"candidates, fixed noise: tokens equal to progen_sample on the "
          f"binder generator's weights {same['binder']}, on the default "
          f"generator's {same['default']}", flush=True)
    expect(same["binder"] and not same["default"],
           f"the \"binder\" label did not run the binder generator: {same}")


def phase_session(torch, pp):
    """Phase 5c: the session on the H100 at full width (progen-s,
    foldscore-s, foldscore-m): campaign A (im-rp, cont-v, multi-objective
    on one executor, with ``devices=None``: every CUDA device), its
    checkpoint restored into a fresh session, and campaign B (the staged
    binder beside the rescore co-tenant over mixed lengths), then the
    binder alone (its designs beside and without the co-tenant, printed)
    and one cycle of campaign B under torch.profiler; then the flash kernel
    held to its plain version at every distinct call those runs made, and
    the "binder" label shown to run the binder generator's weights."""
    import dataclasses

    from repro_torch.session import ImpressSession

    t_phase = time.perf_counter()
    spec_a, spec_b = session_specs()
    cuda0 = torch.device("cuda", 0)
    kinds_a = [p.kind for p in spec_a.protocols]
    print(f"phase 5c: the session: campaign A {kinds_a} x "
          f"{spec_a.structures} structures (receptor {RECEPTOR} + peptide "
          f"{PEPTIDE}), {N_CAND} candidates, {SESSION_CYCLES} cycles; "
          f"ImpressSession(devices=None) -> all CUDA devices", flush=True)
    calls = collections.Counter()       # the flash calls of every run
    sess, rep_a, _ = run_session(torch, pp, spec_a, None, "campaign A",
                                 keep=True, calls=calls)
    try:
        expect(sess.allocator.healthy_devices == torch.cuda.device_count(),
               "campaign A: devices=None did not take every CUDA device")
        default_layers = pp.fold_sets["default"][0].n_layers
        state = json.loads(json.dumps(sess.checkpoint()))
    finally:
        sess.shutdown()
    restored = ImpressSession.from_checkpoint(state, payload=pp,
                                              devices=[cuda0])
    try:
        names = sorted(p.name
                       for p in restored.coordinator.pipelines.values())
        expect(names == sorted(r["name"]
                               for r in state["coordinator"]["pipelines"]),
               "campaign A's checkpoint rebuilt other pipelines")
        with flash_calls(calls):
            rep_r = restored.run(timeout=60)
        expect(rep_r.trajectories == rep_a.trajectories,
               f"restored campaign A added trajectories: "
               f"{rep_r.trajectories} vs {rep_a.trajectories}")
    finally:
        restored.shutdown()
    print(f"  campaign A checkpoint: {len(json.dumps(state))} bytes of JSON, "
          f"{len(names)} pipelines rebuilt, restored run adds no trajectory",
          flush=True)

    print(f"phase 5c: campaign B {[p.kind for p in spec_b.protocols]} x "
          f"{spec_b.structures} structures, receptor lengths "
          f"{SESSION_B_LENS} + peptide {PEPTIDE}, fair scheduling; "
          f"ImpressSession(devices=[{cuda0}])", flush=True)
    _, rep_b, acc_b = run_session(torch, pp, spec_b, [cuda0], "campaign B",
                                  calls=calls)
    cfg_m, scorer = pp.fold_sets["multimer"]
    expect(cfg_m.name == "foldscore-m" and cfg_m.n_layers == 12
           and len(scorer.layers) == 12 and default_layers == 8,
           f"multimer scorer {cfg_m.name} with {len(scorer.layers)} layers")
    st = rep_b["stages"]
    expect({"backbone", "seqdesign", "fold"} <= set(st),
           f"campaign B stage sections {sorted(st)}")
    expect(st["fold"]["tasks"] > st["fold"]["dispatches"],
           f"campaign B: {st['fold']['tasks']} fold tasks in "
           f"{st['fold']['dispatches']} dispatches: nothing fused")
    binder = {k: v for k, v in acc_b.items() if k.startswith("binder/")}
    expect(len(binder) == spec_b.structures
           and all(len(v) == SESSION_CYCLES for v in binder.values()),
           f"campaign B: binder designs by pipeline "
           f"{ {k: len(v) for k, v in binder.items()} }")

    time_scorers(torch, pp)
    solo_spec = dataclasses.replace(spec_b, protocols=spec_b.protocols[:1])
    _, _, acc_solo = run_session(torch, pp, solo_spec, [cuda0],
                                 "campaign B, binder alone", calls=calls)
    same = {f"binder/{k}": v for k, v in acc_solo.items()} == binder
    print(f"  binder designs identical alone and beside the rescore "
          f"co-tenant (bf16, on the card): {same}", flush=True)
    one = dataclasses.replace(spec_b, protocols=tuple(
        dataclasses.replace(p, n_cycles=1) for p in spec_b.protocols))
    profile_step(torch, lambda: run_session(torch, pp, one, [cuda0],
                                            "campaign B, 1 cycle",
                                            calls=calls),
                 "campaign B, 1 cycle", top=8)
    hold_flash_calls(torch, calls)
    namespace_weights(torch, pp)
    print(f"  phase 5c took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def finetune_flash(torch):
    """Phase 5d (a): the flash kernel's autograd Function on the card at
    the finetune batch's shape (8 rows x 8/4 heads of 32, causal, 30
    backbone rows + 24 design tokens), at a ragged length and at a GQA
    group of 1: its forward against the plain version (``TOL``) and its
    dq/dk/dv against ``torch.autograd`` through ``attention_ref``, each
    relative to that gradient's max (``TOL``); one launch a forward and
    one of the gradient kernel a backward, both in the forward's
    ``ops.tally``. Then, at the finetune shape in bf16, the forward
    kernel's, the plain version's and sdpa's device times, and the
    gradient kernel's record (``flash_bwd_record``). Returns the kernel
    records of the finetune shape: the forward's and the gradient's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    S = RECEPTOR + PEPTIDE + RECEPTOR
    g = torch.Generator(device="cuda").manual_seed(7)
    for label, (B, H, KV, Sq) in (
            (f"finetune batch {EVO_BATCH} x 8/4 x {S}", (EVO_BATCH, 8, 4, S)),
            ("ragged 37", (EVO_BATCH, 8, 4, 37)),
            (f"GQA group 1, {EVO_BATCH} x 8/8 x {S}", (EVO_BATCH, 8, 8, S))):
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, Sq, 32, generator=g, device="cuda").to(dt)
            k, v = (torch.randn(B, KV, Sq, 32, generator=g,
                                device="cuda").to(dt) for _ in range(2))
            do = torch.randn(B, H, Sq, 32, generator=g, device="cuda").to(dt)
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            torch.cuda.synchronize()
            ops.reset_launches()
            with ops.tally() as counts:
                out = fa.flash_attention_grad(q, k, v)
            grads = torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
            n, f = ops.launches["flash_attention_bhsd"], \
                dict(ops.forms["flash_attention_bhsd"])
            want = fa.attention_ref(q, k, v)
            want_g = torch.autograd.grad(want, (q, k, v), do)
            tol = TOL[dtype_name(dt)]
            check(f"flash Function {label} {dtype_name(dt)} forward",
                  max_err(out.detach(), want.detach()), tol)
            rel = [max_err(a, b) / float(b.float().abs().max())
                   for a, b in zip(grads, want_g)]
            print(f"  flash Function {label} {dtype_name(dt)} dq, dk, dv: "
                  f"max error relative to the gradient's max "
                  + ", ".join(f"{e:.3e}" for e in rel) + f" (tol {tol:.0e})",
                  flush=True)
            expect(max(rel) <= tol, f"flash Function {label} "
                   f"{dtype_name(dt)}: gradient errors {rel} > {tol}")
            form = "seq_f32" if dt == torch.float32 else "seq_bf16"
            tallied = {"flash_attention_bhsd": 2,
                       ("flash_attention_bhsd", form): 1,
                       ("flash_attention_bhsd", "backward"): 1}
            expect(n == 2 and f == flash_forms(**{form: 1}, backward=1)
                   and counts == tallied,
                   f"flash Function: {n} launches {f} (the forward's tally "
                   f"{dict(counts)}) for one forward and backward, not 1 of "
                   f"{form} and 1 backward")
    B, H, KV = EVO_BATCH, 8, 4
    q, k, v = (torch.randn(B, h, S, 32, generator=g, device="cuda",
                           dtype=torch.bfloat16) for h in (H, KV, KV))
    run_k = lambda: fa.flash_attention_bhsd(q, k, v)
    run_p = lambda: fa.attention_ref(q, k, v)
    run_l = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True)
    err = max_err(run_k(), run_p())
    b_ms, b_by = flash_bound(q, k, v)
    ms, plain, lib = (graph_ms(torch, run_k), graph_ms(torch, run_p),
                      graph_ms(torch, run_l))
    print(f"  flash at the finetune shape {B} x {H}/{KV} x {S} bf16, device "
          f"ms per call: kernel {ms:.4f}, plain {plain:.4f}, sdpa {lib:.4f}, "
          f"bound {b_ms:.6f} ({b_by}); wall per back-to-back call: kernel "
          f"{wall_ms(torch, run_k):.4f}; err {err:.3e}", flush=True)
    bwd = flash_bwd_record(
        torch, "flash_attention_bhsd_bwd_finetune",
        f"at the finetune shape {B} x {H}/{KV} x {S}, hd 32, causal, bf16",
        q, k, v, {}, {"is_causal": True})
    return [{"name": "flash_attention_bhsd_finetune", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:82",
             "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}, bwd]


def finetune_batch(rng, rows, P, L):
    import numpy as np
    return {"backbones": rng.normal(size=(rows, P, 16)).astype(np.float32),
            "sequences": rng.integers(1, 21, size=(rows, L)).astype(np.int32),
            "weights": np.linspace(1.0, 0.2, rows).astype(np.float32)}


def finetune_agreement(torch):
    """Phase 5d (b): a reduced progen-s finetune of 5 steps in fp32 on one
    set of weights and one batch, on the card (the flash kernel's fp32
    form, one launch a layer a step) and on the CPU (its plain version):
    the same losses and log-likelihoods to ``EVO_LOSS_RTOL`` and every
    evolved parameter to ``EVO_PARAM_ATOL``."""
    import copy

    import numpy as np
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.payload import FinetunePayload, ProteinPayload
    from repro_torch.kernels import ops
    from repro_torch.models import protein as prot
    from repro_torch.runtime.allocator import SubMesh

    gcfg = get_reduced("progen-s").replace(compute_dtype="float32")
    fcfg = get_reduced("foldscore-s").replace(compute_dtype="float32")
    weights = prot.init_progen(gcfg, 0, device="cpu")
    batch = finetune_batch(np.random.default_rng(8), 4, gcfg.frontend_seq, 12)
    out = {}
    for dev in ("cuda", "cpu"):
        pp = ProteinPayload(gen_cfg=gcfg, fold_cfg=fcfg, device=dev,
                            progen=copy.deepcopy(weights))
        ops.reset_launches()
        res = FinetunePayload(pp, lr=1e-3, steps=5).finetune(
            SubMesh((pp.device,)), dict(batch))
        if dev == "cuda":
            torch.cuda.synchronize()
            n = ops.forms["flash_attention_bhsd"]["seq_f32"]
            n_bwd = ops.forms["flash_attention_bhsd"]["backward"]
            expect(n == n_bwd == gcfg.n_layers * 5
                   and ops.launches["flash_attention_bhsd"] == 2 * n,
                   f"reduced finetune on the card: {n} flash launches and "
                   f"{n_bwd} of the gradient kernel, not {gcfg.n_layers} x 5 "
                   f"each")
        out[dev] = (res, dict(pp.param_store.current()[1]
                              .named_parameters()))
    (gres, gp), (cres, cp) = out["cuda"], out["cpu"]
    keys = ("loss_first", "loss_last", "mean_ll_first", "mean_ll_last")
    rel = max(abs(gres[k] - cres[k]) / abs(cres[k]) for k in keys)
    print(f"  reduced finetune, 5 steps fp32, card vs CPU: losses "
          f"{gres['loss_first']:.5f} -> {gres['loss_last']:.5f} (CPU "
          f"{cres['loss_first']:.5f} -> {cres['loss_last']:.5f})", flush=True)
    check("reduced finetune losses card vs CPU, relative", rel, EVO_LOSS_RTOL)
    check("reduced finetune parameters card vs CPU",
          max(max_err(gp[n].cpu(), cp[n]) for n in cp), EVO_PARAM_ATOL)
    expect(gres["loss_last"] < gres["loss_first"],
           "reduced finetune on the card did not lower its loss")


@contextlib.contextmanager
def finetune_tallies(out):
    """Append to the list ``out`` a (launches, result) pair for each
    finetune task run in the block: the launches its own thread made
    (``ops.tally``), by a pass-through in ``FinetunePayload.finetune``'s
    place on the class, where the session's registration looks it up."""
    from repro_torch.core.payload import FinetunePayload
    from repro_torch.kernels import ops

    inner = FinetunePayload.finetune

    def tallied(self, submesh, payload):
        with ops.tally() as counts:
            res = inner(self, submesh, payload)
        out.append((dict(counts), res))
        return res
    FinetunePayload.finetune = tallied
    try:
        yield out
    finally:
        FinetunePayload.finetune = inner


def evolution_specs():
    """Phase 5d's sessions: im-rp at full width with and without model
    evolution, otherwise alike. No sub-pipelines: a sub-pipeline's uid,
    hence its seed, depends on how completions interleave, and without
    them the two runs do the same design work until a finetune
    publishes."""
    import dataclasses

    from repro_torch.session import CampaignSpec, ProtocolSpec
    base = CampaignSpec(structures=EVO_STRUCTURES, receptor_len=RECEPTOR,
                        peptide_len=PEPTIDE, max_workers=2, seed=0,
                        reduced=False, protocols=(ProtocolSpec(
                            "im-rp", n_cycles=EVO_CYCLES,
                            n_candidates=N_CAND, max_sub_pipelines=0),),
                        finetune_every=2, min_designs=2,
                        finetune_batch=EVO_BATCH)
    return base, dataclasses.replace(base, evolution=True)


def evolved_weights_ran(torch, pp, v0):
    """Phase 5d (d): a dense ``generate_batch`` of 2 rows x 6 candidates
    with fixed noise after the evolution session must give the tokens of
    ``progen_sample`` on the store's current (evolved) weights, not those
    of version 0's weights ``v0``."""
    import numpy as np
    from repro_torch.models import protein as prot
    from repro_torch.runtime.allocator import SubMesh

    rng = np.random.default_rng(12)
    rows, length = 2, RECEPTOR
    bbs = rng.normal(size=(rows, RECEPTOR + PEPTIDE, 16)).astype(np.float32)
    noise = rng.gumbel(size=(rows, N_CAND, length, pp.gen_cfg.padded_vocab)
                       ).astype(np.float32)
    got = pp.generate_batch(SubMesh((pp.device,)), {
        "backbones": bbs, "seeds": np.arange(rows), "n": N_CAND,
        "length": length, "noise": noise})
    expect(got["gen_version"] == pp.param_store.version,
           f"generate_batch ran version {got['gen_version']}, the store is "
           f"at {pp.param_store.version}")
    got = np.stack([s for s, _ in got["rows"]])
    want = {}
    with torch.inference_mode():
        for label, w in (("evolved", pp.param_store.current()[1]),
                         ("version 0", v0)):
            seqs, _ = prot.progen_sample(
                w, torch.tensor(bbs[:, :pp.gen_cfg.frontend_seq],
                                device=pp.device),
                N_CAND, length, pp.gen_cfg, noise=noise)
            want[label] = seqs.cpu().numpy()
    same = {k: bool(np.array_equal(got, t)) for k, t in want.items()}
    print(f"  generate_batch after the evolution session, {rows} x {N_CAND} "
          f"candidates, fixed noise: tokens equal to progen_sample on the "
          f"evolved weights (version {pp.param_store.version}) "
          f"{same['evolved']}, on version 0's {same['version 0']}",
          flush=True)
    expect(same["evolved"] and not same["version 0"],
           f"the dispatch after evolution did not run the evolved "
           f"weights: {same}")


def checkpoint_round_trip(torch, pp, v0):
    """Phase 5d (e): version 0 and the evolved version saved through one
    ``CheckpointManager`` by ``ParamStore.save``; the evolved one restores
    into a fresh store with logits bitwise those of the weights saved; then
    its ``.npz`` is garbled, and a restore falls back to version 0's intact
    copy, again bitwise."""
    import copy
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import CheckpointManager, verify_checkpoint
    from repro_torch.learn.param_store import ParamStore
    from repro_torch.models import lm
    from repro_torch.models import protein as prot

    cfg = pp.gen_cfg
    rng = np.random.default_rng(13)
    bb = torch.tensor(rng.normal(size=(2, RECEPTOR + PEPTIDE, 16)),
                      dtype=torch.float32, device=pp.device)
    toks = torch.tensor(rng.integers(0, 21, size=(2, RECEPTOR)),
                        device=pp.device)

    def logits(w):
        with torch.inference_mode():
            return lm.lm_logits(w, {"inputs": toks, "patches":
                                    prot.encode_structure(w, bb, cfg)}, cfg)

    ver, evolved = pp.param_store.current()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3, async_write=True)
        ParamStore(v0, version=0).save(mgr, block=True)
        pp.param_store.save(mgr)           # on the manager's writer thread
        mgr.wait()
        fresh = ParamStore(copy.deepcopy(v0))
        retired = []
        fresh.on_retire(retired.extend)
        got = fresh.restore(mgr)
        expect(got == ver and torch.equal(logits(fresh.current()[1]),
                                          logits(evolved)),
               f"restored step {got} (want {ver}) or its logits differ")
        expect(retired == [0], f"the restore announced {retired} retired")
        expect(fresh.publish(copy.deepcopy(v0)) == ver + 1,
               "publishing after the restore reused a version number")
        path = mgr._base(ver) + ".npz"
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            f.write(b"\xff" * 64)
        expect(not verify_checkpoint(mgr._base(ver)),
               "the garbled checkpoint passed verification")
        fresh = ParamStore(copy.deepcopy(v0))
        got = fresh.restore(mgr)
        expect(got == 0 and torch.equal(logits(fresh.current()[1]),
                                        logits(v0)),
               f"the fallback restored step {got}, or its logits differ")
    print(f"  checkpoint round trip on the card: version {ver} restored "
          f"with bitwise logits, publishing on at {ver + 1}; its .npz "
          f"garbled, the restore fell back to step 0, bitwise", flush=True)


def finetune_step_timing(torch, pp):
    """Phase 5d (f): one train step at the finetune batch's shape (8 rows x
    30 backbone rows + 24 tokens) on a trainable copy of the generator:
    wall ms a step (median of 10 after 2 warm-up steps, synchronized), then
    one step under torch.profiler."""
    import numpy as np
    from repro_torch.core.payload import FinetunePayload
    from repro_torch.learn.param_store import ParamStore
    from repro_torch.models.common import trainable
    from repro_torch.optim import init_opt_state

    ft = FinetunePayload(pp, lr=1e-3, steps=12, param_store=ParamStore(
        pp.param_store.current()[1]))
    params = trainable(pp.param_store.current()[1])
    state = init_opt_state(dict(params.named_parameters()), ft.opt)
    batch = {k: torch.tensor(v, device=pp.device) for k, v in finetune_batch(
        np.random.default_rng(14), EVO_BATCH, RECEPTOR + PEPTIDE,
        RECEPTOR).items()}
    step = ft._train_step()
    walls = []
    for _ in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    print(f"  finetune train step, {EVO_BATCH} x ({RECEPTOR + PEPTIDE} + "
          f"{RECEPTOR}) tokens, bf16 compute: wall median "
          f"{statistics.median(walls[2:]):.2f} ms ({min(walls[2:]):.2f}-"
          f"{max(walls[2:]):.2f}), loss {float(m['loss']):.3f}", flush=True)
    profile_step(torch, lambda: step(params, state, batch),
                 "finetune train step", top=10)


def phase_evolution(torch, pp):
    """Phase 5d: model evolution on the H100 at full width. (a) the flash
    Function at the finetune shape; (b) a reduced finetune card vs CPU;
    (c) im-rp through ``ImpressSession`` without and with
    ``evolution=True``, the counters held to what the completed tasks imply
    and each finetune task's own launches to 6 bf16 flash launches and 6
    of the gradient kernel a step, then the flash kernel at every distinct
    call of both runs; (d) the evolved weights shown to
    run; (e) a checkpoint round trip with a garbled copy; (f) a train
    step's wall time and profile. Returns the finetune shape's kernel
    records, the forward's and the gradient kernel's, their launches those
    the finetune tasks of (c) counted."""
    import copy

    from repro_torch.core import pipeline
    from repro_torch.core.pipeline import TaskState

    t_phase = time.perf_counter()
    print("phase 5d: model evolution at full width (progen-s finetune)",
          flush=True)
    records = finetune_flash(torch)
    finetune_agreement(torch)
    base, spec = evolution_specs()
    cuda0 = torch.device("cuda", 0)
    v0 = copy.deepcopy(pp.param_store.current()[1])
    print(f"phase 5d: im-rp x {EVO_STRUCTURES} structures, {EVO_CYCLES} "
          f"cycles, {N_CAND} candidates, without and with evolution "
          f"(finetune every {spec.finetune_every} accepted designs, "
          f"{spec.finetune_steps} steps on up to {EVO_BATCH})", flush=True)
    # both runs draw pipeline and task uids (the sampling seeds) from one
    # start, so they run the same design work until a finetune publishes
    calls = collections.Counter()       # the flash calls of both runs
    uid0 = next(pipeline._uid) + 1
    pipeline._uid = itertools.count(uid0)
    _, rep0, acc0 = run_session(torch, pp, base, [cuda0],
                                "without evolution", calls=calls)
    expect(rep0.evolution is None and pp.param_store.version == 0,
           "the session without evolution evolved the generator")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    pipeline._uid = itertools.count(uid0)
    tallies = []
    with finetune_tallies(tallies):
        sess, rep, acc = run_session(torch, pp, spec, [cuda0],
                                     "with evolution", keep=True,
                                     calls=calls)
    try:
        fts = [t.result for t in sess.executor._tasks.values()
               if t.kind == "finetune" and t.state == TaskState.DONE]
    finally:
        sess.shutdown()
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
    evo = rep.evolution
    done = [r for r in fts if not r["preempted"]]
    steps = sum(r["steps_run"] for r in fts)
    n_layers = pp.gen_cfg.n_layers
    measured = sum(c.get(("flash_attention_bhsd", "seq_bf16"), 0)
                   for c, _ in tallies)
    measured_bwd = sum(c.get(("flash_attention_bhsd", "backward"), 0)
                       for c, _ in tallies)
    print(f"  evolution: {evo['submitted']} finetunes submitted, "
          f"{evo['completed']} completed, {evo['preempted']} preempted, "
          f"{steps} steps; the finetune tasks' own launches (ops.tally) "
          f"{[c for c, _ in tallies]}, {measured} flash forwards and "
          f"{measured_bwd} gradient kernel launches against {n_layers} x "
          f"{steps} steps each; store at version "
          f"{pp.param_store.version}; buffer {evo['buffer']['size']} "
          f"designs", flush=True)
    expect(len(tallies) == len(fts) and all(
        c == {"flash_attention_bhsd": 2 * n_layers * r["steps_run"],
              ("flash_attention_bhsd", "seq_bf16"): n_layers * r["steps_run"],
              ("flash_attention_bhsd", "backward"): n_layers * r["steps_run"]}
        for c, r in tallies), f"finetune tasks' own launches {tallies}, "
        f"not {n_layers} bf16 flash launches and {n_layers} gradient kernel "
        f"launches a step for {len(fts)} tasks")
    for r in fts:
        print(f"    finetune from version {r['base_version']}: "
              f"{r['steps_run']} steps to step {r['steps_done']} on "
              f"{r['n_designs']} designs, {1e3 * r['elapsed_s']:.1f} ms in "
              f"the task" + ("; preempted" if r["preempted"] else
                             f"; loss {r['loss_first']:.3f} -> "
                             f"{r['loss_last']:.3f}, mean log-likelihood "
                             f"{r['mean_ll_first']:.3f} -> "
                             f"{r['mean_ll_last']:.3f}, published version "
                             f"{r['new_version']}"), flush=True)
    print(f"  makespan without evolution {rep0.makespan_s:.3f} s, with "
          f"{rep.makespan_s:.3f} s (the same accepted designs: "
          f"{acc0 == acc}); designs by generator version "
          f"{ {v: q['n'] for v, q in rep.quality_by_version.items()} }; "
          f"peak device memory of the evolution session {peak:.3f} GiB over "
          f"the {before / 2 ** 30:.3f} GiB allocated before it",
          flush=True)
    expect(evo["enabled"] and evo["failed"] == 0,
           f"evolution report {evo}")
    expect(len(done) >= 1 and evo["completed"] == len(done),
           f"{len(done)} finetunes completed")
    expect(all(r["loss_last"] < r["loss_first"] for r in done),
           "a finetune did not lower its loss")
    expect(pp.param_store.version >= 1 and evo["param_version"] >= 1,
           f"the store is at version {pp.param_store.version}")
    hold_flash_calls(torch, calls, "phase 5d")
    evolved_weights_ran(torch, pp, v0)
    checkpoint_round_trip(torch, pp, v0)
    finetune_step_timing(torch, pp)
    records[0]["launches"], records[1]["launches"] = measured, measured_bwd
    print(f"  phase 5d took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return records


# -- phase 5e: the gateway ---------------------------------------------------


def http(base, method, path, tok=None, body=None):
    """One JSON request to the gateway on localhost: (status, body)."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"}
    if tok:
        headers["Authorization"] = f"Bearer {tok}"
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_submit(base, tok, spec):
    s, r = http(base, "POST", "/campaigns", tok, spec)
    expect(s == 201, f"submit answered {s}: {r}")
    return r["id"]


def http_wait(base, cid, tok, timeout=300.0):
    """Poll a campaign's report over HTTP until it is terminal."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s, rep = http(base, "GET", f"/campaigns/{cid}/report", tok)
        expect(s == 200, f"report of {cid} answered {s}: {rep}")
        if rep["state"] in ("COMPLETED", "CANCELED", "FAILED"):
            return rep
        time.sleep(0.02)
    raise AssertionError(f"campaign {cid} did not finish in {timeout} s")


def gateway_spec(seed, structures=GATEWAY_STRUCTURES):
    """``benchmarks/bench_gateway.py``'s default tenant spec at full width:
    a staged binder campaign over receptor lengths 24 and 32 (cycled),
    peptide 8, 2 cycles of 6 candidates, 3 rows a fold batch."""
    return {"structures": structures, "receptor_len": [24, 32],
            "peptide_len": 8, "seed": seed, "reduced": False,
            "protocols": [{"kind": "binder", "n_cycles": 2,
                           "n_candidates": N_CAND, "score_batch": 3}]}


def implied_gateway_launches(done, pp):
    """``implied_session_launches`` plus paged decode: a paged
    ``generate_batch`` dispatch (its leader's result) is one flash
    sequence launch a generator layer an admission and one paged launch a
    layer a decode step."""
    paged = collections.Counter()
    rest = []
    for t in done:
        if t.kind == "generate_batch" and t.payload.get("decode") == "paged":
            if t.result["batch"].get("leader", True):
                ns = t.payload.get("params") or "default"
                n = pp.gen_cfgs[ns].n_layers
                paged[ns, "seq"] += n * t.result["batch"]["admits"]
                paged[ns, "paged"] += n * t.result["batch"]["steps"]
        else:
            rest.append(t)
    want, forms, by_ns = implied_session_launches(rest, pp)
    zero = dict.fromkeys(want, 0)
    for (ns, part), n in paged.items():
        key = "flash_attention_bhsd" if part == "seq" else "paged_decode_bkgh"
        want[key] += n
        by_ns.setdefault(ns, dict(zero))[key] += n
        if part == "seq":
            forms["seq_bf16"] += n
    return want, forms, by_ns


@contextlib.contextmanager
def paged_calls(seen):
    """Append to the list ``seen`` each call the block makes to the paged
    decode wrapper, as its shapes, dtypes, page size and a device copy of
    its lengths (read after the block, so the run is not synchronized), by
    a pass-through in the wrapper's place in its module, where ``ops``
    looks it up at each call."""
    from repro_torch.kernels import paged_attention as pa

    inner = pa.paged_decode_bkgh

    def recording(q, k_pages, v_pages, block_tables, lengths, *, page_size):
        seen.append((tuple(q.shape), tuple(k_pages.shape), q.dtype,
                     k_pages.dtype, tuple(block_tables.shape), page_size,
                     lengths.clone()))
        return inner(q, k_pages, v_pages, block_tables, lengths,
                     page_size=page_size)
    pa.paged_decode_bkgh = recording
    try:
        yield seen
    finally:
        pa.paged_decode_bkgh = inner


def hold_paged_calls(torch, seen, phase):
    """The paged kernel at every distinct call ``paged_calls`` recorded
    (shapes, page size and row lengths), on fresh inputs with a NaN trash
    page past every row's length, in the call's dtype and in fp32, against
    the plain version, to ``PAGED_TOL``."""
    import numpy as np
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(21)
    calls = {(qs, ks, qdt, kdt, bts, page, tuple(lens.tolist()))
             for qs, ks, qdt, kdt, bts, page, lens in seen}
    worst = collections.defaultdict(float)
    for qs, ks, qdt, kdt, bts, page, lens in sorted(calls, key=str):
        B, KV, G, hd = qs
        for dt in {qdt, torch.float32}:
            q, kp, vp, bt, ln, _ = paged_inputs(
                torch, rng, lens, dt, KV=KV, G=G, hd=hd, page=page,
                maxp=bts[1])
            got = pa.paged_decode_bkgh(q, kp, vp, bt, ln, page_size=page)
            want = pa.paged_decode_ref(q, kp, vp, bt, ln, page_size=page)
            torch.cuda.synchronize()
            err = max_err(got, want)
            tol = PAGED_TOL[dtype_name(dt)]
            expect(bool(torch.isfinite(got).all()) and err <= tol,
                   f"paged decode at a {phase} call {qs} lengths {lens} "
                   f"{dtype_name(dt)}: max_abs_err {err} > {tol}")
            worst[dtype_name(dt)] = max(worst[dtype_name(dt)], err)
    print(f"  paged decode at every distinct call {phase} made ({len(seen)} "
          f"calls, {len(calls)} distinct: shapes and row lengths), held to "
          f"the plain version behind a NaN trash page: max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items()))
          + f" (tol {PAGED_TOL})", flush=True)


def gateway_mode(torch, fused, calls):
    """Phase 5e (a) or (b): a fresh ``GatewayService`` at full width on
    every CUDA device (``devices=None``), its HTTP front-end on
    127.0.0.1, alice's and bob's binder campaigns submitted, polled and
    reported over HTTP, one after the other or both live at once. The
    counters are zeroed just before the first submission and read after
    the last completion, and held to what the completed tasks imply."""
    import tempfile
    import threading

    from repro_torch.core.pipeline import TaskState
    from repro_torch.gateway import GatewayService, TenantQuota, make_server
    from repro_torch.kernels import ops

    label = "(b) fused" if fused else "(a) sequential"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as d:
        gw = GatewayService(devices=None, reduced=False, max_workers=4,
                            quotas={t: TenantQuota(1.0)
                                    for t in GATEWAY_TENANTS},
                            trace_dir=os.path.join(d, "trace"),
                            checkpoint_dir=os.path.join(d, "ck"))
        srv = make_server(gw, port=0, tokens=GATEWAY_TOKENS)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = "http://%s:%d" % srv.server_address[:2]
        tok = {t: k for k, t in GATEWAY_TOKENS.items()}
        try:
            gw.start()
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            cids, reports = {}, {}
            with flash_calls(calls):
                # fused: the card is held while both tenants submit, so
                # their first-stage tasks are queued together; else bob's
                # submission can land after alice's first dispatch has
                # closed its 5 ms admission window, and the two campaigns
                # run out of phase without ever sharing a dispatch
                held = gw.allocator.request(1) if fused else None
                expect(not fused or held is not None,
                       "(b) fused: the card could not be held")
                try:
                    for i, tenant in enumerate(GATEWAY_TENANTS):
                        cids[tenant] = http_submit(base, tok[tenant],
                                                   gateway_spec(i))
                        if not fused:
                            reports[tenant] = http_wait(
                                base, cids[tenant], tok[tenant])
                finally:
                    if held is not None:
                        gw.allocator.release(held)
                for tenant in GATEWAY_TENANTS:
                    reports[tenant] = http_wait(base, cids[tenant],
                                                tok[tenant])
                makespan = time.perf_counter() - t0
            s, metrics = http(base, "GET", "/metrics", tok["alice"])
            expect(s == 200, f"GET /metrics answered {s}")
            s, health = http(base, "GET", "/healthz")
            expect(s == 200 and health["status"] == "ok",
                   f"GET /healthz without a token answered {s}: {health}")
            s, _ = http(base, "GET", "/metrics", "tok-nobody")
            expect(s == 401, f"an unknown bearer got {s}, not 401")
            s, _ = http(base, "GET", f"/campaigns/{cids['alice']}/report",
                        tok["bob"])
            expect(s == 404, f"bob read alice's report: {s}, not 404")
        finally:
            srv.shutdown()
            gw.shutdown()
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        forms = dict(ops.forms["flash_attention_bhsd"])
        by_ns = {ns: dict(c) for ns, c in ops.by_namespace.items()}
        tasks = list(gw.executor._tasks.values())
        pp = gw.payload
        expect(os.path.exists(os.path.join(d, "trace", "trace.json")),
               "the gateway wrote no trace")
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
    done = [t for t in tasks if t.state == TaskState.DONE]
    expect(len(done) == len(tasks) and not any(t.retries for t in tasks),
           f"{label}: {len(tasks) - len(done)} tasks not done, "
           f"{sum(t.retries > 0 for t in tasks)} retried")
    for tenant, rep in reports.items():
        expect(rep["state"] == "COMPLETED" and rep["tenant"] == tenant
               and all(len([h for h in p["history"] if "sequence" in h])
                       == 2 for p in rep["pipelines"].values())
               and len(rep["pipelines"]) == GATEWAY_STRUCTURES,
               f"{label}: {tenant}'s campaign {rep['state']}, designs "
               f"{ {n: len(p['history']) for n, p in rep['pipelines'].items()} }")
    want, want_forms, want_ns = implied_gateway_launches(done, pp)
    expect(counts == want and forms == want_forms and by_ns == want_ns,
           f"{label}: launches {counts} {forms} {by_ns}, the completed "
           f"tasks imply {want} {want_forms} {want_ns}")
    cross = metrics["coalesce"].get("cross_tenant", {}).get("dispatches", 0)
    expect(cross >= 1 if fused else cross == 0,
           f"{label}: {cross} cross-tenant fused dispatches")
    traj = sum(r["trajectories"] for r in reports.values())
    kinds = collections.Counter((t.kind, t.stage) for t in done)
    leaders = collections.Counter(
        t.kind for t in done if t.kind not in ("generate_batch",
                                               "predict_batch",
                                               "backbone_batch")
        or t.result["batch"].get("leader", True))
    print(f"  {label}: makespan {makespan:.3f} s, {traj} trajectories, "
          f"{traj / makespan:.3f} candidates/s; {cross} cross-tenant fused "
          f"dispatches; tasks by kind and stage {dict(kinds)} in "
          f"{dict(leaders)} dispatches; bucket table "
          f"{reports['alice']['bucket_table']}", flush=True)
    for tenant in GATEWAY_TENANTS:
        w = metrics["tenants"][tenant]["queue_wait_s"]
        print(f"    {tenant}: p95 queue wait {1e3 * w['p95']:.2f} ms "
              f"({w['count']} tasks), quota {metrics['quotas'][tenant]}",
              flush=True)
    print(f"    launches {counts}, flash by form {forms}, by namespace "
          f"{by_ns}, equal to what the completed tasks imply; the "
          f"gateway's own peak device memory {peak:.3f} GiB over the "
          f"{before / 2 ** 30:.3f} GiB allocated before it; 401 for an "
          f"unknown bearer, 404 for a foreign report, /healthz 200 "
          f"without a token", flush=True)
    return counts, forms, {"makespan": makespan, "trajectories": traj}


def faulted_gateway(torch, calls, paged):
    """Phase 5e (c): carol's im-rp campaign with paged decode beside
    alice's binder campaign in one gateway with a ``FaultPlan``: a
    transient error on carol's first ``generate_batch`` dispatch, a slow
    ``predict_batch`` dispatch, a poison ``predict_batch`` row, a
    corrupted auto-checkpoint (``checkpoint_every_s`` > 0), and a protocol
    handler of carol's that raises once. Returns the launch counts."""
    import tempfile
    import threading

    from repro_torch.checkpoint.io import CheckpointCorruptError
    from repro_torch.core.pipeline import TaskState
    from repro_torch.gateway import GatewayService, make_server
    from repro_torch.kernels import ops
    from repro_torch.resilience import FaultPlan, FaultSpec

    carol = lambda t: t.tenant == "carol"              # noqa: E731
    plan = FaultPlan([
        FaultSpec(op="error", kind="generate_batch", at=1, where=carol),
        FaultSpec(op="slow", kind="predict_batch", at=2, delay_s=0.2,
                  where=carol),
        FaultSpec(op="poison", kind="predict_batch", at=1, where=carol),
        FaultSpec(op="corrupt_checkpoint", at=3),
    ], seed=0)
    fallback = {}
    inner = plan.on_checkpoint_saved
    with tempfile.TemporaryDirectory() as d:
        gw = GatewayService(devices=None, reduced=False, max_workers=4,
                            checkpoint_dir=d, checkpoint_every_s=0.1,
                            fault_plan=plan)

        def probe(path):
            # right after a corrupted copy lands: the newest file fails
            # verification and the load falls back to the .1 copy
            hit = inner(path)
            if hit:
                cid = os.path.basename(path)[len("campaign-"):-len(".json")]
                try:
                    GatewayService._read_envelope(path)
                    fallback["newest_ok"] = True
                except (CheckpointCorruptError, ValueError):
                    fallback["newest_ok"] = False
                fallback["previous"] = GatewayService._read_envelope(
                    path + ".1")
                fallback["loaded"] = gw.load_campaign_checkpoint(cid)
                fallback["cid"] = cid
            return hit
        plan.on_checkpoint_saved = probe
        srv = make_server(gw, port=0, tokens=GATEWAY_TOKENS)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = "http://%s:%d" % srv.server_address[:2]
        tok = {t: k for k, t in GATEWAY_TOKENS.items()}
        stopped = False
        try:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            # the executor runs a campaign's first tasks from its
            # submission on; the drive thread routes their completions.
            # Both are submitted before it starts, so the first round of
            # auto-checkpoints writes carol's (1) then alice's (2): the
            # corrupted third write is carol's second copy
            with flash_calls(calls), paged_calls(paged):
                c = http_submit(base, tok["carol"], FAULTED_SPEC)
                a = http_submit(base, tok["alice"], gateway_spec(0, 1))
                (proto,) = gw._campaigns[c].protocols.values()
                handler = proto.handlers["predict_batch"]
                raised = []

                def raise_once(pl, result):
                    if not raised:
                        raised.append(pl.name)
                        raise RuntimeError("injected protocol handler fault")
                    return handler(pl, result)
                # handlers run on the drive thread, which is not started yet
                proto.handlers["predict_batch"] = raise_once
                gw.start()
                rep_c = http_wait(base, c, tok["carol"])
                rep_a = http_wait(base, a, tok["alice"])
                makespan = time.perf_counter() - t0
                # a restart leaves the crashed binding's dispatches running
                # to their end (their results are dropped): the executor's
                # shutdown waits for them before the counters are read
                srv.shutdown()
                gw.shutdown()
                stopped = True
        finally:
            if not stopped:
                srv.shutdown()
                gw.shutdown()
        torch.cuda.synchronize()
        counts = dict(ops.launches)
        forms = dict(ops.forms["flash_attention_bhsd"])
        by_ns = {ns: dict(cn) for ns, cn in ops.by_namespace.items()}
        tasks = list(gw.executor._tasks.values())
        pp = gw.payload
    summary = plan.summary()
    fired = summary["fired_by_op"]
    done = [t for t in tasks if t.state == TaskState.DONE]
    failed = [t for t in tasks if t.state == TaskState.FAILED]
    res = rep_c.get("resilience", {})
    dead = res.get("deadletter", [])
    poison_ev = [e for e in summary["events"] if e["op"] == "poison"]
    print(f"  (c) faulted: carol's im-rp (paged decode) beside alice's "
          f"binder, makespan {makespan:.3f} s; carol {rep_c['state']}, "
          f"restarts {rep_c.get('restarts', 0)} ({rep_c.get('failure')}), "
          f"{rep_c['trajectories']} trajectories; alice {rep_a['state']}, "
          f"{rep_a['trajectories']} trajectories; faults fired {fired}; "
          f"poison dispatches {poison_ev}; dead letters "
          f"{[(r['kind'], r['class'], r['error']) for r in dead]}; "
          f"{res.get('retries')} retries; tasks by kind "
          f"{dict(collections.Counter(t.kind for t in done))} done, "
          f"{len(failed)} failed", flush=True)
    expect(rep_c["state"] == "COMPLETED" and rep_c.get("restarts") == 1
           and "injected protocol handler fault" in rep_c.get("failure", ""),
           f"carol's campaign {rep_c['state']}, restarts "
           f"{rep_c.get('restarts')}: the supervisor did not restart it")
    expect(rep_a["state"] == "COMPLETED" and "restarts" not in rep_a
           and rep_a["trajectories"] > 0,
           f"the co-tenant's campaign {rep_a['state']}")
    expect(fired.get("error") == 1 and fired.get("slow") == 1
           and fired.get("poison", 0) >= 1
           and fired.get("corrupt_checkpoint") == 1,
           f"faults fired {fired}, not the schedule")
    expect(res.get("faults_injected", {}).get("fired_by_op", {}).get(
        "error") == 1, f"carol's report carries {res.get('faults_injected')}")
    poison = [r for r in dead if r["class"] == "permanent"
              and "poison" in (r["error"] or "")]
    expect(len(poison) == 1 and poison[0]["kind"] == "predict_batch"
           and len(failed) == 1 and failed[0].uid == poison[0]["uid"],
           f"dead letters {dead}, failed tasks "
           f"{[(t.kind, t.error) for t in failed]}")
    expect(poison_ev and poison_ev[0]["fused"],
           f"the poison row's first dispatch {poison_ev} was not fused: "
           f"no batch-mate to complete")
    mates = [t for t in done if t.kind == "predict_batch"
             and t.retries == 1 and t.tenant == "carol"]
    expect(mates, "the poison row's batch-mates did not complete")
    retried = [t for t in done if t.kind == "generate_batch"
               and t.tenant == "carol" and t.retries]
    expect(retried, "no generate_batch retried to done")
    expect(fallback.get("cid") == c and fallback["newest_ok"] is False
           and fallback["loaded"] == fallback["previous"]
           and fallback["loaded"][1] == "carol",
           f"the corrupted checkpoint did not fall back to .1: "
           f"{ {k: v for k, v in fallback.items() if k != 'previous'} }")
    print(f"    the corrupted auto-checkpoint of {c}: the newest copy failed "
          f"verification, load_campaign_checkpoint returned the .1 copy "
          f"(tenant carol); device loss is not run: one card", flush=True)
    want, want_forms, want_ns = implied_gateway_launches(done, pp)
    n_paged = want["paged_decode_bkgh"]
    print(f"    launches {counts}, flash by form {forms}, by namespace "
          f"{by_ns}; implied by the completed tasks: {want}, {want_forms}, "
          f"{want_ns} ({n_paged} paged: {pp.gen_cfg.n_layers} layers x "
          f"{n_paged // pp.gen_cfg.n_layers} decode steps)", flush=True)
    expect(n_paged > 0 and counts == want and forms == want_forms
           and by_ns == want_ns,
           f"(c): launches {counts} {forms} {by_ns}, the completed tasks "
           f"imply {want} {want_forms} {want_ns}")
    return counts, forms


def serve_gateway_cli(torch, pp):
    """Phase 5e (d): ``python -m repro_torch.launch.serve --gateway --port 0
    --checkpoint-dir D`` (full width, every CUDA device): its "listening
    on" line; a single-structure binder campaign over HTTP to its end; a
    second one interrupted by SIGINT while it runs: the process exits 0
    after printing the checkpointed campaign and "gateway stopped", and
    the checkpoint loads in ``ImpressSession.from_checkpoint``."""
    import queue
    import signal
    import tempfile
    import threading

    from repro_torch.gateway import GatewayService
    from repro_torch.session import ImpressSession

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        err_path = os.path.join(d, "stderr.log")
        with open(err_path, "w") as err_file:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve",
                 "--gateway", "--port", "0", "--checkpoint-dir", d], cwd=d,
                env=env, stdout=subprocess.PIPE, stderr=err_file, text=True)
        lines = queue.Queue()
        reader = threading.Thread(target=lambda: [lines.put(ln) for ln in
                                                  proc.stdout], daemon=True)
        reader.start()
        try:
            first = lines.get(timeout=180)
            m = re.match(r"\[serve\] gateway listening on (http://\S+)$",
                         first.strip())
            expect(m is not None, f"serve --gateway printed {first!r}")
            base = m[1]
            t_up = time.perf_counter() - t0
            spec = dict(gateway_spec(0, 1))
            c1 = http_submit(base, None, spec)
            rep = http_wait(base, c1, None)
            expect(rep["state"] == "COMPLETED" and rep["trajectories"] > 0,
                   f"serve --gateway campaign {c1}: {rep['state']}")
            c2 = http_submit(base, None, dict(spec, seed=1))
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reader.join(timeout=30)
        out = []
        while not lines.empty():
            out.append(lines.get().rstrip("\n"))
        with open(err_path) as f:
            err = f.read()
        expect(rc == 0, f"serve --gateway exited {rc}: {err[-2000:]}")
        expect(f"[serve] checkpointed 1 live campaign(s) to {d}: ['{c2}']"
               in out and out[-1] == "[serve] gateway stopped",
               f"serve --gateway printed {out}")
        state, tenant = GatewayService._read_envelope(
            os.path.join(d, f"campaign-{c2}.json"))
        sess = ImpressSession.from_checkpoint(state, payload=pp,
                                              devices=[pp.device])
        try:
            names = sorted(p.name
                           for p in sess.coordinator.pipelines.values())
            rep = sess.run(timeout=120)
        finally:
            sess.shutdown()
    expect(names == sorted(p["name"]
                           for p in state["coordinator"]["pipelines"])
           and rep.trajectories > 0,
           f"the checkpoint of {c2} rebuilt {names}, ran "
           f"{rep.trajectories} trajectories")
    print(f"  (d) serve --gateway: listening after {t_up:.1f} s; {c1} "
          f"completed over HTTP; SIGINT during {c2}: exit 0, "
          f"\"{out[-2]}\", \"{out[-1]}\"; the checkpoint (tenant "
          f"{tenant}) loads in ImpressSession.from_checkpoint and runs "
          f"{rep.trajectories} trajectories", flush=True)


def phase_gateway(torch, pp):
    """Phase 5e: the gateway at full width (progen-s, foldscore-s, the
    "binder" progen-s and the "multimer" foldscore-m) on one card: (a)
    alice's then bob's binder campaign, (b) both at once, (c) carol's
    im-rp with paged decode under a fault plan beside alice, (d) the
    ``serve --gateway`` entry point in a subprocess; then the flash and
    paged kernels held to their plain versions at every distinct call of
    (a)-(c). Returns the launch counts of (a)-(c), by kernel and flash
    form."""
    t_phase = time.perf_counter()
    print(f"phase 5e: the gateway, GatewayService(devices=None, "
          f"reduced=False, max_workers=4, quotas alice/bob 1.0) over HTTP "
          f"on 127.0.0.1; each tenant's spec {gateway_spec(0)}", flush=True)
    calls, paged = collections.Counter(), []
    total = collections.Counter()
    total_forms = collections.Counter()
    modes = {}
    for fused in (False, True):
        counts, forms, modes[fused] = gateway_mode(torch, fused, calls)
        total.update(counts)
        total_forms.update(forms)
    print(f"  fused over sequential: candidates/s x "
          f"{(modes[True]['trajectories'] / modes[True]['makespan']) / (modes[False]['trajectories'] / modes[False]['makespan']):.3f}, "
          f"makespan {modes[False]['makespan']:.3f} -> "
          f"{modes[True]['makespan']:.3f} s", flush=True)
    counts, forms = faulted_gateway(torch, calls, paged)
    total.update(counts)
    total_forms.update(forms)
    serve_gateway_cli(torch, pp)
    hold_flash_calls(torch, calls, "phase 5e")
    hold_paged_calls(torch, paged, "phase 5e")
    print(f"  phase 5e took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total, total_forms


# -- phase 5f: the train launcher ----------------------------------------------


@contextlib.contextmanager
def train_step_tallies(out, first=None):
    """Append to the list ``out`` a (launches, wall ms) pair for each train
    step ``launch.train`` runs in the block: the launches of its own thread
    (``ops.tally``) and its synchronized wall time, by a pass-through in
    ``make_train_step``'s place in ``launch.train``, where ``build`` looks
    it up. ``first(params)`` runs before the block's first step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tr

    inner = tr.make_train_step

    def tallied(cfg, opt, **kw):
        step = inner(cfg, opt, **kw)

        def run(params, opt_state, batch):
            import torch
            if first is not None and not out:
                first(params)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ops.tally() as counts:
                res = step(params, opt_state, batch)
            torch.cuda.synchronize()
            out.append((dict(counts), 1e3 * (time.perf_counter() - t)))
            return res
        return run
    tr.make_train_step = tallied
    try:
        yield out
    finally:
        tr.make_train_step = inner


def time_train_flash(torch):
    """The flash kernel at the train launcher's shape (8 rows x 8/4 heads
    of 32 over 64 patch + 128 token positions, causal, bf16): device ms
    of the kernel, the plain version and sdpa, and the bound; then the
    gradient kernel there (``flash_bwd_record``). Returns the two kernel
    records."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    B, H, KV, S = TRAIN_BATCH, 8, 4, 64 + TRAIN_SEQ
    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn(B, h, S, 32, generator=g, device="cuda",
                           dtype=torch.bfloat16) for h in (H, KV, KV))
    run_k = lambda: fa.flash_attention_bhsd(q, k, v)          # noqa: E731
    run_p = lambda: fa.attention_ref(q, k, v)                 # noqa: E731
    run_l = lambda: F.scaled_dot_product_attention(           # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    err = max_err(run_k(), run_p())
    err_t = max_err(run_k(), fa.attention_tiled_ref(q, k, v))
    check(f"flash at the train shape {B} x {H}/{KV} x {S} bf16", err,
          TOL["bfloat16"])
    check(f"flash at the train shape {B} x {H}/{KV} x {S} bf16 vs "
          f"attention_tiled_ref", err_t, TOL["bfloat16"])
    b_ms, b_by = flash_bound(q, k, v)
    ms, plain, lib = (graph_ms(torch, run_k), graph_ms(torch, run_p),
                      graph_ms(torch, run_l))
    print(f"  flash at the train shape {B} x {H}/{KV} x {S} bf16, device ms "
          f"per call: kernel {ms:.4f}, plain {plain:.4f}, sdpa {lib:.4f}, "
          f"bound {b_ms:.6f} ({b_by}); err {err:.3e}", flush=True)
    bwd = flash_bwd_record(
        torch, "flash_attention_bhsd_bwd_train",
        f"at the train shape {B} x {H}/{KV} x {S}, hd 32, causal, bf16",
        q, k, v, {}, {"is_causal": True})
    return [{"name": "flash_attention_bhsd_train", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:82",
             "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}, bwd]


def phase_train(torch):
    """Phase 5f: ``launch/train.py`` at full progen-s width on the card:
    ``train`` for 6 steps with a checkpoint every 3, then ``restore=True``
    to 9 (3 more steps from step 6), against an uninterrupted 9-step run
    (losses within ``TRAIN_LOSS_RTOL``); each step's launches (``ops.tally``)
    held to one bf16 flash launch and one gradient kernel launch a layer,
    and the counters, zeroed before and read after, to that over every
    step; flash and its gradient kernel held at every distinct call; ms a
    step, tokens/s, one profiled step. Returns the kernel records of the
    train shape, the forward's (its launches the forwards of the steps
    run) and the gradient kernel's (its launches the steps')."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tr
    from repro_torch.optim import OptConfig

    t_phase = time.perf_counter()
    cfg = get_config("progen-s")
    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=9)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=100,
              device="cuda")
    print(f"phase 5f: launch/train.py, {cfg.name} at full width ("
          f"{cfg.n_layers} layers, d {cfg.d_model}), {TRAIN_BATCH} rows x "
          f"({cfg.frontend_seq} patches + {TRAIN_SEQ} tokens), AdamW lr "
          f"{opt.lr}: 6 steps with a checkpoint every 3, restore to 9, "
          f"against 9 uninterrupted", flush=True)
    records = time_train_flash(torch)
    steps, calls = [], collections.Counter()
    torch.cuda.synchronize()
    ops.reset_launches()
    with train_step_tallies(steps), flash_calls(calls), \
            tempfile.TemporaryDirectory() as d:
        _, _, first = tr.train(cfg, opt, steps=6, ckpt_dir=d, ckpt_every=3,
                               **kw)
        _, state, more = tr.train(cfg, opt, steps=9, ckpt_dir=d,
                                  restore=True, **kw)
        _, _, whole = tr.train(cfg, opt, steps=9, **kw)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    forms = dict(ops.forms["flash_attention_bhsd"])
    n = cfg.n_layers
    resumed = first + more
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole))
    print(f"  losses: 6 steps {[round(x, 4) for x in first]}, resumed "
          f"{[round(x, 4) for x in more]} (optimizer count "
          f"{state['count']}), uninterrupted {[round(x, 4) for x in whole]}; "
          f"max relative difference {rel:.3e} (tol {TRAIN_LOSS_RTOL:.0e})",
          flush=True)
    expect(len(first) == 6 and len(more) == 3 and state["count"] == 9
           and len(whole) == 9, "the restore did not resume at step 6")
    expect(rel <= TRAIN_LOSS_RTOL, f"resumed losses differ by {rel}")
    expect(whole[-1] < whole[0], "the train launcher did not lower the loss")
    per_step = {"flash_attention_bhsd": 2 * n,
                ("flash_attention_bhsd", "seq_bf16"): n,
                ("flash_attention_bhsd", "backward"): n}
    expect(len(steps) == 18 and all(c == per_step for c, _ in steps),
           f"train steps' own launches {[c for c, _ in steps]}, not {n} "
           f"bf16 flash launches and {n} gradient kernel launches a step")
    expect(counts == dict(dict.fromkeys(counts, 0),
                          flash_attention_bhsd=36 * n)
           and forms == flash_forms(seq_bf16=18 * n, backward=18 * n),
           f"train launcher: launches {counts} {forms}, not {18 * n} bf16 "
           f"and {18 * n} backward")
    walls = [w for _, w in steps[9:]]           # the uninterrupted run
    ms = statistics.median(walls[1:])
    print(f"  train step: wall median {ms:.2f} ms ({min(walls[1:]):.2f}-"
          f"{max(walls[1:]):.2f}), {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} "
          f"tokens/s; each of the 18 steps {n} bf16 flash launches and {n} "
          f"of the gradient kernel (ops.tally), the counters "
          f"{counts['flash_attention_bhsd']}",
          flush=True)
    hold_flash_calls(torch, calls, "phase 5f")
    params, opt_state, step_fn = tr.build(cfg, opt, device="cuda")
    batch = {k: v.to("cuda") for k, v in lm_batch(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, step=0).items()}
    for _ in range(2):
        params, opt_state, _ = step_fn(params, opt_state, batch)
    profile_step(torch, lambda: step_fn(params, opt_state, batch),
                 "launch/train.py train step", top=10)
    records[0]["launches"] = forms["seq_bf16"]
    records[1]["launches"] = forms["backward"]
    print(f"  phase 5f took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return records


def profile_step(torch, fn, label, top=12, cpu=True):
    """Run ``fn`` once under torch.profiler: device time by kernel and the
    device's busy share of the wall time. ``cpu=False`` traces the device
    alone (a step of tens of thousands of launches then takes seconds, not
    tens of seconds, to summarize). Returns the device kernels' profiler
    events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = kernel_events(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3      # ms
    print(f"  {label} wall {wall * 1e3:.1f} ms (profiled), device busy "
          f"{busy:.2f} ms = {100 * busy / (wall * 1e3):.1f}% of wall, "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):     # the top ones, and the port's own
        if i < top or any(n in e.key for n in PORT_KERNELS):
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms "
                  f"{e.count:6d}x  {e.key[:100]}", flush=True)
    return kernels


def phase_serving(torch):
    """rwkv6-7b LM serving at full width through ``serve_batch``; returns
    the launch counts of the counted window."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm

    import numpy as np

    cfg = get_config("rwkv6-7b")
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    print(f"phase 6: LM serving, {cfg.name} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
          f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype} weights, {cfg.compute_dtype} compute): "
          f"{B} x {P} prompt tokens, {G} generated", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.2f} s:"
          f" {sum(p.numel() for p in params.parameters())} parameters, "
          f"{n_bytes / 1e9:.2f} GB", flush=True)
    # one short request first: library handles and first-call allocations
    serve_batch(cfg, batch=B, prompt_len=16, gen=2, params=params)
    torch.cuda.synchronize()
    ops.reset_launches()
    r = serve_batch(cfg, batch=B, prompt_len=P, gen=G, params=params)
    counts = dict(ops.launches)
    toks = r["tokens"]
    print(f"  prefill {r['prefill_s'] * 1e3:.1f} ms ({r['prefill_tok_s']:.0f}"
          f" tokens/s); decode {r['decode_s'] / (G - 1) * 1e3:.1f} ms per "
          f"step ({r['decode_tok_s']:.1f} tokens/s over {G - 1} steps); peak"
          f" memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    print(f"  launches {counts}; row 0 tokens {toks[0, :8].tolist()}",
          flush=True)
    expect(toks.shape == (B, G), f"tokens {tuple(toks.shape)}")
    expect(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
           "a token outside the vocabulary")
    expect(r["logits_finite"], "a logit is not finite")
    want = {"paged_decode_bkgh": 0, "flash_attention_bhsd": 0,
            "wkv6_bhtk": cfg.n_layers * G, "rglru_btc": 0}
    expect(counts == want, f"launches {counts}, expected {want}")
    forms = dict(ops.forms["wkv6_bhtk"])
    print(f"  wkv6 launches by form {forms}", flush=True)
    want = {"prefill": cfg.n_layers, "decode": cfg.n_layers * (G - 1),
            "backward": 0}
    expect(forms == want, f"wkv6 forms {forms}, expected {want}")
    counts.update(wkv6_bhtk_prefill=forms["prefill"],
                  wkv6_bhtk_decode=forms["decode"])

    # T=1 decode vs one prefill over the same 72 tokens, at full width and
    # depth in fp32: 64 prompt tokens, then 8 greedy decode steps.
    c32 = cfg.replace(compute_dtype="float32")
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(2, 64))).cuda()
    with torch.inference_mode():
        toks32, last = greedy(torch, params, prompts, c32, 9)
        seq = torch.cat([prompts, toks32[:, :-1]], dim=1)
        full, _, _ = lm.prefill(params, {"inputs": seq}, c32)
        per_layer = layer_consistency(torch, params, seq, 64, c32)
    expect(bool(torch.isfinite(last).all()), "fp32 logits not finite")
    # Each layer, fed the prefill's input, gives the same outputs through
    # its state at T=1 as in the prefill, to 1e-4 of the layer's largest
    # output (the residual stream grows from ~3 to ~20 over the 32 layers):
    # room for fp32 products over d 4096 and d_ff 14336 summed in another
    # order (cuBLAS picks other kernels for 2 rows than for 144), carried
    # through 8 steps of state.
    check("full-width fp32, every layer: 8 decode steps vs one prefill over "
          "72 tokens, relative to the layer's output scale", per_layer, 1e-4)
    # End to end, the two paths are two fp32 chains through 32 random
    # layers: their rounding differences grow from layer to layer (a head
    # whose output has a small spread is divided by it in the group norm),
    # so the logits are held only to a quarter of their own scale, which a
    # lost or stale state would exceed.
    scale = float(full.abs().max())
    check(f"full-width fp32, end to end: last decode step vs prefill over "
          f"72 tokens (logits up to {scale:.2f})", max_err(last, full),
          0.25 * scale)

    with torch.inference_mode():
        _, caches, t = lm.prefill(params, {"inputs": prompts.new_ones(
            (B, 16))}, cfg)
        tok = prompts.new_ones((B, 1))
        lm.decode_step(params, caches, tok, t, cfg)        # warm
        profile_step(torch, lambda: lm.decode_step(params, caches, tok, t,
                                                   cfg),
                     f"one decode step ({B} rows)")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_rg_serving(torch):
    """recurrentgemma-2b LM serving at full width through ``serve_batch``;
    returns the launch counts of the counted window."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm

    cfg = get_config("recurrentgemma-2b")
    B, P, G = RG_BATCH, RG_PROMPT, RG_GEN
    kinds = cfg.layer_kinds
    print(f"phase 7: LM serving, {cfg.name} ({cfg.n_layers} layers: "
          f"{kinds.count('rglru')} rglru + {kinds.count('attn_local')} "
          f"attn_local, window {cfg.attn_window}; d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, lru {cfg.lru_width}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype} weights, {cfg.compute_dtype} compute with the "
          f"reference's fp32 residual stream): {B} x {P} prompt tokens, {G} "
          f"generated", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.2f} s:"
          f" {sum(p.numel() for p in params.parameters())} parameters, "
          f"{n_bytes / 1e9:.2f} GB", flush=True)
    serve_batch(cfg, batch=B, prompt_len=16, gen=2, params=params)   # warm
    torch.cuda.synchronize()
    ops.reset_launches()
    r = serve_batch(cfg, batch=B, prompt_len=P, gen=G, params=params)
    counts = dict(ops.launches)
    forms = dict(ops.forms["flash_attention_bhsd"])
    toks = r["tokens"]
    print(f"  prefill {r['prefill_s'] * 1e3:.1f} ms ({r['prefill_tok_s']:.0f}"
          f" tokens/s); decode {r['decode_s'] / (G - 1) * 1e3:.1f} ms per "
          f"step ({r['decode_tok_s']:.1f} tokens/s over {G - 1} steps); peak"
          f" memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    rg_forms = dict(ops.forms["rglru_btc"])
    print(f"  launches {counts}, flash by form {forms}, rglru by form "
          f"{rg_forms}; row 0 tokens {toks[0, :8].tolist()}", flush=True)
    expect(toks.shape == (B, G), f"tokens {tuple(toks.shape)}")
    expect(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
           "a token outside the vocabulary")
    expect(r["logits_finite"], "a logit is not finite")
    want = {"paged_decode_bkgh": 0,
            "flash_attention_bhsd": kinds.count("attn_local") * G,
            "wkv6_bhtk": 0, "rglru_btc": kinds.count("rglru") * G}
    expect(counts == want, f"launches {counts}, expected {want}")
    want = flash_forms(decode=kinds.count("attn_local") * (G - 1),
                       seq_f32=kinds.count("attn_local"))
    expect(forms == want, f"flash forms {forms}, expected {want}")
    # the prefill's scans in the staged form, the decode steps' serial
    want = {"staged": kinds.count("rglru"),
            "serial": kinds.count("rglru") * (G - 1), "backward": 0}
    expect(rg_forms == want, f"rglru forms {rg_forms}, expected {want}")
    counts.update(flash_attention_bhsd_hd256=forms["seq_f32"],
                  flash_attention_bhsd_hd256_decode=forms["decode"])

    # T=1 decode vs one prefill over the same tokens, at full width and
    # depth in fp32: 2100 prompt tokens (past the window, not a multiple of
    # it), then 8 greedy decode steps.
    n_prompt, n_dec = 2100, 8
    c32 = cfg.replace(compute_dtype="float32")
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(2, n_prompt))).cuda()
    with torch.inference_mode():
        toks32, last = greedy(torch, params, prompts, c32, n_dec + 1)
        seq = torch.cat([prompts, toks32[:, :-1]], dim=1)
        full, _, _ = lm.prefill(params, {"inputs": seq}, c32)
        per_layer = layer_consistency(torch, params, seq, n_prompt, c32)
    expect(bool(torch.isfinite(last).all()), "fp32 logits not finite")
    # Each layer, fed the prefill's input, gives the same outputs through
    # its recurrent state or ring cache at T=1 as in the prefill, to 1e-4
    # of the layer's largest output: room for fp32 products summed in
    # another order (other GEMM kernels for 2 rows than for 4,216; the
    # ring's keys in slot order, not position order).
    check(f"full-width fp32, every layer: {n_dec} decode steps vs one "
          f"prefill over {n_prompt + n_dec} tokens, relative to the layer's "
          f"output scale", per_layer, 1e-4)
    # End to end, two fp32 chains through 26 random layers: held to a
    # quarter of the logits' scale, which a lost state or a stale or
    # misplaced ring entry would exceed.
    scale = float(full.abs().max())
    check(f"full-width fp32, end to end: last decode step vs prefill over "
          f"{n_prompt + n_dec} tokens (logits up to {scale:.2f})",
          max_err(last, full), 0.25 * scale)
    del full, last

    # one decode step over a full ring (position P, the 2048 slots filled)
    with torch.inference_mode():
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            1, cfg.vocab_size, size=(B, P))).cuda()
        _, caches, t = lm.prefill(params, {"inputs": prompt}, cfg,
                                  cache_len=P + 2)
        tok = prompt[:, -1:]
        lm.decode_step(params, caches, tok, t, cfg)        # warm
        profile_step(torch, lambda: lm.decode_step(params, caches, tok, t,
                                                   cfg),
                     f"one decode step ({B} rows, ring of {cfg.attn_window} "
                     f"filled)")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# -- phase 8: the dense decoders and whisper's encoder-decoder ----------------


def phase_arch_agreement(torch):
    """(a) Each new arch reduced in fp32, card vs CPU (``phase_lm_agreement``
    with the frontend stub), then its prefill + decode held layer by layer
    to one prefill on the card (``layer_consistency``); reduced smollm's
    head dim of 20 is no compiled head dim, so a card call there raises
    and the arch runs at head dim 16."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.models import lm

    for arch in ARCH_SERVES:
        cfg, note = get_reduced(arch), ""
        if cfg.head_dim not in HEAD_DIMS:
            bad = lm.init_lm(cfg.replace(compute_dtype="float32"), seed=0,
                             device="cuda")
            try:
                with torch.inference_mode():
                    lm.prefill(bad, {"inputs": torch.ones(
                        (2, 4), dtype=torch.long, device="cuda")}, cfg)
            except ValueError as e:
                expect("head dim" in str(e), f"{arch}: {e}")
                print(f"  {arch} reduced at head dim {cfg.head_dim}: the "
                      f"card raises ValueError ({str(e)[-60:]})", flush=True)
            else:
                raise AssertionError(f"{arch}: head dim {cfg.head_dim} ran "
                                     "on the card")
            del bad
            cfg = cfg.replace(head_dim=16)
            note = (f"; head_dim 16, not the reduced config's "
                    f"{get_reduced(arch).head_dim}, which no kernel compiles")
        card, c32, prompts, toks, stub = phase_lm_agreement(
            torch, "phase 8a", arch, 10, cfg=cfg, note=note)
        seq = torch.cat([prompts, toks[:, :-1]], dim=1)
        with torch.inference_mode():
            err = layer_consistency(torch, card, seq, 10, c32, stub)
        check(f"{arch}: every layer, {seq.shape[1] - 10} decode steps vs "
              f"one prefill, relative to the layer's output scale", err, 1e-4)


def whole_on_meta(torch, label, ranges):
    """Each arch of ``ranges`` (arch -> (total range, active range or
    None), the reference's, ``tests/test_models.py``) whole on the meta
    device: parameters outside the norms equal ``param_count``, the total
    (and the active count) in the range."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    for arch, ((lo, hi), active_range) in ranges.items():
        cfg = get_config(arch)
        with torch.device("meta"):
            model = lm.LM(cfg)
        n = sum(p.numel() for p in model.parameters())
        norms = sum(p.numel() for name, p in model.named_parameters()
                    if "norm" in name)
        by_dtype = collections.Counter()
        for p in model.parameters():
            by_dtype[dtype_name(p.dtype)] += p.numel() * p.element_size()
        active = cfg.active_param_count()
        print(f"{label}: {arch} whole on the meta device: {cfg.n_layers} "
              f"layers, {n} parameters ({norms} in norms), param_count "
              f"{cfg.param_count()}, active {active}; weights by dtype (GB) "
              f"{ {k: round(v / 1e9, 2) for k, v in by_dtype.items()} }",
              flush=True)
        expect(n - norms == cfg.param_count(),
               f"{arch}: {n - norms} parameters outside the norms, "
               f"param_count {cfg.param_count()}")
        expect(lo <= n <= hi, f"{arch}: {n} parameters outside [{lo}, {hi}]")
        if active_range:
            alo, ahi = active_range
            expect(alo <= active <= ahi, f"{arch}: {active} active "
                   f"parameters outside [{alo}, {ahi}]")


def weight_bytes(torch, cfg):
    """(bytes of ``cfg``'s weights, each parameter at its own dtype, built
    on the meta device; the largest fp32 temporary their draw makes:
    ``dense_init`` draws an fp32 weight in place and one of another dtype
    in fp32 slices of at most ``DRAW_SLICE`` elements)."""
    from repro_torch.models import lm
    from repro_torch.models.common import DRAW_SLICE
    with torch.device("meta"):
        params = list(lm.LM(cfg).parameters())
    total = sum(p.numel() * p.element_size() for p in params)
    temp = max([4 * min(p.numel(), max(1, DRAW_SLICE // p[0].numel())
                        * p[0].numel())
                for p in params if p.dtype != torch.float32 and p.dim() > 1]
               or [0])
    return total, temp


def serve_cfg(torch, arch):
    """The full config of ``arch``, cut to the deepest number of its
    segment's repeats whose weights (``weight_bytes``: each parameter at
    its dtype) and the draw's fp32 temporary fit in the card's free memory
    with ``SERVE_HEADROOM`` to spare, where the whole model does not;
    returns (cfg, a note of the depth and the reckoning)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    whole, temp = weight_bytes(torch, cfg)
    dtypes = (f"{cfg.param_dtype} weights"
              + (" (routers fp32)" if cfg.moe_experts else ""))
    if whole + temp + SERVE_HEADROOM <= free:
        return cfg, (f"all {cfg.n_layers} layers: {whole / 1e9:.1f} GB of "
                     f"{dtypes}, {free / 1e9:.1f} GB free")
    expect(not cfg.encoder_segments and len(cfg.segments) == 1,
           f"{arch}: only one segment's repeats are cut")
    (kinds, reps), = cfg.segments

    def cut(n):
        return cfg.replace(n_layers=len(kinds) * n, segments=((kinds, n),))
    one = weight_bytes(torch, cut(1))[0]
    per_rep = weight_bytes(torch, cut(2))[0] - one
    fixed = one - per_rep
    n = int((free - SERVE_HEADROOM - temp - fixed) // per_rep)
    expect(n >= 1, f"{arch}: not one repeat of {kinds} fits in "
           f"{free / 1e9:.1f} GB")
    return cut(n), (
        f"depth cut to {n} of {reps} repeats of {list(kinds)} "
        f"({len(kinds) * n} of {cfg.n_layers} layers), the deepest that "
        f"fits: the whole model's {dtypes} are {whole / 1e9:.1f} GB, "
        f"{per_rep / 1e9:.2f} GB a repeat beside {fixed / 1e9:.2f} GB of "
        f"embedding and head, the draw's fp32 slice {temp / 1e9:.2f} GB, "
        f"{free / 1e9:.1f} GB free with {SERVE_HEADROOM / 1e9:.0f} GB kept "
        f"for the rest")


def implied_flash(cfg, gen):
    """Flash launches by form that one serve implies: one sequence launch a
    self-attention layer at prefill (and an encoder layer and a
    cross-attention layer), one decode launch a self- and a cross-attention
    layer a step."""
    n_self = len(cfg.layer_kinds)
    n_cross = cfg.layer_kinds.count("dec_attn")
    n_enc = len(cfg.encoder_kinds)
    seq = n_self + n_cross + n_enc
    dec = (n_self + n_cross) * (gen - 1)
    form = "seq_bf16" if cfg.compute_dtype == "bfloat16" else "seq_f32"
    return flash_forms(decode=dec, **{form: seq})


def serve_arch(torch, arch, calls, phase="phase 8c"):
    """(c)-(d) ``serve_batch`` at full width (``ARCH_SERVES`` or
    ``MOE_SERVES``): seeded weights drawn on the card, one warm request of
    2 tokens at the served prompt length, then the counted serve (launch
    counters zeroed just before, read just after; every flash call
    recorded in ``calls``). Returns (params, cfg, flash launches by
    form)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm

    cfg, cut = serve_cfg(torch, arch)
    B, P, G = {**ARCH_SERVES, **MOE_SERVES}[arch]
    kinds = sorted(set(cfg.layer_kinds + cfg.encoder_kinds))
    front = (f", {cfg.frontend_seq} {cfg.frontend} (stub)"
             if cfg.frontend else "")
    shared = " + a shared one" if cfg.moe_shared_expert else ""
    experts = (f", {cfg.moe_experts} experts of d_ff {cfg.moe_d_ff} top-"
               f"{cfg.moe_top_k}{shared} ({cfg.moe_impl} form, capacity "
               f"factor {cfg.moe_capacity_factor})" if cfg.moe_experts
               else "")
    print(f"{phase}: serve_batch {cfg.name} ({cut}; {kinds}; d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}{', qk-norm' if cfg.qk_norm else ''}, d_ff "
          f"{cfg.d_ff} {cfg.mlp_type}{experts}, {cfg.norm_type}, "
          f"rope {cfg.rope_style} x {cfg.rope_fraction}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype} weights, {cfg.compute_dtype} "
          f"compute): {B} x {P} prompt tokens{front}, {G} generated",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.2f} s: "
          f"{n} parameters, {nbytes / 1e9:.2f} GB (param_count "
          f"{cfg.param_count()}); peak memory of the draw "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    # one warm request at the served prompt length: library handles,
    # GEMM plans and the allocator's blocks for these shapes
    serve_batch(cfg, batch=B, prompt_len=P, gen=2, params=params)
    torch.cuda.synchronize()
    ops.reset_launches()
    with flash_calls(calls):
        r = serve_batch(cfg, batch=B, prompt_len=P, gen=G, params=params)
    counts = dict(ops.launches)
    forms = dict(ops.forms["flash_attention_bhsd"])
    toks = r["tokens"]
    cache = r["cache_len"]
    G_heads = cfg.n_heads // cfg.n_kv_heads
    splits = fa.decode_key_splits(
        B * cfg.n_kv_heads * -(-G_heads // fa.DECODE_GROUP), cache,
        torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"  prefill {r['prefill_s'] * 1e3:.1f} ms ({r['prefill_tok_s']:.0f}"
          f" prompt tokens/s); decode {r['decode_s'] / (G - 1) * 1e3:.2f} ms "
          f"per step ({r['decode_tok_s']:.1f} tokens/s over {G - 1} steps); "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"every logit finite: {r['logits_finite']}", flush=True)
    print(f"  launches {counts}, flash by form {forms} (the self cache's "
          f"{cache} slots in {splits} key range(s) a decode call"
          f"{', each with its combine launch inside the counted call' if splits > 1 else ''}"
          f"); row 0 tokens {toks[0, :8].tolist()}", flush=True)
    expect(toks.shape == (B, G), f"tokens {tuple(toks.shape)}")
    expect(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
           "a token outside the vocabulary")
    expect(r["logits_finite"], f"{arch}: a logit is not finite")
    want = implied_flash(cfg, G)
    expect(forms == want, f"{arch}: flash forms {forms}, expected {want}")
    want = {"paged_decode_bkgh": 0, "wkv6_bhtk": 0, "rglru_btc": 0,
            "flash_attention_bhsd": sum(want.values())}
    expect(counts == want, f"{arch}: launches {counts}, expected {want}")
    return params, cfg, forms


def flash_record(torch, name, label, q, k, v, kw, sdpa_kw, source):
    """One ``{"kernels": ...}`` record of the flash kernel at a phase 2c, 8,
    9, 11 or 12 shape: the kernel against the plain version (and the bf16
    sequence form also against ``attention_tiled_ref``), then the device
    ms by CUDA-graph replay of the kernel, the plain version and
    ``scaled_dot_product_attention`` (given contiguous K/V in q's dtype,
    ``enable_gqa`` where KV < H), and the bound (``flash_bound``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    # sdpa takes one dtype: K/V widened to an fp32 query's
    kc, vc = (t.contiguous().to(q.dtype) for t in (k, v))
    run_k = lambda: fa.flash_attention_bhsd(q, k, v, **kw)        # noqa: E731
    run_p = lambda: fa.attention_ref(q, k, v, **kw)               # noqa: E731
    run_l = lambda: F.scaled_dot_product_attention(               # noqa: E731
        q, kc, vc, enable_gqa=k.shape[1] < q.shape[1], **sdpa_kw)
    got = run_k()
    err = max_err(got, run_p())
    check(f"flash {label}", err, TOL[dtype_name(q.dtype)])
    if q.shape[2] > 1 and q.dtype == torch.bfloat16:
        check(f"flash {label} vs attention_tiled_ref",
              max_err(got, fa.attention_tiled_ref(q, k, v, **kw)),
              TOL[dtype_name(q.dtype)])
    err_l = max_err(run_l(), run_p())
    b_ms, b_by = flash_bound(q, k, v, **kw)
    ms, lib = graph_ms(torch, run_k), graph_ms(torch, run_l)
    plain = graph_ms(torch, run_p, iters=4, replays=5)
    print(f"  flash {label}, device ms per call: kernel {ms:.4f}, plain "
          f"{plain:.4f}, sdpa {lib:.4f}, bound {b_ms:.6f} ({b_by}, "
          f"{100 * b_ms / ms:.1f}% of it); err {err:.3e} (sdpa's "
          f"{err_l:.3e})", flush=True)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": "src/repro/kernels/flash_attention.py:82",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def phase8_records(torch):
    """(f) The flash kernel at phase 8's new shapes: llama3-8b's prefill and
    its decode over the 544-slot cache, whisper-small's encoder, its cross
    prefill and its cross decode over 1500 frames. Returns the records."""
    from repro_torch.configs.registry import get_config

    g = torch.Generator(device="cuda").manual_seed(23)
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=bf16)

    seq_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    dec_src = "src/repro_torch/kernels/csrc/flash_decode.cu"
    out = []
    llama = get_config("llama3-8b")
    B, P, G = ARCH_SERVES["llama3-8b"]
    H, KV, hd = llama.n_heads, llama.n_kv_heads, llama.head_dim
    q, k, v = rnd(B, H, P, hd), rnd(B, KV, P, hd), rnd(B, KV, P, hd)
    out.append(flash_record(
        torch, "flash_attention_bhsd_llama3_prefill",
        f"llama3-8b prefill {B} x {H}/{KV} x {P}, hd {hd}, causal, bf16",
        q, k, v, {}, {"is_causal": True}, seq_src))
    L = P + G
    q = rnd(B, H, 1, hd)
    k, v = (rnd(B, L, KV, hd).transpose(1, 2) for _ in range(2))
    out.append(flash_record(
        torch, "flash_attention_bhsd_llama3_decode",
        f"llama3-8b decode {B} x {H}/{KV} x 1 over the {L}-slot cache in "
        f"place, hd {hd}, bf16", q, k, v, {"causal": False}, {}, dec_src))
    whisper = get_config("whisper-small")
    B, P, G = ARCH_SERVES["whisper-small"]
    H, KV, hd, F_ = (whisper.n_heads, whisper.n_kv_heads, whisper.head_dim,
                     whisper.frontend_seq)
    q, k, v = rnd(B, H, F_, hd), rnd(B, KV, F_, hd), rnd(B, KV, F_, hd)
    out.append(flash_record(
        torch, "flash_attention_bhsd_whisper_encoder",
        f"whisper-small encoder {B} x {H} x {F_}, hd {hd}, non-causal, bf16",
        q, k, v, {"causal": False}, {}, seq_src))
    q = rnd(B, H, P, hd)
    out.append(flash_record(
        torch, "flash_attention_bhsd_whisper_cross",
        f"whisper-small cross prefill {B} x {H} x {P} over {F_} frames, hd "
        f"{hd}, bf16", q, k, v, {"causal": False}, {}, seq_src))
    q = rnd(B, H, 1, hd)
    k, v = (rnd(B, F_, KV, hd).transpose(1, 2) for _ in range(2))
    out.append(flash_record(
        torch, "flash_attention_bhsd_whisper_cross_decode",
        f"whisper-small cross decode {B} x {H} x 1 over the {F_}-frame cross "
        f"cache in place, hd {hd}, bf16", q, k, v, {"causal": False}, {},
        dec_src))
    return out


def phase_archs(torch):
    """Phase 8: the dense decoders and whisper-small. Returns (records,
    their launches by record name)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    phase_arch_agreement(torch)
    # (b) the two the card cannot hold whole
    whole_on_meta(torch, "phase 8b", {"nemotron-4-15b": ((14e9, 17e9), None),
                                      "llava-next-34b": ((32e9, 37e9), None)})
    calls, by_arch = collections.Counter(), {}
    for arch in ARCH_SERVES:
        own = collections.Counter()
        params, cfg, forms = serve_arch(torch, arch, own)
        calls.update(own)
        by_arch[arch] = forms, own
        if arch == "llama3-8b":      # (g) one decode step, profiled
            B, P, _ = ARCH_SERVES[arch]
            with torch.inference_mode():
                prompt = torch.ones((B, P), dtype=torch.long, device="cuda")
                _, caches, t = lm.prefill(params, {"inputs": prompt}, cfg,
                                          cache_len=P + 2)
                tok = prompt[:, -1:]
                lm.decode_step(params, caches, tok, t, cfg)        # warm
                profile_step(torch, lambda: lm.decode_step(
                    params, caches, tok, t, cfg),
                    f"phase 8g: one llama3-8b decode step ({B} rows over "
                    f"{P + 1} cached tokens)")
            del caches
        del params
        gc.collect()
        torch.cuda.empty_cache()
    # (e) every distinct flash call of the six serves, on fresh inputs
    print(f"phase 8e: {sum(calls.values())} flash calls, {len(calls)} "
          f"distinct", flush=True)
    hold_flash_calls(torch, calls, "phase 8")
    records = phase8_records(torch)
    # each record's launches: the serve's calls at its shape
    (llama, _), (_, wcalls) = by_arch["llama3-8b"], by_arch["whisper-small"]
    wcfg = get_config("whisper-small")
    F_, G = wcfg.frontend_seq, ARCH_SERVES["whisper-small"][2]
    enc = sum(c for (qs, ks, *_), c in wcalls.items() if qs[2] == F_)
    cross = sum(c for (qs, ks, *_), c in wcalls.items()
                if 1 < qs[2] < F_ == ks[2])
    cross_dec = sum(c for (qs, ks, *_), c in wcalls.items()
                    if qs[2] == 1 and ks[2] == F_)
    n_cross = wcfg.layer_kinds.count("dec_attn")
    want = (len(wcfg.encoder_kinds), n_cross, n_cross * (G - 1))
    expect((enc, cross, cross_dec) == want,
           f"whisper's flash calls: encoder {enc}, cross {cross}, cross "
           f"decode {cross_dec}; expected {want}")
    launches = {"flash_attention_bhsd_llama3_prefill": llama["seq_bf16"],
                "flash_attention_bhsd_llama3_decode": llama["decode"],
                "flash_attention_bhsd_whisper_encoder": enc,
                "flash_attention_bhsd_whisper_cross": cross,
                "flash_attention_bhsd_whisper_cross_decode": cross_dec}
    print(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records, launches


# phase 9b: the reference's ranges (tests/test_models.py), total and active
MOE_RANGES = {"qwen3-moe-30b-a3b": ((28e9, 33e9), (2e9, 4.5e9)),
              "llama4-maverick-400b-a17b": ((360e9, 430e9), (12e9, 20e9))}
# phase 9g: device time by kind, the first kind whose names a kernel's name
# holds (case ignored)
KERNEL_KINDS = (("flash", ("flash_fwd_", "decode_attention_")),
                ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
                ("routing: sort, scatter, gather, index",
                 ("sort", "scatter", "gather", "index")),
                ("casts and copies", ("copy", "cast")))


def phase_moe_agreement(torch):
    """(a) Both MoE archs reduced in fp32, card vs CPU in the capacity form
    (``phase_lm_agreement``), then each layer's prefill + decode held to
    one prefill on the card in the dense form."""
    for arch in MOE_SERVES:
        card, c32, prompts, toks, _ = phase_lm_agreement(
            torch, "phase 9a", arch, 10, note="; the capacity form")
        seq = torch.cat([prompts, toks[:, :-1]], dim=1)
        with torch.inference_mode():
            err = layer_consistency(torch, card, seq, 10,
                                    c32.replace(moe_impl="dense"))
        check(f"{arch}: every layer in the dense form, {seq.shape[1] - 10} "
              f"decode steps vs one prefill, relative to the layer's output "
              f"scale", err, 1e-4)


def device_time_by_kind(kernels, kinds=KERNEL_KINDS, other="other"):
    """Device ms of the profiled kernels by ``kinds`` (``KERNEL_KINDS``),
    the rest as ``other``; printed with each kind's share."""
    ms = collections.Counter()
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, names in kinds
                     if any(n in name for n in names)), other)
        ms[kind] += e.self_device_time_total / 1e3
    total = sum(ms.values())
    print("  device time by kind: " + "; ".join(
        f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
        for k, v in ms.most_common()), flush=True)
    return dict(ms)


def kernel_split(kernels, prefix):
    """Prints the device ms of each profiled kernel whose name holds
    ``prefix`` (the kernels of one launch: flash's gradient's delta,
    dK/dV and dq), its calls and its ms a call."""
    split = [(re.search(prefix + r"\w*", e.key).group(0), e.count,
              e.self_device_time_total / 1e3)
             for e in kernels if prefix in e.key]
    if split:
        print(f"  {prefix} kernels, device ms (calls, ms a call): " + "; ".join(
            f"{n} {ms:.3f} ({c}, {ms / c:.4f})" for n, c, ms in split),
            flush=True)


def phase9_records(torch):
    """(f) Flash at qwen3-moe-30b-a3b's prefill and its decode over the
    544-slot cache. Returns the records."""
    from repro_torch.configs.registry import get_config

    g = torch.Generator(device="cuda").manual_seed(29)
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=bf16)

    cfg = get_config("qwen3-moe-30b-a3b")
    B, P, G = MOE_SERVES[cfg.name]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = rnd(B, H, P, hd), rnd(B, KV, P, hd), rnd(B, KV, P, hd)
    out = [flash_record(
        torch, "flash_attention_bhsd_qwen3_prefill",
        f"qwen3-moe-30b-a3b prefill {B} x {H}/{KV} x {P}, hd {hd}, causal, "
        f"bf16", q, k, v, {}, {"is_causal": True},
        "src/repro_torch/kernels/csrc/flash_attention.cu")]
    L = P + G
    q = rnd(B, H, 1, hd)
    k, v = (rnd(B, L, KV, hd).transpose(1, 2) for _ in range(2))
    out.append(flash_record(
        torch, "flash_attention_bhsd_qwen3_decode",
        f"qwen3-moe-30b-a3b decode {B} x {H}/{KV} x 1 over the {L}-slot cache "
        f"in place, hd {hd}, bf16", q, k, v, {"causal": False}, {},
        "src/repro_torch/kernels/csrc/flash_decode.cu"))
    return out


def phase_moe(torch):
    """Phase 9: mixture-of-experts and qk-norm. Returns (records, their
    launches by record name)."""
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    phase_moe_agreement(torch)
    whole_on_meta(torch, "phase 9b", MOE_RANGES)                     # (b)
    calls, seq, dec = collections.Counter(), 0, 0
    for arch in MOE_SERVES:
        own = collections.Counter()
        params, cfg, forms = serve_arch(torch, arch, own, "phase 9c")
        calls.update(own)
        seq, dec = seq + forms["seq_bf16"], dec + forms["decode"]
        if arch == "qwen3-moe-30b-a3b":      # (g) one decode step, profiled
            B, P, _ = MOE_SERVES[arch]
            with torch.inference_mode():
                prompt = torch.ones((B, P), dtype=torch.long, device="cuda")
                _, caches, t = lm.prefill(params, {"inputs": prompt}, cfg,
                                          cache_len=P + 2)
                tok = prompt[:, -1:]
                lm.decode_step(params, caches, tok, t, cfg)        # warm
                kernels = profile_step(torch, lambda: lm.decode_step(
                    params, caches, tok, t, cfg),
                    f"phase 9g: one {arch} decode step ({B} rows over "
                    f"{P + 1} cached tokens, {cfg.n_layers} layers)")
                device_time_by_kind(kernels)
            del caches
        del params
        gc.collect()
        torch.cuda.empty_cache()
    # (e) every distinct flash call of the two serves, on fresh inputs
    print(f"phase 9e: {sum(calls.values())} flash calls, {len(calls)} "
          f"distinct", flush=True)
    hold_flash_calls(torch, calls, "phase 9")
    records = phase9_records(torch)
    print(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records, {"flash_attention_bhsd_qwen3_prefill": seq,
                     "flash_attention_bhsd_qwen3_decode": dec}

# ---------------------------------------------------------------------------
# phase 10: training the SSM archs
# ---------------------------------------------------------------------------

# phase 10e: a train step's device time by kind; the rest is the
# elementwise ops and reductions of the norms, gates and AdamW
TRAIN_KINDS = (("wkv6 gradient kernel", ("wkv6_bwd",)),
               ("wkv6 kernel", ("wkv6_",)),
               ("rglru gradient kernel", ("rglru_bwd",)),
               ("rglru kernel", ("rglru_kernel", "rglru_staged_kernel")),
               ("flash gradient kernel", ("flash_bwd_",)),
               ("flash kernel", ("flash_fwd_",)),
               ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
               ("casts and copies", ("copy", "cast")))
TRAIN_OTHER = "elementwise and reductions (norms, gates, AdamW)"
GRAD_NAMES = ("r", "k", "v", "logw", "u", "s0")


def function_parity(torch, label, fn, plain, ins, ups, fwd_ms, n_bwd):
    """(a) One autograd Function on the card: its gradients at the seeded
    upstream ``ups`` against autograd through ``plain`` on the same inputs,
    each relative to the plain gradient's max, to ``TOL`` of the inputs'
    dtype; one launch a forward and ``n_bwd`` a backward, which autograd
    runs on a thread of its own and which counts in the forward's
    ``ops.tally`` all the same; then its backward's time a call beside the
    forward kernel's ``fwd_ms``. Returns the backward's ms."""
    from repro_torch.kernels import ops

    def launched(counts):
        return sum(v for k, v in counts.items() if isinstance(k, str))
    name = dtype_name(ins[0].dtype)
    xs = [x.detach().requires_grad_() for x in ins]
    with ops.tally() as counts:
        outs = fn(*xs)
    n_fwd, base = launched(counts), sum(ops.launches.values())
    got = torch.autograd.grad(outs, xs, ups, retain_graph=True)
    torch.cuda.synchronize()
    n = sum(ops.launches.values()) - base
    expect(n_fwd == 1 and n == n_bwd and launched(counts) == 1 + n_bwd,
           f"{label}: {n_fwd} launches forward, {n} backward (the forward's "
           f"tally {dict(counts)}), not 1 and {n_bwd}")
    want = torch.autograd.grad(plain(*xs), xs, ups)
    for i, (a, b) in enumerate(zip(got, want)):
        scale = float(b.float().abs().max()) or 1.0
        check(f"{label} d(input {i}) / max |d| ({scale:.3e})",
              max_err(a, b) / scale, TOL[name])
    del want
    bwd_ms = wall_ms(torch, lambda: torch.autograd.grad(
        outs, xs, ups, retain_graph=True), iters=3, warmup=1)
    print(f"  {label}: forward kernel {fwd_ms:.4f} ms a call (device); "
          f"backward {bwd_ms:.2f} ms a call (between events), {n_bwd} "
          f"launch(es)", flush=True)
    return bwd_ms


def phase10_functions(torch):
    """(a) ``WKV6``, ``RGLRU`` and ``FlashAttention`` at the training
    shapes against autograd through their plain versions; flash's gradient
    kernel at recurrentgemma-2b's training shape and at phase 12's
    context-parallel chunks (rank 3's), records of their own
    (``flash_bwd_record``). Returns the backwards' ms by label and the
    records."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru, rwkv6

    g = torch.Generator(device="cuda").manual_seed(31)
    out = {}
    train = (SERVE_BATCH, 64, SERVE_PROMPT, 64)
    rank = (TP_BATCH, mesh_cfg("rwkv6-7b", None).d_model // 64 // TP_MESH[1],
            TP_SEQ, 64)
    f32, bf16 = torch.float32, torch.bfloat16
    for shape, dt, ends in ((train, f32, False), (train, bf16, False),
                            (train, f32, True), (rank, f32, False),
                            (rank, bf16, False), ((4, 4, 40, 16), f32, False)):
        B, H, T, K = shape
        ins = wkv_inputs(torch, g, B, H, T, K, dt, logw_ends=ends)
        ups = (torch.randn(B, H, T, K, generator=g, device="cuda").to(dt),
               torch.randn(B, H, K, K, generator=g, device="cuda"))
        fwd = graph_ms(torch, lambda: rwkv6.wkv6_bhtk(*ins), iters=4,
                       replays=3)
        label = (f"WKV6 {B}x{H}x{T}x{K} {dtype_name(dt)}"
                 + (", logw at -e^5 and -1e-6" if ends else ""))
        out[label] = function_parity(torch, label, rwkv6.wkv6_grad,
                                     rwkv6.wkv6_ref, ins, ups, fwd, 1)
        del ins, ups
    ins = wkv_inputs(torch, g, 2, 8, 45, 64, f32)
    dy = torch.randn(2, 8, 45, 64, generator=g, device="cuda")
    got = rwkv6.wkv6_bwd_bhtk(*ins, dy, None)
    for ref in (rwkv6.wkv6_bwd_chunk_ref, rwkv6.wkv6_bwd_serial_ref):
        want = ref(*ins, dy, None)
        for name, a, b in zip(GRAD_NAMES, got, want):
            check(f"WKV6's gradient kernel 2x8x45x64 fp32, dS absent, d{name}"
                  f" vs {ref.__name__} / max |d|",
                  max_err(a, b) / (float(b.abs().max()) or 1.0),
                  TOL["float32"])
    del ins, dy, got, want
    from repro_torch.distributed import cost
    T, C = RG_PROMPT, 2560
    for B in (RG_BATCH, SSM_TRAINS["recurrentgemma-2b"][0]):
        ins = rglru_inputs(torch, g, B, T, C)
        ups = tuple(torch.randn(*x.shape, generator=g, device="cuda")
                    for x in (ins[0], ins[2]))
        fwd = graph_ms(torch, lambda: rglru.rglru_btc(*ins), iters=4,
                       replays=3)
        label = f"RGLRU {B}x{T}x{C} fp32"
        out[label] = function_parity(torch, label, rglru.rglru_grad,
                                     rglru.rglru_ref, ins, ups, fwd, 1)
        h = rglru.rglru_btc(*ins)[0]
        got = rglru.rglru_bwd(ins[0], h, ins[2], *ups)
        want = rglru.rglru_bwd_ref(ins[0], h, ins[2], *ups)
        expect(all(torch.equal(x, y) for x, y in zip(got, want)),
               f"{label}: rglru_bwd's da, db, dh0 not bitwise "
               f"rglru_bwd_ref's")
        timing = ""
        if B == RG_BATCH:   # the training shape is timed in 10f's record
            call_ms, call_by = bound_ms(cost.rglru_bwd_work(B, T, C)[1],
                                        cost.rglru_bwd_work(B, T, C)[0],
                                        "float32")
            k_ms = graph_ms(torch, lambda: rglru.rglru_bwd(
                ins[0], h, ins[2], *ups), iters=5, replays=4)
            timing = (f"; {k_ms:.4f} ms a call (device) against its bound "
                      f"{call_ms:.4f} ms ({call_by})")
        print(f"  {label}: the gradient kernel's da, db and dh0 bitwise "
              f"rglru_bwd_ref's{timing}", flush=True)
        del ins, ups, h, got, want
    B, H, S, hd, W = RG_BATCH, 10, RG_PROMPT, 256, 2048
    ins = tuple(torch.randn(B, n, S, hd, generator=g, device="cuda")
                for n in (H, 1, 1))
    ups = torch.randn(B, H, S, hd, generator=g, device="cuda")
    kw = dict(window=W)
    fwd = graph_ms(torch, lambda: fa.flash_attention_bhsd(*ins, **kw),
                   iters=2, replays=2)
    label = f"FlashAttention {B}x{H}/1x{S} hd {hd} window {W} fp32"
    out[label] = function_parity(
        torch, label, lambda q, k, v: fa.flash_attention_grad(q, k, v, **kw),
        lambda q, k, v: fa.attention_ref(q, k, v, **kw), ins, ups, fwd, 1)
    del ups
    mask = fa._mask(S, torch.arange(S, device="cuda"), True, W, S, S, 0,
                    "cuda")
    records = [flash_bwd_record(
        torch, "flash_attention_bhsd_bwd", f"recurrentgemma-2b {B} x {H}/1 "
        f"x {S}, hd {hd}, causal, window {W}, fp32", *ins, kw,
        {"attn_mask": mask})]
    del ins, mask
    gc.collect()
    torch.cuda.empty_cache()
    # phase 12's context-parallel chunks at rank 3's offset
    for name, label, dt, (B, H, KV, Sq, Sk, hd), off, kw in (
            ("flash_attention_bhsd_bwd_cp_rg_r3",
             "recurrentgemma-2b CP rank 3", torch.float32,
             (4, 10, 1, 128, 512, 256), 384, {"window": W}),
            ("flash_attention_bhsd_bwd_cp_smollm_r3", "smollm-360m CP rank 3",
             torch.bfloat16, (4, 15, 5, 128, 512, 64), 384, {})):
        q = torch.randn(B, H, Sq, hd, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(B, KV, Sk, hd, generator=g, device="cuda").to(dt)
                for _ in range(2))
        mask = fa._mask(Sq, torch.arange(Sk, device="cuda"), True,
                        kw.get("window", 0), Sq, Sk, off, "cuda")
        records.append(flash_bwd_record(
            torch, name, f"{label} {B} x {H}/{KV} x {Sq} at offset {off} "
            f"over {Sk} keys, hd {hd}, causal, {dtype_name(dt)}", q, k, v,
            dict(kw, q_offset=off), {"attn_mask": mask}))
    return out, records


def rglru_form(T):
    """The form ``rglru_btc`` takes at T tokens on the path's fresh
    tensors, whose lru widths (64 reduced, 2560 and a rank's 640) are
    multiples of 4: ``staged`` from one stage of the ring up, else
    ``serial``."""
    from repro_torch.kernels import rglru
    return "staged" if T >= rglru.STAGE_TOKENS else "serial"


def ssm_step_launches(cfg, S):
    """One train step's launches at S tokens with remat "full": wkv6's
    prefill form twice a ``rwkv`` layer (forward, recompute) and its
    backward form once, rglru three times an ``rglru`` layer (forward and
    recompute in ``rglru_form(S)``, and its gradient kernel, the
    ``backward`` form), flash's fp32 sequence form twice an ``attn_local``
    layer (the residual stream is fp32: ``emb_scale``) and its gradient
    kernel once."""
    kinds = cfg.layer_kinds
    n_wkv, n_rg = kinds.count("rwkv"), 3 * kinds.count("rglru")
    n_fa = kinds.count("attn_local")
    want = {}
    if n_wkv:
        want.update({"wkv6_bhtk": 3 * n_wkv,
                     ("wkv6_bhtk", "prefill"): 2 * n_wkv,
                     ("wkv6_bhtk", "backward"): n_wkv})
    if n_rg:
        want.update({"rglru_btc": n_rg,
                     ("rglru_btc", rglru_form(S)): 2 * n_rg // 3,
                     ("rglru_btc", "backward"): n_rg // 3})
    if n_fa:
        want.update({"flash_attention_bhsd": 3 * n_fa,
                     ("flash_attention_bhsd", "seq_f32"): 2 * n_fa,
                     ("flash_attention_bhsd", "backward"): n_fa})
    return want


def backward_split(counts, forms):
    """``counts`` (launches by kernel) with wkv6's, rglru's and flash's
    split into their forward forms (``wkv6_bhtk``, ``rglru_btc``,
    ``flash_attention_bhsd``) and their gradient kernels
    (``wkv6_bhtk_bwd``, ``rglru_btc_bwd``, ``flash_attention_bhsd_bwd``),
    from ``forms`` (``ops.forms``)."""
    n = forms["wkv6_bhtk"]["backward"]
    r = forms["rglru_btc"]["backward"]
    m = forms["flash_attention_bhsd"]["backward"]
    return dict(counts, wkv6_bhtk=counts["wkv6_bhtk"] - n, wkv6_bhtk_bwd=n,
                rglru_btc=counts["rglru_btc"] - r, rglru_btc_bwd=r,
                flash_attention_bhsd=counts["flash_attention_bhsd"] - m,
                flash_attention_bhsd_bwd=m)


def time_wkv6_bwd(torch, g, B, H, T, K, dt, label):
    """The gradient kernel at (B, H, T, K) in ``dt``: its six gradients at a
    seeded upstream held to autograd through ``wkv6_ref`` (``TOL``,
    relative to each gradient's max), two calls bitwise equal; then its
    device time a call (CUDA graph replays, calls rotating over enough
    input sets to fill twice the 50 MB L2), the plain backward's
    (``_bwd_plain`` on the card, between events) and the bound, its work
    from ``distributed.cost.wkv6_bwd_work`` with the products at the
    split-TF32 rate, where the kernel runs them (the record's) and,
    printed, at the fp32 FMA rate. Returns the kernel's record without its
    name."""
    from repro_torch.distributed import cost
    from repro_torch.kernels import rwkv6

    from repro_torch.distributed.roofline import PEAK_FLOPS_SPLIT_TF32

    n_ops, n_bytes = cost.wkv6_bwd_work(B, H, T, K, torch.finfo(dt).bits // 8)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "float32", PEAK_FLOPS_SPLIT_TF32)
    fma_ms, fma_by = bound_ms(n_bytes, n_ops, "float32")
    sets = [(*wkv_inputs(torch, g, B, H, T, K, dt),
             torch.randn(B, H, T, K, generator=g, device="cuda").to(dt),
             torch.randn(B, H, K, K, generator=g, device="cuda"))
            for _ in range(-(-100_000_000 // n_bytes))]
    got = rwkv6.wkv6_bwd_bhtk(*sets[0])
    again = rwkv6.wkv6_bwd_bhtk(*sets[0])
    expect(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"{label}: two calls of the gradient kernel differ")
    xs = [x.detach().requires_grad_() for x in sets[0][:6]]
    want = torch.autograd.grad(rwkv6.wkv6_ref(*xs), xs, sets[0][6:])
    err, name = 0.0, dtype_name(dt)
    for n, a, b in zip(GRAD_NAMES, got, want):
        e = max_err(a, b)
        check(f"{label} {B}x{H}x{T}x{K} {name} d{n} vs autograd / max |d|",
              e / (float(b.float().abs().max()) or 1.0), TOL[name])
        err = max(err, e)
    del got, again, xs, want
    turn = itertools.cycle(sets)
    ms = graph_ms(torch, lambda: rwkv6.wkv6_bwd_bhtk(*next(turn)), iters=5,
                  replays=4)
    plain = wall_ms(torch, lambda: rwkv6._bwd_plain(*next(turn)), iters=3,
                    warmup=1)
    print(f"  WKV6's gradient kernel, {label} {B}x{H}x{T}x{K} {name}, device "
          f"ms per call: kernel {ms:.4f}, plain backward {plain:.2f}, bound "
          f"{b_ms:.4f} at the split-TF32 rate ({b_by}; {n_ops / 1e9:.2f} "
          f"GFLOP, {n_bytes / 1e6:.0f} MB), {100 * b_ms / ms:.1f}% of it; "
          f"{fma_ms:.4f} at the fp32 FMA rate ({fma_by}); chunks of "
          f"{rwkv6.BWD_CHUNK} tokens; two calls bitwise equal; err "
          f"{err:.3e}", flush=True)
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
            "replaces": "src/repro/kernels/rwkv6.py:69", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def ssm_train_agreement(torch):
    """(b) Both archs reduced in fp32 with remat "full": ``SSM_AGREE_STEPS``
    ``make_train_step`` steps from one set of weights and batches on the
    card and on the CPU; the losses to ``EVO_LOSS_RTOL`` relative, every
    weight to ``EVO_PARAM_ATOL``, each card step's launches
    (``ssm_step_launches``)."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.common import trainable
    from repro_torch.optim import OptConfig, init_opt_state, make_train_step

    opt = OptConfig(lr=5e-4, warmup_steps=0, total_steps=10)
    for arch, (B, S) in SSM_AGREE_SHAPES.items():
        cfg = get_reduced(arch).replace(compute_dtype="float32",
                                        remat="full")
        base = lm.init_lm(cfg, seed=0, device="cpu")
        batches = [lm_batch(cfg, B, S, seed=3, step=i)
                   for i in range(SSM_AGREE_STEPS)]
        out, tallies = {}, []
        for dev in ("cuda", "cpu"):
            params = trainable(base, dev)
            state = init_opt_state(dict(params.named_parameters()), opt)
            step, losses = make_train_step(cfg, opt), []
            for b in batches:
                with ops.tally() as counts:
                    params, state, m = step(params, state, {
                        k: v.to(dev) for k, v in b.items()})
                losses.append(float(m["loss"]))
                if dev == "cuda":
                    tallies.append(dict(counts))
            out[dev] = losses, dict(params.named_parameters())
        (gl, gp), (cl, cp) = out["cuda"], out["cpu"]
        want = ssm_step_launches(cfg, S)
        expect(all(c == want for c in tallies), f"{arch} reduced: card "
               f"steps' launches {tallies}, not {want} a step")
        print(f"  {arch} reduced, {SSM_AGREE_STEPS} steps fp32, remat full, "
              f"{B} x {S}: losses card {[round(x, 5) for x in gl]}, CPU "
              f"{[round(x, 5) for x in cl]}; {want} a card step", flush=True)
        check(f"{arch} reduced train losses card vs CPU, relative",
              max(abs(a - b) / abs(b) for a, b in zip(gl, cl)),
              EVO_LOSS_RTOL)
        check(f"{arch} reduced trained weights card vs CPU",
              max(max_err(gp[n].detach().cpu(), cp[n].detach())
                  for n in cp), EVO_PARAM_ATOL)


def n_params(torch, cfg):
    """Parameters of ``cfg``'s LM, built on the meta device."""
    from repro_torch.models import lm
    with torch.device("meta"):
        return sum(p.numel() for p in lm.LM(cfg).parameters())


def train_cfg(torch, arch, B, S):
    """The full config of ``arch``, its first segment's repeats cut to the
    deepest that trains in the card's free memory: 16 bytes a parameter
    (fp32 weights, gradients and two AdamW moments; the update runs in
    slices), the layer inputs remat keeps, and a step's transient memory
    (one layer's recompute, its backward, a CE chunk) as measured on a
    one-repeat model, with ``SERVE_HEADROOM`` to spare. Returns (cfg, the
    reckoning printed)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import train as tr
    from repro_torch.optim import OptConfig

    cfg = get_config(arch)
    (kinds, reps), *rest = cfg.segments

    def cut(n):
        segs = ((kinds, n),) + tuple(rest)
        return cfg.replace(n_layers=sum(len(k) * r for k, r in segs),
                           segments=segs)
    elem = 4 if cfg.emb_scale else 2          # the residual stream's dtype
    saved = B * S * cfg.d_model * elem        # one layer's kept input
    probe = cut(1)
    params, opt_state, step = tr.build(probe, OptConfig(), device="cuda")
    batch = {k: v.cuda() for k, v in lm_batch(probe, B, S).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(params, opt_state, batch)
    torch.cuda.synchronize()
    one = n_params(torch, probe)
    transient = torch.cuda.max_memory_allocated() - 16 * one
    del params, opt_state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    per_rep = n_params(torch, cut(2)) - one

    def need(n):
        return 16 * (one + (n - 1) * per_rep) + saved * cut(n).n_layers \
            + transient
    n = reps
    while n > 1 and need(n) + SERVE_HEADROOM > free:
        n -= 1
    expect(need(n) + SERVE_HEADROOM <= free, f"{arch}: not one repeat of "
           f"{kinds} trains in {free / 1e9:.1f} GB")
    whole = n_params(torch, cfg)
    note = (f"{'all' if n == reps else 'cut to'} {cut(n).n_layers} of "
            f"{cfg.n_layers} layers ({n} of {reps} repeats of {list(kinds)}"
            f"): 16 B x {(one + (n - 1) * per_rep) / 1e9:.3f}B parameters "
            f"(whole model {whole / 1e9:.3f}B, param_count "
            f"{cfg.param_count() / 1e9:.3f}B) + {saved / 1e6:.0f} MB of "
            f"kept input a layer + {transient / 1e9:.2f} GB measured on a "
            f"{probe.n_layers}-layer step = {need(n) / 1e9:.1f} GB, "
            f"{free / 1e9:.1f} GB free, {SERVE_HEADROOM / 1e9:.0f} GB kept")
    return cut(n), note


def ssm_train(torch, arch):
    """(c)-(e) ``launch/train.py`` on ``arch`` at full width, the depth
    from ``train_cfg``: ``SSM_TRAIN_STEPS`` steps of ``SSM_TRAINS`` rows x
    tokens, bf16 compute, the config's remat and CE chunks, no checkpoint;
    each step's launches (``ops.tally``) and the counters (zeroed before,
    read after) held to ``ssm_step_launches``; every loss finite, every
    weight leaf moved; ms a step, tokens/s, peak memory; flash and its
    gradient kernel held at every distinct call the steps made; then one
    more step under ``torch.profiler``. Returns the counters."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tr
    from repro_torch.optim import OptConfig, make_train_step

    B, S = SSM_TRAINS[arch]
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cfg, note = train_cfg(torch, arch, B, S)
    print(f"  the depth reckoning took {time.perf_counter() - t:.1f} s",
          flush=True)
    print(f"phase 10c: launch/train.py, {arch} at full width (d "
          f"{cfg.d_model}, {cfg.compute_dtype} compute, remat {cfg.remat}, "
          f"{cfg.ce_chunks} CE chunks), {B} x {S} tokens, "
          f"{SSM_TRAIN_STEPS} steps; depth {note}", flush=True)
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=SSM_TRAIN_STEPS)
    steps, sums, calls = [], {}, collections.Counter()

    def first(params):
        for n, p in params.named_parameters():
            sums[n] = float(torch.linalg.vector_norm(p.detach(),
                                                     dtype=torch.float64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with train_step_tallies(steps, first), flash_calls(calls):
        params, opt_state, losses = tr.train(
            cfg, opt, steps=SSM_TRAIN_STEPS, batch=B, seq=S, log_every=100,
            device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = dict(ops.launches)
    forms = {k: dict(v) for k, v in ops.forms.items()}
    want = ssm_step_launches(cfg, S)
    expect(len(steps) == SSM_TRAIN_STEPS
           and all(c == want for c, _ in steps),
           f"{arch}: steps' launches {[c for c, _ in steps]}, not {want}")
    total = {k: v * SSM_TRAIN_STEPS for k, v in want.items()
             if isinstance(k, str)}
    expect(counts == dict(dict.fromkeys(counts, 0), **total),
           f"{arch}: counters {counts}, not {total}")
    expect(all(math.isfinite(x) for x in losses), f"{arch}: losses {losses}")
    still = [n for n, p in params.named_parameters() if float(
        torch.linalg.vector_norm(p.detach(), dtype=torch.float64))
        == sums[n]]
    expect(not still, f"{arch}: leaves that did not move: {still[:6]}")
    walls = [w for _, w in steps]
    ms = statistics.median(walls[1:])
    print(f"  {arch}: losses {[round(x, 4) for x in losses]}; step wall "
          f"{[round(w, 1) for w in walls]} ms, median of the last "
          f"{len(walls) - 1} {ms:.1f} ms, {B * S / ms * 1e3:.0f} tokens/s, "
          f"{ms / cfg.n_layers:.1f} ms a layer at {cfg.n_layers} layers; "
          f"peak {peak / 1e9:.2f} GB; {want} a step (ops.tally), counters "
          f"{counts}, forms {forms['wkv6_bhtk']} {forms['flash_attention_bhsd']}"
          f"; all {len(sums)} weight leaves moved", flush=True)
    step_fn = make_train_step(cfg, opt)
    batch = {k: v.cuda() for k, v in lm_batch(cfg, B, S, seed=0,
                                              step=0).items()}
    t = time.perf_counter()
    kernels = profile_step(torch, lambda: step_fn(params, opt_state, batch),
                           f"phase 10e: one {arch} train step", top=10,
                           cpu=False)
    device_time_by_kind(kernels, TRAIN_KINDS, TRAIN_OTHER)
    kernel_split(kernels, "flash_bwd_")
    kernel_split(kernels, "wkv6_bwd_")
    print(f"  the profiled step and its summary took "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    del params, opt_state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    hold_flash_calls(torch, calls, "phase 10c")
    return backward_split(counts, forms)


def phase_ssm_train(torch):
    """Phase 10: training rwkv6-7b and recurrentgemma-2b. Returns (the new
    records, launches by record name)."""
    t_phase = time.perf_counter()
    print("phase 10a: the SSM path's autograd Functions on the card vs "
          "autograd through their plain versions", flush=True)
    bwd, bwd_records = phase10_functions(torch)
    print(f"  phase 10a took {time.perf_counter() - t_phase:.1f} s; phase "
          f"10b: reduced SSM training, card vs CPU", flush=True)
    ssm_train_agreement(torch)
    counts = {}
    for arch in SSM_TRAINS:
        print(f"  {time.perf_counter() - t_phase:.1f} s into phase 10",
              flush=True)
        counts[arch] = ssm_train(torch, arch)
    rg = counts["recurrentgemma-2b"]
    print("phase 10f: the kernels at recurrentgemma-2b's training shape "
          "(rglru's forward also at phase 11a's)", flush=True)
    g = torch.Generator(device="cuda").manual_seed(37)
    B, S, _ = MESH_TRAINS["recurrentgemma-2b"]
    time_rglru(torch, g, B, S, 2560, "phase 11a")
    B, S = SSM_TRAINS["recurrentgemma-2b"]
    records = [dict(time_rglru(torch, g, B, S, 2560, "train"),
                    name="rglru_btc_train"),
               dict(time_rglru_bwd(torch, g, B, S, 2560, "train"),
                    name="rglru_btc_bwd"),
               dict(time_flash256(torch, g, B, S, "train"),
                    name="flash_attention_bhsd_hd256_train")] + bwd_records
    print("phase 10g: WKV6's gradient kernel at rwkv6-7b's training shape "
          "and at phase 11a's", flush=True)
    B, S = SSM_TRAINS["rwkv6-7b"]
    time_wkv6_bwd(torch, g, B, 64, S, 64, torch.float32, "train")
    records.append(dict(time_wkv6_bwd(torch, g, B, 64, S, 64,
                                      torch.bfloat16, "train"),
                        name="wkv6_bhtk_bwd"))
    B, S, _ = MESH_TRAINS["rwkv6-7b"]
    time_wkv6_bwd(torch, g, B, 64, S, 64, torch.bfloat16, "phase 11a")
    print("  backwards, ms a call (between events): " + "; ".join(
        f"{k} {v:.2f}" for k, v in bwd.items()), flush=True)
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return records, {
        "wkv6_bhtk": counts["rwkv6-7b"]["wkv6_bhtk"],
        "wkv6_bhtk_bwd": counts["rwkv6-7b"]["wkv6_bhtk_bwd"],
        "rglru_btc_train": rg["rglru_btc"],
        "rglru_btc_bwd": rg["rglru_btc_bwd"],
        "flash_attention_bhsd_hd256_train": rg["flash_attention_bhsd"],
        "flash_attention_bhsd_bwd": rg["flash_attention_bhsd_bwd"]}

# ---------------------------------------------------------------------------
# phase 11: sharding and cost accounting
# ---------------------------------------------------------------------------


def mesh_cfg(arch, layers):
    """The full config of ``arch``, its first segment's repeats cut to
    ``layers`` layers (None: the whole model) and the other segments
    dropped."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    (kinds, _), *_ = cfg.segments
    reps = layers // len(kinds)
    return cfg.replace(segments=((kinds, reps),),
                       n_layers=reps * len(kinds))


def mesh_step_launches(cfg, S):
    """One train step's launches at S tokens with remat "full": the SSM
    archs' rule (``ssm_step_launches``) and flash's bf16 sequence form
    twice an ``attn`` layer (forward, recompute) and its gradient kernel
    once."""
    want = ssm_step_launches(cfg, S)
    n = cfg.layer_kinds.count("attn")
    if n:
        want.update({"flash_attention_bhsd": 3 * n,
                     ("flash_attention_bhsd", "seq_bf16"): 2 * n,
                     ("flash_attention_bhsd", "backward"): n})
    return want


def rel_err(a, b):
    """max |a - b| / max |b| (over 1 where b is all zeros)."""
    return max_err(a, b) / (float(b.float().abs().max()) or 1.0)


def mesh_train(torch, arch, mesh):
    """(a) ``launch/train.py`` on ``arch`` (``MESH_TRAINS``), ``MESH_STEPS``
    steps with ``mesh=None`` and then on the one-rank mesh from the same
    seed: losses to ``MESH_LOSS_RTOL`` and weights to ``MESH_WEIGHT_RTOL``
    relative (each leaf's max error over its max), each step's launches
    (``ops.tally``) the unsharded run's and ``mesh_step_launches``'; the
    gathered uses and gradient reductions a step; flash and its gradient
    kernel held at every distinct call of both runs. Returns the mesh run:
    (cfg, params, AdamW state, its counters, step walls in ms)."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tr
    from repro_torch.optim import OptConfig

    B, S, layers = MESH_TRAINS[arch]
    cfg = mesh_cfg(arch, layers)
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=MESH_STEPS)
    print(f"phase 11a: launch/train.py --mesh none, then --mesh sim (1, 1) "
          f"over (data, model), {arch} at full width (d {cfg.d_model}, "
          f"{cfg.n_layers} of {mesh_cfg(arch, None).n_layers} layers, "
          f"{cfg.compute_dtype} compute, remat {cfg.remat}, {cfg.ce_chunks} "
          f"CE chunks), {B} x {S} tokens, {MESH_STEPS} steps", flush=True)
    runs, calls = {}, collections.Counter()
    for kind in ("none", "sim"):
        steps, uses = [], dict(sharding.gathers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        ops.reset_launches()
        with train_step_tallies(steps), flash_calls(calls):
            params, state, losses = tr.train(
                cfg, opt, steps=MESH_STEPS, batch=B, seq=S, log_every=100,
                mesh=mesh if kind == "sim" else None, device="cuda")
        torch.cuda.synchronize()
        runs[kind] = {"params": params, "state": state, "losses": losses,
                      "steps": steps,
                      "counts": backward_split(dict(ops.launches),
                                               ops.forms),
                      "gathers": {k: (sharding.gathers[k] - uses[k])
                                  / MESH_STEPS for k in uses}}
        if kind == "none":
            del state, runs[kind]["state"]
    none, sim = runs["none"], runs["sim"]
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(sim["losses"], none["losses"]))
    want = dict(none["params"].named_parameters())
    weight_err = max(rel_err(sharding.whole(p).detach(), want[n].detach())
                     for n, p in sim["params"].named_parameters())
    tallies = [c for c, _ in sim["steps"]]
    expect(all(sharding.is_dtensor(p) for p in sim["params"].parameters()),
           f"{arch}: a parameter of the mesh run is not a DTensor")
    expect(tallies == [c for c, _ in none["steps"]] and all(
        c == mesh_step_launches(cfg, S) for c in tallies),
           f"{arch}: the mesh steps' launches {tallies}, the unsharded "
           f"run's {[c for c, _ in none['steps']]}, the rule "
           f"{mesh_step_launches(cfg, S)}")
    walls = {k: statistics.median([w for _, w in r["steps"]][1:])
             for k, r in runs.items()}
    g = sim["gathers"]
    print(f"  {arch}: losses none {[round(x, 5) for x in none['losses']]}, "
          f"mesh {[round(x, 5) for x in sim['losses']]}; step wall median "
          f"none {walls['none']:.1f} ms, mesh {walls['sim']:.1f} ms; "
          f"{mesh_step_launches(cfg, S)} a step in both; a mesh step "
          f"{g['uses']:.0f} gathered uses (an all-gather each on a mesh of "
          f"more than one rank; remat's recompute gathers again) and "
          f"{g['reductions']:.0f} gradient reductions (a reduce-scatter "
          f"each), none of which sends anything on this one-rank mesh",
          flush=True)
    check(f"{arch} mesh vs none train losses, relative", loss_err,
          MESH_LOSS_RTOL)
    check(f"{arch} mesh vs none trained weights, relative to each leaf's "
          f"max", weight_err, MESH_WEIGHT_RTOL)
    expect(g["uses"] >= g["reductions"] > 0 and g["uses"] == int(g["uses"]),
           f"{arch}: gathers a step {g}")
    del runs["none"], none, want
    gc.collect()
    torch.cuda.empty_cache()
    hold_flash_calls(torch, calls, f"phase 11a {arch}")
    return (cfg, sim["params"], sim["state"], sim["counts"],
            [w for _, w in sim["steps"]])


def mesh_checkpoint(torch, mesh):
    """(b) A mesh checkpoint round trip on smollm-360m: 2 steps saving at
    step 2; step 3's loss from the saved weights (no-grad ``lm_loss`` on
    the mesh) equal bitwise to the loss the restored mesh run's step 3
    reports, and to the ``--mesh none`` launcher's restored from the same
    checkpoint."""
    import shutil
    import tempfile

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as tr
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig

    arch = "smollm-360m"
    B, S, layers = MESH_TRAINS[arch]
    cfg = mesh_cfg(arch, layers)
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=MESH_STEPS)
    kw = dict(batch=B, seq=S, log_every=100, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        params, _, first = tr.train(cfg, opt, steps=2, ckpt_dir=f"{d}/mesh",
                                    ckpt_every=2, mesh=mesh, **kw)
        shutil.copytree(f"{d}/mesh", f"{d}/none")
        batch = {k: v.cuda() for k, v in sharding.local_rows(
            lm_batch(cfg, B, S, seed=0, step=2), mesh).items()}
        with torch.no_grad():
            want = float(lm.lm_loss(params, batch, cfg)[0])
        del params
        gc.collect()
        _, _, on_mesh = tr.train(cfg, opt, steps=3, ckpt_dir=f"{d}/mesh",
                                 restore=True, mesh=mesh, **kw)
        gc.collect()
        _, _, on_none = tr.train(cfg, opt, steps=3, ckpt_dir=f"{d}/none",
                                 restore=True, **kw)
    print(f"phase 11b: {arch} mesh checkpoint at step 2 (losses "
          f"{[round(x, 5) for x in first]}): step 3's loss from the saved "
          f"weights {want!r}; restored on the mesh {on_mesh!r}, restored "
          f"into --mesh none {on_none!r}", flush=True)
    expect(on_mesh == [want], f"the mesh restore's step 3 loss {on_mesh} "
           f"is not {want} bitwise")
    expect(on_none == [want], f"the --mesh none restore's step 3 loss "
           f"{on_none} is not {want} bitwise")


def mesh_roofline(torch, cfg, params, state, mesh, walls):
    """(c) One smollm-360m mesh step counted by ``distributed.cost`` on the
    card: the ``Roofline`` record (FLOPs, bytes and collective bytes per
    device, the attention and mixer tags, 6·N·D), the measured step time
    (the median of (a)'s steps after the first) and the step's model-FLOP
    share at the bf16 peak. Returns the record."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import cost, sharding
    from repro_torch.distributed.roofline import PEAK_FLOPS, Roofline
    from repro_torch.optim import OptConfig, make_train_step

    B, S, _ = MESH_TRAINS[cfg.name]
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=MESH_STEPS)
    step = make_train_step(cfg, opt, mesh=mesh)
    batch = {k: v.cuda() for k, v in sharding.local_rows(
        lm_batch(cfg, B, S, seed=0, step=MESH_STEPS), mesh).items()}
    t = time.perf_counter()
    with cost.counting() as c:
        step(params, state, batch)
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t
    total = c.total
    attn, mix = c.select("flashattn|sdpattn"), c.select(
        "wkvscan|rgscan|moeffn")
    roof = Roofline(
        flops_per_device=total.flops, hbm_bytes_per_device=total.bytes,
        collective_bytes_per_device=total.coll_total, chips=mesh.size(),
        model_flops=cost.model_flops(cfg, "train", B * S),
        collectives={k: round(v) for k, v in total.coll.items() if v})
    step_s = statistics.median(walls[1:]) / 1e3
    rec = dict(roof.to_dict(), step_s=step_s, mfu=roof.mfu(step_s),
               attn_tagged={"flops": attn.flops, "bytes": attn.bytes},
               mixer_tagged={"flops": mix.flops, "bytes": mix.bytes},
               peak_flops=PEAK_FLOPS, count_s=t_count)
    print(f"phase 11c: {cfg.name} mesh train step ({B} x {S}) counted on "
          f"the card in {t_count:.1f} s: {json.dumps(rec)}", flush=True)
    print(f"  6·N·D {roof.model_flops:.4e} FLOPs against {total.flops:.4e} "
          f"counted (model_flops_ratio {roof.model_flops_ratio:.3f}: remat's "
          f"recompute, attention, norms and AdamW); step {step_s * 1e3:.1f} "
          f"ms measured against a {roof.t_bound * 1e3:.1f} ms roofline "
          f"({roof.bottleneck}); smollm-360m train step mfu "
          f"{roof.mfu(step_s):.4f}", flush=True)
    expect(total.coll_total == 0, f"a one-rank mesh counted collective "
           f"bytes {total.coll}")
    expect(attn.flops > 0 and mix.flops == 0 and total.flops
           > roof.model_flops, f"phase 11c: counts {rec}")
    kernels = profile_step(torch, lambda: step(params, state, batch),
                           f"phase 11c: one {cfg.name} mesh train step",
                           top=8, cpu=False)
    device_time_by_kind(kernels, TRAIN_KINDS, TRAIN_OTHER)
    kernel_split(kernels, "flash_bwd_")
    return rec


def start_dryrun(d):
    """(d) Starts ``python -m repro_torch.launch.dryrun`` for each of
    ``DRYRUN_CELLS`` on the single-pod mesh, in subprocesses writing to
    the directory ``d`` (each joins a fake group of 256 ranks on the host;
    nothing reaches the card, so they run beside phase 11's training).
    Returns [(arch, shape, process)]."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log = open(os.path.join(d, f"{arch}_{shape}.log"), "w")
        with log:
            procs.append((arch, shape, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", "single",
                 "--out", d], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT, text=True)))
    return procs


def mesh_dryrun(d, procs, t):
    """(d) Waits for ``start_dryrun``'s subprocesses (started at ``t``),
    then prints each cell's roofline line and its bottleneck."""
    outs = []
    for arch, shape, p in procs:
        p.wait(timeout=max(1.0, t + DRYRUN_TIMEOUT_S - time.perf_counter()))
        with open(os.path.join(d, f"{arch}_{shape}.log")) as f:
            out = f.read()
        expect(p.returncode == 0, f"dryrun {arch} {shape}: exit "
               f"{p.returncode}\n{out[-3000:]}")
        with open(os.path.join(d, f"{arch}_{shape}_single.json")) as f:
            outs.append((json.load(f), out))
    print(f"phase 11d: launch/dryrun.py, {len(outs)} cells on a fake "
          f"256-rank single-pod mesh, done {time.perf_counter() - t:.1f} s "
          f"after their start (beside phase 11a-c)", flush=True)
    for rec, out in outs:
        expect(rec["applicable"] and rec["chips"] == 256
               and rec["roofline"]["flops_per_device"] > 0,
               f"dryrun record {rec}")
        print(f"  {[ln for ln in out.splitlines() if 'chips=' in ln][0]}",
              flush=True)
        print(f"  {rec['arch']} {rec['shape']}: bottleneck "
              f"{rec['roofline']['bottleneck']}, collectives "
              f"{rec['roofline']['collectives']}, attention "
              f"{rec['attn_tagged']['flops']:.4e} and mixer "
              f"{rec['mixer_tagged']['flops']:.4e} FLOPs a device, "
              f"arguments {rec['memory_analysis']['argument_size_bytes']} "
              f"B a rank", flush=True)


def phase_mesh(torch):
    """Phase 11: sharding and cost accounting on a one-rank NCCL mesh.
    Returns (the new records, launches by record name)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import train as tr

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dry = start_dryrun(d)
        try:
            mesh = tr.make_mesh("sim", "cuda")
            expect(dist.get_backend() == "nccl"
                   and mesh.device_type == "cuda"
                   and tuple(mesh.shape) == (1, 1),
                   f"phase 11: mesh {mesh}, backend {dist.get_backend()}")
            try:
                launches = {}
                for arch in MESH_TRAINS:
                    cfg, params, state, counts, walls = mesh_train(
                        torch, arch, mesh)
                    launches[arch] = counts
                    if arch == "smollm-360m":
                        smollm = mesh_roofline(torch, cfg, params, state,
                                               mesh, walls)
                    del params, state
                mesh_checkpoint(torch, mesh)
            finally:
                dist.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()
            mesh_dryrun(d, dry, t_phase)
        finally:
            for _, _, p in dry:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print("phase 11e: flash at smollm-360m's train shape", flush=True)
    B, S, _ = MESH_TRAINS["smollm-360m"]
    cfg = mesh_cfg("smollm-360m", None)
    g = torch.Generator(device="cuda").manual_seed(41)
    q, k, v = (torch.randn(B, h, S, cfg.head_dim, generator=g, device="cuda",
                           dtype=torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    label = (f"smollm-360m train {B} x {cfg.n_heads}/{cfg.n_kv_heads} x "
             f"{S}, hd {cfg.head_dim}, causal, bf16")
    records = [flash_record(
        torch, "flash_attention_bhsd_smollm_train", label, q, k, v, {},
        {"is_causal": True}, "src/repro_torch/kernels/csrc/flash_attention.cu"),
        flash_bwd_record(torch, "flash_attention_bhsd_bwd_smollm_train",
                         label, q, k, v, {}, {"is_causal": True})]
    print(f"  smollm-360m step: mfu {smollm['mfu']:.4f}; phase 11 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    rw, rg = launches["rwkv6-7b"], launches["recurrentgemma-2b"]
    return records, {
        "flash_attention_bhsd_smollm_train":
            launches["smollm-360m"]["flash_attention_bhsd"],
        "flash_attention_bhsd_bwd_smollm_train":
            launches["smollm-360m"]["flash_attention_bhsd_bwd"],
        "wkv6_bhtk": rw["wkv6_bhtk"], "wkv6_bhtk_bwd": rw["wkv6_bhtk_bwd"],
        "rglru_btc_train": rg["rglru_btc"],
        "rglru_btc_bwd": rg["rglru_btc_bwd"],
        "flash_attention_bhsd_hd256_train": rg["flash_attention_bhsd"],
        "flash_attention_bhsd_bwd": rg["flash_attention_bhsd_bwd"]}


# ---------------------------------------------------------------------------
# phase 12: tensor-parallel training over model
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def seen_calls():
    """Each layer's residual shape and each flash call's (Sq, q_offset)
    made in the block, as sets, by pass-throughs in the functions' places
    in their modules (where the callers look them up at each call)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import blocks
    seen = {"layers": set(), "flash": set(), "heads": set()}
    inner_fa, inner_layer = fa.flash_attention_bhsd, blocks.layer_fwd

    def flash(q, k, v, **kw):
        seen["flash"].add((q.shape[2], kw.get("q_offset", 0)))
        seen["heads"].add((q.shape[1], k.shape[1]))
        return inner_fa(q, k, v, **kw)

    def layer(kind, p, x, ctx, cfg):
        seen["layers"].add(tuple(x.shape))
        return inner_layer(kind, p, x, ctx, cfg)
    fa.flash_attention_bhsd, blocks.layer_fwd = flash, layer
    try:
        yield seen
    finally:
        fa.flash_attention_bhsd, blocks.layer_fwd = inner_fa, inner_layer


@contextlib.contextmanager
def moe_calls():
    """Each capacity-form MoE call made in the block: {"products": the set
    of (dispatch shape (G, experts, C, d), the shape of the ``wi`` it
    multiplies), "routing": [(the last token's expert ids, whether each
    was kept), (groups, top-k) each, a call]}, by pass-throughs in
    ``moe._experts``'s and ``moe.dispatch_slots``'s places."""
    from repro_torch.models import moe
    seen = {"products": set(), "routing": []}
    inner, inner_w, inner_d = moe._experts, moe._expert_w, moe.dispatch_slots

    def experts(p, h, cfg, eq_in, eq_out, use="whole"):
        used = []

        def expert_w(w, x, cfg, use):
            out = inner_w(w, x, cfg, use)
            if w is p.wi:
                used.append(tuple(out.shape))
            return out
        moe._expert_w = expert_w
        try:
            out = inner(p, h, cfg, eq_in, eq_out, use)
        finally:
            moe._expert_w = inner_w
        seen["products"].add((tuple(h.shape), used[0]))
        return out

    def dispatch(idx, E, C):
        out = inner_d(idx, E, C)
        k = idx.shape[-1]
        seen["routing"].append((out[0][:, -k:].clone(), out[1][:, -k:]
                                .clone()))
        return out
    moe._experts, moe.dispatch_slots = experts, dispatch
    try:
        yield seen
    finally:
        moe._experts, moe.dispatch_slots = inner, inner_d


def ep_expected_products(cfg, S, mode):
    """The one (dispatch, wi) shape pair ``moe_calls`` must record on a
    rank of the (1, 4) mesh for ``TP_BATCH`` rows of ``S`` tokens in
    ``mode``: llama4 (``"ep"``) and every serve step its E / 4 experts on
    all the rows' groups, qwen3's train rules one group of the 4 with every
    expert."""
    from repro_torch.models.moe import capacity
    m, E = TP_MESH[1], cfg.moe_experts
    d, f, C = cfg.d_model, cfg.moe_d_ff, capacity(S, cfg)
    if cfg.moe_parallelism == "ep" or mode == "serve":
        return {((TP_BATCH, E // m, C, d), (E // m, d, f))}
    return {((TP_BATCH // m, E, C, d), (E, d, f))}


def free_card(torch):
    """Give the card back: Python's garbage, the tensors shared with
    another process that it has released (``ipc_collect``: until then a
    shared block stays allocated here), the allocator's cache."""
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def over_model():
    """The uses so far that gathered a parameter over ``model``."""
    from repro_torch.distributed import sharding
    return sharding.gathers["over_model"]


def tp_expected_seen(cfg, rank):
    """What ``seen_calls`` must record in a phase 12 train step of ``cfg``
    on rank ``rank`` of the (1, 4) mesh: the residual's shape in every
    layer (each rank's 512 / 4 positions where the config sets
    ``sequence_parallel`` and has no recurrent layer), and flash's (Sq,
    q_offset) (each rank's 128 queries at its offset where the heads do
    not divide 4, else the whole sequence; none without attention)."""
    m = TP_MESH[1]
    sp = cfg.sequence_parallel and not any(
        k in ("rwkv", "rglru") for k in cfg.layer_kinds)
    layers = {(TP_BATCH, TP_SEQ // m if sp else TP_SEQ, cfg.d_model)}
    n = TP_SEQ // m
    if all(k in ("rwkv", "rglru") for k in cfg.layer_kinds):
        return layers, set()
    return layers, ({(n, rank * n)} if cfg.n_heads % m else {(TP_SEQ, 0)})


def tp_cfg(arch, dtype):
    """``mesh_cfg`` at phase 12's depth, computing in ``dtype``."""
    return mesh_cfg(arch, {**TP_TRAINS, **TP_SERVES}[arch]).replace(
        compute_dtype=dtype)


def tp_opt():
    from repro_torch.optim import OptConfig
    return OptConfig(lr=3e-4, warmup_steps=1, total_steps=TP_STEPS)


def tp_batch(torch, cfg, mesh, step):
    """``launch.train``'s batch of ``step`` on the card: this rank's rows
    on a mesh."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import sharding
    batch = lm_batch(cfg, TP_BATCH, TP_SEQ, seed=0, step=step)
    if mesh is not None:
        batch = sharding.local_rows(batch, mesh)
    return {k: v.cuda() for k, v in batch.items()}


def tp_first_grads(torch, cfg, mesh):
    """The first step's ``lm_loss`` gradients from seed 0's weights, as
    ``launch.train`` builds them (stored sharded on ``mesh``; the step
    tensor-parallel there): {name: gradient}."""
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    from repro_torch.models.common import trainable
    params = trainable(lm.init_lm(cfg, seed=0, device="cuda"))
    scope = contextlib.nullcontext()
    if mesh is not None:
        sharding.shard_module(params, mesh, cfg)
        scope = sharding.activation_sharding(mesh, cfg, "train")
    named = list(params.named_parameters())
    with scope:
        loss = lm.lm_loss(params, tp_batch(torch, cfg, mesh, 0), cfg)[0]
        grads = torch.autograd.grad(loss, [p for _, p in named])
    return {n: g.detach() for (n, _), g in zip(named, grads)}


def shard_of(full, p):
    """Rank's shard of the whole tensor ``full`` as DTensor ``p`` holds it:
    chunk ``coordinate`` of each mesh dim that shards it (a plain ``p``:
    all of it)."""
    if not hasattr(p, "placements"):
        return full
    mesh = p.device_mesh
    for size, c, pl in zip(mesh.shape, mesh.get_coordinate(), p.placements):
        if pl.is_shard():
            full = full.chunk(size, dim=pl.dim)[c]
    return full


def leaf_errors(named, ref):
    """{name: (max |this rank's shard - ref's|, max |ref|)} over (name,
    tensor) pairs against the whole tensors ``ref``; read on the card, no
    collective (gloo has no all-gather of CUDA tensors)."""
    out = {}
    for n, t in named:
        got = (t.to_local() if hasattr(t, "to_local") else t).detach()
        out[n] = (max_err(got, shard_of(ref[n], t)),
                  float(ref[n].float().abs().max()))
    return out


def tp_train(torch, cfg, mesh):
    """``launch/train.py``'s ``train`` on ``cfg`` for ``TP_STEPS`` steps at
    ``TP_BATCH`` x ``TP_SEQ`` (``mesh`` None: ``--mesh none``): (params,
    AdamW state, losses, each step's (launches, wall ms))."""
    from repro_torch.launch import train as tr
    steps = []
    gc.collect()
    torch.cuda.empty_cache()
    with train_step_tallies(steps):
        params, state, losses = tr.train(
            cfg, tp_opt(), steps=TP_STEPS, batch=TP_BATCH, seq=TP_SEQ,
            log_every=100, mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    return params, state, losses, steps


def tp_counted_step(torch, cfg, params, state, mesh, walls):
    """One more train step under ``distributed.cost``'s counter: FLOPs,
    bytes and collectives (calls and bytes by kind) of this rank, its
    ``Roofline`` on the mesh's ranks, and the MFU of the median measured
    step (after the first)."""
    from repro_torch.distributed import cost
    from repro_torch.distributed.roofline import Roofline
    from repro_torch.optim import make_train_step
    step = make_train_step(cfg, tp_opt(), mesh=mesh)
    batch = tp_batch(torch, cfg, mesh, TP_STEPS)
    with cost.counting() as c:
        step(params, state, batch)
    torch.cuda.synchronize()
    roof = Roofline(
        flops_per_device=c.total.flops, hbm_bytes_per_device=c.total.bytes,
        collective_bytes_per_device=c.total.coll_total, chips=TP_RANKS,
        model_flops=cost.model_flops(cfg, "train", TP_BATCH * TP_SEQ),
        collectives={k: round(v) for k, v in c.total.coll.items() if v})
    step_s = statistics.median(walls[1:]) / 1e3
    return {"flops": c.total.flops, "bytes": c.total.bytes,
            "calls": dict(c.calls), "coll": dict(c.total.coll),
            "step_s": step_s, "mfu": roof.mfu(step_s),
            "t_bound_s": roof.t_bound, "bottleneck": roof.bottleneck}


def tp_rank_run(torch, arch, dtype, ref, mesh):
    """One rank's share of a phase 12 config: the first step's gradients
    and the trained weights against ``ref`` (--mesh none's, whole), the
    losses, each step's launches and wall, one counted step."""
    cfg = tp_cfg(arch, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_over = over_model()
    with seen_calls() as seen, moe_calls() as calls:
        grads = tp_first_grads(torch, cfg, mesh)
    out = {"grads": leaf_errors(grads.items(), ref["grads"]), "seen": seen,
           "products": calls["products"]}
    del grads
    params, state, losses, steps = tp_train(torch, cfg, mesh)
    out["over_model"] = over_model() - n_over
    out.update(losses=losses, steps=steps, weights=leaf_errors(
        params.named_parameters(), ref["weights"]))
    out["counted"] = tp_counted_step(torch, cfg, params, state, mesh,
                                     [w for _, w in steps])
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def tp_serve_ref(torch, cfg):
    """--mesh none's serving of ``cfg`` on the card: seeded prompts of
    ``TP_BATCH`` x ``TP_SEQ`` tokens, one prefill and ``TP_DECODE`` greedy
    decode steps from seed 0's weights. Returns {"inputs", "logits" (the
    prefill's and each step's), "tokens" (each greedy token fed to the
    next step), "launches" (the prefill's and each step's, ``ops.tally``),
    "walls" (ms a decode step), "routing" (``moe_calls``' of each call)}."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    gen = torch.Generator(device="cuda").manual_seed(44)
    inputs = torch.randint(0, cfg.vocab_size, (TP_BATCH, TP_SEQ),
                           generator=gen, device="cuda")
    free_card(torch)
    params = lm.init_lm(cfg, seed=0, device="cuda")
    out = {"inputs": inputs, "logits": [], "tokens": [], "launches": [],
           "walls": []}
    with torch.no_grad():
        with ops.tally() as counts, moe_calls() as calls:
            logits, caches, t = lm.prefill(params, {"inputs": inputs}, cfg,
                                           TP_SEQ + TP_DECODE)
        out["routing"] = []
        for s in range(TP_DECODE + 1):
            out["logits"].append(logits.float())
            out["tokens"].append(logits.argmax(-1)[:, None])
            out["launches"].append(dict(counts))
            out["routing"].append(calls["routing"])
            if s == TP_DECODE:
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ops.tally() as counts, moe_calls() as calls:
                logits, caches = lm.decode_step(params, caches,
                                                out["tokens"][-1], t + s, cfg)
            torch.cuda.synchronize()
            out["walls"].append(1e3 * (time.perf_counter() - t0))
    del params, caches
    free_card(torch)
    return out


def tp_rank_serve(torch, arch, dtype, shape, ref, meshes):
    """One rank's share of a phase 12 serving run: seed 0's weights stored
    by the train rules, the rank's rows of ``ref``'s prompts prefilled
    under them (the rank's cache shards, its vocab slice of the logits);
    then the weights stored by the serve rules and ``TP_DECODE`` steps
    decoded on their 2-D shards, fed ``ref``'s greedy tokens; the logits
    gathered over the vocab against ``ref``'s rows. Each copy is
    ``lm.init_lm`` on the mesh, which draws only the rank's rows of the
    MoE experts. Returns {"errs" (a relative error each: prefill, steps),
    "row_errs" (each row's), "routing" and "products" (``moe_calls``' of
    each call), "over_model" (parameters gathered over ``model``), "heads"
    (the prefill flash calls' (q heads, KV heads)), "same" (same greedy
    tokens each),
    "launches" (``ops.tally`` each), "walls" (ms a decode step), "shapes"
    (each cache shard's against ``cache_spec_tree``'s placement), "coll"
    (the last step's collectives under ``distributed.cost``'s counter:
    bytes by kind, calls), "peak_gb"}."""
    from repro_torch.distributed import cost, sharding
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.common import vocab_lo
    mesh = meshes[shape]
    cfg = tp_cfg(arch, dtype)
    # fsdp off on TP_SERVE_2D's mesh: TP_DECODE's comment
    train_cfg = cfg if shape == TP_MESH else cfg.replace(fsdp=False)
    i, n_dp = sharding.dp_index(mesh)
    rows = slice(i * TP_BATCH // n_dp, (i + 1) * TP_BATCH // n_dp)
    out = {"errs": [], "row_errs": [], "same": [], "launches": [],
           "walls": [], "routing": [], "products": []}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_over = over_model()

    def hold(params, logits, s, calls):
        if vocab_lo(params, cfg) is not None:
            logits = sharding.gather_from_model(logits)
        want = ref["logits"][s][rows]
        diff = (logits.float() - want).abs().amax(-1)
        out["row_errs"].append((diff / (float(want.abs().max()) or 1.0))
                               .tolist())
        out["errs"].append(rel_err(logits.float(), want))
        out["same"].append(bool(torch.equal(logits.argmax(-1),
                                            want.argmax(-1))))
        out["routing"].append(calls["routing"])
        out["products"].append(calls["products"])
    with torch.no_grad():
        # each rank draws seed 0's weights keeping its shards (the experts'
        # rows only: lm.init_lm with the mesh)
        params = lm.init_lm(train_cfg, seed=0, device="cuda", mesh=mesh,
                            mode="train")
        with sharding.activation_sharding(mesh, cfg, "train"):
            with ops.tally() as counts, seen_calls() as seen, \
                    moe_calls() as calls:
                logits, caches, t = lm.prefill(
                    params, {"inputs": ref["inputs"][rows]}, cfg,
                    TP_SEQ + TP_DECODE)
            out["launches"].append(dict(counts))
            out["prefill_flash"] = seen["flash"]
            out["heads"] = seen["heads"]
            hold(params, logits, 0, calls)
        full = lm.init_caches(cfg, TP_BATCH, TP_SEQ + TP_DECODE,
                              device="meta")
        out["shapes"] = [
            (tuple(a.shape), sharding.shard_shape(w.shape, sp, mesh))
            for mine, whole_, spec in zip(
                caches, full, sharding.cache_spec_tree(full, mesh, cfg))
            for (_, a), (_, w), (_, sp) in zip(
                sharding._leaves(mine), sharding._leaves(whole_),
                sharding._leaves(spec))]
        del params, logits
        gc.collect()
        torch.cuda.empty_cache()
        params = lm.init_lm(cfg, seed=0, device="cuda", mesh=mesh,
                            mode="serve")
        with sharding.activation_sharding(mesh, cfg, "serve"):
            for s in range(TP_DECODE):
                last = s == TP_DECODE - 1       # counted, its wall not kept
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ops.tally() as counts, moe_calls() as calls, (
                        cost.counting() if last
                        else contextlib.nullcontext()) as c:
                    logits, caches = lm.decode_step(
                        params, caches, ref["tokens"][s][rows], t + s, cfg)
                torch.cuda.synchronize()
                if not last:
                    out["walls"].append(1e3 * (time.perf_counter() - t0))
                out["launches"].append(dict(counts))
                hold(params, logits, s + 1, calls)
    out["over_model"] = over_model() - n_over
    out["coll"] = {"bytes": dict(c.total.coll), "calls": dict(c.calls)}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def tp_worker(rank, port, tasks, results):
    """A phase 12 rank: joins the gloo group on ``port`` with the card as
    its device, builds the (1, 4) mesh and ``TP_SERVE_2D``'s, then runs
    each task until it gets None: ("train", arch, dtype, --mesh none's
    whole gradients and weights), ("serve", arch, dtype, mesh shape,
    --mesh none's serving run) or ("block", the unsharded MoE block's
    run), the tensors shared from the parent's memory on the card; a
    block's expert gradients go back the same way, held until the next
    task. A failure is reported, then raised."""
    import traceback
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_sim_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=TP_RANKS)
    try:
        meshes = {shape: make_sim_mesh(TP_RANKS, shape, ("data", "model"),
                                       device_type="cuda")
                  for shape in (TP_MESH, TP_SERVE_2D[1])}
        _cuda.lib()
        held = []       # a block's gradients, read by the parent in place
        while (task := tasks.get()) is not None:
            held.clear()
            free_card(torch)
            kind, *args = task
            del task    # the parent's tensors go with the last reference
            if kind == "block":
                res = ep_rank_block(torch, *args, meshes[TP_MESH], held)
            elif kind == "train":
                res = tp_rank_run(torch, *args, meshes[TP_MESH])
            else:
                res = tp_rank_serve(torch, *args, meshes)
            del args
            results.put((rank, res))
            del res
            free_card(torch)
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        dist.destroy_process_group()


def tp_results(results, procs):
    """The four ranks' results of one config, in rank order; raises on a
    rank's failure or when one does not answer in ``TP_TIMEOUT_S``."""
    import queue
    got = {}
    deadline = time.perf_counter() + TP_TIMEOUT_S
    while len(got) < TP_RANKS:
        try:
            rank, res = results.get(timeout=5.0)
        except queue.Empty:
            missing = sorted(set(range(TP_RANKS)) - set(got))
            expect(time.perf_counter() < deadline and all(
                procs[r].exitcode is None for r in missing),
                f"phase 12: ranks {missing} gave no result (exit codes "
                f"{[p.exitcode for p in procs]}, {TP_TIMEOUT_S} s "
                f"allowed)")
            continue
        expect("error" not in res, f"phase 12 rank {rank}: "
               f"{res.get('error')}")
        got[rank] = res
    return [got[r] for r in range(TP_RANKS)]


def tp_grad_tol(arch, dtype):
    """Phase 12's bound on the first step's gradients: ``TP_FLOOR_X``
    times the split's own move where ``TP_SPLIT_MOVES`` has one, else
    ``TP_GRAD_RTOL``."""
    move = TP_SPLIT_MOVES.get((arch, dtype))
    return TP_GRAD_RTOL if move is None else TP_FLOOR_X * move


def tp_hold(arch, dtype, cfg, none, ranks):
    """Phase 12's holds of one config: every rank's losses against --mesh
    none's (rwkv6-7b's fp32 first step only: ``TP_LOSS_RTOL``), the first
    step's gradients (``tp_grad_tol``), each step's launches exactly the
    unsharded step's by kernel and form, and that sequence and context
    parallelism ran where the config and the heads say
    (``tp_expected_seen``: the residual's shape in every layer, flash's
    (Sq, q_offset)); prints the weights' worst leaf and each rank's step,
    collectives and MFU. Returns each rank's launches summed over the
    steps."""
    rtol = TP_LOSS_RTOL[dtype]
    held = 1 if (arch, dtype) == ("rwkv6-7b", "float32") else TP_STEPS
    moe_kinds = any("moe" in k for k in cfg.layer_kinds)
    for r, res in enumerate(ranks):
        layers, flash = tp_expected_seen(cfg, r)
        if moe_kinds:
            want = ep_expected_products(cfg, TP_SEQ, "train")
            expect(res["products"] == want and res["over_model"] == 0,
                   f"{arch} {dtype} rank {r}: expert products "
                   f"{res['products']} (expected {want}), "
                   f"{res['over_model']} parameters gathered over model")
        expect(res["seen"]["layers"] == layers
               and res["seen"]["flash"] == flash,
               f"{arch} {dtype} rank {r}: residual shapes "
               f"{res['seen']['layers']} and flash (Sq, q_offset) "
               f"{res['seen']['flash']}, expected {layers} and {flash}")
        errs = [abs(a - b) / abs(b)
                for a, b in zip(res["losses"], none["losses"])]
        expect(len(errs) == TP_STEPS, f"{arch} {dtype} rank {r}: "
               f"{len(errs)} losses")
        steps = f"steps 1-{held}" if held > 1 else "step 1"
        check(f"{arch} {dtype} rank {r} losses of {steps} vs --mesh none, "
              f"relative", max(errs[:held]), rtol)
        tallies = [c for c, _ in res["steps"]]
        expect(tallies == [c for c, _ in none["steps"]]
               and len(tallies) == TP_STEPS,
               f"{arch} {dtype} rank {r}: launches a step {tallies}, "
               f"--mesh none's {[c for c, _ in none['steps']]}")
    print(f"  {arch} {dtype}: the residual in every layer "
          f"{sorted(ranks[0]['seen']['layers'])} a rank; flash's (Sq, "
          f"q_offset) by rank "
          f"{[sorted(res['seen']['flash']) for res in ranks]}", flush=True)
    if moe_kinds:
        print(f"  {arch} {dtype}: each rank's expert products (dispatch, wi) "
              f"{sorted(ranks[0]['products'])}, no parameter gathered over "
              f"model", flush=True)
    errs = [abs(a - b) / abs(b)
            for a, b in zip(ranks[0]["losses"], none["losses"])]
    print(f"  {arch} {dtype}: losses "
          f"{[round(x, 5) for x in ranks[0]['losses']]}, --mesh none "
          f"{[round(x, 5) for x in none['losses']]}, relative "
          f"{['%.2e' % e for e in errs]}", flush=True)

    def worst(key):
        names = ranks[0][key]
        errs = {n: max(res[key][n][0] for res in ranks) / (
            ranks[0][key][n][1] or 1.0) for n in names}
        name = max(errs, key=errs.get)
        return errs[name], name
    g_err, g_name = worst("grads")
    w_err, w_name = worst("weights")
    print(f"  {arch} {dtype}: first step's gradients' worst leaf {g_name} "
          f"{g_err:.3e} of its max; weights after {TP_STEPS} steps' worst "
          f"leaf {w_name} {w_err:.3e} of its max (AdamW's normalized step "
          f"carries the split's rounding; tests/test_torch_mesh_train.py "
          f"holds the reduced models' weights)", flush=True)
    check(f"{arch} {dtype} first step's gradients vs --mesh none, each "
          f"leaf's max error over its max", g_err, tp_grad_tol(arch, dtype))
    for r, res in enumerate(ranks):
        c = res["counted"]
        walls = [round(w, 1) for _, w in res["steps"]]
        print(f"  {arch} {dtype} rank {r}: launches a step "
              f"{res['steps'][0][0]}; step walls {walls} ms (--mesh "
              f"none {[round(w, 1) for _, w in none['steps']]}); a step's "
              f"collectives {c['calls']} calls, {{"
              + ", ".join(f"{k}: {v:.0f} B" for k, v in c["coll"].items())
              + f"}}; {c['flops']:.4e} FLOPs, {c['bytes']:.4e} B; mfu "
              f"{c['mfu']:.5f} (roofline {c['t_bound_s'] * 1e3:.1f} ms, "
              f"{c['bottleneck']}); peak {res['peak_gb']:.2f} GB", flush=True)
    expect(all(res["counted"]["calls"].get("all-reduce", 0) > 0
               for res in ranks), f"{arch} {dtype}: no all-reduce counted")
    totals = []
    for res in ranks:
        totals.append(collections.Counter())
        for counts, _ in res["steps"]:
            totals[-1].update(counts)
    return totals


def tp_records(torch):
    """The kernels at the local shapes tensor parallelism hands them, each
    held to its plain version, timed beside its bound (flash beside sdpa):
    flash at llama3-8b's 4 x 8/2 x 512 and chatglm3-6b's 4 x 8/1 x 512 (hd
    128, causal, bf16), wkv6's forward and gradient kernels at rwkv6-7b's
    4 x 16 x 512 x 64, rglru at recurrentgemma-2b's 4 x 512 x 640; then,
    held and timed too, the two shapes of phase 11's mesh runs, flash 4 x
    10/1 x 512 (fp32, hd 256, window 2048) and wkv6 4 x 64 x 512 x 64
    (PERF.md's rows of them). Returns the five records and the serving
    ranks' (``tp_serve_records``)."""
    g = torch.Generator(device="cuda").manual_seed(43)
    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    records = []
    for name, arch, kv in (("flash_attention_bhsd_tp_llama3", "llama3-8b",
                            2),
                           ("flash_attention_bhsd_tp_chatglm3",
                            "chatglm3-6b", 1)):
        cfg = mesh_cfg(arch, None)
        h = cfg.n_heads // TP_MESH[1]
        q, k, v = (torch.randn(TP_BATCH, n, TP_SEQ, cfg.head_dim,
                               generator=g, device="cuda",
                               dtype=torch.bfloat16) for n in (h, kv, kv))
        records.append(flash_record(
            torch, name, f"{arch} TP rank {TP_BATCH} x {h}/{kv} x {TP_SEQ}, "
            f"hd {cfg.head_dim}, causal, bf16", q, k, v, {},
            {"is_causal": True}, src))
    H = mesh_cfg("rwkv6-7b", None).d_model // 64 // TP_MESH[1]
    records.append(dict(time_wkv6(torch, g, TP_BATCH, H, TP_SEQ, 64,
                                  "TP rank"), name="wkv6_bhtk_tp"))
    records.append(dict(time_wkv6_bwd(torch, g, TP_BATCH, H, TP_SEQ, 64,
                                      torch.bfloat16, "TP rank"),
                        name="wkv6_bhtk_bwd_tp"))
    C = mesh_cfg("recurrentgemma-2b", None).lru_width // TP_MESH[1]
    records.append(dict(time_rglru(torch, g, TP_BATCH, TP_SEQ, C, "TP rank"),
                        name="rglru_btc_tp"))
    print("  phase 11's mesh-run shapes:", flush=True)
    time_flash256(torch, g, TP_BATCH, TP_SEQ, "mesh run")
    time_wkv6(torch, g, TP_BATCH, 64, TP_SEQ, 64, "mesh run")
    return records + tp_serve_records(torch, g, H, C)


def tp_serve_records(torch, g, H, C):
    """The kernels at the local shapes serving on a mesh hands each rank,
    held and timed as ``tp_records`` does, records of their own: llama3-8b's
    prefill on the (2, 2) mesh, 2 x 16/4 x 512 (hd 128, causal, bf16);
    flash's decode form over the 520 slots of a rank's cache (the prompt
    and ``TP_DECODE`` steps, all filled at the last step): llama3-8b's
    4 x 8/2 read in place and 2 x 16/4 on the (2, 2) mesh, chatglm3-6b's
    4 x 8/1 over its one KV head gathered whole from the head-dim shards
    (a fresh copy), recurrentgemma-2b's fp32 query 4 x 10/1 over hd 256
    gathered likewise (bf16; sdpa gets it widened), smollm-360m's 4 x
    15/5 (hd 64, bf16) likewise; wkv6's decode kernel at
    rwkv6-7b's 4 x ``H`` x 1 x 64 and rglru at recurrentgemma-2b's 4 x 1 x
    ``C``."""
    decode = "src/repro_torch/kernels/csrc/flash_decode.cu"
    L = TP_SEQ + TP_DECODE
    bf16, f32 = torch.bfloat16, torch.float32
    records = []
    llama = mesh_cfg("llama3-8b", None)
    rows, h, kv = (TP_BATCH // TP_SERVE_2D[1][0],
                   llama.n_heads // TP_SERVE_2D[1][1],
                   llama.n_kv_heads // TP_SERVE_2D[1][1])
    q, k, v = (torch.randn(rows, n, TP_SEQ, llama.head_dim, generator=g,
                           device="cuda", dtype=bf16) for n in (h, kv, kv))
    records.append(flash_record(
        torch, "flash_attention_bhsd_tp_llama3_2x2",
        f"llama3-8b (2, 2) rank prefill {rows} x {h}/{kv} x {TP_SEQ}, hd "
        f"{llama.head_dim}, causal, bf16", q, k, v, {}, {"is_causal": True},
        "src/repro_torch/kernels/csrc/flash_attention.cu"))
    cases = (  # name, label, rows, q heads, KV heads, hd, q dtype, seq_k
        ("flash_attention_bhsd_tp_llama3_decode", "llama3-8b (1, 4)",
         TP_BATCH, llama.n_heads // TP_MESH[1],
         llama.n_kv_heads // TP_MESH[1], llama.head_dim, bf16, L),
        ("flash_attention_bhsd_tp_llama3_2x2_decode", "llama3-8b (2, 2)",
         rows, h, kv, llama.head_dim, bf16, L),
        ("flash_attention_bhsd_tp_chatglm3_decode",
         "chatglm3-6b (1, 4), head-dim shards gathered", TP_BATCH,
         mesh_cfg("chatglm3-6b", None).n_heads // TP_MESH[1], 1, 128, bf16,
         None),
        ("flash_attention_bhsd_tp_rg_decode",
         "recurrentgemma-2b (1, 4), head-dim shards gathered, fp32 q",
         TP_BATCH, 10, 1, 256, f32, None),
        ("flash_attention_bhsd_tp_smollm_decode",
         "smollm-360m (1, 4), head-dim shards gathered", TP_BATCH,
         mesh_cfg("smollm-360m", None).n_heads,
         mesh_cfg("smollm-360m", None).n_kv_heads, 64, bf16, None))
    for name, label, B, hq, hk, hd, qdt, seq_k in cases:
        q = torch.randn(B, hq, 1, hd, generator=g, device="cuda").to(qdt)
        k, v = (ring_view(torch, g, B, L, hk, L, hd, bf16) for _ in range(2))
        kw = {"causal": False} if seq_k is None else {"causal": False,
                                                      "seq_k": seq_k}
        records.append(flash_record(
            torch, name, f"{label} rank decode {B} x {hq}/{hk} over {L} "
            f"slots, hd {hd}", q, k, v, kw, {}, decode))
    records.append(dict(time_wkv6(torch, g, TP_BATCH, H, 1, 64,
                                  "TP rank decode"),
                        name="wkv6_bhtk_tp_decode"))
    records.append(dict(time_rglru(torch, g, TP_BATCH, 1, C,
                                   "TP rank decode", "serial"),
                        name="rglru_btc_tp_decode"))
    return records


def tp_logit_tol(arch, dtype):
    """Phase 12's bound on serving's logits: ``TP_FLOOR_X`` times the
    split's own move where ``TP_SERVE_SPLIT_MOVES`` has one, else
    ``TP_LOGIT_RTOL``."""
    move = TP_SERVE_SPLIT_MOVES.get((arch, dtype))
    return TP_LOGIT_RTOL[dtype] if move is None else TP_FLOOR_X * move


def tp_serve_hold(arch, dtype, shape, ref, ranks):
    """Phase 12's holds of one serving run: every rank's prefill and
    decode logits against --mesh none's rows (``tp_logit_tol``; fp32
    also the same greedy tokens), each call's launches exactly --mesh
    none's by kernel and form, each cache shard the shape
    ``cache_spec_tree`` places, no all-gather in a decode step, the
    prefill's flash calls at each rank's chunk of the queries where the
    heads do not divide ``model`` (context parallelism) and at the whole
    prompt elsewhere; prints each rank's decode step wall, a step's
    collectives and the peak memory. Returns rank 0's launches:
    {"prefill": counts, "decode": the steps' summed, "prefill_last": the
    last rank's prefill counts}."""
    rtol = tp_logit_tol(arch, dtype)
    tag = f"{arch} {shape} {dtype}"
    m, n = shape[1], TP_SEQ // shape[1]
    cfg = tp_cfg(arch, dtype)
    attends = not all(k in ("rwkv", "rglru") for k in cfg.layer_kinds)
    experts = any("moe" in k for k in cfg.layer_kinds)
    for r, res in enumerate(ranks):
        want = ({(n, r % m * n)} if cfg.n_heads % m else {(TP_SEQ, 0)}) \
            if attends else set()
        expect(res["prefill_flash"] == want,
               f"{tag} rank {r}: prefill flash (Sq, q_offset) "
               f"{res['prefill_flash']}, expected {want}")
        errs = res["errs"]
        if experts:
            errs = ep_serve_hold(arch, dtype, cfg, ref, ranks, r, tag)
        check(f"{tag} rank {r} prefill + {TP_DECODE} decode steps' logits "
              f"vs --mesh none, max error over max |logit| (worst of "
              f"{['%.1e' % e for e in errs]})", max(errs), rtol)
        expect(dtype != "float32" or all(res["same"]),
               f"{tag} rank {r}: greedy tokens differ {res['same']}")
        expect(res["launches"] == ref["launches"],
               f"{tag} rank {r}: launches {res['launches']}, --mesh none's "
               f"{ref['launches']}")
        expect(all(a == b for a, b in res["shapes"]),
               f"{tag} rank {r}: cache shards {res['shapes']}")
        expect(not res["coll"]["bytes"].get("all-gather"),
               f"{tag} rank {r}: a decode step all-gathers "
               f"{res['coll']}")
        walls = res["walls"][1:]
        print(f"  {tag} rank {r}: a decode step {statistics.median(walls):.1f}"
              f" ms (median of steps 2-{len(walls) + 1}; --mesh none "
              f"{statistics.median(ref['walls'][1:]):.1f} ms); its "
              f"collectives {res['coll']['calls']} calls, {{"
              + ", ".join(f"{k}: {v:.0f} B"
                          for k, v in res["coll"]["bytes"].items())
              + f"}}; {len(res['shapes'])} cache shards as placed; peak "
              f"{res['peak_gb']:.2f} GB", flush=True)
    total = collections.Counter()
    for counts in ranks[0]["launches"][1:]:
        total.update(counts)
    return {"prefill": ranks[0]["launches"][0], "decode": total,
            "prefill_last": ranks[-1]["launches"][0]}


def ep_serve_hold(arch, dtype, cfg, ref, ranks, r, tag):
    """The MoE archs' serving holds of rank ``r``: every expert product
    over the rank's experts (``ep_expected_products``; qwen3's prefill,
    under the train rules, one group of every expert), no parameter
    gathered over ``model``, llama4's flash at its 10 / 2 heads a rank.
    Returns the logits' errors to hold: each call's worst row, where a
    bf16 run leaves out a row whose last token's expert choices or keeps
    differ from --mesh none's (a top-k choice near a tie flips under bf16
    rounding, and then that row's logits are another computation's);
    such rows are counted and printed. A call whose groups the ranks
    split (qwen3's prefill) takes each row's routing from the rank that
    routed it."""
    import torch
    from repro_torch.models.moe import capacity
    res = ranks[r]
    prods = res["products"]
    want = [ep_expected_products(cfg, TP_SEQ, "train")] + [
        ep_expected_products(cfg, 1, "serve")] * TP_DECODE
    expect(prods == want and res["over_model"] == 0,
           f"{tag} rank {r}: expert products {prods} (expected {want}), "
           f"{res['over_model']} parameters gathered over model")
    if arch == EP_ARCH:
        heads = {(cfg.n_heads // TP_MESH[1], cfg.n_kv_heads // TP_MESH[1])}
        expect(res["heads"] == heads, f"{tag} rank {r}: flash heads "
               f"{res['heads']}, expected {heads}")
    if dtype != "bfloat16":
        return res["errs"]
    errs, flipped = [], 0
    for s, theirs in enumerate(ref["routing"]):
        rows = len(res["row_errs"][s])
        mine = []
        for layer, (e, k) in enumerate(res["routing"][s]):
            if e.shape[0] < rows:           # each rank routed its groups
                e, k = (torch.cat([x["routing"][s][layer][i] for x in ranks])
                        for i in (0, 1))
            mine.append((e, k))
        agree = [all(torch.equal(a[row], b[row])
                     for (ea, ka), (eb, kb) in zip(mine, theirs)
                     for a, b in ((ea, eb), (ka, kb)))
                 for row in range(rows)]
        flipped += agree.count(False)
        errs.append(max([e for e, ok in zip(res["row_errs"][s], agree)
                         if ok] or [0.0]))
    print(f"  {tag} rank {r}: {flipped} of {len(errs) * len(agree)} "
          f"(call, row) logits left out of the hold, their last token "
          f"routed otherwise than --mesh none's; all: "
          f"{['%.1e' % e for e in res['errs']]} (capacity "
          f"{capacity(TP_SEQ, cfg)} a prompt's expert)", flush=True)
    return errs


def tp_serve(torch, tasks, results, procs):
    """Phase 12's serving: for each of ``TP_TRAINS`` on the (1, 4) mesh and
    ``TP_SERVE_2D``, in fp32 and in the config's dtype, --mesh none's run
    here (``tp_serve_ref``), then the ranks' (``tp_rank_serve``), held by
    ``tp_serve_hold``. Returns rank 0's launches of the configs' dtypes by
    (arch, mesh shape)."""
    runs = [(arch, TP_MESH) for arch in {**TP_TRAINS, **TP_SERVES}] \
        + [TP_SERVE_2D]
    print(f"phase 12: serving, the prefill of {TP_BATCH} x {TP_SEQ} tokens "
          f"under the train rules and {TP_DECODE} decode steps on the serve "
          f"rules' shards, on {runs}; the decode walls are 4 processes "
          f"sharing one card and gloo's host-staged all-reduces, not NCCL "
          f"scaling", flush=True)
    out = {}
    for dtype in ("float32", None):
        for arch, shape in runs:
            cdt = dtype or mesh_cfg(arch, None).compute_dtype
            t0 = time.perf_counter()
            ref = tp_serve_ref(torch, tp_cfg(arch, cdt))
            t1 = time.perf_counter()
            for q in tasks:
                q.put(("serve", arch, cdt, shape, ref))
            ranks = tp_results(results, procs)
            print(f"phase 12: serving {arch} {cdt} on {shape}: --mesh none "
                  f"{t1 - t0:.1f} s, the mesh {time.perf_counter() - t1:.1f} "
                  f"s", flush=True)
            held = tp_serve_hold(arch, cdt, shape, ref, ranks)
            if dtype is None:
                out[(arch, shape)] = held
            del ref, ranks
            free_card(torch)
    return out


# -- phase 12, expert parallelism: the llama4 MoE block at full width ------


EP_GRADS = ("router", "wi", "wg", "wo")


def ep_block_run(torch, moe_p, x, gy, cfg, sp):
    """The MoE block forward and backward on bf16 leaves: ``moe_fwd`` of
    ``x`` (under ``sp`` the rank's chunk of the sequence), the loss the
    output times ``gy`` summed, plus the load-balance and z aux values (as
    ``lm_loss`` adds them). Returns (y, aux, the input's gradient,
    {router, wi, wg, wo: gradient})."""
    from repro_torch.models import moe
    leaves = [getattr(moe_p, n).requires_grad_(True) for n in EP_GRADS]
    xl = x.detach().clone().requires_grad_(True)
    y, aux = moe.moe_fwd(moe_p, xl, cfg, sp=sp)
    loss = (y.float() * gy.float()).sum() + aux["moe_lb_loss"] \
        + aux["moe_z_loss"]
    grads = torch.autograd.grad(loss, [xl] + leaves)
    return (y.detach(), {k: float(v) for k, v in aux.items()}, grads[0],
            dict(zip(EP_GRADS, grads[1:])))


def ep_block_ref(torch):
    """The unsharded llama4 MoE block (seed 0's weights of the served pair,
    its ``moe`` layer alone kept) on ``EP_BLOCK_SEED``'s bf16 input of
    ``TP_BATCH`` x ``TP_SEQ`` tokens, forward and backward, alone on the
    card: {"x", "gy", "y", "aux", "dx", "router" (on the card), "experts"
    (each expert weight's gradient, in host memory), "top" (each
    gradient's max |value|), "peak_gb"}."""
    from repro_torch.models import lm
    cfg = tp_cfg(EP_ARCH, "bfloat16")
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    moe_p = params.layers[cfg.layer_kinds.index("moe")].moe
    del params
    g = torch.Generator(device="cuda").manual_seed(EP_BLOCK_SEED)
    x, gy = (torch.randn(TP_BATCH, TP_SEQ, cfg.d_model, generator=g,
                         device="cuda").to(torch.bfloat16) for _ in range(2))
    y, aux, dx, grads = ep_block_run(torch, moe_p, x, gy, cfg, False)
    del moe_p
    out = {"x": x, "gy": gy, "y": y, "aux": aux, "dx": dx,
           "router": grads.pop("router"),
           "top": {n: float(t.float().abs().max()) for n, t in grads.items()},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["experts"] = {n: grads.pop(n).cpu() for n in list(grads)}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ep_rank_block(torch, ref, mesh, held):
    """One rank's llama4 MoE block: seed 0's pair drawn on the mesh by the
    train rules (the rank's 32 experts only), its ``moe`` layer forward
    and backward on the rank's chunk of ``ref``'s input (sequence
    parallel, as the config sets it). Returns the output's, the input's
    and the router's gradient's errors against ``ref``, the aux values,
    the rank's expert rows and their gradients (read by the parent in
    place: ``held`` keeps them until the next task), the expert products,
    the parameters gathered over ``model``, the collectives and the peak
    memory."""
    from repro_torch.distributed import cost, sharding
    from repro_torch.models import lm
    cfg = tp_cfg(EP_ARCH, "bfloat16")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(cfg, seed=0, device="cuda", mesh=mesh, mode="train")
    moe_p = params.layers[cfg.layer_kinds.index("moe")].moe
    del params
    # the draw's whole embedding and head went back to this rank's cache,
    # in blocks the block's gradients cannot reuse: give them to the card
    free_card(torch)
    n_over = over_model()
    with sharding.activation_sharding(mesh, cfg, "train"), \
            moe_calls() as calls, cost.counting() as c:
        sp = sharding.seq_split(TP_SEQ, cfg)
        part = sharding.rank_slice(TP_SEQ) if sp else slice(None)
        y, aux, dx, grads = ep_block_run(torch, moe_p, ref["x"][:, part],
                                         ref["gy"][:, part], cfg, sp)
    router = grads.pop("router")
    experts = {n: g.to_local() for n, g in grads.items()}
    held.append((moe_p, experts))
    return {"sp": sp, "y": rel_err(y, ref["y"][:, part]),
            "dx": rel_err(dx, ref["dx"][:, part]),
            "router": rel_err(router.to_local(), shard_of(ref["router"],
                                                          router)),
            "aux": aux, "experts": experts,
            "rows": sharding.expert_rows(mesh, cfg, "train"),
            "products": calls["products"],
            "over_model": over_model() - n_over,
            "coll": dict(c.total.coll),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def ep_block(torch, tasks, results, procs):
    """Phase 12's llama4 MoE block at full width: the unsharded block here
    first (``ep_block_ref``), then every rank's (``ep_rank_block``),
    held: the output, the input's gradient and the router's gradient
    relative to their max, each rank's experts' gradients (its rows of the
    whole gradient, compared ``EP_PIECE`` experts at a time from host
    memory) relative to the whole leaf's max, all within
    ``TP_LOSS_RTOL["bfloat16"]``; the aux values within it too; each
    rank's products over its 32 experts, no parameter gathered over
    ``model`` and no all-gather; each rank's peak memory printed."""
    cfg = tp_cfg(EP_ARCH, "bfloat16")
    rtol = TP_LOSS_RTOL["bfloat16"]
    t0 = time.perf_counter()
    ref = ep_block_ref(torch)
    held_gb = torch.cuda.memory_reserved() / 1e9
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    t1 = time.perf_counter()
    for q in tasks:
        q.put(("block", {k: v for k, v in ref.items() if k != "experts"}))
    ranks = tp_results(results, procs)
    print(f"phase 12: llama4-maverick-400b-a17b MoE block (d {cfg.d_model}, "
          f"{cfg.moe_experts} experts of f {cfg.moe_d_ff}, top-"
          f"{cfg.moe_top_k}, shared expert), {TP_BATCH} x {TP_SEQ} bf16 "
          f"tokens, forward and backward on bf16 leaves: unsharded "
          f"{t1 - t0:.1f} s (peak {ref['peak_gb']:.2f} GB; then this "
          f"process held {held_gb:.2f} GB, {free_gb:.2f} GB free on the "
          f"card), the mesh {time.perf_counter() - t1:.1f} s", flush=True)
    want = ep_expected_products(cfg, TP_SEQ, "train")
    for r, res in enumerate(ranks):
        tag = f"llama4 MoE block rank {r}"
        expect(res["sp"] and res["products"] == want
               and res["over_model"] == 0
               and not res["coll"].get("all-gather"),
               f"{tag}: sp {res['sp']}, products {res['products']} "
               f"(expected {want}), {res['over_model']} gathered over "
               f"model, collectives {res['coll']}")
        for what in ("y", "dx", "router"):
            check(f"{tag} {what} vs the unsharded block, max error over "
                  f"max", res[what], rtol)
        aux = max(abs(res["aux"][k] - v) / (abs(v) or 1.0)
                  for k, v in ref["aux"].items())
        check(f"{tag} aux values vs the unsharded block, relative", aux,
              rtol)
        rows = res["rows"]
        for n, got in res["experts"].items():
            whole = ref["experts"][n]
            err = max(max_err(got[i:i + EP_PIECE],
                              whole[rows.start + i:rows.start + i
                                    + EP_PIECE].cuda())
                      for i in range(0, got.shape[0], EP_PIECE))
            check(f"{tag} {n} gradient, experts {rows.start}-"
                  f"{rows.stop - 1}, vs the unsharded block's, max error "
                  f"over the leaf's max", err / (ref["top"][n] or 1.0), rtol)
        print(f"  {tag}: products (dispatch, wi) {sorted(res['products'])}; "
              f"collectives {res['coll']}; peak {res['peak_gb']:.2f} GB",
              flush=True)
    del ranks, ref
    free_card(torch)


def ep_records(torch, g):
    """Flash at llama4-maverick-400b-a17b's rank-local shapes on the (1, 4)
    mesh, held and timed as ``tp_records`` does: the serving prefill's
    bf16 sequence form, 4 x 40/4 q heads over 8/4 KV heads x 512, hd 128,
    causal (qk-normed q and k are plain tensors to the kernel); its decode
    form over the 520 slots of a rank's cache in place."""
    cfg = mesh_cfg(EP_ARCH, None)
    m = TP_MESH[1]
    h, kv, hd = cfg.n_heads // m, cfg.n_kv_heads // m, cfg.head_dim
    bf16 = torch.bfloat16
    q, k, v = (torch.randn(TP_BATCH, n, TP_SEQ, hd, generator=g,
                           device="cuda", dtype=bf16) for n in (h, kv, kv))
    out = [flash_record(
        torch, "flash_attention_bhsd_ep_llama4",
        f"llama4 (1, 4) rank prefill {TP_BATCH} x {h}/{kv} x {TP_SEQ}, hd "
        f"{hd}, causal, bf16", q, k, v, {}, {"is_causal": True},
        "src/repro_torch/kernels/csrc/flash_attention.cu")]
    L = TP_SEQ + TP_DECODE
    q = torch.randn(TP_BATCH, h, 1, hd, generator=g, device="cuda").to(bf16)
    k, v = (ring_view(torch, g, TP_BATCH, L, kv, L, hd, bf16)
            for _ in range(2))
    out.append(flash_record(
        torch, "flash_attention_bhsd_ep_llama4_decode",
        f"llama4 (1, 4) rank decode {TP_BATCH} x {h}/{kv} over {L} slots, "
        f"hd {hd}", q, k, v, {"causal": False, "seq_k": L}, {},
        "src/repro_torch/kernels/csrc/flash_decode.cu"))
    return out


def phase_tp(torch):
    """Phase 12: tensor-parallel training over ``model``. Four processes on
    the one card join a gloo group (CUDA tensors) as a (1, 4) ("data",
    "model") mesh while the kernels are held and timed at the ranks' local
    shapes here (``tp_records``, ``tp_serve_records``); then each of
    ``TP_TRAINS`` trains
    ``TP_STEPS`` steps there, in fp32 and in its config's dtype, held
    against --mesh none run here from the same seed (``tp_hold``).
    Returns (the records, launches by record name)."""
    import multiprocessing
    import socket

    t_phase = time.perf_counter()
    print(f"phase 12: tensor-parallel training over model, {TP_RANKS} "
          f"processes on the one card as a {TP_MESH} (data, model) mesh over "
          f"gloo with CUDA tensors; {TP_BATCH} x {TP_SEQ} tokens, "
          f"{TP_STEPS} steps; the step walls are 4 processes sharing one "
          f"card and gloo's host-staged all-reduces, not NCCL scaling",
          flush=True)
    free_card(torch)
    ctx = multiprocessing.get_context("spawn")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tasks = [ctx.Queue() for _ in range(TP_RANKS)]
    results = ctx.Queue()
    procs = [ctx.Process(target=tp_worker, args=(r, port, tasks[r], results),
                         daemon=True) for r in range(TP_RANKS)]
    for p in procs:         # the ranks start up while the kernels are timed
        p.start()
    launches = {}
    try:
        records = tp_records(torch)
        records += ep_records(torch, torch.Generator(device="cuda")
                              .manual_seed(48))
        for dtype in ("float32", None):
            for arch in TP_TRAINS:
                cdt = dtype or mesh_cfg(arch, None).compute_dtype
                cfg = tp_cfg(arch, cdt)
                t0 = time.perf_counter()
                grads = tp_first_grads(torch, cfg, None)
                params, state, losses, steps = tp_train(torch, cfg, None)
                del state
                ref = {"grads": grads, "weights": {
                    n: p.detach() for n, p in params.named_parameters()}}
                free_card(torch)
                held_gb = torch.cuda.memory_reserved() / 1e9
                t1 = time.perf_counter()
                for q in tasks:
                    q.put(("train", arch, cdt, ref))
                ranks = tp_results(results, procs)
                print(f"phase 12: {arch} ({cfg.n_layers} of "
                      f"{mesh_cfg(arch, None).n_layers} layers, d "
                      f"{cfg.d_model}) {cdt}: --mesh none {t1 - t0:.1f} s, "
                      f"the mesh {time.perf_counter() - t1:.1f} s; this "
                      f"process held {held_gb:.2f} GB meanwhile, each rank "
                      f"peaked at {[round(r['peak_gb'], 2) for r in ranks]}"
                      f" GB", flush=True)
                total = tp_hold(arch, cdt, cfg, {"losses": losses,
                                                 "steps": steps}, ranks)
                if dtype is None:
                    launches[arch] = total
                del ref, grads, params, ranks
                free_card(torch)
        serving = tp_serve(torch, tasks, results, procs)
        ep_block(torch, tasks, results, procs)
        for q in tasks:
            q.put(None)
        for p in procs:
            p.join(60)
        expect([p.exitcode for p in procs] == [0] * TP_RANKS,
               f"phase 12 ranks' exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    fa = ("flash_attention_bhsd", "seq_bf16")
    f32 = ("flash_attention_bhsd", "seq_f32")
    fd = ("flash_attention_bhsd", "decode")
    fb = ("flash_attention_bhsd", "backward")
    wkv, rg = ("wkv6_bhtk", "prefill"), "rglru_btc"
    pre = {k: v["prefill"] for k, v in serving.items()}
    last = {k: v["prefill_last"] for k, v in serving.items()}
    dec = {k: v["decode"] for k, v in serving.items()}
    llama, llama_2d = ("llama3-8b", TP_MESH), TP_SERVE_2D
    ep = (EP_ARCH, TP_MESH)
    glm, rw, rgm, smol = (("chatglm3-6b", TP_MESH), ("rwkv6-7b", TP_MESH),
                          ("recurrentgemma-2b", TP_MESH),
                          ("smollm-360m", TP_MESH))
    # serving's prefills add to the training records of their shapes (rank
    # 0's; rank 3's for the context-parallel chunks at its offset), its
    # (2, 2) prefill and its decode steps are records of their own
    first = {arch: totals[0] for arch, totals in launches.items()}
    out = {"flash_attention_bhsd_tp_llama3":
               first["llama3-8b"][fa] + pre[llama][fa],
           "flash_attention_bhsd_tp_chatglm3":
               first["chatglm3-6b"][fa] + pre[glm][fa],
           "wkv6_bhtk_tp": first["rwkv6-7b"][wkv] + pre[rw][wkv],
           "wkv6_bhtk_bwd_tp": first["rwkv6-7b"][("wkv6_bhtk", "backward")],
           "rglru_btc_tp": first["recurrentgemma-2b"][rg] + pre[rgm][rg]
           - first["recurrentgemma-2b"][(rg, "backward")],
           "rglru_btc_bwd": first["recurrentgemma-2b"][(rg, "backward")],
           "flash_attention_bhsd_cp_rg_r3":
               launches["recurrentgemma-2b"][-1][f32] + last[rgm][f32],
           "flash_attention_bhsd_cp_smollm":
               first["smollm-360m"][fa] + pre[smol][fa],
           "flash_attention_bhsd_cp_smollm_r3":
               launches["smollm-360m"][-1][fa] + last[smol][fa],
           "flash_attention_bhsd_bwd_cp_rg_r3":
               launches["recurrentgemma-2b"][-1][fb],
           "flash_attention_bhsd_bwd_cp_smollm_r3":
               launches["smollm-360m"][-1][fb],
           "flash_attention_bhsd_tp_smollm_decode": dec[smol][fd],
           "flash_attention_bhsd_tp_llama3_2x2": pre[llama_2d][fa],
           "flash_attention_bhsd_tp_llama3_decode": dec[llama][fd],
           "flash_attention_bhsd_tp_llama3_2x2_decode": dec[llama_2d][fd],
           "flash_attention_bhsd_tp_chatglm3_decode": dec[glm][fd],
           "flash_attention_bhsd_tp_rg_decode": dec[rgm][fd],
           "wkv6_bhtk_tp_decode": dec[rw][("wkv6_bhtk", "decode")],
           "rglru_btc_tp_decode": dec[rgm][rg],
           "flash_attention_bhsd_ep_llama4": pre[ep][fa],
           "flash_attention_bhsd_ep_llama4_decode": dec[ep][fd]}
    expect(all(n > 0 for n in out.values()), f"phase 12 launches {out}")
    # rglru's scans at the rank's 4 x 512 x 640 in the staged form (training
    # and the prefill), its decode steps' in the serial form
    rg_train, rg_pre, rg_dec = (
        {f: c.get((rg, f), 0) for f in ("staged", "serial", "backward")}
        for c in (first["recurrentgemma-2b"], pre[rgm], dec[rgm]))
    expect(rg_train["serial"] == rg_pre["serial"] == rg_dec["staged"] == 0
           and min(rg_train["staged"], rg_train["backward"], rg_pre["staged"],
                   rg_dec["serial"]) > 0,
           f"phase 12 rglru forms: training {rg_train}, prefill {rg_pre}, "
           f"decode {rg_dec}")
    print(f"  launches on the path (rank 0, the configs' dtypes): {out}; "
          f"phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records, out


# this process's CUDA allocator: a cached block larger than
# max_split_size_mb is never split for a smaller tensor, so a small tensor
# kept past a full-width run (logits, a record's inputs) cannot pin the
# tens of GB of that run's freed weights and casts, which phase 12's four
# ranks need beside this process. The ranks keep the default: there it
# would only keep oversize blocks of one size from serving the next
ALLOC_CONF = "max_split_size_mb:256"


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setter or torch.cuda.memory._set_allocator_settings)(ALLOC_CONF)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.payload import ProteinPayload
    from repro_torch.kernels import _cuda

    t_start = time.perf_counter()
    print("phase 1: device and build", flush=True)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    try:
        triton = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton = "absent"
    nvcc = subprocess.run([_cuda.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"  triton {triton}; {nvcc.strip().splitlines()[-1]}", flush=True)
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    name = spill = ""                 # ptxas -v: entry, frame/spills, usage
    for line in (_cuda.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:   # drop the file's prefix
            name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_"
                          r"[0-9a-f]{8}", "", line.split("'")[1])[:72]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}; "
                  f"{spill}", flush=True)

    records = phase_kernels(torch)
    records += phase_wkv6(torch)
    records += phase_rglru_flash256(torch)
    records.append(phase_dense_decode(torch))
    phase_agreement(torch)
    phase_lm_agreement(torch, "phase 3b", "rwkv6-7b", 40)
    phase_lm_agreement(torch, "phase 3c", "recurrentgemma-2b", 20)
    t0 = time.perf_counter()
    pp = ProteinPayload(seed=0, device="cuda")
    print(f"  full-width payload built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    counts = phase_main_path(torch, pp)
    phase_profile(torch, pp)
    campaign = phase_campaign(torch, pp)
    phase_session(torch, pp)
    finetune = phase_evolution(torch, pp)
    for rec in finetune:
        counts[rec["name"]] = rec["launches"]
    records += finetune
    counts["flash_attention_bhsd_decode"] = campaign["default"]["decode"]
    # the gateway's paths add their launches to the records of the forms
    # they ran: paged decode, flash's bf16 sequence form and its decode form
    gateway, gateway_forms = phase_gateway(torch, pp)
    counts["paged_decode_bkgh"] += gateway["paged_decode_bkgh"]
    counts["flash_attention_bhsd"] += gateway_forms["seq_bf16"]
    counts["flash_attention_bhsd_decode"] += gateway_forms["decode"]
    del pp
    train = phase_train(torch)
    for rec in train:
        counts[rec["name"]] = rec["launches"]
    records += train
    wkv = phase_serving(torch)
    counts.update(wkv6_bhtk=wkv["wkv6_bhtk_prefill"],
                  wkv6_bhtk_decode=wkv["wkv6_bhtk_decode"])
    rg = phase_rg_serving(torch)
    counts.update(rglru_btc=rg["rglru_btc"],
                  flash_attention_bhsd_hd256=rg["flash_attention_bhsd_hd256"],
                  flash_attention_bhsd_hd256_decode=rg[
                      "flash_attention_bhsd_hd256_decode"])
    arch_records, arch_launches = phase_archs(torch)
    records += arch_records
    counts.update(arch_launches)
    moe_records, moe_launches = phase_moe(torch)
    records += moe_records
    counts.update(moe_launches)
    # training adds wkv6's prefill launches to phase 6's record (its shape)
    # and has records of its own at recurrentgemma-2b's 4 x 2560
    train_records, train_launches = phase_ssm_train(torch)
    records += train_records
    counts["wkv6_bhtk"] += train_launches.pop("wkv6_bhtk")
    counts.update(train_launches)
    # the mesh runs add their launches to the records of the kernels and
    # forms they ran; smollm-360m's flash shape is a record of its own
    mesh_records, mesh_launches = phase_mesh(torch)
    records += mesh_records
    for name, n in mesh_launches.items():
        counts[name] = counts.get(name, 0) + n
    # tensor-parallel training: the kernels at the ranks' local shapes are
    # records of their own; recurrentgemma's replicated attention adds to
    # the hd-256 training record
    tp_records_, tp_launches = phase_tp(torch)
    records += tp_records_
    for name, n in tp_launches.items():
        counts[name] = counts.get(name, 0) + n
    # the design-length record is the same kernel, run on the main path at
    # the engine's shape
    counts["paged_decode_bkgh_256x320"] = counts["paged_decode_bkgh"]
    for rec in records:
        rec["launches"] = counts[rec["name"]]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
